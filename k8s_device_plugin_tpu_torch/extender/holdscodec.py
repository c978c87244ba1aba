"""The shard-holds overlay's wire: the JAX package's ``extender/holdscodec.py``,
byte for byte.

Sharded admission (``sharding.py``) mirrors each shard's reservation holds
to its peers through an annotation on the shard's Lease
(``tpu.google.com/shard-holds``). A record is ``{"namespace", "gang",
"hosts": {host: cards}}``. In JSON the same hostnames repeat across every
record, so the writer packs the records into a binary layout: a
deduplicated host table, then per record a bitset selecting hosts out of
that table and a varint card count per selected host, base64-armoured
behind a ``tpb1:`` prefix so it still travels as an annotation string.

The reader negotiates the form off the prefix: ``tpb1:`` goes through the
binary decoder, anything else through the lenient JSON parser, so a reader
takes both forms with no handshake. The writer always emits binary: the
JAX writer's ``TPU_SHARD_HOLDS_WIRE=json`` hatch is for rollouts past
readers that only know JSON, and the port's leases carry their own names
(``nvidia-scheduler-extender-shard-<k>``), so no such reader ever reads
them.

Binary layout (version 1), after base64-decoding the part after
``tpb1:``::

    u8                      format version (== 1)
    varint H                host-table size
    H x (varint len, utf8)  hostnames, deduplicated, first-seen order
    varint R                record count
    R x record:
        varint len, utf8    namespace
        varint len, utf8    gang
        ceil(H/8) bytes     host bitset (host i -> byte i//8, bit i%8)
        per set bit, ascending host index:
            varint          cards held on that host (> 0)

Varints are unsigned LEB128. Any structural fault (an unknown version,
truncation, trailing bytes, a zero count, bad UTF-8 or base64) decodes to
the empty overlay, as corrupt JSON does: the reader degrades to "peer holds
unknown" rather than guessing.

Decoding is memoised by a digest of the payload: the peer scan re-reads
every shard's lease each pass, and the annotation is byte-identical between
passes unless that shard's holds changed. A hit returns the cached list
itself; callers treat decoded overlays as read-only.
"""

from __future__ import annotations

import base64
import hashlib
import json
import threading
from collections import OrderedDict
from typing import Dict, List

from ..utils import metrics

_PREFIX = "tpb1:"
_VERSION = 1


# -- varint (unsigned LEB128) -------------------------------------------------


def _put_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _get_varint(buf: bytes, pos: int) -> tuple:
    """(value, new_pos); ValueError on truncation or overflow."""
    value = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint overflow")


def _put_str(out: bytearray, s: str) -> None:
    raw = s.encode("utf-8")
    _put_varint(out, len(raw))
    out.extend(raw)


def _get_str(buf: bytes, pos: int) -> tuple:
    n, pos = _get_varint(buf, pos)
    if pos + n > len(buf):
        raise ValueError("truncated string")
    return buf[pos:pos + n].decode("utf-8"), pos + n


# -- encode -------------------------------------------------------------------


def encode_holds(recs: List[dict]) -> str:
    """The shard-holds annotation's payload: always the binary ``tpb1:``
    form. Records come in canonical shape (``namespace``/``gang`` strings,
    ``hosts`` host -> cards > 0), as the sharding plane builds them from
    its own table's snapshot."""
    return _PREFIX + base64.b64encode(pack_holds(recs)).decode("ascii")


def pack_holds(recs: List[dict]) -> bytes:
    """The raw (pre-base64) version-1 layout."""
    host_index: Dict[str, int] = {}
    for rec in recs:
        for host in rec["hosts"]:
            if host not in host_index:
                host_index[host] = len(host_index)
    out = bytearray()
    out.append(_VERSION)
    _put_varint(out, len(host_index))
    for host in host_index:  # insertion order is index order
        _put_str(out, host)
    nbytes = (len(host_index) + 7) // 8
    _put_varint(out, len(recs))
    for rec in recs:
        _put_str(out, rec["namespace"])
        _put_str(out, rec["gang"])
        bits = 0
        for host in rec["hosts"]:
            bits |= 1 << host_index[host]
        out.extend(bits.to_bytes(nbytes, "little"))
        for host in sorted(rec["hosts"], key=host_index.__getitem__):
            _put_varint(out, rec["hosts"][host])
    return bytes(out)


# -- decode -------------------------------------------------------------------


def unpack_holds(buf: bytes) -> List[dict]:
    """Decode the raw binary layout; ValueError on any fault."""
    if not buf or buf[0] != _VERSION:
        raise ValueError("unknown holds format version")
    pos = 1
    nhosts, pos = _get_varint(buf, pos)
    if nhosts > len(buf):  # a cheap bound before the table is allocated
        raise ValueError("host table larger than payload")
    hosts: List[str] = []
    for _ in range(nhosts):
        h, pos = _get_str(buf, pos)
        hosts.append(h)
    nbytes = (nhosts + 7) // 8
    nrecs, pos = _get_varint(buf, pos)
    if nrecs > len(buf):
        raise ValueError("record count larger than payload")
    recs: List[dict] = []
    for _ in range(nrecs):
        ns, pos = _get_str(buf, pos)
        gang, pos = _get_str(buf, pos)
        if pos + nbytes > len(buf):
            raise ValueError("truncated host bitset")
        bits = int.from_bytes(buf[pos:pos + nbytes], "little")
        pos += nbytes
        if bits >> nhosts:
            raise ValueError("host bitset references unknown host")
        held: Dict[str, int] = {}
        rem = bits
        while rem:
            i = (rem & -rem).bit_length() - 1
            rem &= rem - 1
            cards, pos = _get_varint(buf, pos)
            if cards <= 0:
                raise ValueError("non-positive card count")
            held[hosts[i]] = cards
        recs.append({"namespace": ns, "gang": gang, "hosts": held})
    if pos != len(buf):
        raise ValueError("trailing bytes after last record")
    return recs


def _decode_json(raw: str) -> List[dict]:
    """The JSON form, read leniently as the JAX reader does: a malformed
    host entry is dropped from its record rather than poisoning it, names
    are coerced to strings, a record whose hosts are not a mapping goes."""
    try:
        data = json.loads(raw)
    except ValueError:
        return []
    out: List[dict] = []
    for rec in data if isinstance(data, list) else []:
        if isinstance(rec, dict) and isinstance(rec.get("hosts"), dict):
            out.append({
                "namespace": str(rec.get("namespace", "")),
                "gang": str(rec.get("gang", "")),
                "hosts": {str(h): int(n) for h, n in rec["hosts"].items()
                          if isinstance(n, int) and n > 0},
            })
    return out


# The decode memo, keyed by a short digest of the payload, LRU-bounded.
_MEMO_MAX = 1024
_MEMO: "OrderedDict[bytes, List[dict]]" = OrderedDict()
_MEMO_LOCK = threading.Lock()


def _memo_key(raw: str) -> bytes:
    return hashlib.blake2b(raw.encode("utf-8"), digest_size=16).digest()


def clear_memo() -> None:
    """Drop the decode memo (test isolation)."""
    with _MEMO_LOCK:
        _MEMO.clear()


def decode_holds(raw: str) -> List[dict]:
    """Hold records of a shard-holds payload of either form; a corrupt
    payload of either is the empty overlay. Memoised by content digest:
    callers must treat the result as read-only."""
    if not raw:
        return []
    key = _memo_key(raw)
    with _MEMO_LOCK:
        hit = _MEMO.get(key)
        if hit is not None:
            _MEMO.move_to_end(key)
    if hit is not None:
        metrics.PARSE_AVOIDED.inc(reason="holds_memo")
        return hit
    if raw.startswith(_PREFIX):
        try:
            recs = unpack_holds(base64.b64decode(raw[len(_PREFIX):], validate=True))
        except (ValueError, UnicodeDecodeError):
            recs = []
    else:
        recs = _decode_json(raw)
    with _MEMO_LOCK:
        if key not in _MEMO:
            _MEMO[key] = recs
            while len(_MEMO) > _MEMO_MAX:
                _MEMO.popitem(last=False)
    return recs
