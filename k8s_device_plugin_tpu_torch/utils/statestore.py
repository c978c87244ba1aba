"""The record grammar of the JAX package's ``utils/statestore.py``: one record
a line, ``<crc32 hex> <canonical json>\\n``, and the reader that keeps the
intact prefix of a journal; and its snapshot files: one state document in a
checksummed envelope, written tmp + fsync + rename.

A crash mid-append leaves a partial last line: the reader keeps every intact
record before it and reports the tail as torn rather than raising. A checksum
or JSON failure anywhere stops the read there (everything after a corrupt
record is suspect) and reports ``corrupt``.

The bytes are the JAX plane's, so a black-box segment or a snapshot file
written by either plane reads in the other. The scheduler extender's topology
index persists its snapshot through ``snapshot_doc`` and
``write_snapshot_file``. The journal owner (``StateStore``) and ``read_state``
come with the extender's admission journal.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import List, Optional

from .logging import get_logger

log = get_logger(__name__)

SNAPSHOT_VERSION = 1

# Read statuses, in increasing order of damage: "clean" and "empty" are
# healthy, "torn_tail" is the expected shape after a crash mid-append,
# "corrupt" (a mid-file checksum break) and "snapshot_corrupt" mean bytes
# were lost.
CLEAN = "clean"
EMPTY = "empty"
TORN_TAIL = "torn_tail"
CORRUPT = "corrupt"
SNAPSHOT_CORRUPT = "snapshot_corrupt"


def _crc(payload: bytes) -> str:
    return f"{zlib.crc32(payload) & 0xFFFFFFFF:08x}"


def encode_record(rec: dict) -> bytes:
    payload = json.dumps(rec, separators=(",", ":"), sort_keys=True).encode()
    return _crc(payload).encode() + b" " + payload + b"\n"


def snapshot_doc(data: dict, seq: int = 0) -> dict:
    """Wrap a state document in the checksummed snapshot envelope: version,
    the journal seq it covers, and the CRC of the data's canonical
    encoding."""
    payload = json.dumps(data, separators=(",", ":"), sort_keys=True).encode()
    return {
        "version": SNAPSHOT_VERSION,
        "seq": seq,
        "checksum": _crc(payload),
        "data": data,
    }


def write_snapshot_file(path: str, doc: dict, tmp_path: Optional[str] = None) -> None:
    """Persist a snapshot document atomically: tmp + fsync + rename. Raises
    OSError on disk trouble; the caller decides whether that is fatal."""
    tmp = tmp_path or path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_snapshot_file(snapshot_path: str) -> "tuple[Optional[dict], int, str]":
    """(data, covered_seq, status) of one snapshot file: CLEAN (validated),
    EMPTY (no file) or SNAPSHOT_CORRUPT (unreadable or a checksum mismatch;
    the data is None and the caller rebuilds from scratch). Never raises."""
    try:
        with open(snapshot_path, "rb") as f:
            doc = json.loads(f.read())
        payload = json.dumps(doc.get("data"), separators=(",", ":"),
                             sort_keys=True).encode()
        if doc.get("checksum") != _crc(payload):
            log.warning("snapshot %s failed its checksum; ignoring it", snapshot_path)
            return None, 0, SNAPSHOT_CORRUPT
        return doc.get("data"), int(doc.get("seq", 0)), CLEAN
    except FileNotFoundError:
        return None, 0, EMPTY
    except (OSError, ValueError, TypeError) as e:
        log.warning("unreadable snapshot %s (%s); ignoring it", snapshot_path, e)
        return None, 0, SNAPSHOT_CORRUPT


@dataclasses.dataclass
class LoadResult:
    snapshot: Optional[dict]  # the last compacted state document, or None
    records: List[dict]  # journal records newer than the snapshot, in order
    status: str  # CLEAN / EMPTY / TORN_TAIL / CORRUPT / SNAPSHOT_CORRUPT
    dropped: int  # journal lines discarded as torn or corrupt
    seq: int  # highest seq observed (the snapshot's or the last record's)


def _decode_journal(data: bytes) -> "tuple[List[dict], str, int, int]":
    """(records, status, dropped, good_end). Stops at the first unreadable
    line: a missing trailing newline is a torn tail, a checksum or JSON
    failure is corruption; either way only the intact prefix is trusted.
    ``good_end`` is the byte offset just past the last intact record."""
    records: List[dict] = []
    if not data:
        return records, CLEAN, 0, 0
    lines = data.split(b"\n")
    torn = lines[-1] != b""  # no final newline: the last append was cut
    body = lines[:-1]
    dropped = 1 if torn else 0
    good_end = 0
    for i, line in enumerate(body):
        if not line:
            good_end += 1  # blank line (truncate artifact): skip it
            continue
        sep = line.find(b" ")
        ok = sep == 8 and _crc(line[sep + 1:]).encode() == line[:sep]
        if ok:
            try:
                records.append(json.loads(line[sep + 1:]))
                good_end += len(line) + 1
                continue
            except ValueError:
                pass
        # Everything from here on is suspect: the record boundary can no
        # longer be trusted.
        return records, CORRUPT, dropped + len(body) - i, good_end
    return records, TORN_TAIL if torn else CLEAN, dropped, good_end
