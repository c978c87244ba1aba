"""The record grammar of the JAX package's ``utils/statestore.py``: one record
a line, ``<crc32 hex> <canonical json>\\n``, and the reader that keeps the
intact prefix of a journal.

A crash mid-append leaves a partial last line: the reader keeps every intact
record before it and reports the tail as torn rather than raising. A checksum
or JSON failure anywhere stops the read there (everything after a corrupt
record is suspect) and reports ``corrupt``.

The bytes are the JAX plane's, so a black-box segment written by either
daemon decodes in the other. The journal owner (``StateStore``) and the
snapshot files come with the scheduler extender's admission journal.
"""

from __future__ import annotations

import json
import zlib
from typing import List

# Read statuses, in increasing order of damage: "clean" and "empty" are
# healthy, "torn_tail" is the expected shape after a crash mid-append,
# "corrupt" (a mid-file checksum break) means bytes were lost.
CLEAN = "clean"
EMPTY = "empty"
TORN_TAIL = "torn_tail"
CORRUPT = "corrupt"


def _crc(payload: bytes) -> str:
    return f"{zlib.crc32(payload) & 0xFFFFFFFF:08x}"


def encode_record(rec: dict) -> bytes:
    payload = json.dumps(rec, separators=(",", ":"), sort_keys=True).encode()
    return _crc(payload).encode() + b" " + payload + b"\n"


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
