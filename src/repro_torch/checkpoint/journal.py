"""Crash-safe append-only journal: the storage half of serve recovery.

The counterpart of ``repro/checkpoint/journal.py``, byte for byte the
same record format. The unit of progress of a serving loop is one
tile's worth of exceedance counters, and this journal is its primitive:
an append-only record log where each line is one self-verifying JSON
record,

    ``<crc32 of the json, 8 hex chars> <compact json>\\n``

``append`` writes and flushes (optionally fsyncs — durability vs
throughput is the caller's call); ``replay`` re-reads records in order
and STOPS at the first line that fails its checksum or doesn't parse.
Because the file is append-only, a torn write can only ever be the
final line — a process killed mid-``append`` loses at most the record
being written, never the prefix. No rewrite-in-place, no compaction:
recovery semantics stay trivially auditable, and an *append-only
counter* journaled this way (the serve plane's per-request exceedance
counts and draws-done cursors) makes recovery bitwise-neutral — the
replayed prefix is exactly the state the crashed process had durably
reached.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Iterator, List, Optional


def _encode(record: dict) -> str:
    data = json.dumps(record, separators=(",", ":"), sort_keys=True)
    return f"{zlib.crc32(data.encode()):08x} {data}\n"


def _decode(line: str) -> Optional[dict]:
    """The record, or None when the line is torn/corrupt."""
    if len(line) < 10 or line[8] != " ":
        return None
    crc_hex, data = line[:8], line[9:].rstrip("\n")
    try:
        if int(crc_hex, 16) != zlib.crc32(data.encode()):
            return None
        return json.loads(data)
    except (ValueError, json.JSONDecodeError):
        return None


class Journal:
    """One append-only record log (see module docstring).

    Opening an existing path continues appending after its valid
    prefix — records live forever (the log is the history); readers
    use :func:`replay` / :meth:`records`.
    """

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self.appended = 0

    def append(self, record: dict) -> None:
        """Durably append one record (flush always, fsync opt-in)."""
        self._f.write(_encode(record))
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self.appended += 1

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def records(self) -> List[dict]:
        """This journal's valid prefix, re-read from disk."""
        self._f.flush()
        return list(replay(self.path))


def replay(path: str) -> Iterator[dict]:
    """Yield the journal's records in append order, stopping at the
    first checksum/parse failure (the torn tail of a crashed writer).
    A missing file replays empty — recovery from nothing is a no-op."""
    if not os.path.exists(path):
        return
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            rec = _decode(line)
            if rec is None:
                return
            yield rec
