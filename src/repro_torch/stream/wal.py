"""Write-ahead ingest log: the durability half of fault tolerance.

Every ingest batch is appended (and fsync'd) here *before* any service
state is mutated, so a worker killed at any point can be recovered:
``ResolveService.recover`` restores the latest checkpoint and replays
the WAL tail through the normal ingest path — the stream==batch
schedule-invariance theorem is what turns "replay the arrivals" into
"reach the interrupted run's fixpoint bit-for-bit".

Format — append-only segment files ``wal-<startseq>.log`` of
length-prefixed, CRC-guarded pickle records::

    [u32 payload_len][u32 crc32(payload)][payload]

``payload`` pickles ``{"type": "ingest"|"abort", "seq": int, ...}``;
ingest records carry the *resolved* ``names``/``edges``/``ids`` (ids
are materialized before logging so replay never re-runs auto-id
assignment).  An ``abort`` record marks a sequence number whose ingest
was transactionally rolled back — replay skips it.  A torn tail (the
crash landed mid-append) is detected by the length/CRC check and
truncated on open; a record missing its abort marker because the
worker died mid-ingest is simply replayed, which is exactly the
all-or-nothing semantics the undo log gives the live path.

Segments exist so checkpoints can garbage-collect the log: after a
checkpoint at sequence ``s`` the service rotates to a fresh segment
and drops every segment whose records are all ``<= s``.

The byte format is the JAX reference package's, record for
record, so each package reads the other's log.  The log holds host
data only (names, numpy edges, int ids).
"""

from __future__ import annotations

import os
import pickle
import struct
import time
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

from repro_torch import faults, obs

_HEADER = struct.Struct("<II")
_SEGMENT_FMT = "wal-{:016d}.log"


@dataclass
class WalRecord:
    seq: int
    names: list
    edges: object  # (E, 2) int64 ndarray or None
    ids: list


def _segment_start(path: Path) -> int:
    return int(path.stem.split("-")[1])


def _segments(directory: Path) -> list[Path]:
    return sorted(directory.glob("wal-*.log"), key=_segment_start)


def _read_segment(path: Path, *, repair: bool = False) -> Iterator[dict]:
    """Yield good records; on a torn/corrupt tail stop (and truncate the
    file back to the last good record when ``repair``)."""
    good_end = 0
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off + _HEADER.size <= len(data):
        length, crc = _HEADER.unpack_from(data, off)
        payload = data[off + _HEADER.size : off + _HEADER.size + length]
        if len(payload) < length or zlib.crc32(payload) != crc:
            break
        off += _HEADER.size + length
        good_end = off
        yield pickle.loads(payload)
    if repair and good_end < len(data):
        with open(path, "r+b") as f:
            f.truncate(good_end)


class WriteAheadLog:
    """Single-writer, fsync-per-append ingest log over segment files."""

    def __init__(self, directory: str | os.PathLike, *, fsync: bool = True):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.fsync = fsync
        segs = _segments(self.directory)
        if segs:
            # drop a torn tail before appending after it
            for _ in _read_segment(segs[-1], repair=True):
                pass
            self._path = segs[-1]
        else:
            self._path = self.directory / _SEGMENT_FMT.format(0)
        self._f = open(self._path, "ab")

    # -- append side --------------------------------------------------------

    def _append(self, payload: dict) -> int:
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        t0 = time.perf_counter()
        self._f.write(_HEADER.pack(len(blob), zlib.crc32(blob)))
        self._f.write(blob)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        reg = obs.get_registry()
        reg.counter("wal.appends").inc()
        reg.counter("wal.bytes").inc(_HEADER.size + len(blob))
        reg.histogram("wal.append_ms").observe(
            (time.perf_counter() - t0) * 1e3
        )
        return _HEADER.size + len(blob)

    def append(self, seq: int, names, edges, ids) -> int:
        """Durably log one ingest batch; returns bytes written."""
        return self._append(
            {"type": "ingest", "seq": int(seq), "names": list(names),
             "edges": edges, "ids": [int(i) for i in ids]}
        )

    def append_abort(self, seq: int) -> None:
        """Mark ``seq`` as transactionally rolled back (replay skips it)."""
        self._append({"type": "abort", "seq": int(seq)})

    # -- checkpoint coordination -------------------------------------------

    def rotate(self, next_seq: int) -> None:
        """Start a fresh segment whose records will all be >= next_seq."""
        # a crash here (checkpoint durable, old segment still live) must
        # recover cleanly: the checkpoint wins, the stale tail is skipped
        faults.maybe_fail("wal.rotate")
        self._f.close()
        self._path = self.directory / _SEGMENT_FMT.format(int(next_seq))
        self._f = open(self._path, "ab")

    def gc(self, upto_seq: int) -> int:
        """Delete segments fully covered by a checkpoint at ``upto_seq``
        (every record <= upto_seq); returns segments removed."""
        segs = _segments(self.directory)
        removed = 0
        for seg, nxt in zip(segs, segs[1:]):
            if seg == self._path:
                continue
            if _segment_start(nxt) - 1 <= upto_seq:
                seg.unlink()
                removed += 1
        return removed

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    # -- replay side --------------------------------------------------------

    @staticmethod
    def scan(directory: str | os.PathLike) -> tuple[list[WalRecord], set[int]]:
        """All good ingest records (seq order) + the aborted-seq set.
        Repairs a torn tail in the final segment as a side effect."""
        directory = Path(directory)
        records: dict[int, WalRecord] = {}
        aborted: set[int] = set()
        segs = _segments(directory)
        for i, seg in enumerate(segs):
            for rec in _read_segment(seg, repair=(i == len(segs) - 1)):
                if rec["type"] == "ingest":
                    records[rec["seq"]] = WalRecord(
                        rec["seq"], rec["names"], rec["edges"], rec["ids"]
                    )
                elif rec["type"] == "abort":
                    aborted.add(rec["seq"])
        return [records[s] for s in sorted(records)], aborted
