"""Write-ahead log for mutations: dynamic inserts (and, once streaming is
ported, committed stream epochs).

Every acknowledged mutation otherwise lives only in volatile
DeltaCSRSegment memory. This module is the durability rung: mutation
batches are appended here *before* they are acknowledged, so checkpoint +
WAL-tail replay (runtime/recovery.py) reconstructs a byte-identical store.

Format (one ``wal-<first_seq>.log`` per segment):

    MAGIC ("WKWAL1\\n")
    record*   where record = <u32 body_len> <u32 crc32(body)> <body>
    body = pickle((seq, kind, payload_dict))   # numpy arrays pickle intact

Torn tails are expected (a crash mid-append): replay stops at the first
truncated/short final record with a warning — that batch was never
acknowledged, so dropping it is the contract, not data loss. A CRC mismatch
*before* the tail is real corruption and raises a structured
:class:`CheckpointCorrupt` naming the segment.

Sync policy (``wal_sync`` knob): ``none`` flushes to the OS per append,
``interval`` additionally fsyncs at most once per ``wal_sync_interval_s``,
``always`` fsyncs every append (classic redo-log durability). Segments
rotate at ``wal_segment_mb``; :meth:`WriteAheadLog.truncate_upto` drops
whole segments entirely covered by a checkpoint.

The process-wide accessor :func:`active_wal` is keyed on the ``wal_dir``
knob — empty (the default) means every mutation hook degrades to a single
string check, keeping the serving hot path untouched.

The port's copy of the JAX package's store/wal.py. The record format is
kept byte for byte (the same header, the same pickle protocol, int64
triples in the payload), so a WAL directory written by either package
replays in the other.
"""

from __future__ import annotations

import os
import pickle
import struct
import sys
import threading
import time
import zlib
from dataclasses import dataclass

import numpy as np

from wukong_tpu_torch.analysis.lockdep import (
    declare_leaf,
    make_lock,
    make_rlock,
    register_global_lock,
)
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.utils.errors import CheckpointCorrupt
from wukong_tpu_torch.utils.logger import log_warn

MAGIC = b"WKWAL1\n"
_HDR = struct.Struct("<II")  # body length, crc32(body)

SYNC_POLICIES = ("none", "interval", "always")

# the per-WAL segment lock is a declared LEAF: code holding it only does
# file I/O and never calls back out into locked subsystems — acquiring any
# tracked lock (the mutation lock above all) while holding it is a
# lock-order inversion the lockdep checker flags
declare_leaf("wal.segment")


def _emit_wal_event(kind: str, **attrs) -> None:
    """Cluster-event journal hook (obs/events.py), lazily imported so the
    WAL's import graph stays flat. MUST be called with the segment lock
    released: the journal's ring lock is itself a lockdep leaf, and
    acquiring any lock under wal.segment is an inversion."""
    from wukong_tpu_torch.obs.events import emit_event

    emit_event(kind, **attrs)


@dataclass
class WalRecord:
    seq: int
    kind: str  # "insert" (dynamic batch) | "epoch" (stream commit)
    payload: dict


def _metrics():
    from wukong_tpu_torch.obs.metrics import get_registry

    reg = get_registry()
    return (
        reg.counter("wukong_wal_appends_total", "WAL records appended",
                    labels=("kind",)),
        reg.counter("wukong_wal_bytes_total", "WAL bytes written"),
        reg.counter("wukong_wal_fsyncs_total", "WAL fsync calls"),
        reg.counter("wukong_wal_replayed_total", "WAL records replayed",
                    labels=("kind",)),
    )


class WriteAheadLog:
    """Append-only, checksummed, segment-rotated mutation log."""

    def __init__(self, dirname: str, sync: str | None = None,
                 sync_interval_s: float | None = None,
                 segment_bytes: int | None = None):
        if sync is not None:
            sync = sync.strip().lower()
            if sync not in SYNC_POLICIES:
                raise ValueError(f"wal_sync must be one of {SYNC_POLICIES}, "
                                 f"got {sync!r}")
        self.dir = dirname
        # None = follow the runtime-mutable Global.wal_sync knob per append
        # (an operator flipping `wal_sync always` on a live system must get
        # the stronger policy immediately, not at the next restart)
        self._sync_override = sync
        self._sync_interval_override = (None if sync_interval_s is None
                                        else float(sync_interval_s))
        self.segment_bytes = (Global.wal_segment_mb * (1 << 20)
                              if segment_bytes is None else int(segment_bytes))
        self._lock = make_lock("wal.segment")
        self._fh = None  # guarded by: _lock
        self._fh_bytes = 0  # guarded by: _lock
        self._last_fsync = 0.0  # guarded by: _lock
        # recovery replay must not re-log what it applies
        self._suppress = 0  # guarded by: _lock
        (self._m_appends, self._m_bytes, self._m_fsyncs,
         self._m_replayed) = _metrics()
        os.makedirs(dirname, exist_ok=True)
        self.next_seq = self._scan_next_seq()  # guarded by: _lock

    # ------------------------------------------------------------------
    def _segments(self) -> list[tuple[int, str]]:
        """(first_seq, path) of every on-disk segment, ascending."""
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("wal-") and name.endswith(".log"):
                try:
                    first = int(name[4:-4])
                except ValueError:
                    continue
                out.append((first, os.path.join(self.dir, name)))
        return sorted(out)

    @property
    def sync(self) -> str:
        if self._sync_override is not None:
            return self._sync_override
        live = (Global.wal_sync or "none").strip().lower()
        return live if live in SYNC_POLICIES else "none"

    @property
    def sync_interval_s(self) -> float:
        return (self._sync_interval_override
                if self._sync_interval_override is not None
                else float(Global.wal_sync_interval_s))

    def _scan_next_seq(self) -> int:
        """Find the next seq AND repair a torn tail in place: resuming
        appends after torn bytes would bury the new (acknowledged) record
        behind a mid-segment CRC error — the exact corruption the WAL
        exists to prevent — so the tail segment is truncated back to its
        last valid record before any append."""
        segs = self._segments()
        if not segs:
            return 0
        path = segs[-1][1]
        last_seq, valid_end = self._scan_segment_tail(path)
        if valid_end < os.path.getsize(path):
            dropped = os.path.getsize(path) - valid_end
            log_warn(f"WAL torn tail at {path}:{valid_end}: truncating "
                     f"{dropped} bytes of the "
                     "unacknowledged record before resuming appends")
            _emit_wal_event("wal.torn_tail", path=path, offset=valid_end,
                            dropped_bytes=int(dropped), where="open")
            with open(path, "r+b") as f:
                f.truncate(valid_end)
        return (last_seq + 1) if last_seq is not None else segs[-1][0]

    def _scan_segment_tail(self, path: str) -> tuple[int | None, int]:
        """(last valid seq or None, byte offset just past the last valid
        record) of one segment. Same corruption rules as replay: a torn
        final record is tolerated, a bad CRC before the tail raises."""
        with open(path, "rb") as f:
            data = f.read()
        if not data.startswith(MAGIC):
            raise CheckpointCorrupt("WAL segment missing magic", path=path)
        off = len(MAGIC)
        n = len(data)
        last_seq = None
        while off < n:
            if off + _HDR.size > n:
                break
            blen, crc = _HDR.unpack_from(data, off)
            body = data[off + _HDR.size: off + _HDR.size + blen]
            if len(body) < blen:
                break
            if zlib.crc32(body) != crc:
                if off + _HDR.size + blen >= n:
                    break  # torn in-place overwrite of the final record
                raise CheckpointCorrupt(
                    f"WAL crc mismatch mid-segment at offset {off}",
                    path=path)
            last_seq = pickle.loads(body)[0]
            off += _HDR.size + blen
        return last_seq, off

    # ------------------------------------------------------------------
    # append side
    # ------------------------------------------------------------------
    @property
    def suppressed(self) -> bool:
        return self._suppress > 0  # unguarded: atomic int read; replay raises the count before any hook it replays through can observe it

    def suppress(self):
        """Context manager: WAL hooks become no-ops inside (recovery replay
        re-applies mutations through their normal code paths, which would
        otherwise re-append every record it reads)."""
        wal = self

        class _S:
            def __enter__(self):
                with wal._lock:
                    wal._suppress += 1

            def __exit__(self, *exc):
                with wal._lock:
                    wal._suppress -= 1

        return _S()

    def _open_segment(self, first_seq: int) -> None:  # caller holds: _lock
        if self._fh is not None:
            self._fh.close()
        path = os.path.join(self.dir, f"wal-{first_seq:016d}.log")
        self._fh = open(path, "ab")
        if self._fh.tell() == 0:
            self._fh.write(MAGIC)
        self._fh_bytes = self._fh.tell()

    def append(self, kind: str, **payload) -> int:
        """Durably record one mutation; returns its seq. The ``wal.append``
        fault site fires BEFORE any bytes land, so an injected failure
        leaves both the log and the store untouched (the batch was never
        acknowledged)."""
        from wukong_tpu_torch.runtime import faults

        faults.site("wal.append")
        rotated = None
        with self._lock:
            seq = self.next_seq
            body = pickle.dumps((seq, kind, payload),
                                protocol=pickle.HIGHEST_PROTOCOL)
            if self._fh is None or self._fh_bytes >= self.segment_bytes:
                # a size rotation (an open segment hit wal_segment_mb) is
                # a journal-worthy lifecycle event; the first-ever open is
                # not. Emission waits for the lock release below —
                # events.ring is a leaf and so is wal.segment.
                rotating = self._fh is not None
                self._open_segment(seq)
                if rotating:
                    rotated = self._fh.name
            self._fh.write(_HDR.pack(len(body), zlib.crc32(body)))
            self._fh.write(body)
            self._fh.flush()
            self._fh_bytes += _HDR.size + len(body)
            if self.sync == "always":
                os.fsync(self._fh.fileno())
                self._m_fsyncs.inc()
            elif self.sync == "interval":
                now = time.monotonic()
                if now - self._last_fsync >= self.sync_interval_s:
                    os.fsync(self._fh.fileno())
                    self._last_fsync = now
                    self._m_fsyncs.inc()
            self.next_seq = seq + 1
        self._m_appends.labels(kind=kind).inc()
        self._m_bytes.inc(_HDR.size + len(body))
        if rotated is not None:
            _emit_wal_event("wal.rotate", path=rotated, first_seq=seq)
        return seq

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None

    # ------------------------------------------------------------------
    # replay side
    # ------------------------------------------------------------------
    def _replay_segment(self, path: str, after_seq: int):
        return replay_segment_file(path, after_seq)

    def replay(self, after_seq: int = -1):
        """Yield every durable record with seq > after_seq, oldest first."""
        for _first, path in self._segments():
            for rec in self._replay_segment(path, after_seq):
                self._m_replayed.labels(kind=rec.kind).inc()
                yield rec

    def truncate_upto(self, seq: int) -> int:
        """Drop whole segments whose every record is <= seq (checkpointed).
        A segment straddling the boundary is kept — replay filters by seq,
        so over-retention is only disk, never duplicated application. The
        NEWEST segment is always kept even when fully covered: it anchors
        the sequence namespace — deleting every segment would restart seqs
        at 0 after a reboot while checkpoint manifests still record the old
        high-water mark, silently filtering the restarted (acknowledged)
        records out of replay. Returns segments removed."""
        segs = self._segments()
        removed = 0
        for i, (first, path) in enumerate(segs[:-1]):  # newest never dies
            nxt = segs[i + 1][0]
            # segment covers [first, nxt): droppable iff nxt - 1 <= seq
            # and it is not the active tail
            with self._lock:
                active = (self._fh is not None
                          and os.path.join(
                              self.dir,
                              f"wal-{first:016d}.log") == self._fh.name)
            if nxt - 1 <= seq and not active and nxt > first:
                os.remove(path)
                removed += 1
        return removed


# ---------------------------------------------------------------------------
# read-only replay (module functions, no WriteAheadLog construction)
#
# A reader of another process's live WAL directory must never construct a
# WriteAheadLog on it: the constructor repairs torn tails IN PLACE
# (truncates the file), and a reader racing the appender would see a
# half-written final record as "torn" and destroy acknowledged bytes.
# These functions read with the same corruption rules — torn tail
# tolerated, mid-segment CRC fatal — and never open anything for writing.
# ---------------------------------------------------------------------------

def replay_segment_file(path: str, after_seq: int):
    """Yield records with seq > after_seq from one segment, read-only."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(MAGIC):
        raise CheckpointCorrupt("WAL segment missing magic", path=path)
    off = len(MAGIC)
    n = len(data)
    while off < n:
        if off + _HDR.size > n:
            log_warn(f"WAL torn tail at {path}:{off} (short header); "
                     "dropping the unacknowledged record")
            _emit_wal_event("wal.torn_tail", path=path, offset=off,
                            where="replay")
            return
        blen, crc = _HDR.unpack_from(data, off)
        body = data[off + _HDR.size: off + _HDR.size + blen]
        if len(body) < blen:
            log_warn(f"WAL torn tail at {path}:{off} (short body); "
                     "dropping the unacknowledged record")
            _emit_wal_event("wal.torn_tail", path=path, offset=off,
                            where="replay")
            return
        if zlib.crc32(body) != crc:
            if off + _HDR.size + blen >= n:
                # final record: a torn in-place overwrite, same contract
                log_warn(f"WAL torn tail at {path}:{off} (bad crc on "
                         "final record); dropping it")
                _emit_wal_event("wal.torn_tail", path=path, offset=off,
                                where="replay")
                return
            raise CheckpointCorrupt(
                f"WAL crc mismatch mid-segment at offset {off}",
                path=path)
        seq, kind, payload = pickle.loads(body)
        if seq > after_seq:
            yield WalRecord(seq=seq, kind=kind, payload=payload)
        off += _HDR.size + blen


def replay_dir(dirname: str, after_seq: int = -1):
    """Yield every durable record with seq > after_seq from a WAL
    directory, oldest first, strictly read-only (a torn live tail is
    skipped, never repaired — that is the owning appender's job)."""
    segs = []
    for name in os.listdir(dirname):
        if name.startswith("wal-") and name.endswith(".log"):
            try:
                first = int(name[4:-4])
            except ValueError:
                continue
            segs.append((first, os.path.join(dirname, name)))
    for _first, path in sorted(segs):
        yield from replay_segment_file(path, after_seq)


# ---------------------------------------------------------------------------
# process-wide accessor + the mutation hook
# ---------------------------------------------------------------------------

_state: dict = {"wal": None, "dir": None}  # guarded by: _state_lock
_state_lock = make_lock("wal.state")

# serializes batch mutations (dynamic insert fan-out, stream epoch commits)
# against checkpoint serialization: a checkpoint that captures its WAL
# high-water mark and then serializes stores while a commit is in flight
# would half-contain the racing epoch yet record it as covered. Batch-level
# and reentrant (a commit's nested per-store inserts run on the same
# thread), so the uncontended cost is one lock op per BATCH, not per row.
_commit_lock = make_rlock("wal.mutation_lock")


def mutation_lock() -> "threading.RLock":
    """THE coarse outer commit lock. Always reach it through this accessor
    (never bind ``_commit_lock`` at import): lockdep's ``install()``
    rebuilds the module-level object when the chaos/recovery/batch suites
    flip the process into checked mode."""
    return _commit_lock


# these two are created at import time — before any test can flip the
# debug_locks knob — so they register for lockdep.install() rebinding
register_global_lock(sys.modules[__name__], "_state_lock", "wal.state")
register_global_lock(sys.modules[__name__], "_commit_lock",
                     "wal.mutation_lock", kind="rlock")


def active_wal() -> WriteAheadLog | None:
    """The process WAL per the ``wal_dir`` knob (None when unset). Keyed on
    the directory so tests pointing the knob at fresh tmp dirs get fresh
    logs; the empty-knob fast path is one string check."""
    d = Global.wal_dir
    if not d:
        return None
    with _state_lock:
        if _state["dir"] != d:
            if _state["wal"] is not None:
                _state["wal"].close()
            _state["wal"] = WriteAheadLog(d)
            _state["dir"] = d
        return _state["wal"]


def reset_wal() -> None:
    """Drop the cached process WAL (tests; config reloads pick up a new
    directory automatically via active_wal's key check)."""
    with _state_lock:
        if _state["wal"] is not None:
            _state["wal"].close()
        _state["wal"] = None
        _state["dir"] = None


def maybe_wal_append(kind: str, triples, dedup: bool, ts=None,
                     **extra) -> int | None:
    """THE durability hook every primary mutation path routes through.
    No-op (None) when the WAL is off or a recovery replay is in flight."""
    wal = active_wal()
    if wal is None or wal.suppressed:
        return None
    return wal.append(kind, triples=np.asarray(triples, dtype=np.int64),
                      dedup=bool(dedup), ts=ts, **extra)
