"""Live triple ingestion: timestamped batch sources -> epoch-stamped commits.

The Wukong+S ingest side: a :class:`TripleSource` yields ``(ts, [N,3])``
batches (replayed from an in-memory array, a datagen directory, or a
timestamped file); a :class:`StreamIngestor` commits each batch into one or
more ``DynamicGStore`` partitions as one *epoch* — the unit of incremental
evaluation (continuous.py) and of window retirement (windows.py). Each
commit bumps the store version (device caches restage lazily) and notifies
the standing-query registry.

Resilience: the commit path is a ``stream.ingest`` fault site wrapped in
``retry_call`` (dedup inserts are idempotent, so a transiently-failed batch
replays safely); the store-level insert exposes its own ``dynamic.insert``
site (store/dynamic.py). Non-dedup ingest does NOT retry — a replayed batch
would double-append — so transients there surface to the caller.

The port's copy of the JAX package's stream/ingest.py: an epoch committed
during a shard migration's dual-write window also reaches the recipient
(store/dynamic.py ``migration_sinks``).
"""

from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass

import numpy as np

from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.obs.recorder import get_recorder
from wukong_tpu_torch.obs.trace import activate, maybe_start_trace
from wukong_tpu_torch.store.dynamic import insert_triples, migration_sinks
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError
from wukong_tpu_torch.utils.timer import get_usec

# stream-side metrics: committed epochs/triples as counters, per-epoch
# latencies as histograms (the Monitor keeps its private CDF windows; the
# registry feeds the Prometheus/JSON exporters)
_M_EPOCHS = get_registry().counter(
    "wukong_stream_epochs_total", "Committed stream epochs")
_M_TRIPLES = get_registry().counter(
    "wukong_stream_triples_total", "Triples offered to stream commits")
_M_EVAL = get_registry().histogram(
    "wukong_stream_eval_us", "Standing-query evaluation time per epoch")
_M_LAG = get_registry().histogram(
    "wukong_stream_lag_us", "Commit-to-results lag per epoch")

# recent EpochRecords kept for inspection (bounds memory on long-running
# ingest loops; the Monitor's totals/CDFs keep counting past it)
EPOCH_LOG_WINDOW = 4096


@dataclass
class EpochRecord:
    """One committed epoch's bookkeeping (monitor + window bookkeeping)."""

    epoch: int
    ts: float  # source timestamp of the batch (replay time axis)
    n_triples: int  # batch rows offered
    n_inserted: int  # subject-side edges actually new (post-dedup)
    version: int  # store version after the commit
    ingest_us: int = 0
    eval_us: int = 0  # standing-query evaluation time for this epoch

    @property
    def lag_us(self) -> int:
        """Commit-to-results latency: how far results trail ingestion."""
        return self.ingest_us + self.eval_us


class ReplaySource:
    """Replay an in-memory [N,3] triple array as timestamped batches.

    The time axis is synthetic: batch k carries ``ts = start_ts + k*ts_step``.
    This is the datagen-replay path — deterministic, so delta-vs-oracle
    tests and benchmarks see identical schedules.
    """

    def __init__(self, triples: np.ndarray, batch_size: int,
                 start_ts: float = 0.0, ts_step: float = 1.0):
        triples = np.asarray(triples, dtype=np.int64)
        if triples.ndim != 2 or triples.shape[1] != 3:
            raise WukongError(ErrorCode.UNKNOWN_PATTERN,
                              f"replay source wants [N,3], got {triples.shape}")
        if batch_size < 1:
            raise WukongError(ErrorCode.SYNTAX_ERROR, "batch_size must be >= 1")
        self.triples = triples
        self.batch_size = int(batch_size)
        self.start_ts = start_ts
        self.ts_step = ts_step

    def __iter__(self):
        for k, lo in enumerate(range(0, len(self.triples), self.batch_size)):
            yield (self.start_ts + k * self.ts_step,
                   self.triples[lo:lo + self.batch_size])


class FileSource:
    """Stream id-triple files (``s\\tp\\to`` rows, optional 4th ``ts``
    column) from a datagen-convention directory, in batches.

    Rows without a timestamp get the synthetic axis (batch index), matching
    ReplaySource; 4-column input is split into per-timestamp batches
    (capped at batch_size) so one epoch never mixes timestamps.

    Timestamped grouping is GLOBAL across the directory (datagen
    ``--timestamps`` writes one id_* file per source file, all spanning the
    same epochs, and rows arrive out of order within a file) — which means
    the 4-column path materializes every file before the first epoch is
    emitted, a deliberate trade: correct epoch order over unsorted input
    needs all rows, and replay directories are bounded. The 3-column path
    streams file by file as before.
    """

    def __init__(self, path: str, batch_size: int = 4096):
        self.path = path
        self.batch_size = int(batch_size)

    def _files(self) -> list[str]:
        if os.path.isfile(self.path):
            return [self.path]
        names = sorted(n for n in os.listdir(self.path)
                       if n.startswith("id_"))
        if not names:
            raise WukongError(ErrorCode.FILE_NOT_FOUND,
                              f"no id_* triple files under {self.path}")
        return [os.path.join(self.path, n) for n in names]

    def __iter__(self):
        k = 0
        pending4: list[np.ndarray] = []  # 4-col files: grouped GLOBALLY
        for f in self._files():
            data = np.loadtxt(f, dtype=np.int64, ndmin=2)
            if data.size == 0:
                continue
            if data.shape[1] == 3:
                if pending4:
                    raise WukongError(
                        ErrorCode.UNKNOWN_PATTERN,
                        f"{f}: 3-column file in a timestamped (4-column) "
                        "directory — one replay cannot mix time axes")
                for lo in range(0, len(data), self.batch_size):
                    yield float(k), data[lo:lo + self.batch_size]
                    k += 1
            elif data.shape[1] == 4:
                if k:
                    raise WukongError(
                        ErrorCode.UNKNOWN_PATTERN,
                        f"{f}: 4-column file in a synthetic-axis (3-column) "
                        "directory — one replay cannot mix time axes")
                # don't yield yet: datagen --timestamps writes one id_*
                # file per source file, each spanning the SAME epochs, so
                # per-file grouping would re-emit a timestamp once per
                # file (splitting one epoch and breaking window
                # retirement order). Collect, then sort/group globally.
                pending4.append(data)
            else:
                raise WukongError(
                    ErrorCode.UNKNOWN_PATTERN,
                    f"{f}: want 3 (s p o) or 4 (s p o ts) columns, "
                    f"got {data.shape[1]}")
        if pending4:
            data = np.concatenate(pending4)
            ts_col = data[:, 3]
            order = np.argsort(ts_col, kind="stable")
            data, ts_col = data[order], ts_col[order]
            uts, starts = np.unique(ts_col, return_index=True)
            bounds = np.append(starts, len(data))
            for t, lo, hi in zip(uts, bounds[:-1], bounds[1:]):
                for blo in range(int(lo), int(hi), self.batch_size):
                    yield (float(t),
                           data[blo:min(blo + self.batch_size, hi), :3])


class StreamIngestor:
    """Commits source batches into the store(s) as numbered epochs.

    ``stores`` are the insert targets (host partition + distributed shards,
    like `load -d`); ``continuous`` is the standing-query registry notified
    after every commit; ``monitor`` collects stream lag / per-epoch latency.
    """

    def __init__(self, stores: list, continuous=None, monitor=None,
                 dedup: bool = True):
        self.stores = list(stores)  # lock-free: whole-list rebinding (recovery heals swap it atomically); commit iterates a snapshot reference
        self.continuous = continuous
        self.monitor = monitor
        self.dedup = bool(dedup)
        # the epoch counter advances only inside the WAL mutation lock —
        # the same lock that makes a commit atomic w.r.t. checkpoints
        self.epoch = 0  # guarded by: mutation_lock()
        # recent epochs (bounded)
        self.log: deque = deque(maxlen=EPOCH_LOG_WINDOW)  # lock-free: atomic deque append; report readers tolerate a stale tail

    def commit_epoch(self, triples: np.ndarray, ts: float | None = None
                     ) -> EpochRecord:
        """Insert one batch as the next epoch, then evaluate standing
        queries on its delta. Returns the epoch's record."""
        from wukong_tpu_torch.runtime import faults
        from wukong_tpu_torch.store.gstore import check_vid_range

        triples = np.asarray(triples, dtype=np.int64)
        if triples.ndim != 2 or triples.shape[1] != 3:
            raise WukongError(ErrorCode.UNKNOWN_PATTERN,
                              f"epoch batch wants [N,3], got {triples.shape}")
        check_vid_range(triples)  # once per epoch, not per store
        # durability first (store/wal.py): the epoch is logged BEFORE any
        # store mutates, so a crash mid-apply replays it to completion and
        # a WAL failure fails the commit with the stores untouched — either
        # way no acknowledged epoch is ever lost. The mutation lock keeps
        # the whole commit (log + insert fan-out + registry eval) atomic
        # w.r.t. checkpoint serialization (runtime/recovery.py).
        from wukong_tpu_torch.store.wal import maybe_wal_append, mutation_lock

        # per-epoch trace (the stream lane's unit of work): ingest + eval
        # spans, recorded into the same flight recorder as query traces
        trace = maybe_start_trace(kind="stream")
        t0 = get_usec()

        inserted = [0]  # accumulated across retry attempts: a store that
        # committed before a mid-loop transient dedups its replay to 0, so
        # only the running total counts every edge exactly once

        def _ingest() -> int:
            faults.site("stream.ingest")
            for g in self.stores:
                inserted[0] += insert_triples(g, triples, dedup=self.dedup,
                                              check_ids=False)
            # migration_sinks() read under the mutation lock this commit
            # holds: an epoch committed during a shard migration's
            # dual-write window reaches the recipient too (no epoch
            # lost). Excluded from the inserted count — the sink is a
            # transient mirror of a store already counted
            for g in migration_sinks():
                insert_triples(g, triples, dedup=self.dedup,
                               check_ids=False)
            return inserted[0]

        with mutation_lock(), activate(trace):
            maybe_wal_append("epoch", triples, self.dedup, ts=ts,
                             epoch=self.epoch + 1)
            if trace is None:
                n_ins = self._commit(_ingest)
            else:
                with trace.span("stream.ingest", n_triples=len(triples)):
                    n_ins = self._commit(_ingest)

            self.epoch += 1
            rec = EpochRecord(
                epoch=self.epoch,
                ts=float(ts) if ts is not None else float(self.epoch),
                n_triples=len(triples), n_inserted=n_ins,
                version=getattr(self.stores[0], "version", 0),
                ingest_us=get_usec() - t0)
            if self.continuous is not None:
                if trace is None:
                    rec.eval_us = self.continuous.on_epoch(
                        self.epoch, triples, rec.ts)
                else:
                    with trace.span("stream.eval", epoch=self.epoch):
                        rec.eval_us = self.continuous.on_epoch(
                            self.epoch, triples, rec.ts)
            # the serving plane's actuator edge (serve/):
            # INSIDE the mutation lock — materialized-view maintenance
            # re-keys surviving result-cache entries atomically with the
            # epoch's version bump (a view is never visible at a version
            # it doesn't match). One knob check when the cache is off.
            from wukong_tpu_torch.serve import notify_mutation

            notify_mutation("epoch", version=rec.version,
                            triples=triples)
        # cache-coherence telemetry (obs/reuse.py): the epoch's version
        # edge kills stale shadow keys + journals cache.invalidate —
        # outside the mutation lock, pure observability
        from wukong_tpu_torch.obs.reuse import maybe_note_invalidation

        maybe_note_invalidation("epoch", version=rec.version,
                                epoch=rec.epoch,
                                n_triples=rec.n_triples)
        if self.monitor is not None:
            self.monitor.record_stream_epoch(
                n_triples=rec.n_triples, ingest_us=rec.ingest_us,
                eval_us=rec.eval_us, lag_us=rec.lag_us)
        _M_EPOCHS.inc()
        _M_TRIPLES.inc(rec.n_triples)
        _M_EVAL.observe(rec.eval_us)
        _M_LAG.observe(rec.lag_us)
        if trace is not None:
            # rec.epoch, not self.epoch: past the mutation lock a racing
            # commit may already have advanced the shared counter (found
            # by the guarded-by gate)
            trace.qid = rec.epoch  # epoch number IS the stream qid
            get_recorder().on_complete(trace)
        self.log.append(rec)
        return rec

    def _commit(self, _ingest) -> int:
        from wukong_tpu_torch.runtime.faults import TransientFault
        from wukong_tpu_torch.runtime.resilience import retry_call

        if self.dedup:
            # idempotent under dedup: a replayed batch re-drops as duplicate
            return retry_call(_ingest, site="stream.ingest",
                              retry_on=(TransientFault, OSError))
        return _ingest()

    def commit_vector_epoch(self, vids, vecs=None,
                            tombstone: bool = False) -> int:
        """Vector-plane sibling of commit_epoch: apply one embedding
        upsert (or tombstone) batch to the same store fan-out this
        ingestor commits triple epochs into. WAL-before-ack, version
        bumps, and serving invalidation all live in upsert_batch_into —
        this seam just keeps stream-fed embeddings and stream-fed triples
        on one target list."""
        from wukong_tpu_torch.vector.vstore import upsert_batch_into

        return upsert_batch_into(self.stores, vids, vecs,
                                 dedup=self.dedup, tombstone=tombstone)

    def ingest(self, source, max_epochs: int | None = None) -> list[EpochRecord]:
        """Drain a TripleSource (or any (ts, batch) iterable) into epochs."""
        out = []
        for ts, batch in source:
            out.append(self.commit_epoch(batch, ts=ts))
            if max_epochs is not None and len(out) >= max_epochs:
                break
        return out
