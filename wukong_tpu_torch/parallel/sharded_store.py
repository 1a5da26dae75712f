"""Sharded device store: per-partition hashed CSR segments stacked over a mesh.

The port's copy of the JAX package's parallel/sharded_store.py. Each worker
partition (GStore) stages its segments like the single-card DeviceStore, in
the 64 B bucket-line form K1 probes (``line_table``), but all shards of a
(pid, dir) segment share one bucket count, probe bound and edge padding, so
the stacked tensors bline [D, NB, 16], bhi [D, NB*4, 2] and edges [D, E_pad]
are uniform across shards. The leading axis is the mesh's shard slots: on
the port's one-device mesh every slot lives on the same card, and shard i
is the contiguous row view ``[i]`` (a table K1 takes as it is) — the device
memory of the reference's per-server gstore region (core/mem.hpp kvstore).

Host fetches go through the resilience layer per shard: the
``dist.shard_fetch`` fault site, retry with backoff, a per-shard circuit
breaker, replica failover with ``replication_factor`` > 1, and the heat
producer ``maybe_charge`` on every fetch outcome. A shard whose fetch fails
with no replica to answer is substituted by empty data and listed in
``degraded_shards``; the engine flags the reply incomplete. A key is staged
once: a thread that misses it while another stages it waits for that
staging (at LUBM-640 two stagings of one segment would double its memory).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from wukong_tpu_torch.analysis.lockdep import declare_leaf, make_lock
from wukong_tpu_torch.engine.device_store import (
    _next_pow2,
    build_hash_table,
    line_table,
)
from wukong_tpu_torch.engine.tpu_kernels import check_table
from wukong_tpu_torch.runtime.transport import make_transport, run_op

INT32_MAX = np.iinfo(np.int32).max

# the migration cutover lock guards the shard->host placement map, the
# read-rotation registry, and the stores[] swap — plain list/dict stores
# only, innermost by construction (breaker/staging work runs outside it)
declare_leaf("migration.cutover")


@dataclass
class StackedSegment:
    bline: torch.Tensor  # int32 [D, NB, 16]: each shard's bucket lines
    bhi: torch.Tensor  # int32 [D, NB*4, 2]: the pairs of lanes 4-7
    edges: torch.Tensor  # int32 [D, E_pad], padded with INT32_MAX
    max_probe: int
    max_deg_log2: int
    avg_deg: float  # global average degree (capacity estimation)
    max_deg: int = 1  # global max degree (skew-aware exchange capacities)
    # VERSATILE combined segments: aligned per-edge predicate ids [D, E_pad]
    edges2: torch.Tensor | None = None

    @property
    def nbytes(self) -> int:
        n = (self.bline.numel() + self.bhi.numel() + self.edges.numel()) * 4
        if self.edges2 is not None:
            n += self.edges2.numel() * 4
        return n

    def shard(self, i: int) -> tuple:
        """Shard i's (bline, bhi, edges[, edges2]) as contiguous row views."""
        out = (self.bline[i], self.bhi[i], self.edges[i])
        return out if self.edges2 is None else out + (self.edges2[i],)


@dataclass
class StackedIndex:
    edges: torch.Tensor  # int32 [D, L_pad], pad INT32_MAX
    real_lens: np.ndarray  # [D] host-side true lengths
    total: int

    @property
    def nbytes(self) -> int:
        return self.edges.numel() * 4


def _exec_local(fn, g):
    """Run a fetch spec against a parent-local store (replica/rotation
    copies): declared ``(op, args)`` tuples through run_op, closures
    directly. Never touches the transport — these copies exist to answer
    when the remote side is gone."""
    if isinstance(fn, tuple):
        return run_op(fn[0], g, *fn[1])
    return fn(g)


class ShardedDeviceStore:
    def __init__(self, stores: list, mesh, axis: str = "x",
                 replication_factor: int | None = None):
        from wukong_tpu_torch.config import Global
        from wukong_tpu_torch.runtime.resilience import CircuitBreaker

        self.stores = stores  # lock-free: slot replacement (rebuild_shard) is a single atomic list-item store; readers see old or new, never torn
        self.mesh = mesh
        self.axis = axis
        self.device = mesh.device
        self.D = len(stores)
        if self.D != mesh.size:
            raise ValueError(f"one partition per shard slot: {self.D} "
                             f"partitions, {mesh.size} slots")
        # staging caches are lock-free by design: engines and the heal
        # watcher race dict get/set/clear, every one an atomic CPython op.
        # The worst interleaving re-stages a segment (idempotent, cached
        # value identical) — taking a lock here would serialize every
        # staged fetch behind the slowest staging
        self._cache: dict = {}  # lock-free: atomic dict ops; a key is staged under its own staging lock
        self._index_cache: dict = {}  # lock-free: atomic dict ops, same contract as _cache
        # key -> the lock of its staging in flight (one staging per key)
        self._staging: dict = {}  # lock-free: setdefault is atomic
        self.bytes_used = 0  # lock-free: advisory accounting (HBM budget report), drift is bounded by one staging
        self._seen_version = self.version()  # lock-free: single int store; a stale read just re-runs check_version
        # resilience: per-shard circuit breaker over host-side fetches, and
        # the set of shards whose data is currently missing from stagings
        # (the dist engine tags replies incomplete while it is non-empty)
        self.breaker = CircuitBreaker()
        self.degraded_shards: set[int] = set()  # lock-free: atomic set add/discard; a stale read only delays healing by one watcher sweep
        # fault tolerance: with replication_factor k > 1 each logical
        # shard's data is mirrored onto its k-1 successor hosts; a failed
        # primary fetch fails over to a replica instead of substituting an
        # empty shard, and failover_shards records primaries currently
        # served by replicas (the recovery manager's rebuild signal)
        k = (Global.replication_factor if replication_factor is None
             else replication_factor)
        self.replication_factor = max(1, min(int(k), self.D))
        # shard -> [(host, GStore)]
        self.replicas: dict[int, list] = {}  # lock-free: whole-dict replacement in refresh_replicas; readers iterate a snapshot reference
        self.failover_shards: set[int] = set()  # lock-free: atomic set ops, same contract as degraded_shards
        # journal-edge dedup for shard.failover/shard.degraded events:
        # dict.setdefault is the atomic test-and-set a plain `in` check
        # is not (two engine threads racing the first replica fetch must
        # not double-journal one outage episode); keys are
        # ("failover", shard, host) — per serving replica, so a
        # mid-episode hop to the next replica is its own edge — and
        # ("degraded", shard), swept by _rearm_events on recovery so the
        # NEXT episode re-emits
        self._event_noted: dict = {}  # lock-free: atomic dict setdefault/pop
        # elastic data plane (runtime/migration.py): shard -> serving host
        # (identity unless a migration moved it) and shard -> demoted
        # donor copies still serving rotated reads (replica-read rotation,
        # ROADMAP follow-up j — the plan's predicted-balance model)
        self._migration_lock = make_lock("migration.cutover")
        self.placement: dict[int, int] = {}  # lock-free: reads are atomic dict gets on the fetch path; writes publish under _migration_lock (cutover/rollback)
        self.rotation: dict[int, list] = {}  # lock-free: fetch-path reads see the old or new list, never torn; writes publish under _migration_lock
        self._rotation_rr: dict[int, int] = {}  # lock-free: racy int bumps only skew the read split by one turn
        # the data plane's remote boundary (runtime/transport.py): named
        # ops route primary fetches through it (loopback executes against
        # the local store — byte-for-byte the single-process behavior; the
        # socket transport sends them to worker processes). Replica and
        # rotation fetches stay parent-local by design: they exist to
        # answer when the remote side is GONE.
        self.transport = make_transport()  # lock-free: whole-reference swap by the supervisor; fetches read it once per attempt
        if self.replication_factor > 1:
            self.refresh_replicas()

    def host_of(self, i: int) -> int:
        """The host serving shard ``i``'s primary (identity until a
        migration moves it)."""
        return int(self.placement.get(int(i), int(i)))

    def refresh_replicas(self) -> None:
        """(Re)clone every shard's replicas from its current primary —
        called at construction and after a checkpoint restore (the old
        clones would otherwise mirror a dead store's state)."""
        from wukong_tpu_torch.store.persist import clone_gstore

        self.replicas = {
            i: [((i + j) % self.D, clone_gstore(self.stores[i]))
                for j in range(1, self.replication_factor)]
            for i in range(self.D)}
        if self.rotation:
            # read-rotation copies (demoted migration donors) mirror the
            # restored primaries too, keeping their hosts. Clones are
            # built OUTSIDE the cutover lock (it guards plain dict/list
            # publications only — a concurrent cutover must never stall
            # behind a deep copy), then published in one swap
            with self._migration_lock:
                snap = {i: [h for (h, _g) in rots]
                        for i, rots in self.rotation.items()}
            rebuilt = {i: [(h, clone_gstore(self.stores[i]))
                           for h in hosts]
                       for i, hosts in snap.items()}
            with self._migration_lock:
                self.rotation = rebuilt

    def invalidate_stagings(self) -> None:
        """Drop every staged segment so the next query re-fetches from the
        host partitions (the kill-and-recover drill's model of losing a
        host: its staged device data dies with it)."""
        self._cache.clear()
        self._index_cache.clear()
        self.bytes_used = 0

    def replica_stores(self) -> list:
        """Every replica GStore plus every read-rotation copy (mutation
        fan-out targets: an insert that reaches a primary must reach its
        mirrors, or failover/rotated reads would serve stale data)."""
        return ([rg for reps in self.replicas.values() for (_h, rg) in reps]
                + [rg for rots in self.rotation.values()
                   for (_h, rg) in rots])

    def rebuild_shard(self, i: int, store=None, source: str = "replica"
                      ) -> bool:
        """Promote a rebuilt partition as shard ``i``'s primary: install
        it, close the breaker, clear the degradation flags, and drop
        stagings so the next query fetches from the healed primary. With
        no explicit ``store`` the first surviving replica is cloned.
        Returns False when there is nothing to rebuild from."""
        from wukong_tpu_torch.obs.metrics import get_registry
        from wukong_tpu_torch.obs.trace import trace_event
        from wukong_tpu_torch.store.persist import clone_gstore

        if store is None:
            reps = self.replicas.get(int(i))
            if not reps:
                return False
            store = clone_gstore(reps[0][1])
        self.stores[int(i)] = store
        self.breaker.record_success(int(i))  # promote: close the breaker
        self.degraded_shards.discard(int(i))
        self.failover_shards.discard(int(i))
        self._rearm_events(int(i))
        self.invalidate_stagings()
        trace_event("shard.rebuild", shard=int(i), source=source)
        from wukong_tpu_torch.obs.events import emit_event
        from wukong_tpu_torch.obs.placement import get_lineage

        emit_event("shard.rebuild", shard=int(i), source=source)
        get_lineage().note_heal(int(i), source=source)
        get_registry().counter(
            "wukong_recovery_rebuilds_total",
            "Failed shards rebuilt and promoted",
            labels=("shard", "source")).labels(shard=int(i),
                                               source=source).inc()
        return True

    def cutover_shard(self, i: int, store, host: int,
                      rotate: bool = False) -> None:
        """Migration read-path cutover (runtime/migration.py, called with
        the WAL mutation lock held so no batch commit straddles the swap):
        install ``store`` as shard ``i``'s primary served from ``host``.
        With ``rotate`` the displaced copy is demoted to a read-rotation
        replica on its old host — reads split across both copies, the
        MigrationPlan's predicted-balance model. Then the failover/rebuild
        promotion mechanics: breaker closed, degradation flags cleared,
        stagings dropped so the next query fetches the new primary."""
        # guarded by: _migration_lock — the swap, placement update, and
        # rotation demotion are one atomic publication to the read path
        i = int(i)
        with self._migration_lock:
            old = self.stores[i]
            old_host = self.placement.get(i, i)
            self.stores[i] = store
            self.placement[i] = int(host)
            if rotate and old is not store:
                # APPEND: a re-migrated shard keeps its earlier rotation
                # copies serving — the advisor's predicted-balance model
                # grows the serving set k -> k+1, and the executed split
                # must match what it scored
                self.rotation[i] = (list(self.rotation.get(i, ()))
                                    + [(int(old_host), old)])
        self.breaker.record_success(i)
        self.degraded_shards.discard(i)
        self.failover_shards.discard(i)
        self._rearm_events(i)
        self.invalidate_stagings()

    def rollback_cutover(self, i: int, donor_store, donor_host) -> None:
        """Migration abort after a published cutover: swap the donor back
        as primary on its old host and drop the rotation demotion (called
        with the WAL mutation lock held, like the cutover itself)."""
        # guarded by: _migration_lock — the rollback is the same atomic
        # read-path publication as the cutover it undoes
        i = int(i)
        with self._migration_lock:
            self.stores[i] = donor_store
            self.placement[i] = int(donor_host if donor_host is not None
                                    else i)
            # drop only the entry the cutover demoted (the donor now
            # reinstated as primary) — earlier migrations' rotation
            # copies keep serving
            rots = [(h, g) for (h, g) in self.rotation.get(i, ())
                    if g is not donor_store]
            if rots:
                self.rotation[i] = rots
            else:
                self.rotation.pop(i, None)
        self.breaker.record_success(i)
        self.invalidate_stagings()

    def version(self) -> int:
        """Max dynamic-insert version across all partitions."""
        return max((getattr(g, "version", 0) for g in self.stores), default=0)

    def check_version(self) -> bool:
        """Drop stale stagings after dynamic inserts (mirrors the single-card
        DeviceStore._check_version). Returns True when caches were
        invalidated, so the engine can also drop what it learned from the
        old segments (capacity classes, in-place memos)."""
        v = self.version()
        if v != self._seen_version:
            self._cache.clear()
            self._index_cache.clear()
            self.bytes_used = 0
            self._seen_version = v
            # stagings are gone, so no staged data is missing any shard;
            # the next staging re-evaluates shard health through the breaker
            # (failover_shards persists — it tracks the primary's health for
            # the recovery manager, not this staging's completeness)
            self.degraded_shards.clear()
            # list() first: setdefault from concurrent fetch threads would
            # otherwise race this iteration into a RuntimeError
            for k in list(self._event_noted):
                if k[0] == "degraded":
                    self._event_noted.pop(k, None)
            return True
        return False

    def _fetch_shard(self, i: int, fn, what: str):
        """One shard's host-side fetch through the resilience layer: the
        ``dist.shard_fetch`` fault site, retry with backoff on transients,
        the per-shard circuit breaker, and — with replication on — failover
        to the shard's successor-host replicas. ``fn`` is either a declared
        transport op as an ``(op, args)`` tuple — the staging paths; the
        primary fetch routes it through ``self.transport``, so in socket
        mode it executes in the shard's worker process — or a plain
        closure ``fn(store)`` (probe/drill paths; always parent-local,
        closures cannot cross a process boundary). The primary is tried
        first, then each replica. Returns
        (value, ok); ok=False means primary AND replicas all failed — the
        caller substitutes empty shard data so the chain routes around the
        shard instead of crashing. A later successful primary
        fetch clears the degraded/failover flags (recovery).

        Observability: when the executing query is traced, each fetch is a
        ``shard.fetch`` span on the ambient trace — retry attempts, breaker
        trips, failovers, and injected fault sites land on it as span
        events (the retry/breaker/fault hooks use the same ambient trace)."""
        from wukong_tpu_torch.obs import trace as obs_trace

        tr = obs_trace.current()
        if tr is None:
            return self._fetch_shard_impl(i, fn, what)
        sp = tr.start_span("shard.fetch", shard=i, what=what)
        try:
            out, ok = self._fetch_shard_impl(i, fn, what)
        except BaseException:
            tr.end_span(sp, ok=False, raised=True)
            raise
        tr.end_span(sp, ok=ok)
        return out, ok

    def _fetch_shard_impl(self, i: int, fn, what: str):
        from wukong_tpu_torch.obs.heat import maybe_charge
        from wukong_tpu_torch.runtime import faults
        from wukong_tpu_torch.runtime.resilience import retry_call
        from wukong_tpu_torch.utils.errors import RetryExhausted, ShardUnavailable
        from wukong_tpu_torch.utils.logger import log_warn
        from wukong_tpu_torch.utils.timer import get_usec

        def attempt():
            faults.site("dist.shard_fetch", shard=i)
            if isinstance(fn, tuple):
                op, args = fn
                return self.transport.fetch(i, self.stores[i], op, args)
            return fn(self.stores[i])

        # heat accounting (obs/heat.py): every fetch outcome charges this
        # shard's counters — fetch kind, payload rows/bytes, wall latency —
        # the access-heat histogram ROADMAP item 3's migration decisions
        # start from. One charge per staging, on the slow host path.
        t0 = get_usec()
        rots = self.rotation.get(i)
        if rots:
            # migrated shard with a demoted donor copy: rotate reads
            # across the serving copies (replica-read rotation) — the
            # executed form of the MigrationPlan's predicted balance. A
            # failed rotation read falls through to the primary path.
            got = self._fetch_rotation(i, rots, fn)
            if got is not None:
                maybe_charge(i, "rotation", got[0], get_usec() - t0)
                return got[0], True
        try:
            out = retry_call(attempt, site=f"dist.shard_fetch[{i}]",
                             retry_on=(faults.TransientFault,),
                             breaker=self.breaker, key=i)
        except (faults.ShardDown, ShardUnavailable, RetryExhausted) as e:
            # the primary is gone for this staging (persistent fault, open
            # breaker, or exhausted retries — retry_call already counted
            # the failure toward the breaker, so repeated stagings trip it
            # and stop touching the shard). With replication, fail over.
            got = self._fetch_failover(i, fn, what)
            if got is not None:
                maybe_charge(i, "failover", got[0], get_usec() - t0)
                return got[0], True
            code = e.code.name if isinstance(e, (ShardUnavailable,
                                                 RetryExhausted)) else str(e)
            log_warn(f"shard {i} unavailable during {what} ({code}) and no "
                     "replica answered; substituting an empty shard — "
                     "results will be flagged incomplete")
            self._mark_degraded(i)
            maybe_charge(i, "degraded", None, get_usec() - t0)
            return None, False
        was_down = i in self.degraded_shards or i in self.failover_shards
        self.degraded_shards.discard(i)
        self.failover_shards.discard(i)
        # recovered: re-arm THIS shard's journal edges for the next
        # episode. Gated on the shard actually having been down — while
        # some other shard's episode holds claims, healthy shards' fetches
        # must stay a set-membership test, not a per-fetch dict scan. A
        # claim minted between the was_down read and the discard is swept
        # by the next successful fetch (the claimant adds to the set
        # right after claiming), so no edge is lost, only deferred.
        if was_down and self._event_noted:
            self._rearm_events(i)
        maybe_charge(i, "primary", out, get_usec() - t0)
        return out, True

    def _fetch_rotation(self, i: int, rots: list, fn):
        """One rotated read: every (1 + len(rots))'th turn belongs to the
        primary (returns None — the caller proceeds down the primary
        path), the rest to a demoted-donor copy via the replica fetch
        machinery (its own ``replica.fetch`` fault site + per-(shard,host)
        breaker key). Returns (value,) on success, None to fall through."""
        from wukong_tpu_torch.runtime import faults
        from wukong_tpu_torch.runtime.resilience import retry_call
        from wukong_tpu_torch.utils.errors import RetryExhausted, ShardUnavailable
        from wukong_tpu_torch.utils.logger import log_warn

        n = len(rots) + 1
        c = self._rotation_rr.get(i, 0)
        self._rotation_rr[i] = c + 1
        turn = c % n
        if turn == 0:
            return None  # the primary's turn in the rotation
        host, rg = rots[turn - 1]

        def attempt(rg=rg, host=host):
            faults.site("replica.fetch", shard=host)
            return _exec_local(fn, rg)

        try:
            out = retry_call(attempt, site=f"rotation.fetch[{i}@{host}]",
                             retry_on=(faults.TransientFault,),
                             breaker=self.breaker, key=(i, host))
        except (faults.ShardDown, ShardUnavailable, RetryExhausted) as e:
            log_warn(f"rotation copy {i}@{host} unavailable "
                     f"({e!r:.80}); serving from the primary")
            return None
        return (out,)

    def _fetch_failover(self, i: int, fn, what: str):
        """Try shard ``i``'s replicas in successor order; returns (value,)
        on the first success (the 1-tuple distinguishes a successful None
        fetch from exhaustion), or None when every replica failed too.
        Replica fetches get their own ``replica.fetch`` fault site and
        their own breaker keys, so a sick replica host is routed around
        independently of its primary."""
        from wukong_tpu_torch.obs.metrics import get_registry
        from wukong_tpu_torch.obs.trace import trace_event
        from wukong_tpu_torch.runtime import faults
        from wukong_tpu_torch.runtime.resilience import retry_call
        from wukong_tpu_torch.utils.errors import RetryExhausted, ShardUnavailable
        from wukong_tpu_torch.utils.logger import log_warn

        for host, rg in self.replicas.get(i, []):
            def attempt(rg=rg, host=host):
                faults.site("replica.fetch", shard=host)
                return _exec_local(fn, rg)

            try:
                out = retry_call(attempt, site=f"replica.fetch[{i}->{host}]",
                                 retry_on=(faults.TransientFault,),
                                 breaker=self.breaker, key=(i, host))
            except (faults.ShardDown, ShardUnavailable, RetryExhausted) as e:
                log_warn(f"replica {i}->{host} unavailable during {what} "
                         f"({e!r:.80}); trying the next replica")
                continue
            # journal the failover on the state EDGE only (the first
            # fetch served by THIS replica, not every staging while the
            # primary stays down — a dead primary under load would churn
            # the bounded ring past the very timeline it preserves);
            # setdefault-with-sentinel is the atomic claim. The claim is
            # per (shard, host): a mid-episode hop to the next replica is
            # its own edge — without it the timeline (and the lineage's
            # failover_host) would keep naming the dead first replica
            tok = object()
            first = self._event_noted.setdefault(("failover", i, host),
                                                 tok) is tok
            self.failover_shards.add(i)
            self.degraded_shards.discard(i)
            self._event_noted.pop(("degraded", i), None)
            trace_event("shard.failover", shard=i, replica=host)
            if first:
                from wukong_tpu_torch.obs.events import emit_event
                from wukong_tpu_torch.obs.placement import get_lineage

                emit_event("shard.failover", shard=i, replica=host,
                           what=what)
                get_lineage().note_failover(i, host)
            get_registry().counter(
                "wukong_failover_total",
                "Shard fetches served by a replica after a primary failure",
                labels=("shard",)).labels(shard=i).inc()
            return (out,)
        return None

    def _rearm_events(self, i: int) -> None:
        """Drop every journal-edge claim for shard ``i`` (failover claims
        are per (shard, host), degraded per shard) so the next outage
        episode journals afresh. list() first: concurrent fetch-thread
        setdefault would race a live iteration into RuntimeError."""
        for k in list(self._event_noted):
            if k[1] == i:
                self._event_noted.pop(k, None)

    def _mark_degraded(self, i: int) -> None:
        from wukong_tpu_torch.obs.events import emit_event
        from wukong_tpu_torch.obs.metrics import get_registry

        # journal on the state edge only (see _fetch_failover)
        tok = object()
        first = self._event_noted.setdefault(("degraded", i), tok) is tok
        self.degraded_shards.add(i)
        if first:
            emit_event("shard.degraded", shard=i)
        get_registry().counter(
            "wukong_shard_fetch_degraded_total",
            "Shard fetches that substituted empty data",
            labels=("shard",)).labels(shard=i).inc()

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """A stacked host array on the mesh's device (every slot's rows)."""
        return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32)
                                ).to(self.device)

    def _once(self, cache: dict, key, build):
        """cache[key], staged by build() on a miss, once: a thread that
        misses the key while another stages it waits for that staging.
        build() returns (value, healthy); only a healthy value is cached."""
        if key in cache:
            return cache[key]
        lock = self._staging.setdefault(key, threading.Lock())
        with lock:
            if key in cache:
                return cache[key]
            val, healthy = build()
            if healthy:
                # degraded stagings are never cached: the next query
                # re-stages, so a recovered shard's data reappears without
                # a version bump
                cache[key] = val
                if val is not None:
                    self.bytes_used += val.nbytes
        self._staging.pop(key, None)
        return val

    def _stack_tables(self, shards: list, with_pids: bool) -> StackedSegment:
        """Stack per-shard CSRs into one segment with a shared bucket count,
        probe bound and edge padding (each shard's table checked once)."""
        max_k = max(len(sh[0]) for sh in shards)
        NB = max(_next_pow2((max_k + 3) // 4), 2)
        Ep = _next_pow2(max(max(len(sh[2]) for sh in shards), 1))
        blines, bhis, edges_l, pids_l = [], [], [], []
        max_probe = 1
        max_deg = 1
        tot_e = tot_k = 0
        for sh in shards:
            k, o, e = sh[0], sh[1], sh[2]
            bk, bs, bd, mp = build_hash_table(np.asarray(k), np.asarray(o),
                                              num_buckets=NB)
            bl, bh = line_table(bk, bs, bd)
            blines.append(bl)
            bhis.append(bh)
            max_probe = max(max_probe, mp)
            if len(k):
                max_deg = max(max_deg, int((o[1:] - o[:-1]).max()))
            tot_e += len(e)
            tot_k += len(k)
            ee = np.full(Ep, INT32_MAX, dtype=np.int32)
            ee[: len(e)] = e
            edges_l.append(ee)
            if with_pids:
                pp = np.full(Ep, INT32_MAX, dtype=np.int32)
                pp[: len(sh[3])] = sh[3]
                pids_l.append(pp)
        seg = StackedSegment(
            bline=self._put(np.stack(blines)),
            bhi=self._put(np.stack(bhis)),
            edges=self._put(np.stack(edges_l)),
            edges2=self._put(np.stack(pids_l)) if with_pids else None,
            max_probe=max_probe,
            max_deg_log2=max(int(max_deg).bit_length(), 1),
            avg_deg=tot_e / max(tot_k, 1),
            max_deg=int(max_deg),
        )
        for i in range(self.D):
            check_table(seg.bline[i], seg.bhi[i])
        return seg

    # ------------------------------------------------------------------
    def segment(self, pid: int, d: int) -> StackedSegment | None:
        self.check_version()
        key = (int(pid), int(d))

        def build():
            empty3 = (np.empty(0, np.int64), np.zeros(1, np.int64),
                      np.empty(0, np.int64))
            shards = []
            healthy = True
            for i in range(self.D):
                got, ok = self._fetch_shard(i, ("segment", key),
                                            f"segment({pid},{d})")
                healthy &= ok
                shards.append(got if ok else empty3)
            if all(len(k) == 0 for (k, _, _) in shards):
                return None, healthy
            return self._stack_tables(shards, with_pids=False), healthy
        return self._once(self._cache, key, build)

    def versatile_segment(self, d: int) -> StackedSegment | None:
        """Per-shard COMBINED adjacency of direction d, stacked over the
        mesh: every (predicate, neighbor) pair keyed by vid (the device form
        of the VERSATILE vp lists — see DeviceStore.versatile_segment). The
        distributed expand_versatile step probes it and binds both the
        predicate and the neighbor column; the reference never accelerates
        any versatile shape (gpu_engine.hpp:267-333)."""
        self.check_version()
        key = ("vpv", int(d))

        def build():
            empty4 = (np.empty(0, np.int64), np.zeros(1, np.int64),
                      np.empty(0, np.int64), np.empty(0, np.int64))
            shards = []
            healthy = True
            for i in range(self.D):
                got, ok = self._fetch_shard(
                    i, ("versatile", (int(d),)), f"versatile_segment({d})")
                healthy &= ok
                shards.append(got if ok else empty4)
            if all(len(k) == 0 for (k, _, _, _) in shards):
                return None, healthy
            return self._stack_tables(shards, with_pids=True), healthy
        return self._once(self._cache, key, build)

    def host_max_deg(self, pid: int, d: int) -> int:
        """Global max degree of (pid, d) from host CSR metadata — no device
        staging (capacity estimation reads only this scalar)."""
        md = 0
        for g in self.stores:
            host = g.segments.get((int(pid), int(d)))
            if host is not None and len(host.offsets) > 1:
                md = max(md, int(np.diff(host.offsets).max()))
        return max(md, 1)

    # ------------------------------------------------------------------
    def index_list(self, tpid: int, d: int) -> StackedIndex:
        self.check_version()
        key = (int(tpid), int(d))

        def build():
            lists = []
            healthy = True
            for i in range(self.D):
                got, ok = self._fetch_shard(
                    i, ("index", (int(tpid), int(d))),
                    f"index_list({tpid},{d})")
                healthy &= ok
                lists.append(got if ok else np.empty(0, np.int32))
            L = _next_pow2(max(max((len(x) for x in lists), default=1), 1))
            stacked = np.full((self.D, L), INT32_MAX, dtype=np.int32)
            for i, x in enumerate(lists):
                stacked[i, : len(x)] = x
            return StackedIndex(
                edges=self._put(stacked),
                real_lens=np.asarray([len(x) for x in lists], dtype=np.int64),
                total=int(sum(len(x) for x in lists))), healthy
        return self._once(self._index_cache, key, build)
