"""Distributed generic join: the WCOJ fan-out over a sharded store.

The port's copy of the JAX package's join/dist.py. The first eliminated
variable's candidate set is hash-partitioned into S slices, and each slice runs the ordinary
level-at-a-time WCOJ executor over a *federated* read view of the host
partitions — the per-slice level-0 filter makes the slices disjoint, later
levels only ever consume their own prefix rows, so the union of the S
slice results is exactly the unpartitioned result.

The fan-out rides the heavy lane machinery: slices are fire-and-forget
pool items (``lane="heavy"``, claim-once, ``run``/``fail_all`` contract)
behind a gather barrier on the dispatching thread, which contributes slice
0 itself, claims stragglers the pool never picked up, and re-runs a failed
slice inline — per-slice fallback, so one injected ``join.slice`` fault (or
a dead engine) costs one inline retry, never the query. Deadline and row
budget are SHARED across slices (one query, one budget — the heavy lane's
``_carrier`` discipline): a structured expiry in any slice surfaces as the
query's own structured partial, and every slice sees the charge.

Sorted edge tables are materialized ONCE into a shared
:class:`~wukong_tpu_torch.join.wcoj.JoinTableCache` over the
:class:`ShardedJoinView` (merged per-(pid, dir) CSR segments, keyed on the
summed store versions so any shard's mutation invalidates), and the warm
pass runs on the gather thread BEFORE the fan-out — the
``join.materialize`` fault site therefore still fires with the query
untouched, preserving the degrade-to-walk posture.

Each slice runs the port's ``WCOJExecutor`` on the executor's device, so a
device-routed level launches ``level_probe`` (csrc/level_probe.cu) on the
card; ``device="cpu"`` runs the plain versions.
"""

from __future__ import annotations

import numpy as np

from wukong_tpu_torch.analysis.lockdep import declare_leaf, make_lock
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.join.wcoj import WCOJExecutor
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.runtime import faults
from wukong_tpu_torch.runtime.resilience import check_query
from wukong_tpu_torch.sparql.ir import SPARQLQuery
from wukong_tpu_torch.store.segment import CSRSegment
from wukong_tpu_torch.utils.errors import (
    BudgetExceeded,
    ErrorCode,
    QueryTimeout,
    WukongError,
)
from wukong_tpu_torch.utils.logger import log_warn

_M_DIST_DISPATCH = get_registry().counter(
    "wukong_join_dist_dispatch_total",
    "Distributed-join dispatches", labels=("mode",))
_M_DIST_SLICES = get_registry().counter(
    "wukong_join_dist_slices_total",
    "Partition slices fanned out by distributed joins")
_M_DIST_FALLBACK = get_registry().counter(
    "wukong_join_dist_fallback_total",
    "Distributed-join degradations", labels=("reason",))

# the slice claim flag is a pure check-and-set under its own lock (the
# batcher's _HeavySlice discipline) — innermost, nothing acquired under it
declare_leaf("join.slice")
# the federated view's version/memo bookkeeping: pure data-structure
# work (per-shard dict reads + the CSR merge), nothing acquired under it
declare_leaf("join.view")

# reuse the heavy lane's gather tuning: the pool pops within ~ms when
# healthy, and a wedged claimed slice must not strand the barrier
from wukong_tpu_torch.runtime.batcher import (  # noqa: E402
    HEAVY_GATHER_WAIT_S,
    SLICE_CLAIM_GRACE_S,
)


class _MergedSegments:
    """``.get((pid, d))`` facade producing one global CSR per adjacency:
    per-shard segments concatenated, lexsorted by (key, edge), exact
    duplicate pairs dropped (replicated shards must not double-count an
    edge). The partitioning invariant (each vertex's full adjacency lives
    on its owner) makes the merge a disjoint-key union."""

    def __init__(self, view: "ShardedJoinView"):
        self._view = view

    def get(self, key):
        return self._view._merged_segment(*key)


class ShardedJoinView:
    """Read-only gstore facade over a sharded store's host partitions for
    the join table cache: merged segments, concatenated index lists, and a
    version that bumps whenever ANY shard mutates OR a shard slot is
    replaced wholesale. The LIVE list object is held by reference (never
    copied): a migration cutover / recovery rebuild assigns
    ``sstore.stores[i] = new_store`` in place, and the next version read
    must see the replacement — a copied list would serve retired shard
    data forever with status SUCCESS."""

    def __init__(self, stores: list):
        self._source = stores  # the sharded store's own list, by reference
        self.segments = _MergedSegments(self)
        # one lock guards the version bookkeeping AND the memo: the view
        # is shared by every serving thread through the proxy's single
        # DistributedWCOJExecutor, and an unguarded check-then-install
        # could memoize a pre-mutation merged segment under the
        # post-mutation version key. Pure data-structure work inside —
        # nothing is ever acquired under it.
        self._lock = make_lock("join.view")
        self._memo: dict = {}  # guarded by: _lock
        self._memo_ver = None  # guarded by: _lock
        # per-slot generation counters: a slot's counter bumps whenever
        # the object in that slot is REPLACED (identity change against
        # the held current reference). Monotone and allocation-immune —
        # id() of a GC'd retired store can be reused by a fresh store at
        # an equal version int, which would leave an id()-based key
        # unchanged; the generation counter cannot repeat.
        self._seen = list(stores)  # guarded by: _lock
        self._gen = [0] * len(stores)  # guarded by: _lock

    @property
    def stores(self) -> list:
        return list(self._source)  # snapshot per read, source stays live

    def _version_locked(self) -> int:
        cur = list(self._source)
        if len(cur) != len(self._seen):  # unguarded: caller holds _lock (version property / _merged_segment)
            self._seen = list(cur)  # unguarded: caller holds _lock
            grown = [g + 1 for g in self._gen[: len(cur)]]  # unguarded: caller holds _lock
            self._gen = grown + [0] * (len(cur) - len(grown))  # unguarded: caller holds _lock
        else:
            for i, st in enumerate(cur):
                if st is not self._seen[i]:  # unguarded: caller holds _lock
                    self._gen[i] += 1  # unguarded: caller holds _lock
                    self._seen[i] = st  # unguarded: caller holds _lock
        return hash(tuple(
            (g, int(getattr(st, "version", 0)))
            for g, st in zip(self._gen, cur)))  # unguarded: caller holds _lock

    @property
    def version(self) -> int:
        """Cache key: per-slot (generation, store version) pairs hashed
        to one int — a dynamic insert bumps a store's version, a
        cutover/rebuild swaps the store object itself (bumping that
        slot's generation); either changes the key, so the table cache
        and the merged-segment memo can never serve a retired shard's
        data."""
        with self._lock:
            return self._version_locked()

    def _merged_segment(self, pid: int, d: int):
        with self._lock:
            # version read, memo probe, build, and install are ONE
            # critical section: a concurrent mutation's version bump can
            # then never interleave an old build under a new key (the
            # build serializes per view — one-time work per version)
            ver = self._version_locked()
            if ver != self._memo_ver:
                self._memo.clear()
                self._memo_ver = ver
            key = (int(pid), int(d))
            got = self._memo.get(key)
            if got is not None:
                return got
            parts = [st.segments.get(key) for st in self._source]
            parts = [p for p in parts if p is not None and len(p.edges)]
            if not parts:
                return None
            keys = np.concatenate([np.repeat(p.keys, np.diff(p.offsets))
                                   for p in parts])
            edges = np.concatenate([np.asarray(p.edges, dtype=np.int64)
                                    for p in parts])
            order = np.lexsort((edges, keys))
            k2, e2 = keys[order], edges[order]
            keep = np.ones(len(k2), dtype=bool)
            keep[1:] = (k2[1:] != k2[:-1]) | (e2[1:] != e2[:-1])
            merged = CSRSegment.from_sorted_pairs(k2[keep], e2[keep])
            self._memo[key] = merged
            return merged

    def get_index(self, tpid: int, d: int) -> np.ndarray:
        """Global index list: each member lives on exactly one shard, so
        concatenation is a disjoint union (the cache sorts/uniques it)."""
        parts = [np.asarray(st.get_index(tpid, d), dtype=np.int64)
                 for st in self.stores]
        return np.concatenate(parts) if parts else np.empty(0, np.int64)


class _JoinSlice:
    """One hash-partition slice of a distributed join: a fire-and-forget
    heavy-lane pool item claimable exactly once (the gather thread runs
    stragglers inline without double execution; a pool engine popping an
    already-claimed slice no-ops). Engine-thread death reaches
    :meth:`fail_all` via the scheduler's death handler, so the gather
    barrier always wakes."""

    lane = "heavy"

    __slots__ = ("exec", "q", "qg", "unary", "S", "k", "carrier",
                 "event", "error", "_claim_lock", "_claimed")

    def __init__(self, executor: "DistributedWCOJExecutor", q, qg, unary,
                 S: int, k: int):
        import threading

        self.exec = executor
        self.q = q
        self.qg = qg
        self.unary = unary
        self.S = S
        self.k = k
        self.carrier: SPARQLQuery | None = None
        self.event = threading.Event()
        self.error: BaseException | None = None
        self._claim_lock = make_lock("join.slice")
        self._claimed = False  # guarded by: _claim_lock

    def claim(self) -> bool:
        with self._claim_lock:
            if self._claimed:
                return False
            self._claimed = True
            return True

    def run(self, engine=None) -> None:
        """Pool-engine entry (and the gather thread's inline entry)."""
        if not self.claim():
            return
        self._execute()

    def _execute(self) -> None:
        ok = False
        try:
            self.carrier = self.exec._run_slice(self.q, self.qg, self.unary,
                                                self.S, self.k)
            ok = True
        except BaseException as e:
            self.error = e
        finally:
            if not ok and self.error is None:
                self.error = RuntimeError("join slice aborted")
            self.event.set()

    def fail_all(self, exc: BaseException) -> None:
        """Scheduler death-handler / dead-pool contract."""
        if not self.event.is_set():
            self.error = exc
            self.event.set()

    def retry_inline(self) -> None:
        """Per-slice fallback: one inline re-run on the gather thread."""
        self.error = None
        self._execute()


class DistributedWCOJExecutor(WCOJExecutor):
    """WCOJ over a sharded store: hash-partition the first eliminated
    variable into S slices and fan the per-partition executions out on the
    heavy lane, gathering the disjoint slice tables into one result.

    ``pool`` is the host engine pool (or a zero-arg callable returning
    one/None); with no pool the slices run sequentially on the calling
    thread — same rows, no parallelism. The executor keeps the full
    degradable contract of its base class: any failure RAISES with ``q``
    untouched so the proxy re-dispatches to the (distributed) walk.
    """

    def __init__(self, stores: list, str_server=None, stats=None, pool=None,
                 device="cuda"):
        super().__init__(ShardedJoinView(stores), str_server, stats,
                         device=device)
        self._pool = pool
        self.D = len(stores)

    def _pool_obj(self):
        return self._pool() if callable(self._pool) else self._pool

    def _parts(self) -> int:
        """Fan-out width: join_dist_parts, bounded by the shard count and
        the pool's live engines (a dead pool degrades to 1, not to an
        error)."""
        cap = max(int(Global.join_dist_parts), 1)
        pool = self._pool_obj()
        alive = pool.alive_count() if pool is not None else 1
        return max(min(cap, self.D, max(alive, 1)), 1)

    # ------------------------------------------------------------------
    def run_bgp(self, q) -> None:
        qg, unary = self._analyze_and_warm(q)  # fault sites fire HERE
        S = self._parts()
        if S <= 1:
            _M_DIST_DISPATCH.labels(mode="single").inc()
            return self._run_levels(q, qg, unary)
        _M_DIST_DISPATCH.labels(mode="split").inc()
        _M_DIST_SLICES.inc(S)
        slices = [_JoinSlice(self, q, qg, unary, S, k) for k in range(S)]
        pool = self._pool_obj()
        for s in slices[1:]:
            try:
                pool.submit(s, lane="heavy")
            except Exception:
                pass  # claimed and run inline below
        slices[0].run(None)  # the gather thread works its own share first
        for s in slices[1:]:
            if not s.event.wait(SLICE_CLAIM_GRACE_S):
                if s.claim():  # not started yet: run the straggler inline
                    s._execute()
                elif not s.event.wait(HEAVY_GATHER_WAIT_S):
                    raise WukongError(
                        ErrorCode.UNKNOWN_PATTERN,
                        "join gather barrier timed out on a claimed slice")
        structured = None
        for s in slices:
            if isinstance(s.error, (QueryTimeout, BudgetExceeded)):
                # shared-deadline expiry: the query's own structured
                # degradation, not a slice infrastructure failure — keep
                # settling the other slices, then commit what completed
                structured = s.error
                continue
            if s.error is not None:
                # per-slice fallback: one inline retry on the gather
                # thread; a second failure degrades the whole query to
                # the walk via the caller's error path
                _M_DIST_FALLBACK.labels(reason="slice_retry").inc()
                log_warn(f"join slice {s.k}/{s.S} failed "
                         f"({s.error!r:.120}); re-running inline")
                s.retry_inline()
                if isinstance(s.error, (QueryTimeout, BudgetExceeded)):
                    structured = s.error
                    continue
                if s.error is not None:
                    _M_DIST_FALLBACK.labels(reason="slice_error").inc()
                    raise WukongError(
                        ErrorCode.UNKNOWN_PATTERN,
                        f"join slice failed twice: {s.error!r:.120}")
        cols = {v: i for i, v in enumerate(qg.order)}
        if structured is None:
            try:
                # a deadline expiring AT the gather barrier takes the
                # same partial-commit path as an in-slice expiry — the
                # full result may be sitting in the carriers
                check_query(q, "join.gather")
            except (QueryTimeout, BudgetExceeded) as e:
                structured = e
        if structured is not None:
            # structured expiry: commit the COMPLETED slices' (full-width,
            # disjoint) tables as the partial result before raising — the
            # base-class posture, 'expiry commits the prefix built so
            # far'; an expired slice's own partial prefix has fewer
            # columns and cannot join the gathered table
            done = [s.carrier for s in slices
                    if s.error is None and s.carrier is not None]
            tables = [c.result.table for c in done]
            prefix = self._settle(tables, len(qg.order), q)
            levels = (self._merge_levels([c.join_stats for c in done])
                      if done else [])
            self._commit(q, prefix, cols, levels, partial=True)
            raise structured
        # gather: slice tables are disjoint by the level-0 hash partition;
        # concatenation in slice order is the canonical gathered order
        tables = [s.carrier.result.table for s in slices]
        prefix = self._settle(tables, len(qg.order), q)
        levels = self._merge_levels([s.carrier.join_stats for s in slices])
        self._commit(q, prefix, cols, levels, partial=False)
        q.join_dist = {"slices": S}

    # ------------------------------------------------------------------
    def _settle(self, tables: list, width: int, q=None) -> np.ndarray:
        """Gather-barrier slice settlement: the per-slice result tables
        concatenate on the executor's device (join.kernels.
        concat_rows_padded) when the ``template_device`` knob allows and
        the gathered volume amortizes it — the host ``np.concatenate`` in
        slice order, row for row. A structured failure (an id outside
        int32) latches host for this executor; any other error reaches
        the caller."""
        tables = [t for t in tables if t is not None]
        if not tables:
            return np.empty((0, width), dtype=np.int64)
        knob = str(Global.template_device).strip().lower()
        total = sum(len(t) for t in tables)
        if (knob == "host" or len(tables) < 2 or width < 1 or total == 0
                or getattr(self, "_settle_broken", False)
                or (knob != "device"
                    and total < max(int(Global.template_min_rows), 1))):
            return np.concatenate(tables)
        from wukong_tpu_torch.join.kernels import (
            DeviceRangeError,
            concat_rows_padded,
            pad_pow2,
            to_device_i32,
        )
        try:
            from wukong_tpu_torch.obs.device import maybe_device_dispatch
            from wukong_tpu_torch.utils.timer import get_usec

            S = len(tables)
            cap = pad_pow2(max(len(t) for t in tables))
            st = np.zeros((S, cap, width), dtype=np.int64)
            counts = np.zeros(S, dtype=np.int64)
            for i, t in enumerate(tables):
                st[i, :len(t)] = t
                counts[i] = len(t)
            t0 = get_usec()
            rows, valid, _tot = concat_rows_padded(
                to_device_i32(st, self.device),
                to_device_i32(counts, self.device))
            out = rows[valid].cpu().numpy().astype(np.int64)
            rec = maybe_device_dispatch(
                "dist.settle", template=f"s{S}w{width}", live=total,
                capacity=S * cap, wall_us=get_usec() - t0,
                nbytes=int(st.nbytes // 2) + int(out.nbytes))
            if rec is not None and q is not None:
                dev = getattr(q, "device_steps", None)
                if dev is None:
                    dev = q.device_steps = []
                dev.append(rec)
            return out
        except DeviceRangeError as e:
            self._settle_broken = True
            log_warn(f"device slice settlement degraded to host: {e!r}")
            return np.concatenate(tables)

    # ------------------------------------------------------------------
    def _run_slice(self, q, qg, unary, S: int, k: int) -> SPARQLQuery:
        """One partition's WCOJ on a lightweight carrier sharing the
        parent's (read-only) planned patterns, deadline/budget, and the
        executor's materialized table cache."""
        faults.site("join.slice", shard=k)
        carrier = SPARQLQuery()
        carrier.pattern_group = q.pattern_group
        carrier.deadline = getattr(q, "deadline", None)
        carrier.join_route = self._route_for(q)
        carrier.result.blind = False  # the slice table IS the payload
        ex = WCOJExecutor(self.g, self.str_server, stats=self.stats,
                          tables=self.tables, part=(S, k), device=self.device)
        ex._run_levels(carrier, qg, unary)
        return carrier

    @staticmethod
    def _merge_levels(per_slice: list) -> list:
        """Per-level stats summed across slices (rows/candidates add; the
        wall is the slowest slice — the gather critical path)."""
        merged: list[dict] = []
        for lvs in zip(*per_slice):
            rec = dict(lvs[0])
            rec["rows_in"] = sum(lv["rows_in"] for lv in lvs)
            rec["rows_out"] = sum(lv["rows_out"] for lv in lvs)
            rec["candidates"] = sum(lv["candidates"] for lv in lvs)
            rec["time_us"] = max(lv["time_us"] for lv in lvs)
            rec["slices"] = len(lvs)
            merged.append(rec)
        return merged
