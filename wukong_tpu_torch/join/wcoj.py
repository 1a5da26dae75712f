"""Leapfrog-Triejoin-style worst-case-optimal executor (the ``wcoj`` strategy).

The port's copy of the JAX package's join/wcoj.py. Executes a planned BGP
level-at-a-time in the query graph's variable elimination order
(qgraph.py): each level materializes ONE variable, with every incident
pattern constraining the candidate set *at that level* — per-row adjacency
expansion from the cheapest bound anchor, sorted-set intersection of the
global candidate lists (type/predicate indexes, const neighbor lists), and
ragged binary-search probes for the remaining bound edges. Intermediates
are therefore bounded by the join's fragment size, not by the walk's wedge
blowup.

Edge tables are the store's own CSR segments, verified-sorted once and
cached per store version (:class:`JoinTableCache`). Materialization is a
``join.materialize`` fault site — an injected failure surfaces BEFORE the
query result is touched, so the proxy degrades the query to the walk.

Resilience parity with the walk: the per-query deadline is checked and the
row budget charged at every level; expiry commits the prefix built so far
as a structured partial result (``result.complete = False``).

Level routes (``join_device`` knob): each level's probe phase runs either
on the NumPy host kernels or, on the device route, as ONE
:func:`~wukong_tpu_torch.join.kernels.level_probe` launch per generator
group over a padded flat candidate tensor on the executor's device (the
hand-written CUDA kernel on the card, its plain PyTorch version on a CPU
executor), with int32 copies of the sorted tables cached per store version
next to their host twins. The two routes are byte-identical by
construction. A device level that cannot run — an id or offset outside
int32 (:class:`DeviceRangeError`, reason ``int32_range``), a structured
WukongError, an injected fault — degrades to the host kernels and latches
host for the rest of the query, as in the JAX executor. Unlike the JAX
executor's, the port's device path does NOT catch other exceptions: an
error from building or launching the CUDA kernel, or a CUDA runtime error,
reaches the caller, so a broken kernel never hides behind a quiet host
level.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from wukong_tpu_torch.analysis.lockdep import declare_leaf, make_lock
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine.tpu_kernels import upload
from wukong_tpu_torch.join.kernels import (
    DeviceRangeError,
    check_i32,
    expand_ragged,
    intersect_many,
    keys_index,
    level_probe,
    lookup_ranges,
    member_sorted,
    pad_pow2,
    pair_member,
    to_device_i32,
)
from wukong_tpu_torch.join.qgraph import U_CONST, U_PINDEX, U_TYPE, analyze
from wukong_tpu_torch.obs.device import (
    maybe_device_dispatch,
    maybe_device_resident,
)
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.obs.trace import traced_execute
from wukong_tpu_torch.runtime import faults
from wukong_tpu_torch.runtime.resilience import (
    charge_query,
    check_query,
    mark_partial,
)
from wukong_tpu_torch.store.segment import CSRSegment
from wukong_tpu_torch.types import IN, OUT
from wukong_tpu_torch.utils.device import resolve_device
from wukong_tpu_torch.utils.errors import (
    BudgetExceeded,
    ErrorCode,
    QueryTimeout,
    WukongError,
)
from wukong_tpu_torch.utils.timer import get_usec

_M_MATERIALIZE = get_registry().counter(
    "wukong_join_materialize_total",
    "WCOJ sorted-edge-table cache requests", labels=("outcome",))
# device-route observability (README metrics table): which route each
# level's probe phase actually took, why device levels degraded to host,
# and the per-dispatch candidate volume (the dispatch-amortization
# feedback loop behind join_device_min_candidates)
_M_DEVICE_LEVELS = get_registry().counter(
    "wukong_join_device_levels_total",
    "WCOJ level probe phases by executed route", labels=("route",))
_M_DEVICE_FALLBACK = get_registry().counter(
    "wukong_join_device_fallback_total",
    "Device-route levels degraded to the host kernels", labels=("reason",))
_M_DEVICE_CAND = get_registry().histogram(
    "wukong_join_device_candidates",
    "Candidates per device-probed level",
    buckets=(1 << 10, 1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20,
             1 << 22, 1 << 24))

# the cache lock guards pure dict moves (materialization happens outside
# it); nothing is ever acquired under it
declare_leaf("join.tables")


def _verify_sorted_segment(seg: CSRSegment) -> CSRSegment:
    """Return ``seg`` with edges guaranteed sorted within each key run.

    CSR construction emits this invariant; a defensive verify keeps the
    probe kernels' binary-search contract independent of future store
    writers. O(E) check, re-sort only on violation.
    """
    e, off = seg.edges, seg.offsets
    if len(e) > 1:
        inc = e[1:] >= e[:-1]
        inc[off[1:-1] - 1] = True  # run boundaries may descend
        if not bool(inc.all()):
            keys = np.repeat(seg.keys, np.diff(off))
            order = np.lexsort((e, keys))
            return CSRSegment.from_sorted_pairs(keys[order], e[order])
    return seg


def _sorted_index(arr) -> np.ndarray:
    a = np.asarray(arr, dtype=np.int64)
    if len(a) > 1 and not bool((a[1:] >= a[:-1]).all()):
        a = np.unique(a)
    return a


class JoinTableCache:
    """Per-store cache of verified-sorted edge tables and index lists.

    Keys carry the store version, so mutations (dynamic inserts, stream
    commits) make stale entries unreachable — the plan-cache invalidation
    pattern. Bounded LRU of ``join_table_cache`` entries. Materialization
    (the verify/re-sort pass) runs OUTSIDE the lock behind the
    ``join.materialize`` fault site; a duplicate concurrent build is
    idempotent and the second writer simply refreshes the entry.
    """

    def __init__(self, gstore, device="cuda"):
        self.g = gstore
        self.device = resolve_device(device)  # where device_tables() stages
        self._tables: OrderedDict = OrderedDict()  # guarded by: _lock
        self._lock = make_lock("join.tables")

    def _version(self) -> int:
        return int(getattr(self.g, "version", 0))

    def _get(self, key):
        with self._lock:
            v = self._tables.get(key)
            if v is not None:
                self._tables.move_to_end(key)
            return v

    @staticmethod
    def _dev_nbytes(key, value) -> int:
        """Device-resident bytes of one cache entry (0 for host-side
        segments/indexes — only ``dseg`` tuples live on the device)."""
        if key[1] != "dseg":
            return 0
        return sum(int(getattr(a, "nbytes", 0))
                   for a in value[:3] + value[4:])

    def _put(self, key, value):
        evicted = []
        stale = []
        with self._lock:
            version = key[0]
            if key[1] == "dseg":
                # reap device tables a store-version bump orphaned: their
                # keys can never hit again, but their HBM bytes would
                # otherwise linger until LRU churn found them
                stale = [k for k in self._tables
                         if k[1] == "dseg" and k[0] != version]
                stale_bytes = sum(self._dev_nbytes(k, self._tables.pop(k))
                                  for k in stale)
            self._tables[key] = value
            self._tables.move_to_end(key)
            cap = max(int(Global.join_table_cache), 1)
            while len(self._tables) > cap:
                evicted.append(self._tables.popitem(last=False))
        # residency charges OUTSIDE the cache lock (both are leaves)
        if stale:
            maybe_device_resident("invalidate", "join_table", stale_bytes,
                                  version=int(version))
        fill = self._dev_nbytes(key, value)
        if fill:
            maybe_device_resident("fill", "join_table", fill)
        for k, v in evicted:
            ev = self._dev_nbytes(k, v)
            if ev:
                maybe_device_resident("evict", "join_table", ev)
        return value

    def segment(self, pid: int, d: int) -> CSRSegment:
        """The (pid, dir) adjacency as a verified-sorted CSR segment."""
        key = (self._version(), "seg", int(pid), int(d))
        hit = self._get(key)
        if hit is not None:
            _M_MATERIALIZE.labels(outcome="hit").inc()
            return hit
        _M_MATERIALIZE.labels(outcome="miss").inc()
        faults.site("join.materialize")
        seg = self.g.segments.get((int(pid), int(d)))
        seg = (CSRSegment.empty() if seg is None
               else _verify_sorted_segment(seg))
        return self._put(key, seg)

    def index_list(self, tpid: int, d: int) -> np.ndarray:
        """A type/predicate index as a sorted unique id array."""
        key = (self._version(), "idx", int(tpid), int(d))
        hit = self._get(key)
        if hit is not None:
            _M_MATERIALIZE.labels(outcome="hit").inc()
            return hit
        _M_MATERIALIZE.labels(outcome="miss").inc()
        faults.site("join.materialize")
        return self._put(key, _sorted_index(self.g.get_index(tpid, d)))

    def neighbor_list(self, const: int, pid: int, d: int) -> np.ndarray:
        """One constant's neighbor list (sorted — a CSR edge run)."""
        # uncached: the segment lookup is already one binary search, and
        # per-const keys would churn the bounded cache under template mixes
        return np.asarray(self.segment(pid, d).lookup(const), dtype=np.int64)

    def device_tables(self, pid: int, d: int):
        """The (pid, dir) adjacency as int32 tensors on the cache's device
        (keys, offsets, edges, depth, index) for the level probe — built
        from the verified-sorted host segment and cached per store version
        like every other entry, so mutations self-invalidate and
        steady-state device levels never re-ship tables. ``depth`` is the
        segment's binary-search iteration bound (log2(max_degree)+1 — a
        probe range is one key's edge run, never the whole edge array);
        ``index`` the keys' dense index for the probe kernel
        (:func:`~wukong_tpu_torch.join.kernels.keys_index`, built here
        once with the table; None on the CPU or for sparse keys). Raises
        :class:`DeviceRangeError` (caller degrades to host) when any
        value exceeds int32."""
        key = (self._version(), "dseg", int(pid), int(d))
        hit = self._get(key)
        if hit is not None:
            _M_MATERIALIZE.labels(outcome="hit").inc()
            return hit
        _M_MATERIALIZE.labels(outcome="miss").inc()
        seg = self.segment(pid, d)  # host twin first (verify + fault site)
        max_deg = (int(np.diff(seg.offsets).max())
                   if len(seg.offsets) > 1 else 0)
        keys = to_device_i32(seg.keys, self.device)
        return self._put(key, (keys,
                               to_device_i32(seg.offsets, self.device),
                               to_device_i32(seg.edges, self.device),
                               max(max_deg, 1).bit_length() + 1,
                               keys_index(seg.keys, keys)))

    def clear(self) -> None:
        with self._lock:
            dev = sum(self._dev_nbytes(k, v)
                      for k, v in self._tables.items())
            self._tables.clear()
        if dev:
            maybe_device_resident("invalidate", "join_table", dev)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._tables)}


class WCOJExecutor:
    """Worst-case-optimal BGP execution over one (host) partition.

    ``stats`` (the optimizer's type-centric statistics) refines the
    variable elimination order; without it the analyzer falls back to
    structural heuristics. FILTER evaluation and final processing are
    delegated to the CPU engine's stages so string/DISTINCT/ORDER semantics
    can never drift between strategies. The device route runs on the card
    by default; ``device="cpu"`` runs the plain PyTorch versions.
    """

    def __init__(self, gstore, str_server=None, stats=None, tables=None,
                 part=None, device="cuda"):
        self.g = gstore
        self.str_server = str_server
        self.stats = stats
        # the device route's tensors live here (the proxy's device)
        self.device = resolve_device(device)
        # ``tables`` lets several executors share ONE materialized cache
        self.tables = (tables if tables is not None
                       else JoinTableCache(gstore, self.device))
        # ``part`` = (S, k): keep only level-0 candidates whose hash lands
        # in partition k of S — the distributed generic join's split of the
        # first eliminated variable (join/dist.py's slices; None runs the
        # whole join)
        self.part = part

    # ------------------------------------------------------------------
    def execute(self, q, from_proxy: bool = True):
        """Engine-contract execution: failures land as reply status codes,
        never as raised WukongErrors (CPUEngine parity)."""
        try:
            return self.try_execute(q, from_proxy)
        except WukongError as e:
            q.result.status_code = e.code
            return q

    def try_execute(self, q, from_proxy: bool = True):
        """Degradable execution: a failure in the join phase RAISES with
        ``q`` untouched, so the caller (the proxy's strategy router) can
        re-dispatch the same query to the walk. Structured deadline/budget
        expiry still commits a partial result, and a FILTER/FINAL-stage
        failure after the join committed sets the reply status (those are
        query-semantic — the walk would fail them identically)."""
        return traced_execute(
            q, "wcoj.execute", lambda: self._try_impl(q, from_proxy),
            lambda: {"rows": q.result.nrows,
                     "status": q.result.status_code.name})

    def _try_impl(self, q, from_proxy: bool):
        try:
            self.run_bgp(q)
        except (QueryTimeout, BudgetExceeded) as e:
            mark_partial(q, e)
            return q
        try:
            if q.pattern_group.filters:
                self._cpu()._execute_filters(q)
            if from_proxy:
                self._cpu()._final_process(q)
        except (QueryTimeout, BudgetExceeded) as e:
            mark_partial(q, e)
        except WukongError as e:
            q.result.status_code = e.code
        return q

    def _cpu(self):
        from wukong_tpu_torch.engine.cpu import CPUEngine

        return CPUEngine(self.g, self.str_server)

    # ------------------------------------------------------------------
    def run_bgp(self, q) -> None:
        """Generic join over the BGP. Commits into ``q.result`` only on
        success or on a structured deadline/budget expiry (partial prefix);
        any other failure leaves ``q`` untouched so the caller can degrade
        to the walk."""
        qg, unary_lists = self._analyze_and_warm(q)
        self._run_levels(q, qg, unary_lists)

    def _analyze_and_warm(self, q):
        """Shape checks + up-front materialization of every backing array.
        The ``join.materialize`` fault site fires here, before ``q`` is
        touched — and before the distributed executor fans slices out, so
        a materialization failure degrades the whole query to the walk
        instead of failing mid-gather."""
        pg = q.pattern_group
        if pg.unions or pg.optional:
            raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                              "wcoj executes plain BGPs (UNION/OPTIONAL "
                              "route walk)")
        qg = analyze(pg.patterns, stats=self.stats)
        if not qg.supported:
            raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                              f"wcoj: {qg.reason}")

        unary_lists: dict[int, list] = {v: [] for v in qg.order}
        for u in qg.unaries:
            if u.kind == U_TYPE:
                arr = self.tables.index_list(u.payload, IN)
            elif u.kind == U_PINDEX:
                arr = self.tables.index_list(*u.payload)
            else:  # U_CONST
                arr = self.tables.neighbor_list(*u.payload)
            unary_lists[u.var].append(arr)
        # each edge is consumed exactly once as an adjacency (anchored on
        # the endpoint materialized FIRST, expanding/probing the later
        # one) and once as the earlier endpoint's index list — warm only
        # those, so _level's lazy fetches are guaranteed cache hits and
        # no fault can fire past this point
        pos = {v: i for i, v in enumerate(qg.order)}
        for e in qg.edges:
            later_is_o = pos[e.o] > pos[e.s]
            self.tables.segment(e.pid, OUT if later_is_o else IN)
            earlier = e.s if later_is_o else e.o
            self.tables.index_list(e.pid, IN if earlier == e.s else OUT)
        return qg, unary_lists

    def _run_levels(self, q, qg, unary_lists) -> None:
        """The level loop over an analyzed, warmed query graph."""
        route = self._route_for(q)
        prefix = np.empty((1, 0), dtype=np.int64)
        cols: dict[int, int] = {}
        levels: list[dict] = []
        try:
            for k, v in enumerate(qg.order):
                check_query(q, f"wcoj.level {k}")
                t0 = get_usec()
                rows_in = len(prefix)
                prefix, rec = self._level(qg, v, k, prefix, cols,
                                          unary_lists[v], route, q)
                cols[v] = k
                rec.update(level=k, var=v, rows_in=rows_in,
                           rows_out=len(prefix),
                           time_us=get_usec() - t0)
                levels.append(rec)
                charge_query(q, len(prefix), f"wcoj.level {k}")
        except (QueryTimeout, BudgetExceeded):
            # structured degradation: commit the prefix built so far as a
            # partial result (mark_partial lists every pattern dropped)
            self._commit(q, prefix, cols, levels, partial=True)
            raise
        self._commit(q, prefix, cols, levels, partial=False)

    # ------------------------------------------------------------------
    # level routing (join_device knob; JOIN_ROUTES registry)
    # ------------------------------------------------------------------
    @staticmethod
    def _route_for(q) -> str:
        """The query's level route: the proxy's plan-time classification
        (``q.join_route``) when present, else the forced knob — a bare
        executor under ``auto`` stays on host (it has no cost model to
        amortize the dispatch against)."""
        r = getattr(q, "join_route", None)
        if r is not None:
            return r
        knob = str(Global.join_device).strip().lower()
        return "device" if knob == "device" else "host"

    @staticmethod
    def _device_floor() -> int:
        """Per-level candidate floor for the device probe. A forced
        ``join_device device`` probes every level (deterministic tests);
        under auto-routing, levels below the dispatch-amortization
        threshold keep the host kernels."""
        if str(Global.join_device).strip().lower() == "device":
            return 1
        return max(int(Global.join_device_min_candidates), 1)

    # ------------------------------------------------------------------
    def _level(self, qg, v: int, k: int, prefix: np.ndarray,
               cols: dict, unary: list, route: str = "host", q=None):
        """Materialize variable ``v`` against the bound prefix.

        Generator choice is PER ROW: each prefix row expands from its
        smallest incident candidate list (the cheapest bound adjacency, or
        the intersected global list) — the leapfrog property that bounds
        total candidates by the sum of per-row minimum degrees, which a
        single per-level generator would lose on skewed (hub) data. Every
        constraint then filters all candidates (the generating list's
        self-probe is redundant but always true). Returns the new prefix
        and the level's intersection stats.
        """
        adj = []  # (anchor col, pid, dir, segment) — other endpoint bound
        glob = list(unary)  # global sorted candidate lists
        for e in qg.edges_of(v):
            v_is_o = e.o == v
            other = e.s if v_is_o else e.o
            if other in cols:
                d = OUT if v_is_o else IN
                seg = self.tables.segment(e.pid, d)
                adj.append((cols[other], e.pid, d, seg))
            else:
                glob.append(self.tables.index_list(
                    e.pid, IN if e.s == v else OUT))
        G = intersect_many(glob)
        n = len(prefix)
        if not adj and G is None:
            raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                              f"wcoj: variable {v} has no constraint to "
                              "generate candidates from")

        # per-row generator: argmin over each adjacency's degree and the
        # global list's (constant) length
        ranges = [lookup_ranges(seg.keys, seg.offsets, prefix[:, c])
                  for c, _pid, _d, seg in adj]
        deg_stack = [d for (_s, d) in ranges]
        if G is not None:
            deg_stack.append(np.full(n, len(G), dtype=np.int64))
        degs = np.stack(deg_stack) if n else \
            np.empty((len(deg_stack), 0), dtype=np.int64)
        choice = np.argmin(degs, axis=0) if n else \
            np.empty(0, dtype=np.int64)

        parts = []  # (generator id, row_idx, newcol) per generator group
        for j, (start, deg) in enumerate(ranges):
            rows = np.nonzero(choice == j)[0]
            if len(rows) == 0:
                continue
            row_idx, pos = expand_ragged(start[rows], deg[rows])
            parts.append((j, rows[row_idx], adj[j][3].edges[pos]))
        if G is not None:
            rows = np.nonzero(choice == len(ranges))[0]
            if len(rows):
                parts.append((len(adj), np.repeat(rows, len(G)),
                              np.tile(G, len(rows))))
        if parts:
            row_idx = np.concatenate([p[1] for p in parts])
            newcol = np.concatenate([p[2] for p in parts]).astype(
                np.int64, copy=False)
            # which generator produced each candidate (non-decreasing by
            # construction — groups are appended in generator order), so
            # the device path can elide each group's always-true
            # self-probe and slice groups as contiguous ranges. Only the
            # device route consumes it — the host route skips the alloc
            gid = (np.concatenate([np.full(len(p[1]), p[0],
                                           dtype=np.int16) for p in parts])
                   if route == "device" else None)
        else:
            row_idx = np.empty(0, dtype=np.int64)
            newcol = np.empty(0, dtype=np.int64)
            gid = np.empty(0, dtype=np.int16) if route == "device" else None

        if self.part is not None and k == 0 and len(newcol):
            # distributed generic join: this slice keeps only its hash
            # partition of the first eliminated variable's candidates —
            # BEFORE the probes, so the fan-out divides the probe work
            S, kk = self.part
            from wukong_tpu_torch.utils.mathutil import hash_mod

            pm = hash_mod(newcol.astype(np.int32), S) == kk
            row_idx, newcol = row_idx[pm], newcol[pm]
            if gid is not None:
                gid = gid[pm]

        candidates = len(newcol)
        probes = len(adj) + (1 if G is not None else 0)
        lvl_route = "host"
        if len(newcol):
            mask = None
            if route == "device" and candidates >= self._device_floor() \
                    and not (q is not None
                             and getattr(q, "_join_device_broken", False)):
                try:
                    mask = self._probe_device(G, adj, prefix, row_idx,
                                              newcol, gid, q=q, level=k)
                    lvl_route = "device"
                except (DeviceRangeError, WukongError, *faults.INJECTED) \
                        as e:
                    # degrade THIS query's remaining levels to host (the
                    # wcoj->walk posture, one layer down); the host probe
                    # below serves this level. A kernel or CUDA error is
                    # not caught: it reaches the caller
                    reason = (type(e).__name__ if not isinstance(
                        e, DeviceRangeError) else "int32_range")
                    _M_DEVICE_FALLBACK.labels(reason=reason).inc()
                    if q is not None:
                        q._join_device_broken = True
            if mask is None:
                mask = np.ones(len(newcol), dtype=bool)
                if G is not None:
                    mask &= member_sorted(G, newcol)
                for c, _pid, _d, seg in adj:
                    anchors = prefix[row_idx, c]
                    mask &= pair_member(seg.keys, seg.offsets, seg.edges,
                                        anchors, newcol)
            row_idx, newcol = row_idx[mask], newcol[mask]
        _M_DEVICE_LEVELS.labels(route=lvl_route).inc()
        new_prefix = np.column_stack(
            [prefix[row_idx], newcol]).astype(np.int64, copy=False)
        return new_prefix, {"candidates": candidates, "probes": probes,
                            "route": lvl_route}

    # ------------------------------------------------------------------
    def _probe_device(self, G, adj, prefix: np.ndarray, row_idx: np.ndarray,
                      newcol: np.ndarray, gid: np.ndarray, q=None,
                      level: int = 0) -> np.ndarray:
        """The level's probe phase as one ``level_probe`` launch per
        generator group: each group's padded flat candidate tensor is
        masked by every constraint EXCEPT its own generator (whose
        self-probe is true by construction — candidates were drawn from
        that list), the adjacencies ship as cached device-resident tables
        with their binary-search depth bounds, and the global list ships
        per level (it is an intersection result, not a cacheable table).
        Candidate tensors are padded to power-of-two capacity classes.
        Each group reads its mask back in one copy (its one host sync).
        Returns the host boolean mask over the unpadded candidates —
        identical semantics to the host probes."""
        _M_DEVICE_CAND.observe(len(newcol))
        dev = [self.tables.device_tables(pid, d)
               for (_c, pid, d, _s) in adj]
        glob_dev = (to_device_i32(G, self.device) if G is not None
                    else None)
        mask = np.zeros(len(newcol), dtype=bool)
        # gid is non-decreasing by construction: one diff pass finds the
        # group boundaries (no sort over millions of candidates)
        bounds = np.flatnonzero(np.diff(gid)) + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [len(gid)]])
        for lo, hi in zip(starts.tolist(), ends.tolist()):
            g = int(gid[lo])
            C = hi - lo
            use_glob = G is not None and g != len(adj)
            adj_ids = [j for j in range(len(adj)) if j != g]
            if not adj_ids and not use_glob:
                mask[lo:hi] = True  # only the self-constraint: all pass
                continue
            Cp = pad_pow2(C)
            valid = np.zeros(Cp, dtype=bool)
            valid[:C] = True
            cand = np.zeros(Cp, dtype=np.int32)
            cand[:C] = newcol[lo:hi]  # ids < 2^31 (tables range-checked)
            probes, depths = [], []
            for j in adj_ids:
                keys, offsets, edges, depth, index = dev[j]
                # anchors come from the PREFIX, which host-route levels
                # may have bound from never-range-checked host tables — an
                # unchecked int32 fill would silently wrap ids past 2^31
                # and alias real keys (the degrade-don't-truncate contract)
                avals = check_i32(prefix[row_idx[lo:hi], adj[j][0]],
                                  "anchor values")
                anchors = np.zeros(Cp, dtype=np.int32)
                anchors[:C] = avals
                probes.append((keys, offsets, edges,
                               upload(anchors, self.device), depth, index))
                depths.append(depth)
            t0 = get_usec()
            out = level_probe(upload(valid, self.device),
                              upload(cand, self.device),
                              glob_dev if use_glob else None, probes)
            mask[lo:hi] = out[:C].cpu().numpy()  # the group's one sync
            # candidate/anchor uploads + the mask back (device tables are
            # cached residents and don't re-ship)
            moved = Cp * (1 + 4 + 4 * len(adj_ids)) + C \
                + (int(G.nbytes) if use_glob else 0)
            rec = maybe_device_dispatch(
                "wcoj.probe",
                template="p" + "".join(map(str, depths))
                + ("g" if use_glob else ""),
                live=C, capacity=Cp, wall_us=get_usec() - t0,
                nbytes=moved)
            if rec is not None and q is not None:
                rec["step"] = int(level)
                dsteps = getattr(q, "device_steps", None)
                if dsteps is None:
                    dsteps = q.device_steps = []
                dsteps.append(rec)
        return mask

    # ------------------------------------------------------------------
    def _commit(self, q, prefix: np.ndarray, cols: dict, levels: list,
                partial: bool) -> None:
        res = q.result
        res.set_table(prefix)
        res.col_num = prefix.shape[1]
        for v, c in cols.items():
            res.add_var2col(v, c)
        q.join_stats = levels
        if not partial:
            q.pattern_step = len(q.pattern_group.patterns)
