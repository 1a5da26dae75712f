"""GPU engine — device-resident binding tables over staged CSR segments.

The port of the JAX package's engine/tpu.py (``TPUEngine`` there). The
binding table stays in device memory across pattern steps, each step runs one
of the kernels in tpu_kernels.py against segments staged by DeviceStore, and
the result is copied to the host only at the end (gpu_engine_cuda.hpp:189-196).

Execution discipline: the chain never reads device values mid-query. Output
capacities are estimated from the planner's per-step estimates when the
engine has statistics (``stats=``), else from host CSR metadata; per-step
true totals ride along as device scalars, and ONE sync at the end fetches
table, row count and totals together. If a step overflowed its capacity
class, the whole chain re-runs with exact capacities (inputs are immutable,
so the retry is safe and rows are never lost).

Batched entry points answer B instances of a planned query in one chain and
return per-instance row counts: ``execute_batch`` (a const start, B
constants), ``execute_batch_index`` (an index start, B replicate copies or B
slices of the index), and their in-flight windows ``execute_batch_many``,
``execute_batch_mixed`` and ``execute_batch_index_many``, which dispatch
several chains and read them back in one transfer. Supported shapes run
through the sort-merge executor (engine/tpu_merge.py); the rest, and slice
mode, through the eager chain here with a qid column.

Scope: every shape the JAX engine answers on one partition, through its
state machine PATTERN -> UNION -> OPTIONAL -> FILTER -> FINAL. The longest
device-supported prefix of the pattern chain runs on the card: index and
const starts, known_to_unknown/known/const, and the VERSATILE shapes with an
unbound predicate (known_unknown_unknown and known_unknown_const through
expand2 over the combined-adjacency segment, const_unknown_* from a host CSR
init). The rest runs in the host engine (engine/cpu.py) exactly where the
JAX package runs it on the host: attribute and bound-predicate steps, the
UNION merge, the OPTIONAL left join, FILTERs and the final stage. UNION
branches and shared-variable OPTIONAL groups come back through this engine
as seeded children, so their BGPs ride the device chain too.
"""

from __future__ import annotations

import numpy as np
import torch

from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine import tpu_kernels as K
from wukong_tpu_torch.engine.cpu import CPUEngine
from wukong_tpu_torch.engine.device_store import DeviceStore
from wukong_tpu_torch.engine.optional_join import execute_optional_leftjoin
from wukong_tpu_torch.obs.device import charge_steps
from wukong_tpu_torch.runtime.resilience import (
    charge_query,
    check_query,
    mark_partial,
)
from wukong_tpu_torch.sparql.ir import NO_RESULT, PGType, SPARQLQuery
from wukong_tpu_torch.types import OUT, PREDICATE_ID, TYPE_ID, AttrType
from wukong_tpu_torch.utils.errors import (
    BudgetExceeded,
    CapacityExceeded,
    ErrorCode,
    QueryTimeout,
    WukongError,
    assert_ec,
)
from wukong_tpu_torch.utils.lru import LRUCache
from wukong_tpu_torch.utils.timer import get_usec


class GPUEngine:
    """Executes one SPARQL query with device-resident pattern matching."""

    def __init__(self, gstore, str_server=None, device="cuda",
                 budget_bytes: int | None = None, stats=None):
        self.g = gstore
        self.str_server = str_server
        self.stats = stats  # optional planner Stats for capacity estimation
        if budget_bytes is None:
            budget_bytes = Global.tpu_mem_cache_gb << 30
        self.dstore = DeviceStore(gstore, budget_bytes=budget_bytes,
                                  device=device)
        self.device = self.dstore.device
        self.cpu = CPUEngine(gstore, str_server)
        self.cpu.knn_device = self.device  # knn() device scans run here
        self.cap_min = Global.table_capacity_min
        self.cap_max = Global.table_capacity_max
        self._est_planner = None  # lazy Planner over self.stats
        # pattern tuple -> {step: rows}; bounded LRU
        self._est_cache = LRUCache(4096)
        self._last_attempts = 0  # chain attempts of the last query
        from wukong_tpu_torch.engine.tpu_merge import MergeExecutor

        self.merge = MergeExecutor(self)

    # one capacity class of headroom over an estimate: kernels pay for
    # capacity, so tight classes + overflow retry beat compounding margins
    EST_SAFETY = 2.0

    def _count(self, n) -> torch.Tensor:
        return K.as_count(n, self.device)

    def _chain_estimates(self, patterns) -> dict[int, float]:
        """Per-step row estimates {step: rows} from the planner's joint
        type-table walk (optimizer.estimate_chain); empty when stats are
        absent or the chain shape defeats estimation. Memoized per pattern
        list — the emulator re-dispatches the same template thousands of
        times."""
        if self.stats is None:
            return {}
        key = tuple((p.subject, p.predicate, int(p.direction), p.object)
                    for p in patterns)
        cached = self._est_cache.get(key)
        if cached is not None:
            return cached
        if self._est_planner is None:
            from wukong_tpu_torch.planner.optimizer import Planner

            self._est_planner = Planner(self.stats)
        try:
            ests = self._est_planner.estimate_chain(list(patterns))
        except Exception:
            ests = None
        out = ({} if ests is None
               else {k: max(float(e), 1.0) for k, e in enumerate(ests)})
        self._est_cache.put(key, out)
        return out

    # ------------------------------------------------------------------
    def execute(self, q: SPARQLQuery, from_proxy: bool = True) -> SPARQLQuery:
        """Run q through the state machine (its projection and modifiers
        too when ``from_proxy``). Failures, an unsupported shape among them,
        land on ``q.result.status_code`` with the JAX engine's code. A
        traced query gets a ``gpu.execute`` span (obs/trace.py)."""
        from wukong_tpu_torch.obs.trace import traced_execute

        return traced_execute(
            q, "gpu.execute", lambda: self._execute_impl(q, from_proxy),
            lambda: {"rows": q.result.nrows,
                     "status": q.result.status_code.name})

    def _execute_impl(self, q: SPARQLQuery,
                      from_proxy: bool = True) -> SPARQLQuery:
        try:
            if q.planner_empty and Global.enable_empty_shortcircuit:
                # planner-proved empty (planner.hpp:1505-1509): no device work
                self.cpu.short_circuit_empty(q)
                if from_proxy:
                    self.cpu._final_process(q)
                return q
            if q.knn is not None:
                # the hybrid seed/rank stages borrow the CPU engine's
                # composition seams (vector/knn.py routes device scans
                # itself); a rank-then-pattern seed starts the device chain
                self.cpu._knn_pre(q)
            if q.has_pattern and not q.done_patterns():
                self._run_pattern_chain(q)
            if q.pattern_group.unions and not q.union_done:
                # children route back through THIS engine, so a branch BGP
                # rides the device chain (seeded upload init) when supported
                self.cpu._execute_unions(
                    q, child_exec=lambda c: self.execute(c, from_proxy=False))
            while q.optional_step < len(q.pattern_group.optional):
                self._execute_optional(q)
            if q.pattern_group.filters:
                self.cpu._execute_filters(q)
            if q.knn is not None:
                self.cpu._knn_post(q)
            if from_proxy:
                self.cpu._final_process(q)
        except (QueryTimeout, BudgetExceeded) as e:
            mark_partial(q, e)
        except WukongError as e:
            q.result.status_code = e.code
        return q

    def _execute_optional(self, q: SPARQLQuery) -> None:
        """The next OPTIONAL group: a dedup-seeded child on the device chain
        plus a host left join when it shares a bound variable with the
        parent; else (optional-only queries, attribute columns, a parent-
        bound predicate var, which no seeded child can carry) the host
        engine's in-place formulation."""
        res = q.result
        group = q.pattern_group.optional[q.optional_step]
        shares = any(v < 0 and res.var2col(v) != NO_RESULT
                     for p in group.patterns for v in (p.subject, p.object))
        pred_bound = any(p.predicate < 0 and res.var2col(p.predicate)
                         != NO_RESULT for p in group.patterns)
        if res.attr_col_num == 0 and shares and not pred_bound:
            execute_optional_leftjoin(
                q, self.cpu,
                run_child=lambda c: self.execute(c, from_proxy=False),
                str_server=self.str_server)
        else:
            self.cpu._execute_optional(q)

    # ------------------------------------------------------------------
    # chain execution with deferred overflow handling
    # ------------------------------------------------------------------
    def _run_pattern_chain(self, q: SPARQLQuery) -> None:
        """The longest device-supported prefix of the remaining steps on the
        card, then any remaining steps in the host engine."""
        device_steps = 0
        probe = _MetaResult(q.result)
        for i in range(q.pattern_step, len(q.pattern_group.patterns)):
            pat = q.get_pattern(i)
            if not self._device_supported(q, pat, probe, i == q.pattern_step):
                break
            probe.bind(pat)
            device_steps += 1
        if device_steps:
            self._run_device_prefix(q, device_steps)
        from wukong_tpu_torch.obs.trace import traced_step

        tr = getattr(q, "trace", None)
        while not q.done_patterns():
            traced_step(tr, q, "gpu.host_step",
                        lambda: self.cpu._execute_one_pattern(q))

    def _run_device_prefix(self, q: SPARQLQuery, device_steps: int) -> None:
        # a versatile CONST start is one host CSR walk: staging the whole
        # combined segment for it would be the largest staging of the chain
        # for a single lookup, so it is neither pinned nor prefetched (like
        # an index-origin start, which reads an index list)
        first = q.get_pattern(q.pattern_step)
        vlo = q.pattern_step
        if q.result.col_num == 0 and first.predicate < 0 and first.subject > 0:
            vlo += 1
        end = q.pattern_step + device_steps
        pins = [(q.get_pattern(i).predicate, q.get_pattern(i).direction)
                for i in range(q.pattern_step, end)
                if q.get_pattern(i).predicate > 0]
        pins += [("vpv", int(q.get_pattern(i).direction))
                 for i in range(vlo, end) if q.get_pattern(i).predicate < 0]
        self.dstore.pin(pins)
        try:
            if Global.gpu_enable_pipeline:
                lo = max(q.pattern_step, vlo)
                if lo == 0 and q.start_from_index() \
                        and _is_index_start(q.get_pattern(0)):
                    lo = 1
                self.dstore.prefetch(q.get_pattern(i) for i in range(lo, end))
            self._chain_attempts(q, device_steps)
        finally:
            self.dstore.unpin(pins)

    def _chain_attempts(self, q: SPARQLQuery, device_steps: int) -> None:
        """Dispatch the chain, sync once, and re-run it at exact capacities
        while any step overflowed its class."""
        # a blind query with nothing after the device chain only needs the
        # row count: the table stays on the card (the reference's silent
        # mode never ships result tables, proxy.hpp blind)
        blind_ok = (q.result.blind
                    and q.pattern_step + device_steps
                    == len(q.pattern_group.patterns)
                    and not q.pattern_group.unions
                    and not q.pattern_group.optional
                    and not q.pattern_group.filters)
        cap_override: dict[int, int] = {}
        step_est = (self._chain_estimates(q.pattern_group.patterns)
                    if q.pattern_step == 0 else {})
        # the chain's span closes after its one sync, so it covers the
        # chain's device work; every attribute is a host int the chain
        # already has (the sync's row count, the attempt count)
        tr = getattr(q, "trace", None)
        sp = (tr.start_span("gpu.chain", steps=device_steps,
                            rows_in=q.result.nrows)
              if tr is not None else None)
        attempts = 0
        try:
            for attempt in range(8):
                attempts = self._last_attempts = attempt + 1
                check_query(q, f"gpu.chain attempt {attempt}")
                t0 = get_usec()
                state = _ChainState(q.result)
                state.step_est = step_est
                for k in range(device_steps):
                    step = q.pattern_step + k
                    self._dispatch_one(q, q.get_pattern(step), step, state,
                                       cap_override)
                host_table, n, totals = state.sync(blind=blind_ok)
                moved = 4 * (1 + len(totals))  # the ride-along scalars
                if not blind_ok:
                    moved += int(host_table.nbytes)
                charge_steps("gpu.chain", totals, get_usec() - t0,
                             nbytes=moved, q=q)
                over = [(s, t) for s, t, c in totals if t > c]
                if not over:
                    break
                for s, t in over:
                    if t > self.cap_max:
                        raise CapacityExceeded(
                            f"intermediate result ({t:,} rows) exceeds "
                            f"table_capacity_max ({self.cap_max:,})")
                    cap_override[s] = K.next_capacity(t, self.cap_min,
                                                      self.cap_max)
            else:
                raise WukongError(ErrorCode.UNKNOWN_PATTERN,
                                  "capacity retry limit exceeded")
            charge_query(q, int(n), "gpu.chain")
            res = q.result
            if blind_ok:
                res.nrows = n
            else:
                res.set_table(host_table[:n].astype(np.int64))
            for var, col in state.new_cols:
                res.add_var2col(var, col)
            res.col_num = state.width
            q.pattern_step += device_steps
            q.local_var = state.local_var
        finally:
            if sp is not None:
                tr.end_span(sp, attempts=attempts,
                            dispatches=attempts * device_steps,
                            rows_out=q.result.nrows)

    # ------------------------------------------------------------------
    def _dispatch_one(self, q: SPARQLQuery, pat, step: int,
                      state: "_ChainState", cap_override: dict,
                      anchor_col: int | None = None) -> None:
        start, pid, d, end = pat.subject, pat.predicate, pat.direction, pat.object

        if state.table is None and state.width > 0:
            # seeded chain (a UNION branch or OPTIONAL child over the
            # parent's binding table): upload the host table once, then
            # dispatch this pattern as a normal anchored step. The upload
            # capacity is exact, so it never takes part in the overflow
            # retry. int32 narrowing as in the JAX engine: a BLANK_ID seed
            # (2^32 - 1) wraps to -1, which matches no key's edges.
            host_t = q.result.table
            n0 = len(host_t)
            assert_ec(n0 <= self.cap_max, ErrorCode.UNKNOWN_PATTERN,
                      f"seed table ({n0:,} rows) exceeds "
                      f"table_capacity_max ({self.cap_max:,})")
            cap = K.next_capacity(max(n0, 1), self.cap_min, self.cap_max)
            pad = np.zeros((state.width, cap), dtype=np.int32)
            if host_t.size:
                pad[:, :n0] = host_t.T
            state.table = K.upload(pad, self.device)
            state.n = self._count(n0)
            state.est_rows = max(n0, 1)

        if state.table is None:
            if q.start_from_index() and step == q.pattern_step == 0 \
                    and _is_index_start(pat):
                edges, real = self.dstore.index_list(start, d)
                if q.mt_factor > 1:
                    lo, hi = _mt_slice(real, q.mt_factor, q.mt_tid)
                    edges, real = edges[lo:hi], hi - lo
                if real > self.cap_max:
                    # A deviation from the JAX engine (tpu.py:365-375),
                    # which clamps the start's class and keeps min(real,
                    # cap) rows with status 0: the start records no total,
                    # so neither the retry nor CapacityExceeded would fire.
                    # The port refuses it, and the proxy answers every row
                    # on the host engine (runtime/proxy.py _run_repeats).
                    raise CapacityExceeded(
                        f"index start ({real:,} rows) exceeds "
                        f"table_capacity_max ({self.cap_max:,})")
                cap = cap_override.get(step) or K.next_capacity(
                    real, self.cap_min, self.cap_max)
                table, nn = K.init_from_list(edges, real, cap)
                state.begin(table, nn, end, est_rows=real)
                state.local_var = end
                return
            if pid < 0:
                self._versatile_const_start(q, pat, step, state, cap_override)
                return
            # const_to_unknown start: one host CSR lookup
            assert_ec(q.result.col_num == 0 and state.width == 0,
                      ErrorCode.FIRST_PATTERN_ERROR)
            vids = np.asarray(self.g.get_triples(start, pid, d), dtype=np.int64)
            if len(vids) > self.cap_max:
                # the JAX engine raises a numpy ValueError here (tpu.py:
                # 415-424, the pad write); the port refuses the start as
                # the capacity overflow it is, which the proxy degrades
                raise CapacityExceeded(
                    f"const start ({len(vids):,} neighbours) exceeds "
                    f"table_capacity_max ({self.cap_max:,})")
            cap = cap_override.get(step) or K.next_capacity(
                len(vids), self.cap_min, self.cap_max)
            pad = np.zeros((1, cap), dtype=np.int32)  # [width=1, capacity]
            pad[0, : len(vids)] = vids
            state.begin(K.upload(pad, self.device),
                        self._count(len(vids)), end, est_rows=len(vids))
            return

        col = anchor_col if anchor_col is not None else state.col_of(start)
        assert_ec(col is not None, ErrorCode.VERTEX_INVALID)
        if pid < 0:
            self._versatile_expand(pat, step, state, cap_override, col)
            return
        seg = self.dstore.segment(pid, d)
        e_col = state.col_of(end) if end < 0 else None
        e_known = end < 0 and e_col is not None

        if end < 0 and not e_known:  # known_to_unknown
            if seg is None:
                state.append_empty_col(end)
                return
            est = self._estimate_rows(state, pat, seg, step=step)
            cap_out = cap_override.get(step) or K.next_capacity(
                max(est, self.cap_min), self.cap_min, self.cap_max)
            out, nn, total = K.expand(
                state.table, state.n, seg.bline, seg.bhi,
                seg.edges, col=col, cap_out=cap_out, max_probe=seg.max_probe)
            state.advance_expand(out, nn, end, total, cap_out, step,
                                 est_rows=min(est, cap_out))
            return
        # known_to_known / known_to_const
        C = state.table.shape[1]
        if seg is None:
            keep = torch.zeros(C, dtype=torch.bool, device=self.device)
        else:
            if e_known:
                vals = state.table[e_col]
            else:
                vals = torch.full((C,), int(end), dtype=torch.int32,
                                  device=self.device)
            keep = K.member_mask_known(
                state.table, state.n, vals, seg.bline, seg.bhi,
                seg.edges, col=col, max_probe=seg.max_probe,
                depth=seg.max_deg_log2)
        se = state.step_est.get(step)
        cap_new = cap_override.get(step)
        if cap_new is None and se is not None:
            cap_new = K.next_capacity(
                max(int(se * self.EST_SAFETY), self.cap_min),
                self.cap_min, self.cap_max)
        if cap_new is not None and cap_new < C:
            # estimate-driven or learned shrink: totals ride along so an
            # underestimate retries the chain, never drops rows
            out, nn, total = K.compact_to(state.table, keep, cap_new)
            state.advance_filter(out, nn)
            state.totals.append((step, total, cap_new))
        else:
            out, nn = K.compact(state.table, keep)
            state.advance_filter(out, nn)

    def _versatile_const_start(self, q: SPARQLQuery, pat, step: int,
                               state: "_ChainState",
                               cap_override: dict) -> None:
        """CONST ?p ?y / CONST1 ?p CONST2 (sparql.hpp:246-290's
        const_unknown_*): the const's combined adjacency is one host CSR
        walk, so the table is built on the host and the device chain goes
        on from it. A const object keeps the matching pairs and binds only
        the predicate column."""
        start, pid, d, end = pat.subject, pat.predicate, pat.direction, pat.object
        assert_ec(q.result.col_num == 0 and state.width == 0,
                  ErrorCode.FIRST_PATTERN_ERROR)
        prs, vls = [], []
        for p in self.g.get_triples(start, PREDICATE_ID, d):
            nb = self.g.get_triples(start, int(p), d)
            prs.extend([int(p)] * len(nb))
            vls.extend(int(v) for v in nb)
        prs = np.asarray(prs, dtype=np.int64)
        vls = np.asarray(vls, dtype=np.int64)
        if end > 0:
            cols_data, bind = [prs[vls == end]], [pid]
        else:
            cols_data, bind = [prs, vls], [pid, end]
        real = len(cols_data[0])
        assert_ec(real <= self.cap_max, ErrorCode.UNKNOWN_PATTERN,
                  f"versatile const start ({real:,} pairs) exceeds "
                  f"table_capacity_max ({self.cap_max:,})")
        cap = cap_override.get(step) or K.next_capacity(
            max(real, 1), self.cap_min, self.cap_max)
        pad = np.zeros((len(cols_data), cap), dtype=np.int32)
        for r, cd in enumerate(cols_data):
            pad[r, :real] = cd
        state.table = K.upload(pad, self.device)
        state.n = self._count(real)
        for v in bind:
            state.bind_col(v)
        state.est_rows = max(real, 1)

    def _versatile_expand(self, pat, step: int, state: "_ChainState",
                          cap_override: dict, col: int) -> None:
        """known_unknown_unknown (?x ?p ?y, x bound) through expand2 over
        the combined segment of the pattern's direction; known_unknown_const
        (?x ?p CONST, sparql.hpp:651-699) keeps the expanded pairs whose
        value is the const and drops the value row, so the table binds only
        the predicate column (the host kernel's layout)."""
        pid, end = pat.predicate, pat.object
        vseg = self.dstore.versatile_segment(pat.direction)
        if vseg is None:
            state.append_empty_col(pid)
            if end < 0:
                state.append_empty_col(end)
            return
        fan = max(1.0, vseg.num_edges / max(vseg.num_keys, 1)) * 2
        est = min(int(state.est_rows * fan) or 1, self.cap_max)
        cap_out = cap_override.get(step) or K.next_capacity(
            max(est, self.cap_min), self.cap_min, self.cap_max)
        out, nn, total = K.expand2(
            state.table, state.n, vseg.bline, vseg.bhi,
            vseg.edges2, vseg.edges, col=col, cap_out=cap_out,
            max_probe=vseg.max_probe)
        if end > 0:
            state.totals.append((step, total, cap_out))
            keep = (K._arange(cap_out, out) < nn) & (out[-1] == int(end))
            out, nn = K.compact(out, keep)
            state.table, state.n = out[:-1], nn
            state.bind_col(pid)
            # the fold only shrinks the expansion, so the expand estimate is
            # a safe (over-)estimate for downstream capacity sizing
            state.est_rows = max(min(est, cap_out), 1)
            return
        state.advance_expand2(out, nn, pid, end, total, cap_out, step,
                              est_rows=min(est, cap_out))

    # ------------------------------------------------------------------
    # batched execution: one chain answers B instances of a planned query
    # (the emulator's win — a batch of 1024 instances of one template is
    # one chain; SURVEY §7.6)
    # ------------------------------------------------------------------
    def execute_batch(self, q: SPARQLQuery, consts: np.ndarray) -> np.ndarray:
        """Run a planned const-start query for B different start constants.

        The binding table carries a qid column; all steps run once for the
        whole batch; returns per-query result row counts (blind semantics).
        """
        pats = q.pattern_group.patterns
        self._check_batch_const(q)
        B = len(consts)
        if q.planner_empty and Global.enable_empty_shortcircuit:
            return np.zeros(B, dtype=np.int64)
        if Global.enable_merge_join and self.merge.supports(q):
            return self.merge.run_batch_const(q, consts)

        def make_init(state: "_ChainState", cap_override: dict) -> int:
            # init: [2, cap] — row 0 qid, row 1 the per-instance start constant
            cap0 = K.next_capacity(B, self.cap_min)
            init = np.zeros((2, cap0), dtype=np.int32)  # [width, capacity]
            init[0, :B] = np.arange(B)
            init[1, :B] = consts
            state.table = K.upload(init, self.device)
            state.n = self._count(B)
            state.width = 2
            state.cols[pats[0].subject] = 1  # start consts act as a known col
            state.est_rows = B
            return 0  # dispatch every pattern (the const col pre-binds step 0)

        return self._run_batch_chain(q, B, make_init, est_mult=float(B))

    def _check_batch_const(self, q: SPARQLQuery) -> None:
        """Shared validation for the const-batch entry points: every step
        must be device-supported (the start constant column counts as known
        for steps that re-anchor on it — the reference plans such shapes as
        known_to_*)."""
        pats = q.pattern_group.patterns
        assert_ec(len(pats) > 0 and pats[0].subject > 0,
                  ErrorCode.UNKNOWN_PLAN, "batch execution needs a const start")
        probe = _MetaResult(q.result)
        probe.cols[pats[0].subject] = 1
        probe.width = 2
        for k, pat in enumerate(pats):
            assert_ec(pat.pred_type == int(AttrType.SID_t)
                      and pat.predicate >= 0, ErrorCode.UNKNOWN_PATTERN,
                      "batch steps must have const SID predicates")
            if k > 0:
                assert_ec(probe.col_of(pat.subject) is not None,
                          ErrorCode.UNKNOWN_PATTERN,
                          "batch steps must anchor on a bound column")
            probe.bind(pat)

    def execute_batch_many(self, q: SPARQLQuery, consts_list: list) -> list:
        """K const-batches with as few device syncs as the active path
        allows (the emulator's in-flight window). Applies the same guards
        as execute_batch: planner-proved-empty classes answer instantly,
        the merge path dispatches all K batches back-to-back and syncs
        ONCE (run_batch_const_many), anything else degrades to a per-batch
        loop — callers never need routing knowledge."""
        self._check_batch_const(q)
        if q.planner_empty and Global.enable_empty_shortcircuit:
            return [np.zeros(len(c), dtype=np.int64) for c in consts_list]
        if Global.enable_merge_join and self.merge.supports(q):
            return self.merge.run_batch_const_many(q, consts_list)
        return [self.execute_batch(q, c) for c in consts_list]

    def execute_batch_mixed(self, jobs: list) -> list:
        """One device flight across MULTIPLE const-start templates (the
        cross-class window): jobs = [(query, consts), ...]. Planner-empty
        jobs answer instantly; merge-supported jobs share ONE sync via
        run_batch_const_mixed; the rest degrade to per-job execute_batch.
        Returns per-job count arrays in input order."""
        out: list = [None] * len(jobs)
        mixed = []
        for i, (q, consts) in enumerate(jobs):
            self._check_batch_const(q)
            if q.planner_empty and Global.enable_empty_shortcircuit:
                out[i] = np.zeros(len(consts), dtype=np.int64)
            elif Global.enable_merge_join and self.merge.supports(q):
                mixed.append(i)
            else:
                out[i] = self.execute_batch(q, consts)
        if mixed:
            res = self.merge.run_batch_const_mixed([jobs[i] for i in mixed])
            for i, r in zip(mixed, res):
                out[i] = r
        return out

    def execute_batch_index(self, q: SPARQLQuery, B: int,
                            slice_mode: bool = False) -> np.ndarray:
        """Batched execution of an index-origin (heavy) query.

        replicate mode: B independent full instances — the qid dimension
        amortizes the end-of-chain device sync across B queries (the
        reference's 'at batch' heavy throughput). slice mode: the index scan
        is split into B contiguous slices (qid = slice), the single-card
        analogue of fanning a heavy query out to num_servers x mt_factor
        engines (sparql.hpp:98-108, 1064-1088); per-qid counts sum to the
        query total. Returns per-qid result row counts (blind semantics).

        ``q.mt_factor > 1`` pre-slices the index list to this copy's mt
        range before batching (the heavy-lane split: one dispatch fans out
        as mt_factor carrier copies; per-part counts sum to the full
        query's total).
        """
        pats = q.pattern_group.patterns
        self._check_batch_index(q)
        if q.planner_empty and Global.enable_empty_shortcircuit:
            return np.zeros(B, dtype=np.int64)
        if Global.enable_merge_join and self.merge.supports(q) \
                and q.mt_factor <= 1 and not slice_mode:
            # merge only for REPLICATE mode, where the shared sort amortizes
            # over B copies; slice mode runs the chain once at 1/B
            # granularity, and mt-sliced carriers need the index pre-slicing
            return self.merge.run_batch_index(q, B, slice_mode)
        edges, real = self.dstore.index_list(pats[0].subject, pats[0].direction)
        if q.mt_factor > 1:
            lo, hi = _mt_slice(real, q.mt_factor, q.mt_tid)
            edges, real = edges[lo:hi], hi - lo
        total0 = real if slice_mode else real * B
        assert_ec(total0 <= self.cap_max, ErrorCode.UNKNOWN_PATTERN,
                  f"batch-index start ({total0:,} rows) exceeds "
                  f"table_capacity_max ({self.cap_max:,})")

        def make_init(state: "_ChainState", cap_override: dict) -> int:
            # total0 <= cap_max was asserted above, so cap0 always suffices
            # (the init step does not take part in the overflow retry)
            cap0 = K.next_capacity(max(total0, 1), self.cap_min, self.cap_max)
            state.table, state.n = K.init_batch_index(
                edges, real, B=B, cap=cap0, slice_mode=slice_mode)
            state.width = 2
            state.cols[pats[0].object] = 1
            state.est_rows = max(total0, 1)
            return 1  # pattern 0 is consumed by the init

        return self._run_batch_chain(q, B, make_init,
                                     est_mult=1.0 if slice_mode else float(B))

    def _check_batch_index(self, q: SPARQLQuery) -> None:
        """Shared validation for the index-origin batch entry points."""
        pats = q.pattern_group.patterns
        assert_ec(len(pats) > 0 and q.start_from_index()
                  and _is_index_start(pats[0]) and pats[0].object < 0,
                  ErrorCode.UNKNOWN_PLAN,
                  "batch-index execution needs an index-origin start")
        probe = _MetaResult(q.result)
        probe.cols[pats[0].object] = 1
        probe.width = 2
        for k, pat in enumerate(pats):
            assert_ec(pat.pred_type == int(AttrType.SID_t)
                      and pat.predicate >= 0, ErrorCode.UNKNOWN_PATTERN,
                      "batch steps must have const SID predicates")
            if k > 0:
                assert_ec(probe.col_of(pat.subject) is not None,
                          ErrorCode.UNKNOWN_PATTERN,
                          "batch steps must anchor on a bound column")
                probe.bind(pat)

    def execute_batch_index_many(self, q: SPARQLQuery, B: int,
                                 K_batches: int) -> list:
        """K replicate-mode heavy batches with as few device syncs as the
        active path allows (the heavy-class in-flight window) — same guard
        structure as execute_batch_many."""
        self._check_batch_index(q)
        if q.planner_empty and Global.enable_empty_shortcircuit:
            return [np.zeros(B, dtype=np.int64) for _ in range(K_batches)]
        if Global.enable_merge_join and self.merge.supports(q):
            return self.merge.run_batch_index_many(q, B, K_batches)
        return [self.execute_batch_index(q, B) for _ in range(K_batches)]

    def _run_batch_chain(self, q: SPARQLQuery, B: int, make_init,
                         est_mult: float = 1.0) -> np.ndarray:
        """The eager chain with a qid column: ``make_init(state,
        cap_override)`` builds the start table and returns the first step
        to dispatch; one host read at the end fetches the per-qid counts
        and every step's total, and an overflow re-runs the chain at exact
        capacities."""
        pats = q.pattern_group.patterns
        step_est = {k: e * est_mult
                    for k, e in self._chain_estimates(pats).items()}
        pins = [(p.predicate, p.direction) for p in pats if p.predicate > 0]
        self.dstore.pin(pins)
        try:
            if Global.gpu_enable_pipeline:
                # skip an index-origin start: it consumes an index list
                skip0 = q.start_from_index() and _is_index_start(pats[0])
                self.dstore.prefetch(pats[1:] if skip0 else pats)
            cap_override: dict[int, int] = {}
            for _attempt in range(8):
                check_query(q, f"gpu.batch_chain attempt {_attempt}")
                t0 = get_usec()
                state = _ChainState(q.result)
                state.step_est = step_est
                first = make_init(state, cap_override)
                for k in range(first, len(pats)):
                    pat = q.get_pattern(k)
                    self._dispatch_one(q, pat, k, state, cap_override,
                                       anchor_col=state.col_of(pat.subject))
                counts = _qid_counts(state.table, state.n, B)
                [(host_counts, totals)] = K.fetch_counts(
                    [(counts, [t for (_, t, _) in state.totals])])
                charge_steps("gpu.batch_chain",
                             [(s, t, c) for (s, _, c), t
                              in zip(state.totals, totals)],
                             get_usec() - t0, nbytes=4 * (B + len(totals)),
                             q=q)
                over = False
                for (s, _, c), t in zip(state.totals, totals):
                    if t > c:
                        if t > self.cap_max:
                            raise WukongError(
                                ErrorCode.UNKNOWN_PATTERN,
                                f"batch intermediate ({t:,} rows) exceeds "
                                f"table_capacity_max ({self.cap_max:,})")
                        cap_override[s] = K.next_capacity(t, self.cap_min,
                                                          self.cap_max)
                        over = True
                if not over:
                    return host_counts
            raise WukongError(ErrorCode.UNKNOWN_PATTERN,
                              "batch capacity retry limit exceeded")
        finally:
            self.dstore.unpin(pins)

    def suggest_index_batch(self, q: SPARQLQuery, cap: int = 1024) -> int:
        """Largest power-of-two B (<= cap) whose replicated batch is estimated
        to fit the capacity ceiling at every chain step."""
        pats = q.pattern_group.patterns
        if not pats or not q.start_from_index():
            return 1
        ests = self._chain_estimates(pats)
        if ests:
            peak = max(max(ests.values()),
                       len(self.g.get_index(pats[0].subject,
                                            pats[0].direction)), 1)
        else:
            peak = est = max(len(self.g.get_index(pats[0].subject,
                                                  pats[0].direction)), 1)
            bound = {pats[0].object}
            for pat in pats[1:]:
                if pat.object < 0 and pat.object not in bound \
                        and pat.subject in bound:
                    # a genuine expansion; member/k2k steps only shrink
                    est = int(est * self._fanout(pat)) or 1
                    peak = max(peak, est)
                    bound.add(pat.object)
        B = 1
        while B < cap and 2 * B * peak * self.EST_SAFETY <= self.cap_max:
            B *= 2
        return B

    def _fanout(self, pat, seg=None) -> float:
        """Per-row expansion factor estimate — the single source for both
        capacity estimation (_estimate_rows) and batch sizing, so the two
        can never drift. Stats-based when available (pred edges / anchor
        population, x1.5 safety), else segment average degree x2."""
        if self.stats is not None:
            pe = self.stats.pred_edges.get(pat.predicate)
            if pe:
                anchors = (self.stats.distinct_subj if pat.direction == OUT
                           else self.stats.distinct_obj
                           ).get(pat.predicate, 0) or 1
                return pe / anchors * 1.5
        if seg is not None:
            return max(1.0, seg.num_edges / max(seg.num_keys, 1)) * 2
        host = self.g.segments.get((pat.predicate, pat.direction))
        if host is None:
            return 1.0
        return max(1.0, host.num_edges / max(len(host.keys), 1)) * 2

    def _estimate_rows(self, state, pat, seg, step=None) -> int:
        """Expected output rows of an expansion step.

        Prefers the planner's joint-type-table per-step estimate
        (state.step_est) with EST_SAFETY headroom; falls back to the shared
        _fanout estimate. A wrong estimate costs one chain retry, never
        correctness."""
        se = state.step_est.get(step) if step is not None else None
        if se is not None:
            return max(min(int(se * self.EST_SAFETY), self.cap_max), 1)
        est = int(min(state.est_rows * self._fanout(pat, seg), self.cap_max))
        return max(est, 1)

    def _device_supported(self, q: SPARQLQuery, pat, probe,
                          is_first: bool) -> bool:
        """May this step run on the card (the JAX engine's rule,
        tpu.py:836-869)? Attribute steps, bound-predicate versatiles and
        steps of an in-place OPTIONAL child stay on the host."""
        if q.pg_type == PGType.OPTIONAL:
            return False
        if pat.pred_type != int(AttrType.SID_t):
            return False
        if pat.predicate < 0:
            # VERSATILE: known_unknown_unknown / known_unknown_const via
            # expand2, const_unknown_* via a host CSR init. A bound
            # predicate var has no device kernel: the host engine's
            # known_unknown_* steps take it, as in the JAX package.
            if probe.col_of(pat.predicate) is not None:
                return False
            if is_first and probe.width == 0:
                return pat.subject > 0  # const versatile start
            if not (pat.subject < 0
                    and probe.col_of(pat.subject) is not None):
                return False
            if pat.object < 0:
                return probe.col_of(pat.object) is None
            return True  # const object: expand2 + equality fold
        if is_first and q.pattern_step == 0 and q.start_from_index():
            # index_to_known is host-only, and a seeded (width > 0) table
            # cannot consume an index start (the host kernel raises
            # FIRST_PATTERN_ERROR)
            return probe.width == 0 and probe.col_of(pat.object) is None
        s_known = pat.subject > 0 or probe.col_of(pat.subject) is not None
        if is_first and probe.width == 0:
            return pat.subject > 0  # const start
        return s_known and pat.subject < 0


def _is_index_start(pat) -> bool:
    return pat.predicate in (PREDICATE_ID, TYPE_ID)


def _mt_slice(total: int, mt_factor: int, mt_tid: int):
    mt = mt_tid % mt_factor
    length = total // mt_factor
    lo = mt * length
    hi = (mt + 1) * length if mt != mt_factor - 1 else total
    return lo, hi


class _MetaResult:
    """Host-side shadow of column bindings for chain planning (no device data)."""

    def __init__(self, res):
        self.cols = dict(res.v2c_map)
        self.width = res.col_num

    def col_of(self, var: int):
        c = self.cols.get(var)
        return c if c is not None and c != NO_RESULT else None

    def bind(self, pat) -> None:
        if self.width == 0 and pat.predicate >= 0:
            self.cols[pat.object], self.width = 0, 1
            return
        # a versatile step binds its predicate var first (the pid column
        # precedes the value column, as in the host kernels); a const
        # versatile start puts the pid at column 0
        if pat.predicate < 0 and self.col_of(pat.predicate) is None:
            self.cols[pat.predicate] = self.width
            self.width += 1
        if pat.object < 0 and self.col_of(pat.object) is None:
            self.cols[pat.object] = self.width
            self.width += 1


class _ChainState:
    """Device table + host-side column metadata + deferred overflow scalars."""

    def __init__(self, res):
        self.table = None
        self.n = None
        self.width = res.col_num
        self.cols = dict(res.v2c_map)
        self.new_cols: list = []
        self.totals: list = []  # (step, device_total, cap)
        self.est_rows = 1
        self.step_est: dict = {}  # {step: planner row estimate}
        self.local_var = 0

    def col_of(self, var: int):
        c = self.cols.get(var)
        return c if c is not None and c != NO_RESULT else None

    def begin(self, table, n, end_var: int, est_rows: int) -> None:
        self.table = table
        self.n = n
        self.width = 1
        self.cols[end_var] = 0
        self.new_cols.append((end_var, 0))
        self.est_rows = max(est_rows, 1)

    def advance_expand(self, table, n, end_var: int, total, cap: int,
                       step: int, est_rows: int) -> None:
        self.table = table
        self.n = n
        self.cols[end_var] = self.width
        self.new_cols.append((end_var, self.width))
        self.width += 1
        self.totals.append((step, total, cap))
        self.est_rows = max(est_rows, 1)

    def advance_expand2(self, table, n, pred_var: int, end_var: int, total,
                        cap: int, step: int, est_rows: int) -> None:
        """Versatile expand: binds the predicate column, then the value."""
        self.table = table
        self.n = n
        self.bind_col(pred_var)
        self.bind_col(end_var)
        self.totals.append((step, total, cap))
        self.est_rows = max(est_rows, 1)

    def bind_col(self, var: int) -> None:
        """Bind var to the next column of the table."""
        self.cols[var] = self.width
        self.new_cols.append((var, self.width))
        self.width += 1

    def advance_filter(self, table, n) -> None:
        self.table = table
        self.n = n

    def append_empty_col(self, end_var: int) -> None:
        """Expansion over a missing segment: zero matches, one new column."""
        self.table = torch.cat([self.table, torch.zeros_like(self.table[:1])])
        self.n = torch.zeros_like(self.n)
        self.cols[end_var] = self.width
        self.new_cols.append((end_var, self.width))
        self.width += 1

    def sync(self, blind: bool = False):
        """The single device-to-host sync: row count and all step totals in
        one transfer, plus the table unless ``blind``."""
        scalars = torch.stack([self.n] + [t for (_, t, _) in self.totals])
        vals = scalars.tolist()
        if blind:
            host_table = np.empty((0, self.width), dtype=np.int32)
        else:
            host_table = np.ascontiguousarray(self.table.cpu().numpy().T)
        return (host_table, int(vals[0]),
                [(s, int(t), c) for (s, _, c), t in zip(self.totals, vals[1:])])


def _qid_counts(table, n, B: int):
    """Per-query row counts from the qid column (device-side bincount)."""
    C = table.shape[1]
    live = torch.arange(C, dtype=torch.int32, device=table.device) < n
    return K.qid_bincount(torch.where(live, table[0], B), B)
