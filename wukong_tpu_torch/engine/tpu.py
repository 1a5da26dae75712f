"""GPU engine — device-resident binding tables over staged CSR segments.

The port of the JAX package's engine/tpu.py (``TPUEngine`` there). The
binding table stays in device memory across pattern steps, each step runs one
of the kernels in tpu_kernels.py against segments staged by DeviceStore, and
the result is copied to the host only at the end (gpu_engine_cuda.hpp:189-196).

Execution discipline: the chain never reads device values mid-query. Output
capacities are estimated from host CSR metadata, per-step true totals ride
along as device scalars, and ONE sync at the end fetches table, row count and
totals together. If a step overflowed its capacity class, the whole chain
re-runs with exact capacities (inputs are immutable, so the retry is safe and
rows are never lost).

Scope: basic graph patterns of constant SID predicates — index starts, const
starts, known_to_unknown, known_to_known and known_to_const — with
projection, DISTINCT, LIMIT and OFFSET. Every other shape (attribute
patterns, variable predicates, OPTIONAL, UNION, FILTER, ORDER BY) raises
WukongError(UNKNOWN_PATTERN): the port has no host engine to hand it to.
"""

from __future__ import annotations

import numpy as np
import torch

from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine import tpu_kernels as K
from wukong_tpu_torch.engine.device_store import DeviceStore
from wukong_tpu_torch.sparql.ir import NO_RESULT, PGType, SPARQLQuery
from wukong_tpu_torch.types import PREDICATE_ID, TYPE_ID, AttrType
from wukong_tpu_torch.utils.errors import (
    CapacityExceeded,
    ErrorCode,
    WukongError,
    assert_ec,
)


class GPUEngine:
    """Executes one SPARQL query with device-resident pattern matching."""

    def __init__(self, gstore, str_server=None, device="cuda",
                 budget_bytes: int | None = None):
        self.g = gstore
        self.str_server = str_server
        if budget_bytes is None:
            budget_bytes = Global.tpu_mem_cache_gb << 30
        self.dstore = DeviceStore(gstore, budget_bytes=budget_bytes,
                                  device=device)
        self.device = self.dstore.device
        self.cap_min = Global.table_capacity_min
        self.cap_max = Global.table_capacity_max
        self._last_attempts = 0  # chain attempts of the last query
        from wukong_tpu_torch.engine.tpu_merge import MergeExecutor

        self.merge = MergeExecutor(self)

    # one capacity class of headroom over an estimate: kernels pay for
    # capacity, so tight classes + overflow retry beat compounding margins
    EST_SAFETY = 2.0

    def _count(self, n) -> torch.Tensor:
        return K.as_count(n, self.device)

    # ------------------------------------------------------------------
    def execute(self, q: SPARQLQuery, from_proxy: bool = True) -> SPARQLQuery:
        """Run q's pattern chain on the device (and its projection when
        ``from_proxy``). Unsupported shapes raise; runtime failures such as
        a capacity ceiling land on ``q.result.status_code``."""
        self.check_supported(q)
        try:
            if q.planner_empty and Global.enable_empty_shortcircuit:
                self._short_circuit_empty(q)
            elif q.has_pattern and not q.done_patterns():
                self._run_pattern_chain(q)
            if from_proxy:
                _final_process(q)
        except WukongError as e:
            q.result.status_code = e.code
        return q

    def check_supported(self, q: SPARQLQuery) -> None:
        pg = q.pattern_group
        for what, present in (("UNION", pg.unions), ("OPTIONAL", pg.optional),
                              ("FILTER", pg.filters), ("ORDER BY", q.orders)):
            if present:
                raise WukongError(ErrorCode.UNKNOWN_PATTERN,
                                  f"{what} is not supported by the GPU engine")
        probe = _MetaResult(q.result)
        for i in range(q.pattern_step, len(pg.patterns)):
            pat = q.get_pattern(i)
            if not self._device_supported(q, pat, probe, i == q.pattern_step):
                raise WukongError(ErrorCode.UNKNOWN_PATTERN,
                                  f"pattern {pat!r} is not supported by the "
                                  "GPU engine")
            probe.bind(pat)

    def _device_supported(self, q, pat, probe, is_first: bool) -> bool:
        if q.pg_type == PGType.OPTIONAL:
            return False
        if pat.pred_type != int(AttrType.SID_t) or pat.predicate < 0:
            return False
        if is_first and q.pattern_step == 0 and q.start_from_index():
            return probe.width == 0 and probe.col_of(pat.object) is None
        s_known = pat.subject > 0 or probe.col_of(pat.subject) is not None
        if is_first and probe.width == 0:
            return pat.subject > 0  # const start
        return s_known and pat.subject < 0

    @staticmethod
    def _short_circuit_empty(q: SPARQLQuery) -> None:
        """A provably empty result: bind every pattern var over zero rows."""
        res = q.result
        for pat in q.pattern_group.patterns:
            for var in (pat.subject, pat.predicate, pat.object):
                if var < 0 and res.var2col(var) == NO_RESULT:
                    res.add_var2col(var, res.col_num)
                    res.col_num += 1
        res.set_table(np.empty((0, res.col_num), dtype=np.int64))
        q.pattern_step = len(q.pattern_group.patterns)

    # ------------------------------------------------------------------
    # chain execution with deferred overflow handling
    # ------------------------------------------------------------------
    def _run_pattern_chain(self, q: SPARQLQuery) -> None:
        steps = range(q.pattern_step, len(q.pattern_group.patterns))
        pins = [(q.get_pattern(i).predicate, q.get_pattern(i).direction)
                for i in steps]
        self.dstore.pin(pins)
        try:
            if Global.gpu_enable_pipeline:
                # stage every chain segment up front; an index-origin START
                # consumes an index list, not a segment
                lo = q.pattern_step
                if lo == 0 and q.start_from_index() \
                        and _is_index_start(q.get_pattern(0)):
                    lo = 1
                self.dstore.prefetch(q.get_pattern(i) for i in
                                     range(lo, len(q.pattern_group.patterns)))
            self._chain_attempts(q, len(steps))
        finally:
            self.dstore.unpin(pins)

    def _chain_attempts(self, q: SPARQLQuery, device_steps: int) -> None:
        """Dispatch the chain, sync once, and re-run it at exact capacities
        while any step overflowed its class."""
        # blind queries only need the row count: the table stays on device
        blind = q.result.blind
        cap_override: dict[int, int] = {}
        self._last_attempts = 0
        for attempt in range(8):
            self._last_attempts = attempt + 1
            state = _ChainState(q.result)
            for k in range(device_steps):
                step = q.pattern_step + k
                self._dispatch_one(q, q.get_pattern(step), step, state,
                                   cap_override)
            host_table, n, totals = state.sync(blind=blind)
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
        res = q.result
        if blind:
            res.nrows = n
        else:
            res.set_table(host_table[:n].astype(np.int64))
        for var, col in state.new_cols:
            res.add_var2col(var, col)
        res.col_num = state.width
        q.pattern_step += device_steps
        q.local_var = state.local_var

    # ------------------------------------------------------------------
    def _dispatch_one(self, q: SPARQLQuery, pat, step: int,
                      state: "_ChainState", cap_override: dict,
                      anchor_col: int | None = None) -> None:
        start, pid, d, end = pat.subject, pat.predicate, pat.direction, pat.object

        if state.table is None:
            if q.start_from_index() and step == q.pattern_step == 0 \
                    and _is_index_start(pat):
                edges, real = self.dstore.index_list(start, d)
                cap = cap_override.get(step) or K.next_capacity(
                    real, self.cap_min, self.cap_max)
                table, nn = K.init_from_list(edges, real, cap)
                state.begin(table, nn, end, est_rows=real)
                state.local_var = end
                return
            # const_to_unknown start: one host CSR lookup
            assert_ec(q.result.col_num == 0 and state.width == 0,
                      ErrorCode.FIRST_PATTERN_ERROR)
            vids = np.asarray(self.g.get_triples(start, pid, d), dtype=np.int64)
            cap = cap_override.get(step) or K.next_capacity(
                len(vids), self.cap_min, self.cap_max)
            pad = np.zeros((1, cap), dtype=np.int32)  # [width=1, capacity]
            pad[0, : len(vids)] = vids
            state.begin(torch.from_numpy(pad).to(self.device),
                        self._count(len(vids)), end, est_rows=len(vids))
            return

        col = anchor_col if anchor_col is not None else state.col_of(start)
        assert_ec(col is not None, ErrorCode.VERTEX_INVALID)
        seg = self.dstore.segment(pid, d)
        e_col = state.col_of(end) if end < 0 else None
        e_known = end < 0 and e_col is not None

        if end < 0 and not e_known:  # known_to_unknown
            if seg is None:
                state.append_empty_col(end)
                return
            est = self._estimate_rows(state, pat, seg)
            cap_out = cap_override.get(step) or K.next_capacity(
                max(est, self.cap_min), self.cap_min, self.cap_max)
            out, nn, total = K.expand(
                state.table, state.n, seg.bkey, seg.bstart, seg.bdeg,
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
                state.table, state.n, vals, seg.bkey, seg.bstart, seg.bdeg,
                seg.edges, col=col, max_probe=seg.max_probe,
                depth=seg.max_deg_log2)
        cap_new = cap_override.get(step)
        if cap_new is not None and cap_new < C:
            # learned shrink: totals ride along so an underestimate retries
            # the chain, never drops rows
            out, nn, total = K.compact_to(state.table, keep, cap_new)
            state.advance_filter(out, nn)
            state.totals.append((step, total, cap_new))
        else:
            out, nn = K.compact(state.table, keep)
            state.advance_filter(out, nn)

    # ------------------------------------------------------------------
    # batched execution of an index-origin (heavy) query
    # ------------------------------------------------------------------
    def execute_batch_index(self, q: SPARQLQuery, B: int) -> np.ndarray:
        """Replicate mode: B independent full instances of an index-origin
        query in one chain (the qid dimension amortizes the end-of-chain
        sync across B queries). Returns per-qid result row counts (blind
        semantics)."""
        pats = q.pattern_group.patterns
        self._check_batch_index(q)
        if q.planner_empty and Global.enable_empty_shortcircuit:
            return np.zeros(B, dtype=np.int64)
        if Global.enable_merge_join:
            return self.merge.run_batch_index(q, B)
        edges, real = self.dstore.index_list(pats[0].subject, pats[0].direction)
        total0 = real * B
        assert_ec(total0 <= self.cap_max, ErrorCode.UNKNOWN_PATTERN,
                  f"batch-index start ({total0:,} rows) exceeds "
                  f"table_capacity_max ({self.cap_max:,})")

        def make_init(state: "_ChainState") -> None:
            cap0 = K.next_capacity(max(total0, 1), self.cap_min, self.cap_max)
            state.table, state.n = K.init_batch_index(edges, real, B=B,
                                                      cap=cap0)
            state.width = 2
            state.cols[pats[0].object] = 1
            state.est_rows = max(total0, 1)

        return self._run_batch_chain(q, B, make_init)

    def _check_batch_index(self, q: SPARQLQuery) -> None:
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

    def _run_batch_chain(self, q: SPARQLQuery, B: int, make_init) -> np.ndarray:
        pats = q.pattern_group.patterns
        pins = [(p.predicate, p.direction) for p in pats if p.predicate > 0]
        self.dstore.pin(pins)
        try:
            if Global.gpu_enable_pipeline:
                self.dstore.prefetch(pats[1:])  # pattern 0 is an index start
            cap_override: dict[int, int] = {}
            for _attempt in range(8):
                state = _ChainState(q.result)
                make_init(state)
                for k in range(1, len(pats)):
                    pat = q.get_pattern(k)
                    self._dispatch_one(q, pat, k, state, cap_override,
                                       anchor_col=state.col_of(pat.subject))
                counts = _qid_counts(state.table, state.n, B)
                totals = torch.stack([t for (_, t, _) in state.totals]
                                     ).tolist() if state.totals else []
                host_counts = counts.cpu().numpy()
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

    def _fanout(self, pat, seg=None) -> float:
        """Per-row expansion factor estimate: segment average degree x2 (the
        JAX package's stats-free rule; planner stats are not ported yet)."""
        if seg is not None:
            return max(1.0, seg.num_edges / max(seg.num_keys, 1)) * 2
        host = self.g.segments.get((pat.predicate, pat.direction))
        if host is None:
            return 1.0
        return max(1.0, host.num_edges / max(len(host.keys), 1)) * 2

    def _estimate_rows(self, state, pat, seg) -> int:
        """Expected output rows of an expansion step. A wrong estimate costs
        one chain retry, never correctness."""
        est = int(min(state.est_rows * self._fanout(pat, seg), self.cap_max))
        return max(est, 1)


def _is_index_start(pat) -> bool:
    return pat.predicate in (PREDICATE_ID, TYPE_ID)


class _MetaResult:
    """Host-side shadow of column bindings for chain planning (no device data)."""

    def __init__(self, res):
        self.cols = dict(res.v2c_map)
        self.width = res.col_num

    def col_of(self, var: int):
        c = self.cols.get(var)
        return c if c is not None and c != NO_RESULT else None

    def bind(self, pat) -> None:
        if self.width == 0:
            self.cols[pat.object], self.width = 0, 1
            return
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
    qid = torch.where(live, table[0], B)
    return torch.bincount(qid.long(), minlength=B + 1)[:B]


def _final_process(q: SPARQLQuery) -> None:
    """Projection, DISTINCT, OFFSET and LIMIT on the host table (the CPU
    engine's final stage, engine/cpu.py:_final_process in the JAX package,
    without ORDER BY and attribute columns)."""
    res = q.result
    if res.blind or res.table.size == 0:
        if not res.blind and res.table.size == 0 and res.required_vars:
            res.col_num = len(res.required_vars)
            res.table = np.empty((0, res.col_num), dtype=np.int64)
        return
    assert_ec(len(res.required_vars) > 0, ErrorCode.NO_REQUIRED_VAR)
    table = res.table
    cols = [res.var2col(v) for v in res.required_vars]
    assert_ec(all(c != NO_RESULT for c in cols), ErrorCode.NO_REQUIRED_VAR,
              "projection references an unbound variable")
    if q.distinct:
        # sort by the projected columns first so adjacent-dedup is a true
        # DISTINCT
        rest = [c for c in range(table.shape[1]) if c not in cols]
        keys = [table[:, c] for c in reversed(rest)] + \
            [table[:, c] for c in reversed(cols)]
        table = table[np.lexsort(keys)]
        proj = table[:, cols]
        keep = np.ones(len(table), dtype=bool)
        if len(table) > 1:
            keep[1:] = (proj[1:] != proj[:-1]).any(axis=1)
        table = table[keep]
    if q.offset > 0:
        table = table[q.offset:]
    if q.limit >= 0:
        table = table[:q.limit]
    res.set_table(table[:, cols])
    res.col_num = len(cols)
    res.v2c_map = {v: i for i, v in enumerate(res.required_vars)}
