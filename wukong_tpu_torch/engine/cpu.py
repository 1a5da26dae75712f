"""Host engine — the reference SPARQL engine's semantics on numpy.

The port of the JAX package's engine/cpu.py (``CPUEngine``): the 11
triple-pattern kernels keyed by (subject-state, object-state) under
const/known/unknown predicates, attribute patterns, the
PATTERN -> UNION -> OPTIONAL -> FILTER -> FINAL state machine
(execute_sparql_query, sparql.hpp:1564-1673), OPTIONAL row-masking
(optional_matched_rows + correct_optional_result, query.hpp:782-813), UNION
merge (Result::merge_result, query.hpp:497-533), string-space FILTER evaluation
(sparql.hpp:1158-1382), and final DISTINCT/ORDER/OFFSET/LIMIT/projection
(sparql.hpp:1424-1551).

It executes one query against a single-partition GStore. The GPU engine
(engine/tpu.py) hands it exactly the work the JAX TPUEngine hands its CPU
engine: pattern steps past the device prefix, the UNION merge, in-place
OPTIONAL groups, FILTERs and the final stage. The proxy's engine pool runs
whole queries on it, CORUN included (``enable_corun``). Every BGP step checks
the query's deadline and charges its rows to its budget; an expiry keeps the
rows produced so far (``resilience.mark_partial``). A knn() clause composes
through ``_knn_pre`` (a pure scan or a rank-then-pattern chain: the ranked
scan seeds the binding table) and ``_knn_post`` (pattern-then-rank: the
scan ranks the binding set); a device route scans on ``knn_device``.
"""

from __future__ import annotations

import copy
import re

import numpy as np

from wukong_tpu_torch.config import Global
from wukong_tpu_torch.sparql.ir import (
    NO_RESULT,
    Filter,
    FilterType,
    Pattern,
    PatternGroup,
    PGType,
    Result,
    SPARQLQuery,
)
from wukong_tpu_torch.types import (
    BLANK_ID,
    IN,
    OUT,
    PREDICATE_ID,
    TYPE_ID,
    AttrType,
    is_tpid,
)
from wukong_tpu_torch.utils.errors import (
    BudgetExceeded,
    ErrorCode,
    QueryTimeout,
    WukongError,
    assert_ec,
)

CONST_VAR, KNOWN_VAR, UNKNOWN_VAR = 0, 1, 2


def var_stat(res: Result, ssid: int) -> int:
    """query.hpp var_stat: consts are positive; a negative var is KNOWN once bound."""
    if ssid >= 0:
        return CONST_VAR
    if res.var2col(ssid) != NO_RESULT or res.is_attr_var(ssid):
        return KNOWN_VAR
    return UNKNOWN_VAR


def _empty_table(ncols: int) -> np.ndarray:
    return np.empty((0, ncols), dtype=np.int64)


def _rows_in(main_keys: np.ndarray, sub_keys: np.ndarray) -> np.ndarray:
    """Per-row membership of main_keys rows in the sub_keys row set (the corun
    hash/sort join, sparql.hpp:893-930 — vectorized via structured views)."""
    if len(sub_keys) == 0 or main_keys.shape[1] == 0:
        return np.zeros(len(main_keys), dtype=bool)
    a = np.ascontiguousarray(main_keys.astype(np.int64))
    b = np.ascontiguousarray(sub_keys.astype(np.int64))
    dt = np.dtype([(f"f{i}", np.int64) for i in range(a.shape[1])])
    return np.isin(a.view(dt).reshape(-1), np.unique(b.view(dt).reshape(-1)))


def _expand_rows(deg: np.ndarray):
    """Row indices + within-row edge offsets for a degree-expansion step.

    deg=[2,0,3] -> row_idx=[0,0,2,2,2], local=[0,1,0,1,2] (vectorized ragged arange).
    """
    row_idx = np.repeat(np.arange(len(deg)), deg)
    total = int(deg.sum())
    local = np.ones(total, dtype=np.int64)
    if total:
        starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
        nz = deg > 0
        local[starts[nz]] = np.concatenate([[0], 1 - deg[nz][:-1]])
        local = np.cumsum(local)
    return row_idx, local


class CPUEngine:
    def __init__(self, gstore, str_server=None, mt_slices: int = 1):
        self.g = gstore
        self.str_server = str_server
        # where a knn() scan on the device route runs (vector/knn.py): the
        # GPU engine sets its own device; a CPU device runs the plain scan
        self.knn_device = "cpu"

    # ------------------------------------------------------------------
    # top-level state machine (sparql.hpp:1564-1673)
    # ------------------------------------------------------------------
    def execute(self, q: SPARQLQuery, from_proxy: bool = True) -> SPARQLQuery:
        from wukong_tpu_torch.obs.trace import traced_execute

        return traced_execute(
            q, "cpu.execute", lambda: self._execute_impl(q, from_proxy),
            lambda: {"rows": q.result.nrows,
                     "status": q.result.status_code.name})

    def _execute_impl(self, q: SPARQLQuery, from_proxy: bool) -> SPARQLQuery:
        try:
            if q.planner_empty and Global.enable_empty_shortcircuit:
                # planner proved the conjunction empty from exact type stats
                # (planner.hpp:1505-1509 "identified empty result query"):
                # bind the pattern vars over a zero-row table and skip
                # execution entirely
                self.short_circuit_empty(q)
                if from_proxy:
                    self._final_process(q)
                return q
            if q.knn is not None:
                self._knn_pre(q)
            if q.has_pattern and not q.done_patterns():
                self._execute_patterns(q)
            if q.pattern_group.unions and not q.union_done:
                self._execute_unions(q)
            if q.pattern_group.optional:
                while q.optional_step < len(q.pattern_group.optional):
                    self._execute_optional(q)
            if q.pattern_group.filters:
                self._execute_filters(q)
            if q.knn is not None:
                self._knn_post(q)
            if from_proxy:
                self._final_process(q)
        except (QueryTimeout, BudgetExceeded) as e:
            # graceful degradation: keep the rows produced so far, tag the
            # reply incomplete with the dropped patterns
            from wukong_tpu_torch.runtime.resilience import mark_partial

            mark_partial(q, e)
        except WukongError as e:
            q.result.status_code = e.code
        return q

    def short_circuit_empty(self, q: SPARQLQuery) -> None:
        """Materialize the provably-empty result: bind every pattern var over
        a zero-row table (column order = first-mention order, the same
        convention the kernels use) and mark all stages done, so downstream
        consumers (projection, batch counting) see a normal reply."""
        res = q.result
        for pat in (q.pattern_group.patterns
                    + [p for g in q.pattern_group.optional for p in g.patterns]):
            for var in (pat.subject, pat.predicate, pat.object):
                if var < 0 and res.var2col(var) == NO_RESULT:
                    if var == pat.object and pat.pred_type != int(AttrType.SID_t):
                        res.add_var2col(var, res.attr_col_num, pat.pred_type)
                        res.attr_col_num += 1
                    else:
                        res.add_var2col(var, res.col_num)
                        res.col_num += 1
        res.set_table(np.empty((0, res.col_num), dtype=np.int64))
        res.attr_table = np.empty((0, res.attr_col_num), dtype=np.float64)
        q.pattern_step = len(q.pattern_group.patterns)
        q.union_done = True
        q.optional_step = len(q.pattern_group.optional)

    # ------------------------------------------------------------------
    # hybrid graph+vector composition (vector/)
    # ------------------------------------------------------------------
    def _vstore(self):
        vs = getattr(self.g, "vstore", None)
        if vs is None:
            raise WukongError(ErrorCode.ATTR_DISABLE,
                              "knn() needs a vector store attached to this "
                              "partition (loader --vectors / upsert_batch_into)")
        return vs

    def _knn_params(self, q):
        from wukong_tpu_torch.vector import knn as vknn

        vs = self._vstore()
        anchor = vknn.resolve_anchor(vs, q.knn)
        metric = q.knn.metric or Global.knn_metric
        # the proxy stamps the measured route at plan time; direct engine
        # callers default to the host kernels (always available)
        route = getattr(q, "knn_route", None) or "host"
        return vs, anchor, metric, route

    def _knn_pre(self, q: SPARQLQuery) -> None:
        """Seed-side composition: for a pure scan or a rank-then-pattern
        chain, run the ranked scan first and seed the binding table with
        the top-k vids (the corun sub-query seeding idiom) so the BGP
        walks outward from the k winners. Pattern-then-rank defers to
        :meth:`_knn_post`."""
        from wukong_tpu_torch.vector import knn as vknn

        if not Global.enable_vectors:
            raise WukongError(ErrorCode.ATTR_DISABLE,
                              "knn() requires enable_vectors")
        if getattr(q, "knn_mode", None) is None:
            q.knn_mode = vknn.classify_knn_mode(q)
        if q.knn_mode == "pattern_then_rank":
            return
        seeds = getattr(q, "knn_seeds", None)
        if seeds is None:
            # not pre-solved by the proxy's wide-scan slice split: scan here
            vs, anchor, metric, route = self._knn_params(q)
            seeds, _scores, demoted = vknn.scan_topk(
                vs, anchor, q.knn.k, metric, route=route,
                device=self.knn_device)
            if demoted:
                q.knn_demoted = demoted
        res = q.result
        res.set_table(np.asarray(seeds, dtype=np.int64).reshape(-1, 1))
        res.col_num = 1
        res.add_var2col(q.knn.var, 0)

    def _knn_post(self, q: SPARQLQuery) -> None:
        """Rank-side composition (pattern-then-rank): rank the BGP's
        binding set for the knn variable, keep only rows whose binding
        made the top-k, and order surviving rows by rank (ties by
        original row order, stable). Runs after FILTER so ranked rows
        are exactly the rows a pure BGP would have served."""
        from wukong_tpu_torch.vector import knn as vknn

        if getattr(q, "knn_mode", None) != "pattern_then_rank":
            return
        res = q.result
        col = res.var2col(q.knn.var)
        assert_ec(col != NO_RESULT, ErrorCode.NO_REQUIRED_VAR,
                  "knn() variable is not bound by the pattern group")
        vs, anchor, metric, route = self._knn_params(q)
        top, _scores, demoted = vknn.rank_candidates(
            vs, res.table[:, col], anchor, q.knn.k, metric, route=route,
            device=self.knn_device)
        if demoted:
            q.knn_demoted = demoted
        rank = {int(v): i for i, v in enumerate(top)}
        vals = res.table[:, col]
        pos = np.asarray([rank.get(int(v), -1) for v in vals],
                         dtype=np.int64)
        idx = np.nonzero(pos >= 0)[0]
        order = idx[np.argsort(pos[idx], kind="stable")]
        res.set_table(res.table[order])
        if res.attr_table.size:
            res.attr_table = res.attr_table[order]

    def _execute_patterns(self, q: SPARQLQuery) -> None:
        from wukong_tpu_torch.obs.trace import traced_step
        from wukong_tpu_torch.runtime.resilience import (
            charge_query,
            check_query,
        )

        tr = getattr(q, "trace", None)
        while not q.done_patterns():
            check_query(q, f"cpu.bgp step {q.pattern_step}")
            traced_step(tr, q, "cpu.step",
                        lambda: self._execute_one_pattern(q))
            charge_query(q, q.result.nrows,
                         f"cpu.bgp step {q.pattern_step - 1}")
            # co-run optimization at the marked step (sparql.hpp:1130-1131)
            if (q.corun_enabled and Global.enable_corun
                    and q.pattern_step == q.corun_step):
                self._do_corun(q)

    def _do_corun(self, q: SPARQLQuery) -> None:
        """CORUN: execute patterns [corun_step, fetch_step) over the DEDUPED
        binding set of the anchor var, then semi-join the main table against
        the sub-result — trades traversal for a join (sparql.hpp:816-936)."""
        res = q.result
        corun_step, fetch_step = q.corun_step, q.fetch_step
        assert_ec(0 < corun_step < fetch_step
                  <= len(q.pattern_group.patterns),
                  ErrorCode.UNKNOWN_PLAN, "bad corun/fetch steps")
        vid = q.get_pattern(corun_step).subject
        assert_ec(vid < 0 and res.var2col(vid) != NO_RESULT,
                  ErrorCode.VERTEX_INVALID, "corun anchor must be a bound var")
        col = res.var2col(vid)
        uniq = np.unique(res.table[:, col])

        # remap sub-query vars to fresh ids (-1, -2, ...); remember which main
        # column each remapped var corresponds to, in remap order
        sub_vars: dict[int, int] = {}
        pvars_cols: list[int] = []

        def remap(ssid: int) -> int:
            if ssid >= 0:
                return ssid
            if ssid not in sub_vars:
                sub_vars[ssid] = -(len(sub_vars) + 1)
                pvars_cols.append(res.var2col(ssid))
            return sub_vars[ssid]

        sub = SPARQLQuery()
        for i in range(corun_step, fetch_step):
            p = q.get_pattern(i)
            sub.pattern_group.patterns.append(
                Pattern(remap(p.subject), remap(p.predicate), p.direction,
                        remap(p.object)))
        sub.result.nvars = len(sub_vars)
        sub.result.set_table(uniq.reshape(-1, 1).astype(np.int64))
        sub.result.col_num = 1
        sub.result.add_var2col(sub_vars[vid], 0)
        sub.result.blind = False
        self._execute_patterns(sub)

        # semi-join: keep main rows whose remapped-var tuple appears in the
        # sub-result (columns looked up via the sub v2c map, remap order)
        sub_cols = [sub.result.var2col(sub_vars[v])
                    for v in sub_vars]  # insertion order == remap order
        bound = [(sc, mc) for sc, mc in zip(sub_cols, pvars_cols)
                 if sc != NO_RESULT and mc != NO_RESULT]
        sub_keys = sub.result.table[:, [sc for sc, _ in bound]]
        main_keys = res.table[:, [mc for _, mc in bound]]
        keep = _rows_in(main_keys, sub_keys)
        res.set_table(res.table[keep])
        if res.attr_table.size:
            res.attr_table = res.attr_table[keep]
        q.pattern_step = fetch_step

    # ------------------------------------------------------------------
    # pattern dispatch (sparql.hpp:938-1061)
    # ------------------------------------------------------------------
    def _execute_one_pattern(self, q: SPARQLQuery) -> None:
        pat = q.get_pattern()
        res = q.result
        start, pred, d, end = pat.subject, pat.predicate, pat.direction, pat.object

        if q.pattern_step == 0 and q.start_from_index():
            if res.var2col(end) != NO_RESULT:
                self._index_to_known(q)
            else:
                self._index_to_unknown(q)
            return

        ps = var_stat(res, pred)
        if ps != CONST_VAR:
            key = (var_stat(res, start), var_stat(res, end))
            if key == (CONST_VAR, UNKNOWN_VAR):
                self._const_unknown_unknown(q)
            elif key == (CONST_VAR, CONST_VAR):
                self._const_unknown_const(q)
            elif key == (KNOWN_VAR, UNKNOWN_VAR):
                self._known_unknown_unknown(q)
            elif key == (KNOWN_VAR, CONST_VAR):
                self._known_unknown_const(q)
            else:
                raise WukongError(ErrorCode.UNKNOWN_PATTERN,
                                  f"unsupported pattern (pred var) {key}")
        else:
            key = (var_stat(res, start), var_stat(res, end))
            if key == (CONST_VAR, KNOWN_VAR):
                self._const_to_known(q)
            elif key == (CONST_VAR, UNKNOWN_VAR):
                self._const_to_unknown(q)
            elif key == (KNOWN_VAR, CONST_VAR):
                self._known_to_const(q)
            elif key == (KNOWN_VAR, KNOWN_VAR):
                self._known_to_known(q)
            elif key == (KNOWN_VAR, UNKNOWN_VAR):
                self._known_to_unknown(q)
            else:
                raise WukongError(ErrorCode.UNKNOWN_PATTERN,
                                  f"unsupported pattern (const pred) {key}")

    # ------------------------------------------------------------------
    # index kernels (sparql.hpp:80-137, 194-237)
    # ------------------------------------------------------------------
    def _index_edges(self, q: SPARQLQuery) -> np.ndarray:
        pat = q.get_pattern()
        assert_ec(pat.predicate in (PREDICATE_ID, TYPE_ID), ErrorCode.OBJ_ERROR,
                  "index pattern predicate must be __PREDICATE__ or rdf:type")
        edges = self.g.get_index(pat.subject, pat.direction)
        if q.mt_factor > 1:  # mt slice (sparql.hpp:98-108)
            mt = q.mt_tid % q.mt_factor
            length = len(edges) // q.mt_factor
            lo = mt * length
            hi = (mt + 1) * length if mt != q.mt_factor - 1 else len(edges)
            edges = edges[lo:hi]
        return np.asarray(edges, dtype=np.int64)

    def _index_to_unknown(self, q: SPARQLQuery) -> None:
        res = q.result
        assert_ec(res.col_num == 0, ErrorCode.FIRST_PATTERN_ERROR)
        edges = self._index_edges(q)
        res.set_table(edges.reshape(-1, 1))
        res.col_num = 1
        res.add_var2col(q.get_pattern().object, 0)
        q.pattern_step += 1
        q.local_var = q.get_pattern(q.pattern_step - 1).object

    def _index_to_known(self, q: SPARQLQuery) -> None:
        res = q.result
        col = res.var2col(q.get_pattern().object)
        assert_ec(col != NO_RESULT, ErrorCode.VERTEX_INVALID)
        member = np.isin(res.table[:, col], self._index_edges(q))
        self._apply_row_mask(q, member)
        q.pattern_step += 1

    # ------------------------------------------------------------------
    # const kernels (sparql.hpp:138-293)
    # ------------------------------------------------------------------
    def _const_to_unknown(self, q: SPARQLQuery) -> None:
        pat = q.get_pattern()
        res = q.result
        if pat.pred_type != int(AttrType.SID_t):
            self._attr_const_to_unknown(q)
            return
        assert_ec(res.col_num == 0, ErrorCode.FIRST_PATTERN_ERROR)
        vids = np.asarray(
            self.g.get_triples(pat.subject, pat.predicate, pat.direction),
            dtype=np.int64)
        res.set_table(vids.reshape(-1, 1))
        res.col_num = 1
        res.add_var2col(pat.object, 0)
        q.pattern_step += 1

    def _const_to_known(self, q: SPARQLQuery) -> None:
        pat = q.get_pattern()
        res = q.result
        col = res.var2col(pat.object)
        assert_ec(col != NO_RESULT, ErrorCode.VERTEX_INVALID)
        vids = self.g.get_triples(pat.subject, pat.predicate, pat.direction)
        member = np.isin(res.table[:, col], vids)
        self._apply_row_mask(q, member)
        q.pattern_step += 1

    # ------------------------------------------------------------------
    # known kernels (sparql.hpp:295-555)
    # ------------------------------------------------------------------
    def _known_to_unknown(self, q: SPARQLQuery) -> None:
        pat = q.get_pattern()
        res = q.result
        if pat.pred_type != int(AttrType.SID_t):
            self._attr_known_to_unknown(q)
            return
        col = res.var2col(pat.subject)
        cur = res.table[:, col]
        optional = q.pg_type == PGType.OPTIONAL

        start_arr, deg = self._neighbors_many(cur, pat.predicate, pat.direction)
        if optional:
            omr = res.optional_matched_rows
            # unmatched/blank rows pass through with a BLANK column; matched rows
            # with no neighbors also pass through with BLANK (still matched)
            passthru = (~omr) | (cur == BLANK_ID) | (deg == 0)
            deg_eff = np.where(passthru, 1, deg)
            row_idx, local = _expand_rows(deg_eff)
            newcol = np.empty(len(row_idx), dtype=np.int64)
            is_pass = passthru[row_idx]
            newcol[is_pass] = BLANK_ID
            src = ~is_pass
            newcol[src] = self._gather_edges(
                pat.predicate, pat.direction, cur[row_idx[src]],
                start_arr[row_idx[src]], local[src])
            res.optional_matched_rows = np.where(
                passthru & ~omr, False, True)[row_idx]
            res.set_table(np.column_stack([res.table[row_idx], newcol]))
        else:
            row_idx, local = _expand_rows(deg)
            newcol = self._gather_edges(pat.predicate, pat.direction,
                                        cur[row_idx], start_arr[row_idx], local)
            res.set_table(np.column_stack([res.table[row_idx], newcol]))
            if res.attr_table.size:
                res.attr_table = res.attr_table[row_idx]
        res.add_var2col(pat.object, res.col_num - 1)
        q.pattern_step += 1

    def _known_to_known(self, q: SPARQLQuery) -> None:
        pat = q.get_pattern()
        res = q.result
        cur = res.table[:, res.var2col(pat.subject)]
        known = res.table[:, res.var2col(pat.object)]
        ok = self._contains_many(cur, pat.predicate, pat.direction, known)
        self._apply_row_mask(q, ok)
        q.pattern_step += 1

    def _known_to_const(self, q: SPARQLQuery) -> None:
        pat = q.get_pattern()
        res = q.result
        cur = res.table[:, res.var2col(pat.subject)]
        ok = self._contains_many(cur, pat.predicate, pat.direction,
                                 np.full(len(cur), pat.object, dtype=np.int64))
        self._apply_row_mask(q, ok)
        q.pattern_step += 1

    # ------------------------------------------------------------------
    # versatile kernels — UNKNOWN predicate (sparql.hpp:556-757)
    # ------------------------------------------------------------------
    def _const_unknown_unknown(self, q: SPARQLQuery) -> None:
        pat = q.get_pattern()
        res = q.result
        pids = self.g.get_triples(pat.subject, PREDICATE_ID, pat.direction)
        rows = []
        for p in pids:
            vids = self.g.get_triples(pat.subject, int(p), pat.direction)
            for v in vids:
                rows.append((int(p), int(v)))
        res.set_table(np.asarray(rows, dtype=np.int64).reshape(-1, 2))
        res.col_num = 2
        res.add_var2col(pat.predicate, 0)
        res.add_var2col(pat.object, 1)
        q.pattern_step += 1

    def _known_unknown_unknown(self, q: SPARQLQuery) -> None:
        pat = q.get_pattern()
        res = q.result
        col = res.var2col(pat.subject)
        out_rows, out_p, out_v = [], [], []
        for i, cur in enumerate(res.table[:, col]):
            pids = self.g.get_triples(int(cur), PREDICATE_ID, pat.direction)
            for p in pids:
                vids = self.g.get_triples(int(cur), int(p), pat.direction)
                out_rows.extend([i] * len(vids))
                out_p.extend([int(p)] * len(vids))
                out_v.extend(int(v) for v in vids)
        idx = np.asarray(out_rows, dtype=np.int64)
        res.set_table(np.column_stack([
            res.table[idx],
            np.asarray(out_p, dtype=np.int64),
            np.asarray(out_v, dtype=np.int64),
        ]) if len(idx) else _empty_table(res.col_num + 2))
        res.col_num = res.table.shape[1]
        res.add_var2col(pat.predicate, res.col_num - 2)
        res.add_var2col(pat.object, res.col_num - 1)
        q.pattern_step += 1

    def _known_unknown_const(self, q: SPARQLQuery) -> None:
        pat = q.get_pattern()
        res = q.result
        col = res.var2col(pat.subject)
        out_rows, out_p = [], []
        for i, cur in enumerate(res.table[:, col]):
            pids = self.g.get_triples(int(cur), PREDICATE_ID, pat.direction)
            for p in pids:
                vids = self.g.get_triples(int(cur), int(p), pat.direction)
                if np.isin(pat.object, vids):
                    out_rows.append(i)
                    out_p.append(int(p))
        idx = np.asarray(out_rows, dtype=np.int64)
        res.set_table(np.column_stack([
            res.table[idx], np.asarray(out_p, dtype=np.int64)
        ]) if len(idx) else _empty_table(res.col_num + 1))
        res.col_num = res.table.shape[1]
        res.add_var2col(pat.predicate, res.col_num - 1)
        q.pattern_step += 1

    def _const_unknown_const(self, q: SPARQLQuery) -> None:
        pat = q.get_pattern()
        res = q.result
        assert_ec(res.col_num == 0, ErrorCode.FIRST_PATTERN_ERROR)
        pids = self.g.get_triples(pat.subject, PREDICATE_ID, pat.direction)
        out = [int(p) for p in pids
               if np.isin(pat.object,
                          self.g.get_triples(pat.subject, int(p), pat.direction))]
        res.set_table(np.asarray(out, dtype=np.int64).reshape(-1, 1))
        res.col_num = 1
        res.add_var2col(pat.predicate, 0)
        q.pattern_step += 1

    # ------------------------------------------------------------------
    # attribute kernels (sparql.hpp:238-293 attr arm, 295-414 attr arm)
    # ------------------------------------------------------------------
    def _attr_const_to_unknown(self, q: SPARQLQuery) -> None:
        pat = q.get_pattern()
        res = q.result
        assert_ec(pat.direction == OUT, ErrorCode.UNKNOWN_PATTERN, "attr dir must be OUT")
        assert_ec(res.attr_col_num == 0, ErrorCode.FIRST_PATTERN_ERROR)
        v, has = self.g.get_attr(pat.subject, pat.predicate)
        res.attr_table = (np.asarray([[v]], dtype=np.float64)
                          if has else np.empty((0, 1), dtype=np.float64))
        res.nrows = len(res.attr_table)
        res.add_var2col(pat.object, 0, pat.pred_type)
        res.attr_col_num = 1
        q.pattern_step += 1

    def _attr_known_to_unknown(self, q: SPARQLQuery) -> None:
        pat = q.get_pattern()
        res = q.result
        assert_ec(pat.direction == OUT, ErrorCode.UNKNOWN_PATTERN, "attr dir must be OUT")
        col = res.var2col(pat.subject)
        keep, vals = [], []
        for i, cur in enumerate(res.table[:, col]):
            v, has = self.g.get_attr(int(cur), pat.predicate)
            if has:
                keep.append(i)
                vals.append(v)
        idx = np.asarray(keep, dtype=np.int64)
        res.set_table(res.table[idx])
        newcol = np.asarray(vals, dtype=np.float64).reshape(-1, 1)
        res.attr_table = (np.column_stack([res.attr_table[idx], newcol])
                          if res.attr_table.size else newcol)
        res.add_var2col(pat.object, res.attr_col_num, pat.pred_type)
        res.attr_col_num += 1
        q.pattern_step += 1

    # ------------------------------------------------------------------
    # shared helpers
    # ------------------------------------------------------------------
    def _neighbors_many(self, cur: np.ndarray, pid: int, d: int):
        """(start, degree) arrays for each row's neighbor list."""
        if pid == TYPE_ID and d == IN:
            # type membership comes from the (distributed) type index
            # (sparql.hpp:336-340)
            deg = np.zeros(len(cur), dtype=np.int64)
            for t in np.unique(cur):
                deg[cur == t] = len(self.g.get_index(int(t), IN))
            return np.zeros(len(cur), dtype=np.int64), deg
        seg = self._segment(pid, d)
        if seg is None:
            z = np.zeros(len(cur), dtype=np.int64)
            return z, z.copy()
        return seg.lookup_many(cur)

    def _gather_edges(self, pid: int, d: int, cur, start, local) -> np.ndarray:
        if pid == TYPE_ID and d == IN:
            out = np.empty(len(cur), dtype=np.int64)
            for t in np.unique(cur):
                m = cur == t
                out[m] = np.asarray(self.g.get_index(int(t), IN))[local[m]]
            return out
        seg = self._segment(pid, d)
        return seg.edges[start + local] if seg is not None else np.empty(0, np.int64)

    def _contains_many(self, cur, pid: int, d: int, vals) -> np.ndarray:
        if pid == TYPE_ID and d == IN:
            ok = np.zeros(len(cur), dtype=bool)
            for t in np.unique(cur):
                m = cur == t
                ok[m] = np.isin(vals[m], self.g.get_index(int(t), IN))
            return ok
        seg = self._segment(pid, d)
        if seg is None:
            return np.zeros(len(cur), dtype=bool)
        return seg.contains_pair(cur, vals)

    def _segment(self, pid: int, d: int):
        if pid == PREDICATE_ID:
            return self.g.vp.get(int(d))
        return self.g.segments.get((int(pid), int(d)))

    def _apply_row_mask(self, q: SPARQLQuery, ok: np.ndarray) -> None:
        """Keep matched rows; under OPTIONAL mask instead (sparql.hpp:416-483)."""
        res = q.result
        if q.pg_type == PGType.OPTIONAL:
            omr = res.optional_matched_rows
            newly_failed = omr & ~ok
            if newly_failed.any():
                self._correct_optional_rows(q, newly_failed)
            res.optional_matched_rows = omr & ok
        else:
            res.set_table(res.table[ok])
            if res.attr_table.size:
                res.attr_table = res.attr_table[ok]

    def _correct_optional_rows(self, q: SPARQLQuery, rows_mask: np.ndarray) -> None:
        """correct_optional_result (query.hpp:806-813): blank this group's new vars."""
        res = q.result
        for var in q.pattern_group.optional_new_vars:
            col = res.var2col(var)
            if col != NO_RESULT:
                res.table[rows_mask, col] = BLANK_ID

    # ------------------------------------------------------------------
    # UNION (sparql.hpp:1593-1613, query.hpp:702-711 inherit_union,
    #        query.hpp:497-533 merge_result)
    # ------------------------------------------------------------------
    def _execute_unions(self, q: SPARQLQuery, child_exec=None) -> None:
        """UNION branches as seeded children (query.hpp:702-711
        inherit_union). `child_exec` lets an accelerator engine route the
        children through itself (the branch BGP then rides its chain)
        while the merge semantics stay in one place here."""
        run = child_exec or (lambda c: self.execute(c, from_proxy=False))
        q.union_done = True
        merged: Result | None = None
        for idx, sub_pg in enumerate(q.pattern_group.unions):
            child = SPARQLQuery()
            child.pqid = q.qid
            child.pg_type = PGType.UNION
            child.pattern_group = sub_pg
            child.deadline = q.deadline  # children share the parent's budget
            child.trace = getattr(q, "trace", None)  # ... and its trace
            child.result = copy.deepcopy(q.result)
            child.result.blind = False
            child.mt_factor = q.mt_factor if child.start_from_index() else 1
            run(child)
            if child.result.status_code != ErrorCode.SUCCESS:
                raise WukongError(child.result.status_code, "union child failed")
            merged = self._merge_union(merged, child.result, q.result.nvars)
        q.result.v2c_map = merged.v2c_map
        q.result.col_num = merged.col_num
        q.result.set_table(merged.table)

    def _merge_union(self, whole: Result | None, part: Result, nvars: int) -> Result:
        if whole is None:
            whole = Result(nvars)
        assert_ec(part.attr_col_num == 0, ErrorCode.UNSUPPORT_UNION)
        # grow columns for vars bound by this part but absent in the whole
        col_map = {}  # whole col -> part col (-1 = blank)
        for v in range(1, nvars + 1):
            vid = -v
            wc, pc = whole.var2col(vid), part.var2col(vid)
            if wc == NO_RESULT and pc != NO_RESULT:
                whole.add_var2col(vid, whole.col_num)
                col_map[whole.col_num] = pc
                whole.col_num += 1
            elif wc != NO_RESULT:
                col_map[wc] = pc if pc != NO_RESULT else -1
        new_rows = np.full((part.nrows, whole.col_num), BLANK_ID, dtype=np.int64)
        for wc, pc in col_map.items():
            if pc != -1 and part.table.size:
                new_rows[:, wc] = part.table[:, pc]
        if whole.table.size:
            old = np.full((whole.nrows, whole.col_num), BLANK_ID, dtype=np.int64)
            old[:, :whole.table.shape[1]] = whole.table
            whole.set_table(np.concatenate([old, new_rows]))
        else:
            whole.set_table(new_rows)
        return whole

    # ------------------------------------------------------------------
    # OPTIONAL (sparql.hpp:1616-1649, query.hpp:726-803)
    # ------------------------------------------------------------------
    def _execute_optional(self, q: SPARQLQuery) -> None:
        child = SPARQLQuery()
        child.pqid = q.qid
        child.pg_type = PGType.OPTIONAL
        child.deadline = q.deadline  # children share the parent's budget
        child.trace = getattr(q, "trace", None)  # ... and its trace
        child.pattern_group = copy.deepcopy(q.pattern_group.optional[q.optional_step])
        q.optional_step += 1
        self._count_optional_new_vars(child.pattern_group, q.result)
        self._reorder_optional_patterns(child.pattern_group, q.result)
        child.result = copy.deepcopy(q.result)
        child.result.blind = False
        child.result.optional_matched_rows = np.ones(q.result.nrows, dtype=bool)
        child.mt_factor = q.mt_factor if child.start_from_index() else 1
        # children re-enter the full state machine (nested groups/filters run too)
        self.execute(child, from_proxy=False)
        if child.result.status_code != ErrorCode.SUCCESS:
            raise WukongError(child.result.status_code, "optional child failed")
        q.result.v2c_map = child.result.v2c_map
        q.result.col_num = child.result.col_num
        q.result.set_table(child.result.table)

    def _count_optional_new_vars(self, pg: PatternGroup, res: Result) -> None:
        for p in pg.patterns:
            for fldv in (p.subject, p.predicate, p.object):
                if fldv < 0 and res.var2col(fldv) == NO_RESULT:
                    pg.optional_new_vars.add(fldv)

    def _reorder_optional_patterns(self, pg: PatternGroup, res: Result) -> None:
        """Restrictive patterns first (query.hpp:736-781), greedily
        re-simulating bindings: a var UNKNOWN against the parent result may
        become known through an EARLIER group pattern, so classification
        runs round by round over the growing bound set. Patterns whose only
        bound endpoint is the OBJECT are oriented to expand along IN (the
        planner does this for main-group patterns; optional groups are
        planned here, at execution time)."""
        bound = {v for v in res.v2c_map if res.var2col(v) != NO_RESULT}
        bound |= set(res.attr_v2c_map)
        remaining = list(pg.patterns)
        out = []

        def stat(v):
            if v >= 0:
                return CONST_VAR
            return KNOWN_VAR if v in bound else UNKNOWN_VAR

        while remaining:
            best = None  # (rank, idx, oriented_pattern)
            for i, p in enumerate(remaining):
                if is_tpid(p.subject):
                    rank = 0 if stat(p.object) != UNKNOWN_VAR else 2
                    cand = p
                else:
                    key = (stat(p.subject), stat(p.object))
                    if UNKNOWN_VAR not in key:
                        rank, cand = 0, p
                    elif key[0] in (CONST_VAR, KNOWN_VAR):
                        rank = 1 if key[0] == KNOWN_VAR else 2
                        cand = p
                    elif key[1] in (CONST_VAR, KNOWN_VAR):
                        rank = 1 if key[1] == KNOWN_VAR else 2
                        # flip, don't hardcode: a plan-file '<' pattern is
                        # already IN, and its object-anchored flip is OUT
                        flip = IN if p.direction == OUT else OUT
                        cand = Pattern(p.object, p.predicate, flip,
                                       p.subject, p.pred_type)
                    else:
                        continue  # both endpoints unknown: not yet runnable
                if best is None or rank < best[0]:
                    best = (rank, i, cand)
                    if rank == 0:
                        break
            if best is None:  # nothing executable: keep original order
                out.extend(remaining)
                break
            _rank, i, cand = best
            src = remaining.pop(i)
            out.append(cand)
            for v in (src.subject, src.predicate, src.object):
                if v < 0:
                    bound.add(v)
        pg.patterns[:] = out

    # ------------------------------------------------------------------
    # FILTER (sparql.hpp:1158-1382)
    # ------------------------------------------------------------------
    def _execute_filters(self, q: SPARQLQuery) -> None:
        res = q.result
        keep = np.ones(res.nrows, dtype=bool)
        for f in q.pattern_group.filters:
            self._general_filter(f, res, keep)
        res.set_table(res.table[keep])
        if res.attr_table.size:
            res.attr_table = res.attr_table[keep]

    def _general_filter(self, f: Filter, res: Result, keep: np.ndarray) -> None:
        if f.type == FilterType.And:
            self._general_filter(f.arg1, res, keep)
            self._general_filter(f.arg2, res, keep)
        elif f.type == FilterType.Or:
            k1 = np.ones(len(keep), dtype=bool)
            k2 = np.ones(len(keep), dtype=bool)
            self._general_filter(f.arg1, res, k1)
            self._general_filter(f.arg2, res, k2)
            keep &= k1 | k2
        elif f.type == FilterType.Not:
            k1 = np.ones(len(keep), dtype=bool)
            self._general_filter(f.arg1, res, k1)
            keep &= ~k1
        elif f.type in (FilterType.Equal, FilterType.NotEqual, FilterType.Less,
                        FilterType.LessOrEqual, FilterType.Greater,
                        FilterType.GreaterOrEqual):
            self._relational_filter(f, res, keep)
        elif f.type == FilterType.Builtin_bound:
            col = res.var2col(f.arg1.valueArg)
            if col == NO_RESULT:
                keep &= False  # a never-bound variable is unbound on every row
            else:
                keep &= res.table[:, col] != BLANK_ID
        elif f.type == FilterType.Builtin_isiri:
            self._str_match_filter(f, res, keep, lambda s: s.startswith("<"))
        elif f.type == FilterType.Builtin_isliteral:
            self._str_match_filter(f, res, keep, lambda s: s.startswith('"'))
        elif f.type == FilterType.Builtin_regex:
            try:
                flags = re.IGNORECASE if (f.arg3 and f.arg3.value.strip('"') == "i") else 0
                pat = re.compile(f.arg2.value.strip('"'), flags)
            except re.error:
                raise WukongError(ErrorCode.UNKNOWN_FILTER, "bad regex")
            self._str_match_filter(
                f, res, keep,
                lambda s: (s.startswith('"')
                           and pat.fullmatch(s.strip('"')) is not None))
        else:
            raise WukongError(ErrorCode.UNKNOWN_FILTER, str(f.type))

    def _row_strings(self, res: Result, f: Filter) -> np.ndarray:
        """String value per row for a Variable/Literal filter arg."""
        if f.type == FilterType.Variable:
            col = res.var2col(f.valueArg)
            assert_ec(col != NO_RESULT, ErrorCode.VERTEX_INVALID)
            ids = res.table[:, col]
            uniq = np.unique(ids)
            m = {int(u): (self.str_server.id2str(int(u))
                          if self.str_server.exist_id(int(u)) else "")
                 for u in uniq}
            return np.asarray([m[int(i)] for i in ids], dtype=object)
        if f.type == FilterType.Literal:
            v = f.value if f.value.startswith('"') else f'"{f.value}"'
            return np.asarray([v] * res.nrows, dtype=object)
        raise WukongError(ErrorCode.UNKNOWN_FILTER, "unsupported filter operand")

    @staticmethod
    def _attr_operand(res: Result, f: Filter):
        """Numeric row values when the operand involves an attribute var,
        else None. (Beyond the reference: its FILTER path only compares
        result_table strings — sparql.hpp:1158-1382 — so attr-var filters
        are impossible there; here FILTER(?age > 21) works numerically.)"""
        if f.type == FilterType.Variable and res.is_attr_var(f.valueArg):
            col, _t = res.attr_v2c_map[f.valueArg]
            return np.asarray(res.attr_table[:, col], dtype=np.float64)
        if f.type == FilterType.Literal:
            try:
                return np.full(res.nrows, float(f.value.strip('"')))
            except ValueError:
                return None
        return None

    def _relational_filter(self, f: Filter, res: Result, keep: np.ndarray) -> None:
        # numeric comparison when either side is an attribute var
        na, nb = self._attr_operand(res, f.arg1), self._attr_operand(res, f.arg2)
        attr_cmp = (
            (f.arg1.type == FilterType.Variable and res.is_attr_var(f.arg1.valueArg))
            or (f.arg2.type == FilterType.Variable
                and res.is_attr_var(f.arg2.valueArg)))
        if attr_cmp:
            assert_ec(na is not None and nb is not None,
                      ErrorCode.UNKNOWN_FILTER,
                      "attribute filters compare numbers")
            a, b = na, nb
        else:
            a = self._row_strings(res, f.arg1)
            b = self._row_strings(res, f.arg2)
        if f.type == FilterType.Equal:
            keep &= a == b
        elif f.type == FilterType.NotEqual:
            keep &= a != b
        elif f.type == FilterType.Less:
            keep &= a < b
        elif f.type == FilterType.LessOrEqual:
            keep &= a <= b
        elif f.type == FilterType.Greater:
            keep &= a > b
        elif f.type == FilterType.GreaterOrEqual:
            keep &= a >= b

    def _str_match_filter(self, f: Filter, res: Result, keep, pred) -> None:
        col = res.var2col(f.arg1.valueArg)
        assert_ec(col != NO_RESULT, ErrorCode.VERTEX_INVALID)
        ids = res.table[:, col]
        uniq = np.unique(ids)
        m = {int(u): pred(self.str_server.id2str(int(u)))
             if self.str_server.exist_id(int(u)) else False for u in uniq}
        keep &= np.asarray([m[int(i)] for i in ids], dtype=bool)

    # ------------------------------------------------------------------
    # FINAL (sparql.hpp:1424-1551)
    # ------------------------------------------------------------------
    def _final_process(self, q: SPARQLQuery) -> None:
        res = q.result
        if res.blind or res.table.size == 0:
            # projection metadata still applies on empty tables
            if not res.blind and res.table.size == 0 and res.required_vars:
                res.col_num = len([v for v in res.required_vars
                                   if not res.is_attr_var(v)])
                res.table = _empty_table(res.col_num)
            return
        assert_ec(len(res.required_vars) > 0, ErrorCode.NO_REQUIRED_VAR)

        table = res.table
        if q.distinct or q.orders:
            if q.distinct:
                # sort by the PROJECTED columns first so adjacent-dedup is a
                # true DISTINCT. (The reference sorts by all columns and dedups
                # adjacent rows on projected columns only — final_process,
                # sparql.hpp:1445-1472 — which misses duplicates separated by
                # hidden columns; we fix that here.)
                cols = [res.var2col(v) for v in res.required_vars
                        if not res.is_attr_var(v)]
                rest = [c for c in range(table.shape[1]) if c not in cols]
                keys = [table[:, c] for c in reversed(rest)] + \
                    [table[:, c] for c in reversed(cols)]
                table = table[np.lexsort(keys)]
                proj = table[:, cols]
                keep = np.ones(len(table), dtype=bool)
                if len(table) > 1:
                    keep[1:] = (proj[1:] != proj[:-1]).any(axis=1)
                table = table[keep]
            else:
                table = table[np.lexsort(table.T[::-1])]
            if q.orders:
                keys = []
                for o in reversed(q.orders):
                    col = res.var2col(o.id)
                    assert_ec(col != NO_RESULT, ErrorCode.VERTEX_INVALID,
                              "ORDER BY references an unbound variable")
                    vals = table[:, col]
                    uniq = np.unique(vals)
                    m = {int(u): (self.str_server.id2str(int(u))
                                  if self.str_server.exist_id(int(u)) else "")
                         for u in uniq}
                    k = np.asarray([m[int(v)] for v in vals])
                    if o.descending:
                        # invert ordering by negating the rank
                        ranks = {s: -i for i, s in enumerate(sorted(set(k.tolist())))}
                        k = np.asarray([ranks[s] for s in k])
                    keys.append(k)
                table = table[np.lexsort(keys)]

        if q.offset > 0:
            table = table[q.offset:]
        if q.limit >= 0:
            table = table[:q.limit]

        # projection: requested entity vars, then attr vars
        normal = [v for v in res.required_vars if not res.is_attr_var(v)]
        attr = [v for v in res.required_vars if res.is_attr_var(v)]
        cols = [res.var2col(v) for v in normal]
        assert_ec(all(c != NO_RESULT for c in cols), ErrorCode.NO_REQUIRED_VAR,
                  "projection references an unbound variable")
        res.set_table(table[:, cols])
        res.col_num = len(cols)
        res.v2c_map = {v: i for i, v in enumerate(normal)}
        if attr and res.attr_table.size:
            acols = [res.attr_v2c_map[v][0] for v in attr]
            res.attr_table = res.attr_table[:, acols]
            res.attr_col_num = len(acols)
