"""OPTIONAL as a dedup-seeded child + host left join.

The port of the JAX package's engine/optional_join.py, which the GPU engine
uses as the TPU engine uses it there.

The reference masks rows in place (optional_matched_rows, query.hpp:782-813);
a left join over the shared bound variables is the same relation: parent rows
extend by every child match, rows with no match survive with BLANK_ID in the
group's new columns. The child is a plain BGP query seeded with the DISTINCT
shared bindings, so it rides whatever chain the executing engine provides
(here the GPU engine's device chain)."""

from __future__ import annotations

import copy

import numpy as np

from wukong_tpu_torch.sparql.ir import NO_RESULT, SPARQLQuery
from wukong_tpu_torch.types import BLANK_ID
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError, assert_ec


def execute_optional_leftjoin(q: SPARQLQuery, host, run_child,
                              str_server=None) -> None:
    """Execute q's next OPTIONAL group as a seeded child + left join.

    `host` supplies the CPU engine's optional bookkeeping (new-var counting,
    execution-time reorder, filter evaluation); `run_child` executes the
    child query on the owning engine."""
    group = q.pattern_group.optional[q.optional_step]
    q.optional_step += 1
    res = q.result
    assert_ec(res.attr_col_num == 0, ErrorCode.UNSUPPORTED_SHAPE,
              "OPTIONAL after attribute patterns is unsupported "
              "in the left-join formulation")
    pg = copy.deepcopy(group)
    host._count_optional_new_vars(pg, res)
    host._reorder_optional_patterns(pg, res)
    # the reference evaluates an OPTIONAL group's FILTERs on the child's
    # MERGED table (the child query re-enters the state machine with the
    # parent rows, cpu.py _execute_optional) — a failing filter drops the
    # whole row, matched or BLANK. So filters run after the join here.
    deferred_filters = pg.filters
    pg.filters = []

    # a parent-bound predicate var cannot seed a child (no bound-predicate
    # kernel exists anywhere; the child would re-solve it unconstrained and
    # join on the wrong relation) — callers route that shape elsewhere
    assert_ec(not any(p.predicate < 0 and res.var2col(p.predicate) != NO_RESULT
                      for p in pg.patterns),
              ErrorCode.UNSUPPORTED_SHAPE,
              "OPTIONAL with a parent-bound predicate var has no "
              "seeded-child formulation")
    # join keys = parent-bound vars used by the group's PATTERNS; the
    # deferred filters see every parent column on the joined table, so
    # filter-only vars never need seeding
    used = {v for p in pg.patterns for v in (p.subject, p.object) if v < 0}
    shared = sorted({v for v in used if res.var2col(v) != NO_RESULT},
                    reverse=True)
    assert_ec(len(shared) > 0, ErrorCode.UNSUPPORTED_SHAPE,
              "OPTIONAL group shares no bound variable with its parent")
    pcols = [res.var2col(v) for v in shared]
    seeds = (np.unique(res.table[:, pcols], axis=0)
             if res.table.size else np.empty((0, len(pcols)), np.int64))

    child = SPARQLQuery()
    child.pqid = q.qid
    child.pattern_group = pg
    child.result.nvars = res.nvars
    child.result.set_table(seeds.astype(np.int64))
    child.result.col_num = len(pcols)
    for i, v in enumerate(shared):
        child.result.add_var2col(v, i)
    child.result.blind = False
    run_child(child)
    if child.result.status_code != ErrorCode.SUCCESS:
        raise WukongError(child.result.status_code, "optional child failed")

    cres = child.result
    ckey = [cres.var2col(v) for v in shared]
    new_vars = [v for v, c in sorted(cres.v2c_map.items(),
                                     key=lambda kv: kv[1])
                if v not in shared and c != NO_RESULT]
    cnew = [cres.var2col(v) for v in new_vars]
    row_idx, new_cols = left_join(
        res.table[:, pcols] if res.table.size
        else np.empty((res.nrows, len(pcols)), np.int64),
        cres.table, ckey, cnew, blank=BLANK_ID)
    base = (res.table[row_idx] if res.table.size
            else np.empty((len(row_idx), res.col_num), np.int64))
    w0 = res.col_num
    res.set_table(np.column_stack([base, new_cols])
                  if new_cols.shape[1] else base)  # updates col_num
    for j, v in enumerate(new_vars):
        res.add_var2col(v, w0 + j)
    if deferred_filters:
        assert_ec(str_server is not None, ErrorCode.UNKNOWN_FILTER,
                  "FILTER needs a string server")
        fq = SPARQLQuery()
        fq.pattern_group.filters = deferred_filters
        fq.result = res
        host._execute_filters(fq)


def left_join(parent_keys: np.ndarray, child_table: np.ndarray,
              ckey_cols: list, cnew_cols: list, blank: int):
    """Left join on key columns: each parent key row expands by all child
    rows with an equal key; keyless parents emit one row with `blank` in the
    new columns. Returns (row_idx into parent, new_cols [L, len(cnew_cols)]).
    """
    N, Kw = parent_keys.shape
    M = len(child_table)
    if M == 0:
        return (np.arange(N, dtype=np.int64),
                np.full((N, len(cnew_cols)), blank, dtype=np.int64))
    dt = np.dtype([(f"f{i}", np.int64) for i in range(Kw)])
    ck = np.ascontiguousarray(
        child_table[:, ckey_cols].astype(np.int64)).view(dt).reshape(-1)
    order = np.argsort(ck)
    ck_s = ck[order]
    cnew_s = (child_table[order][:, cnew_cols].astype(np.int64)
              if cnew_cols else np.empty((M, 0), np.int64))
    uniq, starts, cnts = np.unique(ck_s, return_index=True, return_counts=True)
    pk = np.ascontiguousarray(parent_keys.astype(np.int64)).view(dt).reshape(-1)
    gi = np.searchsorted(uniq, pk)
    gi_c = np.clip(gi, 0, len(uniq) - 1)
    matched = uniq[gi_c] == pk
    mcount = np.where(matched, cnts[gi_c], 1)
    row_idx, local = _expand_rows(mcount)
    out = np.full((len(row_idx), len(cnew_cols)), blank, dtype=np.int64)
    is_m = matched[row_idx]
    if cnew_cols and is_m.any():
        out[is_m] = cnew_s[starts[gi_c[row_idx[is_m]]] + local[is_m]]
    return row_idx, out


def _expand_rows(deg: np.ndarray):
    """Row indices + within-row offsets of a degree expansion (the host
    engine's helper of the same name): deg=[2,0,3] -> row_idx=[0,0,2,2,2],
    local=[0,1,0,1,2]."""
    row_idx = np.repeat(np.arange(len(deg)), deg)
    total = int(deg.sum())
    local = np.ones(total, dtype=np.int64)
    if total:
        starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
        nz = deg > 0
        local[starts[nz]] = np.concatenate([[0], 1 - deg[nz][:-1]])
        local = np.cumsum(local)
    return row_idx, local
