"""Greedy fallback planner (used until/unless the cost-based optimizer,
planner/optimizer.py, runs).

Produces a valid execution plan: orders patterns so every step starts from a
CONST or KNOWN endpoint, orienting directions (and rewriting the first pattern
to a const/type-index/predicate-index start) the same way the reference's plans
do. This replaces nothing in the reference (its planner is cost-based,
core/planner.hpp). Same plans as the JAX package's planner/heuristic.py.
"""

from __future__ import annotations

from wukong_tpu_torch.sparql.ir import Pattern, PatternGroup, SPARQLQuery
from wukong_tpu_torch.types import IN, NORMAL_ID_START, OUT, PREDICATE_ID, TYPE_ID, is_tpid
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError


def bound_vars(pg: PatternGroup) -> set:
    """Variables bound once a group's patterns have executed."""
    return {v for p in pg.patterns
            for v in (p.subject, p.predicate, p.object) if v < 0}


def plan_seeded_group(pg: PatternGroup, seed_known: set) -> bool:
    """Plan a UNION branch against inherited bindings (inherit_union,
    query.hpp:702-711). True if the branch anchors on a seeded var in
    subject/object position (planned in place, starting from that binding
    instead of a whole-graph index scan); False for disjoint branches —
    the caller plans those independently. THE single anchorability test:
    predicate-position sharing alone never anchors a chain."""
    anchored = any((p.subject < 0 and p.subject in seed_known)
                   or (p.object < 0 and p.object in seed_known)
                   for p in pg.patterns)
    if anchored:
        _plan_group(pg, seed_known=seed_known)
    return anchored


def heuristic_plan(q: SPARQLQuery) -> None:
    _plan_group(q.pattern_group)
    parent_bound = bound_vars(q.pattern_group)
    for u in q.pattern_group.unions:
        if not plan_seeded_group(u, parent_bound):
            _plan_group(u)
    # OPTIONAL groups are reordered at execution time against the bound result
    # (query.hpp reorder_optional_patterns), not planned here.


def _plan_group(pg: PatternGroup, seed_known: set | None = None) -> None:
    if not pg.patterns:
        return
    remaining = list(pg.patterns)
    planned: list[Pattern] = []
    known: set[int] = set(seed_known or ())

    def bindable(p: Pattern):
        """Orientation score for executing p next; higher is better.

        Mid-plan steps must be anchored on a KNOWN variable (const starts are
        only legal as the first pattern — const_to_unknown/const_unknown_*
        assert an empty table, sparql.hpp:246/717). Valid mid-plan shapes:
        k2k/k2c/c2k (filters, score 3), k2u / known_unknown_* (score 1).
        """
        s_var_known = p.subject < 0 and p.subject in known
        o_var_known = p.object < 0 and p.object in known
        if not (s_var_known or o_var_known):
            return None
        if p.pred_type != 0:  # attr patterns last: they decorate, never prune
            return 0
        s_bound = p.subject > 0 or s_var_known
        o_bound = p.object > 0 or o_var_known
        return 3 if (s_bound and o_bound) else 1

    # choose the start pattern: const start > type pattern > predicate index
    if known and any(bindable(p) is not None for p in remaining):
        # a seeded group (UNION branch) anchors on an inherited binding;
        # no start pattern needed — the greedy loop below orders everything
        first = None
    else:
        first = None
        for p in remaining:
            if (0 < p.subject and not is_tpid(p.subject)) or \
               (0 < p.object and not is_tpid(p.object)
                    and p.object >= NORMAL_ID_START):
                first = p
                break
        if first is None:
            # type-index start on a type pattern, else predicate-index start
            tpat = next((p for p in remaining
                         if p.predicate == TYPE_ID and is_tpid(p.object)),
                        None)
            if tpat is not None:
                remaining.remove(tpat)
                planned.append(Pattern(tpat.object, TYPE_ID, IN, tpat.subject))
            else:
                p0 = next((p for p in remaining if p.predicate > 1), None)
                if p0 is None:
                    raise WukongError(ErrorCode.UNKNOWN_PLAN,
                                      "no plannable start pattern")
                # predicate-index start: bind the subject side, keep the
                # pattern
                planned.append(
                    Pattern(p0.predicate, PREDICATE_ID, IN, p0.subject))
    if first is not None:
        remaining.remove(first)
        if first.subject > 0 and first.subject >= NORMAL_ID_START:
            planned.append(Pattern(first.subject, first.predicate, OUT,
                                   first.object, first.pred_type))
        else:  # const object: flip
            planned.append(Pattern(first.object, first.predicate, IN,
                                   first.subject, first.pred_type))
    for p in planned:
        _note_known(p, known)

    while remaining:
        best, best_score = None, -1
        for p in remaining:
            sc = bindable(p)
            if sc is not None and sc > best_score:
                best, best_score = p, sc
        if best is None:
            raise WukongError(ErrorCode.UNKNOWN_PLAN,
                              "disconnected pattern group")
        remaining.remove(best)
        # anchor on a KNOWN var side: prefer subject if it's a known var,
        # else a const subject with known object stays as written
        # (const_to_known). Variable-predicate patterns have no const-anchored
        # kernel mid-plan (no [CONST|UNKNOWN|KNOWN] kernel, sparql.hpp:981-983),
        # so they must anchor on the known VARIABLE side.
        s_var_known = best.subject < 0 and best.subject in known
        pred_is_var = best.predicate < 0
        s_const_ok = best.subject > 0 and not pred_is_var
        if s_var_known or s_const_ok:
            oriented = Pattern(best.subject, best.predicate, OUT, best.object,
                               best.pred_type)
        else:
            oriented = Pattern(best.object, best.predicate, IN, best.subject,
                               best.pred_type)
        planned.append(oriented)
        _note_known(oriented, known)

    pg.patterns[:] = planned


def _note_known(p: Pattern, known: set) -> None:
    for v in (p.subject, p.predicate, p.object):
        if v < 0:
            known.add(v)
