"""Template signatures and the plan cache of the serving path.

The port's copy of the plan-cache part of the JAX package's
runtime/batcher.py (:137-306): a template signature abstracts a query's
normal-id constants, a plan recipe replays a planned join order onto any
query of the same signature, and ``PlanCache`` keeps recipes (and small
per-template plan facts) in a bounded LRU keyed on signature and store
version. ``QueryBatcher`` and the fused groups of that module are not ported
yet.
"""

from __future__ import annotations

from wukong_tpu_torch.config import Global
from wukong_tpu_torch.sparql.ir import Pattern, SPARQLQuery
from wukong_tpu_torch.types import NORMAL_ID_START, PREDICATE_ID, TYPE_ID
from wukong_tpu_torch.utils.lru import LRUCache


def template_signature(q: SPARQLQuery):
    """Pre-plan template signature: the pattern structure with normal-id
    constants abstracted out. Two queries with the same signature may share
    one plan (any valid join order yields the same result set). Returns
    None for shapes the plan cache does not cover (unions/optionals plan
    recursively; attr patterns ride along fine)."""
    pg = q.pattern_group
    if pg.unions or pg.optional or not pg.patterns:
        return None

    def elem(v: int):
        if v < 0:
            return ("v", v)
        if v >= NORMAL_ID_START:
            return "C"  # abstracted: the template's variable constant
        return ("k", v)  # type ids / specials: structural, kept concrete

    return tuple(
        (elem(p.subject),
         p.predicate if p.predicate >= 0 else ("v", p.predicate),
         int(p.direction), elem(p.object), int(p.pred_type))
        for p in pg.patterns)


def build_plan_recipe(parsed_patterns: list, q: SPARQLQuery):
    """Encode a planned query as a positional recipe over its parsed
    (pre-plan) patterns, so the plan can be replayed onto any same-signature
    query with different constants. Returns None when the plan is not
    safely replayable (planner-proved-empty plans depend on the concrete
    constants; duplicated abstracted constants are positionally ambiguous).
    """
    if q.planner_empty or q.corun_enabled:
        return None
    # parsed value -> positions; field index 0/1/2 = subject/predicate/object
    slots: dict[int, list] = {}
    for i, (s, p, _d, o, _t) in enumerate(parsed_patterns):
        for fi, v in ((0, s), (1, p), (2, o)):
            if v >= 0:
                slots.setdefault(v, []).append((i, fi))

    def enc(v: int):
        if v < 0:
            return ("v", v)
        sl = slots.get(v)
        if sl is None:
            # plan-introduced structural ids only (index-start rewrites)
            return ("lit", v) if v in (PREDICATE_ID, TYPE_ID) else None
        # positions that are concrete in the signature (predicates, type
        # ids) pin the value — no substitution needed
        if any(fi == 1 or v < NORMAL_ID_START for (_i, fi) in sl):
            return ("lit", v)
        if len(sl) > 1:
            return None  # ambiguous duplicate of an abstracted constant
        return ("slot", sl[0])

    recipe = []
    for pat in q.pattern_group.patterns:
        es, ep, eo = enc(pat.subject), enc(pat.predicate), enc(pat.object)
        if es is None or ep is None or eo is None:
            return None
        recipe.append((es, ep, int(pat.direction), eo, int(pat.pred_type)))
    return tuple(recipe)


def apply_plan_recipe(q: SPARQLQuery, recipe) -> bool:
    """Replay a cached plan recipe onto a freshly parsed same-signature
    query. Builds the new pattern list fully before swapping it in."""
    pats = q.pattern_group.patterns

    def dec(e):
        kind, val = e
        if kind in ("v", "lit"):
            return val
        i, fi = val
        p = pats[i]
        return (p.subject, p.predicate, p.object)[fi]

    try:
        new = [Pattern(dec(es), dec(ep), d, dec(eo), pt)
               for (es, ep, d, eo, pt) in recipe]
    except (IndexError, TypeError):  # stale/foreign recipe: replan
        return False
    q.pattern_group.patterns[:] = new
    return True


class PlanCache:
    """Template signature + store version -> plan recipe (bounded LRU).

    Keying on the store version makes store changes self-invalidating: a
    bumped version never matches a stale entry, and the LRU evicts the
    dead keys."""

    def __init__(self, maxsize: int | None = None):
        self._lru = LRUCache(maxsize or Global.plan_cache_size)

    def lookup(self, q: SPARQLQuery, sig, version) -> bool:
        if sig is None:
            return False
        recipe = self._lru.get((sig, version))
        if recipe is None:
            return False
        if not apply_plan_recipe(q, recipe):
            # an entry existed but could not apply (stale/foreign recipe):
            # drop it so the next lookup misses cleanly
            self._lru.pop((sig, version))
            return False
        return True

    def record(self, parsed_patterns, q: SPARQLQuery, sig, version) -> None:
        if sig is None:
            return
        recipe = build_plan_recipe(parsed_patterns, q)
        if recipe is not None:
            self._lru.put((sig, version), recipe)

    def aux(self, kind: str, sig, version, compute):
        """Memoized per-template auxiliary plan facts (the device slice
        count), keyed like a plan recipe on signature + store version.
        ``sig`` None computes uncached."""
        if sig is None:
            return compute()
        key = (kind, sig, version)
        v = self._lru.get(key)
        if v is None:
            v = compute()
            self._lru.put(key, v)
        return v

    def __len__(self) -> int:
        return len(self._lru)


def snapshot_patterns(q: SPARQLQuery) -> list:
    """Pre-plan pattern snapshot for build_plan_recipe (plan mutates the
    list in place)."""
    return [(p.subject, p.predicate, p.direction, p.object, p.pred_type)
            for p in q.pattern_group.patterns]
