"""Query-graph analysis for the tensor-join (WCOJ) execution strategy.

The port's copy of the JAX package's join/qgraph.py (host-only Python).

A planned BGP is re-read as a *join graph*: one node per variable, one edge
per pattern joining two variables, plus unary constraints (type membership,
const-neighbor lists, predicate-index membership) hanging off single nodes.
Two questions are answered here:

- **Is the query cyclic?** The walk's intermediates blow up exactly when the
  join graph has a cycle (a triangle query materializes the full wedge set
  before the closing edge filters it). Cyclicity is union-find over the
  binary edges: an edge whose endpoints are already connected closes a
  cycle — parallel edges between the same pair count, matching the walk's
  expand-then-filter behavior on them.
- **In what order should variables be materialized?** The generic-join
  attribute order. The analyzer consumes the PLANNED pattern list, whose
  order the cost-based optimizer already derived from the type-centric
  cardinality stats (branch-and-bound over the joint type table) — so
  the variables' first-mention order, anchor side first, IS the
  stats-derived attribute order, and it is connected by construction
  (every planned step anchors on a bound variable). A measured
  alternative — re-ordering greedily by per-variable global candidate
  counts — loses badly on shapes like the same-genre pentagon, where a
  globally-small variable (21 genres) makes a catastrophic level-0
  anchor (16.9M vs 0.5M peak candidates on the WatDiv cyclic set);
  conditional (plan-order) cardinality beats marginal cardinality.

The analyzer consumes patterns in *engine form* (anchor in the subject
slot, direction selecting the adjacency side — the shape the planner
emits), normalizing them back to triple-wise (s, p, o) orientation.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from wukong_tpu_torch.types import IN, OUT, PREDICATE_ID, TYPE_ID, is_tpid

#: unary-constraint kinds (payloads documented on Unary)
U_TYPE, U_CONST, U_PINDEX = "type", "const", "pindex"


@dataclass(frozen=True)
class Unary:
    """One single-variable constraint.

    kind U_TYPE:   payload = type id      (var ∈ type index of payload)
    kind U_CONST:  payload = (const, pid, d)
                   (var ∈ neighbors(const, pid, d) — a const endpoint)
    kind U_PINDEX: payload = (pid, d)
                   (var ∈ predicate index of pid on side d)
    """

    var: int
    kind: str
    payload: tuple | int


@dataclass(frozen=True)
class Edge:
    """One binary join edge in TRIPLE orientation: (s_var, pid, o_var)."""

    s: int
    pid: int
    o: int


@dataclass
class QueryGraph:
    """Analysis result: shape support, cyclicity, and elimination order."""

    supported: bool
    reason: str = ""
    vars: tuple = ()
    order: tuple = ()  # variable elimination order (generic-join order)
    cyclic: bool = False
    unaries: list = field(default_factory=list)  # list[Unary]
    edges: list = field(default_factory=list)  # list[Edge]

    def unaries_of(self, v: int) -> list:
        return [u for u in self.unaries if u.var == v]

    def edges_of(self, v: int) -> list:
        return [e for e in self.edges if v in (e.s, e.o)]


def _find(parent: dict, x: int) -> int:
    while parent[x] != x:
        parent[x] = parent[parent[x]]
        x = parent[x]
    return x


def analyze(patterns: list, stats=None) -> QueryGraph:
    """Build the join graph of an already-planned pattern list.

    Returns a QueryGraph with ``supported=False`` (and a reason) for shapes
    the WCOJ executor does not handle — variable predicates, attribute
    patterns, self-loops, meta-predicate expansions, or components without
    any unary anchor. Unsupported shapes route ``walk``; they are never a
    hard error.
    """
    if not patterns:
        return QueryGraph(False, "empty pattern group")
    unaries: list[Unary] = []
    edges: list[Edge] = []
    vars_seen: list[int] = []  # ENGINE-order first mention (anchor first)

    def note(v: int) -> None:
        if v not in vars_seen:
            vars_seen.append(v)

    for p in patterns:
        if p.pred_type != 0:
            return QueryGraph(False, "attribute pattern")
        if p.predicate < 0:
            return QueryGraph(False, "variable predicate")
        # index-origin forms: subject is a type/pred id, not an entity
        if is_tpid(p.subject):
            if p.predicate == TYPE_ID and p.object < 0:
                # (T, rdf:type, IN, ?x): type-index membership
                note(p.object)
                unaries.append(Unary(p.object, U_TYPE, p.subject))
                continue
            if p.predicate == PREDICATE_ID and p.object < 0:
                # (pid, __PREDICATE__, d, ?x): predicate-index membership
                note(p.object)
                unaries.append(Unary(p.object, U_PINDEX,
                                     (p.subject, int(p.direction))))
                continue
            return QueryGraph(False, "unrecognized index pattern")
        if p.predicate in (PREDICATE_ID, TYPE_ID) and not (
                p.predicate == TYPE_ID and p.object >= 0):
            # ?x rdf:type ?t / versatile expansions bind meta ids
            return QueryGraph(False, "meta-predicate expansion")
        # triple-wise orientation: IN means the stored triple is
        # (object, p, subject)
        s, o = ((p.object, p.subject) if p.direction == IN
                else (p.subject, p.object))
        if p.predicate == TYPE_ID:
            # ?x rdf:type T (engine form: anchored either way)
            if s < 0 and o >= 0:
                note(s)
                unaries.append(Unary(s, U_TYPE, o))
                continue
            return QueryGraph(False, "unsupported type-pattern shape")
        if s >= 0 and o >= 0:
            return QueryGraph(False, "fully-constant pattern")
        if s >= 0:  # (c, pid, ?o): o ∈ out-neighbors of c
            note(o)
            unaries.append(Unary(o, U_CONST, (s, p.predicate, OUT)))
            continue
        if o >= 0:  # (?s, pid, c): s ∈ in-neighbors of c
            note(s)
            unaries.append(Unary(s, U_CONST, (o, p.predicate, IN)))
            continue
        if s == o:
            return QueryGraph(False, "self-loop pattern")
        # first-mention follows ENGINE order: the anchor (subject slot of
        # the planned pattern) is the variable the plan binds first
        note(p.subject)
        note(p.object)
        edges.append(Edge(s, p.predicate, o))

    # ---- cyclicity: union-find over binary edges -------------------------
    parent = {v: v for v in vars_seen}
    cyclic = False
    for e in edges:
        ra, rb = _find(parent, e.s), _find(parent, e.o)
        if ra == rb:
            cyclic = True
        else:
            parent[ra] = rb

    qg = QueryGraph(True, vars=tuple(vars_seen), cyclic=cyclic,
                    unaries=unaries, edges=edges)
    # the elimination order: first-mention (anchor first) over the PLANNED
    # patterns — the cost-based plan order already encodes the type-centric
    # cardinality stats, and it is connected by construction. ``stats`` is
    # accepted for future conditional-cardinality refinement of ties; the
    # module docstring records why a marginal-cardinality greedy re-order
    # was rejected.
    qg.order = tuple(vars_seen)
    return qg
