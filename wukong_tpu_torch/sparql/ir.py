"""SPARQL query intermediate representation.

Mirrors the reference IR (core/query.hpp): ``SPARQLQuery`` holds a
``PatternGroup`` tree (patterns / unions / optionals / filters), projection +
modifiers, and an execution ``Result``. Variables are negative ssids assigned in
order of first appearance; constants are positive ids (core/type.hpp:31).

The binding table (``Result``) is a row-major numpy table with a var -> column
map (query.hpp:251-558 — flat vector<sid_t> result_table + v2c_map), which maps
directly onto the device binding-table layout of the GPU engine.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from wukong_tpu_torch.types import AttrType
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError

NO_RESULT = -999  # v2c_map sentinel (query.hpp NO_RESULT_COL)


@dataclass
class Pattern:
    """One triple pattern step (query.hpp:96-116) with execution direction."""

    subject: int
    predicate: int
    direction: int
    object: int
    pred_type: int = int(AttrType.SID_t)  # attr patterns carry the value-type tag

    def __repr__(self):
        d = "<-" if self.direction == 0 else "->"
        return f"({self.subject} {self.predicate}{d}{self.object})"


class FilterType(enum.IntEnum):
    """Filter expression node types (query.hpp:141-147)."""

    Or = 0; And = 1; Equal = 2; NotEqual = 3; Less = 4; LessOrEqual = 5
    Greater = 6; GreaterOrEqual = 7; Plus = 8; Minus = 9; Mul = 10; Div = 11
    Not = 12; UnaryPlus = 13; UnaryMinus = 14; Literal = 15; Variable = 16
    IRI = 17; Function = 18; ArgumentList = 19; Builtin_str = 20
    Builtin_lang = 21; Builtin_langmatches = 22; Builtin_datatype = 23
    Builtin_bound = 24; Builtin_sameterm = 25; Builtin_isiri = 26
    Builtin_isblank = 27; Builtin_isliteral = 28; Builtin_regex = 29
    Builtin_in = 30


@dataclass
class Filter:
    type: FilterType
    arg1: "Filter | None" = None
    arg2: "Filter | None" = None
    arg3: "Filter | None" = None
    value: str = ""  # constant literal / IRI text
    valueArg: int = 0  # variable ssid for Variable nodes


@dataclass
class PatternGroup:
    """patterns + nested unions/optionals + filters (query.hpp:183-230)."""

    patterns: list = field(default_factory=list)
    unions: list = field(default_factory=list)
    filters: list = field(default_factory=list)
    optional: list = field(default_factory=list)
    optional_new_vars: set = field(default_factory=set)

    def get_start(self) -> int:
        if self.patterns:
            return self.patterns[0].subject
        if self.unions:
            return self.unions[0].get_start()
        if self.optional:
            return self.optional[0].get_start()
        raise WukongError(ErrorCode.UNKNOWN_PATTERN, "empty pattern group")


@dataclass
class Order:
    id: int  # variable ssid
    descending: bool = False


@dataclass
class KNNClause:
    """One ``knn(?x, <anchor>, k)`` clause (wukong_tpu_torch/vector/).

    The anchor is EITHER a vertex (``anchor_vid``: rank by similarity to
    that vertex's stored embedding) OR a literal vector (``anchor_vec``:
    a parenthesized number list, dim-checked against the store at
    execution). Exactly one of the two is set. ``var`` is the ranked
    variable's negative ssid; ``metric`` defaults to the ``knn_metric``
    knob at execution when empty.
    """

    var: int
    k: int
    anchor_vid: int | None = None
    anchor_vec: np.ndarray | None = None
    metric: str = ""
    # composition direction, stamped by the parser from the TEXTUAL
    # pattern order (scan | rank_then_pattern | pattern_then_rank).
    # Decided pre-planning: a planner reorder must not flip the query's
    # semantics between "rank the binding set" and "seed the chain".
    mode: str = ""



class Result:
    """Flat row-major binding table + metadata (query.hpp:251-558)."""

    def __init__(self, nvars: int = 0):
        self.nvars = nvars
        self.col_num = 0
        self.attr_col_num = 0
        self.table = np.empty((0, 0), dtype=np.int64)  # [rows, col_num]
        # attribute values, row-aligned with table (attr_v2c_map columns)
        self.attr_table = np.empty((0, 0), dtype=np.float64)
        self.v2c_map: dict[int, int] = {}  # var ssid -> column
        self.attr_v2c_map: dict[int, tuple[int, int]] = {}  # var -> (col, type)
        self.required_vars: list[int] = []
        self.blind = False
        self.status_code = ErrorCode.SUCCESS
        self.nrows = 0  # meaningful even when blind/table cleared
        # OPTIONAL row mask (query.hpp:782-813): rows still matched by the
        # group being executed in place
        self.optional_matched_rows: np.ndarray | None = None
        # resilience: False when a deadline/budget expiry kept the rows
        # produced so far; dropped_patterns lists what was not executed
        self.complete = True
        self.dropped_patterns: list[str] = []

    def var2col(self, var: int) -> int:
        return self.v2c_map.get(var, NO_RESULT)

    def add_var2col(self, var: int, col: int, vtype: int = int(AttrType.SID_t)) -> None:
        if vtype == int(AttrType.SID_t):
            if var not in self.v2c_map:
                self.v2c_map[var] = col
        else:
            if var not in self.attr_v2c_map:
                self.attr_v2c_map[var] = (col, vtype)

    def is_attr_var(self, var: int) -> bool:
        return var in self.attr_v2c_map

    def set_table(self, table: np.ndarray) -> None:
        self.table = table
        if table.ndim == 2:  # empty tables still carry their column count
            self.col_num = table.shape[1]
        self.nrows = len(table)


class PGType(enum.IntEnum):
    BASIC = 0
    UNION = 1
    OPTIONAL = 2
    FILTER = 3


@dataclass
class SPARQLQuery:
    """Query execution state (query.hpp:560-720)."""

    pattern_group: PatternGroup = field(default_factory=PatternGroup)
    result: Result = field(default_factory=Result)
    orders: list = field(default_factory=list)
    qid: int = -1
    pqid: int = -1
    pg_type: PGType = PGType.BASIC
    mt_factor: int = 1
    mt_tid: int = 0
    pattern_step: int = 0
    corun_enabled: bool = False
    corun_step: int = 0
    fetch_step: int = 0
    union_done: bool = False
    optional_step: int = 0
    limit: int = -1
    offset: int = 0
    distinct: bool = False
    local_var: int = 0
    # a planner proved the result empty (the reference's is_empty
    # short-circuit, planner.hpp:1505-1509). Engines honor it under
    # Global.enable_empty_shortcircuit.
    planner_empty: bool = False
    # per-query Deadline (runtime/resilience.py): wall clock + row budget,
    # None = unconstrained. The proxy attaches one from the Global knobs;
    # engines check it at each BGP step and device chain attempt.
    deadline: object = None
    # tenant identity (obs/slo.py): stamped by the proxy at admission
    # (bounded to max_tenants label values) and carried to the batcher, the
    # engine pool and the shed counters; "default" is the single-tenant path
    tenant: str = "default"
    # hybrid graph+vector (vector/): the parsed KNNClause, or None for a
    # pure graph query. The proxy stamps knn_mode/knn_route at plan time;
    # the engine composes the ranked scan with the BGP per the mode.
    knn: object = None

    def get_pattern(self, step: int | None = None) -> Pattern:
        s = self.pattern_step if step is None else step
        return self.pattern_group.patterns[s]

    @property
    def has_pattern(self) -> bool:
        return bool(self.pattern_group.patterns)

    def done_patterns(self) -> bool:
        return self.pattern_step >= len(self.pattern_group.patterns)

    def start_from_index(self) -> bool:
        """First pattern starts from a predicate/type index (query.hpp:660-682)."""
        from wukong_tpu_torch.types import PREDICATE_ID, TYPE_ID, is_tpid

        pg = self.pattern_group
        if not pg.patterns:
            return False
        if is_tpid(pg.patterns[0].subject):
            if pg.patterns[0].predicate not in (PREDICATE_ID, TYPE_ID):
                raise WukongError(ErrorCode.OBJ_ERROR,
                                  "index start requires __PREDICATE__ or rdf:type")
            return True
        return False




@dataclass
class SPARQLTemplate:
    """Parsed template query with %type placeholders (query.hpp:820-856).

    ``ptypes`` lists the placeholder type/predicate ids in pattern order;
    ``pos`` the (pattern_idx, field) slots to patch. ``candidates`` is filled by
    the proxy (fill_template) with the per-placeholder candidate constants.
    """

    query: SPARQLQuery = field(default_factory=SPARQLQuery)
    ptypes: list = field(default_factory=list)  # placeholder type ids
    pos: list = field(default_factory=list)  # (pattern index, "subject"/"object")
    candidates: list = field(default_factory=list)  # list[np.ndarray]

    def instantiate(self, rng: np.random.Generator) -> SPARQLQuery:
        import copy

        q = copy.deepcopy(self.query)
        for i, (pi, fld) in enumerate(self.pos):
            cand = self.candidates[i]
            val = int(cand[rng.integers(0, len(cand))])
            setattr(q.pattern_group.patterns[pi], fld, val)
        return q
