"""SPARQL subset lexer/parser + AST -> IR translation.

Replaces the reference's hand-written SPARQLLexer/SPARQLParser + Parser
(core/SPARQLLexer.hpp, core/SPARQLParser.hpp, core/parser.hpp). Supported
surface (the subset the reference parses — SPARQLParser.hpp):

  PREFIX decls; SELECT [DISTINCT|REDUCED] ?vars|* WHERE { ... };
  triple patterns with '.' separators; nested { } groups; UNION; OPTIONAL;
  FILTER expressions (||, &&, comparisons, arithmetic, !, bound/isIRI/isBLANK/
  isLITERAL/str/regex builtins); ORDER BY [ASC()/DESC()] ; LIMIT; OFFSET;
  plus two Wukong extensions: %prefix:name template placeholders
  (SPARQLParser.hpp template ext; query.hpp:820-856) and the __PREDICATE__
  keyword for predicate-index patterns.

Translation (core/parser.hpp:83-124): variables become negative ssids in order
of first appearance; IRIs/literals resolve through the StringServer (unknown
strings raise SYNTAX_ERROR-class failures like the reference's UNKNOWN_SUB);
attribute predicates get their value-type tag from str_attr_index.

The port's copy of the JAX package's sparql/parser.py, with its knn()
extension.
"""

from __future__ import annotations

import re

import numpy as np

from wukong_tpu_torch.sparql.ir import (
    Filter,
    FilterType,
    KNNClause,
    Order,
    Pattern,
    PatternGroup,
    SPARQLQuery,
    SPARQLTemplate,
)
from wukong_tpu_torch.types import OUT, AttrType
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError

RDF_TYPE_IRI = "<http://www.w3.org/1999/02/22-rdf-syntax-ns#type>"


class SPARQLSyntaxError(WukongError):
    def __init__(self, detail: str):
        super().__init__(ErrorCode.SYNTAX_ERROR, detail)


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<WS>\s+|\#[^\n]*)
  | (?P<IRI><[^<>\s]*>)
  | (?P<VAR>[?$][A-Za-z_][A-Za-z0-9_]*)
  | (?P<STRING>"(?:[^"\\]|\\.)*"(?:\^\^[^\s.;,)]+|@[A-Za-z][A-Za-z0-9-]*)?)
  | (?P<NUM>[+-]?\d+(?:\.\d+)?)
  | (?P<TEMPLATE>%(?:[A-Za-z_][A-Za-z0-9_-]*:[A-Za-z_][A-Za-z0-9_.-]*|<[^<>\s]*>))
  | (?P<PNAME>[A-Za-z_][A-Za-z0-9_-]*:[A-Za-z_][A-Za-z0-9_.-]*)
  | (?P<KEYWORD>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<OP>&&|\|\||!=|<=|>=|[{}().,;*=<>!+\-/:])
    """,
    re.VERBOSE,
)


def tokenize(text: str) -> list[tuple[str, str]]:
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise SPARQLSyntaxError(f"lexer error at: {text[pos:pos + 30]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind != "WS":
            tokens.append((kind, m.group()))
    tokens.append(("EOF", ""))
    return tokens


# ---------------------------------------------------------------------------
# Parser (tokens -> IR with symbolic terms, then id resolution)
# ---------------------------------------------------------------------------


class _Term:
    """Symbolic triple-pattern element before id resolution."""

    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value: str):
        self.kind = kind  # var | iri | literal | template | predicate_kw
        self.value = value

    def __repr__(self):
        return f"{self.kind}:{self.value}"


class Parser:
    """parse(text) -> SPARQLQuery; parse_template(text) -> SPARQLTemplate."""

    def __init__(self, str_server=None):
        self.str_server = str_server

    # -- public API --------------------------------------------------------
    def parse(self, text: str) -> SPARQLQuery:
        q, tmpl = self._parse_full(text)
        if tmpl.pos:
            raise SPARQLSyntaxError("template placeholders in a non-template query")
        return q

    def parse_template(self, text: str) -> SPARQLTemplate:
        q, tmpl = self._parse_full(text)
        if not tmpl.pos:
            raise SPARQLSyntaxError("no %placeholders in template query")
        tmpl.query = q
        return tmpl

    # -- grammar -----------------------------------------------------------
    def _parse_full(self, text: str):
        self.toks = tokenize(text)
        self.i = 0
        self.prefixes: dict[str, str] = {}
        self.vars: dict[str, int] = {}  # ?name -> negative ssid
        self.template = SPARQLTemplate()
        self._knn: KNNClause | None = None  # set by _resolve_group
        self._knn_leading = False  # clause appeared before any pattern

        while self._peek_kw("PREFIX"):
            self._next()
            # prefix name is either "p:" (KEYWORD + ':') or a PNAME-looking token
            kind, val = self._next()
            if kind == "KEYWORD":
                self._expect_op(":")
                pre = val
            elif kind == "PNAME":
                pre = val.split(":", 1)[0]
            else:
                raise SPARQLSyntaxError(f"bad PREFIX name {val!r}")
            iri = self._expect("IRI")
            self.prefixes[pre] = iri

        # Wukong CORUN extension (SPARQLParser.hpp:937-958):
        # `CORUN <corun_step> <fetch_step>` before SELECT
        corun_enabled = False
        corun_step = fetch_step = 0
        if self._peek_kw("CORUN"):
            self._next()
            corun_step = int(self._expect("NUM"))
            fetch_step = int(self._expect("NUM"))
            corun_enabled = True

        self._expect_kw("SELECT")
        distinct = reduced = False
        if self._peek_kw("DISTINCT"):
            self._next()
            distinct = True
        elif self._peek_kw("REDUCED"):
            self._next()
            reduced = True
        proj: list[str] | None = []
        if self._peek()[1] == "*":
            self._next()
            proj = None
        else:
            while self._peek()[0] == "VAR":
                proj.append(self._next()[1])
            if not proj:
                raise SPARQLSyntaxError("SELECT needs at least one variable or *")

        self._expect_kw("WHERE")
        group = self._parse_group()

        orders: list[tuple[str, bool]] = []
        limit, offset = -1, 0
        while True:
            if self._peek_kw("ORDER"):
                self._next()
                self._expect_kw("BY")
                while True:
                    t = self._peek()
                    if t[0] == "VAR":
                        orders.append((self._next()[1], False))
                    elif t[0] == "KEYWORD" and t[1].upper() in ("ASC", "DESC"):
                        kw = self._next()[1].upper()
                        self._expect_op("(")
                        v = self._expect("VAR")
                        self._expect_op(")")
                        orders.append((v, kw == "DESC"))
                    else:
                        break
            elif self._peek_kw("LIMIT"):
                self._next()
                limit = int(self._expect("NUM"))
            elif self._peek_kw("OFFSET"):
                self._next()
                offset = int(self._expect("NUM"))
            else:
                break
        if self._peek()[0] != "EOF":
            raise SPARQLSyntaxError(f"unexpected trailing token {self._peek()[1]!r}")

        q = SPARQLQuery()
        q.pattern_group = self._resolve_group(group)
        q.knn = self._knn
        if q.knn is not None:
            # composition direction from the TEXTUAL layout, before any
            # planner reorder: a knn clause written BEFORE a chain that
            # starts at its variable is a seeded walk
            # (rank-then-pattern); a clause written AFTER the patterns
            # ranks their binding set (pattern-then-rank); no
            # patterns/unions/optionals at all is a pure ranked scan
            pg = q.pattern_group
            if not pg.patterns and not pg.unions and not pg.optional:
                q.knn.mode = "scan"
            elif (self._knn_leading and pg.patterns
                    and pg.patterns[0].subject == q.knn.var):
                q.knn.mode = "rank_then_pattern"
            else:
                q.knn.mode = "pattern_then_rank"
        pg = q.pattern_group
        if not pg.patterns and not pg.unions and pg.optional:
            # a leading OPTIONAL with no required patterns IS the base
            # (optional/q5): the reference's planner promotes the first
            # group to the start — LeftJoin(Unit, A) = A whenever A has
            # solutions, and both formulations yield zero rows otherwise
            first = pg.optional.pop(0)
            pg.patterns = first.patterns
            pg.filters = first.filters + pg.filters
            pg.unions = first.unions
            pg.optional = first.optional + pg.optional
        q.distinct = distinct or reduced
        q.limit = limit
        q.offset = offset
        q.corun_enabled = corun_enabled
        q.corun_step = corun_step
        q.fetch_step = fetch_step
        nvars = len(self.vars)
        q.result.nvars = nvars
        if proj is None:
            q.result.required_vars = sorted(self.vars.values(), reverse=True)
        else:
            q.result.required_vars = [self._var_id(v) for v in proj]
        for vname, desc in orders:
            q.orders.append(Order(self._var_id(vname), desc))
        return q, self.template

    def _parse_group(self) -> dict:
        """Returns a symbolic group {patterns, unions, optional, filters}."""
        self._expect_op("{")
        group = {"patterns": [], "unions": [], "optional": [],
                 "filters": [], "knn": []}
        while True:
            t = self._peek()
            if t[1] == "}":
                self._next()
                break
            if t[1] == ".":  # stray '.' after a group, e.g. OPTIONAL { } .
                self._next()
                continue
            if t[1] == "{":
                # { A } UNION { B } [UNION { C }]...
                sub = self._parse_group()
                if self._peek_kw("UNION"):
                    members = [sub]
                    while self._peek_kw("UNION"):
                        self._next()
                        members.append(self._parse_group())
                    group["unions"].extend(members)
                else:
                    # plain nested group: merge
                    for k in ("patterns", "unions", "optional", "filters",
                              "knn"):
                        group[k].extend(sub[k])
                continue
            if t[0] == "KEYWORD" and t[1].upper() == "OPTIONAL":
                self._next()
                group["optional"].append(self._parse_group())
                continue
            if t[0] == "KEYWORD" and t[1].upper() == "FILTER":
                self._next()
                group["filters"].append(self._parse_filter_expr())
                continue
            if t[0] == "KEYWORD" and t[1].upper() == "KNN":
                # hybrid extension: knn(?x, <anchor|(v0 v1 ...)>, k[, metric]).
                # Clause position disambiguates the composition: written
                # BEFORE the patterns it seeds the chain, AFTER it ranks
                # the binding set
                self._next()
                c = self._parse_knn_clause()
                c["leading"] = not group["patterns"]
                group["knn"].append(c)
                continue
            # triple pattern, with the ';' predicate-object-list and ','
            # object-list shorthand (SPARQLParser.hpp:771-809 parseGraphPattern)
            s = self._parse_term()
            p = self._parse_term(predicate=True)
            o = self._parse_term()
            group["patterns"].append((s, p, o))
            while self._peek()[1] in (";", ","):
                sep = self._next()[1]
                if sep == ";":
                    nk, nv = self._peek()
                    # trailing ';' may be followed by '.', '}', another group
                    # element, or more ';' (SPARQL PropertyListNotEmpty)
                    if nv in (";", ".", "}", "{") or (
                            nk == "KEYWORD"
                            and nv.upper() in ("FILTER", "OPTIONAL")):
                        continue
                    p = self._parse_term(predicate=True)
                o = self._parse_term()
                group["patterns"].append((s, p, o))
            # reference direction terminators '<-' / '->'
            # (SPARQLParser.hpp:820-829). They are pure EXECUTION-orientation
            # hints — '<-' swaps the pattern's endpoints with direction IN,
            # which matches the same triples — and both our planners
            # re-derive orientation from bindings, so the hint is accepted
            # and dropped (the planner-off pre-oriented path is served by
            # .fmt plan files' <</>> markers instead). Matched as TWO
            # one-char OP tokens: a '<-' lexer token would break
            # FILTER(?y<-1), which must stay '<' '-1'.
            nxt = self._peek()[1]
            if nxt in ("<", "-") and self.toks[self.i + 1][1] in ("-", ">")                     and (nxt, self.toks[self.i + 1][1]) in (("<", "-"),
                                                            ("-", ">")):
                self._next()
                self._next()
            elif nxt == ".":
                self._next()
        return group

    # -- knn clause (hybrid graph+vector extension) ------------------------
    _KNN_METRICS = ("cosine", "dot", "l2")

    def _parse_knn_clause(self) -> dict:
        """``knn(?x, anchor, k[, metric])`` — anchor is an IRI/PNAME
        (rank by that vertex's stored embedding) or a parenthesized
        number list ``(0.1 0.2 ...)`` (a literal query vector). Returns
        the symbolic clause; ids resolve in ``_resolve_group``."""
        self._expect_op("(")
        var = self._expect("VAR")
        self._expect_op(",")
        kind, val = self._peek()
        if val == "(":
            self._next()
            nums = []
            while self._peek()[0] == "NUM":
                nums.append(float(self._next()[1]))
            self._expect_op(")")
            if not nums:
                raise SPARQLSyntaxError("knn() literal vector is empty")
            anchor = ("vec", nums)
        elif kind == "IRI":
            anchor = ("iri", self._next()[1])
        elif kind == "PNAME":
            anchor = ("iri", self._expand_pname(self._next()[1]))
        else:
            raise SPARQLSyntaxError(
                f"knn() anchor must be an IRI or a (v0 v1 ...) literal "
                f"vector, got {val!r}")
        self._expect_op(",")
        k = int(self._expect("NUM"))
        if k < 1:
            raise SPARQLSyntaxError("knn() k must be >= 1")
        metric = ""
        if self._peek()[1] == ",":
            self._next()
            metric = self._next()[1].lower()
            if metric not in self._KNN_METRICS:
                raise SPARQLSyntaxError(
                    f"knn() metric must be one of {self._KNN_METRICS}, "
                    f"got {metric!r}")
        self._expect_op(")")
        return {"var": var, "anchor": anchor, "k": k, "metric": metric}

    def _resolve_knn(self, clause: dict) -> KNNClause:
        var = self._var_id(clause["var"])
        akind, aval = clause["anchor"]
        if akind == "vec":
            return KNNClause(var=var, k=clause["k"],
                             anchor_vec=np.asarray(aval, dtype=np.float32),
                             metric=clause["metric"])
        if self.str_server is None:
            raise SPARQLSyntaxError("knn() anchor IRI requires a string server")
        try:
            vid = self.str_server.str2id(aval)
        except KeyError:
            raise WukongError(ErrorCode.UNKNOWN_SUB, aval)
        return KNNClause(var=var, k=clause["k"], anchor_vid=vid,
                         metric=clause["metric"])

    # -- terms -------------------------------------------------------------
    def _parse_term(self, predicate: bool = False) -> _Term:
        kind, val = self._next()
        if kind == "VAR":
            return _Term("var", val)
        if kind == "IRI":
            return _Term("iri", val)
        if kind == "PNAME":
            return _Term("iri", self._expand_pname(val))
        if kind == "TEMPLATE":
            # %prefix:name or %<full-iri> (the watdiv emulator templates use
            # the full-IRI form)
            body = val[1:]
            return _Term("template", body if body.startswith("<")
                         else self._expand_pname(body))
        if kind == "STRING":
            return _Term("literal", val)
        if kind == "NUM":
            return _Term("num", val)
        if kind == "KEYWORD":
            if val == "__PREDICATE__":
                return _Term("predicate_kw", val)
            if val.lower() == "a" and predicate:
                return _Term("iri", RDF_TYPE_IRI)
        raise SPARQLSyntaxError(f"unexpected token {val!r} in triple pattern")

    def _expand_pname(self, pname: str) -> str:
        pre, local = pname.split(":", 1)
        if pre not in self.prefixes:
            raise SPARQLSyntaxError(f"undefined prefix {pre!r}")
        base = self.prefixes[pre]
        return base[:-1] + local + ">"

    # -- filters (precedence climbing: || < && < cmp < addsub < muldiv < unary)
    def _parse_filter_expr(self) -> Filter:
        # FILTER Constraint: bracketted expression or a bare builtin call
        if self._peek()[1] == "(":
            self._next()
            f = self._parse_or()
            self._expect_op(")")
            return f
        return self._parse_unary()

    def _parse_or(self) -> Filter:
        left = self._parse_and()
        while self._peek()[1] == "||":
            self._next()
            left = Filter(FilterType.Or, left, self._parse_and())
        return left

    def _parse_and(self) -> Filter:
        left = self._parse_rel()
        while self._peek()[1] == "&&":
            self._next()
            left = Filter(FilterType.And, left, self._parse_rel())
        return left

    _REL_OPS = {"=": FilterType.Equal, "!=": FilterType.NotEqual,
                "<": FilterType.Less, "<=": FilterType.LessOrEqual,
                ">": FilterType.Greater, ">=": FilterType.GreaterOrEqual}

    def _parse_rel(self) -> Filter:
        left = self._parse_add()
        op = self._peek()[1]
        if op in self._REL_OPS:
            self._next()
            return Filter(self._REL_OPS[op], left, self._parse_add())
        return left

    def _parse_add(self) -> Filter:
        left = self._parse_mul()
        while self._peek()[1] in ("+", "-"):
            op = self._next()[1]
            t = FilterType.Plus if op == "+" else FilterType.Minus
            left = Filter(t, left, self._parse_mul())
        return left

    def _parse_mul(self) -> Filter:
        left = self._parse_unary()
        while self._peek()[1] in ("*", "/"):
            op = self._next()[1]
            t = FilterType.Mul if op == "*" else FilterType.Div
            left = Filter(t, left, self._parse_unary())
        return left

    _BUILTINS = {
        "BOUND": FilterType.Builtin_bound, "ISIRI": FilterType.Builtin_isiri,
        "ISURI": FilterType.Builtin_isiri, "ISBLANK": FilterType.Builtin_isblank,
        "ISLITERAL": FilterType.Builtin_isliteral, "STR": FilterType.Builtin_str,
        "REGEX": FilterType.Builtin_regex, "LANG": FilterType.Builtin_lang,
        "DATATYPE": FilterType.Builtin_datatype, "SAMETERM": FilterType.Builtin_sameterm,
    }

    def _parse_unary(self) -> Filter:
        kind, val = self._peek()
        if val == "!":
            self._next()
            return Filter(FilterType.Not, self._parse_unary())
        if val == "+":
            self._next()
            return Filter(FilterType.UnaryPlus, self._parse_unary())
        if val == "-":
            self._next()
            return Filter(FilterType.UnaryMinus, self._parse_unary())
        if val == "(":
            self._next()
            f = self._parse_or()
            self._expect_op(")")
            return f
        if kind == "VAR":
            self._next()
            return Filter(FilterType.Variable, valueArg=self._var_id(val))
        if kind == "STRING":
            self._next()
            return Filter(FilterType.Literal, value=val)
        if kind == "NUM":
            self._next()
            return Filter(FilterType.Literal, value=val)
        if kind == "IRI":
            self._next()
            return Filter(FilterType.IRI, value=val)
        if kind == "PNAME":
            self._next()
            return Filter(FilterType.IRI, value=self._expand_pname(val))
        if kind == "KEYWORD" and val.upper() in self._BUILTINS:
            self._next()
            ftype = self._BUILTINS[val.upper()]
            self._expect_op("(")
            args = [self._parse_or()]
            while self._peek()[1] == ",":
                self._next()
                args.append(self._parse_or())
            self._expect_op(")")
            f = Filter(ftype)
            if len(args) > 0:
                f.arg1 = args[0]
            if len(args) > 1:
                f.arg2 = args[1]
            if len(args) > 2:
                f.arg3 = args[2]
            return f
        raise SPARQLSyntaxError(f"unexpected token {val!r} in FILTER expression")

    # -- id resolution -----------------------------------------------------
    def _var_id(self, name: str) -> int:
        key = "?" + name[1:]  # normalize $x to ?x
        if key not in self.vars:
            self.vars[key] = -(len(self.vars) + 1)
        return self.vars[key]

    def _resolve_term(self, t: _Term, is_pred: bool) -> tuple[int, int]:
        """Returns (ssid, attr_type_tag)."""
        from wukong_tpu_torch.types import PREDICATE_ID

        if t.kind == "var":
            return self._var_id(t.value), int(AttrType.SID_t)
        if t.kind == "predicate_kw":
            return PREDICATE_ID, int(AttrType.SID_t)
        if self.str_server is None:
            raise SPARQLSyntaxError("constants require a string server")
        try:
            sid = self.str_server.str2id(t.value)
        except KeyError:
            raise WukongError(ErrorCode.UNKNOWN_SUB, t.value)
        at = int(AttrType.SID_t)
        if is_pred and hasattr(self.str_server, "pid2type"):
            at = self.str_server.pid2type.get(sid, int(AttrType.SID_t))
        return sid, at

    def _resolve_group(self, group: dict, top_level: bool = True) -> PatternGroup:
        pg = PatternGroup()
        for (s, p, o) in group["patterns"]:
            if not top_level and (s.kind == "template" or o.kind == "template"):
                raise SPARQLSyntaxError(
                    "%placeholders are only supported in the top-level group")
            ssid, _ = self._resolve_term(s, False) if s.kind != "template" \
                else (self._reserve_template_slot(len(pg.patterns), "subject", s), 0)
            pid, ptype = self._resolve_term(p, True)
            osid, _ = self._resolve_term(o, False) if o.kind != "template" \
                else (self._reserve_template_slot(len(pg.patterns), "object", o), 0)
            pat = Pattern(ssid, pid, OUT, osid)
            pat.pred_type = ptype
            pg.patterns.append(pat)
        for sub in group["unions"]:
            pg.unions.append(self._resolve_group(sub, top_level=False))
        for sub in group["optional"]:
            spg = self._resolve_group(sub, top_level=False)
            pg.optional.append(spg)
        for f in group["filters"]:
            pg.filters.append(f)
        if group.get("knn"):
            if not top_level:
                raise SPARQLSyntaxError(
                    "knn() is only supported in the top-level group")
            if len(group["knn"]) > 1:
                raise SPARQLSyntaxError("at most one knn() clause per query")
            self._knn = self._resolve_knn(group["knn"][0])
            self._knn_leading = bool(group["knn"][0].get("leading"))
        return pg

    def _reserve_template_slot(self, pattern_idx: int, fld: str, t: _Term) -> int:
        """%type placeholder: record slot, resolve the placeholder's type id.
        `%<fromPredicate>` (proxy.hpp:76-99) draws candidates from the
        pattern's own predicate index instead of a type — recorded as a
        marker for fill_template, no id to resolve."""
        if "fromPredicate" in t.value:
            self.template.ptypes.append("fromPredicate")
            self.template.pos.append((pattern_idx, fld))
            return 0
        try:
            tid = self.str_server.str2id(t.value)
        except KeyError:
            raise WukongError(ErrorCode.UNKNOWN_SUB, t.value)
        self.template.ptypes.append(tid)
        self.template.pos.append((pattern_idx, fld))
        return 0  # patched at instantiation

    # -- token helpers -----------------------------------------------------
    def _peek(self):
        return self.toks[self.i]

    def _peek_kw(self, kw: str) -> bool:
        t = self.toks[self.i]
        return t[0] == "KEYWORD" and t[1].upper() == kw.upper()

    def _next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def _expect(self, kind: str) -> str:
        t = self._next()
        if t[0] != kind:
            raise SPARQLSyntaxError(f"expected {kind}, got {t[1]!r}")
        return t[1]

    def _expect_kw(self, kw: str) -> None:
        if not self._peek_kw(kw):
            raise SPARQLSyntaxError(f"expected {kw}, got {self._peek()[1]!r}")
        self._next()

    def _expect_op(self, op: str) -> None:
        t = self._next()
        if t[1] != op:
            raise SPARQLSyntaxError(f"expected {op!r}, got {t[1]!r}")
