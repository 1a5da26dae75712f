"""The port's serving entry: parse -> plan -> execute on the GPU engine.

A slim counterpart of the JAX package's runtime/proxy.py: ``serve_query``
answers one SPARQL text, ``serve_batch_index`` answers B replicate
instances of an index-origin (heavy) text in one device chain. Plans come
from the cost-based planner when the proxy has one (``planner=``, and
``Global.enable_planner``), else from a user plan file's text, else from the
greedy heuristic, in the JAX proxy's order. ``fill_template`` and
``heavy_index_batch`` feed the engine's batched entry points
(``execute_batch*``, ``execute_batch_index*``). Admission, SLOs, tracing,
the plan cache, the batcher and the console are not ported yet.

``serve_query`` answers every shape the JAX engine answers on one
partition: basic graph patterns, variable predicates, attribute patterns,
OPTIONAL, UNION, FILTER and ORDER BY / DISTINCT / LIMIT / OFFSET. The device
prefix of each chain and every seeded UNION/OPTIONAL child run on the card;
the host engine does the rest.
"""

from __future__ import annotations

import numpy as np

from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine.tpu import GPUEngine
from wukong_tpu_torch.planner.heuristic import heuristic_plan
from wukong_tpu_torch.planner.plan_file import set_plan
from wukong_tpu_torch.sparql.ir import SPARQLQuery, SPARQLTemplate
from wukong_tpu_torch.sparql.parser import Parser
from wukong_tpu_torch.types import IN, OUT, is_tpid
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError


class Proxy:
    """Serves SPARQL over one partition. ``device`` defaults to the card;
    pass ``device="cpu"`` for the plain PyTorch versions of every kernel.
    ``planner`` (an optimizer ``Planner``) plans every query when
    ``Global.enable_planner``; its statistics also size the engine's
    capacities, as a JAX deployment passes one ``Stats`` to both."""

    def __init__(self, gstore, str_server, device="cuda",
                 budget_bytes: int | None = None, planner=None):
        self.g = gstore
        self.str_server = str_server
        self.planner = planner  # cost-based optimizer (optional)
        self.engine = GPUEngine(
            gstore, str_server, device=device, budget_bytes=budget_bytes,
            stats=planner.stats if planner is not None else None)
        self.device = self.engine.device

    def parse(self, text: str, plan_text: str | None = None) -> SPARQLQuery:
        """Parse and plan one query text."""
        q = Parser(self.str_server).parse(text)
        self._plan(q, plan_text)
        return q

    def _plan(self, q: SPARQLQuery, plan_text: str | None = None) -> None:
        """The JAX proxy's order: the cost-based planner when enabled (a
        user plan is then ignored), else the user plan, else the greedy
        heuristic."""
        if plan_text is not None and not Global.enable_planner:
            if not set_plan(q.pattern_group, plan_text):
                raise WukongError(ErrorCode.UNKNOWN_PLAN, "bad plan file")
            return
        if self.planner is not None and Global.enable_planner:
            if self.planner.generate_plan(q):
                return
        heuristic_plan(q)

    def serve_query(self, text: str, blind: bool = False) -> SPARQLQuery:
        """Run one query; the reply is ``q.result`` (table, or only the row
        count when ``blind``; ``attr_table`` for attribute variables). A
        shape no engine can run ends on ``q.result.status_code``."""
        q = self.parse(text)
        q.result.blind = blind
        return self.engine.execute(q)

    def serve_batch_index(self, text: str, B: int) -> np.ndarray:
        """B replicate instances of an index-origin query in one chain;
        returns the per-instance result row counts."""
        return self.engine.execute_batch_index(self.parse(text), B)

    def heavy_index_batch(self, q: SPARQLQuery) -> int:
        """The slice count of an index-origin query's batch:
        ``suggest_index_batch`` capped by ``Global.heavy_batch_max``."""
        cap = max(int(Global.heavy_batch_max), 1)
        return max(min(self.engine.suggest_index_batch(q, cap=cap), cap), 1)

    def fill_template(self, tmpl: SPARQLTemplate) -> None:
        """Collect candidate constants per %placeholder by running the
        type/predicate index (proxy.hpp:69-129)."""
        tmpl.candidates = []
        for tid, (pi, fld) in zip(tmpl.ptypes, tmpl.pos):
            if tid == "fromPredicate":
                # %<fromPredicate> (proxy.hpp:76-99): candidates are the
                # pattern's predicate index — subject slots draw its
                # subjects (IN side), object slots its objects (OUT side)
                pat = tmpl.query.pattern_group.patterns[pi]
                d = IN if fld == "subject" else OUT
                cands = np.asarray(self.g.get_index(pat.predicate, d))
                if len(cands) == 0:
                    raise WukongError(
                        ErrorCode.UNKNOWN_SUB,
                        f"no candidates for predicate {pat.predicate}")
                tmpl.candidates.append(cands)
                continue
            if not is_tpid(tid):
                raise WukongError(ErrorCode.SYNTAX_ERROR,
                                  f"placeholder type {tid} is not an index id")
            cands = np.asarray(self.g.get_index(tid, IN))
            if len(cands) == 0:
                raise WukongError(ErrorCode.UNKNOWN_SUB,
                                  f"no instances for placeholder type {tid}")
            tmpl.candidates.append(cands)
