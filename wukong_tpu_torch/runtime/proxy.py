"""The port's serving entry: parse -> plan -> execute on the GPU engine.

A slim counterpart of the JAX package's runtime/proxy.py: ``serve_query``
answers one SPARQL text, ``serve_batch_index`` answers B replicate
instances of an index-origin (heavy) text in one device chain. Admission,
SLOs, tracing, the batcher and the console are not ported yet.

``serve_query`` answers every shape the JAX engine answers on one
partition: basic graph patterns, variable predicates, attribute patterns,
OPTIONAL, UNION, FILTER and ORDER BY / DISTINCT / LIMIT / OFFSET. The device
prefix of each chain and every seeded UNION/OPTIONAL child run on the card;
the host engine does the rest.
"""

from __future__ import annotations

import numpy as np

from wukong_tpu_torch.engine.tpu import GPUEngine
from wukong_tpu_torch.planner.heuristic import heuristic_plan
from wukong_tpu_torch.sparql.ir import SPARQLQuery
from wukong_tpu_torch.sparql.parser import Parser


class Proxy:
    """Serves SPARQL over one partition. ``device`` defaults to the card;
    pass ``device="cpu"`` for the plain PyTorch versions of every kernel."""

    def __init__(self, gstore, str_server, device="cuda",
                 budget_bytes: int | None = None):
        self.g = gstore
        self.str_server = str_server
        self.engine = GPUEngine(gstore, str_server, device=device,
                                budget_bytes=budget_bytes)
        self.device = self.engine.device

    def parse(self, text: str) -> SPARQLQuery:
        """Parse and plan (greedy planner) one query text."""
        q = Parser(self.str_server).parse(text)
        heuristic_plan(q)
        return q

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
