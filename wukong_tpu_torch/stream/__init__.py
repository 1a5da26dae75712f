"""Streaming subsystem: live triple ingestion + continuous SPARQL.

The Wukong+S (SOSP'17) capability ported onto this engine: timestamped
triple batches stream into the dynamic store in epoch-stamped commits
(ingest.py), registered SPARQL BGPs are evaluated *incrementally* on each
epoch's delta via semi-naive rewriting over the existing expand kernels
(continuous.py), and sliding/tumbling windows retire expired epochs and
retract their contribution (windows.py).

:class:`StreamContext` is the assembled facade the proxy exposes
(register/unregister/poll/feed verbs, runtime/proxy.py). The port's copy
of the JAX package's stream/__init__.py; ``device`` is where the epoch
frontier runs (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np

from wukong_tpu_torch.stream.continuous import (
    ContinuousEngine,
    ResultDelta,
    StandingQuery,
    match_delta,
)
from wukong_tpu_torch.stream.ingest import (
    EpochRecord,
    FileSource,
    ReplaySource,
    StreamIngestor,
)
from wukong_tpu_torch.stream.windows import EpochWindow, WindowSpec

__all__ = [
    "ContinuousEngine", "EpochRecord", "EpochWindow", "FileSource",
    "ReplaySource", "ResultDelta", "StandingQuery", "StreamContext",
    "StreamIngestor", "WindowSpec", "match_delta",
]


class StreamContext:
    """One store's streaming runtime: ingestor + standing-query registry.

    ``stores`` lists every insert target (the host partition first; the
    distributed shards ride along like `load -d`); delta evaluation runs
    against ``stores[0]``. With ``pool`` set, delta queries ride the engine
    pool's stream lane instead of executing inline.
    """

    def __init__(self, stores: list, str_server=None, engine=None, pool=None,
                 monitor=None, dedup: bool = True, device="cuda"):
        self.continuous = ContinuousEngine(
            stores[0], str_server, engine=engine, pool=pool, monitor=monitor,
            device=device)
        self.ingestor = StreamIngestor(
            stores, continuous=self.continuous, monitor=monitor, dedup=dedup)

    # -- registry verbs -------------------------------------------------
    def register(self, query, window=None, base_triples=None,
                 callback=None, tenant=None) -> int:
        return self.continuous.register(query, window=window,
                                        base_triples=base_triples,
                                        callback=callback, tenant=tenant)

    def unregister(self, qid: int) -> None:
        self.continuous.unregister(qid)

    def poll(self, qid: int, since_epoch: int = -1) -> list[ResultDelta]:
        return self.continuous.poll(qid, since_epoch)

    def result_set(self, qid: int) -> np.ndarray:
        return self.continuous.result_set(qid)

    def prune(self, qid: int, upto_epoch: int) -> int:
        """Free a standing query's consumed sink history (epoch <= cursor)."""
        return self.continuous.prune(qid, upto_epoch)

    # -- ingest verbs ---------------------------------------------------
    @property
    def epoch(self) -> int:
        return self.ingestor.epoch

    def feed(self, triples: np.ndarray, ts: float | None = None) -> EpochRecord:
        """Commit one batch as the next epoch."""
        return self.ingestor.commit_epoch(triples, ts=ts)

    def feed_source(self, source, max_epochs: int | None = None
                    ) -> list[EpochRecord]:
        return self.ingestor.ingest(source, max_epochs=max_epochs)
