"""The serving plane: the result cache and the materialized views.

The port's copy of the JAX package's serve/__init__.py. Two rungs over the
serving-cache observatory (obs/reuse.py):

- :mod:`wukong_tpu_torch.serve.result_cache` — rung i, the version-keyed
  full-result cache in the proxy's reply path (admission by the popularity
  ledger's verdicts, request collapsing, bounded bytes);
- :mod:`wukong_tpu_torch.serve.views` — rung ii, hot templates promoted
  into incrementally-maintained standing results via the Wukong+S
  semi-naive delta planner, so cache hits survive store-version edges.

:func:`notify_mutation` is THE mutation hook (``MUTATION_EDGES``, the same
causes as ``INVALIDATION_CAUSES``): insert batches, stream epochs and
vector batches call it INSIDE the WAL-mutation-locked commit, so a view is
never visible at a version it doesn't match; recovery restore calls it at
its swap point for the conservative purge. One knob check when the cache
is off (``enable_result_cache``, default off: the serving path is
unchanged). Every entry holds host bytes only: the port's result tables
are NumPy arrays, and a reply whose table is anything else is refused.
"""

from __future__ import annotations

from wukong_tpu_torch.config import Global
from wukong_tpu_torch.serve.result_cache import ResultCache
from wukong_tpu_torch.serve.views import ViewRegistry

__all__ = ["ServePlane", "get_serve", "notify_mutation"]


class ServePlane:
    """The process-wide serving-reuse plane: one result cache + one view
    registry, wired so a cache key's version-edge votes promote its
    template and a view's survival verdict re-keys its entries."""

    def __init__(self):
        self.cache = ResultCache()
        self.views = ViewRegistry()
        self.cache.on_promote = self.views.promote

    def attach(self, gstore, str_server, device="cuda") -> None:
        """Bind to a (new) serving world (the proxy's host partition):
        stale entries and old-world view registrations drop. ``device`` is
        where the views' epoch frontier runs (the proxy's)."""
        self.views.attach(gstore, str_server, device=device)
        self.cache.purge()

    def on_mutation(self, cause: str, version=None, triples=None) -> None:
        """One journaled mutation edge (MUTATION_EDGES semantics)."""
        if cause in ("cutover", "restore"):
            self.cache.purge()
            return
        survivors = set()
        if Global.enable_views and triples is not None:
            survivors = self.views.on_mutation(triples, version or 0)
        self.cache.apply_edge(version or 0, survivors)

    def reset(self) -> None:
        from wukong_tpu_torch.serve.result_cache import reset_divergence

        self.cache.reset()
        self.views.reset()
        reset_divergence()


_plane = ServePlane()


def get_serve() -> ServePlane:
    return _plane


def notify_mutation(cause: str, version=None, triples=None,
                    shard=None) -> None:
    """THE serving-plane mutation hook (every declared invalidation cause
    has exactly this consumer). One knob check when the result cache is
    off."""
    if not Global.enable_result_cache:
        return
    _plane.on_mutation(cause, version=version, triples=triples)
