"""Observability: the process-wide metrics registry (obs/metrics.py).

The JAX package's tracing, flight recorder, exporters, SLO plane and
observatory are not ported yet (ROADMAP §A 2.3, 2.4, 10)."""

from wukong_tpu_torch.obs.metrics import get_registry

__all__ = ["get_registry"]
