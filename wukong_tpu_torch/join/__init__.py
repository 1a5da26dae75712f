"""Worst-case-optimal tensor-join execution (the second execution strategy).

The port's copy of the JAX package's join/. The expand-per-BGP-step walk
(CPUEngine/GPUEngine) explodes on cyclic patterns — a triangle query first
materializes the full wedge set before the closing membership filter prunes
it. Worst-case-optimal joins (Leapfrog Triejoin / generic join) bound
intermediates by the fragment size instead: variables are materialized one
at a time in a global elimination order, and every pattern incident on the
new variable constrains its candidate set at that level.

Layout:

- ``qgraph.py``  — query-graph analyzer: cyclicity + the elimination order
  from the planned pattern list (host-only, a copy of the JAX module).
- ``kernels.py`` — sorted-array primitives: the NumPy host kernels, their
  PyTorch counterparts for the device route, and ``level_probe`` — the
  wrapper of the hand-written CUDA kernel ``csrc/level_probe.cu`` (the
  JAX package's fused ``jit_level_probe``), with its plain PyTorch version.
- ``wcoj.py``    — the executor: per-(predicate, direction) sorted edge
  tables cached per store version, walked level at a time.

The planner selects the strategy per query (``Planner.choose_strategy``,
``join_strategy`` knob: ``auto``/``walk``/``wcoj``); every outcome is a
member of :data:`JOIN_STRATEGIES`. The JAX package's distributed join
(``join/dist.py``) waits for the sharded store (ROADMAP §A, "``parallel/``,
the distributed engine").
"""

from __future__ import annotations

#: THE closed set of execution strategies the planner may choose between
JOIN_STRATEGIES = ("walk", "wcoj")

#: THE closed set of level-execution routes for the wcoj strategy: the
#: NumPy host kernels, or the device path (padded candidate tensors on the
#: proxy's device through ``kernels.level_probe``)
JOIN_ROUTES = ("host", "device")

__all__ = ["JOIN_STRATEGIES", "JOIN_ROUTES"]
