"""wukong-analyze for the port: project-wide static analysis + runtime
concurrency checking (the port's copy of the JAX package's analysis/).

Two halves share this package:

- **Static gates** (:mod:`framework` and its plugins): a registry run by
  ``python -m wukong_tpu_torch.analysis`` (``--json`` for a machine-readable
  report, ``--gate NAME``, ``--list``) over ``wukong_tpu_torch/`` by
  default, and by ``tests/test_torch_analysis.py``. Seventeen gates: the
  JAX package's eighteen less ``transport-contract``, which waits for the
  worker-process pool (runtime/procs.py).
- **Runtime lockdep** (:mod:`lockdep`): ``make_lock``/``make_rlock``/
  ``make_condition`` factories behind the ``debug_locks`` knob, recording
  the per-thread lock acquisition-order graph, reporting order cycles with
  both stacks, flagging declared-leaf inversions, and exporting hold and
  contention histograms.

Import cost: runtime modules import only :mod:`lockdep`, which never pulls
the AST machinery in.
"""

from __future__ import annotations

__all__ = [
    "AnalysisPlugin", "RepoContext", "SourceFile", "Violation",
    "plugin_names", "register", "run_analysis",
]


def __getattr__(name):
    # lazy re-export (PEP 562): the runtime modules import analysis.lockdep
    # at start-up, and resolving this package must not load the
    # ast/tokenize framework; it loads only when a gate runs
    if name in __all__:
        from wukong_tpu_torch.analysis import framework

        return getattr(framework, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
