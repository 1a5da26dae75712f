"""slo-telemetry gate: the SLO plane's admission inputs stay honest.

ROADMAP item 4's admission controller will consume the overload signal
bus (obs/slo.py) the way item 3's migration planner consumes the heat
report — and this gate holds that surface mechanically true the same way
the ``heat-telemetry`` gate does (analysis/telemetry.py), three ways:

- ``ADMISSION_INPUTS`` (a literal dict in ``obs/slo.py``) must exist and
  every metric name it maps a signal to must actually be registered
  somewhere in the package (a ``counter``/``gauge``/``histogram`` call
  with that literal name) — an admission decision must never read a
  number no exporter can scrape.
- every mutable shared structure created in ``obs/slo.py`` ``__init__``
  bodies must carry a ``# guarded by:`` / ``# lock-free:`` /
  ``# unguarded:`` annotation — new telemetry state declares its
  concurrency contract on the line that creates it.
- every lockdep factory lock created in ``obs/slo.py`` must be declared
  a leaf in the same file: per-tenant counters are innermost by
  construction, and the declaration makes lockdep enforce it.
"""

from __future__ import annotations

import ast

from wukong_tpu_torch.analysis.framework import (
    AnalysisPlugin,
    RepoContext,
    Violation,
    register,
)
from wukong_tpu_torch.analysis.telemetry import (
    _annotated,
    _is_mutable_container,
    _str_const,
)

SLO_MODULE = "obs/slo.py"
REGISTRY_NAME = "ADMISSION_INPUTS"


@register
class SLOTelemetryGate(AnalysisPlugin):
    name = "slo-telemetry"
    description = ("overload-bus admission inputs backed by registered "
                   "metrics; slo.py shared state annotated; slo locks "
                   "declared lockdep leaves")

    # ------------------------------------------------------------------
    def _admission_inputs(self, sf):
        """(signal -> metric dict, lineno) from the literal assignment."""
        if sf.tree is None:
            return None, 0
        for st in sf.tree.body:
            tgt = st.targets[0] if isinstance(st, ast.Assign) else (
                st.target if isinstance(st, ast.AnnAssign) else None)
            if not (isinstance(tgt, ast.Name) and tgt.id == REGISTRY_NAME):
                continue
            val = st.value
            if not isinstance(val, ast.Dict):
                return None, st.lineno
            out = {}
            for k, v in zip(val.keys, val.values):
                ks, vs = _str_const(k), _str_const(v)
                if ks is None or vs is None:
                    return None, st.lineno  # non-literal: unverifiable
                out[ks] = vs
            return out, st.lineno
        return None, 0

    def _registered_metrics(self, ctx: RepoContext) -> set[str]:
        names: set[str] = set()
        for sf in ctx.iter_files():
            if sf.tree is None:
                continue
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                fname = node.func.attr if isinstance(
                    node.func, ast.Attribute) else ""
                if fname in ("counter", "gauge", "histogram"):
                    s = _str_const(node.args[0])
                    if s:
                        names.add(s)
        return names

    # ------------------------------------------------------------------
    def run(self, ctx: RepoContext) -> list[Violation]:
        if SLO_MODULE not in ctx.paths():
            return []  # tree without an SLO plane: nothing to check
        sf = ctx.file(SLO_MODULE)
        out: list[Violation] = []

        inputs, line = self._admission_inputs(sf)
        if inputs is None:
            out.append(Violation(
                self.name, SLO_MODULE, line or 1,
                f"no literal {REGISTRY_NAME} dict found — declare every "
                "admission-relevant overload signal and its backing "
                "metric centrally"))
        else:
            registered = self._registered_metrics(ctx)
            for signal, metric in sorted(inputs.items()):
                if metric not in registered:
                    out.append(Violation(
                        self.name, SLO_MODULE, line,
                        f"admission input {signal!r} claims metric "
                        f"{metric!r}, but no code path registers it — an "
                        "admission decision would read an unscrapeable "
                        "number"))

        out.extend(self._check_init_annotations(sf))
        out.extend(self._check_leaf_locks(sf))
        return out

    # ------------------------------------------------------------------
    def _check_init_annotations(self, sf) -> list[Violation]:
        """Mutable self.X containers created in __init__ need a
        concurrency annotation on their line (the heat-telemetry rule,
        applied to the SLO plane's classes)."""
        if sf.tree is None:
            return []
        out = []
        for cls in ast.walk(sf.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            init = next((n for n in cls.body
                         if isinstance(n, ast.FunctionDef)
                         and n.name == "__init__"), None)
            if init is None:
                continue
            for node in ast.walk(init):
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    targets = [node.target]
                else:
                    continue
                for tgt in targets:
                    if not (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        continue
                    if not _is_mutable_container(node.value):
                        continue
                    if not _annotated(sf, node.lineno):
                        out.append(Violation(
                            self.name, sf.rel, node.lineno,
                            f"shared telemetry structure "
                            f"{cls.name}.{tgt.attr} carries no "
                            "`# guarded by:` / `# lock-free:` annotation "
                            "— declare its concurrency contract where it "
                            "is created"))
        return out

    def _check_leaf_locks(self, sf) -> list[Violation]:
        if sf.tree is None:
            return []
        made: dict[str, int] = {}
        declared: set[str] = set()
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fname = node.func.id if isinstance(node.func, ast.Name) else (
                node.func.attr if isinstance(node.func, ast.Attribute)
                else "")
            s = _str_const(node.args[0])
            if s is None:
                continue
            if fname in ("make_lock", "make_rlock", "make_condition"):
                made.setdefault(s, node.lineno)
            elif fname == "declare_leaf":
                declared.add(s)
        return [Violation(
            self.name, sf.rel, line,
            f"slo lock {name!r} is not declared a lockdep leaf in "
            f"{sf.rel} — per-tenant counters must be innermost "
            "(declare_leaf) so lockdep flags any acquisition under them")
            for name, line in sorted(made.items()) if name not in declared]
