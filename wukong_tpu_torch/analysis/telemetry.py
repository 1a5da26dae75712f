"""heat-telemetry gate: the heat report's placement inputs stay honest.

ROADMAP item 3's migration planner will consume the per-shard heat report
(obs/heat.py) as its placement inputs. This gate keeps that surface
mechanically true, three ways:

- ``PLACEMENT_INPUTS`` (a literal dict in ``obs/heat.py``) must exist and
  every metric name it maps a report field to must actually be registered
  somewhere in the package (a ``counter``/``gauge``/``histogram`` call
  with that literal name) — a placement decision must never read a number
  no exporter can scrape.
- every mutable shared structure created in ``obs/heat.py`` ``__init__``
  bodies (dict/list/set/deque literals or constructor calls) must carry a
  ``# guarded by:`` / ``# lock-free:`` / ``# unguarded:`` annotation, and
  the same for any Monitor attribute whose name mentions heat — new
  telemetry state declares its concurrency contract on the line that
  creates it (the guarded-by gate enforces the vocabulary elsewhere;
  this one closes the per-shard-counter gap for classes the entry-point
  heuristic would skip).
- every lockdep factory lock created in ``obs/heat.py``
  (``make_lock("name")``) must be declared a leaf in the same file
  (``declare_leaf("name")``): per-shard counters are innermost by
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

HEAT_MODULE = "obs/heat.py"
MONITOR_MODULE = "runtime/monitor.py"
REGISTRY_NAME = "PLACEMENT_INPUTS"
_ANNOTATIONS = ("guarded by:", "lock-free:", "unguarded:", "caller holds:")
_MUTABLE_CTORS = {"dict", "list", "set", "deque", "defaultdict",
                  "OrderedDict", "Counter"}


def _str_const(node) -> str | None:
    return node.value if (isinstance(node, ast.Constant)
                          and isinstance(node.value, str)) else None


def _is_mutable_container(node) -> bool:
    if isinstance(node, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                         ast.ListComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else "")
        return name in _MUTABLE_CTORS
    return False


def _annotated(sf, line: int) -> bool:
    c = sf.comment(line)
    return any(tok in c for tok in _ANNOTATIONS)


@register
class HeatTelemetryGate(AnalysisPlugin):
    name = "heat-telemetry"
    description = ("heat-report placement inputs backed by registered "
                   "metrics; heat/Monitor shared state annotated; heat "
                   "locks declared lockdep leaves")

    # ------------------------------------------------------------------
    def _placement_inputs(self, sf):
        """(field -> metric dict, lineno) from the literal assignment."""
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
        if HEAT_MODULE not in ctx.paths():
            return []  # tree without a heat plane: nothing to check
        sf = ctx.file(HEAT_MODULE)
        out: list[Violation] = []

        inputs, line = self._placement_inputs(sf)
        if inputs is None:
            out.append(Violation(
                self.name, HEAT_MODULE, line or 1,
                f"no literal {REGISTRY_NAME} dict found — declare every "
                "placement-relevant heat-report field and its backing "
                "metric centrally"))
        else:
            registered = self._registered_metrics(ctx)
            for field, metric in sorted(inputs.items()):
                if metric not in registered:
                    out.append(Violation(
                        self.name, HEAT_MODULE, line,
                        f"placement input {field!r} claims metric "
                        f"{metric!r}, but no code path registers it — a "
                        "placement decision would read an unscrapeable "
                        "number"))

        out.extend(self._check_init_annotations(sf, heat_only=False))
        if MONITOR_MODULE in ctx.paths():
            out.extend(self._check_init_annotations(
                ctx.file(MONITOR_MODULE), heat_only=True))
        out.extend(self._check_leaf_locks(sf))
        return out

    # ------------------------------------------------------------------
    def _check_init_annotations(self, sf, heat_only: bool) -> list[Violation]:
        """Mutable self.X containers created in __init__ need a
        concurrency annotation on their line (heat_only restricts to
        attribute names mentioning 'heat' — the Monitor's legacy fields
        are the guarded-by gate's business, not this one's)."""
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
                    if heat_only and "heat" not in tgt.attr.lower():
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
            f"heat lock {name!r} is not declared a lockdep leaf in "
            f"{sf.rel} — per-shard counters must be innermost "
            "(declare_leaf) so lockdep flags any acquisition under them")
            for name, line in sorted(made.items()) if name not in declared]
