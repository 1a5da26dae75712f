"""placement-telemetry gate: the observatory's decision surface stays honest.

ROADMAP item 3's migration control plane will consume the observe-only
PlacementAdvisor's ``MigrationPlan`` artifact (obs/placement.py) the way
item 4's admission controller consumes ``ADMISSION_INPUTS`` — and this
gate holds that surface mechanically true, the heat-/slo-telemetry
pattern applied to the placement plane:

- ``MIGRATION_PLAN_FIELDS`` (a literal tuple in ``obs/placement.py``)
  must exist and match the ``MigrationPlan`` dataclass's annotated fields
  EXACTLY — the control plane's consumption schema is a registry, not an
  implementation detail that drifts.
- every metric the advisor reads through the tsdb trend windows (a
  ``wukong_*`` string literal passed to a tsdb query call — ``rate`` /
  ``rate_by_label`` / ``series`` / ``quantile`` / ``latest``) must be
  named in ``PLACEMENT_INPUTS`` (obs/heat.py): a placement decision may
  only consume declared placement inputs.
- every mutable shared structure created in ``obs/tsdb.py`` /
  ``obs/events.py`` / ``obs/placement.py`` ``__init__`` bodies carries a
  ``# guarded by:`` / ``# lock-free:`` annotation, and every lockdep
  factory lock those modules create is declared a leaf in the same file
  (trend/journal/ledger locks are innermost by construction — emitters
  fire from under tracked subsystem locks).
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

PLACEMENT_MODULE = "obs/placement.py"
HEAT_MODULE = "obs/heat.py"
OBSERVATORY_MODULES = ("obs/tsdb.py", "obs/events.py", "obs/placement.py")
PLAN_REGISTRY_NAME = "MIGRATION_PLAN_FIELDS"
PLAN_CLASS_NAME = "MigrationPlan"
#: tsdb query methods whose metric-name argument is a placement READ
TSDB_READS = ("rate", "rate_by_label", "series", "quantile", "latest")


def _literal_tuple(sf, name: str):
    """(entries, lineno) of a module-level literal tuple assignment."""
    if sf.tree is None:
        return None, 0
    for st in sf.tree.body:
        tgt = st.targets[0] if isinstance(st, ast.Assign) else (
            st.target if isinstance(st, ast.AnnAssign) else None)
        if not (isinstance(tgt, ast.Name) and tgt.id == name):
            continue
        if not isinstance(st.value, (ast.Tuple, ast.List)):
            return None, st.lineno
        out = []
        for el in st.value.elts:
            s = _str_const(el)
            if s is None:
                return None, st.lineno  # non-literal: unverifiable
            out.append(s)
        return out, st.lineno
    return None, 0


def _literal_dict_values(sf, name: str) -> set[str]:
    """String values of a module-level literal dict assignment."""
    if sf.tree is None:
        return set()
    for st in sf.tree.body:
        tgt = st.targets[0] if isinstance(st, ast.Assign) else (
            st.target if isinstance(st, ast.AnnAssign) else None)
        if (isinstance(tgt, ast.Name) and tgt.id == name
                and isinstance(st.value, ast.Dict)):
            return {s for v in st.value.values
                    if (s := _str_const(v)) is not None}
    return set()


@register
class PlacementTelemetryGate(AnalysisPlugin):
    name = "placement-telemetry"
    description = ("MigrationPlan fields pinned by a literal registry; "
                   "advisor trend reads named in PLACEMENT_INPUTS; "
                   "observatory shared state annotated + locks declared "
                   "lockdep leaves")

    # ------------------------------------------------------------------
    def run(self, ctx: RepoContext) -> list[Violation]:
        if PLACEMENT_MODULE not in ctx.paths():
            return []  # tree without a placement plane: nothing to check
        sf = ctx.file(PLACEMENT_MODULE)
        out: list[Violation] = []
        out.extend(self._check_plan_registry(ctx, sf))
        out.extend(self._check_advisor_inputs(ctx, sf))
        for rel in OBSERVATORY_MODULES:
            if rel not in ctx.paths():
                continue
            mod = ctx.file(rel)
            out.extend(self._check_init_annotations(mod))
            out.extend(self._check_leaf_locks(mod))
        return out

    # ------------------------------------------------------------------
    def _check_plan_registry(self, ctx: RepoContext,
                             sf) -> list[Violation]:
        """MIGRATION_PLAN_FIELDS literal == MigrationPlan dataclass
        fields, exactly (set equality both ways)."""
        reg, line = _literal_tuple(sf, PLAN_REGISTRY_NAME)
        if reg is None:
            return [Violation(
                self.name, sf.rel, line or 1,
                f"no literal {PLAN_REGISTRY_NAME} tuple found — the "
                "MigrationPlan artifact's field set is the control "
                "plane's consumption schema and must be a registry")]
        cls_fields: list[str] = []
        cls_line = 0
        if sf.tree is not None:
            for node in ast.walk(sf.tree):
                if (isinstance(node, ast.ClassDef)
                        and node.name == PLAN_CLASS_NAME):
                    cls_line = node.lineno
                    for st in node.body:
                        if (isinstance(st, ast.AnnAssign)
                                and isinstance(st.target, ast.Name)):
                            cls_fields.append(st.target.id)
        if not cls_fields:
            return [Violation(
                self.name, sf.rel, line,
                f"{PLAN_REGISTRY_NAME} exists but no {PLAN_CLASS_NAME} "
                "dataclass with annotated fields was found")]
        out = []
        for f in sorted(set(reg) - set(cls_fields)):
            out.append(Violation(
                self.name, sf.rel, line,
                f"{PLAN_REGISTRY_NAME} names {f!r} which is not a "
                f"{PLAN_CLASS_NAME} field (stale registry entry)"))
        for f in sorted(set(cls_fields) - set(reg)):
            out.append(Violation(
                self.name, sf.rel, cls_line,
                f"{PLAN_CLASS_NAME} field {f!r} is missing from the "
                f"literal {PLAN_REGISTRY_NAME} registry — the artifact "
                "schema must not drift silently"))
        return out

    def _check_advisor_inputs(self, ctx: RepoContext, sf) -> list[Violation]:
        """Every wukong_* metric literal the advisor passes to a tsdb
        query call must be declared in heat.PLACEMENT_INPUTS."""
        declared: set[str] = set()
        if HEAT_MODULE in ctx.paths():
            declared = _literal_dict_values(ctx.file(HEAT_MODULE),
                                            "PLACEMENT_INPUTS")
        if sf.tree is None:
            return []
        out = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fname = node.func.attr if isinstance(
                node.func, ast.Attribute) else (
                node.func.id if isinstance(node.func, ast.Name) else "")
            if fname not in TSDB_READS:
                continue
            s = _str_const(node.args[0])
            if s is None or not s.startswith("wukong_"):
                continue
            if s not in declared:
                out.append(Violation(
                    self.name, sf.rel, node.lineno,
                    f"advisor reads trend metric {s!r} which is not "
                    f"named in {HEAT_MODULE}::PLACEMENT_INPUTS — every "
                    "placement input must be declared centrally"))
        return out

    # ------------------------------------------------------------------
    def _check_init_annotations(self, sf) -> list[Violation]:
        """Mutable self.X containers created in __init__ need a
        concurrency annotation (the heat-/slo-telemetry rule applied to
        the observatory modules)."""
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
                            f"shared observatory structure "
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
            f"observatory lock {name!r} is not declared a lockdep leaf "
            f"in {sf.rel} — trend/journal/ledger locks must be innermost "
            "(declare_leaf) so lockdep flags any acquisition under them")
            for name, line in sorted(made.items()) if name not in declared]
