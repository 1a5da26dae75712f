"""admission-contract gate: the admission plane reads only what the
observatory promised, and sheds only through declared causes.

The admission controller (runtime/admission.py) is the decision half of
the overload signal bus: it may consult ONLY the signals declared
in ``obs/slo.py::ADMISSION_INPUTS``, through the one accessor
(``read_admission_input``), and every degrade-ladder outcome must flow
through the closed ``SHED_CAUSES`` set so ``wukong_shed_total`` never
grows an undeclared cause label. This gate holds the contract
mechanically true — the cachegate consumer-contract pattern applied to
the admission plane:

- ``CONSUMED_INPUTS`` (a literal tuple in ``runtime/admission.py``) must
  exist and every element must be an ``ADMISSION_INPUTS`` key — the
  controller never reads a signal the observatory did not promise.
- every literal signal name passed to ``read_admission_input`` in the
  module must be a ``CONSUMED_INPUTS`` member, and every consumed input
  must have >=1 read site (a dead declaration means the plane claims a
  signal it ignores).
- ``SHED_CAUSES`` (a literal tuple) is the closed set of admission shed
  causes: every literal cause ``runtime/admission.py`` passes to
  ``maybe_note_shed`` must be declared, and every declared cause must
  have >=1 call site — a rung that silently stopped charging the shed
  counter would hide degradation from the SLO plane.
- every lockdep lock the module creates is declared a leaf there
  (admission decisions fire from the proxy serving path and the pool's
  pop path — nothing may ever be acquired under them), and every
  mutable ``self.X`` container in its ``__init__`` bodies carries a
  ``# guarded by:`` / ``# lock-free:`` annotation.
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
INPUTS_NAME = "ADMISSION_INPUTS"
ADMISSION_MODULE = "runtime/admission.py"
CONSUMED_NAME = "CONSUMED_INPUTS"
CAUSES_NAME = "SHED_CAUSES"
ACCESSOR = "read_admission_input"


@register
class AdmissionContractGate(AnalysisPlugin):
    name = "admission-contract"
    description = ("CONSUMED_INPUTS subset of ADMISSION_INPUTS with every "
                   "read through the declared accessor; SHED_CAUSES a "
                   "closed used set; admission locks declared lockdep "
                   "leaves + shared state annotated")

    # ------------------------------------------------------------------
    @staticmethod
    def _literal_dict_keys(sf, name: str):
        """(keys of a module-level literal dict, lineno)."""
        if sf.tree is None:
            return None, 0
        for st in sf.tree.body:
            tgt = st.targets[0] if isinstance(st, ast.Assign) else (
                st.target if isinstance(st, ast.AnnAssign) else None)
            if not (isinstance(tgt, ast.Name) and tgt.id == name):
                continue
            if not isinstance(st.value, ast.Dict):
                return None, st.lineno
            keys = []
            for k in st.value.keys:
                s = _str_const(k)
                if s is None:
                    return None, st.lineno  # non-literal: unverifiable
                keys.append(s)
            return keys, st.lineno
        return None, 0

    @staticmethod
    def _literal_tuple(sf, name: str):
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
                    return None, st.lineno
                out.append(s)
            return out, st.lineno
        return None, 0

    @staticmethod
    def _call_arg_literals(sf, fname: str) -> list:
        """Every (literal first-arg, lineno) of calls to ``fname``."""
        if sf.tree is None:
            return []
        out = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            name = node.func.attr if isinstance(
                node.func, ast.Attribute) else (
                node.func.id if isinstance(node.func, ast.Name) else "")
            if name != fname:
                continue
            s = _str_const(node.args[0])
            if s is not None:
                out.append((s, node.lineno))
        return out

    # ------------------------------------------------------------------
    def run(self, ctx: RepoContext) -> list[Violation]:
        if ADMISSION_MODULE not in ctx.paths():
            return []  # tree without an admission plane: nothing to check
        sf = ctx.file(ADMISSION_MODULE)
        out: list[Violation] = []

        # -- consumer contract: CONSUMED_INPUTS subset of ADMISSION_INPUTS
        inputs = None
        if SLO_MODULE in ctx.paths():
            inputs, _ = self._literal_dict_keys(ctx.file(SLO_MODULE),
                                                INPUTS_NAME)
        consumed, line = self._literal_tuple(sf, CONSUMED_NAME)
        if consumed is None:
            out.append(Violation(
                self.name, ADMISSION_MODULE, line or 1,
                f"no literal {CONSUMED_NAME} tuple found — declare every "
                "overload signal the admission controller reads"))
        elif inputs is not None:
            for signal in consumed:
                if signal not in inputs:
                    out.append(Violation(
                        self.name, ADMISSION_MODULE, line,
                        f"consumed input {signal!r} is not a declared "
                        f"{SLO_MODULE}::{INPUTS_NAME} signal — the "
                        "controller reads a number the signal bus never "
                        "promised"))

        # -- every accessor read names a consumed input, every consumed
        # input is read somewhere in the module
        if consumed is not None:
            read: set = set()
            for s, ln in self._call_arg_literals(sf, ACCESSOR):
                read.add(s)
                if s not in consumed:
                    out.append(Violation(
                        self.name, ADMISSION_MODULE, ln,
                        f"{ACCESSOR}({s!r}) reads a signal not declared "
                        f"in {CONSUMED_NAME} — undeclared consumption"))
            for s in sorted(set(consumed) - read):
                out.append(Violation(
                    self.name, ADMISSION_MODULE, line,
                    f"declared consumed input {s!r} has no {ACCESSOR} "
                    "read site — the plane claims a signal it ignores"))

        # -- SHED_CAUSES: closed, and every member used
        causes, cline = self._literal_tuple(sf, CAUSES_NAME)
        if causes is None:
            out.append(Violation(
                self.name, ADMISSION_MODULE, cline or 1,
                f"no literal {CAUSES_NAME} tuple found — the admission "
                "shed causes are the degradation contract and must be a "
                "registry"))
        else:
            used: set = set()
            for s, ln in self._call_arg_literals(sf, "maybe_note_shed"):
                used.add(s)
                if s not in causes:
                    out.append(Violation(
                        self.name, ADMISSION_MODULE, ln,
                        f"admission shed cause {s!r} is not declared in "
                        f"{CAUSES_NAME} — wukong_shed_total would grow "
                        "an undeclared cause label"))
            for c in sorted(set(causes) - used):
                out.append(Violation(
                    self.name, ADMISSION_MODULE, cline,
                    f"declared shed cause {c!r} has no maybe_note_shed "
                    "call site — a degrade rung silently stopped "
                    "charging the shed counter"))

        out.extend(self._check_leaf_locks(sf))
        out.extend(self._check_init_annotations(sf))
        return out

    # ------------------------------------------------------------------
    def _check_leaf_locks(self, sf) -> list[Violation]:
        """Every lock the module creates is declared a lockdep leaf (the
        cachegate rule: decisions fire from serving/pop paths — nothing
        may be acquired under admission locks)."""
        if sf.tree is None:
            return []
        made: dict = {}
        declared: set = set()
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
            f"admission lock {name!r} is not declared a lockdep leaf in "
            f"{sf.rel} — admission state must be innermost "
            "(declare_leaf) so lockdep flags any acquisition under it")
            for name, line in sorted(made.items()) if name not in declared]

    def _check_init_annotations(self, sf) -> list[Violation]:
        """Mutable self.X containers created in __init__ need a
        concurrency annotation (the telemetry-gate rule applied to the
        admission plane's classes)."""
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
                elif isinstance(node, ast.AnnAssign) \
                        and node.value is not None:
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
                            f"shared admission structure "
                            f"{cls.name}.{tgt.attr} carries no "
                            "`# guarded by:` / `# lock-free:` annotation "
                            "— declare its concurrency contract where it "
                            "is created"))
        return out
