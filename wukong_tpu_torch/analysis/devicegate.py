"""device-telemetry gate: the device observatory's surface stays honest.

The port's copy of the JAX package's analysis/devicegate.py. The
compiled-template actuator routes whole-plan device programs by the
numbers ``obs/device.py`` reports. Every prior actuator
in this repo shipped one PR after its observatory (reuse->compile-route,
heat->migrate, slo->admission), and each time the gate that froze the
observatory's contract is what let the actuator trust it. This gate
holds the device plane to the same standard, three ways:

- ``DEVICE_INPUTS`` (a literal dict in ``obs/device.py``) must exist,
  every metric it names must actually be registered somewhere in the
  package (a ``counter``/``gauge``/``histogram`` call with that literal
  name), and every registered ``wukong_device_*`` metric must appear in
  the literal — the route chooser's input surface and the scrape-able
  metric surface never drift apart in either direction.
- every module under ``engine/``, ``join/``, ``vector/`` or ``stream/``
  that launches a hand kernel (it calls ``cuda_lib.library``,
  ``cuda_lib.bind`` or ``cuda_lib.count_launch``) or runs torch ops on
  the card (it imports ``torch``) must either call the
  ``maybe_device_dispatch`` seam itself, or appear in the literal
  ``DEVICE_DISPATCH_ALLOWLIST`` in ``obs/device.py`` with a written
  justification — a new device call path cannot silently run outside the
  cost ledger the actuator budgets with. This is the port's translation of
  the JAX gate's rule, which keys on modules that reference ``jax.jit``
  under ``engine/``, ``join/`` and ``vector/``; it is the one rule in which
  the port's gates differ from the JAX ones.
- ``obs/device.py`` keeps the telemetry-gate posture: every mutable
  shared structure created in an ``__init__`` body carries a
  ``# guarded by:`` / ``# lock-free:`` annotation, and every lockdep
  factory lock made in the module is declared a leaf in the same file
  (ledger charges fire from engine sync points — innermost by
  construction, and the declaration makes lockdep enforce it).
"""

from __future__ import annotations

import ast

from wukong_tpu_torch.analysis.framework import (
    AnalysisPlugin,
    RepoContext,
    Violation,
    register,
)

DEVICE_MODULE = "obs/device.py"
TEMPLATE_MODULE = "engine/template_compile.py"
INPUTS_NAME = "DEVICE_INPUTS"
ROUTES_NAME = "TEMPLATE_ROUTES"
READ_NAME = "read_device_input"
KEY_FN = "_program_key"
CHOOSER_FN = "choose_template_route"
ALLOWLIST_NAME = "DEVICE_DISPATCH_ALLOWLIST"
METRIC_PREFIX = "wukong_device_"
SEAM_NAME = "maybe_device_dispatch"
#: packages whose device call sites must charge the dispatch seam
SEAMED_PREFIXES = ("engine/", "join/", "vector/", "stream/")
#: engine/cuda_lib.py entry points whose call marks a hand-kernel launcher
LAUNCH_CALLS = ("library", "bind", "count_launch")
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


def _call_name(node: ast.Call) -> str:
    fn = node.func
    return fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else "")


def _literal_str_dict(sf, name: str):
    """(dict, lineno) for a module-level str->str literal assignment;
    (None, lineno) when missing or non-literal (unverifiable)."""
    if sf.tree is None:
        return None, 0
    for st in sf.tree.body:
        tgt = st.targets[0] if isinstance(st, ast.Assign) else (
            st.target if isinstance(st, ast.AnnAssign) else None)
        if not (isinstance(tgt, ast.Name) and tgt.id == name):
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


@register
class DeviceTelemetryGate(AnalysisPlugin):
    name = "device-telemetry"
    description = ("DEVICE_INPUTS <-> registrations parity; every device "
                   "call site in engine/join/vector/stream charges the dispatch "
                   "seam or sits in the justified allowlist; device-"
                   "observatory shared state annotated and its locks "
                   "declared lockdep leaves")

    # ------------------------------------------------------------------
    def run(self, ctx: RepoContext) -> list[Violation]:
        if DEVICE_MODULE not in ctx.paths():
            return []  # tree without a device plane: nothing to check
        sf = ctx.file(DEVICE_MODULE)
        out: list[Violation] = []
        out.extend(self._check_inputs(ctx, sf))
        out.extend(self._check_dispatch_coverage(ctx, sf))
        out.extend(self._check_init_annotations(sf))
        out.extend(self._check_leaf_locks(sf))
        out.extend(self._check_template_coherence(ctx, sf))
        return out

    # ------------------------------------------------------------------
    # template coherence: the compiled-template actuator's contract
    # ------------------------------------------------------------------
    def _check_template_coherence(self, ctx: RepoContext,
                                  dev_sf) -> list[Violation]:
        """The template actuator's contract, AST-held: the whole-plan program
        cache key composes the store version AND the route-knob set (a
        knob flip or a write can never serve a stale compiled program);
        the route registry is a literal dict; and every measured signal
        the route chooser consumes arrives through ``read_device_input``
        against a declared ``DEVICE_INPUTS`` member — never by reaching
        into the observatory or the metrics registry directly."""
        if TEMPLATE_MODULE not in ctx.paths():
            return []  # no compiled-template plane: nothing to hold
        sf = ctx.file(TEMPLATE_MODULE)
        if sf.tree is None:
            return []
        out: list[Violation] = []
        routes, rline = _literal_str_dict(sf, ROUTES_NAME)
        if routes is None:
            out.append(Violation(
                self.name, TEMPLATE_MODULE, rline or 1,
                f"no literal {ROUTES_NAME} dict found — every route a "
                "template may take must be centrally enumerated with "
                "what it means (the JOIN_ROUTES posture)"))
        decl, _dl = _literal_str_dict(dev_sf, INPUTS_NAME)
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and _call_name(node) == READ_NAME):
                continue
            s = _str_const(node.args[0]) if node.args else None
            if s is None:
                out.append(Violation(
                    self.name, TEMPLATE_MODULE, node.lineno,
                    f"{READ_NAME}() called with a non-literal signal — "
                    "the route chooser's input surface must stay "
                    "AST-verifiable against DEVICE_INPUTS"))
            elif decl is not None and s not in decl:
                out.append(Violation(
                    self.name, TEMPLATE_MODULE, node.lineno,
                    f"{READ_NAME}({s!r}) names a signal absent from "
                    f"{DEVICE_MODULE}::{INPUTS_NAME} — the actuator may "
                    "consume nothing the observatory does not declare"))
        fns = {n.name: n for n in ast.walk(sf.tree)
               if isinstance(n, ast.FunctionDef)}
        pk = fns.get(KEY_FN)
        if pk is None:
            out.append(Violation(
                self.name, TEMPLATE_MODULE, 1,
                f"no {KEY_FN}() found — the compiled-program cache key "
                "must be built in one provable place"))
        else:
            names = {n.id for n in ast.walk(pk)
                     if isinstance(n, ast.Name)}
            names |= {a.arg for a in pk.args.args}
            calls = {_call_name(n) for n in ast.walk(pk)
                     if isinstance(n, ast.Call)}
            if "store_version" not in names:
                out.append(Violation(
                    self.name, TEMPLATE_MODULE, pk.lineno,
                    f"{KEY_FN}() does not reference store_version — a "
                    "dynamic insert must make every stale compiled "
                    "program unreachable"))
            if not any("knob" in c for c in calls):
                out.append(Violation(
                    self.name, TEMPLATE_MODULE, pk.lineno,
                    f"{KEY_FN}() composes no route-knob set (no call "
                    "naming the knobs) — a runtime knob flip could "
                    "serve a program chosen under different routing "
                    "rules"))
        cr = fns.get(CHOOSER_FN)
        if cr is None:
            out.append(Violation(
                self.name, TEMPLATE_MODULE, 1,
                f"no {CHOOSER_FN}() found — the route decision must "
                "live in one checkable function"))
        else:
            reads = [n for n in ast.walk(cr)
                     if isinstance(n, ast.Call)
                     and _call_name(n) == READ_NAME]
            if not reads:
                out.append(Violation(
                    self.name, TEMPLATE_MODULE, cr.lineno,
                    f"{CHOOSER_FN}() never calls {READ_NAME}() — "
                    "measured-feedback demotion must consume declared "
                    "device inputs, not folklore"))
            direct = [n.lineno for n in ast.walk(cr)
                      if (isinstance(n, ast.Name)
                          and n.id == "_observatory")
                      or (isinstance(n, ast.Call)
                          and _call_name(n) == "get_registry")]
            if direct:
                out.append(Violation(
                    self.name, TEMPLATE_MODULE, direct[0],
                    f"{CHOOSER_FN}() reaches into the observatory or "
                    f"metrics registry directly — all signal reads go "
                    f"through {READ_NAME}()"))
        return out

    # ------------------------------------------------------------------
    # DEVICE_INPUTS <-> registered metrics, both directions
    # ------------------------------------------------------------------
    def _registered_metrics(self, ctx: RepoContext) -> dict[str, tuple]:
        found: dict[str, tuple] = {}
        for sf in ctx.iter_files():
            if sf.tree is None:
                continue
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                if _call_name(node) in ("counter", "gauge", "histogram"):
                    s = _str_const(node.args[0])
                    if s:
                        found.setdefault(s, (sf.rel, node.lineno))
        return found

    def _check_inputs(self, ctx: RepoContext, sf) -> list[Violation]:
        decl, line = _literal_str_dict(sf, INPUTS_NAME)
        if decl is None:
            return [Violation(
                self.name, DEVICE_MODULE, line or 1,
                f"no literal {INPUTS_NAME} dict found — declare every "
                "signal the compiled-template route chooser may read and "
                "its backing metric centrally")]
        out = []
        registered = self._registered_metrics(ctx)
        for signal, metric in sorted(decl.items()):
            if metric not in registered:
                out.append(Violation(
                    self.name, DEVICE_MODULE, line,
                    f"device signal {signal!r} claims metric {metric!r}, "
                    "but no code path registers it — a routing decision "
                    "would read an unscrapeable number"))
        declared = set(decl.values())
        for metric, (rel, mline) in sorted(registered.items()):
            if metric.startswith(METRIC_PREFIX) and metric not in declared:
                out.append(Violation(
                    self.name, rel, mline,
                    f"metric {metric!r} is registered but absent from "
                    f"{DEVICE_MODULE}::{INPUTS_NAME} — the device plane's "
                    "metric surface must stay centrally declared"))
        return out

    # ------------------------------------------------------------------
    # dispatch-seam coverage over device-launching modules
    # ------------------------------------------------------------------
    def _launches(self, sf) -> int:
        """First line where the module launches on the device: an import
        of torch, or a cuda_lib.library/bind/count_launch call; 0 when it
        does neither."""
        lines = []
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import) and any(
                    a.name == "torch" or a.name.startswith("torch.")
                    for a in node.names):
                lines.append(node.lineno)
            elif isinstance(node, ast.ImportFrom) and node.module and (
                    node.module == "torch"
                    or node.module.startswith("torch.")):
                lines.append(node.lineno)
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr in LAUNCH_CALLS
                  and isinstance(node.func.value, ast.Name)
                  and node.func.value.id == "cuda_lib"):
                lines.append(node.lineno)
        return min(lines) if lines else 0

    def _calls_seam(self, sf) -> bool:
        return any(isinstance(n, ast.Call) and _call_name(n) == SEAM_NAME
                   for n in ast.walk(sf.tree))

    def _check_dispatch_coverage(self, ctx: RepoContext,
                                 dev_sf) -> list[Violation]:
        allow, aline = _literal_str_dict(dev_sf, ALLOWLIST_NAME)
        out = []
        if allow is None:
            out.append(Violation(
                self.name, DEVICE_MODULE, aline or 1,
                f"no literal {ALLOWLIST_NAME} dict found — device "
                "modules that legitimately skip the dispatch seam must be "
                "listed with a written justification"))
            allow = {}
        for rel, why in sorted(allow.items()):
            if not why.strip():
                out.append(Violation(
                    self.name, DEVICE_MODULE, aline,
                    f"{ALLOWLIST_NAME} entry {rel!r} carries an empty "
                    "justification — say why its dispatches are charged "
                    "elsewhere"))
        covered = set()
        for sf in ctx.iter_files():
            if sf.tree is None or not sf.rel.startswith(SEAMED_PREFIXES):
                continue
            line = self._launches(sf)
            if not line:
                continue
            if self._calls_seam(sf):
                continue
            if sf.rel in allow:
                covered.add(sf.rel)
                continue
            out.append(Violation(
                self.name, sf.rel, line,
                f"{sf.rel} launches a hand kernel or runs torch ops but "
                f"never calls {SEAM_NAME}() and is not in "
                f"{ALLOWLIST_NAME} — a device call path outside the cost "
                "ledger starves the compiled-template route chooser of "
                "its measured inputs"))
        for rel in sorted(set(allow) - covered):
            if rel in ctx.paths() and ctx.file(rel).tree is not None \
                    and (not self._launches(ctx.file(rel))
                         or self._calls_seam(ctx.file(rel))):
                out.append(Violation(
                    self.name, DEVICE_MODULE, aline,
                    f"{ALLOWLIST_NAME} entry {rel!r} is stale — the "
                    "module no longer makes uncharged device calls; drop "
                    "the exemption so it cannot mask a future regression"))
        return out

    # ------------------------------------------------------------------
    # telemetry-gate posture on the observatory module itself
    # ------------------------------------------------------------------
    def _check_init_annotations(self, sf) -> list[Violation]:
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
                    if not any(tok in sf.comment(node.lineno)
                               for tok in _ANNOTATIONS):
                        out.append(Violation(
                            self.name, sf.rel, node.lineno,
                            f"shared device-ledger structure "
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
            fname = _call_name(node)
            s = _str_const(node.args[0])
            if s is None:
                continue
            if fname in ("make_lock", "make_rlock", "make_condition"):
                made.setdefault(s, node.lineno)
            elif fname == "declare_leaf":
                declared.add(s)
        return [Violation(
            self.name, sf.rel, line,
            f"device lock {name!r} is not declared a lockdep leaf in "
            f"{sf.rel} — ledger charges fire from engine sync points and "
            "must stay innermost (declare_leaf) so lockdep flags any "
            "acquisition under them")
            for name, line in sorted(made.items()) if name not in declared]
