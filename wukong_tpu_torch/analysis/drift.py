"""Drift gates: code ↔ registry ↔ documentation sync, mechanically held.

The port's copy of the JAX package's analysis/drift.py, over the port's
tree and the repo's one README.md:

- ``fault-sites`` — every ``faults.site("X")`` call site uses a string
  declared in ``runtime/faults.py::KNOWN_FAULT_SITES``; every declared
  site has ≥1 call site; every declared site appears in ≥1 port test
  (``tests/test_torch_*.py``: the chaos tests are the proof a fault path
  degrades instead of crashing).
- ``config-readme`` — every ``GlobalConfig`` field is documented in
  README (backticked), and every knob named in a README knob table exists
  in ``config.py`` or is declared in :data:`UNPORTED_KNOBS`.
- ``metrics-readme`` — every metric name registered in code appears in
  README, and every ``wukong_*`` name in a README metrics table is
  registered somewhere in code or declared in :data:`UNPORTED_METRICS`.
- ``error-taxonomy`` — every directly-raised ``WukongError`` (and
  ``assert_ec``) uses an ``ErrorCode.X`` member, never a bare int: reply
  status codes are API surface.

The README documents the JAX package, whose knobs and metrics the port
takes over module by module. The two literal dicts below name each README
knob or metric the port does not have, with the ROADMAP item that ports it
or, where the port has no counterpart, the reason. An entry the port now
has is itself a violation, so a declaration cannot outlive the gap it
names.
"""

from __future__ import annotations

import ast
import re

from wukong_tpu_torch.analysis.framework import (
    AnalysisPlugin,
    RepoContext,
    Violation,
    register,
)

#: README knob-table knobs the port's GlobalConfig does not have -> the
#: ROADMAP item that ports it, or why the port has no counterpart
UNPORTED_KNOBS = {
    "exchange_capacity": "no counterpart: declared and read nowhere in the "
                         "JAX package; each exchange step sizes its own "
                         "per-destination capacity class",
    "proc_workers": "ROADMAP §A 7b: runtime/procs.py",
    "proc_heartbeat_ms": "ROADMAP §A 7b: runtime/procs.py",
    "proc_heartbeat_misses": "ROADMAP §A 7b: runtime/procs.py",
    "proc_restart_backoff_ms": "ROADMAP §A 7b: runtime/procs.py",
    "proc_restart_backoff_max_ms": "ROADMAP §A 7b: runtime/procs.py",
    "enable_fp_probe": "ROADMAP §B 2: the fingerprint probe is not ported",
    "enable_pallas": "no counterpart: the port has no Pallas kernels; on the "
                     "card every kernel of the path is the hand-written CUDA "
                     "one, and no knob routes a CUDA tensor to a plain "
                     "version",
    "xla_cache_dir": "no counterpart: the port compiles no XLA; its nvcc "
                     "build cache is wukong_tpu_torch/build/, keyed by a "
                     "hash of each source (engine/cuda_lib.py, "
                     "utils/compilecache.py)",
    "enable_versatile": "no counterpart: the port always runs variable "
                        "predicates, the JAX default (on)",
    "num_proxies": "no counterpart: declared and read nowhere in the JAX "
                   "package",
    "input_folder": "no counterpart: declared and read nowhere in the JAX "
                    "package; the console takes the dataset directory",
    "memstore_size_gb": "no counterpart: declared and read nowhere in the "
                        "JAX package",
    "est_bdr_threshold": "no counterpart: declared and read nowhere in the "
                         "JAX package",
    "enable_dynamic_store": "no counterpart: declared and read nowhere in "
                            "the JAX package; `load -d` always appends "
                            "delta segments",
    "enable_vattr": "no counterpart: declared and read nowhere in the JAX "
                    "package; attribute queries always run",
    "mt_threshold": "no counterpart: declared and read nowhere in the JAX "
                    "package; heavy_batch_max caps the heavy fan-out",
    "rdma_threshold": "no counterpart: declared and read nowhere in the JAX "
                      "package",
    "enable_budget": "no counterpart: declared and read nowhere in the JAX "
                     "package",
}

#: README metrics-table names no port code registers -> the ROADMAP item
#: that ports the code registering it
UNPORTED_METRICS: dict = {}

#: wire ops of runtime/transport.py's registry whose only callers are not
#: ported yet -> the ROADMAP item that ports them (the JAX package's
#: transport-contract gate finds no call site naming them in the port)
PENDING_WIRE_OPS = {
    "ping": "ROADMAP §A 7b: runtime/procs.py, the supervisor's heartbeat",
    "digest": "ROADMAP §A 7b: runtime/procs.py, the rejoin digest check",
}

FAULTS_MODULE = "runtime/faults.py"
FAULT_REGISTRY_NAME = "KNOWN_FAULT_SITES"
CONFIG_MODULE = "config.py"


def _str_const(node) -> str | None:
    return node.value if (isinstance(node, ast.Constant)
                          and isinstance(node.value, str)) else None


@register
class FaultSiteGate(AnalysisPlugin):
    name = "fault-sites"
    description = ("fault sites declared centrally, used in code, and "
                   "exercised by at least one test")

    def _registry(self, ctx: RepoContext):
        """(sites, lineno) from the literal KNOWN_FAULT_SITES assignment."""
        try:
            sf = ctx.file(FAULTS_MODULE)
        except OSError:
            return None, 0
        if sf.tree is None:
            return None, 0
        for st in sf.tree.body:
            tgt = st.targets[0] if isinstance(st, ast.Assign) else (
                st.target if isinstance(st, ast.AnnAssign) else None)
            if isinstance(tgt, ast.Name) and tgt.id == FAULT_REGISTRY_NAME:
                names = set()
                for n in ast.walk(st):
                    s = _str_const(n)
                    if s is not None:
                        names.add(s)
                return names, st.lineno
        return None, 0

    def run(self, ctx: RepoContext) -> list[Violation]:
        if FAULTS_MODULE not in ctx.paths():
            return []  # tree without a fault layer: nothing to check
        declared, reg_line = self._registry(ctx)
        if declared is None:
            return [Violation(self.name, FAULTS_MODULE, 1,
                              f"no literal {FAULT_REGISTRY_NAME} registry "
                              "found — declare every fault site centrally")]
        out: list[Violation] = []
        used: dict[str, tuple[str, int]] = {}  # site -> first call site
        for sf in ctx.iter_files():
            if sf.tree is None:
                continue
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                fname = node.func.attr if isinstance(
                    node.func, ast.Attribute) else (
                    node.func.id if isinstance(node.func, ast.Name) else "")
                if fname != "site" or not node.args:
                    continue
                s = _str_const(node.args[0])
                if s is None:
                    continue
                used.setdefault(s, (sf.rel, node.lineno))
                if s not in declared:
                    out.append(Violation(
                        self.name, sf.rel, node.lineno,
                        f"fault site {s!r} is not declared in "
                        f"{FAULTS_MODULE}::{FAULT_REGISTRY_NAME}"))
        tests = ctx.tests_text()
        for s in sorted(declared):
            if s not in used:
                out.append(Violation(
                    self.name, FAULTS_MODULE, reg_line,
                    f"declared fault site {s!r} has no site() call in the "
                    "package (dead registry entry)"))
            elif tests is not None and s not in tests:
                out.append(Violation(
                    self.name, FAULTS_MODULE, reg_line,
                    f"declared fault site {s!r} is never exercised by any "
                    "test under tests/ — add a deterministic chaos test"))
        return out


def _config_fields(ctx: RepoContext) -> list[tuple[str, int]]:
    """(name, lineno) of every init GlobalConfig field, from source."""
    if CONFIG_MODULE not in ctx.paths():
        return []
    sf = ctx.file(CONFIG_MODULE)
    if sf.tree is None:
        return []
    out = []
    for node in ast.walk(sf.tree):
        if not (isinstance(node, ast.ClassDef)
                and node.name == "GlobalConfig"):
            continue
        for st in node.body:
            if not (isinstance(st, ast.AnnAssign)
                    and isinstance(st.target, ast.Name)):
                continue
            name = st.target.id
            if name.startswith("_"):
                continue
            # field(..., init=False) entries are derived, not knobs
            if isinstance(st.value, ast.Call) and any(
                    kw.arg == "init"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is False
                    for kw in st.value.keywords):
                continue
            out.append((name, st.lineno))
    return out


def _table_cells(text: str, header_word: str) -> list[tuple[str, int]]:
    """Backticked tokens from the FIRST column of markdown tables whose
    header row contains ``header_word``. Returns (token, lineno)."""
    out = []
    in_table = False
    for i, line in enumerate(text.splitlines(), start=1):
        stripped = line.strip()
        if not stripped.startswith("|"):
            in_table = False
            continue
        cells = [c.strip() for c in stripped.strip("|").split("|")]
        if not in_table:
            if cells and header_word in cells[0].lower():
                in_table = True
            continue
        if cells and set(cells[0]) <= set("-: "):
            continue  # the separator row
        if cells:
            for tok in re.findall(r"`([^`]+)`", cells[0]):
                out.append((tok.strip(), i))
    return out


@register
class ConfigReadmeGate(AnalysisPlugin):
    name = "config-readme"
    description = "GlobalConfig knobs and README knob tables stay in sync"

    def run(self, ctx: RepoContext) -> list[Violation]:
        fields = _config_fields(ctx)
        if not fields:
            return []
        readme = ctx.readme_text()
        if readme is None:
            return []
        out = []
        for name, line in fields:
            # documented = the backticked name appears, alone or leading a
            # code phrase ("`metrics_port <port>`" counts)
            if not re.search(rf"`{re.escape(name)}[`\s]", readme):
                out.append(Violation(
                    self.name, CONFIG_MODULE, line,
                    f"config knob {name!r} is not documented in README "
                    "(add it to a knob table or the configuration "
                    "reference)"))
        known = {n for n, _ in fields}
        for tok, line in _table_cells(readme, "knob"):
            for part in re.split(r"\s*/\s*", tok):
                part = part.strip().strip("`")
                if re.fullmatch(r"[a-z][a-z0-9_]*", part) \
                        and part not in known and part not in UNPORTED_KNOBS:
                    out.append(Violation(
                        self.name, "", line,
                        f"README knob-table row names {part!r} which is "
                        "not a GlobalConfig field (stale doc row)"))
        for name, line in fields:
            if name in UNPORTED_KNOBS:
                out.append(Violation(
                    self.name, CONFIG_MODULE, line,
                    f"config knob {name!r} is ported but still declared in "
                    "analysis/drift.py::UNPORTED_KNOBS (stale entry)"))
        return out


@register
class MetricsReadmeGate(AnalysisPlugin):
    name = "metrics-readme"
    description = "registered metric names and README metric tables sync"

    def run(self, ctx: RepoContext) -> list[Violation]:
        readme = ctx.readme_text()
        if readme is None:
            return []
        registered: dict[str, tuple[str, int]] = {}
        for sf in ctx.iter_files():
            if sf.tree is None:
                continue
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                fname = node.func.attr if isinstance(
                    node.func, ast.Attribute) else ""
                if fname not in ("counter", "gauge", "histogram"):
                    continue
                s = _str_const(node.args[0])
                if s and s.startswith("wukong_"):
                    registered.setdefault(s, (sf.rel, node.lineno))
        if not registered:
            return []
        out = []
        for mname, (rel, line) in sorted(registered.items()):
            if mname not in readme:
                out.append(Violation(
                    self.name, rel, line,
                    f"metric {mname!r} is registered in code but absent "
                    "from README (add a metrics-table row)"))
        for tok, line in _table_cells(readme, "metric"):
            for part in re.split(r"\s*,\s*", tok):
                part = part.strip().strip("`")
                if part.startswith("wukong_") and part not in registered \
                        and part not in UNPORTED_METRICS:
                    out.append(Violation(
                        self.name, "", line,
                        f"README metrics-table row names {part!r} which "
                        "no code path registers (drifted name)"))
        for mname, (rel, line) in sorted(registered.items()):
            if mname in UNPORTED_METRICS:
                out.append(Violation(
                    self.name, rel, line,
                    f"metric {mname!r} is registered but still declared in "
                    "analysis/drift.py::UNPORTED_METRICS (stale entry)"))
        return out


@register
class ErrorTaxonomyGate(AnalysisPlugin):
    name = "error-taxonomy"
    description = "raised WukongErrors use ErrorCode members, not bare ints"

    def run(self, ctx: RepoContext) -> list[Violation]:
        out = []
        for sf in ctx.iter_files():
            if sf.tree is None or sf.rel == "utils/errors.py":
                continue  # errors.py defines the taxonomy itself
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                fname = node.func.id if isinstance(node.func, ast.Name) \
                    else ""
                if fname == "WukongError":
                    code = node.args[0]
                elif fname == "assert_ec" and len(node.args) >= 2:
                    code = node.args[1]
                else:
                    continue
                ok = (isinstance(code, ast.Attribute)
                      and isinstance(code.value, ast.Name)
                      and code.value.id == "ErrorCode")
                # propagating an existing structured code is taxonomy-
                # preserving (e.g. `raise WukongError(child.result.
                # status_code, ...)` re-raises a child's reply code)
                ok = ok or (isinstance(code, ast.Attribute)
                            and code.attr in ("status_code", "code"))
                ok = ok or (isinstance(code, ast.Name)
                            and code.id in ("code", "status_code"))
                if not ok:
                    out.append(Violation(
                        self.name, sf.rel, node.lineno,
                        f"{fname}() called with a non-ErrorCode status "
                        "(use a member of utils/errors.py ErrorCode — or "
                        "propagate an existing .code/.status_code — so "
                        "reply codes stay a closed taxonomy)"))
        return out
