"""The port's wukong-analyze (wukong_tpu_torch/analysis/) against the JAX
package's gates.

- Every synthetic tree of the JAX gate tests (tests/test_analysis.py,
  test_observatory.py, test_profile.py, test_slo.py, test_admission.py,
  test_wcoj.py, test_reuse.py) goes through the JAX gate and the port's
  gate of the same name: the violations must be equal, with the package
  name mapped in messages. Two fixtures are translated, each with the
  reason: the fault-site tree names its test file ``test_torch_x.py`` (the
  port counts only its own tests), and the device tree's jitted modules
  become torch modules (the port's one translated rule); both rules also
  have port-only fixtures.
- The registry holds the JAX registry less the two gates of the
  distributed engine, and the port's tree is clean (CLI and API).
- Every violation the JAX gates report on the port's tree is named by one
  of the port's declarations, so no port gate is looser than its JAX gate
  without saying so.
"""

import json
import os
import subprocess
import sys

import pytest

from wukong_tpu.analysis import plugin_names as jax_plugin_names
from wukong_tpu.analysis import run_analysis as jax_run
from wukong_tpu_torch.analysis import plugin_names, run_analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "wukong_tpu_torch")


def write_tree(root, files: dict) -> str:
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
    return str(root)


def _norm(vs) -> list:
    return [(v.gate, v.path, v.line,
             v.message.replace("wukong_tpu_torch", "wukong_tpu"))
            for v in vs]


# ---------------------------------------------------------------------------
# the JAX tests' synthetic trees
# ---------------------------------------------------------------------------

GUARDED_BAD = '''
import threading

class Pool:
    def __init__(self):
        self._lock = threading.Lock()
        self._jobs = []  # guarded by: _lock

    def submit(self, j):
        self._jobs.append(j)

    def drain(self):
        with self._lock:
            out = list(self._jobs)
        return out
'''

GUARDED_THREAD = GUARDED_BAD.replace(
    "    def drain(self):",
    "    def start(self):\n"
    "        threading.Thread(target=self._drain).start()\n\n"
    "    def _drain(self):").replace(
    "    def submit(self, j):\n        self._jobs.append",
    "    def _submit(self, j):\n        self._jobs.append")

NESTED = '''
import threading

class Outer:
    class Inner:
        shared = {}  # guarded by: _lock

        def __init__(self):
            self._lock = threading.Lock()

        def put(self, k, v):
            self.shared[k] = v

        def get(self, k):
            with self._lock:
                return self.shared.get(k)
'''

MODULE_GLOBAL = '''
import threading

_lock = threading.Lock()
_state = {}  # guarded by: _lock

def good(k, v):
    with _lock:
        _state[k] = v

def bad(k):
    return _state.get(k)
'''

FACTORY = '''
def mutation_lock():
    ...

class Ingestor:
    def __init__(self):
        self.epoch = 0  # guarded by: mutation_lock()

    def commit(self):
        with mutation_lock():
            self.epoch += 1

    def peek(self):
        return self.epoch
'''

CONFIG_SRC = '''
from dataclasses import dataclass, field

@dataclass
class GlobalConfig:
    knob_a: int = 1
    knob_b: bool = False
    derived: int = field(default=0, init=False)
'''

FAULTS_SRC = '''
KNOWN_FAULT_SITES = frozenset({"a.site", "b.site"})

def site(name, shard=None):
    ...
'''

FAULT_TREE = {
    "pkg/runtime/faults.py": FAULTS_SRC,
    "pkg/eng.py": ('from . import faults\n'
                   'def f():\n'
                   '    faults.site("a.site")\n'
                   '    faults.site("rogue.site")\n'),
}

TAXONOMY = '''
from wukong_tpu.utils.errors import ErrorCode, WukongError

def good():
    raise WukongError(ErrorCode.SYNTAX_ERROR, "x")

def propagated(child):
    raise WukongError(child.result.status_code, "child failed")

def bad():
    raise WukongError(13, "bare int")
'''

REUSE_OK = (
    "CACHE_INPUTS = {'template_popularity': 'wukong_ok_total',"
    " 'uncacheable': 'wukong_ok_total'}\n"
    "INVALIDATION_CAUSES = ('insert', 'restore')\n"
    "def reg(r):\n"
    "    return r.counter('wukong_ok_total', 'h')\n")

DEV_OK = (
    "declare_leaf('device.dispatch')\n"
    "DEVICE_INPUTS = {'dispatches': 'wukong_device_d_total',"
    " 'padding_efficiency': 'wukong_device_pe'}\n"
    "DEVICE_DISPATCH_ALLOWLIST = {}\n"
    "def reg(r):\n"
    "    r.counter('wukong_device_d_total', 'h')\n"
    "    r.gauge('wukong_device_pe', 'h')\n")

DEVICE_BAD = {
    "pkg/obs/device.py": (
        "DEVICE_INPUTS = {'dispatches': 'wukong_device_d_total',"
        " 'phantom': 'wukong_device_ghost_total'}\n"
        "DEVICE_DISPATCH_ALLOWLIST = {"
        "'engine/kernels.py': '',"
        "'engine/retired.py': 'charged at the chain seam'}\n"
        "def reg(r):\n"
        "    r.counter('wukong_device_d_total', 'h')\n"
        "    r.counter('wukong_device_rogue_total', 'h')\n"
        "class Ledger:\n"
        "    def __init__(self):\n"
        "        self.stats = {}\n"
        "        self._lock = make_lock('device.dispatch')\n"),
    "pkg/join/probe.py": (
        "import jax\n"
        "def mint():\n"
        "    return jax.jit(lambda x: x)\n"),
    "pkg/engine/retired.py": (
        "import jax\n"
        "def run(fn):\n"
        "    out = jax.jit(fn)(1)\n"
        "    maybe_device_dispatch('engine.retired', live=1)\n"
        "    return out\n"),
}

DEVICE_GOOD = {
    "pkg/obs/device.py": (
        "declare_leaf('device.dispatch')\n"
        "DEVICE_INPUTS = {'dispatches': 'wukong_device_d_total'}\n"
        "DEVICE_DISPATCH_ALLOWLIST = {"
        "'engine/kernels.py': 'dispatched and charged in "
        "engine/run.py at the sync point'}\n"
        "def reg(r):\n"
        "    r.counter('wukong_device_d_total', 'h')\n"
        "class Ledger:\n"
        "    def __init__(self):\n"
        "        self.stats = {}  # guarded by: _lock\n"
        "        self._lock = make_lock('device.dispatch')\n"),
    "pkg/engine/kernels.py": (
        "import jax\n"
        "compact = jax.jit(lambda x: x)\n"),
    "pkg/engine/run.py": (
        "import jax\n"
        "def run(fn, x):\n"
        "    out = jax.jit(fn)(x)\n"
        "    maybe_device_dispatch('engine.run', live=1)\n"
        "    return out\n"),
}

JOIN_GOOD = '\nJOIN_STRATEGIES = ("walk", "wcoj")\n'
JOIN_ROUTES = JOIN_GOOD + '\nJOIN_ROUTES = ("host", "device")\n'
CHOOSER_OK = ('\ndef choose_strategy(patterns):\n    if not patterns:\n'
              '        return "walk"\n    return "wcoj"\n')
CHOOSER_BAD = '\ndef choose_strategy(patterns):\n    return "wolk"\n'
ROUTE_OK = ('\ndef choose_join_route(patterns):\n    if not patterns:\n'
            '        return "host"\n    return "device"\n')
ROUTE_BAD = '\ndef classify_join_route(q):\n    return "gpu"\n'

SLO_SRC = "ADMISSION_INPUTS = {'lane_depth': 'wukong_pool_lane_depth'}\n"

#: id -> (gate, {path under tmp: source}); "pkg/..." is the package tree,
#: "README.md" and "tests/..." sit beside it
CASES = {
    # --- guarded-by (test_analysis.py) ---
    "guarded-bad": ("guarded-by", {"pkg/pool.py": GUARDED_BAD}),
    "guarded-under-lock": ("guarded-by", {"pkg/pool.py": GUARDED_BAD.replace(
        "    def submit(self, j):\n        self._jobs.append(j)\n",
        "    def submit(self, j):\n        with self._lock:\n"
        "            self._jobs.append(j)\n")}),
    "guarded-caller-holds": ("guarded-by", {"pkg/pool.py": GUARDED_BAD.replace(
        "    def submit(self, j):",
        "    def submit(self, j):  # caller holds: _lock")}),
    "guarded-unguarded": ("guarded-by", {"pkg/pool.py": GUARDED_BAD.replace(
        "        self._jobs.append(j)",
        "        self._jobs.append(j)  # unguarded: test fixture reason")}),
    "guarded-lockfree": ("guarded-by", {"pkg/pool.py": GUARDED_BAD.replace(
        "# guarded by: _lock", "# lock-free: atomic list append")}),
    "guarded-single-entry": ("guarded-by", {
        "pkg/pool.py": GUARDED_BAD.replace("    def drain(self):",
                                           "    def _drain(self):")}),
    "guarded-thread-target": ("guarded-by", {"pkg/pool.py": GUARDED_THREAD}),
    "guarded-nested-class": ("guarded-by", {"pkg/mod.py": NESTED}),
    "guarded-module-global": ("guarded-by", {"pkg/mod.py": MODULE_GLOBAL}),
    "guarded-factory-lock": ("guarded-by", {"pkg/ing.py": FACTORY}),
    # --- drift gates (test_analysis.py) ---
    "config-missing-knob": ("config-readme", {
        "pkg/config.py": CONFIG_SRC, "README.md": "only `knob_a` documented",
        "tests/.keep": ""}),
    "config-stale-row": ("config-readme", {
        "pkg/config.py": CONFIG_SRC,
        "README.md": ("`knob_a` `knob_b`\n\n"
                      "| knob | default |\n|---|---|\n| `ghost_knob` | 0 |\n"),
        "tests/.keep": ""}),
    "metrics-both-directions": ("metrics-readme", {
        "pkg/m.py": ('from x import get_registry\n'
                     'M = get_registry().counter("wukong_real_total", "h")\n'),
        "README.md": ("| metric | type |\n|---|---|\n"
                      "| `wukong_ghost_total` | counter |\n")}),
    # translated: the JAX fixture's tests/test_x.py is named as a port test
    "fault-sites-declared-and-used": ("fault-sites", {
        **FAULT_TREE, "tests/test_torch_x.py": 'PLAN = "a.site:transient"\n'}),
    "fault-sites-never-exercised": ("fault-sites", {
        **FAULT_TREE, "tests/test_torch_x.py": "nothing here\n"}),
    "error-taxonomy": ("error-taxonomy", {"pkg/m.py": TAXONOMY}),
    "bare-print": ("no-bare-print", {"pkg/m.py": "def f():\n    print('x')\n"}),
    # --- cache-coherence (test_analysis.py, test_reuse.py) ---
    "cache-serve-bad": ("cache-coherence", {
        "pkg/obs/reuse.py": REUSE_OK,
        "pkg/serve/result_cache.py": (
            "CONSUMED_INPUTS = ('template_popularity', 'phantom_signal')\n"
            "MUTATION_EDGES = {'insert': 'kill', 'ghost_edge': 'x'}\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self.entries = {}\n"
            "        self.lock = make_lock('serve.x')\n"),
        "pkg/store/dynamic.py": (
            "def insert_batch(stores):\n"
            "    maybe_note_invalidation('insert')\n"
            "    notify_mutation('insert')\n"
            "    notify_mutation('bogus_edge')\n")}),
    "cache-serve-good": ("cache-coherence", {
        "pkg/obs/reuse.py": REUSE_OK + "declare_leaf('serve.x')\n",
        "pkg/serve/result_cache.py": (
            "CONSUMED_INPUTS = ('template_popularity', 'uncacheable')\n"
            "MUTATION_EDGES = {'insert': 'kill stale', 'restore': 'purge'}\n"
            "declare_leaf('serve.x')\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self.entries = {}  # guarded by: lock\n"
            "        self.lock = make_lock('serve.x')\n"),
        "pkg/store/dynamic.py": (
            "def insert_batch(stores):\n"
            "    maybe_note_invalidation('insert')\n"
            "    notify_mutation('insert')\n"),
        "pkg/runtime/recovery.py": (
            "def recover():\n"
            "    maybe_note_invalidation('restore')\n"
            "    notify_mutation('restore')\n")}),
    "cache-observe-only": ("cache-coherence", {
        "pkg/obs/reuse.py": REUSE_OK,
        "pkg/store/dynamic.py": (
            "def insert_batch(stores):\n"
            "    maybe_note_invalidation('insert')\n"),
        "pkg/runtime/recovery.py": (
            "def recover():\n"
            "    maybe_note_invalidation('restore')\n")}),
    "cache-reuse-bad": ("cache-coherence", {
        "pkg/obs/reuse.py": (
            "CACHE_INPUTS = {'pop': 'wukong_nope_total'}\n"
            "INVALIDATION_CAUSES = ('insert', 'ghost')\n"
            "def trend(ts):\n"
            "    return ts.rate('wukong_rogue_total')\n"
            "class A:\n"
            "    def __init__(self):\n"
            "        self.keys = {}\n"
            "        self.lock = make_lock('reuse.x')\n"),
        "pkg/store/dynamic.py": (
            "def insert_batch(stores):\n"
            "    for g in stores:\n"
            "        insert_triples(g)\n"
            "def other():\n"
            "    maybe_note_invalidation('insert')\n"
            "    maybe_note_invalidation('bogus')\n")}),
    "cache-reuse-good": ("cache-coherence", {
        "pkg/obs/reuse.py": (
            "CACHE_INPUTS = {'pop': 'wukong_ok_total'}\n"
            "INVALIDATION_CAUSES = ('insert',)\n"
            "declare_leaf('reuse.x')\n"
            "def reg(r):\n"
            "    return r.counter('wukong_ok_total', 'h')\n"
            "def trend(ts):\n"
            "    return ts.rate('wukong_ok_total')\n"
            "class A:\n"
            "    def __init__(self):\n"
            "        self.keys = {}  # guarded by: _lock\n"
            "        self.lock = make_lock('reuse.x')\n"),
        "pkg/store/dynamic.py": (
            "def insert_batch(stores):\n"
            "    for g in stores:\n"
            "        insert_triples(g)\n"
            "    maybe_note_invalidation('insert')\n")}),
    # --- vector-coherence (test_analysis.py) ---
    "vector-bad": ("vector-coherence", {
        "pkg/vector/__init__.py": (
            "VECTOR_METRICS = {'upserts': 'wukong_vector_up_total',"
            " 'phantom': 'wukong_vector_ghost_total'}\n"),
        "pkg/vector/vstore.py": (
            "def reg(r):\n"
            "    r.counter('wukong_vector_up_total', 'h')\n"
            "    r.counter('wukong_vector_rogue_total', 'h')\n"
            "class VectorStore:\n"
            "    def __init__(self):\n"
            "        self.slot_of = {}\n"
            "        self._lock = make_lock('vector.slots')\n"
            "    def _apply_slots(self, vids):\n"
            "        with self._lock:\n"
            "            self.vids = vids\n"
            "    def refresh(self):\n"
            "        self.alive = None\n"
            "def apply_batch(g, vs):\n"
            "    return vs.upsert([1])\n")}),
    "vector-good": ("vector-coherence", {
        "pkg/vector/__init__.py": (
            "VECTOR_METRICS = {'upserts': 'wukong_vector_up_total'}\n"),
        "pkg/vector/vstore.py": (
            "declare_leaf('vector.slots')\n"
            "def reg(r):\n"
            "    r.counter('wukong_vector_up_total', 'h')\n"
            "class VectorStore:\n"
            "    def __init__(self):\n"
            "        self.slot_of = {}  # guarded by: _lock\n"
            "        self._lock = make_lock('vector.slots')\n"
            "    def _apply_slots(self, vids):\n"
            "        with self._lock:\n"
            "            self.vids = vids\n"
            "            self.version += 1\n"
            "def apply_batch(g, vs):\n"
            "    n = vs.upsert([1])\n"
            "    bump_store_version(g)\n"
            "    return n\n")}),
    "vector-plain-tree": ("vector-coherence", {
        "pkg/store/gstore.py": "def build():\n    return 1\n"}),
    # --- device-telemetry: the trees without the dispatch rule's modules
    "device-plain-tree": ("device-telemetry", {
        "pkg/engine/tpu.py": "import jax\nf = jax.jit(lambda x: x)\n"}),
    "template-bad": ("device-telemetry", {
        "pkg/obs/device.py": DEV_OK,
        "pkg/engine/template_compile.py": (
            "def _program_key(tsig, caps):\n"
            "    return (tsig, tuple(caps))\n"
            "def choose_template_route(tsig, est):\n"
            "    sig = 'pad' + 'ding'\n"
            "    read_device_input(sig)\n"
            "    read_device_input('ghost_signal')\n"
            "    return 'device' if _observatory else 'host'\n")}),
    "template-good": ("device-telemetry", {
        "pkg/obs/device.py": DEV_OK,
        "pkg/engine/template_compile.py": (
            "TEMPLATE_ROUTES = {'device': 'fused whole-plan program',"
            " 'host': 'the NumPy walk'}\n"
            "def _route_knobs():\n"
            "    return (str(Global.template_device),)\n"
            "def _program_key(tsig, store_version, caps):\n"
            "    return (tsig, store_version, tuple(caps),"
            " _route_knobs())\n"
            "def choose_template_route(tsig, est):\n"
            "    eff = read_device_input('padding_efficiency')\n"
            "    n = read_device_input('dispatches')\n"
            "    return 'host' if eff is None else 'device'\n")}),
    "template-pre": ("device-telemetry", {"pkg/obs/device.py": DEV_OK}),
    # --- placement-telemetry (test_observatory.py) ---
    "placement-bad": ("placement-telemetry", {
        "pkg/obs/heat.py": "PLACEMENT_INPUTS = {'fetches': 'wukong_ok_total'}\n",
        "pkg/obs/placement.py": (
            "MIGRATION_PLAN_FIELDS = ('donor', 'stale_entry')\n"
            "class MigrationPlan:\n"
            "    donor: int\n"
            "    extra: int\n"
            "def advise(ts):\n"
            "    return ts.rate_by_label('wukong_rogue_total', 'shard')\n"
            "class A:\n"
            "    def __init__(self):\n"
            "        self.plans = {}\n"
            "        self.lock = make_lock('placement.x')\n")}),
    "placement-good": ("placement-telemetry", {
        "pkg/obs/heat.py": "PLACEMENT_INPUTS = {'fetches': 'wukong_ok_total'}\n",
        "pkg/obs/placement.py": (
            "MIGRATION_PLAN_FIELDS = ('donor',)\n"
            "declare_leaf('placement.x')\n"
            "class MigrationPlan:\n"
            "    donor: int\n"
            "def advise(ts):\n"
            "    return ts.rate_by_label('wukong_ok_total', 'shard')\n"
            "class A:\n"
            "    def __init__(self):\n"
            "        self.plans = {}  # guarded by: _lock\n"
            "        self.lock = make_lock('placement.x')\n")}),
    # --- heat-telemetry (test_profile.py) ---
    "heat-bad": ("heat-telemetry", {"pkg/obs/heat.py": (
        "PLACEMENT_INPUTS = {'fetches': 'wukong_nope_total'}\n"
        "class A:\n"
        "    def __init__(self):\n"
        "        self.shards = {}\n"
        "        self.lock = make_lock('heat.x')\n")}),
    "heat-good": ("heat-telemetry", {"pkg/obs/heat.py": (
        "PLACEMENT_INPUTS = {'fetches': 'wukong_ok_total'}\n"
        "declare_leaf('heat.x')\n"
        "reg.counter('wukong_ok_total')\n"
        "class A:\n"
        "    def __init__(self):\n"
        "        self.shards = {}  # guarded by: _lock\n"
        "        self.lock = make_lock('heat.x')\n")}),
    # --- slo-telemetry (test_slo.py) ---
    "slo-bad": ("slo-telemetry", {"pkg/obs/slo.py": (
        "ADMISSION_INPUTS = {'shed': 'wukong_nope_total'}\n"
        "class A:\n"
        "    def __init__(self):\n"
        "        self.tenants = {}\n"
        "        self.lock = make_lock('slo.x')\n")}),
    "slo-good": ("slo-telemetry", {"pkg/obs/slo.py": (
        "ADMISSION_INPUTS = {'shed': 'wukong_ok_total'}\n"
        "declare_leaf('slo.x')\n"
        "reg.counter('wukong_ok_total')\n"
        "class A:\n"
        "    def __init__(self):\n"
        "        self.tenants = {}  # guarded by: _lock\n"
        "        self.lock = make_lock('slo.x')\n")}),
    "slo-empty": ("slo-telemetry", {"pkg/other.py": "x = 1\n"}),
    # --- admission-contract (test_admission.py) ---
    "admission-bad": ("admission-contract", {
        "pkg/obs/slo.py": SLO_SRC, "pkg/runtime/admission.py": (
            "CONSUMED_INPUTS = ('lane_depth', 'phantom_signal')\n"
            "SHED_CAUSES = ('admission_defer', 'admission_ghost')\n"
            "def f():\n"
            "    read_admission_input('lane_depth')\n"
            "    read_admission_input('undeclared_read')\n"
            "    maybe_note_shed('admission_defer', 't')\n"
            "    maybe_note_shed('not_declared', 't')\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self.tenants = {}\n"
            "        self.lock = make_lock('admission.state')\n")}),
    "admission-good": ("admission-contract", {
        "pkg/obs/slo.py": SLO_SRC, "pkg/runtime/admission.py": (
            "CONSUMED_INPUTS = ('lane_depth',)\n"
            "SHED_CAUSES = ('admission_defer',)\n"
            "declare_leaf('admission.state')\n"
            "def f():\n"
            "    read_admission_input('lane_depth')\n"
            "    maybe_note_shed('admission_defer', 't')\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self.tenants = {}  # guarded by: _lock\n"
            "        self.lock = make_lock('admission.state')\n")}),
    "admission-empty": ("admission-contract", {"pkg/other.py": "x = 1\n"}),
    # --- join-strategy (test_wcoj.py) ---
    "join-clean": ("join-strategy", {"pkg/join/__init__.py": JOIN_GOOD,
                                     "pkg/planner/opt.py": CHOOSER_OK}),
    "join-undeclared-strategy": ("join-strategy", {
        "pkg/join/__init__.py": JOIN_GOOD, "pkg/planner/opt.py": CHOOSER_BAD}),
    "join-missing-registry": ("join-strategy", {
        "pkg/join/__init__.py": "X = 1\n"}),
    "join-readme-missing-row": ("join-strategy", {
        "pkg/join/__init__.py": JOIN_GOOD,
        "README.md": "| knob | default |\n|---|---|\n| `other` | x |\n"}),
    "join-readme-row": ("join-strategy", {
        "pkg/join/__init__.py": JOIN_GOOD,
        "README.md": "| knob | default |\n|---|---|\n| `join_strategy` | auto |\n"}),
    "join-route-needs-registry": ("join-strategy", {
        "pkg/join/__init__.py": JOIN_GOOD, "pkg/planner/opt.py": ROUTE_OK}),
    "join-undeclared-route": ("join-strategy", {
        "pkg/join/__init__.py": JOIN_ROUTES, "pkg/planner/opt.py": ROUTE_BAD}),
    "join-declared-route": ("join-strategy", {
        "pkg/join/__init__.py": JOIN_ROUTES, "pkg/planner/opt.py": ROUTE_OK}),
    "join-device-row-missing": ("join-strategy", {
        "pkg/join/__init__.py": JOIN_ROUTES,
        "README.md": "| knob | default |\n|---|---|\n| `join_strategy` | auto |\n"}),
    "join-device-row": ("join-strategy", {
        "pkg/join/__init__.py": JOIN_ROUTES,
        "README.md": ("| knob | default |\n|---|---|\n| `join_strategy` | auto |\n"
                      "| `join_device` | auto |\n")}),
}


def _run_both(tmp_path, gate: str, files: dict):
    write_tree(tmp_path, files)
    pkg = str(tmp_path / "pkg")
    return (jax_run(pkg, plugins=[gate]), run_analysis(pkg, plugins=[gate]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_gate_equals_jax_on_its_fixture(tmp_path, case):
    gate, files = CASES[case]
    jax_out, port_out = _run_both(tmp_path, gate, files)
    assert _norm(port_out) == _norm(jax_out)
    # the fixtures are not vacuous: every "bad" tree has findings
    if "bad" in case or "missing" in case or "undeclared" in case:
        assert port_out


# ---------------------------------------------------------------------------
# the two translated rules: port fixtures
# ---------------------------------------------------------------------------

def _to_torch(files: dict) -> dict:
    """The device fixtures with each jitted module as a torch module: the
    translated rule's trigger where the JAX rule's was."""
    return {rel: src.replace("import jax\n", "import torch\n")
            .replace("jax.jit(", "torch.compile(")
            for rel, src in files.items()}


def _dispatch_kind(v) -> tuple:
    """A violation with the dispatch rule's message and line (which name
    the trigger, jax.jit or a torch/cuda_lib line) reduced to its kind."""
    m = v.message
    if "references jax.jit" in m or "launches a hand kernel" in m:
        return (v.gate, v.path, "uncharged device module")
    if "is stale" in m:
        return (v.gate, v.path, m.split(" is stale")[0])
    return (v.gate, v.path, v.line, m)


@pytest.mark.parametrize("name,tree", [("bad", DEVICE_BAD),
                                       ("good", DEVICE_GOOD)])
def test_device_gate_translated_rule_matches_jax(tmp_path, name, tree):
    """The JAX device fixtures, jitted modules turned into torch modules:
    the port's findings are the JAX gate's on the original tree."""
    jax_pkg = write_tree(tmp_path / "jax", tree)
    port_pkg = write_tree(tmp_path / "port", _to_torch(tree))
    jax_out = jax_run(os.path.join(jax_pkg, "pkg"),
                      plugins=["device-telemetry"])
    port_out = run_analysis(os.path.join(port_pkg, "pkg"),
                            plugins=["device-telemetry"])
    assert [_dispatch_kind(v) for v in port_out] \
        == [_dispatch_kind(v) for v in jax_out]
    assert bool(port_out) == (name == "bad")


def test_device_gate_port_rule_fixtures(tmp_path):
    """The translated rule: a hand-kernel launcher (cuda_lib calls) or a
    torch module under engine/, join/, vector/ or stream/ must call the
    seam or be allowlisted; a module referencing jax.jit no longer
    triggers it; an allowlisted module with no device calls is stale."""
    dev = ("declare_leaf('device.dispatch')\n"
           "DEVICE_INPUTS = {'dispatches': 'wukong_device_d_total'}\n"
           "DEVICE_DISPATCH_ALLOWLIST = {"
           "'engine/idle.py': 'charged by its caller'}\n"
           "def reg(r):\n"
           "    r.counter('wukong_device_d_total', 'h')\n")
    pkg = write_tree(tmp_path / "pkg", {
        "obs/device.py": dev,
        "engine/launch.py": ("from wukong_tpu_torch.engine import cuda_lib\n"
                             "def go(fn):\n"
                             "    cuda_lib.count_launch(fn)\n"),
        "stream/frontier.py": "import torch\nx = torch.zeros(1)\n",
        "join/old.py": "import jax\nf = jax.jit(lambda x: x)\n",
        "vector/seamed.py": ("import torch\n"
                             "def scan():\n"
                             "    maybe_device_dispatch('knn', live=1)\n"),
        "engine/idle.py": "def f():\n    return 1\n",
        "runtime/proxy.py": "import torch\n",  # outside the seamed packages
    })
    out = run_analysis(pkg, plugins=["device-telemetry"])
    got = sorted((v.path, v.line) for v in out)
    assert got == [("engine/launch.py", 3), ("obs/device.py", 3),
                   ("stream/frontier.py", 1)]
    assert any("'engine/idle.py' is stale" in v.message for v in out)
    # the JAX gate checks none of it but the jitted join/ module
    jax_paths = {v.path for v in jax_run(pkg, plugins=["device-telemetry"])}
    assert "join/old.py" in jax_paths and "stream/frontier.py" not in jax_paths


def test_fault_sites_count_only_port_tests(tmp_path):
    """A site exercised only by a JAX-package test is untested for the
    port (the JAX gate counts every test file)."""
    write_tree(tmp_path, {**FAULT_TREE,
                          "tests/test_x.py": 'PLAN = "a.site:transient"\n'})
    pkg = str(tmp_path / "pkg")
    port = [v.message for v in run_analysis(pkg, plugins=["fault-sites"])]
    jax = [v.message for v in jax_run(pkg, plugins=["fault-sites"])]
    assert not any("never exercised" in m for m in jax)
    assert any("never exercised" in m and "'a.site'" in m for m in port)


def test_unported_declarations_go_stale(tmp_path, monkeypatch):
    """An UNPORTED_KNOBS knob the config now has, an UNPORTED_METRICS name
    now registered, a PENDING_CAUSES cause with a call site and a
    NON_LEAF_LOCKS lock declared a leaf are each a violation. The
    migration actuator emptied UNPORTED_METRICS and PENDING_CAUSES, so the
    case declares its own entries there."""
    from wukong_tpu_torch.analysis import cachegate, drift

    monkeypatch.setitem(drift.UNPORTED_METRICS, "wukong_migration_phase",
                        "a pending producer")
    monkeypatch.setitem(cachegate.PENDING_CAUSES, "cutover",
                        "a pending producer")
    write_tree(tmp_path, {
        "pkg/config.py": CONFIG_SRC.replace(
            "    knob_a: int = 1\n", "    knob_a: int = 1\n"
            "    enable_pallas: bool = True\n"),
        "pkg/m.py": ('from x import get_registry\n'
                     'M = get_registry().gauge("wukong_migration_phase", '
                     '"h")\n'),
        "pkg/obs/reuse.py": REUSE_OK.replace("('insert', 'restore')",
                                             "('insert', 'cutover')"),
        "pkg/store/dynamic.py": ("def f():\n"
                                 "    maybe_note_invalidation('insert')\n"
                                 "    maybe_note_invalidation('cutover')\n"),
        "pkg/vector/__init__.py": "VECTOR_METRICS = {}\n",
        "pkg/vector/knn.py": ("declare_leaf('vector.stage')\n"
                              "_l = make_lock('vector.stage')\n"),
        "README.md": ("`knob_a` `knob_b` `enable_pallas` "
                      "wukong_migration_phase\n"),
    })
    pkg = str(tmp_path / "pkg")
    msgs = "\n".join(v.message for v in run_analysis(
        pkg, plugins=["config-readme", "metrics-readme", "cache-coherence",
                      "vector-coherence"]))
    assert "'enable_pallas' is ported but still declared" in msgs
    assert "'wukong_migration_phase' is registered but still declared" \
        in msgs
    assert "pending invalidation cause 'cutover'" in msgs
    assert "'vector.stage' is declared a lockdep leaf but listed" in msgs


def test_pending_plan_artifact_waived_then_stale(tmp_path):
    """The MigrationPlan is ported, so nothing waives its registry any
    more: a placement module with neither the MigrationPlan nor its
    registry is flagged as the JAX gate flags it, with or without the
    sharded store's module, and a registry that is present is checked as
    the JAX gate checks it."""
    bare = {"pkg/obs/heat.py": "PLACEMENT_INPUTS = {}\n",
            "pkg/obs/placement.py": ("declare_leaf('placement.x')\n"
                                     "class Advisor:\n"
                                     "    def __init__(self):\n"
                                     "        self.lock = "
                                     "make_lock('placement.x')\n")}
    for sub, files in (("a", bare), ("b", {
            **bare, "pkg/parallel/sharded_store.py": "X = 1\n"})):
        pkg = write_tree(tmp_path / sub, files) + "/pkg"
        got = run_analysis(pkg, plugins=["placement-telemetry"])
        assert any("no literal MIGRATION_PLAN_FIELDS" in v.message
                   for v in got)
        assert _norm(got) == _norm(jax_run(pkg,
                                           plugins=["placement-telemetry"]))
    stale_registry = {**bare, "pkg/obs/placement.py": (
        "MIGRATION_PLAN_FIELDS = ('donor',)\n" + bare["pkg/obs/placement.py"])}
    pkg = write_tree(tmp_path / "c", stale_registry) + "/pkg"
    assert _norm(run_analysis(pkg, plugins=["placement-telemetry"])) == \
        _norm(jax_run(pkg, plugins=["placement-telemetry"]))
    assert run_analysis(pkg, plugins=["placement-telemetry"])


MIGRATION_MUTANTS = {
    # a phase transition that no longer journals
    "unjournaled retire": ("runtime/migration.py",
                           'emit_event("shard.migrate.retire"',
                           'emit_event("shard.migrate.retired"'),
    # the cutover swap with its lock (and the annotation naming it) gone
    "unguarded cutover": ("parallel/sharded_store.py",
                          "        # guarded by: _migration_lock — the swap, "
                          "placement update, and\n"
                          "        # rotation demotion are one atomic "
                          "publication to the read path\n"
                          "        i = int(i)\n"
                          "        with self._migration_lock:\n"
                          "            old = self.stores[i]",
                          "        i = int(i)\n"
                          "        if True:\n"
                          "            old = self.stores[i]"),
    # the actuator's state lock no longer a declared leaf
    "undeclared leaf": ("runtime/migration.py",
                        'declare_leaf("migration.state")',
                        'print("migration.state")'),
}


@pytest.mark.parametrize("mutant", sorted(MIGRATION_MUTANTS))
def test_migration_gate_catches_mutants_of_the_port(tmp_path, mutant):
    """The port's actuator and sharded store, each broken one way: the
    port's migration-safety gate flags the break exactly as the JAX gate
    does, and the unbroken files are clean under both."""
    rel, old, new = MIGRATION_MUTANTS[mutant]
    files = {}
    for name in ("runtime/migration.py", "parallel/sharded_store.py"):
        with open(os.path.join(PORT, name), encoding="utf-8") as f:
            files[name] = f.read()
    clean = write_tree(tmp_path / "clean", files)
    assert run_analysis(clean, plugins=["migration-safety"]) == []
    assert jax_run(clean, plugins=["migration-safety"]) == []
    assert old in files[rel]
    files[rel] = files[rel].replace(old, new, 1)
    bad = write_tree(tmp_path / "bad", files)
    got = run_analysis(bad, plugins=["migration-safety"])
    assert len(got) == 1 and got[0].path == rel
    assert _norm(got) == _norm(jax_run(bad, plugins=["migration-safety"]))


# ---------------------------------------------------------------------------
# the registry, the port's tree, the CLI
# ---------------------------------------------------------------------------

def test_registry_holds_the_sixteen_gates():
    """The JAX registry less transport-contract (it waits for the
    worker-process pool): the sixteen gates of the first port of the
    gates plus migration-safety, seventeen in all."""
    expected = set(jax_plugin_names()) - {"transport-contract"}
    assert plugin_names() == sorted(expected)
    assert "migration-safety" in plugin_names()
    assert len(plugin_names()) == 17


def test_port_tree_is_clean():
    bad = run_analysis()
    assert bad == [], "\n".join(map(str, bad))


def test_cli_json_list_and_exit_codes(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "wukong_tpu_torch.analysis", "--json"],
        capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["count"] == 0 and doc["violations"] == []
    assert set(doc["gates"]) == set(plugin_names())
    listed = subprocess.run(
        [sys.executable, "-m", "wukong_tpu_torch.analysis", "--list"],
        capture_output=True, text=True, cwd=REPO)
    assert listed.returncode == 0
    assert listed.stdout.split() == plugin_names()
    pkg = write_tree(tmp_path, {"m.py": "def f():\n    print('x')\n"})
    bad = subprocess.run(
        [sys.executable, "-m", "wukong_tpu_torch.analysis", "--gate",
         "no-bare-print", pkg], capture_output=True, text=True, cwd=REPO)
    assert bad.returncode == 1 and "bare print()" in bad.stdout
    unknown = subprocess.run(
        [sys.executable, "-m", "wukong_tpu_torch.analysis", "--gate",
         "no-such-gate"], capture_output=True, text=True, cwd=REPO)
    assert unknown.returncode == 2


# ---------------------------------------------------------------------------
# every JAX finding on the port's tree is declared by the port
# ---------------------------------------------------------------------------

def _enclosing_function(rel: str, line: int) -> str:
    import ast

    from wukong_tpu_torch.analysis.obs_gates import _ExecuteFinder

    f = _ExecuteFinder()
    with open(os.path.join(PORT, rel), encoding="utf-8") as fh:
        f.visit(ast.parse(fh.read()))
    return dict(f.hits)[line]


def _declared_by_port(v) -> str | None:
    """The port declaration that names this JAX finding, or None."""
    import re

    from wukong_tpu_torch.analysis import cachegate, drift, obs_gates, \
        placegate, vectorgate
    from wukong_tpu_torch.obs.device import DEVICE_DISPATCH_ALLOWLIST

    quoted = re.findall(r"'([^']+)'", v.message)
    if v.gate == "batcher-route":
        key = (v.path.rpartition("/")[2], _enclosing_function(v.path, v.line))
        return "EXECUTE_ALLOWLIST" if key in obs_gates.EXECUTE_ALLOWLIST \
            else None
    if v.gate == "config-readme" and quoted[0] in drift.UNPORTED_KNOBS:
        return "UNPORTED_KNOBS"
    if v.gate == "metrics-readme" and quoted[0] in drift.UNPORTED_METRICS:
        return "UNPORTED_METRICS"
    if v.gate == "cache-coherence" and quoted[0] in cachegate.PENDING_CAUSES:
        return "PENDING_CAUSES"
    if v.gate == "device-telemetry" and "is stale" in v.message \
            and quoted[0] in DEVICE_DISPATCH_ALLOWLIST:
        return "DEVICE_DISPATCH_ALLOWLIST"
    if v.gate == "vector-coherence" and quoted[0] in vectorgate.NON_LEAF_LOCKS:
        return "NON_LEAF_LOCKS"
    if v.gate == "transport-contract" and quoted[0] in drift.PENDING_WIRE_OPS:
        return "PENDING_WIRE_OPS"
    return None


def test_every_jax_finding_on_the_port_is_declared():
    found = jax_run(PORT)
    undeclared = [str(v) for v in found if _declared_by_port(v) is None]
    assert undeclared == []
    # each declaration is used: no entry names a gap that is not there
    from wukong_tpu_torch.analysis import cachegate, drift, placegate, \
        vectorgate

    by = {}
    for v in found:
        by.setdefault(_declared_by_port(v), set()).update(
            __import__("re").findall(r"'([^']+)'", v.message)[:1])
    assert set(drift.UNPORTED_KNOBS) == by["UNPORTED_KNOBS"]
    assert set(drift.UNPORTED_METRICS) == by.get("UNPORTED_METRICS", set())
    assert set(cachegate.PENDING_CAUSES) == by.get("PENDING_CAUSES", set())
    assert set(vectorgate.NON_LEAF_LOCKS) == by["NON_LEAF_LOCKS"]
    assert set(drift.PENDING_WIRE_OPS) == by["PENDING_WIRE_OPS"]
    # the distributed engine's knobs and metrics, the advisor's planning
    # half and its MigrationPlan are ported: the JAX gates find them in
    # the port's tree, and nothing declares them pending any more
    for knob in ("num_workers", "replication_factor", "enable_dist_inplace",
                 "dist_inplace_rows", "join_dist_parts", "transport_mode",
                 "transport_timeout_ms", "transport_connect_timeout_ms",
                 "transport_max_frame_mb", "placement_interval_s",
                 "placement_imbalance_x", "migration_enable",
                 "migration_rotate_reads"):
        assert knob not in drift.UNPORTED_KNOBS
        assert knob not in by.get("UNPORTED_KNOBS", ())
    for metric in ("wukong_breaker_open", "wukong_shard_fetch_degraded_total",
                   "wukong_placement_imbalance",
                   "wukong_placement_plan_bytes",
                   "wukong_join_dist_dispatch_total",
                   "wukong_join_dist_slices_total",
                   "wukong_join_dist_fallback_total",
                   "wukong_migrations_total", "wukong_migration_bytes_total",
                   "wukong_migration_duration_us",
                   "wukong_migration_aborts_total",
                   "wukong_migration_phase"):
        assert metric not in drift.UNPORTED_METRICS
        assert metric not in by.get("UNPORTED_METRICS", ())
    assert not hasattr(placegate, "PENDING_ARTIFACTS")
    assert not any(v.gate == "placement-telemetry" for v in found)
    # the migration actuator is ported: the cutover cause has its call
    # sites, and the JAX migration-safety gate finds nothing in the port
    assert cachegate.PENDING_CAUSES == {} and drift.UNPORTED_METRICS == {}
    assert not any(v.gate in ("migration-safety", "cache-coherence")
                   for v in found)
