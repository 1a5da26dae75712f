"""The port stands alone: with jax unimportable and every `wukong_tpu` module
refused, the whole of `wukong_tpu_torch` imports (its `obs/` plane included:
the metrics registry, tracing, the flight recorder, the event journal, the
exporters, the SLO plane and EXPLAIN, and the admission controller); with no
GPU, an entry point left at its default device raises instead of running on
the CPU, and a tenant's traced query, an EXPLAIN ANALYZE and a device trace
run on the CPU when asked."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    sys.modules["jax"] = None

    class RefuseJaxPackage(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "wukong_tpu" or name.startswith("wukong_tpu."):
                raise ImportError(f"refused: {name}")
            return None

    sys.meta_path.insert(0, RefuseJaxPackage())
    import torch
    import wukong_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(
        wukong_tpu_torch.__path__, "wukong_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    assert len(names) >= 20, names
    runtime = {"wukong_tpu_torch.runtime." + m for m in (
        "console", "emulator", "scheduler", "monitor", "faults",
        "resilience", "batcher", "proxy")}
    obs = {"wukong_tpu_torch.obs." + m for m in (
        "metrics", "trace", "events", "recorder", "export", "slo",
        "profile")}
    assert runtime | obs | {"wukong_tpu_torch.analysis.lockdep",
                            "wukong_tpu_torch.store.string_server",
                            "wukong_tpu_torch.loader.base",
                            "wukong_tpu_torch.obs",
                            "wukong_tpu_torch.runtime.admission"
                            } <= set(names), names
    from wukong_tpu_torch.obs import get_registry
    snap = get_registry().snapshot()
    for metric in ("wukong_batch_fused_queries_total", "wukong_shed_total",
                   "wukong_admission_decisions_total",
                   "wukong_slo_burn_alerts_total",
                   "wukong_cluster_events_total", "wukong_pool_utilization",
                   "wukong_query_latency_us"):
        assert metric in snap, metric
    leaked = [m for m in sys.modules
              if m == "wukong_tpu" or m.startswith("wukong_tpu.")
              or m == "jax" and sys.modules[m] is not None]
    assert not leaked, leaked

    from wukong_tpu_torch.loader.lubm import VirtualLubmStrings, generate_lubm
    from wukong_tpu_torch.runtime.proxy import Proxy
    from wukong_tpu_torch.store.gstore import build_partition

    g = build_partition(generate_lubm(1, seed=0)[0], 0, 1)
    ss = VirtualLubmStrings(1, seed=0)
    assert not torch.cuda.is_available()
    try:
        Proxy(g, ss)
    except RuntimeError as e:
        assert "no CUDA GPU" in str(e), e
    else:
        raise AssertionError("default-device Proxy ran without a GPU")
    import tempfile

    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.obs import export, get_recorder

    text = ("SELECT ?X WHERE { ?X "
            "<http://www.w3.org/1999/02/22-rdf-syntax-ns#type> "
            "<http://swat.cse.lehigh.edu/onto/univ-bench.owl#"
            "GraduateStudent> . }")
    proxy = Proxy(g, ss, device="cpu")
    Global.enable_tracing = True
    q = proxy.serve_query(text, tenant="gold")
    assert q.result.nrows > 0 and q.trace.tenant == "gold"
    assert get_recorder().last(1)[0] is q.trace
    assert proxy.explain_query(text, analyze=True)["rows"] == q.result.nrows
    with tempfile.TemporaryDirectory() as d:
        Global.xprof_dir = d
        proxy.run_single_query(text)
        assert export.last_capture.startswith(d)
    leaked = [m for m in sys.modules
              if m == "wukong_tpu" or m.startswith("wukong_tpu.")
              or m == "jax" and sys.modules[m] is not None]
    assert not leaked, leaked
    print("ISOLATED", len(names))
""")


def test_port_imports_without_jax_and_refuses_missing_gpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ISOLATED" in r.stdout


def test_no_jax_or_jax_package_imports_in_port_sources():
    import re

    pat = re.compile(r"^\s*(import|from) (jax|wukong_tpu)(\.|\s|$)")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _subdirs, names in os.walk(os.path.join(ROOT, "wukong_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = [f"{f}:{i}" for f in files if os.path.exists(f)
           for i, line in enumerate(open(f), 1) if pat.match(line)]
    assert not bad, bad
