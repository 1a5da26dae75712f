"""The port's heat and placement observatory and its HTTP plane
(obs/heat.py, obs/placement.py, obs/httpd.py; device="cpu") against the
JAX package's, mirroring tests/test_observatory.py:

- the heat report, the shard lineage, the advisor's store-less decisions
  (the JAX advisor with no store attached) and ``render_plan``'s body
  equal the JAX functions' on the same inputs, clocks pinned;
- a vector scan charges its shard, kind ``vector``, as the JAX scan does,
  with neither ``vector.stage`` nor ``vector.slice`` held (lockdep);
- every endpoint answers on a free loopback port; ``/top.json``,
  ``/plan.json``, ``/history.json`` and ``/healthz`` equal the JAX
  server's bodies, and ``/healthz`` reports dead engines (503 under
  ``health_ready_503``); the snapshotter writes a parseable file;
- scrapes of every endpoint during closed-loop serving under lockdep end
  with no error, no lock-order cycle and no leaf inversion, with every
  render plane's ledger lock tracked;
- the ``top``, ``plan`` and ``metrics`` verbs and the monitor's heat
  lines; the kernel build cache's boot outcomes.

Each test resets ``get_heat()``, ``get_advisor()``, ``get_lineage()`` and
``get_tsdb()`` in both packages.
"""

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from wukong_tpu.config import Global as JGlobal
from wukong_tpu.obs import heat as jheat
from wukong_tpu.obs import httpd as jhttpd
from wukong_tpu.obs import placement as jplacement
from wukong_tpu.obs.tsdb import get_tsdb as jget_tsdb
from wukong_tpu.runtime import scheduler as jsched
from wukong_tpu_torch.analysis import lockdep
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.loader import lubm as plubm
from wukong_tpu_torch.obs import heat, httpd, placement
from wukong_tpu_torch.obs.tsdb import get_tsdb
from wukong_tpu_torch.runtime import scheduler
from wukong_tpu_torch.types import OUT

torch.set_num_threads(2)

UB = "http://swat.cse.lehigh.edu/onto/univ-bench.owl#"
ENDPOINTS = ("/metrics", "/metrics.json", "/top", "/top.json", "/slo",
             "/slo.json", "/admission", "/admission.json", "/history",
             "/history.json", "/events", "/events.json", "/plan",
             "/plan.json", "/cache", "/cache.json", "/device",
             "/device.json", "/healthz")


def _reset_planes():
    for mod_heat, mod_pl, tsdb in ((heat, placement, get_tsdb()),
                                   (jheat, jplacement, jget_tsdb())):
        mod_heat.get_heat().reset()
        mod_pl.get_advisor().reset()
        mod_pl.get_lineage().reset()
        tsdb.reset()


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    for G in (Global, JGlobal):
        for k, v in (("enable_heat", True), ("heat_window", 512),
                     ("top_k", 8), ("placement_window_s", 300),
                     ("metrics_port", 0), ("health_ready_503", False),
                     ("enable_tsdb", False), ("metrics_snapshot_s", 0),
                     ("metrics_snapshot_path", "")):
            monkeypatch.setattr(G, k, v)
    # the JAX advisor's planning knobs (the port's come with its sharded
    # store): at their defaults
    monkeypatch.setattr(JGlobal, "placement_interval_s", 0)
    monkeypatch.setattr(JGlobal, "placement_imbalance_x", 2.0)
    _reset_planes()
    yield
    httpd.stop_metrics_http()
    jhttpd.stop_metrics_http()
    _reset_planes()


class _Clock:
    """A pinned get_usec: the same sequence in both packages."""

    def __init__(self, start=1_000_000, step=250):
        self.t, self.step = start, step

    def __call__(self):
        self.t += self.step
        return self.t


def _pin_clocks(monkeypatch):
    for mod in (heat, jheat, placement, jplacement):
        monkeypatch.setattr(mod, "get_usec", _Clock())


CHARGES = [(0, "primary", 100, 800, 40), (1, "primary", 10, 80, 15),
           (0, "vector", 5000, 320000, 900), (2, "failover", 7, 56, 2000),
           (0, "primary", 100, 800, 35), (1, "degraded", 0, 0, 5),
           (0, "rotation", 3, 24, 60), (0, "vector", 5000, 320000, 950)]


def _charge_both(charges=CHARGES):
    for args in charges:
        heat.get_heat().charge(*args)
        jheat.get_heat().charge(*args)


@pytest.mark.parametrize("k", [None, 1, 2])
def test_heat_report_equals_jax(monkeypatch, k):
    _pin_clocks(monkeypatch)
    _charge_both()
    assert heat.get_heat().report(k) == jheat.get_heat().report(k)
    assert heat.get_heat().load_rate_cdf(0) \
        == jheat.get_heat().load_rate_cdf(0)
    assert heat.get_heat().ewma_series() == jheat.get_heat().ewma_series()
    assert heat.FETCH_KINDS == jheat.FETCH_KINDS
    assert heat.PLACEMENT_INPUTS == jheat.PLACEMENT_INPUTS


def test_maybe_charge_and_payload_size_equal_jax(monkeypatch):
    _pin_clocks(monkeypatch)
    a = np.arange(10, dtype=np.int64)
    for payload in ((a, a[:3]), a, None, (None, "x")):
        assert heat.payload_size(payload) == jheat.payload_size(payload)
        heat.maybe_charge(3, "primary", payload, 7)
        jheat.maybe_charge(3, "primary", payload, 7)
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "enable_heat", False)
    heat.maybe_charge(3, "primary", a, 7)  # off: one knob check
    jheat.maybe_charge(3, "primary", a, 7)
    assert heat.get_heat().report() == jheat.get_heat().report()
    assert heat.get_heat().report()["shards"][3]["fetches"] == 4


def test_lineage_report_equals_jax(monkeypatch):
    _pin_clocks(monkeypatch)
    for mod in (placement, jplacement):
        lin = mod.get_lineage()
        lin.note_placement(0, 0, replica_hosts=(1,), store_version=3)
        lin.note_placement(1, 1, rotation_hosts=(2,), store_version=4)
        lin.note_failover(1, 2)
        lin.note_heal(1, source="checkpoint")
        lin.note_checkpoint(0, 123456)
    lin, jlin = placement.get_lineage(), jplacement.get_lineage()
    assert lin.report() == jlin.report()
    for s in (0, 1, 5):
        assert lin.hosts_of(s) == jlin.hosts_of(s)
        assert lin.serving_hosts_of(s) == jlin.serving_hosts_of(s)
        assert lin.checkpoint_bytes(s) == jlin.checkpoint_bytes(s)


class _TSDB:
    """A trend window with fixed per-shard fetch rates."""

    def __init__(self, rates: dict):
        self.rates = rates
        self.reads = []

    def rate_by_label(self, name, label, window_s=None):
        self.reads.append((name, label, window_s))
        return dict(self.rates)


#: per-shard fetch rates in the trend window; the JAX advisor runs with
#: no store attached, as the port's always does
SCENARIOS = {
    "no-data": {},
    "no-store-with-heat": {"0": 9.0},
    "balanced": {"0": 1.0, "1": 1.2, "2": 0.9, "3": 1.1},
    "hot-shard": {"0": 40.0, "1": 1.0, "2": 2.0, "3": 1.0},
    "retired-labels": {"0": 40.0, "7": 90.0, "x": 3.0},
    "one-shard": {"0": 5.0},
    "non-numeric-labels": {"x": 3.0},
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_advisor_decisions_equal_jax(monkeypatch, name):
    _pin_clocks(monkeypatch)
    rates = SCENARIOS[name]
    out = []
    for adv in (placement.PlacementAdvisor(tsdb=_TSDB(rates)),
                jplacement.PlacementAdvisor(tsdb=_TSDB(rates),
                                            lineage=jplacement.ShardLineage())):
        plan = adv.advise_once(window_s=60)
        out.append((adv.status(), plan, adv.tsdb().reads))
    assert out[0] == out[1]
    status = out[0][0]
    want = "no_data" if name in ("no-data", "non-numeric-labels") \
        else "no_store"
    assert status == {"decision": want, "imbalance": 0.0, "plan": None}


def test_render_plan_equals_jax(monkeypatch):
    """With no sharded store attached, a sweep over vector heat renders
    the JAX advisor's no-store status, line for line."""
    _pin_clocks(monkeypatch)
    for mod in (placement, jplacement):
        monkeypatch.setattr(mod.get_advisor(), "_tsdb",
                            _TSDB({"0": 12.5}))
    for mod in (placement, jplacement):
        mod.get_lineage().note_checkpoint(0, 4096)
    text, js = placement.render_plan()
    jtext, jjs = jplacement.render_plan()
    # both bodies carry their idle migration actuator's status
    assert js["migration"] == jjs["migration"]
    assert js["migration"]["in_flight"] is False
    assert js == jjs
    assert js["status"]["decision"] == "no_store"
    assert text == jtext
    assert text.splitlines()[2].startswith("decision no_store  imbalance "
                                           "0.00 (threshold 2")
    assert "4,096" in text.splitlines()[-1]
    text2, _ = placement.render_plan(advise=False)
    assert text2 == text


def test_monitor_heat_and_placement_lines_equal_jax(monkeypatch):
    from wukong_tpu.runtime.monitor import Monitor as JMonitor
    from wukong_tpu_torch.runtime.monitor import Monitor

    _pin_clocks(monkeypatch)
    mon, jmon = Monitor(), JMonitor()
    assert mon.heat_lines() == [] == jmon.heat_lines()
    _charge_both()
    assert mon.heat_lines(k=2) == jmon.heat_lines(k=2)
    assert mon.shard_load_cdfs() == jmon.shard_load_cdfs()
    # under the store-less decision the placement line is quiet (it
    # prints a MigrationPlan)
    for mod in (placement, jplacement):
        monkeypatch.setattr(mod.get_advisor(), "_tsdb", _TSDB({"0": 4.0}))
        mod.render_plan()
    assert mon.placement_lines() == jmon.placement_lines() == []


# ---------------------------------------------------------------------------
# the vector scans' heat charge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sid", [0, 1])
def test_vector_scan_charges_heat_as_jax(monkeypatch, sid):
    from wukong_tpu.vector import knn as jknn
    from wukong_tpu.vector.vstore import VectorStore as JVectorStore
    from wukong_tpu_torch.vector import knn
    from wukong_tpu_torch.vector.vstore import VectorStore

    rng = np.random.default_rng(3)
    vids = np.arange(0, 2000, dtype=np.int64)
    vecs = rng.standard_normal((len(vids), 8)).astype(np.float32)
    vs, jvs = VectorStore(sid, 2, 8), JVectorStore(sid, 2, 8)
    vs.upsert(vids, vecs)
    jvs.upsert(vids, vecs)
    anchor = vecs[5]
    for route in ("host", "device"):
        got = knn.scan_topk(vs, anchor, 7, "cosine", route=route,
                            device="cpu")
        want = jknn.scan_topk(jvs, anchor, 7, "cosine", route=route)
        assert np.array_equal(got[0], want[0])
    rep, jrep = heat.get_heat().report(), jheat.get_heat().report()
    keep = ("fetches", "by_kind", "rows", "bytes", "share")
    assert {s: {k: r[k] for k in keep} for s, r in rep["shards"].items()} \
        == {s: {k: r[k] for k in keep} for s, r in jrep["shards"].items()}
    assert rep["shards"][sid]["by_kind"]["vector"] == 2
    owned = len(vs.snapshot()[0])
    assert 0 < owned < len(vids)
    assert rep["shards"][sid]["rows"] == 2 * owned


# ---------------------------------------------------------------------------
# the HTTP plane
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read().decode()


def test_every_endpoint_answers_and_equals_jax(monkeypatch):
    _pin_clocks(monkeypatch)
    _charge_both()
    for mod in (placement, jplacement):
        monkeypatch.setattr(mod.get_advisor(), "_tsdb", _TSDB({"0": 4.0}))
    port = _free_port()
    assert httpd.maybe_start_metrics_http(port=port) is not None
    assert httpd.maybe_start_metrics_http(port=port) is httpd._server
    jport = _free_port()
    assert jhttpd.maybe_start_metrics_http(port=jport) is not None
    bodies = {}
    for path in ENDPOINTS:
        status, body = _get(port, path)
        assert status == 200, path
        if path.endswith(".json") or path == "/healthz":
            bodies[path] = json.loads(body)
        else:
            assert body
    assert "wukong_shard_heat_fetches_total" in _get(port, "/metrics")[1]
    for path in ("/top.json", "/plan.json?sweep=1", "/history.json",
                 "/healthz"):
        got = json.loads(_get(port, path)[1])
        want = json.loads(_get(jport, path)[1])
        if path == "/top.json":  # process-wide cache and lane counters
            got, want = got["shards"], want["shards"]
        if path.startswith("/plan"):  # the JAX actuator's status
            got.pop("migration"), want.pop("migration")
        assert got == want, path
    assert json.loads(_get(port, "/plan.json")[1])["status"]["decision"] \
        == "no_store"
    assert json.loads(_get(port, "/top.json?k=1")[1])["shards"]["ranked"][0][
        "shard"] == 0
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/nope")
    assert e.value.code == 404


def test_healthz_reports_dead_engines(monkeypatch):
    class Echo:
        def execute(self, q):
            return q

    pool = scheduler.EnginePool(num_engines=2, make_engine=lambda t: Echo())
    jpool = jsched.EnginePool(num_engines=2, make_engine=lambda t: Echo())
    assert httpd.health_report() == jhttpd.health_report()
    for p in (pool, jpool):
        with p._route_lock:
            p._dead[0] = True
    rep = httpd.health_report()
    assert rep == jhttpd.health_report()
    assert rep["live"] and not rep["ready"]
    assert rep["degraded"]["dead_engines"] >= 1
    port = _free_port()
    httpd.maybe_start_metrics_http(port=port)
    assert json.loads(_get(port, "/healthz")[1]) == rep
    monkeypatch.setattr(Global, "health_ready_503", True)
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/healthz")
    assert e.value.code == 503
    httpd.register_health_source("test", lambda: {"x": 1})
    try:
        assert httpd.health_report()["degraded"]["test"] == {"x": 1}
    finally:
        with httpd._lock:
            httpd._health_sources.pop("test", None)
    del pool, jpool


def test_snapshotter_writes_parseable_snapshots(tmp_path, monkeypatch):
    assert httpd.maybe_start_snapshotter() is None  # off by default
    path = str(tmp_path / "snap.json")
    monkeypatch.setattr(Global, "metrics_snapshot_s", 1)
    monkeypatch.setattr(Global, "metrics_snapshot_path", path)
    snap = httpd.maybe_start_snapshotter()
    assert isinstance(snap, httpd.MetricsSnapshotter)
    snap.stop()  # the final write
    assert snap.writes >= 1
    with open(path) as f:
        doc = json.load(f)
    assert "wukong_shard_heat_fetches_total" in doc
    assert not os.path.exists(path + ".tmp")


def test_metrics_port_knob_and_bind_failure(monkeypatch):
    assert httpd.maybe_start_metrics_http() is None  # metrics_port 0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen()
        busy = s.getsockname()[1]
        assert httpd.maybe_start_metrics_http(port=busy) is None
    monkeypatch.setattr(Global, "metrics_port", _free_port())
    assert httpd.maybe_start_metrics_http() is not None


# ---------------------------------------------------------------------------
# scrapes during serving, lockdep-checked; the console verbs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    triples, _ = plubm.generate_lubm(1, seed=42)
    return {"triples": triples, "ss": plubm.VirtualLubmStrings(1, seed=42)}


def _proxy(world):
    from wukong_tpu_torch.runtime.proxy import Proxy
    from wukong_tpu_torch.store.gstore import build_partition

    return Proxy(build_partition(world["triples"], 0, 1), world["ss"],
                 device="cpu")


#: the ledger locks of the planes the handler renders: process-wide
#: singletons made at import, which checked mode must rebuild to track
RENDER_LOCKS = ("admission.state", "device.compile", "device.dispatch",
                "device.residency", "events.ring", "heat.shard",
                "placement.advisor", "placement.lineage",
                "profile.templates", "reuse.ledger", "reuse.shadow",
                "slo.signals", "slo.tenants", "tsdb.ring")


def _lock_holds() -> dict:
    """Tracked lock name -> releases recorded (the hold histogram)."""
    from wukong_tpu_torch.obs.metrics import get_registry

    fam = get_registry().snapshot().get("wukong_lock_hold_us") or {}
    return {s["labels"]["name"]: s["count"] for s in fam.get("series", [])}


def test_concurrent_scrapes_during_serving(world, monkeypatch):
    """Every endpoint scraped in turn by five threads while two closed-loop
    threads serve, the whole process lockdep-checked: every reply 200, no
    error, no lock-order cycle and no leaf inversion, and every render
    plane's ledger lock was tracked (a check that tracked nothing could
    not fail)."""
    lockdep.install(True)
    try:
        before = _lock_holds()
        monkeypatch.setattr(Global, "enable_tsdb", True)
        proxy = _proxy(world)
        g, ss = proxy.g, proxy.str_server
        pid = ss.str2id(f"<{UB}advisor>")
        anchors = np.asarray(g.get_index(pid, OUT))[:8]
        texts = [f"SELECT ?s WHERE {{ ?s <{UB}advisor> "
                 f"{ss.id2str(int(a))} . }}" for a in anchors]
        port = _free_port()
        assert httpd.maybe_start_metrics_http(port=port) is not None
        stop = threading.Event()
        errors: list = []
        served = [0]

        def serve():
            i = 0
            while not stop.is_set():
                try:
                    proxy.serve_query(texts[i % len(texts)], blind=True)
                    served[0] += 1
                except Exception as e:
                    errors.append(("serve", repr(e)))
                i += 1

        def scrape(k):
            i = k
            while not stop.is_set():
                path = ENDPOINTS[i % len(ENDPOINTS)]
                try:
                    status, _body = _get(port, path)
                    if status != 200:
                        errors.append((path, status))
                except Exception as e:
                    errors.append((path, repr(e)))
                i += 1
                get_tsdb().sample_once()

        threads = ([threading.Thread(target=serve, daemon=True)
                    for _ in range(2)]
                   + [threading.Thread(target=scrape, args=(k,), daemon=True)
                      for k in range(5)])
        try:
            for t in threads:
                t.start()
            time.sleep(1.5)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
            httpd.stop_metrics_http()
        assert errors == [], errors[:4]
        assert served[0] > 0
        # bounded memory: the ring's count cap holds though the scrapers
        # sampled far faster than the nominal interval
        assert len(get_tsdb()) <= int(
            Global.tsdb_retention_s / max(Global.tsdb_interval_s, 1)) + 8
        rep = lockdep.report()
        assert rep["cycles"] == [] and rep["leaf_violations"] == []
        after = _lock_holds()
        untracked = [n for n in RENDER_LOCKS
                     if after.get(n, 0) <= before.get(n, 0)]
        assert untracked == []
    finally:
        lockdep.install(False)


def test_console_top_plan_metrics_verbs(world, capsys):
    from wukong_tpu_torch.runtime.console import Console

    _charge_both()
    con = Console(_proxy(world))
    con.run_command("top -k 2")
    out = capsys.readouterr().out
    assert out.startswith("wukong-top  (top 2 per section)")
    assert "SHARDS by fetches (total 8)" in out
    con.run_command("top -j")
    assert json.loads(capsys.readouterr().out)["shards"]["total_fetches"] == 8
    con.run_command("plan -n")
    assert "wukong-plan  (placement advisor, observe-only)" \
        in capsys.readouterr().out
    con.run_command("plan -j")
    assert "status" in json.loads(capsys.readouterr().out)
    con.run_command("metrics")
    assert "# TYPE wukong_shard_heat_fetches_total counter" \
        in capsys.readouterr().out
    con.run_command("metrics -j")
    assert "wukong_placement_plans_total" in json.loads(
        capsys.readouterr().out)
    con.run_command("help")
    help_text = capsys.readouterr().out
    for verb in ("top [-k <n>] [-j]", "plan [-j] [-n]", "metrics [-j]"):
        assert verb in help_text


def test_emulator_run_serving_writes_a_snapshot(world, tmp_path,
                                                monkeypatch):
    from wukong_tpu_torch.runtime.emulator import Emulator

    path = str(tmp_path / "soak.json")
    monkeypatch.setattr(Global, "metrics_snapshot_s", 1)
    monkeypatch.setattr(Global, "metrics_snapshot_path", path)
    proxy = _proxy(world)
    text = (f"SELECT ?s WHERE {{ ?s <{UB}advisor> "
            "<http://www.Department0.University0.edu/FullProfessor0> . }")
    rep = Emulator(proxy).run_serving([text], duration_s=0.2, warmup_s=0.1,
                                      clients=2)
    assert rep["qps"] > 0
    with open(path) as f:
        assert "wukong_query_latency_us" in json.load(f)


# ---------------------------------------------------------------------------
# the kernel build cache's boot outcomes (utils/compilecache.py)
# ---------------------------------------------------------------------------

def _compile_count(outcome):
    from wukong_tpu_torch.obs.metrics import get_registry

    return get_registry().counter(
        "wukong_device_compile_cache_total",
        labels=("outcome", "site")).value(outcome=outcome, site="boot")


def test_build_cache_outcomes_reach_the_device_observatory(tmp_path,
                                                           monkeypatch):
    """A build with every library present is a ``hit``; one that runs the
    compiler a ``miss`` (a stand-in compiler here: the CPU has no nvcc);
    a failed build raises and charges nothing."""
    import sys

    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.utils.compilecache import setup_persistent_cache

    monkeypatch.setattr(cuda_lib, "BUILD", tmp_path / "build")
    fake = tmp_path / "fake_nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_lib, "_nvcc", lambda: str(fake))
    miss, hit = _compile_count("miss"), _compile_count("hit")
    assert setup_persistent_cache() == str(tmp_path / "build")
    assert cuda_lib.last_build_outcome == "miss"
    assert _compile_count("miss") == miss + 1
    setup_persistent_cache()
    assert cuda_lib.last_build_outcome == "hit"
    assert _compile_count("hit") == hit + 1
    for f in (tmp_path / "build").iterdir():
        f.unlink()
    fake.write_text(f"#!{sys.executable}\nimport sys\nsys.exit(3)\n")
    with pytest.raises(RuntimeError, match="failed"):
        cuda_lib.build_all()
    assert (_compile_count("miss"), _compile_count("hit")) \
        == (miss + 1, hit + 1)


def test_scan_heat_charge_is_taken_outside_the_vector_locks(monkeypatch):
    """Under lockdep, a device scan (staging under vector.stage) and a
    sliced scan (claims under vector.slice) charge heat.shard with neither
    vector lock held: no order edge from either into the heat lock."""
    from wukong_tpu_torch.runtime.scheduler import EnginePool
    from wukong_tpu_torch.vector import knn
    from wukong_tpu_torch.vector.vstore import VectorStore

    lockdep.install(True)
    try:
        monkeypatch.setattr(heat, "_accountant", heat.ShardHeatAccountant())
        monkeypatch.setattr(knn, "_stage_lock",
                            lockdep.make_lock("vector.stage"))
        rng = np.random.default_rng(5)
        vids = np.arange(3000, dtype=np.int64)
        vecs = rng.standard_normal((len(vids), 8)).astype(np.float32)
        vs = VectorStore(0, 1, 8)
        vs.upsert(vids, vecs)
        pool = EnginePool(num_engines=2, make_engine=lambda t: None)
        pool.start()
        try:
            knn.scan_topk(vs, vecs[0], 5, "dot", route="device",
                          device="cpu")
            knn.sliced_topk(pool, vs, vecs[1], 5, "dot", "device", 3,
                            device="cpu")
        finally:
            pool.stop()
        rep = lockdep.report()
        edges = {(e["from"], e["to"]) for e in rep["edges"]}
        assert ("vector.stage", "heat.shard") not in edges
        assert ("vector.slice", "heat.shard") not in edges
        assert ("vector.stage", "vector.slots") in edges  # it was tracked
        assert rep["cycles"] == [] and rep["leaf_violations"] == []
        assert heat.get_heat().report()["shards"][0]["fetches"] == 2
    finally:
        lockdep.install(False)


def test_report_endpoints_equal_jax_on_reset_planes():
    """/slo, /admission, /events, /cache, /device and /history as JSON,
    every plane reset in both packages: the bodies equal the JAX server's
    (/device's knobs name the JAX package's xla_cache_dir, which the port
    has no counterpart for; /admission's in-flight ceiling counts each
    package's live pools, /cache reads cumulative registry counters (its
    keys are compared) and /events' sequence numbers count the process's
    earlier events)."""
    import gc

    from wukong_tpu.obs import device as jdev
    from wukong_tpu.obs import events as jev
    from wukong_tpu.obs import reuse as jreuse
    from wukong_tpu.obs import slo as jslo
    from wukong_tpu.runtime import admission as jadm
    from wukong_tpu_torch.obs import device as pdev
    from wukong_tpu_torch.obs import events as pev
    from wukong_tpu_torch.obs import reuse as preuse
    from wukong_tpu_torch.obs import slo as pslo
    from wukong_tpu_torch.runtime import admission as padm

    gc.collect()
    for ev, reuse, dev, slo, adm in ((pev, preuse, pdev, pslo, padm),
                                     (jev, jreuse, jdev, jslo, jadm)):
        ev.get_journal().clear()
        reuse.get_reuse().reset()
        dev.get_device_obs().reset()
        slo.get_slo().reset()
        slo.get_overload().reset()
        adm.get_admission().reset()
    for mod in (pev, jev):
        mod.emit_event("checkpoint.write", parts=1)
        mod.emit_event("breaker.trip", shard=2, key="2")
    port, jport = _free_port(), _free_port()
    httpd.maybe_start_metrics_http(port=port)
    jhttpd.maybe_start_metrics_http(port=jport)
    for path in ("/slo.json", "/admission.json", "/events.json",
                 "/cache.json", "/device.json", "/history.json"):
        got = json.loads(_get(port, path)[1])
        want = json.loads(_get(jport, path)[1])
        if path == "/device.json":
            assert got["knobs"].pop("xla_cache_dir", None) is None
            assert want["knobs"].pop("xla_cache_dir") is not None
        if path == "/admission.json":
            got.pop("inflight_cap"), want.pop("inflight_cap")
        if path == "/cache.json":  # it reads the registry's cumulative
            # counters (parse, plan, uncacheable, the serving plane's):
            # each process's own history, so the shape is compared
            got, want = sorted(got), sorted(want)
        if path == "/events.json":  # ids, sequence numbers and times
            for js in (got, want):  # count the process's earlier events
                for e in js["events"]:
                    for key in ("event_id", "seq", "t_us"):
                        e.pop(key, None)
        assert got == want, path
