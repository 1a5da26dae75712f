"""The distributed engine behind the port's serving surface (device="cpu"),
against the JAX package where it has a counterpart:

- a ``Proxy`` over a ``DistEngine``: ``device="dist"`` answers the host
  engine's rows; a shape the distributed engine refuses (UNSUPPORTED_SHAPE)
  runs again on the host engine; with replication_factor > 1 the proxy
  starts the heal watcher and serves complete replies through a shard-down
  fault (tests/test_torch_heal.py holds the heal against JAX's); ``load
  -d`` reaches every shard and drops the
  learned chain capacities; a shard-down reply shows in ``/healthz``'s
  ``shards`` probe and the monitor's breaker line;
- the distributed WCOJ (join/dist.py) on a 4-shard triangle world, on the
  heavy lane of a host pool: the JAX executor's rows, a ``join.slice``
  fault re-run inline, a single slice without a pool, the federated
  view's version;
- ``Emulator.run_hotspot``: the JAX drill's hot shard, ranking and
  MigrationPlan, the store untouched; the advisor's planning half;
- the console's ``--dist -w 8`` one-shot, with the JAX console's rows.
"""

import numpy as np
import pytest

import chip_smoke
from wukong_tpu.config import Global as JG
from wukong_tpu.engine.cpu import CPUEngine as JCPU
from wukong_tpu.join.dist import DistributedWCOJExecutor as JDWCOJ
from wukong_tpu.loader.datagen import generate_triangle as jtri
from wukong_tpu.loader.lubm import VirtualLubmStrings, generate_lubm
from wukong_tpu.obs import heat as jheat
from wukong_tpu.obs import placement as jplacement
from wukong_tpu.obs import tsdb as jtsdb
from wukong_tpu.parallel.dist_engine import DistEngine as JDist
from wukong_tpu.parallel.mesh import make_mesh as jmesh
from wukong_tpu.planner.heuristic import heuristic_plan as jplan
from wukong_tpu.planner.stats import Stats as JStats
from wukong_tpu.runtime import console as jconsole
from wukong_tpu.runtime import migration as jmigration
from wukong_tpu.runtime.emulator import Emulator as JEmulator
from wukong_tpu.runtime.proxy import Proxy as JProxy
from wukong_tpu.sparql import ir as jir
from wukong_tpu.store.gstore import build_all_partitions as jbap
from wukong_tpu.store.gstore import build_partition as jbp
from wukong_tpu_torch.analysis import lockdep
from wukong_tpu_torch.config import Global as PG
from wukong_tpu_torch.engine.cpu import CPUEngine
from wukong_tpu_torch.join.dist import DistributedWCOJExecutor, ShardedJoinView
from wukong_tpu_torch.join.wcoj import WCOJExecutor
from wukong_tpu_torch.loader import lubm as pl
from wukong_tpu_torch.loader.datagen import generate_triangle
from wukong_tpu_torch.obs import heat as pheat
from wukong_tpu_torch.obs import placement
from wukong_tpu_torch.obs import tsdb as ptsdb
from wukong_tpu_torch.obs.httpd import health_report
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.parallel.dist_engine import DistEngine
from wukong_tpu_torch.planner.heuristic import heuristic_plan
from wukong_tpu_torch.planner.stats import Stats
from wukong_tpu_torch.runtime import console, faults, migration
from wukong_tpu_torch.runtime.emulator import Emulator
from wukong_tpu_torch.runtime.faults import FaultPlan, FaultSpec
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.runtime.scheduler import EnginePool
from wukong_tpu_torch.sparql import ir as pir
from wukong_tpu_torch.store.gstore import build_all_partitions, build_partition
from wukong_tpu_torch.types import IN
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError

QUERIES = chip_smoke.QUERIES


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    """Knobs restored, no leaked fault plan, the process-wide advisor,
    lineage, heat and migration actuator detached after each test (a
    retired world must not advise)."""
    for G in (PG, JG):
        for name in ("enable_dist_inplace", "retry_base_ms", "retry_max_ms",
                     "enable_tpu", "replication_factor", "enable_planner",
                     "breaker_cooldown_ms"):
            monkeypatch.setattr(G, name, getattr(G, name))
        G.retry_base_ms, G.retry_max_ms = 1, 2
    faults.clear()
    yield
    faults.clear()
    for mod in (placement, jplacement):
        mod.get_advisor().reset()
        mod.get_lineage().reset()
    for mod in (pheat, jheat):
        mod.get_heat().reset()
    for mig in (migration, jmigration):
        mig.get_migrator().reset()


@pytest.fixture(scope="module")
def lubm():
    t, _ = pl.generate_lubm(1, seed=42)
    return t, pl.VirtualLubmStrings(1, seed=42)


def _proxy(lubm, **kw):
    """A host-only proxy (enable_tpu off) over a fresh 8-slot engine."""
    t, ss = lubm
    PG.enable_tpu = False
    dist = DistEngine(build_all_partitions(t, 8), ss, device="cpu")
    return Proxy(build_partition(t, 0, 1), ss, device="cpu",
                 dist_engine=dist, **kw)


def _rows(q):
    return sorted(map(tuple, np.asarray(q.result.table).tolist()))


def test_proxy_dist_route_answers_the_host_rows(lubm):
    proxy = _proxy(lubm)
    for name in ("lubm_q1", "lubm_q3", "lubm_q7"):
        qd = proxy.run_single_query(QUERIES[name], device="dist", blind=False)
        qc = proxy.run_single_query(QUERIES[name], device="cpu", blind=False)
        assert qd.result.status_code == 0 and qd.result.nrows > 0, name
        assert _rows(qd) == _rows(qc), name
    with pytest.raises(WukongError) as ei:
        Proxy(build_partition(lubm[0], 0, 1), lubm[1],
              device="cpu").run_single_query(QUERIES["lubm_q3"],
                                             device="dist")
    assert ei.value.code == ErrorCode.UNSUPPORTED_SHAPE


def test_refused_shape_falls_back_to_the_host_engine(lubm, monkeypatch,
                                                     capfd):
    proxy = _proxy(lubm)
    real = proxy.dist.execute

    def refuse(q, from_proxy=True):
        q.result.status_code = ErrorCode.UNSUPPORTED_SHAPE
        return q

    monkeypatch.setattr(proxy.dist, "execute", refuse)
    q = proxy.run_single_query(QUERIES["lubm_q3"], device="dist",
                               blind=False)
    assert "falling back to the host engine" in capfd.readouterr().err
    monkeypatch.setattr(proxy.dist, "execute", real)
    want = proxy.run_single_query(QUERIES["lubm_q3"], device="dist",
                                  blind=False)
    assert q.result.status_code == 0 and _rows(q) == _rows(want)


def test_replicated_proxy_starts_the_heal_watcher(lubm):
    """A proxy over a dist engine with replicas starts the recovery
    manager's heal watcher, serves complete replies through a shard-down
    fault (the replica answers), and the watcher promotes the rebuilt
    primary once the shard is back."""
    t, ss = lubm
    PG.replication_factor = 2
    PG.enable_tpu = False
    PG.enable_dist_inplace = False
    dist = DistEngine(build_all_partitions(t, 8), ss, device="cpu")
    proxy = Proxy(build_partition(t, 0, 1), ss, device="cpu",
                  dist_engine=dist)
    failovers = get_registry().counter(
        "wukong_failover_total",
        "Shard fetches served by a replica after a primary failure",
        labels=("shard",))
    try:
        names = [th.name for th in proxy.recovery()._threads]
        assert names == ["recovery-watcher"]
        want = proxy.run_single_query(QUERIES["lubm_q1"], device="dist",
                                      blind=False)
        f0 = failovers.value(shard="1")
        faults.install(FaultPlan([FaultSpec("dist.shard_fetch",
                                            "shard_down", shard=1)], seed=7))
        dist.sstore.invalidate_stagings()
        q = proxy.run_single_query(QUERIES["lubm_q1"], device="dist",
                                   blind=False)
        assert q.result.complete is True and q.result.dropped_patterns == []
        assert _rows(q) == _rows(want) and q.result.nrows > 0
        # the replica answered (the watcher may already have promoted a
        # rebuilt primary: it races this thread by design)
        assert failovers.value(shard="1") > f0
        faults.clear()
        proxy.recovery().heal_once(force=True)
        assert not proxy.recovery().sick_shards()
        assert dist.sstore.breaker.state(1) == "closed"
    finally:
        proxy.recovery().stop()
    assert proxy.recovery()._threads == []


def test_load_reaches_every_shard_and_respecializes(lubm, tmp_path):
    proxy = _proxy(lubm)
    PG.enable_dist_inplace = False
    text = QUERIES["lubm_q7"]
    q0 = proxy.run_single_query(text, device="dist")
    assert proxy.dist._learned_caps
    # new takesCourse edges: every UndergraduateStudent of the first rows
    # takes the first course of AssociateProfessor0
    ss = lubm[1]
    takes = ss.str2id("<http://swat.cse.lehigh.edu/onto/univ-bench.owl#"
                      "takesCourse>")
    qc = proxy.run_single_query(text, device="cpu", blind=False)
    ys = sorted({r[qc.result.v2c_map[-2]] for r in qc.result.table.tolist()})
    ug = ss.str2id("<http://swat.cse.lehigh.edu/onto/univ-bench.owl#"
                   "UndergraduateStudent>")
    members = proxy.g.get_index(ug, IN)[:40]
    delta = tmp_path / "delta"
    delta.mkdir()
    (delta / "id_delta.nt").write_text("".join(
        f"{int(x)}\t{takes}\t{ys[0]}\n" for x in members))
    assert proxy.dynamic_load_data(str(delta)) > 0
    assert proxy.dist._learned_caps == {}
    assert sum(g.version > 0 for g in proxy.dist.sstore.stores) >= 2
    qd = proxy.run_single_query(text, device="dist", blind=False)
    qh = proxy.run_single_query(text, device="cpu", blind=False)
    assert qd.result.nrows == qh.result.nrows > q0.result.nrows
    assert _rows(qd) == _rows(qh)


def test_shard_down_shows_in_healthz_and_monitor(lubm):
    proxy = _proxy(lubm)
    PG.enable_dist_inplace = False
    faults.install(FaultPlan([FaultSpec("dist.shard_fetch", "shard_down",
                                        shard=1)], seed=7))
    q = proxy.run_single_query(QUERIES["lubm_q7"], device="dist")
    assert q.result.complete is False
    assert "shard:1" in q.result.dropped_patterns
    rep = health_report()
    assert rep["ready"] is False
    assert rep["degraded"]["shards"] == {"degraded": [1], "failover": []}
    lines = proxy.monitor.breaker_report()
    assert lines and lines[0].startswith("Breaker[dist.shard]: ")
    assert "wukong_breaker_open" in get_registry().snapshot()
    faults.clear()
    proxy.dist.sstore.breaker.record_success(1)
    q2 = proxy.run_single_query(QUERIES["lubm_q7"], device="dist")
    assert q2.result.complete is True
    assert "shards" not in health_report()["degraded"]


# ---------------------------------------------------------------------------
# the distributed WCOJ
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tri():
    triples, meta = generate_triangle(m=80, noise=4, seed=2)
    jt, jmeta = jtri(m=80, noise=4, seed=2)
    assert np.array_equal(triples, jt) and meta == jmeta
    g1 = build_partition(triples, 0, 1)
    pool = EnginePool(num_engines=4, make_engine=lambda tid: CPUEngine(g1))
    pool.start()
    yield (g1, [build_partition(triples, k, 4) for k in range(4)],
           Stats.generate(triples), meta, pool,
           [jbp(jt, k, 4) for k in range(4)], JStats.generate(jt))
    pool.stop()


def _mkq(ir, meta):
    from wukong_tpu_torch.types import OUT

    q = ir.SPARQLQuery()
    q.pattern_group.patterns = [ir.Pattern(s, p, OUT, o)
                                for (s, p, o) in meta["patterns"]]
    q.result.nvars = len(meta["vars"])
    q.result.required_vars = list(meta["vars"])
    return q


def test_dist_join_fans_out_and_gathers_identical(tri):
    g1, parts, stats, meta, pool, jparts, jstats = tri
    qw = _mkq(pir, meta)
    heuristic_plan(qw)
    CPUEngine(g1).execute(qw)
    qd = _mkq(pir, meta)
    heuristic_plan(qd)
    DistributedWCOJExecutor(parts, stats=stats, pool=pool,
                            device="cpu").execute(qd)
    qj = _mkq(jir, meta)
    jplan(qj)
    JDWCOJ(jparts, stats=jstats, pool=None).execute(qj)
    assert qd.result.status_code == ErrorCode.SUCCESS
    assert qd.join_dist == {"slices": 4}
    assert _rows(qd) == _rows(qw) == _rows(qj) and qd.result.nrows > 0
    assert all(lv.get("slices") == 4 for lv in qd.join_stats)
    # single without a pool, with the rows of one executor
    qs = _mkq(pir, meta)
    heuristic_plan(qs)
    DistributedWCOJExecutor(parts, stats=stats, pool=None,
                            device="cpu").execute(qs)
    assert getattr(qs, "join_dist", None) is None and _rows(qs) == _rows(qw)


def test_dist_join_slice_fault_degrades_per_slice(tri):
    g1, parts, stats, meta, pool, *_ = tri
    q1 = _mkq(pir, meta)
    heuristic_plan(q1)
    WCOJExecutor(g1, stats=stats, device="cpu").execute(q1)
    lockdep.install(True)
    try:
        plan = FaultPlan([FaultSpec("join.slice", "transient", count=1)],
                         seed=5)
        faults.install(plan)
        qd = _mkq(pir, meta)
        heuristic_plan(qd)
        DistributedWCOJExecutor(parts, stats=stats, pool=pool,
                                device="cpu").execute(qd)
        assert lockdep.cycles() == [] and lockdep.leaf_violations() == []
    finally:
        lockdep.install(False)
    assert [h[0] for h in plan.history] == ["join.slice"]
    assert qd.result.status_code == ErrorCode.SUCCESS
    assert _rows(qd) == _rows(q1)


def test_sharded_join_view_version_tracks_all_shards(tri):
    from wukong_tpu_torch.store.dynamic import insert_triples
    from wukong_tpu_torch.types import NORMAL_ID_START

    _g1, parts, *_ = tri
    live = [build_partition(generate_triangle(m=20, noise=1, seed=8)[0],
                            k, 4) for k in range(4)]
    view = ShardedJoinView(live)
    v0 = view.version
    a = NORMAL_ID_START + 9001
    insert_triples(live[2], np.asarray([[a, 2, a + 1]], dtype=np.int64))
    v1 = view.version
    assert v1 != v0
    live[1] = parts[1]
    assert view.version != v1 and view.stores[1] is live[1]


def test_proxy_wcoj_dist_forced(lubm):
    """q1 forced onto proxy.wcoj_dist(): the walk's rows."""
    proxy = _proxy(lubm)
    q = proxy.parse(QUERIES["lubm_q1"])  # parsed and planned
    q.result.blind = False
    proxy.wcoj_dist().try_execute(q)
    walk = proxy.run_single_query(QUERIES["lubm_q1"], device="dist",
                                  blind=False)
    assert proxy.wcoj_dist() is proxy.wcoj_dist()
    assert q.result.nrows == walk.result.nrows > 0
    cols = [q.result.v2c_map[v] for v in sorted(walk.result.v2c_map)]
    wcols = [walk.result.v2c_map[v] for v in sorted(walk.result.v2c_map)]
    assert sorted(map(tuple, q.result.table[:, cols].tolist())) == \
        sorted(map(tuple, walk.result.table[:, wcols].tolist()))


# ---------------------------------------------------------------------------
# the hot-spot drill and the advisor's planning half
# ---------------------------------------------------------------------------

def test_hotspot_drill_equals_jax(lubm, eight_cpu_devices):
    t, _ss = lubm
    proxy = _proxy(lubm)
    jt, _ = generate_lubm(1, seed=42)
    jd = JDist(jbap(jt, 8), VirtualLubmStrings(1, seed=42), jmesh(8))
    jproxy = JProxy(jbp(jt, 0, 1), None, JCPU(jbp(jt, 0, 1)), None, jd)
    for mod in (pheat, jheat):
        mod.get_heat().reset()
    rep = Emulator(proxy).run_hotspot(n_ops=800, zipf_a=1.6, seed=7)
    jrep = JEmulator(jproxy).run_hotspot(n_ops=800, zipf_a=1.6, seed=7)
    assert rep["hot"] == jrep["hot"] and rep["ranked"] == jrep["ranked"]
    assert rep["ranked"][0] == rep["hot"]
    assert rep["plan_donor_is_hot"] and jrep["plan_donor_is_hot"]
    assert rep["store_untouched"] and jrep["store_untouched"]
    p, jp = rep["plan"], jrep["plan"]
    for k in ("donor_shard", "recipient_host", "bytes_source",
              "imbalance_before", "imbalance_after"):
        assert p[k] == jp[k], k
    # the rates are wall-clock rates of each run; their shards and metric
    assert p["inputs"]["metric"] == jp["inputs"]["metric"]
    assert set(p["inputs"]["fetch_rates_per_s"]) == \
        set(jp["inputs"]["fetch_rates_per_s"])
    assert p["predicted_move_bytes"] == \
        proxy.dist.sstore.stores[rep["hot"]].memory_bytes() > 0
    text, js = placement.render_plan(advise=False)
    assert f"donor shard       {p['donor_shard']}" in text
    assert js["status"]["plan"]["plan_id"] == p["plan_id"]
    assert proxy.monitor.placement_lines()[0].startswith(
        f"Placement[plan {p['plan_id']}: donor shard {p['donor_shard']}")
    snap = get_registry().snapshot()
    assert round(snap["wukong_placement_imbalance"]["series"][0]["value"],
                 3) == p["imbalance_before"]
    assert snap["wukong_placement_plan_bytes"]["series"][0]["value"] == \
        p["predicted_move_bytes"]
    for mod in (ptsdb, jtsdb):
        mod.get_tsdb().reset()


def test_advisor_decisions_equal_jax():
    """The planning sweep's decisions on seeded rate maps: balanced, no
    recipient, planned with a co-located donor, as the JAX advisor."""
    rng = np.random.default_rng(11)
    cases = [{s: float(rng.uniform(9, 11)) for s in range(4)},
             {0: 50.0, 1: 1.0},
             {0: 30.0, 1: 30.0, 2: 31.0, 3: 0.0, 4: 0.0}]
    for rates in cases:
        out = []
        for mod in (placement, jplacement):
            lin = mod.ShardLineage()
            for s in rates:
                lin.note_placement(s, 0 if s < 2 and len(rates) == 5 else s)
            if len(rates) == 2:
                lin.note_placement(0, 0, replica_hosts=(1,))
            dec, imb, plan = mod.PlacementAdvisor(lineage=lin)._decide(
                rates, 300.0, lin)
            out.append((dec, imb, None if plan is None else {
                k: v for k, v in plan.to_dict().items()
                if k not in ("plan_id", "t_us")}))
        assert out[0] == out[1], rates
    assert [f.name for f in __import__("dataclasses").fields(
        placement.MigrationPlan)] == list(placement.MIGRATION_PLAN_FIELDS)


def test_advisor_loop_starts_only_with_a_store(lubm, monkeypatch):
    monkeypatch.setattr(PG, "placement_interval_s", 60)
    adv = placement.get_advisor()
    assert placement.maybe_start_advisor(None) is None
    proxy = _proxy(lubm)  # attaches the store and starts the loop
    try:
        assert adv._thread is not None and adv._store() is proxy.dist.sstore
    finally:
        adv.stop()


# ---------------------------------------------------------------------------
# the console
# ---------------------------------------------------------------------------

def test_console_dist_one_shot(tmp_path, capfd, monkeypatch,
                               eight_cpu_devices):
    import re

    for G in (PG, JG):
        for name in list(vars(G)):
            monkeypatch.setattr(G, name, getattr(G, name))
    d = tmp_path / "id_lubm_1"
    pl.write_dataset(str(d), 1, seed=0)
    cfg = tmp_path / "config"
    cfg.write_text("global_num_engines 2\nglobal_enable_planner false\n")
    qf = tmp_path / "q7"
    qf.write_text(QUERIES["lubm_q7"])
    cmd = f"sparql -f {qf} -d dist -n 2"
    assert console.main([str(cfg), str(d), "--device", "cpu", "--dist",
                         "-w", "8", "-c", cmd]) == 0
    got = capfd.readouterr().err
    assert jconsole.main([str(cfg), str(d), "--dist", "-w", "8",
                          "-c", cmd]) == 0
    want = capfd.readouterr().err
    rows = re.compile(r"\(last\) result rows: (\d+)")
    assert rows.findall(got) == rows.findall(want) != []
    assert PG.num_workers == 8


def test_dist_join_double_slice_failure_degrades_to_walk(tri):
    """A slice that fails its inline retry too degrades the whole query to
    the distributed walk through the proxy's strategy router: SUCCESS, the
    walk's rows, one wcoj->walk fallback counted."""
    g1, parts, stats, meta, pool, *_ = tri
    PG.enable_tpu = False
    dist = DistEngine(parts, None, device="cpu")
    proxy = Proxy(g1, None, device="cpu", dist_engine=dist)
    proxy._pool = pool
    qw = _mkq(pir, meta)
    heuristic_plan(qw)
    CPUEngine(g1).execute(qw)
    fell = get_registry().counter(
        "wukong_join_fallback_total", "WCOJ executions degraded to the walk",
        labels=("reason",)).value(reason="UNKNOWN_PATTERN")
    faults.install(FaultPlan([FaultSpec("join.slice", "transient", count=2,
                                        shard=1)], seed=9))
    q = _mkq(pir, meta)
    heuristic_plan(q)
    q.join_strategy = "wcoj"
    proxy._serve_execute(q, proxy.dist)
    faults.clear()
    proxy._pool = None
    assert q.result.status_code == ErrorCode.SUCCESS
    assert _rows(q) == _rows(qw) and q.result.nrows > 0
    assert get_registry().counter(
        "wukong_join_fallback_total", "WCOJ executions degraded to the walk",
        labels=("reason",)).value(reason="UNKNOWN_PATTERN") == fell + 1


def test_dist_join_budget_expiry_commits_completed_slices(tri, monkeypatch):
    """A row budget spent mid-fan-out: the completed slices commit as the
    partial result, flagged, with the structured status (the JAX
    executor's posture)."""
    from wukong_tpu_torch.runtime.resilience import Deadline

    _g1, parts, stats, meta, pool, *_ = tri
    monkeypatch.setattr(PG, "query_budget_rows", 200)
    qd = _mkq(pir, meta)
    heuristic_plan(qd)
    qd.deadline = Deadline.from_config()
    DistributedWCOJExecutor(parts, stats=stats, pool=pool,
                            device="cpu").execute(qd)
    assert qd.result.status_code == ErrorCode.BUDGET_EXCEEDED
    assert not qd.result.complete
