"""Shard healing in the port (runtime/recovery.py ``sick_shards``,
``heal_once``, ``_rebuild_shard``, the heal watcher) and replicas behind
the proxy, against the JAX package on LUBM-1 (seed 42) over 8 shard slots
(device="cpu") with ``replication_factor`` 2: the cases of
tests/test_chaos.py:834-933 (heal, replicas mirroring inserts, the
kill-and-recover drill), tests/test_recovery.py:774-800 (the rebuild lane)
and tests/test_observatory.py:251 (breaker, failover and heal events).
Beyond them: a heal from a checkpoint and the WAL tail, the proxy's
watcher healing on the pool's rebuild lane, a heal during a migration,
the rebalance drill at 8 slots (the smoke's phase 16), and the console's
``recover -d`` and ``migrate -s`` on a ``--dist`` boot. Rows are held as
multisets against JAX's; the module runs lockdep-checked.
"""

import re
import threading
import time

import numpy as np
import pytest

from test_torch_dist_engine import rows
from wukong_tpu.config import Global as JG
from wukong_tpu.engine.cpu import CPUEngine as JCPU
from wukong_tpu.loader.lubm import VirtualLubmStrings, generate_lubm
from wukong_tpu.obs import events as jevents
from wukong_tpu.obs import heat as jheat
from wukong_tpu.obs import placement as jplacement
from wukong_tpu.obs import tsdb as jtsdb
from wukong_tpu.parallel.dist_engine import DistEngine as JDist
from wukong_tpu.parallel.mesh import make_mesh as jmesh
from wukong_tpu.planner.heuristic import heuristic_plan as jplan
from wukong_tpu.runtime import console as jconsole
from wukong_tpu.runtime import faults as jfaults
from wukong_tpu.runtime import migration as jmigration
from wukong_tpu.runtime import recovery as jrecovery
from wukong_tpu.runtime.emulator import Emulator as JEmulator
from wukong_tpu.runtime.proxy import Proxy as JProxy
from wukong_tpu.sparql.parser import Parser as JParser
from wukong_tpu.store import dynamic as jdynamic
from wukong_tpu.store import persist as jpersist
from wukong_tpu.store.gstore import build_all_partitions as jbap
from wukong_tpu.store.gstore import build_partition as jbp
from wukong_tpu_torch.analysis import lockdep
from wukong_tpu_torch.config import Global as PG
from wukong_tpu_torch.loader import lubm as pl
from wukong_tpu_torch.obs import events, heat, placement, tsdb
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.parallel.dist_engine import DistEngine as PDist
from wukong_tpu_torch.parallel.mesh import make_mesh as pmesh
from wukong_tpu_torch.parallel.sharded_store import ShardedDeviceStore
from wukong_tpu_torch.planner.heuristic import heuristic_plan as pplan
from wukong_tpu_torch.runtime import console, faults, migration, recovery
from wukong_tpu_torch.runtime.emulator import Emulator
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.runtime.scheduler import EnginePool
from wukong_tpu_torch.sparql.parser import Parser as PParser
from wukong_tpu_torch.store import dynamic, persist
from wukong_tpu_torch.store.gstore import build_all_partitions as pbap
from wukong_tpu_torch.store.gstore import build_partition as pbp
from wukong_tpu_torch.utils.mathutil import hash_mod

Q2HOP = """
PREFIX ub: <http://swat.cse.lehigh.edu/onto/univ-bench.owl#>
SELECT ?X ?Y ?Z WHERE {
    ?X ub:memberOf ?Y .
    ?Y ub:subOrganizationOf ?Z .
}
"""
QDEPT = """
PREFIX rdf: <http://www.w3.org/1999/02/22-rdf-syntax-ns#>
PREFIX ub: <http://swat.cse.lehigh.edu/onto/univ-bench.owl#>
SELECT ?X WHERE {
    ?X ub:worksFor <http://www.Department0.University0.edu> .
    ?X rdf:type ub:FullProfessor .
}
"""
SHARD1_DOWN = [dict(site="dist.shard_fetch", kind="shard_down", shard=1)]
FAULTS = (jfaults, faults)


@pytest.fixture(autouse=True, scope="module")
def _lockdep_checked():
    """Lockdep-checked, and no heal watcher or actuator loop this module
    started outlives it."""
    before = set(threading.enumerate())
    lockdep.install(True)
    yield
    try:
        assert lockdep.cycles() == [], lockdep.cycles()
        assert lockdep.leaf_violations() == [], lockdep.leaf_violations()
        left = [t.name for t in set(threading.enumerate()) - before
                if t.is_alive() and t.name in (
                    "recovery-watcher", "recovery-checkpointer",
                    "migration-actuator")]
        assert left == [], left
    finally:
        lockdep.install(False)


def _reset():
    for f in FAULTS:
        f.clear()
    for mig in (migration, jmigration):
        mig.get_migrator().reset()
    for mod in (placement, jplacement):
        mod.get_advisor().reset()
        mod.get_lineage().reset()
    for mod in (heat, jheat):
        mod.get_heat().reset()
    for mod in (tsdb, jtsdb):
        mod.get_tsdb().reset()
    for mod in (events, jevents):
        mod.get_journal().clear()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Knobs restored in both packages (the collective route pinned, fast
    backoff), no leaked fault plan, every process-wide plane reset."""
    for G in (JG, PG):
        for name in ("replication_factor", "enable_tpu", "wal_dir",
                     "checkpoint_dir", "migration_enable",
                     "placement_interval_s", "enable_planner"):
            monkeypatch.setattr(G, name, getattr(G, name))
        monkeypatch.setattr(G, "enable_dist_inplace", False)
        monkeypatch.setattr(G, "retry_base_ms", 1)
        monkeypatch.setattr(G, "retry_max_ms", 2)
    _reset()
    yield
    _reset()


@pytest.fixture(scope="module")
def lubm(eight_cpu_devices):
    triples, _ = generate_lubm(1, seed=42)
    return {"triples": triples, "jss": VirtualLubmStrings(1, seed=42),
            "pss": pl.VirtualLubmStrings(1, seed=42)}


def _engines(lubm, rf: int = 2):
    """A JAX and a port DistEngine over fresh 8-way partitions."""
    old = JG.replication_factor, PG.replication_factor
    JG.replication_factor = PG.replication_factor = rf
    try:
        t = lubm["triples"]
        jd = JDist(jbap(t, 8), lubm["jss"], jmesh(8))
        pd = PDist(pbap(t, 8), lubm["pss"], device="cpu")
    finally:
        JG.replication_factor, PG.replication_factor = old
    assert pd.sstore.replication_factor == rf
    return jd, pd


def _install(specs, seed=0):
    for f in FAULTS:
        f.install(f.FaultPlan([f.FaultSpec(**s) for s in specs], seed=seed))


def _run(lubm, jd, pd, text=Q2HOP):
    jq = JParser(lubm["jss"]).parse(text)
    pq = PParser(lubm["pss"]).parse(text)
    jplan(jq)
    pplan(pq)
    jd.execute(jq)
    pd.execute(pq)
    assert rows(pq) == rows(jq)
    assert bool(pq.result.complete) == bool(jq.result.complete)
    return jq, pq


def _failovers(mod, shard: int) -> float:
    return mod.get_registry().counter(
        "wukong_failover_total",
        "Shard fetches served by a replica after a primary failure",
        labels=("shard",)).value(shard=str(shard))


# ---------------------------------------------------------------------------
# tests/test_chaos.py:834-933
# ---------------------------------------------------------------------------

def test_heal_rebuilds_promotes_and_closes_breaker(lubm):
    from wukong_tpu.obs import metrics as jmetrics
    from wukong_tpu_torch.obs import metrics as pmetrics

    jd, pd = _engines(lubm)
    _install(SHARD1_DOWN)
    for d in (jd, pd):
        d.sstore.invalidate_stagings()
    _jq, pq = _run(lubm, jd, pd)
    assert pq.result.complete is True
    baseline = pq.result.nrows
    for f in FAULTS:
        f.clear()  # the dead host is replaced
    out = []
    for d, rec, mod in ((jd, jrecovery, jmetrics), (pd, recovery, pmetrics)):
        rm = rec.RecoveryManager(d.sstore.stores, sstore=d.sstore)
        healed = rm.heal_once()
        out.append((healed, d.sstore.breaker.state(1),
                    1 in d.sstore.failover_shards, rm.sick_shards()))
    assert out[1] == out[0]
    healed, state, failover, sick = out[1]
    assert 1 in healed and state == "closed" and not failover and not sick
    f_after = _failovers(pmetrics, 1)
    _jq, pq2 = _run(lubm, jd, pd)
    assert pq2.result.complete is True and pq2.result.nrows == baseline
    assert _failovers(pmetrics, 1) == f_after


def test_replicas_mirror_dynamic_inserts(lubm):
    jd, pd = _engines(lubm)
    _jq, q0 = _run(lubm, jd, pd, QDEPT)
    n0 = q0.result.nrows
    ss = lubm["pss"]
    dept = ss.str2id("<http://www.Department0.University0.edu>")
    works = ss.str2id(
        "<http://swat.cse.lehigh.edu/onto/univ-bench.owl#worksFor>")
    prof = ss.str2id(
        "<http://swat.cse.lehigh.edu/onto/univ-bench.owl#FullProfessor>")
    tyid = ss.str2id("<http://www.w3.org/1999/02/22-rdf-syntax-ns#type>")
    newv = 1_000_003
    while hash_mod(np.asarray([newv]), 8)[0] != 3:  # land on shard 3
        newv += 1
    tri = np.asarray([[newv, works, dept], [newv, tyid, prof]],
                     dtype=np.int64)
    for d, dyn in ((jd, jdynamic), (pd, dynamic)):
        dyn.insert_batch_into(
            list(d.sstore.stores) + d.sstore.replica_stores(), tri)
    _jq, q1 = _run(lubm, jd, pd, QDEPT)
    assert q1.result.nrows == n0 + 1
    _install([dict(site="dist.shard_fetch", kind="shard_down", shard=3)])
    for d in (jd, pd):
        d.sstore.invalidate_stagings()
    _jq, q2 = _run(lubm, jd, pd, QDEPT)
    assert q2.result.complete is True and q2.result.nrows == n0 + 1


def _proxies(lubm, rf: int = 2):
    jd, pd = _engines(lubm, rf)
    t = lubm["triples"]
    JG.replication_factor = PG.replication_factor = rf
    JG.enable_tpu = PG.enable_tpu = False
    g = jbp(t, 0, 1)
    jproxy = JProxy(g, lubm["jss"], JCPU(g, lubm["jss"]), None, jd)
    pproxy = Proxy(pbp(t, 0, 1), lubm["pss"], device="cpu", dist_engine=pd)
    return jproxy, pproxy


def _drill_view(rep: dict) -> dict:
    """A drill report, less what the background heal watcher's timing
    decides (it races the drill by design): which sweep healed, and how
    many fetches a replica served (a heal mid-outage drops the stagings,
    and the next round fails over again)."""
    out = {k: v for k, v in rep.items() if k != "healed"}
    out["outage"] = {k: v for k, v in rep["outage"].items()
                     if k != "failovers"}
    return out


def test_kill_and_recover_drill(lubm):
    """The emulator's drill end to end (console ``recover -d``): both
    packages' reports equal, failover kept every outage round complete,
    the shard healed and the verify round matched the baseline."""
    jproxy, pproxy = _proxies(lubm)
    try:
        # replicas through the proxy start the heal watcher at once
        assert pproxy.recovery()._threads
        jrep = JEmulator(jproxy).run_drill(shard=5, rounds=2)
        rep = Emulator(pproxy).run_drill(shard=5, rounds=2)
    finally:
        jproxy.recovery().stop()
        pproxy.recovery().stop()
    assert _drill_view(rep) == _drill_view(jrep)
    assert rep["replication_factor"] == 2
    assert rep["outage"]["complete"] is True
    assert rep["outage"]["nrows_match"] is True
    assert rep["outage"]["failovers"] > 0
    assert rep["healthy"] is True
    assert rep["recovered"] == {"complete": True, "nrows_match": True}


# ---------------------------------------------------------------------------
# tests/test_recovery.py:774-800: the rebuild lane
# ---------------------------------------------------------------------------

def test_rebuild_lane_executes_jobs_in_background():
    class Eng:
        def execute(self, q):
            return q

    pool = EnginePool(num_engines=2, make_engine=lambda tid: Eng())
    pool.start()
    try:
        ran = threading.Event()
        job = recovery.RebuildJob(lambda: ran.set(), label="t")
        assert pool.submit(job, lane="rebuild") == -1
        assert job.done.wait(5.0) and ran.is_set()
        assert pool.poll() == []  # fire-and-forget: no pool-side result
    finally:
        pool.stop()


def test_rebuild_lane_settled_on_dead_pool():
    pool = EnginePool(num_engines=1, make_engine=lambda tid: None)
    pool._dead[0] = True  # whole pool dead, nothing running
    job = recovery.RebuildJob(lambda: None, label="t")
    pool.submit(job, lane="rebuild")
    assert job.done.wait(1.0)  # fail_all settled it instead of stranding


# ---------------------------------------------------------------------------
# tests/test_observatory.py:251: breaker -> failover -> heal, journaled
# ---------------------------------------------------------------------------

def test_breaker_failover_heal_event_correlation(lubm):
    def run(ev_mod, f, sharded, rec, clone, stores, mesh):
        sstore = sharded(stores, mesh, replication_factor=1)
        sstore.replicas = {0: [(1, clone(sstore.stores[0]))]}
        f.install(f.FaultPlan([f.FaultSpec("dist.shard_fetch", "shard_down",
                                           shard=0)], seed=0))
        oks = [sstore._fetch_shard(0, lambda g: np.arange(4), "t")[1]
               for _ in range(4)]
        f.clear()
        healed = rec.RecoveryManager(lambda: list(sstore.stores),
                                     sstore=sstore).heal_once(force=True)
        evs = ev_mod.get_journal().last(shard=0)
        return oks, healed, [e.kind for e in evs], [e.shard for e in evs], \
            [e.seq for e in evs]

    from wukong_tpu.parallel.sharded_store import ShardedDeviceStore as JSS

    class _Mesh4:
        devices = np.empty(4, dtype=object)

    t = lubm["triples"]
    jout = run(jevents, jfaults, JSS, jrecovery, jpersist.clone_gstore,
               [jbp(t, i, 4) for i in range(4)], _Mesh4())
    pout = run(events, faults, ShardedDeviceStore, recovery,
               persist.clone_gstore, [pbp(t, i, 4) for i in range(4)],
               pmesh(4, device="cpu"))
    assert pout[:4] == jout[:4]
    oks, healed, kinds, shards, seqs = pout
    assert all(oks) and healed == [0] and set(shards) == {0}
    assert kinds.count("shard.failover") == 1
    for k in ("breaker.trip", "shard.rebuild", "shard.heal", "breaker.close"):
        assert k in kinds
    assert kinds.index("breaker.trip") < kinds.index("breaker.close")
    assert kinds.index("breaker.close") <= kinds.index("shard.rebuild")
    assert kinds.index("shard.rebuild") <= kinds.index("shard.heal")
    assert seqs == sorted(seqs)
    text, _js = events.render_events(shard=0)
    assert "shard.failover" in text and "breaker.trip" in text
    rep = placement.get_lineage().report()
    assert rep[0]["last_failover_us"] > 0 and rep[0]["last_heal_us"] > 0


# ---------------------------------------------------------------------------
# beyond the JAX cases
# ---------------------------------------------------------------------------

def test_heal_from_checkpoint_and_wal_tail(lubm, tmp_path):
    """No replica: the heal loads the shard from the newest checkpoint and
    replays the WAL tail past it — the JAX manager's digest, and every
    acknowledged insert present."""
    JG.wal_dir, PG.wal_dir = str(tmp_path / "j" / "wal"), str(
        tmp_path / "p" / "wal")
    jd, pd = _engines(lubm, rf=1)
    tri = np.asarray([[7_000_001, 17, 7_000_001]], dtype=np.int64)
    while hash_mod(tri[:, 0], 8)[0] != 2:
        tri += 1
    out = []
    for d, rec, dyn, per, root in ((jd, jrecovery, jdynamic, jpersist, "j"),
                                   (pd, recovery, dynamic, persist, "p")):
        rm = rec.RecoveryManager(lambda d=d: list(d.sstore.stores),
                                 sstore=d.sstore,
                                 ckpt_dir=str(tmp_path / root / "ckpt"))
        rm.checkpoint()
        dyn.insert_batch_into(list(d.sstore.stores), tri)
        want = per.gstore_digest(d.sstore.stores[2])
        d.sstore.degraded_shards.add(2)  # the primary is gone
        healed = rm.heal_once(force=True)
        got = per.gstore_digest(d.sstore.stores[2])
        out.append((healed, got == want, rm.sick_shards(), got))
    assert out[1] == out[0]
    assert out[1][:3] == ([2], True, [])


def test_proxy_watcher_heals_on_the_rebuild_lane(lubm, monkeypatch):
    """A proxy over replicas: the watcher sees the failed-over primary and
    rebuilds it on a thread of the engine pool (the rebuild lane), with no
    explicit sweep; the breaker closes and /healthz's ``shards`` clears."""
    from wukong_tpu_torch.obs.httpd import health_report

    ran_on = []
    orig_run = recovery.RebuildJob.run

    def run(job, engine):
        ran_on.append((job.label, threading.current_thread().name))
        return orig_run(job, engine)

    monkeypatch.setattr(recovery.RebuildJob, "run", run)
    _jproxy, proxy = _proxies(lubm)
    proxy.engine_pool()
    failovers = get_registry().counter(
        "wukong_failover_total",
        "Shard fetches served by a replica after a primary failure",
        labels=("shard",))
    f0 = failovers.value(shard="4")
    try:
        faults.install(faults.FaultPlan([faults.FaultSpec(
            "dist.shard_fetch", "shard_down", shard=4)], seed=0))
        q = proxy.run_single_query(Q2HOP, device="dist")
        assert q.result.complete is True
        assert failovers.value(shard="4") > f0  # the replica answered
        deadline = time.monotonic() + 10
        while not ran_on and time.monotonic() < deadline:
            time.sleep(0.05)  # the watcher sweeps every 0.5 s
        faults.clear()
        deadline = time.monotonic() + 10
        while proxy.recovery().sick_shards() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert ran_on and all(lb == "shard-4" for lb, _t in ran_on)
        watcher = [t.name for t in proxy.recovery()._threads]
        assert not any(t in watcher for _lb, t in ran_on)
        assert not proxy.recovery().sick_shards()
        assert proxy.dist.sstore.breaker.state(4) == "closed"
        assert "shards" not in health_report()["degraded"]
        q2 = proxy.run_single_query(Q2HOP, device="dist")
        assert q2.result.complete and q2.result.nrows == q.result.nrows
    finally:
        faults.clear()
        proxy.recovery().stop()
        _jproxy.recovery().stop()
        proxy._pool.stop()


def test_heal_during_a_migration(lubm, tmp_path):
    """A heal sweep inside a migration's dual-write window (the WAL on):
    the heal and the cutover take the mutation lock in turn, neither
    deadlocks, the migration completes, and both packages end on the same
    digests."""
    JG.wal_dir, PG.wal_dir = str(tmp_path / "j"), str(tmp_path / "p")
    JG.migration_enable = PG.migration_enable = True
    jd, pd = _engines(lubm)
    out = []
    for d, mig, rec, plc, per in (
            (jd, jmigration, jrecovery, jplacement, jpersist),
            (pd, migration, recovery, placement, persist)):
        rm = rec.RecoveryManager(lambda d=d: list(d.sstore.stores),
                                 sstore=d.sstore)
        plan = plc.MigrationPlan(
            plan_id="mp-heal", t_us=0, donor_shard=3, recipient_host=5,
            predicted_move_bytes=1 << 20, bytes_source="estimate",
            donor_rate_per_s=4.0, mean_rate_per_s=1.0, imbalance_before=2.5,
            imbalance_after=1.5, window_s=60.0, inputs={}, reason="test")
        healed = []

        def hook(phase, _job, d=d, rm=rm):
            if phase == "catchup":
                d.sstore.failover_shards.add(1)
                healed.extend(rm.heal_once(force=True))

        m = mig.get_migrator()
        m.attach(sstore=d.sstore)
        job = m.run_plan(plan, phase_hook=hook)
        out.append((job.phase, healed, rm.sick_shards(), d.sstore.placement,
                    [per.gstore_digest(g) for g in d.sstore.stores]))
    assert out[1] == out[0]
    assert out[1][:4] == ("done", [1], [], {3: 5})


def test_rebalance_at_eight_slots_takes_two_moves(lubm):
    """The smoke's phase 16 (a) at LUBM-1: 600 Zipf(1.6) fetches over 8
    slots. One move with read rotation leaves the hot shard's load split
    over two hosts, above placement_imbalance_x; the advisor's next plan
    (a second rotation copy) brings it under. Both packages give the same
    rounds."""
    reps = []
    JG.migration_enable = PG.migration_enable = True
    jproxy, pproxy = _proxies(lubm, rf=1)
    for emu, ss in ((JEmulator(jproxy), jproxy.dist.sstore),
                    (Emulator(pproxy), pproxy.dist.sstore)):
        rounds = []
        for _ in range(3):
            rep = emu.run_rebalance(n_ops=600, zipf_a=1.6, seed=7)
            rounds.append((rep["hot"], rep["plan"]["donor_shard"],
                           rep["plan"]["recipient_host"],
                           rep["queries_identical"], rep["rebalanced"],
                           rep["decision_after"],
                           round(rep["imbalance_after"], 2),
                           dict(ss.placement),
                           [h for h, _g in ss.rotation.get(rep["hot"], ())]))
            if rep["rebalanced"]:
                break
        reps.append(rounds)
    assert reps[1] == reps[0]
    (r1, r2) = reps[1]
    assert r1[3] and r2[3]  # every probe identical
    assert r1[4] is False and r1[5] == "planned" and r1[6] > 2.0
    assert r2[4] is True and r2[5] == "balanced" and r2[6] < 2.0
    assert len(r2[8]) == 2  # the hot shard serves from three hosts


# ---------------------------------------------------------------------------
# the console on a --dist boot
# ---------------------------------------------------------------------------

def _boot(tmp_path, cfg_lines: str, cmd: str, capfd):
    d = tmp_path / "id_lubm_1"
    if not d.exists():
        pl.write_dataset(str(d), 1, seed=0)
    cfg = tmp_path / "config"
    cfg.write_text("global_num_engines 2\nglobal_enable_planner false\n"
                   + cfg_lines)
    capfd.readouterr()
    assert console.main([str(cfg), str(d), "--device", "cpu", "--dist",
                         "-w", "8", "-c", cmd]) == 0
    got = capfd.readouterr()
    assert jconsole.main([str(cfg), str(d), "--dist", "-w", "8",
                          "-c", cmd]) == 0
    want = capfd.readouterr()
    return got, want


@pytest.fixture
def _console_knobs(monkeypatch):
    """Every knob restored in both packages; the booted proxies' heal
    watchers (a console exits with its proxy's threads running, in both
    packages) stopped."""
    import gc

    for G in (PG, JG):
        for name in list(vars(G)):
            monkeypatch.setattr(G, name, getattr(G, name))
    yield
    for mod in (recovery, jrecovery):
        for rm in [o for o in gc.get_objects()
                   if type(o) is mod.RecoveryManager]:
            rm.stop()
    for mig in (migration, jmigration):
        mig.get_migrator().reset()


def test_console_dist_boot_migrate_status(tmp_path, capfd, _console_knobs):
    got, want = _boot(tmp_path, "", "migrate -s -j", capfd)
    js, jjs = (__import__("json").loads(c.out) for c in (got, want))
    assert js == jjs
    assert js["enabled"] is False and js["in_flight"] is False


def test_console_recover_drill(tmp_path, capfd, _console_knobs):
    """``recover -d 1`` on a boot with replication 2 runs the drill and
    logs the JAX console's report (less which sweep healed)."""
    got, want = _boot(tmp_path, "global_replication_factor 2\n",
                      "recover -d 1", capfd)
    pat = re.compile(r"drill report: (\{.*\})")
    (rep,), (jrep,) = pat.findall(got.err), pat.findall(want.err)
    rep, jrep = eval(rep), eval(jrep)  # noqa: S307 (our own log line)
    assert _drill_view(rep) == _drill_view(jrep)
    assert rep["outage"]["complete"] and rep["healthy"]
    assert rep["recovered"] == {"complete": True, "nrows_match": True}
