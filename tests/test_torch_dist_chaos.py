"""Shard faults on the port's distributed engine (device="cpu"), after
tests/test_chaos.py's distributed cases, held against the JAX DistEngine
under the same seeded fault plans: a persistent ``dist.shard_fetch``
shard_down gives a well-formed reply flagged incomplete with ``shard:1``
dropped (the rows of JAX's partial reply), the schedule replays, transients
retry through, ``dist.chain_dispatch`` transients retry and their
exhaustion is a structured RETRY_EXHAUSTED, a recovered shard gives
complete replies again, persistent faults trip the per-shard breaker, and
with replication_factor 2 a replica answers (``replica.fetch``) until it
too is down. Lockdep checks the module's lock order."""

import numpy as np
import pytest

from test_torch_dist_engine import rows, same
from wukong_tpu.config import Global as JG
from wukong_tpu.loader.lubm import VirtualLubmStrings, generate_lubm
from wukong_tpu.parallel.dist_engine import DistEngine as JDist
from wukong_tpu.parallel.mesh import make_mesh as jmesh
from wukong_tpu.planner.heuristic import heuristic_plan as jplan
from wukong_tpu.runtime import faults as jfaults
from wukong_tpu.sparql.parser import Parser as JParser
from wukong_tpu.store.gstore import build_all_partitions as jbap
from wukong_tpu_torch.analysis import lockdep
from wukong_tpu_torch.config import Global as PG
from wukong_tpu_torch.loader import lubm as pl
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.parallel.dist_engine import DistEngine as PDist
from wukong_tpu_torch.parallel.mesh import make_mesh as pmesh
from wukong_tpu_torch.parallel.sharded_store import ShardedDeviceStore
from wukong_tpu_torch.planner.heuristic import heuristic_plan as pplan
from wukong_tpu_torch.runtime import faults
from wukong_tpu_torch.runtime.faults import FaultPlan, FaultSpec
from wukong_tpu_torch.sparql.parser import Parser as PParser
from wukong_tpu_torch.store.gstore import build_all_partitions as pbap
from wukong_tpu_torch.utils.errors import ErrorCode

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


@pytest.fixture(autouse=True, scope="module")
def _lockdep_checked():
    lockdep.install(True)
    yield
    try:
        assert lockdep.cycles() == [], lockdep.cycles()
        assert lockdep.leaf_violations() == [], lockdep.leaf_violations()
    finally:
        lockdep.install(False)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No leaked plan; the sharded route pinned (LUBM-1 chains are light);
    fast backoff in both packages."""
    faults.clear()
    jfaults.clear()
    for G in (JG, PG):
        monkeypatch.setattr(G, "enable_dist_inplace", False)
        monkeypatch.setattr(G, "retry_base_ms", 1)
        monkeypatch.setattr(G, "retry_max_ms", 2)
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def dist_world(eight_cpu_devices):
    triples, _ = generate_lubm(1, seed=42)
    pt, _ = pl.generate_lubm(1, seed=42)
    return (VirtualLubmStrings(1, seed=42), jbap(triples, 8), jmesh(8),
            pl.VirtualLubmStrings(1, seed=42), pbap(pt, 8))


def _engines(w):
    jss, jst, jm, pss, pst = w
    return JDist(jst, jss, jm), PDist(pst, pss, device="cpu")


def _install(specs, seed):
    """The same fault plan in both packages; returns the port's."""
    jfaults.install(jfaults.FaultPlan(
        [jfaults.FaultSpec(**s) for s in specs], seed=seed))
    plan = FaultPlan([FaultSpec(**s) for s in specs], seed=seed)
    faults.install(plan)
    return plan


def _run(w, jd, pd, text=Q2HOP):
    jq = JParser(w[0]).parse(text)
    pq = PParser(w[3]).parse(text)
    jplan(jq)
    pplan(pq)
    jd.execute(jq)
    pd.execute(pq)
    return jq, pq


SHARD1_DOWN = [dict(site="dist.shard_fetch", kind="shard_down", shard=1)]


def test_shard_down_yields_flagged_partial_result(dist_world):
    jd, pd = _engines(dist_world)
    plan = _install(SHARD1_DOWN, seed=7)
    jq, pq = _run(dist_world, jd, pd)
    same(jq, pq, jd, pd)
    assert pq.result.status_code == ErrorCode.SUCCESS
    assert pq.result.complete is False
    assert "shard:1" in pq.result.dropped_patterns
    assert plan.history and all(site == "dist.shard_fetch" and shard == 1
                                for (site, shard, _) in plan.history)


def test_shard_down_schedule_replays_identically(dist_world):
    out = []
    for _ in range(2):
        jd, pd = _engines(dist_world)
        plan = _install(SHARD1_DOWN, seed=7)
        _jq, pq = _run(dist_world, jd, pd)
        out.append((plan.history, pq.result.nrows,
                    list(pq.result.dropped_patterns)))
    assert out[0] == out[1]


def test_dist_results_complete_without_faults(dist_world):
    jd, pd = _engines(dist_world)
    jq, pq = _run(dist_world, jd, pd)
    same(jq, pq, jd, pd)
    assert pq.result.complete is True and pq.result.dropped_patterns == []


def test_shard_transients_are_retried_transparently(dist_world):
    jd, pd = _engines(dist_world)
    plan = _install([dict(site="dist.shard_fetch", kind="transient",
                          shard=2, count=1)], seed=0)
    jq, pq = _run(dist_world, jd, pd)
    same(jq, pq, jd, pd)
    assert pq.result.complete is True and len(plan.history) == 1


def test_chain_dispatch_transient_retried_transparently(dist_world):
    jd, pd = _engines(dist_world)
    j0, p0 = _run(dist_world, jd, pd)
    plan = _install([dict(site="dist.chain_dispatch", kind="transient",
                          count=1)], seed=3)
    jq, pq = _run(dist_world, jd, pd)
    same(jq, pq, jd, pd)
    assert [h[0] for h in plan.history] == ["dist.chain_dispatch"]
    assert pq.result.complete is True
    assert rows(pq) == rows(p0) and pq.result.nrows == p0.result.nrows


def test_chain_dispatch_exhaustion_is_structured(dist_world):
    jd, pd = _engines(dist_world)
    plan = _install([dict(site="dist.chain_dispatch", kind="transient")],
                    seed=3)
    jq, pq = _run(dist_world, jd, pd)  # must not raise
    assert pq.result.status_code == ErrorCode.RETRY_EXHAUSTED
    assert int(jq.result.status_code) == int(pq.result.status_code)
    assert len(plan.history) == PG.retry_max_attempts


def test_shard_recovery_restores_complete_results(dist_world, monkeypatch):
    for G in (JG, PG):
        monkeypatch.setattr(G, "breaker_cooldown_ms", 0)
    jd, pd = _engines(dist_world)
    _install(SHARD1_DOWN, seed=0)
    _jq, pq = _run(dist_world, jd, pd)
    assert pq.result.complete is False
    faults.clear()
    jfaults.clear()
    jq2, pq2 = _run(dist_world, jd, pd)
    same(jq2, pq2, jd, pd)
    assert pq2.result.complete is True and pq2.result.dropped_patterns == []


def test_breaker_opens_after_repeated_shard_down(dist_world):
    jd, pd = _engines(dist_world)
    _install(SHARD1_DOWN, seed=0)
    for text in (Q2HOP, QDEPT):
        jq, pq = _run(dist_world, jd, pd, text)
        same(jq, pq)
        assert pq.result.complete is False
    assert pd.sstore.breaker.tripped(1)
    assert 1 in pd.sstore.degraded_shards
    degraded = get_registry().counter(
        "wukong_shard_fetch_degraded_total",
        "Shard fetches that substituted empty data",
        labels=("shard",)).value(shard="1")
    assert degraded >= 2


# ---------------------------------------------------------------------------
# replication: failover through replica.fetch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def replicated(dist_world):
    old = JG.replication_factor, PG.replication_factor
    JG.replication_factor = PG.replication_factor = 2
    try:
        jd, pd = _engines(dist_world)
    finally:
        JG.replication_factor, PG.replication_factor = old
    assert pd.sstore.replication_factor == 2
    return jd, pd


def test_default_replication_factor_means_no_replicas(dist_world):
    sstore = ShardedDeviceStore(dist_world[4], pmesh(8, device="cpu"))
    assert sstore.replication_factor == 1
    assert sstore.replicas == {} and sstore.replica_stores() == []


def test_failover_keeps_results_complete(dist_world, replicated):
    jd, pd = replicated
    _j0, p0 = _run(dist_world, jd, pd)
    _install(SHARD1_DOWN, seed=0)
    for d in (jd, pd):
        d.sstore.invalidate_stagings()
    jq, pq = _run(dist_world, jd, pd)
    same(jq, pq, jd, pd)
    assert pq.result.complete is True and pq.result.dropped_patterns == []
    assert pq.result.nrows == p0.result.nrows
    assert 1 in pd.sstore.failover_shards


def test_failover_under_breaker_open_skips_dead_primary(dist_world,
                                                        replicated):
    jd, pd = replicated
    breaker = pd.sstore.breaker
    old_cd = breaker.cooldown_s
    breaker.cooldown_s = 1e9
    plan = _install(SHARD1_DOWN, seed=0)
    try:
        for _ in range(2):
            pd.sstore.invalidate_stagings()
            _jq, pq = _run(dist_world, jd, pd)
            assert pq.result.complete is True
        assert breaker.tripped(1)
        fired = len(plan.history)
        pd.sstore.invalidate_stagings()
        _jq, pq = _run(dist_world, jd, pd)
        assert len(plan.history) == fired  # the primary is not touched
        assert pq.result.complete is True
    finally:
        breaker.cooldown_s = old_cd


def test_failover_exhausted_degrades_to_flagged_partial(dist_world,
                                                        replicated):
    jd, pd = replicated
    _install(SHARD1_DOWN + [dict(site="replica.fetch", kind="shard_down",
                                 shard=2)], seed=0)
    for d in (jd, pd):
        d.sstore.invalidate_stagings()
    jq, pq = _run(dist_world, jd, pd)
    assert pq.result.status_code == ErrorCode.SUCCESS
    assert pq.result.complete is False
    assert "shard:1" in pq.result.dropped_patterns
    assert pq.result.nrows == jq.result.nrows
    assert np.array_equal(np.sort(pq.result.table, 0),
                          np.sort(jq.result.table, 0))
    assert 1 in pd.sstore.degraded_shards
