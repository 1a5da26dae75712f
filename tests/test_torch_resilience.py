"""The port's resilience layer against the JAX package's (device="cpu" for
the GPU engine: every kernel's plain version). Fault plans give the same
schedule for the same seed in both packages; deadlines and row budgets end
a query with the JAX engines' partial rows, status and dropped patterns;
the engine pool sheds expired queries and turns an injected fault into the reply. The
whole file runs with the port's lockdep checker on, and must record no
lock-order cycle and no leaf violation."""

import numpy as np
import pytest

from wukong_tpu.config import Global as JGlobal
from wukong_tpu.engine.cpu import CPUEngine as JCPUEngine
from wukong_tpu.loader.lubm import VirtualLubmStrings as JStrings
from wukong_tpu.loader.lubm import generate_lubm as jgenerate
from wukong_tpu.planner.heuristic import heuristic_plan as jheuristic
from wukong_tpu.runtime import faults as jfaults
from wukong_tpu.runtime.resilience import Deadline as JDeadline
from wukong_tpu.sparql.parser import Parser as JParser
from wukong_tpu.store.gstore import build_partition as jbuild
from wukong_tpu_torch.analysis import lockdep
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine.cpu import CPUEngine
from wukong_tpu_torch.engine.tpu import GPUEngine
from wukong_tpu_torch.loader.lubm import VirtualLubmStrings, generate_lubm
from wukong_tpu_torch.planner.heuristic import heuristic_plan
from wukong_tpu_torch.runtime import faults
from wukong_tpu_torch.runtime.faults import (
    FaultPlan,
    FaultSpec,
    TransientFault,
    parse_plan,
)
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.runtime.resilience import Deadline
from wukong_tpu_torch.runtime.scheduler import EnginePool
from wukong_tpu_torch.sparql.parser import Parser
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.utils.errors import (
    BudgetExceeded,
    ErrorCode,
    QueryTimeout,
)

PREFIX = """PREFIX rdf: <http://www.w3.org/1999/02/22-rdf-syntax-ns#>
PREFIX ub: <http://swat.cse.lehigh.edu/onto/univ-bench.owl#>
"""
# a 2-hop chain whose step-0 index scan seeds thousands of rows, a
# const-anchored lookup, and a chain with an OPTIONAL tail
Q2HOP = PREFIX + """SELECT ?X ?Y ?Z WHERE {
    ?X ub:memberOf ?Y . ?Y ub:subOrganizationOf ?Z . }"""
QDEPT = PREFIX + """SELECT ?X WHERE {
    ?X ub:worksFor <http://www.Department0.University0.edu> .
    ?X rdf:type ub:FullProfessor . }"""
QOPT = PREFIX + """SELECT ?X ?Y WHERE {
    ?X ub:memberOf <http://www.Department0.University0.edu> .
    ?X rdf:type ub:GraduateStudent .
    OPTIONAL { ?X ub:advisor ?Y } }"""


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
def _no_leaked_plan():
    faults.clear()
    yield
    faults.clear()


class FakeClock:
    """Injectable monotonic clock; sleep() advances it."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


class SteppingClock:
    """Advances by a fixed step on every read."""

    def __init__(self, step: float):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        t = self.t
        self.t += self.step
        return t


# ---------------------------------------------------------------------------
# fault plans: the same schedule as the JAX package's
# ---------------------------------------------------------------------------

def _schedule(mod, plan, rounds: int = 60) -> list:
    out = []
    for i in range(rounds):
        for site in ("pool.execute", "proxy.serve", "other"):
            try:
                plan.fire(site, shard=i % 3)
                out.append("ok")
            except mod.TransientFault:
                out.append("transient")
            except mod.ShardDown:
                out.append("down")
    return out


@pytest.mark.parametrize("text", [
    "seed=42;pool.execute:transient,p=0.3;proxy.serve:shard_down,p=0.2,"
    "count=5",
    "seed=7;pool.execute:transient,p=0.5,after=3,shard=1;"
    "other:transient,p=0.9,count=10",
    "pool.execute:transient,p=0.25;proxy.serve:delay,delay=0.0,p=0.5",
])
def test_fault_plan_schedule_matches_jax(text):
    sleeps_a, sleeps_b = [], []
    a = jfaults.parse_plan(text, sleep=sleeps_a.append)
    b = parse_plan(text, sleep=sleeps_b.append)
    assert [(s.site, s.kind, s.p, s.count, s.after, s.delay_s, s.shard)
            for s in a.specs] == [(s.site, s.kind, s.p, s.count, s.after,
                                   s.delay_s, s.shard) for s in b.specs]
    assert a.seed == b.seed
    assert _schedule(jfaults, a) == _schedule(faults, b)
    assert a.history == b.history and sleeps_a == sleeps_b


def test_fault_plan_seed_and_stream_independence():
    def run(seed, sites):
        plan = FaultPlan([FaultSpec("a", "transient", p=0.5),
                          FaultSpec("b", "transient", p=0.5)], seed=seed)
        got = []
        for _ in range(30):
            for s in sites:
                try:
                    plan.fire(s)
                    got.append((s, "ok"))
                except TransientFault:
                    got.append((s, "fault"))
        return [x for x in got if x[0] == "b"]

    assert run(42, "ab") == run(42, "ab")
    assert run(42, "ab") != run(43, "ab")
    assert run(7, "ab") == run(7, "b")  # site a never perturbs site b


def test_parse_plan_rejects_bad_entries():
    with pytest.raises(ValueError):
        parse_plan("x:transient,bogus=1")
    with pytest.raises(ValueError):  # a bad kind is a parse-time error
        parse_plan("pool.execute:delay=0.05")


def test_env_var_installs_plan(monkeypatch):
    monkeypatch.setenv("WUKONG_FAULT_PLAN", "seed=9;pool.execute:transient")
    monkeypatch.setitem(faults._state, "plan", None)
    monkeypatch.setitem(faults._state, "env_checked", False)
    plan = faults.active()
    assert plan is not None and plan.seed == 9
    faults.clear()
    assert faults.active() is None


# ---------------------------------------------------------------------------
# deadlines and row budgets
# ---------------------------------------------------------------------------

def test_deadline_expiry_budget_and_config(monkeypatch):
    clock = FakeClock()
    dl = Deadline(timeout_ms=100, clock=clock)
    dl.check("t0")
    clock.t += 0.2
    assert dl.expired()
    with pytest.raises(QueryTimeout) as ei:
        dl.check("step 3")
    assert ei.value.code == ErrorCode.QUERY_TIMEOUT
    budget = Deadline(budget_rows=10, clock=clock)
    budget.charge_rows(6)
    with pytest.raises(BudgetExceeded):
        budget.charge_rows(5, "step 1")
    assert not budget.expired()
    monkeypatch.setattr(Global, "query_deadline_ms", 0)
    monkeypatch.setattr(Global, "query_budget_rows", 0)
    assert Deadline.from_config() is None
    monkeypatch.setattr(Global, "query_budget_rows", 500)
    assert Deadline.from_config().budget_rows == 500


@pytest.fixture(scope="module")
def worlds():
    jt, _ = jgenerate(1, seed=42)
    pt, _ = generate_lubm(1, seed=42)
    jg, js = jbuild(jt, 0, 1), JStrings(1, seed=42)
    pg, ps = build_partition(pt, 0, 1), VirtualLubmStrings(1, seed=42)
    return (jg, js, JCPUEngine(jg, js)), (pg, ps)


def _pair(worlds, text):
    (jg, js, _), (pg, ps) = worlds
    qj = JParser(js).parse(text)
    jheuristic(qj)
    qp = Parser(ps).parse(text)
    heuristic_plan(qp)
    return qj, qp


def _same_reply(qj, qp):
    rj, rp = qj.result, qp.result
    assert int(rp.status_code) == int(rj.status_code)
    assert rp.complete == rj.complete
    assert rp.dropped_patterns == rj.dropped_patterns
    assert rp.nrows == rj.nrows
    assert np.array_equal(np.asarray(rp.table), np.asarray(rj.table))


@pytest.mark.parametrize("budget", [1, 3000, 10**9])
@pytest.mark.parametrize("text", [Q2HOP, QDEPT, QOPT],
                         ids=["2hop", "dept", "optional"])
def test_host_budget_matches_jax(worlds, text, budget):
    (_jg, _js, jcpu), (pg, ps) = worlds
    qj, qp = _pair(worlds, text)
    qj.deadline = JDeadline(budget_rows=budget)
    qp.deadline = Deadline(budget_rows=budget)
    jcpu.execute(qj)
    CPUEngine(pg, ps).execute(qp)
    _same_reply(qj, qp)
    if budget == 1:
        assert qp.result.status_code == ErrorCode.BUDGET_EXCEEDED
        assert qp.result.complete is False and qp.result.dropped_patterns


@pytest.mark.parametrize("partial", [True, False])
def test_host_deadline_matches_jax(worlds, monkeypatch, partial):
    """A 50 ms deadline on a clock stepping 30 ms a read: the step-0 check
    passes and the step-1 check expires, in both packages."""
    (_jg, _js, jcpu), (pg, ps) = worlds
    monkeypatch.setattr(Global, "enable_partial_results", partial)
    monkeypatch.setattr(JGlobal, "enable_partial_results", partial)
    qj, qp = _pair(worlds, Q2HOP)
    qj.deadline = JDeadline(timeout_ms=50, clock=SteppingClock(0.03))
    qp.deadline = Deadline(timeout_ms=50, clock=SteppingClock(0.03))
    jcpu.execute(qj)
    CPUEngine(pg, ps).execute(qp)
    _same_reply(qj, qp)
    assert qp.result.status_code == ErrorCode.QUERY_TIMEOUT
    assert (qp.result.nrows > 0) == partial


def test_no_deadline_leaves_the_reply_complete(worlds):
    (_jg, _js, _jcpu), (pg, ps) = worlds
    _qj, qp = _pair(worlds, Q2HOP)
    assert qp.deadline is None
    CPUEngine(pg, ps).execute(qp)
    assert qp.result.status_code == ErrorCode.SUCCESS
    assert qp.result.complete is True and qp.result.dropped_patterns == []


def test_gpu_engine_checks_and_charges_its_chain(worlds):
    """The device chain checks the deadline per attempt and charges its
    rows once: an expired deadline ends it before any step runs, and a
    budget below the chain's rows ends it after the chain."""
    _, (pg, ps) = worlds
    eng = GPUEngine(pg, ps, device="cpu")
    _qj, q = _pair(worlds, Q2HOP)
    clock = FakeClock()
    q.deadline = Deadline(timeout_ms=10, clock=clock)
    clock.t = 1.0
    eng.execute(q)
    assert q.result.status_code == ErrorCode.QUERY_TIMEOUT
    assert q.result.complete is False and q.pattern_step == 0
    assert q.result.dropped_patterns == [repr(p) for p in
                                         q.pattern_group.patterns]
    _qj, q = _pair(worlds, Q2HOP)
    q.deadline = Deadline(budget_rows=5)
    eng.execute(q)
    assert q.result.status_code == ErrorCode.BUDGET_EXCEEDED
    assert q.deadline.rows_charged > 5


def test_proxy_attaches_the_configured_deadline(worlds, monkeypatch):
    _, (pg, ps) = worlds
    proxy = Proxy(pg, ps, device="cpu")
    monkeypatch.setattr(Global, "query_budget_rows", 1)
    for device in ("gpu", "cpu"):
        q = proxy.run_single_query(Q2HOP, repeats=3, device=device,
                                   blind=False)
        assert q.result.status_code == ErrorCode.BUDGET_EXCEEDED
        assert q.result.complete is False


# ---------------------------------------------------------------------------
# engine pool: load shedding and the pool.execute fault site
# ---------------------------------------------------------------------------

def test_pool_sheds_expired_queries_and_keeps_serving():
    class Echo:
        def execute(self, q):
            return ("served", q)

    pool = EnginePool(num_engines=2, make_engine=lambda tid: Echo())
    pool.start()
    try:
        clock = FakeClock()
        expired = type("Q", (), {})()
        expired.deadline = Deadline(timeout_ms=10, clock=clock)
        clock.t = 1.0
        assert isinstance(pool.wait(pool.submit(expired), timeout=10),
                          QueryTimeout)
        healthy = type("Q", (), {})()
        assert pool.wait(pool.submit(healthy), timeout=10) == ("served",
                                                               healthy)
    finally:
        pool.stop()


def test_pool_fault_site_injects_per_engine():
    class Echo:
        def execute(self, q):
            return "served"

    faults.install(FaultPlan([FaultSpec("pool.execute", "transient",
                                        count=1, shard=0)], seed=0))
    pool = EnginePool(num_engines=1, make_engine=lambda tid: Echo())
    pool.start()
    try:
        q = type("Q", (), {})()
        assert isinstance(pool.wait(pool.submit(q), timeout=10),
                          TransientFault)
        assert pool.wait(pool.submit(q), timeout=10) == "served"
        assert faults.active().history == [("pool.execute", 0, "transient")]
    finally:
        pool.stop()


def test_proxy_serve_fault_site_reaches_the_caller(worlds):
    _, (pg, ps) = worlds
    proxy = Proxy(pg, ps, device="cpu")
    faults.install(parse_plan("seed=1;proxy.serve:transient,count=1"))
    with pytest.raises(TransientFault):
        proxy.serve_query(QDEPT)
    assert proxy.serve_query(QDEPT).result.nrows > 0
