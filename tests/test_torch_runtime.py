"""The port's serving runtime (device="cpu": every kernel's plain version)
against the JAX package's on the same seeds.

- Repairs: at LUBM-3, seed 7, with both packages' capacity ceiling at
  4,096 / 256 rows, the port's proxy answers q1 and q2 with the JAX proxy's
  rows by degrading CAPACITY_EXCEEDED to its host engine (fault 1), q6's
  index start past the ceiling with all the JAX host engine's rows (fault
  2), and at a 256-row ceiling a const start past it with CAPACITY_EXCEEDED
  from the GPU engine, then the host engine's rows (fault 3).
- ``run_single_query``: the seven basic shapes and the extended suite give
  the JAX proxy's rows with repeats and with a user plan under
  ``enable_planner = False``; the parse and plan caches replay one plan.
- Writers and readers: ``write_dataset`` writes the JAX writer's bytes;
  ``load_triples``, ``load_attr_triples`` and ``StringServer`` read the JAX
  arrays and ids; ``load_config`` / ``reload_config`` agree knob by knob.
- The engine pool answers single-query rows, steals, respawns a dead
  engine; ``Monitor.cdf`` is the JAX ``_cdf``.
- The emulator: template candidates equal the JAX ones, no errors, light
  classes on device batches, a batch's counts equal its single queries.
"""

import copy
import filecmp
import itertools
import os
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from wukong_tpu import config as jconfig
from wukong_tpu.config import Global as JGlobal
from wukong_tpu.engine.cpu import CPUEngine as JCPUEngine
from wukong_tpu.engine.tpu import TPUEngine
from wukong_tpu.loader import base as jbase
from wukong_tpu.loader import lubm as jlubm
from wukong_tpu.planner.optimizer import Planner as JPlanner
from wukong_tpu.planner.stats import Stats as JStats
from wukong_tpu.runtime.monitor import _cdf as jcdf
from wukong_tpu.runtime.proxy import Proxy as JProxy
from wukong_tpu.sparql.parser import Parser as JParser
from wukong_tpu.store.gstore import build_partition as jbuild
from wukong_tpu.store.string_server import StringServer as JStringServer
from wukong_tpu_torch import config as pconfig
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine.cpu import CPUEngine
from wukong_tpu_torch.loader import base as pbase
from wukong_tpu_torch.loader import lubm as plubm
from wukong_tpu_torch.planner.optimizer import Planner
from wukong_tpu_torch.planner.stats import Stats
from wukong_tpu_torch.runtime.emulator import Emulator, MixConfig
from wukong_tpu_torch.runtime.monitor import Monitor
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.runtime.scheduler import EnginePool
from wukong_tpu_torch.sparql.parser import Parser
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.store.string_server import StringServer
from wukong_tpu_torch.utils.errors import ErrorCode

torch.set_num_threads(2)

QUERIES = {**chip_smoke.QUERIES, **chip_smoke.EXT_QUERIES}


def _rows(res):
    rows = np.asarray(res.table).tolist()
    if res.attr_table.size:
        rows = [r + a for r, a in zip(rows, res.attr_table.tolist())]
    return [tuple(r) for r in rows]


def _same_rows(got, want, ordered=False):
    assert int(got.result.status_code) == int(want.result.status_code)
    a, b = _rows(got.result), _rows(want.result)
    assert (a == b) if ordered else (sorted(a) == sorted(b))


def _ceiling(monkeypatch, cap_max, cap_min):
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "table_capacity_max", cap_max)
        monkeypatch.setattr(G, "table_capacity_min", cap_min)


# ---------------------------------------------------------------------------
# repairs: faults 1-3 at LUBM-3, seed 7, under a lowered capacity ceiling
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lubm3():
    jt, _ = jlubm.generate_lubm(3, seed=7)
    jg = jbuild(jt, 0, 1, attr_triples=jlubm.generate_lubm_attrs(3, seed=7))
    js = jlubm.VirtualLubmStrings(3, seed=7)
    pt, _ = plubm.generate_lubm(3, seed=7)
    pg = build_partition(pt, 0, 1,
                         attr_triples=plubm.generate_lubm_attrs(3, seed=7))
    return (jg, js, JStats.generate(jt)), (
        pg, plubm.VirtualLubmStrings(3, seed=7), Stats.generate(pt))


def _proxies(lubm3):
    """Both proxies, built as each console builds them, after the
    ceiling was lowered (each engine reads it when it is built)."""
    (jg, js, jstats), (pg, ps, pstats) = lubm3
    jproxy = JProxy(jg, js, JCPUEngine(jg, js),
                    TPUEngine(jg, js, stats=jstats), planner=JPlanner(jstats))
    return jproxy, Proxy(pg, ps, device="cpu", planner=Planner(pstats))


@pytest.mark.parametrize("name,rows", [("lubm_q1", 2929), ("lubm_q2", 94)])
def test_capacity_overflow_degrades_to_the_host_engine(
        lubm3, monkeypatch, capfd, name, rows):
    """Fault 1: the port's GPU engine answers CAPACITY_EXCEEDED; its proxy
    answers the JAX proxy's rows through its host engine, and says so."""
    _ceiling(monkeypatch, 4096, 256)
    jproxy, proxy = _proxies(lubm3)
    text = QUERIES[name]
    q = proxy.parse(text)
    proxy.gpu.execute(q)
    assert q.result.status_code == ErrorCode.CAPACITY_EXCEEDED
    want = jproxy.run_single_query(text, blind=False)
    assert want.result.nrows == rows
    capfd.readouterr()
    got = proxy.run_single_query(text, repeats=2, blind=False)
    assert "degrading to the host engine" in capfd.readouterr().err
    _same_rows(got, want)
    _same_rows(proxy.serve_query(text), want)


def test_long_index_start_is_answered_in_full(lubm3, monkeypatch):
    """Fault 2: q6's index start (8,620 rows) passes a 4,096-row ceiling.
    The JAX engine keeps 4,096 rows with status 0; the port's GPU engine
    refuses it, and its proxy answers all rows, as the JAX host engine."""
    _ceiling(monkeypatch, 4096, 256)
    (jg, js, jstats), _ = lubm3
    _jproxy, proxy = _proxies(lubm3)
    text = QUERIES["lubm_q6"]
    q = proxy.parse(text)
    proxy.gpu.execute(q)
    assert q.result.status_code == ErrorCode.CAPACITY_EXCEEDED
    want = JParser(js).parse(text)
    JPlanner(jstats).generate_plan(want)
    JCPUEngine(jg, js).execute(want)
    assert want.result.nrows == 8620
    for got in (proxy.serve_query(text),
                proxy.run_single_query(text, blind=False)):
        _same_rows(got, want)


@pytest.mark.parametrize("name", ["lubm_q5", "x_opt_light", "x_union",
                                  "x_filter"])
def test_long_const_start_is_a_capacity_overflow(lubm3, monkeypatch, name):
    """Fault 3: at a 256-row ceiling a const start with more neighbours
    (the JAX engine raises numpy's ValueError there) is CAPACITY_EXCEEDED
    from the GPU engine, then the host engine's rows."""
    _ceiling(monkeypatch, 256, 256)
    (jg, js, jstats), (pg, ps, pstats) = lubm3
    proxy = Proxy(pg, ps, device="cpu", planner=Planner(pstats))
    text = QUERIES[name]
    q = proxy.parse(text)
    q.result.blind = False
    proxy.gpu.execute(q)
    assert q.result.status_code == ErrorCode.CAPACITY_EXCEEDED
    want = JParser(js).parse(text)
    JPlanner(jstats).generate_plan(want)
    JCPUEngine(jg, js).execute(want)
    assert want.result.status_code == 0 and want.result.nrows > 0
    _same_rows(proxy.run_single_query(text, blind=False), want)
    _same_rows(proxy.serve_query(text), want)


# ---------------------------------------------------------------------------
# run_single_query against the JAX proxy (LUBM-1, seed 42)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    jt, _ = jlubm.generate_lubm(1, seed=42)
    jg = jbuild(jt, 0, 1, attr_triples=jlubm.generate_lubm_attrs(1, seed=42))
    js = jlubm.VirtualLubmStrings(1, seed=42)
    jstats = JStats.generate(jt)
    jproxy = JProxy(jg, js, JCPUEngine(jg, js),
                    TPUEngine(jg, js, stats=jstats), planner=JPlanner(jstats))
    pt, _ = plubm.generate_lubm(1, seed=42)
    pg = build_partition(pt, 0, 1,
                         attr_triples=plubm.generate_lubm_attrs(1, seed=42))
    ps = plubm.VirtualLubmStrings(1, seed=42)
    proxy = Proxy(pg, ps, device="cpu", planner=Planner(Stats.generate(pt)))
    return jproxy, proxy


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_run_single_query_matches_jax(world, name):
    jproxy, proxy = world
    want = jproxy.run_single_query(QUERIES[name], blind=False)
    got = proxy.run_single_query(QUERIES[name], repeats=3, blind=False)
    _same_rows(got, want, ordered=name in chip_smoke.ORDERED)
    # Global.silent: blind replies carry the row count only
    blind, jblind = (p.run_single_query(QUERIES[name]) for p in (proxy, jproxy))
    assert blind.result.blind and jblind.result.blind
    assert blind.result.nrows == jblind.result.nrows


@pytest.mark.parametrize("name,plan", [
    ("lubm_q3", "2 <\n1 >\n"), ("lubm_q4", "1 <\n2 >\n3 >\n4 >\n"),
    ("lubm_q2", "1 <\n4 <\n2 >\n5 >\n3 >\n6 >\n"), ("lubm_q5", "1 <<\n1 >\n")])
@pytest.mark.parametrize("device", ["gpu", "cpu"])
def test_user_plan_without_the_planner(world, monkeypatch, name, plan,
                                       device):
    jproxy, proxy = world
    monkeypatch.setattr(Global, "enable_planner", False)
    monkeypatch.setattr(JGlobal, "enable_planner", False)
    want = jproxy.run_single_query(QUERIES[name], plan_text=plan,
                                   device="tpu" if device == "gpu" else "cpu",
                                   blind=False)
    got = proxy.run_single_query(QUERIES[name], repeats=2, plan_text=plan,
                                 device=device, blind=False)
    _same_rows(got, want)
    assert repr(got.pattern_group.patterns) == \
        repr(want.pattern_group.patterns)


def test_parse_and_plan_caches_replay_one_plan(world):
    """A repeated text is parsed once and comes back pristine; a template
    with another constant replays the recorded plan, and that plan is the
    one the planner gives it."""
    _jproxy, proxy = world
    text = QUERIES["lubm_q4"]
    a, b = proxy.parse(text), proxy.parse(text)
    assert a is not b and repr(a.pattern_group.patterns) == \
        repr(b.pattern_group.patterns)
    proxy.serve_query(text)
    again = proxy.parse(text)
    assert again.result.nrows == 0 and again.pattern_step == 0
    other = text.replace("Department0.University0", "Department1.University0")
    before = len(proxy._plan_cache)
    replayed = proxy.parse(other)
    assert len(proxy._plan_cache) == before  # replayed, not recorded
    fresh = Parser(proxy.str_server).parse(other)
    assert proxy.planner.generate_plan(fresh)
    assert repr(replayed.pattern_group.patterns) == \
        repr(fresh.pattern_group.patterns)
    assert proxy.serve_query(other).result.status_code == 0


# ---------------------------------------------------------------------------
# writers and readers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["npy", "text"])
def test_write_dataset_matches_the_jax_writer(tmp_path, fmt):
    a, b = tmp_path / "jax", tmp_path / "port"
    ma = jlubm.write_dataset(str(a), 1, seed=3, fmt=fmt,
                             write_str_normal=fmt == "text")
    mb = plubm.write_dataset(str(b), 1, seed=3, fmt=fmt,
                             write_str_normal=fmt == "text")
    assert ma == mb
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert mismatch == [] and errors == [] and len(match) == len(names)


def test_readers_match_jax(tmp_path):
    d = str(tmp_path / "lubm1")
    plubm.write_dataset(d, 1, seed=5)
    assert np.array_equal(pbase.load_triples(d), jbase.load_triples(d))
    cols = pbase.load_attr_triples(d)
    rows = jbase.load_attr_triples(d)
    assert [tuple(r) for r in zip(*(c.tolist() for c in cols))] == rows
    text = str(tmp_path / "text")
    plubm.write_dataset(text, 1, seed=5, fmt="text")
    assert np.array_equal(np.sort(pbase.load_triples(text), axis=0),
                          np.sort(pbase.load_triples(d), axis=0))
    js, ps = JStringServer(d), StringServer(d)
    assert ps._s2i == js._s2i and ps.pid2type == js.pid2type
    ids = np.unique(pbase.load_triples(d)[:, [0, 2]])[::997]
    for i in ids.tolist():
        assert ps.id2str(i) == js.id2str(i)
        assert ps.str2id(js.id2str(i)) == i
    assert not ps.exist("<nope>") and not ps.exist_id(2**31 - 2)


CONFIG_TEXT = """# a JAX deployment's file, knobs the port lacks included
global_num_engines 3
global_enable_tpu true
global_silent false
global_stealing_pattern 1
global_query_budget_rows 5000
global_enable_partial_results false
global_breaker_threshold 7
global_retry_max_attempts 5
global_plan_cache_size 64
global_table_capacity_max 65536
global_mt_threshold 2
global_enable_result_cache true
"""


def _knobs(G):
    return {f: getattr(G, f) for f in pconfig.Global._names()}


def test_config_loads_like_jax(tmp_path, monkeypatch, capfd):
    for name in pconfig.Global._names():
        monkeypatch.setattr(Global, name, getattr(Global, name))
        monkeypatch.setattr(JGlobal, name, getattr(JGlobal, name))
    monkeypatch.setattr(JGlobal, "num_workers", JGlobal.num_workers)
    monkeypatch.setattr(JGlobal, "mt_threshold", JGlobal.mt_threshold)
    monkeypatch.setattr(JGlobal, "enable_result_cache",
                        JGlobal.enable_result_cache)
    monkeypatch.setattr(JGlobal, "retry_max_attempts",
                        JGlobal.retry_max_attempts)
    assert _knobs(Global) == _knobs(JGlobal)  # the same defaults
    path = tmp_path / "cfg"
    path.write_text(CONFIG_TEXT)
    pconfig.load_config(str(path))
    jconfig.load_config(str(path))
    err = capfd.readouterr().err
    assert "unknown config item ignored: global_mt_threshold" in err
    assert "global_retry_max_attempts" not in err  # the port has it since
    assert _knobs(Global) == _knobs(JGlobal)
    assert Global.num_engines == 3 and Global.plan_cache_size == 64
    assert Global.breaker_threshold == JGlobal.breaker_threshold == 7
    assert Global.retry_max_attempts == JGlobal.retry_max_attempts == 5
    runtime = "global_query_deadline_ms 250\ndevice_batch 512\n"
    pconfig.reload_config(runtime)
    jconfig.reload_config(runtime)
    assert _knobs(Global) == _knobs(JGlobal)
    for bad in ("num_engines 8", "global_enable_tpu false"):
        with pytest.raises(ValueError):
            pconfig.reload_config(bad)
    with pytest.raises(ValueError):  # junk int: nothing is applied
        pconfig.reload_config("heavy_batch_max 3\nplan_cache_size x")
    assert Global.heavy_batch_max == JGlobal.heavy_batch_max
    assert Global.dump().splitlines()[0] == "global_num_engines\t3"


# ---------------------------------------------------------------------------
# the engine pool and the monitor
# ---------------------------------------------------------------------------

def test_engine_pool_answers_single_rows_and_steals(world):
    _jproxy, proxy = world
    text = QUERIES["lubm_q5"]
    want = proxy.serve_query(text, blind=True).result.nrows
    pool = EnginePool(num_engines=4, make_engine=lambda tid: CPUEngine(
        proxy.g, proxy.str_server))
    pool.start()
    try:
        qids = []
        for _ in range(16):
            q = proxy.parse(text)
            q.result.blind = True
            qids.append(pool.submit(q, tid=0))  # neighbours must steal
        outs = [pool.wait(qid, timeout=60) for qid in qids]
        assert all(o.result.status_code == 0 and o.result.nrows == want
                   for o in outs)
        assert pool.poll() == []
    finally:
        pool.stop()
    assert proxy.engine_pool() is proxy.engine_pool()


def test_engine_pool_respawns_a_dead_engine():
    """A thread death fails its in-flight query, the tid respawns, and past
    MAX_RESPAWNS the engine is declared dead and routed around."""

    class Bomb:
        def __init__(self, tid):
            self.tid = tid

        def execute(self, q):
            if q == "die":
                raise SystemExit(13)  # escapes the per-query except
            return ("ok", self.tid, q)

    pool = EnginePool(num_engines=2, make_engine=Bomb)
    pool._neighbors = lambda tid: []  # no stealing: a fixed victim
    pool.start()
    try:
        assert pool.wait(pool.submit("a"), timeout=10)[0] == "ok"
        assert isinstance(pool.wait(pool.submit("die", tid=0), timeout=10),
                          RuntimeError)
        end = time.time() + 10
        while pool.health()[0]["respawns"] != 1:
            assert time.time() < end
            time.sleep(0.01)
        assert pool.wait(pool.submit("b", tid=0), timeout=10)[0] == "ok"
        assert pool.health()[0] == {"alive": True, "respawns": 0,
                                    "busy_us": 0}
        for _ in range(EnginePool.MAX_RESPAWNS + 1):
            assert isinstance(pool.wait(pool.submit("die", tid=0),
                                        timeout=10), RuntimeError)
        end = time.time() + 10
        while pool.health()[0]["alive"]:
            assert time.time() < end
            time.sleep(0.01)
        for _ in range(4):
            assert pool.wait(pool.submit("c", tid=0), timeout=10)[1] == 1
        assert threading.active_count() >= 1
    finally:
        pool.stop()


@pytest.mark.parametrize("n", [0, 1, 7, 100, 1001])
def test_monitor_cdf_matches_jax(n):
    rng = np.random.default_rng(n)
    vals = rng.exponential(300.0, n).tolist()
    m = Monitor()
    for i, v in enumerate(vals):
        m.add_latency(v, qtype=i % 2)
    m.add_latency(5.0, qtype=2, count=3)
    assert m.cdf() == jcdf(vals + [5.0] * 3)
    assert m.cdf(0) == jcdf(vals[0::2]) and m.cdf(2) == jcdf([5.0] * 3)
    assert m.cdf(9) == {}


# ---------------------------------------------------------------------------
# the emulator
# ---------------------------------------------------------------------------

def _mix(parser, heavy=True):
    tmpl = [parser.parse_template(chip_smoke.TEMPLATES[n])
            for n in sorted(chip_smoke.TEMPLATES)]
    heavies = [QUERIES[n] for n in chip_smoke.HEAVY] if heavy else []
    return MixConfig(tmpl, heavies, [1] * (len(tmpl) + len(heavies)))


def test_template_candidates_match_jax(world):
    jproxy, proxy = world
    for name in sorted(chip_smoke.TEMPLATES):
        tj = JParser(jproxy.str_server).parse_template(
            chip_smoke.TEMPLATES[name])
        tp = Parser(proxy.str_server).parse_template(
            chip_smoke.TEMPLATES[name])
        jproxy.fill_template(tj)
        proxy.fill_template(tp)
        assert tp.ptypes == tj.ptypes and tp.pos == tj.pos
        assert [c.tolist() for c in tp.candidates] == \
            [np.asarray(c).tolist() for c in tj.candidates]


def test_emulator_runs_every_route(world, monkeypatch):
    """sparql-emu with batch 16, 0.5 s: light classes on device batches
    (windows after their first batch), heavy ones in index batches, no
    errors. A loaded host draws few classes in 0.5 s, so runs repeat with
    the next seed until every light class has replied, within a deadline;
    each run holds every invariant."""
    _jproxy, proxy = world
    calls = []
    orig = proxy.gpu.merge.run_batch_const_mixed
    monkeypatch.setattr(proxy.gpu.merge, "run_batch_const_mixed",
                        lambda jobs: calls.append(len(jobs)) or orig(jobs))
    modes: dict = {}
    replied: set = set()
    deadline = time.monotonic() + 120
    for seed in itertools.count():
        out = Emulator(proxy).run(_mix(Parser(proxy.str_server)),
                                  duration_s=0.5, warmup_s=0.1, batch=16,
                                  parallel=4, seed=seed)
        assert out["errors"] == 0 and out["shed"] == 0
        assert out["thpt_qps"] > 0
        assert out["precompiled_classes"] == 4 and out["wall_qps"] > 0
        for c, mode in out["class_mode"].items():
            modes.setdefault(c, set()).add(mode)
        replied |= {c for c in range(4) if out["cdf"][c]}
        if replied == set(range(4)) and all(c in modes for c in range(4)):
            break
        assert time.monotonic() < deadline, (
            f"light classes {sorted(set(range(4)) - replied)} never replied")
    assert all(modes[c] == {"device-batch"} for c in range(4))
    assert all(modes.get(c, {"device-batch"}) == {"device-batch"}
               for c in (4, 5, 6))
    assert calls and all(w == 4 for w in calls)


@pytest.mark.parametrize("entry", ["execute_batch", "execute_batch_mixed",
                                   "execute_batch_index"])
def test_emulator_device_oom_is_not_degraded(world, monkeypatch, entry):
    """The card running out of memory in a device batch fails the run: only
    a query-scoped WukongError degrades a class to the host pool."""
    _jproxy, proxy = world

    def oom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("out of memory in a device batch")

    monkeypatch.setattr(proxy.gpu, entry, oom)
    if entry == "execute_batch_index":
        mix = MixConfig([], [QUERIES["lubm_q6"]], [1])
    else:
        mix = _mix(Parser(proxy.str_server), heavy=False)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        Emulator(proxy).run(mix, duration_s=0.3, warmup_s=0.05, batch=16,
                            parallel=4)


def test_emulator_pool_path_sheds_by_budget(world, monkeypatch):
    """With the GPU engine off, every class rides the host pool; a row
    budget of 1 ends every query as a partial reply, not an error."""
    _jproxy, proxy = world
    monkeypatch.setattr(Global, "enable_tpu", False)
    out = Emulator(proxy).run(_mix(Parser(proxy.str_server), heavy=False),
                              duration_s=0.3, warmup_s=0.05, parallel=2)
    assert out["errors"] == 0 and out["precompiled_classes"] == 0
    assert set(out["class_mode"].values()) == {"pool"}
    monkeypatch.setattr(Global, "query_budget_rows", 1)
    out = Emulator(proxy).run(_mix(Parser(proxy.str_server), heavy=False),
                              duration_s=0.3, warmup_s=0.05, parallel=2)
    assert out["errors"] == 0


@pytest.mark.parametrize("name", sorted(chip_smoke.TEMPLATES))
def test_emulator_batch_counts_equal_single_queries(world, name):
    _jproxy, proxy = world
    tmpl = Parser(proxy.str_server).parse_template(chip_smoke.TEMPLATES[name])
    proxy.fill_template(tmpl)
    rng = np.random.default_rng(11)
    q0 = tmpl.instantiate(rng)
    inst = getattr(q0.pattern_group.patterns[tmpl.pos[0][0]], tmpl.pos[0][1])
    emu = Emulator(proxy)
    emu._plan(q0)
    q0._inst_const = inst
    assert emu._batchable(tmpl, q0)
    consts = emu._draw_consts(tmpl, rng, 16)
    counts = proxy.gpu.execute_batch(q0, consts)
    for i, c in enumerate(consts):
        qi = copy.deepcopy(tmpl.query)
        pi, fld = tmpl.pos[0]
        setattr(qi.pattern_group.patterns[pi], fld, int(c))
        emu._plan(qi)
        qi.result.blind = True
        proxy.cpu.execute(qi)
        assert counts[i] == qi.result.nrows, (i, int(c))


@pytest.mark.parametrize("window", ["filter", "expand"])
def test_corun_matches_jax(world, monkeypatch, window):
    """CORUN (enable_corun) at a marked step: the host engine, alone and as
    an engine of the pool, keeps the JAX host engine's rows — a filter
    window the plain rows, an expansion window each main row once."""
    from wukong_tpu.sparql.ir import Pattern as JPattern
    from wukong_tpu.sparql.ir import SPARQLQuery as JQuery
    from wukong_tpu_torch.sparql.ir import Pattern, SPARQLQuery

    jproxy, proxy = world
    ss = proxy.str_server
    ub = "<http://swat.cse.lehigh.edu/onto/univ-bench.owl#{}>".format
    d0 = ss.str2id("<http://www.Department0.University0.edu>")
    second = ((1, 1, ss.str2id(ub("UndergraduateStudent")))
              if window == "filter" else (ss.str2id(ub("takesCourse")), 1, -2))
    pats = [(d0, ss.str2id(ub("memberOf")), 0, -1), (-1, *second)]
    monkeypatch.setattr(Global, "enable_corun", True)
    monkeypatch.setattr(JGlobal, "enable_corun", True)

    def query(P, Q, corun):
        q = Q()
        q.pattern_group.patterns = [P(*p) for p in pats]
        q.result.nvars = 2
        q.result.required_vars = [-1]
        q.corun_enabled, q.corun_step, q.fetch_step = corun, 1, 2
        return q

    want = jproxy.cpu.execute(query(JPattern, JQuery, True))
    plain = proxy.cpu.execute(query(Pattern, SPARQLQuery, False))
    pool = proxy.engine_pool()
    for got in (proxy.cpu.execute(query(Pattern, SPARQLQuery, True)),
                pool.wait(pool.submit(query(Pattern, SPARQLQuery, True)),
                          timeout=60)):
        _same_rows(got, want)
    if window == "filter":
        _same_rows(plain, want)
    else:
        assert sorted({r[0] for r in _rows(plain.result)}) == \
            sorted(r[0] for r in _rows(want.result))
