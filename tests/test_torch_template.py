"""The port's whole-plan compiled templates (engine/template_compile.py and
the proxy's template route) against the JAX package's, on the same seeds
(device="cpu": the program's tensors lie on the CPU and its pair probes
run ``level_probe_plain``; the JAX programs run on XLA's CPU backend).

- ``extract_template``'s spec, v2c map, projection and width equal to the
  JAX ones for every chip_smoke shape at LUBM-3.
- Compiled rows equal to the JAX template's IN ORDER (and to the port's
  host walk in order), projected and blind, on LUBM-3 and the cyclic
  worlds.
- A forced regrow converges to the same rows and capacity classes as the
  JAX engine; overflow past the ceiling degrades to the walk with the
  ``TemplateOverflow`` latch; the ``small_measured`` and
  ``low_efficiency`` latches, and the re-arm after a store version bump.
- ``_program_key`` carries the route knobs; LRU eviction under
  ``template_budget_mb`` keeps the JAX engine's program count and
  resident bytes; the ``template.compile`` and ``template.dispatch``
  fault sites degrade to the walk and latch.
- ROADMAP §C 2: q6 past a lowered ``table_capacity_max`` is answered in
  full through the template route, with the JAX proxy's rows and route.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from wukong_tpu.config import Global as JGlobal
from wukong_tpu.engine import template_compile as jtc
from wukong_tpu.engine.cpu import CPUEngine as JCPUEngine
from wukong_tpu.engine.tpu import TPUEngine
from wukong_tpu.loader import datagen as jdg
from wukong_tpu.loader import lubm as jlubm
from wukong_tpu.obs import device as jdev
from wukong_tpu.obs.metrics import get_registry as jget_registry
from wukong_tpu.planner.optimizer import Planner as JPlanner
from wukong_tpu.planner.stats import Stats as JStats
from wukong_tpu.runtime import faults as jfaults
from wukong_tpu.runtime.proxy import Proxy as JProxy
from wukong_tpu.store.gstore import build_partition as jbuild
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine import template_compile as ptc
from wukong_tpu_torch.engine.cpu import CPUEngine
from wukong_tpu_torch.loader import datagen as pdg
from wukong_tpu_torch.loader import lubm as plubm
from wukong_tpu_torch.obs import device as pdev
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.planner.optimizer import Planner
from wukong_tpu_torch.planner.stats import Stats
from wukong_tpu_torch.runtime import faults
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.store.gstore import build_partition

torch.set_num_threads(2)

SHAPES = {**chip_smoke.QUERIES, **chip_smoke.EXT_QUERIES}
KNOBS = ("join_strategy", "template_device", "template_min_rows",
         "template_capacity_retries", "template_budget_mb",
         "template_demote_eff", "table_capacity_min", "table_capacity_max",
         "enable_device_obs", "enable_batching")


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    for k in KNOBS:
        monkeypatch.setattr(Global, k, getattr(type(Global)(), k))
        monkeypatch.setattr(JGlobal, k, getattr(type(JGlobal)(), k))
    for mod in (faults, jfaults):
        mod.clear()
    for mod in (ptc, jtc):
        mod.reset_demotions()
    for mod in (pdev, jdev):
        mod.get_device_obs().reset()
    yield
    for mod in (faults, jfaults):
        mod.clear()
    for mod in (ptc, jtc):
        mod.reset_demotions()


def _both(monkeypatch, **knobs):
    for k, v in knobs.items():
        monkeypatch.setattr(Global, k, v)
        monkeypatch.setattr(JGlobal, k, v)


@pytest.fixture(scope="module")
def lubm3():
    pt, _ = plubm.generate_lubm(3, seed=7)
    jt, _ = jlubm.generate_lubm(3, seed=7)
    return {"g": build_partition(
                pt, 0, 1, attr_triples=plubm.generate_lubm_attrs(3, seed=7)),
            "jg": jbuild(jt, 0, 1,
                         attr_triples=jlubm.generate_lubm_attrs(3, seed=7)),
            "ss": plubm.VirtualLubmStrings(3, seed=7),
            "jss": jlubm.VirtualLubmStrings(3, seed=7),
            "stats": Stats.generate(pt), "jstats": JStats.generate(jt)}


WORLDS = {
    "triangle": {"m": 60, "noise": 3, "seed": 1},
    "diamond": {"m": 40, "noise": 2, "seed": 1},
    "clique4": {"n": 120, "fan": 6, "ncliques": 8, "seed": 1},
}


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for name, kw in WORLDS.items():
        t, meta = getattr(pdg, f"generate_{name}")(**kw)
        jt, jmeta = getattr(jdg, f"generate_{name}")(**kw)
        out[name] = {"g": build_partition(t, 0, 1), "jg": jbuild(jt, 0, 1),
                     "ss": pdg.CyclicStrings(meta),
                     "jss": jdg.CyclicStrings(jmeta),
                     "stats": Stats.generate(t),
                     "jstats": JStats.generate(jt),
                     "text": pdg.cyclic_query_text(meta)}
    return out


def _proxies(w, jax_tpu=False):
    jp = JProxy(w["jg"], w["jss"], JCPUEngine(w["jg"], w["jss"]),
                TPUEngine(w["jg"], w["jss"], stats=w["jstats"])
                if jax_tpu else None, planner=JPlanner(w["jstats"]))
    return Proxy(w["g"], w["ss"], device="cpu",
                 planner=Planner(w["stats"])), jp


def _prepared(proxy, jproxy, text, blind=False):
    q = proxy._parse_text(text)
    proxy._plan_prepared(q, blind, None)
    jq = jproxy._parse_text(text)
    jproxy._plan_prepared(jq, blind, None)
    return q, jq


def _series(reg, prefix="wukong_template_"):
    """{(metric, labels): value} of every counter series under prefix (the
    `wukong_template_programs` gauge reads one engine's program count, and
    which engine differs by design: the JAX gauge keeps its last engine
    alive, the port's holds it weakly)."""
    out = {}
    for name, m in reg.snapshot().items():
        if name.startswith(prefix) and m.get("kind") == "counter":
            for s in m.get("series", []):
                labels = tuple(sorted((s.get("labels") or {}).items()))
                out[(name, labels)] = s.get("value")
    return out


def _delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if isinstance(v, (int, float)) and v != before.get(k, 0)}


# ---------------------------------------------------------------------------
# extraction and the compiled rows
# ---------------------------------------------------------------------------

def test_extract_template_equals_jax(lubm3):
    proxy, jproxy = _proxies(lubm3)
    eligible = 0
    for name, text in SHAPES.items():
        for blind in (False, True):
            q, jq = _prepared(proxy, jproxy, text, blind)
            got, want = ptc.extract_template(q), jtc.extract_template(jq)
            assert got == want, name
            eligible += got is not None
    assert eligible >= 6


def _compile_both(w, text, blind, monkeypatch):
    """Serve ``text`` through each package's TemplateCompiledEngine (and
    the port's host walk): (port query, JAX query, walk query)."""
    _both(monkeypatch, template_device="device", join_strategy="walk")
    proxy, jproxy = _proxies(w)
    q, jq = _prepared(proxy, jproxy, text, blind)
    served = ptc.TemplateCompiledEngine(w["g"], w["ss"],
                                        device="cpu").try_execute(q)
    jserved = jtc.TemplateCompiledEngine(w["jg"], w["jss"]).try_execute(jq)
    assert served == jserved
    qh = proxy._parse_text(text)
    proxy._plan_prepared(qh, blind, None)
    CPUEngine(w["g"], w["ss"]).execute(qh)
    return served, q, jq, qh


def _same(q, jq, qh):
    for other in (jq, qh):
        assert int(q.result.status_code) == int(other.result.status_code)
        assert q.result.nrows == other.result.nrows
        assert q.result.v2c_map == other.result.v2c_map
        assert q.result.col_num == other.result.col_num
        if not q.result.blind:
            assert np.asarray(q.result.table).tolist() == \
                np.asarray(other.result.table).tolist()


@pytest.mark.parametrize("blind", [False, True])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_compiled_rows_equal_jax_in_order_lubm(lubm3, monkeypatch, name,
                                               blind):
    served, q, jq, qh = _compile_both(lubm3, SHAPES[name], blind,
                                      monkeypatch)
    if served:
        _same(q, jq, qh)
        assert q._template_label == jq._template_label


@pytest.mark.parametrize("blind", [False, True])
@pytest.mark.parametrize("name", sorted(WORLDS))
def test_compiled_rows_equal_jax_in_order_worlds(worlds, monkeypatch, name,
                                                 blind):
    w = worlds[name]
    served, q, jq, qh = _compile_both(w, w["text"], blind, monkeypatch)
    assert served
    _same(q, jq, qh)
    assert q.result.nrows > 0


# ---------------------------------------------------------------------------
# capacity: regrow and overflow
# ---------------------------------------------------------------------------

def test_regrow_converges_as_jax(lubm3, monkeypatch):
    _both(monkeypatch, template_device="device", join_strategy="walk")
    proxy, jproxy = _proxies(lubm3)
    text = SHAPES["lubm_q1"]
    q, jq = _prepared(proxy, jproxy, text)
    spec = ptc.extract_template(q)[0]
    eng = ptc.TemplateCompiledEngine(lubm3["g"], lubm3["ss"], device="cpu")
    jeng = jtc.TemplateCompiledEngine(lubm3["jg"], lubm3["jss"])
    # the start list's own class, every expand's far too small
    start = eng._initial_caps(q._tsig, spec, None)[0]
    tiny = (start,) + (2,) * sum(op[0] == "expand" for op in spec[1:])
    for e, qq in ((eng, q), (jeng, jq)):
        e._good_caps[(qq._tsig, e._version())] = tiny
    assert eng.try_execute(q) and jeng.try_execute(jq)
    assert np.asarray(q.result.table).tolist() == \
        np.asarray(jq.result.table).tolist()
    assert eng._good_caps[(q._tsig, 0)] == jeng._good_caps[(jq._tsig, 0)]
    assert eng._good_caps[(q._tsig, 0)] != tiny
    got, want = (dict(dev.read_device_input("dispatches", "template.plan"))
                 for dev in (pdev, jdev))
    got.pop("wall_us"), want.pop("wall_us")
    assert got == want and got["count"] >= 2


def test_overflow_degrades_to_the_walk_and_latches(worlds, monkeypatch):
    w = worlds["triangle"]
    _both(monkeypatch, template_device="device", join_strategy="walk",
          table_capacity_min=64, table_capacity_max=128)
    proxy, jproxy = _proxies(w)
    fallback = ("wukong_template_fallback_total",
                (("reason", "TemplateOverflow"),))
    before = (_series(get_registry()), _series(jget_registry()))
    q = proxy.serve_query(w["text"])
    jq = jproxy.serve_query(w["text"], blind=False)
    # (the walk then runs on each proxy's own engine: the port's GPU
    # engine meets the same ceiling and its rows come from the host engine)
    assert _delta(before[0], _series(get_registry()))[fallback] == \
        _delta(before[1], _series(jget_registry()))[fallback] == 1
    assert not getattr(q, "_template_compiled", False)
    assert sorted(map(tuple, q.result.table.tolist())) == \
        sorted(map(tuple, jq.result.table.tolist()))
    assert ptc.demotion_report() == jtc.demotion_report()
    assert "TemplateOverflow" in ptc.demotion_report().values()
    q2 = proxy.serve_query(w["text"])
    jq2 = jproxy.serve_query(w["text"], blind=False)
    assert q2.template_route == jq2.template_route == "latched_host"


# ---------------------------------------------------------------------------
# routing: the chooser, the latches, the program key, the budget
# ---------------------------------------------------------------------------

def test_route_chooser_and_latches_equal_jax(monkeypatch):
    sig = ("t", 1)
    for knob, est, min_rows in (("host", 10**6, 4096), ("device", None, 4096),
                                ("auto", 999, 1000), ("auto", None, 1000),
                                ("auto", 1000, 1000), ("bogus", 10, 1)):
        _both(monkeypatch, template_device=knob, template_min_rows=min_rows)
        assert ptc.choose_template_route(sig, est) == \
            jtc.choose_template_route(sig, est)
    assert ptc.TEMPLATE_ROUTES.keys() == jtc.TEMPLATE_ROUTES.keys()
    # a latch holds until the store version moves
    _both(monkeypatch, template_device="device")
    for mod in (ptc, jtc):
        mod.latch_demotion(("t", 2), "compile_failed", version=7)
        assert mod.choose_template_route(("t", 2), 10**6, 7) == \
            "latched_host"
        assert mod.choose_template_route(("t", 2), 10**6, 8) == "device"
    assert ptc.demotion_report() == jtc.demotion_report()
    # low_efficiency: the site's measured padding efficiency, read through
    # read_device_input, after 8 dispatches
    _both(monkeypatch, template_device="auto", template_min_rows=1,
          template_demote_eff=0.5)
    for mod in (pdev, jdev):
        for _ in range(7):
            mod.maybe_device_dispatch("template.plan", template="tx",
                                      live=1, capacity=4096)
    assert ptc.choose_template_route(("t", 3), 10**6, 0) == \
        jtc.choose_template_route(("t", 3), 10**6, 0) == "device"
    for mod in (pdev, jdev):
        mod.maybe_device_dispatch("template.plan", template="tx", live=1,
                                  capacity=4096)
    assert ptc.choose_template_route(("t", 3), 10**6, 0) == \
        jtc.choose_template_route(("t", 3), 10**6, 0) == "latched_host"
    assert ptc.demotion_report() == jtc.demotion_report()
    assert "low_efficiency" in ptc.demotion_report().values()


def test_small_measured_latch_and_version_rearm(lubm3):
    """At LUBM-3 q1's estimate routes it device; its measured 2,929 live
    rows are under template_min_rows, so the next call walks
    (small_measured), as in the JAX proxy, until the store version moves."""
    w = {**lubm3}
    proxy, jproxy = _proxies(w)
    text = SHAPES["lubm_q1"]
    routes = []
    for _ in range(2):
        q = proxy.serve_query(text)
        jq = jproxy.serve_query(text, blind=False)
        routes.append((q.template_route, jq.template_route))
    assert routes == [("device", "device"), ("latched_host",) * 2]
    assert ptc.demotion_report() == jtc.demotion_report()
    assert list(ptc.demotion_report().values()) == ["small_measured"]
    for g in (w["g"], w["jg"]):
        g.version = 1
    try:
        q = proxy.serve_query(text)
        jq = jproxy.serve_query(text, blind=False)
        assert q.template_route == jq.template_route == "device"
        assert q._template_compiled and jq._template_compiled
        assert q.result.table.tolist() == jq.result.table.tolist()
    finally:
        for g in (w["g"], w["jg"]):
            del g.version


def test_program_key_carries_route_knobs(monkeypatch):
    keys = []
    for knob in ("auto", "device"):
        for min_rows in (4096, 1):
            _both(monkeypatch, template_device=knob,
                  template_min_rows=min_rows)
            for version, blind in ((0, False), (1, False), (0, True)):
                k = ptc._program_key(("t",), version, (1024, 2048), blind)
                assert k == jtc._program_key(("t",), version, (1024, 2048),
                                             blind)
                keys.append(k)
    assert len(set(keys)) == len(keys)


def test_lru_eviction_under_budget_equals_jax(lubm3, monkeypatch):
    _both(monkeypatch, template_device="device", join_strategy="walk",
          template_budget_mb=1, table_capacity_min=1 << 16)
    proxy, jproxy = _proxies(lubm3)
    eng = ptc.TemplateCompiledEngine(lubm3["g"], lubm3["ss"], device="cpu")
    jeng = jtc.TemplateCompiledEngine(lubm3["jg"], lubm3["jss"])
    seq = []
    for name in ("lubm_q6", "lubm_q1", "lubm_q6", "lubm_q2"):
        q, jq = _prepared(proxy, jproxy, SHAPES[name])
        assert eng.try_execute(q) and jeng.try_execute(jq)
        assert q.result.table.tolist() == jq.result.table.tolist()
        got = (eng.program_count(),
               pdev.read_device_input("resident_bytes").get("template", 0))
        want = (jeng.program_count(),
                jdev.read_device_input("resident_bytes").get("template", 0))
        assert got == want, name
        seq.append(got)
    assert min(n for n, _b in seq) == 1  # an eviction happened
    assert seq[-1][1] == sum(p.nbytes for p in eng._programs.values())


@pytest.mark.parametrize("site", ["template.compile", "template.dispatch"])
def test_fault_sites_degrade_to_the_walk_and_latch(worlds, monkeypatch,
                                                   site):
    w = worlds["diamond"]
    _both(monkeypatch, template_device="device", join_strategy="walk")
    proxy, jproxy = _proxies(w)
    for mod in (faults, jfaults):
        mod.install(mod.parse_plan(f"seed=0;{site}:transient,count=1"))
    before = (_series(get_registry()), _series(jget_registry()))
    q = proxy.serve_query(w["text"])
    jq = jproxy.serve_query(w["text"], blind=False)
    d = _delta(before[0], _series(get_registry()))
    assert d == _delta(before[1], _series(jget_registry()))
    assert d[("wukong_template_fallback_total",
              (("reason", "TransientFault"),))] == 1
    assert sorted(map(tuple, q.result.table.tolist())) == \
        sorted(map(tuple, jq.result.table.tolist()))
    assert list(ptc.demotion_report().values()) == ["TransientFault"]
    assert ptc.demotion_report() == jtc.demotion_report()


def test_long_index_start_through_the_template_route(lubm3, monkeypatch):
    """ROADMAP §C 2: q6's index start (8,620 rows) past a 4,096-row
    ceiling is answered in full through the template route at default
    knobs, with the JAX proxy's route and rows, in order."""
    _both(monkeypatch, table_capacity_max=4096, table_capacity_min=256)
    proxy, jproxy = _proxies(lubm3, jax_tpu=True)
    text = SHAPES["lubm_q6"]
    for _ in range(2):
        q = proxy.serve_query(text)
        jq = jproxy.serve_query(text, blind=False)
        assert q.template_route == jq.template_route == "device"
        assert q._template_compiled and jq._template_compiled
        assert q.result.nrows == jq.result.nrows == 8620
        assert q.result.table.tolist() == jq.result.table.tolist()


def test_concurrent_dispatches_keep_their_own_results(lubm3, monkeypatch):
    """Serving threads share one template engine (its program cache and
    learned capacities under its lock) while each dispatch keeps its own
    totals, overflow flags and live count: 8 threads with a short switch
    interval, blind and table replies of two templates interleaved, every
    reply equal to the single-threaded one."""
    import sys
    import threading

    _both(monkeypatch, template_device="device", join_strategy="walk")
    proxy, _jp = _proxies(lubm3)
    texts = [SHAPES["lubm_q2"], SHAPES["lubm_q6"]]
    want = {}
    for i, text in enumerate(texts):
        for blind in (False, True):
            q = proxy.serve_query(text, blind=blind)
            assert q._template_compiled
            want[(i, blind)] = (q.result.nrows,
                                None if blind else q.result.table.tolist())
    errors, done = [], []

    def client(k):
        try:
            for n in range(6):
                i, blind = (k + n) % 2, bool((k + n // 2) % 2)
                q = proxy.serve_query(texts[i], blind=blind)
                got = (q.result.nrows,
                       None if blind else q.result.table.tolist())
                if not q._template_compiled or got != want[(i, blind)]:
                    errors.append((k, n, i, blind))
            done.append(k)
        except Exception as e:  # reported below with the thread's id
            errors.append((k, repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and sorted(done) == list(range(8))


def test_programs_gauge_does_not_keep_a_dropped_engine():
    """The process-wide registry's `wukong_template_programs` callback holds
    its engine weakly: a dropped proxy's programs and staged operands are
    freed (the JAX engine's closure keeps every engine alive)."""
    import gc
    import weakref

    g = build_partition(np.asarray([[1 << 17, 5, (1 << 17) + 1]],
                                   dtype=np.int64), 0, 1)
    eng = ptc.TemplateCompiledEngine(g, device="cpu")
    eng._programs["k"] = object()
    gauge = get_registry().gauge("wukong_template_programs", "")
    gauge._refresh()
    assert get_registry().snapshot()["wukong_template_programs"][
        "series"][0]["value"] == 1.0
    ref = weakref.ref(eng)
    del eng
    gc.collect()
    assert ref() is None
    gauge._refresh()
    assert get_registry().snapshot()["wukong_template_programs"][
        "series"][0]["value"] == 0.0
