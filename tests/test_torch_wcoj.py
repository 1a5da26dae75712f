"""The port's WCOJ strategy (wukong_tpu_torch/join/, the planner's and the
proxy's routing and feedback) against the JAX package's, on the same seeds
(device="cpu": the device route runs ``level_probe_plain``; the JAX device
route runs its jitted probe on XLA's CPU backend). Every comparison is
exact: ids, masks, row order and counters.

- ``analyze`` on the three cyclic worlds and every chip_smoke shape at
  LUBM-1: support and reason, order, cyclicity, unaries, edges.
- ``level_probe_plain`` against the JAX ``jit_level_probe`` and
  ``level_probe_host``, bit for bit, on chip_smoke's adversarial cases.
- WCOJ rows (in order), per-level stats and blind counts against the JAX
  executor on triangle, diamond and clique4, on both level routes.
- ``choose_strategy`` / ``choose_join_route`` at each knob setting.
- ``serve_query`` at default knobs on LUBM-3 and LUBM-10 (seed 7) and on
  the cyclic worlds: every call's strategy, level route, template route
  and level stats equal to the JAX proxy's, call after call (at LUBM-10
  q1 and q2 route wcoj on their first call and are demoted to the walk),
  with equal ``wukong_join_*`` / ``wukong_template_*`` counter deltas.
- Degradation: a ``join.materialize`` fault degrades to the walk; an id
  past int32 degrades a device level to host with reason ``int32_range``;
  an error raised inside ``level_probe`` (a stand-in for a CUDA error)
  reaches the caller, with no fallback counter moved.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from wukong_tpu.config import Global as JGlobal
from wukong_tpu.engine import template_compile as jtc
from wukong_tpu.engine.cpu import CPUEngine as JCPUEngine
from wukong_tpu.engine.tpu import TPUEngine
from wukong_tpu.join import kernels as JK
from wukong_tpu.join.qgraph import analyze as janalyze
from wukong_tpu.join.wcoj import WCOJExecutor as JWCOJ
from wukong_tpu.loader import datagen as jdg
from wukong_tpu.loader import lubm as jlubm
from wukong_tpu.obs import device as jdev
from wukong_tpu.obs.metrics import get_registry as jget_registry
from wukong_tpu.planner.optimizer import Planner as JPlanner
from wukong_tpu.planner.stats import Stats as JStats
from wukong_tpu.runtime import faults as jfaults
from wukong_tpu.runtime.proxy import Proxy as JProxy
from wukong_tpu.sparql.parser import Parser as JParser
from wukong_tpu.store.gstore import build_partition as jbuild
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine import template_compile as ptc
from wukong_tpu_torch.join import kernels as PK
from wukong_tpu_torch.join import wcoj as pwcoj
from wukong_tpu_torch.join.qgraph import analyze
from wukong_tpu_torch.join.wcoj import WCOJExecutor
from wukong_tpu_torch.loader import datagen as pdg
from wukong_tpu_torch.loader import lubm as plubm
from wukong_tpu_torch.obs import device as pdev
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.planner.optimizer import Planner
from wukong_tpu_torch.planner.stats import Stats
from wukong_tpu_torch.runtime import faults
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.sparql.parser import Parser
from wukong_tpu_torch.store.gstore import build_partition

torch.set_num_threads(2)

WORLDS = {
    "triangle": {"m": 60, "noise": 3, "seed": 1},
    "diamond": {"m": 40, "noise": 2, "seed": 1},
    "clique4": {"n": 120, "fan": 6, "ncliques": 8, "seed": 1},
}
KNOBS = ("join_strategy", "wcoj_ratio", "wcoj_min_rows", "join_device",
         "join_device_min_candidates", "template_device",
         "enable_device_obs", "enable_planner", "enable_batching",
         "join_table_cache")


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    """Every knob a test sets starts at its default in both packages; no
    fault plan, no template latch, clean observatories."""
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


def _world(name):
    fn = f"generate_{name}"
    t, meta = getattr(pdg, fn)(**WORLDS[name])
    jt, jmeta = getattr(jdg, fn)(**WORLDS[name])
    return {"g": build_partition(t, 0, 1), "jg": jbuild(jt, 0, 1),
            "ss": pdg.CyclicStrings(meta), "jss": jdg.CyclicStrings(jmeta),
            "stats": Stats.generate(t), "jstats": JStats.generate(jt),
            "text": pdg.cyclic_query_text(meta)}


@pytest.fixture(scope="module")
def worlds():
    return {name: _world(name) for name in WORLDS}


def _lubm(scale):
    pt, _ = plubm.generate_lubm(scale, seed=7)
    jt, _ = jlubm.generate_lubm(scale, seed=7)
    return {"g": build_partition(
                pt, 0, 1, attr_triples=plubm.generate_lubm_attrs(scale, seed=7)),
            "jg": jbuild(jt, 0, 1,
                         attr_triples=jlubm.generate_lubm_attrs(scale, seed=7)),
            "ss": plubm.VirtualLubmStrings(scale, seed=7),
            "jss": jlubm.VirtualLubmStrings(scale, seed=7),
            "stats": Stats.generate(pt), "jstats": JStats.generate(jt)}


@pytest.fixture(scope="module")
def lubm():
    return {3: _lubm(3), 10: _lubm(10)}


def _planned(w, text):
    """The text parsed and planned by each package's cost planner."""
    q = Parser(w["ss"]).parse(text)
    Planner(w["stats"]).generate_plan(q)
    jq = JParser(w["jss"]).parse(text)
    JPlanner(w["jstats"]).generate_plan(jq)
    return q, jq


def _proxies(w, jax_tpu=False):
    jp = JProxy(w["jg"], w["jss"], JCPUEngine(w["jg"], w["jss"]),
                TPUEngine(w["jg"], w["jss"], stats=w["jstats"])
                if jax_tpu else None,
                planner=JPlanner(w["jstats"]))
    return Proxy(w["g"], w["ss"], device="cpu",
                 planner=Planner(w["stats"])), jp


def _qg(qg):
    return (qg.supported, qg.reason, qg.vars, qg.order, qg.cyclic,
            [(u.var, u.kind, u.payload) for u in qg.unaries],
            [(e.s, e.pid, e.o) for e in qg.edges])


def _levels(q):
    return [{k: v for k, v in lv.items() if k != "time_us"}
            for lv in (getattr(q, "join_stats", None) or [])]


def _series(reg, prefixes=("wukong_join_", "wukong_template_")):
    """{(metric, labels): value} of every counter series under prefixes."""
    out = {}
    for name, m in reg.snapshot().items():
        if name.startswith(prefixes) and m.get("kind") == "counter":
            for s in m.get("series", []):
                labels = tuple(sorted((s.get("labels") or {}).items()))
                out[(name, labels)] = s.get("value")
    return out


def _delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if isinstance(v, (int, float)) and v != before.get(k, 0)}


# ---------------------------------------------------------------------------
# the query graph and the kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(WORLDS))
def test_analyze_equal_on_worlds(worlds, name):
    q, jq = _planned(worlds[name], worlds[name]["text"])
    got = _qg(analyze(q.pattern_group.patterns))
    assert got == _qg(janalyze(jq.pattern_group.patterns))
    assert got[0] and got[4]  # supported and cyclic


def test_analyze_equal_on_lubm_shapes(lubm):
    w = lubm[3]
    for name, text in {**chip_smoke.QUERIES, **chip_smoke.EXT_QUERIES}.items():
        q, jq = _planned(w, text)
        assert _qg(analyze(q.pattern_group.patterns)) == \
            _qg(janalyze(jq.pattern_group.patterns)), name
    q, _jq = _planned(w, chip_smoke.QUERIES["lubm_q1"])
    assert _qg(analyze(q.pattern_group.patterns))[4]  # q1 is cyclic


@pytest.mark.parametrize("case", chip_smoke.level_probe_cases(),
                         ids=lambda c: c[0])
def test_level_probe_plain_equals_jax(case):
    import jax.numpy as jnp

    _name, valid, cand, glob, adj, full = case

    def t(a):
        return torch.from_numpy(a)

    got = PK.level_probe_plain(
        t(valid), t(cand), None if glob is None else t(glob),
        [(t(k), t(o), t(e), t(a), d) for k, o, e, a, d in adj]).numpy()
    fn = JK.jit_level_probe(tuple(d for *_r, d in adj), glob is not None)
    args = [jnp.asarray(valid), jnp.asarray(cand),
            jnp.asarray(glob) if glob is not None
            else jnp.zeros(1, dtype=jnp.int32)]
    for k, o, e, a, _d in adj:
        args += [jnp.asarray(k), jnp.asarray(o), jnp.asarray(e),
                 jnp.asarray(a)]
    assert got.dtype == bool
    assert np.array_equal(got, np.asarray(fn(*args)))
    if full:  # the host twin searches to full depth
        flat = [x for k, o, e, a, _d in adj for x in (k, o, e, a)]
        assert np.array_equal(got, JK.level_probe_host(valid, cand, glob,
                                                       *flat))
        assert np.array_equal(got, PK.level_probe_host(valid, cand, glob,
                                                       *flat))
    # level_probe on CPU tensors is the plain version
    assert np.array_equal(got, PK.level_probe(
        t(valid), t(cand), None if glob is None else t(glob),
        [(t(k), t(o), t(e), t(a), d) for k, o, e, a, d in adj]).numpy())


def test_host_kernels_equal_jax():
    rng = np.random.default_rng(3)
    a = np.unique(rng.integers(0, 500, 200))
    b = np.unique(rng.integers(0, 500, 300))
    c = np.unique(rng.integers(0, 500, 100))
    assert np.array_equal(PK.intersect_many([a, b, c]),
                          JK.intersect_many([a, b, c]))
    assert PK.intersect_many([]) is None
    keys, offsets, edges, _d = chip_smoke._lp_csr(rng, 50, 9, 400, 1000)
    vids = rng.integers(0, 1000, 700)
    for x, y in zip(PK.lookup_ranges(keys, offsets, vids),
                    JK.lookup_ranges(keys, offsets, vids)):
        assert np.array_equal(x, y)
    start, deg = PK.lookup_ranges(keys, offsets, vids)
    for x, y in zip(PK.expand_ragged(start, deg),
                    JK.expand_ragged(start, deg)):
        assert np.array_equal(x, y)
    # the torch route of lookup_ranges / member_sorted / pair_member
    tk, to, te = (torch.from_numpy(x.astype(np.int32))
                  for x in (keys, offsets, edges))
    tv = torch.from_numpy(vids.astype(np.int32))
    for x, y in zip(PK.lookup_ranges(tk, to, tv), (start, deg)):
        assert np.array_equal(x.numpy(), y)
    assert np.array_equal(
        PK.member_sorted(te[:50].sort().values, tv).numpy(),
        JK.member_sorted(np.sort(edges[:50]), vids))
    anchors = keys[rng.integers(0, len(keys), 700)]
    vals = edges[rng.integers(0, len(edges), 700)]
    assert np.array_equal(
        PK.pair_member(tk, to, te, torch.from_numpy(anchors.astype(np.int32)),
                       torch.from_numpy(vals.astype(np.int32)),
                       depth=5).numpy(),
        JK.pair_member(keys, offsets, edges, anchors, vals))
    with pytest.raises(PK.DeviceRangeError):
        PK.to_device_i32(np.array([1, 2**31]), "cpu")
    with pytest.raises(PK.DeviceRangeError):
        PK.to_device_i32(np.array([-(2**31) - 1]), "cpu")
    assert PK.to_device_i32(np.array([0, 2**31 - 1]), "cpu").dtype == \
        torch.int32


# ---------------------------------------------------------------------------
# the executor on both routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("name", sorted(WORLDS))
def test_wcoj_rows_equal_jax(worlds, monkeypatch, name, route):
    w = worlds[name]
    _both(monkeypatch, join_device=route)
    for blind in (False, True):
        q, jq = _planned(w, w["text"])
        q.result.blind = jq.result.blind = blind
        WCOJExecutor(w["g"], w["ss"], stats=w["stats"], device="cpu").execute(q)
        JWCOJ(w["jg"], w["jss"], stats=w["jstats"]).execute(jq)
        assert int(q.result.status_code) == int(jq.result.status_code) == 0
        assert q.result.nrows == jq.result.nrows > 0
        assert _levels(q) == _levels(jq)
        assert all(lv["route"] == route for lv in _levels(q))
        if not blind:
            assert np.asarray(q.result.table).tolist() == \
                np.asarray(jq.result.table).tolist()
            assert q.result.v2c_map == jq.result.v2c_map


def test_choose_strategy_and_route_equal(worlds, lubm, monkeypatch):
    shapes = [(worlds[n], worlds[n]["text"]) for n in sorted(WORLDS)]
    shapes += [(lubm[3], chip_smoke.QUERIES[n])
               for n in ("lubm_q1", "lubm_q2", "lubm_q6")]
    for strategy in ("auto", "walk", "wcoj"):
        for device in ("auto", "host", "device"):
            for ratio, floor in ((4, 8192), (1, 1), (4, 1 << 40)):
                _both(monkeypatch, join_strategy=strategy,
                      join_device=device, wcoj_ratio=ratio,
                      wcoj_min_rows=floor, join_device_min_candidates=floor)
                for w, text in shapes:
                    q, jq = _planned(w, text)
                    pats, jpats = (q.pattern_group.patterns,
                                   jq.pattern_group.patterns)
                    pl, jpl = Planner(w["stats"]), JPlanner(w["jstats"])
                    assert pl.choose_strategy(pats) == \
                        jpl.choose_strategy(jpats), (strategy, text[-60:])
                    assert pl.choose_join_route(pats) == \
                        jpl.choose_join_route(jpats), (device, text[-60:])


# ---------------------------------------------------------------------------
# the proxy at default knobs: routing and feedback, call after call
# ---------------------------------------------------------------------------

def _decision(q):
    return (getattr(q, "join_strategy", None), getattr(q, "join_route", None),
            getattr(q, "template_route", None), _levels(q),
            bool(getattr(q, "_template_compiled", False)))


def _serve_equal(proxy, jproxy, texts, calls=3):
    """Serve each text ``calls`` times through both proxies; every call's
    decisions and rows (in order on the template route) must agree.
    Returns each text's decision sequence."""
    seqs = {}
    for name, text in texts.items():
        seq = []
        for _ in range(calls):
            q = proxy.serve_query(text)
            jq = jproxy.serve_query(text, blind=False)
            assert _decision(q) == _decision(jq), (name, len(seq))
            assert int(q.result.status_code) == int(jq.result.status_code)
            rows = np.asarray(q.result.table).tolist()
            jrows = np.asarray(jq.result.table).tolist()
            if _decision(q)[4]:
                assert rows == jrows, name
            else:
                assert sorted(map(tuple, rows)) == \
                    sorted(map(tuple, jrows)), name
            seq.append(_decision(q)[:3])
        seqs[name] = seq
    return seqs


@pytest.mark.parametrize("scale", [3, 10])
def test_proxy_routes_equal_jax_on_lubm(lubm, scale):
    proxy, jproxy = _proxies(lubm[scale], jax_tpu=True)
    before = (_series(get_registry()), _series(jget_registry()))
    seqs = _serve_equal(proxy, jproxy, chip_smoke.QUERIES)
    after = (_series(get_registry()), _series(jget_registry()))
    assert _delta(before[0], after[0]) == _delta(before[1], after[1])
    if scale == 10:
        # the first call routes wcoj, measured blowup demotes to the walk
        for name in ("lubm_q1", "lubm_q2"):
            assert seqs[name][0][0] == "wcoj"
            assert all(s[0] == "walk" for s in seqs[name][1:])
        assert seqs["lubm_q1"][0][1] == "device"
        assert seqs["lubm_q6"] == [("walk", None, "device")] * 3
        d = _delta(before[0], after[0])
        assert d[("wukong_join_demotions_total", ())] == 2
        assert d[("wukong_join_route_demotions_total", ())] == 1


def test_proxy_routes_equal_jax_on_worlds(worlds):
    for name in sorted(WORLDS):
        proxy, jproxy = _proxies(worlds[name])
        seqs = _serve_equal(proxy, jproxy, {name: worlds[name]["text"]})
        assert seqs[name][0][0] in ("wcoj", "walk")


# ---------------------------------------------------------------------------
# degradation
# ---------------------------------------------------------------------------

def test_join_materialize_fault_degrades_to_walk(worlds, monkeypatch):
    w = worlds["triangle"]
    _both(monkeypatch, join_strategy="wcoj")
    proxy, jproxy = _proxies(w)
    before = (_series(get_registry()), _series(jget_registry()))
    for mod in (faults, jfaults):
        mod.install(mod.parse_plan("seed=0;join.materialize:transient,count=1"))
    q = proxy.serve_query(w["text"])
    jq = jproxy.serve_query(w["text"], blind=False)
    after = (_series(get_registry()), _series(jget_registry()))
    d = _delta(before[0], after[0])
    assert d == _delta(before[1], after[1])
    assert d[("wukong_join_fallback_total",
              (("reason", "TransientFault"),))] == 1
    assert q.join_strategy == "wcoj" and getattr(q, "join_stats", None) is None
    assert sorted(map(tuple, q.result.table.tolist())) == \
        sorted(map(tuple, jq.result.table.tolist()))
    # the next query materializes and joins
    q2 = proxy.serve_query(w["text"])
    assert _levels(q2) and q2.result.nrows == q.result.nrows


def test_int32_range_degrades_a_device_level_to_host(worlds, monkeypatch):
    """An id past int32 in a level's global list: the device level refuses
    (DeviceRangeError, reason int32_range), the level and the rest of the
    query run on the host kernels, and the rows are the JAX executor's."""
    w = _world("triangle")
    big = 2**31 + 5
    for g in (w["g"], w["jg"]):
        for key in list(g.index):
            if key[1] == 0:  # every predicate's subject list gains big
                g.index[key] = np.append(g.index[key], big)
    _both(monkeypatch, join_device="device")
    before = (_series(get_registry()), _series(jget_registry()))
    q, jq = _planned(w, w["text"])
    WCOJExecutor(w["g"], w["ss"], stats=w["stats"], device="cpu").execute(q)
    JWCOJ(w["jg"], w["jss"], stats=w["jstats"]).execute(jq)
    after = (_series(get_registry()), _series(jget_registry()))
    d = _delta(before[0], after[0])
    assert d == _delta(before[1], after[1])
    assert d[("wukong_join_device_fallback_total",
              (("reason", "int32_range"),))] == 1
    assert _levels(q) == _levels(jq)
    assert [lv["route"] for lv in _levels(q)] == ["host"] * len(_levels(q))
    assert q.result.table.tolist() == jq.result.table.tolist()


def test_kernel_error_reaches_the_caller(worlds, monkeypatch):
    """A RuntimeError raised inside level_probe (what a failed CUDA build,
    launch or run raises) is not answered by a host level or the walk: it
    reaches the caller of serve_query, and no fallback counter moves."""
    w = worlds["triangle"]
    _both(monkeypatch, join_strategy="wcoj", join_device="device")

    def broken(*_a, **_k):
        raise RuntimeError("level_probe kernel launch failed: stand-in")

    monkeypatch.setattr(pwcoj, "level_probe", broken)
    proxy, _jp = _proxies(w)
    before = _series(get_registry())
    with pytest.raises(RuntimeError, match="stand-in"):
        proxy.serve_query(w["text"])
    moved = _delta(before, _series(get_registry()))
    assert not [k for k in moved if "fallback" in k[0]]
    # the same holds on the template route's pair probe
    _both(monkeypatch, join_strategy="walk", template_device="device")
    monkeypatch.setattr(ptc, "level_probe", broken)
    before = _series(get_registry())
    with pytest.raises(RuntimeError, match="stand-in"):
        proxy.serve_query(w["text"])
    moved = _delta(before, _series(get_registry()))
    assert not [k for k in moved if "fallback" in k[0]]
    assert ptc.demotion_report() == {}


@pytest.mark.parametrize("make", [
    lambda w: pwcoj.JoinTableCache(w["g"]),
    lambda w: WCOJExecutor(w["g"], w["ss"], stats=w["stats"]),
    lambda w: ptc.TemplateCompiledEngine(w["g"], w["ss"]),
], ids=["JoinTableCache", "WCOJExecutor", "TemplateCompiledEngine"])
def test_strategy_engines_default_to_the_card(worlds, make):
    """Built with no device, each strategy's engine runs on the card: with
    no card it raises at construction rather than run its device route as
    plain torch on the host."""
    w = worlds["triangle"]
    if torch.cuda.is_available():
        assert make(w).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make(w)
