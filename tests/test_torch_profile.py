"""The port's EXPLAIN / EXPLAIN ANALYZE and latency attribution
(obs/profile.py; device="cpu": every kernel's plain version) against the
JAX package's on the same LUBM-1 store, built inline, mirroring
tests/test_profile.py.

- EXPLAIN of each of the 19 shapes of tests/test_torch_query_shapes.py
  (the extended suite and its MORE shapes) and of the seven basic shapes,
  under the cost-based planner, equals the JAX report field by field; only
  ``rendered`` may differ.
- EXPLAIN ANALYZE of the same shapes: the same status, rows, completeness,
  estimates, event counts, and each host step's ``rows_in`` and
  ``rows_out`` (the JAX TPU engine's ``tpu.host_step`` spans against the
  port's ``gpu.host_step``); the decomposition's components sum to at most
  the total.
- ``decompose`` attributes a fused member through its group's
  ``batch.settled``; the latency attributor's verdicts equal the JAX one's
  on the same traces; ``template_key`` equals the JAX key.
"""

import pytest
import torch

import chip_smoke
from test_torch_query_shapes import MORE
from test_wcoj import LUBM_PREFIX
from wukong_tpu.config import Global as JGlobal
from wukong_tpu.engine.cpu import CPUEngine as JCPUEngine
from wukong_tpu.engine.tpu import TPUEngine
from wukong_tpu.loader import lubm as jlubm
from wukong_tpu.obs import profile as jprofile
from wukong_tpu.obs import trace as jtrace
from wukong_tpu.planner.optimizer import Planner as JPlanner
from wukong_tpu.planner.stats import Stats as JStats
from wukong_tpu.runtime.proxy import Proxy as JProxy
from wukong_tpu.store.gstore import build_partition as jbuild
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.loader import lubm as plubm
from wukong_tpu_torch.obs import get_recorder, get_registry
from wukong_tpu_torch.obs import profile
from wukong_tpu_torch.obs import trace as ptrace
from wukong_tpu_torch.planner.optimizer import Planner
from wukong_tpu_torch.planner.stats import Stats
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.utils.errors import ErrorCode

torch.set_num_threads(2)

SHAPES = {**{n: t for n, t in chip_smoke.EXT_QUERIES.items()},
          **{n: LUBM_PREFIX + t for n, t in MORE.items()}}
BASIC = chip_smoke.QUERIES
Q_CHAIN = chip_smoke.PREFIX + """SELECT ?X ?Y WHERE {
    ?X ub:memberOf ?Y .
    ?Y ub:subOrganizationOf ?Z .
}"""
# keys that name a run, not a result
RUN_KEYS = ("rendered", "trace_id", "total_us", "decomposition")


@pytest.fixture(scope="module")
def world():
    jt, _ = jlubm.generate_lubm(1, seed=42)
    jg = jbuild(jt, 0, 1, attr_triples=jlubm.generate_lubm_attrs(1, seed=42))
    jss = jlubm.VirtualLubmStrings(1, seed=42)
    pt, _ = plubm.generate_lubm(1, seed=42)
    g = build_partition(pt, 0, 1,
                        attr_triples=plubm.generate_lubm_attrs(1, seed=42))
    ss = plubm.VirtualLubmStrings(1, seed=42)
    jproxy = JProxy(jg, jss, cpu_engine=JCPUEngine(jg, jss),
                    tpu_engine=TPUEngine(jg, jss),
                    planner=JPlanner(JStats.generate(jt)))
    proxy = Proxy(g, ss, device="cpu", planner=Planner(Stats.generate(pt)))
    return {"jproxy": jproxy, "proxy": proxy, "g": g, "ss": ss}


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    """The planner on in both packages; the wcoj and compiled-template
    routes off in both (these reports hold the walk's host steps; the
    strategies' reports are held in test_torch_wcoj.py and
    test_torch_template.py) and the device observatory off in both (its
    dispatch records carry each engine's own site names and times);
    tracing and attribution off, recorders clean."""
    from wukong_tpu.obs import get_recorder as jget_recorder

    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "enable_planner", True)
        monkeypatch.setattr(G, "enable_tracing", False)
        monkeypatch.setattr(G, "enable_attribution", False)
        monkeypatch.setattr(G, "enable_batching", False)
        monkeypatch.setattr(G, "join_strategy", "walk")
        monkeypatch.setattr(G, "template_device", "host")
        monkeypatch.setattr(G, "enable_device_obs", False)
    get_recorder().clear()
    jget_recorder().clear()
    profile.get_attributor().reset()
    yield
    profile.get_attributor().reset()


def _strip(report):
    out = {k: v for k, v in report.items() if k not in RUN_KEYS}
    out["steps"] = [{k: v for k, v in s.items() if k != "time_us"}
                    for s in report["steps"]]
    return out


# ---------------------------------------------------------------------------
# EXPLAIN and EXPLAIN ANALYZE against the JAX reports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SHAPES) + sorted(BASIC))
def test_explain_report_equals_jax(world, name):
    text = SHAPES.get(name) or BASIC[name]
    got = world["proxy"].explain_query(text)
    want = world["jproxy"].explain_query(text)
    assert got["mode"] == "EXPLAIN"
    assert _strip(got) == _strip(want)
    assert got["rendered"].splitlines()[0] == "EXPLAIN"


@pytest.mark.parametrize("name", sorted(SHAPES) + sorted(BASIC))
def test_analyze_rows_and_host_steps_equal_jax(world, name):
    text = SHAPES.get(name) or BASIC[name]
    got = world["proxy"].explain_query(text, analyze=True)
    want = world["jproxy"].explain_query(text, analyze=True)
    assert got["mode"] == want["mode"] == "EXPLAIN ANALYZE"
    assert _strip(got) == _strip(want)
    for k in ("status", "rows", "complete"):
        assert got[k] == want[k], k
    d = got["decomposition"]
    assert sum(d["components"].values()) <= d["total_us"]
    assert d["total_us"] == got["total_us"]
    assert get_recorder().find(got["trace_id"]) is not None
    # the host steps' actuals come from the trace: the same spans as JAX
    tr = get_recorder().find(got["trace_id"])
    from wukong_tpu.obs import get_recorder as jget_recorder

    jtr = jget_recorder().find(want["trace_id"])
    steps = [(s.attrs["step"], s.attrs["rows_in"], s.attrs["rows_out"])
             for s in tr.spans if s.name in profile.STEP_SPANS]
    jsteps = [(s.attrs["step"], s.attrs["rows_in"], s.attrs["rows_out"])
              for s in jtr.spans if s.name in jprofile.STEP_SPANS]
    assert steps == jsteps


def test_analyze_renders_and_covers_the_chain(world):
    r = world["proxy"].explain_query(Q_CHAIN, analyze=True)
    assert r["status"] == "SUCCESS"
    assert r["decomposition"]["components"]["execute"] > 0
    assert "latency:" in r["rendered"] and "est_rows" in r["rendered"]
    host = world["proxy"].explain_query(Q_CHAIN, analyze=True, device="cpu")
    # the host engine runs every step: each step has its actuals
    for k, s in enumerate(host["steps"]):
        assert s["step"] == k and s["rows_out"] is not None
    assert host["steps"][-1]["rows_out"] == host["rows"]


def test_explain_without_planner_renders_dashes(world, monkeypatch):
    monkeypatch.setattr(Global, "enable_planner", False)
    r = world["proxy"].explain_query(Q_CHAIN)
    assert r["planner"] == "heuristic/none"
    assert all("est_rows" not in s for s in r["steps"])
    assert "-" in r["rendered"]


def test_console_explain_and_analyze_verbs(world, tmp_path, capsys):
    from wukong_tpu_torch.runtime.console import Console

    qf = tmp_path / "q.sparql"
    qf.write_text(Q_CHAIN)
    con = Console(world["proxy"])
    con.run_command(f"analyze -f {qf} -d cpu")
    out = capsys.readouterr().out
    assert "EXPLAIN ANALYZE" in out and "latency:" in out
    con.run_command(f"explain -f {qf} -j")
    assert '"mode": "EXPLAIN"' in capsys.readouterr().out
    con.run_command("explain")  # usage error, the console lives on
    con.run_command("trace -n 4")
    assert "qid=" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# decomposition of a fused member, the attributor, template keys
# ---------------------------------------------------------------------------

def test_batched_member_attribution(world):
    from wukong_tpu_torch.runtime.batcher import (
        FusedGroup,
        QueryBatcher,
        _Pending,
    )

    proxy = world["proxy"]
    light, _heavy = chip_smoke.live_texts(proxy)
    members = []
    for t in light[:3]:
        tr = ptrace.QueryTrace(kind="query", text=t)
        members.append(_Pending(proxy._prepare(t, True, None, "default",
                                               tr, None)))
    b = QueryBatcher(proxy.cpu, proxy.gpu)
    try:
        FusedGroup(members, b, engine=proxy.gpu).run(None)
    finally:
        b.close()
    for m in members:
        assert m.q.result.status_code == ErrorCode.SUCCESS
        m.trace.finish("SUCCESS")
        settled = [sp.attrs for sp in m.trace.spans
                   if sp.name == "batch.settled"]
        assert settled and settled[0]["dispatch_us"] > 0
        d = profile.decompose(m.trace)
        assert d["components"]["execute"] == settled[0]["dispatch_us"]


def _fake(mod, total_us, parse_us, execute_us, exec_name):
    tr = mod.QueryTrace(kind="query")
    sp = tr.start_span("proxy.parse")
    tr.end_span(sp)
    sp.t1_us = sp.t0_us + parse_us
    sp2 = tr.start_span(exec_name)
    tr.end_span(sp2)
    sp2.t1_us = sp2.t0_us + execute_us
    tr.finish("SUCCESS")
    tr.t1_us = tr.t0_us + total_us
    return tr


SERIES = ([(1000, 100, 850)] * 10 + [(5000, 120, 4800)]
          + [(1000, 100, 850)] * 3 + [(1000, 600, 350)])


@pytest.mark.parametrize("share, p95", [(25, 100), (25, 10_000), (90, 100)])
def test_attributor_verdicts_equal_jax(monkeypatch, share, p95):
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "attribution_min_samples", 8)
        monkeypatch.setattr(G, "attribution_share_drift_pct", share)
        monkeypatch.setattr(G, "attribution_p95_drift_pct", p95)
        monkeypatch.setattr(G, "attribution_cooldown_s", 0)
    att = profile.LatencyAttributor(window=64)
    jatt = jprofile.LatencyAttributor(window=64)
    got, want = [], []
    for (total, parse, execute) in SERIES:
        for a, mod, name, out in ((att, ptrace, "gpu.execute", got),
                                  (jatt, jtrace, "tpu.execute", want)):
            v = a.observe(_fake(mod, total, parse, execute, name), "T")
            out.append(None if v is None else
                       {k: v[k] for k in ("reason", "component",
                                          "share_drift_pts", "total_us",
                                          "baseline_p95_us")})
    assert got == want and any(got)
    assert [{k: v for k, v in r.items() if k != "example"}
            for r in att.report()] == \
        [{k: v for k, v in r.items() if k != "example"}
         for r in jatt.report()]
    dumps = [r for r, _t in get_recorder().dumps]
    assert dumps.count("LATENCY_REGRESSION") == sum(v is not None
                                                    for v in got)
    assert get_registry().counter(
        "wukong_latency_regressions_total",
        labels=("template",)).value(template="T") >= 1


@pytest.mark.parametrize("name", ["lubm_q3", "lubm_q5", "lubm_q1"])
def test_template_key_equals_jax(world, name):
    text = BASIC[name]
    q = world["proxy"]._parse_text(text)
    jq = world["jproxy"]._parse_text(text)
    assert profile.template_key(q, text) == jprofile.template_key(jq, text)


def test_attribution_via_proxy(world, monkeypatch):
    monkeypatch.setattr(Global, "enable_tracing", True)
    monkeypatch.setattr(Global, "enable_attribution", True)
    for _ in range(3):
        q = world["proxy"].run_single_query(Q_CHAIN, blind=True)
        assert q.result.status_code == ErrorCode.SUCCESS
    [row] = profile.get_attributor().report()
    assert row["count"] == 3 and row["top_component"] == "execute"
    assert row["template"].startswith("sig:")


def test_attribution_off_is_untouched(world, monkeypatch):
    monkeypatch.setattr(Global, "enable_tracing", True)
    world["proxy"].run_single_query(Q_CHAIN, blind=True)
    assert profile.get_attributor().report() == []


# ---------------------------------------------------------------------------
# render_top (the `top` verb, GET /top)
# ---------------------------------------------------------------------------

def _top_sections(text):
    """The shards and templates sections (the caches line and the lanes
    read each package's process-wide counters)."""
    return text.split("  caches:")[0]


@pytest.mark.parametrize("k", [None, 2])
def test_render_top_equals_jax(monkeypatch, k):
    from wukong_tpu.obs import heat as jheat
    from wukong_tpu_torch.obs import heat

    class Clock:
        def __init__(self):
            self.t = 5_000_000

        def __call__(self):
            self.t += 333
            return self.t

    for mod in (heat, jheat):
        monkeypatch.setattr(mod, "get_usec", Clock())
        mod.get_heat().reset()
    jprofile.get_attributor().reset()
    try:
        for args in ((0, "vector", 5000, 320000, 900),
                     (1, "primary", 10, 80, 15),
                     (0, "vector", 4000, 256000, 700),
                     (2, "failover", 7, 56, 2000)):
            heat.get_heat().charge(*args)
            jheat.get_heat().charge(*args)
        for tmpl, rows in (("T1", SERIES), ("T2", SERIES[:5])):
            for (total, parse, execute) in rows:
                profile.get_attributor().observe(
                    _fake(ptrace, total, parse, execute, "gpu.execute"), tmpl)
                jprofile.get_attributor().observe(
                    _fake(jtrace, total, parse, execute, "tpu.execute"), tmpl)
        text, js = profile.render_top(k)
        jtext, jjs = jprofile.render_top(k)
        assert js["shards"] == jjs["shards"]
        strip = ("example",)
        assert [{a: b for a, b in r.items() if a not in strip}
                for r in js["templates"]] == \
            [{a: b for a, b in r.items() if a not in strip}
             for r in jjs["templates"]]
        assert _top_sections(text) == _top_sections(jtext)
        assert set(js) == set(jjs) == {"shards", "templates", "lanes",
                                       "caches"}
        assert set(js["caches"]) == set(jjs["caches"])
        assert "LANES" in text and js["shards"]["ranked"][0]["shard"] == 0
    finally:
        for mod in (heat, jheat):
            mod.get_heat().reset()
        jprofile.get_attributor().reset()


def test_lane_depths_reads_the_pool_gauges():
    from wukong_tpu_torch.runtime.scheduler import EnginePool

    class Echo:
        def execute(self, q):
            return q

    pool = EnginePool(num_engines=2, make_engine=lambda t: Echo())
    pool.start()
    try:
        qids = [pool.submit(i) for i in range(4)]
        for qid in qids:
            pool.wait(qid, timeout=5)
        lanes = profile._lane_depths()
        assert lanes["queue_depth"] == 0
        assert lanes["submitted[default]"] >= 4
        assert "depth[batch]" in lanes
    finally:
        pool.stop()
