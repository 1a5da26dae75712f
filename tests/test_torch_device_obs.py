"""The port's device-cost observatory (wukong_tpu_torch/obs/device.py)
against the JAX package's, on the same charges (device="cpu": the device
routes run their plain PyTorch versions).

- Ledger readings equal to the JAX ones on one dispatch sequence, with the
  padding efficiency hand-computed across pad_pow2 classes; residency
  bytes across a store-version invalidation (one edge per kind); the
  variant-storm sentinel once per cooldown with its journal event.
- ``read_device_input``'s contract: undeclared and metric-only signals
  raise KeyError, live signals read the same values as the JAX reader.
- The surfaces on a device-routed triangle query: the ``device`` console
  verb, ``Monitor.device_lines``, EXPLAIN ANALYZE's device table (each
  WCOJ probe group's site, capacity, live rows and temperature equal to
  the JAX proxy's), and off-knob zero-touch.
"""

import json

import numpy as np
import pytest
import torch

from wukong_tpu.config import Global as JGlobal
from wukong_tpu.engine.cpu import CPUEngine as JCPUEngine
from wukong_tpu.join.wcoj import JoinTableCache as JJoinTableCache
from wukong_tpu.loader import datagen as jdg
from wukong_tpu.obs import device as jdev
from wukong_tpu.obs.events import get_journal as jget_journal
from wukong_tpu.planner.optimizer import Planner as JPlanner
from wukong_tpu.planner.stats import Stats as JStats
from wukong_tpu.runtime.proxy import Proxy as JProxy
from wukong_tpu.store.gstore import build_partition as jbuild
from wukong_tpu_torch.analysis import lockdep
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine import template_compile as ptc
from wukong_tpu_torch.join.kernels import pad_pow2
from wukong_tpu_torch.join.wcoj import JoinTableCache
from wukong_tpu_torch.loader import datagen as pdg
from wukong_tpu_torch.obs import device as pdev
from wukong_tpu_torch.obs.events import get_journal
from wukong_tpu_torch.obs.metrics import get_registry, snapshot_labeled_value
from wukong_tpu_torch.planner.optimizer import Planner
from wukong_tpu_torch.planner.stats import Stats
from wukong_tpu_torch.runtime.console import Console
from wukong_tpu_torch.runtime.monitor import Monitor
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.store.gstore import build_partition

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _lockdep_checked():
    """The ledgers' locks are leaves: the module runs with the lock-order
    checker on for every lock it creates, and ends with no cycle and no
    leaf violation."""
    lockdep.install(True)
    yield
    try:
        assert lockdep.cycles() == [], lockdep.cycles()
        assert lockdep.leaf_violations() == [], lockdep.leaf_violations()
    finally:
        lockdep.install(False)


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    """The observatory and the journal on and clean in both packages, and
    the template demotion latches empty."""
    from wukong_tpu.engine import template_compile as jtc

    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "enable_device_obs", True)
        monkeypatch.setattr(G, "enable_events", True)
    for mod in (pdev, jdev):
        mod.get_device_obs().reset()
    get_journal().clear()
    jget_journal().clear()
    ptc.reset_demotions()
    jtc.reset_demotions()
    yield
    for mod in (pdev, jdev):
        mod.get_device_obs().reset()
    ptc.reset_demotions()
    jtc.reset_demotions()


# (site, template, live, capacity, wall_us, nbytes, count)
SEQUENCE = [
    ("t.probe", "p1", 1, pad_pow2(1), 10, 100, 1),
    ("t.probe", "p1", 700, pad_pow2(700), 12, 0, 1),
    ("t.probe", "p1", 1025, pad_pow2(1025), 30, 8, 1),
    ("t.probe", "p2g", 5000, pad_pow2(5000), 7, 0, 1),
    ("t.chain", "d2", 500, 1024, 100, 16, 1),
    ("t.chain", "d2", 500, 1024, 100, 0, 2),
    ("t.empty", "e", 0, 0, 5, 0, 1),
    ("t.allpad", "a", 0, 1024, 5, 0, 1),
]


def _charge_both():
    got, want = [], []
    for site, tmpl, live, cap, wall, nb, count in SEQUENCE:
        got.append(pdev.maybe_device_dispatch(
            site, template=tmpl, live=live, capacity=cap, wall_us=wall,
            nbytes=nb, count=count))
        want.append(jdev.maybe_device_dispatch(
            site, template=tmpl, live=live, capacity=cap, wall_us=wall,
            nbytes=nb, count=count))
    return got, want


def test_ledger_readings_equal_jax():
    got, want = _charge_both()
    assert got == want
    assert [pad_pow2(n) for n in (1, 700, 1025, 5000)] == [1024, 1024,
                                                          2048, 8192]
    # hand-computed: live / padded over every charged dispatch of a site
    eff = pdev.read_device_input("padding_efficiency", site="t.probe")
    assert eff == pytest.approx((1 + 700 + 1025 + 5000)
                                / (1024 + 1024 + 2048 + 8192))
    chain = pdev.read_device_input("padding_efficiency", site="t.chain")
    assert chain == pytest.approx(1000 / (1024 + 2 * 1024))
    assert pdev.read_device_input("padding_efficiency",
                                  site="t.allpad") == 0.0
    assert pdev.read_device_input("padding_efficiency",
                                  site="t.empty") is None
    prep = pdev.get_device_obs().report(16)
    jrep = jdev.get_device_obs().report(16)
    assert prep == jrep
    assert prep["dispatches"] == {"count": 9, "cold": 6, "warm": 3,
                                  "wall_us": 269}
    assert prep["variants"] == {"t.probe": 3, "t.chain": 1, "t.empty": 1,
                                "t.allpad": 1}


def test_residency_across_version_invalidation(monkeypatch):
    """JoinTableCache device-table fills charge their bytes; a store
    version bump reaps the stale tables as ONE invalidate edge with their
    summed bytes; the high-water survives; the JAX cache reads the same."""
    class Store:
        version = 7

    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "join_table_cache", 64)
    stores = (Store(), Store())
    caches = (JoinTableCache(stores[0], device="cpu"),
              JJoinTableCache(stores[1]))
    a = np.zeros(100, dtype=np.int32)  # 400 B each, 1,200 B an entry
    readings = []
    for cache, store, dev in zip(caches, stores, (pdev, jdev)):
        snap0 = (get_registry() if dev is pdev
                 else jdev.get_registry()).snapshot()
        cache._put((7, "dseg", 11, 0), (a, a, a, 2))
        cache._put((7, "dseg", 12, 0), (a, a, a, 3))
        first = dev.get_device_obs().residency.totals()
        store.version = 8
        cache._put((8, "dseg", 11, 0), (a, a, a, 2))
        snap1 = (get_registry() if dev is pdev
                 else jdev.get_registry()).snapshot()
        inv = [snapshot_labeled_value(s, "wukong_device_residency_total",
                                      kind="join_table", event="invalidate")
               for s in (snap0, snap1)]
        after = (dev.read_device_input("resident_bytes"),
                 dev.read_device_input("residency_high_water"))
        # a second invalidate on the same version drops the bytes but
        # counts no second edge
        res = dev.get_device_obs().residency
        again = res.invalidate("join_table", 1200, version=8)
        readings.append((first, *after, inv[1] - inv[0], again,
                         res.totals()))
    assert readings[0] == readings[1]
    assert readings[0] == ({"join_table": 2400}, {"join_table": 1200},
                           2400, 1, False, {"join_table": 0})


def test_residency_lru_evict_and_budget(monkeypatch):
    class Store:
        version = 7

    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "join_table_cache", 2)
        monkeypatch.setattr(G, "device_budget_mb", 1)
    a = np.zeros(64, dtype=np.int32)  # 768 B an entry
    for cache, dev in ((JoinTableCache(Store(), device="cpu"), pdev),
                       (JJoinTableCache(Store()), jdev)):
        for i in range(3):
            cache._put((7, "dseg", i, 0), (a, a, a, 2))
        assert dev.get_device_obs().residency.totals() == {
            "join_table": 2 * 768}
        dev.maybe_device_resident("fill", "segment", 2 << 20)
        assert dev.get_device_obs().residency.stats()["over_budget"]
        assert "OVER BUDGET" in dev.render_device()[0]


# chain syncs: (site, [(step, total, cap)], wall_us, nbytes)
CHAIN_SYNCS = [
    ("t.steps", [(0, 3, 1024), (1, 900, 1024), (2, 5000, 4096)], 301, 44),
    ("t.steps", [(0, 3, 1024), (1, 2000, 1024), (2, 5000, 4096)], 90, 0),
    ("t.steps", [(1, 7, 0), (2, 7, 2048)], 5, 12),
    ("t.steps.storm", [(k, k, 1024 << k) for k in range(5)], 50, 8),
]


def test_charge_steps_equals_jax_chain_charge(monkeypatch):
    """``charge_steps`` (one sync, two ledger locks) leaves the records,
    ledgers, metric series and storm event that the JAX engine's
    ``_charge_chain`` leaves with one charge a step: warm and cold steps,
    an overflowed total, a zero-capacity step, and storms, one of them
    tripped part way through one sync."""
    from wukong_tpu.engine.tpu import _charge_chain as jcharge_chain
    from wukong_tpu.obs.metrics import get_registry as jget_registry

    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "device_variant_limit", 3)
        monkeypatch.setattr(G, "device_storm_cooldown_s", 60.0)

    class Q:
        pass

    pq, jq = Q(), Q()
    for site, steps, wall, nbytes in CHAIN_SYNCS:
        pdev.charge_steps(site, steps, wall, nbytes=nbytes, q=pq)
        jcharge_chain(jq, site, steps, wall, nbytes)
    assert pq.device_steps == jq.device_steps
    assert len(pq.device_steps) == 13
    assert pdev.get_device_obs().report(64) == \
        jdev.get_device_obs().report(64)

    def series(reg):
        snap = reg.snapshot()
        return {(name, tuple(sorted(e["labels"].items()))):
                {k: v for k, v in e.items() if k != "labels"}
                for name in pdev.DEVICE_INPUTS.values()
                for e in (snap.get(name) or {}).get("series", [])
                if e["labels"].get("site", "").startswith("t.steps")}

    got, want = series(get_registry()), series(jget_registry())
    assert got == want and got
    storm = get_journal().last(kind="device.variant_storm")
    jstorm = jget_journal().last(kind="device.variant_storm")
    assert [e.attrs for e in storm] == [e.attrs for e in jstorm]
    # each site trips once, at its fourth mint; the storm site's trip
    # falls inside one sync, before its fifth step mints
    assert [(e.attrs["site"], e.attrs["variants_total"])
            for e in storm] == [("t.steps", 4), ("t.steps.storm", 4)]
    # off: no record, no ledger entry
    monkeypatch.setattr(Global, "enable_device_obs", False)
    pdev.charge_steps("t.steps.off", [(0, 1, 1024)], 1, q=pq)
    assert len(pq.device_steps) == 13


def test_storm_once_per_cooldown_with_journal_event(monkeypatch):
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "device_variant_limit", 2)
        monkeypatch.setattr(G, "device_storm_cooldown_s", 60.0)
    for i in range(6):
        pdev.maybe_device_dispatch("t.storm", template=f"v{i}", live=1,
                                   capacity=1024)
        jdev.maybe_device_dispatch("t.storm", template=f"v{i}", live=1,
                                   capacity=1024)
    got = get_journal().last(kind="device.variant_storm")
    want = jget_journal().last(kind="device.variant_storm")
    assert len(got) == len(want) == 1
    assert got[0].attrs == want[0].attrs
    assert got[0].attrs["minted_in_window"] == 3
    snap = get_registry().snapshot()
    assert snapshot_labeled_value(snap, "wukong_device_variant_storms_total",
                                  site="t.storm") == 1
    # the ledger alone: trips when the window crosses the limit, then not
    # again until the cooldown elapses; a warm re-dispatch mints nothing
    trips = []
    for mod in (pdev, jdev):
        led = mod.CompileLedger(limit=3, cooldown_s=60.0)
        trips.append([led.note("s", f"t{i}", 1024) for i in range(8)]
                     + [led.note("s", "t0", 1024)])
    assert trips[0] == trips[1]
    assert [i for i, (_c, s) in enumerate(trips[0]) if s is not None] == [3]


def test_read_device_input_contract():
    for name in pdev.DEVICE_INPUTS.values():
        assert name in get_registry().snapshot(), name
    assert pdev.DEVICE_INPUTS == jdev.DEVICE_INPUTS
    for mod in (pdev, jdev):
        with pytest.raises(KeyError):
            mod.read_device_input("no_such_signal")
        with pytest.raises(KeyError):
            mod.read_device_input("bytes_moved")  # metric-backed only
    _charge_both()
    for mod in (pdev, jdev):
        mod.maybe_device_resident("fill", "segment", 4096)
    for signal, site in (("padding_efficiency", None),
                         ("padding_efficiency", "t.chain"),
                         ("dispatches", None), ("dispatches", "t.probe"),
                         ("variants", None), ("variants", "t.probe"),
                         ("resident_bytes", None),
                         ("residency_high_water", None)):
        assert (pdev.read_device_input(signal, site)
                == jdev.read_device_input(signal, site)), signal


# ---------------------------------------------------------------------------
# the surfaces, on a device-routed triangle query
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tri():
    triples, meta = pdg.generate_triangle(m=60, noise=3, seed=1)
    jt, _ = jdg.generate_triangle(m=60, noise=3, seed=1)
    g, jg = build_partition(triples, 0, 1), jbuild(jt, 0, 1)
    ss, jss = pdg.CyclicStrings(meta), jdg.CyclicStrings(meta)
    return (g, ss, Stats.generate(triples)), (jg, jss, JStats.generate(jt)), \
        pdg.cyclic_query_text(meta)


def _proxies(tri):
    (g, ss, st), (jg, jss, jst), text = tri
    return (Proxy(g, ss, device="cpu", planner=Planner(st)),
            JProxy(jg, jss, cpu_engine=JCPUEngine(jg, jss),
                   planner=JPlanner(jst)), text)


def _force_device_wcoj(monkeypatch):
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "wcoj_min_rows", 1)
        monkeypatch.setattr(G, "wcoj_ratio", 1)
        monkeypatch.setattr(G, "join_device", "device")


def test_console_device_verb(tri, monkeypatch, capsys):
    proxy, _jproxy, text = _proxies(tri)
    _force_device_wcoj(monkeypatch)
    proxy.serve_query(text, blind=True)
    con = Console(proxy)
    assert con.run_command("device") is True
    out = capsys.readouterr().out
    assert "wukong-device" in out and "wcoj.probe" in out
    assert con.run_command("device -j -k 2") is True
    js = json.loads(capsys.readouterr().out)
    assert js["dispatches"]["count"] >= 1
    assert len(js["ranked"]) <= 2
    assert js["residency"]["by_kind"].get("join_table", 0) > 0


def test_monitor_device_line(tri, monkeypatch):
    mon = Monitor()
    assert mon.device_lines() == []  # quiet before any charge
    proxy, _jproxy, text = _proxies(tri)
    _force_device_wcoj(monkeypatch)
    proxy.serve_query(text, blind=True)
    lines = mon.device_lines()
    assert len(lines) == 1 and lines[0].startswith("Device[")
    assert "pad_eff" in lines[0] and "resident" in lines[0]


def test_explain_analyze_device_table_equals_jax(tri, monkeypatch):
    """The device table of EXPLAIN ANALYZE on a device-routed triangle:
    one row per WCOJ probe group, each row's site, template, capacity,
    live rows, level and temperature equal to the JAX proxy's."""
    proxy, jproxy, text = _proxies(tri)
    _force_device_wcoj(monkeypatch)
    rep = proxy.explain_query(text, analyze=True)
    jrep = jproxy.explain_query(text, analyze=True)
    assert rep["strategy"] == jrep["strategy"] == "wcoj"
    assert rep["route"] == jrep["route"] == "device"
    keys = ("site", "template", "capacity", "live", "step", "dispatches",
            "temp", "padding_efficiency")
    got = [{k: s[k] for k in keys} for s in rep["device_steps"]]
    want = [{k: s[k] for k in keys} for s in jrep["device_steps"]]
    assert got == want and got
    assert all(s["site"] == "wcoj.probe" for s in got)
    assert [{k: v for k, v in lv.items() if k != "time_us"}
            for lv in rep["wcoj_levels"]] == \
        [{k: v for k, v in lv.items() if k != "time_us"}
         for lv in jrep["wcoj_levels"]]
    rendered = rep["rendered"]
    assert "device:" in rendered and "wcoj.probe" in rendered
    assert "route: device" in rendered


def test_off_knob_is_zero_touch(tri, monkeypatch):
    """enable_device_obs off: the seams return None / do nothing, the
    ledgers stay empty across a device-routed query, and no series of a
    DEVICE_INPUTS metric moves."""
    proxy, _jproxy, text = _proxies(tri)
    _force_device_wcoj(monkeypatch)
    monkeypatch.setattr(Global, "enable_device_obs", False)
    snap0 = get_registry().snapshot()
    assert pdev.maybe_device_dispatch("t.off", template="x", live=1,
                                      capacity=1024) is None
    pdev.maybe_device_resident("fill", "segment", 1 << 20)
    pdev.note_feedback("join_route", "demote_host")
    q = proxy.serve_query(text, blind=True)
    assert q.join_strategy == "wcoj" and q.result.nrows > 0
    obs = pdev.get_device_obs()
    assert obs.dispatch_ledger.report(10) == []
    assert obs.residency.totals() == {}
    assert obs.compile_ledger.variant_counts() == {}
    assert getattr(q, "device_steps", None) is None
    snap1 = get_registry().snapshot()
    for metric in pdev.DEVICE_INPUTS.values():
        assert (snap1.get(metric) or {}).get("series", []) == \
            (snap0.get(metric) or {}).get("series", []), metric
    text_out, js = pdev.render_device()
    assert "enable_device_obs is OFF" in text_out and js["enabled"] is False
