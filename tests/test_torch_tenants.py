"""``Emulator.run_tenants`` on the port (device="cpu", the pool started and
batching on): three short scenarios, normal, chaos and the 2x overload
drill with admission armed, each at most 0.5 s. The checks hold for any
interleaving of the client threads:

- every reply is counted once: by the scenario's per-tenant stats, by the
  SLO tracker and by a wrapper around the proxy;
- normal: no errors, every tenant served;
- chaos (faults at ``proxy.serve`` with p = 0.25): gold and silver alert
  and bulk does not, with one SLO_BURN dump each, each dumped trace JSON
  and carrying its ``fault.injected`` event;
- overload: gold is neither partial nor rejected, bulk is shed.
"""

import json
import threading

import pytest
import torch

import chip_smoke
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.loader.lubm import VirtualLubmStrings, generate_lubm
from wukong_tpu_torch.obs import get_recorder
from wukong_tpu_torch.obs import slo
from wukong_tpu_torch.planner.optimizer import Planner
from wukong_tpu_torch.planner.stats import Stats
from wukong_tpu_torch.runtime.admission import get_admission
from wukong_tpu_torch.runtime.emulator import Emulator
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.store.gstore import build_partition

torch.set_num_threads(2)

KNOBS = ("enable_batching", "enable_admission", "admission_quotas",
         "admission_max_inflight", "enable_tracing", "trace_sample_every",
         "slo_dump_cooldown_s")


@pytest.fixture(scope="module")
def world():
    t, _ = generate_lubm(1, seed=42)
    g = build_partition(t, 0, 1)
    ss = VirtualLubmStrings(1, seed=42)
    proxy = Proxy(g, ss, device="cpu", planner=Planner(Stats.generate(t)))
    light, _heavy = chip_smoke.live_texts(proxy)
    proxy.engine_pool()
    yield proxy, light[:32]
    proxy._pool.stop()
    if proxy._batcher is not None:
        proxy._batcher.close()


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    for name in KNOBS:
        monkeypatch.setattr(Global, name, getattr(Global, name))
    monkeypatch.setattr(Global, "enable_batching", True)
    get_admission().reset()
    yield
    get_admission().reset()


class Counted:
    """Stands for the proxy: counts every call by tenant, raised or not."""

    def __init__(self, proxy):
        self.proxy = proxy
        self.calls: dict = {}
        self._lock = threading.Lock()

    def serve_query(self, text, blind=True, tenant="default"):
        try:
            return self.proxy.serve_query(text, blind=blind, tenant=tenant)
        finally:
            with self._lock:
                self.calls[tenant] = self.calls.get(tenant, 0) + 1


def _run(world, **kw):
    proxy, texts = world
    counted = Counted(proxy)
    out = Emulator(counted).run_tenants(texts, duration_s=0.5, warmup_s=0.0,
                                        seed=3, **kw)
    assert set(out["tenants"]) == {"gold", "silver", "bulk"}
    for name, r in out["tenants"].items():
        counted_once = (r["served"] + r["errors"] + r["partial"]
                        + r["rejected"])
        assert counted_once == counted.calls[name], name
        assert r["slo"]["total"] == counted.calls[name], name
    return out


def test_normal_scenario(world):
    out = _run(world)
    for name, r in out["tenants"].items():
        assert r["errors"] == 0 and r["served"] > 0, name
        assert r["slo"]["spec"] is not None
        assert set(r["slo"]["burn"]) == {"fast", "slow"}
    rows = {r["tenant"]: r for r in out["slo_json"]["tenants"]}
    assert set(rows) >= {"gold", "silver", "bulk"}
    assert out["qps"] > 0 and out["chaos"] is False


def test_chaos_scenario_alerts_and_dumps_once(world):
    out = _run(world, chaos=True, chaos_p=0.25)
    assert out["alerts"]["gold"] >= 1 and out["alerts"]["silver"] >= 1
    assert out["alerts"]["bulk"] == 0
    per = {}
    for d in out["burn_dumps"]:
        per[d["tenant"]] = per.get(d["tenant"], 0) + 1
    assert per == {"gold": 1, "silver": 1}
    dumped = [tr for r, tr in get_recorder().dumps if r == "SLO_BURN"]
    for tr in dumped:
        json.dumps(tr.to_dict())
        assert "fault.injected" in {sp.name for sp in tr.spans}
        assert tr.status == "ERROR"
    assert Global.enable_tracing is False  # restored after the run


def test_overload_scenario_protects_gold(world, monkeypatch):
    monkeypatch.setattr(Global, "enable_admission", True)
    monkeypatch.setattr(Global, "admission_quotas", chip_smoke.TENANT_QUOTAS)
    monkeypatch.setattr(Global, "admission_max_inflight",
                        chip_smoke.TENANT_MAX_INFLIGHT)
    out = _run(world, overload_x=2.0)
    gold = out["tenants"]["gold"]
    assert gold["clients"] == 4 and gold["partial"] == 0
    assert gold["rejected"] == 0 and gold["served"] > 0
    dec = out["admission"]["decisions"]
    assert not any(k.endswith("/gold") and not k.startswith("admit/")
                   for k in dec)
    assert sum(n for k, n in dec.items()
               if k.endswith("/bulk") and not k.startswith("admit/")) > 0
    assert slo.read_admission_input("tenant_inflight").get("gold", 0) == 0
