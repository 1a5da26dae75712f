"""The port's serving plane (result cache, views) against the JAX package's.

Through ``Proxy(device="cpu")`` over LUBM-1 built inline from a seed: a hit
equals the uncached reply byte for byte and is served without a parse; a
version edge invalidates; a view re-keys the entries a write leaves
untouched; concurrent misses collapse onto one execution; and the same
traffic through both packages' proxies gives the same cache counters,
replies and read-mostly drill fields. Every test resets the process-wide
planes and restores any knob it sets, in both packages.
"""

import threading
import time

import numpy as np
import pytest
import torch

from wukong_tpu.config import Global as JGlobal
from wukong_tpu.engine.cpu import CPUEngine as JCPUEngine
from wukong_tpu.loader import lubm as jlubm
from wukong_tpu.obs import reuse as jreuse
from wukong_tpu.runtime.emulator import Emulator as JEmulator
from wukong_tpu.runtime.proxy import Proxy as JProxy
from wukong_tpu.serve import get_serve as jget_serve
from wukong_tpu.serve import result_cache as jresult_cache
from wukong_tpu.store.dynamic import insert_batch_into as jinsert
from wukong_tpu.store.gstore import build_partition as jbuild
from wukong_tpu_torch import serve
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.loader import lubm as plubm
from wukong_tpu_torch.obs import reuse
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.runtime.emulator import Emulator, _replies_identical
from wukong_tpu_torch.runtime.monitor import Monitor
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.serve import get_serve, result_cache
from wukong_tpu_torch.serve.views import ViewRegistry
from wukong_tpu_torch.store.dynamic import insert_batch_into
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.types import OUT

torch.set_num_threads(2)

UB = "http://swat.cse.lehigh.edu/onto/univ-bench.owl#"
KNOBS = ("enable_result_cache", "enable_views", "enable_reuse",
         "view_promote_edges", "views_max", "result_cache_mb",
         "enable_tracing", "tsdb_interval_s")


@pytest.fixture(scope="module")
def triples():
    t, _ = plubm.generate_lubm(1, seed=42)
    return t


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for G in (Global, JGlobal):
        for k in KNOBS:
            monkeypatch.setattr(G, k, getattr(G, k))
        G.enable_reuse = True
        G.enable_tracing = False
        G.tsdb_interval_s = 3600
    for plane, obs in ((get_serve(), reuse.get_reuse()),
                       (jget_serve(), jreuse.get_reuse())):
        plane.reset()
        obs.reset()
    yield
    get_serve().reset()
    jget_serve().reset()


def _cache_on(views=False):
    for G in (Global, JGlobal):
        G.enable_result_cache = True
        G.enable_views = views
        G.view_promote_edges = 1
        G.views_max = 256


def _proxy(triples):
    g = build_partition(triples, 0, 1)
    return Proxy(g, plubm.VirtualLubmStrings(1, seed=42), device="cpu")


def _jproxy(triples):
    g = jbuild(triples, 0, 1)
    js = jlubm.VirtualLubmStrings(1, seed=42)
    return JProxy(g, js, JCPUEngine(g, js))


def texts_of(proxy, per=6):
    g, ss = proxy.g, proxy.str_server
    out = []
    for pred in ("advisor", "takesCourse", "memberOf", "teacherOf"):
        pid = ss.str2id(f"<{UB}{pred}>")
        anchors = np.asarray(g.get_index(pid, OUT))[:per]
        out += [f"SELECT ?s WHERE {{ ?s <{UB}{pred}> "
                f"{ss.id2str(int(a))} . }}" for a in anchors]
    return out


def _uncached(proxy, text, blind=True):
    return Emulator(proxy)._readmostly_oracle(text) if blind else None


def _parse_count():
    snap = get_registry().snapshot().get("wukong_parse_cache_total", {})
    return sum(s["value"] for s in snap.get("series", []))


def test_hit_equals_uncached_and_skips_parse(triples):
    _cache_on()
    proxy = _proxy(triples)
    rc = get_serve().cache
    for text in texts_of(proxy, per=3):
        first = proxy.serve_query(text, blind=True)
        second = proxy.serve_query(text, blind=True)  # filled on the first
        n0 = _parse_count()
        third = proxy.serve_query(text, blind=True)  # zero-parse fast path
        assert _parse_count() == n0
        want = _uncached(proxy, text)
        for q in (first, second, third):
            assert _replies_identical(q, want)
        assert not third.result.table.flags.writeable
        assert third._rc_probe == "hit"
    st = rc.stats()
    assert st["hits"] >= 2 * 12 and st["fills"] == 12
    # an unblind reply is a different key: a miss, then a hit
    t = texts_of(proxy, per=1)[0]
    a = proxy.serve_query(t, blind=False)
    b = proxy.serve_query(t, blind=False)
    assert a._rc_probe == "miss" and b._rc_probe == "hit"
    assert np.array_equal(a.result.table, b.result.table)


def test_version_edge_invalidates(triples):
    _cache_on()
    proxy = _proxy(triples)
    text = texts_of(proxy, per=1)[2]  # the memberOf text
    proxy.serve_query(text, blind=True)
    proxy.serve_query(text, blind=True)
    assert get_serve().cache.stats()["entries"] == 1
    q0 = proxy.serve_query(text, blind=False)
    # a write that ADDS a matching edge: the entry must not serve stale rows
    anchor = q0.result.table  # columns: ?s
    s_new = int(triples[:, 0].max()) + 1
    pid = proxy.str_server.str2id(f"<{UB}takesCourse>")
    obj = int(np.asarray(proxy.g.get_index(pid, OUT))[0])
    insert_batch_into([proxy.g], np.asarray([[s_new, pid, obj]]))
    assert get_serve().cache.stats()["entries"] == 0
    text2 = f"SELECT ?s WHERE {{ ?s <{UB}takesCourse> " \
            f"{proxy.str_server.id2str(obj)} . }}"
    q = proxy.serve_query(text2, blind=False)
    assert s_new in set(q.result.table[:, 0].tolist())
    assert len(anchor) >= 1
    rc = get_serve().cache
    assert rc.stats()["killed"] >= 1


def test_views_rekey_survivors(triples):
    """With views on, a template promoted on its first surviving refill
    keeps its entry across a write that touches nothing it reads."""
    _cache_on(views=True)
    proxy = _proxy(triples)
    text = texts_of(proxy, per=1)[0]  # advisor
    other = np.asarray([[int(triples[:, 0].max()) + 5,
                         proxy.str_server.str2id(f"<{UB}teacherOf>"),
                         int(triples[:, 2].max()) + 5]])
    proxy.serve_query(text, blind=True)
    proxy.serve_query(text, blind=True)  # fill at version v0
    insert_batch_into([proxy.g], other)  # entry dies (no view yet)
    proxy.serve_query(text, blind=True)  # refill at v0+1: promoted
    assert get_serve().views.count() == 1
    insert_batch_into([proxy.g], other + 1)  # untouched: re-keyed
    q = proxy.serve_query(text, blind=True)
    assert q._rc_probe == "hit"
    assert _replies_identical(q, _uncached(proxy, text))
    vs = get_serve().views.stats()
    assert vs["views"][0]["survived"] >= 1
    # a touching write: the entry drops, the reply shows the new row
    a = proxy.serve_query(text, blind=False)
    anchor = proxy.str_server.str2id(text.split()[-3])
    pid = proxy.str_server.str2id(f"<{UB}advisor>")
    s_new = int(triples[:, 0].max()) + 9
    insert_batch_into([proxy.g], np.asarray([[s_new, pid, anchor]]))
    b = proxy.serve_query(text, blind=False)
    assert b._rc_probe == "miss"
    assert b.result.nrows == a.result.nrows + 1


def test_concurrent_requests_collapse(triples, monkeypatch):
    _cache_on()
    proxy = _proxy(triples)
    text = texts_of(proxy, per=1)[1]
    proxy.serve_query(text, blind=True)  # the ledger has seen the template
    get_serve().cache.purge()
    real = proxy._dispatch
    runs = []

    def slow(q, eng, pinned):
        runs.append(1)
        time.sleep(0.3)
        return real(q, eng, pinned)

    monkeypatch.setattr(proxy, "_dispatch", slow)
    replies = []
    threads = [threading.Thread(
        target=lambda: replies.append(proxy.serve_query(text, blind=True)))
        for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(replies) == 6 and len(runs) == 1
    st = get_serve().cache.stats()
    assert st["collapsed"] == 5 and st["inflight"] == 0
    want = _uncached(proxy, text)
    assert all(_replies_identical(q, want) for q in replies)


def test_host_bytes_only_and_edges(triples):
    _cache_on()
    proxy = _proxy(triples)
    text = texts_of(proxy, per=1)[0]
    q = proxy._parse_text(text)
    proxy._plan_prepared(q, True, None)
    rc = get_serve().cache
    served, lease = rc.acquire(q)
    assert not served and lease is not None
    proxy.cpu.execute(q)
    q.result.table = torch.from_numpy(np.asarray(q.result.table))
    r0 = rc.stats()["refused"]
    lease.settle(q)  # a tensor table is refused, the followers still wake
    assert rc.stats()["refused"] == r0 + 1 and rc.stats()["entries"] == 0
    assert rc.stats()["inflight"] == 0
    assert set(result_cache.MUTATION_EDGES) == set(reuse.INVALIDATION_CAUSES)
    assert (set(result_cache.MUTATION_EDGES)
            == set(jresult_cache.MUTATION_EDGES))
    assert result_cache.CONSUMED_INPUTS == jresult_cache.CONSUMED_INPUTS
    # restore purges; the knob off makes notify_mutation inert
    proxy.serve_query(text, blind=True)
    proxy.serve_query(text, blind=True)
    assert rc.stats()["entries"] == 1
    serve.notify_mutation("restore")
    assert rc.stats()["entries"] == 0 and rc.stats()["purges"] >= 1
    purges = rc.stats()["purges"]
    Global.enable_result_cache = False
    serve.notify_mutation("restore")
    assert rc.stats()["purges"] == purges
    assert isinstance(get_serve().views, ViewRegistry)


def test_cache_counters_equal_jax(triples):
    """The same Zipfian traffic with writes, through both packages'
    proxies with the cache and views on: equal replies, equal real-cache
    counters, equal view verdicts, no real-vs-shadow divergence apart from
    the JAX package's own."""
    _cache_on(views=True)
    proxy, jproxy = _proxy(triples), _jproxy(triples)
    texts = texts_of(proxy, per=5)
    rng = np.random.default_rng(11)
    w = 1.0 / np.arange(1, len(texts) + 1) ** 1.2
    seq = rng.choice(len(texts), size=150, p=w / w.sum())
    pool = triples[rng.integers(0, len(triples), 512)]
    for k, i in enumerate(seq):
        a = proxy.serve_query(texts[i], blind=False, tenant="gold")
        b = jproxy.serve_query(texts[i], blind=False, tenant="gold")
        assert _replies_identical(a, b)
        if k % 25 == 24:
            rows = pool[rng.integers(0, len(pool), 24)]
            insert_batch_into([proxy.g], rows, dedup=False)
            jinsert([jproxy.g], rows, dedup=False)
    ps, js = get_serve().cache.stats(), jget_serve().cache.stats()
    for k in ("hits", "misses", "fills", "killed", "entries", "refused",
              "collapsed", "purges"):
        assert ps[k] == js[k], k
    pv, jv = get_serve().views.stats(), jget_serve().views.stats()
    for k in ("registered", "promoted", "rejected", "demoted", "banned"):
        assert pv[k] == jv[k], k
    assert ([(v["edges"], v["touched"], v["survived"]) for v in pv["views"]]
            == [(v["edges"], v["touched"], v["survived"])
                for v in jv["views"]])
    assert result_cache.divergence_total() == \
        jresult_cache.divergence_total()
    lines = Monitor().cache_lines()
    assert lines[0].startswith("Cache[real ") and \
        lines[1].startswith("Cache[shadow ")


@pytest.mark.parametrize("cached", [False, True], ids=["shadow", "cached"])
def test_run_readmostly_equals_jax(triples, cached):
    """Emulator.run_readmostly at LUBM-1: the fields a seed fixes equal the
    JAX emulator's (times and rates excluded)."""
    if cached:
        for G in (Global, JGlobal):
            G.view_promote_edges = 1
            G.views_max = 256
    proxy, jproxy = _proxy(triples), _jproxy(triples)
    texts = texts_of(proxy, per=16)
    rng = np.random.default_rng(7)
    pool = triples[rng.integers(0, len(triples), 1024)]
    kw = dict(reads=120, warmup_reads=60, write_rates=(0.0, 0.02, 0.08),
              zipf_a=1.2, seed=7, write_batch=pool, tenants=["gold", "bulk"],
              cached=cached, views=cached)
    got = Emulator(proxy).run_readmostly(texts, **kw)
    want = JEmulator(jproxy).run_readmostly(texts, **kw)
    # (uncacheable_by_reason reads a process-wide counter, which other
    # tests in the same worker move)
    for k in ("predicted_hit_rate", "degrades", "store_untouched",
              "zipf_alpha", "bytes_saved"):
        assert got[k] == want[k], k
    fields = ("write_rate", "reads", "served", "errors", "writes", "probes",
              "hits", "hit_rate", "keys_killed")
    if cached:
        fields += ("real_probes", "real_hits", "real_hit_rate",
                   "real_killed")
    for a, b in zip(got["phases"], want["phases"]):
        assert {k: a[k] for k in fields} == {k: b[k] for k in fields}
    assert got["predicted_hit_rate"] >= 0.5
    if cached:
        for k in ("identical", "mismatches", "hit_rate", "shadow_predicted",
                  "beats_shadow", "hit_rate_drop_pts", "views_enabled"):
            assert got["real"][k] == want["real"][k], k
        assert got["real"]["identical"] and got["real"]["beats_shadow"]
        assert (got["real"]["views"]["promoted"]
                == want["real"]["views"]["promoted"] > 0)


def test_view_frontier_error_reaches_the_writer(triples, monkeypatch):
    """A promoted view's epoch frontier runs on the proxy's device; an
    error there (other than ids past int32) reaches the writer of the
    batch, where the JAX registry would latch host."""
    from wukong_tpu_torch.join import kernels as K

    _cache_on(views=True)
    proxy = _proxy(triples)
    text = texts_of(proxy, per=1)[0]
    other = np.asarray([[int(triples[:, 0].max()) + 5,
                         proxy.str_server.str2id(f"<{UB}teacherOf>"),
                         int(triples[:, 2].max()) + 5]])
    proxy.serve_query(text, blind=True)
    proxy.serve_query(text, blind=True)
    insert_batch_into([proxy.g], other)
    proxy.serve_query(text, blind=True)
    assert get_serve().views.count() == 1
    for G in (Global,):
        monkeypatch.setattr(G, "template_device", "device")
    insert_batch_into([proxy.g], other + 1)  # the device path, no error
    assert proxy.serve_query(text, blind=True)._rc_probe == "hit"

    def boom(*a, **k):
        raise RuntimeError("CUDA error: device-side assert triggered")

    monkeypatch.setattr(K, "seed_extract", boom)
    with pytest.raises(RuntimeError, match="device-side assert"):
        insert_batch_into([proxy.g], other + 2)
    monkeypatch.setattr(Global, "template_device", "host")
    insert_batch_into([proxy.g], other + 3)  # the host masks serve again
