"""The port's serving-cache observatory against the JAX package's.

The same query texts, planned by each package's proxy over the same LUBM-1
world (built inline from a seed), must get equal ``classify`` verdicts and
keys (the template signature's digest among them); the same reply stream
through both proxies' ``serve_query`` must give equal shadow-cache hit
sequences, ledger rankings and invalidation kills. Every test starts from
clean process-wide observatories and restores any knob it sets.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from wukong_tpu.config import Global as JGlobal
from wukong_tpu.engine.cpu import CPUEngine as JCPUEngine
from wukong_tpu.loader import lubm as jlubm
from wukong_tpu.obs import reuse as jreuse
from wukong_tpu.obs.tsdb import get_tsdb as jget_tsdb
from wukong_tpu.planner.optimizer import Planner as JPlanner
from wukong_tpu.planner.stats import Stats as JStats
from wukong_tpu.runtime.proxy import Proxy as JProxy
from wukong_tpu.serve import result_cache as jresult_cache
from wukong_tpu.store.dynamic import insert_batch_into as jinsert
from wukong_tpu.store.gstore import build_partition as jbuild
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.loader import lubm as plubm
from wukong_tpu_torch.obs import reuse
from wukong_tpu_torch.obs.tsdb import get_tsdb
from wukong_tpu_torch.planner.optimizer import Planner
from wukong_tpu_torch.planner.stats import Stats
from wukong_tpu_torch.runtime.console import Console
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.serve import result_cache
from wukong_tpu_torch.store.dynamic import insert_batch_into
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.types import OUT

torch.set_num_threads(2)

UB = "http://swat.cse.lehigh.edu/onto/univ-bench.owl#"
PREFIX = chip_smoke.PREFIX
DEPT0 = chip_smoke.DEPT0


@pytest.fixture(scope="module")
def worlds():
    jt, _ = jlubm.generate_lubm(1, seed=42)
    pt, _ = plubm.generate_lubm(1, seed=42)
    assert np.array_equal(jt, pt)
    return jt, pt


def _proxies(worlds):
    """Fresh partitions and proxies (writes in a test never leak)."""
    jt, pt = worlds
    jg = jbuild(jt, 0, 1, attr_triples=jlubm.generate_lubm_attrs(1, seed=42))
    pg = build_partition(pt, 0, 1,
                         attr_triples=plubm.generate_lubm_attrs(1, seed=42))
    js = jlubm.VirtualLubmStrings(1, seed=42)
    ps = plubm.VirtualLubmStrings(1, seed=42)
    jproxy = JProxy(jg, js, JCPUEngine(jg, js),
                    planner=JPlanner(JStats.generate(jt)))
    return jproxy, Proxy(pg, ps, device="cpu",
                         planner=Planner(Stats.generate(pt)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "enable_reuse", True)
        monkeypatch.setattr(G, "enable_result_cache", False)
        monkeypatch.setattr(G, "enable_tracing", False)
        monkeypatch.setattr(G, "tsdb_interval_s", 3600)
    reuse.get_reuse().reset()
    jreuse.get_reuse().reset()
    result_cache.reset_divergence()
    jresult_cache.reset_divergence()
    yield
    reuse.get_reuse().reset()
    jreuse.get_reuse().reset()


def light_texts(proxy, per: int = 6) -> list:
    g, ss = proxy.g, proxy.str_server
    out = []
    for pred in ("advisor", "takesCourse", "memberOf", "teacherOf"):
        pid = ss.str2id(f"<{UB}{pred}>")
        anchors = np.asarray(g.get_index(pid, OUT))[:per]
        out += [f"SELECT ?s WHERE {{ ?s <{UB}{pred}> "
                f"{ss.id2str(int(a))} . }}" for a in anchors]
    return out


SHAPES = {
    **chip_smoke.QUERIES, **chip_smoke.EXT_QUERIES,
    "ambiguous": PREFIX + f"""SELECT ?X ?Y WHERE {{
        ?X ub:memberOf {DEPT0} . ?X ub:advisor ?Y .
        ?Y ub:worksFor {DEPT0} . }}""",
    "proved_empty": PREFIX + """SELECT ?X ?Y WHERE {
        ?X ub:takesCourse ?Y . ?Y rdf:type ub:FullProfessor . }""",
    "blind_twin": PREFIX + f"SELECT ?X WHERE {{ ?X ub:memberOf {DEPT0} . }}",
}


def _planned(proxy, text, blind=True):
    q = proxy._parse_text(text)
    proxy._plan_prepared(q, blind, None, tenant="t")
    return q


def test_classify_verdicts_and_keys_equal(worlds):
    jproxy, proxy = _proxies(worlds)
    reasons = set()
    for name, text in list(SHAPES.items()) + [
            (f"light{i}", t) for i, t in enumerate(light_texts(proxy))]:
        for blind in (True, False):
            jk, jr = jreuse.classify(_planned(jproxy, text, blind))
            pk, pr = reuse.classify(_planned(proxy, text, blind))
            assert (pk, pr) == (jk, jr), name
            reasons.add(pr)
    # the cacheable verdict and the structural refusals all occur
    assert {None, "shape", "ambiguous_const"} <= reasons
    assert reuse.UNCACHEABLE_REASONS == jreuse.UNCACHEABLE_REASONS
    assert reuse.INVALIDATION_CAUSES == jreuse.INVALIDATION_CAUSES
    assert reuse.CACHE_INPUTS == jreuse.CACHE_INPUTS


def test_classify_corun_and_knn_keys(worlds, monkeypatch):
    jproxy, proxy = _proxies(worlds)
    text = SHAPES["lubm_q4"]
    for q in (_planned(jproxy, text), _planned(proxy, text)):
        q.corun_enabled = True
    assert reuse.classify(_planned(proxy, text))[1] is None
    q = _planned(proxy, text)
    q.corun_enabled = True
    jq = _planned(jproxy, text)
    jq.corun_enabled = True
    assert reuse.classify(q) == jreuse.classify(jq) == (None, "corun")
    q.corun_enabled = jq.corun_enabled = False
    q.planner_empty = jq.planner_empty = True
    assert reuse.classify(q) == jreuse.classify(jq) == (None,
                                                        "planner_empty")


def _serve_both(jproxy, proxy, seq, writes=None, rows=None):
    """Serve the same (text, tenant) sequence through both proxies; after
    the k-th reply in ``writes`` insert ``rows`` into both stores. Returns
    each side's per-reply shadow verdicts (True = would have hit)."""
    out = ([], [])
    for k, (text, ten) in enumerate(seq):
        for side, (px, obs) in enumerate(((jproxy, jreuse.get_reuse()),
                                         (proxy, reuse.get_reuse()))):
            h0 = obs.shadow.hits
            q = px.serve_query(text, blind=True, tenant=ten)
            assert int(q.result.status_code) == 0
            out[side].append(obs.shadow.hits > h0)
        if writes and k in writes:
            jinsert([jproxy.g], rows, dedup=False)
            insert_batch_into([proxy.g], rows, dedup=False)
    return out


@pytest.mark.parametrize("cap", [4096, 6])
def test_shadow_hit_sequences_equal(worlds, monkeypatch, cap):
    """A Zipfian reply stream with version edges between replies: the two
    shadow caches agree reply by reply, and on every counter."""
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "shadow_cache_size", cap)
    jproxy, proxy = _proxies(worlds)
    texts = light_texts(proxy, per=8)
    texts[1:1] = [SHAPES["x_union"], SHAPES["lubm_q5"]]
    rng = np.random.default_rng(3)
    w = 1.0 / np.arange(1, len(texts) + 1) ** 1.2
    idx = rng.choice(len(texts), size=160, p=w / w.sum())
    seq = [(texts[i], ("gold", "bulk")[k % 2]) for k, i in enumerate(idx)]
    rows = worlds[1][rng.integers(0, len(worlds[1]), 16)]
    jv, pv = _serve_both(jproxy, proxy, seq, writes={40, 41, 90}, rows=rows)
    assert pv == jv and any(pv) and not all(pv)
    ps, js = reuse.get_reuse().shadow.stats(), jreuse.get_reuse().shadow.stats()
    assert ps == js
    assert ps["killed"] > 0 and (cap > 6 or ps["evicts"] > 0)
    pr = reuse.get_reuse().report(k=100)
    jr = jreuse.get_reuse().report(k=100)

    def strip(rep):
        return [{k: v for k, v in r.items() if k != "rate_qps"}
                for r in rep["popularity"]["ranked"]]

    assert strip(pr) == strip(jr)
    assert pr["popularity"]["zipf_alpha"] == jr["popularity"]["zipf_alpha"]
    assert pr["popularity"]["total_reads"] == jr["popularity"]["total_reads"]
    assert pr["uncacheable_by_reason"].get("shape", 0) > 0
    for sig in {r["template"] for r in pr["popularity"]["ranked"]}:
        a = reuse.read_cache_input("template_popularity", template=sig)
        b = jreuse.read_cache_input("template_popularity", template=sig)
        assert (a["reads"], a["cacheable"]) == (b["reads"], b["cacheable"])
        assert (reuse.read_cache_input("uncacheable", template=sig)
                == jreuse.read_cache_input("uncacheable", template=sig))
    assert (reuse.read_cache_input("predicted_hit_rate")
            == jreuse.read_cache_input("predicted_hit_rate"))
    with pytest.raises(KeyError):
        reuse.read_cache_input("bytes_saved")
    with pytest.raises(KeyError):
        reuse.read_cache_input("nope")


def test_ledger_overflow_and_sampling(monkeypatch):
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "reuse_sample_every", 3)
    port = reuse.TemplatePopularityLedger(window=16, max_templates=3)
    jax = jreuse.TemplatePopularityLedger(window=16, max_templates=3)
    names = [f"t{k % 5}" for k in range(40)] + ["t0"] * 20 + ["t1"] * 7
    got = [(port.charge(n, "a", 1), jax.charge(n, "a", 1)) for n in names]
    assert all(a == b for a, b in got)
    assert any(a == reuse.OVERFLOW_TEMPLATE for a, _ in got)
    assert port.zipf_alpha() == jax.zipf_alpha()
    port.note_uncacheable("t1", "partial")
    jax.note_uncacheable("t1", "partial")
    assert port.uncacheable_counts("t1") == jax.uncacheable_counts("t1")
    assert port.verdict("t1")["cacheable"] is jax.verdict("t1")["cacheable"]
    # one probe in three is sampled, the same ones in both
    sp, sj = reuse.ShadowCache(capacity=8), jreuse.ShadowCache(capacity=8)
    po, jo = reuse.ReuseObservatory(), jreuse.ReuseObservatory()
    po.shadow, jo.shadow = sp, sj
    assert [po._probe_seq, jo._probe_seq] == [0, 0]
    for k in range(12):
        sp.probe(("k", k % 4), 1, 3, 24)
        sj.probe(("k", k % 4), 1, 3, 24)
    assert sp.stats() == sj.stats()
    assert sp.invalidate(2, "insert") == sj.invalidate(2, "insert") == 4
    assert sp.invalidate(None, "restore") == sj.invalidate(None,
                                                          "restore") == 0


def test_invalidation_hook_knob_and_mutation_paths(worlds, monkeypatch):
    """Insert batches and vector batches reach maybe_note_invalidation in
    the port as in the JAX package; with the observatory off the hook is
    inert."""
    from wukong_tpu.obs.events import get_journal as jjournal
    from wukong_tpu.vector.vstore import upsert_batch_into as jupsert
    from wukong_tpu_torch.obs.events import get_journal
    from wukong_tpu_torch.vector.vstore import upsert_batch_into

    jproxy, proxy = _proxies(worlds)
    rows = worlds[1][:8]
    get_journal().clear()
    jjournal().clear()
    for inserter, px in ((insert_batch_into, proxy), (jinsert, jproxy)):
        inserter([px.g], rows, dedup=False)
    vids, vecs = np.arange(4), np.ones((4, 8), dtype=np.float32)
    upsert_batch_into([proxy.g], vids, vecs)
    jupsert([jproxy.g], vids, vecs)
    pe = [(e.kind, e.attrs.get("cause"), e.attrs.get("version_to"))
          for e in get_journal().last(10, kind="cache.invalidate")]
    je = [(e.kind, e.attrs.get("cause"), e.attrs.get("version_to"))
          for e in jjournal().last(10, kind="cache.invalidate")]
    assert pe == je and [c for _k, c, _v in pe] == ["insert", "vector"]
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "enable_reuse", False)
    assert reuse.maybe_note_invalidation("insert", version=9) == 0
    assert reuse.maybe_observe_reuse(None, "t", 0) is None


def test_trend_hit_rates_render_and_cache_verb(worlds, capsys):
    jproxy, proxy = _proxies(worlds)
    get_tsdb().reset()
    jget_tsdb().reset()
    get_tsdb().sample_once()
    jget_tsdb().sample_once()
    texts = light_texts(proxy, per=3)
    seq = [(t, "gold") for t in texts * 3]
    _serve_both(jproxy, proxy, seq)
    get_tsdb().sample_once()
    jget_tsdb().sample_once()
    trend, jtrend = reuse.reuse_trend(), jreuse.reuse_trend()
    assert set(trend) == set(jtrend) >= {"reads_per_s", "probes_per_s"}
    rates = reuse.cache_hit_rates()
    assert set(rates) == {"parse", "plan", "shadow"}
    assert (rates["shadow"]["hit_rate"]
            == jreuse.cache_hit_rates()["shadow"]["hit_rate"]
            == pytest.approx(2 / 3))
    text, js = reuse.render_cache(k=4)
    jtext, jjs = jreuse.render_cache(k=4)
    assert js["shadow"] == jjs["shadow"]
    assert js["real"]["cache"]["entries"] == 0 and not js["real"]["enabled"]
    # the rows above TEMPLATES are the same text in both (the rate column
    # below is time-based)
    assert text.split("TEMPLATES")[0] == jtext.split("TEMPLATES")[0]
    Console(proxy).run_command("cache -k 2")
    out = capsys.readouterr().out
    assert out.startswith("wukong-cache") and "SHADOW  hit_rate 66.7%" in out
    Console(proxy).run_command("cache -j")
    assert '"shadow"' in capsys.readouterr().out
