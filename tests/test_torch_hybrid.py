"""knn() queries through the port's proxy (device="cpu": the kNN kernel's plain
version) against the JAX proxy on LUBM-2 with the same embeddings
(make_vectors, seed 0) on professors and graduate students.

- The parser's knn() against the JAX parser: clause fields, mode stamps,
  and the same SPARQLSyntaxError messages.
- A pure ranked scan, rank-then-pattern, pattern-then-rank and a literal
  anchor under knn_device host, device and auto (auto with a low split
  threshold: the device route, sliced across the engine pool): rows equal
  to the JAX proxy's as multisets (the scan's ranked rows, and an ORDER BY
  reply, in order), the same mode and route stamps.
- ATTR_DISABLE with enable_vectors off; the compiled-template route
  refuses a knn query; EXPLAIN's knn section; the drill's demotion latches
  the route memo to host, while any other device failure raises out of
  serve_query; a short run_graphrag serves both kinds with no error.
"""

import collections

import numpy as np
import pytest
import torch

import chip_smoke
from wukong_tpu.config import Global as JGlobal
from wukong_tpu.engine.cpu import CPUEngine as JCPUEngine
from wukong_tpu.engine.tpu import TPUEngine
from wukong_tpu.loader import lubm as jlubm
from wukong_tpu.loader.datagen import make_vectors as jmake_vectors
from wukong_tpu.runtime.proxy import Proxy as JProxy
from wukong_tpu.sparql.parser import Parser as JParser
from wukong_tpu.sparql.parser import SPARQLSyntaxError as JSyntaxError
from wukong_tpu.store.gstore import build_partition as jbuild
from wukong_tpu.vector import knn as jknn
from wukong_tpu.vector.vstore import upsert_batch_into as jupsert
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine.template_compile import extract_template
from wukong_tpu_torch.loader import lubm as plubm
from wukong_tpu_torch.loader.datagen import make_vectors
from wukong_tpu_torch.runtime.emulator import Emulator
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.sparql.parser import Parser, SPARQLSyntaxError
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.types import IN, OUT
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError
from wukong_tpu_torch.vector import knn
from wukong_tpu_torch.vector.vstore import upsert_batch_into

torch.set_num_threads(2)

DIM = 16
UB = "http://swat.cse.lehigh.edu/onto/univ-bench.owl#"
KNOBS = ("enable_vectors", "vector_dim", "knn_device", "knn_split_threshold",
         "knn_metric", "template_device", "join_strategy", "enable_batching",
         "enable_planner")


@pytest.fixture(scope="module")
def world():
    jt, _ = jlubm.generate_lubm(2, seed=0)
    jg = jbuild(jt, 0, 1)
    jss = jlubm.VirtualLubmStrings(2, seed=0)
    pt, _ = plubm.generate_lubm(2, seed=0)
    g = build_partition(pt, 0, 1)
    ss = plubm.VirtualLubmStrings(2, seed=0)
    advisor = ss.str2id(f"<{UB}advisor>")
    gs_type = ss.str2id(f"<{UB}GraduateStudent>")
    profs = np.unique(np.asarray(g.get_index(advisor, OUT), np.int64))
    grads = np.unique(np.asarray(g.get_index(gs_type, IN), np.int64))
    vids = np.union1d(profs, grads)
    vecs = make_vectors(vids, DIM)
    assert np.array_equal(vecs, jmake_vectors(vids, DIM))
    upsert_batch_into([g], vids, vecs)
    jupsert([jg], vids, vecs)
    jproxy = JProxy(jg, jss, cpu_engine=JCPUEngine(jg, jss),
                    tpu_engine=TPUEngine(jg, jss))
    proxy = Proxy(g, ss, device="cpu")
    lit = " ".join(f"{x:.3f}" for x in vecs[3])
    prof, grad = ss.id2str(int(profs[0])), ss.id2str(int(grads[5]))
    texts = {
        "scan": f"SELECT ?x WHERE {{ knn(?x, {prof}, 10) }}",
        "rank_then_pattern": (f"SELECT ?p ?d WHERE {{ knn(?p, {prof}, 8) . "
                              f"?p <{UB}worksFor> ?d }}"),
        "pattern_then_rank": (f"SELECT ?x ?d WHERE {{ ?x <{UB}memberOf> ?d "
                              f". knn(?x, {grad}, 10) }}"),
        "pattern_then_rank_wide": (
            f"SELECT ?x WHERE {{ ?x <http://www.w3.org/1999/02/22-rdf-"
            f"syntax-ns#type> <{UB}GraduateStudent> . "
            f"knn(?x, {grad}, 10, l2) }}"),
        "literal": f"SELECT ?x WHERE {{ knn(?x, ({lit}), 5, dot) }}",
        "ordered": (f"SELECT ?p ?d WHERE {{ knn(?p, {prof}, 8) . "
                    f"?p <{UB}worksFor> ?d }} ORDER BY DESC(?d) ?p"),
    }
    return {"proxy": proxy, "jproxy": jproxy, "g": g, "ss": ss,
            "texts": texts, "profs": profs, "grads": grads}


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    for G in (Global, JGlobal):
        for name in KNOBS:
            monkeypatch.setattr(G, name, getattr(G, name))
        G.enable_vectors = True
        G.vector_dim = DIM
        G.template_device = "host"
        G.join_strategy = "walk"
        G.enable_batching = False
        G.enable_planner = False
    knn._DEVICE_FAIL_HOOK = None
    jknn._DEVICE_FAIL_HOOK = None
    yield
    knn._DEVICE_FAIL_HOOK = None
    jknn._DEVICE_FAIL_HOOK = None


MODES = {"scan": "scan", "rank_then_pattern": "rank_then_pattern",
         "pattern_then_rank": "pattern_then_rank",
         "pattern_then_rank_wide": "pattern_then_rank", "literal": "scan",
         "ordered": "rank_then_pattern"}


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODES))
def test_parser_clause_equals_jax(world, name):
    text = world["texts"][name]
    q = Parser(world["ss"]).parse(text)
    jq = JParser(world["jproxy"].str_server).parse(text)
    a, b = q.knn, jq.knn
    assert (a.var, a.k, a.anchor_vid, a.metric, a.mode) == \
        (b.var, b.k, b.anchor_vid, b.metric, b.mode)
    assert a.mode == MODES[name]
    if b.anchor_vec is None:
        assert a.anchor_vec is None
    else:
        assert np.array_equal(a.anchor_vec, b.anchor_vec)


BAD = [
    "SELECT ?a WHERE { knn(?a, <{p}>, 5) . knn(?a, <{p}>, 5) }",
    "SELECT ?a WHERE { knn(?a, <{p}>, 0) }",
    "SELECT ?a WHERE { knn(?a, <{p}>, 5, manhattan) }",
    "SELECT ?a WHERE { knn(?a, (), 5) }",
    "SELECT ?a WHERE { knn(?a, 7, 5) }",
    "SELECT ?a ?b WHERE { { knn(?a, <{p}>, 5) . ?a <{ub}worksFor> ?b } "
    "UNION { ?a <{ub}memberOf> ?b } }",
]


@pytest.mark.parametrize("bad", BAD)
def test_parser_refusals_equal_jax(world, bad):
    prof = world["ss"].id2str(int(world["profs"][0]))[1:-1]
    text = bad.replace("{p}", prof).replace("{ub}", UB)
    with pytest.raises(JSyntaxError) as je:
        JParser(world["jproxy"].str_server).parse(text)
    with pytest.raises(SPARQLSyntaxError) as pe:
        Parser(world["ss"]).parse(text)
    assert str(pe.value) == str(je.value)


def test_unknown_anchor_iri_is_unknown_sub(world):
    text = "SELECT ?a WHERE { knn(?a, <http://nowhere/x>, 5) }"
    with pytest.raises(WukongError) as e:
        Parser(world["ss"]).parse(text)
    assert e.value.code == ErrorCode.UNKNOWN_SUB


# ---------------------------------------------------------------------------
# the serving path against the JAX proxy
# ---------------------------------------------------------------------------

def _rows(q):
    return collections.Counter(map(tuple, np.asarray(q.result.table)
                                   .tolist()))


@pytest.mark.parametrize("knob", ["host", "device", "auto"])
@pytest.mark.parametrize("name", sorted(MODES))
def test_serve_equals_jax(world, knob, name):
    for G in (Global, JGlobal):
        G.knn_device = knob
        if knob == "auto":
            # every scan counts as wide: the device route, and a scan-side
            # knn sliced across the engine pool's heavy lane
            G.knn_split_threshold = 100
    text = world["texts"][name]
    q = world["proxy"].serve_query(text)
    jq = world["jproxy"].serve_query(text, blind=False)
    assert q.result.status_code == jq.result.status_code == \
        ErrorCode.SUCCESS
    assert q.knn_mode == jq.knn_mode == MODES[name]
    assert q.knn_route == jq.knn_route
    assert q.knn_route == ("device" if knob != "host" else "host")
    assert q.result.nrows > 0
    assert _rows(q) == _rows(jq)
    if MODES[name] == "scan" or "ORDER BY" in text:
        # the ranked seeds in rank order; ORDER BY's order
        assert np.array_equal(q.result.table, jq.result.table)
    if knob == "auto" and MODES[name] != "pattern_then_rank":
        assert q.lane == "heavy" and q._knn_wide
        assert q.knn_seeds is not None  # presolved by the sliced scan


def test_rank_then_pattern_walks_the_device_chain(world, monkeypatch):
    """The seeds start the GPU engine's chain (K1's path on the card)."""
    from wukong_tpu_torch.engine import tpu_kernels as K

    calls = []
    orig = K.probe_kernel

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(K, "probe_kernel", spy)
    q = world["proxy"].serve_query(world["texts"]["rank_then_pattern"])
    assert q.result.nrows > 0 and calls


def test_knn_refused_with_vectors_off(world):
    for G in (Global, JGlobal):
        G.enable_vectors = False
    text = world["texts"]["scan"]
    with pytest.raises(WukongError) as e:
        world["proxy"].serve_query(text)
    assert e.value.code == ErrorCode.ATTR_DISABLE
    with pytest.raises(Exception) as je:
        world["jproxy"].serve_query(text, blind=False)
    assert je.value.code.name == "ATTR_DISABLE"


def test_template_route_refuses_knn(world):
    Global.template_device = "device"
    proxy = world["proxy"]
    text = world["texts"]["rank_then_pattern"]
    assert extract_template(proxy.parse(text)) is None
    q = proxy.serve_query(text)
    assert getattr(q, "template_route", None) is None
    assert not getattr(q, "_template_compiled", False)
    Global.template_device = "host"
    assert _rows(q) == _rows(proxy.serve_query(text))


def test_explain_knn_section_equals_jax(world):
    for name in ("rank_then_pattern", "pattern_then_rank"):
        text = world["texts"][name]
        got = world["proxy"].explain_query(text)
        want = world["jproxy"].explain_query(text)
        assert got["knn"] == want["knn"]
        assert got["knn"]["est_rows"] == world["g"].vstore.live_count()
        assert got["knn"]["est_bytes"] == got["knn"]["est_rows"] * DIM * 4
        line = [ln for ln in got["rendered"].splitlines()
                if ln.startswith("knn:")]
        assert line == [ln for ln in want["rendered"].splitlines()
                        if ln.startswith("knn:")]


def _boom():
    raise RuntimeError("injected device failure")


def test_the_drill_demotes_and_latches_the_route_memo(world):
    Global.knn_device = "auto"
    Global.knn_split_threshold = 1
    proxy = world["proxy"]
    text = world["texts"]["rank_then_pattern"]
    want = proxy.serve_query(text.replace(", 8)", ", 8, cosine)"))
    knn._DEVICE_FAIL_HOOK = _boom
    try:
        q = proxy.serve_query(text)
    finally:
        knn._DEVICE_FAIL_HOOK = None
    assert q.result.status_code == ErrorCode.SUCCESS
    assert q.knn_route == "device" and q.knn_demoted == "RuntimeError"
    q2 = proxy.serve_query(text)
    assert q2.knn_route == "host"  # the memo absorbed the demotion
    assert _rows(q2) == _rows(q) == _rows(want)


def test_any_other_device_failure_reaches_the_caller(world, monkeypatch):
    Global.knn_device = "device"

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(knn, "knn_scan", broken)
    for name in ("scan", "pattern_then_rank"):
        with pytest.raises(RuntimeError, match="illegal memory access"):
            world["proxy"].serve_query(world["texts"][name])


def test_run_graphrag_serves_both_kinds(world):
    Global.knn_device = "device"
    proxy, ss = world["proxy"], world["ss"]
    profs = world["profs"]
    graph = [f"SELECT ?s WHERE {{ ?s <{UB}advisor> {ss.id2str(int(a))} . }}"
             for a in profs[:16]]
    tmpl = ("SELECT ?p ?d WHERE { knn(?p, {anchor}, 8) . "
            f"?p <{UB}worksFor> ?d }}")
    anchors = [ss.id2str(int(a)) for a in profs[:8]]
    out = Emulator(proxy).run_graphrag(graph, tmpl, anchors, duration_s=0.5,
                                       warmup_s=0.1, clients=2, seed=7)
    assert out["errors"] == 0
    assert out["hybrid"]["served"] > 0 and out["graph"]["served"] > 0
    assert out["anchors"] == 8 and out["clients"] == 2


def test_chip_smoke_hybrid_texts_parse(world):
    """The texts phase 13 serves on the card parse in both packages."""
    ss = world["ss"]
    prof = ss.id2str(int(world["profs"][0]))
    texts = chip_smoke.hybrid_texts(prof, prof)
    assert len(texts) == 7
    for text in texts.values():
        q = Parser(ss).parse(text)
        jq = JParser(world["jproxy"].str_server).parse(text)
        assert q.knn.mode == jq.knn.mode
