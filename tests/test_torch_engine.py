"""The port's GPUEngine (device="cpu": every kernel's plain version) against
the JAX package's TPUEngine and CPUEngine on LUBM-1: the seven inline LUBM
shapes give equal row multisets, replicate batches give exactly the JAX
per-qid counts (with the stream arms forced on in both packages), a forced
tiny capacity retries to the same rows, and the shapes the first slices
refused (OPTIONAL, UNION, FILTER, variable predicates, ORDER BY) give the
JAX engines' rows."""

import numpy as np
import pytest
import torch

from test_wcoj import LUBM_PREFIX, LUBM_REFERENCE_SHAPES
from wukong_tpu.config import Global as JGlobal
from wukong_tpu.engine import tpu_stream as JS
from wukong_tpu.engine.cpu import CPUEngine
from wukong_tpu.engine.tpu import TPUEngine
from wukong_tpu.loader.lubm import VirtualLubmStrings, generate_lubm
from wukong_tpu.planner.heuristic import heuristic_plan
from wukong_tpu.sparql.parser import Parser
from wukong_tpu.store.gstore import build_partition
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine import tpu_stream as S
from wukong_tpu_torch.loader import lubm as port_lubm
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.store.gstore import build_partition as port_build
from wukong_tpu_torch.utils.errors import ErrorCode

# the suite runs several test processes side by side: keep torch's own
# thread pool small so it does not starve their timing-sensitive tests
torch.set_num_threads(2)

SHAPES = sorted(LUBM_REFERENCE_SHAPES)


@pytest.fixture(scope="module")
def world():
    triples, _ = generate_lubm(1, seed=42)
    g = build_partition(triples, 0, 1)
    ss = VirtualLubmStrings(1, seed=42)
    pt, _ = port_lubm.generate_lubm(1, seed=42)
    proxy = Proxy(port_build(pt, 0, 1), port_lubm.VirtualLubmStrings(1, 42),
                  device="cpu")
    return g, ss, proxy, CPUEngine(g, ss), TPUEngine(g, ss)


def _jax_rows(eng, ss, text):
    q = Parser(ss).parse(text)
    heuristic_plan(q)
    eng.execute(q)
    assert q.result.status_code == 0
    return sorted(map(tuple, q.result.table.tolist()))


@pytest.mark.parametrize("name", SHAPES)
def test_lubm_shapes_match_jax_engines(world, name):
    g, ss, proxy, cpu, tpu = world
    text = LUBM_REFERENCE_SHAPES[name]
    want = _jax_rows(cpu, ss, text)
    assert _jax_rows(tpu, ss, text) == want
    q = proxy.serve_query(text)
    assert q.result.status_code == ErrorCode.SUCCESS
    assert sorted(map(tuple, q.result.table.tolist())) == want
    assert len(want) > 0


HEAVY = [n for n in SHAPES if n in ("lubm_q1", "lubm_q2", "lubm_q6")]


@pytest.fixture
def force_stream(monkeypatch):
    """Both packages take the stream arm for every expand whose capacity is
    tile-aligned (the density gate off), the JAX one in interpret mode; the
    port's emit wrappers are counted."""
    monkeypatch.setattr(JS, "FORCE_INTERPRET", True)
    monkeypatch.setattr(JS, "want_stream",
                        lambda est, ne, cap: cap % JS.TILE == 0)
    monkeypatch.setattr(S, "want_stream",
                        lambda est, ne, cap: cap % S.TILE == 0)
    calls = {"stream": 0, "mhot": 0}
    for arm, attr in (("stream", "stream_emit"), ("mhot", "stream_emit_m")):
        orig = getattr(S, attr)

        def counted(*a, _orig=orig, _arm=arm, **kw):
            calls[_arm] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(S, attr, counted)
    return calls


def _jax_batch(tpu, ss, text, B):
    q = Parser(ss).parse(text)
    heuristic_plan(q)
    return np.asarray(tpu.execute_batch_index(q, B)).tolist()


def test_replicate_batch_stream_arms_match_jax(world, force_stream):
    """Both packages take their stream arms (the JAX kernels in interpret
    mode): distinct anchors at B=1 (K2), duplicates at B=2 (K3)."""
    g, ss, proxy, cpu, tpu = world
    text = LUBM_REFERENCE_SHAPES["lubm_q2"]
    single = len(_jax_rows(cpu, ss, text))
    for B, arm in ((1, "stream"), (2, "mhot")):
        before = force_stream[arm]
        got = proxy.serve_batch_index(text, B).tolist()
        assert got == _jax_batch(tpu, ss, text, B) == [single] * B
        assert force_stream[arm] > before


@pytest.mark.parametrize("name", HEAVY)
def test_replicate_batch_counts_match_jax(world, name, monkeypatch):
    """Every arm the port's merge executor takes (the density gate off, so
    the stream arms run wherever capacities allow) gives the JAX counts."""
    g, ss, proxy, cpu, tpu = world
    monkeypatch.setattr(S, "want_stream",
                        lambda est, ne, cap: cap % S.TILE == 0)
    text = LUBM_REFERENCE_SHAPES[name]
    single = len(_jax_rows(cpu, ss, text))
    for B in (1, S.MDUP, S.MDUP + 2):
        got = proxy.serve_batch_index(text, B).tolist()
        assert got == _jax_batch(tpu, ss, text, B) == [single] * B


def test_replicate_batch_without_merge_join(world, monkeypatch):
    """enable_merge_join off: the eager probe chain with a qid column."""
    g, ss, proxy, cpu, tpu = world
    monkeypatch.setattr(Global, "enable_merge_join", False)
    monkeypatch.setattr(JGlobal, "enable_merge_join", False)
    for name in ("lubm_q1", "lubm_q2"):
        text = LUBM_REFERENCE_SHAPES[name]
        q = Parser(ss).parse(text)
        heuristic_plan(q)
        want = np.asarray(tpu.execute_batch_index(q, 3)).tolist()
        assert proxy.serve_batch_index(text, 3).tolist() == want


def test_capacity_overflow_retry(world, monkeypatch):
    """A tiny starting capacity forces the chain to regrow mid-query."""
    g, ss, proxy, cpu, tpu = world
    monkeypatch.setattr(Global, "table_capacity_min", 16)
    small = Proxy(proxy.g, proxy.str_server, device="cpu")
    assert small.gpu.cap_min == 16
    # estimates far below the truth: the first attempt must overflow
    monkeypatch.setattr(small.gpu, "_fanout", lambda pat, seg=None: 1e-3)
    text = LUBM_REFERENCE_SHAPES["lubm_q2"]
    q = small.serve_query(text)
    assert q.result.status_code == ErrorCode.SUCCESS
    assert small.gpu._last_attempts > 1
    assert sorted(map(tuple, q.result.table.tolist())) == \
        _jax_rows(cpu, ss, text)


def test_distinct_limit_offset(world):
    g, ss, proxy, cpu, tpu = world
    text = LUBM_PREFIX + """SELECT DISTINCT ?Y WHERE {
        ?X rdf:type ub:GraduateStudent . ?X ub:memberOf ?Y . }"""
    for tail in ("", " LIMIT 5", " OFFSET 3 LIMIT 4"):
        want = _jax_rows(cpu, ss, text + tail)
        q = proxy.serve_query(text + tail)
        assert sorted(map(tuple, q.result.table.tolist())) == want


@pytest.mark.parametrize("text", [
    LUBM_PREFIX + "SELECT * WHERE { ?X ub:memberOf ?Y . "
    "OPTIONAL { ?X ub:advisor ?Z . } }",
    LUBM_PREFIX + "SELECT * WHERE { { ?X ub:memberOf ?Y . } "
    "UNION { ?X ub:worksFor ?Y . } }",
    LUBM_PREFIX + "SELECT * WHERE { ?X ub:memberOf ?Y . FILTER(?X != ?Y) }",
    LUBM_PREFIX + "SELECT * WHERE { "
    "<http://www.Department0.University0.edu> ?P ?X . }",
    LUBM_PREFIX + "SELECT ?X WHERE { ?X ub:memberOf "
    "<http://www.Department0.University0.edu> . } ORDER BY ?X",
], ids=["optional", "union", "filter", "variable_predicate", "order_by"])
def test_formerly_refused_shapes_match_jax(world, text):
    """Shapes the port raised UNKNOWN_PATTERN on before it had a host
    engine; ORDER BY fixes the row order, so it is compared exactly."""
    g, ss, proxy, cpu, tpu = world
    q = proxy.serve_query(text)
    assert q.result.status_code == ErrorCode.SUCCESS
    got = q.result.table.tolist()
    for eng in (cpu, tpu):
        want = Parser(ss).parse(text)
        heuristic_plan(want)
        eng.execute(want)
        assert want.result.status_code == 0
        rows = want.result.table.tolist()
        if "ORDER BY" in text:
            assert got == rows
        else:
            assert sorted(map(tuple, got)) == sorted(map(tuple, rows))
    assert len(got) > 0
