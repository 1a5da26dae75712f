"""The port's distributed engine (device="cpu": 8 shard slots on the CPU,
every kernel's plain version) against the JAX package's DistEngine on its
8-device virtual CPU mesh, on LUBM-1 (seed 42): the cases of
tests/test_dist_engine.py. Each case holds rows (as multisets), status,
``complete``, the chain stats (classes, exchange capacities and peaks,
retries) and ``bytes_model`` equal to JAX's. The shape cases (OPTIONAL,
UNION, attributes, variable predicates) are in test_torch_dist_shapes.py.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from wukong_tpu.config import Global as JG
from wukong_tpu.engine.cpu import CPUEngine as JCPU
from wukong_tpu.loader.lubm import VirtualLubmStrings, generate_lubm
from wukong_tpu.parallel.dist_engine import DistEngine as JDist
from wukong_tpu.parallel.mesh import make_mesh as jmesh
from wukong_tpu.planner.heuristic import heuristic_plan as jplan
from wukong_tpu.sparql import ir as jir
from wukong_tpu.sparql.parser import Parser as JParser
from wukong_tpu.store.gstore import build_all_partitions as jbap
from wukong_tpu.store.gstore import build_partition as jbp
from wukong_tpu_torch.config import Global as PG
from wukong_tpu_torch.loader import lubm as pl
from wukong_tpu_torch.parallel.dist_engine import DistEngine as PDist
from wukong_tpu_torch.parallel.mesh import make_mesh as pmesh
from wukong_tpu_torch.planner.heuristic import heuristic_plan as pplan
from wukong_tpu_torch.sparql import ir as pir
from wukong_tpu_torch.sparql.parser import Parser as PParser
from wukong_tpu_torch.store.gstore import build_all_partitions as pbap

torch.set_num_threads(2)

UB = "http://swat.cse.lehigh.edu/onto/univ-bench.owl#"
RDF = "http://www.w3.org/1999/02/22-rdf-syntax-ns#"
PREFIX = f"PREFIX rdf: <{RDF}>\nPREFIX ub: <{UB}>\n"
DEPT0 = chip_smoke.DEPT0
BASIC = chip_smoke.QUERIES


@pytest.fixture(autouse=True)
def _pin_collective_route():
    """At LUBM-1 every const-start chain is light, so in-place routing
    would answer most cases without the collective chain they hold: pin
    the sharded route in both packages (the in-place cases flip it)."""
    old = JG.enable_dist_inplace, PG.enable_dist_inplace
    JG.enable_dist_inplace = PG.enable_dist_inplace = False
    yield
    JG.enable_dist_inplace, PG.enable_dist_inplace = old


class World:
    def __init__(self, scale: int, seed: int, attrs: bool = False):
        from wukong_tpu.loader.lubm import generate_lubm_attrs as jattrs

        triples, _ = generate_lubm(scale, seed=seed)
        ja = jattrs(scale, seed=seed) if attrs else None
        self.jss = VirtualLubmStrings(scale, seed=seed)
        self.jd = JDist(jbap(triples, 8, attr_triples=ja), self.jss,
                        jmesh(8))
        self.jcpu = JCPU(jbp(triples, 0, 1, attr_triples=ja), self.jss)
        pt, _ = pl.generate_lubm(scale, seed=seed)
        pa = pl.generate_lubm_attrs(scale, seed=seed) if attrs else None
        self.pss = pl.VirtualLubmStrings(scale, seed=seed)
        self.pd = PDist(pbap(pt, 8, attr_triples=pa), self.pss,
                        device="cpu")


@pytest.fixture(scope="module")
def world(eight_cpu_devices):
    return World(1, 42)


def rows(q):
    """The reply's rows over its variables in sorted order, as a sorted
    list of tuples, with its attribute values appended."""
    res = q.result
    t = np.asarray(res.table)
    if res.v2c_map and t.size:
        t = t[:, [res.v2c_map[v] for v in sorted(res.v2c_map)]]
    out = t.tolist()
    if np.asarray(res.attr_table).size:
        out = [r + a for r, a in zip(out, np.asarray(res.attr_table).tolist())]
    return sorted(map(tuple, out))


def same(jq, pq, jd=None, pd=None):
    """Status, complete, rows, dropped patterns and (with the engines)
    chain stats and bytes_model equal."""
    assert int(pq.result.status_code) == int(jq.result.status_code)
    assert bool(pq.result.complete) == bool(jq.result.complete)
    assert pq.result.nrows == jq.result.nrows
    assert rows(pq) == rows(jq)
    assert list(pq.result.dropped_patterns) == list(jq.result.dropped_patterns)
    if jd is not None:
        assert pd.last_chain_stats == jd.last_chain_stats
        assert pd.bytes_model() == jd.bytes_model()


def run_text(w, text, blind=False, from_proxy=True, plan=True):
    """(JAX reply, port reply) of one query text on both engines."""
    jq = JParser(w.jss).parse(text)
    pq = PParser(w.pss).parse(text)
    if plan:
        jplan(jq)
        pplan(pq)
    jq.result.blind = pq.result.blind = blind
    w.jd.execute(jq, from_proxy=from_proxy)
    w.pd.execute(pq, from_proxy=from_proxy)
    return jq, pq


def run_mk(w, mk, from_proxy=False):
    """Both replies of a query built by mk(ir module, string server)."""
    jq, pq = mk(jir, w.jss), mk(pir, w.pss)
    w.jd.execute(jq, from_proxy=from_proxy)
    w.pd.execute(pq, from_proxy=from_proxy)
    return jq, pq


def check_text(w, text, **kw):
    jq, pq = run_text(w, text, **kw)
    same(jq, pq, w.jd, w.pd)
    return pq


@pytest.mark.parametrize("qn", sorted(BASIC))
def test_dist_matches_cpu(world, qn):
    pq = check_text(world, BASIC[qn])
    assert pq.result.status_code == 0
    # and the host engine's rows, as the JAX test holds its own
    qc = JParser(world.jss).parse(BASIC[qn])
    jplan(qc)
    world.jcpu.execute(qc)
    assert rows(pq) == rows(qc)


def test_dist_blind_counts(world):
    pq = check_text(world, BASIC["lubm_q2"], blind=True)
    assert pq.result.nrows > 0 and pq.result.table.size == 0


def test_dist_versatile_const_start(world):
    pq = check_text(world, f"SELECT ?X ?P WHERE {{ ?X ?P {DEPT0} . }}")
    assert pq.result.status_code == 0 and pq.result.nrows > 0

    def mk(ir, ss):
        from wukong_tpu_torch.types import IN, OUT, PREDICATE_ID

        works = ss.str2id(f"<{UB}worksFor>")
        q = ir.SPARQLQuery()
        q.result.nvars = 3
        q.pattern_group.patterns = [
            ir.Pattern(works, PREDICATE_ID, IN, -1),
            ir.Pattern(-1, works, OUT, -2),
            ir.Pattern(-1, -3, OUT, -2)]
        q.result.required_vars = [-1, -2, -3]
        return q

    jq, pq = run_mk(world, mk, from_proxy=True)
    assert pq.result.status_code != 0
    assert int(pq.result.status_code) == int(jq.result.status_code)


def test_dist_filter_and_projection(world):
    pq = check_text(world, PREFIX + f"""SELECT DISTINCT ?Y1 WHERE {{
        ?X ub:worksFor {DEPT0} . ?X rdf:type ub:FullProfessor .
        ?X ub:name ?Y1 . FILTER regex(?Y1, "FullProfessor[0-2]") }}""")
    assert pq.result.nrows == 3


def test_inplace_routes_agree_with_collective(world):
    """Light const-start chains route in place, with the rows of the
    collective chain and of JAX's in-place route."""
    from wukong_tpu_torch.types import NORMAL_ID_START

    for qn in ("lubm_q4", "lubm_q5", "lubm_q6"):
        JG.enable_dist_inplace = PG.enable_dist_inplace = True
        try:
            jq, pq = run_text(world, BASIC[qn])
        finally:
            JG.enable_dist_inplace = PG.enable_dist_inplace = False
        same(jq, pq, world.jd, world.pd)
        first = pq.pattern_group.patterns[0]
        if first.subject >= NORMAL_ID_START and first.predicate > 0:
            assert world.pd.last_chain_stats["mode"] == "inplace", qn
        _jq2, pq2 = run_text(world, BASIC[qn])
        assert rows(pq2) == rows(pq), qn


def test_inplace_overflow_falls_back_to_collective(world):
    text = PREFIX + """SELECT ?X ?Y WHERE {
        ?X ub:subOrganizationOf <http://www.University0.edu> .
        ?Y ub:memberOf ?X . }"""
    q0 = PParser(world.pss).parse(text)
    pplan(q0)
    first = q0.pattern_group.patterns[0]
    fan = len(world.pd._inplace_engine().g.get_triples(
        first.subject, first.predicate, first.direction))
    assert fan > 0
    old = JG.dist_inplace_rows, PG.dist_inplace_rows
    JG.enable_dist_inplace = PG.enable_dist_inplace = True
    JG.dist_inplace_rows = PG.dist_inplace_rows = fan
    try:
        jq, pq = run_text(world, text, from_proxy=False)
    finally:
        JG.dist_inplace_rows, PG.dist_inplace_rows = old
        JG.enable_dist_inplace = PG.enable_dist_inplace = False
    same(jq, pq, world.jd, world.pd)
    assert world.pd.last_chain_stats.get("mode") != "inplace"
    assert pq.result.nrows > fan


def test_inplace_seeded_union_child(world):
    text = PREFIX + f"""SELECT ?X ?Y WHERE {{
        ?X ub:worksFor {DEPT0} .
        {{ ?X ub:teacherOf ?Y . }} UNION {{ ?Y ub:advisor ?X . }} }}"""
    JG.enable_dist_inplace = PG.enable_dist_inplace = True
    try:
        jq, pq = run_text(world, text)
    finally:
        JG.enable_dist_inplace = PG.enable_dist_inplace = False
    same(jq, pq)
    _jq2, pq2 = run_text(world, text)
    assert pq.result.nrows > 0 and rows(pq2) == rows(pq)


def test_inplace_attr_tail_and_blind(world):
    JG.enable_dist_inplace = PG.enable_dist_inplace = True
    try:
        jq, pq = run_text(world, BASIC["lubm_q4"], blind=True)
    finally:
        JG.enable_dist_inplace = PG.enable_dist_inplace = False
    same(jq, pq, world.jd, world.pd)
    assert pq.result.nrows > 0 and pq.result.table.shape[0] == 0


def test_dist_cap_memo_roundtrip(world, tmp_path):
    check_text(world, BASIC["lubm_q7"], blind=True, from_proxy=False)
    path = str(tmp_path / "caps.json")
    world.pd.save_cap_memo(path)
    world.jd.save_cap_memo(str(tmp_path / "jcaps.json"))
    assert open(path).read() == open(tmp_path / "jcaps.json").read()
    fresh = PDist(world.pd.sstore.stores, world.pss, world.pd.mesh)
    fresh.load_cap_memo(path)
    assert fresh._learned_caps == world.pd._learned_caps
    key = next(iter(fresh._learned_caps))
    fresh._learned_caps[key] = {("cap", 0): 1024}
    fresh.load_cap_memo(path)
    assert fresh._learned_caps[key] == {("cap", 0): 1024}


# ---------------------------------------------------------------------------
# the one-device mesh, the sharded store's row views, the device rule
# ---------------------------------------------------------------------------

def test_mesh_is_slots_on_one_device(monkeypatch):
    from wukong_tpu_torch.parallel import mesh

    m = pmesh(8, device="cpu")
    assert (m.size, m.device.type, m.axis) == (8, "cpu", "x")
    assert pmesh(devices=["cpu"] * 4).size == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pmesh(8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PDist(pbap(pl.generate_lubm(1, seed=1)[0], 2), None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(NotImplementedError, match="7b"):
        pmesh(devices=["cuda:0", "cuda:1"])
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    assert mesh.init_multihost() is None
    with pytest.raises(NotImplementedError, match="7b"):
        mesh.init_multihost("localhost:1234", 2, 0)


def test_stacked_rows_are_k1_tables(world):
    """Shard i of a stacked segment is the contiguous row view [i] that K1
    takes as it is; the alignment check refuses a view off a 16 B
    boundary."""
    from wukong_tpu_torch.engine import cuda_lib
    from wukong_tpu_torch.engine.tpu_kernels import check_table
    from wukong_tpu_torch.types import OUT

    works = world.pss.str2id(f"<{UB}worksFor>")
    seg = world.pd.sstore.segment(works, OUT)
    D, NB, L = seg.bline.shape
    assert (D, L) == (8, 16) and tuple(seg.bhi.shape) == (8, NB * 4, 2)
    for i in range(D):
        bline, bhi, edges = seg.shard(i)
        check_table(bline, bhi)
        assert bline.is_contiguous() and bhi.is_contiguous()
        assert bline.data_ptr() % 64 == seg.bline.data_ptr() % 64
        cuda_lib.require_aligned("probe_kernel", bline, bhi)
    off = seg.bline.view(-1)[1:]  # 4 B off the line
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_lib.require_aligned("probe_kernel", off)
