"""The port's whole single-partition query path (device="cpu": every
kernel's plain version) against the JAX package's TPUEngine and CPUEngine on
LUBM-1 (seed 42) with attributes: OPTIONAL, UNION, FILTER, ORDER BY,
attribute and variable-predicate shapes give the same rows (in the same
order where ORDER BY fixes it), the same column bindings, the same attribute
tables (float64, exactly) and the same status codes."""

import pytest
import torch

import chip_smoke
from test_wcoj import LUBM_PREFIX
from wukong_tpu.engine.cpu import CPUEngine
from wukong_tpu.engine.tpu import TPUEngine
from wukong_tpu.loader.lubm import (
    VirtualLubmStrings,
    generate_lubm,
    generate_lubm_attrs,
)
from wukong_tpu.planner.heuristic import heuristic_plan
from wukong_tpu.sparql.parser import Parser
from wukong_tpu.store.gstore import build_partition
from wukong_tpu.types import BLANK_ID, OUT
from wukong_tpu_torch.loader import lubm as port_lubm
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.store.gstore import build_partition as port_build

# the suite runs several test processes side by side: keep torch's own
# thread pool small so it does not starve their timing-sensitive tests
torch.set_num_threads(2)

DEPT0, UNIV0 = chip_smoke.DEPT0, chip_smoke.UNIV0


@pytest.fixture(scope="module")
def world():
    triples, _ = generate_lubm(1, seed=42)
    g = build_partition(triples, 0, 1,
                        attr_triples=generate_lubm_attrs(1, seed=42))
    ss = VirtualLubmStrings(1, seed=42)
    pt, _ = port_lubm.generate_lubm(1, seed=42)
    pg = port_build(pt, 0, 1,
                    attr_triples=port_lubm.generate_lubm_attrs(1, seed=42))
    proxy = Proxy(pg, port_lubm.VirtualLubmStrings(1, seed=42), device="cpu")
    return ss, proxy, CPUEngine(g, ss), TPUEngine(g, ss)


def _jax(eng, ss, text, blind=False):
    q = Parser(ss).parse(text)
    heuristic_plan(q)
    q.result.blind = blind
    eng.execute(q)
    return q


def _rows(res):
    """Rows with their attribute values appended, as sortable tuples."""
    t = res.table.tolist()
    if res.attr_table.size:
        t = [r + a for r, a in zip(t, res.attr_table.tolist())]
    return t


def _assert_same(port_q, jax_q, ordered: bool):
    a, b = port_q.result, jax_q.result
    assert int(a.status_code) == int(b.status_code)
    assert a.nrows == b.nrows
    if ordered:
        assert _rows(a) == _rows(b)
    else:
        assert sorted(_rows(a)) == sorted(_rows(b))
    assert a.v2c_map == b.v2c_map
    assert a.attr_v2c_map == b.attr_v2c_map
    assert a.attr_table.dtype == b.attr_table.dtype
    assert a.attr_table.shape == b.attr_table.shape


def _parity(world, text, ordered=False):
    ss, proxy, cpu, tpu = world
    got = proxy.serve_query(text)
    for eng in (tpu, cpu):
        _assert_same(got, _jax(eng, ss, text), ordered)
    return got


@pytest.mark.parametrize("name", sorted(chip_smoke.EXT_QUERIES))
def test_extended_suite_matches_jax_engines(world, name):
    q = _parity(world, chip_smoke.EXT_QUERIES[name],
                ordered=name in chip_smoke.ORDERED)
    assert q.result.status_code == 0
    # LUBM-1 has one university, so every degree is from it and
    # x_filter's ?U != ?D keeps nothing (LUBM-640 keeps rows)
    assert (q.result.nrows == 0) == (name == "x_filter")


def test_versatile_steps_ran_on_the_device_chain(world):
    """x_vers_kuu and x_vers_kuc_fold expand through expand2 over the staged
    OUT combined segment; the const starts need no staging."""
    ss, proxy, cpu, tpu = world
    ds = proxy.gpu.dstore
    ds._cache.pop(("vpv", int(OUT)), None)
    proxy.serve_query(chip_smoke.EXT_QUERIES["x_vers_const"])
    assert ("vpv", int(OUT)) not in ds._cache
    for name in ("x_vers_kuu", "x_vers_kuc_fold"):
        ds._cache.pop(("vpv", int(OUT)), None)
        proxy.serve_query(chip_smoke.EXT_QUERIES[name])
        assert ds._cache[("vpv", int(OUT))].edges2 is not None


MORE = {
    # FILTER on two bound columns that keeps rows at LUBM-1
    "filter_eq": f"""SELECT ?X ?U ?D WHERE {{ ?X ub:memberOf {DEPT0} .
        ?X ub:advisor ?Y . ?X ub:undergraduateDegreeFrom ?U .
        ?Y ub:doctoralDegreeFrom ?D . FILTER (?U = ?D) }}""",
    "filter_regex": f"""SELECT ?N WHERE {{ ?X ub:worksFor {DEPT0} .
        ?X ub:name ?N . FILTER regex(?N, "FullProfessor[0-3]") }}""",
    "distinct_order_desc": f"""SELECT DISTINCT ?Y WHERE {{
        ?X ub:memberOf {DEPT0} . ?X ub:advisor ?Y . }} ORDER BY DESC(?Y)""",
    "optional_only": "SELECT * WHERE { OPTIONAL { ?X ub:headOf ?D } }",
    "optional_after_attr": f"""SELECT * WHERE {{ ?X ub:memberOf {DEPT0} .
        ?X ub:age ?A . OPTIONAL {{ ?X ub:advisor ?Y }} }}""",
    "optional_bound_predicate": f"""SELECT * WHERE {{
        ?X ub:worksFor {DEPT0} . ?X ?P ?Y . OPTIONAL {{ ?Y ?P ?Z }} }}""",
    "bound_predicate_step": f"""SELECT * WHERE {{
        ?X ub:worksFor {DEPT0} . ?X ?P ?Y . ?Y ?P ?Z }}""",
    "attr_filter_id": f"""SELECT ?X ?I WHERE {{ ?X ub:worksFor {DEPT0} .
        ?X ub:id ?I . FILTER (?I < 5) }}""",
}


@pytest.mark.parametrize("name", sorted(MORE))
def test_more_shapes_match_jax_engines(world, name):
    q = _parity(world, LUBM_PREFIX + MORE[name],
                ordered="ORDER BY" in MORE[name])
    assert q.result.status_code == 0 and q.result.nrows > 0


@pytest.mark.parametrize("text, code", [
    # an attribute column in a UNION branch has no merge (query.hpp)
    (LUBM_PREFIX + f"""SELECT * WHERE {{ ?X ub:memberOf {DEPT0} .
        {{ ?X ub:age ?A }} UNION {{ ?X ub:advisor ?Y }} }}""",
     "UNSUPPORT_UNION"),
    # ORDER BY a variable no pattern binds
    (LUBM_PREFIX + f"""SELECT ?X WHERE {{ ?X ub:memberOf {DEPT0} . }}
        ORDER BY ?Q""", "VERTEX_INVALID"),
], ids=["attr_in_union", "order_by_unbound"])
def test_failures_end_on_status_code(world, text, code):
    q = _parity(world, text)
    assert q.result.status_code.name == code


def test_two_optional_groups_share_a_blank_column(world):
    """The second group's seeds carry the BLANK_ID (2^32 - 1) the first
    group left in ?Y; its int32 upload matches the JAX engine's bit for bit,
    and the joined rows equal both JAX engines'."""
    ss, proxy, cpu, tpu = world
    text = LUBM_PREFIX + f"""SELECT ?X ?Y ?D ?U WHERE {{
        ?X ub:memberOf {DEPT0} .
        OPTIONAL {{ ?X ub:advisor ?Y }} .
        OPTIONAL {{ ?Y ub:worksFor ?D . ?D ub:subOrganizationOf ?U }} }}"""
    got = proxy.serve_query(text)
    _assert_same(got, _jax(tpu, ss, text), ordered=True)
    _assert_same(got, _jax(cpu, ss, text), ordered=False)
    y, d = got.result.table[:, 1], got.result.table[:, 2]
    assert (y == BLANK_ID).any() and (y != BLANK_ID).any()
    assert (d[y == BLANK_ID] == BLANK_ID).all()
    assert (d[y != BLANK_ID] != BLANK_ID).any()


def test_blind_query_with_trailing_filter_fetches_table(world):
    """A blind chain keeps its table on the card only when nothing follows
    it: a trailing FILTER needs the rows, so the reply's count is the
    filtered one, as in the JAX engine."""
    ss, proxy, cpu, tpu = world
    base = LUBM_PREFIX + f"""SELECT ?X ?N WHERE {{ ?X ub:memberOf {DEPT0} .
        ?X ub:name ?N . """
    text = base + 'FILTER regex(?N, "UndergraduateStudent1.*") }'
    full = proxy.serve_query(text)
    blind = proxy.serve_query(text, blind=True)
    want = _jax(tpu, ss, text, blind=True)
    assert int(blind.result.status_code) == int(want.result.status_code) == 0
    assert blind.result.nrows == want.result.nrows == full.result.nrows
    unfiltered = proxy.serve_query(base + "}", blind=True)
    assert unfiltered.result.table.size == 0  # the table stayed on device
    assert 0 < full.result.nrows < unfiltered.result.nrows


@pytest.mark.parametrize("name", sorted(chip_smoke.EXT_QUERIES))
def test_host_engine_alone_matches_jax(world, name):
    """The port's host engine runs a whole query by itself, as it runs an
    in-place OPTIONAL child (every step, UNION, OPTIONAL, FILTER and the
    final stage on the host): the same reply as the JAX CPUEngine."""
    from wukong_tpu_torch.engine.cpu import CPUEngine as PortCPU

    ss, proxy, cpu, tpu = world
    text = chip_smoke.EXT_QUERIES[name]
    got = PortCPU(proxy.g, proxy.str_server).execute(proxy.parse(text))
    _assert_same(got, _jax(cpu, ss, text), ordered=name in chip_smoke.ORDERED)
