"""The port's planner (statistics, the type-centric optimizer, user plan
files, templates) against the JAX package's on the same numpy triples:
LUBM-1 (seed 42), a small hand-built world with multi-typed and untyped
vertices (the complex-type loop paths), and the large untyped world of
tests/test_stats_fastpath.py (the vectorised signature path). Statistics
are equal field by field, stat files load across packages, plans are equal
step by step (with ``planner_empty``), estimates agree to a relative 1e-12,
and templates instantiate to equal queries under one rng seed."""

import numpy as np
import pytest
import torch

import chip_smoke
from test_stats_fastpath import _world_with_big_untyped
from wukong_tpu.loader.lubm import VirtualLubmStrings, generate_lubm
from wukong_tpu.planner import optimizer as jopt
from wukong_tpu.planner.plan_file import set_plan as jset_plan
from wukong_tpu.planner.stats import Stats as JStats
from wukong_tpu.runtime.proxy import Proxy as JProxy
from wukong_tpu.sparql.ir import Pattern as JPattern
from wukong_tpu.sparql.ir import SPARQLQuery as JQuery
from wukong_tpu.sparql.parser import Parser as JParser
from wukong_tpu.store.gstore import build_partition
from wukong_tpu.types import NORMAL_ID_START, OUT, TYPE_ID
from wukong_tpu_torch.loader import lubm as port_lubm
from wukong_tpu_torch.planner import optimizer as popt
from wukong_tpu_torch.planner.plan_file import set_plan as pset_plan
from wukong_tpu_torch.planner.stats import Stats as PStats
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.sparql.ir import Pattern as PPattern
from wukong_tpu_torch.sparql.ir import SPARQLQuery as PQuery
from wukong_tpu_torch.sparql.parser import Parser as PParser
from wukong_tpu_torch.sparql.parser import SPARQLSyntaxError
from wukong_tpu_torch.store.gstore import build_partition as port_build

torch.set_num_threads(2)

FIELDS = ("tyscount", "pstype", "potype", "fine_type", "pred_edges",
          "distinct_subj", "distinct_obj", "complex_members")

EMPTY_SHAPE = chip_smoke.PREFIX + """SELECT ?X ?Y WHERE {
    ?X rdf:type ub:GraduateStudent . ?X ub:worksFor ?Y . }"""
SHAPES = {**chip_smoke.QUERIES, **chip_smoke.EXT_QUERIES,
          "x_empty": EMPTY_SHAPE}


def _hand_triples() -> np.ndarray:
    """Multi-typed vertices (two type sets), single-typed ones, untyped
    vertices with out-edges (two predicate sets) and literal objects."""
    b = NORMAL_ID_START
    T1, T2, T3 = 20, 21, 22
    P1, P2, P3 = 3, 4, 5
    rows = []
    for v in range(8):  # vertices 0-3 typed {T1, T2}, 4-5 {T1, T3}, 6-7 T1
        rows.append((b + v, TYPE_ID, T1))
        if v < 4:
            rows.append((b + v, TYPE_ID, T2))
        elif v < 6:
            rows.append((b + v, TYPE_ID, T3))
    for v in range(8, 12):  # single-typed T3
        rows.append((b + v, TYPE_ID, T3))
    for v in range(12, 16):  # untyped, out-predicates {P1} or {P1, P2}
        rows.append((b + v, P1, b + (v % 8)))
        if v % 2:
            rows.append((b + v, P2, b + 8 + (v % 4)))
    for v in range(12):  # typed edges and literal objects (no out-edges)
        rows.append((b + v, P2, b + 8 + (v % 4)))
        rows.append((b + v, P3, b + 100 + v))
    return np.unique(np.asarray(rows, dtype=np.int64), axis=0)


@pytest.fixture(scope="module")
def lubm():
    triples, _ = generate_lubm(1, seed=42)
    return triples, JStats.generate(triples), PStats.generate(triples)


@pytest.fixture(scope="module")
def world(lubm):
    triples, js, ps = lubm
    ss = VirtualLubmStrings(1, seed=42)
    pt, _ = port_lubm.generate_lubm(1, seed=42)
    jproxy = JProxy(build_partition(triples, 0, 1), ss)
    proxy = Proxy(port_build(pt, 0, 1), port_lubm.VirtualLubmStrings(1, 42),
                  device="cpu", planner=popt.Planner(ps))
    return ss, jopt.Planner(js), jproxy, proxy


def _assert_stats_equal(a, b):
    for f in FIELDS:
        assert getattr(a, f) == getattr(b, f), f
        assert list(getattr(a, f)) == list(getattr(b, f)), f  # dict order
    assert np.array_equal(a.vtype, b.vtype)
    assert np.array_equal(a.vtype_ids, b.vtype_ids)
    assert a.vtype.dtype == b.vtype.dtype


@pytest.mark.parametrize("which", ["lubm", "hand", "big_untyped"])
def test_stats_fields_equal(lubm, which):
    if which == "lubm":
        triples, js, ps = lubm
    else:
        triples = (_hand_triples() if which == "hand"
                   else _world_with_big_untyped())
        js, ps = JStats.generate(triples), PStats.generate(triples)
    assert any(c < 0 for c in js.tyscount)  # complex types were minted
    _assert_stats_equal(ps, js)
    for v in np.concatenate([triples[:50, 0], triples[-50:, 2]]):
        assert ps.type_of(int(v)) == js.type_of(int(v))
    for t in list(js.tyscount)[:20]:
        assert ps.types_containing(t) == js.types_containing(t)
        assert ps.count_containing(t) == js.count_containing(t)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stat_file_loads_in_the_other_package(lubm, tmp_path, writer):
    _, js, ps = lubm
    path = str(tmp_path / "statfile")
    if writer == "jax":
        js.save(path)
        _assert_stats_equal(PStats.load(path), js)
    else:
        ps.save(path)
        _assert_stats_equal(JStats.load(path), ps)
    # make_planner loads the file instead of generating
    assert popt.make_planner(None, path).stats.tyscount == js.tyscount


def _steps(pg):
    """A pattern group's plan, step by step, its UNION and OPTIONAL
    sub-groups included."""
    return ([(p.subject, p.predicate, int(p.direction), p.object)
             for p in pg.patterns],
            [_steps(u) for u in pg.unions], [_steps(o) for o in pg.optional])


def _plan_both(world, text):
    ss, jplanner, _jproxy, proxy = world
    qj = JParser(ss).parse(text)
    assert jplanner.generate_plan(qj)
    qp = proxy.parse(text)
    return qj, qp


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plans_and_estimates_match_jax(world, name):
    ss, jplanner, _jproxy, proxy = world
    qj, qp = _plan_both(world, SHAPES[name])
    assert _steps(qp.pattern_group) == _steps(qj.pattern_group)
    assert qp.planner_empty == qj.planner_empty
    # statistics cover the triples, not the attributes: the JAX planner
    # starts x_attr at its attribute predicate's (empty) index and proves
    # the query empty, and the port mirrors it
    assert qp.planner_empty == (name in ("x_empty", "x_attr"))
    pj, pp = qj.pattern_group.patterns, qp.pattern_group.patterns
    ej, ep = jplanner.estimate_chain(pj), proxy.planner.estimate_chain(pp)
    assert (ej is None) == (ep is None)
    if ej is not None:
        assert ep == pytest.approx(ej, rel=1e-12)
        assert proxy.planner.estimate_peak_rows(pp) == \
            jplanner.estimate_peak_rows(pj)
        assert proxy.planner.explain_steps(pp) == \
            pytest.approx(jplanner.explain_steps(pj), rel=1e-12)


@pytest.mark.parametrize("name", sorted(chip_smoke.TEMPLATES))
def test_templates_instantiate_and_plan_like_jax(world, name):
    """parse_template, fill_template and instantiate under one rng seed
    give equal queries, and the planner plans each instance alike."""
    ss, jplanner, jproxy, proxy = world
    text = chip_smoke.TEMPLATES[name]
    tj = JParser(ss).parse_template(text)
    tp = PParser(proxy.str_server).parse_template(text)
    assert (tp.ptypes, tp.pos) == (tj.ptypes, tj.pos)
    jproxy.fill_template(tj)
    proxy.fill_template(tp)
    assert all(np.array_equal(a, b)
               for a, b in zip(tp.candidates, tj.candidates))
    rj, rp = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(4):
        qj, qp = tj.instantiate(rj), tp.instantiate(rp)
        assert _steps(qp.pattern_group) == _steps(qj.pattern_group)
        assert jplanner.generate_plan(qj) and proxy.planner.generate_plan(qp)
        assert _steps(qp.pattern_group) == _steps(qj.pattern_group)
        assert qp.planner_empty == qj.planner_empty
    with pytest.raises(SPARQLSyntaxError):
        PParser(proxy.str_server).parse(text)
    with pytest.raises(SPARQLSyntaxError):
        PParser(proxy.str_server).parse_template(chip_smoke.QUERIES[name])


def _hand_query(mod_pattern, mod_query, pats):
    q = mod_query()
    q.pattern_group.patterns = [mod_pattern(*p) for p in pats]
    q.result.nvars = 2
    q.result.required_vars = [-1, -2]
    return q


@pytest.mark.parametrize("pats", [
    [(-1, TYPE_ID, OUT, 20), (-1, 4, OUT, -2), (-2, TYPE_ID, OUT, 22)],
    [(-1, 3, OUT, -2), (-2, TYPE_ID, OUT, 21)],
    [(-1, TYPE_ID, OUT, 22), (-1, 5, OUT, -2)],
], ids=["complex_typed", "untyped_subject", "literal_object"])
def test_plans_match_jax_on_complex_types(pats):
    triples = _hand_triples()
    jp = jopt.Planner(JStats.generate(triples))
    pp = popt.Planner(PStats.generate(triples))
    qj, qp = _hand_query(JPattern, JQuery, pats), _hand_query(
        PPattern, PQuery, pats)
    assert jp.generate_plan(qj) and pp.generate_plan(qp)
    assert _steps(qp.pattern_group) == _steps(qj.pattern_group)
    assert qp.planner_empty == qj.planner_empty
    ej = jp.estimate_chain(qj.pattern_group.patterns)
    assert pp.estimate_chain(qp.pattern_group.patterns) == \
        pytest.approx(ej, rel=1e-12)


@pytest.mark.parametrize("name,plan", [
    ("lubm_q3", "2 <\n1 >\n"),
    ("lubm_q4", "1 <\n2 >\n3 >\n4 >\n"),
    ("lubm_q6", "1 <\n"),
    ("lubm_q2", "1 <\n4 <\n2 >\n5 >\n3 >\n6 >\n"),
    ("lubm_q5", "1 <<\n1 >\n"),
    ("lubm_q5", "7 <\n"),  # pattern number out of range: refused
])
def test_set_plan_matches_jax(world, name, plan):
    ss, _jplanner, _jproxy, proxy = world
    qj = JParser(ss).parse(chip_smoke.QUERIES[name])
    qp = PParser(proxy.str_server).parse(chip_smoke.QUERIES[name])
    ok = jset_plan(qj.pattern_group, plan)
    assert pset_plan(qp.pattern_group, plan) == ok
    assert ok == (plan != "7 <\n")
    assert _steps(qp.pattern_group) == _steps(qj.pattern_group)


def test_proxy_plans_in_the_jax_order(world, monkeypatch):
    """The planner when enabled (a user plan is then ignored), else the
    user plan, else the heuristic; a malformed user plan is refused."""
    ss, jplanner, _jproxy, proxy = world
    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.utils.errors import ErrorCode, WukongError

    text, plan = chip_smoke.QUERIES["lubm_q4"], "1 <\n2 >\n3 >\n4 >\n"
    qj = JParser(ss).parse(text)
    jplanner.generate_plan(qj)
    assert _steps(proxy.parse(text, plan).pattern_group) == \
        _steps(qj.pattern_group)
    monkeypatch.setattr(Global, "enable_planner", False)
    qj = JParser(ss).parse(text)
    jset_plan(qj.pattern_group, plan)
    assert _steps(proxy.parse(text, plan).pattern_group) == \
        _steps(qj.pattern_group)
    with pytest.raises(WukongError) as e:
        proxy.parse(text, "9 >\n")
    assert e.value.code == ErrorCode.UNKNOWN_PLAN
