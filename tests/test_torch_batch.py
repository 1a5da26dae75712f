"""The port's batched serving path (device="cpu": every kernel's plain
version) against the JAX package's TPUEngine on LUBM-1 (seed 42) with
attributes, both planned by their type-centric planner over statistics of
the same triples, with Pallas in interpret mode where the JAX engine
streams. Const batches (merge on and off), their in-flight windows (one
template, mixed templates), index batches in replicate and slice mode, the
mt_factor carriers and the heavy window give exactly the JAX per-qid
counts; batch sizing, capacity walks and the capacity memo agree; guards
answer with the JAX error codes; and the proxy under the planner serves the
basic and extended suites with the JAX rows."""

import copy

import numpy as np
import pytest
import torch

import chip_smoke
from wukong_tpu.config import Global as JGlobal
from wukong_tpu.engine import tpu_stream as JS
from wukong_tpu.engine.tpu import TPUEngine
from wukong_tpu.loader.lubm import (
    VirtualLubmStrings,
    generate_lubm,
    generate_lubm_attrs,
)
from wukong_tpu.planner.heuristic import heuristic_plan as jheuristic
from wukong_tpu.planner.optimizer import Planner as JPlanner
from wukong_tpu.planner.plan_file import set_plan as jset_plan
from wukong_tpu.planner.stats import Stats as JStats
from wukong_tpu.runtime.proxy import Proxy as JProxy
from wukong_tpu.sparql.parser import Parser as JParser
from wukong_tpu.store.gstore import build_partition
from wukong_tpu.utils.errors import WukongError as JWukongError
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine import tpu_stream as S
from wukong_tpu_torch.engine.tpu import _mt_slice
from wukong_tpu_torch.loader import lubm as port_lubm
from wukong_tpu_torch.planner.heuristic import heuristic_plan
from wukong_tpu_torch.planner.optimizer import Planner
from wukong_tpu_torch.planner.plan_file import set_plan
from wukong_tpu_torch.planner.stats import Stats
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.sparql.parser import Parser
from wukong_tpu_torch.store.gstore import build_partition as port_build
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError

torch.set_num_threads(2)

TEMPLATES = sorted(chip_smoke.TEMPLATES)
HEAVY = list(chip_smoke.HEAVY)
EMPTY_INDEX = chip_smoke.PREFIX + """SELECT ?X ?Y WHERE {
    ?X rdf:type ub:GraduateStudent . ?X ub:worksFor ?Y . }"""


@pytest.fixture(scope="module")
def world():
    triples, _ = generate_lubm(1, seed=42)
    g = build_partition(triples, 0, 1,
                        attr_triples=generate_lubm_attrs(1, seed=42))
    ss = VirtualLubmStrings(1, seed=42)
    js = JStats.generate(triples)
    tpu = TPUEngine(g, ss, stats=js)
    pt, _ = port_lubm.generate_lubm(1, seed=42)
    pg = port_build(pt, 0, 1,
                    attr_triples=port_lubm.generate_lubm_attrs(1, seed=42))
    proxy = Proxy(pg, port_lubm.VirtualLubmStrings(1, seed=42), device="cpu",
                  planner=Planner(Stats.generate(pt)))
    return ss, JPlanner(js), tpu, JProxy(g, ss, tpu_engine=tpu), proxy


@pytest.fixture
def force_stream(monkeypatch):
    """Both packages take the stream arm for every merge-arm expand whose
    capacity is tile-aligned (the density gate off), the JAX one in
    interpret mode; the port's emit wrappers are counted."""
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


def _both(world, text):
    """(JAX query, port query), each planned by its own planner."""
    ss, jplanner, _tpu, _jproxy, proxy = world
    qj = JParser(ss).parse(text)
    jplanner.generate_plan(qj)
    return qj, proxy.parse(text)


def _template_batch(world, name, B=12, seed=3):
    """One instance of a light template planned in both packages (its plan
    must start from the placeholder's constant, as the emulator requires)
    and B constants drawn from the placeholder's candidates."""
    ss, jplanner, _tpu, jproxy, proxy = world
    text = chip_smoke.TEMPLATES[name]
    tj = JParser(ss).parse_template(text)
    tp = Parser(proxy.str_server).parse_template(text)
    jproxy.fill_template(tj)
    proxy.fill_template(tp)
    qj = tj.instantiate(np.random.default_rng(seed))
    qp = tp.instantiate(np.random.default_rng(seed))
    pi, fld = tp.pos[0]
    inst = getattr(qp.pattern_group.patterns[pi], fld)
    jplanner.generate_plan(qj)
    proxy._plan(qp)
    assert qp.pattern_group.patterns[0].subject == inst
    cand = tp.candidates[0]
    consts = np.asarray(cand[np.random.default_rng(seed).integers(
        0, len(cand), B)], dtype=np.int64)
    return qj, qp, consts, tp


def _single_rows(proxy, tp, const) -> int:
    """Rows of the template instance with its placeholder set to const,
    served alone."""
    q = copy.deepcopy(tp.query)
    pi, fld = tp.pos[0]
    setattr(q.pattern_group.patterns[pi], fld, int(const))
    proxy._plan(q)
    proxy.gpu.execute(q)
    assert q.result.status_code == 0
    return q.result.nrows


@pytest.mark.parametrize("merge", [True, False], ids=["merge", "no_merge"])
@pytest.mark.parametrize("name", TEMPLATES)
def test_const_batch_matches_jax(world, name, merge, monkeypatch):
    _ss, _jp, tpu, _jproxy, proxy = world
    monkeypatch.setattr(Global, "enable_merge_join", merge)
    monkeypatch.setattr(JGlobal, "enable_merge_join", merge)
    qj, qp, consts, tp = _template_batch(world, name)
    got = proxy.gpu.execute_batch(qp, consts).tolist()
    assert got == np.asarray(tpu.execute_batch(qj, consts)).tolist()
    assert got[:4] == [_single_rows(proxy, tp, c) for c in consts[:4]]
    assert sum(got) > 0


@pytest.mark.parametrize("name", ["lubm_q4", "lubm_q5"])
def test_const_batch_stream_arms_match_jax(world, name, force_stream):
    """Distinct constants stream through K2, repeated ones through K3."""
    _ss, _jp, tpu, _jproxy, proxy = world
    qj, qp, consts, _tp = _template_batch(world, name, B=8)
    for cs in (np.unique(consts), np.repeat(consts[:2], 3)):
        got = proxy.gpu.execute_batch(qp, cs).tolist()
        assert got == np.asarray(tpu.execute_batch(qj, cs)).tolist()
    assert force_stream["stream"] > 0 and force_stream["mhot"] > 0


def test_const_windows_match_jax(world):
    """execute_batch_many (K batches of one template, one read) and
    execute_batch_mixed (one flight over every template), warm and on a
    cold memo (overflowing batches re-run through the slow path)."""
    _ss, _jp, tpu, _jproxy, proxy = world
    jobs_j, jobs_p = [], []
    for name in TEMPLATES:
        qj, qp, consts, _tp = _template_batch(world, name)
        parts = [consts[:5], consts[5:], consts[::2]]
        want = [np.asarray(c).tolist()
                for c in tpu.execute_batch_many(qj, parts)]
        assert [c.tolist() for c in
                proxy.gpu.execute_batch_many(qp, parts)] == want
        jobs_j.append((qj, consts))
        jobs_p.append((qp, consts))
    want = [np.asarray(c).tolist() for c in tpu.execute_batch_mixed(jobs_j)]
    assert [c.tolist() for c in proxy.gpu.execute_batch_mixed(jobs_p)] \
        == want
    proxy.gpu.merge._cap_memo = type(proxy.gpu.merge._cap_memo)(4096)
    assert [c.tolist() for c in proxy.gpu.execute_batch_mixed(jobs_p)] \
        == want


@pytest.mark.parametrize("mode", ["rep", "slice"])
@pytest.mark.parametrize("name", HEAVY)
def test_index_batch_matches_jax(world, name, mode, force_stream):
    _ss, _jp, tpu, _jproxy, proxy = world
    qj, qp = _both(world, chip_smoke.QUERIES[name])
    single = proxy.serve_query(chip_smoke.QUERIES[name]).result.nrows
    sl = mode == "slice"
    for B in ((4, 8) if sl else (1, 3)):
        got = proxy.gpu.execute_batch_index(qp, B, slice_mode=sl).tolist()
        assert got == np.asarray(
            tpu.execute_batch_index(qj, B, slice_mode=sl)).tolist()
        assert (sum(got) == single) if sl else (got == [single] * B)
        # the merge executor's own slice and replicate modes
        got = proxy.gpu.merge.run_batch_index(qp, B, sl).tolist()
        assert got == np.asarray(tpu.merge.run_batch_index(qj, B, sl)).tolist()


@pytest.mark.parametrize("name", HEAVY)
def test_mt_factor_carriers_match_jax(world, name):
    """Three carrier copies of a heavy query, each pre-sliced to its part
    of the index; their counts sum to the whole query's rows. A carrier
    whose part is empty (q1 starts from LUBM-1's one university) answers
    zeros in the port; the JAX gather refuses an empty list, so such a
    carrier is held against the total only."""
    _ss, _jp, tpu, _jproxy, proxy = world
    single = proxy.serve_query(chip_smoke.QUERIES[name]).result.nrows
    total = 0
    for tid in range(3):
        qj, qp = _both(world, chip_smoke.QUERIES[name])
        qj.mt_factor = qp.mt_factor = 3
        qj.mt_tid = qp.mt_tid = tid
        got = proxy.gpu.execute_batch_index(qp, 2).tolist()
        p0 = qp.pattern_group.patterns[0]
        lo, hi = _mt_slice(len(proxy.g.get_index(p0.subject, p0.direction)),
                           3, tid)
        if hi > lo:
            assert got == np.asarray(tpu.execute_batch_index(qj, 2)).tolist()
        assert got[0] == got[1]
        total += got[0]
    assert total == single


@pytest.mark.parametrize("name", HEAVY)
def test_index_window_sizing_and_walk_match_jax(world, name):
    _ss, _jp, tpu, _jproxy, proxy = world
    qj, qp = _both(world, chip_smoke.QUERIES[name])
    want = [np.asarray(c).tolist()
            for c in tpu.execute_batch_index_many(qj, 2, 3)]
    assert [c.tolist() for c in
            proxy.gpu.execute_batch_index_many(qp, 2, 3)] == want
    assert proxy.gpu.suggest_index_batch(qp) == tpu.suggest_index_batch(qj)
    assert proxy.heavy_index_batch(qp) == min(tpu.suggest_index_batch(qj),
                                              Global.heavy_batch_max)
    for B, mode in ((2, "rep"), (4, "slice")):
        proxy.gpu.execute_batch_index(qp, B, slice_mode=mode == "slice")
        # both merges learn this (B, mode)'s capacities from their own run:
        # the engine's slice mode takes the direct path, not the merge
        proxy.gpu.merge.run_batch_index(qp, B, mode == "slice")
        tpu.merge.run_batch_index(qj, B, mode == "slice")
        pm, jm = proxy.gpu.merge, tpu.merge
        pp, jj = qp.pattern_group.patterns, qj.pattern_group.patterns

        def walk(m, pats):
            folds = m._plan_folds(pats, index_mode=True)
            return [(k, kind, fold, ci, co) for k, _p, kind, fold, ci, co
                    in m._walk_caps(pats, folds, True, B, mode)]
        assert walk(pm, pp) == walk(jm, jj)


def test_capacity_memo_learns_and_round_trips(world, tmp_path):
    """A second call of the same batch makes no retry; the memo written by
    save_cap_memo loads into a fresh engine, which then retries nothing."""
    _ss, _jp, _tpu, _jproxy, proxy = world
    _qj, qp, consts, _tp = _template_batch(world, "lubm_q7")
    merge = proxy.gpu.merge
    first = proxy.gpu.execute_batch(qp, consts).tolist()
    before = merge.total_retries
    assert proxy.gpu.execute_batch(qp, consts).tolist() == first
    assert merge.total_retries == before
    path = str(tmp_path / "cap_memo.json")
    merge.save_cap_memo(path)
    fresh = Proxy(proxy.g, proxy.str_server, device="cpu",
                  planner=proxy.planner)
    fresh.gpu.merge.load_cap_memo(path)
    assert dict(fresh.gpu.merge._cap_memo.items()) == \
        dict(merge._cap_memo.items())
    assert fresh.gpu.execute_batch(qp, consts).tolist() == first
    assert fresh.gpu.merge.total_retries == 0


def test_planner_empty_answers_zeros(world):
    _ss, _jp, tpu, _jproxy, proxy = world
    qj, qp = _both(world, EMPTY_INDEX)
    assert qp.planner_empty and qj.planner_empty
    for eng, q in ((proxy.gpu, qp), (tpu, qj)):
        assert np.asarray(eng.execute_batch_index(q, 3)).tolist() == [0] * 3
        assert [np.asarray(c).tolist() for c in
                eng.execute_batch_index_many(q, 2, 2)] == [[0, 0]] * 2


@pytest.mark.parametrize("shape,plan,entry", [
    ("x_vers_kuu", None, "const"), ("x_attr", None, "const"),
    ("lubm_q5", "1 >\n", "const"), ("lubm_q5", None, "index"),
    ("x_vers_kuu", None, "index"),
], ids=["variable_predicate", "attribute_step", "non_const_start",
        "const_start_as_index", "versatile_as_index"])
def test_unsupported_batch_shapes_raise_jax_codes(world, shape, plan, entry):
    """Each batch entry point refuses a plan it cannot run with the JAX
    error code. The plans are the heuristic's, or (non_const_start) a user
    plan that keeps q5's pattern as written, from its variable subject."""
    ss, _jp, tpu, _jproxy, proxy = world
    text = {**chip_smoke.QUERIES, **chip_smoke.EXT_QUERIES}[shape]
    qj = JParser(ss).parse(text)
    qp = Parser(proxy.str_server).parse(text)
    if plan is None:
        jheuristic(qj)
        heuristic_plan(qp)
    else:
        assert jset_plan(qj.pattern_group, plan)
        assert set_plan(qp.pattern_group, plan)
    consts = np.full(2, 1 << 17, dtype=np.int64)
    runs = {"const": (lambda e, q: e.execute_batch(q, consts),
                      lambda e, q: e.execute_batch_many(q, [consts]),
                      lambda e, q: e.execute_batch_mixed([(q, consts)])),
            "index": (lambda e, q: e.execute_batch_index(q, 2),
                      lambda e, q: e.execute_batch_index(q, 2, True),
                      lambda e, q: e.execute_batch_index_many(q, 2, 2))}
    for run in runs[entry]:
        with pytest.raises(JWukongError) as je:
            run(tpu, qj)
        with pytest.raises(WukongError) as pe:
            run(proxy.gpu, qp)
        assert int(pe.value.code) == int(je.value.code)


def _rows(res):
    t = res.table.tolist()
    if res.attr_table.size:
        t = [r + a for r, a in zip(t, res.attr_table.tolist())]
    return t


@pytest.mark.parametrize("name", sorted({**chip_smoke.QUERIES,
                                         **chip_smoke.EXT_QUERIES}))
def test_planned_proxy_serves_suites_like_jax(world, name):
    _ss, _jp, tpu, _jproxy, proxy = world
    text = {**chip_smoke.QUERIES, **chip_smoke.EXT_QUERIES}[name]
    qj, _qp = _both(world, text)
    tpu.execute(qj)
    got = proxy.serve_query(text)
    assert int(got.result.status_code) == int(qj.result.status_code)
    if name == "x_union_index":
        # the JAX planner returns at once on a group with no patterns of
        # its own, so the UNION branches keep their parsed form, which no
        # engine starts from: both answer UNKNOWN_PATTERN
        assert got.result.status_code == ErrorCode.UNKNOWN_PATTERN
        return
    assert int(got.result.status_code) == 0
    if name in chip_smoke.ORDERED:
        assert _rows(got.result) == _rows(qj.result)
    else:
        assert sorted(_rows(got.result)) == sorted(_rows(qj.result))
    assert got.result.v2c_map == qj.result.v2c_map


def test_stream_arm_bound_holds(world, force_stream, monkeypatch):
    """The merge executor's host bounds on a streamed frontier's key
    multiplicity (the stream arm's choice, read from no device value) hold:
    ``mult`` is never below the most rows a matched key has, and
    ``mult_lo`` never above the fewest: const batches with repeated
    constants, and replicate index batches."""
    _ss, _jp, _tpu, _jproxy, proxy = world
    seen = []
    orig = S.stream_expand

    def checked(skey, sstart, sdeg, edges, cur, n, live, cap_out, mult,
                **kw):
        deg = dict(zip(skey.tolist(), sdeg.tolist()))
        nn = int(n)
        keys = [k for k, ok in zip(cur[:nn].tolist(), live[:nn].tolist())
                if ok and deg.get(k, 0) > 0]
        counts = np.unique(keys, return_counts=True)[1] if keys else [0]
        seen.append((mult, int(max(counts)), kw.get("mult_lo", 1),
                     int(min(counts)) if keys else None))
        return orig(skey, sstart, sdeg, edges, cur, n, live, cap_out, mult,
                    **kw)

    monkeypatch.setattr(S, "stream_expand", checked)
    for name in ("lubm_q4", "lubm_q5"):
        _qj, qp, consts, _tp = _template_batch(world, name, B=8)
        for cs in (np.unique(consts), np.repeat(consts[:2], 3)):
            proxy.gpu.execute_batch(qp, cs)
    for name in HEAVY:
        q = proxy.parse(chip_smoke.QUERIES[name])
        proxy.gpu.execute_batch_index(q, 3)
    assert seen and any(t > 1 for _m, t, _lo, _f in seen)
    assert any(lo > 1 for _m, _t, lo, _f in seen)
    assert all(m is None or m >= t for m, t, _lo, _f in seen), seen
    assert all(f is None or lo <= f for _m, _t, lo, f in seen), seen
