"""The port's distributed engine (device="cpu") against the JAX package's
DistEngine on its 8-device virtual CPU mesh: the chain cases of
tests/test_dist_engine.py (capacity classes and retries, learned classes,
skew-aware exchange capacities, deeper chains at LUBM-2, presharded loads,
mid-chain const and variable-predicate steps), each holding rows, status,
``complete``, chain stats and ``bytes_model`` equal to JAX's. The helpers
and the LUBM-1 world are test_torch_dist_engine.py's.
"""

import numpy as np

from test_torch_dist_engine import (  # noqa: F401 (fixtures)
    BASIC,
    DEPT0,
    UB,
    World,
    _pin_collective_route,
    check_text,
    jbap,
    jir,
    jmesh,
    JDist,
    PDist,
    pbap,
    pir,
    pl,
    run_mk,
    same,
    world,
)
from wukong_tpu.loader.lubm import VirtualLubmStrings
from wukong_tpu_torch.loader import generic_rdf as pgen


def test_dist_capacity_retry(world, monkeypatch):
    """Tiny capacity classes (cap_min 32): the classes, exchange
    capacities and retries of JAX's chain."""
    monkeypatch.setattr(world.jd, "cap_min", 32)
    monkeypatch.setattr(world.pd, "cap_min", 32)
    world.jd._fn_cache.clear()
    for d in (world.jd, world.pd):
        d._learned_caps.clear()
    pq = check_text(world, BASIC["lubm_q2"], blind=True)
    assert pq.result.nrows > 0
    for d in (world.jd, world.pd):
        d._learned_caps.clear()


def test_dist_larger_scale_deep_chain(eight_cpu_devices):
    """LUBM-2 (seed 9) across 8 shards: deeper chains, several exchanges,
    real skew."""
    w = World(2, 9)
    for qn in ("lubm_q1", "lubm_q7"):
        pq = check_text(w, BASIC[qn], blind=True)
        assert pq.result.status_code == 0 and pq.result.nrows > 0, qn


def test_dist_skew_aware_exchange_no_retry(eight_cpu_devices):
    """Hub-skewed exchanges: the multiplicity bound absorbs the hot
    destination on the first attempt, as in JAX, and the per-destination
    capacity covers the true hot multiplicity."""
    from wukong_tpu.loader.generic_rdf import generate_generic
    from wukong_tpu.types import TYPE_ID

    triples, _ = generate_generic(20_000, n_preds=8, n_types=4, seed=5)
    pt, _ = pgen.generate_generic(20_000, n_preds=8, n_types=4, seed=5)
    assert np.array_equal(triples, pt)
    jd = JDist(jbap(triples, 8), None, jmesh(8))
    pd = PDist(pbap(pt, 8), None, device="cpu")
    pids = [int(p) for p in np.unique(triples[:, 1]) if p != TYPE_ID][:2]

    def mk(ir, _ss=None):
        q = ir.SPARQLQuery()
        q.pattern_group.patterns = [ir.Pattern(pids[0], 0, 0, -1),
                                    ir.Pattern(-1, pids[0], 1, -2),
                                    ir.Pattern(-2, pids[1], 1, -3)]
        q.result.nvars = 3
        q.result.required_vars = [-1, -2, -3]
        return q

    jq, pq = mk(jir), mk(pir)
    jd.execute(jq, from_proxy=False)
    pd.execute(pq, from_proxy=False)
    same(jq, pq, jd, pd)
    assert pd.last_chain_stats["retries"] == 0
    plan = pd._build_plan(mk(pir), {}, n_steps=3)
    hub = triples[triples[:, 1] == pids[0]][:, 2]
    assert plan.steps[2].exch_cap >= int(np.bincount(hub - hub.min()).max())
    assert [s.exch_cap for s in plan.steps] == \
        [s.exch_cap for s in jd._build_plan(mk(jir), {}, n_steps=3).steps]


def test_preshard_multihost_load_matches_global(tmp_path, eight_cpu_devices):
    """2 hosts x 4 shards, each host built from its own file: segment for
    segment the global build, and answering as JAX's presharded cluster."""
    from wukong_tpu.loader.base import load_host_partitions as jlhp
    from wukong_tpu.loader.base import preshard_dataset as jpre
    from wukong_tpu_torch.loader.base import (
        load_host_partitions,
        load_triples,
        preshard_dataset,
    )

    src, ps, jps = tmp_path / "ds", tmp_path / "p", tmp_path / "j"
    pl.write_dataset(str(src), 1, seed=9)
    meta = preshard_dataset(str(src), str(ps), num_hosts=2,
                            shards_per_host=4)
    assert meta == jpre(str(src), str(jps), num_hosts=2, shards_per_host=4)
    for h in range(2):
        assert np.array_equal(np.load(ps / f"host{h:03d}_triples.npy"),
                              np.load(jps / f"host{h:03d}_triples.npy"))
    stores = [g for h in range(2) for g in load_host_partitions(str(ps), h)]
    assert [g.sid for g in stores] == list(range(8))
    assert any(g.attrs for g in stores)
    want = pbap(load_triples(str(src)), 8)
    for g, wg in zip(stores, want):
        assert set(g.segments) == set(wg.segments)
        for k in wg.segments:
            assert np.array_equal(g.segments[k].keys, wg.segments[k].keys)
            assert np.array_equal(g.segments[k].edges, wg.segments[k].edges)
    jstores = [g for h in range(2) for g in jlhp(str(jps), h)]
    w = World.__new__(World)
    w.jss = VirtualLubmStrings(1, seed=9)
    w.pss = pl.VirtualLubmStrings(1, seed=9)
    w.jd = JDist(jstores, w.jss, jmesh(8))
    w.pd = PDist(stores, w.pss, device="cpu")
    assert check_text(w, BASIC["lubm_q4"]).result.nrows > 0


def test_dist_versatile_probe_bound(eight_cpu_devices):
    """The versatile step probes at the COMBINED segment's own bound (3
    rounds on this world), not a default of 1."""
    from wukong_tpu.loader.generic_rdf import generate_generic
    from wukong_tpu.types import OUT, TYPE_ID

    triples, _ = generate_generic(20_000, n_preds=8, n_types=4, seed=5)
    pt, _ = pgen.generate_generic(20_000, n_preds=8, n_types=4, seed=5)
    jd = JDist(jbap(triples, 8), None, jmesh(8))
    pd = PDist(pbap(pt, 8), None, device="cpu")
    assert pd.sstore.versatile_segment(int(OUT)).max_probe > 1
    pid = [int(p) for p in np.unique(triples[:, 1]) if p != TYPE_ID][0]

    def mk(ir):
        q = ir.SPARQLQuery()
        q.pattern_group.patterns = [ir.Pattern(pid, 0, 0, -1),
                                    ir.Pattern(-1, -2, OUT, -3)]
        q.result.nvars = 3
        q.result.required_vars = [-1, -2, -3]
        return q

    jq, pq = mk(jir), mk(pir)
    jd.execute(jq, from_proxy=False)
    pd.execute(pq, from_proxy=False)
    same(jq, pq, jd, pd)
    assert pq.result.nrows > 0


def test_dist_c2k_mid_chain(world):
    from wukong_tpu_torch.types import IN, OUT, TYPE_ID

    def mk(ir, ss):
        fp = ss.str2id(f"<{UB}FullProfessor>")
        works = ss.str2id(f"<{UB}worksFor>")
        fp0 = ss.str2id("<http://www.Department0.University0.edu/"
                        "FullProfessor0>")
        q = ir.SPARQLQuery()
        q.pattern_group.patterns = [ir.Pattern(fp, TYPE_ID, IN, -1),
                                    ir.Pattern(-1, works, OUT, -2),
                                    ir.Pattern(fp0, works, OUT, -2)]
        q.result.nvars = 2
        q.result.required_vars = [-1, -2]
        return q

    jq, pq = run_mk(world, mk)
    same(jq, pq, world.jd, world.pd)
    assert pq.result.nrows > 0


def test_dist_seeded_union_c2k_branch(world):
    from wukong_tpu_torch.types import IN, OUT, TYPE_ID

    def mk(ir, ss):
        ap = ss.str2id(f"<{UB}AssociateProfessor>")
        works = ss.str2id(f"<{UB}worksFor>")
        q = ir.SPARQLQuery()
        q.pattern_group.patterns = [ir.Pattern(ap, TYPE_ID, IN, -1),
                                    ir.Pattern(-1, works, OUT, -2)]
        for d in (0, 1):
            c = ss.str2id(f"<http://www.Department{d}.University0.edu/"
                          "FullProfessor0>")
            u = ir.PatternGroup()
            u.patterns = [ir.Pattern(c, works, OUT, -2)]
            q.pattern_group.unions.append(u)
        q.result.nvars = 2
        q.result.required_vars = [-1, -2]
        return q

    jq, pq = run_mk(world, mk)
    same(jq, pq)
    assert pq.result.nrows > 0


def test_dist_versatile_const_shapes(world):
    """const_unknown_const and known_unknown_const: the owner-shard start
    and expand2 with its equality fold."""
    from wukong_tpu_torch.types import IN, OUT, TYPE_ID

    def shape(pats, req):
        def mk(ir, ss):
            ids = {"dept0": ss.str2id(DEPT0),
                   "univ0": ss.str2id("<http://www.University0.edu>"),
                   "fp": ss.str2id(f"<{UB}FullProfessor>"),
                   "works": ss.str2id(f"<{UB}worksFor>")}
            q = ir.SPARQLQuery()
            q.result.nvars = len(req)
            q.pattern_group.patterns = [
                ir.Pattern(*(ids.get(x, x) for x in p)) for p in pats]
            q.result.required_vars = list(req)
            return q
        return mk

    for pats, req in (
            ([("dept0", -9, OUT, "univ0")], [-9]),
            ([("dept0", -9, IN, -1), (-1, "works", OUT, -2)], [-9, -1, -2]),
            ([("fp", TYPE_ID, IN, -1), (-1, -9, OUT, "univ0")], [-1, -9]),
            ([("fp", TYPE_ID, IN, -1), (-1, -9, OUT, "univ0"),
              (-1, "works", OUT, -2)], [-1, -9, -2])):
        jq, pq = run_mk(world, shape(pats, req))
        same(jq, pq)
        assert pq.result.status_code == 0 and pq.result.nrows > 0, pats


def test_learned_caps_tighten_steady_state(world):
    """The second run of an exchange-bearing chain runs at the exact
    classes it learned (no larger than the first run's), as JAX's does; an
    undersized class injected on the learned chain retries back."""
    for d in (world.jd, world.pd):
        d._learned_caps.clear()
    check_text(world, BASIC["lubm_q7"], blind=True, from_proxy=False)
    st1 = world.pd.last_chain_stats
    assert world.pd._learned_caps == world.jd._learned_caps != {}
    check_text(world, BASIC["lubm_q7"], blind=True, from_proxy=False)
    st2 = world.pd.last_chain_stats
    assert all(b["cap"] <= a["cap"]
               for a, b in zip(st1["steps"], st2["steps"]))
    for s in st2["steps"]:
        assert s["rows_peak_shard"] <= s["cap"]
        if "exch_cap" in s:
            assert s["exch_peak_dest"] <= s["exch_cap"]
    # undersize the chain's widest step
    i = max(range(len(st2["steps"])),
            key=lambda k: st2["steps"][k]["rows_peak_shard"])
    world.jd.force_cap_override = {("cap", i): 2}
    world.pd.force_cap_override = {("cap", i): 2}
    check_text(world, BASIC["lubm_q7"], blind=True, from_proxy=False)
    assert world.pd.last_chain_stats["retries"] >= 1


def test_partitions_build_alike_on_threads(eight_cpu_devices):
    """build_all_partitions, its partitions built on host threads, builds
    partition for partition what JAX's sequential build does."""
    from wukong_tpu.loader.lubm import generate_lubm_attrs as jattrs

    pt, _ = pl.generate_lubm(1, seed=3)
    par = pbap(pt, 8, attr_triples=pl.generate_lubm_attrs(1, seed=3))
    want = jbap(pt, 8, attr_triples=jattrs(1, seed=3))
    for a, j in zip(par, want):
        assert a.sid == j.sid and set(a.segments) == set(j.segments)
        for k in a.segments:
            for f in ("keys", "offsets", "edges"):
                assert np.array_equal(getattr(a.segments[k], f),
                                      getattr(j.segments[k], f))
        assert set(a.index) == set(j.index)
        for k in a.index:
            assert np.array_equal(a.index[k], j.index[k])
        assert set(a.attrs) == set(j.attrs)
        for k in a.attrs:
            assert np.array_equal(a.attrs[k].keys, j.attrs[k].keys)
