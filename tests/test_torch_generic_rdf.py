"""The port's DBpedia-shaped world (wukong_tpu_torch/loader/generic_rdf.py)
against the JAX package's: the same arguments give the same triples; the
five dbpsb shapes that ``chip_smoke.dbpsb_shapes`` builds in the port's IR
(the JAX bench's, bench.py:2145-2175) and a seeded random-BGP fuzz (after
tests/test_generic_rdf.py) answer the same rows through the port's GPU
engine (device="cpu": every kernel's plain version) and host engine as
through the JAX CPUEngine and TPUEngine and an independent oracle, all
planned by each package's planner on one partition."""

import numpy as np
import pytest
import torch

from bgp_oracle import TripleIndex, eval_bgp
from wukong_tpu.engine.cpu import CPUEngine as JCPU
from wukong_tpu.engine.tpu import TPUEngine as JTPU
from wukong_tpu.loader import generic_rdf as jgr
from wukong_tpu.planner.optimizer import Planner as JPlanner
from wukong_tpu.planner.stats import Stats as JStats
from wukong_tpu.sparql import ir as jir
from wukong_tpu.store.checker import check_partition as jcheck
from wukong_tpu.store.gstore import build_partition as jbuild
from wukong_tpu_torch.engine.cpu import CPUEngine
from wukong_tpu_torch.engine.tpu import GPUEngine
from wukong_tpu_torch.loader import generic_rdf as pgr
from wukong_tpu_torch.planner.optimizer import Planner
from wukong_tpu_torch.planner.stats import Stats
from wukong_tpu_torch.sparql import ir as pir
from wukong_tpu_torch.store.checker import check_partition
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.types import OUT, TYPE_ID

import chip_smoke

torch.set_num_threads(2)

N_ENTITIES = 100_000
KW = {"n_preds": 200, "n_types": 50, "seed": 1}


@pytest.fixture(scope="module")
def world():
    jt, jmeta = jgr.generate_generic(N_ENTITIES, **KW)
    pt, pmeta = pgr.generate_generic(N_ENTITIES, **KW)
    jg, pg = jbuild(jt, 0, 1), build_partition(pt, 0, 1)
    jstats, pstats = JStats.generate(jt), Stats.generate(pt)
    return {"jt": jt, "meta": pmeta, "jg": jg, "pg": pg, "jstats": jstats,
            "pstats": pstats, "idx": TripleIndex(jt),
            "jcpu": JCPU(jg, None), "jtpu": JTPU(jg, None, stats=jstats),
            "cpu": CPUEngine(pg, None),
            "gpu": GPUEngine(pg, None, device="cpu", stats=pstats)}


@pytest.mark.parametrize("n,kw", [
    (N_ENTITIES, KW), (20_000, {"n_preds": 80, "n_types": 20, "seed": 5}),
    (3_000, {"seed": 0, "untyped_frac": 0.5, "hub_frac": 0.01})])
def test_generator_triple_for_triple(n, kw):
    want, wmeta = jgr.generate_generic(n, **kw)
    got, gmeta = pgr.generate_generic(n, **kw)
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want)
    assert gmeta == wmeta


def test_store_consistent_in_both(world):
    assert check_partition(world["pg"]) == jcheck(world["jg"]) == []


def _port_query(pats, nvars, distinct=False):
    q = pir.SPARQLQuery()
    q.pattern_group.patterns = [pir.Pattern(*p) for p in pats]
    q.result.nvars = nvars
    q.result.required_vars = [-(i + 1) for i in range(nvars)]
    q.distinct = distinct
    return q


def _jax_query(pats, nvars, distinct=False):
    q = jir.SPARQLQuery()
    q.pattern_group.patterns = [jir.Pattern(*p) for p in pats]
    q.result.nvars = nvars
    q.result.required_vars = [-(i + 1) for i in range(nvars)]
    q.distinct = distinct
    return q


def _run(eng, planner, q, req, from_proxy=False):
    assert planner.generate_plan(q)
    q.result.blind = False
    eng.execute(q, from_proxy=from_proxy)
    assert int(q.result.status_code) == 0, type(eng)
    cols = [q.result.var2col(v) for v in req]
    return sorted(map(tuple, np.asarray(q.result.table)[:, cols].tolist()))


@pytest.mark.parametrize("name", chip_smoke.DBPSB_SHAPES)
def test_dbpsb_shape_rows_equal_the_jax_engines(world, name):
    shapes = chip_smoke.dbpsb_shapes(world["jt"], world["meta"],
                                     world["pstats"])
    q0 = shapes[name]
    pats = [(p.subject, p.predicate, p.direction, p.object)
            for p in q0.pattern_group.patterns]
    nvars, dist = q0.result.nvars, bool(q0.distinct)
    req = list(q0.result.required_vars)
    outs = {}
    for label, eng, planner, mk in (
            ("gpu", world["gpu"], Planner(world["pstats"]), _port_query),
            ("cpu", world["cpu"], Planner(world["pstats"]), _port_query),
            ("jax cpu", world["jcpu"], JPlanner(world["jstats"]), _jax_query),
            ("jax tpu", world["jtpu"], JPlanner(world["jstats"]),
             _jax_query)):
        outs[label] = _run(eng, planner, mk(pats, nvars, dist), req,
                           from_proxy=True)
    assert outs["gpu"], f"{name}: the anchors must make it non-empty"
    if not dist:
        raw = [(s, p, o) for s, p, _d, o in pats]
        outs["oracle"] = sorted(eval_bgp(world["idx"], raw, req))
    for label, rows in outs.items():
        assert rows == outs["jax cpu"], f"{label} diverged on {name}"


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_random_bgps(world, seed):
    """Random connected BGPs (var-var or const-anchored starts, expansions,
    rdf:type filters, k2k closures, k2c consts), the JAX fuzz's generator:
    the port's GPU and host engines, the JAX CPUEngine and TPUEngine and
    the nested-loop oracle agree on each."""
    jt = world["jt"]
    rng = np.random.default_rng(1000 + seed)
    pids = [int(p) for p in np.unique(jt[:, 1]) if p != TYPE_ID]
    norm = jt[jt[:, 1] != TYPE_ID]
    typed = jt[jt[:, 1] == TYPE_ID]

    def random_bgp():
        n_pat = int(rng.integers(2, 5))
        row = norm[rng.integers(0, len(norm))]
        if rng.random() < 0.3:
            pats, bound, nxt = [(int(row[0]), int(row[1]), -1)], [-1], -2
        else:
            pats, bound, nxt = [(-1, int(row[1]), -2)], [-1, -2], -3
        for _ in range(n_pat - 1):
            a = int(rng.choice(bound))
            pid = int(rng.choice(pids))
            kind = rng.random()
            if kind < 0.45:
                pats.append((a, pid, nxt) if rng.random() < 0.5
                            else (nxt, pid, a))
                bound.append(nxt)
                nxt -= 1
            elif kind < 0.6:
                pats.append((a, int(TYPE_ID),
                             int(typed[rng.integers(0, len(typed)), 2])))
            elif kind < 0.8 and len(bound) >= 2:
                b = int(rng.choice([v for v in bound if v != a]))
                pats.append((a, pid, b))
            else:
                objs = norm[norm[:, 1] == pid][:, 2]
                pats.append((a, pid, int(objs[rng.integers(0, len(objs))])))
        return pats, sorted(set(bound), reverse=True)

    for _ in range(3):
        raw, req = random_bgp()
        want = sorted(eval_bgp(world["idx"], raw, req))
        pats = [(s, p, OUT, o) for s, p, o in raw]
        for label, eng, planner, mk in (
                ("gpu", world["gpu"], Planner(world["pstats"]), _port_query),
                ("cpu", world["cpu"], Planner(world["pstats"]), _port_query),
                ("jax cpu", world["jcpu"], JPlanner(world["jstats"]),
                 _jax_query),
                ("jax tpu", world["jtpu"], JPlanner(world["jstats"]),
                 _jax_query)):
            q = mk(pats, 0)
            q.result.nvars = len(req)
            q.result.required_vars = list(req)
            assert _run(eng, planner, q, req) == want, (label, raw)
