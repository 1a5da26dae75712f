"""The port's YAGO-shaped world (wukong_tpu_torch/loader/yago.py) against the
JAX package's: the same (n_person, seed) gives the same triples and layout,
the string backends agree on the constants the reference queries use, and
``chip_smoke.YAGO_QUERIES`` (yago_q1-q4, written from the module's
description) answer the same rows through the port's planner-backed proxy
(device="cpu") as through the JAX CPUEngine and TPUEngine under the JAX
planner — and as an independent nested-loop oracle."""

import numpy as np
import pytest
import torch

from bgp_oracle import TripleIndex, eval_bgp
from wukong_tpu.engine.cpu import CPUEngine
from wukong_tpu.engine.tpu import TPUEngine
from wukong_tpu.loader import yago as jy
from wukong_tpu.planner.optimizer import Planner as JPlanner
from wukong_tpu.planner.stats import Stats as JStats
from wukong_tpu.sparql.parser import Parser as JParser
from wukong_tpu.store.gstore import build_partition as jbuild
from wukong_tpu_torch.loader import yago as py
from wukong_tpu_torch.planner.optimizer import Planner
from wukong_tpu_torch.planner.stats import Stats
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.store.gstore import build_partition

from chip_smoke import YAGO_QUERIES

torch.set_num_threads(2)

N_PERSON, SEED = 20_000, 0


@pytest.fixture(scope="module")
def world():
    jt, _ = jy.generate_yago(N_PERSON, seed=SEED)
    pt, _ = py.generate_yago(N_PERSON, seed=SEED)
    jss = jy.YagoStrings(N_PERSON, SEED)
    jg = jbuild(jt, 0, 1)
    jstats = JStats.generate(jt)
    proxy = Proxy(build_partition(pt, 0, 1), py.YagoStrings(N_PERSON, SEED),
                  device="cpu", planner=Planner(Stats.generate(pt)))
    return jt, pt, jss, jg, jstats, proxy


@pytest.mark.parametrize("n_person,seed", [(800, 0), (20_000, 0),
                                           (5_000, 3)])
def test_generator_triple_for_triple(n_person, seed):
    want, _ = jy.generate_yago(n_person, seed=seed)
    got, _ = py.generate_yago(n_person, seed=seed)
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want)
    assert py.generate_yago_meta(n_person) == jy.generate_yago_meta(n_person)


def test_strings_agree():
    js, ps = jy.YagoStrings(N_PERSON, SEED), py.YagoStrings(N_PERSON, SEED)
    names = ["<Athens>", "<Albert_Einstein>", "<Person3>", "<City1>",
             "<University2>", "<Ext7>",
             "<http://www.w3.org/1999/02/22-rdf-syntax-ns#type>"]
    names += [f"<{jy.Y}{n}>" for n in list(jy.P) + list(jy.T)]
    for s in names:
        assert ps.str2id(s) == js.str2id(s)
        assert ps.id2str(ps.str2id(s)) == js.id2str(js.str2id(s))
    for bad in ("<Cityscape>", "<Person99999999>", "<NoSuchThing>"):
        assert ps.exist(bad) == js.exist(bad) is False


@pytest.mark.parametrize("qn", sorted(YAGO_QUERIES))
def test_yago_query_rows_equal_the_jax_engines(world, qn):
    jt, _pt, jss, jg, jstats, proxy = world
    text = YAGO_QUERIES[qn]
    q0 = JParser(jss).parse(text)
    raw = [(p.subject, p.predicate, p.object)
           for p in q0.pattern_group.patterns]
    req = list(q0.result.required_vars)
    want = sorted(eval_bgp(TripleIndex(jt), raw, req))
    assert want, f"{qn}: the world's witnesses must make it non-empty"

    got = proxy.serve_query(text, blind=False)
    assert got.result.status_code == 0
    pcols = [got.result.v2c_map[v] for v in req]
    assert sorted(map(tuple, got.result.table[:, pcols].tolist())) == want
    for eng in (CPUEngine(jg, jss), TPUEngine(jg, jss, stats=jstats)):
        q = JParser(jss).parse(text)
        JPlanner(jstats).generate_plan(q)
        eng.execute(q, from_proxy=False)
        assert int(q.result.status_code) == 0
        cols = [q.result.var2col(v) for v in req]
        assert sorted(map(tuple, np.asarray(
            q.result.table)[:, cols].tolist())) == want, type(eng)
