"""The port's WatDiv loader (wukong_tpu_torch/loader/watdiv.py) against the
JAX package's: from the same (scale, seed) the synthesizer gives the same
triples and layout, ``write_dataset`` writes the same directory byte for
byte, the virtual strings agree, and the twelve S/F templates, filled and
instantiated from one seed by each package's ``fill_template``, draw the same
constants and answer the same rows through the port's proxy (device="cpu":
every kernel's plain version) as through the JAX CPUEngine and TPUEngine
(run on the CPU, as the JAX tests run it)."""

import os

import numpy as np
import pytest
import torch

from wukong_tpu.engine.cpu import CPUEngine
from wukong_tpu.engine.tpu import TPUEngine
from wukong_tpu.loader import datagen as jdg
from wukong_tpu.loader import watdiv as jw
from wukong_tpu.planner.heuristic import heuristic_plan
from wukong_tpu.runtime.proxy import Proxy as JProxy
from wukong_tpu.sparql.parser import Parser as JParser
from wukong_tpu.store.gstore import build_partition as jbuild
from wukong_tpu_torch.loader import datagen as pdg
from wukong_tpu_torch.loader import watdiv as pw
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.sparql.parser import Parser
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.store.string_server import StringServer

import chip_smoke

torch.set_num_threads(2)

SCALE, SEED = 10, 0


@pytest.fixture(scope="module")
def world():
    jt, _ = jw.generate_watdiv(SCALE, seed=SEED)
    pt, _ = pw.generate_watdiv(SCALE, seed=SEED)
    jss = jw.VirtualWatdivStrings(SCALE, SEED)
    jg = jbuild(jt, 0, 1)
    jproxy = JProxy(jg, jss, CPUEngine(jg, jss), TPUEngine(jg, jss))
    ss = pw.VirtualWatdivStrings(SCALE, SEED)
    proxy = Proxy(build_partition(pt, 0, 1), ss, device="cpu")
    return jt, pt, jproxy, proxy


@pytest.mark.parametrize("scale,seed", [(1, 0), (10, 0), (37, 5)])
def test_generator_triple_for_triple(scale, seed):
    want, wl = jw.generate_watdiv(scale, seed=seed)
    got, gl = pw.generate_watdiv(scale, seed=seed)
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want)
    assert vars(gl) == vars(wl)


def test_write_dataset_byte_for_byte(tmp_path):
    jmeta = jw.write_dataset(str(tmp_path / "jax"), 5, seed=2, chunk_rows=7000)
    pmeta = pw.write_dataset(str(tmp_path / "port"), 5, seed=2, chunk_rows=7000)
    assert pmeta == jmeta
    for root, _dirs, files in os.walk(tmp_path / "jax"):
        rel = os.path.relpath(root, tmp_path / "jax")
        assert sorted(os.listdir(tmp_path / "port" / rel)) == sorted(
            os.listdir(root))
        for f in files:
            assert ((tmp_path / "port" / rel / f).read_bytes()
                    == (tmp_path / "jax" / rel / f).read_bytes()), f
    # the port's string server picks the virtual WatDiv backend from it
    ss = StringServer(str(tmp_path / "port"))
    vs = pw.VirtualWatdivStrings(5, 2)
    for s in ("<http://db.uwaterloo.ca/~galuc/wsdbm/User3>",
              "<http://purl.org/stuff/rev#hasReview>"):
        assert ss.str2id(s) == vs.str2id(s)


def test_strings_layout_and_templates_agree(world):
    jt, _pt, _jp, _p = world
    js, ps = jw.VirtualWatdivStrings(SCALE, SEED), pw.VirtualWatdivStrings(
        SCALE, SEED)
    assert pw.index_strings() == jw.index_strings()
    assert pw.TEMPLATES == jw.TEMPLATES
    assert pw.P == jw.P and pw.T == jw.T
    rng = np.random.default_rng(0)
    ids = np.unique(np.concatenate([jt[:, 0], jt[:, 2]]))
    for vid in rng.choice(ids, 200, replace=False).tolist():
        assert ps.exist_id(vid) == js.exist_id(vid)
        if js.exist_id(vid):
            assert ps.id2str(vid) == js.id2str(vid)
            assert ps.str2id(ps.id2str(vid)) == vid
    for bad in ("<http://db.uwaterloo.ca/~galuc/wsdbm/User99999999>",
                "<nothing>"):
        assert ps.exist(bad) == js.exist(bad) is False
    assert pdg.watdiv_cyclic_patterns() == jdg.watdiv_cyclic_patterns()


def _rows(table, cols=None):
    t = np.asarray(table)
    if cols is not None:
        t = t[:, cols]
    return sorted(map(tuple, t.tolist()))


@pytest.mark.parametrize("name", sorted(jw.TEMPLATES))
def test_template_rows_equal_the_jax_engines(world, name):
    _jt, _pt, jproxy, proxy = world
    jt = JParser(jproxy.str_server).parse_template(jw.TEMPLATES[name])
    jproxy.fill_template(jt)
    pt = Parser(proxy.str_server).parse_template(pw.TEMPLATES[name])
    proxy.fill_template(pt)
    for a, b in zip(pt.candidates, jt.candidates):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    jq = jt.instantiate(np.random.default_rng(3))
    pq = pt.instantiate(np.random.default_rng(3))
    pi, fld = pt.pos[0]
    const = getattr(pq.pattern_group.patterns[pi], fld)
    assert const == getattr(jq.pattern_group.patterns[pi], fld)
    # the port answers the filled text through its proxy
    text = chip_smoke.fill_text(pw.TEMPLATES[name], proxy.str_server, const)
    got = proxy.serve_query(text, blind=False)
    assert got.result.status_code == 0
    for eng in (jproxy.cpu, jproxy.tpu):
        q = JParser(jproxy.str_server).parse(text)
        heuristic_plan(q)
        q.result.blind = False
        eng.execute(q)
        assert int(q.result.status_code) == 0
        assert got.result.v2c_map == q.result.v2c_map
        assert _rows(got.result.table) == _rows(q.result.table), type(eng)
