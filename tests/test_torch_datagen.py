"""The port's loader/datagen.py against the JAX package's: from the same seed
and sizes each cyclic-world generator gives the same triples, row for row,
and the same meta; the virtual string backend and the query text agree; the
N-Triples converter (``convert_dir``, with @prefix lines, typed literals and
seeded timestamps) and its CLI write the same directory byte for byte; and
``load_dataset`` builds the same partitions from it."""

import os

import numpy as np
import pytest

from wukong_tpu.loader import datagen as jdg
from wukong_tpu_torch.loader import datagen as pdg

CASES = [
    ("generate_triangle", {"m": 60, "noise": 3, "seed": 1}),
    ("generate_triangle", {"m": 2000, "noise": 4, "seed": 0}),
    ("generate_triangle", {"m": 7, "noise": 0, "seed": 5}),
    ("generate_diamond", {"m": 40, "noise": 2, "seed": 1}),
    ("generate_diamond", {"m": 192, "noise": 4, "seed": 3}),
    ("generate_clique4", {"n": 120, "fan": 6, "ncliques": 8, "seed": 1}),
    ("generate_clique4", {"n": 400, "fan": 8, "ncliques": 24, "seed": 2}),
]


@pytest.mark.parametrize("fn,kw", CASES,
                         ids=[f"{f}-{i}" for i, (f, _k) in enumerate(CASES)])
def test_generators_triple_for_triple(fn, kw):
    want, wmeta = getattr(jdg, fn)(**kw)
    got, gmeta = getattr(pdg, fn)(**kw)
    assert got.dtype == want.dtype == np.int64
    assert got.shape == want.shape
    assert np.array_equal(got, want)
    assert gmeta == wmeta
    assert pdg.cyclic_query_text(gmeta) == jdg.cyclic_query_text(wmeta)


@pytest.mark.parametrize("fn", ["generate_triangle", "generate_diamond",
                                "generate_clique4"])
def test_strings_agree(fn):
    _t, meta = getattr(pdg, fn)(seed=0)
    js, ps = jdg.CyclicStrings(meta), pdg.CyclicStrings(meta)
    names = ([f"<urn:cyc:p:{n}>" for n in meta["P"]]
             + [f"<urn:cyc:t:{n}>" for n in meta["T"]]
             + ["<http://www.w3.org/1999/02/22-rdf-syntax-ns#type>",
                "<urn:cyc:v:0>", "<urn:cyc:v:17>"])
    for s in names:
        assert ps.str2id(s) == js.str2id(s)
        assert ps.id2str(ps.str2id(s)) == js.id2str(js.str2id(s))
        assert ps.exist(s) and js.exist(s)
    assert not ps.exist("<urn:other>") and not js.exist("<urn:other>")


# ---------------------------------------------------------------------------
# N-Triples -> id triples (convert_dir and the CLI), and load_dataset
# ---------------------------------------------------------------------------

NT_A = """@prefix ub: <http://swat.cse.lehigh.edu/onto/univ-bench.owl#> .
@prefix ex: <http://example.org/> .
ex:alice <http://www.w3.org/1999/02/22-rdf-syntax-ns#type> ub:Student .
ex:alice ub:memberOf <http://example.org/dept0> .
ex:alice ub:age "21"^^xsd:int .
<http://example.org/bob> ub:advisor ex:carol .
ex:carol ub:height "1.75"^^<http://www.w3.org/2001/XMLSchema#float> .
short line
ex:carol <http://www.w3.org/1999/02/22-rdf-syntax-ns#type> ub:Professor .
"""
NT_B = """<http://example.org/dave> <http://swat.cse.lehigh.edu/onto/univ-bench.owl#memberOf> <http://example.org/dept0> .
<http://example.org/dave> <http://example.org/score> "2.5e3"^^xsd:double .
<http://example.org/dave> <http://example.org/name> "Dave Smith" .
"""


def _nt_dir(root):
    src = root / "nt"
    src.mkdir()
    (src / "part_a.nt").write_text(NT_A)
    (src / "part_b.nt").write_text(NT_B)
    (src / ".hidden").write_text("ignored\n")
    return src


def _same_tree(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.mark.parametrize("timestamps,ts_seed", [(0, 0), (5, 3)])
def test_convert_dir_byte_for_byte(tmp_path, timestamps, ts_seed):
    src = _nt_dir(tmp_path)
    want = jdg.convert_dir(str(src), str(tmp_path / "jax"), timestamps,
                           ts_seed)
    got = pdg.convert_dir(str(src), str(tmp_path / "port"), timestamps,
                          ts_seed)
    assert got == want and got["attr_vertex"] == 3
    _same_tree(tmp_path / "port", tmp_path / "jax")
    assert pdg._find_type('"1"^^xsd:int') == jdg._find_type('"1"^^xsd:int')
    with pytest.raises(ValueError):
        pdg._find_value("no quotes")


def test_cli_and_load_dataset(tmp_path, capsys):
    from wukong_tpu.loader import base as jbase
    from wukong_tpu_torch.loader import base as pbase
    from wukong_tpu_torch.store.persist import gstore_digest
    from wukong_tpu.store.persist import gstore_digest as jdigest

    src = _nt_dir(tmp_path)
    assert pdg.main([str(src), str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    assert jdg.main([str(src), str(tmp_path / "jax")]) == 0
    assert capsys.readouterr().out == out
    _same_tree(tmp_path / "port", tmp_path / "jax")
    stores = pbase.load_dataset(str(tmp_path / "port"), 2)
    jstores = jbase.load_dataset(str(tmp_path / "jax"), 2)
    assert [gstore_digest(g) for g in stores] == [jdigest(g)
                                                   for g in jstores]
    assert sum(len(g.attrs) for g in stores) == 3
