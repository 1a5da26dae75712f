"""The port's cyclic worlds (wukong_tpu_torch/loader/datagen.py) against the
JAX package's: from the same seed and sizes each generator gives the same
triples, row for row, and the same meta; the virtual string backend and the
query text agree."""

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
