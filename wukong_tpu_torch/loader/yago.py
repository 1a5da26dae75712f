"""Yago-shaped dataset synthesizer + virtual string backend.

The reference's yago suite (scripts/sparql_query/yago/yago_q1-q4) runs
against a YAGO2 dump that cannot ship with the repository. This module
synthesizes a yago-SHAPED graph — the suite's predicate vocabulary
(livesIn / graduatedFrom / hasInternalWikipediaLinkTo /
hasExternalWikipediaLinkTo plus born/died), a power-law wiki-link graph,
city/university fan-ins — and a string backend that resolves the EXACT
constants the reference query files use (``<Athens>``,
``<Albert_Einstein>``), so the reference texts execute verbatim:

- yago_q1: ``?x livesIn <Athens>``       — const-object lookup
- yago_q2: shared-object join through ``<Albert_Einstein>``'s alma mater
- yago_q3: 3-hop self-join over the internal-link relation (the heavy)
- yago_q4: internal-link step between two external-link stars

Determinism contract matches loader/lubm.py: everything is a pure
function of (n_person, seed); the witnesses the queries need are forced
(<Athens> is the most-popular city; <Albert_Einstein> always graduated).

The port's copy of the JAX package's loader/yago.py. The four query texts
live in chip_smoke.py as ``YAGO_QUERIES``, written from the list above.
"""

from __future__ import annotations

import numpy as np

from wukong_tpu_torch.types import NORMAL_ID_START, PREDICATE_ID, TYPE_ID

Y = "http://yago-knowledge.org/resource/"

PRED_NAMES = [
    "livesIn", "graduatedFrom", "hasInternalWikipediaLinkTo",
    "hasExternalWikipediaLinkTo", "wasBornIn", "diedIn",
]
TYPE_NAMES = ["Person", "City", "University", "ExternalPage"]
P = {n: 2 + i for i, n in enumerate(PRED_NAMES)}
T = {n: 2 + len(PRED_NAMES) + i for i, n in enumerate(TYPE_NAMES)}


def _zipf_pick(rng, n_items: int, size: int) -> np.ndarray:
    """Zipf-ish popularity: item 0 most popular (the <Athens> contract)."""
    r = np.minimum(rng.zipf(1.6, size) - 1, n_items - 1)
    return r.astype(np.int64)


def generate_yago(n_person: int = 20_000, seed: int = 0):
    """Returns ([M,3] int64 triples, meta). Deterministic in (n_person, seed)."""
    rng = np.random.Generator(np.random.PCG64([seed, 77]))
    # ONE source of layout truth: YagoStrings resolves constants from the
    # same function, so the id map can never drift from the data
    m = generate_yago_meta(n_person)
    NC, NU, NE = m["NC"], m["NU"], m["NE"]
    city0, univ0, ext0, per0 = (m["city0"], m["univ0"], m["ext0"],
                                m["per0"])
    persons = per0 + np.arange(n_person)

    s_l, p_l, o_l = [], [], []

    def emit(s, p, o):
        s = np.asarray(s, dtype=np.int64)
        o = np.asarray(o, dtype=np.int64)
        s_l.append(s)
        p_l.append(np.full(len(s), p, dtype=np.int64))
        o_l.append(o)

    # rdf:type for every entity
    emit(city0 + np.arange(NC), TYPE_ID, np.full(NC, T["City"]))
    emit(univ0 + np.arange(NU), TYPE_ID, np.full(NU, T["University"]))
    emit(ext0 + np.arange(NE), TYPE_ID, np.full(NE, T["ExternalPage"]))
    emit(persons, TYPE_ID, np.full(n_person, T["Person"]))

    # livesIn: one city per person, zipf — <Athens> (city 0) is the hub
    emit(persons, P["livesIn"], city0 + _zipf_pick(rng, NC, n_person))
    # wasBornIn 80% / diedIn 25%
    m = rng.random(n_person) < 0.8
    emit(persons[m], P["wasBornIn"], city0 + _zipf_pick(rng, NC, int(m.sum())))
    m = rng.random(n_person) < 0.25
    emit(persons[m], P["diedIn"], city0 + _zipf_pick(rng, NC, int(m.sum())))
    # graduatedFrom: 60% of persons, 1-2 universities; person 0
    # (<Albert_Einstein>) ALWAYS graduates (yago_q2's witness)
    grad = rng.random(n_person) < 0.6
    grad[0] = True
    gs = persons[grad]
    k = rng.integers(1, 3, len(gs))
    emit(np.repeat(gs, k), P["graduatedFrom"],
         univ0 + _zipf_pick(rng, NU, int(k.sum())))
    # internal wiki links: person -> person, out-degree 1-6 (power-lawish
    # in-degree via zipf target pick) — yago_q3's 3-hop self-join fuel
    k = rng.integers(1, 7, n_person)
    src = np.repeat(persons, k)
    emit(src, P["hasInternalWikipediaLinkTo"],
         per0 + _zipf_pick(rng, n_person, len(src)))
    # external wiki links: 70% of persons, 1-3 external pages
    m = rng.random(n_person) < 0.7
    es = persons[m]
    k = rng.integers(1, 4, len(es))
    emit(np.repeat(es, k), P["hasExternalWikipediaLinkTo"],
         ext0 + _zipf_pick(rng, NE, int(k.sum())))

    triples = np.stack([np.concatenate(s_l), np.concatenate(p_l),
                        np.concatenate(o_l)], axis=1)
    # with-replacement draws can repeat an edge; the CSR store dedups
    # physically, so the triple SET is the dataset (matches the oracle)
    triples = np.unique(triples, axis=0)
    return triples, m


class YagoStrings:
    """O(1)-memory string<->id backend for the yago-shaped world (same
    role as VirtualLubmStrings: resolve query constants, render results).
    Resolves the reference files' exact constants: ``<Athens>`` = city 0,
    ``<Albert_Einstein>`` = person 0."""

    def __init__(self, n_person: int = 20_000, seed: int = 0):
        self.meta = generate_yago_meta(n_person)
        self._special = {"<Athens>": self.meta["city0"],
                         "<Albert_Einstein>": self.meta["per0"]}
        self._pred = {f"<{Y}{n}>": pid for n, pid in P.items()}
        self._type = {f"<{Y}{n}>": tid for n, tid in T.items()}
        self._pred["<http://www.w3.org/1999/02/22-rdf-syntax-ns#type>"] = \
            TYPE_ID
        self._pred["__PREDICATE__"] = PREDICATE_ID

    def str2id(self, s: str) -> int:
        for table in (self._special, self._pred, self._type):
            if s in table:
                return table[s]
        m = self.meta
        for prefix, base, count in (("<City", m["city0"], m["NC"]),
                                    ("<University", m["univ0"], m["NU"]),
                                    ("<Ext", m["ext0"], m["NE"]),
                                    ("<Person", m["per0"], m["n_person"])):
            if s.startswith(prefix) and s.endswith(">"):
                try:
                    i = int(s[len(prefix):-1])
                except ValueError:
                    continue  # "<Cityscape>" etc: not ours -> KeyError below
                if 0 <= i < count:
                    return base + i
        raise KeyError(s)

    def id2str(self, i: int) -> str:
        i = int(i)
        for s, v in self._special.items():
            if v == i:
                return s
        for table in (self._pred, self._type):
            for s, v in table.items():
                if v == i:
                    return s
        m = self.meta
        for name, base, count in (("City", m["city0"], m["NC"]),
                                  ("University", m["univ0"], m["NU"]),
                                  ("Ext", m["ext0"], m["NE"]),
                                  ("Person", m["per0"], m["n_person"])):
            if base <= i < base + count:
                return f"<{name}{i - base}>"
        raise KeyError(i)

    def exist(self, s: str) -> bool:
        try:
            self.str2id(s)
            return True
        except KeyError:
            return False

    def exist_id(self, i: int) -> bool:
        try:
            self.id2str(i)
            return True
        except KeyError:
            return False


def generate_yago_meta(n_person: int) -> dict:
    """Layout metadata without materializing triples (id math only)."""
    NC = max(n_person // 200, 8)
    NU = max(n_person // 500, 4)
    NE = max(n_person // 2, 16)
    base = NORMAL_ID_START
    return {"NC": NC, "NU": NU, "NE": NE, "n_person": n_person,
            "city0": int(base), "univ0": int(base + NC),
            "ext0": int(base + NC + NU), "per0": int(base + NC + NU + NE)}
