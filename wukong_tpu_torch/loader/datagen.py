"""Synthetic cyclic worlds for the tensor-join strategy.

The port's copy of the cyclic part of the JAX package's loader/datagen.py:
the triangle, diamond and 4-clique worlds (star/co-star hub relations where
every pairwise join is quadratic while the cyclic result stays linear), the
virtual string backend the parser needs for them, and each world's query
text. From the same seed the generators give the JAX triples bit for bit
(both draw from ``numpy.random.default_rng`` in the same order). The JAX
module's NT -> ID converter (``convert_dir``), vectors and WatDiv patterns
wait for ROADMAP §A 3 and §A 6.
"""

from __future__ import annotations


def _cyclic_meta(P: dict, T: dict, patterns: list, vars_: list) -> dict:
    return {"P": dict(P), "T": dict(T), "patterns": list(patterns),
            "vars": list(vars_)}


def _star_costar(rng, rows: list, pid: int, L, R, noise: int, m: int) -> None:
    """Append the AGM lower-bound hub relation {L[0]}xR ∪ Lx{R[0]} (plus
    ``noise*m`` random background edges) for one predicate — the instance
    where every pairwise join is quadratic while the cyclic result stays
    linear. Shared by the triangle and diamond worlds."""
    import numpy as np

    rows.append(np.column_stack([np.full(len(R), L[0]),
                                 np.full(len(R), pid), R]))
    rows.append(np.column_stack([L, np.full(len(L), pid),
                                 np.full(len(L), R[0])]))
    if noise > 0:
        k = noise * m
        rows.append(np.column_stack([rng.choice(L, k),
                                     np.full(k, pid), rng.choice(R, k)]))


def generate_triangle(m: int = 256, noise: int = 4, seed: int = 0):
    """Tripartite triangle world A--p1->B--p2->C with closing A--p3->C.

    Star/co-star hubs on all three relations (each relation ~2m edges, all
    pairwise joins Θ(m²), triangles Θ(m)) plus ``noise*m`` random edges per
    relation and per-entity type triples.
    """
    import numpy as np

    from wukong_tpu_torch.types import NORMAL_ID_START, TYPE_ID

    rng = np.random.default_rng(seed)
    P = {"p1": 2, "p2": 3, "p3": 4}
    T = {"A": 5, "B": 6, "C": 7}
    A = np.arange(NORMAL_ID_START, NORMAL_ID_START + m, dtype=np.int64)
    B, C = A + m, A + 2 * m
    rows = []
    _star_costar(rng, rows, P["p1"], A, B, noise, m)
    _star_costar(rng, rows, P["p2"], B, C, noise, m)
    _star_costar(rng, rows, P["p3"], A, C, noise, m)
    for t, part in ((T["A"], A), (T["B"], B), (T["C"], C)):
        rows.append(np.column_stack([part, np.full(m, TYPE_ID),
                                     np.full(m, t)]))
    triples = np.concatenate(rows).astype(np.int64)
    va, vb, vc = -1, -2, -3
    meta = _cyclic_meta(P, T, [(va, P["p1"], vb), (vb, P["p2"], vc),
                               (va, P["p3"], vc)], [va, vb, vc])
    return triples, meta


def generate_diamond(m: int = 192, noise: int = 4, seed: int = 0):
    """4-cycle world A--p1->B--p2->C--p3->D with closing A--p4->D (the
    diamond BGP), star/co-star hubs on every relation + noise + types."""
    import numpy as np

    from wukong_tpu_torch.types import NORMAL_ID_START, TYPE_ID

    rng = np.random.default_rng(seed)
    P = {"p1": 2, "p2": 3, "p3": 4, "p4": 5}
    T = {"A": 6, "B": 7, "C": 8, "D": 9}
    A = np.arange(NORMAL_ID_START, NORMAL_ID_START + m, dtype=np.int64)
    B, C, D = A + m, A + 2 * m, A + 3 * m
    rows = []
    _star_costar(rng, rows, P["p1"], A, B, noise, m)
    _star_costar(rng, rows, P["p2"], B, C, noise, m)
    _star_costar(rng, rows, P["p3"], C, D, noise, m)
    _star_costar(rng, rows, P["p4"], A, D, noise, m)
    for t, part in ((T["A"], A), (T["B"], B), (T["C"], C), (T["D"], D)):
        rows.append(np.column_stack([part, np.full(m, TYPE_ID),
                                     np.full(m, t)]))
    triples = np.concatenate(rows).astype(np.int64)
    va, vb, vc, vd = -1, -2, -3, -4
    meta = _cyclic_meta(P, T, [(va, P["p1"], vb), (vb, P["p2"], vc),
                               (vc, P["p3"], vd), (va, P["p4"], vd)],
                        [va, vb, vc, vd])
    return triples, meta


def generate_clique4(n: int = 400, fan: int = 8, ncliques: int = 24,
                     seed: int = 0):
    """Single-predicate world with planted (direction-consistent) 4-cliques
    in a random lower-id->higher-id background graph. The 4-clique BGP is
    the densest small cyclic shape (6 patterns over 4 vars)."""
    import numpy as np

    from wukong_tpu_torch.types import NORMAL_ID_START, TYPE_ID

    rng = np.random.default_rng(seed)
    P = {"p": 2}
    T = {"V": 3}
    V = np.arange(NORMAL_ID_START, NORMAL_ID_START + n, dtype=np.int64)
    src = np.repeat(V[:-1], fan)
    dst_off = rng.integers(1, np.maximum(n - 1 - (src - V[0]), 1) + 1)
    dst = src + dst_off  # strictly higher id: no 2-cycles
    rows = [np.column_stack([src, np.full(len(src), P["p"]), dst])]
    for _ in range(ncliques):
        picks = np.sort(rng.choice(n, 4, replace=False)) + V[0]
        for i in range(4):
            for j in range(i + 1, 4):
                rows.append(np.array([[picks[i], P["p"], picks[j]]]))
    rows.append(np.column_stack([V, np.full(n, TYPE_ID),
                                 np.full(n, T["V"])]))
    triples = np.concatenate(rows).astype(np.int64)
    v1, v2, v3, v4 = -1, -2, -3, -4
    pats = [(a, P["p"], b) for a, b in
            ((v1, v2), (v1, v3), (v1, v4), (v2, v3), (v2, v4), (v3, v4))]
    meta = _cyclic_meta(P, T, pats, [v1, v2, v3, v4])
    return triples, meta


class CyclicStrings:
    """Minimal virtual string backend for the synthetic cyclic worlds
    (``<urn:cyc:p:NAME>`` predicates, ``<urn:cyc:t:NAME>`` types,
    ``<urn:cyc:v:K>`` entities) — enough for the parser/proxy path."""

    def __init__(self, meta: dict):
        self._s2i = {f"<urn:cyc:p:{n}>": i for n, i in meta["P"].items()}
        self._s2i.update({f"<urn:cyc:t:{n}>": i
                          for n, i in meta["T"].items()})
        self._s2i["<http://www.w3.org/1999/02/22-rdf-syntax-ns#type>"] = 1
        self._i2s = {i: s for s, i in self._s2i.items()}

    def str2id(self, s: str) -> int:
        from wukong_tpu_torch.types import NORMAL_ID_START

        if s in self._s2i:
            return self._s2i[s]
        if s.startswith("<urn:cyc:v:") and s.endswith(">"):
            return NORMAL_ID_START + int(s[len("<urn:cyc:v:"):-1])
        raise KeyError(s)

    def id2str(self, i: int) -> str:
        from wukong_tpu_torch.types import NORMAL_ID_START

        if i in self._i2s:
            return self._i2s[i]
        return f"<urn:cyc:v:{i - NORMAL_ID_START}>"

    def exist(self, s: str) -> bool:
        try:
            self.str2id(s)
            return True
        except (KeyError, ValueError):
            return False

    def exist_id(self, i: int) -> bool:
        return True


def cyclic_query_text(meta: dict) -> str:
    """SPARQL text of a cyclic world's query (CyclicStrings vocabulary)."""
    p_name = {i: n for n, i in meta["P"].items()}

    def term(v: int) -> str:
        return f"?v{-v}" if v < 0 else f"<urn:cyc:p:{p_name[v]}>"

    sel = " ".join(f"?v{-v}" for v in meta["vars"])
    body = " ".join(f"{term(s)} <urn:cyc:p:{p_name[p]}> {term(o)} ."
                    for (s, p, o) in meta["patterns"])
    return f"SELECT {sel} WHERE {{ {body} }}"
