"""Generic heterogeneous RDF synthesizer (DBpedia-style mixed workloads).

The eval ladder ends at "DBpedia-2016, mixed L/C/F workload" (BASELINE.json).
Real DBpedia arrives as N-Triples through the generic NT->ID datagen
(loader/datagen.py); this module synthesizes a *DBpedia-shaped* graph for
testing at will: a long-tail (zipf) predicate distribution over hundreds of
predicates, a type system where a large fraction of entities are untyped or
multi-typed (exactly what the optimizer's complex-type machinery exists for,
stats.hpp:46-75), and hub entities with very high degree (the University0-style
hotspots that stress capacity-balanced shuffles).

The port's copy of the JAX package's loader/generic_rdf.py: the same
arguments give the same triples.
"""

from __future__ import annotations

import numpy as np

from wukong_tpu_torch.types import NORMAL_ID_START, TYPE_ID


def _ragged_arange(k: np.ndarray) -> np.ndarray:
    """[0..k0-1, 0..k1-1, ...] for per-entity type offsets."""
    total = int(k.sum())
    out = np.ones(total, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(k)[:-1]])
    out[starts] = np.concatenate([[0], 1 - k[:-1]])
    return np.cumsum(out)


def generate_generic(n_entities: int = 100_000, n_preds: int = 200,
                     n_types: int = 50, avg_deg: float = 8.0,
                     untyped_frac: float = 0.35, multityped_frac: float = 0.15,
                     hub_frac: float = 0.001, seed: int = 0):
    """Returns ([M,3] int64 triples, meta dict). Deterministic in the args."""
    rng = np.random.Generator(np.random.PCG64([seed, 11]))
    ent_base = NORMAL_ID_START
    ents = ent_base + np.arange(n_entities)
    pred_ids = 2 + np.arange(n_preds)
    type_ids = 2 + n_preds + np.arange(n_types)

    # ---- typing: most entities single-typed, a chunk untyped, some multi ----
    u = rng.random(n_entities)
    untyped = u < untyped_frac
    multi = (u >= untyped_frac) & (u < untyped_frac + multityped_frac)
    single = ~(untyped | multi)
    t_of = type_ids[rng.integers(0, n_types, n_entities)]
    ts = [ents[single]]
    to = [t_of[single]]
    # multi-typed entities get 2-3 DISTINCT types (offset trick: base + a
    # nonzero step mod n_types never repeats within 3 draws for n_types > 3)
    n_multi = int(multi.sum())
    if n_multi:
        k = rng.integers(2, 4, n_multi)
        base = rng.integers(0, n_types, n_multi)
        step = rng.integers(1, max(n_types // 3, 2), n_multi)
        rep_ent = np.repeat(ents[multi], k)
        j = _ragged_arange(k)
        tsel = (np.repeat(base, k) + j * np.repeat(step, k)) % n_types
        ts.append(rep_ent)
        to.append(type_ids[tsel])

    # ---- edges: zipf over predicates, hubs attract extra in-degree --------
    M = int(n_entities * avg_deg)
    zipf_p = np.minimum(rng.zipf(1.3, M) - 1, n_preds - 1)
    s = ents[rng.integers(0, n_entities, M)]
    o = ents[rng.integers(0, n_entities, M)]
    n_hubs = max(int(n_entities * hub_frac), 1)
    hubs = ents[rng.choice(n_entities, n_hubs, replace=False)]
    hub_mask = rng.random(M) < 0.05  # 5% of edges rewired into hubs
    o = np.where(hub_mask, hubs[rng.integers(0, n_hubs, M)], o)

    triples = np.concatenate([
        np.stack([np.concatenate(ts), np.full(sum(len(x) for x in ts), TYPE_ID),
                  np.concatenate(to)], axis=1),
        np.stack([s, pred_ids[zipf_p], o], axis=1),
    ])
    triples = np.unique(triples, axis=0)
    meta = {"n_entities": n_entities, "n_preds": n_preds, "n_types": n_types,
            "num_triples": int(len(triples)), "hubs": hubs[:8].tolist()}
    return triples, meta
