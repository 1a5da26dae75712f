"""K1 (the hash probe) in its staged form against the JAX package, bit for
bit: the port's build_hash_table, line_table and probe_kernel (its plain
version, on the CPU) against the JAX build_hash_table, _hash_find and
pallas_probe (interpret mode), on numpy-seeded tables and frontiers.

The cases are the inputs the CUDA kernel's design must get right: a dense
frontier where every row hits and about four rows share a bucket (as in
x_opt_heavy's OPTIONAL child), frontier keys of -1 against empty bucket
lanes, probes of three rounds and more, frontiers whose length is not a
multiple of the rows a thread owns, and n at 0, 1, C - 1 and C.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wukong_tpu.engine import tpu_kernels as JK
from wukong_tpu.engine.device_store import build_hash_table as jbuild
from wukong_tpu_torch.engine import tpu_kernels as K
from wukong_tpu_torch.engine.device_store import build_hash_table as tbuild
from wukong_tpu_torch.engine.device_store import line_table

# the suite runs several test processes side by side: keep torch's own
# thread pool small so it does not starve their timing-sensitive tests
torch.set_num_threads(2)

_HASH_MULT = np.uint32(2654435761)


def _table(kind: str, rng):
    """(keys, offsets, num_buckets or None) of a seeded segment."""
    if kind == "multi_round":
        # every key's home bucket is 0 of 8: later keys spill 3+ rounds on
        NB = 8
        cand = np.arange(1 << 17, (1 << 17) + 20000, dtype=np.int64)
        home = (cand.astype(np.uint32) * _HASH_MULT) & np.uint32(NB - 1)
        keys = np.sort(cand[home == 0][:30])
        return keys, np.arange(len(keys) + 1, dtype=np.int64) * 3, NB
    keys = np.sort(rng.choice(1 << 26, 2048, replace=False)).astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(rng.integers(0, 9, len(keys)))])
    return keys, offs, None


def _frontier(kind: str, keys, C: int, rng) -> np.ndarray:
    if kind == "dense":
        # sorted distinct keys, all hitting (np.unique order, as the OPTIONAL
        # stage dedups its parent rows); C <= len(keys)
        return np.sort(rng.choice(keys, C, replace=False)).astype(np.int32)
    if kind == "neg1":
        # -1 meets the empty lanes of its home bucket: found, (0, 0)
        cur = rng.choice(keys, C).astype(np.int32)
        cur[rng.random(C) < 0.4] = -1
        cur[rng.random(C) < 0.1] = 2**31 - 1
        return cur
    if kind == "multi_round":
        return np.concatenate([keys, keys + 1, [-1]] * (C // len(keys) + 1)
                              )[:C].astype(np.int32)
    hit = rng.random(C) < 0.6  # "mixed": hits and misses
    return np.where(hit, rng.choice(keys, C),
                    rng.integers(1 << 27, 1 << 28, C)).astype(np.int32)


# (table and frontier kind, C, n): C off the 4- and 8-row groups of a
# thread, n at 0, 1, C - 1 and C
CASES = [("dense", 2048, n) for n in ("C", "C-1", "1", "0")] + [
    ("neg1", 2048, "C"), ("neg1", 1023, "C-1"),
    ("multi_round", 1024, "C"), ("multi_round", 997, "C-1"),
    ("mixed", 1021, "C"), ("mixed", 1021, "C-1"), ("mixed", 1027, "1"),
    ("mixed", 6, "C"), ("mixed", 5, "0"),
]


@pytest.mark.parametrize("kind,C,n_at", CASES,
                         ids=[f"{k}-C{c}-n{n}" for k, c, n in CASES])
def test_probe_staged_matches_jax(kind, C, n_at):
    rng = np.random.default_rng(CASES.index((kind, C, n_at)))
    keys, offs, nb = _table(kind, rng)
    jkey, jstart, jdeg, jprobe = jbuild(keys, offs, nb)
    tkey, tstart, tdeg, tprobe = tbuild(keys, offs, nb)
    # the placement is the JAX one; the staged form: a bucket's keys then
    # the pairs of lanes 0-3 in one line, the pairs of lanes 4-7 apart
    for t, j in ((tkey, jkey), (tstart, jstart), (tdeg, jdeg)):
        assert np.array_equal(t, j)
    assert tprobe == jprobe
    bline, bhi = line_table(tkey, tstart, tdeg)
    NB = len(jkey)
    assert bline.shape == (NB, 16) and bhi.shape == (NB * 4, 2)
    assert np.array_equal(bline[:, :8], jkey)
    assert np.array_equal(bline[:, 8::2], jstart[:, :4])
    assert np.array_equal(bline[:, 9::2], jdeg[:, :4])
    assert np.array_equal(bhi.reshape(NB, 4, 2)[..., 0], jstart[:, 4:])
    assert np.array_equal(bhi.reshape(NB, 4, 2)[..., 1], jdeg[:, 4:])
    if kind == "multi_round":
        assert jprobe >= 3
    if kind in ("dense", "neg1"):
        assert len(keys) == 4 * jkey.shape[0]  # four keys a bucket
        assert (jkey == -1).any(axis=1).mean() > 0.9  # empty lanes to meet
        assert (jkey[:, 4:] != -1).any()  # and pairs kept apart, in bhi
    cur = _frontier(kind, keys, C, rng)
    if kind == "dense":  # every key: about four frontier rows a bucket
        hb = (cur.astype(np.uint32) * _HASH_MULT) & np.uint32(len(jkey) - 1)
        assert C / len(np.unique(hb)) > 3.5
    n = {"C": C, "C-1": C - 1, "1": 1, "0": 0}[n_at]

    jk, js, jd = (jnp.asarray(a.reshape(-1)) for a in (jkey, jstart, jdeg))
    want = JK._hash_find(jk, js, jd, jnp.asarray(cur), jnp.arange(C) < n,
                         jprobe)
    # pallas_probe takes whole 1,024-row tiles: pad the frontier past C
    Cp = -(-C // 1024) * 1024
    pad = np.zeros(Cp, np.int32)
    pad[:C] = cur
    pallas = JK.pallas_probe(jk, js, jd, jnp.asarray(pad), jnp.int32(n),
                             jprobe, interpret=True)
    got = K.probe_kernel(torch.from_numpy(bline), torch.from_numpy(bhi),
                         torch.from_numpy(cur), n, tprobe)
    assert got[0].dtype == torch.bool
    assert got[1].dtype == got[2].dtype == torch.int32
    for w, p, t in zip(want, pallas, got):
        w = np.asarray(w).astype(np.int64)
        assert np.array_equal(np.asarray(p).astype(np.int64)[:C], w)
        assert np.array_equal(t.numpy().astype(np.int64), w)
    found = got[0].numpy()
    assert not found[n:].any()
    if kind == "dense":
        assert found[:n].all()
    if kind == "neg1":
        neg = (cur == -1) & (np.arange(C) < n)
        assert neg.any() and found[neg].all()
        assert not got[1].numpy()[neg].any() and not got[2].numpy()[neg].any()


def _bad_table(kind: str):
    """A staged (bline, bhi) pair, broken as ``kind`` says."""
    keys = np.arange(0, 64, 3, dtype=np.int64)
    bline, bhi = (torch.from_numpy(a) for a in line_table(
        *tbuild(keys, np.arange(len(keys) + 1, dtype=np.int64))[:3]))
    NB = bline.shape[0]
    return {"ok": (bline, bhi),
            "int64": (bline.long(), bhi),
            "nb_not_pow2": (bline[:NB - 1], bhi[:(NB - 1) * 4]),
            "bhi_short": (bline, bhi[:-1]),
            "strided": (bline.t().contiguous().t(), bhi)}[kind]


@pytest.mark.parametrize("kind", ["ok", "int64", "nb_not_pow2", "bhi_short",
                                  "strided"])
def test_check_table(kind):
    """The staged form check that DeviceStore runs once a table: the
    tables line_table makes pass, and a table K1 would read out of bounds
    or misread raises."""
    bline, bhi = _bad_table(kind)
    if kind == "ok":
        K.check_table(bline, bhi)
    else:
        with pytest.raises(ValueError):
            K.check_table(bline, bhi)
