"""The distributed chain's collectives: the port's ``_exchange`` and
``_allgather_rows`` (torch ops over the shard slots' stacked tensors)
against the JAX functions inside ``shard_map`` on the 8-device virtual CPU
mesh, on seeded random tables — bit for bit in every live row, row count,
per-destination peak and received total. Cases cover an exchange capacity
that overflows, empty shards, full shards, and -1 values (a BLANK_ID
routed by the floored modulo)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from wukong_tpu.parallel import dist_engine as JD
from wukong_tpu.parallel.mesh import make_mesh as jmesh
from wukong_tpu_torch.parallel import dist_engine as PD

D = 8

try:
    from jax import shard_map
except ImportError:  # pre-0.5 JAX
    from jax.experimental.shard_map import shard_map


def _smap(fn, n_in, out):
    mesh = jmesh(D)
    kw = dict(mesh=mesh, in_specs=(P("x"),) * n_in, out_specs=out)
    try:
        return jax.jit(shard_map(fn, check_vma=False, **kw))
    except TypeError:
        return jax.jit(shard_map(fn, check_rep=False, **kw))


def jax_exchange(table, n, col, exch_cap, cap_new):
    def f(t, nn):
        out, m, em, tot = JD._exchange(t[0], nn[0], col, exch_cap, cap_new,
                                       D, "x")
        return out[None], m[None], em[None], tot[None]
    fn = _smap(f, 2, (P("x"),) * 4)
    return [np.asarray(a) for a in fn(jnp.asarray(table), jnp.asarray(n))]


def jax_allgather(table, n):
    def f(t, nn):
        out, m = JD._allgather_rows(t[0], nn[0], D, "x")
        return out[None], m[None]
    fn = _smap(f, 2, (P("x"),) * 2)
    return [np.asarray(a) for a in fn(jnp.asarray(table), jnp.asarray(n))]


def seeded_case(seed, W, C, ns, lo=-1, hi=1 << 20):
    rng = np.random.default_rng(seed)
    table = rng.integers(lo, hi, size=(D, W, C)).astype(np.int32)
    return table, np.asarray(ns, dtype=np.int32)


CASES = {
    # name: (seed, W, C, per-shard live counts, col, exch_cap, cap_new)
    "roomy": (0, 3, 256, [200, 13, 0, 256, 77, 128, 1, 90], 1, 64, 512),
    "exch_overflow": (1, 2, 256, [256] * 8, 0, 8, 256),
    "recv_overflow": (2, 2, 128, [128] * 8, 1, 128, 64),
    "empty_shards": (3, 1, 64, [0, 0, 0, 40, 0, 0, 0, 0], 0, 16, 64),
    "all_empty": (4, 2, 32, [0] * 8, 0, 8, 32),
    "blanks": (5, 3, 128, [100, 50, 128, 0, 3, 64, 127, 5], 2, 32, 256),
}


def _live(table, n):
    """Each shard's live rows as row tuples."""
    return [sorted(map(tuple, table[d][:, : int(n[d])].T.tolist()))
            for d in range(D)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_exchange_matches_jax(name, eight_cpu_devices):
    seed, W, C, ns, col, exch_cap, cap_new = CASES[name]
    lo = -1 if name == "blanks" else 0
    table, n = seeded_case(seed, W, C, ns, lo=lo,
                           hi=3 if name == "blanks" else 1 << 20)
    if name == "blanks":
        assert (table[:, col] == -1).any()
    jt, jn, jem, jtot = jax_exchange(table, n, col, exch_cap, cap_new)
    pt, pn, pem, ptot = (a.numpy() for a in PD._exchange(
        torch.from_numpy(table), torch.from_numpy(n), col, exch_cap,
        cap_new, D))
    assert np.array_equal(pn, jn) and np.array_equal(pem, jem)
    assert np.array_equal(ptot, jtot)
    # bit for bit: live rows in place, zeros past them
    assert np.array_equal(pt, jt)
    if name == "exch_overflow":
        assert (jem > exch_cap).any()
    if name == "recv_overflow":
        assert (jtot > cap_new).any() and (pn == cap_new).any()
    # every live row that fit reached its owner (floored modulo)
    if name == "roomy":
        got = _live(pt, pn)
        for d in range(D):
            assert all(int(r[col]) % D == d for r in got[d])
        assert sum(len(g) for g in got) == int(n.sum())


@pytest.mark.parametrize("name", ["roomy", "empty_shards", "all_empty",
                                  "blanks"])
def test_allgather_matches_jax(name, eight_cpu_devices):
    seed, W, C, ns, *_ = CASES[name]
    table, n = seeded_case(seed, W, C, ns)
    jt, jn = jax_allgather(table, n)
    pt, pn = PD._allgather_rows(torch.from_numpy(table), torch.from_numpy(n))
    for d in range(D):  # every JAX shard holds the same gathered table
        assert np.array_equal(pt.numpy(), jt[d])
        assert int(pn) == int(jn[d]) == int(n.sum())
