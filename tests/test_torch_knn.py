"""The port's k-NN operator (wukong_tpu_torch/vector/knn.py) against the JAX
package's on the same seeded inputs, on the CPU (the kernel's plain version;
the JAX device route is XLA on the CPU).

Tolerances: the sums run in another order than numpy's or XLA's, so scores
agree at rtol 1e-5, atol 1e-5 (float32 dot products of length <= 64); ids
are compared exactly on inputs whose scores around the top k differ by more
than 1e-3 (checked on each input in float64). Exact ties use integer-valued
vectors under the dot metric, where every sum is exact in float32 in any
order, so their order is compared bit for bit.

- ``knn_scan_plain`` equals the JAX ``_jit_scan`` (masked scores, then
  ``lax.top_k``) position for position, and ``topk_device`` over a staged
  block equals the JAX ``topk_device`` and ``topk_host``, for each metric;
- exact ties in slot order; k past the live rows, every slot dead, n = 0,
  k = n; the slot-list path; ``sliced_topk``'s merge equal to one scan;
- ``knn_scan_plain`` equals ``_jit_scan`` on the card's adversarial cases
  (``chip_smoke.knn_case_inputs`` at 1/64 of their rows), with phase 2's
  equality;
- the drill demotes a device scan to the host (scan, candidates, slices);
  any other exception raises.
"""

import threading

import numpy as np
import pytest
import torch

import chip_smoke
from wukong_tpu.vector import knn as jknn
from wukong_tpu.vector import vstore as jvstore
from wukong_tpu_torch.vector import knn
from wukong_tpu_torch.vector.vstore import VectorStore

RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def _no_drill():
    knn._DEVICE_FAIL_HOOK = None
    jknn._DEVICE_FAIL_HOOK = None
    yield
    knn._DEVICE_FAIL_HOOK = None
    jknn._DEVICE_FAIL_HOOK = None


def _data(n, d, seed, dead_every=7, cosine=False):
    """Seeded rows, a mask and an anchor. With ``cosine`` the rows sit at
    distinct angles to the anchor (cosines 2/n apart, random norms), since
    random rows put cosines closer than float error."""
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    alive = np.ones(n, dtype=bool)
    if dead_every:
        alive[::dead_every] = False
    vids = (np.arange(n, dtype=np.int64) * 3 + 11)
    anchor = rng.standard_normal(d).astype(np.float32)
    if cosine:
        u = anchor.astype(np.float64) / np.linalg.norm(anchor)
        w = vecs.astype(np.float64)
        w -= np.outer(w @ u, u)
        w /= np.linalg.norm(w, axis=1, keepdims=True)
        c = rng.permutation(np.linspace(-0.99, 0.99, n))
        rows = c[:, None] * u + np.sqrt(1 - c * c)[:, None] * w
        vecs = (rows * rng.uniform(0.5, 4.0, (n, 1))).astype(np.float32)
    return vids, vecs, alive, anchor


def _separated(vecs, alive, anchor, metric, k):
    """Every gap between the float64 scores of the k + 1 best live rows
    exceeds 1e-3, so their order cannot depend on summation order."""
    v = vecs.astype(np.float64)
    a = anchor.astype(np.float64)
    if metric == "dot":
        s = v @ a
    elif metric == "cosine":
        s = (v @ a) / (np.maximum(np.linalg.norm(v, axis=1), 1e-12)
                       * max(np.linalg.norm(a), 1e-12))
    else:
        s = -np.sum((v - a) ** 2, axis=1)
    top = np.sort(s[alive])[::-1][:k + 1]
    return len(top) < 2 or float(np.min(-np.diff(top))) > 1e-3


def _jax_scan(vecs, alive, anchor, k, metric):
    """The JAX device program on the padded block, as its topk_device
    builds it: (scores, positions)."""
    n = len(vecs)
    cap = jknn.pad_pow2(n)
    base = np.zeros((cap, vecs.shape[1]), dtype=np.float32)
    base[:n] = vecs
    mask = np.zeros(cap, dtype=bool)
    mask[:n] = alive
    s, i = jknn._jit_scan(metric, int(min(k, cap)))(base, mask, anchor)
    return np.asarray(s), np.asarray(i)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("metric", knn.KNN_METRICS)
@pytest.mark.parametrize("n,d,k,seed", [(300, 16, 10, 1), (257, 8, 12, 2),
                                        (1000, 64, 8, 3), (40, 4, 40, 4)])
def test_plain_scan_equals_jax_scan(metric, n, d, k, seed):
    vids, vecs, alive, anchor = _data(n, d, seed, cosine=metric == "cosine")
    assert _separated(vecs, alive, anchor, metric, k)
    s, i = knn.knn_scan_plain(_t(vecs), _t(alive), _t(anchor), k, metric)
    js, ji = _jax_scan(vecs, alive, anchor, k, metric)
    kk = min(k, n)
    assert s.dtype == torch.float32 and i.dtype == torch.int64
    assert tuple(s.shape) == tuple(i.shape) == (kk,)
    fin = np.isfinite(js[:kk])
    assert np.array_equal(np.isfinite(s.numpy()), fin)
    assert np.array_equal(i.numpy()[fin], ji[:kk][fin])
    np.testing.assert_allclose(s.numpy()[fin], js[:kk][fin], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("case", chip_smoke.knn_case_inputs(scale=1 / 64),
                         ids=lambda c: c[0])
def test_plain_scan_equals_jax_scan_on_the_kernel_cases(case):
    """The card's adversarial cases (chip_smoke phase 2, at 1/64 of their
    row counts): knn_scan_plain against the JAX _jit_scan on the same
    candidates, with phase 2's equality (chip_smoke.knn_agree: scores
    within 1e-5, ids exact where scores are 1e-3 apart, bit for bit on
    integer-valued input)."""
    _name, base, alive, anchor, k, metric, rows, slots, exact = case
    if slots is not None:
        sub, live = base[slots], alive[slots]
    else:
        lo, hi = (0, len(base)) if rows is None else rows
        sub, live = base[lo:hi], alive[lo:hi]
    got = knn.knn_scan_plain(_t(base), _t(alive), _t(anchor), k, metric,
                             rows, None if slots is None else _t(slots))
    kk = min(k, len(sub))
    assert tuple(got[0].shape) == tuple(got[1].shape) == (kk,)
    if kk == 0:
        return
    js, ji = _jax_scan(sub, live, anchor, kk + 1, metric)
    chip_smoke.knn_agree(got, (torch.from_numpy(np.array(js[:kk + 1])),
                               torch.from_numpy(np.array(ji[:kk + 1]))),
                         exact)


@pytest.mark.parametrize("metric", knn.KNN_METRICS)
def test_topk_device_equals_jax_device_and_host(metric):
    vids, vecs, alive, anchor = _data(500, 32, 5, cosine=metric == "cosine")
    k = 11
    assert _separated(vecs, alive, anchor, metric, k)
    blk = knn.stage_block(vids, vecs, alive, "cpu")
    gv, gs = knn.topk_device(blk, anchor, k, metric)
    jv, js = jknn.topk_device(vids, vecs, alive, anchor, k, metric)
    hv, hs = knn.topk_host(vids, vecs, alive, anchor, k, metric)
    jhv, jhs = jknn.topk_host(vids, vecs, alive, anchor, k, metric)
    assert np.array_equal(gv, jv) and np.array_equal(gv, hv)
    assert np.array_equal(hv, jhv) and np.array_equal(hs, jhs)
    np.testing.assert_allclose(gs, js, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gs, hs, rtol=RTOL, atol=ATOL)


def test_exact_ties_keep_slot_order_bit_for_bit():
    rng = np.random.default_rng(8)
    n, d = 600, 16
    vecs = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
    alive = rng.random(n) > 0.2
    anchor = rng.integers(-2, 3, size=d).astype(np.float32)
    vids = np.arange(n, dtype=np.int64) + 100
    for k in (1, 10, 77, n):
        s, i = knn.knn_scan_plain(_t(vecs), _t(alive), _t(anchor), k, "dot")
        js, ji = _jax_scan(vecs, alive, anchor, k, "dot")
        assert np.array_equal(i.numpy(), ji[:min(k, n)])
        assert np.array_equal(s.numpy(), js[:min(k, n)])  # bit for bit
        got = knn.topk_device(knn.stage_block(vids, vecs, alive, "cpu"),
                              anchor, k, "dot")
        want = knn.topk_host(vids, vecs, alive, anchor, k, "dot")
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        jv, jsc = jknn.topk_device(vids, vecs, alive, anchor, k, "dot")
        assert np.array_equal(got[0], jv) and np.array_equal(got[1], jsc)


def test_edge_cases():
    vids, vecs, alive, anchor = _data(20, 8, 9, dead_every=2)  # 10 live
    blk = knn.stage_block(vids, vecs, alive, "cpu")
    # k past the live rows: dead rows fill the scan's tail at -inf, and the
    # route keeps only the live ones
    s, i = knn.knn_scan_plain(blk.base, blk.alive, _t(anchor), 15, "l2")
    assert len(s) == 15 and np.isinf(s.numpy()[10:]).all()
    assert i.numpy()[10:].tolist() == [0, 2, 4, 6, 8]  # dead, in slot order
    v, _ = knn.topk_device(blk, anchor, 15, "l2")
    assert len(v) == 10 and np.array_equal(
        v, jknn.topk_device(vids, vecs, alive, anchor, 15, "l2")[0])
    # k = n
    s, i = knn.knn_scan_plain(blk.base, blk.alive, _t(anchor), 20, "dot")
    assert sorted(i.tolist()) == list(range(20))
    # every slot dead
    dead = knn.stage_block(vids, vecs, np.zeros(20, bool), "cpu")
    assert len(knn.topk_device(dead, anchor, 5, "cosine")[0]) == 0
    # n = 0
    empty = knn.stage_block(vids[:0], vecs[:0], alive[:0], "cpu")
    s, i = knn.knn_scan_plain(empty.base, empty.alive, _t(anchor), 5, "dot")
    assert len(s) == len(i) == 0
    assert len(knn.topk_device(empty, anchor, 5, "dot")[0]) == 0
    assert len(knn.topk_host(vids[:0], vecs[:0], alive[:0], anchor, 5,
                             "dot")[0]) == 0


def test_zero_vector_under_cosine_scores_zero():
    vids, vecs, alive, anchor = _data(30, 8, 10, dead_every=0)
    vecs[3] = 0.0
    s, i = knn.knn_scan_plain(_t(vecs), _t(alive), _t(anchor), 30,
                              "cosine")
    js, ji = _jax_scan(vecs, alive, anchor, 30, "cosine")
    assert s.numpy()[i.numpy().tolist().index(3)] == 0.0
    np.testing.assert_allclose(np.sort(s.numpy()), np.sort(js[:30]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", knn.KNN_METRICS)
def test_slot_list_path_equals_row_gather(metric):
    vids, vecs, alive, anchor = _data(400, 16, 12)
    rng = np.random.default_rng(13)
    slots = np.sort(rng.choice(400, size=90, replace=False)).astype(np.int64)
    s, i = knn.knn_scan_plain(_t(vecs), _t(alive), _t(anchor), 9, metric,
                              slots=_t(slots))
    s2, i2 = knn.knn_scan_plain(_t(vecs[slots]), _t(alive[slots]),
                                _t(anchor), 9, metric)
    assert np.array_equal(i.numpy(), i2.numpy())
    assert np.array_equal(s.numpy(), s2.numpy())
    # a row range is the same scan over the range's rows
    s3, i3 = knn.knn_scan_plain(_t(vecs), _t(alive), _t(anchor), 9, metric,
                                rows=(50, 250))
    s4, i4 = knn.knn_scan_plain(_t(vecs[50:250]), _t(alive[50:250]),
                                _t(anchor), 9, metric)
    assert np.array_equal(i3.numpy(), i4.numpy())
    assert np.array_equal(s3.numpy(), s4.numpy())


def _stores(n=300, dim=8, seed=3, dead_every=7):
    rng = np.random.default_rng(seed)
    vids = np.arange(n, dtype=np.int64) * 2 + 5
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    out = []
    for cls in (VectorStore, jvstore.VectorStore):
        vs = cls(0, 1, dim)
        vs.upsert(vids, vecs)
        vs.tombstone(vids[::dead_every])
        out.append(vs)
    return out


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("metric", knn.KNN_METRICS)
def test_rank_candidates_equals_jax(route, metric):
    port, jax_ = _stores()
    rng = np.random.default_rng(21)
    # repeats and ids the store lacks: np.unique drops the first, the
    # slot lookup the second
    cand = np.concatenate([rng.choice(port.vids, 120), [1, 3, 100001]])
    anchor = np.asarray(port.get(int(port.vids[1])))
    gv, gs, gd = knn.rank_candidates(port, cand, anchor, 7, metric,
                                     route=route)
    jv, js, jd = jknn.rank_candidates(jax_, cand, anchor, 7, metric,
                                      route=route)
    assert gd is None and jd is None
    assert np.array_equal(gv, jv)
    np.testing.assert_allclose(gs, js, rtol=RTOL, atol=ATOL)


class _ThreadPool:
    """A heavy lane that runs each submitted slice on its own thread."""

    def __init__(self):
        self.submitted = 0

    def submit(self, item, lane=None):
        assert lane == "heavy"
        self.submitted += 1
        threading.Thread(target=item.run, daemon=True).start()


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("parts", [2, 5])
def test_sliced_topk_equals_one_scan_and_jax(route, parts):
    port, jax_ = _stores(n=400)
    anchor = np.asarray(port.get(int(port.vids[8])))
    want_v, want_s, _ = knn.scan_topk(port, anchor, 9, "l2", route="host")
    pool = _ThreadPool()
    got_v, got_s, demoted = knn.sliced_topk(pool, port, anchor, 9, "l2",
                                            route, parts)
    assert pool.submitted == parts - 1 and demoted is None
    assert np.array_equal(got_v, want_v)
    np.testing.assert_allclose(got_s, want_s, rtol=RTOL, atol=ATOL)
    jv, _js, _jd = jknn.sliced_topk(_ThreadPool(), jax_, anchor, 9, "l2",
                                    route, parts)
    assert np.array_equal(got_v, jv)


def test_scan_topk_stages_once_per_version():
    port, _jax = _stores(n=100)
    anchor = np.asarray(port.get(int(port.vids[1])))
    knn.scan_topk(port, anchor, 5, "dot", route="device")
    blk = port._knn_block
    assert blk is not None and blk.version == port.version
    knn.scan_topk(port, anchor, 5, "dot", route="device")
    assert port._knn_block is blk
    port.upsert([7], np.ones((1, 8), np.float32))
    assert port._knn_block is None  # the upsert dropped the old staging
    got = knn.scan_topk(port, anchor, 5, "dot", route="device")
    assert port._knn_block.version == port.version
    want = knn.scan_topk(port, anchor, 5, "dot", route="host")
    assert np.array_equal(got[0], want[0])


def _boom():
    raise RuntimeError("injected device failure")


def test_the_drill_demotes_each_device_route_to_the_host():
    port, jax_ = _stores()
    anchor = np.asarray(port.get(int(port.vids[4])))
    want = knn.scan_topk(port, anchor, 5, "cosine", route="host")
    jwant = jknn.scan_topk(jax_, anchor, 5, "cosine", route="host")
    knn._DEVICE_FAIL_HOOK = _boom
    got = knn.scan_topk(port, anchor, 5, "cosine", route="device")
    assert got[2] == "RuntimeError" and np.array_equal(got[0], want[0])
    assert np.array_equal(got[0], jwant[0])
    cand = port.vids[::2]
    r = knn.rank_candidates(port, cand, anchor, 4, "dot", route="device")
    rh = knn.rank_candidates(port, cand, anchor, 4, "dot", route="host")
    assert r[2] == "RuntimeError" and np.array_equal(r[0], rh[0])
    s = knn.sliced_topk(_ThreadPool(), port, anchor, 7, "cosine", "device",
                        3)
    assert s[2] == "RuntimeError"
    assert np.array_equal(s[0], knn.scan_topk(port, anchor, 7, "cosine")[0])
    with pytest.raises(knn.DeviceDrill):  # the route function itself raises
        knn.topk_device(knn.staged_block(port, "cpu"), anchor, 3, "dot")


def test_any_other_device_failure_raises(monkeypatch):
    port, _jax = _stores()
    anchor = np.asarray(port.get(int(port.vids[4])))

    def broken(*a, **kw):
        raise torch.cuda.OutOfMemoryError("out of memory in the scan")

    monkeypatch.setattr(knn, "knn_scan", broken)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        knn.scan_topk(port, anchor, 5, "dot", route="device")
    with pytest.raises(torch.cuda.OutOfMemoryError):
        knn.rank_candidates(port, port.vids, anchor, 5, "dot",
                            route="device")
    with pytest.raises(torch.cuda.OutOfMemoryError):  # after one retry
        knn.sliced_topk(_ThreadPool(), port, anchor, 5, "dot", "device", 3)
    # the host route never touches the kernel
    assert len(knn.scan_topk(port, anchor, 5, "dot", route="host")[0]) == 5


def test_launch_counter_starts_at_zero_and_cpu_never_launches():
    port, _jax = _stores(n=50)
    before = knn.knn_scan.launches
    knn.scan_topk(port, np.asarray(port.get(int(port.vids[1]))), 3, "dot",
                  route="device")
    assert knn.knn_scan.launches == before  # a CPU block runs the plain scan


def test_pad_pow2_and_scores_equal_jax():
    for n in (0, 1, 1023, 1024, 1025, 70000):
        assert knn.pad_pow2(n) == jknn.pad_pow2(n)
    vids, vecs, alive, anchor = _data(50, 8, 14)
    for metric in knn.KNN_METRICS:
        assert np.array_equal(knn.scores(vecs, anchor[None], metric),
                              jknn.scores(vecs, anchor[None], metric))
