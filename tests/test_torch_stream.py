"""The port's streaming plane (Wukong+S) against the JAX package's.

- windows: ``SupportIndex``, ``WindowSpec`` and ``EpochWindow`` answer the
  same sequences the same way;
- the epoch frontier: the port's ``seed_masks`` / ``seed_extract`` /
  ``unique_rows_padded`` on CPU tensors equal the JAX package's host twins
  and its jitted functions on JAX's CPU (mask; live prefix and count), over
  T = 1-5 terms, repeated variables, constant endpoints, empty epochs, ids
  at 2^31 - 1 and padded N; ``device_seed_*`` degrade to the host masks on
  ``DeviceRangeError`` only, any other error reaches the caller;
- ``ContinuousEngine`` / ``StreamContext`` give the same ``ResultDelta``s,
  epoch by epoch, as the JAX package's over the same base and epochs:
  plain and windowed queries (retraction, ``base_triples``), the pool's
  stream lane, callbacks, ``prune``, registration refusals;
- the proxy's stream verbs, checkpoints with standing queries and the
  replay of ``epoch`` WAL records, the monitor's stream stats, the pool's
  stream lane and the ingest sources.

Every input is LUBM-1 built inline from a seed, or numpy from a seed.
"""

import os

import numpy as np
import pytest
import torch

from wukong_tpu.config import Global as JGlobal
from wukong_tpu.engine.cpu import CPUEngine as JCPUEngine
from wukong_tpu.join import kernels as jk
from wukong_tpu.loader import lubm as jlubm
from wukong_tpu.runtime.monitor import Monitor as JMonitor
from wukong_tpu.runtime.proxy import Proxy as JProxy
from wukong_tpu.store import wal as jwal
from wukong_tpu.store.gstore import build_partition as jbuild
from wukong_tpu.stream import FileSource as JFileSource
from wukong_tpu.stream import ReplaySource as JReplaySource
from wukong_tpu.stream import StreamContext as JStreamContext
from wukong_tpu.stream import windows as jwin
from wukong_tpu.stream.continuous import match_delta as jmatch_delta
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.engine.cpu import CPUEngine
from wukong_tpu_torch.join import kernels as K
from wukong_tpu_torch.loader import lubm as plubm
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.runtime.monitor import Monitor
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.runtime.scheduler import EnginePool
from wukong_tpu_torch.store import wal
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.stream import (
    FileSource,
    ReplaySource,
    StreamContext,
    continuous,
    windows,
)
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError

torch.set_num_threads(2)

PREFIX = """
PREFIX rdf: <http://www.w3.org/1999/02/22-rdf-syntax-ns#>
PREFIX ub: <http://swat.cse.lehigh.edu/onto/univ-bench.owl#>
"""
Q_ONEHOP = PREFIX + "SELECT ?X ?Y WHERE { ?X ub:memberOf ?Y . }"
Q_CHAIN = PREFIX + """SELECT ?X ?Y ?Z WHERE {
    ?X ub:memberOf ?Y . ?Y ub:subOrganizationOf ?Z . }"""
Q_CONST = PREFIX + """SELECT ?X WHERE {
    ?X ub:worksFor <http://www.Department0.University0.edu> .
    ?X rdf:type ub:FullProfessor . }"""
Q_ADVISOR = PREFIX + """SELECT ?X ?Y WHERE { ?X ub:advisor ?Y .
    ?Y ub:worksFor <http://www.Department0.University0.edu> . }"""
Q_FILTER = PREFIX + """SELECT ?X ?Y ?Z WHERE {
    ?X ub:advisor ?Y . ?X ub:memberOf ?Z . FILTER ( ?Y != ?Z ) }"""
Q_SELF = PREFIX + "SELECT ?X WHERE { ?X ub:advisor ?X . ?X ub:memberOf ?Y }"
PLAIN = {"onehop": Q_ONEHOP, "chain": Q_CHAIN, "const": Q_CONST,
         "advisor": Q_ADVISOR, "filter": Q_FILTER, "self": Q_SELF}


@pytest.fixture(scope="module")
def world():
    triples, _ = plubm.generate_lubm(1, seed=42)
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(triples))
    n = int(len(triples) * 0.7)
    return triples[perm[:n]], triples[perm[n:]]


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    for G in (Global, JGlobal):
        for k in ("template_device", "join_device",
                  "join_device_min_candidates", "wal_dir",
                  "checkpoint_dir", "enable_result_cache"):
            monkeypatch.setattr(G, k, getattr(G, k))
    yield


def _strings():
    return (plubm.VirtualLubmStrings(1, seed=42),
            jlubm.VirtualLubmStrings(1, seed=42))


def _deltas(ctx, qid):
    return [(d.epoch, d.sign, d.rows.tolist()) for d in ctx.poll(qid)]


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,slide", [(1, 1), (3, 1), (4, 4), (5, 2)])
def test_epoch_windows_equal(size, slide):
    pw = windows.EpochWindow(spec=windows.WindowSpec(size, slide))
    jw = jwin.EpochWindow(spec=jwin.WindowSpec(size, slide))
    for e in range(1, 14):
        t = np.full((e % 3, 3), e, dtype=np.int64)
        a, b = pw.add(e, t), jw.add(e, t)
        assert [x for x, _ in a] == [x for x, _ in b]
        assert pw.live_epochs() == jw.live_epochs()
        assert np.array_equal(pw.live_triples(), jw.live_triples())
    assert windows.WindowSpec.tumbling(4) == windows.WindowSpec(4, 4)
    for bad in ((0, 1), (2, 3), (2, 0)):
        with pytest.raises(ValueError):
            windows.WindowSpec(*bad)
        with pytest.raises(ValueError):
            jwin.WindowSpec(*bad)


def test_support_index_equal():
    ps, js = windows.SupportIndex(), jwin.SupportIndex()
    rng = np.random.default_rng(5)
    for idx in (ps, js):
        idx.note_base({(0,), (1,)})
    for e in range(1, 9):
        rows = {(int(x),) for x in rng.integers(0, 12, 6)}
        ps.note_epoch(e, rows)
        js.note_epoch(e, rows)
        if e % 3 == 0:
            assert ps.retire([e - 2, e - 1]) == js.retire([e - 2, e - 1])
        assert ps.counts == js.counts
    assert [ps.support_of((k,)) for k in range(12)] == \
        [js.support_of((k,)) for k in range(12)]
    ps.reset()
    js.reset()
    assert ps.base == js.base and not ps.counts and not js.by_epoch


# ---------------------------------------------------------------------------
# the epoch frontier
# ---------------------------------------------------------------------------

def _frontier_case(rng, n, T, big=False):
    hi = 2**31 - 1
    s = rng.integers(0, 9, n).astype(np.int32)
    p = rng.integers(1, 5, n).astype(np.int32)
    o = rng.integers(0, 9, n).astype(np.int32)
    if big and n:
        s[: n // 3] = hi
        o[n // 4: n // 2] = hi
    npad = K.pad_pow2(n, floor=8) if n else 8
    cols = [np.full(npad, -1, dtype=np.int32) for _ in range(3)]
    for c, v in zip(cols, (s, p, o)):
        c[:n] = v
    tp = rng.integers(1, 5, T).astype(np.int32)
    ts = np.where(rng.random(T) < 0.3, rng.integers(0, 9, T),
                  -1).astype(np.int32)
    to = np.where(rng.random(T) < 0.3, rng.integers(0, 9, T),
                  -1).astype(np.int32)
    if big:
        ts[0] = hi
    eq = (rng.random(T) < 0.3) & (ts < 0) & (to < 0)
    ca = np.where(ts < 0, 0, 2).astype(np.int32)
    cb = np.where(to < 0, 2, ca).astype(np.int32)
    return (*cols, tp, ts, to, eq, ca, cb)


CASES = [(0, 1, False), (1, 1, False), (7, 2, False), (64, 3, True),
         (200, 4, False), (333, 5, True), (1024, 5, False)]


@pytest.mark.parametrize("n,T,big", CASES)
def test_seed_masks_and_extract_equal_jax(n, T, big):
    rng = np.random.default_rng(n * 7 + T)
    s, p, o, tp, ts, to, eq, ca, cb = _frontier_case(rng, n, T, big)
    t = [torch.from_numpy(np.asarray(x)) for x in (s, p, o, tp, ts, to, eq,
                                                   ca, cb)]
    # the mask: the port on tensors and as its NumPy twin, JAX's host twin
    # and JAX's jitted function
    m = K.seed_masks(*t[:7]).numpy()
    assert np.array_equal(m, K.seed_masks_host(s, p, o, tp, ts, to, eq))
    assert np.array_equal(m, jk.seed_masks_host(s, p, o, tp, ts, to, eq))
    assert np.array_equal(m, np.asarray(jk.jit_seed_masks()(
        s, p, o, tp, ts, to, eq)))
    # the seed rows: live prefix and count
    A, B, C = (x.numpy() for x in K.seed_extract(*t))
    for ref in (K.seed_extract_host(s, p, o, tp, ts, to, eq, ca, cb),
                jk.seed_extract_host(s, p, o, tp, ts, to, eq, ca, cb),
                jk.jit_seed_extract()(s, p, o, tp, ts, to, eq, ca, cb)):
        RA, RB, RC = (np.asarray(x) for x in ref)
        assert np.array_equal(C, RC)
        for i in range(T):
            k = int(C[i])
            assert np.array_equal(A[i, :k], RA[i, :k])
            assert np.array_equal(B[i, :k], RB[i, :k])
    # the NumPy twin is the JAX host twin in full, padding included
    hA, hB, _ = K.seed_extract_host(s, p, o, tp, ts, to, eq, ca, cb)
    jA, jB, _ = jk.seed_extract_host(s, p, o, tp, ts, to, eq, ca, cb)
    assert np.array_equal(hA, jA) and np.array_equal(hB, jB)


@pytest.mark.parametrize("seed", range(4))
def test_unique_rows_padded_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    ca = rng.integers(-3, 5, n).astype(np.int32)
    cb = rng.integers(-3, 5, n).astype(np.int32)
    if seed == 3:
        ca[:] = 2**31 - 1
        cb[::2] = -(2**31)
    valid = rng.random(n) < 0.7
    ja, jb, jc = jk.unique_rows_padded(ca, cb, valid)
    na, nb, nc = K.unique_rows_padded(ca, cb, valid)
    assert np.array_equal(na, ja) and np.array_equal(nb, jb) and nc == jc
    ta, tb, tc = K.unique_rows_padded(torch.from_numpy(ca),
                                      torch.from_numpy(cb),
                                      torch.from_numpy(valid))
    k = int(jc)
    assert int(tc) == k
    assert np.array_equal(ta[:k].numpy(), ja[:k])
    assert np.array_equal(tb[:k].numpy(), jb[:k])
    want = np.unique(np.stack([ca[valid], cb[valid]], 1), axis=0)
    assert np.array_equal(np.stack([ta[:k].numpy(), tb[:k].numpy()], 1),
                          want.reshape(-1, 2))


class _Owner:
    device = "cpu"


def _parsed_patterns(texts):
    from wukong_tpu_torch.sparql.parser import Parser

    ss, _ = _strings()
    pats = []
    for t in texts:
        pats += Parser(ss).parse(t).pattern_group.patterns
    return pats


def test_device_seed_paths_equal_match_delta(world, monkeypatch):
    """The batched frontier (device="cpu") against match_delta, the port's
    and the JAX package's, for every pattern of the plain queries."""
    _base, live = world
    pats = _parsed_patterns(PLAIN.values())
    for G in (Global,):
        monkeypatch.setattr(G, "template_device", "device")
        monkeypatch.setattr(G, "join_device", "device")
    for batch in (live[:1], live[:5000], live[5000:5001],
                  np.empty((0, 3), np.int64)):
        fused = continuous.device_seed_extract(pats, batch, owner=_Owner())
        masks = continuous.device_seed_masks(pats, batch, owner=_Owner())
        if not len(batch):
            assert fused is None and masks is None
            continue
        for i, pat in enumerate(pats):
            jv, js = jmatch_delta(pat, batch)
            pv, ps = continuous.match_delta(pat, batch)
            assert pv == jv and np.array_equal(ps, js)
            assert fused[i][0] == jv and np.array_equal(fused[i][1], js)
            mv, ms = continuous.match_delta(pat, batch, row_mask=masks[i])
            assert mv == jv and np.array_equal(ms, js)


def test_device_seed_degrades_only_on_range_error(world, monkeypatch):
    _base, live = world
    pats = _parsed_patterns([Q_ONEHOP, Q_CHAIN])
    monkeypatch.setattr(Global, "template_device", "device")
    monkeypatch.setattr(Global, "join_device", "device")
    big = live[:100].copy()
    big[0, 0] = 2**31 + 5  # an id past int32
    owner = _Owner()
    snap = get_registry().snapshot()

    def outcome(name, s):
        return sum(x["value"] for x in s.get(
            "wukong_stream_seed_batch_total", {}).get("series", [])
            if x["labels"].get("outcome") == name)

    f0 = outcome("fallback", snap)
    assert continuous.device_seed_extract(pats, big, owner=owner) is None
    assert continuous.device_seed_masks(pats, big, owner=owner) is None
    assert owner._seed_extract_broken and owner._seed_device_broken
    assert outcome("fallback", get_registry().snapshot()) == f0 + 2
    # latched: the next epoch (in range) stays host without a try
    assert continuous.device_seed_extract(pats, live[:100],
                                          owner=owner) is None
    # the knobs and the amortization threshold route host
    fresh = _Owner()
    monkeypatch.setattr(Global, "template_device", "host")
    assert continuous.device_seed_extract(pats, live[:100],
                                          owner=fresh) is None
    monkeypatch.setattr(Global, "template_device", "auto")
    monkeypatch.setattr(Global, "join_device_min_candidates", 10**9)
    assert continuous.device_seed_extract(pats, live[:100],
                                          owner=fresh) is None
    monkeypatch.setattr(Global, "join_device_min_candidates", 1)
    assert continuous.device_seed_extract(pats, live[:100],
                                          owner=fresh) is not None

    # any other error reaches the caller: through the engine's epoch
    def boom(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(K, "seed_extract", boom)
    with pytest.raises(RuntimeError, match="illegal memory"):
        continuous.device_seed_extract(pats, live[:100], owner=fresh)
    ss, _ = _strings()
    ctx = StreamContext([build_partition(world[0], 0, 1)], ss, device="cpu")
    ctx.register(Q_ONEHOP)
    with pytest.raises(RuntimeError, match="illegal memory"):
        ctx.feed(live[:100])
    assert not getattr(ctx.continuous, "_seed_extract_broken", False)


# ---------------------------------------------------------------------------
# the continuous engine against the JAX package's
# ---------------------------------------------------------------------------

def _pair_contexts(base, pool=None, jpool=None):
    ss, js = _strings()
    pg, jg = build_partition(base, 0, 1), jbuild(base, 0, 1)
    return (StreamContext([pg], ss, pool=pool, device="cpu"),
            JStreamContext([jg], js, pool=jpool))


@pytest.mark.parametrize("route", ["auto", "device", "host"])
def test_plain_queries_equal_jax_epoch_by_epoch(world, monkeypatch, route):
    base, live = world
    monkeypatch.setattr(Global, "template_device", route)
    ctx, jctx = _pair_contexts(base)
    qids = {n: (ctx.register(t), jctx.register(t)) for n, t in PLAIN.items()}
    for (ts, batch), (jts, jbatch) in zip(ReplaySource(live, 4096),
                                          JReplaySource(live, 4096)):
        assert ts == jts and np.array_equal(batch, jbatch)
        rec, jrec = ctx.feed(batch, ts=ts), jctx.feed(jbatch, ts=jts)
        assert (rec.epoch, rec.n_triples, rec.n_inserted, rec.version) == \
            (jrec.epoch, jrec.n_triples, jrec.n_inserted, jrec.version)
    for n, (q, jq) in qids.items():
        assert _deltas(ctx, q) == _deltas(jctx, jq), n
        assert np.array_equal(ctx.result_set(q), jctx.result_set(jq))
        sq = ctx.continuous.queries[q]
        assert sq.degraded_epochs == 0 and sq.epochs_evaluated == ctx.epoch
    if route == "device":
        assert getattr(ctx.continuous, "_seed_extract_broken", False) is False


@pytest.mark.parametrize("spec", [(3, 1), (4, 4)], ids=["sliding",
                                                        "tumbling"])
def test_windowed_queries_equal_jax(world, spec):
    """Windowed standing queries with retraction, one with base_triples."""
    base, live = world
    ss, _ = _strings()
    sub = ss.str2id("<http://swat.cse.lehigh.edu/onto/univ-bench.owl#"
                    "subOrganizationOf>")
    base_t = base[base[:, 1] == sub]
    ctx, jctx = _pair_contexts(base)
    q1 = (ctx.register(Q_ONEHOP, window=windows.WindowSpec(*spec)),
          jctx.register(Q_ONEHOP, window=jwin.WindowSpec(*spec)))
    q2 = (ctx.register(Q_CHAIN, window=windows.WindowSpec(*spec),
                       base_triples=base_t),
          jctx.register(Q_CHAIN, window=jwin.WindowSpec(*spec),
                        base_triples=base_t))
    for _ts, batch in ReplaySource(live, 3000):
        ctx.feed(batch)
        jctx.feed(batch)
    for q, jq in (q1, q2):
        assert _deltas(ctx, q) == _deltas(jctx, jq)
        assert any(d[1] < 0 for d in _deltas(ctx, q))  # retractions
        assert np.array_equal(ctx.result_set(q), jctx.result_set(jq))


def test_stream_lane_callbacks_prune_equal_jax(world):
    base, live = world
    ss, js = _strings()
    pg, jg = build_partition(base, 0, 1), jbuild(base, 0, 1)
    pool = EnginePool(num_engines=2, make_engine=lambda t: CPUEngine(pg, ss))
    from wukong_tpu.runtime.scheduler import EnginePool as JEnginePool

    jpool = JEnginePool(num_engines=2,
                        make_engine=lambda t: JCPUEngine(jg, js))
    pool.start()
    jpool.start()
    try:
        ctx = StreamContext([pg], ss, pool=pool, device="cpu")
        jctx = JStreamContext([jg], js, pool=jpool)
        seen, jseen = [], []
        q = ctx.continuous.register(Q_CHAIN, callback=seen.append,
                                    tenant="gold")
        jq = jctx.continuous.register(Q_CHAIN, callback=jseen.append,
                                      tenant="gold")
        bad = ctx.register(Q_CONST, callback=lambda d: 1 / 0)
        for _ts, batch in ReplaySource(live, 6000):
            ctx.feed(batch)
            jctx.feed(batch)
        # an interactive query rides the same pool's default lane
        from wukong_tpu_torch.planner.heuristic import heuristic_plan
        from wukong_tpu_torch.sparql.parser import Parser

        one = Parser(ss).parse(Q_ONEHOP)
        heuristic_plan(one)
        one.result.blind = True
        assert pool.wait(pool.submit(one), 60).result.status_code == 0
        assert _deltas(ctx, q) == _deltas(jctx, jq)
        assert [(d.epoch, d.rows.tolist()) for d in seen] == \
            [(d.epoch, d.rows.tolist()) for d in jseen]
        assert ctx.continuous.queries[bad].callback_errors > 0
        e = ctx.epoch
        assert ctx.prune(q, e - 1) == jctx.prune(jq, e - 1)
        assert _deltas(ctx, q) == _deltas(jctx, jq)
        assert all(d[0] >= e for d in _deltas(ctx, q))
        assert ctx.poll(q, since_epoch=e) == []
        ctx.unregister(q)
        with pytest.raises(WukongError):
            ctx.poll(q)
        assert pool.poll() == []  # stream completions are wait()'s
    finally:
        pool.stop()
        jpool.stop()


@pytest.mark.parametrize("text,code", [
    (PREFIX + "SELECT ?X WHERE { ?X ub:memberOf ?Y } LIMIT 3",
     ErrorCode.UNSUPPORTED_SHAPE),
    (PREFIX + "SELECT ?X ?Z WHERE { ?X ub:memberOf ?Y . ?Z ub:name ?W }",
     ErrorCode.UNSUPPORTED_SHAPE),
    (PREFIX + "SELECT ?X WHERE { ?X ?P ?Y }", ErrorCode.UNSUPPORTED_SHAPE),
    (PREFIX + "SELECT ?X WHERE { { ?X ub:memberOf ?Y } UNION "
     "{ ?X ub:worksFor ?Y } }", ErrorCode.UNSUPPORTED_SHAPE),
    (PREFIX + "SELECT ?X WHERE { <http://www.Department0.University0.edu> "
     "ub:subOrganizationOf <http://www.University0.edu> . ?X ub:memberOf "
     "<http://www.Department0.University0.edu> }",
     ErrorCode.UNSUPPORTED_SHAPE),
])
def test_registration_refusals_equal_jax(world, text, code):
    ctx, jctx = _pair_contexts(world[0][:2000])
    with pytest.raises(WukongError) as e:
        ctx.register(text)
    from wukong_tpu.utils.errors import WukongError as JWukongError

    with pytest.raises(JWukongError) as je:
        jctx.register(text)
    assert int(e.value.code) == int(je.value.code) == int(code)
    with pytest.raises(WukongError):
        ctx.register(Q_ONEHOP, callback=3)


# ---------------------------------------------------------------------------
# the proxy's verbs, checkpoints and WAL replay
# ---------------------------------------------------------------------------

def test_proxy_stream_verbs_equal_jax(world):
    base, live = world
    ss, js = _strings()
    pg, jg = build_partition(base, 0, 1), jbuild(base, 0, 1)
    proxy = Proxy(pg, ss, device="cpu")
    jproxy = JProxy(jg, js, JCPUEngine(jg, js))
    q, jq = proxy.stream_register(Q_ADVISOR), jproxy.stream_register(
        Q_ADVISOR)
    for _ts, batch in ReplaySource(live[:12000], 4000):
        proxy.stream_feed(batch)
        jproxy.stream_feed(batch)
    assert [(d.epoch, d.sign, d.rows.tolist()) for d in proxy.stream_poll(q)] \
        == [(d.epoch, d.sign, d.rows.tolist()) for d in jproxy.stream_poll(jq)]
    assert proxy.stream_prune(q, 1) == jproxy.stream_prune(jq, 1)
    # the standing result equals a one-shot over the final store
    one = proxy.serve_query(Q_ADVISOR)
    assert sorted(map(tuple, one.result.table.tolist())) == \
        sorted(map(tuple, proxy.stream_context().result_set(q).tolist()))
    st, jst = proxy.monitor.stream_stats(), jproxy.monitor.stream_stats()
    assert (st["epochs"], st["triples"]) == (jst["epochs"], jst["triples"])
    proxy.stream_unregister(q)
    with pytest.raises(WukongError):
        proxy.stream_poll(q)


def test_checkpoint_recover_standing_queries(world, tmp_path, monkeypatch):
    """A checkpoint holds the registry; after it, epochs are WAL-logged;
    a fresh proxy over the base recovers both: the registry, the result
    sets and the epoch counter equal the first proxy's, and the epochs
    after the checkpoint replay through the stream context."""
    base, live = world
    monkeypatch.setattr(Global, "wal_dir", str(tmp_path / "wal"))
    monkeypatch.setattr(Global, "checkpoint_dir", str(tmp_path / "ckpt"))
    ss, _ = _strings()
    batches = list(ReplaySource(live[:15000], 3000))
    try:
        proxy = Proxy(build_partition(base, 0, 1), ss, device="cpu")
        qa = proxy.stream_register(Q_CHAIN)
        qb = proxy.stream_register(Q_ONEHOP, window=windows.WindowSpec(2))
        for _ts, b in batches[:2]:
            proxy.stream_feed(b)
        path = proxy.checkpoint()
        assert os.path.exists(os.path.join(path, "stream.pkl"))
        for ts, b in batches[2:]:
            proxy.stream_feed(b, ts=ts)
        before = {q: proxy.stream_context().result_set(q) for q in (qa, qb)}
        sinks = {q: _deltas(proxy.stream_context(), q) for q in (qa, qb)}
        digest = proxy.g.version
        wal.reset_wal()  # the process ends

        fresh = Proxy(build_partition(base, 0, 1), ss, device="cpu")
        stats = fresh.recover()
        assert stats["standing_queries"] == 2
        assert stats["replayed"]["epoch"] == len(batches) - 2
        assert stats["epoch"] == len(batches)
        ctx = fresh.stream_context()
        assert sorted(ctx.continuous.queries) == [qa, qb]
        for q in (qa, qb):
            assert np.array_equal(ctx.result_set(q), before[q])
            assert _deltas(ctx, q) == sinks[q]
        assert fresh.g.version >= digest - len(batches)
        from wukong_tpu_torch.store.persist import gstore_digest

        assert gstore_digest(fresh.g) == gstore_digest(proxy.g)
    finally:
        wal.reset_wal()
        jwal.reset_wal()


# ---------------------------------------------------------------------------
# monitor, pool lane, sources
# ---------------------------------------------------------------------------

def test_monitor_stream_stats_equal_jax():
    m, jm = Monitor(), JMonitor()
    for k in range(1, 40):
        for mon in (m, jm):
            mon.record_stream_epoch(n_triples=k * 3, ingest_us=k * 11,
                                    eval_us=k * 7, lag_us=k * 18)
    assert m.stream_stats() == jm.stream_stats()
    assert m.stream_lag_cdf((0.5, 0.99)) == jm.stream_lag_cdf((0.5, 0.99))
    child = Monitor()
    child.share_observability(m)
    assert child.stream is m.stream and child._last_stream_epochs == 39
    m.record_stream_epoch(1, 1, 1, 1)
    assert child.stream_stats()["epochs"] == 40


def test_stream_lane_pops_last_and_dead_pool_fails():
    order = []

    class Eng:
        def execute(self, q):
            order.append(q)
            return q

    pool = EnginePool(num_engines=1, make_engine=lambda t: Eng())
    hs = [pool.submit("stream-a", lane="stream"),
          pool.submit("default-a"),
          pool.submit("stream-b", lane="stream")]
    pool.start()
    try:
        assert [pool.wait(h, 10) for h in hs] == ["stream-a", "default-a",
                                                  "stream-b"]
        assert order[0] == "default-a"  # interactive work first
        h = pool.submit("stream-c", lane="stream")
        pool.wait(h, 10)
        assert pool.poll() == [] or all(
            r != "stream-c" for _q, r in pool.poll())
    finally:
        pool.stop()
    with pytest.raises(ValueError):
        pool.submit("x", lane="nope")
    dead = EnginePool(num_engines=1, make_engine=lambda t: Eng())
    dead._dead[0] = True
    h = dead.submit("s", lane="stream")
    with pytest.raises(RuntimeError):
        raise dead.wait(h, 1)


def test_sources_equal_jax(tmp_path, world):
    _base, live = world
    got = [(t, b.tolist()) for t, b in ReplaySource(live[:1000], 300,
                                                    start_ts=5, ts_step=2)]
    want = [(t, b.tolist()) for t, b in JReplaySource(live[:1000], 300,
                                                      start_ts=5, ts_step=2)]
    assert got == want
    d3, d4 = tmp_path / "three", tmp_path / "four"
    d3.mkdir()
    d4.mkdir()
    rows = live[:500]
    np.savetxt(d3 / "id_a.nt", rows[:260], fmt="%d", delimiter="\t")
    np.savetxt(d3 / "id_b.nt", rows[260:], fmt="%d", delimiter="\t")
    ts = (np.arange(len(rows)) * 7) % 5
    np.savetxt(d4 / "id_a.nt", np.c_[rows[:200], ts[:200]], fmt="%d",
               delimiter="\t")
    np.savetxt(d4 / "id_b.nt", np.c_[rows[200:], ts[200:]], fmt="%d",
               delimiter="\t")
    for d in (d3, d4):
        a = [(t, b.tolist()) for t, b in FileSource(str(d), 64)]
        b = [(t, b.tolist()) for t, b in JFileSource(str(d), 64)]
        assert a == b and a
    with pytest.raises(WukongError):
        ReplaySource(np.zeros((3, 2)), 4)


def test_commit_vector_epoch_and_wal_epoch_records(world, tmp_path,
                                                   monkeypatch):
    base, live = world
    monkeypatch.setattr(Global, "wal_dir", str(tmp_path / "wal"))
    ss, _ = _strings()
    g = build_partition(base, 0, 1)
    try:
        ctx = StreamContext([g], ss, device="cpu")
        ctx.feed(live[:100], ts=3.5)
        n = ctx.ingestor.commit_vector_epoch(
            np.arange(5), np.ones((5, 4), np.float32))
        assert n == 5 and g.vstore.live_count() == 5
        recs = list(wal.active_wal().replay(after_seq=-1))
        assert [r.kind for r in recs] == ["epoch", "vector"]
        assert recs[0].payload["epoch"] == 1 and recs[0].payload["ts"] == 3.5
    finally:
        wal.reset_wal()
