"""The port's dynamic store (wukong_tpu_torch/store/dynamic.py) and checker
against the JAX package's, on LUBM-1 (seed 42):

- the same insert sequence gives the same arrays, version and
  ``gstore_digest`` in both packages, and equals a bulk build;
- new predicates and types, dedup, kept duplicates, inserted-edge counts,
  the lazy delta merge, four partitions' cross-consistency, the int32 id
  refusal and the ``dynamic.insert`` fault site behave as in JAX;
- gsck gives the JAX violation list on a good and on a corrupted store;
- after an insert on a CPU proxy every route answers the JAX engines'
  rows from the new version: the walk, WCOJ with the plain level probe,
  and the compiled template, each restaging its version-keyed cache;
- an insert racing with 8 serving threads under lockdep: no error, no lock
  cycle, and the final rows are the JAX rows of the final store."""

import sys
import threading

import numpy as np
import pytest
import torch

from wukong_tpu.engine.cpu import CPUEngine as JCPU
from wukong_tpu.engine.tpu import TPUEngine as JTPU
from wukong_tpu.loader.lubm import P, VirtualLubmStrings, generate_lubm
from wukong_tpu.planner.heuristic import heuristic_plan
from wukong_tpu.sparql.parser import Parser as JParser
from wukong_tpu.store import checker as jchecker
from wukong_tpu.store import dynamic as jdyn
from wukong_tpu.store import persist as jpersist
from wukong_tpu.store.gstore import build_partition as jbuild
from wukong_tpu_torch.analysis import lockdep
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.loader import lubm as plubm
from wukong_tpu_torch.runtime import faults
from wukong_tpu_torch.runtime.proxy import Proxy
from wukong_tpu_torch.store import checker, dynamic, persist
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.store.segment import CSRSegment
from wukong_tpu_torch.types import IN, OUT, TYPE_ID
from wukong_tpu_torch.utils.errors import WukongError

import chip_smoke

torch.set_num_threads(2)

Q1, Q2, Q6 = (chip_smoke.QUERIES[k] for k in ("lubm_q1", "lubm_q2",
                                              "lubm_q6"))
Q5 = chip_smoke.QUERIES["lubm_q5"]


@pytest.fixture(scope="module")
def lubm():
    triples, lay = generate_lubm(1, seed=42)
    return triples, lay, VirtualLubmStrings(1, seed=42)


def _split(triples, seed=0, parts=3, share=0.5):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(triples))
    n = int(len(triples) * share)
    return triples[perm[:n]], np.array_split(triples[perm[n:]], parts)


def _arrays_equal(pg, jg):
    pm, pa = persist._collect_arrays(pg)
    jm, ja = jpersist._collect_arrays(jg)
    assert pm == jm
    assert sorted(pa) == sorted(ja)
    for k in ja:
        assert pa[k].dtype == ja[k].dtype and np.array_equal(pa[k], ja[k]), k


@pytest.mark.parametrize("dedups", [(True, True, True), (False, True, False),
                                    (False, False, False)])
def test_insert_sequence_matches_jax_and_bulk(lubm, dedups):
    triples, _lay, _ss = lubm
    base, batches = _split(triples)
    pg, jg = build_partition(base, 0, 1), jbuild(base, 0, 1)
    for b, dd in zip(batches, dedups):
        assert dynamic.insert_triples(pg, b, dedup=dd) == \
            jdyn.insert_triples(jg, b, dedup=dd)
    assert pg.version == jg.version == len(batches)
    _arrays_equal(pg, jg)
    assert persist.gstore_digest(pg) == jpersist.gstore_digest(jg)
    # the batches are disjoint from the base: inserting them equals a bulk
    # build of all the triples, array for array
    bulk = build_partition(triples, 0, 1)
    assert persist.gstore_digest(pg) == persist.gstore_digest(bulk)
    assert checker.check_partition(pg) == []


class _LexsortGate:
    """numpy for store/dynamic.py, whose ``lexsort`` in the merge thread
    stops once between the merge's snapshot of the deltas and its clear."""

    def __init__(self):
        self.inside, self.go = threading.Event(), threading.Event()

    def __getattr__(self, name):
        return getattr(np, name)

    def lexsort(self, keys):
        if threading.current_thread().name == "merger" and \
                not self.inside.is_set():
            self.inside.set()
            assert self.go.wait(30)
        return np.lexsort(keys)


def test_append_during_a_readers_merge_is_kept(monkeypatch):
    """A writer appends while a reader's merge of the earlier deltas is in
    progress: the writer's batch is neither cleared by the merge nor
    duplicated past dedup, and the segment equals one built at once."""
    gate = _LexsortGate()
    monkeypatch.setattr(dynamic, "np", gate)
    base = CSRSegment.from_pairs(np.repeat(np.arange(20), 10),
                                 np.tile(np.arange(10), 20))
    b1 = (np.arange(100, 110, dtype=np.int64), np.arange(10, dtype=np.int64))
    b2 = (np.arange(200, 210, dtype=np.int64), np.arange(10, dtype=np.int64))
    seg = dynamic.DeltaCSRSegment(base)
    assert seg.append(*b1, dedup=True) == 10
    merger = threading.Thread(target=lambda: seg.keys, name="merger")
    merger.start()
    assert gate.inside.wait(30)
    added = []
    writer = threading.Thread(
        target=lambda: added.append(seg.append(*b2, dedup=True)))
    writer.start()
    writer.join(0.5)  # with the segment's lock the writer waits here
    gate.go.set()
    merger.join(30)
    writer.join(30)
    assert added == [10]
    assert seg.append(*b2, dedup=True) == 0  # already there
    ks = np.concatenate([np.repeat(base.keys, np.diff(base.offsets)),
                         b1[0], b2[0]])
    vs = np.concatenate([base.edges, b1[1], b2[1]])
    whole = CSRSegment.from_pairs(ks, vs)
    assert seg.num_edges == whole.num_edges == 220
    for name in ("keys", "offsets", "edges"):
        assert np.array_equal(getattr(seg, name), getattr(whole, name))


def test_new_predicate_and_type(lubm):
    triples, _lay, _ss = lubm
    pg, jg = build_partition(triples, 0, 1), jbuild(triples, 0, 1)
    NEW_P, NEW_T = 90, 91
    v1, v2 = 1 << 20, (1 << 20) + 1
    batch = np.asarray([[v1, NEW_P, v2], [v1, TYPE_ID, NEW_T]], dtype=np.int64)
    dynamic.insert_triples(pg, batch)
    jdyn.insert_triples(jg, batch)
    assert pg.get_triples(v1, NEW_P, OUT).tolist() == [v2]
    assert pg.get_triples(v2, NEW_P, IN).tolist() == [v1]
    assert pg.get_index(NEW_T, IN).tolist() == [v1]
    assert NEW_T in pg.type_ids
    _arrays_equal(pg, jg)
    assert checker.check_partition(pg) == []


def test_dedup_counts_and_kept_duplicates(lubm):
    triples, lay, _ss = lubm
    pg, jg = build_partition(triples, 0, 1), jbuild(triples, 0, 1)
    d0, fp0 = int(lay.dept_id[0]), int(lay.fac_base[0])
    dup = np.asarray([[fp0, P["worksFor"], d0]], dtype=np.int64)
    new = np.asarray([[1 << 23, P["worksFor"], d0]], dtype=np.int64)
    n0 = len(pg.get_triples(fp0, P["worksFor"], OUT))
    for g, ins in ((pg, dynamic.insert_triples), (jg, jdyn.insert_triples)):
        assert ins(g, dup, dedup=True) == 0
        assert ins(g, new, dedup=True) == 1
        assert ins(g, new, dedup=True) == 0  # visible in the pending delta
        assert ins(g, dup, dedup=False) == 1
    assert len(pg.get_triples(fp0, P["worksFor"], OUT)) == n0 + 1
    _arrays_equal(pg, jg)


def test_four_partitions_stay_cross_consistent(lubm):
    triples, _lay, _ss = lubm
    base, batches = _split(triples, seed=3, parts=2)
    stores = [build_partition(base, i, 4) for i in range(4)]
    jstores = [jbuild(base, i, 4) for i in range(4)]
    for b in batches:
        dynamic.insert_batch_into(stores, b)
        for g in jstores:
            jdyn.insert_triples(g, b)
    assert checker.check_cross_partition(stores) == []
    for pg, jg in zip(stores, jstores):
        assert persist.gstore_digest(pg) == jpersist.gstore_digest(jg)


def test_delta_merge_is_lazy_and_exact():
    base = CSRSegment.from_pairs(
        np.arange(1000, dtype=np.int64) % 100 + (1 << 17),
        np.arange(1000, dtype=np.int64) + (1 << 18))
    seg = dynamic.DeltaCSRSegment(base)
    jseg = jdyn.DeltaCSRSegment(base)
    for i in range(50):
        ks = np.asarray([(1 << 17) + i], dtype=np.int64)
        vs = np.asarray([(1 << 19) + i], dtype=np.int64)
        for s in (seg, jseg):
            assert s.append(ks, vs, dedup=True) == 1
            assert s.append(ks, vs, dedup=True) == 0
    assert seg._n_pending == 50 and seg._pending  # nothing merged yet
    assert seg.num_edges == base.num_edges + 50
    assert (1 << 19) + 3 in seg.lookup((1 << 17) + 3).tolist()
    assert not seg._pending
    for attr in ("keys", "offsets", "edges"):
        assert np.array_equal(getattr(seg, attr), getattr(jseg, attr))
    assert seg.memory_bytes() == jseg.memory_bytes()


def test_ids_past_int32_are_refused_untouched(lubm, tmp_path):
    """insert_triples and `load -d` (load_dir_into) check the id range
    before any mutation, as in JAX: the card's int32 tables never narrow
    an id silently."""
    triples, _lay, _ss = lubm
    pg = build_partition(triples, 0, 1)
    before = persist.gstore_digest(pg)
    for k, bad in enumerate(([[1 << 20, 5, 2**31 - 1]], [[-3, 5, 1 << 20]])):
        bad = np.asarray(bad, dtype=np.int64)
        with pytest.raises(WukongError):
            dynamic.insert_triples(pg, bad)
        with pytest.raises(WukongError):
            dynamic.load_dir_into([pg], chip_smoke.write_ids(
                str(tmp_path / f"bad{k}"), bad))
    assert persist.gstore_digest(pg) == before
    assert getattr(pg, "version", 0) == 0


def test_insert_fault_site_leaves_the_store_untouched(lubm):
    triples, _lay, _ss = lubm
    base, batches = _split(triples, seed=1, parts=1)
    pg = build_partition(base, 0, 1)
    before = persist.gstore_digest(pg)
    faults.install(faults.parse_plan("seed=0;dynamic.insert:transient,"
                                     "count=1"))
    try:
        with pytest.raises(faults.TransientFault):
            dynamic.insert_batch_into([pg], batches[0])
        assert persist.gstore_digest(pg) == before
        dynamic.insert_batch_into([pg], batches[0])  # the retry commits
    finally:
        faults.install(None)
    assert persist.gstore_digest(pg) == persist.gstore_digest(
        build_partition(triples, 0, 1))


def _corrupt(g, mod):
    """Drop one member of a type index and one subject of a predicate
    index, and plant an index entry with no edges (the same edits in
    both packages' stores)."""
    t = sorted(k for k in g.index if k[1] == IN and k[0] in g.type_ids)[0]
    g.index[t] = g.index[t][1:]
    p = sorted(k for k in g.index if k[1] == IN and k[0] not in g.type_ids
               and k[0] != TYPE_ID)[0]
    g.index[p] = g.index[p][2:]
    o = sorted(k for k in g.index if k[1] == OUT)[0]
    g.index[o] = np.union1d(g.index[o], [(1 << 24) + 7])


def test_gsck_matches_jax_on_good_and_corrupted_stores(lubm):
    triples, _lay, _ss = lubm
    pg, jg = build_partition(triples, 0, 1), jbuild(triples, 0, 1)
    assert checker.check_partition(pg) == jchecker.check_partition(jg) == []
    _corrupt(pg, checker)
    _corrupt(jg, jchecker)
    for flags in ((True, True), (True, False), (False, True)):
        got = checker.check_partition(pg, *flags)
        assert got == jchecker.check_partition(jg, *flags)
    assert len(checker.check_partition(pg)) >= 3
    stores = [build_partition(triples, i, 3) for i in range(3)]
    jstores = [jbuild(triples, i, 3) for i in range(3)]
    k = sorted(k for k in stores[1].segments if k[1] == IN)[0]
    del stores[1].segments[k], jstores[1].segments[k]
    got = checker.check_cross_partition(stores)
    assert got and got == jchecker.check_cross_partition(jstores)


def _jax_rows(g, ss, text):
    out = []
    for eng in (JCPU(g, ss), JTPU(g, ss)):
        q = JParser(ss).parse(text)
        heuristic_plan(q)
        q.result.blind = False
        eng.execute(q)
        assert int(q.result.status_code) == 0
        out.append(sorted(map(tuple, q.result.table.tolist())))
    assert out[0] == out[1]
    return out[0]


@pytest.mark.parametrize("route", ["walk", "wcoj", "template"])
def test_routes_answer_the_new_version(lubm, monkeypatch, tmp_path, route):
    """Each package's proxy over the same 90% of LUBM-1, planned with its
    statistics, loads the other 10% with `load -d`: every route then
    answers the JAX proxy's rows from the new version, with the JAX
    proxy's routes (the statistics stay as they were, as the JAX proxy
    leaves them)."""
    from wukong_tpu.config import Global as JGlobal
    from wukong_tpu.planner.optimizer import Planner as JPlanner
    from wukong_tpu.planner.stats import Stats as JStats
    from wukong_tpu.runtime.proxy import Proxy as JProxy
    from wukong_tpu_torch.planner.optimizer import Planner
    from wukong_tpu_torch.planner.stats import Stats

    triples, _lay, ss = lubm
    base, batches = _split(triples, seed=5, parts=1, share=0.9)
    proxy = Proxy(build_partition(base, 0, 1),
                  plubm.VirtualLubmStrings(1, seed=42), device="cpu",
                  planner=Planner(Stats.generate(base)))
    jg = jbuild(base, 0, 1)
    jproxy = JProxy(jg, ss, JCPU(jg, ss), JTPU(jg, ss),
                    planner=JPlanner(JStats.generate(base)))
    knobs = {"walk": {"join_strategy": "walk", "template_device": "host"},
             "wcoj": {"join_strategy": "wcoj", "join_device": "device"},
             "template": {"join_strategy": "walk",
                          "template_device": "device",
                          "template_min_rows": 1}}[route]
    for G in (Global, JGlobal):
        for k, v in knobs.items():
            monkeypatch.setattr(G, k, v)
    texts = (Q1, Q2, Q6) if route != "walk" else (Q1, Q2, Q5, Q6)

    def same(text):
        q = proxy.serve_query(text, blind=False)
        jq = jproxy.serve_query(text, blind=False)
        assert q.result.status_code == 0 and int(jq.result.status_code) == 0
        assert sorted(map(tuple, q.result.table.tolist())) == sorted(
            map(tuple, jq.result.table.tolist())), route
        assert q.join_strategy == jq.join_strategy
        return q

    for text in texts:  # stage every cache at version 0
        same(text)
    d = chip_smoke.write_ids(str(tmp_path / "delta"), batches[0])
    proxy.dynamic_load_data(d)
    jproxy.dynamic_load_data(d)
    assert proxy.g.version == jg.version == 1
    assert persist.gstore_digest(proxy.g) == jpersist.gstore_digest(jg)
    for text in texts:
        q = same(text)
        if route == "wcoj" and text != Q6:  # one pattern: no join
            assert q.join_strategy == "wcoj" and q.result.nrows
        if route == "template":
            assert q._template_compiled
    if route == "walk":
        assert proxy.gpu.dstore._seen_version == 1
    if route == "wcoj":
        # the device tables of version 0 were reaped at the first build of
        # version 1 (host entries of version 0 age out of the LRU)
        keys = [k for k in proxy.wcoj().tables._tables if k[1] == "dseg"]
        assert keys and all(k[0] == 1 for k in keys)
    if route == "template":
        eng = proxy.template_engine()
        assert eng.program_count() >= 1
        assert all(k[1] == 1 for k in eng._programs)


@pytest.fixture
def checked_locks():
    lockdep.install(True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
        assert lockdep.cycles() == [], lockdep.cycles()
        assert lockdep.leaf_violations() == [], lockdep.leaf_violations()
    finally:
        sys.setswitchinterval(old)
        lockdep.install(False)


def test_insert_racing_serving_threads(lubm, checked_locks, tmp_path,
                                       monkeypatch):
    """8 serving threads on a CPU proxy while the main thread loads three
    batches with the WAL on: every reply is status 0, and once the inserts
    are done every thread's next reply is the final store's JAX rows."""
    triples, _lay, ss = lubm
    base, batches = _split(triples, seed=2, parts=3)
    monkeypatch.setattr(Global, "wal_dir", str(tmp_path / "wal"))
    proxy = Proxy(build_partition(base, 0, 1),
                  plubm.VirtualLubmStrings(1, seed=42), device="cpu")
    texts = [Q5, Q6, Q2, chip_smoke.QUERIES["lubm_q7"]]
    done = threading.Event()
    errors, final = [], {}

    def serve(i):
        text = texts[i % len(texts)]
        try:
            while True:
                last = done.is_set()
                q = proxy.serve_query(text, blind=False)
                if q.result.status_code != 0:
                    errors.append(q.result.status_code)
                if last:
                    final[i] = sorted(map(tuple, q.result.table.tolist()))
                    return
        except BaseException as e:  # reported by the assert below
            errors.append(e)

    ths = [threading.Thread(target=serve, args=(i,)) for i in range(8)]
    for t in ths:
        t.start()
    try:
        for b in batches:
            dynamic.insert_batch_into([proxy.g], b)
    finally:
        done.set()
        for t in ths:
            t.join(120)
    from wukong_tpu_torch.store import wal

    wal.reset_wal()
    assert not any(t.is_alive() for t in ths)
    assert errors == []
    jfull = jbuild(triples, 0, 1)
    for i, rows in final.items():
        assert rows == _jax_rows(jfull, ss, texts[i % len(texts)])
    assert len(final) == 8
    assert lockdep.report()["edges"]  # the checker saw the locks
