"""The port's shard-migration actuator (runtime/migration.py) against the
JAX package's: the cases of tests/test_migration.py at its size (LUBM-1
seed 42 in N_SHARDS = 4 partitions, donor 3, recipient 2), each run in both
packages on the same partitions. Each case holds the job's phases, status
and counters, the fetched payloads byte for byte after every phase, the
journal's events, the metrics' deltas, the phase gauge, the /plan,
/healthz and monitor surfaces and the rebalance report equal to JAX's, and
the JAX test's own assertions on the port. The module runs lockdep-checked
in both packages.
"""

import importlib
import os

import numpy as np
import pytest

from wukong_tpu.loader.lubm import VirtualLubmStrings, generate_lubm

N_SHARDS = 4
DONOR = 3
RECIPIENT = 2
ROOTS = ("wukong_tpu", "wukong_tpu_torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Pkg:
    """One package's modules under the names the cases use."""

    def __init__(self, root: str):
        imp = importlib.import_module
        self.root = root
        self.G = imp(f"{root}.config").Global
        self.faults = imp(f"{root}.runtime.faults")
        self.mig = imp(f"{root}.runtime.migration")
        self.placement = imp(f"{root}.obs.placement")
        self.events = imp(f"{root}.obs.events")
        self.heat = imp(f"{root}.obs.heat")
        self.tsdb = imp(f"{root}.obs.tsdb")
        self.metrics = imp(f"{root}.obs.metrics")
        self.httpd = imp(f"{root}.obs.httpd")
        self.monitor = imp(f"{root}.runtime.monitor")
        self.dyn = imp(f"{root}.store.dynamic")
        self.gs = imp(f"{root}.store.gstore")
        self.persist = imp(f"{root}.store.persist")
        self.wal = imp(f"{root}.store.wal")
        self.emu = imp(f"{root}.runtime.emulator")
        self.sharded = imp(f"{root}.parallel.sharded_store")
        self.errors = imp(f"{root}.utils.errors")
        self.timer = imp(f"{root}.utils.timer")
        self.ingest = imp(f"{root}.stream.ingest")
        self.lockdep = imp(f"{root}.analysis.lockdep")
        self.hash_mod = imp(f"{root}.utils.mathutil").hash_mod

    @property
    def port(self) -> bool:
        return self.root == "wukong_tpu_torch"

    def mesh(self):
        if self.port:
            from wukong_tpu_torch.parallel.mesh import make_mesh

            return make_mesh(N_SHARDS, device="cpu")

        class _Mesh:
            devices = np.empty(N_SHARDS, dtype=object)

        return _Mesh()

    def counter(self, name, labels, **lv):
        return self.metrics.get_registry().counter(
            name, labels=labels).value(**lv)


PKGS = [Pkg(r) for r in ROOTS]
J, P = PKGS


@pytest.fixture(autouse=True, scope="module")
def _lockdep_checked():
    """Both actuators run lockdep-checked: the cutover and state locks are
    declared leaves, so an acquisition under them, or a cycle through
    the WAL mutation lock, fails the module's teardown."""
    for pk in PKGS:
        pk.lockdep.install(True)
    yield
    try:
        for pk in PKGS:
            assert pk.lockdep.cycles() == [], (pk.root, pk.lockdep.cycles())
            assert pk.lockdep.leaf_violations() == [], (
                pk.root, pk.lockdep.leaf_violations())
    finally:
        for pk in PKGS:
            pk.lockdep.install(False)


@pytest.fixture(scope="module")
def world():
    triples, _ = generate_lubm(1, seed=42)
    return {"triples": triples,
            "parts": {pk.root: [pk.gs.build_partition(triples, i, N_SHARDS)
                                for i in range(N_SHARDS)] for pk in PKGS}}


def _reset(pk):
    pk.mig.get_migrator().reset()
    pk.placement.get_advisor().reset()
    pk.placement.get_lineage().reset()
    pk.events.get_journal().clear()
    pk.heat.get_heat().reset()
    pk.tsdb.get_tsdb().reset()
    pk.faults.clear()


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    """Knobs at the JAX test's defaults in both packages (migration
    disarmed: each case arms explicitly), every process-wide singleton
    clean, no fault plan or WAL leaking across cases."""
    for pk in PKGS:
        for k, v in (("migration_enable", False),
                     ("migration_rotate_reads", True),
                     ("placement_interval_s", 0), ("wal_dir", ""),
                     ("enable_events", True), ("enable_tsdb", True)):
            monkeypatch.setattr(pk.G, k, v)
        _reset(pk)
    yield
    for pk in PKGS:
        _reset(pk)


def _sstore(pk, world):
    stores = [pk.persist.clone_gstore(g) for g in world["parts"][pk.root]]
    return pk.sharded.ShardedDeviceStore(stores, pk.mesh(),
                                         replication_factor=1)


def _oracle(pk, world):
    return pk.persist.clone_gstore(world["parts"][pk.root][DONOR])


def _plan(pk, donor=DONOR, recipient=RECIPIENT):
    return pk.placement.MigrationPlan(
        plan_id="mp-test", t_us=pk.timer.get_usec(), donor_shard=donor,
        recipient_host=recipient, predicted_move_bytes=1 << 20,
        bytes_source="estimate", donor_rate_per_s=4.0,
        mean_rate_per_s=1.0, imbalance_before=2.5, imbalance_after=1.5,
        window_s=60.0, inputs={}, reason="test")


def _edges(pk, k: int, shard: int = DONOR, base: int = 100000):
    out = []
    s = base
    while len(out) < k:
        if pk.hash_mod(np.array([s]), N_SHARDS)[0] == shard:
            out.append((s, 17, s))
        s += 1
    return np.asarray(out, dtype=np.int64)


def _fetch(pk, sstore, shard=DONOR):
    return sstore._fetch_shard(shard, pk.emu._probe_read, "migtest")


def _arm(pk, sstore, monkeypatch, owner=None):
    monkeypatch.setattr(pk.G, "migration_enable", True)
    mig = pk.mig.get_migrator()
    mig.attach(sstore=sstore, owner=owner)
    return mig


def _job(job) -> dict:
    """A job's record, less what is the run's own (the plan's clock, the
    pause, the journal's event ids)."""
    d = job.to_dict()
    d["event_ids"] = len(d["event_ids"])
    d.pop("cutover_pause_us")
    return d


def _events(pk, **kw) -> list:
    out = []
    for e in pk.events.get_journal().last(**kw):
        attrs = {k: v for k, v in e.attrs.items()
                 if k not in ("pause_us", "plan")}
        out.append((e.kind, e.shard, sorted(attrs.items())))
    return out


def _digest(pk, g):
    return pk.persist.gstore_digest(g)


def both(fn, *args, **kw):
    """fn run for each package; the two records must be equal. Returns
    the port's record."""
    jrec, prec = (fn(pk, *args, **kw) for pk in PKGS)
    assert prec == jrec
    return prec


# ---------------------------------------------------------------------------
# the off-knob posture
# ---------------------------------------------------------------------------

def test_disabled_executor_refuses_and_posture_unchanged(world):
    def case(pk):
        sstore = _sstore(pk, world)
        mig = pk.mig.get_migrator()
        mig.attach(sstore=sstore)
        with pytest.raises(pk.errors.WukongError,
                           match="migration_enable is off"):
            mig.run_plan(_plan(pk))
        return {"placement": sstore.placement, "rotation": sstore.rotation,
                "journal": _events(pk, kind="shard.migrate"),
                "in_flight": mig.status()["in_flight"],
                "loop": pk.mig.maybe_start_migration(sstore)}

    rec = both(case)
    assert rec == {"placement": {}, "rotation": {}, "journal": [],
                   "in_flight": False, "loop": None}


def test_disabled_advisor_stays_observe_only(world):
    def case(pk):
        sstore = _sstore(pk, world)
        fp = [(id(g), _digest(pk, g)) for g in sstore.stores]
        adv = pk.placement.get_advisor()
        adv.attach_store(sstore)
        adv.advise_once()
        return {"untouched": [(id(g), _digest(pk, g))
                              for g in sstore.stores] == fp,
                "placement": sstore.placement}

    assert both(case) == {"untouched": True, "placement": {}}


# ---------------------------------------------------------------------------
# the happy path
# ---------------------------------------------------------------------------

def test_full_migration_happy_path(world, monkeypatch):
    def case(pk):
        sstore = _sstore(pk, world)
        mig = _arm(pk, sstore, monkeypatch)
        donor_store = sstore.stores[DONOR]
        d0 = _digest(pk, donor_store)
        c0 = pk.counter("wukong_migrations_total", ("outcome",),
                        outcome="completed")
        job = mig.run_plan(_plan(pk))
        lin = pk.placement.get_lineage().report()[DONOR]
        j = pk.events.get_journal()
        return {"job": _job(job), "swapped": sstore.stores[DONOR]
                is not donor_store, "placement": sstore.placement,
                "rotation": [h for h, _g in sstore.rotation[DONOR]],
                "copy_digest": _digest(pk, sstore.stores[DONOR]) == d0,
                "donor_digest": _digest(pk, donor_store) == d0,
                "primary_host": lin["primary_host"],
                "rotation_hosts": lin["rotation_hosts"],
                "completed": pk.counter(
                    "wukong_migrations_total", ("outcome",),
                    outcome="completed") - c0,
                "events": _events(pk, kind="shard.migrate", shard=DONOR),
                "linked": all(j.find(ev) is not None
                              for ev in job.event_ids)}

    rec = both(case)
    assert rec["job"]["phase"] == "done" and rec["job"]["attempts"] == 1
    assert rec["swapped"] and rec["placement"] == {DONOR: RECIPIENT}
    assert rec["rotation"] == [DONOR] and rec["rotation_hosts"] == [DONOR]
    assert rec["copy_digest"] and rec["donor_digest"]
    assert rec["primary_host"] == RECIPIENT and rec["completed"] == 1
    assert rec["job"]["bytes_moved"] > 0 and rec["job"]["event_ids"] == 4
    assert [e[0] for e in rec["events"]] == [
        "shard.migrate.start", "shard.migrate.catchup",
        "shard.migrate.cutover", "shard.migrate.retire"]
    assert rec["linked"]


def test_rotate_off_retires_donor_outright(world, monkeypatch):
    def case(pk):
        monkeypatch.setattr(pk.G, "migration_rotate_reads", False)
        sstore = _sstore(pk, world)
        job = _arm(pk, sstore, monkeypatch).run_plan(_plan(pk))
        return {"job": _job(job), "rotation": sstore.rotation,
                "placement": sstore.placement}

    rec = both(case)
    assert rec["job"]["phase"] == "done" and rec["job"]["rotated"] is False
    assert rec["rotation"] == {} and rec["placement"] == {DONOR: RECIPIENT}


def test_serving_byte_identical_through_every_phase(world, monkeypatch):
    """A probe through the resilience fetch path after every phase
    returns the pre-migration bytes, complete; the payloads are the same
    bytes in both packages."""
    def case(pk):
        sstore = _sstore(pk, world)
        mig = _arm(pk, sstore, monkeypatch)
        oracle, ok = _fetch(pk, sstore)
        seen, payloads = {}, {}

        def hook(phase, _job):
            out, complete = _fetch(pk, sstore)
            seen[phase] = bool(complete) and np.array_equal(out, oracle)
            payloads[phase] = np.asarray(out).tobytes()

        job = mig.run_plan(_plan(pk), phase_hook=hook)
        turns = []
        for _ in range(2 * len(sstore.rotation.get(DONOR, ())) + 2):
            out, complete = _fetch(pk, sstore)
            turns.append(bool(complete) and np.array_equal(out, oracle))
        return {"ok": ok, "phase": job.phase, "seen": seen,
                "payloads": payloads, "turns": turns,
                "oracle": np.asarray(oracle).tobytes()}

    rec = both(case)
    assert rec["ok"] and rec["phase"] == "done"
    assert set(rec["seen"]) == set(P.mig.MIGRATION_PHASES)
    assert all(rec["seen"].values()) and all(rec["turns"])
    assert all(b == rec["oracle"] for b in rec["payloads"].values())


def test_wal_catchup_replays_tail_and_dual_writes(world, monkeypatch,
                                                  tmp_path):
    def case(pk):
        monkeypatch.setattr(pk.G, "wal_dir", str(tmp_path / pk.root))
        sstore = _sstore(pk, world)
        mig = _arm(pk, sstore, monkeypatch)
        w_clone = _edges(pk, 1, base=100000)
        w_catchup = _edges(pk, 1, base=101000)

        def hook(phase, _job):
            if phase == "clone":  # in the WAL tail the catch-up replays
                pk.dyn.insert_batch_into(list(sstore.stores), w_clone)
            elif phase == "catchup":  # the dual-write window
                pk.dyn.insert_batch_into(list(sstore.stores), w_catchup)

        job = mig.run_plan(_plan(pk), phase_hook=hook)
        oracle = _oracle(pk, world)
        pk.dyn.insert_triples(oracle, w_clone, check_ids=False)
        pk.dyn.insert_triples(oracle, w_catchup, check_ids=False)
        (_h, rot), = sstore.rotation[DONOR]
        return {"job": _job(job),
                "primary": _digest(pk, sstore.stores[DONOR]),
                "rotation": _digest(pk, rot),
                "oracle": _digest(pk, oracle)}

    rec = both(case)
    assert rec["job"]["phase"] == "done" and rec["job"]["replayed"] == 1
    assert rec["primary"] == rec["oracle"] == rec["rotation"]


def test_stream_epoch_dual_applies_during_window(world):
    """A stream epoch committed during the dual-write window reaches the
    recipient through ``migration_sinks()``, counted once."""
    def case(pk):
        sstore = _sstore(pk, world)
        recipient = pk.persist.clone_gstore(sstore.stores[DONOR])
        with pk.wal.mutation_lock():
            pk.dyn.enroll_migration_sink(("migrate", DONOR), recipient)
        try:
            ing = pk.ingest.StreamIngestor(list(sstore.stores))
            batch = _edges(pk, 2, base=102000)
            rec = ing.commit_epoch(batch)
            with pk.wal.mutation_lock():
                sinks = pk.dyn.migration_sinks()
        finally:
            with pk.wal.mutation_lock():
                pk.dyn.deroll_migration_sink(("migrate", DONOR))
        oracle = _oracle(pk, world)
        pk.dyn.insert_triples(oracle, batch, check_ids=False)
        with pk.wal.mutation_lock():
            left = pk.dyn.migration_sinks()
        return {"n_inserted": rec.n_inserted, "n": len(batch),
                "sink_is_recipient": sinks == [recipient], "left": left,
                "digest": _digest(pk, recipient) == _digest(pk, oracle)}

    rec = both(case)
    assert rec["n_inserted"] == rec["n"] == 2
    assert rec["sink_is_recipient"] and rec["left"] == [] and rec["digest"]


def test_vector_upsert_dual_applies_during_window(world, monkeypatch):
    """The vector plane's fan-out (``upsert_batch_into``): a batch
    committed during the dual-write window reaches the recipient's vector
    store, which then equals the donor's."""
    def case(pk):
        vs = importlib.import_module(f"{pk.root}.vector.vstore")
        monkeypatch.setattr(pk.G, "enable_vectors", True)
        monkeypatch.setattr(pk.G, "vector_dim", 4)
        sstore = _sstore(pk, world)
        recipient = pk.persist.clone_gstore(sstore.stores[DONOR])
        vids = np.asarray([s for s in range(200)
                           if pk.hash_mod(np.array([s]), N_SHARDS)[0]
                           == DONOR][:6], dtype=np.int64)
        vecs = np.random.default_rng(3).standard_normal(
            (len(vids), 4)).astype(np.float32)
        with pk.wal.mutation_lock():
            pk.dyn.enroll_migration_sink(("migrate", DONOR), recipient)
        try:
            n = vs.upsert_batch_into(list(sstore.stores), vids, vecs)
        finally:
            with pk.wal.mutation_lock():
                pk.dyn.deroll_migration_sink(("migrate", DONOR))
        donor = sstore.stores[DONOR].vstore
        return {"n": n, "rows": recipient.vstore.digest() == donor.digest(),
                "count": len(vids)}

    rec = both(case)
    assert rec["n"] == rec["count"] > 0 and rec["rows"]


# ---------------------------------------------------------------------------
# chaos: injected faults at each phase abort cleanly back to the donor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site,kind", [
    ("migration.clone", "transient"),
    ("migration.catchup", "transient"),
    ("migration.cutover", "shard_down"),
])
def test_fault_at_each_phase_aborts_with_donor_untouched(
        world, monkeypatch, site, kind):
    def case(pk):
        sstore = _sstore(pk, world)
        mig = _arm(pk, sstore, monkeypatch)
        donor_store = sstore.stores[DONOR]
        d0 = _digest(pk, donor_store)
        a0 = pk.counter("wukong_migration_aborts_total", ("cause",),
                        cause="injected_fault")
        pk.faults.install(pk.faults.FaultPlan(
            [pk.faults.FaultSpec(site, kind)], seed=0))
        with pytest.raises((pk.faults.TransientFault,
                            pk.faults.ShardDown)):
            mig.run_plan(_plan(pk))
        pk.faults.clear()
        job = mig.job()
        with pk.wal.mutation_lock():
            sinks = pk.dyn.migration_sinks()
        out, complete = _fetch(pk, sstore)
        return {"phase": job.phase, "cause": job.abort_cause,
                "same_primary": sstore.stores[DONOR] is donor_store,
                "digest": _digest(pk, donor_store) == d0,
                "placement": sstore.placement, "rotation": sstore.rotation,
                "sinks": sinks,
                "abort": _events(pk, kind="shard.migrate.abort"),
                "aborts": pk.counter("wukong_migration_aborts_total",
                                     ("cause",),
                                     cause="injected_fault") - a0,
                "served": bool(complete) and np.array_equal(
                    out, pk.emu._probe_read(donor_store))}

    rec = both(case)
    assert rec["phase"] == "aborted" and rec["cause"] == "injected_fault"
    assert rec["same_primary"] and rec["digest"] and rec["served"]
    assert rec["placement"] == {} and rec["rotation"] == {}
    assert rec["sinks"] == [] and rec["aborts"] == 1
    (ev,) = rec["abort"]
    assert ev[1] == DONOR and ("at_phase", site.split(".")[1]) in ev[2]


def test_fault_mid_flight_write_survives_abort(world, monkeypatch,
                                               tmp_path):
    def case(pk):
        monkeypatch.setattr(pk.G, "wal_dir", str(tmp_path / pk.root))
        sstore = _sstore(pk, world)
        mig = _arm(pk, sstore, monkeypatch)
        w = _edges(pk, 1, base=103000)
        pk.faults.install(pk.faults.FaultPlan(
            [pk.faults.FaultSpec("migration.catchup", "transient")],
            seed=0))
        with pytest.raises(pk.faults.TransientFault):
            mig.run_plan(_plan(pk), phase_hook=lambda ph, _j: (
                pk.dyn.insert_batch_into(list(sstore.stores), w)
                if ph == "clone" else None))
        pk.faults.clear()
        oracle = _oracle(pk, world)
        pk.dyn.insert_triples(oracle, w, check_ids=False)
        return {"digest": _digest(pk, sstore.stores[DONOR]),
                "oracle": _digest(pk, oracle)}

    rec = both(case)
    assert rec["digest"] == rec["oracle"]


def test_abort_after_published_cutover_swaps_back(world, monkeypatch):
    def case(pk):
        sstore = _sstore(pk, world)
        mig = _arm(pk, sstore, monkeypatch)
        donor_store = sstore.stores[DONOR]
        d0 = _digest(pk, donor_store)

        def hook(phase, _job):
            if phase == "cutover":
                raise RuntimeError("operator pulled the plug")

        with pytest.raises(RuntimeError):
            mig.run_plan(_plan(pk), phase_hook=hook)
        out, complete = _fetch(pk, sstore)
        return {"phase": mig.job().phase,
                "same_primary": sstore.stores[DONOR] is donor_store,
                "digest": _digest(pk, donor_store) == d0,
                "host": sstore.placement.get(DONOR, DONOR),
                "rotation": sstore.rotation,
                "abort": _events(pk, kind="shard.migrate.abort"),
                "served": bool(complete) and np.array_equal(
                    out, pk.emu._probe_read(donor_store))}

    rec = both(case)
    assert rec["phase"] == "aborted" and rec["same_primary"]
    assert rec["digest"] and rec["host"] == DONOR and rec["rotation"] == {}
    (ev,) = rec["abort"]
    assert ("swapped_back", True) in ev[2] and rec["served"]


def test_concurrent_abort_stops_the_state_machine(world, monkeypatch):
    def case(pk):
        sstore = _sstore(pk, world)
        mig = _arm(pk, sstore, monkeypatch)
        donor_store = sstore.stores[DONOR]

        def hook(phase, _job):
            if phase == "clone":  # the operator wins the race
                assert mig.abort(cause="operator").phase == "aborted"

        with pytest.raises(pk.errors.WukongError, match="aborted"):
            mig.run_plan(_plan(pk), phase_hook=hook)
        job = mig.job()
        with mig._lock:
            in_history = sum(1 for j in mig._history if j is job)
        return {"phase": job.phase, "cause": job.abort_cause,
                "same_primary": sstore.stores[DONOR] is donor_store,
                "placement": sstore.placement, "rotation": sstore.rotation,
                "in_history": in_history}

    rec = both(case)
    assert rec == {"phase": "aborted", "cause": "operator",
                   "same_primary": True, "placement": {}, "rotation": {},
                   "in_history": 1}


def test_abort_after_retire_keeps_recipient_serving(world, monkeypatch):
    def case(pk):
        monkeypatch.setattr(pk.G, "migration_rotate_reads", False)
        sstore = _sstore(pk, world)
        mig = _arm(pk, sstore, monkeypatch)
        oracle, _ok = _fetch(pk, sstore)

        def hook(phase, _job):
            if phase == "retire":
                raise RuntimeError("late failure")

        with pytest.raises(RuntimeError):
            mig.run_plan(_plan(pk), phase_hook=hook)
        out, complete = _fetch(pk, sstore)
        return {"phase": mig.job().phase,
                "primary": sstore.stores[DONOR] is not None,
                "placement": sstore.placement,
                "served": bool(complete) and np.array_equal(out, oracle)}

    assert both(case) == {"phase": "aborted", "primary": True,
                          "placement": {DONOR: RECIPIENT}, "served": True}


def test_remigration_grows_the_rotation_set(world, monkeypatch):
    def case(pk):
        sstore = _sstore(pk, world)
        mig = _arm(pk, sstore, monkeypatch)
        oracle, _ok = _fetch(pk, sstore)
        mig.run_plan(_plan(pk))
        mig.run_plan(_plan(pk, donor=DONOR, recipient=1))
        mid = (dict(sstore.placement),
               [h for h, _g in sstore.rotation[DONOR]])

        def hook(phase, _job):
            if phase == "cutover":
                raise RuntimeError("boom")

        with pytest.raises(RuntimeError):
            mig.run_plan(_plan(pk, donor=DONOR, recipient=0),
                         phase_hook=hook)
        turns = []
        for _ in range(6):
            out, complete = _fetch(pk, sstore)
            turns.append(bool(complete) and np.array_equal(out, oracle))
        return {"mid": mid, "placement": sstore.placement,
                "rotation": [h for h, _g in sstore.rotation[DONOR]],
                "turns": turns}

    rec = both(case)
    assert rec["mid"] == ({DONOR: 1}, [DONOR, RECIPIENT])
    assert rec["placement"] == {DONOR: 1}
    assert rec["rotation"] == [DONOR, RECIPIENT] and all(rec["turns"])


def test_operator_abort_via_executor(world, monkeypatch):
    def case(pk):
        sstore = _sstore(pk, world)
        mig = _arm(pk, sstore, monkeypatch)
        first = mig.abort(cause="operator")
        job = mig.run_plan(_plan(pk))
        return {"first": first, "phase": job.phase,
                "after": mig.abort(cause="operator")}

    assert both(case) == {"first": None, "phase": "done", "after": None}


# ---------------------------------------------------------------------------
# the kill drill: crash (no rollback) at each phase, then resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site", ["migration.clone", "migration.catchup",
                                  "migration.cutover"])
def test_kill_at_each_phase_resumes_with_zero_lost_writes(
        world, monkeypatch, tmp_path, site):
    def case(pk):
        monkeypatch.setattr(pk.G, "wal_dir", str(tmp_path / pk.root))
        sstore = _sstore(pk, world)
        mig = _arm(pk, sstore, monkeypatch)
        writes = [_edges(pk, 1, base=104000), _edges(pk, 1, base=105000)]
        pk.faults.install(pk.faults.FaultPlan(
            [pk.faults.FaultSpec(site, "transient")], seed=0))
        with pytest.raises(pk.faults.TransientFault):
            mig.run_plan(_plan(pk), rollback=False,
                         phase_hook=lambda ph, _j: (
                             pk.dyn.insert_batch_into(
                                 list(sstore.stores), writes[0],
                                 dedup=False) if ph == "clone" else None))
        pk.faults.clear()
        crashed = mig.job().phase
        pk.dyn.insert_batch_into(list(sstore.stores), writes[1],
                                 dedup=False)
        job = mig.resume(phase_hook=lambda ph, _j: None)
        oracle = _oracle(pk, world)
        for w in (writes if site != "migration.clone" else writes[1:]):
            pk.dyn.insert_triples(oracle, w, dedup=False, check_ids=False)
        (_h, rot), = sstore.rotation[DONOR]
        return {"crashed": crashed, "job": _job(job),
                "primary": _digest(pk, sstore.stores[DONOR]),
                "rotation": _digest(pk, rot),
                "oracle": _digest(pk, oracle),
                "placement": sstore.placement}

    rec = both(case)
    assert rec["crashed"] == site.split(".")[1]
    assert rec["job"]["phase"] == "done" and rec["job"]["attempts"] == 2
    assert rec["primary"] == rec["oracle"] == rec["rotation"]
    assert rec["placement"] == {DONOR: RECIPIENT}


def test_resume_guards(world, monkeypatch):
    def case(pk):
        sstore = _sstore(pk, world)
        mig = _arm(pk, sstore, monkeypatch)
        msgs = []
        with pytest.raises(pk.errors.WukongError,
                           match="no crashed migration") as e1:
            mig.resume()
        msgs.append(str(e1.value))
        mig.run_plan(_plan(pk))
        with pytest.raises(pk.errors.WukongError,
                           match="no crashed migration") as e2:
            mig.resume()
        msgs.append(str(e2.value))
        return msgs

    both(case)


def test_second_plan_refused_while_in_flight(world, monkeypatch):
    def case(pk):
        sstore = _sstore(pk, world)
        mig = _arm(pk, sstore, monkeypatch)
        hits = []

        def hook(phase, _job):
            if phase == "clone" and not hits:
                hits.append(phase)
                with pytest.raises(pk.errors.WukongError,
                                   match="already in flight"):
                    mig.run_plan(_plan(pk, donor=1, recipient=0))

        job = mig.run_plan(_plan(pk), phase_hook=hook)
        return {"hits": hits, "phase": job.phase,
                "placement": sstore.placement}

    assert both(case) == {"hits": ["clone"], "phase": "done",
                          "placement": {DONOR: RECIPIENT}}


def test_plan_validation(world, monkeypatch):
    def case(pk):
        sstore = _sstore(pk, world)
        mig = _arm(pk, sstore, monkeypatch)
        msgs = []
        for kw, pat in (({"donor": 99}, "donor shard"),
                        ({"recipient": 99}, "recipient host")):
            with pytest.raises(pk.errors.WukongError, match=pat) as e:
                mig.run_plan(_plan(pk, **kw))
            msgs.append((int(e.value.code), str(e.value)))
        with pytest.raises(pk.errors.WukongError,
                           match="no live sharded store") as e:
            pk.mig.MigrationExecutor().run_plan(_plan(pk))
        msgs.append((int(e.value.code), str(e.value)))
        return msgs

    both(case)


# ---------------------------------------------------------------------------
# surfaces: events filter, /plan, /healthz, Monitor, metrics, console
# ---------------------------------------------------------------------------

def test_events_migrate_filter(world, monkeypatch):
    def case(pk):
        sstore = _sstore(pk, world)
        _arm(pk, sstore, monkeypatch).run_plan(_plan(pk))
        _text, js = pk.events.render_events(kind="migrate")
        (cut,) = pk.events.get_journal().last(kind="shard.migrate.cutover")
        return {"counts": js["counts"],
                "shards": {e["shard"] for e in js["events"]},
                "kinds": [e["kind"] for e in js["events"]],
                "journal": [e.kind for e in pk.events.get_journal().last(
                    kind="shard.migrate")],
                "recipient": cut.attrs["recipient_host"],
                "pause_ok": cut.attrs["pause_us"] >= 0}

    rec = both(case)
    assert set(rec["counts"]) == {
        "shard.migrate.start", "shard.migrate.catchup",
        "shard.migrate.cutover", "shard.migrate.retire"}
    assert rec["shards"] == {DONOR} and rec["kinds"] == rec["journal"]
    assert rec["recipient"] == RECIPIENT and rec["pause_ok"]


def test_plan_surface_healthz_and_monitor_mid_flight(world, monkeypatch):
    def case(pk):
        sstore = _sstore(pk, world)
        mig = _arm(pk, sstore, monkeypatch)
        mon = pk.monitor.Monitor()
        seen = {}

        def hook(phase, _job):
            if phase != "cutover":
                return
            text, js = pk.placement.render_plan(advise=False)
            rep = pk.httpd.health_report()
            seen["plan"] = "migration IN FLIGHT" in text
            seen["plan_js"] = js["migration"]["in_flight"]
            seen["healthz_live"] = rep["live"]
            seen["healthz"] = rep["degraded"].get("migration")
            seen["monitor"] = mon.migration_lines()

        mig.run_plan(_plan(pk), phase_hook=hook)
        text, js = pk.placement.render_plan(advise=False)
        seen["after"] = ("IN FLIGHT" in text, js["migration"]["in_flight"],
                         js["migration"]["last"]["phase"],
                         "migration" in pk.httpd.health_report()["degraded"],
                         mon.migration_lines())
        return seen

    rec = both(case)
    assert rec["plan"] and rec["plan_js"] and rec["healthz_live"] is True
    assert rec["healthz"] == {"shard": DONOR, "phase": "cutover",
                              "recipient_host": RECIPIENT}
    assert rec["monitor"] and "Migration[" in rec["monitor"][0]
    assert rec["after"] == (False, False, "done", False, [])


def test_phase_gauge_tracks_the_state_machine(world, monkeypatch):
    def case(pk):
        sstore = _sstore(pk, world)
        mig = _arm(pk, sstore, monkeypatch)
        g0 = pk.mig._phase_gauge()
        gauges = {}
        mig.run_plan(_plan(pk), phase_hook=lambda ph, _j: gauges.setdefault(
            ph, pk.mig._phase_gauge()))
        snap = pk.metrics.get_registry().snapshot()["wukong_migration_phase"]
        return {"before": g0, "gauges": gauges,
                "after": pk.mig._phase_gauge(),
                "exported": snap["series"][0]["value"]}

    rec = both(case)
    assert rec["before"] == rec["after"] == rec["exported"] == 0.0
    assert rec["gauges"] == {ph: float(i + 1) for i, ph in
                             enumerate(P.mig.MIGRATION_PHASES)}


def test_console_migrate_verb_surfaces(world, capfd, monkeypatch):
    """The verbs with no dist world attached: status prints, abort is a
    no-op, a sweep reports no plan, and the armed posture does not crash;
    the port console logs the JAX console's lines."""
    from wukong_tpu.engine.cpu import CPUEngine as JCPU
    from wukong_tpu.runtime.console import Console as JConsole
    from wukong_tpu.runtime.proxy import Proxy as JProxy
    from wukong_tpu_torch.loader.lubm import VirtualLubmStrings as PSS
    from wukong_tpu_torch.runtime.console import Console as PConsole
    from wukong_tpu_torch.runtime.proxy import Proxy as PProxy

    monkeypatch.setattr(P.G, "enable_tpu", False)
    g = world["parts"]["wukong_tpu"][0]
    jss = VirtualLubmStrings(1, seed=42)
    jcon = JConsole(JProxy(g, jss, JCPU(g, jss)))
    pg = world["parts"]["wukong_tpu_torch"][0]
    pcon = PConsole(PProxy(pg, PSS(1, seed=42), device="cpu"))

    def run(con, pk):
        capfd.readouterr()
        outs = []
        for line in ("migrate -s -j", "migrate -abort", "migrate"):
            assert con.run_command(line) is True
            c = capfd.readouterr()
            outs.append(c.out.strip() + "|" + " ".join(
                ln.split("] ", 1)[-1] for ln in c.err.splitlines()))
        monkeypatch.setattr(pk.G, "migration_enable", True)
        assert con.run_command("migrate") is True
        c = capfd.readouterr()
        outs.append(" ".join(ln.split("] ", 1)[-1]
                             for ln in c.err.splitlines()))
        monkeypatch.setattr(pk.G, "migration_enable", False)
        return outs

    got, want = run(pcon, P), run(jcon, J)
    assert got == want
    assert '"in_flight": false' in got[0]
    assert "no migration in flight" in got[1]


def test_actuator_loop_start_stop(world, monkeypatch):
    def case(pk):
        sstore = _sstore(pk, world)
        monkeypatch.setattr(pk.G, "migration_enable", True)
        monkeypatch.setattr(pk.G, "placement_interval_s", 60)
        mig = pk.mig.maybe_start_migration(sstore)
        try:
            running = mig is not None and mig._thread is not None
            advisor_idle = pk.placement.get_advisor()._thread is None
        finally:
            pk.mig.get_migrator().stop()
        return {"running": running, "advisor_idle": advisor_idle,
                "stopped": pk.mig.get_migrator()._thread is None}

    assert both(case) == {"running": True, "advisor_idle": True,
                          "stopped": True}


# ---------------------------------------------------------------------------
# the executed rebalance drill
# ---------------------------------------------------------------------------

def _rebalance(pk, world, n_ops, rounds=1):
    """Emulator.run_rebalance over a fresh sharded store, ``rounds`` times
    or until rebalanced; returns each round's report, less its clocks."""
    sstore = _sstore(pk, world)
    emu = pk.emu.Emulator(_proxy(pk, world))
    out = []
    for _ in range(rounds):
        rep = emu.run_rebalance(n_ops=n_ops, zipf_a=1.6, seed=7,
                                sstore=sstore)
        p = rep["plan"]
        out.append({
            "hot": rep["hot"], "ranked": rep["ranked"],
            "executed": rep["executed"], "donor_is_hot":
                rep["plan_donor_is_hot"],
            "identical": rep["queries_identical"],
            "probes": rep["probes"], "rebalanced": rep["rebalanced"],
            "decision_after": rep["decision_after"],
            "before": rep["imbalance_before"],
            "after": round(rep["imbalance_after"], 3),
            "gain_over_1": rep["rebalance_gain"] > 1.0,
            "job": {k: v for k, v in rep["job"].items()
                    if k not in ("plan_id", "event_ids",
                                 "cutover_pause_us")},
            "store_untouched": rep["store_untouched"],
            "plan": (p["donor_shard"], p["recipient_host"]),
            "placement": dict(sstore.placement)})
        if rep["rebalanced"]:
            break
    return out


def _proxy(pk, world):
    if pk.port:
        from wukong_tpu_torch.loader.lubm import VirtualLubmStrings as PSS
        from wukong_tpu_torch.runtime.proxy import Proxy

        pk.G.enable_tpu = False
        return Proxy(world["parts"][pk.root][0], PSS(1, seed=42),
                     device="cpu")
    from wukong_tpu.engine.cpu import CPUEngine
    from wukong_tpu.runtime.proxy import Proxy

    g = world["parts"][pk.root][0]
    ss = VirtualLubmStrings(1, seed=42)
    return Proxy(g, ss, CPUEngine(g, ss))


def test_rebalance_drill_executes_and_rebalances(world, monkeypatch):
    for pk in PKGS:
        monkeypatch.setattr(pk.G, "migration_enable", True)
        monkeypatch.setattr(pk.G, "enable_tpu", pk.G.enable_tpu)
    (rep,) = both(_rebalance, world, 900)
    assert rep["executed"] and rep["donor_is_hot"] and rep["identical"]
    assert set(rep["probes"]) == set(P.mig.MIGRATION_PHASES) | {"post"}
    assert rep["rebalanced"] and rep["decision_after"] == "balanced"
    assert rep["after"] < rep["before"] and rep["gain_over_1"]
    assert rep["job"]["phase"] == "done" and rep["job"]["bytes_moved"] > 0
    assert rep["store_untouched"] is False
    assert rep["placement"] == {rep["hot"]: rep["plan"][1]}


def test_rebalance_drill_refuses_when_disarmed(world, monkeypatch):
    def case(pk):
        monkeypatch.setattr(pk.G, "enable_tpu", pk.G.enable_tpu)
        sstore = _sstore(pk, world)
        emu = pk.emu.Emulator(_proxy(pk, world))
        with pytest.raises(pk.errors.WukongError,
                           match="migration_enable is off") as e:
            emu.run_rebalance(n_ops=600, zipf_a=1.6, seed=7, sstore=sstore)
        return {"msg": str(e.value), "placement": sstore.placement}

    assert both(case)["placement"] == {}


# ---------------------------------------------------------------------------
# the migration-safety analysis gate
# ---------------------------------------------------------------------------

def test_migration_gate_fixtures(tmp_path):
    from wukong_tpu.analysis import run_analysis as jax_run
    from wukong_tpu_torch.analysis import run_analysis

    def write(name: str, tree: dict) -> str:
        root = tmp_path / name
        for rel, src in tree.items():
            p = root / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(src)
        return str(root)

    bad = write("bad", {
        "runtime/migration.py": (
            "MIGRATION_PHASES = ('clone', 'cutover')\n"
            "def _phase_cutover(job):\n"
            "    emit_event('shard.migrate.cutover', shard=1)\n"
            "    swap()\n"
            "lock = make_lock('migration.state')\n"),
        "parallel/sharded_store.py": (
            "def cutover_shard(i, store):\n"
            "    stores[i] = store\n")})
    got = run_analysis(bad, plugins=["migration-safety"])
    want = jax_run(bad, plugins=["migration-safety"])
    assert [(v.path, v.line, v.message) for v in got] == \
        [(v.path, v.line, v.message) for v in want]
    msgs = "\n".join(str(v) for v in got)
    for frag in ("shard.migrate.start", "shard.migrate.abort",
                 "_phase_cutover", "cutover_shard", "migration.state"):
        assert frag in msgs

    good = write("good", {
        "runtime/migration.py": (
            "MIGRATION_PHASES = ('clone', 'catchup', 'cutover', 'retire')\n"
            "declare_leaf('migration.state')\n"
            "lock = make_lock('migration.state')\n"
            "def run(job):\n"
            "    emit_event('shard.migrate.start', shard=1)\n"
            "    emit_event('shard.migrate.catchup', shard=1)\n"
            "    emit_event('shard.migrate.retire', shard=1)\n"
            "    emit_event('shard.migrate.abort', shard=1)\n"
            "def _phase_cutover(job):  # guarded by: the migration lock\n"
            "    emit_event('shard.migrate.cutover', shard=1)\n"),
        "parallel/sharded_store.py": (
            "def cutover_shard(self, i, store):\n"
            "    with self._migration_lock:\n"
            "        self.stores[i] = store\n")})
    assert run_analysis(good, plugins=["migration-safety"]) == []
    empty = str(tmp_path / "empty")
    os.makedirs(empty, exist_ok=True)
    assert run_analysis(empty, plugins=["migration-safety"]) == []


def test_repo_migration_gate_clean():
    from wukong_tpu.analysis import run_analysis as jax_run
    from wukong_tpu_torch.analysis import run_analysis

    pkg = os.path.join(REPO, "wukong_tpu_torch")
    assert run_analysis(pkg, plugins=["migration-safety"]) == []
    # the JAX gate finds nothing in the port's actuator either
    assert jax_run(pkg, plugins=["migration-safety"]) == []
