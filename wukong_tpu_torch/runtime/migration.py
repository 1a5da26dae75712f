"""Live shard-migration actuator: crash-safe clone / catch-up / cutover / retire.

The port's copy of the JAX package's runtime/migration.py, over the port's
sharded store (parallel/sharded_store.py: D shard slots on one device).
:class:`MigrationExecutor` is the actuator of the placement advisor's
``MigrationPlan`` (obs/placement.py; Pragh, ATC'19 — live repartitioning
without downtime): it drives a four-phase state machine, each phase
journaled (``shard.migrate.*``) and each of clone / catch-up / cutover an
injectable fault site:

1. **clone** — snapshot the donor shard's primary onto the recipient host
   through the transport seam (``Transport.snapshot``, runtime/transport.py:
   the structural ``persist.clone_gstore`` copy). The snapshot is taken
   under the WAL *mutation lock*, so it is exact at a recorded WAL
   high-water mark (``seq_clone``).
2. **catch-up** — replay the WAL tail ``(seq_clone, now]`` onto the
   recipient under the mutation lock, with re-logging suppressed, then
   enroll the recipient as a **dual-write sink** (store/dynamic.py) inside
   the same critical section: from this instant every committed batch or
   epoch reaches the recipient too, so no mutation can fall between replay
   and dual-write. With the WAL off, the dual-write starts at the snapshot
   instant instead and catch-up is a no-op.
3. **cutover** — atomically swap the read path to the recipient
   (``ShardedDeviceStore.cutover_shard``: primary install, placement
   update, breaker close, staging invalidation), deroll the dual sink, and
   rebind long-lived mutation fan-out lists (the stream ingestor's), all in
   ONE mutation-locked section. The pause is measured
   (``cutover_pause_us``). With ``migration_rotate_reads`` (default on) the
   donor copy is demoted to a read-rotation replica on its old host; off
   drops it. The swap drops every staging, so the next query restages every
   shard's segments from the new primaries (on the card: fresh inputs of
   K1, with the stacked segments' shared geometry recomputed).
4. **retire** — release the donor copy (unless rotated), re-arm the
   shard's breaker, journal completion, observe the duration histogram.

Crash safety: every phase is resumable and abortable. ``abort()`` rolls
back to the donor — dual sink derolled, a completed cutover swapped back —
with the donor's ``persist.gstore_digest`` untouched (the migration only
ever *reads* the donor). ``resume()`` rolls forward from the recorded
state: a crash in clone or catch-up restarts from a fresh snapshot, a crash
at cutover redoes the idempotent swap, a crash at retire re-retires. Writes
issued during any phase survive.

Known bound (shared with the heal promotion path): a writer that
snapshotted its fan-out target list *before* a cutover and commits *after*
it applies to the retired donor object. The window is one in-flight
``_insert_targets()`` call; stream epochs are immune (their bound list is
rebound inside the cutover's critical section).

Wired behind the ``migration_enable`` knob (default off: the advisor stays
observe-only and ``run_plan`` refuses). With it on and
``placement_interval_s > 0``, the actuator loop sweeps the advisor and
executes each plan. Surfaces: the ``migrate`` / ``migrate -abort`` console
verbs, in-flight state on ``/plan`` and ``/healthz`` (a mid-cutover shard
reports degraded-not-dead), a Monitor ``Migration[...]`` line, and the
``wukong_migration*`` metrics.
"""

from __future__ import annotations

import threading
import weakref
from collections import deque
from dataclasses import dataclass, field

from wukong_tpu_torch.analysis.lockdep import (
    declare_leaf,
    make_lock,
    register_global_lock,
)
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.events import emit_event
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.obs.placement import MigrationPlan, get_advisor, get_lineage
from wukong_tpu_torch.store.wal import active_wal, mutation_lock
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError
from wukong_tpu_torch.utils.logger import log_info, log_warn
from wukong_tpu_torch.utils.timer import get_usec

#: the actuator's phase order — a literal registry (the migration-safety
#: analysis gate pins it and requires every phase transition to journal)
MIGRATION_PHASES = ("clone", "catchup", "cutover", "retire")

# the executor state lock guards job-field/history updates only (plain
# scalar/deque writes) — innermost by construction; events/metrics are
# always emitted OUTSIDE it, and the phase bodies take the WAL mutation
# lock BEFORE ever touching it
declare_leaf("migration.state")

_M_MIGRATIONS = get_registry().counter(
    "wukong_migrations_total", "Shard migrations by outcome",
    labels=("outcome",))
_M_BYTES = get_registry().counter(
    "wukong_migration_bytes_total", "Bytes moved by shard migrations")
_M_DURATION = get_registry().histogram(
    "wukong_migration_duration_us",
    "End-to-end shard-migration duration (usec)")
_M_ABORTS = get_registry().counter(
    "wukong_migration_aborts_total", "Migration aborts by cause",
    labels=("cause",))


@dataclass
class MigrationJob:
    """One migration's live state — the resumable record ``resume()``
    rolls forward from and ``abort()`` rolls back from."""

    plan: MigrationPlan
    t_start_us: int = 0
    phase: str = "pending"  # pending|clone|catchup|cutover|retire|done|aborted
    next_i: int = 0  # index of the next phase to run (resume cursor)
    attempts: int = 0  # execute/resume entries (journaled on re-runs)
    seq_clone: int = -1  # WAL high-water mark at the snapshot instant
    replayed: int = 0  # WAL records replayed by catch-up
    bytes_moved: int = 0
    cutover_pause_us: int = 0
    donor_host: int | None = None
    abort_cause: str = ""
    rotated: bool = False  # donor demoted to a read-rotation replica
    event_ids: list = field(default_factory=list)
    recipient: object = None  # the in-flight clone (GStore)
    donor_store: object = None  # rollback anchor until retire
    dirty_catchup: bool = False  # a partial replay may have landed

    def to_dict(self) -> dict:
        return {"plan_id": self.plan.plan_id,
                "donor_shard": self.plan.donor_shard,
                "recipient_host": self.plan.recipient_host,
                "phase": self.phase, "attempts": self.attempts,
                "seq_clone": self.seq_clone, "replayed": self.replayed,
                "bytes_moved": self.bytes_moved,
                "cutover_pause_us": self.cutover_pause_us,
                "rotated": self.rotated,
                "abort_cause": self.abort_cause,
                "event_ids": list(self.event_ids)}


def _sink_key(donor: int) -> tuple:
    return ("migrate", int(donor))


class MigrationExecutor:
    """Drives MigrationPlans through the four-phase state machine; one
    migration in flight at a time (the cluster moves one shard, proves
    balance, then moves the next — the advisory loop's cadence)."""

    def __init__(self, sstore=None, owner=None):
        # weakref posture (the advisor's): the executor is process-global,
        # and a strong capture would pin a retired world's partitions (and
        # the proxy that owns them) in memory
        self._sstore_ref = None  # lock-free: rebound atomically; phases deref once
        self._owner_ref = None  # lock-free: rebound atomically (the proxy, for fan-out rebinds)
        self.attach(sstore=sstore, owner=owner)
        self._lock = make_lock("migration.state")
        # reference swaps + job-field updates; phases run on one runner
        # thread, readers are /plan + Monitor + healthz threads
        self._job: MigrationJob | None = None  # guarded by: _lock
        self._history: deque = deque(maxlen=32)  # guarded by: _lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None  # lock-free: start/stop are operator-thread only

    # ------------------------------------------------------------------
    def attach(self, sstore=None, owner=None) -> None:
        """Bind the sharded store (weakly) and the owning proxy (weakly;
        duck-typed: ``_insert_targets()`` and optionally ``_stream`` /
        ``_on_store_change`` are used for post-cutover fan-out rebinds)."""
        if sstore is not None:
            self._sstore_ref = weakref.ref(sstore)
        if owner is not None:
            self._owner_ref = weakref.ref(owner)

    def _store(self):
        ref = self._sstore_ref
        return ref() if ref is not None else None

    def _owner(self):
        ref = self._owner_ref
        return ref() if ref is not None else None

    def _require_store(self):
        ss = self._store()
        if ss is None:
            raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                              "no live sharded store attached — nothing "
                              "to migrate (--dist worlds only)")
        return ss

    # ------------------------------------------------------------------
    # the state machine
    # ------------------------------------------------------------------
    def run_plan(self, plan: MigrationPlan, phase_hook=None,
                rollback: bool = True) -> MigrationJob:
        """Run one plan end to end. ``phase_hook(phase, job)`` fires after
        each completed phase (drills interleave probes/writes there). Any
        phase failure rolls back via :meth:`abort` and re-raises;
        ``rollback=False`` leaves the crashed state in place instead (the
        kill drill's posture — :meth:`resume` picks it up)."""
        if not Global.migration_enable:
            raise WukongError(
                ErrorCode.UNSUPPORTED_SHAPE,
                "migration_enable is off — the actuator refuses to move "
                "shards (observe-only posture; flip the knob to arm it)")
        ss = self._require_store()
        donor = int(plan.donor_shard)
        recipient_host = int(plan.recipient_host)
        if not 0 <= donor < ss.D:
            raise WukongError(ErrorCode.UNKNOWN_PATTERN,
                              f"plan names donor shard {donor} but the "
                              f"store has {ss.D} shards")
        if not 0 <= recipient_host < ss.D:
            raise WukongError(ErrorCode.UNKNOWN_PATTERN,
                              f"plan names recipient host {recipient_host} "
                              f"but the cluster has {ss.D} hosts")
        with self._lock:
            if self._job is not None and self._job.phase not in ("done",
                                                                 "aborted"):
                cur = self._job.plan.plan_id
            else:
                cur = None
                self._job = MigrationJob(plan=plan, t_start_us=get_usec())
            job = self._job
        if cur is not None:
            raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                              f"migration {cur} is already in flight — "
                              "abort it or let it finish")
        try:
            self._run(job, phase_hook)
        except BaseException as e:
            if rollback:
                self.abort(cause=self._cause(e))
            raise
        return job

    def resume(self, phase_hook=None) -> MigrationJob:
        """Roll the crashed in-flight migration forward from its recorded
        state. A crash in clone or catch-up restarts from a fresh snapshot
        (a partially-replayed recipient must never double-apply a
        non-dedup record); a crash at cutover/retire redoes the idempotent
        phase."""
        with self._lock:
            job = self._job
        if job is None or job.phase in ("done", "aborted"):
            raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                              "no crashed migration to resume (aborted "
                              "plans re-execute from scratch)")
        if job.next_i <= 1 or job.dirty_catchup:
            # clone or catch-up did not complete: discard the copy and
            # re-snapshot — the WAL tail from the NEW seq_clone covers
            # every write the discarded copy might have missed
            self._drop_copy(job)
            with self._lock:
                job.next_i = 0
                job.replayed = 0
                job.dirty_catchup = False
        try:
            self._run(job, phase_hook)
        except BaseException as e:
            self.abort(cause=self._cause(e))
            raise
        return job

    def _run(self, job: MigrationJob, phase_hook) -> None:
        phases = (self._phase_clone, self._phase_catchup,
                  self._phase_cutover, self._phase_retire)
        with self._lock:
            job.attempts += 1
        while job.next_i < len(phases):
            i = job.next_i
            # a concurrent abort() (the operator's `migrate -abort`
            # against the actuator loop's runner thread) wins: the state
            # machine must never roll forward past an abort, and a phase
            # that raced the abort gets its side effects re-rolled-back
            with self._lock:
                aborted = job.phase == "aborted"
                if not aborted:
                    job.phase = MIGRATION_PHASES[i]
            if aborted:
                self._abort_raced(job)
            phases[i](job)
            with self._lock:
                aborted = job.phase == "aborted"
                if not aborted:
                    job.next_i = i + 1
            if aborted:
                self._abort_raced(job)
            if phase_hook is not None:
                phase_hook(MIGRATION_PHASES[i], job)
        with self._lock:
            if job.phase == "aborted":  # abort raced the final hook
                aborted = True
            else:
                aborted = False
                job.phase = "done"
                job.donor_store = None  # rollback anchor released
                self._history.append(job)
        if aborted:
            self._abort_raced(job)
        _M_MIGRATIONS.labels(outcome="completed").inc()
        _M_DURATION.observe(get_usec() - job.t_start_us)
        log_info(
            f"migration {job.plan.plan_id} complete: shard "
            f"{job.plan.donor_shard} -> host {job.plan.recipient_host} "
            f"({job.bytes_moved / 2**20:.1f} MiB, {job.replayed} WAL "
            f"records caught up, cutover pause {job.cutover_pause_us}us"
            f"{', donor rotated' if job.rotated else ''})")

    def _abort_raced(self, job: MigrationJob) -> None:
        """A concurrent :meth:`abort` landed while a phase was running:
        its rollback may predate the racing phase's side effects (a sink
        enrolled, a cutover published), so re-roll them back, then stop
        the runner."""
        self._rollback(job)
        with self._lock:
            job.recipient = None
        raise WukongError(
            ErrorCode.UNSUPPORTED_SHAPE,
            f"migration {job.plan.plan_id} aborted "
            f"({job.abort_cause or 'operator'}) — the state machine "
            "stops here")

    @staticmethod
    def _cause(e: BaseException) -> str:
        from wukong_tpu_torch.runtime.faults import ShardDown, TransientFault

        if isinstance(e, (TransientFault, ShardDown)):
            return "injected_fault"
        if isinstance(e, WukongError):
            return e.code.name.lower()
        return type(e).__name__.lower()

    # ------------------------------------------------------------------
    def _phase_clone(self, job: MigrationJob) -> None:
        """Snapshot the donor under the mutation lock: exact at
        ``seq_clone``, writes pause only for the copy. The copy itself is
        a transport transfer (runtime/transport.py ``snapshot``: the
        in-memory structural clone)."""
        from wukong_tpu_torch.runtime import faults
        from wukong_tpu_torch.store.dynamic import enroll_migration_sink

        ss = self._require_store()
        donor = job.plan.donor_shard
        ev = emit_event("shard.migrate.start", shard=donor,
                        plan=job.plan.plan_id,
                        recipient_host=job.plan.recipient_host,
                        predicted_bytes=job.plan.predicted_move_bytes,
                        attempt=job.attempts)
        if ev:
            job.event_ids.append(ev)
        faults.site("migration.clone", shard=donor)
        wal = active_wal()
        with mutation_lock():
            job.seq_clone = (wal.next_seq - 1) if wal is not None else -1
            job.donor_store = ss.stores[donor]
            job.donor_host = ss.host_of(donor)
            job.recipient = ss.transport.snapshot(donor, job.donor_store)
            if wal is None:
                # no WAL tail to catch up from: dual-write must start at
                # the snapshot instant, inside this same critical section
                enroll_migration_sink(_sink_key(donor), job.recipient)
        mb = getattr(job.recipient, "memory_bytes", None)
        job.bytes_moved = int(mb()) if callable(mb) else int(
            job.plan.predicted_move_bytes)
        _M_BYTES.inc(job.bytes_moved)

    def _phase_catchup(self, job: MigrationJob) -> None:
        """Replay the WAL tail ``(seq_clone, now]`` onto the recipient and
        enroll the dual-write sink, one mutation-locked section: every
        committed batch is either replayed here or dual-applied after —
        never both, never neither."""
        from wukong_tpu_torch.runtime import faults
        from wukong_tpu_torch.store.dynamic import (
            enroll_migration_sink,
            insert_triples,
        )

        donor = job.plan.donor_shard
        faults.site("migration.catchup", shard=donor)
        wal = active_wal()
        replayed = 0
        if wal is not None:
            with mutation_lock():
                job.dirty_catchup = True
                # suppression is safe here: the mutation lock excludes
                # live commits for the replay window, so only the replay
                # itself is suppressed (direct per-partition inserts fire
                # no WAL hook anyway — the _rebuild_shard contract)
                with wal.suppress():
                    from wukong_tpu_torch.vector.vstore import apply_vector_record

                    for rec in wal.replay(after_seq=job.seq_clone):
                        if rec.kind == "vector":
                            # embedding mutations ride the same tail: the
                            # recipient's vstore must match the donor's at
                            # sink-enroll time or knn answers tear on cutover
                            apply_vector_record(job.recipient, rec.payload)
                        else:
                            insert_triples(
                                job.recipient, rec.payload["triples"],
                                dedup=bool(rec.payload.get("dedup", True)),
                                check_ids=False)
                        replayed += 1
                enroll_migration_sink(_sink_key(donor), job.recipient)
                job.dirty_catchup = False
        job.replayed = replayed
        ev = emit_event("shard.migrate.catchup", shard=donor,
                        plan=job.plan.plan_id, replayed=replayed,
                        since_seq=job.seq_clone)
        if ev:
            job.event_ids.append(ev)

    def _phase_cutover(self, job: MigrationJob) -> None:
        """Swap the read path to the recipient and retire the dual sink in
        one mutation-locked section; the measured pause is the only write
        stall the cutover costs."""
        from wukong_tpu_torch.runtime import faults
        from wukong_tpu_torch.store.dynamic import deroll_migration_sink

        ss = self._require_store()
        donor = job.plan.donor_shard
        faults.site("migration.cutover", shard=donor)
        rotate = bool(Global.migration_rotate_reads)
        t0 = get_usec()
        # the swap itself is guarded by: the store's _migration_lock
        # (taken inside cutover_shard); this frame additionally holds the
        # WAL mutation lock so no batch commit straddles the publication
        with mutation_lock():
            if ss.stores[donor] is not job.recipient:  # resume idempotence
                ss.cutover_shard(donor, job.recipient,
                                 job.plan.recipient_host, rotate=rotate)
            job.rotated = bool(ss.rotation.get(donor))
            deroll_migration_sink(_sink_key(donor))
            # long-lived bound fan-out lists (the stream ingestor's) must
            # learn the new primary inside the SAME critical section, or
            # the next epoch would insert into the retired donor
            self._rebind_targets()
            # the serving plane's actuator edge (serve/): the
            # read-path swap purges the real result cache inside the
            # same critical section — the clone is byte-identical, but a
            # rotation-split read after the publication must never race
            # a stale entry. One knob check when the cache is off.
            from wukong_tpu_torch.serve import notify_mutation

            notify_mutation("cutover", shard=donor)
        job.cutover_pause_us = get_usec() - t0
        get_lineage().observe_store(ss)  # post-move lineage, immediately
        # cache-coherence telemetry (obs/reuse.py): a read-path swap is a
        # conservative full purge for a version-keyed result cache (the
        # shard's version counter travels with the byte-identical clone,
        # so a version-diff kill would see no edge — the swap itself is
        # the invalidation). Outside the mutation lock, after the pause
        # measurement: pure observability
        from wukong_tpu_torch.obs.reuse import maybe_note_invalidation

        maybe_note_invalidation("cutover", version=None, shard=donor,
                                plan=job.plan.plan_id)
        ev = emit_event("shard.migrate.cutover", shard=donor,
                        plan=job.plan.plan_id,
                        recipient_host=job.plan.recipient_host,
                        pause_us=job.cutover_pause_us,
                        rotated=job.rotated)
        if ev:
            job.event_ids.append(ev)
        own = self._owner()
        if own is not None and hasattr(own, "_on_store_change"):
            own._on_store_change()  # plan caches / compiled chains re-derive

    def _phase_retire(self, job: MigrationJob) -> None:
        """Release the donor copy (unless demoted to a rotation replica at
        cutover) and re-arm the shard's breaker."""
        ss = self._require_store()
        donor = job.plan.donor_shard
        if not job.rotated:
            job.donor_store = None  # the last strong ref: the copy dies
        ss.breaker.record_success(donor)  # migrations end with a closed breaker
        ev = emit_event("shard.migrate.retire", shard=donor,
                        plan=job.plan.plan_id, rotated=job.rotated,
                        bytes=job.bytes_moved)
        if ev:
            job.event_ids.append(ev)

    def _rebind_targets(self) -> None:  # caller holds: wal.mutation_lock
        own = self._owner()
        if own is None:
            return
        stream = getattr(own, "_stream", None)
        if stream is not None and hasattr(own, "_insert_targets"):
            stream.ingestor.stores = own._insert_targets()

    def _drop_copy(self, job: MigrationJob) -> None:
        """Discard the in-flight recipient copy + its dual sink (rollback
        or re-snapshot); the donor is untouched by construction."""
        from wukong_tpu_torch.store.dynamic import deroll_migration_sink

        with mutation_lock():
            deroll_migration_sink(_sink_key(job.plan.donor_shard))
        job.recipient = None

    def _rollback(self, job: MigrationJob) -> bool:
        """Deroll the dual sink and, when a cutover already published the
        recipient, swap the read path back to the donor. Idempotent (also
        re-run after a phase raced a concurrent abort). Returns whether a
        published cutover was swapped back."""
        from wukong_tpu_torch.store.dynamic import deroll_migration_sink

        ss = self._store()
        donor = job.plan.donor_shard
        swapped = False
        with mutation_lock():
            deroll_migration_sink(_sink_key(donor))
            if (ss is not None and job.recipient is not None
                    and ss.stores[donor] is job.recipient
                    and job.donor_store is not None):
                # cutover already published: swap the read path back. A
                # retire that already RELEASED the donor leaves nothing
                # to swap back to — the recipient stays primary (the
                # migration is committed in all but name)
                ss.rollback_cutover(donor, job.donor_store, job.donor_host)
                swapped = True
                self._rebind_targets()
                # the swap-back is a read-path publication like the
                # cutover itself: the real result cache purges inside
                # the same critical section (serve plane actuator edge)
                from wukong_tpu_torch.serve import notify_mutation

                notify_mutation("cutover", shard=donor)
        return swapped

    # ------------------------------------------------------------------
    def abort(self, cause: str = "operator") -> MigrationJob | None:
        """Roll the in-flight migration back to the donor: dual sink
        derolled, a completed cutover swapped back, recipient discarded.
        The donor's content digest is untouched — the migration only ever
        read it. Safe against a concurrently running runner thread: the
        state machine re-checks for the abort at every phase boundary and
        re-rolls-back anything a racing phase published. Returns the
        aborted job, or None when nothing is in flight."""
        with self._lock:
            job = self._job
            if job is None or job.phase in ("done", "aborted"):
                return None
            at_phase = job.phase
            job.phase = "aborted"  # published FIRST: the runner stops here
            job.abort_cause = str(cause)
        swapped = self._rollback(job)
        donor = job.plan.donor_shard
        with self._lock:
            job.recipient = None
            self._history.append(job)
        ev = emit_event("shard.migrate.abort", shard=donor,
                        plan=job.plan.plan_id, cause=str(cause),
                        at_phase=at_phase, swapped_back=swapped)
        if ev:
            job.event_ids.append(ev)
        _M_ABORTS.labels(cause=str(cause)).inc()
        _M_MIGRATIONS.labels(outcome="aborted").inc()
        own = self._owner()
        if swapped and own is not None and hasattr(own, "_on_store_change"):
            own._on_store_change()
        log_warn(f"migration {job.plan.plan_id} aborted at {at_phase} "
                 f"({cause}); donor shard {donor} untouched"
                 + (" (cutover rolled back)" if swapped else ""))
        return job

    # ------------------------------------------------------------------
    def status(self) -> dict:
        """The actuator's surface body (/plan, /healthz probe, Monitor)."""
        with self._lock:
            job = self._job
            last = self._history[-1] if self._history else None
        in_flight = job is not None and job.phase not in ("done", "aborted")
        return {"enabled": bool(Global.migration_enable),
                "in_flight": in_flight,
                "job": job.to_dict() if job is not None else None,
                "last": last.to_dict() if last is not None else None}

    def job(self) -> MigrationJob | None:
        with self._lock:
            return self._job

    def reset(self) -> None:
        """Tests: stop the loop, drop job/history/attachments, deroll any
        leaked dual sink."""
        self.stop()
        with self._lock:
            job = self._job
        if job is not None and job.phase not in ("done", "aborted"):
            self.abort(cause="reset")
        with self._lock:
            self._job = None
            self._history.clear()
        self._sstore_ref = None
        self._owner_ref = None

    # ------------------------------------------------------------------
    # the actuator loop (the advisory loop, armed)
    # ------------------------------------------------------------------
    def start(self) -> "MigrationExecutor":
        """Launch the background actuator loop: every
        ``placement_interval_s`` seconds, sweep the advisor and execute
        the plan it emits. Idempotent; the thread is a daemon."""
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run_loop, daemon=True,
                                        name="migration-actuator")
        self._thread.start()
        return self

    def _run_loop(self) -> None:
        me = threading.current_thread()
        while not self._stop.wait(max(float(Global.placement_interval_s
                                            or 1), 1.0)):
            if self._thread is not me:
                return  # superseded: an execute overran stop()'s join
            if (not Global.migration_enable
                    or Global.placement_interval_s <= 0):
                continue  # knobs flipped off at runtime: idle
            try:
                with self._lock:
                    busy = (self._job is not None
                            and self._job.phase not in ("done", "aborted"))
                if busy or self._store() is None:
                    continue
                plan = get_advisor().advise_once()
                if plan is not None:
                    self.run_plan(plan)
            except Exception as e:  # the actuator must never die silently
                log_warn(f"migration actuator sweep failed: {e!r}")

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        # clear BEFORE the fresh Event below (the advisor's straggler-safe
        # stop pattern): _run_loop self-retires once superseded
        self._thread = None
        if t is not None:
            t.join(timeout=2)
        self._stop = threading.Event()


# process-wide actuator (console verb, /plan, Monitor, healthz share it)
_migrator = MigrationExecutor()
# checked mode (lockdep.install) rebuilds the singleton's state lock
register_global_lock(_migrator, "_lock", "migration.state")


def get_migrator() -> MigrationExecutor:
    return _migrator


def maybe_start_migration(sstore=None, owner=None
                          ) -> "MigrationExecutor | None":
    """Attach the sharded store/owner and start the actuator loop when
    ``migration_enable`` + ``placement_interval_s`` ask for one. The
    attach happens either way so the ``migrate`` verb works on demand.
    Returns the executor when its loop runs (the caller then skips the
    observe-only advisor loop — one sweeper, not two), else None."""
    _migrator.attach(sstore=sstore, owner=owner)
    if sstore is not None:
        get_advisor().attach_store(sstore)
    if not Global.migration_enable or Global.placement_interval_s <= 0:
        return None
    if _migrator._store() is None:
        return None
    # the actuator loop sweeps the advisor itself: the observe-only loop
    # would double every decision counter if both ran
    get_advisor().stop()
    return _migrator.start()


def _phase_gauge() -> float:
    """Pull gauge: the in-flight phase as an index into MIGRATION_PHASES
    (1-based; 0 = idle/done/aborted)."""
    job = _migrator.job()
    if job is None or job.phase not in MIGRATION_PHASES:
        return 0.0
    return float(MIGRATION_PHASES.index(job.phase) + 1)


get_registry().gauge(
    "wukong_migration_phase",
    "In-flight migration phase (1=clone..4=retire, 0=idle)"
).set_function(_phase_gauge)


def _health_probe():
    """/healthz readiness source: a shard mid-migration serves (live),
    but the process reports degraded-not-dead until retire."""
    st = _migrator.status()
    if not st["in_flight"]:
        return None
    j = st["job"]
    return {"shard": j["donor_shard"], "phase": j["phase"],
            "recipient_host": j["recipient_host"]}


from wukong_tpu_torch.obs.httpd import register_health_source  # noqa: E402

register_health_source("migration", _health_probe)
