"""Shard lineage + the observe-only placement advisor (MigrationPlan).

The port's copy of the JAX package's obs/placement.py. Three pieces:

- :class:`ShardLineage` — the per-shard placement ledger: primary host,
  replica hosts, store version, last failover/heal timestamps, and the
  shard's last measured **checkpoint byte size** (``RecoveryManager.
  checkpoint`` records each partition file's on-disk bytes). This is what
  "how much data would a migration move" is answered from.
- :class:`MigrationPlan` — the literal decision artifact a migration
  control plane consumes: donor shard, recipient host, predicted bytes to
  move, and the predicted post-move balance. Its field set is pinned by
  the literal ``MIGRATION_PLAN_FIELDS`` registry (the
  ``placement-telemetry`` analysis gate holds the two identical).
- :class:`PlacementAdvisor` — **observe-only**: reads the heat plane's
  ``PLACEMENT_INPUTS`` *through the tsdb trend windows* (per-shard fetch
  rates over ``placement_window_s`` — a sustained hot spot, not a
  transient spike), scores imbalance as the max/mean per-host load-rate
  ratio of the attached sharded store, and emits a MigrationPlan when it
  reaches ``placement_imbalance_x``. It never touches the store. The
  predicted post-move state models donor reads split across
  donor+recipient (replica-read rotation). With no store attached (a
  proxy over one partition), a sweep over heat reports ``no_store``.

Surfaced as ``GET /plan`` + ``/plan.json``, the ``plan`` console verb, a
Monitor ``Placement[...]`` rolling-report line, and the
``wukong_placement_*`` metrics. An optional advisory loop runs at
``placement_interval_s`` (0 = advise on demand only, the default). The
migration actuator (runtime/migration.py) executes plans; ``render_plan``
carries its in-flight state, and the lineage observes each move at its
cutover.
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field, fields

from wukong_tpu_torch.analysis.lockdep import (
    declare_leaf,
    make_lock,
    register_global_lock,
)
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.heat import PLACEMENT_INPUTS
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.obs.tsdb import get_tsdb
from wukong_tpu_torch.utils.logger import log_info, log_warn
from wukong_tpu_torch.utils.timer import get_usec

#: the MigrationPlan artifact's field registry — a literal the
#: placement-telemetry analysis gate compares against the dataclass, so
#: the control plane's consumption surface can never drift silently
MIGRATION_PLAN_FIELDS = (
    "plan_id", "t_us", "donor_shard", "recipient_host",
    "predicted_move_bytes", "bytes_source", "donor_rate_per_s",
    "mean_rate_per_s", "imbalance_before", "imbalance_after", "window_s",
    "inputs", "reason",
)

# lineage/advisor locks guard dict/scalar updates only — innermost by
# construction, like heat.shard (note_* hooks fire from under the
# recovery/WAL locks, so these MUST stay leaves)
declare_leaf("placement.lineage")
declare_leaf("placement.advisor")

_M_PLANS = get_registry().counter(
    "wukong_placement_plans_total",
    "Placement-advisor decisions by outcome", labels=("decision",))


@dataclass
class MigrationPlan:
    """The observe-only migration decision artifact (never executed
    here; the migration actuator is its consumer)."""

    plan_id: str
    t_us: int
    donor_shard: int
    recipient_host: int
    predicted_move_bytes: int
    bytes_source: str  # "checkpoint" (measured) | "estimate" (memory_bytes)
    donor_rate_per_s: float
    mean_rate_per_s: float
    imbalance_before: float
    imbalance_after: float
    window_s: float
    inputs: dict = field(default_factory=dict)
    reason: str = ""

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


class _ShardRecord:
    __slots__ = ("primary_host", "replica_hosts", "rotation_hosts",
                 "store_version", "last_failover_us", "failover_host",
                 "last_heal_us", "heal_source", "checkpoint_bytes",
                 "checkpoint_t_us")

    def __init__(self):
        self.primary_host = None
        self.replica_hosts: tuple = ()
        # hosts whose demoted donor copies still serve rotated reads
        # after a migration (runtime/migration.py; follow-up j)
        self.rotation_hosts: tuple = ()
        self.store_version = 0
        self.last_failover_us = 0
        self.failover_host = None  # the replica host serving the shard
        self.last_heal_us = 0
        self.heal_source = ""  # "replica" | "checkpoint" — how it healed
        self.checkpoint_bytes = 0
        self.checkpoint_t_us = 0


class ShardLineage:
    """Process-wide per-shard placement ledger."""

    def __init__(self):
        self._lock = make_lock("placement.lineage")
        self._shards: dict[int, _ShardRecord] = {}  # guarded by: _lock

    def _rec(self, shard: int) -> _ShardRecord:  # caller holds: _lock
        r = self._shards.get(int(shard))
        if r is None:
            r = self._shards[int(shard)] = _ShardRecord()
        return r

    # -- producers ------------------------------------------------------
    def note_placement(self, shard: int, primary_host: int,
                       replica_hosts=(), store_version: int = 0,
                       rotation_hosts=()) -> None:
        with self._lock:
            r = self._rec(shard)
            r.primary_host = int(primary_host)
            r.replica_hosts = tuple(int(h) for h in replica_hosts)
            r.rotation_hosts = tuple(int(h) for h in rotation_hosts)
            r.store_version = int(store_version)

    def note_failover(self, shard: int, replica_host: int) -> None:
        with self._lock:
            r = self._rec(shard)
            r.last_failover_us = get_usec()
            r.failover_host = int(replica_host)

    def note_heal(self, shard: int, source: str = "replica") -> None:
        with self._lock:
            r = self._rec(shard)
            r.last_heal_us = get_usec()
            r.heal_source = str(source)

    def note_checkpoint(self, shard: int, nbytes: int) -> None:
        """One checkpointed partition's measured on-disk bytes — the
        advisor's predicted-move-bytes source (recovery.checkpoint)."""
        with self._lock:
            r = self._rec(shard)
            r.checkpoint_bytes = int(nbytes)
            r.checkpoint_t_us = get_usec()

    # -- readers --------------------------------------------------------
    def observe_store(self, sstore) -> None:
        """Fold a sharded store's CURRENT placement (the migration-aware
        ``placement`` map when present, identity otherwise; replicas =
        successor hosts; rotation = demoted donor copies still serving
        reads) and per-shard store versions into the ledger — called
        before advising so the plan reads live topology, not a stale
        note."""
        if sstore is None:
            return
        replicas = dict(getattr(sstore, "replicas", {}) or {})
        placement = dict(getattr(sstore, "placement", {}) or {})
        rotation = dict(getattr(sstore, "rotation", {}) or {})
        for i, g in enumerate(sstore.stores):
            self.note_placement(
                i, placement.get(i, i),
                tuple(h for (h, _g) in replicas.get(i, ())),
                getattr(g, "version", 0),
                rotation_hosts=tuple(h for (h, _g) in rotation.get(i, ())))

    def checkpoint_bytes(self, shard: int) -> int:
        with self._lock:
            r = self._shards.get(int(shard))
            return r.checkpoint_bytes if r is not None else 0

    def hosts_of(self, shard: int) -> tuple:
        """(primary host, replica hosts) — hosts a migration must avoid
        as recipients (they already hold the shard's data)."""
        with self._lock:
            r = self._shards.get(int(shard))
            if r is None:
                return None, ()
            return r.primary_host, r.replica_hosts

    def serving_hosts_of(self, shard: int) -> tuple:
        """Every host currently SERVING reads for the shard: the primary
        plus any read-rotation copies. The advisor splits the shard's load
        rate across exactly this set — imbalance must reflect who actually
        answers the fetches."""
        with self._lock:
            r = self._shards.get(int(shard))
            if r is None or r.primary_host is None:
                return ()
            return (r.primary_host, *r.rotation_hosts)

    def report(self) -> dict:
        with self._lock:
            snap = {s: (r.primary_host, r.replica_hosts, r.rotation_hosts,
                        r.store_version, r.last_failover_us,
                        r.failover_host, r.last_heal_us, r.heal_source,
                        r.checkpoint_bytes)
                    for s, r in self._shards.items()}
        return {s: {"primary_host": p, "replica_hosts": list(reps),
                    "rotation_hosts": list(rots),
                    "store_version": v, "last_failover_us": fo,
                    "failover_host": fh, "last_heal_us": heal,
                    "heal_source": hs, "checkpoint_bytes": cb}
                for s, (p, reps, rots, v, fo, fh, heal, hs, cb)
                in sorted(snap.items())}

    def reset(self) -> None:
        with self._lock:
            self._shards.clear()


class PlacementAdvisor:
    """Observe-only placement loop: trend-windowed heat in, literal
    MigrationPlan out, store never touched."""

    def __init__(self, sstore=None, tsdb=None, lineage=None):
        self._sstore_ref = None  # lock-free: rebound atomically; sweeps deref once
        if sstore is not None:
            self.attach_store(sstore)
        self._tsdb = tsdb
        self._lineage = lineage
        self._lock = make_lock("placement.advisor")
        self._last_plan: MigrationPlan | None = None  # guarded by: _lock
        self._last_imbalance = 0.0  # guarded by: _lock
        self._last_decision = "no_data"  # guarded by: _lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None  # lock-free: start/stop are operator-thread only

    # ------------------------------------------------------------------
    def attach_store(self, sstore) -> None:
        # weakref: the advisor is process-global — a strong capture would
        # pin a retired world's partitions in memory and keep /plan
        # advising on its dead topology (the healthz-probe posture,
        # proxy.py). Whoever serves the store keeps it alive.
        self._sstore_ref = weakref.ref(sstore)

    def _store(self):
        """The attached sharded store, or None once its world retired."""
        ref = self._sstore_ref
        return ref() if ref is not None else None

    def tsdb(self):
        return self._tsdb if self._tsdb is not None else get_tsdb()

    def lineage(self) -> ShardLineage:
        return self._lineage if self._lineage is not None else get_lineage()

    # ------------------------------------------------------------------
    def advise_once(self, window_s: float | None = None
                    ) -> MigrationPlan | None:
        """One advisory sweep. Reads the heat plane's fetch rates through
        the tsdb trend window (PLACEMENT_INPUTS["fetches"]), scores
        max/mean host-load imbalance, and emits a MigrationPlan when it
        clears ``placement_imbalance_x``. Pure observation: no store
        object is written, ever."""
        win = (float(window_s) if window_s is not None
               else max(float(Global.placement_window_s), 1.0))
        lineage = self.lineage()
        ss = self._store()
        lineage.observe_store(ss)
        # the trend read: per-shard fetch rate over the window (summed
        # over the kind label) — PLACEMENT_INPUTS names this metric
        rates_raw = self.tsdb().rate_by_label(
            "wukong_shard_heat_fetches_total", "shard", win)
        rates: dict[int, float] = {}
        for k, v in rates_raw.items():
            try:
                rates[int(k)] = float(v)
            except ValueError:
                continue  # a non-numeric shard label is not placement input
        if ss is not None:
            # score the LIVE topology only: metric label values persist
            # past the stores that minted them (a retired test/world's
            # shard 7 must not read as an idle member of this cluster),
            # and a live shard with zero window fetches IS an idle member
            live = range(len(ss.stores))
            rates = {s: rates.get(s, 0.0) for s in live}
        elif rates:
            # heat labels with NO live store to validate them against:
            # an on-demand sweep (/plan?sweep=1, the console verb) after
            # the world retired must not turn the dead world's residual
            # window rates into a MigrationPlan the control plane would
            # consume — the same hazard maybe_start_advisor refuses to
            # loop on. No samples at all stays "no_data" below.
            with self._lock:
                self._last_decision = "no_store"
                self._last_imbalance = 0.0
            _M_PLANS.labels(decision="no_store").inc()
            return None
        # the host aggregation reads the lineage leaf lock — computed
        # BEFORE taking the advisor leaf (leaves never nest)
        decision, imb_now, plan = self._decide(rates, win, lineage)
        with self._lock:
            self._last_decision = decision
            self._last_imbalance = imb_now
            if plan is not None:
                self._last_plan = plan
        _M_PLANS.labels(decision=decision).inc()
        if plan is not None:
            log_info(
                f"placement advisor: plan {plan.plan_id} — donor shard "
                f"{plan.donor_shard} -> host {plan.recipient_host}, "
                f"~{plan.predicted_move_bytes / 2**20:.1f} MiB "
                f"({plan.bytes_source}), imbalance "
                f"{plan.imbalance_before:.2f} -> {plan.imbalance_after:.2f}"
                f" over {plan.window_s:.0f}s")
        return plan

    @staticmethod
    def _imbalance(loads: dict[int, float]) -> float:
        vals = [v for v in loads.values() if v >= 0]
        if not vals or sum(vals) <= 0:
            return 0.0
        mean = sum(vals) / len(vals)
        return max(vals) / mean if mean > 0 else 0.0

    @staticmethod
    def _serving_map(rates: dict[int, float],
                     lineage: "ShardLineage") -> dict[int, tuple]:
        """shard -> the hosts serving its reads (primary + rotation
        copies; identity fallback). The load split the migration actuator
        makes real (replica-read rotation) is scored the same way it is
        served: a shard's rate divides evenly across this set."""
        m: dict[int, tuple] = {}
        for s in rates:
            hs = lineage.serving_hosts_of(s)
            m[s] = hs if hs else (s,)
        return m

    def _decide(self, rates: dict[int, float], win: float,
                lineage: ShardLineage):
        """(decision label, current imbalance, plan | None). Caller holds
        no locks. Imbalance is scored over HOST loads everywhere
        (trigger, before, after): with identity placement that equals the
        per-shard view, and once the control plane co-locates or rotates
        shards the overloaded HOST is what must read as imbalanced."""
        serving = self._serving_map(rates, lineage)
        hosts: dict[int, float] = {}
        for s, r in rates.items():
            for h in serving[s]:
                hosts[h] = hosts.get(h, 0.0) + r / len(serving[s])
        imb = self._imbalance(hosts)
        if len(rates) < 2 or sum(rates.values()) <= 0:
            return "no_data", imb, None
        threshold = max(float(Global.placement_imbalance_x), 1.0)
        if imb < threshold:
            return "balanced", imb, None
        # donor = the hottest shard SERVED BY the overloaded host — the
        # global max-rate shard can sit on a healthy host once placement
        # is no longer identity, and moving it would not relieve the
        # trigger
        hot_host = max(sorted(hosts), key=lambda h: hosts[h])
        on_hot = [s for s in rates if hot_host in serving[s]]
        donor = max(sorted(on_hot), key=lambda s: rates[s])
        donor_host = hot_host
        _primary, replicas = lineage.hosts_of(donor)
        excluded = {donor_host, *serving[donor], *replicas}
        candidates = {h: v for h, v in hosts.items() if h not in excluded}
        if not candidates:
            return "no_recipient", imb, None
        recipient = min(sorted(candidates), key=lambda h: candidates[h])
        # predicted post-move balance: donor reads split across its
        # current serving set PLUS the recipient (replica-read rotation —
        # what the migration actuator's cutover+rotate executes)
        after = dict(hosts)
        k = len(serving[donor])
        shed = rates[donor] / k - rates[donor] / (k + 1)
        for h in serving[donor]:
            after[h] -= shed
        after[recipient] = after.get(recipient, 0.0) + rates[donor] / (k + 1)
        imb_after = self._imbalance(after)
        if imb_after >= imb:
            # a plan that does not move the needle is not a plan — the
            # control plane must never act on a no-op artifact
            return "no_improvement", imb, None
        nbytes = lineage.checkpoint_bytes(donor)
        source = "checkpoint"
        if nbytes <= 0:
            source = "estimate"
            nbytes = self._estimate_bytes(donor)
        mean = sum(rates.values()) / len(rates)
        plan = MigrationPlan(
            plan_id=f"mp{get_usec():016d}",
            t_us=get_usec(),
            donor_shard=int(donor),
            recipient_host=int(recipient),
            predicted_move_bytes=int(nbytes),
            bytes_source=source,
            donor_rate_per_s=round(rates[donor], 3),
            mean_rate_per_s=round(mean, 3),
            imbalance_before=round(imb, 3),
            imbalance_after=round(imb_after, 3),
            window_s=round(win, 3),
            inputs={"fetch_rates_per_s":
                    {str(s): round(r, 3) for s, r in sorted(rates.items())},
                    "metric": "wukong_shard_heat_fetches_total"},
            reason=(f"imbalance {imb:.2f} >= placement_imbalance_x "
                    f"{threshold:g} over {win:.0f}s"),
        )
        return "planned", imb, plan

    def _estimate_bytes(self, shard: int) -> int:
        """Fallback predicted-move bytes when no checkpoint measured the
        shard yet: the live partition's host-array footprint (the npz
        checkpoint stores the same arrays uncompressed, so the two agree
        within zip framing)."""
        ss = self._store()
        if ss is None:
            return 0
        try:
            g = ss.stores[int(shard)]
        except (IndexError, TypeError):
            return 0
        mb = getattr(g, "memory_bytes", None)
        return int(mb()) if callable(mb) else 0

    # ------------------------------------------------------------------
    def last_plan(self) -> MigrationPlan | None:
        with self._lock:
            return self._last_plan

    def status(self) -> dict:
        with self._lock:
            return {"decision": self._last_decision,
                    "imbalance": round(self._last_imbalance, 3),
                    "plan": (self._last_plan.to_dict()
                             if self._last_plan is not None else None)}

    def reset(self) -> None:
        self._sstore_ref = None
        with self._lock:
            self._last_plan = None
            self._last_imbalance = 0.0
            self._last_decision = "no_data"

    # -- the optional advisory loop -------------------------------------
    def start(self) -> "PlacementAdvisor":
        """Launch the background advisory loop (``placement_interval_s``
        seconds per sweep; observe-only, so the loop is always safe).
        Idempotent; the thread is a daemon."""
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="placement-advisor")
        self._thread.start()
        return self

    def _run(self) -> None:
        me = threading.current_thread()
        while not self._stop.wait(max(float(Global.placement_interval_s
                                            or 1), 1.0)):
            if self._thread is not me:
                return  # superseded: a sweep overran stop()'s join
            if Global.placement_interval_s <= 0:
                continue  # knob flipped off at runtime: idle
            try:
                self.advise_once()
            except Exception as e:  # the advisor must never die silently
                log_warn(f"placement advisor sweep failed: {e!r}")

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        # clear BEFORE the fresh Event below: a sweep that outlives the
        # bounded join would otherwise read the new (unset) event and keep
        # sweeping forever; _run exits once it is no longer self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=2)
        self._stop = threading.Event()


# process-wide instances (sharded store, recovery, /plan, Monitor share them)
_lineage = ShardLineage()
_advisor = PlacementAdvisor()
# checked mode (lockdep.install) rebuilds the process-wide ledgers' locks
register_global_lock(_lineage, "_lock", "placement.lineage")
register_global_lock(_advisor, "_lock", "placement.advisor")


def get_lineage() -> ShardLineage:
    return _lineage


def get_advisor() -> PlacementAdvisor:
    return _advisor


def _imbalance_gauge() -> float:
    with _advisor._lock:
        return _advisor._last_imbalance


def _plan_bytes_gauge() -> float:
    with _advisor._lock:
        p = _advisor._last_plan
        return float(p.predicted_move_bytes) if p is not None else 0.0


get_registry().gauge(
    "wukong_placement_imbalance",
    "Max/mean host load-rate ratio at the advisor's last sweep"
).set_function(_imbalance_gauge)
get_registry().gauge(
    "wukong_placement_plan_bytes",
    "Predicted bytes to move for the advisor's last MigrationPlan"
).set_function(_plan_bytes_gauge)


def maybe_start_advisor(sstore=None) -> "PlacementAdvisor | None":
    """Attach the sharded store and start the advisory loop when
    ``placement_interval_s`` asks for one (0 = on-demand only). The
    store attach happens either way so ``/plan`` can advise on demand.
    Without a live attached store there is nothing to advise on (a
    single-host proxy, or a config reload after its world retired), so
    no loop is started — sweeping raw heat labels would score shards of
    whatever world last minted them."""
    if sstore is not None:
        _advisor.attach_store(sstore)
    if Global.placement_interval_s <= 0:
        return None
    if _advisor._store() is None:
        return None
    return _advisor.start()


# ---------------------------------------------------------------------------
# the /plan report (endpoint + console verb + Monitor line)
# ---------------------------------------------------------------------------

def render_plan(advise: bool = True) -> tuple[str, dict]:
    """(plain text, JSON) for the /plan endpoint and the ``plan`` console
    verb. ``advise`` runs one fresh sweep first (observe-only, so always
    safe); the body is the advisor status + the last MigrationPlan."""
    if advise:
        try:
            _advisor.advise_once()
        except Exception as e:
            log_warn(f"placement advise failed: {e!r}")
    st = _advisor.status()
    # the actuator's in-flight state rides the same surface (lazy import:
    # runtime/migration.py imports this module at its top level)
    from wukong_tpu_torch.runtime.migration import get_migrator

    mig = get_migrator().status()
    js = {"status": st, "lineage": get_lineage().report(),
          "inputs": dict(PLACEMENT_INPUTS), "migration": mig}
    lines = ["wukong-plan  (placement advisor"
             + (" + migration actuator)" if mig and mig["enabled"]
                else ", observe-only)"), ""]
    lines.append(f"decision {st['decision']}  imbalance "
                 f"{st['imbalance']:.2f} (threshold "
                 f"{max(float(Global.placement_imbalance_x), 1.0):g}, "
                 f"window {Global.placement_window_s}s)")
    if mig is not None:
        j = mig["job"] if mig["in_flight"] else None
        if j is not None:
            lines.append(
                f"migration IN FLIGHT: {j['plan_id']} shard "
                f"{j['donor_shard']} -> host {j['recipient_host']}, "
                f"phase {j['phase']}, {j['bytes_moved']:,} bytes moved, "
                f"{j['replayed']} WAL records caught up")
        elif mig["last"] is not None:
            j = mig["last"]
            lines.append(
                f"last migration: {j['plan_id']} shard "
                f"{j['donor_shard']} -> host {j['recipient_host']} "
                f"({j['phase']}"
                + (f": {j['abort_cause']}" if j["abort_cause"] else "")
                + f", {j['bytes_moved']:,} bytes, cutover pause "
                f"{j['cutover_pause_us']}us)")
    p = st["plan"]
    if p is None:
        lines.append("  (no MigrationPlan emitted — imbalance under "
                     "threshold, or no trend samples yet)")
    else:
        lines.append("")
        lines.append(f"plan {p['plan_id']}:")
        lines.append(f"  donor shard       {p['donor_shard']} "
                     f"({p['donor_rate_per_s']:,.2f} fetch/s vs mean "
                     f"{p['mean_rate_per_s']:,.2f})")
        lines.append(f"  recipient host    {p['recipient_host']}")
        lines.append(f"  predicted move    "
                     f"{p['predicted_move_bytes']:,} bytes "
                     f"({p['bytes_source']})")
        lines.append(f"  balance           {p['imbalance_before']:.2f} -> "
                     f"{p['imbalance_after']:.2f} (donor reads split to "
                     "recipient)")
        lines.append(f"  reason            {p['reason']}")
    lin = js["lineage"]
    if lin:
        lines.append("")
        lines.append(f"{'shard':>5} {'host':>4} {'replicas':<10} "
                     f"{'version':>7} {'ckpt_bytes':>12} {'failover':>9} "
                     f"{'heal':>9}")
        for s, r in lin.items():
            lines.append(
                f"{s:>5} {('-' if r['primary_host'] is None else r['primary_host']):>4} "
                f"{str(r['replica_hosts']):<10.10} {r['store_version']:>7} "
                f"{r['checkpoint_bytes']:>12,} "
                f"{'yes' if r['last_failover_us'] else '-':>9} "
                f"{'yes' if r['last_heal_us'] else '-':>9}")
    return "\n".join(lines) + "\n", js
