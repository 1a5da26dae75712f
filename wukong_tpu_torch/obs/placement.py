"""Shard lineage + the observe-only placement advisor.

The port's copy of the JAX package's obs/placement.py, less what needs a
sharded store. Two pieces:

- :class:`ShardLineage` — the per-shard placement ledger: primary host,
  replica hosts, store version, last failover/heal timestamps, and the
  shard's last measured **checkpoint byte size** (``RecoveryManager.
  checkpoint`` records the partition file's on-disk bytes). This is what
  "how much data would a migration move" is answered from.
- :class:`PlacementAdvisor` — **observe-only**: reads the heat plane's
  ``PLACEMENT_INPUTS`` *through the tsdb trend windows* (per-shard fetch
  rates over ``placement_window_s``). The port serves one partition, so
  no store is attached: a sweep over the vector scans' heat reports the
  JAX advisor's ``no_store`` decision, and with no samples ``no_data``.

The JAX advisor's planning half (host imbalance against
``placement_imbalance_x``, the ``MigrationPlan`` artifact and its
``MIGRATION_PLAN_FIELDS`` registry, the loop at ``placement_interval_s``
and ``maybe_start_advisor``) scores a sharded store's live topology and
comes with it (ROADMAP §A 7), as does the migration actuator's status in
:func:`render_plan`, None until ``runtime/migration.py``.

Surfaced as ``GET /plan`` + ``/plan.json``, the ``plan`` console verb,
and the ``wukong_placement_plans_total`` decision counter.
"""

from __future__ import annotations

from wukong_tpu_torch.analysis.lockdep import (
    declare_leaf,
    make_lock,
    register_global_lock,
)
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.heat import PLACEMENT_INPUTS
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.obs.tsdb import get_tsdb
from wukong_tpu_torch.utils.logger import log_warn
from wukong_tpu_torch.utils.timer import get_usec

# lineage/advisor locks guard dict/scalar updates only — innermost by
# construction, like heat.shard (note_* hooks fire from under the
# recovery/WAL locks, so these MUST stay leaves)
declare_leaf("placement.lineage")
declare_leaf("placement.advisor")

_M_PLANS = get_registry().counter(
    "wukong_placement_plans_total",
    "Placement-advisor decisions by outcome", labels=("decision",))


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
    """Observe-only placement sweep without a sharded store: trend-windowed
    heat in, the JAX advisor's store-less decision out. Its planning half
    (host imbalance, donor and recipient, the ``MigrationPlan`` artifact,
    the background loop and their knobs) needs the sharded store's live
    topology and comes with it (ROADMAP §A 7)."""

    def __init__(self, tsdb=None):
        self._tsdb = tsdb
        self._lock = make_lock("placement.advisor")
        self._last_decision = "no_data"  # guarded by: _lock

    def tsdb(self):
        return self._tsdb if self._tsdb is not None else get_tsdb()

    def advise_once(self, window_s: float | None = None) -> None:
        """One sweep. Reads the heat plane's per-shard fetch rates through
        the tsdb trend window (PLACEMENT_INPUTS["fetches"]); any rate is
        heat with no live store to validate it against, so the decision is
        the JAX advisor's ``no_store`` (no samples at all: ``no_data``).
        No plan is ever emitted."""
        win = (float(window_s) if window_s is not None
               else max(float(Global.placement_window_s), 1.0))
        rates = self.tsdb().rate_by_label(
            "wukong_shard_heat_fetches_total", "shard", win)
        decision = ("no_store" if any(map(_is_shard, rates))
                    else "no_data")
        with self._lock:
            self._last_decision = decision
        _M_PLANS.labels(decision=decision).inc()

    def status(self) -> dict:
        with self._lock:
            return {"decision": self._last_decision, "imbalance": 0.0,
                    "plan": None}

    def reset(self) -> None:
        with self._lock:
            self._last_decision = "no_data"


def _is_shard(label: str) -> bool:
    """A numeric shard label (any other is not placement input)."""
    try:
        int(label)
    except ValueError:
        return False
    return True


# process-wide instances (recovery, /plan and the plan verb share them)
_lineage = ShardLineage()
_advisor = PlacementAdvisor()
# checked mode (lockdep.install) rebuilds the process-wide ledgers' locks
register_global_lock(_lineage, "_lock", "placement.lineage")
register_global_lock(_advisor, "_lock", "placement.advisor")


def get_lineage() -> ShardLineage:
    return _lineage


def get_advisor() -> PlacementAdvisor:
    return _advisor


# ---------------------------------------------------------------------------
# the /plan report (endpoint + console verb + Monitor line)
# ---------------------------------------------------------------------------

def render_plan(advise: bool = True) -> tuple[str, dict]:
    """(plain text, JSON) for the /plan endpoint and the ``plan`` console
    verb. ``advise`` runs one fresh sweep first (observe-only, so always
    safe); the body is the advisor status + the shard lineage."""
    if advise:
        try:
            _advisor.advise_once()
        except Exception as e:
            log_warn(f"placement advise failed: {e!r}")
    st = _advisor.status()
    # the JAX surface adds the migration actuator's in-flight state here;
    # the port has no actuator until runtime/migration.py (ROADMAP §A 7),
    # so "migration" is None
    js = {"status": st, "lineage": get_lineage().report(),
          "inputs": dict(PLACEMENT_INPUTS), "migration": None}
    lines = ["wukong-plan  (placement advisor, observe-only)", ""]
    lines.append(f"decision {st['decision']}  imbalance "
                 f"{st['imbalance']:.2f} (window "
                 f"{Global.placement_window_s}s)")
    lines.append("  (no MigrationPlan: planning needs a sharded store)")
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
