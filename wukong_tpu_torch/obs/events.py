"""Structured cluster-event journal: one correlated lifecycle timeline.

The port's copy of the JAX package's obs/events.py. :class:`EventJournal`
is a bounded in-memory ring (``events_ring`` deep, optional JSONL mirror at
``events_log_path``) of :class:`ClusterEvent` records, each with an ordered
id and the correlation keys ``shard`` / ``tenant`` / ``qid``, so a failure
timeline reads as a sequence.

The port's emitters (each one knob check when ``enable_events`` is off):

- resilience — ``breaker.trip`` / ``breaker.close``
- slo — ``slo.burn`` (the burn sentinel)
- profile — ``latency.regression`` (the regression sentinel)
- recorder — ``trace.dump`` (auto-dumps that no other event triggered)
- admission — ``admission.shed`` / ``admission.quota``

``EVENT_KINDS`` keeps the JAX package's full list: the kinds of the
subsystems the port does not have yet (shards, recovery, the WAL, caches,
migration, the device observatory) are emitted once they are ported.
FlightRecorder dumps reference the triggering event id (``SLO_BURN`` dumps
carry their ``slo.burn`` event's id), so a dump and its journal entry
cross-link. Read back by the ``events`` console verb and the Monitor's
``Events[...]`` line.
"""

from __future__ import annotations

import itertools
import json
from collections import deque

from wukong_tpu_torch.analysis.lockdep import (
    declare_leaf,
    make_lock,
    register_global_lock,
)
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.utils.logger import log_warn
from wukong_tpu_torch.utils.timer import get_usec

#: the event kinds the journal's emitters produce (documentation + the
#: ``events`` report's ordering hint; emit() accepts any kind string)
EVENT_KINDS = (
    "breaker.trip", "breaker.close", "shard.failover", "shard.degraded",
    "shard.rebuild", "shard.heal", "checkpoint.write", "recovery.restore",
    "recovery.replay", "wal.rotate", "wal.torn_tail", "slo.burn",
    "latency.regression", "trace.dump",
    # serving-cache observatory (obs/reuse.py): one event per
    # store-mutation version edge, carrying the edge + shadow-key kills
    "cache.invalidate",
    # the shard-migration actuator's phase transitions
    # (runtime/migration.py; correlate with -K shard.migrate)
    "shard.migrate.start", "shard.migrate.catchup",
    "shard.migrate.cutover", "shard.migrate.retire", "shard.migrate.abort",
    # the admission control plane (runtime/admission.py): degrade-ladder
    # sheds and per-tenant quota breaches (correlate with -K admission —
    # shed storms, burn alerts, and breaker trips on one timeline)
    "admission.shed", "admission.quota",
    # the device-cost observatory's variant-storm sentinel (the JAX
    # package's obs/device.py): a dispatch site minted too many compiled
    # variants inside one window
    "device.variant_storm",
)

# the journal lock guards a deque append and the JSONL file handle —
# innermost by construction (emitters fire from under tracked subsystem
# locks, so this MUST stay a leaf; file I/O under it mirrors wal.segment)
declare_leaf("events.ring")

_M_EVENTS = get_registry().counter(
    "wukong_cluster_events_total", "Cluster lifecycle events journaled",
    labels=("kind",))


class ClusterEvent:
    """One journaled lifecycle event (immutable once emitted)."""

    __slots__ = ("seq", "t_us", "kind", "shard", "tenant", "qid", "attrs")

    def __init__(self, seq: int, t_us: int, kind: str, shard, tenant, qid,
                 attrs: dict):
        self.seq = seq
        self.t_us = t_us
        self.kind = kind
        self.shard = shard
        self.tenant = tenant
        self.qid = qid
        self.attrs = attrs

    @property
    def event_id(self) -> str:
        return f"ev{self.seq:08d}"

    def to_dict(self) -> dict:
        return {"event_id": self.event_id, "seq": self.seq,
                "t_us": self.t_us, "kind": self.kind,
                **({"shard": self.shard} if self.shard is not None else {}),
                **({"tenant": self.tenant} if self.tenant is not None
                   else {}),
                **({"qid": self.qid} if self.qid is not None else {}),
                "attrs": dict(self.attrs)}


class EventJournal:
    """Bounded ring of ClusterEvents + optional JSONL file mirror."""

    def __init__(self, capacity: int | None = None,
                 log_path: str | None = None):
        self._capacity = capacity
        self._log_path_override = log_path
        self._lock = make_lock("events.ring")
        self._ring: deque[ClusterEvent] = deque(  # guarded by: _lock
            maxlen=capacity or max(int(Global.events_ring), 16))
        self._seq = itertools.count(1)  # guarded by: _lock
        self._fh = None  # guarded by: _lock
        self._fh_path = None  # guarded by: _lock

    # ------------------------------------------------------------------
    def emit(self, kind: str, shard=None, tenant=None, qid=None,
             **attrs) -> str:
        """Journal one event; returns its event id. ``shard``/``tenant``/
        ``qid`` are the correlation keys every consumer may filter on."""
        want = self._capacity or max(int(Global.events_ring), 16)
        path = (self._log_path_override
                if self._log_path_override is not None
                else Global.events_log_path)
        with self._lock:
            # seq + timestamp minted INSIDE the critical section: minted
            # outside, two racing emitters could append (and mirror) out
            # of seq order, breaking the tail-reads-chronologically
            # contract the journal exists to preserve
            ev = ClusterEvent(next(self._seq), get_usec(), str(kind),
                              None if shard is None else int(shard),
                              None if tenant is None else str(tenant),
                              None if qid is None else int(qid),
                              attrs)
            if self._ring.maxlen != want:
                # events_ring is runtime-mutable; resize lazily keeping
                # the tail (one critical section, the recorder's pattern)
                self._ring = deque(self._ring, maxlen=want)
            self._ring.append(ev)
            if path:
                line = json.dumps(ev.to_dict(), sort_keys=True, default=str)
                try:
                    if self._fh is None or self._fh_path != path:
                        if self._fh is not None:
                            self._fh.close()
                        self._fh = open(path, "a")
                        self._fh_path = path
                    self._fh.write(line + "\n")
                    self._fh.flush()
                except OSError as e:  # a full disk must not fail the emitter
                    fh, self._fh, self._fh_path = self._fh, None, None
                    try:
                        if fh is not None:
                            fh.close()
                    except OSError:
                        pass  # the fd must not outlive the drop either way
                    log_warn(f"event journal: JSONL write failed: {e}")
        _M_EVENTS.labels(kind=ev.kind).inc()
        return ev.event_id

    # ------------------------------------------------------------------
    def last(self, n: int | None = None, kind: str | None = None,
             shard: int | None = None) -> list[ClusterEvent]:
        """Newest-last view of the ring, optionally filtered by kind
        and/or correlation shard. The kind filter matches exactly OR as a
        run of dotted segments — ``shard.migrate`` (or just ``migrate``)
        selects every ``shard.migrate.*`` phase event as one timeline."""
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            needle = f".{kind}."
            evs = [e for e in evs if f".{e.kind}.".find(needle) >= 0]
        if shard is not None:
            evs = [e for e in evs if e.shard == int(shard)]
        return evs if n is None else evs[-n:]

    def find(self, event_id: str) -> ClusterEvent | None:
        with self._lock:
            evs = list(self._ring)
        for e in reversed(evs):
            if e.event_id == event_id:
                return e
        return None

    def counts(self) -> dict[str, int]:
        """{kind: count} over the current ring."""
        with self._lock:
            evs = list(self._ring)
        out: dict[str, int] = {}
        for e in evs:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
                self._fh_path = None


# process-wide journal (every emitter and the ``events`` verb share it)
_journal = EventJournal()
# checked mode (lockdep.install) rebuilds the process-wide ledgers' locks
register_global_lock(_journal, "_lock", "events.ring")


def get_journal() -> EventJournal:
    return _journal


def emit_event(kind: str, shard=None, tenant=None, qid=None,
               **attrs) -> str | None:
    """THE emitter hook subsystems call: one knob check when the journal
    is off (returns None — callers treat the id as optional)."""
    if not Global.enable_events:
        return None
    return _journal.emit(kind, shard=shard, tenant=tenant, qid=qid, **attrs)


# ---------------------------------------------------------------------------
# the events report (console verb + Monitor line)
# ---------------------------------------------------------------------------

def render_events(k: int | None = None, shard: int | None = None,
                  kind: str | None = None) -> tuple[str, dict]:
    """(plain-text table, JSON dict) for the
    ``events`` console verb: kind counts on top, the newest events below
    (newest last, so the tail reads chronologically)."""
    kk = k if k is not None else max(int(Global.top_k), 1) * 4
    evs = _journal.last(kk, kind=kind, shard=shard)
    if kind is None and shard is None:
        counts = _journal.counts()
    else:
        # a filtered view reports ITS OWN size — global counts next to a
        # filtered events list would misstate what the reader is holding
        counts = {}
        for e in _journal.last(kind=kind, shard=shard):
            counts[e.kind] = counts.get(e.kind, 0) + 1
    js = {"counts": counts, "total": sum(counts.values()),
          "events": [e.to_dict() for e in evs]}
    lines = ["wukong-events  (cluster lifecycle journal)", ""]
    if counts:
        lines.append("  ".join(f"{kd}:{n}" for kd, n in sorted(
            counts.items())))
    else:
        lines.append("  (no events journaled — enable_events on?)")
    lines.append("")
    lines.append(f"{'event':<12} {'t_us':>16} {'kind':<20} {'shard':>5} "
                 f"{'tenant':<10} {'qid':>6}  attrs")
    for e in evs:
        attrs = " ".join(f"{k2}={v}" for k2, v in sorted(e.attrs.items()))
        lines.append(
            f"{e.event_id:<12} {e.t_us:>16,} {e.kind:<20.20} "
            f"{'-' if e.shard is None else e.shard:>5} "
            f"{(e.tenant or '-'):<10.10} "
            f"{'-' if e.qid is None else e.qid:>6}  {attrs[:60]}")
    return "\n".join(lines) + "\n", js
