"""Deterministic fault injection for the chaos tests.

The port's copy of the JAX package's runtime/faults.py. The execution stack
exposes named fault sites (``faults.site("pool.execute", shard=3)``) at its
failure points; a :class:`FaultPlan` installed for the process decides, from
a seeded RNG, whether each site call is delayed, fails transiently, or hits
a persistently-down shard. The same seed and specs replay the same failure
schedule in both packages, so chaos tests are ordinary deterministic tests.

A plan is installed from code (tests) or by the ``WUKONG_FAULT_PLAN``
environment variable (chaos runs of the console):

    WUKONG_FAULT_PLAN="seed=42;pool.execute:transient,p=0.3,count=2"
    WUKONG_FAULT_PLAN="proxy.serve:delay,delay=0.05"

The port's sites (``KNOWN_FAULT_SITES``):
- ``pool.execute`` — per-query execution in runtime/scheduler.py
  (``shard`` = the engine's thread id);
- ``proxy.serve`` — the serving-boundary dispatch in runtime/proxy.py,
  before any engine runs: an injected failure reaches the caller;
- ``batch.heavy.dispatch`` — one slice dispatch of a fused heavy group in
  runtime/batcher.py (a failed slice is re-run once on the gather thread);
- ``join.materialize`` — a sorted edge table or index list built for the
  WCOJ executor (join/wcoj.py), before the query is touched: the proxy
  degrades the query to the walk;
- ``template.compile`` / ``template.dispatch`` — staging and running a
  compiled template program (engine/template_compile.py): the proxy
  latches the template's demotion and walks;
- ``hdfs.read`` — one HDFS client invocation (loader/hdfs.py), retried
  with backoff;
- ``dynamic.insert`` — a batch insert into one partition
  (store/dynamic.py), before the store mutates (``shard`` = its sid);
- ``wal.append`` — a write-ahead-log append (store/wal.py), before any
  byte lands: the batch is neither logged nor applied;
- ``checkpoint.write`` — a checkpoint bundle (runtime/recovery.py), before
  any byte lands;
- ``vector.upsert`` — a vector batch (vector/vstore.py
  ``upsert_batch_into``), before the WAL append: the WAL and every vector
  store stay untouched, and a retry commits.

A plan may name sites of the JAX package the port does not have yet; they
never fire. When no plan is installed every hook is a cheap no-op. Each
firing is a ``fault.injected`` event on the ambient trace and counts
``wukong_faults_injected_total{site,kind}``.
"""

from __future__ import annotations

import hashlib
import os
import random
import threading
import time
from dataclasses import dataclass, field

KNOWN_FAULT_SITES = frozenset({"pool.execute", "proxy.serve",
                               "batch.heavy.dispatch", "join.materialize",
                               "template.compile", "template.dispatch",
                               "hdfs.read", "dynamic.insert", "wal.append",
                               "checkpoint.write", "vector.upsert"})


class TransientFault(Exception):
    """An injected transient infrastructure failure (retryable)."""


class ShardDown(Exception):
    """An injected persistent shard failure (not retryable)."""

    def __init__(self, site: str, shard: int | None):
        self.site = site
        self.shard = shard
        super().__init__(f"injected shard-down at {site} (shard={shard})")


#: what an installed plan raises at a site: the degrading paths (a wcoj
#: join to the walk, a compiled template to the walk) catch these by name
INJECTED = (TransientFault, ShardDown)


@dataclass
class FaultSpec:
    """One injection rule. kind: 'delay' | 'transient' | 'shard_down'."""

    site: str
    kind: str
    p: float = 1.0  # per-call firing probability (seeded RNG)
    count: int | None = None  # max times this spec fires (None = unlimited)
    after: int = 0  # skip the first N matching calls
    delay_s: float = 0.0  # 'delay' kind: how long to sleep
    shard: int | None = None  # restrict to one shard (None = any)
    fired: int = field(default=0, compare=False)
    seen: int = field(default=0, compare=False)


class FaultPlan:
    """Seeded, replayable schedule of injected faults.

    Each spec draws from its own RNG stream (derived from the plan seed, the
    site name and the spec index), so whether one site fires never perturbs
    another site's schedule: the same seed gives the same failure schedule
    under reordered calls across sites.
    """

    def __init__(self, specs: list[FaultSpec] | None = None, seed: int = 0,
                 sleep=time.sleep):
        self.seed = int(seed)
        self.specs = list(specs or [])
        self.sleep = sleep
        self.history: list[tuple[str, int | None, str]] = []
        self._rngs: dict[int, random.Random] = {}
        # serving threads hit one site at once: the counts and draws are
        # taken under this lock, so a spec with count=N fires N times
        self._lock = threading.Lock()

    def _rng(self, idx: int) -> random.Random:
        if idx not in self._rngs:
            h = hashlib.sha256(
                f"{self.seed}:{self.specs[idx].site}:{idx}".encode()).digest()
            self._rngs[idx] = random.Random(int.from_bytes(h[:8], "big"))
        return self._rngs[idx]

    def fire(self, site: str, shard: int | None = None) -> None:
        """Apply every matching spec to one site call. Raises TransientFault /
        ShardDown or sleeps, per the seeded schedule."""
        for idx, sp in enumerate(self.specs):
            if sp.site != site:
                continue
            if sp.shard is not None and shard is not None and sp.shard != shard:
                continue
            with self._lock:
                sp.seen += 1
                if sp.seen <= sp.after:
                    continue
                if sp.count is not None and sp.fired >= sp.count:
                    continue
                # draw even when p == 1 so trimming p later replays the
                # same underlying stream
                if self._rng(idx).random() >= sp.p:
                    continue
                sp.fired += 1
                self.history.append((site, shard, sp.kind))
            # an injected fault lands on the ambient trace and the metrics
            # registry, so a chaos run's trace explains itself
            from wukong_tpu_torch.obs.metrics import get_registry
            from wukong_tpu_torch.obs.trace import trace_event

            trace_event("fault.injected", site=site, kind=sp.kind,
                        shard=shard)
            get_registry().counter(
                "wukong_faults_injected_total", "Injected fault firings",
                labels=("site", "kind")).labels(site=site,
                                                kind=sp.kind).inc()
            if sp.kind == "delay":
                self.sleep(sp.delay_s)
            elif sp.kind == "transient":
                raise TransientFault(f"injected transient at {site}"
                                     f" (shard={shard})")
            elif sp.kind == "shard_down":
                raise ShardDown(site, shard)
            else:
                raise ValueError(f"unknown fault kind: {sp.kind}")


def parse_plan(text: str, sleep=time.sleep) -> FaultPlan:
    """Parse the compact ``WUKONG_FAULT_PLAN`` form: ';'-separated entries,
    optionally starting with ``seed=N``; each entry is
    ``<site>:<kind>[,k=v...]`` with keys p/count/after/delay/shard."""
    seed = 0
    specs: list[FaultSpec] = []
    for ent in text.split(";"):
        ent = ent.strip()
        if not ent:
            continue
        if ent.startswith("seed="):
            seed = int(ent[5:])
            continue
        site, _, rest = ent.partition(":")
        parts = rest.split(",")
        kind = parts[0].strip()
        if kind not in ("delay", "transient", "shard_down"):
            # a bad kind is a config error at startup, not a ValueError
            # mid-query from FaultPlan.fire
            raise ValueError(f"unknown fault kind: {kind!r} in {ent!r} "
                             "(expected delay|transient|shard_down)")
        kw: dict = {}
        for p in parts[1:]:
            k, _, v = p.partition("=")
            k = k.strip()
            if k == "p":
                kw["p"] = float(v)
            elif k == "count":
                kw["count"] = int(v)
            elif k == "after":
                kw["after"] = int(v)
            elif k == "delay":
                kw["delay_s"] = float(v)
            elif k == "shard":
                kw["shard"] = int(v)
            else:
                raise ValueError(f"unknown fault-plan key: {k}")
        specs.append(FaultSpec(site=site.strip(), kind=kind, **kw))
    return FaultPlan(specs, seed=seed, sleep=sleep)


# ---------------------------------------------------------------------------
# process-wide installation
# ---------------------------------------------------------------------------

_state: dict = {"plan": None, "env_checked": False}


def install(plan: FaultPlan | None) -> None:
    _state["plan"] = plan
    _state["env_checked"] = True  # explicit install overrides the env var


def clear() -> None:
    _state["plan"] = None
    _state["env_checked"] = True


def active() -> FaultPlan | None:
    if not _state["env_checked"]:
        _state["env_checked"] = True
        text = os.environ.get("WUKONG_FAULT_PLAN")
        if text:
            _state["plan"] = parse_plan(text)
    return _state["plan"]


def site(name: str, shard: int | None = None) -> None:
    """Fault hook: no-op unless a plan is installed."""
    plan = active()
    if plan is not None:
        plan.fire(name, shard)
