"""Recovery manager: crash-consistent checkpoint/restore + shard healing.

- :meth:`RecoveryManager.checkpoint` — write one atomic checkpoint bundle:
  every partition (base + materialized dynamic deltas, versioned +
  checksummed via store/persist.py) under a manifest recording the WAL
  high-water mark; then truncate WAL segments the retained checkpoints
  fully cover.
- :meth:`RecoveryManager.recover` — boot-time restore: load the newest
  valid checkpoint into the existing store objects IN PLACE, then replay
  the WAL tail through the normal mutation path (suppressed re-logging) to
  a byte-identical store. A torn WAL tail (the unacknowledged batch) is
  dropped — exactly the acknowledged-write contract.
- :meth:`RecoveryManager.heal_once` / :meth:`start` — runtime healing: the
  watcher observes ``failover_shards`` / ``degraded_shards`` / tripped
  breakers on the sharded store and rebuilds the failed primary (from its
  replica, else from checkpoint + WAL), then promotes it and closes the
  breaker. Rebuilds ride the engine pool's ``rebuild`` lane when a pool is
  running, so healing soaks idle capacity instead of displacing
  interactive queries. :meth:`start` also runs the periodic checkpointer
  (``checkpoint_interval_s``).

Consistency note: checkpoint serialization and shard rebuilds hold the WAL
*mutation lock* (store/wal.py), so every batch commit is either fully
inside the bundle (seq <= the manifest's ``wal_seq``) or fully after it
(replayed on restore) — never half-captured — and a batch never lands only
in a primary that a rebuild is about to replace. Writes pause for the
window; reads are unaffected.

The port's copy of the JAX package's runtime/recovery.py: the same bundle
layout and manifest (a checkpoint or WAL directory written by either
package recovers in the other), the same ``checkpoint.write`` fault site,
events and metrics. With a stream context (stream/), a bundle also holds
the standing-query registry and the epoch counter (``stream.pkl``,
CRC-checked in the manifest), and the WAL's ``epoch`` records replay
through the context, re-evaluating the standing queries. A restore purges
the result cache and the shadow cache (``notify_mutation`` /
``maybe_note_invalidation``, cause ``restore``). With a sharded store
(``sstore``, parallel/sharded_store.py), the checkpoint holds every shard,
WAL replay reaches the shards' replicas too, and a restore re-clones the
replicas from the restored primaries. A promoted shard drops every staging
of the sharded store, so the next query restages from the healed primary.
"""

from __future__ import annotations

import json
import os
import pickle
import threading
import time
import zlib

from wukong_tpu_torch.analysis.lockdep import make_lock
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.events import emit_event
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.obs.placement import get_lineage
from wukong_tpu_torch.obs.trace import trace_event
from wukong_tpu_torch.store.persist import (
    adopt_gstore,
    checkpoint_part_path,
    load_gstore,
    save_gstore,
)
from wukong_tpu_torch.store.wal import active_wal
from wukong_tpu_torch.utils.errors import (
    CheckpointCorrupt,
    ErrorCode,
    WukongError,
)
from wukong_tpu_torch.utils.logger import log_error, log_info, log_warn

MANIFEST_VERSION = (1, 0)
HEAL_BACKOFF_S = 2.0  # min spacing between rebuild attempts per shard
# checkpoints retained on disk. The WAL is truncated behind the OLDEST
# retained bundle, not the newest — recover() falls back to an older
# bundle when the newest is corrupt, and that fallback is only sound if
# the older bundle's WAL tail still exists.
CKPT_RETAIN = 2

_M_CKPTS = get_registry().counter(
    "wukong_checkpoint_writes_total", "Checkpoints written")
_M_RESTORES = get_registry().counter(
    "wukong_recovery_restores_total", "Checkpoint restores completed")
_M_REPLAYED = get_registry().counter(
    "wukong_recovery_replayed_total", "WAL records re-applied by recovery",
    labels=("kind",))


class RebuildJob:
    """A background rebuild riding the engine pool's ``rebuild`` lane
    (scheduler.py): fire-and-forget like a fused batch — ``run`` does the
    work, ``fail_all`` absorbs pool-death so nothing strands."""

    def __init__(self, fn, label: str = ""):
        self._fn = fn
        self.label = label
        self.done = threading.Event()

    def run(self, _engine) -> None:
        try:
            self._fn()
        finally:
            self.done.set()

    def fail_all(self, exc) -> None:
        log_warn(f"rebuild job {self.label} not executed: {exc!r}")
        self.done.set()


class RecoveryManager:
    """One process's checkpoint and recovery coordinator.

    ``stores`` are the checkpointed partitions (or a zero-arg callable
    returning the current ones); ``stream`` is the StreamContext whose
    registry and epoch ride in each bundle (None: none is written);
    ``sstore`` is the sharded store watched for failed shards, whose
    replicas mirror the primaries; ``pool`` is a zero-arg callable
    returning the engine pool (or None) for background rebuilds;
    ``on_change`` runs after any restore or rebuild so the owner can drop
    derived caches (plan cache, learned chain capacities, stream insert
    targets).
    """

    def __init__(self, stores, stream=None, sstore=None,
                 ckpt_dir: str | None = None, pool=None, on_change=None):
        self.stream = stream
        self.sstore = sstore
        self._stores_src = stores
        # an explicit ckpt_dir pins; otherwise the runtime-mutable knob is
        # read at use time (the console can set it after the proxy booted)
        self._ckpt_dir_override = ckpt_dir
        self.pool = pool or (lambda: None)
        self.on_change = on_change
        # heal bookkeeping is shared between the background watcher, the
        # console/drill thread, and the pool engine running a RebuildJob —
        # the claim (inflight check + backoff check + attempt stamp) must
        # be one atomic step or two sweeps double-queue a shard's rebuild
        self._heal_lock = make_lock("recovery.heal")
        self._heal_attempts: dict[int, float] = {}  # guarded by: _heal_lock
        # shards with a rebuild queued/running on the pool's rebuild lane:
        # the lane drains only when every other lane is empty, so without
        # this the watcher would enqueue a duplicate job per sweep while
        # one waits out a busy pool
        self._heal_inflight: set[int] = set()  # guarded by: _heal_lock
        self._lock = make_lock("recovery.ckpt")
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []  # lock-free: start()/stop() are operator-thread only

    @property
    def stores(self) -> list:
        src = self._stores_src
        return list(src() if callable(src) else src)

    @property
    def ckpt_dir(self) -> str:
        return (self._ckpt_dir_override if self._ckpt_dir_override is not None
                else Global.checkpoint_dir)

    def _mutation_targets(self) -> list:
        """The full insert fan-out: primaries plus every live replica —
        WAL replay must mirror writes exactly like the live path does."""
        targets = list(self.stores)
        if self.sstore is not None:
            targets += self.sstore.replica_stores()
        return targets

    # ------------------------------------------------------------------
    # checkpoint side
    # ------------------------------------------------------------------
    def checkpoint(self) -> str:
        """Write one atomic checkpoint bundle; returns its path. The
        ``checkpoint.write`` fault site fires before any bytes land."""
        from wukong_tpu_torch.runtime import faults
        from wukong_tpu_torch.store.wal import mutation_lock

        if not self.ckpt_dir:
            raise WukongError(ErrorCode.FILE_NOT_FOUND,
                              "checkpoint_dir is not configured")
        faults.site("checkpoint.write")
        with self._lock, mutation_lock():
            # the mutation lock excludes in-flight batch commits for the
            # serialization window: every mutation is either fully inside
            # this bundle (seq <= wal_seq) or fully after it (replayed on
            # restore) — never half-captured
            os.makedirs(self.ckpt_dir, exist_ok=True)
            n = self._next_index()
            final = os.path.join(self.ckpt_dir, f"ckpt-{n:06d}")
            tmp = final + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            wal = active_wal()
            wal_seq = (wal.next_seq - 1) if wal is not None else -1
            t0 = time.monotonic()
            parts = []
            ckpt_bytes = 0
            for idx, g in enumerate(self.stores):
                ppath = checkpoint_part_path(tmp, idx)
                save_gstore(g, ppath)
                nbytes = os.path.getsize(ppath)
                ckpt_bytes += nbytes
                parts.append({"sid": int(g.sid),
                              "num_workers": int(g.num_workers),
                              "bytes": int(nbytes)})
                # the placement ledger's predicted-move-bytes source:
                # each distributed shard's measured on-disk size (the host
                # partition spans every shard — recording it under its sid
                # would overwrite shard 0's real size)
                if (self.sstore is None
                        or int(g.num_workers) == self.sstore.D):
                    get_lineage().note_checkpoint(int(g.sid), nbytes)
            man = {"format": list(MANIFEST_VERSION), "wal_seq": int(wal_seq),
                   "parts": parts, "stream": False, "epoch": 0}
            if self.stream is not None:
                state = {"registry": self.stream.continuous.export_state(),
                         "epoch": int(self.stream.ingestor.epoch)}
                blob = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
                with open(os.path.join(tmp, "stream.pkl"), "wb") as f:
                    f.write(blob)
                man["stream"] = True
                man["stream_crc"] = zlib.crc32(blob)
                man["epoch"] = state["epoch"]
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(man, f)
            os.rename(tmp, final)  # atomic publish: no torn checkpoints
            self._retire_old_checkpoints(wal)
            _M_CKPTS.inc()
            trace_event("checkpoint.write", path=final, wal_seq=wal_seq,
                        parts=len(parts))
            emit_event("checkpoint.write", path=final, wal_seq=wal_seq,
                       parts=len(parts), bytes=int(ckpt_bytes))
            log_info(f"checkpoint {final} written in "
                     f"{time.monotonic() - t0:.2f}s "
                     f"({len(parts)} part(s), wal_seq={wal_seq})")
            return final

    def _retire_old_checkpoints(self, wal) -> None:
        """Keep the newest CKPT_RETAIN bundles, drop the rest, and
        truncate the WAL behind the oldest retained bundle (every
        retained bundle keeps its full replay tail)."""
        import shutil

        found = list(self._checkpoints())  # newest first
        for path, _man in found[CKPT_RETAIN:]:
            shutil.rmtree(path, ignore_errors=True)
        retained = found[:CKPT_RETAIN]
        if wal is not None and retained:
            wal.truncate_upto(min(int(m["wal_seq"]) for _p, m in retained))

    def _next_index(self) -> int:
        idxs = [int(name[5:]) for name in os.listdir(self.ckpt_dir)
                if name.startswith("ckpt-") and name[5:].isdigit()]
        return (max(idxs) + 1) if idxs else 1

    def _checkpoints(self):
        """Yield (path, manifest) of checkpoint candidates, newest first;
        invalid ones (missing/corrupt manifest, newer-major format) are
        skipped with a warning so one bad bundle never blocks recovery
        from an older one."""
        if not self.ckpt_dir or not os.path.isdir(self.ckpt_dir):
            return
        names = sorted((n for n in os.listdir(self.ckpt_dir)
                        if n.startswith("ckpt-") and n[5:].isdigit()),
                       reverse=True)
        for name in names:
            path = os.path.join(self.ckpt_dir, name)
            try:
                with open(os.path.join(path, "MANIFEST.json")) as f:
                    man = json.load(f)
                if int(man["format"][0]) > MANIFEST_VERSION[0]:
                    log_warn(f"checkpoint {path}: manifest format "
                             f"{man['format']} is newer than this build; "
                             "skipping")
                    continue
                yield path, man
            except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
                log_warn(f"checkpoint {path}: unreadable manifest ({e}); "
                         "skipping")

    def newest_checkpoint(self) -> tuple[str, dict] | None:
        return next(self._checkpoints(), None)

    # ------------------------------------------------------------------
    # restore side
    # ------------------------------------------------------------------
    def recover(self) -> dict:
        """Boot-time restore: newest checkpoint into the live store
        objects, WAL tail replayed through the normal mutation path.
        Returns stats."""
        from wukong_tpu_torch.obs import get_recorder, maybe_start_trace
        from wukong_tpu_torch.obs.trace import activate

        trace = maybe_start_trace(kind="recovery")
        stats = {"checkpoint": None, "restored_parts": 0,
                 "replayed": {"insert": 0, "epoch": 0, "vector": 0},
                 "epoch": 0, "standing_queries": 0}
        with activate(trace):
            self._recover_impl(stats, trace)
        if trace is not None:
            get_recorder().on_complete(trace)
        return stats

    def _load_bundle(self, path: str, man: dict) -> dict:
        """Read + validate EVERY payload of one checkpoint without
        mutating any live state — a corrupt part file must surface here,
        where falling back to an older checkpoint is still possible, never
        halfway through an in-place restore."""
        targets = self.stores
        if len(man["parts"]) != len(targets):
            raise CheckpointCorrupt(
                f"bundle has {len(man['parts'])} parts but this process "
                f"has {len(targets)} stores", path=path)
        parts = []
        for idx, _part in enumerate(man["parts"]):
            g = targets[idx]
            g2 = load_gstore(checkpoint_part_path(path, idx))
            if g2.sid != g.sid or g2.num_workers != g.num_workers:
                raise CheckpointCorrupt(
                    f"part {idx} is partition {g2.sid}/{g2.num_workers}, "
                    f"target is {g.sid}/{g.num_workers}", path=path)
            parts.append((g, g2))
        state = None
        if man.get("stream") and self.stream is not None:
            with open(os.path.join(path, "stream.pkl"), "rb") as f:
                blob = f.read()
            if zlib.crc32(blob) != man.get("stream_crc"):
                raise CheckpointCorrupt("stream state checksum mismatch",
                                        path=path)
            state = pickle.loads(blob)
        elif man.get("stream"):
            # as the JAX manager with no stream context: the partitions
            # restore, the registry state is not read
            log_warn(f"checkpoint {path}: stream state not restored (no "
                     "stream context)")
        return {"path": path, "man": man, "parts": parts, "stream": state}

    def _recover_impl(self, stats: dict, trace) -> None:
        bundle = None
        for path, man in self._checkpoints():
            try:
                bundle = self._load_bundle(path, man)
                break
            except (WukongError, OSError) as e:
                log_warn(f"checkpoint {path} unusable ({e}); trying an "
                         "older one")
        after_seq = -1
        if bundle is not None:
            path, man = bundle["path"], bundle["man"]
            sp = trace.start_span("recovery.restore",
                                  path=path) if trace else None
            for g, g2 in bundle["parts"]:  # validated: cannot fail partway
                adopt_gstore(g, g2)
            if self.sstore is not None and self.sstore.replicas:
                self.sstore.refresh_replicas()
            if bundle["stream"] is not None:
                state = bundle["stream"]
                self.stream.continuous.import_state(state["registry"])
                self.stream.ingestor.epoch = int(state["epoch"])
                stats["standing_queries"] = len(
                    state["registry"]["queries"])
            after_seq = int(man["wal_seq"])
            stats["checkpoint"] = path
            stats["restored_parts"] = len(man["parts"])
            if sp is not None:
                trace.end_span(sp, parts=len(man["parts"]),
                               wal_seq=after_seq)
            _M_RESTORES.inc()
            emit_event("recovery.restore", path=path,
                       parts=len(man["parts"]), wal_seq=after_seq)
        if self.stream is not None:
            self.stream.ingestor.stores = self._mutation_targets()
        self._replay_wal(after_seq, stats, trace)
        # a restore replaces array contents wholesale: a version-keyed
        # cache purges conservatively (the restored world's versions are
        # not comparable to the cached keys'), and the edge lands as one
        # cache.invalidate event. One knob check each when off.
        from wukong_tpu_torch.obs.reuse import maybe_note_invalidation
        from wukong_tpu_torch.serve import notify_mutation

        maybe_note_invalidation("restore", version=None,
                                checkpoint=stats["checkpoint"])
        notify_mutation("restore")
        if self.on_change is not None:
            self.on_change()
        stats["epoch"] = (self.stream.ingestor.epoch
                          if self.stream is not None else 0)
        log_info(f"recovery: checkpoint={stats['checkpoint']} "
                 f"replayed={stats['replayed']} epoch={stats['epoch']}")

    def _replay_wal(self, after_seq: int, stats: dict, trace) -> None:
        from wukong_tpu_torch.store.dynamic import insert_triples

        wal = active_wal()
        if wal is None:
            return
        sp = trace.start_span("recovery.replay",
                              after_seq=after_seq) if trace else None
        prev_seq = after_seq
        with wal.suppress():
            for rec in wal.replay(after_seq=after_seq):
                # seqs are contiguous by construction: a gap means the
                # records between were truncated away (e.g. behind a
                # checkpoint that is NOT the one we restored) — applying
                # the rest would silently skip acknowledged mutations
                if rec.seq != prev_seq + 1:
                    raise CheckpointCorrupt(
                        f"WAL gap: record {rec.seq} follows {prev_seq} — "
                        "the tail for this checkpoint was truncated",
                        path=wal.dir)
                prev_seq = rec.seq
                if rec.kind == "epoch" and self.stream is not None:
                    # re-commit at the RECORDED epoch number (every record
                    # past wal_seq is outside the checkpoint), so a ghost
                    # record — an epoch whose commit failed after its
                    # append — never shifts later acknowledged epochs
                    ep = int(rec.payload.get("epoch",
                                             self.stream.ingestor.epoch + 1))
                    self.stream.ingestor.epoch = ep - 1
                    self.stream.ingestor.commit_epoch(
                        rec.payload["triples"], ts=rec.payload.get("ts"))
                elif rec.kind == "vector":
                    # embedding mutation: re-apply into every target's
                    # vstore (attaches one if the checkpoint predates the
                    # vector plane); version numbering re-derives, same as
                    # graph versions do
                    from wukong_tpu_torch.vector.vstore import (
                        apply_vector_record,
                    )

                    for g in self._mutation_targets():
                        apply_vector_record(g, rec.payload)
                else:
                    # a plain insert — or a stream epoch with no stream
                    # context to re-evaluate it: the data still must not
                    # be lost
                    for g in self._mutation_targets():
                        insert_triples(g, rec.payload["triples"],
                                       dedup=rec.payload["dedup"],
                                       check_ids=False)
                kind = rec.kind if rec.kind in ("epoch", "vector") \
                    else "insert"
                stats["replayed"][kind] += 1
                _M_REPLAYED.labels(kind=kind).inc()
        if sp is not None:
            trace.end_span(sp, **stats["replayed"])
        if sum(stats["replayed"].values()):
            emit_event("recovery.replay", after_seq=after_seq,
                       **stats["replayed"])

    # ------------------------------------------------------------------
    # runtime healing
    # ------------------------------------------------------------------
    def sick_shards(self) -> list[int]:
        if self.sstore is None:
            return []
        ss = self.sstore
        sick = set(ss.failover_shards) | set(ss.degraded_shards)
        sick |= {k for k in ss.breaker.tripped_keys() if isinstance(k, int)}
        return sorted(sick)

    def heal_once(self, background: bool = False,
                  force: bool = False) -> list[int]:
        """One healing sweep: rebuild + promote every sick shard (rate
        limited per shard by HEAL_BACKOFF_S unless ``force`` — the
        explicit console/drill path must not be skipped just because the
        background watcher attempted recently). With ``background`` and a
        running pool, rebuilds ride the pool's rebuild lane; otherwise
        they run inline. Returns the shards healed (inline mode)."""
        healed = []
        now = time.monotonic()
        for i in self.sick_shards():
            pool = self.pool() if background else None
            with self._heal_lock:
                # the whole claim is one atomic step: inflight check,
                # backoff check, attempt stamp, and (background mode) the
                # inflight mark — a concurrent sweep sees either nothing
                # or a fully-claimed shard, never a half-claim
                if i in self._heal_inflight:
                    continue  # one queued/running rebuild per shard, ever
                if not force and now - self._heal_attempts.get(
                        i, -1e18) < HEAL_BACKOFF_S:
                    continue
                self._heal_attempts[i] = now
                if pool is not None:
                    self._heal_inflight.add(i)
            if pool is not None:
                def _job(i=i):
                    try:
                        self._rebuild_shard(i)
                    finally:
                        with self._heal_lock:
                            self._heal_inflight.discard(i)

                job = RebuildJob(_job, label=f"shard-{i}")
                if pool.submit(job, lane="rebuild") == -1 and job.done.is_set():
                    # dead pool settled it via fail_all without running
                    with self._heal_lock:
                        self._heal_inflight.discard(i)
            elif self._rebuild_shard(i):
                healed.append(i)
        return healed

    def _rebuild_shard(self, i: int) -> bool:
        """Rebuild shard ``i``'s primary from its replica, else from the
        newest checkpoint + WAL tail; promote on success. Runs under the
        WAL mutation lock: a batch committing mid-rebuild would otherwise
        land only in the OLD store objects (or tear the replica clone),
        and the promoted primary would silently miss it."""
        from wukong_tpu_torch.store.wal import mutation_lock

        with mutation_lock():
            return self._rebuild_shard_locked(i)

    def _rebuild_shard_locked(self, i: int) -> bool:
        from wukong_tpu_torch.store.dynamic import insert_triples

        ss = self.sstore
        if ss is None:
            return False
        if ss.rebuild_shard(i, source="replica"):
            log_info(f"shard {i} rebuilt from replica and promoted")
            emit_event("shard.heal", shard=int(i), source="replica")
            self._after_rebuild()
            return True
        found = self.newest_checkpoint()
        if found is None:
            log_warn(f"shard {i} has no replica and no checkpoint — "
                     "cannot rebuild")
            return False
        path, man = found
        idx = next((j for j, p in enumerate(man["parts"])
                    if p["sid"] == i and p["num_workers"] == ss.D), None)
        if idx is None:
            log_warn(f"shard {i}: no matching partition in {path}")
            return False
        try:
            g_new = load_gstore(checkpoint_part_path(path, idx))
        except WukongError as e:
            log_error(f"shard {i}: checkpoint partition unreadable: {e}")
            return False
        wal = active_wal()
        if wal is not None:
            # direct per-partition inserts: no WAL hook fires here, so no
            # suppress() — holding the process-wide suppression on this
            # background thread would let concurrent LIVE commits skip
            # their WAL appends (acknowledged-but-unlogged writes)
            from wukong_tpu_torch.vector.vstore import apply_vector_record

            for rec in wal.replay(after_seq=int(man["wal_seq"])):
                if rec.kind == "vector":
                    apply_vector_record(g_new, rec.payload)
                else:
                    insert_triples(g_new, rec.payload["triples"],
                                   dedup=rec.payload["dedup"],
                                   check_ids=False)
        ss.rebuild_shard(i, store=g_new, source="checkpoint")
        log_info(f"shard {i} rebuilt from {path} + WAL tail and promoted")
        emit_event("shard.heal", shard=int(i), source="checkpoint")
        self._after_rebuild()
        return True

    def _after_rebuild(self) -> None:
        # a promoted primary is a NEW object: rebind the stream context's
        # insert fan-out and let the owner drop derived caches
        if self.stream is not None:
            self.stream.ingestor.stores = self._mutation_targets()
        if self.on_change is not None:
            self.on_change()

    # ------------------------------------------------------------------
    # background threads
    # ------------------------------------------------------------------
    def start(self, watch_interval_s: float = 0.5) -> None:
        """Launch the heal watcher (when a sharded store is attached) and
        the periodic checkpointer (when checkpoint_interval_s asks for
        one). Idempotent; both threads are daemons."""
        if self._threads:
            return
        if self.sstore is not None:
            t = threading.Thread(target=self._watch_loop,
                                 args=(watch_interval_s,), daemon=True,
                                 name="recovery-watcher")
            t.start()
            self._threads.append(t)
        if Global.checkpoint_interval_s > 0 and self.ckpt_dir:
            t = threading.Thread(target=self._checkpoint_loop, daemon=True,
                                 name="recovery-checkpointer")
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []
        self._stop = threading.Event()

    def _watch_loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                if self.sick_shards():
                    self.heal_once(background=True)
            except Exception as e:  # the watcher must never die silently
                log_error(f"recovery watcher: {e!r}")

    def _checkpoint_loop(self) -> None:
        while not self._stop.wait(max(Global.checkpoint_interval_s, 1)):
            try:
                self.checkpoint()
            except Exception as e:
                log_error(f"periodic checkpoint failed: {e!r}")
