"""Host engine pool: per-engine run queues with work stealing.

The port's copy of the JAX package's runtime/scheduler.py (``EnginePool``,
:123-755). The reference runs N engine threads per server, each with a
private queue, work stealing from neighbours (pair or ring, per
``Global.stealing_pattern``) and an adaptive busy-poll/snooze loop
(core/engine/engine.hpp:78-219). Here the engines are host ``CPUEngine``s on
threads: numpy releases the GIL in its heavy operations, so queries overlap.

Beyond the reference, as in the JAX package: a query whose deadline expired
while queued is shed with ``QueryTimeout``; an engine thread that dies is
respawned up to ``MAX_RESPAWNS`` times, then declared dead, its queue moved
to the live engines and its tid routed around (``health`` reports it).

Three lanes carry fire-and-forget items (``run(engine)`` /
``fail_all(exc)``), each settling its own futures: the batcher's fused
groups (runtime/batcher.py) and background rebuild jobs
(runtime/recovery.py ``RebuildJob``):
- ``batch``: light fused groups, popped right after an engine's own queue
  (interactive traffic; work stealing cannot split a group);
- ``heavy``: fused index-origin groups and their split slices, popped after
  every interactive source, with at most ``heavy_lane_pct`` percent of the
  engines (min 1) running heavy groups at once; a slice continues an
  admitted group and is popped outside that cap;
- ``rebuild``: background rebuild jobs, popped only when every other lane
  is empty (a rebuild soaks idle capacity, never displaces serving).
A group carries the GPU engine, so these host threads drive device work.

With ``enable_admission`` (runtime/admission.py) default-lane queries ride
a weighted-fair sub-lane (``FairQueue``, popped after the batch lane and
before stealing), and the heavy lane's pick gives each tenant its weighted
share of the heavy slots (``_heavy_pick_locked``, ``_heavy_by_tenant``).
Every queued item is stamped at submit and its wait charged to its lane's
queue-delay EWMA when popped (obs/slo.py); a traced query's ``pool.queue``
span closes on every exit from the queue; the depth, lane-depth and
utilization gauges are pull gauges over every live pool.

The stream lane (``submit(q, lane="stream")``) is a shared low-priority
queue for standing-query delta work (stream/continuous.py). Engines drain
it after their own queue, their steal targets and the heavy lane, so
interactive one-shot queries always go first and continuous evaluation
soaks up idle capacity, under the same deadline/budget machinery (expired
stream items are shed like interactive ones). With admission armed, a
delta query carrying ``owner_tenant`` rides the fair sub-lane at its
owner's weight instead. Stream-lane completions are reserved for
``wait()`` and never returned by ``poll()``, so an open-loop ``poll()``
consumer (the emulator) can share the pool with the stream context. The
rebuild lane's producer, shard healing, waits for the distributed engine
(ROADMAP §A, "``parallel/``, the distributed engine").
"""

from __future__ import annotations

import collections
import threading
import weakref

from wukong_tpu_torch.analysis.lockdep import make_lock
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.obs.slo import maybe_note_queue_delay, maybe_note_shed
from wukong_tpu_torch.runtime import faults
from wukong_tpu_torch.utils.errors import QueryTimeout
from wukong_tpu_torch.utils.logger import log_error, log_warn
from wukong_tpu_torch.utils.timer import get_usec

_M_SUBMITTED = get_registry().counter(
    "wukong_pool_submitted_total", "Queries submitted to the engine pool",
    labels=("lane",))
_M_SHED = get_registry().counter(
    "wukong_pool_shed_total",
    "Queries shed from the queue with an expired deadline")
_M_RESPAWNS = get_registry().counter(
    "wukong_pool_engine_respawns_total", "Engine-thread crash respawns")

# every live pool feeds the depth and utilization gauges (weakly
# referenced: a dropped pool reads as gone, never as stale depth)
_POOLS: "weakref.WeakSet" = weakref.WeakSet()


def _queue_depth() -> int:
    return sum(sum(len(dq) for dq in p.queues) + len(p.stream_queue)
               + len(p.batch_queue)
               + len(p.heavy_queue) + len(p.heavy_slices)
               + len(p.rebuild_queue)
               + (len(f) if (f := p._fair) is not None else 0)
               for p in list(_POOLS))


get_registry().gauge(
    "wukong_pool_queue_depth",
    "Queries waiting in pool queues (incl. stream/batch/heavy/rebuild lanes)"
).set_function(_queue_depth)


def _lane_depth_series() -> dict:
    """Per-lane queue depth across every live pool (an ADMISSION_INPUTS
    signal, obs/slo.py)."""
    acc = {"default": 0, "batch": 0, "heavy": 0, "stream": 0, "rebuild": 0}
    for p in list(_POOLS):
        acc["default"] += sum(len(dq) for dq in p.queues)
        acc["batch"] += len(p.batch_queue)
        acc["heavy"] += len(p.heavy_queue) + len(p.heavy_slices)
        acc["stream"] += len(p.stream_queue)
        acc["rebuild"] += len(p.rebuild_queue)
        f = p._fair  # the fair sub-lane exists once admission armed
        if f is not None:
            acc["fair"] = acc.get("fair", 0) + len(f)
    return {(k,): v for k, v in acc.items()}


get_registry().gauge(
    "wukong_pool_lane_depth", "Queries waiting per pool lane",
    labels=("lane",)).set_function(_lane_depth_series)


def _pool_utilization() -> float:
    """Busy fraction of live engines across every live pool (an
    ADMISSION_INPUTS signal)."""
    busy = alive = 0
    for p in list(_POOLS):
        for t in range(p.n):
            if not p._dead[t]:  # unguarded: report-only snapshot
                alive += 1
                if p._busy_since[t]:
                    busy += 1
    return busy / alive if alive else 0.0


get_registry().gauge(
    "wukong_pool_utilization",
    "Busy fraction of live pool engines").set_function(_pool_utilization)


def _live_engine_count() -> int:
    """Engines not declared dead across every live pool: the admission
    plane's derived in-flight capacity (admission ``_inflight_cap``)."""
    return sum(p.alive_count() for p in list(_POOLS))


class EnginePool:
    # engine-thread crashes (outside the per-query try) respawn up to this
    # many times per tid; past it the engine is declared dead, its queue is
    # redistributed, and routing skips it
    MAX_RESPAWNS = 3

    # idle relax bounds: a submit releases a semaphore permit and wakes one
    # sleeper at once, so a deep cap costs nothing in pickup latency; it only
    # thins the poll cadence of an idle pool
    IDLE_SNOOZE_MIN_US = 10
    IDLE_SNOOZE_MAX_US = 20000

    def __init__(self, num_engines: int | None = None, make_engine=None):
        """make_engine(tid) -> object with .execute(query) (one per thread,
        mirroring per-thread SPARQLEngine instances)."""
        self.n = num_engines or Global.num_engines
        # per-engine run queues, each guarded by the matching lock
        self.queues = [collections.deque() for _ in range(self.n)]
        self.locks = [make_lock("pool.queue") for _ in range(self.n)]
        self._make_engine = make_engine
        self._threads: list[threading.Thread | None] = [None] * self.n
        self._stop = threading.Event()
        self._pending = threading.Semaphore(0)
        self._results: dict[int, object] = {}  # guarded by: _results_lock
        self._results_lock = make_lock("pool.results")
        self._next_qid = 0  # guarded by: _results_lock
        self._done = {}  # guarded by: _results_lock
        # finished qids (poll() feed); append-before-set protocol relies on
        # CPython deque append/popleft atomicity
        self._completed = collections.deque()
        self._respawns = [0] * self.n  # per-tid slot, single writer
        self._dead = [False] * self.n  # guarded by: _route_lock
        # serializes dead-state transitions against routing: submit's
        # dead-check + enqueue must not interleave with declare-dead's
        # drain, or a query lands in a queue nobody will ever pop
        self._route_lock = make_lock("pool.route")
        self._busy_since = [0] * self.n  # per-tid slot, single writer
        self._inflight: list = [None] * self.n  # per-tid slot, single writer
        # stream lane: shared low-priority queue for standing-query work
        self.stream_queue = collections.deque()  # guarded by: _stream_lock
        self._stream_lock = make_lock("pool.stream")
        # stream-lane qids are reserved for wait(): poll() skips them, so
        # an open-loop poll() consumer sharing this pool can't steal the
        # stream context's completions
        self._stream_qids: set = set()  # guarded by: _results_lock
        # batch lane: light fused groups, one indivisible item each
        self.batch_queue = collections.deque()  # guarded by: _batch_lock
        self._batch_lock = make_lock("pool.batch")
        # heavy lane: fused heavy groups under the weighted cap, and the
        # split slices of running groups (cap-exempt) in a deque of their
        # own, so the pop path never scans the group queue for them
        self.heavy_queue = collections.deque()  # guarded by: _heavy_lock
        self.heavy_slices = collections.deque()  # guarded by: _heavy_lock
        self._heavy_lock = make_lock("pool.heavy")
        self._heavy_inflight = 0  # guarded by: _heavy_lock
        # rebuild lane: background rebuild jobs (runtime/recovery.py
        # RebuildJob), drained only when every other lane is empty
        self.rebuild_queue = collections.deque()  # guarded by: _rebuild_lock
        self._rebuild_lock = make_lock("pool.rebuild")
        # weighted-fair sub-lane (runtime/admission.py FairQueue), made on
        # the first admission-armed submission: off, the pop path pays one
        # attribute read
        self._fair = None  # guarded by: _route_lock
        # heavy-lane slots held per tenant: the per-tenant weighted cap
        # (admission heavy_cap_for) counts against this
        self._heavy_by_tenant: dict = {}  # guarded by: _heavy_lock
        _POOLS.add(self)

    # ------------------------------------------------------------------
    def start(self) -> None:
        for tid in range(self.n):
            self._spawn(tid)

    def _spawn(self, tid: int) -> None:
        t = threading.Thread(target=self._run_engine, args=(tid,),
                             daemon=True, name=f"engine-{tid}")
        t.start()
        self._threads[tid] = t

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            if t is not None:
                self._pending.release()
        for t in self._threads:
            if t is not None:
                t.join(timeout=5)
        self._threads = [None] * self.n

    # ------------------------------------------------------------------
    # failure detection / recovery (beyond the reference: its engine
    # pthreads have no supervision — wukong.cpp:245-252)
    # ------------------------------------------------------------------
    def health(self) -> dict:
        """Per-engine liveness snapshot: alive flag, respawn count, and how
        long the current query has been executing (0 = idle)."""
        now = get_usec()
        return {
            tid: {"alive": not self._dead[tid],
                  "respawns": self._respawns[tid],
                  "busy_us": (now - b) if (b := self._busy_since[tid]) else 0}
            for tid in range(self.n)}

    def _fail(self, qid: int, exc: Exception) -> None:
        """Deliver an error result, honouring the append-before-set
        protocol."""
        with self._results_lock:
            self._results[qid] = exc
            ev = self._done[qid]
        self._completed.append(qid)
        ev.set()

    @staticmethod
    def _stamp_enqueue(query, lane: str) -> None:
        """Queue-delay accounting for the overload bus (obs/slo.py): submit
        stamps the enqueue clock, the popping engine charges the lane's
        delay EWMA. One knob check when accounting is off; ``__slots__``
        items skip silently."""
        if not Global.enable_tenant_accounting:
            return
        try:
            query._slo_enq_us = get_usec()
            query._slo_lane = lane
        except AttributeError:
            pass

    @staticmethod
    def _charge_queue_delay(query) -> None:
        enq = getattr(query, "_slo_enq_us", None)
        if enq is not None:
            query._slo_enq_us = None
            maybe_note_queue_delay(getattr(query, "_slo_lane", "default"),
                                   get_usec() - enq)

    @staticmethod
    def _end_queue_span(query, **attrs) -> None:
        """Close a traced query's pool.queue span. Every exit from the
        queue (popped, shed, or failed by a dead pool) ends it, or the open
        span keeps counting time and swallows later trace events."""
        qs = getattr(query, "_obs_queue_span", None)
        if qs is not None:
            query.trace.end_span(qs, **attrs)
            query._obs_queue_span = None

    def _on_engine_death(self, tid: int, exc: BaseException) -> None:
        # the in-flight query (if any) likely triggered the crash: fail it
        # rather than retry it into every engine, and never strand its waiter
        self._busy_since[tid] = 0
        item = self._inflight[tid]
        self._inflight[tid] = None
        if item is not None:
            qid, query = item
            if qid is None:  # a lane item: settle its members' futures
                self._heavy_done(query)  # a heavy slot died with the thread
                query.fail_all(RuntimeError(
                    f"engine-{tid} crashed executing a fused batch: "
                    f"{exc!r}"))
            else:
                self._fail(qid, RuntimeError(
                    f"engine-{tid} crashed executing query {qid}: {exc!r}"))
        self._respawns[tid] += 1
        _M_RESPAWNS.inc()
        if self._respawns[tid] <= self.MAX_RESPAWNS and not self._stop.is_set():
            log_warn(f"engine-{tid} died ({exc!r}); respawning "
                     f"({self._respawns[tid]}/{self.MAX_RESPAWNS})")
            self._spawn(tid)  # its queue is intact; the new thread drains it
            return
        # crash loop: declare dead, push queued work to the neighbours so
        # nothing strands, and stop routing here
        log_error(f"engine-{tid} dead after {self._respawns[tid]} crashes; "
                  "redistributing its queue")
        with self._route_lock:
            self._dead[tid] = True
            with self.locks[tid]:
                stranded = list(self.queues[tid])
                self.queues[tid].clear()
            live = [t for t in range(self.n) if not self._dead[t]]
            for k, it in enumerate(stranded):
                if not live:  # whole pool dead: fail queries, don't hang
                    self._end_queue_span(it[1], dead_pool=True)
                    self._fail(it[0], RuntimeError("engine pool dead"))
                    continue
                dst = live[k % len(live)]
                with self.locks[dst]:
                    self.queues[dst].append(it)
                self._pending.release()
            if not live:  # nobody left to drain the lanes either
                # ...starting with the fair sub-lane: pop until dry
                f = self._fair
                while f is not None:
                    it = f.pop()
                    if it is None:
                        break
                    self._end_queue_span(it[1], dead_pool=True)
                    self._fail(it[0], RuntimeError("engine pool dead"))
                # ...the stream lane: its waiters get the error
                with self._stream_lock:
                    stream_stranded = list(self.stream_queue)
                    self.stream_queue.clear()
                for it in stream_stranded:
                    self._end_queue_span(it[1], dead_pool=True)
                    self._fail(it[0], RuntimeError("engine pool dead"))
                with self._batch_lock:
                    stranded = list(self.batch_queue)
                    self.batch_queue.clear()
                with self._heavy_lock:
                    stranded += (list(self.heavy_queue)
                                 + list(self.heavy_slices))
                    self.heavy_queue.clear()
                    self.heavy_slices.clear()
                # ...and the rebuild lane: the same settlement
                with self._rebuild_lock:
                    stranded += list(self.rebuild_queue)
                    self.rebuild_queue.clear()
                for _qid, lane_item in stranded:
                    lane_item.fail_all(RuntimeError("engine pool dead"))

    # ------------------------------------------------------------------
    def submit(self, query, tid: int | None = None,
               lane: str | None = None) -> int:
        """Enqueue a query; returns a handle. tid routes like the
        reference's proxy dst engine choice (round-robin default,
        proxy.hpp:143-160).

        lane="stream" bypasses per-engine routing into the shared
        low-priority stream queue: any engine drains it, but only after its
        own queue, its steal targets and the heavy lane (standing-query
        work never displaces interactive queries); its completion is
        reserved for wait().

        lane="batch" enqueues a light FusedGroup (runtime/batcher.py) and
        lane="heavy" a HeavyGroup or one of its split slices, each as ONE
        indivisible fire-and-forget item: it settles its members' futures
        itself, so no result entry is made and -1 is returned. A dead pool
        fails the item at once through its fail_all. lane="rebuild"
        enqueues a background rebuild job (runtime/recovery.py RebuildJob)
        with the same contract, drained only when every other lane is
        empty.

        With ``enable_admission`` a default-lane query with no routing pin
        rides the weighted-fair sub-lane (``_submit_fair``). A traced query
        gets a ``pool.queue`` span, closed by the engine that pops it."""
        if lane in ("batch", "heavy", "rebuild"):
            _M_SUBMITTED.labels(lane=lane).inc()
            if lane == "batch":
                lock, queue = self._batch_lock, self.batch_queue
            elif lane == "rebuild":
                lock, queue = self._rebuild_lock, self.rebuild_queue
            elif getattr(query, "heavy_continuation", False):
                lock, queue = self._heavy_lock, self.heavy_slices
            else:
                lock, queue = self._heavy_lock, self.heavy_queue
            self._stamp_enqueue(query, lane)
            with self._route_lock:
                if all(self._dead):
                    query.fail_all(RuntimeError("engine pool dead"))
                    return -1
                with lock:
                    queue.append((None, query))
            self._pending.release()
            return -1
        if lane not in (None, "default", "stream"):
            raise ValueError(f"unknown pool lane {lane!r}")
        lane = lane or "default"
        _M_SUBMITTED.labels(lane=lane).inc()
        with self._results_lock:
            qid = self._next_qid
            self._next_qid += 1
            self._done[qid] = threading.Event()
        # the queue span opens here and closes on the engine thread that
        # pops the query (a cross-thread end)
        tr = getattr(query, "trace", None)
        if tr is not None:
            query._obs_queue_span = tr.start_span(
                "pool.queue", qid=qid, lane=lane)
        self._stamp_enqueue(query, lane)
        if lane == "stream":
            if Global.enable_admission and getattr(query, "owner_tenant",
                                                   None):
                # priority inheritance: a standing query's maintenance
                # work rides the fair sub-lane at its OWNER's weight
                # instead of the last-priority stream lane
                return self._submit_fair(qid, query, stream=True)
            with self._results_lock:
                self._stream_qids.add(qid)
            with self._route_lock:
                if all(self._dead[k] for k in range(self.n)):
                    self._end_queue_span(query, dead_pool=True)
                    self._fail(qid, RuntimeError("engine pool dead"))
                    return qid
                with self._stream_lock:
                    self.stream_queue.append((qid, query))
            self._pending.release()
            return qid
        if tid is None and Global.enable_admission:
            # default-lane traffic with no routing pin rides the DRR fair
            # sub-lane: per-tenant sub-queues drained by weight
            return self._submit_fair(qid, query)
        t = qid % self.n if tid is None else tid % self.n
        with self._route_lock:  # atomic dead-check + enqueue vs declare-dead
            if self._dead[t]:  # route around dead engines
                live = [k for k in range(self.n) if not self._dead[k]]
                if not live:
                    self._end_queue_span(query, dead_pool=True)
                    self._fail(qid, RuntimeError("engine pool dead"))
                    return qid
                t = live[qid % len(live)]
            with self.locks[t]:
                self.queues[t].append((qid, query))
        self._pending.release()
        return qid

    def _submit_fair(self, qid: int, query, stream: bool = False) -> int:
        """Enqueue into the weighted-fair sub-lane (admission armed). The
        tenant is the effective one (``owner_tenant`` first) and the DRR
        weight is resolved here, from the lock-free quota map: FairQueue
        never calls out under ``admission.queue``, which stays a leaf. A
        stream-lane item keeps its completion reserved for wait()."""
        from wukong_tpu_torch.runtime.admission import (
            FairQueue,
            effective_tenant,
            get_admission,
        )

        ten = effective_tenant(query)
        w = get_admission().weight(ten)
        if stream:
            with self._results_lock:
                self._stream_qids.add(qid)
        with self._route_lock:  # atomic dead-check + enqueue, as above
            if all(self._dead[k] for k in range(self.n)):
                self._end_queue_span(query, dead_pool=True)
                self._fail(qid, RuntimeError("engine pool dead"))
                return qid
            f = self._fair
            if f is None:
                f = self._fair = FairQueue()
            f.push(ten, (qid, query), weight=w)
        self._pending.release()
        return qid

    def wait(self, qid: int, timeout: float | None = None):
        """Returns the engine's result, or raises TimeoutError (the result
        stays claimable by a later wait)."""
        with self._results_lock:
            ev = self._done[qid]
        if not ev.wait(timeout):
            raise TimeoutError(f"query {qid} still running")
        with self._results_lock:
            self._done.pop(qid, None)
            self._stream_qids.discard(qid)
            try:
                self._completed.remove(qid)
            except ValueError:
                pass
            return self._results.pop(qid, None)

    def poll(self) -> list:
        """Drain finished queries as (qid, result) pairs — the open-loop
        receive side (proxy.hpp tryrecv_reply analogue). A pool user should
        consume completions via EITHER wait() or poll(), not both."""
        out = []
        while True:
            try:
                qid = self._completed.popleft()
            except IndexError:
                break
            with self._results_lock:
                if qid not in self._done:  # already consumed via wait()
                    continue
                if qid in self._stream_qids:
                    # stream-lane completions belong to the stream
                    # context's wait() — leave them claimable
                    continue
                self._done.pop(qid)
                out.append((qid, self._results.pop(qid, None)))
        return out

    # ------------------------------------------------------------------
    def _neighbors(self, tid: int) -> list[int]:
        """Stealing pattern (engine.hpp:186-207): 0=pair, 1=ring."""
        if self.n <= 1:
            return []
        if Global.stealing_pattern == 1:  # ring: next engine
            return [(tid + 1) % self.n]
        return [tid ^ 1] if (tid ^ 1) < self.n else []  # pair

    def alive_count(self) -> int:
        """Engines not declared dead (the heavy split fan-out bound)."""
        return sum(1 for t in range(self.n) if not self._dead[t])

    def _heavy_cap(self) -> int:
        """Most engines running heavy-lane groups at once."""
        return max((self.n * max(int(Global.heavy_lane_pct), 0)) // 100, 1)

    def _heavy_done(self, query) -> None:
        """Release the weighted heavy slot an engine-loop pop took: only a
        heavy group took one (a slice continuation did not), with its
        tenant's slot when admission counted one."""
        if getattr(query, "lane", None) != "heavy" \
                or getattr(query, "heavy_continuation", False):
            return
        ten = getattr(query, "_adm_heavy_ten", None)
        with self._heavy_lock:
            self._heavy_inflight = max(self._heavy_inflight - 1, 0)
            if ten is not None:
                query._adm_heavy_ten = None
                left = self._heavy_by_tenant.get(ten, 1) - 1
                if left <= 0:
                    self._heavy_by_tenant.pop(ten, None)
                else:
                    self._heavy_by_tenant[ten] = left

    def _heavy_pick_locked(self) -> int:  # caller holds: _heavy_lock
        """Index of the first heavy-queue group whose tenant is under its
        weighted slot share, or -1 when every queued tenant is at its cap.
        ``heavy_cap_for`` is a pure function of the lock-free quota map: no
        lock is taken under ``pool.heavy``."""
        if not Global.enable_admission:
            return 0 if self.heavy_queue else -1
        from wukong_tpu_torch.runtime.admission import get_admission

        adm = get_admission()
        cap = self._heavy_cap()
        for i, (_qid, g) in enumerate(self.heavy_queue):
            ten = getattr(g, "tenant", None)
            if ten is None:
                return i  # an untagged group: no tenant cap
            if (self._heavy_by_tenant.get(ten, 0)
                    < adm.heavy_cap_for(ten, cap, self._heavy_by_tenant)):
                return i
        return -1

    def _pop_work(self, tid: int):
        # own queue first (front)
        with self.locks[tid]:
            if self.queues[tid]:
                return self.queues[tid].popleft()
        # batch lane next: fused groups are interactive traffic, popped
        # whole (a group is one item: stealing can never split it)
        with self._batch_lock:
            if self.batch_queue:
                return self.batch_queue.popleft()
        # weighted-fair sub-lane (admission armed): one DRR pop serves the
        # per-tenant sub-queues by weight, ahead of stealing (a fair item
        # has no owner engine to steal from)
        f = self._fair  # unguarded: reads the set-once published reference
        if f is not None:
            item = f.pop()
            if item is not None:
                return item
        # steal from neighbours (back — leave the owner its freshest work)
        for nb in self._neighbors(tid):
            with self.locks[nb]:
                if self.queues[nb]:
                    return self.queues[nb].pop()
        # heavy lane after every interactive source, under the weighted
        # cap; split SLICES are cap-exempt continuations — their group
        # already holds a slot, and capping them would stall its gather
        # barrier behind itself
        with self._heavy_lock:
            if self.heavy_slices:
                return self.heavy_slices.popleft()
            if self.heavy_queue and self._heavy_inflight < self._heavy_cap():
                i = self._heavy_pick_locked()
                if i >= 0:
                    item = self.heavy_queue[i]
                    del self.heavy_queue[i]
                    self._heavy_inflight += 1
                    ten = getattr(item[1], "tenant", None)
                    if ten is not None and Global.enable_admission:
                        # stamp the counted tenant on the group so
                        # _heavy_done releases the same slot even if the
                        # knob or the quota map changes mid-flight
                        item[1]._adm_heavy_ten = ten
                        self._heavy_by_tenant[ten] = (
                            self._heavy_by_tenant.get(ten, 0) + 1)
                    return item
        # stream lane next-to-last: standing-query work fills idle capacity
        if self.stream_queue:  # unguarded: an idle engine's peek at an empty lane; the pop rechecks under the lock
            with self._stream_lock:
                if self.stream_queue:
                    return self.stream_queue.popleft()
        # rebuild lane last: background rebuilds are fully deferrable
        if self.rebuild_queue:  # unguarded: an idle engine's peek at an empty lane; the pop rechecks under the lock
            with self._rebuild_lock:
                if self.rebuild_queue:
                    return self.rebuild_queue.popleft()
        return None

    def _run_engine(self, tid: int) -> None:
        try:
            self._engine_loop(tid)
        except BaseException as e:  # thread death (not per-query errors)
            if not self._stop.is_set():
                self._on_engine_death(tid, e)

    def _engine_loop(self, tid: int) -> None:
        from wukong_tpu_torch.runtime.bind import get_binder

        get_binder().bind_thread(tid)  # no-op unless core binding is enabled
        engine = self._make_engine(tid)
        snooze_us = self.IDLE_SNOOZE_MIN_US
        while not self._stop.is_set():
            item = self._pop_work(tid)
            if item is None:
                # capped exponential idle backoff with wake-on-submit
                got = self._pending.acquire(timeout=snooze_us / 1e6)
                snooze_us = (self.IDLE_SNOOZE_MIN_US if got
                             else min(snooze_us * 2, self.IDLE_SNOOZE_MAX_US))
                continue
            qid, query = item
            self._inflight[tid] = item
            self._busy_since[tid] = get_usec()
            self._charge_queue_delay(query)  # overload bus: per-lane EWMA
            if qid is None:  # batch/heavy lanes: fire-and-forget items
                try:
                    faults.site("pool.execute", shard=tid)
                    query.run(engine)
                except Exception as e:
                    # run() settles its members on its own errors; this
                    # catches the re-raise (and fault injection) so the
                    # engine thread lives on — fail_all is idempotent
                    query.fail_all(e)
                self._heavy_done(query)  # release the weighted heavy slot
                self._busy_since[tid] = 0
                self._inflight[tid] = None
                self._respawns[tid] = 0
                continue
            # close the queue span opened at submit (the wait IS the span)
            self._end_queue_span(query, engine=tid)
            try:
                # a query whose deadline expired while queued fails fast
                # with a structured QueryTimeout instead of occupying the
                # engine (load shedding); the pool keeps serving
                dl = getattr(query, "deadline", None)
                if dl is not None and dl.expired():
                    _M_SHED.inc()
                    maybe_note_shed("queue_deadline",
                                    getattr(query, "tenant", "default"))
                    raise QueryTimeout(
                        f"deadline expired in engine-{tid} queue")
                faults.site("pool.execute", shard=tid)
                out = engine.execute(query)
            except Exception as e:  # engine errors become the reply
                out = e
            # cleared HERE, not in a finally: a thread-killing exception
            # must leave the in-flight marker for _on_engine_death to fail
            # the query instead of stranding its waiter
            self._busy_since[tid] = 0
            self._inflight[tid] = None
            # a served query proves the engine healthy: reset the crash
            # budget so isolated poison queries never add up to a
            # permanent declare-dead
            self._respawns[tid] = 0
            with self._results_lock:
                self._results[qid] = out
                ev = self._done[qid]  # capture: a racing poll() may pop it
            # append BEFORE set(): a wait()er woken by set() must find the
            # qid already in _completed so its remove() never races it
            self._completed.append(qid)
            ev.set()
