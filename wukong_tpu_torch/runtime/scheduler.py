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

Two lanes carry the batcher's fused groups (runtime/batcher.py), each
group one fire-and-forget item (``run(engine)`` / ``fail_all(exc)``) that
settles its members' futures itself:
- ``batch``: light fused groups, popped right after an engine's own queue
  (interactive traffic; work stealing cannot split a group);
- ``heavy``: fused index-origin groups and their split slices, popped after
  every interactive source, with at most ``heavy_lane_pct`` percent of the
  engines (min 1) running heavy groups at once; a slice continues an
  admitted group and is popped outside that cap.
A group carries the GPU engine, so these host threads drive device work.

Left out, each waiting for its subsystem: the stream and rebuild lanes, the
admission fair queue ``_submit_fair`` and the tenant branch of
``_heavy_pick_locked`` (ROADMAP §A 2.2), the queue-delay stamps, shed notes
and queue span (§A 2.3-2.4), and the utilization and total-depth gauges.
"""

from __future__ import annotations

import collections
import threading
import weakref

from wukong_tpu_torch.analysis.lockdep import make_lock
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.metrics import get_registry
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

# every live pool feeds the per-lane depth gauge (weakly referenced: a
# dropped pool reads as gone, never as stale depth)
_POOLS: "weakref.WeakSet" = weakref.WeakSet()


def _lane_depth_series() -> dict:
    """Per-lane queue depth across every live pool."""
    acc = {"default": 0, "batch": 0, "heavy": 0}
    for p in list(_POOLS):
        acc["default"] += sum(len(dq) for dq in p.queues)
        acc["batch"] += len(p.batch_queue)
        acc["heavy"] += len(p.heavy_queue) + len(p.heavy_slices)
    return {(k,): v for k, v in acc.items()}


get_registry().gauge(
    "wukong_pool_lane_depth", "Queries waiting per pool lane",
    labels=("lane",)).set_function(_lane_depth_series)


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
                    self._fail(it[0], RuntimeError("engine pool dead"))
                    continue
                dst = live[k % len(live)]
                with self.locks[dst]:
                    self.queues[dst].append(it)
                self._pending.release()
            if not live:  # nobody left to drain the lanes either
                with self._batch_lock:
                    stranded = list(self.batch_queue)
                    self.batch_queue.clear()
                with self._heavy_lock:
                    stranded += (list(self.heavy_queue)
                                 + list(self.heavy_slices))
                    self.heavy_queue.clear()
                    self.heavy_slices.clear()
                for _qid, lane_item in stranded:
                    lane_item.fail_all(RuntimeError("engine pool dead"))

    # ------------------------------------------------------------------
    def submit(self, query, tid: int | None = None,
               lane: str | None = None) -> int:
        """Enqueue a query; returns a handle. tid routes like the
        reference's proxy dst engine choice (round-robin default,
        proxy.hpp:143-160).

        lane="batch" enqueues a light FusedGroup (runtime/batcher.py) and
        lane="heavy" a HeavyGroup or one of its split slices, each as ONE
        indivisible fire-and-forget item: it settles its members' futures
        itself, so no result entry is made and -1 is returned. A dead pool
        fails the item at once through its fail_all."""
        if lane in ("batch", "heavy"):
            _M_SUBMITTED.labels(lane=lane).inc()
            if lane == "batch":
                lock, queue = self._batch_lock, self.batch_queue
            elif getattr(query, "heavy_continuation", False):
                lock, queue = self._heavy_lock, self.heavy_slices
            else:
                lock, queue = self._heavy_lock, self.heavy_queue
            with self._route_lock:
                if all(self._dead):
                    query.fail_all(RuntimeError("engine pool dead"))
                    return -1
                with lock:
                    queue.append((None, query))
            self._pending.release()
            return -1
        if lane not in (None, "default"):
            raise ValueError(f"unknown pool lane {lane!r}")
        _M_SUBMITTED.labels(lane="default").inc()
        with self._results_lock:
            qid = self._next_qid
            self._next_qid += 1
            self._done[qid] = threading.Event()
        t = qid % self.n if tid is None else tid % self.n
        with self._route_lock:  # atomic dead-check + enqueue vs declare-dead
            if self._dead[t]:  # route around dead engines
                live = [k for k in range(self.n) if not self._dead[k]]
                if not live:
                    self._fail(qid, RuntimeError("engine pool dead"))
                    return qid
                t = live[qid % len(live)]
            with self.locks[t]:
                self.queues[t].append((qid, query))
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
        heavy group took one (a slice continuation did not)."""
        if getattr(query, "lane", None) != "heavy" \
                or getattr(query, "heavy_continuation", False):
            return
        with self._heavy_lock:
            self._heavy_inflight = max(self._heavy_inflight - 1, 0)

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
                self._heavy_inflight += 1
                return self.heavy_queue.popleft()
        return None

    def _run_engine(self, tid: int) -> None:
        try:
            self._engine_loop(tid)
        except BaseException as e:  # thread death (not per-query errors)
            if not self._stop.is_set():
                self._on_engine_death(tid, e)

    def _engine_loop(self, tid: int) -> None:
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
            try:
                # a query whose deadline expired while queued fails fast
                # with a structured QueryTimeout instead of occupying the
                # engine (load shedding); the pool keeps serving
                dl = getattr(query, "deadline", None)
                if dl is not None and dl.expired():
                    _M_SHED.inc()
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
