"""Lockdep-style runtime lock-order checker.

The port's copy of the JAX package's analysis/lockdep.py. Every lock made
through :func:`make_lock` takes part, keyed by its *name* (a lock class,
not an instance: two pools' ``pool.route`` locks share one node, as
lockdep's lock classes do). Each acquisition made while other locks are
held adds edges to a process-wide directed graph:

- **Cycle detection.** An edge that closes a cycle is a potential deadlock:
  one thread took A then B earlier, another now takes B while holding A.
  The first detection is recorded with both stacks.
- **Declared leaves.** :func:`declare_leaf` marks a lock class innermost
  (the row-budget lock, the observatory's ledgers). Acquiring any tracked
  lock while holding a leaf is recorded as a violation.
- **Hold/contention histograms.** Every tracked lock exports
  ``wukong_lock_wait_us{name}`` / ``wukong_lock_hold_us{name}`` and a
  ``wukong_lock_contended_total{name}`` counter, and the findings count
  ``wukong_lockdep_cycles_total`` / ``wukong_lockdep_leaf_violations_total``,
  through the obs MetricsRegistry (whose own locks are deliberately not
  tracked: the checker publishes through them).

Zero cost when off: with ``debug_locks`` false :func:`make_lock` returns a
plain ``threading.Lock``, :func:`make_rlock` a plain ``threading.RLock``
(the WAL's mutation lock) and :func:`make_condition` a plain
``threading.Condition`` (the batcher's). A module-level lock created at
import, or the lock of a process-wide singleton (the observatory's
ledgers), registers through :func:`register_global_lock`, and
:func:`install` rebuilds it, so whole-process checked mode covers it.
"""

from __future__ import annotations

import threading
import time
import traceback

from wukong_tpu_torch.config import Global

__all__ = [
    "DebugCondition", "DebugLock", "DebugRLock", "cycles", "declare_leaf",
    "install", "leaf_violations", "make_condition", "make_lock",
    "make_rlock", "register_global_lock", "report", "reset",
]


def _metrics():
    from wukong_tpu_torch.obs.metrics import get_registry

    reg = get_registry()
    return (reg.histogram("wukong_lock_wait_us",
                          "Time spent waiting for contended tracked locks",
                          labels=("name",)),
            reg.histogram("wukong_lock_hold_us",
                          "Tracked lock hold times", labels=("name",)),
            reg.counter("wukong_lock_contended_total",
                        "Tracked lock acquisitions that had to block",
                        labels=("name",)),
            reg.counter("wukong_lockdep_cycles_total",
                        "Lock-order cycles detected"),
            reg.counter("wukong_lockdep_leaf_violations_total",
                        "Acquisitions while holding a declared-leaf lock"))


class _LockdepState:
    """Process-wide acquisition-order graph + findings."""

    def __init__(self):
        self._mu = threading.Lock()  # guards every field below; a plain
        # lock by construction — the checker cannot check itself
        self.edges: dict[tuple[str, str], dict] = {}  # (a,b) -> first stack
        self.cycles: list[dict] = []
        self.leaf_violations: list[dict] = []
        self.leaves: set[str] = set()
        self.seen_cycle_keys: set[tuple] = set()
        self._tls = threading.local()

    # -- per-thread held stack -----------------------------------------
    def held(self) -> list[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    # -- graph ----------------------------------------------------------
    def _path_exists(self, src: str, dst: str) -> list[str] | None:
        """DFS over recorded edges; returns the node path src..dst."""
        stack = [(src, [src])]
        seen = {src}
        adj: dict[str, list[str]] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, []).append(b)
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def on_acquired(self, name: str) -> None:
        """Record one successful acquisition of ``name`` by this thread.
        Must be called AFTER the underlying lock is held (the order graph
        only ever records orders that really happened)."""
        held = self.held()
        if held:
            prev = held[-1]
            with self._mu:
                # steady state: the edge exists and no leaf is held — skip
                # the (expensive) stack capture entirely
                need = (any(h in self.leaves for h in held)
                        or (prev != name
                            and (prev, name) not in self.edges))
            if need:
                self._record(name, held)
        held.append(name)

    def _record(self, name: str, held: list[str]) -> None:
        """Slow path: something new to write down (first time this edge is
        seen, or a leaf lock is held). Captures the stack once."""
        prev = held[-1]
        stack_txt = "".join(traceback.format_stack(limit=16)[:-2])
        tname = threading.current_thread().name
        cycle_msg = None
        with self._mu:
            for h in held:
                if h in self.leaves:
                    _metrics()[4].inc()
                    key = ("leaf", h, name)
                    if key not in self.seen_cycle_keys:
                        self.seen_cycle_keys.add(key)
                        self.leaf_violations.append({
                            "holding": h, "acquiring": name,
                            "thread": tname, "stack": stack_txt})
            if prev != name and (prev, name) not in self.edges:
                # before recording prev->name, see if name->..->prev
                # already exists: that is the inversion
                path = self._path_exists(name, prev)
                if path is not None:
                    key = tuple(sorted((prev, name)))
                    if key not in self.seen_cycle_keys:
                        self.seen_cycle_keys.add(key)
                        first_edge = self.edges.get((path[0], path[1]), {})
                        self.cycles.append({
                            "cycle": path + [name],
                            "this_order": (prev, name),
                            "thread": tname,
                            "stack_here": stack_txt,
                            "stack_first": first_edge.get("stack", ""),
                            "thread_first": first_edge.get("thread", ""),
                        })
                        _metrics()[3].inc()
                        cycle_msg = (
                            "lockdep: lock-order cycle "
                            f"{' -> '.join(path + [name])}: this thread "
                            f"acquires {name!r} while holding {prev!r}, "
                            "but the opposite order was recorded earlier "
                            "— potential deadlock (both stacks kept; see "
                            "analysis.lockdep.report())")
                # first observation only: a later slow-path visit (leaf
                # held, or a racing thread) must not overwrite the stack
                # a cycle report will present as "stack_first", and a
                # reentrant same-name acquire must not self-edge
                self.edges[(prev, name)] = {"stack": stack_txt,
                                            "thread": tname}
        if cycle_msg is not None:  # log outside the checker's own mutex
            from wukong_tpu_torch.utils.logger import log_error

            log_error(cycle_msg)

    def on_released(self, name: str) -> None:
        held = self.held()
        # released in any order (lock scopes are not always LIFO): drop
        # the most recent matching entry
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return


_state = _LockdepState()


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

class DebugLock:
    """threading.Lock wrapper feeding the order graph + histograms."""

    _kind = "lock"

    def __init__(self, name: str):
        self.name = name
        self._inner = self._make_inner()
        self._acquired_at = 0.0  # monotonic; only read by the owner
        (self._m_wait, self._m_hold, self._m_contended,
         _c, _l) = _metrics()

    @staticmethod
    def _make_inner():
        return threading.Lock()

    # -- lock protocol --------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking=False)
        if not got:
            if not blocking:
                return False
            self._m_contended.labels(name=self.name).inc()
            t0 = time.monotonic()
            got = self._inner.acquire(timeout=timeout) \
                if timeout and timeout > 0 else self._inner.acquire()
            if not got:
                return False
            self._m_wait.labels(name=self.name).observe(
                (time.monotonic() - t0) * 1e6)
        self._acquired_at = time.monotonic()
        _state.on_acquired(self.name)
        return True

    def release(self) -> None:
        held_us = (time.monotonic() - self._acquired_at) * 1e6
        _state.on_released(self.name)
        self._inner.release()
        self._m_hold.labels(name=self.name).observe(held_us)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class DebugRLock(DebugLock):
    """Reentrant variant: only the outermost acquire/release feed the
    order graph and the hold histogram."""

    _kind = "rlock"

    def __init__(self, name: str):
        super().__init__(name)
        self._owner: int | None = None  # mutated only while inner is held
        self._depth = 0

    @staticmethod
    def _make_inner():
        return threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._owner == me:  # reentrant fast path: we already hold it
            self._inner.acquire()
            self._depth += 1
            return True
        got = self._inner.acquire(blocking=False)
        if not got:
            if not blocking:
                return False
            self._m_contended.labels(name=self.name).inc()
            t0 = time.monotonic()
            got = self._inner.acquire(timeout=timeout) \
                if timeout and timeout > 0 else self._inner.acquire()
            if not got:
                return False
            self._m_wait.labels(name=self.name).observe(
                (time.monotonic() - t0) * 1e6)
        self._owner = me
        self._depth = 1
        self._acquired_at = time.monotonic()
        _state.on_acquired(self.name)
        return True

    def release(self) -> None:
        self._depth -= 1
        if self._depth == 0:
            held_us = (time.monotonic() - self._acquired_at) * 1e6
            self._owner = None
            _state.on_released(self.name)
            self._inner.release()
            self._m_hold.labels(name=self.name).observe(held_us)
        else:
            self._inner.release()

    def locked(self) -> bool:
        return self._owner is not None


def make_lock(name: str):
    """A mutex participating in lockdep when ``debug_locks`` is on; a
    PLAIN ``threading.Lock`` otherwise (zero wrapper cost off-path)."""
    return DebugLock(name) if Global.debug_locks else threading.Lock()


def make_rlock(name: str):
    return DebugRLock(name) if Global.debug_locks else threading.RLock()


def make_condition(name: str):
    """A Condition whose underlying mutex participates in lockdep when on.
    ``Condition.wait`` releases/reacquires through the wrapper, so the
    held-stack stays exact across waits."""
    if not Global.debug_locks:
        return threading.Condition()
    return threading.Condition(DebugLock(name))


DebugCondition = make_condition  # the factory IS the wrapper spelling


# ---------------------------------------------------------------------------
# leaves + module-level lock rebinding
# ---------------------------------------------------------------------------

def declare_leaf(name: str) -> None:
    """Declare a lock class innermost: acquiring any tracked lock while
    holding it is a violation (idempotent; safe to call at import)."""
    with _state._mu:
        _state.leaves.add(name)


#: (module, attribute, name, kind) of module-level locks created at import
#: time — install() rebuilds them so whole-process checked mode is possible
_GLOBAL_LOCKS: list[tuple[object, str, str, str]] = []
_GLOBAL_LOCKS_MU = threading.Lock()
_FACTORIES = {"lock": make_lock, "rlock": make_rlock,
              "condition": make_condition}


def register_global_lock(module, attr: str, name: str,
                         kind: str = "lock") -> None:
    """Declare a module-global lock, or the lock of a process-wide
    singleton made at import (``module`` is then the instance), for
    :func:`install` rebinding. The owner keeps using ``<module>.<attr>``;
    install() swaps the object, so callers must always read it through the
    owner (the accessor-function pattern ``mutation_lock()`` does this
    naturally)."""
    if kind not in _FACTORIES:
        raise ValueError(f"unknown lock kind {kind!r}")
    with _GLOBAL_LOCKS_MU:
        _GLOBAL_LOCKS.append((module, attr, name, kind))


def install(enabled: bool) -> None:
    """Flip the process into/out of checked mode: sets the
    ``debug_locks`` knob, rebuilds every registered module-level lock, and
    resets recorded state. Only call when the registered locks are not
    held (test setup/teardown, process boot) — swapping a held lock would
    orphan its waiters."""
    Global.debug_locks = bool(enabled)
    with _GLOBAL_LOCKS_MU:
        regs = list(_GLOBAL_LOCKS)
    for module, attr, name, kind in regs:
        setattr(module, attr, _FACTORIES[kind](name))
    reset()


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------

def cycles() -> list[dict]:
    with _state._mu:
        return list(_state.cycles)


def leaf_violations() -> list[dict]:
    with _state._mu:
        return list(_state.leaf_violations)


def report() -> dict:
    """Everything recorded since the last reset, JSON-ready."""
    with _state._mu:
        return {
            "enabled": bool(Global.debug_locks),
            "edges": [{"from": a, "to": b, "thread": e["thread"]}
                      for (a, b), e in sorted(_state.edges.items())],
            "leaves": sorted(_state.leaves),
            "cycles": list(_state.cycles),
            "leaf_violations": list(_state.leaf_violations),
        }


def reset() -> None:
    """Clear the graph and findings (leaf declarations persist — they are
    architecture, not observations)."""
    with _state._mu:
        _state.edges.clear()
        _state.cycles.clear()
        _state.leaf_violations.clear()
        _state.seen_cycle_keys.clear()
