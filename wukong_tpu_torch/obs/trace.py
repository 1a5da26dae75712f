"""Per-query trace context: trace id + span stack, propagated end to end.

The port's copy of the JAX package's obs/trace.py. A :class:`QueryTrace` is
created at proxy receipt (sampled by the ``enable_tracing`` /
``trace_sample_every`` knobs), carried on the query (``q.trace``, next to
``q.deadline``), and *activated* as a thread-ambient context while an
engine executes it, so layers that never see the query (fault sites, the
circuit breaker) attach events to the right trace.

Granularity: spans are opened per step (a device chain, a host step, a
pool wait, a fused dispatch), never per row. With tracing off every hook
is one ``getattr``/``None`` check.

On the card a span measures host time and holds no tensor: every
attribute is a Python ``int``, ``float``, ``str``, ``bool`` or ``None``
that the code already had on the host. The ``gpu.chain`` span closes after
the chain's one sync, so it covers the chain's device work; a span never
syncs to be "accurate" — per-kernel device time comes from the device
trace (obs/export.py ``maybe_device_trace``).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from collections import defaultdict

from wukong_tpu_torch.analysis.lockdep import declare_leaf, make_lock
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.utils.timer import get_usec

# span-stack locks only guard list/dict appends: innermost by construction
declare_leaf("trace.spans")

_tls = threading.local()
_trace_seq = itertools.count(1)
# one sampling sequence per kind: a burst of one kind must not skew the
# 1-in-N sampling of another
_sample_seqs: dict[str, itertools.count] = {}


class Span:
    """One timed operation inside a trace. ``end()`` is idempotent and may
    run on another thread than the start (a queue span ends on the engine
    thread that popped the query)."""

    __slots__ = ("name", "t0_us", "t1_us", "attrs", "events", "depth", "tid")

    def __init__(self, name: str, attrs: dict, depth: int, tid: int):
        self.name = name
        self.t0_us = get_usec()
        self.t1_us: int | None = None
        self.attrs = attrs
        self.events: list[tuple[int, str, dict]] = []
        self.depth = depth
        self.tid = tid

    def event(self, name: str, **attrs) -> None:
        self.events.append((get_usec(), name, attrs))

    def end(self, **attrs) -> None:
        if attrs:
            self.attrs.update(attrs)
        if self.t1_us is None:
            self.t1_us = get_usec()

    @property
    def dur_us(self) -> int:
        return (self.t1_us if self.t1_us is not None else get_usec()) - self.t0_us

    def to_dict(self) -> dict:
        return {"name": self.name, "t0_us": self.t0_us,
                "dur_us": self.dur_us, "depth": self.depth, "tid": self.tid,
                "attrs": dict(self.attrs),
                "events": [{"t_us": t, "name": n, "attrs": a}
                           for t, n, a in self.events]}


class QueryTrace:
    """Trace id + per-thread span stacks for one query (or fused dispatch).

    Spans append under a lock: the proxy thread, the pool thread running
    the query and the batcher's threads may all write."""

    def __init__(self, kind: str = "query", qid: int | None = None,
                 text: str | None = None, tenant: str = "default"):
        n = next(_trace_seq)
        self.trace_id = f"{kind[0]}{n:06d}"
        self.kind = kind
        self.qid = n if qid is None else qid
        self.text = text
        # tenant identity (obs/slo.py): the proxy stamps the bounded label
        # at admission, so every recorded or dumped trace names its tenant
        self.tenant = tenant
        self.t0_us = get_usec()
        self.t1_us: int | None = None
        self.status = "RUNNING"
        self.spans: list[Span] = []  # guarded by: _lock
        self._lock = make_lock("trace.spans")
        self._stacks: dict[int, list[Span]] = defaultdict(list)  # guarded by: _lock

    # ------------------------------------------------------------------
    def start_span(self, name: str, **attrs) -> Span:
        tid = threading.get_ident()
        with self._lock:
            stack = self._stacks[tid]
            sp = Span(name, attrs, depth=len(stack), tid=tid)
            stack.append(sp)
            self.spans.append(sp)
        return sp

    def end_span(self, sp: Span, **attrs) -> None:
        sp.end(**attrs)
        with self._lock:
            # pop from whichever thread's stack holds it (cross-thread ends)
            for stack in self._stacks.values():
                if sp in stack:
                    stack.remove(sp)
                    break

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        sp = self.start_span(name, **attrs)
        try:
            yield sp
        finally:
            self.end_span(sp)

    def event(self, name: str, **attrs) -> None:
        """Attach to the current thread's innermost open span, else to a
        zero-length span at trace level."""
        tid = threading.get_ident()
        with self._lock:
            stack = self._stacks.get(tid)
            if stack:
                stack[-1].events.append((get_usec(), name, attrs))
                return
            sp = Span(name, attrs, depth=0, tid=tid)
            sp.t1_us = sp.t0_us
            self.spans.append(sp)

    def finish(self, status: str = "SUCCESS") -> None:
        if self.t1_us is None:
            self.t1_us = get_usec()
            self.status = status

    # ------------------------------------------------------------------
    @property
    def dur_us(self) -> int:
        return (self.t1_us if self.t1_us is not None else get_usec()) - self.t0_us

    def step_summary(self) -> dict[str, dict]:
        """Span timings by name: {name: {count, total_us, max_us}}."""
        out: dict[str, dict] = {}
        for sp in self.spans:  # unguarded: reporting on finished traces
            d = out.setdefault(sp.name, {"count": 0, "total_us": 0, "max_us": 0})
            d["count"] += 1
            d["total_us"] += sp.dur_us
            d["max_us"] = max(d["max_us"], sp.dur_us)
        return out

    def event_names(self) -> list[str]:
        return [n for sp in self.spans for (_t, n, _a) in sp.events]  # unguarded: reporting on finished traces

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "kind": self.kind, "qid": self.qid,
                "tenant": self.tenant,
                "status": self.status, "t0_us": self.t0_us,
                "dur_us": self.dur_us,
                **({"text": self.text} if self.text else {}),
                "spans": [sp.to_dict() for sp in self.spans]}  # unguarded: reporting on finished traces


# ---------------------------------------------------------------------------
# ambient (thread-local) current trace
# ---------------------------------------------------------------------------

def current() -> QueryTrace | None:
    """The trace active on this thread, or None."""
    return getattr(_tls, "trace", None)


@contextlib.contextmanager
def activate(trace: QueryTrace | None):
    """Make ``trace`` this thread's ambient trace for the block."""
    prev = getattr(_tls, "trace", None)
    _tls.trace = trace
    try:
        yield trace
    finally:
        _tls.trace = prev


def trace_event(name: str, **attrs) -> None:
    """Record an event on the ambient trace; one getattr without one."""
    tr = getattr(_tls, "trace", None)
    if tr is not None:
        tr.event(name, **attrs)


def maybe_start_trace(kind: str = "query", qid: int | None = None,
                      text: str | None = None) -> QueryTrace | None:
    """A new QueryTrace per the ``enable_tracing`` + ``trace_sample_every``
    knobs, or None."""
    if not Global.enable_tracing:
        return None
    n = max(int(Global.trace_sample_every), 1)
    if n > 1:
        seq = _sample_seqs.get(kind)
        if seq is None:
            seq = _sample_seqs.setdefault(kind, itertools.count())
        if next(seq) % n:
            return None
    return QueryTrace(kind=kind, qid=qid, text=text)


# ---------------------------------------------------------------------------
# engine instrumentation helpers (the host and GPU engines share them)
# ---------------------------------------------------------------------------

def traced_execute(q, span_name: str, body, end_attrs=None):
    """Engine execute() wrapper: activate ``q.trace`` on this thread and
    span the whole execution. Untraced, it is one getattr then ``body()``.
    ``end_attrs()`` supplies the span's closing attributes."""
    tr = getattr(q, "trace", None)
    if tr is None:
        return body()
    with activate(tr):
        sp = tr.start_span(span_name)
        try:
            return body()
        finally:
            tr.end_span(sp, **(end_attrs() if end_attrs is not None else {}))


def traced_step(tr, q, span_name: str, fn) -> None:
    """One BGP-step span with rows in and out (the host ints the step
    keeps); ``tr is None`` runs ``fn()`` bare."""
    if tr is None:
        fn()
        return
    rows_in = q.result.nrows
    sp = tr.start_span(span_name, step=q.pattern_step,
                       pattern=repr(q.get_pattern()))
    try:
        fn()
    finally:
        tr.end_span(sp, rows_in=rows_in, rows_out=q.result.nrows)


# ---------------------------------------------------------------------------
# StepTrace: host-side per-label aggregates
# ---------------------------------------------------------------------------

class StepTrace:
    """Per-query step timings: step label -> [usec]."""

    def __init__(self):
        self.records: dict[str, list[int]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, label: str):
        t0 = get_usec()
        try:
            yield
        finally:
            self.records[label].append(get_usec() - t0)

    def summary(self) -> dict[str, dict]:
        out = {}
        for label, xs in self.records.items():
            out[label] = {"count": len(xs), "total_us": sum(xs),
                          "max_us": max(xs)}
        return out
