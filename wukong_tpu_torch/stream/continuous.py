"""Continuous SPARQL: standing queries evaluated incrementally per epoch.

The Wukong+S core (SOSP'17): a registered BGP query is not re-run from
scratch when new triples arrive — each ingest epoch is evaluated
*semi-naively*. For a query with patterns P1..Pn and an epoch delta D
(the batch's new triples), the new results are exactly

    union over i of  eval(P1..Pi-1, Pi|D, Pi+1..Pn)  against the merged graph

because every new result uses at least one new triple, and the term that
pins pattern i to D covers all results whose (lexicographically first) new
triple matches Pi. Each term is executed by seeding the binding table with
Pi's matches in D — the *frontier* — and running the remaining patterns
through the ordinary engine kernels (known_to_unknown & friends) against
the merged CSR, exactly the delta-join shape GPU Datalog engines use for
semi-naive iteration (arXiv:2501.13051, arXiv:2604.20073). Terms are
planned ONCE at registration (the heuristic planner's ``seed_known`` mode
orders the remaining patterns off the frontier bindings); per epoch only
the seed tables change.

Results are maintained as a set of projected rows; per-epoch additions are
emitted to an append-only per-query sink (:class:`ResultDelta`). Windowed
queries (windows.py) evaluate against a private window store and emit
retraction deltas when epochs retire.

Push-mode sinks: ``register(..., callback=fn)`` invokes
``fn(delta)`` for every committed :class:`ResultDelta` next to the pull
``poll()`` surface. Callback exceptions are contained by the per-query
barrier (the epoch stays committed, the pull sink stays correct) and
surface as the ``wukong_stream_callback_errors_total`` metric plus the
query's ``callback_errors`` counter.

Supported standing-query shapes: BGPs with FILTERs, DISTINCT-style set
semantics, const/var subjects and objects, type patterns. Rejected at
registration (structured errors, never silent wrong answers): UNION,
OPTIONAL, variable predicates, attribute patterns, ORDER/LIMIT/OFFSET,
cartesian (disconnected) products.

The port's copy of the JAX package's stream/continuous.py. As there, delta
queries run on a host ``CPUEngine`` over the host partition (inline or on
the engine pool's stream lane); the device part is the epoch frontier
(:func:`device_seed_extract`, :func:`device_seed_masks`): every term's
row mask and deduped seed rows as one batched torch computation on the
engine's ``device`` (join/kernels.py ``seed_extract``), copied back once an
epoch. Unlike the JAX functions, which catch any exception and latch the
host masks, these degrade to the host masks only on ``DeviceRangeError``
(ids past int32) and on the knobs (``join_device`` / ``template_device``
``host``, the amortization threshold): any other error, a CUDA one among
them, reaches the caller.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np

from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs.metrics import get_registry
from wukong_tpu_torch.obs.trace import current as current_trace
from wukong_tpu_torch.planner.heuristic import heuristic_plan, plan_seeded_group
from wukong_tpu_torch.sparql.ir import NO_RESULT, Pattern, PatternGroup, SPARQLQuery
from wukong_tpu_torch.types import IN, AttrType
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError, assert_ec
from wukong_tpu_torch.utils.logger import log_warn
from wukong_tpu_torch.utils.timer import get_usec

# bound on waiting for a stream-lane delta term when the deadline knob is
# off — the lane is strictly lowest-priority, so a saturated pool could
# otherwise block the feed forever
STREAM_WAIT_TIMEOUT_S = 60.0

_M_CB_ERRORS = get_registry().counter(
    "wukong_stream_callback_errors_total",
    "Push-sink callback invocations that raised (contained)")
# device-batched frontier seeding: outcome=fused when one batched device
# computation produced every term's seed rows, device when it produced
# every term's row mask, host when the epoch was under the amortization
# threshold / the knob pinned host, fallback when the ids exceeded int32
# and the per-term NumPy masks served instead
_M_SEED_BATCH = get_registry().counter(
    "wukong_stream_seed_batch_total",
    "Per-epoch frontier seeding by route", labels=("outcome",))


@dataclass
class ResultDelta:
    """One sink entry: rows added (sign=+1) or retracted (sign=-1) at epoch."""

    epoch: int
    sign: int
    rows: np.ndarray  # [k, len(required_vars)], row-sorted

    def __repr__(self):
        s = "+" if self.sign > 0 else "-"
        return f"ResultDelta(epoch={self.epoch}, {s}{len(self.rows)} rows)"


def _triplewise(pat: Pattern) -> tuple[int, int, int]:
    """(s, p, o) in *triple* terms: a direction-IN pattern walks in-edges of
    its subject slot, i.e. the stored triple is (object, p, subject)."""
    if pat.direction == IN:
        return pat.object, pat.predicate, pat.subject
    return pat.subject, pat.predicate, pat.object


def match_delta(pat: Pattern, triples: np.ndarray, row_mask=None):
    """Frontier of one pattern over an epoch batch: (vars, seed_table).

    vars lists the pattern's variable endpoints (triple order, deduped);
    seed_table is the [k, len(vars)] distinct bindings drawn from the batch
    rows matching the pattern's constants. Empty batch -> (vars, 0-row).
    ``row_mask`` supplies a precomputed batch-row match mask (the
    device-batched seeding path) — the host mask passes are then skipped.
    """
    ts, tp, to = _triplewise(pat)
    s, p, o = triples[:, 0], triples[:, 1], triples[:, 2]
    mask = row_mask if row_mask is not None else (p == tp)
    cols = []
    vars_: list[int] = []
    for end, col in ((ts, s), (to, o)):
        if end >= 0:
            if row_mask is None:
                mask = mask & (col == end)
        elif end in vars_:  # repeated var (?x p ?x): equality, one column
            if row_mask is None:
                mask = mask & (s == o)
        else:
            vars_.append(end)
            cols.append(col)
    if not vars_:
        # fully-const pattern: no frontier bindings to seed (rejected at
        # registration for standing queries)
        return vars_, np.empty((0, 0), dtype=np.int64)
    seed = np.stack([c[mask] for c in cols], axis=1).astype(np.int64)
    if len(seed):
        seed = np.unique(seed, axis=0)
    return vars_, seed


def _term_specs(patterns: list):
    """Per-term spec arrays [T] (predicate, subject-const, object-const,
    repeated-var equality; -1 marks a wildcard endpoint), matching
    match_delta's host masks."""
    T = len(patterns)
    tp = np.empty(T, dtype=np.int64)
    ts = np.empty(T, dtype=np.int64)
    to = np.empty(T, dtype=np.int64)
    eq = np.zeros(T, dtype=bool)
    for i, pat in enumerate(patterns):
        ps, pp, po = _triplewise(pat)
        tp[i] = pp
        ts[i] = ps if ps >= 0 else -1
        to[i] = po if po >= 0 else -1
        eq[i] = ps < 0 and ps == po
    return tp, ts, to, eq


def _seed_route(knob_name: str, patterns: list, n: int, owner,
                latch: str) -> bool:
    """Whether an epoch's frontier runs on the device: not when the knob
    pins host, the epoch is empty, the owner latched host after a
    DeviceRangeError, or (under auto) the epoch's term-rows are under the
    ``join_device_min_candidates`` amortization threshold."""
    knob = str(getattr(Global, knob_name)).strip().lower()
    return not (knob == "host" or not patterns or n == 0
                or (owner is not None and getattr(owner, latch, False))
                or (knob != "device"
                    and n * len(patterns)
                    < max(int(Global.join_device_min_candidates), 1)))


def _upload_batch(triples: np.ndarray, specs, device):
    """The padded epoch columns and the term specs as int32 tensors on
    ``device``; DeviceRangeError when any value is outside int32."""
    import torch

    from wukong_tpu_torch.join.kernels import pad_pow2, to_device_i32

    n = len(triples)
    npad = pad_pow2(n)
    cols = np.full((3, npad), -1, dtype=np.int64)
    cols[:, :n] = triples.T
    dev = torch.device(device)
    s, p, o = (to_device_i32(cols[k], dev) for k in range(3))
    tp, ts, to = (to_device_i32(a, dev) for a in specs[:3])
    eq = torch.from_numpy(specs[3]).to(dev)
    return npad, s, p, o, tp, ts, to, eq


def _owner_device(owner, device):
    if device is not None:
        return device
    return getattr(owner, "device", None) or "cuda"


def device_seed_masks(patterns: list, triples: np.ndarray, owner=None,
                      device=None):
    """Per-term frontier row masks [T, N] as one batched torch computation
    on the device (join.kernels.seed_masks), copied back once: a large
    epoch's T per-term NumPy mask passes collapse into one padded
    dispatch. Returns None when the epoch is under the
    ``join_device_min_candidates`` amortization threshold, the
    ``join_device`` knob pins host, or the ids exceed int32
    (DeviceRangeError, latched host on ``owner`` so it is paid once) — the
    caller then runs the per-term host masks (byte-identical by the
    parity tests). Any other error reaches the caller. ``device`` defaults
    to the owner's (the ContinuousEngine's)."""
    from wukong_tpu_torch.join.kernels import DeviceRangeError, seed_masks

    n = len(triples)
    if not _seed_route("join_device", patterns, n, owner,
                       "_seed_device_broken"):
        _M_SEED_BATCH.labels(outcome="host").inc()
        return None
    try:
        npad, *args = _upload_batch(triples, _term_specs(patterns),
                                    _owner_device(owner, device))
    except DeviceRangeError as e:
        _M_SEED_BATCH.labels(outcome="fallback").inc()
        if owner is not None:
            owner._seed_device_broken = True
        log_warn(f"device seed batching degraded to host masks: {e!r}")
        return None
    t0 = get_usec()
    masks = seed_masks(*args)[:, :n].cpu().numpy()  # the one D2H copy
    del args
    _M_SEED_BATCH.labels(outcome="device").inc()
    from wukong_tpu_torch.obs.device import maybe_device_dispatch

    maybe_device_dispatch(
        "stream.seed_masks", template=f"t{len(patterns)}",
        live=n, capacity=npad, wall_us=get_usec() - t0,
        nbytes=3 * 4 * npad + 3 * 4 * len(patterns)
        + len(patterns) * (1 + npad))
    return masks


def _term_var_cols(pat: Pattern) -> tuple[list[int], int, int]:
    """A term's variable endpoints in match_delta's triple order, plus
    the stacked-(s, p, o) column each seed column draws from (``ca ==
    cb`` for a one-variable term — the duplicated column dedupes
    identically to a one-column np.unique)."""
    ts, _tp, to = _triplewise(pat)
    vars_: list[int] = []
    cols: list[int] = []
    for end, c in ((ts, 0), (to, 2)):
        if end < 0 and end not in vars_:
            vars_.append(end)
            cols.append(c)
    if not cols:
        return vars_, 0, 0
    if len(cols) == 1:
        return vars_, cols[0], cols[0]
    return vars_, cols[0], cols[1]


def device_seed_extract(patterns: list, triples: np.ndarray, owner=None,
                        device=None):
    """The fully device-evaluated stream frontier: one batched torch
    computation (join.kernels.seed_extract) evaluates every term's row mask
    AND its deduped seed rows, copied back once, dropping the per-term host
    ``np.stack``/``np.unique`` that ``device_seed_masks`` still leaves.
    Returns ``[(vars, seed)]`` in term order — byte-identical to
    :func:`match_delta` per the parity tests — or None when the
    ``template_device`` knob pins host, the epoch is under the
    amortization threshold, or the ids exceed int32 (DeviceRangeError,
    latched per owner on ``_seed_extract_broken``). Any other error
    reaches the caller. The device temporaries are released before it
    returns."""
    from wukong_tpu_torch.join.kernels import DeviceRangeError, seed_extract

    T = len(patterns)
    n = len(triples)
    if not _seed_route("template_device", patterns, n, owner,
                       "_seed_extract_broken"):
        return None
    metas: list[list[int]] = []
    ca = np.zeros(T, dtype=np.int64)
    cb = np.zeros(T, dtype=np.int64)
    for i, pat in enumerate(patterns):
        vars_, a, b = _term_var_cols(pat)
        ca[i], cb[i] = a, b
        metas.append(vars_)
    try:
        npad, *args = _upload_batch(triples, _term_specs(patterns),
                                    _owner_device(owner, device))
    except DeviceRangeError as e:
        _M_SEED_BATCH.labels(outcome="fallback").inc()
        if owner is not None:
            owner._seed_extract_broken = True
        log_warn(f"fused device seed extraction degraded to host: {e!r}")
        return None
    import torch

    t0 = get_usec()
    dev = args[0].device
    A, B, counts = seed_extract(*args, torch.from_numpy(ca).to(dev),
                                torch.from_numpy(cb).to(dev))
    # the one D2H copy of the epoch: both columns and the counts
    flat = torch.cat([A.reshape(-1), B.reshape(-1), counts]).cpu().numpy()
    del args, A, B, counts
    A = flat[:T * npad].reshape(T, npad)
    B = flat[T * npad:2 * T * npad].reshape(T, npad)
    counts = flat[2 * T * npad:]
    _M_SEED_BATCH.labels(outcome="fused").inc()
    from wukong_tpu_torch.obs.device import maybe_device_dispatch

    maybe_device_dispatch(
        "stream.seed_extract", template=f"t{T}",
        live=int(counts.sum()), capacity=npad * T,
        wall_us=get_usec() - t0,
        nbytes=3 * 4 * npad + 5 * 4 * T + 2 * 4 * T * npad)
    out = []
    for i, vars_ in enumerate(metas):
        k = int(counts[i])
        if not vars_:
            out.append((vars_, np.empty((0, 0), dtype=np.int64)))
        elif len(vars_) == 1:
            out.append((vars_, A[i, :k].astype(np.int64).reshape(-1, 1)))
        else:
            out.append((vars_, np.stack(
                [A[i, :k], B[i, :k]], axis=1).astype(np.int64)))
    return out


def _pattern_vars(patterns: list[Pattern]) -> set[int]:
    return {v for p in patterns for v in (p.subject, p.object) if v < 0}


@dataclass
class StandingQuery:
    qid: int
    proto: SPARQLQuery  # pristine parsed (unplanned) query, for refreshes
    text: str | None
    patterns: list  # parsed patterns, triple-wise orientation
    required_vars: list
    nvars: int
    term_plans: list  # term_plans[i] = planned remaining patterns for term i
    window: object = None  # EpochWindow | None
    wstore: object = None  # private window store (windowed queries only)
    base_triples: object = None  # static base included in window rebuilds
    support: object = None  # SupportIndex (windowed queries only)
    callback: object = None  # push-mode sink: fn(ResultDelta), exceptions contained
    tenant: str = "default"  # owner — delta queries inherit it (admission)
    seen: set = field(default_factory=set)
    sink: list = field(default_factory=list)  # list[ResultDelta]
    epochs_evaluated: int = 0
    degraded_epochs: int = 0  # epochs where >=1 term failed (missed results)
    callback_errors: int = 0  # push-sink invocations that raised (contained)
    last_eval_us: int = 0

    def result_set(self) -> np.ndarray:
        """Current standing result: row-sorted distinct projected rows."""
        if not self.seen:
            return np.empty((0, len(self.required_vars)), dtype=np.int64)
        return np.asarray(sorted(self.seen), dtype=np.int64)


class ContinuousEngine:
    """Standing-query registry + per-epoch semi-naive evaluator.

    ``engine`` executes delta queries inline (default: a CPUEngine over
    ``gstore``); ``pool`` routes them through the host engine pool's stream
    lane instead (scheduler.py), interleaving with one-shot queries under
    the same deadline/budget machinery. ``device`` is where the epoch
    frontier runs (the card unless the caller asks for the CPU).
    """

    def __init__(self, gstore, str_server=None, engine=None, pool=None,
                 monitor=None, device="cuda"):
        self.g = gstore
        self.str_server = str_server
        self.device = device
        if engine is None:
            from wukong_tpu_torch.engine.cpu import CPUEngine

            engine = CPUEngine(gstore, str_server)
        self.engine = engine
        self.pool = pool
        self.monitor = monitor
        self.queries: dict[int, StandingQuery] = {}
        self._next_qid = 0
        self.last_epoch = 0  # highest epoch evaluated (stamps snapshots)
        self._abandoned: list = []  # timed-out pool handles to reap later

    def _reap_abandoned(self) -> None:
        """Discard completions whose wait timed out on an earlier epoch
        (poll() skips stream-lane qids, so only wait() can free them)."""
        for h in self._abandoned[:]:
            try:
                self.pool.wait(h, timeout=0)
            except TimeoutError:
                continue  # still running; try again next epoch
            self._abandoned.remove(h)

    # ------------------------------------------------------------------
    # registration
    # ------------------------------------------------------------------
    def register(self, query, window=None, base_triples=None,
                 callback=None, tenant=None) -> int:
        """Register a standing query (SPARQL text or parsed SPARQLQuery).

        ``window`` (WindowSpec) scopes it to the live epochs only, evaluated
        against a private window store; ``base_triples`` [N,3] are static
        triples included in every window rebuild; ``callback`` is a
        push-mode sink invoked as ``callback(delta)`` per committed
        ResultDelta (including the registration snapshot) — exceptions are
        contained and surfaced as a metric, never as a poisoned commit;
        ``tenant`` names the owner — its per-epoch delta queries are
        stamped ``owner_tenant`` so the admission plane's weighted-fair
        scheduling runs this maintenance work at the OWNER's weight
        (priority inheritance), not the anonymous stream lane's.
        """
        if callback is not None and not callable(callback):
            raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                              "callback must be callable")
        text = None
        if isinstance(query, str):
            from wukong_tpu_torch.sparql.parser import Parser

            text = query
            query = Parser(self.str_server).parse(query)
        self._validate(query)
        patterns = [copy.copy(p) for p in query.pattern_group.patterns]
        term_plans = [self._plan_term(patterns, i) for i in range(len(patterns))]
        # the full-query plan must also exist (window refreshes re-run it)
        heuristic_plan(copy.deepcopy(query))
        qid = self._next_qid
        self._next_qid += 1
        sq = StandingQuery(
            qid=qid, proto=copy.deepcopy(query), text=text, patterns=patterns,
            required_vars=list(query.result.required_vars),
            nvars=query.result.nvars, term_plans=term_plans,
            callback=callback,
            tenant=(tenant or getattr(query, "tenant", None) or "default"))
        if window is not None:
            from wukong_tpu_torch.stream.windows import (
                EpochWindow,
                SupportIndex,
                WindowSpec,
            )

            if not isinstance(window, WindowSpec):
                raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                                  "window must be a WindowSpec")
            sq.window = EpochWindow(spec=window)
            sq.support = SupportIndex()
            if base_triples is not None:
                sq.base_triples = np.asarray(base_triples, dtype=np.int64)
            sq.wstore = self._build_window_store(sq)
        # initial snapshot: results already derivable at registration time
        # (from the base graph, or base_triples for windowed queries) seed
        # the standing set — epochs only ever add deltas on top of it
        self._snapshot(sq, self.last_epoch,
                       sq.wstore if sq.window is not None else self.g)
        if sq.support is not None:
            # the registration window is empty, so everything seen so far
            # derives from base_triples alone — permanent support (base
            # triples never retire)
            sq.support.note_base(sq.seen)
        self.queries[qid] = sq
        return qid

    def unregister(self, qid: int) -> None:
        assert_ec(qid in self.queries, ErrorCode.UNKNOWN_SUB,
                  f"unknown standing query {qid}")
        del self.queries[qid]

    def poll(self, qid: int, since_epoch: int = -1) -> list[ResultDelta]:
        """Append-only deltas with epoch > since_epoch (the Wukong+S
        client-pull surface). The default returns the full history including
        the registration-time snapshot — which is stamped with the epoch
        current at registration (0 before any feed), so a cursor of 0 would
        hide it for early registrants but not late ones."""
        assert_ec(qid in self.queries, ErrorCode.UNKNOWN_SUB,
                  f"unknown standing query {qid}")
        return [d for d in self.queries[qid].sink if d.epoch > since_epoch]

    def result_set(self, qid: int) -> np.ndarray:
        assert_ec(qid in self.queries, ErrorCode.UNKNOWN_SUB,
                  f"unknown standing query {qid}")
        return self.queries[qid].result_set()

    def prune(self, qid: int, upto_epoch: int) -> int:
        """Free consumed sink history: drop deltas with epoch <= upto_epoch
        (the client's poll cursor). The standing result set is unaffected —
        only the replayable history shrinks. Returns entries dropped.

        Sinks are otherwise unbounded (truncating silently would hand late
        pollers wrong answers), so long-running clients should prune behind
        their cursor."""
        assert_ec(qid in self.queries, ErrorCode.UNKNOWN_SUB,
                  f"unknown standing query {qid}")
        sq = self.queries[qid]
        kept = [d for d in sq.sink if d.epoch > upto_epoch]
        dropped = len(sq.sink) - len(kept)
        sq.sink = kept
        return dropped

    # ------------------------------------------------------------------
    # checkpoint surface (runtime/recovery.py)
    # ------------------------------------------------------------------
    def export_state(self) -> dict:
        """Picklable snapshot of the standing-query registry: pristine
        protos, per-term plans, standing result sets, sink history, and
        window live-epoch bookkeeping. Window *stores* are excluded — they
        rebuild deterministically from the live triples on import. Push
        callbacks are process-local closures and cannot survive a restart;
        they are recorded only as a flag so import can warn."""
        qs = []
        for sq in self.queries.values():
            qs.append({
                "qid": sq.qid, "proto": sq.proto, "text": sq.text,
                "patterns": sq.patterns,
                "required_vars": sq.required_vars, "nvars": sq.nvars,
                "term_plans": sq.term_plans,
                "window": ((sq.window.spec.size, sq.window.spec.slide)
                           if sq.window is not None else None),
                "window_live": (list(sq.window.live)
                                if sq.window is not None else None),
                "base_triples": sq.base_triples,
                "seen": sq.seen, "sink": sq.sink,
                "epochs_evaluated": sq.epochs_evaluated,
                "degraded_epochs": sq.degraded_epochs,
                "callback_errors": sq.callback_errors,
                "had_callback": sq.callback is not None,
            })
        return {"next_qid": self._next_qid, "last_epoch": self.last_epoch,
                "queries": qs}

    def import_state(self, state: dict) -> None:
        """Restore a registry snapshot (replacing the current registry);
        window stores are rebuilt from the checkpointed live epochs."""
        from wukong_tpu_torch.stream.windows import EpochWindow, WindowSpec

        self.queries.clear()
        self._next_qid = int(state["next_qid"])
        self.last_epoch = int(state["last_epoch"])
        for d in state["queries"]:
            sq = StandingQuery(
                qid=d["qid"], proto=d["proto"], text=d["text"],
                patterns=d["patterns"], required_vars=d["required_vars"],
                nvars=d["nvars"], term_plans=d["term_plans"],
                base_triples=d["base_triples"], seen=d["seen"],
                sink=d["sink"], epochs_evaluated=d["epochs_evaluated"],
                degraded_epochs=d["degraded_epochs"],
                callback_errors=d["callback_errors"])
            if d["window"] is not None:
                from wukong_tpu_torch.stream.windows import SupportIndex

                sq.window = EpochWindow(spec=WindowSpec(*d["window"]),
                                        live=list(d["window_live"]))
                sq.wstore = self._build_window_store(sq)
                # support evidence is process-local and rebuilt empty: the
                # retirement path never DEPENDS on it for correctness (the
                # overdelete evaluation drives candidates), it only loses
                # its fast paths until evidence re-accumulates
                sq.support = SupportIndex()
            if d["had_callback"]:
                log_warn(f"standing query {sq.qid}: push callback did not "
                         "survive the restart — re-register the sink")
            self.queries[sq.qid] = sq

    def _validate(self, q: SPARQLQuery) -> None:
        pg = q.pattern_group
        if pg.unions or pg.optional:
            raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                              "standing queries support BGP+FILTER only "
                              "(no UNION/OPTIONAL)")
        if q.orders or q.limit >= 0 or q.offset > 0:
            raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                              "ORDER/LIMIT/OFFSET have no incremental "
                              "semantics; standing results are sets")
        if not pg.patterns:
            raise WukongError(ErrorCode.UNKNOWN_PATTERN,
                              "standing query has no patterns")
        for p in pg.patterns:
            if p.predicate < 0:
                raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                                  "variable-predicate patterns are not "
                                  "incrementally evaluable here")
            if p.pred_type != int(AttrType.SID_t):
                raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                                  "attribute patterns are not supported in "
                                  "standing queries")
            if p.subject >= 0 and p.object >= 0:
                raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                                  "fully-constant pattern has no frontier")
        missing = [v for v in q.result.required_vars
                   if v not in _pattern_vars(pg.patterns)]
        if missing:
            raise WukongError(ErrorCode.NO_REQUIRED_VAR,
                              f"projection vars {missing} not bound by the BGP")

    def _plan_term(self, patterns: list[Pattern], i: int) -> list[Pattern]:
        """Order/orient the remaining patterns of term i off the frontier
        bindings of pattern i — done once at registration."""
        seed = {v for v in (_triplewise(patterns[i])[0],
                            _triplewise(patterns[i])[2]) if v < 0}
        pg = PatternGroup(
            patterns=[copy.copy(p) for j, p in enumerate(patterns) if j != i])
        # plan_seeded_group is THE anchorability test (planner.heuristic):
        # True plans in place off the frontier bindings (raising
        # UNKNOWN_PLAN if stuck); False means a disjoint remainder
        if pg.patterns and not plan_seeded_group(pg, seed):
            raise WukongError(
                ErrorCode.UNSUPPORTED_SHAPE,
                f"pattern {patterns[i]!r} shares no variable with the rest "
                "of the BGP (cartesian product is not incrementally "
                "evaluable)")
        return pg.patterns

    # ------------------------------------------------------------------
    # per-epoch evaluation
    # ------------------------------------------------------------------
    def on_epoch(self, epoch: int, triples: np.ndarray, ts=None) -> int:
        """Evaluate every standing query against one committed epoch.

        Called by the ingestor AFTER the batch is inserted into the main
        store. Returns total evaluation microseconds across queries.
        """
        self.last_epoch = max(self.last_epoch, int(epoch))
        total_us = 0
        tr = current_trace()  # the epoch trace, when ingest is traced
        queries = list(self.queries.values())
        # every standing query's frontier for this epoch in ONE batched
        # device computation (one copy back), outside the per-query
        # containment below: a device error reaches the committer
        flat: list = []
        for sq in queries:
            flat.extend(sq.patterns)
        all_seeds = self._frontier(flat, triples) if flat else []
        lo = 0
        for sq in queries:
            seeds = all_seeds[lo:lo + len(sq.patterns)]
            lo += len(sq.patterns)
            t0 = get_usec()
            sp = (tr.start_span("stream.eval_query", qid=sq.qid)
                  if tr is not None else None)
            try:
                if sq.window is not None:
                    self._on_epoch_windowed(sq, epoch, triples, seeds)
                else:
                    self._delta_eval(sq, epoch, triples, self.engine,
                                     seeds)
            except Exception as e:
                # the main store already committed this epoch — one query's
                # failure must not escape the commit or starve the others.
                # Its results for this epoch are missing: degraded, never
                # wrong, and never a poisoned ingest path.
                sq.degraded_epochs += 1
                log_warn(f"standing query {sq.qid}: epoch {epoch} "
                         f"evaluation failed: {e!r}")
            sq.epochs_evaluated += 1
            sq.last_eval_us = get_usec() - t0
            if sp is not None:
                tr.end_span(sp, degraded_epochs=sq.degraded_epochs)
            total_us += sq.last_eval_us
        return total_us

    def _frontier(self, patterns: list, triples: np.ndarray) -> list:
        """``[(vars, seed)]`` for every pattern over an epoch batch: the
        fused device frontier first (mask + unique seed rows in one
        batched computation); the mask-only batch and the per-term host
        masks remain the byte-identical fallbacks, in that order."""
        seeds = device_seed_extract(patterns, triples, owner=self)
        if seeds is not None:
            return seeds
        masks = device_seed_masks(patterns, triples, owner=self)
        return [match_delta(pat, triples,
                            row_mask=masks[i] if masks is not None else None)
                for i, pat in enumerate(patterns)]

    def _delta_eval(self, sq: StandingQuery, epoch: int, triples: np.ndarray,
                    engine, seeds: list | None = None) -> None:
        """One semi-naive pass: seed each term's frontier from the batch
        (``seeds``, the epoch's frontier for this query, else computed
        here), run the planned remainder against the merged store, merge
        new rows."""
        from wukong_tpu_torch.runtime.resilience import Deadline

        new_rows: set = set()
        degraded = False
        jobs = []  # (query, term index)
        if seeds is None:
            seeds = self._frontier(sq.patterns, triples)
        for i in range(len(sq.patterns)):
            vars_, seed = seeds[i]
            if len(seed) == 0:
                continue
            q = self._make_delta_query(sq, i, vars_, seed)
            q.deadline = Deadline.from_config()
            jobs.append((q, i))
        if self.pool is not None and engine is self.engine:
            self._reap_abandoned()
            # stream lane: interleave with one-shot queries on the pool.
            # The wait is bounded — the lane is strictly lowest-priority,
            # so sustained interactive load could otherwise starve it and
            # block the feed indefinitely
            timeout = ((Global.query_deadline_ms / 1e3)
                       if Global.query_deadline_ms > 0
                       else STREAM_WAIT_TIMEOUT_S)
            handles = [(self.pool.submit(q, lane="stream"), i)
                       for q, i in jobs]
            outs = []
            for h, i in handles:
                try:
                    outs.append((self.pool.wait(h, timeout=timeout), i))
                except TimeoutError as e:
                    # leave the completion claimable and reap it on a later
                    # epoch; this term's results are missing for this epoch
                    self._abandoned.append(h)
                    outs.append((e, i))
        else:
            outs = []
            for q, i in jobs:
                try:
                    outs.append((engine.execute(q, from_proxy=False), i))
                except Exception as e:  # mirror the pool path's contract
                    outs.append((e, i))
        for out, i in outs:
            if isinstance(out, Exception):
                degraded = True
                log_warn(f"standing query {sq.qid}: term {i} failed at "
                         f"epoch {epoch}: {out!r}")
                continue
            if out.result.status_code != ErrorCode.SUCCESS:
                # deadline/budget expiry or engine error: results of this
                # term are missing for this epoch — degraded, never wrong
                degraded = True
                log_warn(f"standing query {sq.qid}: term {i} degraded at "
                         f"epoch {epoch}: {out.result.status_code.name}")
                continue
            try:
                new_rows |= self._project(out.result, sq.required_vars)
            except WukongError as e:
                degraded = True
                log_warn(f"standing query {sq.qid}: term {i} projection "
                         f"failed at epoch {epoch}: {e!r}")
        if degraded:
            sq.degraded_epochs += 1
        if sq.support is not None and not degraded:
            # per-result support: this epoch's evidence is EVERY row its
            # delta derived (not just the fresh ones — an already-seen row
            # re-derived here is kept alive by this epoch too)
            sq.support.note_epoch(epoch, new_rows)
        fresh = new_rows - sq.seen
        if fresh:
            sq.seen |= fresh
            self._push(sq, ResultDelta(
                epoch=epoch, sign=+1,
                rows=np.asarray(sorted(fresh), dtype=np.int64)))

    def _push(self, sq: StandingQuery, delta: ResultDelta) -> None:
        """Commit one delta: append to the pull sink, then invoke the
        push-mode callback (if any) with its exception contained — a bad
        subscriber degrades to a metric, never into the epoch commit."""
        sq.sink.append(delta)
        if sq.callback is None:
            return
        try:
            sq.callback(delta)
        except Exception as e:
            sq.callback_errors += 1
            _M_CB_ERRORS.inc()
            log_warn(f"standing query {sq.qid}: push callback failed at "
                     f"epoch {delta.epoch}: {e!r}")

    def _make_delta_query(self, sq: StandingQuery, i: int, vars_: list[int],
                          seed: np.ndarray) -> SPARQLQuery:
        q = SPARQLQuery()
        q.pattern_group = PatternGroup(
            patterns=list(sq.term_plans[i]),
            filters=sq.proto.pattern_group.filters)
        res = q.result
        res.nvars = sq.nvars
        for col, v in enumerate(vars_):
            res.add_var2col(v, col)
        res.set_table(seed)
        res.blind = True  # engines skip final-process; we project ourselves
        # priority inheritance: the delta runs AS maintenance for its
        # owner — the pool's fair sub-lane schedules it at that weight
        q.owner_tenant = sq.tenant
        return q

    @staticmethod
    def _project(res, required_vars: list[int]) -> set:
        cols = [res.var2col(v) for v in required_vars]
        if any(c == NO_RESULT for c in cols):
            if res.nrows == 0:
                return set()
            raise WukongError(ErrorCode.NO_REQUIRED_VAR,
                              "standing-query projection var unbound")
        if res.nrows == 0:
            return set()
        return set(map(tuple, res.table[:, cols].tolist()))

    # ------------------------------------------------------------------
    # windowed queries
    # ------------------------------------------------------------------
    def _build_window_store(self, sq: StandingQuery):
        from wukong_tpu_torch.store.gstore import build_partition

        parts = [sq.window.live_triples()]
        if sq.base_triples is not None:
            parts.insert(0, sq.base_triples)
        triples = np.concatenate(parts) if len(parts) > 1 else parts[0]
        return build_partition(triples, 0, 1)

    def _on_epoch_windowed(self, sq: StandingQuery, epoch: int,
                           triples: np.ndarray, seeds: list) -> None:
        from wukong_tpu_torch.engine.cpu import CPUEngine
        from wukong_tpu_torch.runtime.resilience import retry_call
        from wukong_tpu_torch.store.dynamic import insert_triples

        retired = sq.window.add(epoch, triples)
        if retired:
            # the retired triples' frontier, before the containment below
            # (a device error reaches the committer, as on_epoch's)
            rseeds = self._frontier(
                sq.patterns, np.concatenate([t for _, t in retired]))
            try:
                self._retire_incremental(sq, epoch, triples, retired, seeds,
                                         rseeds)
            except Exception as e:
                # a failed retirement step must not strand half-updated
                # bookkeeping — degrade to the old full refresh (rebuild +
                # re-run + diff): correct, just not incremental
                log_warn(f"standing query {sq.qid}: incremental "
                         f"retirement at epoch {epoch} degraded to full "
                         f"refresh: {e!r}")
                sq.wstore = self._build_window_store(sq)
                if sq.support is not None:
                    sq.support.reset()
                self._snapshot(sq, epoch, sq.wstore)
            return
        try:
            # the private window-store insert is a dynamic.insert fault
            # site like the main commit; dedup makes replays idempotent,
            # so retry the same way
            retry_call(lambda: insert_triples(sq.wstore, triples,
                                              dedup=True, check_ids=False),
                       site="dynamic.insert")
            self._delta_eval(sq, epoch, triples,
                             CPUEngine(sq.wstore, self.str_server), seeds)
        except Exception as e:
            # the main store already committed this epoch — a window-side
            # failure must not escape and strand half-updated bookkeeping.
            # Rebuild from the recorded live epochs and diff: a full
            # refresh, correct but not incremental.
            log_warn(f"standing query {sq.qid}: windowed epoch {epoch} "
                     f"degraded to full refresh: {e!r}")
            sq.wstore = self._build_window_store(sq)
            if sq.support is not None:
                sq.support.reset()
            self._snapshot(sq, epoch, sq.wstore)

    def _retire_incremental(self, sq: StandingQuery, epoch: int,
                            triples: np.ndarray, retired: list, seeds: list,
                            rseeds: list) -> None:
        """Per-result support-counted retraction (windows.py module doc):
        overdelete candidates from a delta evaluation seeded with the
        RETIRED triples, base-support fast path, targeted re-derivation
        over the rebuilt survivor store, then normal delta evaluation of
        the arriving epoch. Retraction work scales with the rows touching
        retired data, not with the standing result."""
        from wukong_tpu_torch.engine.cpu import CPUEngine

        pre_store = sq.wstore  # base + previously-live epochs
        retired_triples = np.concatenate([t for _, t in retired])
        # 1. overdelete: every row with >=1 derivation using retired data
        cand = self._eval_terms_inline(
            sq, retired_triples, CPUEngine(pre_store, self.str_server),
            rseeds)
        cand &= sq.seen
        # 2. support: evidence-exhausted rows are candidates by
        # construction (safety net, normally a subset of the overdelete);
        # base-supported rows never retract and skip verification
        if sq.support is not None:
            cand |= sq.support.retire([e for e, _ in retired]) & sq.seen
            cand -= sq.support.base
        # 3. survivor store INCLUDING the arriving epoch: a candidate row
        # re-derivable through the new triples must not flicker -/+ in
        # one epoch
        sq.wstore = self._build_window_store(sq)
        # 4. re-derive the candidates; the rest of the standing set keeps
        # all its derivations and is untouched
        dead = (cand - self._verify_rows(sq, cand)) if cand else set()
        if dead:
            sq.seen -= dead
            self._push(sq, ResultDelta(
                epoch=epoch, sign=-1,
                rows=np.asarray(sorted(dead), dtype=np.int64)))
        # 5. additions from the arriving epoch (already in the store)
        self._delta_eval(sq, epoch, triples,
                         CPUEngine(sq.wstore, self.str_server), seeds)

    def _eval_terms_inline(self, sq: StandingQuery,
                           triples: np.ndarray, engine,
                           seeds: list | None = None) -> set:
        """All projected rows derivable with >=1 triple from ``triples``
        against ``engine``'s store (the semi-naive term union, inline).
        Raises on any term failure — the caller falls back to a full
        refresh rather than trusting an incomplete candidate set."""
        rows: set = set()
        if seeds is None:
            seeds = self._frontier(sq.patterns, triples)
        for i in range(len(sq.patterns)):
            vars_, seed = seeds[i]
            if len(seed) == 0:
                continue
            q = self._make_delta_query(sq, i, vars_, seed)
            out = engine.execute(q, from_proxy=False)
            if out.result.status_code != ErrorCode.SUCCESS:
                raise WukongError(out.result.status_code,
                                  f"retirement term {i} failed")
            rows |= self._project(out.result, sq.required_vars)
        return rows

    def _verify_rows(self, sq: StandingQuery, cand: set) -> set:
        """Which candidate projected rows still have a full derivation
        over the current window store: seed the BGP with the candidate
        bindings (planned off the projection vars) and re-derive."""
        from wukong_tpu_torch.engine.cpu import CPUEngine
        from wukong_tpu_torch.planner.heuristic import plan_seeded_group

        if not cand:
            return set()
        pg = PatternGroup(
            patterns=[copy.copy(p) for p in sq.proto.pattern_group.patterns],
            filters=sq.proto.pattern_group.filters)
        if not plan_seeded_group(pg, set(sq.required_vars)):
            # cannot anchor on the projection vars (registration rejects
            # cartesian shapes, so this cannot happen) — caller refreshes
            raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                              "verification not anchorable")
        q = SPARQLQuery()
        q.pattern_group = pg
        res = q.result
        res.nvars = sq.nvars
        for col, v in enumerate(sq.required_vars):
            res.add_var2col(v, col)
        res.set_table(np.asarray(sorted(cand), dtype=np.int64))
        res.blind = True
        out = CPUEngine(sq.wstore, self.str_server).execute(
            q, from_proxy=False)
        if out.result.status_code != ErrorCode.SUCCESS:
            raise WukongError(out.result.status_code,
                              "candidate re-derivation failed")
        return self._project(out.result, sq.required_vars)

    def _snapshot(self, sq: StandingQuery, epoch: int, store) -> None:
        """Full (non-incremental) evaluation against ``store``; the diff
        against the current standing set is emitted as retraction/addition
        deltas. Used for the registration snapshot and window refreshes."""
        from wukong_tpu_torch.engine.cpu import CPUEngine

        q = copy.deepcopy(sq.proto)
        heuristic_plan(q)
        q.result.blind = True
        eng = CPUEngine(store, self.str_server)
        eng.execute(q, from_proxy=False)
        if q.result.status_code != ErrorCode.SUCCESS:
            sq.degraded_epochs += 1
            log_warn(f"standing query {sq.qid}: snapshot degraded at "
                     f"epoch {epoch}: {q.result.status_code.name}")
            return
        now = self._project(q.result, sq.required_vars)
        gone, fresh = sq.seen - now, now - sq.seen
        if gone:
            self._push(sq, ResultDelta(
                epoch=epoch, sign=-1,
                rows=np.asarray(sorted(gone), dtype=np.int64)))
        if fresh:
            self._push(sq, ResultDelta(
                epoch=epoch, sign=+1,
                rows=np.asarray(sorted(fresh), dtype=np.int64)))
        sq.seen = now
