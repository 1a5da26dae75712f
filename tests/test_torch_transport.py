"""The port's transport seam (runtime/transport.py) against the JAX
package's, after tests/test_procs.py's framing, registry and transport
cases: frames byte for byte the JAX encoder's, the torn-tail contract,
structured FRAME_TOO_LARGE / TRANSPORT_CORRUPT errors, every declared op
round-tripping both sides and executing to the JAX op's arrays, loopback
and peerless-socket fetches, a dead peer's retry exhaustion, and
retry_call's breaker and deadline arguments. The wire cases run a small
frame server in a thread (the worker processes' serve loop is not ported):
injected faults at transport.connect / send / recv are retried through."""

import random
import socket
import threading

import numpy as np
import pytest

from wukong_tpu.runtime import transport as JT
from wukong_tpu.store.gstore import build_partition as jbp
from wukong_tpu_torch.analysis import lockdep
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.runtime import faults
from wukong_tpu_torch.runtime.faults import FaultPlan, FaultSpec
from wukong_tpu_torch.runtime.resilience import (
    CircuitBreaker,
    Deadline,
    retry_call,
)
from wukong_tpu_torch.runtime.transport import (
    FRAME_MAGIC,
    MESSAGE_REGISTRY,
    OP_HANDLERS,
    FrameDecoder,
    LoopbackTransport,
    SocketTransport,
    decode_frames,
    encode_frame,
    make_transport,
    pack_error,
    pack_message,
    pack_reply,
    run_op,
    unpack_message,
    unpack_reply,
)
from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.store.persist import gstore_digest, gstore_from_bytes
from wukong_tpu_torch.types import IN, OUT
from wukong_tpu_torch.utils.errors import (
    ErrorCode,
    FrameTooLarge,
    QueryTimeout,
    RetryExhausted,
    ShardUnavailable,
    TransportCorrupt,
    WukongError,
)

D = 4


@pytest.fixture(autouse=True, scope="module")
def _lockdep_checked():
    """The transport's per-connection locks are declared leaves: no order
    cycle and no leaf inversion through the module."""
    lockdep.install(True)
    yield
    try:
        assert lockdep.cycles() == [], lockdep.cycles()
        assert lockdep.leaf_violations() == [], lockdep.leaf_violations()
    finally:
        lockdep.install(False)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _triples():
    rng = np.random.default_rng(7)
    n = 400
    s = rng.integers(1000, 1400, size=n)
    p = rng.integers(2, 6, size=n)
    o = rng.integers(1000, 1400, size=n)
    return np.stack([s, p, o], axis=1).astype(np.int64)


@pytest.fixture(scope="module")
def stores():
    return [build_partition(_triples(), i, D) for i in range(D)]


@pytest.fixture(scope="module")
def g0(stores):
    return stores[0]


# ---------------------------------------------------------------------------
# framing (pure functions)
# ---------------------------------------------------------------------------

def test_frame_roundtrip_and_jax_bytes():
    payloads = [b"", b"x", b"hello wire" * 100]
    buf = b"".join(encode_frame(p) for p in payloads)
    assert buf == b"".join(JT.encode_frame(p) for p in payloads)
    out, consumed = decode_frames(buf)
    assert out == payloads and consumed == len(buf)
    assert FRAME_MAGIC == JT.FRAME_MAGIC == b"WKTX"


def test_torn_frame_drops_only_unacknowledged_message():
    f1, f2 = encode_frame(b"first"), encode_frame(b"second-message")
    for cut in range(1, len(f2)):
        out, consumed = decode_frames(f1 + f2[:cut])
        assert out == [b"first"] and consumed == len(f1)
    dec = FrameDecoder()
    assert dec.feed(f1 + f2[:5]) == [b"first"]
    assert dec.feed(f2[5:]) == [b"second-message"]


def test_frame_decoder_byte_at_a_time():
    frames = [encode_frame(b"a" * 37), encode_frame(b""), encode_frame(b"z")]
    dec = FrameDecoder()
    got = []
    for b in b"".join(frames):
        got += dec.feed(bytes([b]))
    assert got == [b"a" * 37, b"", b"z"]


def test_corruption_is_structured():
    with pytest.raises(TransportCorrupt) as ei:
        decode_frames(b"XXXX" + encode_frame(b"p")[4:])
    assert ei.value.code == ErrorCode.TRANSPORT_CORRUPT
    f = bytearray(encode_frame(b"payload-bytes"))
    f[-1] ^= 0xFF
    with pytest.raises(TransportCorrupt):
        decode_frames(bytes(f))


def test_oversized_frame_names_the_limit(monkeypatch):
    with pytest.raises(FrameTooLarge) as ei:
        encode_frame(b"x" * 100, max_bytes=64)
    assert ei.value.code == ErrorCode.FRAME_TOO_LARGE
    assert "transport_max_frame_mb" in str(ei.value)
    with pytest.raises(FrameTooLarge):
        decode_frames(encode_frame(b"y" * 100), max_bytes=64)
    monkeypatch.setattr(Global, "transport_max_frame_mb", 0)
    with pytest.raises(FrameTooLarge):
        encode_frame(b"over the knob")


# ---------------------------------------------------------------------------
# the message registry and the ops
# ---------------------------------------------------------------------------

_SAMPLE_ARGS = {"ping": (7,), "segment": (3, OUT), "versatile": (IN,),
                "index": (2, IN), "digest": (), "sync": (5,),
                "snapshot": ()}


def test_registry_and_handlers_cover_the_jax_ops():
    assert set(MESSAGE_REGISTRY) == set(OP_HANDLERS) == set(_SAMPLE_ARGS)
    assert set(MESSAGE_REGISTRY) == set(JT.MESSAGE_REGISTRY)


@pytest.mark.parametrize("op", sorted(_SAMPLE_ARGS))
def test_pack_unpack_roundtrip_every_message_type(op):
    args = _SAMPLE_ARGS[op]
    pack, unpack = MESSAGE_REGISTRY[op]
    assert pack(args) == JT.MESSAGE_REGISTRY[op][0](args)
    assert unpack(pack(args)) == tuple(int(a) for a in args)
    (payload,), _ = decode_frames(encode_frame(pack_message(op, 3, args)))
    assert unpack_message(payload) == (op, 3, tuple(int(a) for a in args))
    # a JAX peer's request reads the same
    assert unpack_message(JT.pack_message(op, 3, args))[0] == op


def test_malformed_messages_and_replies():
    with pytest.raises(TransportCorrupt):
        unpack_message(b"\x00not-a-pickle")
    with pytest.raises(TransportCorrupt):
        unpack_message(pack_reply("wrong-shape"))
    with pytest.raises(TransportCorrupt):
        unpack_message(pack_message("segment", 0, (1, 0))
                       .replace(b"segment", b"zegment"))
    assert unpack_reply(pack_reply({"a": 1})) == {"a": 1}
    with pytest.raises(WukongError) as ei:
        unpack_reply(pack_error(int(ErrorCode.SHARD_UNAVAILABLE), "gone"))
    assert ei.value.code == ErrorCode.SHARD_UNAVAILABLE
    with pytest.raises(TransportCorrupt):
        unpack_reply(b"\x80\x04N.")


def test_run_op_matches_the_jax_ops(g0):
    jg = jbp(_triples(), 0, D)
    for op in ("segment", "versatile", "index"):
        got = run_op(op, g0, *_SAMPLE_ARGS[op])
        want = JT.run_op(op, jg, *_SAMPLE_ARGS[op])
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert np.array_equal(np.asarray(a), np.asarray(b)), op
            assert np.asarray(a).dtype == np.asarray(b).dtype, op
    missing = run_op("segment", g0, 999, OUT)
    assert len(missing[0]) == 0 and list(missing[1]) == [0]
    assert run_op("digest", g0) == int(gstore_digest(g0))
    assert run_op("ping", g0, 42) == {"sid": 0, "version": 0, "seq": 42}
    assert run_op("sync", g0, 5) == 0
    blob = run_op("snapshot", g0)
    assert gstore_digest(gstore_from_bytes(blob)) == gstore_digest(g0)
    with pytest.raises(WukongError):
        run_op("no-such-op", g0)


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

def test_make_transport_mode_knob(monkeypatch):
    assert make_transport().mode == "loopback"
    monkeypatch.setattr(Global, "transport_mode", "socket")
    assert isinstance(make_transport(), SocketTransport)
    monkeypatch.setattr(Global, "transport_mode", "carrier-pigeon")
    with pytest.raises(WukongError) as ei:
        make_transport()
    assert ei.value.code == ErrorCode.UNSUPPORTED_SHAPE


def test_loopback_fetch_dispatch_and_snapshot(g0):
    lo = LoopbackTransport()
    for x, y in zip(lo.fetch(0, g0, "segment", (3, OUT)),
                    run_op("segment", g0, 3, OUT)):
        assert np.array_equal(x, y)
    assert lo.dispatch(lambda u, v: u + v, 2, 3) == 5
    snap = lo.snapshot(0, g0)
    assert snap is not g0 and gstore_digest(snap) == gstore_digest(g0)
    assert lo.peer_for(0) is None


def test_peerless_socket_transport_serves_locally(g0):
    tr = SocketTransport()
    try:
        for x, y in zip(tr.fetch(0, g0, "segment", (3, OUT)),
                        run_op("segment", g0, 3, OUT)):
            assert np.array_equal(x, y)
        assert gstore_digest(tr.snapshot(0, g0)) == gstore_digest(g0)
    finally:
        tr.close()


class _FrameServer:
    """A thread serving framed requests against ``stores`` (one request,
    one reply, until the peer closes)."""

    def __init__(self, stores):
        self.stores = stores
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.addr = self.sock.getsockname()
        self.served = 0
        self._t = threading.Thread(target=self._accept, daemon=True)
        self._t.start()

    def _accept(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        dec = FrameDecoder()
        with conn:
            while True:
                chunk = conn.recv(1 << 20)
                if not chunk:
                    return
                for payload in dec.feed(chunk):
                    op, sid, args = unpack_message(payload)
                    out = run_op(op, self.stores[sid], *args)
                    self.served += 1
                    conn.sendall(encode_frame(pack_reply(out)))

    def close(self):
        self.sock.close()


@pytest.fixture()
def wire(stores, monkeypatch):
    monkeypatch.setattr(Global, "retry_base_ms", 1)
    monkeypatch.setattr(Global, "retry_max_ms", 2)
    srv = _FrameServer(stores)
    tr = SocketTransport(timeout_ms=5000, connect_timeout_ms=2000)
    for s in range(D):
        tr.register_peer(s, srv.addr)
    yield tr, srv
    tr.close()
    srv.close()


def _same_fetch(tr, g, shard):
    for x, y in zip(tr.fetch(shard, g, "segment", (3, OUT)),
                    run_op("segment", g, 3, OUT)):
        assert np.array_equal(x, y)


def test_wire_fetch_is_byte_identical(wire, stores):
    tr, srv = wire
    for s in range(D):
        _same_fetch(tr, stores[s], s)
        assert tr.fetch(s, stores[s], "digest", ()) == \
            int(gstore_digest(stores[s]))
    assert srv.served == 2 * D and tr.peer_for(1) == srv.addr


@pytest.mark.parametrize("site", ["transport.connect", "transport.send",
                                  "transport.recv"])
def test_wire_transients_are_retried_through(wire, stores, site):
    tr, _srv = wire
    tr.close()  # a fresh connection, so transport.connect fires too
    plan = FaultPlan([FaultSpec(site, "transient", count=1)], seed=3)
    faults.install(plan)
    _same_fetch(tr, stores[2], 2)
    assert [h[0] for h in plan.history] == [site]


def test_dead_peer_exhausts_retries(g0, monkeypatch):
    monkeypatch.setattr(Global, "retry_base_ms", 1)
    monkeypatch.setattr(Global, "retry_max_ms", 2)
    sink = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sink.bind(("127.0.0.1", 0))
    dead = ("127.0.0.1", sink.getsockname()[1])
    sink.close()
    tr = SocketTransport(connect_timeout_ms=200)
    tr.register_peer(0, dead)
    try:
        with pytest.raises(RetryExhausted):
            tr._retry_call(0, "digest", ())
        # the per-(peer, shard) breaker counted every failed attempt
        assert tr.breaker.snapshot()[(dead, 0)]["consecutive_failures"] \
            == Global.retry_max_attempts
    finally:
        tr.close()
    with pytest.raises(ShardUnavailable):
        SocketTransport()._retry_call(1, "digest", ())


# ---------------------------------------------------------------------------
# retry_call: the breaker, the deadline, no sleep after the last attempt
# ---------------------------------------------------------------------------

def test_retry_call_never_sleeps_after_the_final_attempt():
    calls, sleeps = [], []

    def boom():
        calls.append(1)
        raise faults.TransientFault("always down")

    with pytest.raises(RetryExhausted):
        retry_call(boom, site="test.audit", attempts=4, base_ms=1, max_ms=2,
                   rng=random.Random(0), sleep=sleeps.append)
    assert len(calls) == 4 and len(sleeps) == 3


def test_retry_call_breaker_and_deadline():
    clock = [0.0]
    br = CircuitBreaker(threshold=2, cooldown_ms=1000,
                        clock=lambda: clock[0])

    def boom():
        raise faults.TransientFault("down")

    with pytest.raises(RetryExhausted):
        retry_call(boom, attempts=2, base_ms=1, max_ms=1, breaker=br, key=5,
                   sleep=lambda s: None)
    assert br.tripped(5)
    with pytest.raises(ShardUnavailable) as ei:  # open: not even called
        retry_call(lambda: 1, breaker=br, key=5)
    assert ei.value.shard == 5
    clock[0] = 2.0  # half-open: one trial, a success closes the key
    assert retry_call(lambda: 7, breaker=br, key=5) == 7
    assert not br.tripped(5)
    dl = Deadline(timeout_ms=50, clock=lambda: clock[0])
    clock[0] = 2.049
    with pytest.raises(QueryTimeout):  # the backoff would pass the deadline
        retry_call(boom, attempts=3, base_ms=100, max_ms=100,
                   deadline=dl, sleep=lambda s: None)
    clock[0] = 3.0
    with pytest.raises(QueryTimeout):  # expired before the first attempt
        retry_call(lambda: 1, deadline=dl)
