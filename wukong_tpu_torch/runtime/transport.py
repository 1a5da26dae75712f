"""Transport seam: the data plane's remote-fetch boundary, made explicit.

The port's copy of the JAX package's runtime/transport.py. The sharded
store's shard fetches go through it, so the process boundary is one object
and the in-process default costs nothing:

- **Ops, not closures.** Each remote-readable operation is a named op
  (``"segment"``, ``"index"``, ...) executed by :func:`run_op` against one
  partition. The sharded store passes ``(op, args)`` down its fetch path
  instead of a closure, so both transports serve the identical code path.
- **Two transports.** :class:`LoopbackTransport` (default) executes ops
  directly against the local store, with no serialization. :class:`SocketTransport` speaks a
  length-prefixed + CRC framed wire protocol over TCP to the per-shard-
  group worker processes (runtime/procs.py, which the port does not have
  yet: until it does, a socket transport has no peers and serves every
  shard locally), with per-connection send/recv
  timeouts, ``retry_call`` backoff, and per-(peer, shard) circuit breakers.
- **A closed message registry.** Every wire message type is declared in
  the literal :data:`MESSAGE_REGISTRY` with an explicit serialize +
  deserialize pair and a server-side handler in :data:`OP_HANDLERS` (the
  JAX package's ``transport-contract`` gate holds the two in sync; the
  port's copy of that gate comes with the worker processes).

Framing (the WAL's discipline, applied to the wire): every frame is
``MAGIC | u32 length | u32 crc32 | payload``. A torn frame (short header
or body) drops only the unacknowledged trailing message — the bytes before
it all parse; a mid-buffer CRC mismatch is a structured
``TRANSPORT_CORRUPT`` (never a silent skip); a frame above the
``transport_max_frame_mb`` knob raises ``FRAME_TOO_LARGE`` naming the
limit, on both the encode and decode side.

Fault sites: ``transport.connect`` / ``transport.send`` /
``transport.recv`` fire before their syscall, so injected chaos exercises
the exact reconnect/retry/breaker paths a dead worker process does.
"""

from __future__ import annotations

import pickle
import socket
import struct
import zlib

from wukong_tpu_torch.analysis.lockdep import declare_leaf, make_lock
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.utils.errors import (
    ErrorCode,
    FrameTooLarge,
    ShardUnavailable,
    TransportCorrupt,
    WukongError,
)

FRAME_MAGIC = b"WKTX"
_FRAME_HDR = struct.Struct("<II")  # (payload length, payload crc32)

# the per-connection send/recv lock: innermost by construction (nothing
# is acquired while a frame is on the wire), so a declared leaf
declare_leaf("transport.conn")


def _max_frame_bytes(max_bytes: int | None = None) -> int:
    return (int(max_bytes) if max_bytes is not None
            else Global.transport_max_frame_mb * (1 << 20))


# ---------------------------------------------------------------------------
# framing (pure functions — golden-tested without sockets)
# ---------------------------------------------------------------------------

def encode_frame(payload: bytes, max_bytes: int | None = None) -> bytes:
    """One wire frame: MAGIC + length + crc + payload. Oversized payloads
    raise FRAME_TOO_LARGE naming the knob — the sender must refuse what
    the receiver would refuse, or the error surfaces a timeout away."""
    limit = _max_frame_bytes(max_bytes)
    if len(payload) > limit:
        raise FrameTooLarge(
            f"frame payload is {len(payload)} bytes, over the "
            f"transport_max_frame_mb limit ({limit} bytes)")
    return (FRAME_MAGIC + _FRAME_HDR.pack(len(payload), zlib.crc32(payload))
            + payload)


def decode_frames(buf: bytes, max_bytes: int | None = None
                  ) -> tuple[list[bytes], int]:
    """Parse every complete frame from ``buf``; returns (payloads,
    consumed). A torn tail (short magic/header/body) stops the parse —
    only the unacknowledged trailing message is dropped, the WAL's
    torn-tail contract. A bad magic or a CRC mismatch on a COMPLETE frame
    raises TRANSPORT_CORRUPT (corruption mid-stream is never skippable);
    an oversized declared length raises FRAME_TOO_LARGE naming the limit."""
    limit = _max_frame_bytes(max_bytes)
    out: list[bytes] = []
    off = 0
    n = len(buf)
    hdr = len(FRAME_MAGIC) + _FRAME_HDR.size
    while off < n:
        if off + hdr > n:
            break  # torn header: wait for (or drop) the rest
        if buf[off:off + len(FRAME_MAGIC)] != FRAME_MAGIC:
            raise TransportCorrupt(
                f"bad frame magic at offset {off}")
        blen, crc = _FRAME_HDR.unpack_from(buf, off + len(FRAME_MAGIC))
        if blen > limit:
            raise FrameTooLarge(
                f"frame declares {blen} bytes, over the "
                f"transport_max_frame_mb limit ({limit} bytes)")
        body = buf[off + hdr: off + hdr + blen]
        if len(body) < blen:
            break  # torn body: the unacknowledged message
        if zlib.crc32(body) != crc:
            raise TransportCorrupt(
                f"frame crc mismatch at offset {off}")
        out.append(body)
        off += hdr + blen
    return out, off


class FrameDecoder:
    """Incremental frame parser for a stream socket: feed chunks, yield
    complete payloads, keep the torn tail buffered for the next chunk."""

    def __init__(self, max_bytes: int | None = None):
        self._buf = b""
        self._max = max_bytes

    def feed(self, chunk: bytes) -> list[bytes]:
        self._buf += chunk
        frames, consumed = decode_frames(self._buf, self._max)
        self._buf = self._buf[consumed:]
        return frames


# ---------------------------------------------------------------------------
# ops: the remote-readable operations, executed against ONE partition
# ---------------------------------------------------------------------------

def _op_ping(g, seq: int):
    """Liveness + staleness probe: the supervisor's heartbeat payload."""
    return {"sid": int(g.sid), "version": int(getattr(g, "version", 0)),
            "seq": int(seq)}


def _op_segment(g, pid: int, d: int):
    """One (pid, dir) CSR fetch: (keys, offsets, edges); the TYPE_ID/IN
    pseudo-segment is the type-index CSR."""
    import numpy as np

    from wukong_tpu_torch.engine.device_store import type_index_csr
    from wukong_tpu_torch.types import IN, TYPE_ID

    if int(pid) == TYPE_ID and int(d) == IN:
        return type_index_csr(g)
    host = g.segments.get((int(pid), int(d)))
    if host is None:
        return (np.empty(0, np.int64), np.zeros(1, np.int64),
                np.empty(0, np.int64))
    return (host.keys, host.offsets, host.edges)


def _op_versatile(g, d: int):
    """Combined variable-predicate adjacency of direction d."""
    from wukong_tpu_torch.engine.device_store import combined_adjacency

    return combined_adjacency(g, int(d))


def _op_index(g, tpid: int, d: int):
    import numpy as np

    return np.asarray(g.get_index(int(tpid), int(d)), dtype=np.int32)


def _op_digest(g):
    """Content CRC over every persisted array — the rejoin proof: a
    restarted worker serves only after its digest matches the parent's."""
    from wukong_tpu_torch.store.persist import gstore_digest

    return int(gstore_digest(g))


def _op_sync(g, upto_seq: int):
    """Worker-side WAL catch-up hook. On the parent (loopback) the store
    IS the mutation target, so there is nothing to sync; a worker process
    binds its WAL-tail replay here."""
    return 0


def _op_snapshot(g):
    """Serialize one partition through the checkpoint wire format — the
    migration transfer's payload (a byte-identical copy by the save/load
    roundtrip contract)."""
    from wukong_tpu_torch.store.persist import gstore_to_bytes

    return gstore_to_bytes(g)


# serialize / deserialize pairs: the explicit wire schema of each message
# type's REQUEST arguments (results ride the generic response envelope).
# Requests are plain ints on purpose — a message type that needs to ship
# an object must grow an explicit schema here, reviewed as a diff.

def pack_ping(args) -> dict:
    (seq,) = args
    return {"seq": int(seq)}


def unpack_ping(d: dict) -> tuple:
    return (int(d["seq"]),)


def pack_segment(args) -> dict:
    pid, d = args
    return {"pid": int(pid), "d": int(d)}


def unpack_segment(d: dict) -> tuple:
    return (int(d["pid"]), int(d["d"]))


def pack_versatile(args) -> dict:
    (d,) = args
    return {"d": int(d)}


def unpack_versatile(d: dict) -> tuple:
    return (int(d["d"]),)


def pack_index(args) -> dict:
    tpid, d = args
    return {"tpid": int(tpid), "d": int(d)}


def unpack_index(d: dict) -> tuple:
    return (int(d["tpid"]), int(d["d"]))


def pack_digest(args) -> dict:
    return {}


def unpack_digest(d: dict) -> tuple:
    return ()


def pack_sync(args) -> dict:
    (upto_seq,) = args
    return {"upto_seq": int(upto_seq)}


def unpack_sync(d: dict) -> tuple:
    return (int(d["upto_seq"]),)


def pack_snapshot(args) -> dict:
    return {}


def unpack_snapshot(d: dict) -> tuple:
    return ()


# the central wire-message registry: every message type the transport can
# carry, with its serialize + deserialize sides. Adding a message type =
# add the pack/unpack pair, the handler, the registry row, and a test.
MESSAGE_REGISTRY = {
    "ping": (pack_ping, unpack_ping),
    "segment": (pack_segment, unpack_segment),
    "versatile": (pack_versatile, unpack_versatile),
    "index": (pack_index, unpack_index),
    "digest": (pack_digest, unpack_digest),
    "sync": (pack_sync, unpack_sync),
    "snapshot": (pack_snapshot, unpack_snapshot),
}

# server-side executors, one per registry row (same key set — gate-held)
OP_HANDLERS = {
    "ping": _op_ping,
    "segment": _op_segment,
    "versatile": _op_versatile,
    "index": _op_index,
    "digest": _op_digest,
    "sync": _op_sync,
    "snapshot": _op_snapshot,
}


def run_op(op: str, g, *args):
    """Execute one declared op against a local partition — the loopback
    execution path AND the worker's server dispatch."""
    h = OP_HANDLERS.get(op)
    if h is None:
        raise TransportCorrupt(f"undeclared transport op {op!r}")
    return h(g, *args)


def pack_message(op: str, sid: int, args: tuple) -> bytes:
    """Request wire form: pickled (op, sid, schema-packed args)."""
    ent = MESSAGE_REGISTRY.get(op)
    if ent is None:
        raise TransportCorrupt(f"undeclared transport op {op!r}")
    return pickle.dumps((op, int(sid), ent[0](args)),
                        protocol=pickle.HIGHEST_PROTOCOL)


def unpack_message(payload: bytes) -> tuple[str, int, tuple]:
    """Inverse of :func:`pack_message`; every malformation is a structured
    TRANSPORT_CORRUPT, never a bare KeyError/UnpicklingError."""
    try:
        op, sid, d = pickle.loads(payload)
    except Exception as e:  # noqa: BLE001 — pickle raises many shapes
        raise TransportCorrupt(f"unreadable request: {e}") from None
    ent = MESSAGE_REGISTRY.get(op)
    if ent is None:
        raise TransportCorrupt(f"undeclared transport op {op!r}")
    try:
        args = ent[1](d)
    except (KeyError, TypeError, ValueError) as e:
        raise TransportCorrupt(
            f"malformed {op!r} request: {e}") from None
    return op, int(sid), args


def pack_reply(result) -> bytes:
    return pickle.dumps(("ok", result), protocol=pickle.HIGHEST_PROTOCOL)


def pack_error(code: int, detail: str) -> bytes:
    return pickle.dumps(("err", int(code), str(detail)),
                        protocol=pickle.HIGHEST_PROTOCOL)


def unpack_reply(payload: bytes):
    try:
        t = pickle.loads(payload)
    except Exception as e:  # noqa: BLE001
        raise TransportCorrupt(f"unreadable reply: {e}") from None
    try:
        if t[0] == "ok":
            return t[1]
        if t[0] == "err":
            # re-raise the peer's structured code, taxonomy-preserving
            code = ErrorCode(int(t[1]))
            raise WukongError(code, t[2])
        kind = t[0]
    except (TypeError, IndexError, ValueError) as e:
        # a reply that is not ("ok", r) / ("err", code, detail) is
        # corruption, never a bare TypeError a timeout away from its cause
        raise TransportCorrupt(f"malformed reply envelope: {e}") from None
    raise TransportCorrupt(f"unknown reply kind {kind!r}")


def _metrics():
    from wukong_tpu_torch.obs.metrics import get_registry

    reg = get_registry()
    return (
        reg.counter("wukong_transport_messages_total",
                    "Wire messages sent by the socket transport",
                    labels=("op", "result")),
        reg.counter("wukong_transport_bytes_total",
                    "Wire bytes moved by the socket transport",
                    labels=("direction",)),
    )


# ---------------------------------------------------------------------------
# the Transport interface + both implementations
# ---------------------------------------------------------------------------

class LoopbackTransport:
    """In-process transport: ops execute directly against the local store
    object, with no serialization. The default (``transport_mode
    loopback``)."""

    mode = "loopback"

    def fetch(self, shard: int, store, op: str, args: tuple):
        return run_op(op, store, *args)

    def dispatch(self, fn, *args):
        """Chain dispatch seam (parallel/dist_engine.py): the shard slots
        share one process and one card, so both transports execute in
        place; the call path is the same object the fetch path uses."""
        return fn(*args)

    def snapshot(self, shard: int, store):
        """A shard's transfer copy (the migration actuator's clone)."""
        from wukong_tpu_torch.store.persist import clone_gstore

        return clone_gstore(store)

    def peer_for(self, shard: int):
        return None

    def close(self) -> None:
        pass


class SocketTransport(LoopbackTransport):
    """Framed TCP transport to the per-shard-group worker processes.

    Shards with a registered peer fetch over the wire; shards without one
    (or whose worker is being restarted) are served from the local store:
    the parent keeps the authoritative copy."""

    mode = "socket"

    def __init__(self, timeout_ms: int | None = None,
                 connect_timeout_ms: int | None = None):
        from wukong_tpu_torch.runtime.resilience import CircuitBreaker

        self._timeout_ms = timeout_ms
        self._connect_timeout_ms = connect_timeout_ms
        self.peers: dict[int, tuple] = {}  # lock-free: whole-entry puts/pops; fetch reads a snapshot get
        # per-(peer, shard) breaker: a sick worker is routed around per
        # shard, independent of the parent-side sstore breaker
        self.breaker = CircuitBreaker()
        # addr -> (sock, decoder, leaf send/recv lock)
        self._conns: dict[tuple, tuple] = {}  # guarded by: _conn_lock
        self._conn_lock = make_lock("transport.conn")
        self._m_msgs, self._m_bytes = _metrics()

    # -- peer registry ---------------------------------------------------
    def register_peer(self, shard: int, addr: tuple) -> None:
        self.peers[int(shard)] = tuple(addr)

    def deregister_peer(self, shard: int) -> None:
        self.peers.pop(int(shard), None)
        self.breaker.record_success(int(shard))

    def peer_for(self, shard: int):
        return self.peers.get(int(shard))

    # -- connection management ------------------------------------------
    @property
    def timeout_s(self) -> float:
        ms = (self._timeout_ms if self._timeout_ms is not None
              else Global.transport_timeout_ms)
        return max(int(ms), 1) / 1000.0

    @property
    def connect_timeout_s(self) -> float:
        ms = (self._connect_timeout_ms if self._connect_timeout_ms is not None
              else Global.transport_connect_timeout_ms)
        return max(int(ms), 1) / 1000.0

    def _connection(self, addr: tuple):
        from wukong_tpu_torch.runtime import faults

        with self._conn_lock:
            ent = self._conns.get(addr)
        if ent is not None:
            return ent
        faults.site("transport.connect")
        sock = socket.create_connection(addr,
                                        timeout=self.connect_timeout_s)
        sock.settimeout(self.timeout_s)
        ent = (sock, FrameDecoder(), make_lock("transport.conn"))
        with self._conn_lock:
            old = self._conns.get(addr)
            if old is not None:
                # lost the connect race: keep the established one
                sock.close()
                return old
            self._conns[addr] = ent
        return ent

    def _drop_connection(self, addr: tuple) -> None:
        with self._conn_lock:
            ent = self._conns.pop(addr, None)
        if ent is not None:
            try:
                ent[0].close()
            except OSError:
                pass

    def close(self) -> None:
        with self._conn_lock:
            conns, self._conns = dict(self._conns), {}
        for (sock, _dec, _lk) in conns.values():
            try:
                sock.close()
            except OSError:
                pass

    # -- the wire call ---------------------------------------------------
    def call(self, addr: tuple, op: str, sid: int, args: tuple = ()):
        """One framed request/reply on the peer connection. Socket-level
        failures surface as TransientFault (the connection is dropped so
        the retry reconnects); the caller's retry_call owns the backoff."""
        from wukong_tpu_torch.runtime import faults

        frame = encode_frame(pack_message(op, sid, args))
        try:
            sock, dec, lk = self._connection(addr)
        except OSError as e:
            self._m_msgs.labels(op=op, result="connect_error").inc()
            raise faults.TransientFault(
                f"transport connect to {addr} failed: {e}") from e
        try:
            with lk:
                faults.site("transport.send")
                sock.sendall(frame)
                self._m_bytes.labels(direction="sent").inc(len(frame))
                while True:
                    faults.site("transport.recv")
                    chunk = sock.recv(1 << 20)
                    if not chunk:
                        raise TransportCorrupt(
                            f"peer {addr} closed mid-reply (torn frame "
                            "dropped; the request was never acknowledged)")
                    self._m_bytes.labels(direction="recv").inc(len(chunk))
                    frames = dec.feed(chunk)
                    if frames:
                        break
        except (OSError, TransportCorrupt, faults.TransientFault) as e:
            # one request per connection at a time (the leaf lock), so a
            # failed exchange leaves no interleaved reply behind: drop
            # the connection and let the retry rebuild it
            self._drop_connection(addr)
            self._m_msgs.labels(op=op, result="error").inc()
            if isinstance(e, faults.TransientFault):
                raise
            raise faults.TransientFault(
                f"transport {op} to {addr} failed: {e}") from e
        self._m_msgs.labels(op=op, result="ok").inc()
        return unpack_reply(frames[0])

    def _retry_call(self, shard: int, op: str, args: tuple):
        from wukong_tpu_torch.runtime import faults
        from wukong_tpu_torch.runtime.resilience import retry_call

        addr = self.peers.get(int(shard))
        if addr is None:
            raise ShardUnavailable(
                f"no transport peer registered for shard {shard}",
                shard=int(shard))
        return retry_call(
            lambda: self.call(addr, op, int(shard), args),
            site=f"transport.{op}[{shard}@{addr[1]}]",
            retry_on=(faults.TransientFault,),
            breaker=self.breaker, key=(addr, int(shard)))

    # -- Transport interface --------------------------------------------
    def fetch(self, shard: int, store, op: str, args: tuple):
        if int(shard) not in self.peers:
            # no worker owns this shard (or it was deregistered for a
            # restart window): the parent's copy is authoritative
            return run_op(op, store, *args)
        return self._retry_call(int(shard), op, args)

    def snapshot(self, shard: int, store):
        """A shard's transfer copy: pulled from its worker over the wire
        when one serves it (after a WAL catch-up to the parent's committed
        seq), otherwise the parent's copy round-tripped through the
        checkpoint wire codec (the bytes a remote pull would move)."""
        from wukong_tpu_torch.store.persist import gstore_from_bytes, gstore_to_bytes
        from wukong_tpu_torch.store.wal import active_wal

        if int(shard) in self.peers:
            wal = active_wal()
            upto = (wal.next_seq - 1) if wal is not None else -1
            self._retry_call(int(shard), "sync", (upto,))
            blob = self._retry_call(int(shard), "snapshot", ())
        else:
            blob = gstore_to_bytes(store)
            self._m_bytes.labels(direction="local").inc(len(blob))
        return gstore_from_bytes(blob)


def make_transport():
    """The sharded store's construction-time transport choice: the
    ``transport_mode`` knob (loopback default; ``socket`` arms the wire
    path, whose peers a process supervisor registers as workers come up;
    a peerless socket serves locally, so flipping the knob alone changes
    no reply)."""
    mode = (Global.transport_mode or "loopback").strip().lower()
    if mode == "socket":
        return SocketTransport()
    if mode != "loopback":
        raise WukongError(ErrorCode.UNSUPPORTED_SHAPE,
                          f"unknown transport_mode {mode!r} "
                          "(expected loopback|socket)")
    return LoopbackTransport()
