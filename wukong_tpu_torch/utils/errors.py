"""Error codes surfaced to clients on query replies.

Mirrors utils/errors.hpp:28-79 — engine-side failures do not kill workers; they
become a ``status_code`` on the reply, and the frontend renders a message.
"""

from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    SUCCESS = 0
    SYNTAX_ERROR = 1  # parser-level failure
    UNKNOWN_SUB = 2  # unknown subject string
    UNKNOWN_PATTERN = 3  # pattern shape not supported by the engine
    ATTR_DISABLE = 4  # attribute query while vattr support disabled
    NO_REQUIRED_VAR = 5  # projection references an unbound variable
    UNSUPPORT_UNION = 6
    OBJ_ERROR = 7  # malformed index pattern
    VERTEX_INVALID = 8  # known var has no bound column
    UNKNOWN_FILTER = 9
    FIRST_PATTERN_ERROR = 10  # start pattern must begin an empty table
    UNKNOWN_PLAN = 11
    UNSUPPORTED_SHAPE = 12  # engine cannot run this plan shape (fallback-able)
    FILE_NOT_FOUND = 13  # dataset/HDFS source unreachable
    # ---- resilience taxonomy (no reference analogue: the reference's only
    # failure handling is "engine-side failures become a status_code"; these
    # make deadline/budget/infrastructure failures distinguishable so the
    # proxy can degrade instead of treating everything as a query bug) ----
    QUERY_TIMEOUT = 14  # per-query wall-clock deadline expired
    BUDGET_EXCEEDED = 15  # per-query intermediate-row work budget exhausted
    CAPACITY_EXCEEDED = 16  # device capacity ceiling hit (host-fallback-able)
    SHARD_UNAVAILABLE = 17  # shard down / circuit breaker open
    RETRY_EXHAUSTED = 18  # transient-failure retries used up
    CHECKPOINT_CORRUPT = 19  # checkpoint/WAL bundle unreadable or mismatched
    FRAME_TOO_LARGE = 20  # transport frame over transport_max_frame_mb
    TRANSPORT_CORRUPT = 21  # wire frame/message failed CRC or schema checks


_MESSAGES = {
    ErrorCode.SUCCESS: "success",
    ErrorCode.SYNTAX_ERROR: "syntax error",
    ErrorCode.UNKNOWN_SUB: "unknown subject (not in string server)",
    ErrorCode.UNKNOWN_PATTERN: "unsupported triple pattern",
    ErrorCode.ATTR_DISABLE: "attribute support is disabled (enable_vattr)",
    ErrorCode.NO_REQUIRED_VAR: "projection variable is not bound",
    ErrorCode.UNSUPPORT_UNION: "unsupported UNION shape",
    ErrorCode.OBJ_ERROR: "malformed index pattern",
    ErrorCode.VERTEX_INVALID: "known variable has no bound column",
    ErrorCode.UNKNOWN_FILTER: "unsupported FILTER expression",
    ErrorCode.FIRST_PATTERN_ERROR: "start pattern applied to a non-empty table",
    ErrorCode.UNKNOWN_PLAN: "invalid or missing query plan",
    ErrorCode.UNSUPPORTED_SHAPE: "plan shape unsupported by this engine",
    ErrorCode.FILE_NOT_FOUND: "dataset source unreachable",
    ErrorCode.QUERY_TIMEOUT: "query deadline expired",
    ErrorCode.BUDGET_EXCEEDED: "query work budget exhausted",
    ErrorCode.CAPACITY_EXCEEDED: "device capacity exceeded",
    ErrorCode.SHARD_UNAVAILABLE: "shard unavailable (circuit open)",
    ErrorCode.RETRY_EXHAUSTED: "transient-failure retries exhausted",
    ErrorCode.CHECKPOINT_CORRUPT: "checkpoint/WAL bundle corrupt or incompatible",
    ErrorCode.FRAME_TOO_LARGE: "transport frame exceeds transport_max_frame_mb",
    ErrorCode.TRANSPORT_CORRUPT: "transport frame or message corrupt",
}


class WukongError(Exception):
    """Query-scoped failure carrying an ErrorCode (utils/errors.hpp WukongException)."""

    def __init__(self, code: ErrorCode, detail: str = ""):
        self.code = ErrorCode(code)
        self.detail = detail
        msg = _MESSAGES.get(self.code, "unknown error")
        super().__init__(f"[{self.code.name}] {msg}" + (f": {detail}" if detail else ""))


class QueryTimeout(WukongError):
    """Per-query wall-clock deadline expired (resilience layer)."""

    def __init__(self, detail: str = ""):
        super().__init__(ErrorCode.QUERY_TIMEOUT, detail)


class BudgetExceeded(WukongError):
    """Per-query intermediate-row work budget exhausted (resilience layer)."""

    def __init__(self, detail: str = ""):
        super().__init__(ErrorCode.BUDGET_EXCEEDED, detail)


class CapacityExceeded(WukongError):
    """A device capacity ceiling (table_capacity_max) was hit. The proxy
    treats this as degradable: the host engine has no capacity classes, so
    the same query can complete there."""

    def __init__(self, detail: str = ""):
        super().__init__(ErrorCode.CAPACITY_EXCEEDED, detail)


class ShardUnavailable(WukongError):
    """A shard is down or its circuit breaker is open."""

    def __init__(self, detail: str = "", shard: int | None = None):
        self.shard = shard
        super().__init__(ErrorCode.SHARD_UNAVAILABLE, detail)


class RetryExhausted(WukongError):
    """A transient failure survived every retry attempt."""

    def __init__(self, detail: str = "", last: BaseException | None = None):
        self.last = last
        super().__init__(ErrorCode.RETRY_EXHAUSTED, detail)


class CheckpointCorrupt(WukongError):
    """A persisted bundle (gstore checkpoint, WAL segment, recovery
    manifest) failed validation: truncated archive, checksum mismatch, or
    a newer-major format this build refuses to guess at. Carries the
    offending path so operators know which artifact to discard."""

    def __init__(self, detail: str = "", path: str | None = None):
        self.path = path
        super().__init__(ErrorCode.CHECKPOINT_CORRUPT,
                         f"{detail} ({path})" if path else detail)


class FrameTooLarge(WukongError):
    """A transport frame (sent or received) exceeds the configured
    ``transport_max_frame_mb`` ceiling. Raised on the encode side too: the
    sender refuses what the receiver would refuse."""

    def __init__(self, detail: str = ""):
        super().__init__(ErrorCode.FRAME_TOO_LARGE, detail)


class TransportCorrupt(WukongError):
    """A wire frame or message failed validation: bad magic, CRC mismatch on
    a complete frame, an undeclared op, or a request/reply that does not
    match its MESSAGE_REGISTRY schema. A torn trailing frame is dropped
    instead (only the unacknowledged message)."""

    def __init__(self, detail: str = ""):
        super().__init__(ErrorCode.TRANSPORT_CORRUPT, detail)


def assert_ec(cond: bool, code: ErrorCode, detail: str = "") -> None:
    if not cond:
        raise WukongError(code, detail)
