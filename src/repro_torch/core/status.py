"""LCI status objects — the ternary ``done/posted/retry`` return protocol.

The paper (§3.2.5) defines four categories for every posting operation:

* ``done``   — completed immediately; completion objects will NOT be signaled.
* ``posted`` — accepted; completion objects will be signaled later.
* ``retry``  — temporary resource unavailability; caller should resubmit
  (or do something useful first: aggregate, poll other queues, ...).
* fatal     — raised as an exception (we mirror that: Python exceptions).

Compared to MPI's binary success/failure this surfaces back-pressure to the
client.  The same protocol governs the functional tensor resources (packet
pool exhaustion -> ``retry`` encoded as a status code in an int32 tensor).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional


class ErrorKind(enum.IntEnum):
    """Top-level status category (paper §3.2.5)."""

    DONE = 0
    POSTED = 1
    RETRY = 2
    ERR = 3                    # terminal failure (chaos plane, DESIGN.md §16)


class ErrorCode(enum.IntEnum):
    """Fine-grained codes within a category — "each category includes
    multiple error codes to deliver more information"."""

    # done
    DONE_OK = 0
    DONE_INLINE = 1            # const-folded / immediately completed comm
    # posted
    POSTED_OK = 10
    POSTED_UNMATCHED = 11      # send/recv inserted into matching engine
    POSTED_BACKLOG = 12        # moved to backlog queue
    # retry
    RETRY_NOPACKET = 20        # packet pool exhausted
    RETRY_NOSLOT = 21          # capacity slot unavailable (MoE / KV page)
    RETRY_LOCKED = 22          # try-lock analogue: resource busy
    RETRY_BACKLOG_FULL = 23
    RETRY_QUEUE_FULL = 24      # completion queue ring full
    # err — terminal: the op will never complete; comps ARE signaled
    # (exactly once) with the error status so callers never hang
    ERR_TIMEOUT = 30           # post deadline / retry budget exhausted
    ERR_PEER_DEAD = 31         # peer rank declared dead (heartbeat/chaos)


class FatalError(RuntimeError):
    """Paper: 'fatal errors are reported through C++ exceptions'."""


@dataclasses.dataclass(slots=True)
class Status:
    """The ``status_t`` object returned by posting/checking operations.

    When ``kind == DONE`` the payload fields (``value``/``buffer``, ``rank``,
    ``tag``) carry valid information about the completed operation.

    Slotted: statuses are the highest-volume objects on the data plane
    (two per eager message), so the ~20% ctor/footprint win matters.
    """

    kind: ErrorKind
    code: ErrorCode = ErrorCode.DONE_OK
    value: Any = None          # delivered payload (ndarray or tensor)
    rank: Optional[int] = None
    tag: Optional[int] = None
    user_context: Any = None

    # -- predicates mirroring the paper's is_done / is_posted / is_retry ----
    def is_done(self) -> bool:
        return self.kind == ErrorKind.DONE

    def is_posted(self) -> bool:
        return self.kind == ErrorKind.POSTED

    def is_retry(self) -> bool:
        return self.kind == ErrorKind.RETRY

    def is_err(self) -> bool:
        return self.kind == ErrorKind.ERR

    def get_buffer(self):
        if not self.is_done():
            raise FatalError("status payload only valid when done")
        return self.value


def done(value: Any = None, *, code: ErrorCode = ErrorCode.DONE_OK,
         rank: int | None = None, tag: int | None = None) -> Status:
    return Status(ErrorKind.DONE, code, value=value, rank=rank, tag=tag)


def posted(*, code: ErrorCode = ErrorCode.POSTED_OK, ctx: Any = None) -> Status:
    return Status(ErrorKind.POSTED, code, user_context=ctx)


def retry(code: ErrorCode = ErrorCode.RETRY_LOCKED) -> Status:
    return Status(ErrorKind.RETRY, code)


def err(code: ErrorCode = ErrorCode.ERR_TIMEOUT, *,
        rank: int | None = None, tag: int | None = None,
        ctx: Any = None) -> Status:
    """Terminal failure status — signaled to comps exactly once in place
    of the ``done`` the op would have delivered (DESIGN.md §16)."""
    return Status(ErrorKind.ERR, code, rank=rank, tag=tag, user_context=ctx)


# Integer encodings for tensor status values. Functional resources (the
# slot pool, ...) return an int32 status so device code can select on it
# with torch.where, without reading it back to the host.
IN_GRAPH_DONE = 0
IN_GRAPH_RETRY = 1
