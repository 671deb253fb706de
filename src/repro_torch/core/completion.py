"""Completion objects (paper §3.2.5/§4.1.4) — handler, queue, synchronizer.

The paper: "a completion object is a functor with a virtual signal method
that takes a status_t object as an argument. Derived from it, LCI defines
four built-in completion object types: handler, queue, synchronizer, and
graph."  The graph lives in :mod:`repro_torch.core.graph`.

Host-side objects carry the paper's exact semantics and are used by the
runtime (:mod:`repro_torch.core.runtime`).  The reference's in-graph
signal counter has a tensor mirror here (:class:`SyncState`,
:func:`init_sync`, :func:`sync_signal`, :func:`sync_ready`): plain
functions on tensors that run on whatever device their inputs are on and
return a new state rather than mutating the old one.

Atomicity notes from the paper, and what happens to them here:

* completion queue — "one based on the state-of-the-art LCRQ and the other
  on a hand-written Fetch-And-Add-based fix-sized array".  The host queue is
  a deque (single-threaded host runtime); the FAA-array queue is the LCQ
  of :mod:`repro_torch.core.concurrency`.
* synchronizer — "an atomic flag (when expecting one signal) or a fixed-size
  array protected by two atomic counters".  Kept structurally: one expected
  signal skips the array entirely.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, List, Optional

import torch

from . import attrs as _attrs
from .status import ErrorCode, FatalError, Status, done, retry
from .telemetry import NULL_TELEMETRY

# shared signal ack: Status is immutable and signalers only branch on
# is_retry()/code, so one object serves every accepted delivery (statuses
# are the highest-volume objects on the data plane — see status.Status)
_ACCEPTED = done()


def _as_progress_fn(source) -> Optional[Callable[[], Any]]:
    """Normalize anything that can drive progress into a 0-arg callable.

    Accepts a ``LocalCluster``/``ProgressEngine`` (``progress_all``), a
    ``Runtime``/``Endpoint`` (``progress``), a plain callable, or ``None``
    (no driver — the completion must arrive from another thread, e.g. the
    checkpoint writer).
    """
    if source is None:
        return None
    if callable(source) and not hasattr(source, "progress"):
        return source
    if hasattr(source, "progress_all"):
        return source.progress_all
    if hasattr(source, "progress"):
        return source.progress
    raise FatalError(f"cannot drive progress with {source!r}: expected a "
                     "cluster/runtime/engine/endpoint or a callable")


class CompletionObject(_attrs.AttrResource):
    """Base functor — the unified ``comp`` protocol (paper §3.2.5).

    Every completion object allocated from a runtime (``alloc_handler`` /
    ``alloc_cq`` / ``alloc_sync`` / ``alloc_graph``) satisfies one
    contract:

    * ``signal(status) -> Status`` — deliver one completion.  Returns
      ``done()`` when accepted, ``retry(RETRY_QUEUE_FULL)`` when the
      object cannot take the signal *right now* (the progress engine
      parks rejected signals in the device backlog and redelivers).
    * ``test() -> (ready, payload)`` — non-blocking readiness probe.
    * ``wait(progress=None)`` — drive ``progress`` (a cluster, runtime,
      engine, endpoint, or callable) until ``test()`` reports ready, then
      return the payload.  Progress stays explicit: the *caller* names
      who moves data (paper §3.2.6).
    """

    def signal(self, status: Status) -> Status:  # pragma: no cover
        raise NotImplementedError

    def signal_many(self, statuses: List[Status]) -> List[Status]:
        """Deliver a burst of completions in order; returns one result
        Status per delivery, aligned with the input.  The default just
        loops ``signal``; bulk-capable objects (queues) override it to
        pay their admission cost once per burst.  Acceptance is always a
        *prefix*: once one delivery is rejected (``retry``), the rest of
        the burst must be rejected too, so the progress engine's parked
        redeliveries stay in order."""
        out: List[Status] = []
        for i, st in enumerate(statuses):
            r = self.signal(st)
            out.append(r)
            if isinstance(r, Status) and r.is_retry():
                out.extend(retry(r.code) for _ in statuses[i + 1:])
                break
        return out

    def test(self) -> tuple[bool, Any]:  # pragma: no cover - interface
        raise NotImplementedError

    def wait(self, progress=None, max_rounds: int = 100_000) -> Any:
        drive = _as_progress_fn(progress)
        if drive is None:
            # completion owed by another thread (e.g. the checkpoint
            # writer): block until signaled — there is no progress to
            # drive, so rounds would measure nothing but sleep time
            delay = 1e-5
            while True:
                ok, payload = self.test()
                if ok:
                    return payload
                time.sleep(delay)
                delay = min(delay * 2, 1e-2)
        for _ in range(max_rounds):
            ok, payload = self.test()
            if ok:
                return payload
            drive()
        raise FatalError(f"{type(self).__name__}.wait: not ready after "
                         f"{max_rounds} progress rounds")


class CompletionHandler(CompletionObject):
    """Handler: a function invoked inline at completion time.

    Paper: "Completion handler is essentially a function and does not need
    any special treatment."  ``test()`` reports ready once at least one
    signal has been delivered; the payload is the most recent status.
    """

    def __init__(self, fn: Callable[[Status], None]):
        self.fn = fn
        self.signals = 0
        self.last: Optional[Status] = None
        self._export_attr("signals", lambda: self.signals)

    def signal(self, status: Status) -> Status:
        self.signals += 1
        self.last = status
        self.fn(status)
        return done()

    def test(self) -> tuple[bool, Optional[Status]]:
        return self.signals > 0, self.last


class CompletionQueue(CompletionObject):
    """Queue: completions are enqueued; the client polls with ``pop``.

    ``capacity`` bounds the queue like the FAA fixed-size array; a full
    queue surfaces ``retry(RETRY_QUEUE_FULL)`` to the *signaler* (the
    progress engine pushes it to the backlog instead of dropping it).
    """

    def __init__(self, capacity: Optional[int] = None,
                 resolved: Optional[_attrs.ResolvedAttrs] = None,
                 tele=None):
        self._q: collections.deque = collections.deque()
        self.capacity = capacity
        self.pushes = 0
        self.pops = 0
        self.tele = tele if tele is not None else NULL_TELEMETRY
        self._init_attrs(resolved or _attrs.resolved_from_values(
            {"cq_capacity": capacity or 0}))
        self._export_attr("depth", lambda: len(self._q))
        self._export_attr("pushes", lambda: self.pushes)
        self._export_attr("pops", lambda: self.pops)
        self._export_attr("telemetry", self._telemetry_block)

    def _telemetry_block(self) -> dict:
        return {"level": self.tele.level,
                "counters": {"cq.pushes": self.pushes,
                             "cq.pops": self.pops,
                             "cq.depth": len(self._q)}}

    def signal(self, status: Status) -> Status:
        if self.capacity is not None and len(self._q) >= self.capacity:
            return retry(ErrorCode.RETRY_QUEUE_FULL)
        self._q.append(status)
        self.pushes += 1
        return _ACCEPTED

    def signal_many(self, statuses: List[Status]) -> List[Status]:
        """Bulk enqueue: one capacity check + one deque extend for the
        accepted prefix (queue-full rejects the rest, in order)."""
        room = (len(statuses) if self.capacity is None
                else max(0, self.capacity - len(self._q)))
        n = min(room, len(statuses))
        self._q.extend(statuses if n == len(statuses) else statuses[:n])
        self.pushes += n
        return ([_ACCEPTED] * n
                + [retry(ErrorCode.RETRY_QUEUE_FULL)] * (len(statuses) - n))

    def pop(self) -> Status:
        """``cq_pop``: done-status with payload, or retry when empty."""
        tele = self.tele
        if tele.timers_on:
            with tele.span("cq.pop"):
                return self._pop()
        return self._pop()

    def _pop(self) -> Status:
        if not self._q:
            return retry(ErrorCode.RETRY_LOCKED)
        self.pops += 1
        return self._q.popleft()

    def test(self) -> tuple[bool, Optional[Status]]:
        """Non-destructive probe: (non-empty, front status or None)."""
        return bool(self._q), (self._q[0] if self._q else None)

    def wait(self, progress=None, max_rounds: int = 100_000) -> Status:
        """``cq_wait``: progress until non-empty, then pop one status."""
        super().wait(progress, max_rounds)
        return self.pop()

    def __len__(self) -> int:
        return len(self._q)


class Synchronizer(CompletionObject):
    """Synchronizer: becomes ready after ``expected`` signals.

    Paper: "similar to MPI requests but can accept multiple signals before
    becoming ready."
    """

    def __init__(self, expected: int = 1):
        if expected < 1:
            raise _attrs.AttrError(
                f"attribute 'expected' must be >= 1, got {expected}")
        self.expected = expected
        self._received: List[Status] = []
        self._error: Optional[BaseException] = None
        self._export_attr("expected", lambda: self.expected)
        self._export_attr("received", lambda: len(self._received))

    def signal(self, status: Status) -> Status:
        if len(self._received) >= self.expected:
            raise FatalError("synchronizer signaled past ready")
        self._received.append(status)
        return done()

    def fail(self, exc: BaseException) -> None:
        """Deliver a failure instead of a signal (e.g. the async
        checkpoint writer crashed): ready/test()/wait() re-raise it as a
        FatalError so a failed operation can never look complete."""
        self._error = exc

    def _check_failed(self) -> None:
        if self._error is not None:
            raise FatalError(f"synchronizer failed: "
                             f"{self._error!r}") from self._error

    @property
    def ready(self) -> bool:
        self._check_failed()
        return len(self._received) >= self.expected

    def test(self) -> tuple[bool, List[Status]]:
        """Nonblocking readiness check; payloads valid once ready."""
        return self.ready, list(self._received)

    def reset(self) -> None:
        self._received.clear()
        self._error = None


# ---------------------------------------------------------------------------
# Remote-completion registry — the MPMC array (paper §4.1.1).
#
# "rarely written but frequently read ... a write and append is protected by
# a lock to prevent missed writes, but read is lock-free.  Every resize
# swaps the old array with a new one that doubles the size."  We keep the
# doubling-growth array shape (reads index a plain list slot; appends may
# reallocate) because the Fig-5 benchmark and tests exercise its geometry.
# ---------------------------------------------------------------------------

class MPMCArray:
    """Append-mostly registry with doubling growth and O(1) reads."""

    def __init__(self, initial_cap: int = 8):
        self._arr: list = [None] * initial_cap
        self._n = 0
        self.resizes = 0

    def append(self, item: Any) -> int:
        if self._n == len(self._arr):
            old = self._arr
            self._arr = old + [None] * len(old)   # swap-with-doubled copy
            self.resizes += 1
        idx = self._n
        self._arr[idx] = item
        self._n += 1
        return idx

    def __getitem__(self, idx: int) -> Any:
        if idx >= self._n:
            raise FatalError(f"MPMCArray read past end: {idx} >= {self._n}")
        return self._arr[idx]

    def __len__(self) -> int:
        return self._n


# ---------------------------------------------------------------------------
# Functional synchronizer: a signal counter + fixed payload slots (the
# mirror of the reference's in-graph one).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SyncState:
    expected: torch.Tensor    # () int32
    received: torch.Tensor    # () int32
    payload: torch.Tensor     # (expected_max, width) float32


def init_sync(expected: int, width: int, max_signals: int = 0, *,
              device="cuda") -> SyncState:
    cap = max(expected, max_signals, 1)
    return SyncState(
        expected=torch.full((), expected, dtype=torch.int32, device=device),
        received=torch.zeros((), dtype=torch.int32, device=device),
        payload=torch.zeros((cap, width), dtype=torch.float32,
                            device=device))


def sync_signal(state: SyncState, record) -> SyncState:
    """Count one signal and store its record; signals past the payload's
    last slot overwrite that slot, as the reference's clamped index
    does."""
    pos = torch.clamp(state.received, max=state.payload.shape[0] - 1)
    row = torch.as_tensor(record, dtype=state.payload.dtype,
                          device=state.payload.device)
    row = row.expand(1, state.payload.shape[1])
    return SyncState(state.expected, state.received + 1,
                     state.payload.index_copy(0, pos.long().reshape(1),
                                              row))


def sync_ready(state: SyncState) -> torch.Tensor:
    return state.received >= state.expected
