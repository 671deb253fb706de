"""Backlog queue (paper §4.1.5) — storage for temporarily postponed requests.

The paper: "The backlog queue is used to store communication requests that
cannot be immediately submitted and cannot be back-propagated to the user
... LCI expects such scenarios to be rare, so we implement it with a simple
C++ queue with a spinlock. An atomic flag prevents the progress engine from
unnecessarily polling an empty backlog queue."

Host-side :class:`BacklogQueue` keeps that shape — and, since the
concurrency subsystem landed, the paper's exact locking: a deque guarded
by a spinlock-style :class:`~repro_torch.core.concurrency.TryLock`, with a real
:class:`~repro_torch.core.concurrency.AtomicFlag` empty-flag fast path so the
progress engine never takes the lock just to learn the queue is empty.
An optional capacity bound surfaces ``retry(RETRY_BACKLOG_FULL)`` on
``push`` — but never on ``push_front``: a requeue of an already-popped
item (a rejected signal redelivery, a still-full fabric) must not fail,
so the head push bypasses the capacity check.

The functional ring (:func:`init_ring` / :func:`ring_push` /
:func:`ring_pop`) is the tensor mirror of the reference's jitted ring:
plain functions on tensors that run on whatever device their inputs are
on, branch-free, returning a new ring rather than mutating the old one.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Optional

import torch

from .concurrency.atomics import AtomicFlag
from .concurrency.locks import TryLock
from .status import ErrorCode, Status, done, retry


class BacklogQueue:
    """Host-side backlog: thread-safe FIFO of postponed descriptors.

    Lock granularity (DESIGN.md §10): one spinlock per queue — the paper
    expects the backlog to be nearly always empty, so a finer structure
    would buy nothing.  The :attr:`empty_flag` read is lock-free.
    """

    def __init__(self, capacity: Optional[int] = None):
        self._q: collections.deque = collections.deque()
        self.capacity = capacity
        self.max_depth = 0          # telemetry: paper expects this to stay ~0
        self.lock = TryLock(name="backlog")
        self._empty = AtomicFlag(init=True)

    @property
    def empty_flag(self) -> bool:
        """The atomic-flag fast path: progress() checks this before polling
        (and before taking the lock)."""
        return self._empty.is_set()

    def push(self, item: Any) -> Status:
        with self.lock:
            if self.capacity is not None and len(self._q) >= self.capacity:
                return retry(ErrorCode.RETRY_BACKLOG_FULL)
            self._q.append(item)
            self.max_depth = max(self.max_depth, len(self._q))
            self._empty.clear()
        return done()

    def push_front(self, item: Any) -> Status:
        """Requeue at the head: a popped item that could not be processed
        goes back to its original position, preserving FIFO delivery.

        Never fails: the item was already accounted for when it was first
        pushed (or is owed a redelivery, e.g. a signal a full CQ rejected),
        so the capacity bound does not apply — rejecting a requeue would
        drop a completion the runtime has promised to deliver."""
        with self.lock:
            self._q.appendleft(item)
            self.max_depth = max(self.max_depth, len(self._q))
            self._empty.clear()
        return done()

    def pop(self) -> tuple[Any, Status]:
        if self._empty.is_set():                 # lock-free fast path
            return None, retry(ErrorCode.RETRY_LOCKED)
        with self.lock:
            if not self._q:
                return None, retry(ErrorCode.RETRY_LOCKED)
            item = self._q.popleft()
            if not self._q:
                self._empty.test_and_set()
            return item, done()

    def __len__(self) -> int:
        return len(self._q)


# ---------------------------------------------------------------------------
# Functional ring (the mirror of the reference's in-graph ring):
#
#   buf  (cap, width) int32/float payload records
#   head ()           int32  -- next pop position (monotone counter)
#   tail ()           int32  -- next push position (monotone counter)
#
# Indices wrap modulo cap; (tail - head) is the live count.  Every op is
# tensor arithmetic selected with ``torch.where`` and indexed with
# ``index_select`` / ``index_copy`` (no host branch, no index read back),
# so a ring on the card never syncs with the host, and every op returns a
# new ring: the old one stays valid, as the reference's values do.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Ring:
    buf: torch.Tensor
    head: torch.Tensor
    tail: torch.Tensor


def init_ring(cap: int, width: int, dtype=torch.int32, *,
              device="cuda") -> Ring:
    return Ring(buf=torch.zeros((cap, width), dtype=dtype, device=device),
                head=torch.zeros((), dtype=torch.int32, device=device),
                tail=torch.zeros((), dtype=torch.int32, device=device))


def ring_push(ring: Ring, record) -> tuple[Ring, torch.Tensor]:
    """Push one record. Returns (ring', status): 0 ok, 1 full (retry)."""
    cap = ring.buf.shape[0]
    ok = ring.tail - ring.head < cap
    pos = torch.remainder(ring.tail, cap).long().reshape(1)
    record = torch.as_tensor(record, dtype=ring.buf.dtype,
                             device=ring.buf.device)
    row = torch.where(ok, record, ring.buf.index_select(0, pos))
    return (Ring(ring.buf.index_copy(0, pos, row), ring.head,
                 ring.tail + ok.to(torch.int32)),
            torch.where(ok, 0, 1).to(torch.int32))


def ring_pop(ring: Ring) -> tuple[Ring, torch.Tensor, torch.Tensor]:
    """Pop one record. Returns (ring', record, status): 0 ok, 1 empty."""
    cap = ring.buf.shape[0]
    ok = ring.tail > ring.head
    pos = torch.remainder(ring.head, cap).long().reshape(1)
    row = ring.buf.index_select(0, pos)[0]
    rec = torch.where(ok, row, torch.zeros_like(row))
    return (Ring(ring.buf, ring.head + ok.to(torch.int32), ring.tail),
            rec, torch.where(ok, 0, 1).to(torch.int32))


def ring_size(ring: Ring) -> torch.Tensor:
    return ring.tail - ring.head
