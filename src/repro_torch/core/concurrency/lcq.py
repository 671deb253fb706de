"""LCQ (paper §4.1.4) — a fixed-size FAA-ticket MPMC queue.

The paper ships two completion-queue backends: "one based on the
state-of-the-art LCRQ and the other on a hand-written Fetch-And-Add-based
fix-sized array".  :class:`LCQ` is the second one: a fixed-size slot array
with monotone head/tail ticket counters.  Each slot carries a sequence
number; a producer claims a ticket from ``tail`` (CAS-guarded FAA — the
CPython stand-in for the x86 ``lock xadd``/CAS pair, see
:mod:`.atomics`), writes its payload, and publishes by bumping the slot
sequence.  A consumer symmetrically claims from ``head``.  The sequence
numbers are what make the design safe for *multiple* producers and
consumers: a ticket holder can always tell whether its slot is still
occupied by a straggling peer from the previous lap.

Both operations are non-blocking, per the paper's discipline: a full
queue surfaces ``retry(RETRY_QUEUE_FULL)`` to the producer (the progress
engine parks the completion in the backlog) and an empty queue surfaces
``retry`` to the consumer — nothing ever blocks or is dropped.

:class:`ThreadSafeCompletionQueue` wraps an LCQ in the unified ``comp``
protocol so it is a drop-in, thread-safe replacement for the host
:class:`~repro_torch.core.completion.CompletionQueue` — allocate one with
``Runtime.alloc_cq(threadsafe=True)`` when worker threads will signal or
drain it concurrently.
"""
from __future__ import annotations

import time
from typing import Any, List, Optional

from ..completion import CompletionObject
from ..status import ErrorCode, Status, done, retry
from .atomics import AtomicCounter

_EMPTY = object()          # slot sentinel distinct from any user payload

# shared signal ack: Status is immutable, and signalers only ever branch
# on is_retry()/code — one object serves every accepted delivery instead
# of a constructor call per completion on the hot path
_ACCEPTED = done()

# pop-side liveness bound: when the queue *looks* non-empty (a producer
# claimed a ticket) but nothing is published yet, spin at most this many
# failed pops before yielding the core to the mid-ticket producer
_POP_SPIN_LIMIT = 16
_POP_YIELD_SLEEP = 1e-5


class _Slot:
    __slots__ = ("seq", "data")

    def __init__(self, seq: int):
        self.seq = seq
        self.data = _EMPTY


class LCQ:
    """Fixed-size FAA-ticket MPMC queue of arbitrary Python objects.

    ``push``/``pop`` return in-graph-style int statuses alongside their
    results so hot loops can branch cheaply; the completion-queue wrapper
    translates them into the ternary Status protocol.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("LCQ capacity must be >= 1")
        self.capacity = capacity
        self._slots = [_Slot(i) for i in range(capacity)]
        self._head = AtomicCounter()
        self._tail = AtomicCounter()
        # telemetry: ticket races lost (the "contention" of a lock-free
        # structure — a CAS that failed and had to re-read)
        self.push_races = AtomicCounter()
        self.pop_races = AtomicCounter()

    def push(self, item: Any) -> bool:
        """Non-blocking enqueue; False when the queue is full."""
        cap = self.capacity
        while True:
            pos = self._tail.load()
            slot = self._slots[pos % cap]
            dif = slot.seq - pos
            if dif == 0:
                # slot free for this lap: claim the ticket
                if self._tail.compare_exchange(pos, pos + 1):
                    slot.data = item
                    slot.seq = pos + 1        # publish
                    return True
                self.push_races.fetch_add(1)  # lost the ticket race
            elif dif < 0:
                return False                  # a full lap behind: full
            # dif > 0: a racing producer claimed pos but the counter
            # already moved on — re-read the tail

    def push_many(self, items: List[Any]) -> int:
        """Bulk enqueue: claim a run of tickets with ONE tail CAS.

        Scans the free-slot prefix for this lap, then advances ``tail``
        by the whole run at once — K messages pay one ticket claim
        instead of K (the FAA-amortization the fused doorbells already
        apply to pool lanes and the fabric, here on the completion
        queue).  The scan-then-CAS is safe: a scanned-free slot can only
        change state via a producer *publish*, and publishing requires a
        ticket from the very CAS we are about to attempt — if any racing
        producer got in first, our CAS fails and we re-scan.

        Returns the number of items accepted (always a prefix; 0 when
        full).  A short count means the queue ran out of free slots —
        the caller retries the remainder, exactly like a failed
        ``push``."""
        cap = self.capacity
        n = len(items)
        while True:
            pos = self._tail.load()
            k = 0
            while k < n:
                slot = self._slots[(pos + k) % cap]
                if slot.seq != pos + k:
                    break
                k += 1
            if k == 0:
                if self._slots[pos % cap].seq - pos < 0:
                    return 0                  # a full lap behind: full
                continue                      # stale tail: re-read
            if self._tail.compare_exchange(pos, pos + k):
                for i in range(k):
                    slot = self._slots[(pos + i) % cap]
                    slot.data = items[i]
                    slot.seq = pos + i + 1    # publish
                return k
            self.push_races.fetch_add(1)

    def pop(self) -> tuple[Any, bool]:
        """Non-blocking dequeue; (None, False) when empty."""
        cap = self.capacity
        while True:
            pos = self._head.load()
            slot = self._slots[pos % cap]
            dif = slot.seq - (pos + 1)
            if dif == 0:
                if self._head.compare_exchange(pos, pos + 1):
                    item = slot.data
                    slot.data = _EMPTY
                    slot.seq = pos + cap      # free the slot for next lap
                    return item, True
                self.pop_races.fetch_add(1)
            elif dif < 0:
                return None, False            # nothing published yet: empty
            # dif > 0: re-read the head

    def pop_many(self, limit: int = 0) -> List[Any]:
        """Bulk dequeue: claim a run of published slots with ONE head
        CAS (mirror of :meth:`push_many`; same scan-then-CAS argument —
        a scanned-published slot can only be consumed via a head ticket,
        and a racing consumer fails our CAS).  Returns up to ``limit``
        items (all published when 0); ``[]`` when empty."""
        cap = self.capacity
        lim = min(limit, cap) if limit else cap
        while True:
            pos = self._head.load()
            k = 0
            while k < lim:
                slot = self._slots[(pos + k) % cap]
                if slot.seq != pos + k + 1:
                    break
                k += 1
            if k == 0:
                if self._slots[pos % cap].seq - (pos + 1) < 0:
                    return []                 # nothing published: empty
                continue                      # stale head: re-read
            if self._head.compare_exchange(pos, pos + k):
                out: List[Any] = []
                for i in range(k):
                    slot = self._slots[(pos + i) % cap]
                    out.append(slot.data)
                    slot.data = _EMPTY
                    slot.seq = pos + i + cap  # free for the next lap
                return out
            self.pop_races.fetch_add(1)

    def __len__(self) -> int:
        return max(0, self._tail.load() - self._head.load())

    @property
    def pushes(self) -> int:
        """Total accepted pushes (the tail ticket counter)."""
        return self._tail.load()

    @property
    def pops(self) -> int:
        return self._head.load()

    def __repr__(self) -> str:
        return f"LCQ(cap={self.capacity}, live={len(self)})"


class ThreadSafeCompletionQueue(CompletionObject):
    """The LCQ as a completion object — a thread-safe ``alloc_cq`` result.

    Same surface as the host :class:`~repro_torch.core.completion.CompletionQueue`
    (``signal``/``pop``/``test``/``wait``/``len``), but every method is
    safe under concurrent signalers *and* concurrent poppers: the serving
    scheduler drains client CQs from worker threads through exactly this
    object.
    """

    def __init__(self, capacity: Optional[int] = None, resolved=None,
                 tele=None):
        self._q = LCQ(capacity or 4096)
        self.capacity = capacity
        self._pop_yields = AtomicCounter()
        from .. import attrs as _attrs
        from ..telemetry import NULL_TELEMETRY
        self.tele = tele if tele is not None else NULL_TELEMETRY
        self._init_attrs(resolved or _attrs.resolved_from_values(
            {"cq_capacity": capacity or 0}))
        self._export_attr("depth", lambda: len(self._q))
        self._export_attr("pop_yields", lambda: self.pop_yields)
        self._export_attr("threadsafe", lambda: True)
        self._export_attr("telemetry", self._telemetry_block)

    def _telemetry_block(self) -> dict:
        races = self.races()
        return {"level": self.tele.level,
                "counters": {"cq.pushes": self.pushes,
                             "cq.pops": self.pops,
                             "cq.depth": len(self._q),
                             "cq.pop_yields": self.pop_yields,
                             "cq.push_races": races["push_races"],
                             "cq.pop_races": races["pop_races"]}}

    def signal(self, status: Status) -> Status:
        if self._q.push(status):
            return _ACCEPTED
        return retry(ErrorCode.RETRY_QUEUE_FULL)

    def signal_many(self, statuses: List[Status]) -> List[Status]:
        """Bulk admission through :meth:`LCQ.push_many`: the whole burst
        claims its tickets with one tail CAS, and the ack statuses are a
        shared immutable ``done()`` — K completions, O(1) atomics and
        zero per-row constructions.  Acceptance stays a prefix (the LCQ
        accepts a free-slot prefix), matching the base contract."""
        n = self._q.push_many(statuses) if statuses else 0
        if n == len(statuses):
            return [_ACCEPTED] * n
        return ([_ACCEPTED] * n
                + [retry(ErrorCode.RETRY_QUEUE_FULL)] * (len(statuses) - n))

    def pop(self) -> Status:
        tele = self.tele
        if tele.timers_on:
            with tele.span("cq.pop"):
                return self._pop()
        return self._pop()

    def _pop(self) -> Status:
        item, ok = self._q.pop()
        if not ok:
            return retry(ErrorCode.RETRY_LOCKED)
        return item

    def pop_many(self, limit: int = 0) -> List[Status]:
        """Bulk drain through :meth:`LCQ.pop_many`: one head CAS claims
        every published completion (up to ``limit``).  ``[]`` when
        empty — the consumer-side mirror of :meth:`signal_many`."""
        return self._q.pop_many(limit)

    def test(self) -> tuple[bool, Optional[Status]]:
        """Non-destructive probe: under concurrency the front item may be
        popped by a peer between test() and pop() — ready=True only means
        the queue *was* non-empty."""
        return len(self._q) > 0, None

    def wait(self, progress=None, max_rounds: int = 100_000) -> Status:
        spins = 0
        while True:
            super().wait(progress, max_rounds)
            st = self.pop()
            if not st.is_retry():
                return st
            # pop failed even though test() saw the queue non-empty.
            # Either a concurrent popper won the race for that item, or —
            # under burst signaling — a producer holds a claimed-but-
            # unpublished ticket (len() counts the ticket, pop() sees an
            # unpublished slot).  In the latter case looping here would
            # busy-spin exactly as long as the producer stays descheduled,
            # so: bounded spin, then yield the core to let it publish.
            spins += 1
            if spins > _POP_SPIN_LIMIT:
                self._pop_yields.fetch_add(1)
                time.sleep(_POP_YIELD_SLEEP)

    @property
    def pushes(self) -> int:
        return self._q.pushes

    @property
    def pops(self) -> int:
        return self._q.pops

    @property
    def pop_yields(self) -> int:
        """Times a ``wait`` pop spun out against a mid-ticket producer
        and yielded (liveness telemetry for the spin-bound regression)."""
        return self._pop_yields.load()

    def races(self) -> dict:
        return {"push_races": self._q.push_races.load(),
                "pop_races": self._q.pop_races.load()}

    def __len__(self) -> int:
        return len(self._q)


def drain(cq, limit: int = 0) -> List[Status]:
    """Pop done-statuses until empty (or ``limit``); never blocks."""
    pop_many = getattr(cq, "pop_many", None)
    if pop_many is not None:                  # bulk claim: one head CAS
        return pop_many(limit)
    out: List[Status] = []
    while not limit or len(out) < limit:
        st = cq.pop()
        if st.is_retry():
            break
        out.append(st)
    return out
