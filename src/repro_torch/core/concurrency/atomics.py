"""Atomic primitives (paper §4.1) — counters, flags, bounded credits.

The paper's runtime is "built on atomic data structures": C++ atomics
(fetch-and-add tickets, test-and-set flags, compare-exchange loops) show
up in the completion queue (§4.1.4), the backlog queue's empty flag
(§4.1.5), and the MPMC registry (§4.1.1).  CPython has no public atomic
ints, so every primitive here presents the *lock-free-style API* (``load``
/ ``store`` / ``fetch_add`` / ``compare_exchange`` / ``test_and_set``)
while internally sequencing writers with one tiny ``threading.Lock`` per
object.  Reads are deliberately lock-free: under the GIL a plain attribute
read is atomic and always observes a fully written value, which is exactly
the paper's "write under a lock, read lock-free" MPMC-array discipline.

GIL caveat (see DESIGN.md §10): these objects provide *correctness*
(linearizable updates, exact counters), not hardware parallelism.  The
contention behaviour they expose — try-lock failure rates, FAA ticket
races — is real, because the GIL preempts between bytecodes.
"""
from __future__ import annotations

import threading


class AtomicCounter:
    """An atomic integer: FAA tickets, exact multi-writer telemetry.

    ``fetch_add`` returns the *old* value (the FAA ticket); ``add``
    returns the new one.  ``compare_exchange`` is the CAS used by the
    LCQ head/tail loops.
    """

    __slots__ = ("_value", "_lock")

    def __init__(self, value: int = 0):
        self._value = value
        self._lock = threading.Lock()

    def load(self) -> int:
        return self._value            # GIL: reads never tear

    @property
    def value(self) -> int:
        return self._value

    def store(self, value: int) -> None:
        with self._lock:
            self._value = value

    def fetch_add(self, n: int = 1) -> int:
        with self._lock:
            old = self._value
            self._value = old + n
            return old

    def add(self, n: int = 1) -> int:
        return self.fetch_add(n) + n

    def compare_exchange(self, expected: int, desired: int) -> bool:
        """CAS: if the value equals ``expected``, set ``desired``."""
        with self._lock:
            if self._value != expected:
                return False
            self._value = desired
            return True

    def __int__(self) -> int:
        return self._value

    def __repr__(self) -> str:
        return f"AtomicCounter({self._value})"


class AtomicFlag:
    """Test-and-set flag — the backlog queue's §4.1.5 empty-flag analogue."""

    __slots__ = ("_set", "_lock")

    def __init__(self, init: bool = False):
        self._set = init
        self._lock = threading.Lock()

    def test_and_set(self) -> bool:
        """Set the flag; returns the *previous* value."""
        with self._lock:
            old = self._set
            self._set = True
            return old

    def clear(self) -> None:
        with self._lock:
            self._set = False

    def is_set(self) -> bool:
        return self._set              # lock-free read

    def __bool__(self) -> bool:
        return self._set

    def __repr__(self) -> str:
        return f"AtomicFlag({self._set})"


class AtomicCredit:
    """Bounded credit counter: non-blocking acquire against a capacity.

    The atomic analogue of a counting semaphore whose ``acquire`` never
    blocks — a full resource surfaces *retry* to the caller (the paper's
    back-pressure discipline) instead of a wait.  Used to bound
    completion-queue and backlog capacities under concurrent writers
    without a full lock around the data structure.
    """

    __slots__ = ("limit", "_used", "_lock")

    def __init__(self, limit: int):
        if limit < 1:
            raise ValueError("credit limit must be >= 1")
        self.limit = limit
        self._used = 0
        self._lock = threading.Lock()

    def try_acquire(self, n: int = 1) -> bool:
        with self._lock:
            if self._used + n > self.limit:
                return False
            self._used += n
            return True

    def release(self, n: int = 1) -> None:
        with self._lock:
            self._used = max(0, self._used - n)

    @property
    def used(self) -> int:
        return self._used

    @property
    def available(self) -> int:
        return self.limit - self._used

    def __repr__(self) -> str:
        return f"AtomicCredit({self._used}/{self.limit})"
