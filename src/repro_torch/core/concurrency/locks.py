"""Non-blocking try-locks (paper §4.1.1) with contention telemetry.

The paper: "LCI uses fine-grained non-blocking locks (try-locks) to
protect shared resources.  A thread that fails to acquire a lock does not
wait: it either returns a retry status to the user or moves on to other
work."  Blocking acquisition exists only as a fallback for paths that
cannot fail (e.g. a matching-engine insert), and even there it spins with
exponential backoff rather than parking the thread.

:class:`TryLock` is that lock, instrumented: every acquisition, failed
try, and backoff spin is counted, so benchmarks can emit the per-lock
contention telemetry the paper uses to argue the runtime is
threading-efficient (Figs 2/3).  ``reentrant=True`` backs the lock with
an RLock — used for the per-device progress lock, where a progress pass
may be re-entered by the same thread through a completion callback.
"""
from __future__ import annotations

import threading
import time

from .. import attrs as _attrs
from .atomics import AtomicCounter

# backoff schedule for the blocking fallback: a few pure spins (cheap,
# catches short critical sections), then sleeps doubling up to 1 ms.
# Attribute-tunable (env mutability: process-wide, read at construction):
# lock_spin_count / lock_backoff_max in the DESIGN.md §12 registry.
_BACKOFF_MIN = 1e-6


class TryLock:
    """A non-blocking lock with acquisition/contention counters.

    * ``try_acquire()`` — the paper's primary operation: never blocks,
      returns False immediately when the lock is held.
    * ``acquire()`` — spin-backoff blocking fallback for must-succeed
      paths; also the context-manager entry.
    * ``release()`` / context-manager exit.

    Counters: ``acquisitions`` (successful acquires, exact — only the
    holder increments), ``contentions`` (failed try-acquires, atomic),
    ``spins`` (backoff iterations inside blocking acquires, atomic).
    """

    def __init__(self, name: str = "lock", reentrant: bool = False,
                 spin_count: int = None, backoff_max: float = None):
        self.name = name
        self._lock = threading.RLock() if reentrant else threading.Lock()
        # spin/backoff tuning resolves through the attribute system
        # (default -> REPRO_ATTR_LOCK_*); explicit args win
        self.spin_count = (spin_count if spin_count is not None
                           else _attrs.resolve_one("lock_spin_count"))
        self.backoff_max = (backoff_max if backoff_max is not None
                            else _attrs.resolve_one("lock_backoff_max"))
        self.acquisitions = 0
        self._contentions = AtomicCounter()
        self._spins = AtomicCounter()

    @property
    def contentions(self) -> int:
        return self._contentions.load()

    @property
    def spins(self) -> int:
        return self._spins.load()

    def try_acquire(self) -> bool:
        """One non-blocking attempt; a failure is a counted contention."""
        if self._lock.acquire(blocking=False):
            self.acquisitions += 1
            return True
        self._contentions.fetch_add(1)
        return False

    def acquire(self) -> None:
        """Blocking fallback: spin, then exponential backoff."""
        if self._lock.acquire(blocking=False):
            self.acquisitions += 1
            return
        self._contentions.fetch_add(1)
        delay = _BACKOFF_MIN
        spins = 0
        while True:
            spins += 1
            if spins > self.spin_count:
                time.sleep(delay)
                delay = min(delay * 2, self.backoff_max)
            if self._lock.acquire(blocking=False):
                self._spins.fetch_add(spins)
                self.acquisitions += 1
                return

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "TryLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def stats(self) -> dict:
        """Per-lock telemetry row (benchmarks aggregate these)."""
        return {"name": self.name, "acquisitions": self.acquisitions,
                "contentions": self.contentions, "spins": self.spins}

    def __repr__(self) -> str:
        return (f"TryLock({self.name!r}, acq={self.acquisitions}, "
                f"contended={self.contentions})")


def aggregate_lock_stats(locks) -> dict:
    """Sum telemetry over a group of locks (one benchmark JSON cell)."""
    total = {"locks": 0, "acquisitions": 0, "contentions": 0, "spins": 0}
    for lk in locks:
        total["locks"] += 1
        total["acquisitions"] += lk.acquisitions
        total["contentions"] += lk.contentions
        total["spins"] += lk.spins
    return total
