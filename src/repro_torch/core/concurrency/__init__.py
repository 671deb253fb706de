"""Threading-efficient runtime primitives (paper §4.1–§4.2).

The paper's headline: a runtime "built on atomic data structures,
fine-grained non-blocking locks, and low-level network insights".  This
package is that machinery with real Python threads:

* :mod:`.locks`   — :class:`TryLock`, the non-blocking lock with
  contention counters and a spin-backoff blocking fallback (§4.1.1).
* :mod:`.atomics` — atomic counter / flag / bounded-credit primitives
  behind one lock-free-style API.
* :mod:`.lcq`     — the Fetch-And-Add fixed-size MPMC queue (§4.1.4) and
  the thread-safe completion-queue backend built on it.
* :mod:`.workers` — :class:`ProgressWorkerPool`: N threads driving
  progress engines through per-device try-locks (§4.2.3: a thread that
  fails the try-lock moves on).

The structures it hardens live next door: the packet pool's per-lane
deques with try-lock steal-half, the matching engine's per-bucket locks,
and the backlog queue's atomic empty flag.  DESIGN.md §10 maps which
structure holds which lock and where the GIL caveats apply.
"""
from .atomics import AtomicCounter, AtomicCredit, AtomicFlag
from .lcq import LCQ, ThreadSafeCompletionQueue, drain
from .locks import TryLock, aggregate_lock_stats
from .workers import ProgressWorkerPool

__all__ = [
    "AtomicCounter", "AtomicCredit", "AtomicFlag",
    "LCQ", "ThreadSafeCompletionQueue", "drain",
    "TryLock", "aggregate_lock_stats",
    "ProgressWorkerPool",
]
