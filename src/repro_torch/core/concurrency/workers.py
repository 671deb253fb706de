"""Multithreaded progress workers (paper §4.2.3).

The paper's discipline for driving progress from many threads: every
device carries a try-lock; any number of threads may call ``progress``,
and "a thread that fails the try-lock simply moves on" — to the next
device, or back to useful work — instead of waiting.  One device is
therefore never progressed by two threads at once (the engine's reaction
chain stays single-writer per device), yet progress work is *shared*:
whichever thread gets there first drains everyone's traffic, and the
others skip the redundant pass.

:class:`ProgressWorkerPool` packages that loop: N daemon threads sweep a
list of ``(engine, device)`` targets through
:meth:`~repro_torch.core.progress.engine.ProgressEngine.try_progress`, with a
per-worker rotation offset so workers start on different devices, and an
idle backoff so a quiet fabric doesn't spin the GIL.  Construct one
directly, from a runtime/cluster, or implicitly through
``EndpointSpec(progress="workers", n_workers=K)``.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence, Tuple

from .. import attrs as _attrs
from ..attrs import AttrError
from ..status import FatalError
from ..telemetry import NULL_SPAN as _NO_SPAN
from ..telemetry import NULL_TELEMETRY
from .atomics import AtomicCounter, AtomicFlag
from .locks import aggregate_lock_stats

_IDLE_SLEEP_MIN = 1e-5
_IDLE_SLEEP_MAX = 1e-3


class ProgressWorkerPool(_attrs.AttrResource):
    """N threads cooperatively driving progress over a set of devices.

    ``targets`` is a sequence of ``(engine, device)`` pairs; a device may
    appear under at most one engine (the usual dedicated split) or many
    devices under one shared engine — the per-device try-lock makes both
    safe.  Lifecycle: ``start()`` spawns daemon workers, ``stop()`` joins
    them (with a timeout so a wedged worker fails fast instead of hanging
    the caller), and the pool is reusable after ``stop()``.
    """

    def __init__(self, targets: Sequence[Tuple[object, object]],
                 n_workers: int = 2, name: str = "workers",
                 burst: Optional[int] = None,
                 resolved: Optional[_attrs.ResolvedAttrs] = None,
                 tele=None):
        if burst is None:
            burst = _attrs.resolve_one("worker_burst")
        if n_workers < 1:
            raise AttrError(
                f"attribute 'n_workers' must be >= 1 for a worker pool, "
                f"got {n_workers}")
        if not targets:
            raise FatalError("worker pool needs at least one "
                             "(engine, device) target")
        if burst < 0:
            raise AttrError("attribute 'worker_burst' must be >= 0 "
                            f"(0 = unbounded drain), got {burst}")
        self.targets = list(targets)
        self.n_workers = n_workers
        self.name = name
        self.tele = tele if tele is not None else NULL_TELEMETRY
        self._init_attrs(resolved or _attrs.resolved_from_values(
            {"n_workers": n_workers, "worker_burst": burst}))
        self._export_attr("n_targets", lambda: len(self.targets))
        self._export_attr("running", lambda: self.running)
        self._export_attr("lock_skips", lambda: self.lock_skips.load())
        self._export_attr("idle_naps", lambda: self.idle_naps.load())
        self._export_attr("contention", lambda: aggregate_lock_stats(
            dev.progress_lock for _, dev in self.targets))
        self._export_attr("telemetry", self._telemetry_block)
        # wire messages drained per try-lock acquisition: bounds how long
        # one worker holds a device's progress lock (a busy stream is
        # swept in bursts, not monopolized), while still amortizing the
        # lock + backlog sweep across the whole burst (paper §4.3)
        self.burst = burst
        self._threads: List[threading.Thread] = []
        self._stop = AtomicFlag()
        # telemetry
        self.worker_passes = [AtomicCounter() for _ in range(n_workers)]
        self.lock_skips = AtomicCounter()    # try-lock failures -> moved on
        self.idle_naps = AtomicCounter()

    # -- construction helpers ------------------------------------------------
    @classmethod
    def for_runtime(cls, runtime, n_workers: int = 2,
                    name: Optional[str] = None,
                    burst: Optional[int] = None) -> "ProgressWorkerPool":
        """Workers over every device of one runtime, via its shared engine."""
        return cls([(runtime.engine, d) for d in runtime.devices],
                   n_workers, name or f"rank{runtime.rank}/workers",
                   burst=burst, tele=getattr(runtime, "tele", None))

    @classmethod
    def for_cluster(cls, cluster, n_workers: int = 2,
                    name: str = "cluster/workers",
                    burst: Optional[int] = None) -> "ProgressWorkerPool":
        """Workers over every device of every rank (thread-mode testbed)."""
        targets = [(rt.engine, d) for rt in cluster.runtimes
                   for d in rt.devices]
        return cls(targets, n_workers, name, burst=burst,
                   tele=getattr(cluster, "tele", None))

    # -- lifecycle -----------------------------------------------------------
    @property
    def running(self) -> bool:
        return bool(self._threads)

    def start(self) -> "ProgressWorkerPool":
        if self._threads:
            raise FatalError(f"worker pool {self.name!r} already started")
        self._stop.clear()
        self._threads = [
            threading.Thread(target=self._run, args=(w,), daemon=True,
                             name=f"{self.name}/{w}")
            for w in range(self.n_workers)
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Signal and join all workers; a worker that fails to exit within
        ``timeout`` raises (deadlock should fail fast, not hang CI)."""
        if not self._threads:
            return
        self._stop.test_and_set()
        deadline = time.monotonic() + timeout
        stuck = []
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                stuck.append(t.name)
        self._threads = []
        if stuck:
            raise FatalError(f"progress workers failed to stop: {stuck}")

    def __enter__(self) -> "ProgressWorkerPool":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the worker loop -----------------------------------------------------
    def _run(self, wid: int) -> None:
        targets = self.targets
        n = len(targets)
        passes = self.worker_passes[wid]
        tele = self.tele
        delay = _IDLE_SLEEP_MIN
        while not self._stop.is_set():
            did = False
            # rotation offset decorrelates workers: worker w starts its
            # sweep w targets in, so two workers rarely hit the same
            # device's try-lock back to back
            with tele.span("worker.sweep") if tele.timers_on else _NO_SPAN:
                for i in range(n):
                    eng, dev = targets[(i + wid) % n]
                    r = eng.try_progress(dev, self.burst)
                    if r is None:
                        self.lock_skips.fetch_add(1)   # contended: move on
                    elif r:
                        passes.fetch_add(1)
                        did = True
            if did:
                delay = _IDLE_SLEEP_MIN
            else:
                self.idle_naps.fetch_add(1)
                with (tele.span("worker.nap") if tele.timers_on
                      else _NO_SPAN):
                    time.sleep(delay)              # quiet fabric: back off
                delay = min(delay * 2, _IDLE_SLEEP_MAX)

    # -- telemetry -----------------------------------------------------------
    def _telemetry_block(self) -> dict:
        return {"level": self.tele.level,
                "counters": {
                    "workers.passes": sum(c.load()
                                          for c in self.worker_passes),
                    "workers.lock_skips": self.lock_skips.load(),
                    "workers.idle_naps": self.idle_naps.load()}}

    def counters(self) -> dict:
        """Worker passes + the per-device progress-lock contention map."""
        return {
            "name": self.name,
            "n_workers": self.n_workers,
            "burst": self.burst,
            "worker_passes": [c.load() for c in self.worker_passes],
            "lock_skips": self.lock_skips.load(),
            "idle_naps": self.idle_naps.load(),
            "device_locks": aggregate_lock_stats(
                dev.progress_lock for _, dev in self.targets),
        }

    def __repr__(self) -> str:
        state = "running" if self.running else "stopped"
        return (f"ProgressWorkerPool({self.name!r}, n_workers="
                f"{self.n_workers}, targets={len(self.targets)}, {state})")
