"""Ring-buffer event trace with Chrome ``trace_event`` export.

At ``telemetry_level=trace`` every stage span also emits one *complete*
event (name, start, duration) into a bounded per-thread ring: each
thread writes its own ring lock-free (the shard discipline of
:mod:`.counters`), capacity is ``trace_capacity`` events per thread, and
old events are overwritten in FIFO order — tracing a long run costs a
fixed amount of memory and keeps the *latest* window, which is the part
you want when something goes wrong at the end.

Export is the Chrome/Perfetto ``trace_event`` JSON array format
(load it at ``chrome://tracing`` or https://ui.perfetto.dev): one lane
(``tid``) per worker thread, one process group (``pid``) per rank, and
``"ph": "X"`` complete events whose stacking reconstructs span nesting.
"""
from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional


class _Ring:
    """One thread's bounded event ring (single-writer, wraparound)."""

    __slots__ = ("name", "capacity", "events", "next", "total")

    def __init__(self, name: str, capacity: int):
        self.name = name
        self.capacity = capacity
        self.events: List[Optional[tuple]] = [None] * capacity
        self.next = 0
        self.total = 0

    def emit(self, event: tuple) -> None:
        self.events[self.next] = event
        self.next = (self.next + 1) % self.capacity
        self.total += 1

    def ordered(self) -> List[tuple]:
        """Live events, oldest first (handles wraparound)."""
        if self.total < self.capacity:
            return [e for e in self.events[:self.next]]
        return ([e for e in self.events[self.next:]]
                + [e for e in self.events[:self.next]])


class TraceBuffer:
    """All threads' rings + the Chrome export."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("trace_capacity must be >= 1")
        self.capacity = capacity
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._rings: List[_Ring] = []

    def _ring(self) -> _Ring:
        ring = getattr(self._tls, "ring", None)
        if ring is None:
            ring = _Ring(threading.current_thread().name, self.capacity)
            with self._lock:
                self._rings.append(ring)
            self._tls.ring = ring
        return ring

    def emit(self, name: str, t0_ns: int, dur_ns: int,
             depth: int = 0) -> None:
        self._ring().emit((name, t0_ns, dur_ns, depth))

    def events(self) -> List[Dict]:
        """Merged view across lanes, sorted by start time."""
        with self._lock:
            rings = list(self._rings)
        out = []
        for ring in rings:
            for name, t0, dur, depth in ring.ordered():
                out.append({"name": name, "ts_ns": t0, "dur_ns": dur,
                            "lane": ring.name, "depth": depth})
        out.sort(key=lambda e: e["ts_ns"])
        return out

    def chrome_trace(self, pid: int = 0) -> Dict:
        """The ``trace_event`` document: one ``"X"`` (complete) event per
        span, lanes as ``tid``, timestamps in microseconds."""
        events = [{"name": e["name"], "ph": "X", "pid": pid,
                   "tid": e["lane"], "ts": e["ts_ns"] / 1e3,
                   "dur": e["dur_ns"] / 1e3} for e in self.events()]
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str, pid: int = 0) -> str:
        """Write the Chrome trace JSON to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(pid), f)
        return path
