"""Straggler detection & mitigation hooks (DESIGN.md §7).

On a real multi-pod job, per-step wall times are collected per host; a
host whose step times drift beyond a z-score threshold is flagged so the
launcher can (a) exclude it at the next elastic reshard, or (b) re-issue
its data shard through the backlog-queue path.  Here the monitor is the
single-process version of that machinery, used by the train loop and
covered by unit tests; the launcher consumes ``flagged``.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Deque, Dict, List, Optional


@dataclasses.dataclass
class StragglerReport:
    step: int
    dt: float
    mean: float
    std: float
    zscore: float


class StepTimeMonitor:
    """Sliding-window z-score flagging of slow steps/hosts."""

    def __init__(self, window: int = 50, z_threshold: float = 3.0,
                 warmup: int = 5):
        self.window = window
        self.z_threshold = z_threshold
        self.warmup = warmup
        self._times: Deque[float] = collections.deque(maxlen=window)
        self.reports: List[StragglerReport] = []
        self.flagged: List[StragglerReport] = []
        self._n = 0

    def record(self, step: int, dt: float) -> Optional[StragglerReport]:
        self._n += 1
        if len(self._times) >= self.warmup:
            mean = sum(self._times) / len(self._times)
            var = sum((t - mean) ** 2 for t in self._times) / len(self._times)
            std = math.sqrt(var)
            z = (dt - mean) / std if std > 1e-12 else 0.0
            rep = StragglerReport(step, dt, mean, std, z)
            self.reports.append(rep)
            if z > self.z_threshold:
                # flagged samples stay OUT of the window: a straggler
                # folded into the baseline inflates mean/std and masks
                # the next straggler (two slow steps in a row would
                # normalize each other)
                self.flagged.append(rep)
                return rep
        self._times.append(dt)
        return None

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {"mean": 0.0, "n": 0, "flagged": 0}
        return {"mean": sum(self._times) / len(self._times),
                "n": self._n, "flagged": len(self.flagged)}


class HostWatchdog:
    """Heartbeat bookkeeping for the launcher's failure detector.

    Hosts post monotonically increasing step heartbeats; ``dead_hosts``
    returns hosts whose heartbeat lags the median by more than ``grace``
    steps — the launcher restarts from the last committed checkpoint with
    the surviving host set (elastic restore handles the re-shard).
    """

    def __init__(self, n_hosts: int, grace: int = 10):
        self.n_hosts = n_hosts
        self.grace = grace
        self.heartbeat: Dict[int, int] = {h: 0 for h in range(n_hosts)}

    def beat(self, host: int, step: int) -> None:
        self.heartbeat[host] = max(self.heartbeat[host], step)

    def dead_hosts(self) -> List[int]:
        beats = sorted(self.heartbeat.values())
        median = beats[len(beats) // 2]
        return [h for h, b in self.heartbeat.items()
                if median - b > self.grace]
