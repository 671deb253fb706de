"""Unified observability plane (DESIGN.md §15).

One :class:`Telemetry` object per cluster (shared by every rank's
runtime unless a rank overrides ``telemetry_level``) bundles the three
storage layers and the level gate:

* :mod:`.counters` — the typed metric registry: per-thread-sharded
  counters and log2 histograms merged on read, plus *collectors* that
  fold the runtime's long-standing per-resource counters (device
  posts/pushes, protocol stats, pool/matching/lock telemetry) into the
  same snapshot, so one read surfaces everything.
* :mod:`.timers` — stage-scoped nesting spans over every hot path.
* :mod:`.trace` — the bounded event trace with Chrome export.

Levels compose upward (``off < counters < timers < trace``); the level
is an ordinary attribute (``telemetry_level``, env spelling
``REPRO_ATTR_TELEMETRY_LEVEL``) resolved through the four-layer chain.
``off`` is the contract the overhead gate enforces: every instrumented
call site pays one attribute read and a branch — ``span()`` returns the
:data:`~.timers.NULL_SPAN` singleton, ``add()`` returns immediately —
and the legacy counters (always on, they predate this layer) remain the
only bookkeeping.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Tuple

from .counters import (Histogram, MetricRegistry, merge_counters,
                       merge_hists, merge_snapshots, quantile_bound,
                       record_burst_mix)
from .timers import NULL_SPAN, SPAN_PREFIX, Span, summarize_spans
from .trace import TraceBuffer

#: telemetry levels, cheapest first; each includes everything before it
LEVELS = ("off", "counters", "timers", "trace")


class Telemetry:
    """The attr-controlled observability hub for one cluster/runtime."""

    __slots__ = ("level", "counters_on", "timers_on", "trace_on",
                 "registry", "trace", "_depth", "_collectors")

    def __init__(self, level: str = "off", trace_capacity: int = 4096):
        if level not in LEVELS:
            raise ValueError(f"unknown telemetry level {level!r}; "
                             f"expected one of {LEVELS}")
        rank = LEVELS.index(level)
        self.level = level
        self.counters_on = rank >= 1
        self.timers_on = rank >= 2
        self.trace_on = rank >= 3
        self.registry = MetricRegistry()
        self.trace = TraceBuffer(trace_capacity) if self.trace_on else None
        self._depth = threading.local()
        # (prefix, fn) pairs; fn() -> {name: number}.  Many resources may
        # share a prefix (every device attaches under "device"); the
        # snapshot sums overlapping keys, which is the aggregation the
        # BENCH block wants.
        self._collectors: List[Tuple[str, object]] = []

    # -- write side (hot paths branch on the *_on booleans) ------------------
    def span(self, stage: str):
        """A stage-scoped timer context manager; the NULL_SPAN singleton
        when timers are off (the zero-allocation fast path)."""
        if not self.timers_on:
            return NULL_SPAN
        return Span(self, stage)

    def add(self, name: str, n: int = 1) -> None:
        if self.counters_on:
            self.registry.add(name, n)

    def observe(self, name: str, value: int) -> None:
        if self.counters_on:
            self.registry.observe(name, value)

    # -- unification ---------------------------------------------------------
    def attach(self, prefix: str, fn) -> None:
        """Fold a legacy counter source into every snapshot: ``fn()``
        returns ``{name: number}``, surfaced as ``<prefix>.<name>`` and
        summed across sources sharing the prefix."""
        self._collectors.append((prefix, fn))

    def snapshot(self) -> Dict:
        """The raw, mergeable telemetry document:
        ``{"level", "counters", "spans"}`` — registry shards merged,
        collectors sampled, span histograms keyed by stage name."""
        raw = self.registry.snapshot()
        counters = dict(raw["counters"])
        for prefix, fn in self._collectors:
            for name, value in fn().items():
                if not isinstance(value, (int, float)):
                    continue
                key = f"{prefix}.{name}"
                counters[key] = counters.get(key, 0) + value
        spans = {name[len(SPAN_PREFIX):]: h
                 for name, h in raw["hists"].items()
                 if name.startswith(SPAN_PREFIX)}
        return {"level": self.level, "counters": counters, "spans": spans}

    # -- export --------------------------------------------------------------
    def chrome_trace(self, pid: int = 0) -> Dict:
        if self.trace is None:
            return {"traceEvents": [], "displayTimeUnit": "ms"}
        return self.trace.chrome_trace(pid)

    def export_trace(self, path: str, pid: int = 0) -> str:
        """Dump the Chrome ``trace_event`` JSON; returns ``path``."""
        import json
        with open(path, "w") as f:
            json.dump(self.chrome_trace(pid), f)
        return path

    def __repr__(self) -> str:
        return f"Telemetry(level={self.level!r})"


#: the shared do-nothing instance resources fall back to when their
#: owner never wired telemetry (directly-constructed pools, engines...)
NULL_TELEMETRY = Telemetry("off")


def render_block(snapshot: Dict) -> Dict:
    """Render a raw snapshot into the BENCH-JSON ``telemetry`` block:
    merged counters plus summarized stage timers (count/total/p50/p99)."""
    return {"level": snapshot.get("level", "off"),
            "counters": {k: snapshot["counters"][k]
                         for k in sorted(snapshot.get("counters", {}))},
            "spans": summarize_spans(snapshot.get("spans", {}))}


__all__ = [
    "LEVELS", "NULL_SPAN", "NULL_TELEMETRY", "SPAN_PREFIX",
    "Histogram", "MetricRegistry", "Span", "Telemetry", "TraceBuffer",
    "merge_counters", "merge_hists", "merge_snapshots",
    "quantile_bound", "record_burst_mix", "render_block",
    "summarize_spans",
]
