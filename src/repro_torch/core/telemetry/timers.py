"""Stage-scoped timer spans (DESIGN.md §15).

``with tele.span("post_burst"): ...`` times one stage and records the
duration into the metric registry's log2 histogram for that stage
(key ``span:<stage>``).  Spans nest: each thread keeps a depth counter,
and at trace level every span also emits one complete event into the
trace ring, so the Chrome timeline shows the nesting as stacked slices.

The off-level fast path is the whole design: :meth:`Telemetry.span`
returns the module-level :data:`NULL_SPAN` singleton when timers are
disabled — no allocation, no clock read, nothing but one attribute
branch at the call site.

Stage taxonomy (what the hot paths are instrumented with):

========================  ====================================================
``post``                  one scalar ``ProgressEngine.post``
``post_burst``            one ``post_burst`` doorbell (fused or scalar runs)
``progress``              one full progress pass (outer span)
``progress.backlog``      backlog redelivery sub-stage
``progress.tx_sweep``     source-completion sweep sub-stage
``progress.drain``        fabric drain + reaction-chain sub-stage
``transport.push``        one fabric try_push/push_burst/push_packed
``transport.drain``       one fabric drain call (any backend)
``pool.get``              packet pool get/get_n (lane lock + steal)
``pool.put``              packet pool put/put_n
``match.now``             lock-free pre-posted-recv probe
``match.insert``          bucket-locked matching insert
``cq.pop``                one completion-queue pop
``signal``                one batched completion delivery (signal_many)
``worker.sweep``          one worker pass over its (engine, device) targets
``worker.nap``            one idle-backoff sleep in the worker loop
========================  ====================================================
"""
from __future__ import annotations

import time
from typing import Dict

from .counters import quantile_bound

#: histogram key prefix for stage spans
SPAN_PREFIX = "span:"


class _NullSpan:
    """The compiled-away span: a no-op context manager singleton."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Span:
    """One live stage measurement (constructed only when timers are on).
    The owning telemetry's ``_depth`` thread-local tracks nesting."""

    __slots__ = ("_tele", "stage", "_t0")

    def __init__(self, tele, stage: str):
        self._tele = tele
        self.stage = stage

    def __enter__(self):
        d = self._tele._depth
        d.depth = getattr(d, "depth", 0) + 1
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tele = self._tele
        tele._depth.depth -= 1
        dur = t1 - self._t0
        tele.registry.observe(SPAN_PREFIX + self.stage, dur)
        if tele.trace is not None:
            tele.trace.emit(self.stage, self._t0, dur,
                            depth=tele._depth.depth)
        return False


def summarize_spans(spans: Dict[str, Dict]) -> Dict[str, Dict]:
    """Render raw span histograms (``{stage: {count, sum, buckets}}``)
    into the BENCH-JSON summary: count, total time, and p50/p99 bucket
    estimates in microseconds; the sparse buckets ride along so merged
    documents stay re-mergeable."""
    out: Dict[str, Dict] = {}
    for stage, h in sorted(spans.items()):
        buckets = h.get("buckets", {})
        out[stage] = {
            "count": h.get("count", 0),
            "total_us": round(h.get("sum", 0) / 1e3, 3),
            "p50_us": round(quantile_bound(buckets, 0.50) / 1e3, 3),
            "p99_us": round(quantile_bound(buckets, 0.99) / 1e3, 3),
            "buckets": buckets,
        }
    return out
