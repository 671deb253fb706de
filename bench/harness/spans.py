"""The program's own spans in a traced stretch, and the device work that
each one launched.

The program (``repro_torch.core.telemetry``) marks its parts with spans
when its hub is active at ``trace`` level: each is a ``record_function``
named ``repro:<stage>`` on the thread that ran it (the caller's, or
autograd's backward thread), on the profiler's clock.  From a
``torch.profiler`` trace this module takes, beside what
:func:`.trace.from_events` takes:

- the program's spans, with their thread;
- for each device op, the runtime call that launched it (``cudaLaunch*``,
  ``cudaMemcpyAsync``, ...: the host event with the op's
  ``correlation_id``), so its host time and thread.

Each device op in the stretch is charged to the innermost program span
open on its launching thread when it was launched; where that thread had
none open, to the innermost one open on any thread (a kernel that
autograd's thread launches outside a recompute belongs to the caller's
``train.backward``); else to ``unattributed``.  The idle gaps are named
as :func:`.trace.idle_gaps` names them, with the innermost program span
the host was in, where one was open, in place of the harness span.  On a
trace without program spans every reading here is what :mod:`.trace`
reads, or nothing.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from . import trace as trace_mod

PREFIX = "repro:"
UNATTRIBUTED = "unattributed"
#: the CUDA runtime and driver calls that launch device work
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")


@dataclasses.dataclass
class HostSpan:
    name: str            # the stage, without the prefix
    start: int           # ns, the profiler's clock
    end: int
    tid: int


@dataclasses.dataclass
class Spans:
    """A traced stretch with the program's spans and the launches."""
    trace: trace_mod.Trace
    program: List[HostSpan]                    # by start
    #: per op of ``trace.device``: (host ns, thread) of its launch
    launches: List[Optional[Tuple[int, int]]]


def _method(e, name: str, default=None):
    fn = getattr(e, name, None)
    return fn() if fn is not None else default


def from_events(events: Iterable) -> Spans:
    """:func:`.trace.from_events` of ``events``, with the program's spans
    and each device op's launch.  Events without a correlation id or a
    thread (an older profiler) give ops with no launch."""
    events = list(events)
    base = trace_mod.from_events(events)
    cpu = torch.autograd.DeviceType.CPU
    program: List[HostSpan] = []
    runtime: Dict[int, Tuple[int, int]] = {}
    corr: Dict[Tuple[str, int, int], int] = {}
    for e in events:
        name, start = e.name(), int(e.start_ns())
        end = start + int(e.duration_ns())
        if e.device_type() == cpu:
            if e.is_user_annotation():
                if name.startswith(PREFIX):
                    program.append(HostSpan(name[len(PREFIX):], start, end,
                                            _method(e, "start_thread_id", 0)))
            elif _RUNTIME.match(name):
                c = _method(e, "correlation_id")
                if c:
                    runtime[c] = (start, _method(e, "start_thread_id", 0))
        elif not e.is_user_annotation():
            c = _method(e, "correlation_id")
            if c:
                corr[(name, start, end)] = c
    program.sort(key=lambda s: (s.start, -s.end))
    launches = [runtime.get(corr.get((d.name, d.start, d.end), 0))
                for d in base.device]
    return Spans(base, program, launches)


def from_profiler(prof) -> Spans:
    return from_events(prof.profiler.kineto_results.events())


class _Open:
    """The innermost of a set of properly nested spans open at a time."""

    def __init__(self, spans: Sequence[HostSpan]):
        self.spans = sorted(spans, key=lambda s: (s.start, -s.end))
        self.starts = [s.start for s in self.spans]
        self.parent: List[int] = []
        stack: List[int] = []
        for i, s in enumerate(self.spans):
            while stack and self.spans[stack[-1]].end <= s.start:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: int) -> Optional[HostSpan]:
        i = bisect.bisect_right(self.starts, t) - 1
        # the innermost span open at t encloses the last one begun
        # before it: walk out until one is still open
        while i >= 0 and self.spans[i].end <= t:
            i = self.parent[i]
        return self.spans[i] if i >= 0 else None


class Attribution:
    """The program span a time on a thread belongs to."""

    def __init__(self, program: Sequence[HostSpan]):
        by: Dict[int, List[HostSpan]] = {}
        for s in program:
            by.setdefault(s.tid, []).append(s)
        self.threads = {tid: _Open(spans) for tid, spans in by.items()}

    def at(self, t: int, tid: Optional[int] = None) -> Optional[HostSpan]:
        """The innermost span open at ``t`` on ``tid``; where it has none,
        the innermost (latest begun) open on any thread."""
        own = self.threads.get(tid)
        hit = own.at(t) if own is not None else None
        if hit is not None:
            return hit
        best = None
        for o in self.threads.values():
            s = o.at(t)
            if s is not None and (best is None or s.start > best.start):
                best = s
        return best


def _ops(sp: Spans) -> List[Tuple[trace_mod.Event, int, Optional[int],
                                    str]]:
    """Each device op of the stretch: (op, its ns of the busy time, the
    host ns of its launch, the span it is charged to).  Each instant of
    :func:`.trace.busy_ns` goes to one op, the one that began first where
    two overlap, so the ns sum to the busy time."""
    win = sp.trace.window
    if win is None:
        return []
    lo, hi = win
    att = Attribution(sp.program)
    out, cursor = [], lo
    for ev, launch in zip(sp.trace.device, sp.launches):   # by start
        if ev.end <= lo or ev.start >= hi:
            continue
        ns = max(0, min(ev.end, hi) - max(ev.start, cursor))
        cursor = max(cursor, min(ev.end, hi))
        span = att.at(*launch) if launch is not None else None
        out.append((ev, ns, launch[0] if launch is not None else None,
                    span.name if span is not None else UNATTRIBUTED))
    return out


def charged(sp: Spans) -> List[Tuple[trace_mod.Event, str]]:
    """Each device op of the stretch with the span it is charged to."""
    return [(ev, name) for ev, _, _, name in _ops(sp)]


def device_ns(sp: Spans) -> Dict[str, int]:
    """Device ns of the stretch by the span each op is charged to; the
    values sum to the busy time."""
    out: Dict[str, int] = {}
    for _, ns, _, name in _ops(sp):
        out[name] = out.get(name, 0) + ns
    return out


def share(sp: Spans, stages: Sequence[str]) -> Optional[float]:
    """The device time of the ops launched while a span of ``stages`` was
    open, on any thread (the spans' inclusive time: a recompute that
    autograd's thread runs inside the caller's ``train.backward`` counts
    to it), as a share of the stretch's busy time; None without program
    spans or device work."""
    if not sp.program:
        return None
    busy = trace_mod.busy_ns(sp.trace)
    if not busy:
        return None
    merged: List[List[int]] = []
    for s in sp.program:                               # by start
        if s.name not in stages:
            continue
        if merged and s.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], s.end)
        else:
            merged.append([s.start, s.end])
    starts = [a for a, _ in merged]

    def inside(t: Optional[int]) -> bool:
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        return i >= 0 and t < merged[i][1]

    ns = sum(n for _, n, t, _ in _ops(sp) if inside(t))
    return 100.0 * ns / busy


def span_ms(snapshot: Optional[Dict], prefix: str, per: str
            ) -> Optional[float]:
    """Host ms in the spans whose stage starts with ``prefix``, per span
    ``per``, from the hub's snapshot (``spans``: the stage histograms)."""
    spans = (snapshot or {}).get("spans", {})
    calls = spans.get(per, {}).get("count", 0)
    if not calls:
        return None
    ns = sum(h["sum"] for k, h in spans.items() if k.startswith(prefix))
    return ns / 1e6 / calls


def fill_percent(counters: Optional[Dict]) -> Optional[float]:
    """The program's filled MoE slots over the slots it allotted."""
    allotted = (counters or {}).get("moe.slots_allotted")
    if not allotted:
        return None
    return 100.0 * counters["moe.slots_filled"] / allotted


def idle_gaps(sp: Spans, top: int = 10) -> List[List]:
    """:func:`.trace.idle_gaps`, each gap named by the innermost program
    span the host was in when it began (on any thread), and by the
    harness span only where no program span was open."""
    tr = sp.trace
    win = tr.window
    if win is None:
        return []
    lo, hi = win
    att = Attribution(sp.program)
    inner = [s for s in tr.spans
             if s.name != trace_mod.SPAN_PREFIX + "stretch"]
    starts = [s.start for s in inner]

    def host_at(t: int) -> str:
        span = att.at(t)
        if span is not None:
            return span.name
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and inner[i].end > t:
            return inner[i].name[len(trace_mod.SPAN_PREFIX):]
        return "harness"

    by: Dict[str, int] = {}

    def gap(a: int, b: int, then: str) -> None:
        key = f"{host_at(a)} -> {then}"
        by[key] = by.get(key, 0) + (b - a)

    cursor = lo
    for e in tr.device:
        if e.end <= lo or e.start >= hi:
            continue
        s = max(e.start, lo)
        if s > cursor:
            gap(cursor, s, trace_mod.short_name(e.name))
        cursor = max(cursor, min(e.end, hi))
    if hi > cursor:
        gap(cursor, hi, "end")
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v / 1e9] for k, v in ranked]
