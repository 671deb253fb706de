"""Reading a ``torch.profiler`` trace of a traced stretch.

The harness marks what the host is doing with spans of its own
(``record_function`` names starting with ``bench:``): the whole stretch
(``bench:stretch``) and, inside it, each call into the program and each
synchronize.  From the trace it takes the device's work (kernels,
copies and sets, never the profiler's own annotations on the device
timeline): the busy time inside the stretch, the time and count of each
named kernel, and the idle gaps between device work, each named by the
harness span the host was in when the gap began and the device work
that ended it.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

SPAN_PREFIX = "bench:"

#: the port's kernels by layer: the symbol patterns of each one's launches
KERNELS = {
    "flash_attention": re.compile(r"\bflash_fwd\w*_kernel"),
    "rmsnorm": re.compile(r"\brmsnorm\w*_kernel"),
    "moe_gmm": re.compile(r"\bgmm_(simt|wgmma|mma_t)_kernel"),
    "ssd_scan": re.compile(r"\bssd_scan\w*_kernel"),
}


@dataclasses.dataclass
class Event:
    name: str
    start: int          # ns, the profiler's clock
    end: int


@dataclasses.dataclass
class Trace:
    device: List[Event]          # device work, by start
    spans: List[Event]           # the harness's host spans, by start

    @property
    def window(self) -> Optional[Tuple[int, int]]:
        for s in self.spans:
            if s.name == SPAN_PREFIX + "stretch":
                return s.start, s.end
        return None


def from_events(events) -> Trace:
    """The device work and the harness spans of profiler events (torch's
    ``_KinetoEvent``: name, device type, start and duration).  The
    annotations that the profiler mirrors onto the device's timeline
    carry the name of a host annotation and are not device work."""
    host_marks, device, spans = set(), [], []
    for e in events:
        name = e.name()
        start = int(e.start_ns())
        ev = Event(name, start, start + int(e.duration_ns()))
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.is_user_annotation():
                host_marks.add(name)
                if name.startswith(SPAN_PREFIX):
                    spans.append(ev)
        elif not e.is_user_annotation():
            device.append(ev)
    device = [ev for ev in device if ev.name not in host_marks]
    device.sort(key=lambda ev: ev.start)
    spans.sort(key=lambda ev: ev.start)
    return Trace(device, spans)


def from_profiler(prof) -> Trace:
    """The device work and the harness spans of a finished profile."""
    return from_events(prof.profiler.kineto_results.events())


def _clip(events: Sequence[Event], lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(max(e.start, lo), min(e.end, hi)) for e in events
            if e.end > lo and e.start < hi]


def busy_ns(trace: Trace) -> Optional[int]:
    """Nanoseconds of the stretch in which some device work ran."""
    win = trace.window
    if win is None:
        return None
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(_clip(trace.device, *win)):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def layer_of(symbol: str) -> Optional[str]:
    for layer, pat in KERNELS.items():
        if pat.search(symbol):
            return layer
    return None


def kernel_ns(trace: Trace, layer: str) -> Tuple[int, int]:
    """(device ns, launches) of the port's kernel ``layer`` in the
    stretch."""
    win = trace.window
    if win is None:
        return 0, 0
    pat = KERNELS[layer]
    ns = n = 0
    for e in trace.device:
        if e.start >= win[0] and e.end <= win[1] and pat.search(e.name):
            ns += e.end - e.start
            n += 1
    return ns, n


_TEMPLATE_WORD = re.compile(r"[A-Za-z_]\w*(?:Functor|Op|_kernel|_impl)\w*")


def short_name(symbol: str) -> str:
    """A device op's name by its layer: the port's kernels as
    ``<layer>: <kernel>``; ATen kernels as ``aten: <kernel>[<functors>]``
    with the distinctive words of their template arguments, so that two
    elementwise kernels read apart; library GEMMs as ``gemm: ...``;
    copies and sets as they are."""
    base = re.sub(r"^void\s+", "", symbol.replace("(anonymous namespace)::",
                                                    ""))
    head = base.split("<", 1)[0].split("(", 1)[0]
    kernel = head.rsplit("::", 1)[-1].strip()
    layer = layer_of(symbol)
    if layer:
        return f"{layer}: {KERNELS[layer].search(symbol).group(0)}"
    if symbol.startswith(("Memcpy", "Memset")):
        return symbol
    if re.search(r"gemm|xmma|cutlass|cublas|sm90_|sm80_", symbol, re.I):
        return f"gemm: {base[:160]}"
    words = []
    for w in _TEMPLATE_WORD.findall(base[len(head):]):
        w = w.rsplit("::", 1)[-1]
        if w != kernel and w not in words:
            words.append(w)
    dtypes = [t for t in ("BFloat16", "Half", "float", "double", "long",
                          "bool", "int") if re.search(rf"\b{t}\b", base)]
    inner = ",".join(words[:4] + dtypes[:2])
    prefix = "aten" if "at::native" in symbol or "at::" in symbol else "op"
    return f"{prefix}: {kernel}[{inner}]" if inner else f"{prefix}: {kernel}"


def device_ops(trace: Trace, top: int = 10) -> List[List]:
    """The device ops that took most time in the stretch: [name, s]."""
    win = trace.window
    if win is None:
        return []
    by: Dict[str, int] = {}
    for e in trace.device:
        if e.start >= win[0] and e.end <= win[1]:
            k = short_name(e.name)
            by[k] = by.get(k, 0) + (e.end - e.start)
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v / 1e9] for k, v in ranked]


def idle_gaps(trace: Trace, top: int = 10) -> List[List]:
    """The device's idle time in the stretch, summed by what the host was
    doing when each gap began (the harness span it was in, else
    ``harness``) and the device op that ended it: [name, s]."""
    win = trace.window
    if win is None:
        return []
    lo, hi = win
    inner = [s for s in trace.spans if s.name != SPAN_PREFIX + "stretch"]
    starts = [s.start for s in inner]

    def host_at(t: int) -> str:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and inner[i].end > t:
            return inner[i].name[len(SPAN_PREFIX):]
        return "harness"

    by: Dict[str, int] = {}

    def gap(a: int, b: int, then: str) -> None:
        key = f"{host_at(a)} -> {then}"
        by[key] = by.get(key, 0) + (b - a)

    cursor = lo
    for e in trace.device:
        if e.end <= lo or e.start >= hi:
            continue
        s = max(e.start, lo)
        if s > cursor:
            gap(cursor, s, short_name(e.name))
        cursor = max(cursor, min(e.end, hi))
    if hi > cursor:
        gap(cursor, hi, "end")
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v / 1e9] for k, v in ranked]
