"""What the per-layer metrics under ``bench/metrics`` read from a run.

Each returns None where the run gave it nothing to read (no trace, no
device work, no call of the kernel), never 0 for a share.
"""
from __future__ import annotations

from typing import Optional

from . import counts, peaks, trace


def idle_percent(ctx) -> Optional[float]:
    """The share of the traced stretch in which no kernel, copy or set
    ran on the device."""
    if ctx.trace is None or ctx.trace.window is None:
        return None
    lo, hi = ctx.trace.window
    busy = trace.busy_ns(ctx.trace)
    if not busy:
        return None
    return 100.0 * (1.0 - busy / (hi - lo))


def mfu_percent(ctx) -> Optional[float]:
    """The window's model FLOPs over its time, as a share of the card's
    dense bf16 peak."""
    if not ctx.work or ctx.window_s <= 0 or ctx.device_name == "cpu":
        return None
    flops = sum(counts.model_flops(ctx.model, b, s,
                                   train=ctx.kind == "train")
                for b, s in ctx.work)
    peak = peaks.peaks(ctx.device_name)["bf16_flops"]
    return 100.0 * flops / (ctx.window_s * peak)


def dispatch_ms(ctx) -> Optional[float]:
    """Mean host time from the entry's call to its return (before the
    synchronize), over the window's calls or steps."""
    if not ctx.dispatch_s:
        return None
    return 1e3 * sum(ctx.dispatch_s) / len(ctx.dispatch_s)


def roofline_percent(ctx, layer: str) -> Optional[float]:
    """The least time the card needs for the stretch's calls of the
    port's kernel ``layer`` (each call's larger bound) over the device
    time its launches took."""
    if ctx.trace is None or ctx.calls is None or ctx.device_name == "cpu":
        return None
    ns, launches = trace.kernel_ns(ctx.trace, layer)
    work = ctx.calls.work(layer)
    if not ns or not launches or not work:
        return None
    need = sum(peaks.bound_seconds(f, b, ctx.device_name, tc)
               for f, b, tc in work)
    return 100.0 * need / (ns / 1e9)
