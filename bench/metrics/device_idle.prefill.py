"""device_idle.prefill: the device idle share of a prefill cell's stretch."""
from bench.harness.readers import idle_percent


def read(ctx):
    return idle_percent(ctx) if ctx.kind == "prefill" else None
