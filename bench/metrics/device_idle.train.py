"""device_idle.train: the device idle share of a training cell's stretch."""
from bench.harness.readers import idle_percent


def read(ctx):
    return idle_percent(ctx) if ctx.kind == "train" else None
