"""mfu.train: a training window's model FLOPs as a share of the peak."""
from bench.harness.readers import mfu_percent


def read(ctx):
    return mfu_percent(ctx) if ctx.kind == "train" else None
