"""dispatch_ms.train: host ms from the train step's entry to its return."""
from bench.harness.readers import dispatch_ms


def read(ctx):
    return dispatch_ms(ctx) if ctx.kind == "train" else None
