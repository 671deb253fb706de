"""dispatch_ms.prefill: host ms from the prefill entry to its return."""
from bench.harness.readers import dispatch_ms


def read(ctx):
    return dispatch_ms(ctx) if ctx.kind == "prefill" else None
