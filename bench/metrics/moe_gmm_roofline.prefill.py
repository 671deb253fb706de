"""moe_gmm_roofline.prefill: the moe_gmm kernel's share of its roofline in
prefill."""
from bench.harness.readers import roofline_percent


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return roofline_percent(ctx, "moe_gmm")
