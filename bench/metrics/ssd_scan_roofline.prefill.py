"""ssd_scan_roofline.prefill: the ssd_scan kernel's share of its roofline in
prefill."""
from bench.harness.readers import roofline_percent


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return roofline_percent(ctx, "ssd_scan")
