"""ssd_scan_roofline.train: the ssd_scan kernel's share of its roofline in
training (the forward and the remat recompute)."""
from bench.harness.readers import roofline_percent


def read(ctx):
    if ctx.kind != "train":
        return None
    return roofline_percent(ctx, "ssd_scan")
