"""k1_roofline.backlog: K1 (csrc/contention_scan.cu): its least time by
the frozen bytes/operations count over its device time in the traced
stretch, %."""

from benchmark.spans import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "backlog", "k1")
