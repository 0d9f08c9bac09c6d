"""k2_roofline.backlog: K2 (csrc/domain_rank.cu): its least time by the
frozen bytes/operations count over its device time in the traced stretch,
%. K2 launches only where a class has a domain quota (spread or
anti-affinity)."""

from benchmark.spans import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "backlog", "k2")
