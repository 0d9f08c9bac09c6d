"""idle_share.backlog: the device (H100): 1 − the union of kernel and
copy intervals ÷ the traced stretch of backlog waves, %."""

from benchmark.spans import idle_pct


def read(ctx):
    return idle_pct(ctx, "backlog")
