"""pods_per_s: pods bound in the window (by the binder's clock) ÷ the
window's seconds. The window runs from the first timed wave's start to the
end of the wave in flight when `--seconds` have passed, so no wave is cut
in two."""


def read(ctx):
    t0, t1 = ctx["t_window"], ctx["t_close"]
    n = sum(1 for _, _, t in ctx["binds"] if t0 <= t <= t1)
    return n / (t1 - t0)
