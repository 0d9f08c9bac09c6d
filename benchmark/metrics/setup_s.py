"""setup_s: from process start to the first timed wave: torch import
and the CUDA context, the kernel builds on a checkout's first run, the
cluster's generation and fill, and the warm-up waves."""


def read(ctx):
    return ctx["setup_s"]
