"""dispatch_ms.backlog: the device cycle (sched/cycle.py, ops/): the
dispatch + readback spans a backlog wave, ms. The dispatch span also holds
the host interning the next backlog while the device runs."""

from benchmark.spans import span_ms


def read(ctx):
    return span_ms(ctx, "backlog", ("dispatch", "readback"))
