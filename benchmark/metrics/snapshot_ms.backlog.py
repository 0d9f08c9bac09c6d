"""snapshot_ms.backlog: the resident cache and the encoder
(state/cache.py, state/encode.py): the snapshot span a backlog wave, ms."""

from benchmark.spans import span_ms


def read(ctx):
    return span_ms(ctx, "backlog", ("snapshot",))
