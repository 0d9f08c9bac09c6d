"""commit_ms.backlog: commit and bind (Scheduler._commit, the binder):
the intent-write + bind-commit + retire spans a backlog wave, ms."""

from benchmark.spans import span_ms


def read(ctx):
    return span_ms(ctx, "backlog", ("intent-write", "bind-commit", "retire"))
