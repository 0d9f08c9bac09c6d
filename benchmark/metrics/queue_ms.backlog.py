"""queue_ms.backlog: the queue and event layer (sched/queue.py and
Scheduler.on_pod_*): the pump + pop + requeue spans a backlog wave plus
the time in the event handlers (the top-ups, the bindings'
confirmations, the deletions), ms."""

from benchmark.spans import span_ms


def read(ctx):
    return span_ms(ctx, "backlog", ("pump", "pop", "requeue"), events=True)
