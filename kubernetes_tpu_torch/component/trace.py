"""Operation tracing: spans with steps + slow-op logging.

Analog of `vendor/k8s.io/utils/trace/trace.go` (utiltrace) as used by the
scheduler (`core/generic_scheduler.go:188-217` Step/LogIfLong): a Trace
collects timed steps; if the whole operation exceeds a threshold, the steps
are emitted so slow cycles are explainable. Also the hook point for
torch.profiler ranges on device-dispatch steps (port of the JAX package's
component/trace.py; `device_step_marker` is a `torch.profiler`
record_function where the JAX one is a jax.profiler TraceAnnotation).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional, Tuple

logger = logging.getLogger("kubernetes_tpu_torch.trace")


#: default LogIfLong threshold (the reference's 100ms scheduler trace bound)
DEFAULT_THRESHOLD = 0.1


class Trace:
    def __init__(self, name: str, clock: Callable[[], float] = time.monotonic,
                 threshold: float = DEFAULT_THRESHOLD, **fields):
        self.name = name
        self.fields = fields
        self.clock = clock
        self.threshold = threshold
        self.start = clock()
        self.steps: List[Tuple[float, str]] = []
        self._ended: Optional[float] = None

    def step(self, msg: str) -> None:
        self.steps.append((self.clock(), msg))

    def duration(self) -> float:
        return (self._ended or self.clock()) - self.start

    def log_if_long(self, threshold: float,
                    sink: Optional[Callable[[str], None]] = None) -> bool:
        """utiltrace.LogIfLong: emit the step timeline when total > threshold.
        Returns True if it logged."""
        self._ended = self.clock()
        total = self.duration()
        if total < threshold:
            return False
        emit = sink or (lambda s: logger.warning("%s", s))
        fs = ",".join(f"{k}={v}" for k, v in self.fields.items())
        lines = [f'Trace "{self.name}" ({fs}) took {total * 1000:.1f}ms '
                 f"(threshold {threshold * 1000:.0f}ms):"]
        prev = self.start
        for ts, msg in self.steps:
            lines.append(f"  +{(ts - prev) * 1000:.1f}ms {msg}")
            prev = ts
        emit("\n".join(lines))
        return True

    def __enter__(self) -> "Trace":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # exiting on an exception: the operation's failure path already
        # reports (and the timeline would blame the step that happened to
        # be open when the raise unwound) — only log clean slow exits
        if exc_type is None:
            self.log_if_long(self.threshold)


def device_step_marker(name: str):
    """A torch.profiler range for device-dispatch steps — it shows up around
    the step's CUDA kernels in a profiler trace (KTPU_PROFILE)."""
    try:
        import torch

        return torch.profiler.record_function(name)
    except Exception:  # noqa: BLE001 — profiling must never break the op
        import contextlib
        return contextlib.nullcontext()
