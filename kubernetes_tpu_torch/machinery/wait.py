"""Polling / backoff / run-until helpers.

Analog of apimachinery `pkg/util/wait` (PollImmediate, Until, Backoff) and
client-go's wait usage. Threads + Events instead of goroutines + channels.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable


class TimeoutError_(TimeoutError):
    pass


def poll_until(condition: Callable[[], bool], interval: float = 0.01,
               timeout: float = 10.0, immediate: bool = True) -> None:
    """wait.PollImmediate: run condition every interval until true/timeout."""
    deadline = time.monotonic() + timeout
    if immediate and condition():
        return
    while time.monotonic() < deadline:
        time.sleep(interval)
        if condition():
            return
    raise TimeoutError_(f"condition not met within {timeout}s")


def until(fn: Callable[[], None], period: float, stop: threading.Event) -> None:
    """wait.Until: run fn every period until stop is set. Runs inline; callers
    put it on a thread."""
    while not stop.is_set():
        fn()
        if stop.wait(period):
            return


def run_until(fn: Callable[[], None], period: float, stop: threading.Event,
              name: str = "wait.Until") -> threading.Thread:
    t = threading.Thread(target=until, args=(fn, period, stop), name=name, daemon=True)
    t.start()
    return t


@dataclass
class Backoff:
    """wait.Backoff / client-go workqueue exponential backoff parameters."""

    base: float = 0.005
    factor: float = 2.0
    max_delay: float = 10.0
    jitter: float = 0.1

    def delay(self, failures: int) -> float:
        d = min(self.base * (self.factor ** failures), self.max_delay)
        if self.jitter:
            d *= 1.0 + random.random() * self.jitter
        return min(d, self.max_delay)


def jittered(duration: float, max_factor: float = 1.0) -> float:
    """wait.Jitter."""
    return duration * (1.0 + random.random() * max_factor)
