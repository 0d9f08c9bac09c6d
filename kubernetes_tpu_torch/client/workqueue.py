"""Rate-limited work queues.

Analog of client-go `util/workqueue`: the Interface (Add/Get/Done with
dirty/processing dedup), DelayingQueue (AddAfter), and RateLimitingQueue
(AddRateLimited with per-item exponential backoff capped by an overall
limiter) — the retry spine of every controller.

(A copy of the JAX package's client/workqueue.py.)
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Any, Dict, List, Optional, Tuple


class WorkQueue:
    """workqueue.Type: exactly-once in-flight semantics. An item re-added
    while processing is marked dirty and requeued on Done."""

    def __init__(self):
        self._mu = threading.Condition()
        self._queue: List[Any] = []
        self._dirty: set = set()
        self._processing: set = set()
        self._shutting_down = False

    def add(self, item: Any) -> None:
        with self._mu:
            if self._shutting_down or item in self._dirty:
                return
            self._dirty.add(item)
            if item in self._processing:
                return
            self._queue.append(item)
            self._mu.notify()

    def get(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Blocks until an item or shutdown; None on shutdown/timeout."""
        with self._mu:
            if not self._mu.wait_for(
                    lambda: self._queue or self._shutting_down,
                    timeout=timeout):
                return None
            if not self._queue:
                return None
            item = self._queue.pop(0)
            self._processing.add(item)
            self._dirty.discard(item)
            return item

    def done(self, item: Any) -> None:
        with self._mu:
            self._processing.discard(item)
            if item in self._dirty:
                self._queue.append(item)
                self._mu.notify()

    def shutdown(self) -> None:
        with self._mu:
            self._shutting_down = True
            self._mu.notify_all()

    @property
    def is_shutdown(self) -> bool:
        with self._mu:
            return self._shutting_down

    def __len__(self) -> int:
        with self._mu:
            return len(self._queue)


class DelayingQueue(WorkQueue):
    """workqueue.DelayingInterface: AddAfter via a waiting heap + pump."""

    def __init__(self):
        super().__init__()
        self._heap: List[Tuple[float, int, Any]] = []
        self._seq = 0
        self._heap_mu = threading.Condition()
        self._stop = threading.Event()
        self._pump = threading.Thread(target=self._loop, daemon=True,
                                      name="delaying-queue")
        self._pump.start()

    def add_after(self, item: Any, delay: float) -> None:
        if delay <= 0:
            self.add(item)
            return
        with self._heap_mu:
            self._seq += 1
            heapq.heappush(self._heap, (time.monotonic() + delay, self._seq, item))
            self._heap_mu.notify()

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._heap_mu:
                now = time.monotonic()
                while self._heap and self._heap[0][0] <= now:
                    _, _, item = heapq.heappop(self._heap)
                    self.add(item)
                wait = (self._heap[0][0] - now) if self._heap else 1.0
                self._heap_mu.wait(timeout=min(wait, 1.0))

    def shutdown(self) -> None:
        self._stop.set()
        with self._heap_mu:
            self._heap_mu.notify_all()
        super().shutdown()


class RateLimiter:
    """workqueue.DefaultControllerRateLimiter: per-item exponential backoff
    (5ms→1000s) — the token-bucket half is a no-op here since consumers are
    in-process (no API QPS to protect)."""

    def __init__(self, base: float = 0.005, max_delay: float = 1000.0):
        self.base = base
        self.max_delay = max_delay
        self._mu = threading.Lock()
        self._failures: Dict[Any, int] = {}

    def when(self, item: Any) -> float:
        with self._mu:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
        return min(self.base * (2 ** n), self.max_delay)

    def forget(self, item: Any) -> None:
        with self._mu:
            self._failures.pop(item, None)

    def retries(self, item: Any) -> int:
        with self._mu:
            return self._failures.get(item, 0)


class RateLimitingQueue(DelayingQueue):
    """workqueue.RateLimitingInterface."""

    def __init__(self, limiter: Optional[RateLimiter] = None):
        super().__init__()
        self.limiter = limiter or RateLimiter()

    def add_rate_limited(self, item: Any) -> None:
        self.add_after(item, self.limiter.when(item))

    def forget(self, item: Any) -> None:
        self.limiter.forget(item)

    def num_requeues(self, item: Any) -> int:
        return self.limiter.retries(item)
