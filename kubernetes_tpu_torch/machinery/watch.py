"""Watch event types and channels.

Analog of apimachinery `pkg/watch/watch.go`: an Interface delivering a stream
of {type, object} events. Here a watch is a closeable blocking queue; the
storage layer and clients share this shape.

The channel is the per-watcher BOUNDED delivery buffer of the cacher
contract (cacher.go forgetWatcher): a producer that finds it full terminates
THIS watcher instead of blocking the broadcast loop, and `terminate()` lets
it leave a terminal Status event (e.g. 410 "too old resource version") that
the consumer receives after draining whatever it had buffered — so even a
slow-but-alive client learns WHY its stream died instead of seeing a bare
socket EOF.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"
BOOKMARK = "BOOKMARK"
ERROR = "ERROR"


@dataclass(frozen=True)
class Event:
    type: str
    object: Dict[str, Any]


class Watch:
    """watch.Interface: ResultChan() + Stop(). Iteration ends on Stop or when
    the producer closes the stream; a terminal event set via `terminate()`
    is delivered exactly once, after the buffered events drain."""

    _SENTINEL = object()

    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=capacity)
        self._stopped = threading.Event()
        self._term_mu = threading.Lock()
        self._terminal: Optional[Event] = None
        # True iff a producer stopped this stream because the buffer was
        # FULL — the deaf-consumer case. Lets the dispatcher distinguish a
        # real backpressure eviction from a consumer that closed its own
        # stream a moment before the send (which must not be counted or
        # terminated as deaf).
        self.overflowed = False

    def send(self, event: Event, timeout: Optional[float] = 5.0) -> bool:
        """Producer side. Returns False if the watcher is gone/slow: the
        reference terminates slow watchers (cacher.go forgetWatcher) rather
        than blocking the event path."""
        if self._stopped.is_set():
            return False
        try:
            if timeout is not None and timeout <= 0:
                self._q.put_nowait(event)
            else:
                self._q.put(event, timeout=timeout)
            return True
        except queue.Full:
            self.overflowed = True
            self.stop()
            return False

    def terminate(self, event: Event) -> None:
        """Stop the stream with a terminal event the consumer still gets
        AFTER draining the buffer — works even when the buffer is full (the
        deaf-watcher case, where the failed send() already stopped the
        stream and a plain send() could never land the WHY)."""
        with self._term_mu:
            if self._terminal is None:
                self._terminal = event
        self.stop()

    def _take_terminal(self) -> Optional[Event]:
        with self._term_mu:
            t, self._terminal = self._terminal, None
            return t

    def stop(self) -> None:
        if not self._stopped.is_set():
            self._stopped.set()
            try:
                self._q.put_nowait(self._SENTINEL)
            except queue.Full:
                pass

    @property
    def stopped(self) -> bool:
        return self._stopped.is_set()

    def depth(self) -> int:
        """Buffered (undelivered) events — the backpressure signal the
        dispatcher exports as `watch_buffer_depth`."""
        return self._q.qsize()

    def __iter__(self) -> Iterator[Event]:
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                t = self._take_terminal()
                if t is not None:
                    yield t
                return
            yield item
            if self._stopped.is_set() and self._q.empty():
                t = self._take_terminal()
                if t is not None:
                    yield t
                return

    def next(self, timeout: Optional[float] = None) -> Optional[Event]:
        """Blocking pop; the terminal event (if any) after drain; None on
        stop/timeout."""
        if self._stopped.is_set() and self._q.empty():
            return self._take_terminal()
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        if item is self._SENTINEL:
            return self._take_terminal()
        return item
