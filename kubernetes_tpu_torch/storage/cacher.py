"""Watch cache: the Cacher tier between the KV store and watchers.

Analog of the apiserver's Cacher
(`staging/src/k8s.io/apiserver/pkg/storage/cacher/cacher.go:309`):
the reference interposes a reflector-fed ring buffer (watchCache, :369-374)
between etcd and the N registered watchers so that

  * each event is decoded ONCE, not once per watcher, and
  * a new watcher resuming from a recent resourceVersion replays its catch-up
    window from memory — storage reads stay independent of watcher count
    (`WatchCache.events_since`); only a resume older than the ring's horizon
    falls through to the backing store (counted in `storage_fallbacks`).

The ring holds already-decoded events `(rev, type, key, obj)` in revision
order. `horizon` is the revision BEFORE the oldest retained event: a resume
from `since >= horizon` is served fully from memory.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Deque, Dict, List, NamedTuple, Optional

DEFAULT_CAPACITY = 8192  # ring slots (cacher.go watchCache capacity analog)


class CachedEvent(NamedTuple):
    rev: int
    type: str        # machinery.watch ADDED/MODIFIED/DELETED
    key: str
    obj: Dict[str, Any]  # decoded, resourceVersion set


class WatchCache:
    """Decoded-event ring buffer with a revision horizon."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, horizon: int = 0):
        self._mu = threading.Lock()
        self._ring: Deque[CachedEvent] = deque()
        self._capacity = capacity
        self._horizon = horizon   # rev before the oldest retained event
        self.hits = 0             # catch-ups served from memory
        self.storage_fallbacks = 0  # catch-ups that had to read the store

    @property
    def horizon(self) -> int:
        with self._mu:
            return self._horizon

    def add(self, ev: CachedEvent) -> None:
        with self._mu:
            if len(self._ring) >= self._capacity:
                evicted = self._ring.popleft()
                self._horizon = evicted.rev
            self._ring.append(ev)

    def compact(self, at_rev: int) -> None:
        """Drop every retained event at or below `at_rev` and raise the
        horizon to it — what a sustained storm does to the ring organically
        (old revisions churn out). Resumes below the new horizon fall back
        to storage, where a compacted revision earns its 410."""
        with self._mu:
            while self._ring and self._ring[0].rev <= at_rev:
                self._ring.popleft()
            self._horizon = max(self._horizon, at_rev)

    def events_since(self, since: int, prefix: str) -> Optional[List[CachedEvent]]:
        """Events with rev > since under prefix, from memory — or None when
        `since` predates the ring's horizon (caller falls back to storage)."""
        with self._mu:
            if since < self._horizon:
                self.storage_fallbacks += 1
                return None
            self.hits += 1
            return [e for e in self._ring
                    if e.rev > since and e.key.startswith(prefix)]
