"""WatchMux: ONE apiserver watch stream fanned out to per-tenant routes (a
copy of the JAX package's client/watchmux.py over the port's informers).

The fleet's watch-amplification killer: K tenants
sharing one cluster each used to own a full informer set — K apiserver watch
streams per resource, and every disruption × K relists. The mux inverts
that: ONE `SharedInformer` (one upstream list+watch, bookmark-resumable,
relist only on a genuine 410) feeds an indexer, and events fan out to
per-tenant routes keyed by a tenant label.

Per-route delivery discipline (the cacher contract, one layer up):

  * every route owns a BOUNDED queue drained by its own consumer thread —
    one slow tenant can never stall the upstream pump or its siblings;
  * a route that overflows (or is hit by the `watch.stall@<route>` chaos
    seam) is BROKEN, not blocked: its queue is cleared, a sequence fence is
    raised past every event it may have lost, and a RESYNC marker replays
    the route's world from the mux's OWN indexer snapshot — the apiserver
    never sees a relist for a route-local failure;
  * in-flight events racing the fence are discarded by sequence number, so
    a resynced route can't interleave stale deltas into its rebuilt view.

Mux-stream death (`mux.die@stream` seam, or the upstream informer thread
exiting) leaves every route serving from its last-delivered state; `revive()`
restarts the upstream informer, which RESUMES from its last (possibly
bookmarked) resourceVersion — the indexer survives, so recovery costs one
watch re-establishment, not K relists.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..machinery import meta
from .informers import SharedInformer
from ..utils import faultline

Obj = Dict[str, Any]

TENANT_LABEL = "ktpu.io/tenant"

_RESYNC = "RESYNC"


class MuxRoute:
    """One tenant's delivery lane: bounded queue + consumer thread + the
    route's own view of the world (what the fence-and-resync diff runs
    against)."""

    def __init__(self, name: str,
                 on_add: Callable[[Obj], None] = lambda o: None,
                 on_update: Callable[[Obj, Obj], None] = lambda o, n: None,
                 on_delete: Callable[[Obj], None] = lambda o: None,
                 capacity: int = 1024):
        self.name = name
        self.on_add = on_add
        self.on_update = on_update
        self.on_delete = on_delete
        # clamp: 0/negative would defeat the bounded-queue overflow check
        # (len >= capacity) and let a deaf route grow without eviction
        self.capacity = max(1, capacity)
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._q: deque = deque()
        self._stop = False
        self.seq = 0              # per-route event sequence (producer side)
        self.fence = 0            # events with seq <= fence are void
        # the route's delivered view: key → last object handed to handlers
        # (object REFERENCES shared with the mux indexer — no copies)
        self.view: Dict[str, Obj] = {}
        # counters the chaos drills and the bench read
        self.delivered = 0
        self.resyncs = 0          # indexer-snapshot rebuilds taken
        self.evictions = 0        # queue overflows / injected stalls
        self.discarded_stale = 0  # fenced-off events dropped by seq
        self.handler_errors = 0   # tenant-handler exceptions swallowed —
                                  # a silently-diverging tenant must show
                                  # up in metrics, not nowhere
        self.last_event = time.monotonic()
        self._thread = threading.Thread(
            target=self._drain, name=f"muxroute-{name}", daemon=True)
        self._thread.start()

    # -- producer side (called from the informer handler thread) -------- #

    def offer(self, typ: str, old: Optional[Obj], new: Optional[Obj],
              stall: bool = False) -> None:
        """Enqueue one event; a full queue (or an injected stall) breaks
        the route — clear, fence, resync — instead of blocking the mux."""
        with self._cv:
            if self._stop:
                return
            if stall or len(self._q) >= self.capacity:
                # slow-consumer backpressure: this ONE route pays with a
                # local resync; the upstream stream and sibling routes
                # never notice (the deaf-watcher contract, route-local)
                self.evictions += 1
                self._break_locked()
            else:
                self.seq += 1
                self._q.append((self.seq, typ, old, new))
                self._cv.notify()

    def _break_locked(self) -> None:
        """Break the route (caller holds `_cv`): raise the fence past every
        event the queue may have lost, clear the backlog, and leave one
        RESYNC marker — the ONE fence protocol both the overflow path and
        explicit resyncs must share."""
        self.seq += 1
        self.fence = self.seq
        self._q.clear()
        self._q.append((self.seq, _RESYNC, None, None))
        self._cv.notify()

    def resync(self) -> None:
        """Force a fence+resync (used when a route joins late or after a
        mux revive where per-route delivery may have gaps)."""
        with self._cv:
            if self._stop:
                return
            self._break_locked()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            # drop the undelivered backlog: _drain only exits on an EMPTY
            # queue, so a deep backlog behind a handler blocked on the
            # tenant's ingest lock could outlive the bounded join and keep
            # mutating a supposedly-quiesced tenant — clearing bounds the
            # leak to the ONE in-flight handler
            self._q.clear()
            self._cv.notify()
        self._thread.join(timeout=3)

    def depth(self) -> int:
        with self._mu:
            return len(self._q)

    # -- consumer side --------------------------------------------------- #

    def _snapshot(self) -> Dict[str, Obj]:
        """Set by the owning mux: returns this route's slice of the mux
        indexer. Patched in WatchMux.route(); a standalone route (unit
        tests) resyncs to empty."""
        return {}

    def _drain(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait(timeout=0.5)
                if self._stop and not self._q:
                    return
                if not self._q:
                    continue
                seq, typ, old, new = self._q.popleft()
            if typ == _RESYNC:
                self._apply_resync()
                continue
            with self._mu:
                stale = seq <= self.fence
            if stale:
                self.discarded_stale += 1
                continue
            self._apply(typ, old, new)

    def _apply(self, typ: str, old: Optional[Obj], new: Optional[Obj]) -> None:
        try:
            if typ == "DELETED":
                key = meta.namespaced_key(old or new)
                known = self.view.pop(key, None)
                self.on_delete(known if known is not None else (old or new))
            else:  # ADDED / MODIFIED / synthetic sync
                key = meta.namespaced_key(new)
                known = self.view.get(key)
                self.view[key] = new
                if known is None:
                    self.on_add(new)
                else:
                    self.on_update(known, new)
            self.delivered += 1
            self.last_event = time.monotonic()
        except Exception:  # noqa: BLE001 — one tenant's handler bug must
            self.handler_errors += 1  # not kill the route thread

    def _apply_resync(self) -> None:
        """Rebuild the route's view from the mux's indexer snapshot — a
        DeltaFIFO Replace at route granularity, sourced locally. The
        apiserver is NOT consulted: a route-local failure has route-local
        cost."""
        snap = self._snapshot()
        gone = [k for k in self.view if k not in snap]
        for k in gone:
            obj = self.view.pop(k)
            try:
                self.on_delete(obj)
            except Exception:  # noqa: BLE001
                self.handler_errors += 1
        for k, obj in snap.items():
            known = self.view.get(k)
            if known is obj:
                continue  # same object reference: nothing changed
            if known is not None and meta.resource_version(known) == \
                    meta.resource_version(obj):
                self.view[k] = obj
                continue
            self.view[k] = obj
            try:
                if known is None:
                    self.on_add(obj)
                else:
                    self.on_update(known, obj)
            except Exception:  # noqa: BLE001
                self.handler_errors += 1
        self.resyncs += 1
        self.delivered += 1
        self.last_event = time.monotonic()


class WatchMux:
    """One upstream SharedInformer, K per-tenant routes.

    `route_key(obj)` names the route an object belongs to (default: the
    `ktpu.io/tenant` label); unrouted objects are counted and dropped.
    The mux OWNS its informer's lifecycle: `start()`/`stop()`, plus
    `die()`/`revive()` for the mux-stream death drill."""

    def __init__(self, informer: SharedInformer,
                 route_key: Optional[Callable[[Obj], str]] = None,
                 tenant_label: str = TENANT_LABEL,
                 buffer: int = 1024, name: str = ""):
        self.informer = informer
        self.name = name or informer.rc.resource
        self.tenant_label = tenant_label
        self.route_key = route_key or (
            lambda o: meta.labels_of(o).get(tenant_label, ""))
        self.buffer = buffer
        self._mu = threading.Lock()
        self.routes: Dict[str, MuxRoute] = {}
        self.unrouted_events = 0
        self.deaths = 0           # upstream stream deaths (die()/seam)
        self.revives = 0
        # route snapshots are served off a named index, not a full
        # indexer scan: a revive() resyncing K routes costs O(per-route
        # slice) each instead of K copies of the whole object list
        self._index_name = f"mux-route:{self.name}"
        informer.indexer.add_index(
            self._index_name, lambda o: [self.route_key(o)])
        informer.add_handlers(on_add=self._on_add,
                              on_update=self._on_update,
                              on_delete=self._on_delete)

    # -- lifecycle ------------------------------------------------------- #

    def start(self) -> "WatchMux":
        self.informer.start()
        return self

    def wait_for_sync(self, timeout: float = 10.0) -> bool:
        return self.informer.wait_for_sync(timeout)

    def stop(self) -> None:
        self.informer.stop()
        with self._mu:
            routes = list(self.routes.values())
        for r in routes:
            r.stop()

    @property
    def alive(self) -> bool:
        t = self.informer._thread
        return t is not None and t.is_alive()

    @property
    def last_signal(self) -> float:
        """Monotonic stamp of the last upstream signal (event, bookmark, or
        list) — the staleness metric's anchor."""
        return self.informer.last_signal

    def die(self) -> None:
        """Kill the upstream stream (the `mux.die@stream` drill): the
        informer stops, routes keep serving their last-delivered state."""
        self.deaths += 1
        self.informer.stop()

    def revive(self) -> "WatchMux":
        """Restart the upstream informer. Restart-as-resume: the indexer and
        last (possibly bookmark-advanced) resourceVersion survived, so this
        re-establishes ONE watch — no relist unless the resume token fell
        beneath the compaction floor while dead. Routes are fenced+resynced
        from the indexer once the stream is back, closing any per-route gap
        from the dead window."""
        self.revives += 1
        self.informer.start()
        self.informer.wait_for_sync(10.0)
        with self._mu:
            routes = list(self.routes.values())
        for r in routes:
            r.resync()
        return self

    # -- routes ---------------------------------------------------------- #

    def route(self, name: str,
              on_add: Callable[[Obj], None] = lambda o: None,
              on_update: Callable[[Obj, Obj], None] = lambda o, n: None,
              on_delete: Callable[[Obj], None] = lambda o: None,
              buffer: Optional[int] = None) -> MuxRoute:
        r = MuxRoute(name, on_add, on_update, on_delete,
                     capacity=self.buffer if buffer is None else buffer)
        r._snapshot = lambda: self._route_snapshot(name)
        with self._mu:
            # check-and-insert under ONE lock hold: two racing
            # registrations of the same name must not silently replace a
            # live route (stranding its consumer thread and splitting the
            # tenant's event flow); the loser tears its route down and
            # raises
            duplicate = name in self.routes
            if not duplicate:
                self.routes[name] = r
        if duplicate:
            r.stop()  # outside the lock: stop() joins the drain thread
            raise ValueError(f"route {name!r} already registered")
        if self.informer.has_synced:
            r.resync()  # late joiner: synthesize its world from the indexer
        return r

    def _route_snapshot(self, name: str) -> Dict[str, Obj]:
        return {meta.namespaced_key(o): o
                for o in self.informer.indexer.by_index(self._index_name,
                                                        name)}

    def depths(self) -> Dict[str, int]:
        with self._mu:
            return {n: r.depth() for n, r in self.routes.items()}

    # -- upstream handlers (informer thread) ----------------------------- #

    def _maybe_die(self) -> None:
        # per-mux site (mux.die@pods / mux.die@nodes) targets ONE mux with
        # a deterministic hit count; the shared legacy site "stream" kills
        # whichever attached mux fans the Nth event overall
        if faultline.should("mux.die", self.name) or \
                faultline.should("mux.die", "stream"):
            # the stream dies FROM the delivery path (a broken pump, a
            # half-closed socket): stopping the informer from its own
            # handler thread would self-join — detach
            threading.Thread(target=self.die, name="mux-die",
                             daemon=True).start()

    def _fan(self, typ: str, old: Optional[Obj], new: Optional[Obj]) -> None:
        self._maybe_die()
        obj = new if new is not None else old
        key = self.route_key(obj)
        with self._mu:
            r = self.routes.get(key)
        if r is None:
            self.unrouted_events += 1
            return
        stall = faultline.should("watch.stall", r.name)
        r.offer(typ, old, new, stall=stall)

    def _on_add(self, obj: Obj) -> None:
        self._fan("ADDED", None, obj)

    def _on_update(self, old: Obj, new: Obj) -> None:
        ko, kn = self.route_key(old), self.route_key(new)
        if ko != kn:
            # the object moved tenants: a delete on the old route, an add
            # on the new — each route's view stays internally consistent
            self._fan("DELETED", old, None)
            self._fan("ADDED", None, new)
            return
        self._fan("MODIFIED", old, new)

    def _on_delete(self, obj: Obj) -> None:
        self._fan("DELETED", obj, None)

    # -- stats ------------------------------------------------------------ #

    def stats(self) -> Dict[str, Any]:
        with self._mu:
            routes = dict(self.routes)
        return {
            "name": self.name,
            "upstream_streams": 1,
            "alive": self.alive,
            "relists": self.informer.relists,
            "resumes": self.informer.resumes,
            "bookmark_resumes": self.informer.bookmark_resumes,
            "bookmarks_seen": self.informer.bookmarks_seen,
            "deaths": self.deaths,
            "revives": self.revives,
            "unrouted_events": self.unrouted_events,
            "route_evictions": sum(r.evictions for r in routes.values()),
            "route_resyncs": sum(r.resyncs for r in routes.values()),
            "handler_errors": sum(r.handler_errors
                                  for r in routes.values()),
            "routes": {n: {"delivered": r.delivered,
                           "evictions": r.evictions,
                           "resyncs": r.resyncs,
                           "handler_errors": r.handler_errors,
                           "depth": r.depth()}
                       for n, r in routes.items()},
        }
