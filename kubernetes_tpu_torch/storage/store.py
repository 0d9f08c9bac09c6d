"""storage.Interface: versioned object storage over the MVCC kvstore, with
the watch hub and the watch cache (a copy of the JAX package's
storage/store.py).

Analog of `staging/src/k8s.io/apiserver/pkg/storage/etcd3/store.go`: objects
are JSON-encoded under `/registry/<resource>/[<ns>/]<name>`; as in the
reference, resourceVersion is NOT stored in the value — it is filled from the
record's mod_revision on every read (store.go Versioner). GuaranteedUpdate
retries a CAS on mod_revision (store.go:219-300); Watch delivers events from
a given revision with 410-Gone on compaction. One dispatcher thread pumps kv
events to all registered watchers (role of etcd watch streams + the apiserver
Cacher, storage/cacher/cacher.go:309). A range lists in key order, as both of
the JAX package's backends do: `default/p-10` before `default/p-2`.

Watch-plane contract (the cacher's delivery discipline):

  * every watcher owns a BOUNDED buffer (`KTPU_WATCH_BUFFER`, default 8192);
    a consumer that stops draining is terminated — that ONE stream gets a
    410 "too old resource version" terminal Status (so the client knows to
    resume/relist) and the broadcast loop never blocks or balloons for it
    (cacher.go forgetWatcher);
  * BOOKMARK events carry the dispatched revision on a timer AND immediately
    on every compaction-boundary crossing (`compact_to`), so a quiet
    stream's resume token stays above the compaction floor and reconnects
    resume instead of relisting;
  * `drop_watchers` (the apiserver-restart seam) emits a terminal 503
    Status BEFORE closing each stream — clients resume by resourceVersion
    rather than discovering death by socket EOF and blind-relisting.

"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..component.metrics import DEFAULT_REGISTRY as _REG
from ..machinery import errors, meta
from ..machinery import watch as mwatch
from . import native
from .cacher import CachedEvent, WatchCache
# the records and PyKV are imported from this module too
from .native import (  # noqa: F401
    EVENT_CREATE,
    EVENT_DELETE,
    EVENT_PUT,
    CompactedError,
    KVEvent,
    KVRecord,
    PyKV,
)
from ..utils import faultline

Obj = Dict[str, Any]
Predicate = Optional[Callable[[Obj], bool]]


# watch-plane delivery telemetry: the per-watcher buffer is the
# backpressure boundary — its depth is the early-warning signal, and an
# eviction is the cacher contract actually firing (one deaf consumer paid,
# everyone else's broadcast stayed live)
WATCH_BUFFER_DEPTH = _REG.gauge(
    "watch_buffer_depth",
    "Deepest per-watcher delivery buffer observed at dispatch, by resource",
    labels=("resource",))
WATCH_DEAF_EVICTIONS = _REG.counter(
    "apiserver_watch_deaf_evictions_total",
    "Watch streams terminated with a too-old error because the consumer "
    "stopped draining its bounded buffer (cacher forgetWatcher contract)",
    labels=("resource",))
WATCH_BOOKMARKS_SENT = _REG.counter(
    "apiserver_watch_bookmarks_sent_total",
    "BOOKMARK events sent to opted-in watchers, by trigger "
    "(timer, compaction)",
    labels=("trigger",))


def _parse_watch_buffer(value, default: int = 8192) -> int:
    """Bounds-checked buffer parse (the KTPU_FLIGHT_RING convention):
    garbage falls back to the default, and the result clamps to [1, 2^20]
    — 0/negative would make queue.Queue UNBOUNDED, silently disabling the
    deaf-eviction contract this buffer exists to enforce."""
    try:
        n = int(value)
    except (TypeError, ValueError):
        return default
    return max(1, min(n, 1 << 20))


def _encode(obj: Obj) -> bytes:
    obj = dict(obj)
    md = dict(obj.get("metadata") or {})
    md.pop("resourceVersion", None)
    obj["metadata"] = md
    return json.dumps(obj, separators=(",", ":"), sort_keys=True).encode()


def _decode(data: bytes, rev: int) -> Obj:
    obj = json.loads(data)
    meta.set_resource_version(obj, str(rev))
    return obj


def _resource_of(prefix: str) -> str:
    """`/registry/<group>/<resource>/…` → `<resource>` (metric label
    granularity; registry.Store.key_root shape — `/registry/core/pods/` →
    `pods`). Bare test prefixes like `/registry/pods/` fall back to their
    last segment."""
    parts = prefix.strip("/").split("/")
    if len(parts) >= 3:
        return parts[2]
    return parts[-1] if parts and parts[-1] else "all"


@dataclass
class _Watcher:
    """One registered watch stream: the delivery buffer plus its horizon.

    `since` is the revision at/below which events are before this watcher's
    catch-up replay and must never be re-delivered; `bookmarks` opts the
    stream into BOOKMARK events (allowWatchBookmarks)."""

    prefix: str
    watch: mwatch.Watch
    predicate: Predicate
    since: int
    bookmarks: bool
    resource: str = field(default="")

    def __post_init__(self):
        if not self.resource:
            self.resource = _resource_of(self.prefix)


def _too_old_status(detail: str) -> Obj:
    return errors.new_gone(f"too old resource version: {detail}").status()


class Storage:
    """Object store + watch hub over one KV backend."""

    def __init__(self, kv=None, watch_buffer: Optional[int] = None,
                 bookmark_interval: Optional[float] = None,
                 data_dir: Optional[str] = None,
                 durability: Optional[str] = None):
        # data_dir turns the store durable: the kv is wrapped in the
        # WAL/snapshot layer (storage/wal.py) and recovery has ALREADY run
        # by the time new_kv returns — self.kv.rev() below is the last
        # durable revision, so the pump, the cacher horizon and every RV
        # this process hands out continue the pre-crash sequence
        self.kv = kv if kv is not None else native.new_kv(
            data_dir=data_dir, durability=durability)
        self._watch_mu = threading.Lock()
        self._watchers: List[_Watcher] = []
        self._watch_buffer = _parse_watch_buffer(
            watch_buffer if watch_buffer is not None
            else os.environ.get("KTPU_WATCH_BUFFER"))
        self._bookmark_interval = float(
            bookmark_interval if bookmark_interval is not None
            else os.environ.get("KTPU_WATCH_BOOKMARK_INTERVAL", "10"))
        self._dispatched_rev = self.kv.rev()
        # Cacher tier (storage/cacher.py ⇔ cacher.go:309): the pump decodes
        # each event once into this ring; watcher catch-up replays from it so
        # storage reads stay independent of watcher count
        self.watch_cache = WatchCache(horizon=self._dispatched_rev)
        # resources the depth gauge was last exported for: when a
        # resource's final watcher stops, its series must drop to 0 rather
        # than freeze at the last (typically full-buffer) reading
        self._depth_resources: set = set()
        # watch-plane counters the bench/chaos drills assert against
        self.deaf_evictions = 0
        self.bookmarks_sent = 0
        self.compaction_bookmarks = 0
        self._stop = threading.Event()
        self._pump = threading.Thread(target=self._dispatch_loop,
                                      name="storage-watch-pump", daemon=True)
        self._pump.start()

    def close(self) -> None:
        self._stop.set()
        self._pump.join(timeout=2)
        with self._watch_mu:
            for wr in self._watchers:
                wr.watch.stop()
            self._watchers.clear()
        self.kv.close()

    def drop_watchers(self) -> int:
        """Terminate every registered watch stream (the data survives).
        This is what an apiserver restart looks like from a client: the
        store (etcd) keeps its state, every open watch connection dies, and
        reflectors re-establish. Each stream gets a terminal 503 Status
        FIRST (the reference closes the response with a Status frame), so
        informers resume from their last resourceVersion instead of
        discovering death by socket EOF and falling into the blind-relist
        path. Used by the chaos injector's ``apiserver.restart`` seam;
        returns the number of streams dropped."""
        status = errors.new_service_unavailable(
            "apiserver restarting; watch stream closed").status()
        with self._watch_mu:
            n = len(self._watchers)
            for wr in self._watchers:
                wr.watch.terminate(mwatch.Event(mwatch.ERROR, status))
            self._watchers.clear()
        return n

    @property
    def dispatched_rev(self) -> int:
        """How far the broadcast pump has gotten. A compaction drill that
        wants to move the floor WITHOUT manufacturing a pump gap (events
        destroyed before they were ever broadcast 410 every live watcher)
        compacts at this revision, not the kv head."""
        return self._dispatched_rev

    def live_watchers(self, prefix: str = "") -> int:
        """Registered, not-yet-stopped streams under prefix — the bench's
        `upstream_watches_per_resource` reads this (one mux stream per
        resource for a whole tenant fleet is the acceptance bar)."""
        with self._watch_mu:
            return sum(1 for wr in self._watchers
                       if not wr.watch.stopped
                       and wr.prefix.startswith(prefix))

    # ------------------------------------------------------------------ #
    # CRUD (etcd3 store.go Create:143 / Get:86 / Delete / GuaranteedUpdate:219)
    # ------------------------------------------------------------------ #

    def create(self, key: str, obj: Obj, resource: str = "object") -> Obj:
        rev = self.kv.txn_put(key, 0, _encode(obj))
        if rev < 0:
            raise errors.new_already_exists(resource, meta.name(obj))
        out = meta.deep_copy(obj)
        meta.set_resource_version(out, str(rev))
        return out

    def get(self, key: str, resource: str = "object", name: str = "") -> Obj:
        rec = self.kv.get(key)
        if rec is None:
            raise errors.new_not_found(resource, name or key)
        return _decode(rec.value, rec.mod_rev)

    def list(self, prefix: str, predicate: Predicate = None) -> Tuple[List[Obj], str]:
        recs, at_rev = self.kv.range(prefix)
        items = []
        for rec in recs:
            obj = _decode(rec.value, rec.mod_rev)
            if predicate is None or predicate(obj):
                items.append(obj)
        return items, str(at_rev)

    def count(self, prefix: str) -> int:
        return self.kv.count(prefix)

    def delete(self, key: str, resource: str = "object", name: str = "",
               expected_rv: Optional[str] = None) -> Obj:
        while True:
            rec = self.kv.get(key)
            if rec is None:
                raise errors.new_not_found(resource, name or key)
            if expected_rv is not None and str(rec.mod_rev) != expected_rv:
                raise errors.new_conflict(resource, name or key,
                                          "the object has been modified")
            rv = self.kv.txn_delete(key, rec.mod_rev)
            if rv > 0:
                return _decode(rec.value, rec.mod_rev)
            if rv == 0:
                raise errors.new_not_found(resource, name or key)
            # lost a race with a concurrent update; retry

    def guaranteed_update(self, key: str, update_fn: Callable[[Obj], Obj],
                          resource: str = "object", name: str = "",
                          ignore_not_found: bool = False,
                          expected_rv: Optional[str] = None) -> Obj:
        """Retry loop: read → user transform → CAS write (store.go:219-300).

        update_fn receives a deep copy (with resourceVersion set) and returns
        the new object, or raises to abort.
        """
        chaos_cas = False  # at most one injected conflict per call: the
        # retry loop must converge even under FAULT_SPEC=store.cas_conflict@1.0
        while True:
            rec = self.kv.get(key)
            if rec is None:
                if not ignore_not_found:
                    raise errors.new_not_found(resource, name or key)
                cur: Obj = {}
                cur_mod = 0
            else:
                cur = _decode(rec.value, rec.mod_rev)
                cur_mod = rec.mod_rev
            if (expected_rv is not None and rec is not None
                    and str(rec.mod_rev) != expected_rv):
                # the precondition holds on EVERY iteration, not just the
                # first: when our txn_put loses the CAS race to a
                # concurrent writer, the retry re-reads a revision past
                # the caller's precondition and MUST conflict — retrying
                # with the stale body would silently stomp the winner
                # (observed: a lease renew racing a usurper's claim
                # overwrote it and kept the incumbent leading — the exact
                # window lease fencing closes). etcd3 store.go preconditions
                # are checked per attempt for the same reason.
                raise errors.new_conflict(
                    resource, name or key,
                    "the object has been modified; please apply your changes "
                    "to the latest version and try again")
            if faultline.should("store.latency", "guaranteed_update"):
                # chaos: the storage backend (etcd) is slow — every hit
                # read-transform-write stalls KTPU_SLOW_S. The bind-intent
                # writes and Lease renews ride this path, so the overload
                # drills use it to slow the COMMIT side without touching
                # the watch/ingest side.
                import os as _os
                import time as _time

                _time.sleep(float(_os.environ.get("KTPU_SLOW_S", "0.2")))
            updated = update_fn(meta.deep_copy(cur))
            if not chaos_cas and faultline.should("store.cas_conflict",
                                                  "guaranteed_update"):
                # chaos: behave exactly as if a concurrent writer won the
                # CAS race — skip the put and take the re-read/retry path
                chaos_cas = True
                continue
            rev = self.kv.txn_put(key, cur_mod if cur_mod else 0, _encode(updated))
            if rev > 0:
                out = meta.deep_copy(updated)
                meta.set_resource_version(out, str(rev))
                return out
            # CAS failure → re-read and retry

    # ------------------------------------------------------------------ #
    # Compaction
    # ------------------------------------------------------------------ #

    def compact_to(self, at_rev: int) -> None:
        """A REAL compaction at `at_rev`: the KV history and the cacher ring
        both drop everything at/below it, and every bookmark-opted LIVE
        watcher immediately receives a BOOKMARK carrying a revision ABOVE
        the new floor — the compaction-boundary crossing bookmark. That is
        what turns a later reconnect into a resume instead of a 410 relist:
        a quiet stream's resume token would otherwise sit below the floor
        exactly when the apiserver is busiest (the self-inflicted
        list-storm exists to kill)."""
        self.kv.compact(at_rev)
        self.watch_cache.compact(at_rev)
        self._send_bookmarks(trigger="compaction")

    # ------------------------------------------------------------------ #
    # Watch
    # ------------------------------------------------------------------ #

    def watch(self, prefix: str, since_rv: str = "",
              predicate: Predicate = None,
              bookmarks: bool = False,
              buffer: Optional[int] = None) -> mwatch.Watch:
        """Watch events under prefix with revision > since_rv.

        since_rv ""/"0" = from now. Raises Gone(410) if since_rv predates
        compaction — the caller must relist (reflector relist semantics).
        `buffer` bounds this watcher's delivery queue (default
        KTPU_WATCH_BUFFER); a consumer that stops draining it is evicted
        with a too-old terminal error, never allowed to stall the pump.
        """
        if faultline.should("store.compact", "watch"):
            # chaos: a REAL compaction at the current revision — stale
            # resumes below earn a genuine 410, and the dispatch pump's own
            # compaction handling runs against true state, not a mock. The
            # cacher ring compacts with it (a sustained storm churns old
            # revisions out of the window organically).
            self.compact_to(self.kv.rev())
        # per-call buffers go through the same clamp as the ctor/env path:
        # `buffer or ...` would send 0 to the default instead of the
        # documented clamp-to-1, and a negative value would make the queue
        # UNBOUNDED — un-evictable deaf consumers
        w = mwatch.Watch(capacity=_parse_watch_buffer(
            buffer, default=self._watch_buffer))
        wr = _Watcher(prefix=prefix, watch=w, predicate=predicate,
                      since=0, bookmarks=bookmarks)
        with self._watch_mu:
            # "" / "0" = from NOW: the current store revision, regardless of
            # how far the dispatch pump has gotten
            since = int(since_rv) if since_rv not in ("", "0") else self.kv.rev()
            # catch-up: replay history before going live under the same lock
            # the pump uses, so no event is missed or duplicated; the pump
            # delivers everything > max(since, _dispatched_rev). The replay
            # is served from the watch cache whenever `since` is within its
            # horizon — no storage read per watcher (cacher.go:369-374)
            cached = self.watch_cache.events_since(since, prefix)
            if cached is not None:
                for ce in cached:
                    if ce.rev > self._dispatched_rev:
                        break
                    self._deliver(wr, ce)
            else:
                try:
                    history = self.kv.events_since(since, prefix)
                except CompactedError:
                    raise errors.new_gone(
                        f"too old resource version: {since} "
                        f"(compacted at {self.kv.compacted_rev()})")
                for ev in history:
                    if ev.rev > self._dispatched_rev:
                        break  # the pump will deliver the rest
                    self._deliver(wr, self._to_cached(ev))
            wr.since = max(since, self._dispatched_rev)
            self._watchers.append(wr)
        return w

    @staticmethod
    def _to_cached(ev: KVEvent) -> CachedEvent:
        typ = {EVENT_CREATE: mwatch.ADDED,
               EVENT_PUT: mwatch.MODIFIED,
               EVENT_DELETE: mwatch.DELETED}[ev.type]
        return CachedEvent(rev=ev.rev, type=typ, key=ev.key,
                           obj=_decode(ev.value, ev.rev))

    def _deliver(self, wr: _Watcher, ce: CachedEvent,
                 timeout: float = 0.0) -> None:
        if wr.predicate is not None and not wr.predicate(ce.obj):
            return
        w = wr.watch
        if w.stopped:
            return
        # watchers receive a copy so one consumer's mutation can't leak into
        # another's view of the shared decoded event
        obj = meta.deep_copy(ce.obj)
        # non-blocking from the dispatcher: a watcher that cannot keep up is
        # terminated with a too-old terminal error — it alone pays, and the
        # event path for everyone else never stalls (cacher.go
        # forgetWatcher). The terminal Status survives the full buffer
        # (machinery/watch.Watch.terminate), so a slow-but-alive consumer
        # drains its backlog and THEN learns it must resume/relist.
        if not w.send(mwatch.Event(ce.type, obj), timeout=timeout):
            self._evict_if_deaf(wr, at_rev=ce.rev)

    def _evict_if_deaf(self, wr: _Watcher, at_rev: int) -> None:
        """A failed send is a DEAF eviction only when the buffer actually
        overflowed (Watch.overflowed); a consumer that closed its own
        stream a moment before the send gets neither a bogus too-old
        terminal nor a tick on the eviction metric."""
        w = wr.watch
        if not w.overflowed:
            return
        w.terminate(mwatch.Event(
            mwatch.ERROR,
            _too_old_status(f"{at_rev} (watcher evicted: delivery "
                            f"buffer of {w.capacity} exhausted)")))
        self.deaf_evictions += 1
        WATCH_DEAF_EVICTIONS.inc(resource=wr.resource)

    def _send_bookmarks(self, trigger: str = "timer") -> None:
        with self._watch_mu:
            for wr in self._watchers:
                if wr.bookmarks and not wr.watch.stopped:
                    # never below the watcher's own horizon (a bookmark at
                    # the pump's lagging revision would hand a resuming
                    # reflector an RV it has already consumed past,
                    # replaying duplicates) and never ABOVE the pump's
                    # dispatched revision: advertising the compaction
                    # floor itself when it outran the pump would hand out
                    # a resume token that silently skips events destroyed
                    # before they were ever broadcast. For a compaction at
                    # <= dispatched_rev (compact_to's contract for the
                    # seam and drills) this value already sits at/above
                    # the new floor, which is what makes the reconnect a
                    # resume; a floor beyond the pump leaves tokens below
                    # it, and the next resume earns its honest 410.
                    rv = max(wr.since, self._dispatched_rev)
                    if wr.watch.send(mwatch.Event(mwatch.BOOKMARK, {
                            "kind": "Bookmark", "apiVersion": "v1",
                            "metadata": {"resourceVersion": str(rv)}}),
                            timeout=0):
                        self.bookmarks_sent += 1
                        if trigger == "compaction":
                            self.compaction_bookmarks += 1
                        WATCH_BOOKMARKS_SENT.inc(trigger=trigger)
                    else:
                        # a bookmark landing on a FULL buffer is the same
                        # deaf consumer _deliver evicts — it must get the
                        # same too-old terminal + metric, not a silent
                        # stop that reads as a clean EOF
                        self._evict_if_deaf(wr, at_rev=rv)

    def _export_depths(self) -> None:
        """Deepest live delivery buffer per resource → watch_buffer_depth.
        Called from the pump with the watch lock held."""
        deepest: Dict[str, int] = {}
        for wr in self._watchers:
            if not wr.watch.stopped:
                d = wr.watch.depth()
                if d >= deepest.get(wr.resource, -1):
                    deepest[wr.resource] = d
        for res in self._depth_resources - set(deepest):
            WATCH_BUFFER_DEPTH.set(0, resource=res)
        self._depth_resources = set(deepest)
        for res, d in deepest.items():
            WATCH_BUFFER_DEPTH.set(d, resource=res)

    def _dispatch_loop(self) -> None:
        last_bm = time.monotonic()
        while not self._stop.is_set():
            rev = self.kv.wait(self._dispatched_rev, timeout=0.25)
            if faultline.should("watch.compact", "floor"):
                # chaos : a compaction storm hitting mid-stream —
                # a REAL compaction at the pump's own dispatched revision
                # (already-broadcast history only: compacting the kv head
                # would destroy events the pump hasn't read and force the
                # fell-behind 410 on everyone), with the boundary-crossing
                # bookmark broadcast that keeps LIVE opted-in streams
                # resumable. The drill asserts resumes, not relists,
                # survive this.
                self.compact_to(self._dispatched_rev)
            if time.monotonic() - last_bm >= self._bookmark_interval:
                last_bm = time.monotonic()
                self._send_bookmarks(trigger="timer")
            if rev <= self._dispatched_rev:
                continue
            try:
                events = self.kv.events_since(self._dispatched_rev, "")
            except CompactedError:
                # the pump fell behind compaction: watchers have an
                # unrecoverable gap — error them all out so clients relist
                # (the reference terminates such watchers, cacher.go)
                with self._watch_mu:
                    gone = errors.new_gone(
                        "watch events compacted away; relist required")
                    for wr in self._watchers:
                        wr.watch.terminate(
                            mwatch.Event(mwatch.ERROR, gone.status()))
                    self._watchers.clear()
                    self._dispatched_rev = self.kv.rev()
                    # the compacted-away events never reached the ring: the
                    # cache has a GAP, so its window must restart at now —
                    # otherwise a later resume would be served an incomplete
                    # history instead of falling through to a 410
                    self.watch_cache = WatchCache(
                        horizon=self._dispatched_rev)
                continue
            with self._watch_mu:
                cached = [self._to_cached(ev) for ev in events]  # decode ONCE
                for ce in cached:
                    self.watch_cache.add(ce)
                live = []
                for wr in self._watchers:
                    if wr.watch.stopped:
                        continue
                    for ce in cached:
                        if ce.rev > wr.since and ce.key.startswith(wr.prefix):
                            self._deliver(wr, ce)
                    if not wr.watch.stopped:
                        live.append(wr)
                self._watchers = live
                self._export_depths()
                if events:
                    self._dispatched_rev = max(e.rev for e in events)
