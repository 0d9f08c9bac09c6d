"""Informers: reflector-fed shared caches with event handlers.

Analog of client-go `tools/cache`: Reflector.ListAndWatch
(`tools/cache/reflector.go:187`) → delta processing → thread-safe indexer
store + handler fan-out (`shared_informer.go:293`). A 410 Gone (compacted
watch) triggers relist, exactly as the reference reflector does; handlers see
the same add/update/delete stream DeltaFIFO would deliver, including initial
list synthesis.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..component.metrics import DEFAULT_REGISTRY as _REG
from ..machinery import meta
from ..machinery import watch as mwatch
from ..machinery.wait import Backoff
from ..client.rest import ResourceClient
from ..utils import faultline

Obj = Dict[str, Any]
IndexFn = Callable[[Obj], List[str]]

# ingest telemetry: watch-event volume per resource/type and the
# relist cadence — the denominators the watch→bind e2e latency histogram
# (sched/metrics.py POD_E2E_LATENCY) is read against. The scheduler's pod
# stamp itself happens at handler time (the queue-add inside the dispatch
# below), so these series bound how much ingest the stamps cover.
INFORMER_EVENTS = _REG.counter(
    "informer_watch_events_total",
    "Watch events dispatched to informer handlers",
    labels=("resource", "type"))
INFORMER_RELISTS = _REG.counter(
    "informer_relists_total",
    "Full list+replace rounds (initial sync, 410 Gone, deaf watch)",
    labels=("resource",))
# The watch plane: bookmarks keep a quiet stream's resume token fresh,
# and resumes are the relists we DIDN'T pay — the ratio of these two series
# against informer_relists_total is the watch plane's health at a glance.
INFORMER_BOOKMARKS = _REG.counter(
    "informer_bookmarks_total",
    "BOOKMARK events received (resume token advanced without a relist)",
    labels=("resource",))
INFORMER_RESUMES = _REG.counter(
    "informer_watch_resumes_total",
    "Watch streams re-established from the last resourceVersion instead of "
    "relisting, by what last advanced the token (bookmark vs event)",
    labels=("resource", "via"))


class RelistBackoff:
    """Failure-counting wrapper around machinery/wait.Backoff for reflector
    relists.

    The reference reflector retries ListAndWatch through a backoff manager
    (reflector.go:187 + wait.Backoff); a fixed 0.5 s cadence means a
    compaction storm — every resume earning a fresh 410 — has N informers
    hammering the apiserver at 2 Hz each, exactly when it is busiest. Delays
    double per consecutive failed round, jittered, clamped to `cap` so a
    fleet of reflectors doesn't relist in lockstep."""

    def __init__(self, base: float = 0.5, cap: float = 30.0,
                 factor: float = 2.0, jitter: float = 0.5):
        self.base = base
        self.cap = cap
        self._b = Backoff(base=base, factor=factor, max_delay=cap,
                          jitter=jitter)
        self.attempts = 0

    def next(self) -> float:
        d = self._b.delay(self.attempts)
        self.attempts += 1
        return d

    def reset(self) -> None:
        self.attempts = 0

    def collapse(self) -> None:
        """Collapse the ladder to its FIRST rung (not a full reset): a
        successful list proves the failure the backoff was pricing is
        over, but a watch phase that keeps dying right after every good
        list must still pace on rung 1, not the raw base cadence — only
        a delivered watch signal earns `reset()`."""
        self.attempts = min(self.attempts, 1)


class Indexer:
    """cache.ThreadSafeStore + Indexers: objects by key, plus named indexes
    (e.g. pods by node name)."""

    def __init__(self, index_fns: Optional[Dict[str, IndexFn]] = None):
        self._mu = threading.RLock()
        self._items: Dict[str, Obj] = {}
        self._index_fns = dict(index_fns or {})
        self._indexes: Dict[str, Dict[str, set]] = {
            name: {} for name in self._index_fns}

    def add_index(self, name: str, fn: IndexFn) -> None:
        """cache.AddIndexers: register an index late and backfill it."""
        with self._mu:
            if name in self._index_fns:
                return
            self._index_fns[name] = fn
            idx: Dict[str, set] = {}
            for key, obj in self._items.items():
                for v in fn(obj):
                    idx.setdefault(v, set()).add(key)
            self._indexes[name] = idx

    def _update_index(self, key: str, old: Optional[Obj],
                      new: Optional[Obj]) -> None:
        for name, fn in self._index_fns.items():
            idx = self._indexes[name]
            if old is not None:
                for v in fn(old):
                    idx.get(v, set()).discard(key)
            if new is not None:
                for v in fn(new):
                    idx.setdefault(v, set()).add(key)

    def replace(self, objs: List[Obj]) -> None:
        with self._mu:
            self._items = {meta.namespaced_key(o): o for o in objs}
            self._indexes = {name: {} for name in self._index_fns}
            for k, o in self._items.items():
                self._update_index(k, None, o)

    def upsert(self, obj: Obj) -> Optional[Obj]:
        key = meta.namespaced_key(obj)
        with self._mu:
            old = self._items.get(key)
            self._items[key] = obj
            self._update_index(key, old, obj)
            return old

    def delete(self, obj: Obj) -> Optional[Obj]:
        key = meta.namespaced_key(obj)
        with self._mu:
            old = self._items.pop(key, None)
            if old is not None:
                self._update_index(key, old, None)
            return old

    def get(self, key: str) -> Optional[Obj]:
        with self._mu:
            return self._items.get(key)

    def list(self) -> List[Obj]:
        with self._mu:
            return list(self._items.values())

    def keys(self) -> List[str]:
        with self._mu:
            return list(self._items.keys())

    def by_index(self, name: str, value: str) -> List[Obj]:
        with self._mu:
            keys = self._indexes.get(name, {}).get(value, set())
            return [self._items[k] for k in keys if k in self._items]

    def __len__(self) -> int:
        with self._mu:
            return len(self._items)


class Lister:
    """Namespace-aware read interface over an Indexer (client-go listers)."""

    def __init__(self, indexer: Indexer):
        self.indexer = indexer

    def list(self, namespace: str = "",
             selector: Optional[Callable[[Obj], bool]] = None) -> List[Obj]:
        out = []
        for o in self.indexer.list():
            if namespace and meta.namespace(o) != namespace:
                continue
            if selector is not None and not selector(o):
                continue
            out.append(o)
        return out

    def get(self, namespace: str, name: str) -> Optional[Obj]:
        key = f"{namespace}/{name}" if namespace else name
        return self.indexer.get(key)


class SharedInformer:
    """One reflector + one indexer + N handlers for one resource."""

    def __init__(self, rc: ResourceClient, namespace: str = "",
                 label_selector: str = "", field_selector: str = "",
                 index_fns: Optional[Dict[str, IndexFn]] = None,
                 relist_backoff: float = 0.5):
        self.rc = rc
        self.namespace = namespace
        self.label_selector = label_selector
        self.field_selector = field_selector
        self.indexer = Indexer(index_fns)
        self.lister = Lister(self.indexer)
        self.relist_backoff = relist_backoff  # base delay (back-compat name)
        self.backoff = RelistBackoff(base=relist_backoff)
        # a round that survived this long was healthy: reset the ladder so
        # one transient blip after a quiet hour doesn't start at the cap
        self._backoff_reset_after = max(5.0, 4 * relist_backoff)
        self._handlers: List[Tuple[Callable, Callable, Callable]] = []
        self._handler_mu = threading.Lock()
        self._stop = threading.Event()
        self._synced = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._watch: Optional[mwatch.Watch] = None
        self.last_sync_rv = ""
        # watch-plane bookkeeping: how the resume token last
        # advanced, and the resume/relist split the bench budgets read
        self._rv_from_bookmark = False
        self.relists = 0            # full list+replace rounds
        self.resumes = 0            # re-watches from last_sync_rv
        self.bookmark_resumes = 0   # ... where a BOOKMARK supplied the rv
        self.bookmarks_seen = 0
        # liveness: monotonic stamp of the last signal (event, bookmark, or
        # successful list) — the staleness metric's denominator upstream
        self.last_signal = time.monotonic()

    # -- handler registration (AddEventHandler) ----------------------------- #

    def add_handlers(self, on_add: Callable[[Obj], None] = lambda o: None,
                     on_update: Callable[[Obj, Obj], None] = lambda o, n: None,
                     on_delete: Callable[[Obj], None] = lambda o: None) -> None:
        with self._handler_mu:
            self._handlers.append((on_add, on_update, on_delete))
            if self._synced.is_set():
                # late joiner gets synthetic adds for current state
                for o in self.indexer.list():
                    on_add(o)

    # -- lifecycle ---------------------------------------------------------- #

    def start(self) -> "SharedInformer":
        """Start — or RESTART — the reflector. A stopped informer keeps its
        indexer and last_sync_rv, so starting it again is a watch RESUME
        (the WatchMux revive path rides this: a mux-stream death must not
        cost a relist when the resume token is still above the floor)."""
        if self._thread is not None and self._thread.is_alive():
            if not self._stop.is_set():
                return self  # genuinely running
            # the old lifecycle is stopping but its thread outlived
            # stop()'s bounded join (wedged in a synchronous handler).
            # Returning here would leave NO reflector once it exits, and
            # replacing _stop while it still runs would resurrect it (the
            # loop re-reads self._stop) — so wait it out, bounded, and
            # fail LOUDLY rather than report a restart that never happened
            self._thread.join(timeout=10)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"informer-{self.rc.resource}: previous lifecycle's "
                    "thread is still exiting (a handler is likely wedged); "
                    "cannot restart yet")
        if self._stop.is_set():
            self._stop = threading.Event()  # fresh lifecycle, old thread dead
        self._thread = threading.Thread(target=self._run,
                                        name=f"informer-{self.rc.resource}",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        w = self._watch
        if w is not None:
            w.stop()
        if self._thread is not None:
            self._thread.join(timeout=3)

    def wait_for_sync(self, timeout: float = 10.0) -> bool:
        return self._synced.wait(timeout)

    @property
    def has_synced(self) -> bool:
        return self._synced.is_set()

    # -- the reflector loop (reflector.go:187 ListAndWatch) ----------------- #

    def _run(self) -> None:
        # a RESTART of a previously-synced informer (WatchMux revive, a
        # stopped-then-started reflector) resumes from its last token
        # instead of relisting — the indexer and last_sync_rv survived
        resume_first = self._synced.is_set() and bool(self.last_sync_rv)
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                self._list_and_watch(skip_list=resume_first)
            except Exception:  # noqa: BLE001 — reflector retries everything
                pass
            resume_first = False
            if time.monotonic() - t0 >= self._backoff_reset_after:
                self.backoff.reset()  # the round was healthy for a while
            if self._stop.wait(self.backoff.next()):
                return

    @staticmethod
    def _error_code(obj) -> int:
        """Status code off a watch ERROR event's payload (0 if unreadable)."""
        try:
            return int(obj.get("code") or 0)
        except (AttributeError, TypeError, ValueError):
            return 0

    def _list_and_watch(self, skip_list: bool = False) -> None:
        if not skip_list:
            INFORMER_RELISTS.inc(resource=self.rc.resource)
            self.relists += 1
            lst = self.rc.list(self.namespace, self.label_selector,
                               self.field_selector)
            items = lst.get("items", [])
            rv = lst.get("metadata", {}).get("resourceVersion", "")
            old_keys = set(self.indexer.keys())
            # last-known objects become delete tombstones (DeltaFIFO
            # DeletedFinalStateUnknown carries the final object, not a key)
            old_objs = {k: self.indexer.get(k) for k in old_keys}
            self.indexer.replace(items)
            self.last_sync_rv = rv
            self._rv_from_bookmark = False
            self.last_signal = time.monotonic()
            # ANY successful list+replace collapses the relist ladder to
            # its first rung (the old after-a-healthy-round-only reset
            # left a watch that died right after the initial list
            # retrying at the decayed cap forever); the full reset
            # happens below, once the watch actually delivers a signal
            self.backoff.collapse()
            # synthesize deltas for the replace (DeltaFIFO Replace)
            new_keys = {meta.namespaced_key(o) for o in items}
            with self._handler_mu:
                handlers = list(self._handlers)
            for o in items:
                k = meta.namespaced_key(o)
                for add, upd, _ in handlers:
                    if k in old_keys:
                        # deliver the pre-gap cached object as old so
                        # diffing handlers see changes that happened during
                        # the watch gap (DeltaFIFO Replace semantics)
                        upd(old_objs.get(k) or o, o)
                    else:
                        add(o)
            for k in old_keys - new_keys:
                tomb = old_objs.get(k) or {"metadata": dict(zip(
                    ("namespace", "name"), meta.split_key(k)))}
                for _, _, dele in handlers:
                    dele(tomb)
            self._synced.set()

        # Watch, RESUMING across clean stream ends: bookmarks keep
        # last_sync_rv fresh on quiet resources, so a dropped stream
        # re-watches from there (reflector.go re-establishes the watch
        # from its lastSyncResourceVersion). Only a GENUINE 410 Gone —
        # the resume token fell beneath the compaction floor — forces the
        # full relist this method restarts with; any other terminal ERROR
        # (an apiserver restart's 503, a converter failure) re-establishes
        # by resourceVersion, which is the whole point of the watch plane: one
        # compaction blip must not become a fleet-wide list storm.
        # Silence bound: a healthy opted-in stream carries a bookmark at
        # least every KTPU_WATCH_BOOKMARK_INTERVAL (10s default); total
        # silence far beyond that means the watch is deaf (e.g. resumed
        # from a future RV after a storage reset, where the server happily
        # streams nothing forever) — relist rather than trust it. The
        # bound scales with the configured interval so a slow-bookmark
        # server doesn't turn every quiet watch into a relist loop.
        import os as _os

        silence_limit = max(9 * float(_os.environ.get(
            "KTPU_WATCH_BOOKMARK_INTERVAL", "10") or 10), 90.0)
        last_signal = time.monotonic()
        first_stream = not skip_list
        pending_resume: Optional[str] = None
        while not self._stop.is_set():
            if not first_stream:
                # this re-watch IS the resume path (classified by what last
                # advanced the token — a bookmark-funded resume is the
                # compaction-immunity signal the bench asserts) — but it is
                # only COUNTED once the re-established stream delivers its
                # first signal: an attempt that is refused, insta-closes,
                # or 410s straight into a relist never resumed anything,
                # and counting it would falsely certify the bookmark
                # property (each new attempt overwrites the pending slot)
                pending_resume = ("bookmark" if self._rv_from_bookmark
                                  else "event")
            first_stream = False
            error_break = False
            w = self.rc.watch(self.namespace, self.label_selector,
                              self.field_selector,
                              resource_version=self.last_sync_rv,
                              allow_bookmarks=True)
            self._watch = w
            try:
                while not self._stop.is_set():
                    ev = w.next(timeout=1.0)
                    if ev is None:
                        if w.stopped:
                            break  # stream ended → resume from last rv
                        if time.monotonic() - last_signal > silence_limit:
                            return  # deaf watch → full relist
                        continue
                    if ev.type == mwatch.ERROR:
                        # ERROR frames are NOT liveness: a server stuck
                        # erroring every resume must eventually trip the
                        # silence bound below and relist, not spin forever
                        if self._error_code(ev.object) == 410:
                            # 410 Gone: the token is beneath the compaction
                            # floor — only a full relist can close the gap
                            return
                        # any other terminal error (restart 503, a 429
                        # refused re-establishment, stream teardown): the
                        # token is still good — resume, but UNDER THE
                        # LADDER: a refused watch is server pushback, and
                        # re-watching at the bare 0.05 s resume cadence
                        # would hammer a saturated apiserver ~20×/s (the
                        # ladder fully resets on the first real signal)
                        error_break = True
                        break
                    last_signal = time.monotonic()
                    self.last_signal = last_signal
                    # the watch phase is demonstrably alive: NOW the round
                    # is healthy and the relist ladder fully resets (the
                    # counterpart of the rung-1 collapse after the list)
                    if self.backoff.attempts:
                        self.backoff.reset()
                    if pending_resume is not None:
                        # first delivered signal on a re-established watch:
                        # the resume actually happened — count it now
                        self.resumes += 1
                        if pending_resume == "bookmark":
                            self.bookmark_resumes += 1
                        INFORMER_RESUMES.inc(resource=self.rc.resource,
                                             via=pending_resume)
                        pending_resume = None
                    if ev.type == mwatch.BOOKMARK:
                        # the server's liveness+progress pulse: advance the
                        # resume token without touching the indexer
                        rv = meta.resource_version(ev.object)
                        if rv:
                            self.last_sync_rv = rv
                            self._rv_from_bookmark = True
                        self.bookmarks_seen += 1
                        INFORMER_BOOKMARKS.inc(resource=self.rc.resource)
                        continue
                    if faultline.should("watch.drop", "informer"):
                        # chaos: the stream dies mid-flight and THIS event
                        # is lost with it — the resume from last_sync_rv
                        # (which has not advanced past it) must redeliver
                        break
                    if faultline.should("watch.relist", "informer"):
                        return  # chaos: 410-equivalent → full relist
                    if faultline.should("watch.storm", "informer"):
                        # chaos: an event storm — the whole world redelivers
                        # at once (a relist IS a storm: every object arrives
                        # as one burst of upserts). The overload governor's
                        # ingest-pressure signal is what this exercises; the
                        # at-least-once contract makes the redelivery safe.
                        return
                    self._dispatch(ev)
                    rv = meta.resource_version(ev.object)
                    if rv:
                        self.last_sync_rv = rv
                        self._rv_from_bookmark = False
            finally:
                w.stop()
                self._watch = None
            if time.monotonic() - last_signal > silence_limit:
                return  # repeated silent resumes → full relist
            if error_break:
                # terminal-error resumes pace on the relist ladder (capped
                # exponential + jitter): consecutive refusals escalate,
                # the first delivered signal resets
                if self._stop.wait(self.backoff.next()):
                    return
                continue
            if self._stop.wait(0.05):
                return  # brief pause: a server that insta-closes streams
                # must not spin the resume loop hot

    def _dispatch(self, ev: mwatch.Event) -> None:
        INFORMER_EVENTS.inc(resource=self.rc.resource, type=str(ev.type))
        with self._handler_mu:
            handlers = list(self._handlers)
        if ev.type == mwatch.ADDED:
            old = self.indexer.upsert(ev.object)
            for add, upd, _ in handlers:
                if old is None:
                    add(ev.object)
                else:
                    upd(old, ev.object)
        elif ev.type == mwatch.MODIFIED:
            old = self.indexer.upsert(ev.object)
            for add, upd, _ in handlers:
                if old is None:
                    add(ev.object)
                else:
                    upd(old, ev.object)
        elif ev.type == mwatch.DELETED:
            old = self.indexer.delete(ev.object)
            for _, _, dele in handlers:
                dele(old if old is not None else ev.object)


class InformerFactory:
    """SharedInformerFactory: one informer per resource, shared by consumers."""

    def __init__(self, client):
        self.client = client
        self._informers: Dict[Tuple[str, str, str], SharedInformer] = {}
        self._mu = threading.Lock()

    def informer(self, attr: str, namespace: str = "",
                 field_selector: str = "",
                 index_fns: Optional[Dict[str, IndexFn]] = None) -> SharedInformer:
        rc: ResourceClient = getattr(self.client, attr)
        key = (rc.group, rc.resource, namespace, field_selector)
        with self._mu:
            inf = self._informers.get(key)
            if inf is None:
                inf = SharedInformer(
                    rc, namespace=namespace, field_selector=field_selector,
                    index_fns=index_fns)
                self._informers[key] = inf
            elif index_fns:
                # a later consumer's indexes must still materialize on the
                # shared informer (client-go AddIndexers)
                for name, fn in index_fns.items():
                    inf.indexer.add_index(name, fn)
            return inf

    def start(self) -> None:
        with self._mu:
            for inf in self._informers.values():
                if inf._thread is None:
                    inf.start()

    def wait_for_sync(self, timeout: float = 10.0) -> bool:
        with self._mu:
            infs = list(self._informers.values())
        return all(i.wait_for_sync(timeout) for i in infs)

    def stop(self) -> None:
        with self._mu:
            for inf in self._informers.values():
                inf.stop()


def pods_by_node_index(pod: Obj) -> List[str]:
    """The pods-by-nodeName index every node-centric consumer wants."""
    node = pod.get("spec", {}).get("nodeName", "")
    return [node] if node else []
