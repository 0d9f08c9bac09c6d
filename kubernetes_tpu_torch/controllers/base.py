"""The controller pattern: informer events → workqueue → sync loop.

Analog of the shape every reference controller shares
(`pkg/controller/replicaset/replica_set.go:139,470,610`): handlers enqueue
namespaced keys, N workers pop keys and call `sync(key)`, failures requeue
with rate-limited backoff, success forgets the key.
"""

from __future__ import annotations

import threading
import traceback
from typing import Callable, Dict, List, Optional

from ..client.informers import InformerFactory, SharedInformer
from ..client.workqueue import RateLimitingQueue
from ..machinery import meta


class Expectations:
    """controller_utils.ControllerExpectations: remember how many child
    creations/deletions a sync dispatched and hold further syncs until the
    informer has observed them — the guard against over-creating children on
    stale lister reads (controller_utils.go:150-260)."""

    TIMEOUT = 300.0  # ExpectationsTimeout: 5 minutes

    def __init__(self):
        self._mu = threading.Lock()
        self._data: Dict[str, List[float]] = {}  # key -> [adds, dels, stamp]

    def expect_creations(self, key: str, n: int) -> None:
        with self._mu:
            import time as _t
            self._data[key] = [float(n), 0.0, _t.monotonic()]

    def expect_deletions(self, key: str, n: int) -> None:
        with self._mu:
            import time as _t
            self._data[key] = [0.0, float(n), _t.monotonic()]

    def creation_observed(self, key: str) -> None:
        with self._mu:
            e = self._data.get(key)
            if e is not None:
                e[0] -= 1

    def deletion_observed(self, key: str) -> None:
        with self._mu:
            e = self._data.get(key)
            if e is not None:
                e[1] -= 1

    def satisfied(self, key: str) -> bool:
        with self._mu:
            e = self._data.get(key)
            if e is None:
                return True
            import time as _t
            if e[0] <= 0 and e[1] <= 0:
                return True
            return _t.monotonic() - e[2] > self.TIMEOUT  # expired → resync

    def forget(self, key: str) -> None:
        with self._mu:
            self._data.pop(key, None)


class Controller:
    """Base: wire informers to a keyed queue; run workers over sync(key)."""

    name = "controller"
    max_requeues = 15

    def __init__(self, client, factory: InformerFactory, workers: int = 1):
        self.client = client
        self.factory = factory
        self.queue = RateLimitingQueue()
        self.workers = workers
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self.sync_errors: List[str] = []

    # -- wiring helpers ----------------------------------------------------- #

    def enqueue(self, obj: Dict) -> None:
        self.queue.add(meta.namespaced_key(obj))

    def enqueue_key(self, key: str) -> None:
        self.queue.add(key)

    def watch_resource(self, attr: str, enqueue_fn: Optional[Callable] = None,
                       **informer_kw) -> SharedInformer:
        inf = self.factory.informer(attr, **informer_kw)
        fn = enqueue_fn or self.enqueue
        inf.add_handlers(on_add=fn, on_update=lambda o, n: fn(n), on_delete=fn)
        return inf

    def watch_owned(self, attr: str, owner_kind: str,
                    expectations: Optional[Expectations] = None) -> SharedInformer:
        """Enqueue the controller owner of changed children
        (resolveControllerRef, replica_set.go:319). With expectations, child
        add/delete events lower the owner's pending counts first
        (replica_set.go addPod/deletePod → expectations.CreationObserved)."""

        def owner_key(obj: Dict) -> Optional[str]:
            ref = meta.controller_ref(obj)
            if ref is not None and ref.get("kind") == owner_kind:
                ns = meta.namespace(obj)
                return f"{ns}/{ref['name']}" if ns else ref["name"]
            return None

        def on_add(obj: Dict) -> None:
            key = owner_key(obj)
            if key is None:
                return
            if expectations is not None:
                expectations.creation_observed(key)
            self.enqueue_key(key)

        def on_delete(obj: Dict) -> None:
            key = owner_key(obj)
            if key is None:
                return
            if expectations is not None:
                expectations.deletion_observed(key)
            self.enqueue_key(key)

        def on_update(old: Dict, new: Dict) -> None:
            key = owner_key(new)
            if key is not None:
                self.enqueue_key(key)

        inf = self.factory.informer(attr)
        inf.add_handlers(on_add=on_add, on_update=on_update,
                         on_delete=on_delete)
        return inf

    # -- lifecycle ---------------------------------------------------------- #

    def sync(self, key: str) -> None:  # override
        raise NotImplementedError

    def _worker(self, stop: threading.Event, queue: RateLimitingQueue) -> None:
        # stop/queue are captured per-generation so workers from a previous
        # leadership term exit cleanly instead of serving the new queue
        while not stop.is_set():
            key = queue.get(timeout=0.5)
            if key is None:
                if queue.is_shutdown:
                    return
                continue
            try:
                self.sync(key)
                queue.forget(key)
            except Exception:  # noqa: BLE001 — controller loops never die
                self.sync_errors.append(traceback.format_exc())
                if queue.num_requeues(key) < self.max_requeues:
                    queue.add_rate_limited(key)
                else:
                    queue.forget(key)
            finally:
                queue.done(key)

    def start(self) -> "Controller":
        """Start (or RE-start after stop — leadership can come back: the
        manager's on_started_leading must be able to revive workers).
        Handlers capture `self`, so swapping the queue re-arms them."""
        if self._stop.is_set() or self.queue.is_shutdown:
            self._stop = threading.Event()
            self.queue = RateLimitingQueue()
            self._threads = []
        for i in range(self.workers):
            t = threading.Thread(target=self._worker,
                                 args=(self._stop, self.queue), daemon=True,
                                 name=f"{self.name}-worker-{i}")
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        self.queue.shutdown()
        for t in self._threads:
            t.join(timeout=2)


def pod_from_template(owner: Dict, template: Dict, name: str = "",
                      generate_name: str = "") -> Dict:
    """GetPodFromTemplate (pkg/controller/controller_utils.go): stamp labels,
    ownerRef, and spec from the workload's pod template."""
    pod = {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {
            "namespace": meta.namespace(owner),
            "labels": dict((template.get("metadata", {}).get("labels")) or {}),
            # annotations ride along too (GetPodFromTemplate copies both —
            # rollout restart's restartedAt stamp travels this way)
            "annotations": dict((template.get("metadata", {})
                                 .get("annotations")) or {}),
            "ownerReferences": [meta.owner_reference(owner)],
        },
        "spec": meta.deep_copy(template.get("spec", {})),
    }
    if name:
        pod["metadata"]["name"] = name
    else:
        pod["metadata"]["generateName"] = generate_name or \
            f"{meta.name(owner)}-"
    return pod


def is_pod_active(pod: Dict) -> bool:
    """controller_utils.IsPodActive: not terminated, not being deleted."""
    phase = pod.get("status", {}).get("phase", "")
    return phase not in ("Succeeded", "Failed") and \
        not meta.is_being_deleted(pod)


def is_pod_ready(pod: Dict) -> bool:
    for c in pod.get("status", {}).get("conditions", []) or []:
        if c.get("type") == "Ready":
            return c.get("status") == "True"
    return False
