"""kube-scheduler, the process: informer wiring + scheduling loop + binder
(port of the JAX package's sched/server.py).

Analog of `cmd/kube-scheduler/app/server.go` (Run :167) +
`pkg/scheduler/eventhandlers.go` (AddAllEventHandlers :335): watches pods
and nodes through the client (client/), feeds the batched scheduling core
(sched/scheduler.py Scheduler, on the card unless `device="cpu"` is asked
for), binds via the pods/binding subresource, evicts preemption victims
through the API, records FailedScheduling events, and optionally runs
behind leader election like the reference binary (:254-260).

Threads: the informers' pumps and the elector call in under `_mu`; the loop
thread runs each wave under it, and the wave's device work runs on the
dispatch supervisor's worker (sched/supervisor.py), which builds the CUDA
kernels on first use under the kernel library's lock (ops/kernels.py).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import dataclasses

from ..api.types import (
    NodeSelector,
    NodeSelectorTerm,
    Pod,
)
from ..api.v1 import node_from_v1, pod_from_v1
from ..client.events import EventRecorder
from ..client.informers import SharedInformer
from ..client.leaderelection import (
    LeaderElectionConfig,
    LeaderElector,
)
from ..machinery import errors, meta
from ..sched.scheduler import Scheduler

Obj = Dict[str, Any]


class APIBinder:
    """Binder over POST pods/{name}/binding (scheduler.go:565). (The JAX
    package's binder runs BindPodVolumes first when a volume binder is
    wired; the port has no volume binder yet.)

    Fenced: with a `fence_source` attached (leader election), every Binding
    is stamped with the current lease generation so the apiserver can
    reject a deposed leader's write (api.types.FENCING_TOKEN_ANNOTATION;
    apiserver/server.py `bind_pod`).

    Retry budget: server PUSHBACK — 429 TooManyRequests from the
    max-inflight filter, 503 from a restarting apiserver — is retried
    through ONE shared implementation of the backoff semantics
    (client/rest.py RetryPolicy: capped exponential + jitter, the Status'
    `retryAfterSeconds` honored as a floor, per-bind deadline). Both 429
    and 503 are rejected BEFORE the Binding mutates anything, so the
    retry can never double-apply. Everything else (fenced 409,
    already-assigned, NotFound) still fails fast — persistent pushback
    past the budget is the commit breaker's job (sched/overload.py),
    not the binder's."""

    def __init__(self, client, fence_source=None,
                 fence_lease: str = "",
                 retry_budget: int = 3,
                 retry_base_s: float = 0.05,
                 retry_cap_s: float = 1.0,
                 bind_deadline_s: float = 3.0):
        from ..api.types import DEFAULT_FENCING_LEASE
        from ..client.rest import RetryPolicy

        self.client = client
        self.fence_source = fence_source  # () -> int lease generation
        self.fence_lease = fence_lease or DEFAULT_FENCING_LEASE
        self.stale_rejects = 0  # fenced-off binds (the mechanism working)
        self.pushback_retries = 0  # 429/503 absorbed by the budget
        self.pushback_failures = 0  # budget/deadline exhausted
        self.retry = RetryPolicy(attempts=retry_budget, base_s=retry_base_s,
                                 cap_s=retry_cap_s,
                                 deadline_s=bind_deadline_s,
                                 on_retry=self._note_pushback_retry)

    def _note_pushback_retry(self) -> None:
        self.pushback_retries += 1

    def bind(self, pod: Pod, node_name: str) -> bool:
        from ..api.types import (FENCED_BIND_MARKER,
                                              FENCING_LEASE_ANNOTATION,
                                              FENCING_TOKEN_ANNOTATION)

        annotations = None
        if self.fence_source is not None:
            annotations = {
                FENCING_TOKEN_ANNOTATION: str(int(self.fence_source())),
                FENCING_LEASE_ANNOTATION: self.fence_lease,
            }
        try:
            self.retry.run(lambda: self.client.pods.bind(
                pod.name, node_name, pod.namespace,
                uid=pod.uid, annotations=annotations))
            return True
        except errors.StatusError as e:
            if annotations is not None and errors.is_conflict(e) \
                    and FENCED_BIND_MARKER in str(e):
                self.stale_rejects += 1
            elif e.code in (429, 503):
                self.pushback_failures += 1
            return False


class TelemetryGateway:
    """Scheduler-side scrape point: the apiserver already serves
    the shared registry at its /metrics, but the scheduler is its own
    process in production — it needs its own exposition. Serves

      /metrics               component/metrics.py text format (the shared
                             DEFAULT_REGISTRY: scheduler_* series included)
      /debug/flightrecorder  the flight-recorder ring as structured JSON
                             (read-only: the same document shape an
                             auto-dump writes, with none of the dump
                             side effects)
      /debug/why/<ns>/<pod>  the pod's latest decision attribution
                             (reason counts, top-k candidates
                             with score decomposition, queue lane +
                             attempts + first-seen age) — requires a
                             `scheduler` and its KTPU_EXPLAIN explainer
      /healthz               "ok"

    on a daemonized stdlib HTTP server; port 0 binds an ephemeral port."""

    def __init__(self, telemetry, host: str = "127.0.0.1", port: int = 0,
                 scheduler=None):
        import http.server
        import json as _json
        import socketserver

        from ..component.metrics import DEFAULT_REGISTRY

        tel = telemetry
        sched = scheduler

        def _why_doc(ns: str, name: str):
            """The why-pending document, assembled read-only from the
            explainer's latest attribution, the queue lane and the e2e
            tracker's first-seen stamp. None when the pod is entirely
            unknown (404)."""
            key = f"{ns}/{name}"
            doc: Dict[str, Any] = {"pod": key}
            attribution = None
            if getattr(sched, "explainer", None) is not None:
                attribution = sched.explainer.why(key)
                doc["explain_enabled"] = True
            else:
                doc["explain_enabled"] = False
            lane, attempts = sched.queue.describe(key)
            doc["queue_lane"] = lane
            doc["attempts"] = attempts
            first = tel.tracker.first_seen(key)
            doc["first_seen_age_s"] = (
                round(sched.clock() - first, 6) if first is not None
                else None)
            if attribution is not None:
                doc["attribution"] = attribution
            if attribution is None and lane is None and first is None:
                return None
            return doc

        class _Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # noqa: ARG002 - silence stdlib
                pass

            def do_GET(self):  # noqa: N802 - stdlib handler name
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = DEFAULT_REGISTRY.expose_text().encode()
                    ctype = "text/plain; version=0.0.4"
                elif path == "/debug/flightrecorder":
                    # read-only: a scrape loop must not clobber last_dump,
                    # count as a dump, or write KTPU_FLIGHT_DIR files
                    body = _json.dumps(
                        tel.snapshot_doc("debug-endpoint"), indent=1).encode()
                    ctype = "application/json"
                elif path.startswith("/debug/why/") and sched is not None:
                    parts = [p for p in path.split("/") if p][2:]
                    if len(parts) != 2:
                        self.send_error(404)
                        return
                    doc = _why_doc(parts[0], parts[1])
                    if doc is None:
                        self.send_error(404)
                        return
                    body = _json.dumps(doc, indent=1).encode()
                    ctype = "application/json"
                elif path == "/healthz":
                    body, ctype = b"ok", "text/plain"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        class _Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
            daemon_threads = True

        self._httpd = _Server((host, port), _Handler)
        self.host, self.port = self._httpd.server_address
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="scheduler-telemetry-http",
                                        daemon=True)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "TelemetryGateway":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def pod_schedulable_v1(obj: Obj) -> bool:
    """Is this v1 pod dict something a scheduler should (still) act on?
    Shared by SchedulerServer's informer handlers and the fleet watch
    plane's per-tenant ingest (fleet/server._TenantIngest) — ONE
    definition, so the two paths cannot drift."""
    phase = obj.get("status", {}).get("phase", "")
    return phase not in ("Succeeded", "Failed") and \
        not meta.is_being_deleted(obj)


def apply_pod_update_v1(scheduler: Scheduler, old: Obj, new: Obj,
                        to_pod) -> None:
    """The informer pod-UPDATE transition (eventhandlers.go:335-441),
    against one Scheduler: a no-longer-schedulable pod either frees its
    node's resources (terminated on a node) or leaves the queue; a live
    one flows through on_pod_update. `to_pod` is the caller's v1→Pod
    conversion (it owns creation_index stamping). Callers provide their
    own locking. Shared by SchedulerServer and _TenantIngest."""
    if not pod_schedulable_v1(new):
        p = pod_from_v1(new)
        if p.node_name:
            # terminated on its node: free the resources
            if scheduler.cache.get_pod(p.key) is not None:
                scheduler.cache.remove_pod(p.key)
                scheduler.queue.move_all_to_active(scheduler.clock())
        else:
            scheduler.queue.delete(p.key)
        return
    scheduler.on_pod_update(pod_from_v1(old), to_pod(new))


def restrict_pod_nodes(pod: Pod, allowed: frozenset) -> Pod:
    """AND a node-name restriction into the pod's required node affinity by
    adding matchFields(metadata.name IN allowed) to every term (or one fresh
    term) — evaluated on device like any other affinity."""
    names = tuple(sorted(allowed))
    aff = pod.affinity
    if aff.node_required and aff.node_required.terms:
        terms = tuple(
            dataclasses.replace(t, field_name_in=tuple(
                sorted(set(t.field_name_in) & allowed
                       if t.field_name_in else allowed)) or ("",))
            for t in aff.node_required.terms)
    else:
        terms = (NodeSelectorTerm(field_name_in=names),)
    pod.affinity = dataclasses.replace(
        aff, node_required=NodeSelector(terms=terms))
    return pod


class SchedulerServer:
    """The scheduler process: New + Run (scheduler.go:255,425-431)."""

    def __init__(self, client, scheduler: Optional[Scheduler] = None,
                 scheduler_name: str = "default-scheduler",
                 cycle_interval: float = 0.05,
                 batch_window: float = 0.02,
                 leader_elect: bool = False,
                 config=None,
                 base_dims=None,
                 ledger=None,
                 lease_config: Optional[Dict[str, Any]] = None,
                 standby_warm_interval: float = 2.0,
                 telemetry_port: Optional[int] = None,
                 device=None):
        """`device`: where a Scheduler built here runs — the card unless
        the caller names another (`"cpu"`); with no card and no explicit
        CPU it raises (state/arrays.py resolve_device). A caller-built
        `scheduler` keeps its own device."""
        from ..state.dims import Dims

        # ComponentConfig / Policy surface (apis/config/types.go:45-112 →
        # sched/config.py): a config file/dict drives scheduler name, plugin
        # composition + weights, extenders, backoff bounds, feature gates,
        # preemption, and leader election.
        self.config = None
        framework = None
        extenders = ()
        queue = None
        if config is not None and scheduler is not None:
            # a pre-built Scheduler already fixed its queue/framework/
            # extenders — applying only the remainder of the config would be
            # a silently half-applied configuration
            raise ValueError(
                "pass either a pre-built scheduler OR a config; a config's "
                "queue/framework/extender wiring cannot be grafted onto an "
                "existing Scheduler")
        if config is not None:
            from ..extender.client import HTTPExtender
            from ..sched.config import (
                KubeSchedulerConfiguration, load_config)
            from ..sched.queue import PriorityQueue

            self.config = (config if isinstance(config, KubeSchedulerConfiguration)
                           else load_config(config))
            self.config.apply_feature_gates()
            scheduler_name = self.config.scheduler_name
            framework = self.config.build_framework()
            extenders = tuple(HTTPExtender(e) for e in self.config.extenders)
            queue = PriorityQueue(
                initial_backoff=self.config.pod_initial_backoff_seconds,
                max_backoff=self.config.pod_max_backoff_seconds)
            leader_elect = leader_elect or self.config.leader_election.leader_elect

        self.client = client
        self.recorder = EventRecorder(client, component=scheduler_name)
        self.scheduler = scheduler or Scheduler(
            binder=APIBinder(client), scheduler_name=scheduler_name,
            queue=queue,
            framework=framework,
            extenders=extenders,
            # shape floor: tiny waves share one compiled (P,N,E) signature
            # instead of recompiling at every power-of-two batch size; a
            # caller expecting a large cluster pre-sizes (capacity
            # provisioning — avoids growth-bucket recompiles mid-flight)
            base_dims=base_dims or Dims(N=64, P=128, E=512),
            device=device)
        if self.scheduler.binder is None:
            self.scheduler.binder = APIBinder(client)
        if self.config is not None:
            if self.config.decision_provenance:
                # config-file switch for the provenance pipeline (the env
                # alternative is KTPU_EXPLAIN); the event sink attaches in
                # start() with the informer lister
                self.scheduler.enable_explain()
            self.scheduler.hard_pod_affinity_weight = float(
                self.config.hard_pod_affinity_symmetric_weight)
            # the fused engines honor the plugin composition through traced
            # per-component weights/flags (ops/lattice.py EngineConfig)
            self.scheduler.engine_config = self.config.engine_config()
            # NodeLabel needs vocab ids for its configured keys; intern them
            # now so the ids are stable before any node arrives. A caller-
            # supplied Scheduler keeps its own framework (possibly None).
            fw = self.scheduler.framework
            for pl in (fw.score_plugins if fw is not None else ()):
                if type(pl).__name__ == "NodeLabel":
                    keys = self.scheduler.encoder.vocabs.label_keys
                    pl._present_ids = tuple(keys.intern(k) for k in pl.present)
                    pl._absent_ids = tuple(keys.intern(k) for k in pl.absent)
        if scheduler is None and (self.config is None or
                                  not self.config.disable_preemption):
            from ..sched.preemption import APIEvictor, Preemptor

            # preemption is ON by default — DisablePreemption defaults
            # false (apis/config/types.go:76); only an explicit
            # disablePreemption: true (or a caller-built Scheduler) turns
            # it off. Victims are evicted THROUGH THE API (APIEvictor) —
            # the cache-only default evictor would free resources the
            # scheduler sees while the victim pod lives on in the
            # apiserver, double-booking its node. PDB lister for the
            # preemption what-if (filterPodsWithPDBViolation inputs) —
            # served from the PDB informer cache wired in start(), like
            # the reference's policy lister, never a synchronous LIST on
            # the preemption hot path
            self.scheduler.preemptor = Preemptor(
                evictor=APIEvictor(client),
                pdb_source=lambda: list(self._pdb_cache.values()))
        self.cycle_interval = cycle_interval
        # debounce: when pods flood in, wait this long so one batched device
        # wave absorbs them instead of many tiny waves (adds at most this
        # much latency to an isolated pod)
        self.batch_window = batch_window
        self.pdb_informer = None
        self._pdb_cache: Dict[str, tuple] = {}  # key → (ns, selector, allowed)
        self._creation_seq = 0
        self._stop = threading.Event()
        self._threads = []
        self._mu = threading.Lock()  # serializes event handlers vs waves
        self.pod_informer: Optional[SharedInformer] = None
        self.node_informer: Optional[SharedInformer] = None
        self.elector: Optional[LeaderElector] = None
        self._active = threading.Event()
        if leader_elect:
            self.elector = LeaderElector(client, LeaderElectionConfig(
                lock_name="kube-scheduler",
                on_started_leading=self._active.set,
                on_stopped_leading=self._on_stopped_leading,
                **(lease_config or {})))
            # fencing: the scheduler stamps the elector's lease generation
            # into intents; the API binder stamps it into Binding writes
            self.scheduler.fence_source = \
                lambda: self.elector.fencing_token
            if isinstance(self.scheduler.binder, APIBinder):
                self.scheduler.binder.fence_source = \
                    lambda: self.elector.fencing_token
        else:
            self._active.set()
        # exactly-once restart/HA (sched/ledger.py): with a ledger attached,
        # every (re)acquisition of leadership — including plain process
        # start — reconciles unretired bind intents BEFORE the first wave
        self.scheduler.ledger = ledger if ledger is not None \
            else self.scheduler.ledger
        self.standby_warm_interval = standby_warm_interval
        self._standby_last = 0.0
        self._needs_recover = self.scheduler.ledger is not None
        self.last_recovery = None      # RecoveryReport of the latest pass
        self.last_recovery_error = None
        self.takeovers = 0             # leadership activations that ran one
        self._crashed = False
        self.total_scheduled = 0
        self.total_unschedulable_events = 0
        # scheduler-side /metrics + /debug/flightrecorder exposition
        # (TelemetryGateway): None = off, 0 = ephemeral port, N = fixed
        self.telemetry_port = telemetry_port
        self.telemetry_gateway: Optional[TelemetryGateway] = None

    # -- conversion --------------------------------------------------------- #

    def _to_pod(self, obj: Obj) -> Pod:
        pod = pod_from_v1(obj)
        # stable FIFO-within-priority ordering (creationTimestamp analog)
        self._creation_seq += 1
        pod.creation_index = self._creation_seq
        return pod

    @staticmethod
    def _schedulable(obj: Obj) -> bool:
        return pod_schedulable_v1(obj)

    # -- event handlers (eventhandlers.go:335-441) --------------------------- #

    def _on_pod_add(self, obj: Obj) -> None:
        if not self._schedulable(obj):
            return
        with self._mu:
            self.scheduler.on_pod_add(self._to_pod(obj))

    def _on_pod_update(self, old: Obj, new: Obj) -> None:
        with self._mu:
            apply_pod_update_v1(self.scheduler, old, new, self._to_pod)

    def _on_pod_delete(self, obj: Obj) -> None:
        with self._mu:
            self.scheduler.on_pod_delete(pod_from_v1(obj))

    def _on_node_add(self, obj: Obj) -> None:
        with self._mu:
            self.scheduler.on_node_add(node_from_v1(obj))

    def _on_node_update(self, old: Obj, new: Obj) -> None:
        with self._mu:
            self.scheduler.on_node_update(node_from_v1(new))

    def _on_node_delete(self, obj: Obj) -> None:
        with self._mu:
            self.scheduler.on_node_delete(meta.name(obj))

    # -- lifecycle ----------------------------------------------------------- #

    def _on_pdb(self, obj: Obj) -> None:
        from ..api.v1 import _label_selector

        m = obj.get("metadata", {})
        key = f"{m.get('namespace', 'default')}/{m.get('name', '')}"
        self._pdb_cache[key] = (
            m.get("namespace", "default"),
            _label_selector(obj.get("spec", {}).get("selector")),
            int(obj.get("status", {}).get("disruptionsAllowed", 0)),
        )

    def _on_pdb_delete(self, obj: Obj) -> None:
        m = obj.get("metadata", {})
        self._pdb_cache.pop(
            f"{m.get('namespace', 'default')}/{m.get('name', '')}", None)

    def start(self) -> "SchedulerServer":
        if self.scheduler.preemptor is not None \
                and getattr(self.scheduler.preemptor, "pdb_source", None) \
                is not None:
            self.pdb_informer = SharedInformer(
                self.client.poddisruptionbudgets)
            self.pdb_informer.add_handlers(
                on_add=self._on_pdb,
                on_update=lambda old, new: self._on_pdb(new),
                on_delete=self._on_pdb_delete)
            self.pdb_informer.start()
            self.pdb_informer.wait_for_sync()
        self.pod_informer = SharedInformer(self.client.pods)
        self.pod_informer.add_handlers(on_add=self._on_pod_add,
                                       on_update=self._on_pod_update,
                                       on_delete=self._on_pod_delete)
        self.node_informer = SharedInformer(self.client.nodes)
        self.node_informer.add_handlers(on_add=self._on_node_add,
                                        on_update=self._on_node_update,
                                        on_delete=self._on_node_delete)
        self.node_informer.start()
        self.node_informer.wait_for_sync()
        self.pod_informer.start()
        self.pod_informer.wait_for_sync()
        if self.elector is not None:
            self.elector.start()
        # SIGUSR2 cache dump/compare (internal/cache/debugger/debugger.go:55)
        from ..sched.debugger import CacheComparer, install_sigusr2

        self.comparer = CacheComparer(self.scheduler.cache, self.client)
        install_sigusr2(self.comparer)
        # decision provenance: rich FailedScheduling events flow through
        # the apiserver on the APIBinder transport discipline (the pushback
        # retry budget) — wired here, where the informer lister can supply
        # involvedObject UIDs
        if self.scheduler.explainer is not None \
                and self.scheduler.explainer.sink is None:
            from ..sched.explain import APIEventSink

            self.scheduler.explainer.sink = APIEventSink(
                self.client, component=self.scheduler.scheduler_name,
                pod_lookup=lambda ns, name: (
                    self.pod_informer.lister.get(ns, name)
                    if self.pod_informer is not None else None))
        if self.telemetry_port is not None:
            self.telemetry_gateway = TelemetryGateway(
                self.scheduler.telemetry, port=self.telemetry_port,
                scheduler=self.scheduler).start()
        t = threading.Thread(target=self._loop, daemon=True,
                             name="scheduler-loop")
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self.elector is not None:
            self.elector.stop()
        for inf in (self.pod_informer, self.node_informer,
                    self.pdb_informer):
            if inf is not None:
                inf.stop()
        for t in self._threads:
            t.join(timeout=2)
        if self.telemetry_gateway is not None:
            self.telemetry_gateway.stop()
            self.telemetry_gateway = None
        self.scheduler.telemetry.stop_profile()

    def crash(self) -> None:
        """Simulated abrupt process death (restart drills, bench failover
        stage): the loop and informers stop, but the Lease is NOT released,
        no callbacks fire, and nothing is requeued or flushed — whatever
        the bind pipeline had in flight stays exactly where the 'kill'
        caught it (unretired intents included). The next leader's
        reconciliation is what cleans up — that is the thing under test."""
        self._crashed = True
        self._stop.set()
        if self.elector is not None:
            self.elector.crash()
        for inf in (self.pod_informer, self.node_informer,
                    self.pdb_informer):
            if inf is not None:
                inf.stop()
        for t in self._threads:
            t.join(timeout=2)

    def _on_stopped_leading(self) -> None:
        """Any leadership loss re-arms the reconciliation pass HERE, on the
        elector thread — not only in the loop's standby branch. A loop
        wedged inside a long degraded wave can lose and re-acquire the
        lease without ever observing the inactive state; arming on the
        callback guarantees the re-acquisition still replays whatever the
        interim leader left unretired before serving a single wave."""
        self._needs_recover = self.scheduler.ledger is not None
        self._active.clear()

    def _lookup_pod(self, pod_key: str):
        """Informer truth for intent replay: the live pod (node_name = the
        apiserver's committed view) or None when deleted."""
        from ..api.v1 import pod_from_v1

        ns, name = meta.split_key(pod_key)
        obj = self.pod_informer.lister.get(ns, name) \
            if self.pod_informer is not None else None
        if obj is None:
            return None
        return self._to_pod(obj) if not obj.get("spec", {}).get("nodeName") \
            else pod_from_v1(obj)

    # -- the loop (wait.Until(scheduleOne) → batched waves) ------------------ #

    def _loop(self) -> None:
        while not self._stop.is_set():
            if not self._active.is_set():
                # warm standby: the next activation must find compiled
                # executables and a resident snapshot, not a cold encoder —
                # failover skips cold-compile and full re-ingest
                self._needs_recover = self.scheduler.ledger is not None
                now = time.monotonic()
                if now - self._standby_last >= self.standby_warm_interval:
                    self._standby_last = now
                    with self._mu:
                        try:
                            self.scheduler.warm_standby()
                        except Exception:  # noqa: BLE001 - standby warmth
                            pass           # is an optimization, never fatal
                self._stop.wait(0.2)
                continue
            if self._needs_recover:
                # first led beat (process start, or a takeover): replay
                # unretired bind intents against informer truth before any
                # wave pops a pod — exactly-once binding across the handoff
                self._needs_recover = False
                with self._mu:
                    try:
                        self.last_recovery = self.scheduler.recover(
                            lookup=self._lookup_pod)
                        self.takeovers += 1
                        # a takeover is a flight-recorder trigger: the ring
                        # at this moment explains what the interim leader's
                        # waves looked like when the lease changed hands
                        self.scheduler.telemetry.dump("takeover")
                    except Exception as e:  # noqa: BLE001 - a failed
                        # recovery pass leaves the intents unretired for
                        # the next one; scheduling proceeds (pods are
                        # requeued by informer truth regardless)
                        self.last_recovery_error = e
            with self._mu:
                pending = self.scheduler.queue.lengths()[0]
            if pending and self.batch_window:
                # coalesce STORMS into few large waves with the full
                # window; a small pending set (a preemption retry burst, a
                # gang trickling in over milliseconds) gets a SHORT wait —
                # enough to gather co-created pods into one all-or-nothing
                # wave, without the full window's latency tax on every
                # tiny wave (a preemption burst would spend ~1 s just
                # waiting)
                w = self.batch_window if pending >= 32 \
                    else min(0.05, self.batch_window)
                self._stop.wait(w)  # let the batch fill
            stats = self.run_one_wave()
            if stats is None or stats.attempted == 0:
                self._stop.wait(self.cycle_interval)

    def run_one_wave(self):
        from ..sched import metrics as sched_metrics

        with self._mu:
            try:
                stats = self.scheduler.schedule_pending()
            except Exception:  # noqa: BLE001 — the loop never dies
                return None
            # depths() carries the deferred lane too — the governor's own
            # control signals become scrapeable gauges
            queue_lengths = self.scheduler.queue.depths()
            cache_counts = (len(self.scheduler.cache.nodes()),
                            len(self.scheduler.cache.scheduled_pods()))
        sched_metrics.observe_wave(stats, queue_lengths, cache_counts)
        self.total_scheduled += stats.scheduled
        if stats.unschedulable:
            self.total_unschedulable_events += stats.unschedulable
        # FailedScheduling events, as scheduler.go:436-448 records on
        # FitError. With decision provenance on, the explainer already
        # emitted the rich per-predicate events from inside the wave for
        # every pod it ATTRIBUTED — the generic message would double-post
        # a weaker duplicate for those. But failure paths the attribution
        # never sees (extender rejections, framework rollbacks, the
        # gang-host-rounds route, a failed attribution readback) must
        # still get the generic event: gate per pod on whether an
        # attribution doc exists, not on the explainer's mere presence.
        explainer = self.scheduler.explainer
        for key in stats.failed_keys:
            if explainer is not None and explainer.why(key) is not None:
                continue
            ns, name = meta.split_key(key)
            obj = self.pod_informer.lister.get(ns, name) \
                if self.pod_informer else None
            if obj is not None:
                self.recorder.event(obj, "Warning", "FailedScheduling",
                                    "no nodes available to schedule pod")
        return stats

    def wait_until_idle(self, timeout: float = 30.0) -> bool:
        """Test helper: wait until no pods are pending in the active queue."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._mu:
                active = self.scheduler.queue.lengths()[0]
            if active == 0:
                return True
            time.sleep(0.05)
        return False
