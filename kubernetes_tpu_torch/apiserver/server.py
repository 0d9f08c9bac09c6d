"""The API server: REST engine + HTTP front end with watch streaming (a copy
of the JAX package's apiserver/server.py; the engine holds no device state:
it is host code wherever it runs).

Analog of `cmd/kube-apiserver` + the generic apiserver library
(`staging/src/k8s.io/apiserver/pkg/server/`): a delegation of
Store-per-resource registries behind one handler chain. The engine
(`APIServer`) is usable in-process (the integration-test path — the reference
does the same with its in-process master, `test/integration/framework`);
`HTTPGateway` serves the same engine over HTTP with chunked watch streams.

Request paths match the reference wire layout:
    /api/v1/{resource}                              (legacy core group)
    /api/v1/namespaces/{ns}/{resource}[/{name}[/{sub}]]
    /apis/{group}/{version}/...
    /healthz /readyz /livez /version /metrics /api /apis
"""

from __future__ import annotations

import json
import os
import socketserver
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..machinery import errors, meta
from ..machinery import watch as mwatch
from ..machinery.scheme import ResourceInfo, Scheme
from ..apiserver.registry import AdmissionFn, Store
from ..apiserver.resources import build_scheme
from ..storage.store import Storage

Obj = Dict[str, Any]

VERSION_INFO = {
    "major": "1", "minor": "17+",
    "gitVersion": "v1.17.0-torch.1",
    "platform": "torch",
}

# registered HERE, against the shared registry, like client/informers.py
# does for its own series — an apiserver metric must not depend on the
# sched package being importable
from ..component.metrics import DEFAULT_REGISTRY as _REG  # noqa: E402

APISERVER_INFLIGHT_REJECTS = _REG.counter(
    "apiserver_inflight_request_rejects_total",
    "Requests rejected 429 by the max-inflight filter, by class",
    labels=("kind",))


class MaxInflightFilter:
    """Admission-by-capacity for the request path — the analog
    of the reference's max-inflight filter
    (apiserver/pkg/server/filters/maxinflight.go): at most `limit`
    readonly and `mutating_limit` mutating requests execute concurrently;
    a request arriving with the lane full is rejected IMMEDIATELY with
    429 TooManyRequests + `retryAfterSeconds` (the reference's
    `Retry-After: 1`) — never queued, so a storm cannot pile latency onto
    requests the server will shed anyway. Watches are exempt (the
    long-running-request check): they hold their slot for the stream's
    lifetime and are bounded by the watcher registry instead.

    0 (the default) disables a lane. Thread-safe: the HTTP gateway serves
    from a thread pool and LocalTransport callers race informer pumps."""

    def __init__(self, limit: int = 0, mutating_limit: int = 0,
                 retry_after_s: int = 1):
        self.limit = int(limit)
        self.mutating_limit = int(mutating_limit)
        self.retry_after_s = retry_after_s
        self._mu = threading.Lock()
        self._inflight = 0
        self._inflight_mutating = 0
        self.rejected = 0
        self.rejected_mutating = 0
        self.peak = 0

    def acquire(self, mutating: bool) -> bool:
        with self._mu:
            if mutating:
                if self.mutating_limit and \
                        self._inflight_mutating >= self.mutating_limit:
                    self.rejected_mutating += 1
                    APISERVER_INFLIGHT_REJECTS.inc(kind="mutating")
                    return False
                self._inflight_mutating += 1
            else:
                if self.limit and self._inflight >= self.limit:
                    self.rejected += 1
                    APISERVER_INFLIGHT_REJECTS.inc(kind="readonly")
                    return False
                self._inflight += 1
            self.peak = max(self.peak,
                            self._inflight + self._inflight_mutating)
            return True

    def release(self, mutating: bool) -> None:
        with self._mu:
            if mutating:
                self._inflight_mutating -= 1
            else:
                self._inflight -= 1


class APIServer:
    """The in-process REST engine: one Store per served resource.

    admission: None installs the default plugin chain
    (apiserver/admission.py); pass an explicit callable (or
    `lambda op, info, obj, old: obj`) to override/disable.
    """

    def __init__(self, storage: Optional[Storage] = None,
                 admission: Optional[AdmissionFn] = None,
                 scheme: Optional[Scheme] = None,
                 max_inflight: Optional[int] = None,
                 max_mutating_inflight: Optional[int] = None,
                 watch_buffer: Optional[int] = None,
                 data_dir: Optional[str] = None,
                 durability: Optional[str] = None):
        from ..apiserver.admission import AdmissionChain
        from ..apiserver.crd import install_crd_hook

        # max-inflight request gate (maxinflight.go analog): explicit
        # ctor limits win; env KTPU_MAX_INFLIGHT / KTPU_MAX_MUTATING_
        # INFLIGHT otherwise; unset/0 = unlimited (the historical shape)
        if max_inflight is None:
            max_inflight = int(os.environ.get("KTPU_MAX_INFLIGHT", "0") or 0)
        if max_mutating_inflight is None:
            max_mutating_inflight = int(os.environ.get(
                "KTPU_MAX_MUTATING_INFLIGHT", "0") or 0)
        self.inflight = MaxInflightFilter(
            max_inflight, max_mutating_inflight) \
            if (max_inflight or max_mutating_inflight) else None
        # watch_buffer bounds every watcher's delivery buffer (the
        # cacher's per-watcher channel size; KTPU_WATCH_BUFFER env
        # inside Storage otherwise): a consumer that stops draining is
        # evicted with a too-old error, never allowed to balloon memory
        # data_dir (or KTPU_STORE_DIR) makes the control plane durable:
        # boot-time recovery replays snapshot + WAL tail BEFORE the first
        # request is served, so a rebooted apiserver answers with revisions
        # that continue the pre-crash sequence
        if data_dir is None:
            data_dir = os.environ.get("KTPU_STORE_DIR") or None
        self.storage = storage or Storage(watch_buffer=watch_buffer,
                                          data_dir=data_dir,
                                          durability=durability)
        self.scheme = scheme or build_scheme()
        if admission is None:
            admission = AdmissionChain()
        if hasattr(admission, "attach"):
            admission.attach(self)
        self.admission = admission
        from ..apiserver.webhooks import AuditLog, WebhookDispatcher

        self._webhooks = WebhookDispatcher(self)
        # audit backend (apiserver/pkg/audit): ring + optional JSONL file via
        # KTPU_AUDIT_LOG
        import os as _os

        self.audit = AuditLog(path=_os.environ.get("KTPU_AUDIT_LOG"))
        self._stores: Dict[Tuple[str, str], Store] = {}
        for info in self.scheme.resources():
            self._install(info)
        # TTL-bounded events storage (kube-apiserver --event-ttl,
        # default 1h): the decision-provenance pipeline writes a
        # FailedScheduling Event per (pod, reason-fingerprint) backoff step
        # — without a TTL the events namespace grows without bound. Pruned
        # lazily at read time (registry.Store); KTPU_EVENT_TTL=0 disables.
        try:
            ttl = float(os.environ.get("KTPU_EVENT_TTL", "3600") or 0)
        except ValueError:
            ttl = 3600.0
        ev_store = self._stores.get(("", "events"))
        if ev_store is not None and ttl > 0:
            ev_store.ttl_seconds = ttl
        # multi-version CRD conversion wiring: (group, plural) → entry
        # (apiextensions conversion/converter.go; see apiserver/crd.py)
        self.crd_conversions: Dict[Tuple[str, str], Any] = {}
        # namespace bookkeeping: ensure default namespaces exist
        for ns in ("default", "kube-system", "kube-public", "kube-node-lease"):
            try:
                self.store("", "namespaces").create("", {
                    "apiVersion": "v1", "kind": "Namespace",
                    "metadata": {"name": ns}})
            except errors.StatusError:
                pass
        install_crd_hook(self)

    def _install(self, info: ResourceInfo) -> Store:
        st = Store(self.storage, self.scheme, info, admission=self._admit)
        self._stores[(info.group, info.resource)] = st
        return st

    def _admit(self, op: str, info: ResourceInfo, obj: Optional[Obj],
               old: Optional[Obj]) -> Optional[Obj]:
        # Reference ordering (options/plugins.go: MutatingAdmissionWebhook
        # sits after the built-in mutators, ValidatingAdmissionWebhook after
        # the built-in validators): built-in mutate → mutating webhooks →
        # built-in validate → validating webhooks. Validators therefore see
        # the webhook-patched object — a mutating webhook cannot dodge quota
        # or LimitRange maxima. Webhook-config mutations are not
        # self-administered and instead invalidate the dispatcher's cache.
        adm = self.admission
        phased = hasattr(adm, "mutate") and hasattr(adm, "validate")
        if adm is not None:
            obj = adm.mutate(op, info, obj, old) if phased \
                else adm(op, info, obj, old)
        if info.group != "admissionregistration.k8s.io":
            obj = self._webhooks.dispatch(op, info, obj, old,
                                          phase="mutating")
            if phased:
                adm.validate(op, info, obj, old)
            self._webhooks.dispatch(op, info, obj, old, phase="validating")
        else:
            if phased:
                adm.validate(op, info, obj, old)
            self._webhooks.invalidate()
        return obj

    def close(self) -> None:
        self.audit.close()
        self.storage.close()

    # ------------------------------------------------------------------ #
    # registry access
    # ------------------------------------------------------------------ #

    def store(self, group: str, resource: str) -> Store:
        st = self._stores.get((group, resource))
        if st is None:
            info = self.scheme.lookup_resource(group, resource)
            if info is None:
                raise errors.new_not_found(resource, "")
            st = self._stores.get((info.group, info.resource))
            if st is None:
                raise errors.new_not_found(resource, "")
        return st

    def register_resource(self, info: ResourceInfo) -> Store:
        """Dynamic registration (the CRD install path)."""
        self.scheme.register(info)
        return self._install(info)

    def unregister_resource(self, group: str, resource: str) -> None:
        """Dynamic removal (CRD deletion). Stored CR objects remain in the
        backend but are no longer served, matching apiextensions."""
        self.scheme.unregister(group, resource)
        self._stores.pop((group, resource), None)

    # ------------------------------------------------------------------ #
    # subresources (registry/core/pod/storage: BindingREST, StatusREST …)
    # ------------------------------------------------------------------ #

    def bind_pod(self, namespace: str, name: str, binding: Obj) -> Obj:
        """POST pods/{name}/binding — the scheduler's terminal write
        (registry/core/pod/storage/storage.go BindingREST.Create).

        Fenced: a Binding stamped with a fencing token (the scheduler's
        lease generation, api.types.FENCING_TOKEN_ANNOTATION) is checked
        against the LIVE Lease; a strictly older token is a deposed
        leader's write racing its own failover and is rejected with 409 —
        the server-side half of exactly-once binding across leader
        handoffs. Unstamped Bindings (non-HA schedulers, kubectl) pass."""
        from ..utils import faultline

        if faultline.should("apiserver.slow", "bind"):
            # chaos: the commit path specifically outruns capacity — the
            # bind stalls KTPU_SLOW_S while the rest of the API stays
            # fast (what trips the commit-latency SLO, not the ingest)
            time.sleep(float(os.environ.get("KTPU_SLOW_S", "0.2")))
        target = (binding.get("target") or {}).get("name", "")
        if not target:
            raise errors.new_bad_request("binding.target.name is required")
        self._check_bind_fence(binding, name)
        uid_pre = meta.uid(binding)

        def apply(pod: Obj) -> Obj:
            if not pod:
                raise errors.new_not_found("pods", name)
            if uid_pre and meta.uid(pod) != uid_pre:
                raise errors.new_conflict("pods", name, "uid does not match")
            if pod.get("spec", {}).get("nodeName"):
                raise errors.new_conflict(
                    "pods", name, f'pod is already assigned to node '
                    f'"{pod["spec"]["nodeName"]}"')
            pod.setdefault("spec", {})["nodeName"] = target
            conds = pod.setdefault("status", {}).setdefault("conditions", [])
            conds.append({"type": "PodScheduled", "status": "True",
                          "lastTransitionTime": meta.now_rfc3339()})
            return pod

        return self.store("", "pods").storage.guaranteed_update(
            self.store("", "pods").key_for(namespace, name), apply,
            "pods", name)

    def _check_bind_fence(self, binding: Obj, name: str) -> None:
        """Reject a Binding whose fencing token is older than the current
        lease generation. Token == current accepts (the live leader);
        token > current accepts too (our Lease read can only lag the
        truth — monotonicity means a NEWER token is never the stale
        side). A missing Lease accepts: fencing is opt-in per write."""
        from ..api.types import (DEFAULT_FENCING_LEASE,
                                              FENCED_BIND_MARKER,
                                              FENCING_LEASE_ANNOTATION,
                                              FENCING_TOKEN_ANNOTATION)

        ann = (binding.get("metadata") or {}).get("annotations") or {}
        tok = ann.get(FENCING_TOKEN_ANNOTATION)
        if tok is None:
            return
        lease_ref = ann.get(FENCING_LEASE_ANNOTATION, DEFAULT_FENCING_LEASE)
        lns, _, lname = lease_ref.partition("/")
        try:
            lease = self.store("coordination.k8s.io", "leases").get(
                lns, lname)
        except errors.StatusError as e:
            if errors.is_not_found(e):
                return  # no lease on record → nothing to fence against
            raise  # any OTHER failure must not silently open the fence
        current = int((lease.get("spec") or {}).get("leaseTransitions", 0))
        try:
            stamped = int(tok)
        except (TypeError, ValueError):
            raise errors.new_bad_request(
                f"malformed fencing token {tok!r}") from None
        if stamped < current:
            raise errors.new_conflict(
                "pods", name,
                f"{FENCED_BIND_MARKER}: fencing token {stamped} is stale "
                f"(lease {lease_ref} is at generation {current}) — a "
                f"deposed scheduler may not commit placements")

    def evict_pod(self, namespace: str, name: str, eviction: Obj) -> Obj:
        """POST pods/{name}/eviction — PDB-gated delete. The gate decrements
        the budget atomically; a failed delete credits the slot back so a
        phantom eviction cannot pin the budget at zero."""
        pod = None
        if self.admission is not None:
            pod = self.store("", "pods").get(namespace, name)
            self.admission("EVICT", self.scheme.lookup_resource("", "pods"),
                           eviction, pod)
        try:
            return self.store("", "pods").delete(namespace, name)
        except errors.StatusError:
            if pod is not None:
                from ..apiserver.admission import (
                    credit_pdb_disruption,
                )

                credit_pdb_disruption(self, pod)
            raise

    def get_scale(self, group: str, resource: str, namespace: str,
                  name: str) -> Obj:
        obj = self.store(group, resource).get(namespace, name)
        return {
            "apiVersion": "autoscaling/v1", "kind": "Scale",
            "metadata": {"name": name, "namespace": namespace,
                         "resourceVersion": meta.resource_version(obj)},
            "spec": {"replicas": int(obj.get("spec", {}).get("replicas", 0))},
            "status": {"replicas": int(obj.get("status", {}).get("replicas", 0)),
                       "selector": ""},
        }

    def put_scale(self, group: str, resource: str, namespace: str,
                  name: str, scale: Obj) -> Obj:
        replicas = int(scale.get("spec", {}).get("replicas", 0))
        st_info = self.store(group, resource).info

        def apply(obj: Obj) -> Obj:
            if not obj:
                raise errors.new_not_found(resource, name)
            old = meta.deep_copy(obj)
            obj.setdefault("spec", {})["replicas"] = replicas
            # scale writes admit like any other UPDATE (webhooks included)
            out = self._admit("UPDATE", st_info, obj, old)
            return out if out is not None else obj

        st = self.store(group, resource)
        out = st.storage.guaranteed_update(st.key_for(namespace, name), apply,
                                           resource, name)
        return self.get_scale(group, resource, namespace, name)

    def delete_namespace(self, name: str) -> Obj:
        """Namespace delete = phase Terminating until spec.finalizers empties
        (registry/core/namespace/storage: Delete + FinalizeREST)."""
        st = self.store("", "namespaces")
        cur = st.get("", name)
        self._admit("DELETE", st.info, None, cur)  # incl. webhook dispatch

        def mark(o: Obj) -> Obj:
            if not o:
                raise errors.new_not_found("namespaces", name)
            meta.ensure_meta(o)["deletionTimestamp"] = meta.now_rfc3339()
            o.setdefault("status", {})["phase"] = "Terminating"
            return o

        out = st.storage.guaranteed_update(st.key_for("", name), mark,
                                           "namespaces", name)
        if not out.get("spec", {}).get("finalizers"):
            return st.storage.delete(st.key_for("", name), "namespaces", name)
        return out

    def finalize_namespace(self, name: str, ns_obj: Obj) -> Obj:
        st = self.store("", "namespaces")
        fins = ns_obj.get("spec", {}).get("finalizers", [])

        def apply(o: Obj) -> Obj:
            if not o:
                raise errors.new_not_found("namespaces", name)
            o.setdefault("spec", {})["finalizers"] = fins
            return o

        out = st.storage.guaranteed_update(st.key_for("", name), apply,
                                           "namespaces", name)
        if meta.is_being_deleted(out) and not out["spec"]["finalizers"]:
            return st.storage.delete(st.key_for("", name), "namespaces", name)
        return out

    # ------------------------------------------------------------------ #
    # discovery
    # ------------------------------------------------------------------ #

    def discovery_groups(self) -> Obj:
        groups: Dict[str, List[str]] = {}
        for info in self.scheme.resources():
            if info.group:
                entry = self.crd_conversions.get((info.group, info.resource))
                versions = list(entry.served) if entry is not None \
                    else [info.version]
                groups.setdefault(info.group, [])
                for v in versions:
                    if v not in groups[info.group]:
                        groups[info.group].append(v)
        return {"kind": "APIGroupList", "apiVersion": "v1", "groups": [
            {"name": g, "versions": [
                {"groupVersion": f"{g}/{v}", "version": v} for v in vs],
             "preferredVersion": {"groupVersion": f"{g}/{vs[0]}",
                                  "version": vs[0]}}
            for g, vs in sorted(groups.items())]}

    def discovery_resources(self, group: str, version: str) -> Obj:
        out = []
        for info in self.scheme.resources():
            # a multi-version CRD is discoverable at every served version,
            # not only the storage version its ResourceInfo registers
            entry = self.crd_conversions.get((info.group, info.resource))
            if entry is not None and info.group == group \
                    and version in entry.served and version != info.version:
                out.append({"name": info.resource, "kind": info.kind,
                            "namespaced": info.namespaced,
                            "shortNames": list(info.short_names),
                            "verbs": ["create", "delete", "deletecollection",
                                      "get", "list", "patch", "update",
                                      "watch"]})
                for sub in info.subresources:
                    out.append({"name": f"{info.resource}/{sub}",
                                "kind": info.kind,
                                "namespaced": info.namespaced,
                                "verbs": ["get", "update", "patch"]})
                continue
            if info.group == group and info.version == version:
                out.append({"name": info.resource, "kind": info.kind,
                            "namespaced": info.namespaced,
                            "shortNames": list(info.short_names),
                            "verbs": ["create", "delete", "deletecollection",
                                      "get", "list", "patch", "update",
                                      "watch"]})
                for sub in info.subresources:
                    out.append({"name": f"{info.resource}/{sub}",
                                "kind": info.kind, "namespaced": info.namespaced,
                                "verbs": ["get", "update", "patch"]})
        return {"kind": "APIResourceList",
                "groupVersion": f"{group}/{version}" if group else version,
                "resources": out}


# --------------------------------------------------------------------------- #
# request model shared by HTTP gateway and in-process clients
# --------------------------------------------------------------------------- #


_AUDIT_VERBS = {"POST": "create", "PUT": "update", "PATCH": "patch",
                "DELETE": "delete"}


def _is_csr_create_path(path: str) -> bool:
    """True when a POST path resolves to the certificatesigningrequests
    COLLECTION — the requester-identity stamp must key on what the server
    will actually create (the resolved resource), not on body `kind`, which
    the registry merely defaults."""
    parts = [p for p in path.split("/") if p]
    return bool(parts) and parts[-1] == "certificatesigningrequests"


class _ConvertingWatch:
    """Wraps a Watch, converting every event's object to the requested CRD
    version on delivery — what makes `watch sees converted objects` true for
    multi-version CRDs (conversion/converter.go applied to the watch path)."""

    def __init__(self, w: mwatch.Watch, fn: Callable[[Obj], Obj]):
        self._w = w
        self._fn = fn

    def next(self, timeout: Optional[float] = None):
        ev = self._w.next(timeout=timeout)
        if ev is None:
            return None
        if ev.type not in (mwatch.ADDED, mwatch.MODIFIED, mwatch.DELETED):
            # ERROR (e.g. the 410 Gone relist signal) and BOOKMARK carry
            # Status/bookmark payloads, not CR objects — never converted
            return ev
        try:
            return mwatch.Event(ev.type, self._fn(ev.object))
        except errors.StatusError as e:
            # converter failure mid-stream: surface it as a watch ERROR
            # (the reference's watch stream carries a Status event), then
            # end the stream — a silent clean EOF would hide the fault in
            # an indefinite relist loop
            self._w.stop()
            return mwatch.Event(mwatch.ERROR, e.status())

    def stop(self) -> None:
        self._w.stop()

    @property
    def stopped(self) -> bool:
        return self._w.stopped


def _conversion_for(api: APIServer, path: str):
    """(entry, wanted_version) when `path` addresses a multi-version CRD at
    a non-storage served version; (None, "") otherwise."""
    parts = [p for p in path.split("/") if p]
    if len(parts) < 4 or parts[0] != "apis":
        return None, ""
    group, want = parts[1], parts[2]
    rest = parts[3:]
    if rest[0] == "namespaces" and len(rest) >= 3:
        rest = rest[2:]
    entry = api.crd_conversions.get((group, rest[0]))
    if entry is None or want == entry.storage or want not in entry.served:
        return None, ""
    return entry, want


def handle_rest(api: APIServer, method: str, path: str,
                query: Dict[str, str], body: Optional[Obj], user: str = ""):
    """Route one REST request. Returns (code, obj) or ("WATCH", Watch).

    The max-inflight gate sits here — the chokepoint BOTH the
    HTTP gateway and LocalTransport cross — so in-proc storms are shed
    exactly like wire storms. Watches are exempt (long-running); a full
    lane rejects with 429 + retryAfterSeconds before any routing work."""
    gate = api.inflight
    if gate is None or query.get("watch", "") in ("true", "1"):
        return _handle_rest_admitted(api, method, path, query, body, user)
    mutating = method not in ("GET", "HEAD")
    if not gate.acquire(mutating):
        raise errors.new_too_many_requests(
            "too many requests in flight, please retry",
            retry_seconds=gate.retry_after_s)
    try:
        return _handle_rest_admitted(api, method, path, query, body, user)
    finally:
        gate.release(mutating)


def _handle_rest_admitted(api: APIServer, method: str, path: str,
                          query: Dict[str, str], body: Optional[Obj],
                          user: str = ""):
    """The pre-gate handle_rest: CRD conversion chokepoint + audit +
    router. Multi-version CRD requests convert here: bodies from the
    requested version to the storage version, results back (lists per item,
    watches per event). Mutations are audited here too (stage
    ResponseComplete, both outcomes) — the reference's audit filter sits in
    the same position in the handler chain."""
    from ..utils import faultline

    if faultline.should("apiserver.slow", "handle_rest"):
        # chaos: a control plane drowning in its own queue — every hit
        # request stalls for KTPU_SLOW_S before routing (the overload
        # drills use this to breach the commit-latency SLO
        # deterministically; the breaker is what's under test)
        time.sleep(float(os.environ.get("KTPU_SLOW_S", "0.2")))
    if faultline.should("apiserver.restart", "handle_rest"):
        # chaos: the apiserver process dies and comes back between two
        # requests. Storage (etcd) survives; every open watch connection
        # does not — each gets a terminal 503 Status first, so
        # reflectors RESUME from their last resourceVersion instead of
        # blind-relisting — and THIS request is the one that hit the
        # connection-refused window.
        api.storage.drop_watchers()
        raise errors.new_service_unavailable(
            "apiserver restarting (chaos-injected)")
    entry = None
    if api.crd_conversions:
        entry, want = _conversion_for(api, path)
    if entry is not None and isinstance(body, dict) and \
            method in ("POST", "PUT"):
        try:
            body = entry.convert([body], entry.storage)[0]
        except errors.StatusError as e:
            # a converter-down failure is still an audited outcome of the
            # attempted mutation ("both outcomes" holds for conversion too)
            if method in _AUDIT_VERBS:
                _audit(api, method, path, e.code, user, meta.name(body))
            raise
    if entry is not None and method == "PATCH" and want != entry.storage:
        # PATCH bodies are partial documents: they cannot convert wholesale.
        # The reference applies the patch AT THE REQUEST VERSION
        # (apiserver patch.go → conversion stack): read storage object,
        # convert to the request version, apply the dialect there, convert
        # the merged result back, CAS-write (PARITY #16 closed).
        out = _patch_through_conversion(api, entry, want, path,
                                        query, body, user)
    else:
        out = _handle_rest_audited(api, method, path, query, body, user)
    if entry is None:
        return out
    tag, obj = out
    if tag == "WATCH":
        return "WATCH", _ConvertingWatch(
            obj, lambda o: entry.convert([o], want)[0])
    if isinstance(obj, dict):
        if isinstance(obj.get("items"), list):
            obj = {**obj, "apiVersion": f"{entry.group}/{want}",
                   "items": entry.convert(obj["items"], want)}
        elif obj.get("kind") != "Status" and "metadata" in obj:
            obj = entry.convert([obj], want)[0]
    return tag, obj


def _patch_through_conversion(api: APIServer, entry, want: str,
                              path: str, query: Dict[str, str],
                              body, user: str):
    """Apply a CR patch at the REQUEST version when it differs from the
    storage version: GET (storage) → convert → merge/json-patch → convert
    back → CAS PUT, retried on conflict. Strategic merge is rejected for
    CRs (no struct tags), same as the reference."""
    from ..machinery.strategicpatch import json_patch

    ptype = query.get("__patchType", "merge")
    if ptype == "strategic":
        raise errors.StatusError(
            415, "UnsupportedMediaType",
            "strategic merge patch is not supported for custom resources")
    from ..apiserver.registry import _merge_patch

    def run():
        # the internal GET/PUT legs use the UNaudited router: the client
        # issued ONE patch, so the trail must show one patch — not a fan
        # of internal update events (one per CAS retry)
        last: Optional[errors.StatusError] = None
        for _ in range(5):
            _, cur = _handle_rest_inner(api, "GET", path, {}, None)
            cur_req = entry.convert([cur], want)[0]
            if ptype == "json":
                new_req = json_patch(cur_req, body)
            else:
                new_req = _merge_patch(cur_req, body or {})
            new_storage = entry.convert([new_req], entry.storage)[0]
            # CAS on the version we read — a racing write re-runs the patch
            meta.ensure_meta(new_storage)["resourceVersion"] = \
                meta.resource_version(cur)
            try:
                return _handle_rest_inner(api, "PUT", path, query,
                                          new_storage)
            except errors.StatusError as e:
                if not errors.is_conflict(e):
                    raise
                last = e
        raise last if last is not None else errors.StatusError(
            500, "InternalError", "patch retry limit")

    try:
        out = run()
    except errors.StatusError as e:
        _audit(api, "PATCH", path, e.code, user)
        raise
    _audit(api, "PATCH", path, out[0] if isinstance(out[0], int) else 200,
           user)
    return out


def _handle_rest_audited(api: APIServer, method: str, path: str,
                         query: Dict[str, str], body: Optional[Obj],
                         user: str = ""):
    if method not in _AUDIT_VERBS:
        return _handle_rest_inner(api, method, path, query, body)
    body_name = meta.name(body) if isinstance(body, dict) else ""
    try:
        out = _handle_rest_inner(api, method, path, query, body)
    except errors.StatusError as e:
        _audit(api, method, path, e.code, user, body_name)
        raise
    code = out[0] if isinstance(out[0], int) else 200
    _audit(api, method, path, code, user, body_name)
    return out


def _audit(api: APIServer, method: str, path: str, code: int,
           user: str, body_name: str = "") -> None:
    # NB: mirrors _handle_rest_inner's path grammar (kept separate because
    # the router may fail before resolving a store; any change to the
    # namespaces-subresource exception below must update BOTH sites)
    parts = [p for p in path.split("/") if p]
    ns = name = resource = ""
    try:
        rest = parts[2:] if parts[0] == "api" else parts[3:]
        # same namespaces-subresource exception as the router: finalize/
        # status on a namespace addresses the namespace itself
        if rest and rest[0] == "namespaces" and len(rest) >= 3 and not (
                len(rest) == 3 and rest[2] in ("finalize", "status")):
            ns, rest = rest[1], rest[2:]
        resource = rest[0] if rest else ""
        name = rest[1] if len(rest) > 1 else ""
    except IndexError:
        pass
    api.audit.record(_AUDIT_VERBS[method], resource, ns, name or body_name,
                     code, user)


def _handle_rest_inner(api: APIServer, method: str, path: str,
                       query: Dict[str, str], body: Optional[Obj]):
    parts = [p for p in path.split("/") if p]
    if not parts:
        return 200, {"paths": ["/api", "/apis", "/healthz", "/metrics",
                               "/openapi/v2", "/version"]}

    # non-resource endpoints
    if parts[0] in ("healthz", "readyz", "livez"):
        return 200, "ok"
    if parts[0] == "openapi":
        from ..apiserver.openapi import build_openapi

        return 200, build_openapi(api)
    if parts[0] == "metrics":
        from ..component.metrics import DEFAULT_REGISTRY

        return 200, DEFAULT_REGISTRY.expose_text()
    if parts[0] == "version":
        return 200, VERSION_INFO
    if parts[0] == "api" and len(parts) == 1:
        return 200, {"kind": "APIVersions", "versions": ["v1"]}
    if parts[0] == "apis" and len(parts) == 1:
        return 200, api.discovery_groups()
    if parts[0] == "api" and len(parts) == 2:
        return 200, api.discovery_resources("", parts[1])
    if parts[0] == "apis" and len(parts) == 3:
        return 200, api.discovery_resources(parts[1], parts[2])

    # resource endpoints
    if parts[0] == "api" and len(parts) >= 2:
        group, rest = "", parts[2:]
    elif parts[0] == "apis" and len(parts) >= 3:
        group, rest = parts[1], parts[3:]
    else:
        raise errors.new_not_found("path", path)
    if not rest:
        raise errors.new_not_found("path", path)

    # namespace scoping: namespaces/{ns}/{resource}/... — except the
    # namespaces subresources themselves (namespaces/{name}/finalize|status),
    # which the reference registers as explicit routes
    namespace = ""
    if rest[0] == "namespaces" and len(rest) >= 3 and not (
            len(rest) == 3 and rest[2] in ("finalize", "status")):
        namespace, rest = rest[1], rest[2:]
    resource = rest[0]
    name = rest[1] if len(rest) > 1 else ""
    sub = rest[2] if len(rest) > 2 else ""

    try:
        st = api.store(group, resource)
    except errors.StatusError:
        # aggregation layer (kube-aggregator proxyHandler): a group/version
        # no local registry serves may be claimed by an APIService
        from ..apiserver import aggregator

        version = parts[2] if parts[0] == "apis" and len(parts) > 2 else "v1"
        svc = aggregator.find_apiservice(api, group, version)
        if svc is None:
            raise
        return aggregator.proxy(api, svc, method, path, query, body)
    info = st.info

    lsel = query.get("labelSelector", "")
    fsel = query.get("fieldSelector", "")
    rv = query.get("resourceVersion", "")
    watching = query.get("watch", "") in ("true", "1")
    # WatchBookmarks opt-in (apiserver watch handler's allowWatchBookmarks)
    bookmarks = query.get("allowWatchBookmarks", "") in ("true", "1")

    if not name:
        if watching:
            return "WATCH", st.watch(namespace, lsel, fsel, rv,
                                     allow_bookmarks=bookmarks)
        if method == "GET":
            return 200, st.list(namespace, lsel, fsel)
        if method == "POST":
            return 201, st.create(namespace, body or {})
        if method == "DELETE":
            gone = st.delete_collection(namespace, lsel, fsel)
            return 200, api.scheme.new_list(info, gone)
        raise errors.new_method_not_supported(resource, method)

    # subresources
    if sub:
        if sub == "binding" and info.resource == "pods" and method == "POST":
            return 201, api.bind_pod(namespace, name, body or {})
        if sub == "eviction" and info.resource == "pods" and method == "POST":
            return 201, api.evict_pod(namespace, name, body or {})
        if sub == "scale":
            if method == "GET":
                return 200, api.get_scale(group, resource, namespace, name)
            if method == "PUT":
                return 200, api.put_scale(group, resource, namespace, name,
                                          body or {})
        if sub == "finalize" and info.resource == "namespaces" and method == "PUT":
            return 200, api.finalize_namespace(name, body or {})
        if sub == "approval" and info.resource == "certificatesigningrequests" \
                and method == "PUT":
            # CSR approval (pkg/registry/certificates approval REST): the
            # body is the CSR carrying Approved/Denied conditions; only
            # status.conditions lands (spec + certificate untouched —
            # enforced by the registry's approval strategy)
            return 200, st.update(namespace, name, body or {},
                                  subresource="approval")
        if sub == "status":
            if method == "GET":
                return 200, st.get(namespace, name)
            if method == "PUT":
                return 200, st.update(namespace, name, body or {},
                                      subresource="status")
            if method == "PATCH":
                return 200, st.patch(
                    namespace, name, {} if body is None else body,
                    subresource="status",
                    patch_type=query.get("__patchType", "merge"))
        raise errors.new_method_not_supported(f"{resource}/{sub}", method)

    if watching:
        return "WATCH", st.watch(namespace, lsel,
                                 f"metadata.name={name}" + (f",{fsel}" if fsel else ""),
                                 rv, allow_bookmarks=bookmarks)
    if method == "GET":
        return 200, st.get(namespace, name)
    if method == "PUT":
        return 200, st.update(namespace, name, body or {})
    if method == "PATCH":
        # `body or {}` would collapse an EMPTY json-patch op list (a legal
        # no-op) into a dict and 400 it
        return 200, st.patch(namespace, name, {} if body is None else body,
                             patch_type=query.get("__patchType", "merge"))
    if method == "DELETE":
        if info.resource == "namespaces":
            return 200, api.delete_namespace(name)
        pre = (body or {}).get("preconditions", {}).get("resourceVersion")
        return 200, st.delete(namespace, name, expected_rv=pre)
    raise errors.new_method_not_supported(resource, method)


# --------------------------------------------------------------------------- #
# HTTP gateway
# --------------------------------------------------------------------------- #


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "kubernetes-tpu-apiserver"

    def log_message(self, fmt, *args):  # quiet
        pass

    def _run(self, method: str) -> None:
        from ..machinery import codec

        api: APIServer = self.server.api  # type: ignore[attr-defined]
        auth_gate = getattr(self.server, "auth_gate", None)
        parsed = urlparse(self.path)
        query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        # content negotiation (protobuf.go analog, machinery/codec.py):
        # binary replies only when the client Accepts them; binary bodies
        # recognized by Content-Type
        self._binary_reply = codec.accepts_binary(
            self.headers.get("Accept", ""))
        body: Optional[Obj] = None
        length = int(self.headers.get("Content-Length") or 0)
        if length:
            raw = self.rfile.read(length)
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            try:
                body = codec.decode(raw) \
                    if ctype == codec.BINARY_MEDIA_TYPE else json.loads(raw)
            except (json.JSONDecodeError, ValueError, IndexError):
                self._reply(400, errors.new_bad_request(
                    "invalid request body").status())
                return
            if method == "PATCH":
                # patch dialect rides Content-Type
                # (apiserver/pkg/endpoints/handlers/patch.go patchTypes)
                query["__patchType"] = {
                    "application/strategic-merge-patch+json": "strategic",
                    "application/json-patch+json": "json",
                }.get(ctype, "merge")
        try:
            user = ""
            try:
                if auth_gate is not None:
                    uinfo = auth_gate.check_info(method, parsed.path, query,
                                                 dict(self.headers.items()))
                    user = uinfo.name if uinfo is not None else ""
                    if (uinfo is not None and method == "POST"
                            and isinstance(body, dict)
                            and _is_csr_create_path(parsed.path)):
                        # the SERVER stamps the requester identity
                        # (registry/certificates strategy
                        # PrepareForCreate): client-claimed username/
                        # groups are overwritten, or bootstrap-group
                        # membership would be forgeable and the
                        # auto-approver's trust in spec.groups unfounded.
                        # Keyed on the RESOLVED RESOURCE PATH, never the
                        # body's kind: Store.create defaults an omitted
                        # kind AFTER this check, so a kind-less POST to
                        # the CSR collection used to slip through with
                        # forged spec.username/groups intact
                        body.setdefault("spec", {})["username"] = uinfo.name
                        body["spec"]["groups"] = list(uinfo.groups)
            except errors.StatusError as e:
                # denied requests are audited too (the reference's audit
                # filter wraps the authorizer for exactly this)
                if method in _AUDIT_VERBS:
                    _audit(api, method, parsed.path, e.code, user,
                           meta.name(body) if isinstance(body, dict) else "")
                raise
            result = handle_rest(api, method, parsed.path, query, body,
                                 user=user)
        except errors.StatusError as e:
            self._reply(e.code, e.status())
            return
        except Exception as e:  # noqa: BLE001 — the 500 boundary
            self._reply(500, errors.StatusError(
                500, "InternalError", str(e)).status())
            return
        if result[0] == "WATCH":
            self._stream_watch(result[1], query)
        else:
            self._reply(result[0], result[1])

    def _reply(self, code: int, obj: Any) -> None:
        from ..machinery import codec

        if getattr(self, "_binary_reply", False) and not isinstance(obj, str):
            data = codec.encode(obj)
            ctype = codec.BINARY_MEDIA_TYPE
        else:
            data = json.dumps(obj).encode() if not isinstance(obj, str) \
                else obj.encode()
            ctype = "application/json"
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        if code == 429 and isinstance(obj, dict):
            # the reference's max-inflight filter sets Retry-After: 1;
            # the Status body carries the same value as retryAfterSeconds
            ra = (obj.get("details") or {}).get("retryAfterSeconds")
            self.send_header("Retry-After", str(int(ra or 1)))
        self.end_headers()
        self.wfile.write(data)

    def _stream_watch(self, w: mwatch.Watch, query: Dict[str, str]) -> None:
        """Chunked stream of watch events: {"type","object"} JSON lines by
        default (apimachinery streaming serializer), varint-length-delimited
        binary frames when the client negotiated the binary codec (the
        streaming-protobuf seat)."""
        from ..machinery import codec

        binary = getattr(self, "_binary_reply", False)
        timeout = float(query.get("timeoutSeconds", "3600"))
        self.send_response(200)
        self.send_header("Content-Type", codec.BINARY_MEDIA_TYPE if binary
                         else "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        import time as _time
        deadline = _time.monotonic() + timeout
        try:
            while _time.monotonic() < deadline:
                ev = w.next(timeout=min(1.0, deadline - _time.monotonic()))
                if ev is None:
                    if w.stopped:
                        break
                    continue
                if binary:
                    chunk = codec.encode_frame(
                        {"type": ev.type, "object": ev.object})
                else:
                    chunk = (json.dumps(
                        {"type": ev.type, "object": ev.object},
                        separators=(",", ":")) + "\n").encode()
                self.wfile.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            w.stop()
            try:
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass

    def do_GET(self):
        self._run("GET")

    def do_POST(self):
        self._run("POST")

    def do_PUT(self):
        self._run("PUT")

    def do_PATCH(self):
        self._run("PATCH")

    def do_DELETE(self):
        self._run("DELETE")


class _ThreadingHTTPServer(socketserver.ThreadingMixIn, socketserver.TCPServer):
    daemon_threads = True
    allow_reuse_address = True
    # the listen backlog: socketserver's 5 overflowed under a hundred hollow
    # kubelets' heartbeats and watches, and a client saw its connection
    # reset (ROADMAP §C, C6; the JAX package's gateway keeps 5)
    request_queue_size = 1024


class HTTPGateway:
    """Serve an APIServer over HTTP (the kube-apiserver process boundary)."""

    def __init__(self, api: APIServer, host: str = "127.0.0.1", port: int = 0,
                 auth_gate=None):
        self.api = api
        self._httpd = _ThreadingHTTPServer((host, port), _Handler)
        self._httpd.api = api  # type: ignore[attr-defined]
        self._httpd.auth_gate = auth_gate  # type: ignore[attr-defined]
        self.host, self.port = self._httpd.server_address
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="apiserver-http", daemon=True)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "HTTPGateway":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
