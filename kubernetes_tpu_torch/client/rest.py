"""REST transports + the typed client surface.

Analog of client-go's rest.RESTClient + typed clientsets. Two transports
serve the same interface: `LocalTransport` calls the in-process engine
directly (the integration-test path), `HTTPTransport` crosses the real wire
with chunked watch streams. Components depend only on `Client`.

A copy of the JAX package's client/rest.py over the port's apiserver
(apiserver/server.py), JSON only: the binary codec (machinery/codec.py) is
not ported yet (ROADMAP A11b, second half).
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from ..machinery import errors, meta
from ..machinery import watch as mwatch

Obj = Dict[str, Any]


def status_code(e: Exception) -> Optional[int]:
    """The HTTP status of an apiserver client's error: an exception with an
    int `code`, as machinery.errors.StatusError (either package's), else
    None."""
    code = getattr(e, "code", None)
    return code if isinstance(code, int) else None


@dataclass
class RetryPolicy:
    """Client-side retry budget for server PUSHBACK: 429 from
    the apiserver's max-inflight filter and 503 from a restart window are
    rejected BEFORE the request mutates anything, so retrying them is
    safe for every verb. Capped exponential backoff with jitter; the
    Status' `retryAfterSeconds` (the wire form of the reference's
    `Retry-After: 1` header) is honored as a floor; `deadline_s` bounds
    the whole attempt train. Any other failure propagates immediately.
    The error is classified by its `code` (`status_code`), so the budget
    also serves a caller whose client raises another package's status
    error (sched/explain.py APIEventSink)."""

    attempts: int = 3          # retries after the first try
    base_s: float = 0.05
    cap_s: float = 1.0
    deadline_s: float = 5.0
    # observability hook: called once per retry actually taken (APIBinder
    # counts absorbed pushback through it)
    on_retry: Optional[Any] = None

    def run(self, fn):
        deadline = time.monotonic() + self.deadline_s
        delay = self.base_s
        for attempt in range(self.attempts + 1):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 - classified by code
                if status_code(e) not in (429, 503) \
                        or attempt >= self.attempts:
                    raise
                details = getattr(e, "details", None) or {}
                ra = float(details.get("retryAfterSeconds") or 0)
                wait = max(ra, delay * random.uniform(0.5, 1.0))
                if time.monotonic() + wait > deadline:
                    raise
                if self.on_retry is not None:
                    self.on_retry()
                time.sleep(wait)
                delay = min(delay * 2, self.cap_s)
        raise AssertionError("unreachable")  # loop always returns/raises


class LocalTransport:
    """Direct calls into an in-process APIServer (no serialization cost —
    the reference's integration suite does the same with its in-proc
    master). `retry` opts into the pushback budget — the in-proc
    max-inflight filter raises the same 429s the wire path serves."""

    def __init__(self, api, retry: Optional[RetryPolicy] = None):
        self.api = api
        self.retry = retry

    def request(self, method: str, path: str, query: Dict[str, str],
                body: Optional[Obj]) -> Obj:
        from ..apiserver.server import handle_rest

        def once() -> Obj:
            code, obj = handle_rest(self.api, method, path, dict(query), body)
            return obj

        return once() if self.retry is None else self.retry.run(once)

    def stream_watch(self, path: str, query: Dict[str, str]) -> mwatch.Watch:
        from ..apiserver.server import handle_rest

        q = dict(query)
        q["watch"] = "true"
        try:
            tag, w = handle_rest(self.api, "GET", path, q, None)
        except errors.StatusError as e:
            # a REFUSED watch (410 Gone on a compacted resume RV, a restart
            # window's 503) surfaces as a terminal watch ERROR event — the
            # same shape the HTTP transport's pump delivers — so the
            # reflector's relist-vs-resume decision reads ONE code path on
            # both transports instead of a raised exception on one and a
            # Status event on the other
            w = mwatch.Watch(capacity=1)
            w.terminate(mwatch.Event(mwatch.ERROR, e.status()))
            return w
        assert tag == "WATCH"
        return w


class HTTPTransport:
    """The wire path: REST + chunked watch streams, JSON bodies."""

    def __init__(self, base_url: str, timeout: float = 30.0,
                 token: str = "", binary: bool = False,
                 retry: Optional[RetryPolicy] = None):
        if binary:
            raise NotImplementedError(
                "the binary codec (machinery/codec.py) is not ported yet "
                "(ROADMAP A11b, second half)")
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.token = token
        self.retry = retry

    def _url(self, path: str, query: Dict[str, str]) -> str:
        url = self.base_url + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        return url

    @staticmethod
    def _decode_body(raw: bytes) -> Obj:
        try:
            return json.loads(raw)
        except json.JSONDecodeError:
            return {"raw": raw.decode(errors="replace")}

    def request(self, method: str, path: str, query: Dict[str, str],
                body: Optional[Obj]) -> Obj:
        if self.retry is None:
            return self._request_once(method, path, query, body)
        return self.retry.run(
            lambda: self._request_once(method, path, query, body))

    def _request_once(self, method: str, path: str, query: Dict[str, str],
                      body: Optional[Obj]) -> Obj:
        # the patch dialect travels as a Content-Type on the wire (the
        # gateway maps it back; apiserver patch.go patchTypes) — pop the
        # local-transport query key and translate
        query = dict(query)
        ptype = query.pop("__patchType", None)
        req = urllib.request.Request(self._url(path, query), method=method)
        data = None
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        if body is not None:
            data = json.dumps(body).encode()
            req.add_header("Content-Type", {
                "strategic": "application/strategic-merge-patch+json",
                "json": "application/json-patch+json",
                "merge": "application/merge-patch+json",
            }.get(ptype, "application/json"))
        try:
            with urllib.request.urlopen(req, data=data,
                                        timeout=self.timeout) as r:
                return self._decode_body(r.read())
        except urllib.error.HTTPError as e:
            try:
                status = self._decode_body(e.read())
            except Exception:  # noqa: BLE001
                raise errors.StatusError(e.code, "Unknown", str(e))
            raise errors.from_status(status)

    def stream_watch(self, path: str, query: Dict[str, str]) -> mwatch.Watch:
        q = dict(query)
        q["watch"] = "true"
        q.setdefault("timeoutSeconds", "3600")
        # the socket timeout derives from the timeoutSeconds ACTUALLY sent
        # (plus the request-timeout margin) — a short-timeout watch must
        # hang up when the server does, not 1 h later (the old hardcoded
        # `self.timeout + 3600` kept a 10 s watch's socket open 3610 s)
        try:
            server_timeout = float(q["timeoutSeconds"])
        except (TypeError, ValueError):
            server_timeout = 3600.0
        sock_timeout = self.timeout + server_timeout
        w = mwatch.Watch(capacity=8192)

        def pump_json(r) -> None:
            for raw_line in r:
                if w.stopped:
                    return
                line = raw_line.strip()
                if not line:
                    continue
                ev = json.loads(line)
                w.send(mwatch.Event(ev["type"], ev["object"]))

        def pump() -> None:
            try:
                req = urllib.request.Request(self._url(path, q))
                if self.token:
                    req.add_header("Authorization", f"Bearer {self.token}")
                with urllib.request.urlopen(req, timeout=sock_timeout) as r:
                    pump_json(r)
            except urllib.error.HTTPError as e:
                # a refused watch (410 Gone on a compacted resume RV) must
                # surface as a watch ERROR, not masquerade as a clean
                # stream end — the reflector's relist path keys on it
                try:
                    status = self._decode_body(e.read())
                except Exception:  # noqa: BLE001
                    status = {"kind": "Status", "code": e.code,
                              "reason": "Unknown"}
                w.send(mwatch.Event(mwatch.ERROR, status))
            except Exception:  # noqa: BLE001 — stream teardown
                pass
            finally:
                w.stop()

        threading.Thread(target=pump, name="http-watch", daemon=True).start()
        return w


class ResourceClient:
    """Verbs for one resource (a typed clientset entry)."""

    def __init__(self, transport, group: str, version: str, resource: str,
                 namespaced: bool):
        self.transport = transport
        self.group = group
        self.version = version
        self.resource = resource
        self.namespaced = namespaced

    def _path(self, namespace: str = "", name: str = "", sub: str = "") -> str:
        root = f"/api/{self.version}" if not self.group else \
            f"/apis/{self.group}/{self.version}"
        parts = [root]
        if self.namespaced and namespace:
            parts.append(f"namespaces/{namespace}")
        parts.append(self.resource)
        if name:
            parts.append(name)
        if sub:
            parts.append(sub)
        return "/".join(parts)

    # -- verbs -------------------------------------------------------------- #

    def create(self, obj: Obj, namespace: str = "") -> Obj:
        ns = namespace or meta.namespace(obj) or ("default" if self.namespaced else "")
        return self.transport.request("POST", self._path(ns), {}, obj)

    def get(self, name: str, namespace: str = "default") -> Obj:
        return self.transport.request("GET", self._path(namespace, name), {}, None)

    def list(self, namespace: str = "", label_selector: str = "",
             field_selector: str = "") -> Obj:
        q = {}
        if label_selector:
            q["labelSelector"] = label_selector
        if field_selector:
            q["fieldSelector"] = field_selector
        return self.transport.request("GET", self._path(namespace), q, None)

    def update(self, obj: Obj, namespace: str = "") -> Obj:
        ns = namespace or meta.namespace(obj)
        return self.transport.request("PUT", self._path(ns, meta.name(obj)),
                                      {}, obj)

    def update_status(self, obj: Obj, namespace: str = "") -> Obj:
        ns = namespace or meta.namespace(obj)
        return self.transport.request(
            "PUT", self._path(ns, meta.name(obj), "status"), {}, obj)

    def patch(self, name: str, patch: Obj, namespace: str = "default",
              patch_type: str = "merge") -> Obj:
        q = {"__patchType": patch_type} if patch_type != "merge" else {}
        return self.transport.request("PATCH", self._path(namespace, name),
                                      q, patch)

    def patch_status(self, name: str, patch: Obj,
                     namespace: str = "default",
                     patch_type: str = "merge") -> Obj:
        q = {"__patchType": patch_type} if patch_type != "merge" else {}
        return self.transport.request(
            "PATCH", self._path(namespace, name, "status"), q, patch)

    def delete(self, name: str, namespace: str = "default",
               resource_version: str = "") -> Obj:
        body = None
        if resource_version:
            body = {"preconditions": {"resourceVersion": resource_version}}
        return self.transport.request("DELETE", self._path(namespace, name),
                                      {}, body)

    def delete_collection(self, namespace: str = "",
                          label_selector: str = "") -> Obj:
        q = {"labelSelector": label_selector} if label_selector else {}
        return self.transport.request("DELETE", self._path(namespace), q, None)

    def watch(self, namespace: str = "", label_selector: str = "",
              field_selector: str = "", resource_version: str = "",
              allow_bookmarks: bool = False,
              timeout_seconds: Optional[int] = None) -> mwatch.Watch:
        q: Dict[str, str] = {}
        if label_selector:
            q["labelSelector"] = label_selector
        if field_selector:
            q["fieldSelector"] = field_selector
        if resource_version:
            q["resourceVersion"] = resource_version
        if allow_bookmarks:
            q["allowWatchBookmarks"] = "true"
        if timeout_seconds is not None:
            # rides to the server AND (HTTP transport) sizes the socket
            # timeout — the two can no longer disagree by an hour
            q["timeoutSeconds"] = str(int(timeout_seconds))
        return self.transport.stream_watch(self._path(namespace), q)

    # -- subresources ------------------------------------------------------- #

    def bind(self, name: str, node_name: str, namespace: str = "default",
             uid: str = "", annotations: Optional[Dict[str, str]] = None
             ) -> Obj:
        binding = {"apiVersion": "v1", "kind": "Binding",
                   "metadata": {"name": name, "namespace": namespace},
                   "target": {"kind": "Node", "name": node_name}}
        if uid:
            binding["metadata"]["uid"] = uid
        if annotations:
            # fencing-token stamping rides here (api.types
            # FENCING_TOKEN_ANNOTATION); the server fences on it
            binding["metadata"]["annotations"] = dict(annotations)
        return self.transport.request(
            "POST", self._path(namespace, name, "binding"), {}, binding)

    def evict(self, name: str, namespace: str = "default") -> Obj:
        return self.transport.request(
            "POST", self._path(namespace, name, "eviction"), {},
            {"apiVersion": "policy/v1beta1", "kind": "Eviction",
             "metadata": {"name": name, "namespace": namespace}})

    def get_scale(self, name: str, namespace: str = "default") -> Obj:
        return self.transport.request("GET", self._path(namespace, name, "scale"),
                                      {}, None)

    def put_scale(self, name: str, replicas: int,
                  namespace: str = "default") -> Obj:
        return self.transport.request(
            "PUT", self._path(namespace, name, "scale"), {},
            {"spec": {"replicas": replicas}})

    def finalize(self, name: str, obj: Obj) -> Obj:
        return self.transport.request("PUT", self._path("", name, "finalize"),
                                      {}, obj)


_KNOWN = {
    # attr: (group, version, resource, namespaced)
    "pods": ("", "v1", "pods", True),
    "nodes": ("", "v1", "nodes", False),
    "namespaces": ("", "v1", "namespaces", False),
    "services": ("", "v1", "services", True),
    "endpoints": ("", "v1", "endpoints", True),
    "events": ("", "v1", "events", True),
    "configmaps": ("", "v1", "configmaps", True),
    "secrets": ("", "v1", "secrets", True),
    "serviceaccounts": ("", "v1", "serviceaccounts", True),
    "persistentvolumes": ("", "v1", "persistentvolumes", False),
    "persistentvolumeclaims": ("", "v1", "persistentvolumeclaims", True),
    "replicationcontrollers": ("", "v1", "replicationcontrollers", True),
    "resourcequotas": ("", "v1", "resourcequotas", True),
    "limitranges": ("", "v1", "limitranges", True),
    "deployments": ("apps", "v1", "deployments", True),
    "replicasets": ("apps", "v1", "replicasets", True),
    "statefulsets": ("apps", "v1", "statefulsets", True),
    "daemonsets": ("apps", "v1", "daemonsets", True),
    "controllerrevisions": ("apps", "v1", "controllerrevisions", True),
    "jobs": ("batch", "v1", "jobs", True),
    "cronjobs": ("batch", "v1beta1", "cronjobs", True),
    "poddisruptionbudgets": ("policy", "v1beta1", "poddisruptionbudgets", True),
    "leases": ("coordination.k8s.io", "v1", "leases", True),
    "endpointslices": ("discovery.k8s.io", "v1beta1", "endpointslices", True),
    "horizontalpodautoscalers": ("autoscaling", "v1",
                                 "horizontalpodautoscalers", True),
    "storageclasses": ("storage.k8s.io", "v1", "storageclasses", False),
    "csinodes": ("storage.k8s.io", "v1", "csinodes", False),
    "priorityclasses": ("scheduling.k8s.io", "v1", "priorityclasses", False),
    "customresourcedefinitions": ("apiextensions.k8s.io", "v1",
                                  "customresourcedefinitions", False),
    "roles": ("rbac.authorization.k8s.io", "v1", "roles", True),
    "rolebindings": ("rbac.authorization.k8s.io", "v1", "rolebindings", True),
    "clusterroles": ("rbac.authorization.k8s.io", "v1", "clusterroles",
                     False),
    "clusterrolebindings": ("rbac.authorization.k8s.io", "v1",
                            "clusterrolebindings", False),
    "certificatesigningrequests": ("certificates.k8s.io", "v1beta1",
                                   "certificatesigningrequests", False),
}


class Client:
    """The clientset: `client.pods.create(...)`, `client.resource(...)`."""

    def __init__(self, transport):
        self.transport = transport
        self._cache: Dict[Tuple[str, str, str], ResourceClient] = {}

    @staticmethod
    def local(api, retry: Optional[RetryPolicy] = None) -> "Client":
        return Client(LocalTransport(api, retry=retry))

    @staticmethod
    def http(base_url: str, token: str = "", binary: bool = False,
             retry: Optional[RetryPolicy] = None) -> "Client":
        """`retry` opts into the 429/503 pushback budget (RetryPolicy);
        `binary=True` (the binary codec) raises: not ported yet."""
        return Client(HTTPTransport(base_url, token=token, binary=binary,
                                    retry=retry))

    def resource(self, group: str, version: str, resource: str,
                 namespaced: bool = True) -> ResourceClient:
        key = (group, version, resource)
        if key not in self._cache:
            self._cache[key] = ResourceClient(self.transport, group, version,
                                              resource, namespaced)
        return self._cache[key]

    def __getattr__(self, attr: str) -> ResourceClient:
        spec = _KNOWN.get(attr)
        if spec is None:
            raise AttributeError(attr)
        return self.resource(spec[0], spec[1], spec[2], spec[3])

    def version(self) -> Obj:
        return self.transport.request("GET", "/version", {}, None)
