"""kube-aggregator: APIService registration + request proxying.

Analog of staging/src/k8s.io/kube-aggregator/pkg/apiserver/
(apiserver.go AddAPIService → proxyHandler): `APIService` objects claim a
{group, version}; requests under /apis/{group}/{version}/... that no local
registry serves are forwarded to the aggregated server and its response is
returned verbatim.

Deviation (same family as docs/PARITY.md #6): the reference resolves the
backing `spec.service` through cluster networking; there is no kernel/network
dataplane here, so the backend is addressed by `spec.externalURL` (or a
caller-registered in-process handler for tests). Watch streams are not
proxied — aggregated APIs here are request/response.

(A copy of the JAX package's apiserver/aggregator.py.)
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Callable, Dict, Optional, Tuple

from ..machinery import errors, meta

Obj = Dict[str, Any]

# test/in-process backends: APIService name → handler(method, path, query,
# body) → (code, obj). Checked before the HTTP proxy.
_LOCAL_BACKENDS: Dict[str, Callable] = {}


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, req, fp, code, msg, headers, newurl):
        return None  # surface the 3xx as an HTTPError → returned verbatim


_NO_REDIRECT_OPENER = urllib.request.build_opener(_NoRedirect)


def register_local_backend(name: str, handler: Callable) -> None:
    _LOCAL_BACKENDS[name] = handler


def unregister_local_backend(name: str) -> None:
    _LOCAL_BACKENDS.pop(name, None)


def find_apiservice(api, group: str, version: str) -> Optional[Obj]:
    """Look up the APIService claiming {version}.{group} (apiservice names
    follow the reference's <version>.<group> convention)."""
    try:
        store = api.store("apiregistration.k8s.io", "apiservices")
    except errors.StatusError:
        return None
    want = f"{version}.{group}" if group else version
    try:
        svc = store.get("", want)
    except errors.StatusError:
        return None
    return svc


def proxy(api, apiservice: Obj, method: str, path: str,
          query: Dict[str, str], body: Optional[Obj]) -> Tuple[int, Obj]:
    """Forward one request to the aggregated server (proxyHandler.ServeHTTP)."""
    name = meta.name(apiservice)
    local = _LOCAL_BACKENDS.get(name)
    if local is not None:
        return local(method, path, query, body)

    base = (apiservice.get("spec", {}) or {}).get("externalURL", "")
    if not base:
        raise errors.new_service_unavailable(
            f"APIService {name} has no reachable backend "
            "(spec.externalURL unset and no in-process handler)")
    url = base.rstrip("/") + "/" + path.lstrip("/")
    if query:
        url += "?" + urllib.parse.urlencode(query)
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method, headers={
        "Content-Type": "application/json"})
    # per-APIService timeout (the reference's proxy transport dial timeout);
    # redirects are NOT followed — the reference's proxyHandler returns the
    # backend's 3xx to the caller rather than re-issuing the (possibly
    # body-carrying) request to an attacker-chosen Location
    try:
        timeout = float((apiservice.get("spec", {}) or {})
                        .get("timeoutSeconds") or 10)
    except (TypeError, ValueError):
        timeout = 10.0
    try:
        with _NO_REDIRECT_OPENER.open(req, timeout=timeout) as resp:
            payload = resp.read()
            code = resp.status
    except urllib.error.HTTPError as e:
        payload = e.read()
        code = e.code
    except (urllib.error.URLError, OSError) as e:
        raise errors.new_service_unavailable(
            f"APIService {name}: backend unreachable: {e}")
    try:
        obj = json.loads(payload) if payload else {}
    except json.JSONDecodeError:
        obj = {"raw": payload.decode(errors="replace")}
    return code, obj
