"""Webhook admission + audit logging — the apiserver library's remaining
handler-chain tiers (SURVEY §2.2 "apiserver library": handler chain
(auth/n, auth/z, admission webhooks, audit)).

Webhook admission ⇔ plugin/pkg/admission/webhook/{mutating,validating}:
`MutatingWebhookConfiguration` / `ValidatingWebhookConfiguration` objects
register webhooks with resource rules; matching requests POST an
AdmissionReview to the webhook and apply its AdmissionResponse (patches for
mutating, allow/deny for both). As with the aggregation layer
(docs/PARITY.md #13), backends are addressed by `url` in clientConfig (or an
in-process handler for tests) — there is no cluster network to resolve a
service reference through. failurePolicy Ignore/Fail is honored.

Audit ⇔ staging/src/k8s.io/apiserver/pkg/audit: every REST mutation emits a
structured event (stage ResponseComplete) to a pluggable sink — an in-memory
ring by default, a JSONL file when `audit_path` is set (the reference's log
backend).

(A copy of the JAX package's apiserver/webhooks.py.)
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..machinery import errors, meta

Obj = Dict[str, Any]

# in-process webhook backends: url → handler(review) → response dict
_LOCAL_WEBHOOKS: Dict[str, Callable] = {}


def register_local_webhook(url: str, handler: Callable) -> None:
    _LOCAL_WEBHOOKS[url] = handler


def unregister_local_webhook(url: str) -> None:
    _LOCAL_WEBHOOKS.pop(url, None)


def _rule_matches(rule: Obj, op: str, info) -> bool:
    ops = rule.get("operations", ["*"])
    if "*" not in ops and op not in ops:
        return False
    groups = rule.get("apiGroups", ["*"])
    if "*" not in groups and info.group not in groups:
        return False
    versions = rule.get("apiVersions", ["*"])
    if "*" not in versions and info.version not in versions:
        return False
    scope = rule.get("scope", "*")
    if scope == "Namespaced" and not info.namespaced:
        return False
    if scope == "Cluster" and info.namespaced:
        return False
    resources = rule.get("resources", ["*"])
    return "*" in resources or info.resource in resources


def _webhook_selectors_match(api, wh: Obj, info, obj: Optional[Obj],
                             old: Optional[Obj]) -> bool:
    """namespaceSelector / objectSelector gating
    (webhook/rules + webhook/object matchers in the reference). matchPolicy
    is a no-op here — one served version per resource (docs/PARITY.md #14)."""
    from ..machinery import labels as mlabels

    osel = wh.get("objectSelector")
    if osel:
        sel = mlabels.from_label_selector(osel)
        if not (sel.matches(meta.labels_of(obj or {})) or
                (old is not None and sel.matches(meta.labels_of(old)))):
            return False
    nsel = wh.get("namespaceSelector")
    if nsel:
        if info.resource == "namespaces":
            # operations on a Namespace itself match against its own labels
            # (webhook/predicates/namespace/matcher.go GetNamespaceLabels)
            ns_obj = obj or old or {}
        elif info.namespaced:
            ns = meta.namespace(obj or old or {}) or "default"
            try:
                ns_obj = api.store("", "namespaces").get("", ns)
            except errors.StatusError:
                ns_obj = {}
        else:
            return True  # cluster-scoped: namespaceSelector never excludes
        if not mlabels.from_label_selector(nsel).matches(
                meta.labels_of(ns_obj)):
            return False
    return True


def _call_webhook(cfg_url: str, review: Obj, timeout: float) -> Obj:
    local = _LOCAL_WEBHOOKS.get(cfg_url)
    if local is not None:
        return local(review)
    import urllib.request

    req = urllib.request.Request(
        cfg_url, data=json.dumps(review).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _apply_json_patch(obj: Obj, patch: List[Obj]) -> Obj:
    """The subset of RFC 6902 mutating webhooks emit (add/replace/remove on
    simple paths)."""
    import copy

    out = copy.deepcopy(obj)
    for op in patch:
        parts = [p.replace("~1", "/").replace("~0", "~")
                 for p in op.get("path", "").strip("/").split("/") if p != ""]
        tgt = out
        for p in parts[:-1]:
            if isinstance(tgt, list):
                tgt = tgt[int(p)]
            else:
                tgt = tgt.setdefault(p, {})
        leaf = parts[-1] if parts else None
        kind = op.get("op")
        if kind in ("add", "replace"):
            if isinstance(tgt, list):
                if leaf == "-":
                    tgt.append(op.get("value"))
                else:
                    tgt.insert(int(leaf), op.get("value")) if kind == "add" \
                        else tgt.__setitem__(int(leaf), op.get("value"))
            elif leaf is None:
                out = op.get("value")
            else:
                tgt[leaf] = op.get("value")
        elif kind == "remove" and leaf is not None:
            if isinstance(tgt, list):
                del tgt[int(leaf)]
            else:
                tgt.pop(leaf, None)
    return out


class WebhookDispatcher:
    """Runs matching mutating then validating webhooks for one admission
    attempt (webhook/mutating/dispatcher.go + validating/dispatcher.go)."""

    def __init__(self, api):
        self.api = api
        # config cache, invalidated by APIServer._admit whenever a webhook
        # configuration itself is mutated (the watch-fed cached source the
        # reference uses, without a watcher thread): None = stale
        self._cache: Dict[str, Optional[List[Obj]]] = {}
        self._cache_mu = threading.Lock()

    def invalidate(self) -> None:
        with self._cache_mu:
            self._cache.clear()

    def _configs(self, kind_plural: str) -> List[Obj]:
        with self._cache_mu:
            cached = self._cache.get(kind_plural)
        if cached is not None:
            return cached
        try:
            store = self.api.store("admissionregistration.k8s.io", kind_plural)
        except errors.StatusError:
            return []  # resource not registered ⇒ genuinely no webhooks
        # storage failures fail CLOSED: admitting a mutation because the
        # webhook configs could not be read would bypass a Fail-policy hook
        objs, _ = store.storage.list(store.prefix_for(""))
        with self._cache_mu:
            self._cache[kind_plural] = objs
        return objs

    def dispatch(self, op: str, info, obj: Optional[Obj],
                 old: Optional[Obj],
                 phase: Optional[str] = None) -> Optional[Obj]:
        """phase='mutating'|'validating' runs one tier (the server interleaves
        built-in validators between them); None runs both in order."""
        tiers = (("mutating", "mutatingwebhookconfigurations"),
                 ("validating", "validatingwebhookconfigurations"))
        if phase is not None:
            tiers = tuple(t for t in tiers if t[0] == phase)
        for phase, plural in tiers:
            for cfg in self._configs(plural):
                for wh in cfg.get("webhooks", []) or []:
                    if not any(_rule_matches(r, op, info)
                               for r in wh.get("rules", []) or []):
                        continue
                    if not _webhook_selectors_match(self.api, wh, info,
                                                    obj, old):
                        continue
                    url = (wh.get("clientConfig", {}) or {}).get("url", "")
                    policy = wh.get("failurePolicy", "Fail")
                    timeout = float(wh.get("timeoutSeconds", 10))
                    review = {
                        "apiVersion": "admission.k8s.io/v1",
                        "kind": "AdmissionReview",
                        "request": {
                            "operation": op,
                            "resource": {"group": info.group,
                                         "resource": info.resource},
                            "namespace": meta.namespace(obj or old or {}),
                            "name": meta.name(obj or old or {}),
                            "object": obj, "oldObject": old,
                        },
                    }
                    try:
                        out = _call_webhook(url, review, timeout)
                    except Exception as e:  # noqa: BLE001 — policy decides
                        if policy == "Ignore":
                            continue
                        raise errors.new_service_unavailable(
                            f"admission webhook {wh.get('name', url)} "
                            f"failed: {e}")
                    resp = out.get("response", {}) or {}
                    if not resp.get("allowed", False):
                        msg = (resp.get("status", {}) or {}).get(
                            "message", "denied by admission webhook")
                        raise errors.new_forbidden(
                            info.resource, meta.name(obj or old or {}), msg)
                    if phase == "mutating" and resp.get("patch") and \
                            obj is not None:
                        import base64

                        try:
                            patch = json.loads(base64.b64decode(resp["patch"]))
                            obj = _apply_json_patch(obj, patch)
                        except Exception as e:  # malformed patch = webhook
                            # failure → failurePolicy decides, and callers
                            # always see a StatusError
                            if policy == "Ignore":
                                continue
                            raise errors.new_service_unavailable(
                                f"admission webhook {wh.get('name', url)} "
                                f"returned an unusable patch: {e}")
        return obj


class AuditLog:
    """apiserver/pkg/audit log backend: ResponseComplete events to a ring
    (and optionally a JSONL file)."""

    def __init__(self, capacity: int = 4096, path: Optional[str] = None):
        self._mu = threading.Lock()        # guards ring + seq + pending
        self._io_mu = threading.Lock()     # serializes file writers only
        self._ring = deque(maxlen=capacity)
        self._pending: List[Obj] = []      # events not yet on disk
        self._path = path
        self._file = None  # opened once, lazily (reference log backend)
        self._closed = False
        self._seq = 0

    def record(self, verb: str, resource: str, namespace: str, name: str,
               code: int, user: str = "") -> None:
        ev = {
            "kind": "Event", "apiVersion": "audit.k8s.io/v1",
            "stage": "ResponseComplete",
            "verb": verb, "user": {"username": user or "system:unknown"},
            "objectRef": {"resource": resource, "namespace": namespace,
                          "name": name},
            "responseStatus": {"code": code},
            "stageTimestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                            time.gmtime()),
        }
        with self._mu:
            self._seq += 1
            ev["auditID"] = f"audit-{self._seq}"
            self._ring.append(ev)
            if self._path:
                self._pending.append(ev)
        if self._path:
            self._flush()

    def _flush(self) -> None:
        """Drain pending events to the JSONL file OUTSIDE the record mutex:
        a slow disk batches behind one writer instead of serializing every
        REST mutation (the reference's log backend is likewise an async
        batching sink)."""
        with self._io_mu:
            with self._mu:
                batch, self._pending = self._pending, []
            if not batch or self._closed:
                return  # post-close records stay in the ring only
            if self._file is None:
                self._file = open(self._path, "a")
            self._file.write("".join(json.dumps(e) + "\n" for e in batch))
            self._file.flush()

    def close(self) -> None:
        if self._path:
            self._flush()
        with self._io_mu:
            self._closed = True
            if self._file is not None:
                self._file.close()
                self._file = None

    def events(self) -> List[Obj]:
        with self._mu:
            return list(self._ring)
