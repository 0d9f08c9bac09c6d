"""Generic REST registry: one Store per resource over storage.Interface.

Analog of `staging/src/k8s.io/apiserver/pkg/registry/generic/registry/store.go`
(Create:338, Update:453, Delete:605-1000, Watch:1087) — the machinery every
resource's REST storage shares: defaulting, validation, name/namespace
resolution, uid + creationTimestamp stamping, resourceVersion conflict
semantics, label/field selector filtering, finalizer-aware two-phase delete,
and watch with initial-events synthesis.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..machinery import errors, labels as mlabels, meta
from ..machinery import watch as mwatch
from ..machinery.scheme import ResourceInfo, Scheme
from ..storage.store import Storage

Obj = Dict[str, Any]

# admission hook: (operation, resource_info, obj, old_obj) -> obj (mutating)
# or raises StatusError (validating). operation ∈ CREATE/UPDATE/DELETE.
AdmissionFn = Callable[[str, ResourceInfo, Optional[Obj], Optional[Obj]], Optional[Obj]]


def parse_field_selector(sel: str) -> List[Tuple[str, str, bool]]:
    """fields.ParseSelector: comma-separated dotted-path (==|=|!=) value."""
    out: List[Tuple[str, str, bool]] = []
    if not sel:
        return out
    for part in sel.split(","):
        part = part.strip()
        if not part:
            continue
        if "!=" in part:
            k, _, v = part.partition("!=")
            out.append((k.strip(), v.strip(), False))
        elif "==" in part:
            k, _, v = part.partition("==")
            out.append((k.strip(), v.strip(), True))
        elif "=" in part:
            k, _, v = part.partition("=")
            out.append((k.strip(), v.strip(), True))
        else:
            raise errors.new_bad_request(f"invalid field selector {part!r}")
    return out


def _field_get(obj: Obj, path: str) -> str:
    cur: Any = obj
    for seg in path.split("."):
        if not isinstance(cur, dict) or seg not in cur:
            return ""
        cur = cur[seg]
    return "" if cur is None else str(cur)


def match_field_selector(obj: Obj, reqs: List[Tuple[str, str, bool]]) -> bool:
    for path, want, positive in reqs:
        got = _field_get(obj, path)
        if (got == want) != positive:
            return False
    return True


class Store:
    """registry.Store for one resource."""

    def __init__(self, storage: Storage, scheme: Scheme, info: ResourceInfo,
                 admission: Optional[AdmissionFn] = None,
                 after_create: Optional[Callable[[Obj], None]] = None,
                 after_update: Optional[Callable[[Obj], None]] = None,
                 after_delete: Optional[Callable[[Obj], None]] = None):
        self.storage = storage
        self.scheme = scheme
        self.info = info
        self.admission = admission
        self.after_create = after_create
        self.after_update = after_update
        self.after_delete = after_delete
        # TTL-bounded storage (the events resource, the analog
        # of kube-apiserver's --event-ttl etcd leases): 0 = objects live
        # forever (every other resource); > 0 = objects whose freshness
        # stamp (lastTimestamp for Events, else creationTimestamp) ages
        # past this many seconds are pruned lazily at read time — list()
        # sweeps them, get() 404s them. Deletes flow through the ordinary
        # storage path, so watchers observe DELETED events.
        self.ttl_seconds: float = 0.0
        self._name_seq = 0
        self._seq_mu = threading.Lock()

    def _ttl_expired(self, obj: Obj, now: float) -> bool:
        if not self.ttl_seconds:
            return False
        stamp = meta.parse_rfc3339(obj.get("lastTimestamp")) \
            or meta.parse_rfc3339(
                (obj.get("metadata") or {}).get("creationTimestamp"))
        return stamp is not None and now - stamp > self.ttl_seconds

    def _ttl_delete(self, obj: Obj) -> None:
        try:
            gone = self.storage.delete(
                self.key_for(meta.namespace(obj) or "", meta.name(obj)),
                self.info.resource, meta.name(obj))
        except errors.StatusError:
            return  # a concurrent delete already settled it
        if self.after_delete:
            # a TTL sweep is still a delete: stores that install
            # after_delete hooks (CRD unregister, ClusterIP release) must
            # see it, or setting ttl_seconds on such a store would leak
            self.after_delete(gone)

    # ------------------------------------------------------------------ #
    # keys
    # ------------------------------------------------------------------ #

    def key_root(self) -> str:
        g = self.info.group or "core"
        return f"/registry/{g}/{self.info.resource}/"

    def key_for(self, namespace: str, name: str) -> str:
        if self.info.namespaced:
            if not namespace:
                raise errors.new_bad_request(
                    f"namespace is required for {self.info.resource}")
            return f"{self.key_root()}{namespace}/{name}"
        return f"{self.key_root()}{name}"

    def prefix_for(self, namespace: str) -> str:
        if self.info.namespaced and namespace:
            return f"{self.key_root()}{namespace}/"
        return self.key_root()

    # ------------------------------------------------------------------ #
    # verbs (store.go Create:338 / Get / List / Update:453 / Delete / Watch)
    # ------------------------------------------------------------------ #

    def create(self, namespace: str, obj: Obj) -> Obj:
        obj = meta.deep_copy(obj)
        obj.setdefault("apiVersion", self.info.api_version)
        obj.setdefault("kind", self.info.kind)
        md = meta.ensure_meta(obj)
        if self.info.namespaced:
            md.setdefault("namespace", namespace or "default")
            if namespace and md["namespace"] != namespace:
                raise errors.new_bad_request(
                    "the namespace of the object does not match the request")
        if not md.get("name"):
            gen = md.get("generateName")
            if not gen:
                raise errors.new_invalid(self.info.kind, "",
                                         "metadata.name: Required value")
            with self._seq_mu:
                self._name_seq += 1
                md["name"] = f"{gen}{self._name_seq:05x}"
        md["uid"] = meta.new_uid()
        md["creationTimestamp"] = meta.now_rfc3339()
        md.setdefault("generation", 1)
        md.pop("deletionTimestamp", None)
        self.scheme.default(obj)
        if self.admission:
            mutated = self.admission("CREATE", self.info, obj, None)
            if mutated is not None:
                obj = mutated
        self.scheme.validate(obj)
        out = self.storage.create(self.key_for(md.get("namespace", ""), md["name"]),
                                  obj, self.info.resource)
        if self.after_create:
            self.after_create(out)
        return out

    def get(self, namespace: str, name: str) -> Obj:
        obj = self.storage.get(self.key_for(namespace, name),
                               self.info.resource, name)
        if self.ttl_seconds and self._ttl_expired(obj, time.time()):
            self._ttl_delete(obj)
            raise errors.new_not_found(self.info.resource, name)
        return obj

    def list(self, namespace: str = "", label_selector: str = "",
             field_selector: str = "") -> Obj:
        lsel = mlabels.parse(label_selector) if label_selector else None
        freqs = parse_field_selector(field_selector)

        def pred(o: Obj) -> bool:
            if lsel is not None and not lsel.matches(meta.labels_of(o)):
                return False
            if freqs and not match_field_selector(o, freqs):
                return False
            return True

        items, rv = self.storage.list(self.prefix_for(namespace), pred)
        if self.ttl_seconds:
            # lazy TTL sweep: the list that would have served an expired
            # object deletes it instead (watchers see DELETED); bounded by
            # the listing the caller already paid for
            now = time.time()
            live = []
            for o in items:
                if self._ttl_expired(o, now):
                    self._ttl_delete(o)
                else:
                    live.append(o)
            items = live
        return self.scheme.new_list(self.info, items, rv)

    # resources whose spec is immutable after create: the reference's
    # strategy PrepareForUpdate copies the old spec over the incoming one
    # (csrStrategy pins newCSR.Spec = oldCSR.Spec — a mutable CSR spec
    # would let a requester swap in a forged username/groups AFTER the
    # server stamped the authenticated identity at create time)
    _IMMUTABLE_SPEC_RESOURCES = frozenset({"certificatesigningrequests"})

    def _pin_immutable_spec(self, cur: Obj, new: Obj) -> None:
        """PrepareForUpdate spec pinning for _IMMUTABLE_SPEC_RESOURCES: the
        stored spec silently wins on plain update/patch, exactly like the
        reference strategy (not a 400 — kubectl apply round-trips specs)."""
        if self.info.resource in self._IMMUTABLE_SPEC_RESOURCES \
                and "spec" in cur:
            new["spec"] = meta.deep_copy(cur["spec"])

    def update(self, namespace: str, name: str, obj: Obj,
               subresource: str = "") -> Obj:
        """Full-object PUT. resourceVersion in the body, if set, is the
        optimistic-concurrency precondition (store.go:453-520)."""
        expected_rv = meta.resource_version(obj) or None

        def apply(cur: Obj) -> Obj:
            if not cur:
                raise errors.new_not_found(self.info.resource, name)
            new = meta.deep_copy(obj)
            new["apiVersion"] = cur.get("apiVersion", self.info.api_version)
            new["kind"] = cur.get("kind", self.info.kind)
            # immutable metadata carries over (ObjectMeta update strategy)
            nm = meta.ensure_meta(new)
            cm = cur.get("metadata", {})
            for f in ("uid", "creationTimestamp", "namespace", "name",
                      "deletionTimestamp", "generation"):
                if f in cm:
                    nm[f] = cm[f]
                else:
                    nm.pop(f, None)
            if subresource == "status":
                # status updates touch ONLY .status (registry status strategy)
                merged = meta.deep_copy(cur)
                merged["status"] = new.get("status", {})
                merged["metadata"] = cm
                new = merged
            elif subresource == "approval":
                # CSR approval touches ONLY status.conditions (registry/
                # certificates approval strategy): an approval built from a
                # stale read must not wipe an issued status.certificate,
                # approval callers must not inject one, and settled
                # Approved/Denied verdicts are immutable — a body that
                # drops or flips them is a 400, not a silent un-approval
                new_conds = (new.get("status", {}) or {}).get(
                    "conditions", []) or []
                new_by_type = {c.get("type"): c for c in new_conds}
                if "Approved" in new_by_type and "Denied" in new_by_type:
                    raise errors.new_invalid(
                        self.info.resource, name,
                        "status.conditions: Invalid value: Approved and "
                        "Denied conditions are mutually exclusive")
                for c in (cur.get("status", {}) or {}).get(
                        "conditions", []) or []:
                    ctype = c.get("type")
                    if ctype not in ("Approved", "Denied"):
                        continue
                    nc = new_by_type.get(ctype)
                    if nc is None or nc.get("status", "True") != \
                            c.get("status", "True"):
                        # settled verdicts are immutable: neither removed
                        # nor status-flipped (certificates validation)
                        raise errors.new_invalid(
                            self.info.resource, name,
                            f"status.conditions: Invalid value: the "
                            f"{ctype} condition cannot be removed or "
                            f"changed")
                merged = meta.deep_copy(cur)
                merged.setdefault("status", {})["conditions"] = new_conds
                merged["metadata"] = cm
                new = merged
            elif subresource == "":
                # spec updates keep status (registry strategy PrepareForUpdate)
                if "status" in cur and "status" not in new:
                    new["status"] = cur["status"]
                self._pin_immutable_spec(cur, new)
                if _spec_changed(cur, new):
                    nm["generation"] = int(cm.get("generation", 1)) + 1
            self.scheme.default(new)
            if self.admission:
                mutated = self.admission("UPDATE", self.info, new, cur)
                if mutated is not None:
                    new = mutated
            self.scheme.validate(new)
            return new

        out = self.storage.guaranteed_update(
            self.key_for(namespace, name), apply, self.info.resource, name,
            expected_rv=expected_rv)
        if self.after_update:
            self.after_update(out)
        return self._finish_delete_if_ready(namespace, name, out)

    def patch(self, namespace: str, name: str, patch: Obj,
              subresource: str = "", patch_type: str = "merge") -> Obj:
        """PATCH (apiserver/pkg/endpoints/handlers/patch.go) with an RFC 7386
        JSON merge body ("merge"); of the reference's other two content
        types, strategic merge and the RFC 6902 op list, neither is ported
        yet."""

        if patch_type in ("strategic", "json"):
            # apimachinery/pkg/util/strategicpatch (the JAX package's
            # machinery/strategicpatch.py) is not ported yet
            raise errors.StatusError(
                415, "UnsupportedMediaType",
                f"{patch_type} patch is not ported yet (ROADMAP A11b, "
                f"second half); use a JSON merge patch")
        if not isinstance(patch, dict):
            raise errors.new_bad_request(
                f"a {patch_type} patch body must be a JSON object")

        def apply(cur: Obj) -> Obj:
            if not cur:
                raise errors.new_not_found(self.info.resource, name)
            new = _merge_patch(cur, patch)
            nm = meta.ensure_meta(new)
            cm = cur.get("metadata", {})
            for f in ("uid", "creationTimestamp", "namespace", "name",
                      "resourceVersion", "deletionTimestamp"):
                if f in cm:
                    nm[f] = cm[f]
            if subresource == "":
                self._pin_immutable_spec(cur, new)
            if subresource == "" and _spec_changed(cur, new):
                nm["generation"] = int(cm.get("generation", 1)) + 1
            self.scheme.default(new)
            if self.admission:
                mutated = self.admission("UPDATE", self.info, new, cur)
                if mutated is not None:
                    new = mutated
            self.scheme.validate(new)
            return new

        out = self.storage.guaranteed_update(self.key_for(namespace, name),
                                             apply, self.info.resource, name)
        if self.after_update:
            self.after_update(out)
        return self._finish_delete_if_ready(namespace, name, out)

    def delete(self, namespace: str, name: str,
               expected_rv: Optional[str] = None) -> Obj:
        """Two-phase delete: objects holding finalizers get deletionTimestamp
        and live on until the last finalizer is removed (store.go:605-760
        graceful/finalizer flow)."""
        cur = self.get(namespace, name)
        if self.admission:
            self.admission("DELETE", self.info, None, cur)
        if meta.finalizers(cur) and not meta.is_being_deleted(cur):
            def mark(o: Obj) -> Obj:
                meta.ensure_meta(o)["deletionTimestamp"] = meta.now_rfc3339()
                return o
            return self.storage.guaranteed_update(
                self.key_for(namespace, name), mark, self.info.resource, name)
        out = self.storage.delete(self.key_for(namespace, name),
                                  self.info.resource, name, expected_rv)
        if self.after_delete:
            self.after_delete(out)
        return out

    def _finish_delete_if_ready(self, namespace: str, name: str, obj: Obj) -> Obj:
        """An update that empties the finalizer list of a deleting object
        completes the delete (store.go deleteForEmptyFinalizers)."""
        if meta.is_being_deleted(obj) and not meta.finalizers(obj):
            try:
                out = self.storage.delete(self.key_for(namespace, name),
                                          self.info.resource, name)
                if self.after_delete:
                    self.after_delete(out)
            except errors.StatusError:
                pass
        return obj

    def delete_collection(self, namespace: str, label_selector: str = "",
                          field_selector: str = "") -> List[Obj]:
        lst = self.list(namespace, label_selector, field_selector)
        out = []
        for item in lst["items"]:
            try:
                out.append(self.delete(meta.namespace(item), meta.name(item)))
            except errors.StatusError:
                pass
        return out

    def watch(self, namespace: str = "", label_selector: str = "",
              field_selector: str = "", resource_version: str = "",
              allow_bookmarks: bool = False) -> mwatch.Watch:
        lsel = mlabels.parse(label_selector) if label_selector else None
        freqs = parse_field_selector(field_selector)

        def pred(o: Obj) -> bool:
            if lsel is not None and not lsel.matches(meta.labels_of(o)):
                return False
            if freqs and not match_field_selector(o, freqs):
                return False
            return True

        return self.storage.watch(self.prefix_for(namespace),
                                  since_rv=resource_version, predicate=pred,
                                  bookmarks=allow_bookmarks)


def _spec_changed(old: Obj, new: Obj) -> bool:
    return old.get("spec") != new.get("spec")


def _merge_patch(target: Obj, patch: Obj) -> Obj:
    """RFC 7386 JSON merge patch."""
    if not isinstance(patch, dict):
        return meta.deep_copy(patch)
    out = meta.deep_copy(target) if isinstance(target, dict) else {}
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge_patch(out[k], v)
        else:
            out[k] = meta.deep_copy(v)
    return out
