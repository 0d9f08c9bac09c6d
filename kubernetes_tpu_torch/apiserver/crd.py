"""CustomResourceDefinitions: dynamic registration, validation, conversion.

Analog of `staging/src/k8s.io/apiextensions-apiserver`: a CRD object
registers a new served resource at /apis/{group}/{version}/{plural} with
structural-schema validation (the openAPIV3Schema subset that carries:
type, properties, required, enum, minimum/maximum, items).

Multi-version CRDs convert through `spec.conversion`
(pkg/apiserver/conversion/converter.go): objects persist at the single
`storage: true` version; serving another `served` version converts on the
way out (and request bodies on the way in). Strategy `None` rewrites
apiVersion only; strategy `Webhook` POSTs a ConversionReview
{request: {uid, desiredAPIVersion, objects}} to the configured client and
uses response.convertedObjects — the same wire contract as
conversion/webhook_converter.go, carried by the round-3 webhook transport
(apiserver/webhooks.py `_call_webhook`, so tests can register in-process
converters). (A copy of the JAX package's
apiserver/crd.py.)"""

from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..machinery import errors, meta
from ..machinery.scheme import ResourceInfo

Obj = Dict[str, Any]


@dataclass
class ConversionEntry:
    """One multi-version CRD's conversion wiring (converter.go's
    crConverter, flattened)."""

    group: str
    plural: str
    served: List[str]        # every served version
    storage: str             # the persisted version
    strategy: str            # "None" | "Webhook"
    webhook_url: str = ""
    timeout: float = 10.0

    def convert(self, objs: List[Obj], desired_version: str) -> List[Obj]:
        if not objs:
            return []
        apiv = f"{self.group}/{desired_version}"
        if self.strategy != "Webhook":
            out = []
            for o in objs:
                c = meta.deep_copy(o)
                c["apiVersion"] = apiv
                out.append(c)
            return out
        from ..apiserver.webhooks import _call_webhook

        review = {
            "apiVersion": "apiextensions.k8s.io/v1",
            "kind": "ConversionReview",
            "request": {"uid": uuid.uuid4().hex,
                        "desiredAPIVersion": apiv,
                        "objects": objs},
        }
        try:
            out = _call_webhook(self.webhook_url, review, self.timeout)
        except Exception as e:  # noqa: BLE001 — converter down = 500
            raise errors.StatusError(
                500, "InternalError",
                f"conversion webhook for {self.group}/{self.plural} "
                f"failed: {e}")
        resp = (out or {}).get("response", {}) or {}
        if (resp.get("result", {}) or {}).get("status") != "Success":
            msg = (resp.get("result", {}) or {}).get(
                "message", "conversion webhook refused the objects")
            raise errors.StatusError(500, "InternalError", msg)
        conv = resp.get("convertedObjects") or []
        if len(conv) != len(objs):
            raise errors.StatusError(
                500, "InternalError",
                "conversion webhook returned the wrong object count")
        for src, c in zip(objs, conv):
            c["apiVersion"] = apiv
            # conversion must preserve object identity (the reference's
            # webhook converter validates this — a converter that mutates
            # name/namespace/uid/resourceVersion corrupts identity on
            # GET/LIST/WATCH and on bodies converted to storage version)
            src_meta = src.get("metadata", {}) or {}
            c_meta = c.setdefault("metadata", {})
            for field in ("name", "namespace", "uid", "resourceVersion"):
                if field not in src_meta:
                    continue
                if field not in c_meta:
                    # a converter that DROPS an identity field is sloppy,
                    # not conflicting: restore it (a served object without
                    # resourceVersion would defeat optimistic concurrency
                    # on the client's next full-object PUT)
                    c_meta[field] = src_meta[field]
                elif c_meta[field] != src_meta[field]:
                    raise errors.StatusError(
                        500, "InternalError",
                        f"conversion webhook for {self.group}/{self.plural}"
                        f" mutated metadata.{field} of "
                        f"{src_meta.get('name', '?')}")
        return conv


def conversion_entry_from_crd(crd: Obj) -> Optional[ConversionEntry]:
    """Multi-version conversion wiring, or None for single-version CRDs."""
    spec = crd.get("spec", {})
    versions = spec.get("versions") or []
    served = [v.get("name", "") for v in versions if v.get("served", True)]
    if len(served) < 2:
        return None
    storage = next((v.get("name", "") for v in versions
                    if v.get("storage") and v.get("served", True)), served[0])
    conv = spec.get("conversion") or {}
    strategy = conv.get("strategy", "None")
    url = ""
    if strategy == "Webhook":
        url = ((conv.get("webhook") or {}).get("clientConfig") or
               conv.get("webhookClientConfig") or {}).get("url", "")
    return ConversionEntry(
        group=spec.get("group", ""),
        plural=(spec.get("names") or {}).get("plural", ""),
        served=served, storage=storage, strategy=strategy,
        webhook_url=url,
        timeout=float(conv.get("timeoutSeconds", 10)))


def validate_against_schema(value: Any, schema: Dict[str, Any],
                            path: str = "") -> List[str]:
    """Structural-schema validation (apiextensions pkg/apiserver/validation)."""
    errs: List[str] = []
    if not isinstance(schema, dict):
        return errs
    typ = schema.get("type")
    if typ:
        ok = {"object": dict, "array": list, "string": str,
              "integer": int, "number": (int, float),
              "boolean": bool}.get(typ)
        if ok is not None and value is not None:
            if typ == "integer" and isinstance(value, bool):
                errs.append(f"{path or '.'}: expected integer")
            elif not isinstance(value, ok):
                errs.append(f"{path or '.'}: expected {typ}")
                return errs
    if "enum" in schema and value not in schema["enum"]:
        errs.append(f"{path or '.'}: must be one of {schema['enum']}")
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        if "minimum" in schema and value < schema["minimum"]:
            errs.append(f"{path or '.'}: must be >= {schema['minimum']}")
        if "maximum" in schema and value > schema["maximum"]:
            errs.append(f"{path or '.'}: must be <= {schema['maximum']}")
    if isinstance(value, dict):
        for req in schema.get("required", []) or []:
            if req not in value:
                errs.append(f"{path}.{req}: Required value")
        props = schema.get("properties") or {}
        for k, sub in props.items():
            if k in value:
                errs.extend(validate_against_schema(value[k], sub,
                                                    f"{path}.{k}"))
    if isinstance(value, list):
        items = schema.get("items")
        if items:
            for i, item in enumerate(value):
                errs.extend(validate_against_schema(item, items,
                                                    f"{path}[{i}]"))
    return errs


def resource_info_from_crd(crd: Obj) -> Optional[ResourceInfo]:
    """Build the served-resource registration from a CRD object."""
    spec = crd.get("spec", {})
    group = spec.get("group", "")
    names = spec.get("names", {})
    plural = names.get("plural", "")
    kind = names.get("kind", "")
    versions = spec.get("versions") or []
    # multi-version: objects persist (and validate) at the storage version
    # when it is served; other served versions route through the
    # ConversionEntry. A served:false storage version (legal mid-migration)
    # must NOT be registered as the serving version — fall back to the
    # first served one (deviation: persistence then happens there too).
    served = next((v for v in versions
                   if v.get("storage") and v.get("served", True)), None) \
        or next((v for v in versions if v.get("served", True)), None)
    if not (group and plural and kind and served):
        return None
    schema = ((served.get("schema") or {}).get("openAPIV3Schema")
              or (spec.get("validation") or {}).get("openAPIV3Schema"))

    def validator(obj: Obj) -> List[str]:
        if not schema:
            return []
        # metadata is validated by the generic registry, not the schema
        body = {k: v for k, v in obj.items()
                if k not in ("apiVersion", "kind", "metadata")}
        return validate_against_schema(body, schema)

    return ResourceInfo(
        group=group,
        version=served.get("name", "v1"),
        kind=kind,
        resource=plural,
        namespaced=spec.get("scope", "Namespaced") == "Namespaced",
        list_kind=names.get("listKind", kind + "List"),
        short_names=tuple(names.get("shortNames") or ()),
        subresources=tuple(
            s for s in ("status",)
            if (served.get("subresources") or spec.get("subresources") or {})
            .get(s) is not None),
        validator=validator,
        custom=True,
    )


def install_crd_hook(api) -> None:
    """Wire the CRD store so creates/updates (re-)register the resource
    immediately, deletes unserve it, and existing CRDs re-register on server
    start (the apiextensions controller loop collapsed to its effect)."""
    store = api.store("apiextensions.k8s.io", "customresourcedefinitions")

    def register(crd: Obj) -> None:
        info = resource_info_from_crd(crd)
        if info is not None:
            api.register_resource(info)
            entry = conversion_entry_from_crd(crd)
            if entry is not None:
                api.crd_conversions[(info.group, info.resource)] = entry
            else:
                api.crd_conversions.pop((info.group, info.resource), None)
            # mark Established, as the apiextensions status controller does
            def establish(o: Obj) -> Obj:
                conds = o.setdefault("status", {}).setdefault("conditions", [])
                if not any(c.get("type") == "Established" for c in conds):
                    conds.append({"type": "Established", "status": "True",
                                  "reason": "InitialNamesAccepted"})
                return o
            try:
                store.storage.guaranteed_update(
                    store.key_for("", meta.name(crd)), establish,
                    "customresourcedefinitions", meta.name(crd))
            except Exception:  # noqa: BLE001
                pass

    def unregister(crd: Obj) -> None:
        info = resource_info_from_crd(crd)
        if info is not None:
            api.unregister_resource(info.group, info.resource)
            api.crd_conversions.pop((info.group, info.resource), None)

    def reregister(crd: Obj) -> None:
        # update path: a changed schema/conversion replaces both immediately
        register(crd)

    store.after_create = register
    store.after_update = reregister
    store.after_delete = unregister
    # replay CRDs already persisted (server restart)
    try:
        items, _ = store.storage.list(store.key_root())
        for crd in items:
            register(crd)
    except Exception:  # noqa: BLE001
        pass
