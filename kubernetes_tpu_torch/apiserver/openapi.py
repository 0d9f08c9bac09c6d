"""Served OpenAPI v2 — the `/openapi/v2` discovery document.

The reference serves the full swagger document built by kube-openapi from
generated per-type metadata (`api/openapi-spec/swagger.json`, wired in
`staging/src/k8s.io/apiserver`'s openapi handler); `kubectl explain`
resolves field paths against it. Here the same document is assembled at
request time from what the server actually serves:

  * every registered `ResourceInfo` contributes its REST paths and a
    definition entry tagged `x-kubernetes-group-version-kind`;
  * kinds with curated doc trees (cli/explain.py `_TREE`) get full
    property schemas with descriptions — the SAME data `kubectl explain`
    renders, so the served spec and explain output cannot diverge;
  * custom resources contribute their `openAPIV3Schema`.

A vanilla HTTP client can GET /openapi/v2 and discover every schema; the
document is rebuilt per request (registration changes — CRD installs —
show up immediately, the analog of the reference's spec aggregator
re-merging on CRD change).

(A copy of the JAX package's apiserver/openapi.py.)
"""

from __future__ import annotations

from typing import Any, Dict, Optional

Obj = Dict[str, Any]

_PRIMITIVE_TYPES = {
    "string": {"type": "string"},
    "integer": {"type": "integer", "format": "int32"},
    "boolean": {"type": "boolean"},
    "number": {"type": "number"},
    "Quantity": {"type": "string",
                 "description": "Resource quantity (resource.Quantity)"},
    "map[string]string": {"type": "object",
                          "additionalProperties": {"type": "string"}},
    "map[string]Quantity": {"type": "object",
                            "additionalProperties": {"type": "string"}},
}


def _doc_node_to_schema(node: Obj) -> Obj:
    """cli/explain.py doc node → swagger schema (with descriptions)."""
    typ = node.get("type", "Object")
    doc = node.get("doc", "")
    if typ.startswith("[]"):
        inner = dict(node, type=typ[2:])
        return {"type": "array", "description": doc,
                "items": _doc_node_to_schema(dict(inner, doc=""))}
    if typ in _PRIMITIVE_TYPES:
        out = dict(_PRIMITIVE_TYPES[typ])
        if doc:
            out["description"] = doc
        return out
    out: Obj = {"type": "object"}
    if doc:
        out["description"] = doc
    fields = node.get("fields") or {}
    if fields:
        out["properties"] = {k: _doc_node_to_schema(v)
                             for k, v in fields.items()}
    return out


def definition_name(group: str, version: str, kind: str) -> str:
    """The reference's definition naming: io.k8s.api.<group>.<version>.Kind
    for in-tree groups, reverse-DNS for CRD groups."""
    if not group:
        return f"io.k8s.api.core.{version}.{kind}"
    if "." not in group:
        return f"io.k8s.api.{group}.{version}.{kind}"
    return ".".join(reversed(group.split("."))) + f".{version}.{kind}"


def _crd_schema_for(api, info) -> Optional[Obj]:
    """A custom resource's openAPIV3Schema, if its CRD carries one."""
    if not getattr(info, "custom", False):
        return None
    try:
        store = api.store("apiextensions.k8s.io",
                          "customresourcedefinitions")
        crd = store.storage.get(
            store.key_for("", f"{info.resource}.{info.group}"))
    except Exception:  # noqa: BLE001 — no CRD store / object: generic def
        return None
    if not isinstance(crd, dict) or not crd:
        return None
    spec = crd.get("spec", {})
    versions = spec.get("versions") or []
    v = next((x for x in versions if x.get("name") == info.version), None) \
        or (versions[0] if versions else None)
    return ((v or {}).get("schema") or {}).get("openAPIV3Schema") or \
        (spec.get("validation") or {}).get("openAPIV3Schema")


def _paths_for(info, ref: str) -> Dict[str, Obj]:
    """Collection + item paths with the verb surface the registry serves."""
    base = f"/api/{info.version}" if not info.group \
        else f"/apis/{info.group}/{info.version}"
    if info.namespaced:
        coll = f"{base}/namespaces/{{namespace}}/{info.resource}"
    else:
        coll = f"{base}/{info.resource}"
    item = coll + "/{name}"
    schema_ref = {"$ref": f"#/definitions/{ref}"}
    ok = {"200": {"description": "OK", "schema": schema_ref}}
    gvk = {"group": info.group, "version": info.version, "kind": info.kind}
    out = {
        coll: {
            "get": {"operationId": f"list{info.kind}",
                    "responses": ok,
                    "x-kubernetes-group-version-kind": gvk},
            "post": {"operationId": f"create{info.kind}",
                     "parameters": [{"name": "body", "in": "body",
                                     "schema": schema_ref}],
                     "responses": ok,
                     "x-kubernetes-group-version-kind": gvk},
        },
        item: {
            "get": {"operationId": f"read{info.kind}", "responses": ok},
            "put": {"operationId": f"replace{info.kind}",
                    "parameters": [{"name": "body", "in": "body",
                                    "schema": schema_ref}],
                    "responses": ok},
            "patch": {"operationId": f"patch{info.kind}", "responses": ok},
            "delete": {"operationId": f"delete{info.kind}",
                       "responses": ok},
        },
    }
    if "status" in (info.subresources or ()):
        out[item + "/status"] = {
            "get": {"operationId": f"read{info.kind}Status",
                    "responses": ok},
            "put": {"operationId": f"replace{info.kind}Status",
                    "responses": ok},
            "patch": {"operationId": f"patch{info.kind}Status",
                      "responses": ok},
        }
    return out


def build_openapi(api) -> Obj:
    """Assemble the swagger 2.0 document for everything currently served."""
    from ..cli.explain import _TREE

    definitions: Dict[str, Obj] = {}
    paths: Dict[str, Obj] = {}
    for info in api.scheme.resources():
        ref = definition_name(info.group, info.version, info.kind)
        tree = _TREE.get(info.resource) if not info.group or \
            info.group in ("apps", "batch", "policy") else None
        crd_schema = _crd_schema_for(api, info)
        if tree is not None:
            schema = _doc_node_to_schema(tree)
        elif crd_schema is not None:
            schema = dict(crd_schema)
            schema.setdefault("type", "object")
        else:
            schema = {"type": "object",
                      "description": f"{info.kind} ({info.group or 'core'}/"
                                     f"{info.version})"}
        schema["x-kubernetes-group-version-kind"] = [{
            "group": info.group, "version": info.version,
            "kind": info.kind}]
        definitions[ref] = schema
        paths.update(_paths_for(info, ref))
    return {
        "swagger": "2.0",
        "info": {"title": "Kubernetes", "version": "v1.17.0-tpu.1"},
        "paths": paths,
        "definitions": definitions,
    }


def find_definition(doc: Obj, group: str, version: str,
                    kind: str = "", resource: str = "") -> Optional[Obj]:
    """Resolve a definition by group/version/kind via the
    x-kubernetes-group-version-kind tags (what kubectl explain does with
    the served document). `resource` matches by lowercased plural-ish
    kind when the kind is unknown."""
    for schema in (doc.get("definitions") or {}).values():
        for gvk in schema.get("x-kubernetes-group-version-kind", []):
            if gvk.get("group") != group or gvk.get("version") != version:
                continue
            if kind and gvk.get("kind") == kind:
                return schema
            if resource and gvk.get("kind", "").lower() + "s" == resource:
                return schema
    return None
