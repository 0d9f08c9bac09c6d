"""Strategic merge patch + JSON patch — the kubectl-apply merge machinery.

Analog of `staging/src/k8s.io/apimachinery/pkg/util/strategicpatch/patch.go`
(StrategicMergePatch) and `evanphx/json-patch` (RFC 6902, which the
reference serves for `application/json-patch+json`).

Strategic merge differs from RFC 7386 merge patch in ONE structural way:
list fields tagged `patchStrategy:"merge"` in the reference's types merge
ELEMENT-WISE by their `patchMergeKey` instead of being replaced wholesale.
That is what makes `kubectl apply` of a pod template with a modified
container list update the one container instead of dropping its siblings.

The reference carries the strategy in Go struct tags
(`staging/src/k8s.io/api/core/v1/types.go`, e.g. Containers:
patchStrategy:"merge" patchMergeKey:"name"); here the same facts live in
`MERGE_KEYS` — a longest-suffix path table, which handles the PodSpec
being embedded at different depths (pod spec.containers vs deployment
spec.template.spec.containers) without per-kind duplication.

Directives (patch.go directive constants):
  * `$patch: delete`  in a merge-list element: delete the element whose
    merge key matches (or, in a map value: delete semantics for maps).
  * `$patch: replace` as a list element or map entry: replace wholesale
    instead of merging.
  * `$deleteFromPrimitiveList/<field>: [v, ...]`: remove values from a
    primitive merge list (e.g. finalizers).
  * `$setElementOrder/<field>: [...]`: result list order (merge-key values
    for object lists, values for primitive lists).
  * `$retainKeys: [...]` in a map: drop keys not listed (the
    `patchStrategy:"retainKeys"` half of volumes' merge,retainKeys).

(A copy of the JAX package's machinery/strategicpatch.py.)
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..machinery import errors

Obj = Dict[str, Any]

PATCH_DIRECTIVE = "$patch"
DELETE_FROM_PRIMITIVE = "$deleteFromPrimitiveList/"
SET_ELEMENT_ORDER = "$setElementOrder/"
RETAIN_KEYS = "$retainKeys"

# (path-suffix, merge key). Longest matching suffix wins; paths are tuples
# of field names with list indices elided. Mined from the reference's
# patchMergeKey/patchStrategy struct tags (api/core/v1 + apps/v1 +
# apimachinery/meta/v1 types.go).
MERGE_KEYS: List[Tuple[Tuple[str, ...], str]] = [
    (("containers", "ports"), "containerPort"),
    (("initContainers", "ports"), "containerPort"),
    (("ephemeralContainers", "ports"), "containerPort"),
    (("ports",), "port"),                 # Service spec.ports
    (("containers",), "name"),
    (("initContainers",), "name"),
    (("ephemeralContainers",), "name"),
    (("env",), "name"),
    (("volumeMounts",), "mountPath"),
    (("volumeDevices",), "devicePath"),
    (("volumes",), "name"),
    (("imagePullSecrets",), "name"),
    (("hostAliases",), "ip"),
    (("topologySpreadConstraints",), "topologyKey"),
    (("podIPs",), "ip"),
    (("secrets",), "name"),               # ServiceAccount.secrets
    (("ownerReferences",), "uid"),
    (("conditions",), "type"),
    (("addresses",), "type"),             # NodeStatus.addresses
]

# patchStrategy:"merge" on []string fields: values union / delete by value
PRIMITIVE_MERGE_FIELDS = {"finalizers", "podCIDRs"}


def merge_key_for(path: Tuple[str, ...]) -> Optional[str]:
    """Longest-suffix lookup into MERGE_KEYS; None → atomic list."""
    best: Optional[str] = None
    best_len = 0
    for suffix, key in MERGE_KEYS:
        if len(suffix) <= len(path) and path[-len(suffix):] == suffix \
                and len(suffix) > best_len:
            best, best_len = key, len(suffix)
    return best


def _is_primitive_merge(path: Tuple[str, ...]) -> bool:
    return bool(path) and path[-1] in PRIMITIVE_MERGE_FIELDS


def strategic_merge(cur: Any, patch: Any,
                    path: Tuple[str, ...] = ()) -> Any:
    """Apply a strategic merge patch. Returns the merged value (inputs are
    not mutated)."""
    if isinstance(patch, dict):
        if not isinstance(cur, dict):
            cur = {}
        return _merge_map(cur, patch, path)
    # non-map patch values replace (lists at this level were handled by the
    # parent map merge; a bare list patch replaces, as in patch.go)
    return copy.deepcopy(patch)


def _merge_map(cur: Obj, patch: Obj, path: Tuple[str, ...]) -> Obj:
    directive = patch.get(PATCH_DIRECTIVE)
    if directive == "replace":
        out = {k: copy.deepcopy(v) for k, v in patch.items()
               if k != PATCH_DIRECTIVE}
        return out
    if directive == "delete":
        return {}
    if directive is not None:
        raise errors.new_bad_request(
            f"invalid $patch directive {directive!r}")

    out = copy.deepcopy(cur)

    # $setElementOrder/<field> companions are consumed by the list merge
    orders: Dict[str, List[Any]] = {}
    deletions: Dict[str, List[Any]] = {}
    retain: Optional[List[str]] = None
    for k, v in patch.items():
        if k.startswith(SET_ELEMENT_ORDER):
            orders[k[len(SET_ELEMENT_ORDER):]] = v
        elif k.startswith(DELETE_FROM_PRIMITIVE):
            deletions[k[len(DELETE_FROM_PRIMITIVE):]] = v
        elif k == RETAIN_KEYS:
            retain = v

    for k, v in patch.items():
        if (k.startswith(SET_ELEMENT_ORDER)
                or k.startswith(DELETE_FROM_PRIMITIVE)
                or k == RETAIN_KEYS):
            continue
        child_path = path + (k,)
        if v is None:
            out.pop(k, None)
            continue
        if isinstance(v, dict):
            out[k] = _merge_map(out.get(k) if isinstance(out.get(k), dict)
                                else {}, v, child_path)
            continue
        if isinstance(v, list):
            out[k] = _merge_list(out.get(k), v, child_path,
                                 orders.get(k))
            continue
        out[k] = copy.deepcopy(v)

    # primitive-list deletions may arrive WITHOUT a companion field entry
    for field, values in deletions.items():
        have = out.get(field)
        if isinstance(have, list):
            out[field] = [x for x in have if x not in values]

    # order-only patches (kubectl apply reorders without changing content)
    for field, order in orders.items():
        if field not in patch and isinstance(out.get(field), list):
            out[field] = _reorder(out[field], order,
                                  merge_key_for(path + (field,)))

    if retain is not None:
        out = {k: v for k, v in out.items() if k in retain}
    return out


def _merge_list(cur: Any, patch: List[Any], path: Tuple[str, ...],
                order: Optional[List[Any]]) -> List[Any]:
    if not isinstance(cur, list):
        cur = []
    # `$patch: replace` as a list element: replace the whole list
    if any(isinstance(e, dict) and e.get(PATCH_DIRECTIVE) == "replace"
           for e in patch):
        return [copy.deepcopy(e) for e in patch
                if not (isinstance(e, dict)
                        and e.get(PATCH_DIRECTIVE) == "replace")]
    key = merge_key_for(path)
    if key is None:
        if _is_primitive_merge(path):
            merged = list(cur)
            for v in patch:
                if v not in merged:
                    merged.append(v)
            return merged
        return copy.deepcopy(patch)          # atomic list: replace

    merged: List[Any] = [copy.deepcopy(e) for e in cur]
    index = {e.get(key): i for i, e in enumerate(merged)
             if isinstance(e, dict)}
    for e in patch:
        if not isinstance(e, dict):
            raise errors.new_bad_request(
                f"strategic merge: element of {'.'.join(path)} "
                "is not an object")
        kv = e.get(key)
        if e.get(PATCH_DIRECTIVE) == "delete":
            merged = [m for m in merged
                      if not (isinstance(m, dict) and m.get(key) == kv)]
            index = {m.get(key): i for i, m in enumerate(merged)
                     if isinstance(m, dict)}
            continue
        if kv is None:
            raise errors.new_bad_request(
                f"strategic merge: element of {'.'.join(path)} "
                f"lacks merge key {key!r}")
        if kv in index:
            merged[index[kv]] = _merge_map(merged[index[kv]], e, path)
        else:
            index[kv] = len(merged)
            merged.append(_merge_map({}, e, path))
    if order is not None:
        merged = _reorder(merged, order, key)
    return merged


def _reorder(items: List[Any], order: List[Any],
             key: Optional[str]) -> List[Any]:
    """$setElementOrder: listed elements first in the given order, then the
    unlisted ones in their current relative order (patch.go order merge).
    Order entries come as objects bearing only the merge key (what kubectl
    emits) or as bare merge-key values; both normalize to the key value."""
    def sort_value(e):
        return e.get(key) if (key and isinstance(e, dict)) else e

    pos: Dict[Any, int] = {}
    for i, v in enumerate(order):
        v = sort_value(v)
        if isinstance(v, (dict, list)):
            raise errors.new_bad_request(
                "invalid $setElementOrder entry (expected merge-key value "
                "or an object bearing the merge key)")
        pos.setdefault(v, i)
    listed = [e for e in items if sort_value(e) in pos]
    unlisted = [e for e in items if sort_value(e) not in pos]
    listed.sort(key=lambda e: pos[sort_value(e)])
    return listed + unlisted


# --------------------------------------------------------------------- #
# kubectl-apply three-way patch body
# --------------------------------------------------------------------- #

LAST_APPLIED_ANNOTATION = "kubectl.kubernetes.io/last-applied-configuration"


def apply_patch_body(last: Obj, desired: Obj,
                     path: Tuple[str, ...] = (),
                     merge_lists: bool = True) -> Obj:
    """The patch `kubectl apply` sends: the full desired state plus the
    DELETIONS implied by last-applied-configuration — `null` for map keys
    and `$patch: delete` entries for merge-list elements that were in the
    last applied manifest but are gone from the new one (apply.go
    CreateThreeWayMergePatch's deletion half; the modification half is
    subsumed by sending the full desired state). With merge_lists=False
    the body is a plain 3-way JSON merge patch (lists replace wholesale) —
    the dialect kubectl uses for custom resources."""
    out: Obj = {}
    last = last if isinstance(last, dict) else {}
    for k in last:
        if k not in desired:
            out[k] = None  # deleted since last apply
    for k, dv in desired.items():
        child = path + (k,)
        lv = last.get(k)
        if isinstance(dv, dict):
            out[k] = apply_patch_body(lv if isinstance(lv, dict) else {},
                                      dv, child, merge_lists)
            continue
        if isinstance(dv, list) and merge_lists:
            mk = merge_key_for(child)
            if mk and all(isinstance(e, dict) for e in dv):
                last_by = {e.get(mk): e for e in (lv or [])
                           if isinstance(e, dict)}
                lst: List[Any] = []
                for e in dv:
                    le = last_by.get(e.get(mk))
                    lst.append(apply_patch_body(le, e, child, merge_lists)
                               if isinstance(le, dict)
                               else copy.deepcopy(e))
                gone = set(last_by) - {e.get(mk) for e in dv}
                lst.extend({mk: kv, PATCH_DIRECTIVE: "delete"}
                           for kv in sorted(gone, key=str))
                out[k] = lst
                continue
            if _is_primitive_merge(child):
                out[k] = copy.deepcopy(dv)
                removed = [x for x in (lv or []) if x not in dv]
                if removed:
                    out[DELETE_FROM_PRIMITIVE + k] = removed
                continue
        out[k] = copy.deepcopy(dv)
    return out


# --------------------------------------------------------------------- #
# RFC 6902 JSON patch (application/json-patch+json)
# --------------------------------------------------------------------- #


def _ptr_parts(pointer: str) -> List[str]:
    if pointer == "":
        return []
    if not pointer.startswith("/"):
        raise errors.new_bad_request(f"invalid JSON pointer {pointer!r}")
    return [p.replace("~1", "/").replace("~0", "~")
            for p in pointer[1:].split("/")]


def _list_index(tok: str, n: int, allow_end: bool = False) -> int:
    """A list token must be a valid in-range index (RFC 6902 → 400)."""
    if allow_end and tok == "-":
        return n
    try:
        idx = int(tok)
    except (TypeError, ValueError):
        raise errors.new_bad_request(
            f"JSON patch: invalid array index {tok!r}")
    if not 0 <= idx < n + (1 if allow_end else 0):
        raise errors.new_bad_request(
            f"JSON patch: array index {idx} out of range")
    return idx


def _ptr_walk(doc: Any, parts: Sequence[str]) -> Tuple[Any, Any]:
    """Walk to the parent of the target; returns (parent, last_token)."""
    cur = doc
    for p in parts[:-1]:
        if isinstance(cur, list):
            cur = cur[_list_index(p, len(cur))]
        elif isinstance(cur, dict):
            if p not in cur:
                raise errors.new_bad_request(
                    f"JSON pointer path /{'/'.join(parts)} not found")
            cur = cur[p]
        else:
            raise errors.new_bad_request(
                f"JSON pointer path /{'/'.join(parts)} not found")
    return cur, parts[-1] if parts else None


def json_patch(doc: Obj, ops: List[Obj]) -> Obj:
    """Apply an RFC 6902 op list. Returns the new document."""
    out = copy.deepcopy(doc)
    if not isinstance(ops, list):
        raise errors.new_bad_request("JSON patch body must be an array")
    for op in ops:
        kind = op.get("op")
        parts = _ptr_parts(op.get("path", ""))
        if kind in ("add", "replace", "test"):
            # RFC 6902 §4: add/replace/test REQUIRE the "value" member —
            # defaulting an absent value to null would silently null out
            # the target (evanphx/json-patch, the reference's library,
            # rejects it too)
            if "value" not in op:
                raise errors.new_bad_request(
                    f'JSON patch {kind}: missing "value" member')
            value = copy.deepcopy(op["value"])
        if kind == "move" or kind == "copy":
            f_parts = _ptr_parts(op.get("from", ""))
            parent, tok = _ptr_walk(out, f_parts)
            if isinstance(parent, list):
                value = parent[_list_index(tok, len(parent))]
            elif isinstance(parent, dict) and tok in parent:
                value = parent[tok]
            else:
                raise errors.new_bad_request(
                    f"JSON patch {kind}: {op.get('from')} not found")
            value = copy.deepcopy(value)
            if kind == "move":
                if isinstance(parent, list):
                    parent.pop(_list_index(tok, len(parent)))
                else:
                    parent.pop(tok)
        if not parts:
            if kind in ("add", "replace", "move", "copy"):
                if not isinstance(value, dict):
                    raise errors.new_bad_request(
                        "whole-document value must be an object")
                out = value
            elif kind == "test":
                if out != value:
                    raise errors.new_bad_request("JSON patch test failed")
            elif kind == "remove":
                raise errors.new_bad_request(
                    "JSON patch remove: cannot remove the root document")
            else:
                raise errors.new_bad_request(
                    f"invalid JSON patch op {kind!r}")
            continue
        parent, tok = _ptr_walk(out, parts)
        if kind in ("add", "move", "copy"):
            if isinstance(parent, list):
                parent.insert(_list_index(tok, len(parent),
                                          allow_end=True), value)
            elif isinstance(parent, dict):
                parent[tok] = value
            else:
                raise errors.new_bad_request(
                    f"JSON patch {kind}: {op.get('path')} not found")
        elif kind == "replace":
            if isinstance(parent, list):
                parent[_list_index(tok, len(parent))] = value
            elif isinstance(parent, dict) and tok in parent:
                parent[tok] = value
            else:
                raise errors.new_bad_request(
                    f"JSON patch replace: {op.get('path')} not found")
        elif kind == "remove":
            if isinstance(parent, list):
                parent.pop(_list_index(tok, len(parent)))
            elif isinstance(parent, dict) and tok in parent:
                parent.pop(tok)
            else:
                raise errors.new_bad_request(
                    f"JSON patch remove: {op.get('path')} not found")
        elif kind == "test":
            # RFC 6902: test against a NONEXISTENT target fails — a None
            # expected value must not pass via dict.get defaulting
            if isinstance(parent, list):
                got = parent[_list_index(tok, len(parent))]
            elif isinstance(parent, dict) and tok in parent:
                got = parent[tok]
            else:
                raise errors.new_bad_request("JSON patch test failed")
            if got != value:
                raise errors.new_bad_request("JSON patch test failed")
        else:
            raise errors.new_bad_request(f"invalid JSON patch op {kind!r}")
    return out
