"""ObjectMeta/TypeMeta accessors over dict-shaped API objects.

Analog of apimachinery `pkg/apis/meta/v1/types.go` (ObjectMeta) and
`pkg/api/meta` accessor helpers. Objects are plain dicts in their JSON wire
shape: {"apiVersion", "kind", "metadata": {...}, "spec": {...}, "status": ...}.
"""

from __future__ import annotations

import copy
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

Obj = Dict[str, Any]


def ensure_meta(obj: Obj) -> Dict[str, Any]:
    return obj.setdefault("metadata", {})


def name(obj: Obj) -> str:
    return obj.get("metadata", {}).get("name", "")


def namespace(obj: Obj) -> str:
    return obj.get("metadata", {}).get("namespace", "")


def uid(obj: Obj) -> str:
    return obj.get("metadata", {}).get("uid", "")


def resource_version(obj: Obj) -> str:
    return obj.get("metadata", {}).get("resourceVersion", "")


def set_resource_version(obj: Obj, rv: str) -> None:
    ensure_meta(obj)["resourceVersion"] = rv


def generation(obj: Obj) -> int:
    return int(obj.get("metadata", {}).get("generation", 0))


def labels_of(obj: Obj) -> Dict[str, str]:
    return obj.get("metadata", {}).get("labels") or {}


def annotations_of(obj: Obj) -> Dict[str, str]:
    return obj.get("metadata", {}).get("annotations") or {}


def creation_timestamp(obj: Obj) -> str:
    return obj.get("metadata", {}).get("creationTimestamp", "")


def deletion_timestamp(obj: Obj) -> Optional[str]:
    return obj.get("metadata", {}).get("deletionTimestamp")


def finalizers(obj: Obj) -> List[str]:
    return obj.get("metadata", {}).get("finalizers") or []


def owner_references(obj: Obj) -> List[Dict[str, Any]]:
    return obj.get("metadata", {}).get("ownerReferences") or []


def controller_ref(obj: Obj) -> Optional[Dict[str, Any]]:
    """The ownerReference with controller=true, if any
    (metav1.GetControllerOf)."""
    for ref in owner_references(obj):
        if ref.get("controller"):
            return ref
    return None


def namespaced_key(obj: Obj) -> str:
    """cache.MetaNamespaceKeyFunc: "<ns>/<name>", or "<name>" cluster-scoped."""
    ns = namespace(obj)
    return f"{ns}/{name(obj)}" if ns else name(obj)


def split_key(key: str) -> Tuple[str, str]:
    """cache.SplitMetaNamespaceKey."""
    if "/" in key:
        ns, _, n = key.partition("/")
        return ns, n
    return "", key


def new_uid() -> str:
    return str(uuid.uuid4())


def now_rfc3339() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def parse_rfc3339(s: Optional[str]) -> Optional[float]:
    """Epoch seconds for an RFC3339 timestamp (now_rfc3339's Z form;
    fractional seconds dropped; ±HH:MM offsets applied), or None when
    absent/unparseable — the TTL sweep must treat a malformed stamp as
    'no stamp', never raise."""
    if not s or not isinstance(s, str):
        return None
    import calendar
    import re

    base = s[:19]  # YYYY-MM-DDTHH:MM:SS
    try:
        t = float(calendar.timegm(
            time.strptime(base, "%Y-%m-%dT%H:%M:%S")))
    except ValueError:
        return None
    m = re.match(r"^(?:\.\d+)?([+-])(\d{2}):?(\d{2})$", s[19:].rstrip("Z"))
    if m:
        sign, hh, mm = m.group(1), int(m.group(2)), int(m.group(3))
        off = hh * 3600 + mm * 60
        t += -off if sign == "+" else off
    return t


def gvk(obj: Obj) -> Tuple[str, str, str]:
    """(group, version, kind) from apiVersion/kind fields."""
    api_version = obj.get("apiVersion", "v1")
    kind = obj.get("kind", "")
    if "/" in api_version:
        group, _, version = api_version.partition("/")
    else:
        group, version = "", api_version
    return group, version, kind


def api_version_of(group: str, version: str) -> str:
    return f"{group}/{version}" if group else version


def owner_reference(owner: Obj, controller: bool = True,
                    block_owner_deletion: bool = True) -> Dict[str, Any]:
    """metav1.NewControllerRef."""
    return {
        "apiVersion": owner.get("apiVersion", "v1"),
        "kind": owner.get("kind", ""),
        "name": name(owner),
        "uid": uid(owner),
        "controller": controller,
        "blockOwnerDeletion": block_owner_deletion,
    }


def deep_copy(obj: Obj) -> Obj:
    """DeepCopyObject — generated per-type in the reference; one generic
    implementation suffices for dict-shaped objects."""
    return copy.deepcopy(obj)


def is_being_deleted(obj: Obj) -> bool:
    return deletion_timestamp(obj) is not None
