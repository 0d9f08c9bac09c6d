"""ObjectMeta accessors over dict-shaped API objects — the subset of the JAX
package's machinery/meta.py that the port's storage and the bind-intent
ledger call.

Analog of apimachinery `pkg/api/meta` accessor helpers. Objects are plain
dicts in their JSON wire shape: {"apiVersion", "kind", "metadata": {...},
"spec": {...}}.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

Obj = Dict[str, Any]


def ensure_meta(obj: Obj) -> Dict[str, Any]:
    return obj.setdefault("metadata", {})


def name(obj: Obj) -> str:
    return obj.get("metadata", {}).get("name", "")


def resource_version(obj: Obj) -> str:
    return obj.get("metadata", {}).get("resourceVersion", "")


def set_resource_version(obj: Obj, rv: str) -> None:
    ensure_meta(obj)["resourceVersion"] = rv


def deep_copy(obj: Obj) -> Obj:
    """DeepCopyObject — generated per-type in the reference; one generic
    implementation suffices for dict-shaped objects."""
    return copy.deepcopy(obj)
