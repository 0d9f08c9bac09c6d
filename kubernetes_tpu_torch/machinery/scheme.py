"""Scheme: kind registry, defaulting, validation, codec.

Analog of apimachinery `pkg/runtime` (Scheme/codecs). Objects live in their
versioned JSON-dict form; the Scheme maps (group, version, kind) and REST
resource names to registered type info with defaulting + validation hooks.
Since dicts are self-describing there is no hub-and-spoke conversion layer —
each kind registers at one storage version (the reference's internal types
collapse to the same thing for a single served version).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..machinery import errors, meta

Obj = Dict[str, Any]
DefaultFn = Callable[[Obj], None]
ValidateFn = Callable[[Obj], List[str]]


@dataclass
class ResourceInfo:
    """One served REST resource (≈ APIResource + RESTStorage registration)."""

    group: str
    version: str
    kind: str            # e.g. "Pod"
    resource: str        # plural REST name, e.g. "pods"
    namespaced: bool = True
    list_kind: str = ""  # e.g. "PodList"
    short_names: Tuple[str, ...] = ()
    subresources: Tuple[str, ...] = ()  # e.g. ("status", "binding")
    defaulter: Optional[DefaultFn] = None
    validator: Optional[ValidateFn] = None
    custom: bool = False  # CRD-served: no struct tags → strategic patch 415

    def __post_init__(self) -> None:
        if not self.list_kind:
            self.list_kind = self.kind + "List"

    @property
    def api_version(self) -> str:
        return meta.api_version_of(self.group, self.version)

    @property
    def gvr(self) -> Tuple[str, str, str]:
        return (self.group, self.version, self.resource)


class Scheme:
    """runtime.Scheme analog: register kinds, default, validate, encode/decode."""

    def __init__(self) -> None:
        self._by_gvk: Dict[Tuple[str, str, str], ResourceInfo] = {}
        self._by_resource: Dict[Tuple[str, str], ResourceInfo] = {}
        self._by_short: Dict[str, ResourceInfo] = {}

    def register(self, info: ResourceInfo) -> ResourceInfo:
        self._by_gvk[(info.group, info.version, info.kind)] = info
        self._by_resource[(info.group, info.resource)] = info
        for s in info.short_names:
            self._by_short[s] = info
        return info

    def unregister(self, group: str, resource: str) -> None:
        info = self._by_resource.pop((group, resource), None)
        if info is not None:
            self._by_gvk.pop((info.group, info.version, info.kind), None)
            for s in info.short_names:
                if self._by_short.get(s) is info:
                    del self._by_short[s]

    def resources(self) -> List[ResourceInfo]:
        return list(self._by_resource.values())

    def lookup_kind(self, group: str, version: str, kind: str) -> Optional[ResourceInfo]:
        return self._by_gvk.get((group, version, kind))

    def lookup_resource(self, group: str, resource: str) -> Optional[ResourceInfo]:
        """Resolve a REST resource name (plural, singular-ish, or short name)."""
        info = self._by_resource.get((group, resource))
        if info:
            return info
        info = self._by_short.get(resource)
        if info and info.group == group:
            return info
        # tolerate kind-cased or singular names (kubectl-style convenience)
        for (g, _), i in self._by_resource.items():
            if g == group and (i.kind.lower() == resource.lower()
                               or i.resource.rstrip("s") == resource):
                return i
        return None

    def default(self, obj: Obj) -> Obj:
        g, v, k = meta.gvk(obj)
        info = self.lookup_kind(g, v, k)
        if info and info.defaulter:
            info.defaulter(obj)
        return obj

    def validate(self, obj: Obj) -> None:
        g, v, k = meta.gvk(obj)
        info = self.lookup_kind(g, v, k)
        errs: List[str] = []
        if not meta.name(obj) and not (obj.get("metadata") or {}).get("generateName"):
            errs.append("metadata.name: Required value")
        if info and info.validator:
            errs.extend(info.validator(obj))
        if errs:
            raise errors.new_invalid(k or "Object", meta.name(obj), "; ".join(errs))

    # -- codec ------------------------------------------------------------- #
    @staticmethod
    def encode(obj: Obj) -> bytes:
        return json.dumps(obj, separators=(",", ":"), sort_keys=True).encode()

    @staticmethod
    def decode(data: bytes) -> Obj:
        obj = json.loads(data)
        if not isinstance(obj, dict):
            raise errors.new_bad_request("body must be a JSON object")
        return obj

    def new_list(self, info: ResourceInfo, items: List[Obj],
                 resource_version: str = "") -> Obj:
        return {
            "apiVersion": info.api_version,
            "kind": info.list_kind,
            "metadata": {"resourceVersion": resource_version},
            "items": items,
        }
