"""Scheduler-extender wire types — byte-compatible with the reference's JSON
(a copy of the JAX package's extender/wire.py).

Mirror of pkg/scheduler/apis/extender/v1/types.go: ExtenderArgs (:71),
ExtenderFilterResult (:86), HostPriority/HostPriorityList (:118),
Victims/MetaVictims (:50,:63), ExtenderPreemptionArgs/Result (:37,:33),
ExtenderBindingArgs/Result (:100,:112), MaxExtenderPriority=10 (:29).

Go's encoding/json marshals these structs with their exported field names
verbatim ("Pod", "Nodes", "NodeNames", "FailedNodes", "Error", "Host",
"Score", …), so the dict keys here are capitalized exactly like that — a stock
kube-scheduler's HTTPExtender (core/extender.go:424-450 send()) can POST to us
and decode our responses unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

MIN_EXTENDER_PRIORITY = 0
MAX_EXTENDER_PRIORITY = 10  # types.go:29


@dataclass
class ExtenderArgs:
    """types.go:71 — Pod is full v1.Pod JSON; exactly one of Nodes (full
    v1.NodeList) or NodeNames is set depending on nodeCacheCapable."""

    pod: Dict[str, Any]
    nodes: Optional[List[Dict[str, Any]]] = None  # NodeList.items
    node_names: Optional[List[str]] = None

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "ExtenderArgs":
        nodes = obj.get("Nodes")
        return ExtenderArgs(
            pod=obj.get("Pod") or {},
            nodes=(nodes or {}).get("items") if nodes is not None else None,
            node_names=obj.get("NodeNames"),
        )

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"Pod": self.pod}
        out["Nodes"] = {"items": self.nodes} if self.nodes is not None else None
        out["NodeNames"] = self.node_names
        return out


@dataclass
class ExtenderFilterResult:
    """types.go:86."""

    nodes: Optional[List[Dict[str, Any]]] = None
    node_names: Optional[List[str]] = None
    failed_nodes: Dict[str, str] = field(default_factory=dict)
    error: str = ""

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "ExtenderFilterResult":
        nodes = obj.get("Nodes")
        return ExtenderFilterResult(
            nodes=(nodes or {}).get("items") if nodes is not None else None,
            node_names=obj.get("NodeNames"),
            failed_nodes=obj.get("FailedNodes") or {},
            error=obj.get("Error") or "",
        )

    def to_json(self) -> Dict[str, Any]:
        return {
            "Nodes": {"items": self.nodes} if self.nodes is not None else None,
            "NodeNames": self.node_names,
            "FailedNodes": self.failed_nodes,
            "Error": self.error,
        }


@dataclass
class HostPriority:
    """types.go:118 — scores are 0..MaxExtenderPriority; the caller rescales
    by weight × (MaxNodeScore/MaxExtenderPriority) (generic_scheduler.go:868)."""

    host: str
    score: int

    def to_json(self) -> Dict[str, Any]:
        return {"Host": self.host, "Score": self.score}

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "HostPriority":
        return HostPriority(host=obj.get("Host", ""), score=int(obj.get("Score", 0)))


@dataclass
class Victims:
    """types.go:50 — full pod objects."""

    pods: List[Dict[str, Any]] = field(default_factory=list)
    num_pdb_violations: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {"Pods": self.pods, "NumPDBViolations": self.num_pdb_violations}

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "Victims":
        return Victims(pods=obj.get("Pods") or [],
                       num_pdb_violations=int(obj.get("NumPDBViolations", 0)))


@dataclass
class MetaVictims:
    """types.go:63 — UID-only pod identifiers (nodeCacheCapable mode)."""

    pods: List[str] = field(default_factory=list)  # pod UIDs
    num_pdb_violations: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {"Pods": [{"UID": uid} for uid in self.pods],
                "NumPDBViolations": self.num_pdb_violations}

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "MetaVictims":
        return MetaVictims(
            pods=[p.get("UID", "") for p in obj.get("Pods") or []],
            num_pdb_violations=int(obj.get("NumPDBViolations", 0)),
        )


@dataclass
class ExtenderPreemptionArgs:
    """types.go:37."""

    pod: Dict[str, Any]
    node_name_to_victims: Dict[str, Victims] = field(default_factory=dict)
    node_name_to_meta_victims: Dict[str, MetaVictims] = field(default_factory=dict)

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "ExtenderPreemptionArgs":
        return ExtenderPreemptionArgs(
            pod=obj.get("Pod") or {},
            node_name_to_victims={
                k: Victims.from_json(v) for k, v in (obj.get("NodeNameToVictims") or {}).items()
            },
            node_name_to_meta_victims={
                k: MetaVictims.from_json(v)
                for k, v in (obj.get("NodeNameToMetaVictims") or {}).items()
            },
        )

    def to_json(self) -> Dict[str, Any]:
        return {
            "Pod": self.pod,
            "NodeNameToVictims": {k: v.to_json() for k, v in self.node_name_to_victims.items()},
            "NodeNameToMetaVictims": {
                k: v.to_json() for k, v in self.node_name_to_meta_victims.items()
            },
        }


@dataclass
class ExtenderPreemptionResult:
    """types.go:33."""

    node_name_to_meta_victims: Dict[str, MetaVictims] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {"NodeNameToMetaVictims": {
            k: v.to_json() for k, v in self.node_name_to_meta_victims.items()
        }}

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "ExtenderPreemptionResult":
        return ExtenderPreemptionResult(node_name_to_meta_victims={
            k: MetaVictims.from_json(v)
            for k, v in (obj.get("NodeNameToMetaVictims") or {}).items()
        })


@dataclass
class ExtenderBindingArgs:
    """types.go:100."""

    pod_name: str
    pod_namespace: str
    pod_uid: str
    node: str

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "ExtenderBindingArgs":
        return ExtenderBindingArgs(
            pod_name=obj.get("PodName", ""),
            pod_namespace=obj.get("PodNamespace", ""),
            pod_uid=obj.get("PodUID", ""),
            node=obj.get("Node", ""),
        )

    def to_json(self) -> Dict[str, Any]:
        return {"PodName": self.pod_name, "PodNamespace": self.pod_namespace,
                "PodUID": self.pod_uid, "Node": self.node}


@dataclass
class ExtenderBindingResult:
    """types.go:112."""

    error: str = ""

    def to_json(self) -> Dict[str, Any]:
        return {"Error": self.error}

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "ExtenderBindingResult":
        return ExtenderBindingResult(error=obj.get("Error") or "")
