"""kubectl explain: field documentation walked from a schema tree.

The reference resolves `kubectl explain pods.spec.containers` against the
server's OpenAPI document (staging/src/k8s.io/kubectl/pkg/cmd/explain +
pkg/explain field-path walker). Here the same dotted-path walk runs over
(a) a built-in doc tree for the core kinds this framework serves, and
(b) a CRD's openAPIV3Schema for custom resources — so `explain` answers
for every resource the apiserver can store.

Doc nodes are {"doc": str, "type": str, "fields": {name: node}}.

(A copy of the JAX package's cli/explain.py.)
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

Node = Dict[str, Any]


def _n(doc: str, typ: str = "Object", **fields: Node) -> Node:
    return {"doc": doc, "type": typ, "fields": fields}


_META = _n(
    "Standard object metadata (metav1.ObjectMeta).",
    "Object",
    name=_n("Unique name within a namespace.", "string"),
    namespace=_n("Namespace scoping the object (default: \"default\").",
                 "string"),
    labels=_n("String keys/values for organizing and selecting objects.",
              "map[string]string"),
    annotations=_n("Unstructured metadata for tools and extensions.",
                   "map[string]string"),
    uid=_n("System-generated unique identifier.", "string"),
    resourceVersion=_n("Opaque version for optimistic concurrency.",
                       "string"),
)

_RESOURCES_REQ = _n(
    "Compute resources required by this container.",
    "Object",
    requests=_n("Minimum resources the scheduler reserves "
                "(cpu/memory/ephemeral-storage/extended).",
                "map[string]Quantity"),
    limits=_n("Maximum resources the kubelet enforces.",
              "map[string]Quantity"),
)

_CONTAINER = _n(
    "A single container to run in the pod.",
    "Object",
    name=_n("Container name, unique within the pod.", "string"),
    image=_n("Container image reference.", "string"),
    resources=_RESOURCES_REQ,
    ports=_n("Ports to expose; hostPort reserves the port on the node "
             "(PodFitsHostPorts).", "[]Object"),
)

_AFFINITY = _n(
    "Scheduling affinity: node affinity, pod affinity/anti-affinity.",
    "Object",
    nodeAffinity=_n("Constrains nodes by label (MatchNodeSelector / "
                    "NodeAffinity priority).", "Object"),
    podAffinity=_n("Attracts to nodes whose topology domain runs matching "
                   "pods (MatchInterPodAffinity).", "Object"),
    podAntiAffinity=_n("Repels from domains running matching pods.",
                       "Object"),
)

_POD_SPEC = _n(
    "Specification of the desired pod behavior.",
    "Object",
    containers=_CONTAINER | {"type": "[]Object"},
    initContainers=_n("Run to completion before containers start; "
                      "resources take the per-resource max.", "[]Object"),
    nodeName=_n("Target node; set by the scheduler via Binding.", "string"),
    nodeSelector=_n("Node labels that must match (PodMatchNodeSelector).",
                    "map[string]string"),
    affinity=_AFFINITY,
    tolerations=_n("Taints this pod tolerates "
                   "(PodToleratesNodeTaints).", "[]Object"),
    topologySpreadConstraints=_n(
        "Even spreading across topology domains (EvenPodsSpread).",
        "[]Object"),
    priority=_n("Scheduling priority; higher preempts lower.", "integer"),
    priorityClassName=_n("Resolves to spec.priority via PriorityClass.",
                         "string"),
    schedulerName=_n("Which scheduler handles this pod.", "string"),
    restartPolicy=_n("Always | OnFailure | Never.", "string"),
    overhead=_n("Pod-level resource overhead added to requests "
                "(PodOverhead).", "map[string]Quantity"),
)

_TREE: Dict[str, Node] = {
    "pods": _n(
        "A group of containers scheduled onto one node.",
        "Object",
        metadata=_META,
        spec=_POD_SPEC,
        status=_n("Observed pod state, written by the kubelet.", "Object",
                  phase=_n("Pending | Running | Succeeded | Failed.",
                           "string"),
                  podIP=_n("IP assigned by the runtime sandbox.", "string"),
                  conditions=_n("PodScheduled / Ready / ContainersReady.",
                                "[]Object")),
    ),
    "nodes": _n(
        "A worker machine registered with the control plane.",
        "Object",
        metadata=_META,
        spec=_n("Node configuration.", "Object",
                unschedulable=_n("Cordon flag (CheckNodeUnschedulable).",
                                 "boolean"),
                taints=_n("Repel pods without matching tolerations.",
                          "[]Object"),
                podCIDR=_n("Per-node pod address range (nodeipam).",
                           "string")),
        status=_n("Reported by the kubelet.", "Object",
                  capacity=_n("Total resources on the node.",
                              "map[string]Quantity"),
                  allocatable=_n("Resources available to pods "
                                 "(PodFitsResources).",
                                 "map[string]Quantity"),
                  conditions=_n("Ready and pressure conditions; heartbeat "
                                "target.", "[]Object"),
                  images=_n("Images present (ImageLocality score).",
                            "[]Object")),
    ),
    "services": _n(
        "A named virtual IP load-balancing to selected pods.",
        "Object",
        metadata=_META,
        spec=_n("Service behavior.", "Object",
                selector=_n("Pods backing this service "
                            "(Endpoints/EndpointSlice source).",
                            "map[string]string"),
                ports=_n("Exposed port mappings.", "[]Object")),
    ),
    "deployments": _n(
        "Declarative rollout management for ReplicaSets.",
        "Object",
        metadata=_META,
        spec=_n("Desired deployment state.", "Object",
                replicas=_n("Desired pod count.", "integer"),
                selector=_n("Pods owned by this deployment.", "Object"),
                template=_n("Pod template; hash-suffixed per revision.",
                            "Object"),
                strategy=_n("RollingUpdate | Recreate.", "Object")),
        status=_n("Rollout progress.", "Object",
                  readyReplicas=_n("Pods passing readiness.", "integer"),
                  updatedReplicas=_n("Pods at the newest template.",
                                     "integer")),
    ),
}


def _from_openapi(schema: Dict[str, Any], doc: str = "") -> Node:
    """Lift an OpenAPI schema subtree (CRD openAPIV3Schema, or a served
    /openapi/v2 definition) into a doc node. Arrays descend into items so
    `pods.spec.containers.resources` keeps walking."""
    typ = schema.get("type", "Object")
    if typ == "array":
        items = schema.get("items") or {}
        inner = _from_openapi(items)
        return {
            "doc": schema.get("description", doc) or inner["doc"],
            "type": f"[]{inner['type']}",
            "fields": inner["fields"],
        }
    return {
        "doc": schema.get("description", doc) or "<no description>",
        "type": typ,
        "fields": {k: _from_openapi(v)
                   for k, v in (schema.get("properties") or {}).items()},
    }


def explain_text(resource: str, group: str, version: str,
                 field_path: List[str],
                 crd_schema: Optional[Dict[str, Any]] = None,
                 node: Optional[Node] = None,
                 ) -> Optional[str]:
    """Render the explain output for `resource[.field...]`, or None if the
    path does not resolve. `node` carries a pre-resolved doc tree (the
    served-OpenAPI path); crd_schema lifts a raw openAPIV3Schema; the
    built-in tree is the in-process fallback."""
    if node is not None:
        pass
    elif crd_schema is not None:
        node = _from_openapi(crd_schema, f"Custom resource {resource}")
        node["fields"].setdefault("metadata", _META)
    else:
        node = _TREE.get(resource)
    if node is None:
        return None
    walked = [resource]
    for seg in field_path:
        node = (node.get("fields") or {}).get(seg)
        if node is None:
            return None
        walked.append(seg)
    gv = f"{group}/{version}" if group else version
    lines = [f"KIND:     {resource}",
             f"VERSION:  {gv}", "",
             f"FIELD:    {'.'.join(walked)} <{node['type']}>"
             if field_path else f"RESOURCE: {resource} <{node['type']}>",
             "",
             "DESCRIPTION:",
             f"     {node['doc']}"]
    fields = node.get("fields") or {}
    if fields:
        lines += ["", "FIELDS:"]
        for name in sorted(fields):
            child = fields[name]
            lines.append(f"   {name}\t<{child['type']}>")
            lines.append(f"     {child['doc']}")
    return "\n".join(lines) + "\n"
