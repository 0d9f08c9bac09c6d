"""Converters between real Kubernetes v1 JSON objects and the framework's
scheduling object model.

The extender boundary receives full ``v1.Pod`` / ``v1.Node`` JSON from a stock
kube-scheduler (reference: pkg/scheduler/apis/extender/v1/types.go:71 — the
``ExtenderArgs.Pod`` field is a ``*v1.Pod``). These functions parse exactly the
scheduler-relevant slice of those objects into api/types.py (a copy of the
JAX package's api/v1.py).

Semantics mirrored from the reference:
  * Pod resource requests = sum over containers, element-wise max with each
    initContainer, plus spec.overhead
    (algorithm/predicates/predicates.go:763 GetResourceRequest).
  * Host ports collected from every container's ports[] with hostPort != 0
    (nodeinfo/node_info.go HostPortInfo population).
  * Affinity/tolerations/topologySpreadConstraints map field-for-field onto the
    dataclasses in api/types.py (staging/src/k8s.io/api/core/v1/types.go).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .types import (
    Affinity,
    HostPort,
    LabelSelector,
    Node,
    NodeSelector,
    NodeSelectorTerm,
    Op,
    Pod,
    PodAffinityTerm,
    PreferredSchedulingTerm,
    Requirement,
    Resources,
    Taint,
    TaintEffect,
    Toleration,
    TolerationOp,
    TopologySpreadConstraint,
    UnsatisfiableAction,
    WeightedPodAffinityTerm,
    parse_cpu_milli,
    parse_mem_kib,
    DEFAULT_SCHEDULER_NAME,
)

_OP = {
    "In": Op.IN,
    "NotIn": Op.NOT_IN,
    "Exists": Op.EXISTS,
    "DoesNotExist": Op.DOES_NOT_EXIST,
    "Gt": Op.GT,
    "Lt": Op.LT,
}
_OP_NAME = {v: k for k, v in _OP.items()}

_EFFECT = {
    "NoSchedule": TaintEffect.NO_SCHEDULE,
    "PreferNoSchedule": TaintEffect.PREFER_NO_SCHEDULE,
    "NoExecute": TaintEffect.NO_EXECUTE,
}
_EFFECT_NAME = {v: k for k, v in _EFFECT.items()}

_TOL_OP = {"Exists": TolerationOp.EXISTS, "Equal": TolerationOp.EQUAL, "": TolerationOp.EQUAL}

_UNSAT = {
    "DoNotSchedule": UnsatisfiableAction.DO_NOT_SCHEDULE,
    "ScheduleAnyway": UnsatisfiableAction.SCHEDULE_ANYWAY,
}


# --------------------------------------------------------------------------- #
# resource accounting (predicates.go:763 GetResourceRequest)
# --------------------------------------------------------------------------- #


def _req_of(requests: Dict[str, Any]) -> Tuple[int, int, int, Dict[str, int]]:
    cpu = parse_cpu_milli(requests.get("cpu", 0))
    mem = parse_mem_kib(requests.get("memory", 0))
    eph = parse_mem_kib(requests.get("ephemeral-storage", 0))
    scalars: Dict[str, int] = {}
    for k, v in requests.items():
        if k in ("cpu", "memory", "ephemeral-storage"):
            continue
        # extended/scalar resources are integer counts (hugepages-* are byte
        # quantities; parse through the suffix table)
        scalars[k] = parse_mem_kib(v) * 1024 if "hugepages" in k else int(parse_cpu_milli(v) / 1000)
    return cpu, mem, eph, scalars


def pod_request_from_spec(spec: Dict[str, Any]) -> Resources:
    """GetResourceRequest: Σ containers, max with each initContainer, + overhead."""
    cpu = mem = eph = 0
    scalars: Dict[str, int] = {}
    for c in spec.get("containers") or []:
        rc, rm, re, rs = _req_of((c.get("resources") or {}).get("requests") or {})
        cpu += rc
        mem += rm
        eph += re
        for k, v in rs.items():
            scalars[k] = scalars.get(k, 0) + v
    for c in spec.get("initContainers") or []:
        rc, rm, re, rs = _req_of((c.get("resources") or {}).get("requests") or {})
        cpu = max(cpu, rc)
        mem = max(mem, rm)
        eph = max(eph, re)
        for k, v in rs.items():
            scalars[k] = max(scalars.get(k, 0), v)
    oc, om, oe, osc = _req_of(spec.get("overhead") or {})
    cpu += oc
    mem += om
    eph += oe
    for k, v in osc.items():
        scalars[k] = scalars.get(k, 0) + v
    return Resources(
        milli_cpu=cpu, memory_kib=mem, ephemeral_kib=eph, pods=1,
        scalars=tuple(sorted(scalars.items())),
    )


# --------------------------------------------------------------------------- #
# selectors / affinity
# --------------------------------------------------------------------------- #


def _requirements(exprs: Optional[List[Dict[str, Any]]]) -> Tuple[Requirement, ...]:
    out = []
    for e in exprs or []:
        out.append(Requirement(e["key"], _OP[e["operator"]], tuple(e.get("values") or ())))
    return tuple(out)


def node_names_from_terms(terms) -> Optional[List[str]]:
    """metadata.name `In` values across raw v1 nodeSelectorTerms — the
    matchFields extraction shared by the PV topology walk
    (volume/pv_controller.py) and the daemon-pod target resolution
    (controllers/workloads.py). None when no such field exists (an
    unrestricted term list is not an empty restriction)."""
    names: List[str] = []
    restricted = False
    for t in terms or []:
        for f in t.get("matchFields") or []:
            if f.get("key") == "metadata.name" and f.get("operator") == "In":
                restricted = True
                names.extend(f.get("values") or [])
    return names if restricted else None


def _node_term(term: Dict[str, Any]) -> NodeSelectorTerm:
    fields = term.get("matchFields") or []
    names: Tuple[str, ...] = ()
    for f in fields:
        if f.get("key") == "metadata.name" and f.get("operator") == "In":
            names = names + tuple(f.get("values") or ())
    return NodeSelectorTerm(
        requirements=_requirements(term.get("matchExpressions")),
        field_name_in=names,
    )


def _label_selector(sel: Optional[Dict[str, Any]]) -> LabelSelector:
    if not sel:
        return LabelSelector()
    return LabelSelector.of(
        match_labels=sel.get("matchLabels") or {},
        expressions=list(_requirements(sel.get("matchExpressions"))),
    )


def _pod_aff_terms(terms: Optional[List[Dict[str, Any]]]) -> Tuple[PodAffinityTerm, ...]:
    return tuple(
        PodAffinityTerm(
            selector=_label_selector(t.get("labelSelector")),
            topology_key=t.get("topologyKey", ""),
            namespaces=tuple(t.get("namespaces") or ()),
        )
        for t in terms or []
    )


def _weighted_pod_aff_terms(
    terms: Optional[List[Dict[str, Any]]],
) -> Tuple[WeightedPodAffinityTerm, ...]:
    return tuple(
        WeightedPodAffinityTerm(
            weight=int(t.get("weight", 1)),
            term=_pod_aff_terms([t.get("podAffinityTerm") or {}])[0],
        )
        for t in terms or []
    )


def affinity_from_spec(spec: Dict[str, Any]) -> Affinity:
    aff = spec.get("affinity") or {}
    node_aff = aff.get("nodeAffinity") or {}
    pod_aff = aff.get("podAffinity") or {}
    anti_aff = aff.get("podAntiAffinity") or {}

    required = node_aff.get("requiredDuringSchedulingIgnoredDuringExecution")
    node_required = (
        NodeSelector(tuple(_node_term(t) for t in required.get("nodeSelectorTerms") or []))
        if required is not None
        else None
    )
    node_preferred = tuple(
        PreferredSchedulingTerm(weight=int(p.get("weight", 1)), term=_node_term(p.get("preference") or {}))
        for p in node_aff.get("preferredDuringSchedulingIgnoredDuringExecution") or []
    )
    return Affinity(
        node_required=node_required,
        node_preferred=node_preferred,
        pod_required=_pod_aff_terms(pod_aff.get("requiredDuringSchedulingIgnoredDuringExecution")),
        pod_preferred=_weighted_pod_aff_terms(
            pod_aff.get("preferredDuringSchedulingIgnoredDuringExecution")),
        anti_required=_pod_aff_terms(anti_aff.get("requiredDuringSchedulingIgnoredDuringExecution")),
        anti_preferred=_weighted_pod_aff_terms(
            anti_aff.get("preferredDuringSchedulingIgnoredDuringExecution")),
    )


# --------------------------------------------------------------------------- #
# Pod / Node
# --------------------------------------------------------------------------- #


def pod_from_v1(obj: Dict[str, Any]) -> Pod:
    """Parse the scheduler-relevant slice of a v1.Pod JSON object."""
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}

    host_ports: List[HostPort] = []
    for c in (spec.get("containers") or []) + (spec.get("initContainers") or []):
        for p in c.get("ports") or []:
            hp = int(p.get("hostPort", 0) or 0)
            if hp > 0:
                host_ports.append(
                    HostPort(port=hp, protocol=p.get("protocol", "TCP") or "TCP",
                             host_ip=p.get("hostIP", "") or "")
                )

    tolerations = tuple(
        Toleration(
            key=t.get("key", "") or "",
            op=_TOL_OP.get(t.get("operator", ""), TolerationOp.EQUAL),
            value=t.get("value", "") or "",
            effect=_EFFECT.get(t.get("effect")) if t.get("effect") else None,
        )
        for t in spec.get("tolerations") or []
    )

    spread = tuple(
        TopologySpreadConstraint(
            max_skew=int(t.get("maxSkew", 1)),
            topology_key=t.get("topologyKey", ""),
            when_unsatisfiable=_UNSAT.get(t.get("whenUnsatisfiable", "DoNotSchedule"),
                                          UnsatisfiableAction.DO_NOT_SCHEDULE),
            selector=_label_selector(t.get("labelSelector")),
        )
        for t in spec.get("topologySpreadConstraints") or []
    )

    # gang scheduling: the coscheduling protocol's pod-carried group
    # reference (label or annotation pod-group.scheduling.sigs.k8s.io/name
    # + .../min-available); no in-tree reference equivalent (BASELINE #5).
    # Label wins over annotation for BOTH keys, so a single source supplies
    # a consistent (name, min) pair.
    labels = dict(meta.get("labels") or {})
    anns = dict(meta.get("annotations") or {})

    def _gang(key):
        full = f"pod-group.scheduling.sigs.k8s.io/{key}"
        return labels.get(full, "") or anns.get(full, "")

    group = _gang("name")
    try:
        min_member = int(_gang("min-available") or 0)
    except (TypeError, ValueError):
        min_member = 0

    return Pod(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default") or "default",
        uid=meta.get("uid", "") or "",
        labels=labels,
        requests=pod_request_from_spec(spec),
        node_selector=dict(spec.get("nodeSelector") or {}),
        affinity=affinity_from_spec(spec),
        tolerations=tolerations,
        topology_spread=spread,
        host_ports=tuple(host_ports),
        priority=int(spec.get("priority", 0) or 0),
        node_name=spec.get("nodeName", "") or "",
        scheduler_name=spec.get("schedulerName", DEFAULT_SCHEDULER_NAME) or DEFAULT_SCHEDULER_NAME,
        pod_group=group,
        min_member=min_member,
    )


def node_from_v1(obj: Dict[str, Any]) -> Node:
    """Parse the scheduler-relevant slice of a v1.Node JSON object."""
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    alloc = status.get("allocatable") or {}

    scalars: Dict[str, int] = {}
    for k, v in alloc.items():
        if k in ("cpu", "memory", "ephemeral-storage", "pods"):
            continue
        scalars[k] = parse_mem_kib(v) * 1024 if "hugepages" in k else int(parse_cpu_milli(v) / 1000)

    taints = tuple(
        Taint(key=t.get("key", ""), value=t.get("value", "") or "",
              effect=_EFFECT.get(t.get("effect"), TaintEffect.NO_SCHEDULE))
        for t in spec.get("taints") or []
    )

    images: Dict[str, int] = {}
    for img in status.get("images") or []:
        size_kib = -(-int(img.get("sizeBytes", 0)) // 1024)
        for name in img.get("names") or []:
            images[name] = size_kib

    return Node(
        name=meta.get("name", ""),
        labels=dict(meta.get("labels") or {}),
        prefer_avoid_pods=(
            "scheduler.alpha.kubernetes.io/preferAvoidPods"
            in (meta.get("annotations") or {})),
        allocatable=Resources(
            milli_cpu=parse_cpu_milli(alloc.get("cpu", 0)),
            memory_kib=parse_mem_kib(alloc.get("memory", 0)),
            ephemeral_kib=parse_mem_kib(alloc.get("ephemeral-storage", 0)),
            pods=int(str(alloc.get("pods", 0))),
            scalars=tuple(sorted(scalars.items())),
        ),
        taints=taints,
        unschedulable=bool(spec.get("unschedulable", False)),
        images_kib=images,
    )


# --------------------------------------------------------------------------- #
# back to v1 JSON (for tests and for our own control-plane objects)
# --------------------------------------------------------------------------- #


def pod_to_v1(pod: Pod) -> Dict[str, Any]:
    """Minimal round-trippable v1.Pod JSON for a framework Pod."""
    spec: Dict[str, Any] = {
        "schedulerName": pod.scheduler_name,
        "priority": pod.priority,
        "containers": [{
            "name": "main",
            "resources": {"requests": {
                "cpu": f"{pod.requests.milli_cpu}m",
                "memory": f"{pod.requests.memory_kib}Ki",
                **({"ephemeral-storage": f"{pod.requests.ephemeral_kib}Ki"}
                   if pod.requests.ephemeral_kib else {}),
                **{k: str(v) for k, v in pod.requests.scalars},
            }},
            "ports": [
                {"hostPort": hp.port, "protocol": hp.protocol,
                 **({"hostIP": hp.host_ip} if hp.host_ip else {})}
                for hp in pod.host_ports
            ],
        }],
    }
    if pod.node_name:
        spec["nodeName"] = pod.node_name
    if pod.node_selector:
        spec["nodeSelector"] = dict(pod.node_selector)
    if pod.tolerations:
        spec["tolerations"] = [
            {"key": t.key, "operator": "Exists" if t.op == TolerationOp.EXISTS else "Equal",
             "value": t.value,
             **({"effect": _EFFECT_NAME[t.effect]} if t.effect is not None else {})}
            for t in pod.tolerations
        ]
    aff = _affinity_to_v1(pod.affinity)
    if aff:
        spec["affinity"] = aff
    if pod.topology_spread:
        spec["topologySpreadConstraints"] = [
            {"maxSkew": c.max_skew, "topologyKey": c.topology_key,
             "whenUnsatisfiable": ("DoNotSchedule"
                                   if c.when_unsatisfiable == UnsatisfiableAction.DO_NOT_SCHEDULE
                                   else "ScheduleAnyway"),
             "labelSelector": _selector_to_v1(c.selector)}
            for c in pod.topology_spread
        ]
    md: Dict[str, Any] = {"name": pod.name, "namespace": pod.namespace,
                          "uid": pod.uid, "labels": dict(pod.labels)}
    if pod.pod_group:
        anns: Dict[str, Any] = {
            "pod-group.scheduling.sigs.k8s.io/name": pod.pod_group}
        if pod.min_member:
            anns["pod-group.scheduling.sigs.k8s.io/min-available"] = \
                str(pod.min_member)
        md["annotations"] = anns
    return {"metadata": md, "spec": spec}


def _selector_to_v1(sel: LabelSelector) -> Dict[str, Any]:
    return {"matchExpressions": [
        {"key": r.key, "operator": _OP_NAME[r.op], "values": list(r.values)}
        for r in sel.requirements
    ]}


def _node_term_to_v1(t: NodeSelectorTerm) -> Dict[str, Any]:
    out: Dict[str, Any] = {"matchExpressions": [
        {"key": r.key, "operator": _OP_NAME[r.op], "values": list(r.values)}
        for r in t.requirements
    ]}
    if t.field_name_in:
        out["matchFields"] = [
            {"key": "metadata.name", "operator": "In", "values": list(t.field_name_in)}
        ]
    return out


def _pod_term_to_v1(t: PodAffinityTerm) -> Dict[str, Any]:
    return {"labelSelector": _selector_to_v1(t.selector), "topologyKey": t.topology_key,
            **({"namespaces": list(t.namespaces)} if t.namespaces else {})}


def _affinity_to_v1(aff: Affinity) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    node: Dict[str, Any] = {}
    if aff.node_required is not None:
        node["requiredDuringSchedulingIgnoredDuringExecution"] = {
            "nodeSelectorTerms": [_node_term_to_v1(t) for t in aff.node_required.terms]
        }
    if aff.node_preferred:
        node["preferredDuringSchedulingIgnoredDuringExecution"] = [
            {"weight": p.weight, "preference": _node_term_to_v1(p.term)}
            for p in aff.node_preferred
        ]
    if node:
        out["nodeAffinity"] = node
    if aff.pod_required or aff.pod_preferred:
        out["podAffinity"] = {
            **({"requiredDuringSchedulingIgnoredDuringExecution":
                [_pod_term_to_v1(t) for t in aff.pod_required]} if aff.pod_required else {}),
            **({"preferredDuringSchedulingIgnoredDuringExecution":
                [{"weight": w.weight, "podAffinityTerm": _pod_term_to_v1(w.term)}
                 for w in aff.pod_preferred]} if aff.pod_preferred else {}),
        }
    if aff.anti_required or aff.anti_preferred:
        out["podAntiAffinity"] = {
            **({"requiredDuringSchedulingIgnoredDuringExecution":
                [_pod_term_to_v1(t) for t in aff.anti_required]} if aff.anti_required else {}),
            **({"preferredDuringSchedulingIgnoredDuringExecution":
                [{"weight": w.weight, "podAffinityTerm": _pod_term_to_v1(w.term)}
                 for w in aff.anti_preferred]} if aff.anti_preferred else {}),
        }
    return out


def node_to_v1(node: Node) -> Dict[str, Any]:
    return {
        "metadata": {"name": node.name, "labels": dict(node.labels),
                     **({"annotations": {
                         "scheduler.alpha.kubernetes.io/preferAvoidPods":
                         "{}"}} if node.prefer_avoid_pods else {})},
        "spec": {
            **({"taints": [
                {"key": t.key, "value": t.value, "effect": _EFFECT_NAME[t.effect]}
                for t in node.taints
            ]} if node.taints else {}),
            **({"unschedulable": True} if node.unschedulable else {}),
        },
        "status": {
            "allocatable": {
                "cpu": f"{node.allocatable.milli_cpu}m",
                "memory": f"{node.allocatable.memory_kib}Ki",
                "ephemeral-storage": f"{node.allocatable.ephemeral_kib}Ki",
                "pods": str(node.allocatable.pods),
                **{k: str(v) for k, v in node.allocatable.scalars},
            },
            "images": [
                {"names": [name], "sizeBytes": kib * 1024}
                for name, kib in sorted(node.images_kib.items())
            ],
        },
    }
