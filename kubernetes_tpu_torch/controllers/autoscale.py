"""HPA, volume attach/detach + expansion, and node-IPAM controllers.

  * HorizontalPodAutoscalerController ⇔ pkg/controller/podautoscaler/
    horizontal.go (reconcileAutoscaler :524, computeReplicasForMetrics :235,
    the 0.1 usage-ratio tolerance in pkg/podautoscaler/replica_calculator.go):
    desired = ceil(current × utilization/target), clamped to [min, max].
    Metrics come from a pluggable provider; the default reads the pod
    annotation `kubernetes-tpu.io/cpu-utilization` (an in-process stand-in
    for the metrics API the reference queries — the resource-metrics server
    is an out-of-tree component there too).
  * AttachDetachController ⇔ pkg/controller/volume/attachdetach/: desired
    attachments = attachable volumes of pods bound to each node; reconciled
    into node.status.volumesAttached/volumesInUse.
  * VolumeExpansionController ⇔ pkg/controller/volume/expand/: a PVC whose
    requested storage outgrew its PV's capacity gets both capacities raised
    (no cloud to call — the size bookkeeping IS the portable semantics,
    like kube-proxy's rule rendering, docs/PARITY.md #6).
  * NodeIpamController ⇔ pkg/controller/nodeipam/: carve per-node podCIDRs
    out of the cluster CIDR (range allocator).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional

from ..machinery import errors, meta
# attachable-volume identity is shared with the kubelet's volume manager
# (both sides must agree on unique volume names)
from ..volume.names import (
    attachable_volume_ids as _pod_attachable_volumes,
)

from .base import Controller, InformerFactory

HPA_TOLERANCE = 0.1  # replica_calculator.go defaultTestingTolerance analog
CPU_ANNOTATION = "kubernetes-tpu.io/cpu-utilization"

_SCALE_TARGETS = {
    "Deployment": "deployments",
    "ReplicaSet": "replicasets",
    "ReplicationController": "replicationcontrollers",
    "StatefulSet": "statefulsets",
}


def annotation_metrics(pod: Dict) -> Optional[float]:
    """Annotation-carried per-pod CPU utilization (percent of request) — the
    test-fixture source, and the fallback when no metrics API is serving."""
    v = meta.annotations_of(pod).get(CPU_ANNOTATION)
    try:
        return float(v) if v is not None else None
    except (TypeError, ValueError):
        return None


class ResourceMetricsProvider:
    """The HPA's metrics-client seat (horizontal.go:96 via
    pkg/controller/podautoscaler/metrics RESTMetricsClient): per-pod CPU
    utilization = usage from the resource-metrics API
    (metrics.k8s.io/v1beta1 PodMetrics, served through the aggregator by
    component/metrics_server.py) ÷ the pod's CPU request. Falls back to the
    annotation source when the API is not serving (no metrics-server
    installed), so fixture-driven tests keep working."""

    def __init__(self, client, cache_ttl: float = 1.0,
                 clock: Optional[Callable[[], float]] = None):
        self.client = client
        self.cache_ttl = cache_ttl
        self.clock = clock or time.monotonic
        self._mu = threading.Lock()
        self._cache: Dict[str, tuple] = {}  # ns → (fetched_at, {pod: milli})

    def _usage_by_pod(self, ns: str) -> Optional[Dict[str, int]]:
        now = self.clock()
        with self._mu:
            hit = self._cache.get(ns)
            if hit is not None and now - hit[0] < self.cache_ttl:
                return hit[1]
        from ..api.v1 import parse_cpu_milli

        try:
            lst = self.client.resource(
                "metrics.k8s.io", "v1beta1", "pods", True).list(ns)
        except errors.StatusError:
            # API not serving → caller falls back; cached negatively so an
            # HPA sync over many pods does one probe per TTL, not one per pod
            with self._mu:
                self._cache[ns] = (now, None)
            return None
        usage = {}
        for m in lst.get("items", []):
            usage[meta.name(m)] = sum(
                parse_cpu_milli((c.get("usage") or {}).get("cpu", 0))
                for c in m.get("containers", []))
        with self._mu:
            self._cache[ns] = (now, usage)
        return usage

    def __call__(self, pod: Dict) -> Optional[float]:
        usage = self._usage_by_pod(meta.namespace(pod))
        if usage is None:
            return annotation_metrics(pod)
        milli = usage.get(meta.name(pod))
        if milli is None:
            return None  # no sample yet (reference: pod skipped this cycle)
        from ..api.v1 import pod_request_from_spec

        req = pod_request_from_spec(pod.get("spec", {}) or {}).milli_cpu
        if req <= 0:
            return None  # utilization is undefined without a request
        return 100.0 * milli / req


class HorizontalPodAutoscalerController(Controller):
    """horizontal.go reconcileAutoscaler: read the scale target, average the
    pods' utilization, scale by the usage ratio within tolerance."""

    name = "horizontalpodautoscaler"

    def __init__(self, client, factory: InformerFactory,
                 metrics: Optional[Callable[[Dict], Optional[float]]] = None):
        super().__init__(client, factory)
        # default: the resource-metrics API client (with annotation
        # fallback) — the reference's RESTMetricsClient wiring
        self.metrics = metrics or ResourceMetricsProvider(client)
        self.hpa_informer = self.watch_resource("horizontalpodautoscalers")
        self.pod_informer = self.factory.informer("pods")
        # metric changes arrive as pod updates → resync the owning HPAs
        self.pod_informer.add_handlers(
            on_update=lambda o, n: self._pod_changed(n))

    def _pod_changed(self, pod: Dict) -> None:
        for hpa in self.hpa_informer.lister.list(meta.namespace(pod)):
            self.enqueue(hpa)

    def resync(self) -> None:
        """Periodic control loop (the reference reconciles every 15s)."""
        for hpa in self.hpa_informer.lister.list(None):
            self.enqueue(hpa)

    def sync(self, key: str) -> None:
        ns, name = meta.split_key(key)
        hpa = self.hpa_informer.lister.get(ns, name)
        if hpa is None:
            return
        spec = hpa.get("spec", {})
        ref = spec.get("scaleTargetRef", {})
        attr = _SCALE_TARGETS.get(ref.get("kind", ""))
        if attr is None:
            return
        rc = getattr(self.client, attr)
        try:
            target = rc.get(ref.get("name", ""), ns)
        except errors.StatusError:
            return
        current = int(target.get("spec", {}).get("replicas", 1) or 0)
        min_r = int(spec.get("minReplicas", 1) or 1)
        max_r = int(spec.get("maxReplicas", max(min_r, 1)))
        target_util = float(spec.get("targetCPUUtilizationPercentage", 80))

        from ..api.semantics import selector_matches
        from ..api.v1 import _label_selector

        sel = target.get("spec", {}).get("selector", {}) or {}
        if "matchLabels" not in sel and "matchExpressions" not in sel:
            # bare map selectors (RC-style spec.selector)
            sel = {"matchLabels": sel}
        selector = _label_selector(sel)
        utils: List[float] = []
        for pod in self.pod_informer.lister.list(ns):
            if selector.requirements and not selector_matches(
                    selector, meta.labels_of(pod)):
                continue
            u = self.metrics(pod)
            if u is not None:
                utils.append(u)

        desired = current
        if utils and current > 0:
            avg = sum(utils) / len(utils)
            ratio = avg / max(target_util, 1e-9)
            # within tolerance → no scale (replica_calculator.go:94)
            if abs(ratio - 1.0) > HPA_TOLERANCE:
                desired = int(math.ceil(current * ratio))
        desired = max(min_r, min(desired, max_r))

        if desired != current:
            target["spec"]["replicas"] = desired
            rc.update(target, ns)
        status = {"currentReplicas": current, "desiredReplicas": desired}
        if utils:
            status["currentCPUUtilizationPercentage"] = int(
                sum(utils) / len(utils))
        if hpa.get("status") != status:
            hpa = dict(hpa)
            hpa["status"] = status
            try:
                self.client.horizontalpodautoscalers.update_status(hpa, ns)
            except (errors.StatusError, AttributeError):
                try:
                    self.client.horizontalpodautoscalers.update(hpa, ns)
                except errors.StatusError:
                    pass




class AttachDetachController(Controller):
    """pkg/controller/volume/attachdetach/: reconcile the attached-volume
    lists in node status against the pods bound to each node."""

    name = "attachdetach"

    def __init__(self, client, factory: InformerFactory):
        super().__init__(client, factory)
        self.node_informer = self.watch_resource(
            "nodes", enqueue_fn=lambda o: self.enqueue_key(meta.name(o)))
        self.pod_informer = self.factory.informer("pods")
        # pods indexed by node so one sync is O(pods on that node), not
        # O(all pods) — 50k-pod bind storms would otherwise make this
        # controller quadratic (attachdetach's desiredStateOfWorld populator
        # keys by node for the same reason)
        self.pod_informer.indexer.add_index(
            "node", lambda o: [o.get("spec", {}).get("nodeName", "")]
            if o.get("spec", {}).get("nodeName") else [])
        self.pod_informer.add_handlers(
            on_add=self._pod_changed,
            on_update=lambda o, n: self._pod_changed(n),
            on_delete=self._pod_changed)

    def _pod_changed(self, pod: Dict) -> None:
        node = pod.get("spec", {}).get("nodeName", "")
        if node:
            self.enqueue_key(node)

    def sync(self, key: str) -> None:
        node = self.node_informer.lister.get(None, key)
        if node is None:
            return
        want: List[str] = []
        for pod in self.pod_informer.indexer.by_index("node", key):
            if meta.is_being_deleted(pod):
                continue
            for vid in _pod_attachable_volumes(pod):
                if vid not in want:
                    want.append(vid)
        status = node.get("status", {})
        # SAFE DETACH (reconciler.go): a volume leaving the desired set
        # stays attached while the KUBELET still reports it in
        # volumesInUse (unmount in progress) — detaching under an active
        # mount corrupts; volumesInUse is the kubelet's report
        # (kubelet_node_status.go setNodeVolumesInUseStatus), not ours
        in_use = set(status.get("volumesInUse") or [])
        keep = sorted(set(want) | (
            {v.get("name") for v in status.get("volumesAttached") or []}
            & in_use))
        attached = [{"name": v, "devicePath": ""} for v in keep]
        if status.get("volumesAttached") == attached:
            return
        node = dict(node)
        node.setdefault("status", {})
        node["status"]["volumesAttached"] = attached
        try:
            self.client.nodes.update_status(node)
        except (errors.StatusError, AttributeError):
            try:
                self.client.nodes.update(node)
            except errors.StatusError:
                pass


def _qty_kib(q) -> int:
    from ..api.types import parse_mem_kib

    try:
        return parse_mem_kib(q)
    except (ValueError, TypeError):
        return 0


class PVNotSynced(Exception):
    """A claim's PV is not in the controller's lister yet (the claim is
    requeued)."""


class VolumeExpansionController(Controller):
    """pkg/controller/volume/expand/: grow a bound PV (and the PVC status)
    when the claim requests more storage."""

    name = "volumeexpand"

    def __init__(self, client, factory: InformerFactory):
        super().__init__(client, factory)
        self.pvc_informer = self.watch_resource("persistentvolumeclaims")
        self.pv_informer = self.factory.informer("persistentvolumes")

    def sync(self, key: str) -> None:
        ns, name = meta.split_key(key)
        pvc = self.pvc_informer.lister.get(ns, name)
        if pvc is None:
            return
        want = _qty_kib(pvc.get("spec", {}).get("resources", {})
                        .get("requests", {}).get("storage"))
        have = _qty_kib(pvc.get("status", {}).get("capacity", {})
                        .get("storage"))
        pv_name = pvc.get("spec", {}).get("volumeName", "")
        if not want or want <= have or not pv_name:
            return
        pv = self.pv_informer.lister.get(None, pv_name)
        if pv is None:
            # the PV's event has not reached this lister yet: requeue the
            # claim (rate-limited, Controller._worker) and write no status,
            # as upstream's expand controller does. Writing the grown status
            # here would make `want <= have` on every later sync and leave
            # the PV unexpanded for good (the JAX package does; ROADMAP §C,
            # C3).
            raise PVNotSynced(f"persistentvolume {pv_name!r} of claim "
                              f"{key!r} is not in the lister yet")
        if _qty_kib(pv.get("spec", {}).get("capacity", {})
                    .get("storage")) < want:
            pv = dict(pv)
            pv.setdefault("spec", {}).setdefault("capacity", {})
            pv["spec"]["capacity"]["storage"] = f"{want}Ki"
            try:
                self.client.persistentvolumes.update(pv)
            except errors.StatusError:
                return
        pvc = dict(pvc)
        pvc.setdefault("status", {}).setdefault("capacity", {})
        pvc["status"]["capacity"]["storage"] = f"{want}Ki"
        try:
            self.client.persistentvolumeclaims.update_status(pvc, ns)
        except (errors.StatusError, AttributeError):
            try:
                self.client.persistentvolumeclaims.update(pvc, ns)
            except errors.StatusError:
                pass


class NodeIpamController(Controller):
    """pkg/controller/nodeipam/ (range allocator): carve one /`size` podCIDR
    per node out of the cluster CIDR and write spec.podCIDR."""

    name = "nodeipam"

    def __init__(self, client, factory: InformerFactory,
                 cluster_cidr: str = "10.244.0.0/16", node_bits: int = 8):
        super().__init__(client, factory)
        import ipaddress

        self.network = ipaddress.ip_network(cluster_cidr)
        self.node_prefix = self.network.prefixlen + node_bits
        self.node_informer = self.watch_resource(
            "nodes", enqueue_fn=lambda o: self.enqueue_key(meta.name(o)))

    def _used_cidrs(self) -> set:
        return {n.get("spec", {}).get("podCIDR")
                for n in self.node_informer.lister.list(None)
                if n.get("spec", {}).get("podCIDR")}

    def sync(self, key: str) -> None:
        node = self.node_informer.lister.get(None, key)
        if node is None or node.get("spec", {}).get("podCIDR"):
            return
        used = self._used_cidrs()
        for subnet in self.network.subnets(new_prefix=self.node_prefix):
            cidr = str(subnet)
            if cidr not in used:
                node = dict(node)
                node.setdefault("spec", {})["podCIDR"] = cidr
                try:
                    self.client.nodes.update(node)
                except errors.StatusError:
                    pass  # conflict → informer update requeues
                return
