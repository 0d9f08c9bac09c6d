"""Infrastructure controllers: Endpoints, NodeLifecycle, Namespace, GC,
PodGC, Disruption (PDB), ResourceQuota, TTL/ServiceAccount.

Analog of `pkg/controller/{endpoint,nodelifecycle,namespace,garbagecollector,
podgc,disruption,resourcequota,serviceaccount}`.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ..client.informers import InformerFactory
from ..controllers.base import Controller, is_pod_ready
from ..machinery import errors, labels as mlabels, meta


def service_ports(svc: Dict) -> List[Dict]:
    """The endpoint-port list both endpoint controllers derive from a
    Service's spec.ports (named targetPorts fall back to the service port —
    container-port resolution is not modeled)."""
    return [{"name": p.get("name", ""),
             "port": int(p.get("targetPort", p.get("port", 0)))
             if not isinstance(p.get("targetPort"), str) else p.get("port"),
             "protocol": p.get("protocol", "TCP")}
            for p in svc.get("spec", {}).get("ports", []) or []]


class EndpointsController(Controller):
    """endpoint/endpoints_controller.go: Service selector × ready pods →
    Endpoints subsets."""

    name = "endpoints"

    def __init__(self, client, factory: InformerFactory):
        super().__init__(client, factory)
        self.svc_informer = self.watch_resource("services")
        self.pod_informer = self.factory.informer("pods")
        self.pod_informer.add_handlers(
            on_add=self._pod_changed,
            on_update=lambda o, n: self._pod_changed(n),
            on_delete=self._pod_changed)

    def _pod_changed(self, pod: Dict) -> None:
        ns = meta.namespace(pod)
        for svc in self.svc_informer.lister.list(ns):
            sel = svc.get("spec", {}).get("selector") or {}
            if sel and mlabels.selector_from_set(sel).matches(
                    meta.labels_of(pod)):
                self.enqueue(svc)

    def sync(self, key: str) -> None:
        ns, name = meta.split_key(key)
        svc = self.svc_informer.lister.get(ns, name)
        if svc is None:
            try:
                self.client.endpoints.delete(name, ns)
            except errors.StatusError:
                pass
            return
        sel = svc.get("spec", {}).get("selector") or {}
        if not sel:
            return  # headless-without-selector: endpoints managed externally
        match = mlabels.selector_from_set(sel)
        addresses, not_ready = [], []
        for pod in self.pod_informer.lister.list(ns):
            if not match.matches(meta.labels_of(pod)):
                continue
            if meta.is_being_deleted(pod):
                continue
            ip = pod.get("status", {}).get("podIP", "")
            node = pod.get("spec", {}).get("nodeName", "")
            if not ip:
                continue
            entry = {"ip": ip, "nodeName": node,
                     "targetRef": {"kind": "Pod", "name": meta.name(pod),
                                   "namespace": ns, "uid": meta.uid(pod)}}
            (addresses if is_pod_ready(pod) else not_ready).append(entry)
        ports = service_ports(svc)
        subsets = []
        if addresses or not_ready:
            subsets = [{"addresses": addresses,
                        "notReadyAddresses": not_ready, "ports": ports}]
        ep = {"apiVersion": "v1", "kind": "Endpoints",
              "metadata": {"name": name, "namespace": ns,
                           "labels": dict(meta.labels_of(svc))},
              "subsets": subsets}
        try:
            cur = self.client.endpoints.get(name, ns)
            if cur.get("subsets") != subsets:
                ep["metadata"]["resourceVersion"] = ""
                cur["subsets"] = subsets
                self.client.endpoints.update(cur, ns)
        except errors.StatusError as e:
            if errors.is_not_found(e):
                self.client.endpoints.create(ep, ns)


SERVICE_NAME_LABEL = "kubernetes.io/service-name"  # discovery well-known label


class EndpointSliceController(Controller):
    """endpointslice/endpointslice_controller.go + reconciler.go: Service
    selector × pods → a SET of EndpointSlice objects, each holding at most
    `max_endpoints_per_slice` endpoints (the reference default is 100,
    endpointslice_controller.go:64,174 — the whole point of slices over
    Endpoints: 5k-endpoint services fan out as many small watch events
    instead of one giant object rewrite).

    Deviation (PARITY): slices are named deterministically `<svc>-<i>` and
    endpoints are packed in sorted-IP order, where the reference uses
    generateName suffixes and an incremental bin-packing reconciler; the
    observable contract — every ready/not-ready endpoint appears in exactly
    one owned slice, no slice exceeds the max — is the same."""

    name = "endpointslice"

    def __init__(self, client, factory: InformerFactory,
                 max_endpoints_per_slice: int = 100):
        super().__init__(client, factory)
        self.max_per_slice = max_endpoints_per_slice
        self.svc_informer = self.watch_resource("services")
        self.pod_informer = self.factory.informer("pods")
        self.pod_informer.add_handlers(
            on_add=self._pod_changed,
            on_update=lambda o, n: self._pod_changed(n),
            on_delete=self._pod_changed)

    def _pod_changed(self, pod: Dict) -> None:
        ns = meta.namespace(pod)
        for svc in self.svc_informer.lister.list(ns):
            sel = svc.get("spec", {}).get("selector") or {}
            if sel and mlabels.selector_from_set(sel).matches(
                    meta.labels_of(pod)):
                self.enqueue(svc)

    def _owned_slices(self, ns: str, svc_name: str) -> List[Dict]:
        # server-side label selection, the way the reference indexes slices
        # by the service-name label — not an O(all slices) namespace scan
        items = self.client.endpointslices.list(
            ns, label_selector=f"{SERVICE_NAME_LABEL}={svc_name}"
        ).get("items", [])
        return sorted(items, key=meta.name)

    def sync(self, key: str) -> None:
        ns, name = meta.split_key(key)
        svc = self.svc_informer.lister.get(ns, name)
        if svc is None:
            for sl in self._owned_slices(ns, name):
                try:
                    self.client.endpointslices.delete(meta.name(sl), ns)
                except errors.StatusError:
                    pass
            return
        sel = svc.get("spec", {}).get("selector") or {}
        if not sel:
            return  # selectorless services: slices managed externally
        match = mlabels.selector_from_set(sel)
        endpoints = []
        for pod in self.pod_informer.lister.list(ns):
            if not match.matches(meta.labels_of(pod)) \
                    or meta.is_being_deleted(pod):
                continue
            ip = pod.get("status", {}).get("podIP", "")
            if not ip:
                continue
            endpoints.append({
                "addresses": [ip],
                "conditions": {"ready": is_pod_ready(pod)},
                "topology": {"kubernetes.io/hostname":
                             pod.get("spec", {}).get("nodeName", "")},
                "targetRef": {"kind": "Pod", "name": meta.name(pod),
                              "namespace": ns, "uid": meta.uid(pod)},
            })
        endpoints.sort(key=lambda e: e["addresses"][0])
        ports = service_ports(svc)
        chunks = [endpoints[i:i + self.max_per_slice]
                  for i in range(0, len(endpoints), self.max_per_slice)] \
            or [[]]
        existing = self._owned_slices(ns, name)
        for i, chunk in enumerate(chunks):
            desired = {
                "apiVersion": "discovery.k8s.io/v1beta1",
                "kind": "EndpointSlice",
                "metadata": {
                    "name": f"{name}-{i}", "namespace": ns,
                    "labels": {SERVICE_NAME_LABEL: name},
                    "ownerReferences": [meta.owner_reference(svc)],
                },
                "addressType": "IPv4",
                "endpoints": chunk,
                "ports": ports,
            }
            cur = next((s for s in existing
                        if meta.name(s) == f"{name}-{i}"), None)
            if cur is None:
                self.client.endpointslices.create(desired, ns)
            elif (cur.get("endpoints") != chunk
                  or cur.get("ports") != ports):
                cur["endpoints"] = chunk
                cur["ports"] = ports
                self.client.endpointslices.update(cur, ns)
        keep = {f"{name}-{i}" for i in range(len(chunks))}
        for sl in existing:
            if meta.name(sl) not in keep:
                try:
                    self.client.endpointslices.delete(meta.name(sl), ns)
                except errors.StatusError:
                    pass


TAINT_UNREACHABLE = "node.kubernetes.io/unreachable"
TAINT_NOT_READY = "node.kubernetes.io/not-ready"
TAINT_MEMORY_PRESSURE = "node.kubernetes.io/memory-pressure"
TAINT_DISK_PRESSURE = "node.kubernetes.io/disk-pressure"


class NodeLifecycleController(Controller):
    """nodelifecycle/node_lifecycle_controller.go:212-304: heartbeat-driven
    Ready tracking; stale nodes get Unknown status + NoExecute taints; pods on
    tainted nodes evict after tolerationSeconds (taint manager)."""

    name = "nodelifecycle"

    def __init__(self, client, factory: InformerFactory,
                 monitor_grace: float = 40.0,
                 default_eviction_wait: float = 300.0,
                 clock=time.time):
        super().__init__(client, factory)
        self.monitor_grace = monitor_grace
        self.default_eviction_wait = default_eviction_wait
        self.clock = clock
        self.node_informer = self.watch_resource("nodes")
        self.pod_informer = self.factory.informer("pods")
        # kube-node-lease renewals are the cheap heartbeat path; watched,
        # not polled (the reference's lease informer), and scoped to the
        # one namespace that matters — an unscoped watch would churn on
        # every leader-election renewal in kube-system
        self.lease_informer = self.factory.informer(
            "leases", namespace="kube-node-lease")
        self._taint_since: Dict[str, float] = {}

    def poll_once(self, now: Optional[float] = None) -> None:
        """One monitor sweep (the reference runs monitorNodeHealth every 5 s)."""
        now = self.clock() if now is None else now
        for node in self.node_informer.lister.list():
            self._check_node(node, now)
        self._evict_pods(now)

    def sync(self, key: str) -> None:
        _, name = meta.split_key(key)
        node = self.node_informer.lister.get("", name)
        if node is not None:
            self._check_node(node, self.clock())

    def _heartbeat(self, node: Dict) -> float:
        """Freshest signal of kubelet life: the Ready condition's heartbeat
        OR the node's kube-node-lease renewal, whichever is newer — the
        lease is the CHEAP heartbeat path (node_lifecycle_controller.go
        tryUpdateNodeHealth reads both; a kubelet that only renews its
        lease must not be declared unreachable)."""
        hb = 0.0
        for c in node.get("status", {}).get("conditions", []) or []:
            if c.get("type") == "Ready":
                hb = max(hb, float(c.get("heartbeatUnix", 0) or 0))
        lease = self.lease_informer.lister.get("kube-node-lease",
                                               meta.name(node))
        if lease is not None:
            hb = max(hb, float(lease.get("spec", {})
                               .get("renewTime", 0) or 0))
        return hb

    def _check_node(self, node: Dict, now: float) -> None:
        name = meta.name(node)
        hb = self._heartbeat(node)
        taints = list(node.get("spec", {}).get("taints", []) or [])
        has_unreachable = any(t.get("key") == TAINT_UNREACHABLE for t in taints)
        stale = hb > 0 and (now - hb) > self.monitor_grace
        if has_unreachable and name not in self._taint_since:
            # recover the eviction clock from the taint's own timestamp —
            # survives informer lag and controller restarts (the reference
            # stores TimeAdded on the taint for exactly this)
            t = next(t for t in taints if t.get("key") == TAINT_UNREACHABLE)
            self._taint_since[name] = float(t.get("timeAddedUnix", now) or now)
        if stale and not has_unreachable:
            taints.append({"key": TAINT_UNREACHABLE, "effect": "NoExecute",
                           "timeAddedUnix": now})
            self._taint_since[name] = now
            self._write_taints(node, taints, ready="Unknown")
        elif not stale and has_unreachable and hb > 0:
            taints = [t for t in taints if t.get("key") != TAINT_UNREACHABLE]
            self._taint_since.pop(name, None)
            self._write_taints(node, taints, ready="True")
        self._sync_pressure_taint(node)

    def _sync_pressure_taint(self, node: Dict) -> None:
        """TaintNodesByCondition: the MemoryPressure / DiskPressure
        conditions the kubelet's eviction manager reports become the
        NoSchedule taints `node.kubernetes.io/{memory,disk}-pressure` —
        the scheduler's taint filter then repels new pods without any
        scheduler-side special case."""
        conds = node.get("status", {}).get("conditions", [])
        want = {}
        for cond_type, taint_key in (("MemoryPressure",
                                      TAINT_MEMORY_PRESSURE),
                                     ("DiskPressure", TAINT_DISK_PRESSURE)):
            want[taint_key] = any(
                c.get("type") == cond_type and c.get("status") == "True"
                for c in conds)
        taints = list(node.get("spec", {}).get("taints", []) or [])
        has = {k: any(t.get("key") == k for t in taints) for k in want}
        if want == has:
            return

        def update():
            cur = self.client.nodes.get(meta.name(node), "")
            cur_taints = [t for t in cur.get("spec", {}).get("taints", [])
                          or [] if t.get("key") not in want]
            for key, on in want.items():
                if on:
                    cur_taints.append({"key": key, "effect": "NoSchedule"})
            cur.setdefault("spec", {})["taints"] = cur_taints
            self.client.nodes.update(cur, "")

        try:
            update()
        except errors.StatusError:
            pass

    def _write_taints(self, node: Dict, taints: List[Dict], ready: str) -> None:
        def update():
            cur = self.client.nodes.get(meta.name(node), "")
            cur.setdefault("spec", {})["taints"] = taints
            conds = cur.setdefault("status", {}).setdefault("conditions", [])
            for c in conds:
                if c.get("type") == "Ready":
                    c["status"] = ready
                    break
            else:
                conds.append({"type": "Ready", "status": ready})
            self.client.nodes.update(cur, "")
        try:
            update()
        except errors.StatusError:
            pass

    def _toleration_seconds(self, pod: Dict) -> float:
        secs = None
        for t in pod.get("spec", {}).get("tolerations", []) or []:
            if t.get("key") in (TAINT_UNREACHABLE, None, "") and \
                    t.get("effect") in ("NoExecute", None, ""):
                ts = t.get("tolerationSeconds")
                if ts is None:
                    return float("inf")  # tolerates forever
                secs = min(secs, float(ts)) if secs is not None else float(ts)
        return secs if secs is not None else self.default_eviction_wait

    def _evict_pods(self, now: float) -> None:
        for name, since in list(self._taint_since.items()):
            node = self.node_informer.lister.get("", name)
            if node is None or not any(
                    t.get("key") == TAINT_UNREACHABLE
                    for t in node.get("spec", {}).get("taints", []) or []):
                self._taint_since.pop(name, None)
                continue
            for pod in self.pod_informer.lister.list():
                if pod.get("spec", {}).get("nodeName") != name:
                    continue
                if now - since >= self._toleration_seconds(pod):
                    try:
                        self.client.pods.delete(meta.name(pod),
                                                meta.namespace(pod))
                    except errors.StatusError:
                        pass


class NamespaceController(Controller):
    """namespace/namespace_controller.go: on Terminating, delete all
    namespaced content, then clear the 'kubernetes' finalizer."""

    name = "namespace"
    # resources swept on namespace deletion (the reference discovers these
    # dynamically via the discovery client)
    SWEEP = ["pods", "services", "endpoints", "configmaps", "secrets",
             "replicationcontrollers", "deployments", "replicasets",
             "statefulsets", "daemonsets", "jobs", "cronjobs",
             "persistentvolumeclaims", "serviceaccounts", "events",
             "poddisruptionbudgets", "resourcequotas", "limitranges"]

    def __init__(self, client, factory: InformerFactory):
        super().__init__(client, factory)
        self.ns_informer = self.watch_resource("namespaces")

    def sync(self, key: str) -> None:
        _, name = meta.split_key(key)
        ns = self.ns_informer.lister.get("", name)
        if ns is None or not meta.is_being_deleted(ns):
            return
        remaining = 0
        for attr in self.SWEEP:
            rc = getattr(self.client, attr)
            lst = rc.list(name)
            for item in lst.get("items", []):
                remaining += 1
                try:
                    rc.delete(meta.name(item), name)
                except errors.StatusError:
                    pass
        if remaining == 0:
            cur = meta.deep_copy(ns)
            cur["spec"]["finalizers"] = [
                f for f in cur.get("spec", {}).get("finalizers", [])
                if f != "kubernetes"]
            try:
                self.client.namespaces.finalize(name, cur)
            except errors.StatusError:
                pass
        else:
            self.enqueue_key(key)  # content pending; re-check


class GarbageCollector(Controller):
    """garbagecollector: delete children whose controller owner vanished
    (foreground/orphan policies collapse to background here — the default)."""

    name = "garbagecollector"
    TRACKED = ["pods", "replicasets", "jobs", "controllerrevisions"]
    OWNER_ATTR = {"ReplicaSet": "replicasets", "Deployment": "deployments",
                  "StatefulSet": "statefulsets", "DaemonSet": "daemonsets",
                  "Job": "jobs", "CronJob": "cronjobs",
                  "ReplicationController": "replicationcontrollers"}

    def __init__(self, client, factory: InformerFactory):
        super().__init__(client, factory)
        self.informers = {attr: self.watch_resource(attr)
                          for attr in self.TRACKED}

    def sync(self, key: str) -> None:
        # key format: "<attr>|<ns>/<name>"
        attr, _, nskey = key.partition("|")
        if not nskey:
            return
        ns, name = meta.split_key(nskey)
        obj = self.informers[attr].lister.get(ns, name)
        if obj is None:
            return
        ref = meta.controller_ref(obj)
        if ref is None:
            return
        owner_attr = self.OWNER_ATTR.get(ref.get("kind", ""))
        if owner_attr is None:
            return
        try:
            owner = getattr(self.client, owner_attr).get(ref["name"], ns)
            if meta.uid(owner) != ref.get("uid"):
                raise errors.new_not_found(owner_attr, ref["name"])
        except errors.StatusError as e:
            if errors.is_not_found(e):
                try:
                    getattr(self.client, attr).delete(name, ns)
                except errors.StatusError:
                    pass

    def enqueue(self, obj: Dict) -> None:  # route through attr-tagged keys
        pass

    def watch_resource(self, attr: str, **kw):
        inf = self.factory.informer(attr)

        def tag(o: Dict) -> None:
            self.enqueue_key(f"{attr}|{meta.namespaced_key(o)}")

        inf.add_handlers(on_add=tag, on_update=lambda o, n: tag(n),
                         on_delete=lambda o: None)
        return inf

    def sweep(self) -> None:
        """Full-mark pass (the reference's graph resync)."""
        for attr, inf in self.informers.items():
            for o in inf.lister.list():
                self.enqueue_key(f"{attr}|{meta.namespaced_key(o)}")


class PodGCController(Controller):
    """podgc/gc_controller.go: delete pods bound to vanished nodes and
    terminated pods beyond the threshold."""

    name = "podgc"
    terminated_threshold = 1000

    def __init__(self, client, factory: InformerFactory):
        super().__init__(client, factory)
        self.pod_informer = self.factory.informer("pods")
        self.node_informer = self.factory.informer("nodes")

    def sync(self, key: str) -> None:
        self.poll_once()

    def poll_once(self) -> None:
        nodes = {meta.name(n) for n in self.node_informer.lister.list()}
        terminated = []
        for pod in self.pod_informer.lister.list():
            node = pod.get("spec", {}).get("nodeName", "")
            phase = pod.get("status", {}).get("phase", "")
            if node and node not in nodes:
                try:
                    self.client.pods.delete(meta.name(pod), meta.namespace(pod))
                except errors.StatusError:
                    pass
            elif phase in ("Succeeded", "Failed"):
                terminated.append(pod)
        excess = len(terminated) - self.terminated_threshold
        if excess > 0:
            terminated.sort(
                key=lambda p: p["metadata"].get("creationTimestamp", ""))
            for pod in terminated[:excess]:
                try:
                    self.client.pods.delete(meta.name(pod), meta.namespace(pod))
                except errors.StatusError:
                    pass


class DisruptionController(Controller):
    """disruption/disruption.go: keep PDB status.disruptionsAllowed current;
    the eviction admission consults it."""

    name = "disruption"

    def __init__(self, client, factory: InformerFactory):
        super().__init__(client, factory)
        self.pdb_informer = self.watch_resource("poddisruptionbudgets")
        self.pod_informer = self.factory.informer("pods")
        self.pod_informer.add_handlers(
            on_add=self._pod_changed,
            on_update=lambda o, n: self._pod_changed(n),
            on_delete=self._pod_changed)

    def _pod_changed(self, pod: Dict) -> None:
        ns = meta.namespace(pod)
        for pdb in self.pdb_informer.lister.list(ns):
            sel = mlabels.from_label_selector(
                pdb.get("spec", {}).get("selector"))
            if sel.matches(meta.labels_of(pod)):
                self.enqueue(pdb)

    def sync(self, key: str) -> None:
        ns, name = meta.split_key(key)
        pdb = self.pdb_informer.lister.get(ns, name)
        if pdb is None:
            return
        spec = pdb.get("spec", {})
        sel = mlabels.from_label_selector(spec.get("selector"))
        pods = [p for p in self.pod_informer.lister.list(ns)
                if sel.matches(meta.labels_of(p))
                and not meta.is_being_deleted(p)]
        healthy = sum(1 for p in pods if is_pod_ready(p))
        total = len(pods)
        if "minAvailable" in spec:
            desired_healthy = _resolve_maybe_pct(spec["minAvailable"], total)
            allowed = max(0, healthy - desired_healthy)
        elif "maxUnavailable" in spec:
            mu = _resolve_maybe_pct(spec["maxUnavailable"], total)
            desired_healthy = max(0, total - mu)
            allowed = max(0, mu - (total - healthy))
        else:
            desired_healthy = total
            allowed = 0
        status = {"currentHealthy": healthy, "desiredHealthy": desired_healthy,
                  "expectedPods": total, "disruptionsAllowed": allowed,
                  "observedGeneration": meta.generation(pdb)}
        if pdb.get("status", {}) != status:
            cur = meta.deep_copy(pdb)
            cur["status"] = status
            try:
                self.client.poddisruptionbudgets.update_status(cur, ns)
            except errors.StatusError:
                pass


def _resolve_maybe_pct(v, total: int) -> int:
    if isinstance(v, str) and v.endswith("%"):
        import math
        return math.ceil(total * int(v[:-1]) / 100)
    return int(v)


class ResourceQuotaController(Controller):
    """resourcequota/resource_quota_controller.go: recompute namespace usage
    into quota status; admission enforces the hard limits."""

    name = "resourcequota"

    def __init__(self, client, factory: InformerFactory):
        super().__init__(client, factory)
        self.quota_informer = self.watch_resource("resourcequotas")
        self.pod_informer = self.factory.informer("pods")
        self.pod_informer.add_handlers(
            on_add=self._pod_changed,
            on_update=lambda o, n: self._pod_changed(n),
            on_delete=self._pod_changed)

    def _pod_changed(self, pod: Dict) -> None:
        for q in self.quota_informer.lister.list(meta.namespace(pod)):
            self.enqueue(q)

    def sync(self, key: str) -> None:
        from ..machinery import quantity as mq

        ns, name = meta.split_key(key)
        quota = self.quota_informer.lister.get(ns, name)
        if quota is None:
            return
        hard = quota.get("spec", {}).get("hard", {})
        pods = [p for p in self.pod_informer.lister.list(ns)
                if p.get("status", {}).get("phase")
                not in ("Succeeded", "Failed")]
        used: Dict[str, str] = {}
        if "pods" in hard:
            used["pods"] = str(len(pods))
        for res_key, req_field in (("requests.cpu", "cpu"),
                                   ("requests.memory", "memory"),
                                   ("limits.cpu", "cpu"),
                                   ("limits.memory", "memory")):
            if res_key not in hard:
                continue
            section = "requests" if res_key.startswith("requests") else "limits"
            total = mq.Quantity(0)
            for p in pods:
                for c in p.get("spec", {}).get("containers", []) or []:
                    v = (c.get("resources", {}).get(section) or {}).get(req_field)
                    if v is not None:
                        total = total + mq.parse(v)
            used[res_key] = str(total)
        status = {"hard": hard, "used": used}
        if quota.get("status", {}) != status:
            cur = meta.deep_copy(quota)
            cur["status"] = status
            try:
                self.client.resourcequotas.update_status(cur, ns)
            except errors.StatusError:
                pass
