"""Container manager + image GC — the kubelet's on-node resource seat.

The scheduler's arithmetic is advisory; the NODE enforces. This module is
the analog of:

  * `pkg/kubelet/cm/container_manager_linux.go` — node allocatable
    (capacity minus system/kube reservations) and the admission gate the
    kubelet runs before starting a pod (`kubelet.go canAdmitPod` →
    `pkg/kubelet/lifecycle/predicate.go GeneralPredicates`), with the
    OutOfcpu/OutOfmemory/OutOfpods rejection reasons;
  * `pkg/kubelet/qos/policy.go` — QoS classification (Guaranteed /
    Burstable / BestEffort), which orders eviction;
  * `pkg/kubelet/images/image_gc_manager.go:83` — high/low watermark image
    garbage collection over the runtime's image store, LRU, in-use exempt.

There are no real cgroups here (no containers — FakeCRI stands in for the
runtime), so "enforcement" means the admission ledger: a pod whose
requests do not fit into allocatable minus the sum of admitted pods'
requests is REJECTED with phase Failed — exactly the reference's behavior
when a static pod or a stale-scheduler binding lands on a full node.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from ..api.types import parse_cpu_milli, parse_mem_kib

Obj = Dict[str, Any]


def pod_requests(pod: Obj) -> Tuple[int, int]:
    """Effective (milliCPU, memKiB) request — max over init containers vs
    sum over app containers (resource_helpers.go PodRequestsAndLimits)."""
    cpu = mem = 0
    spec = pod.get("spec", {}) or {}
    for c in spec.get("containers", []) or []:
        req = (c.get("resources", {}) or {}).get("requests", {}) or {}
        cpu += parse_cpu_milli(str(req.get("cpu", "0") or "0"))
        mem += parse_mem_kib(str(req.get("memory", "0") or "0"))
    for c in spec.get("initContainers", []) or []:
        req = (c.get("resources", {}) or {}).get("requests", {}) or {}
        cpu = max(cpu, parse_cpu_milli(str(req.get("cpu", "0") or "0")))
        mem = max(mem, parse_mem_kib(str(req.get("memory", "0") or "0")))
    return cpu, mem


def pod_qos(pod: Obj) -> str:
    """qos.GetPodQOS: Guaranteed when every container's requests == limits
    for both cpu+memory and they are set; BestEffort when no container
    sets any request/limit; Burstable otherwise."""
    spec = pod.get("spec", {}) or {}
    containers = (spec.get("containers", []) or []) + \
        (spec.get("initContainers", []) or [])
    any_set = False
    guaranteed = bool(containers)
    for c in containers:
        res = c.get("resources", {}) or {}
        req = res.get("requests", {}) or {}
        lim = res.get("limits", {}) or {}
        if req or lim:
            any_set = True
        for key in ("cpu", "memory"):
            if not lim.get(key) or req.get(key, lim.get(key)) != lim[key]:
                guaranteed = False
    if not any_set:
        return "BestEffort"
    return "Guaranteed" if guaranteed else "Burstable"


class ContainerManager:
    """Node allocatable + the canAdmitPod gate."""

    def __init__(self, capacity: Dict[str, str],
                 system_reserved: Optional[Dict[str, str]] = None,
                 kube_reserved: Optional[Dict[str, str]] = None):
        self.capacity = dict(capacity)
        self.system_reserved = dict(system_reserved or {})
        self.kube_reserved = dict(kube_reserved or {})

    def _reserved(self, key: str) -> int:
        parse = parse_cpu_milli if key == "cpu" else parse_mem_kib
        return sum(parse(str(r.get(key, "0") or "0"))
                   for r in (self.system_reserved, self.kube_reserved))

    def allocatable(self) -> Dict[str, str]:
        """Capacity minus reservations (GetNodeAllocatableReservation) —
        what the node REPORTS, and what admission enforces."""
        out = dict(self.capacity)
        cpu = parse_cpu_milli(str(self.capacity.get("cpu", "0"))) \
            - self._reserved("cpu")
        mem = parse_mem_kib(str(self.capacity.get("memory", "0"))) \
            - self._reserved("memory")
        out["cpu"] = f"{max(cpu, 0)}m"
        out["memory"] = f"{max(mem, 0)}Ki"
        return out

    def admit(self, pod: Obj, active_pods: List[Obj]) -> Tuple[bool, str,
                                                               str]:
        """canAdmitPod: fit `pod` into allocatable minus the admitted pods'
        requests. Returns (ok, reason, message); reasons are the
        reference's OutOfcpu / OutOfmemory / OutOfpods
        (lifecycle/predicate.go → ... AdmissionFailureHandler)."""
        alloc = self.allocatable()
        alloc_cpu = parse_cpu_milli(str(alloc.get("cpu", "0")))
        alloc_mem = parse_mem_kib(str(alloc.get("memory", "0")))
        alloc_pods = int(alloc.get("pods", 110) or 110)
        used_cpu = used_mem = 0
        for p in active_pods:
            c, m = pod_requests(p)
            used_cpu += c
            used_mem += m
        cpu, mem = pod_requests(pod)
        if len(active_pods) + 1 > alloc_pods:
            return (False, "OutOfpods",
                    f"Node didn't have enough capacity: pods, requested: 1, "
                    f"used: {len(active_pods)}, capacity: {alloc_pods}")
        if used_cpu + cpu > alloc_cpu:
            return (False, "OutOfcpu",
                    f"Node didn't have enough resource: cpu, requested: "
                    f"{cpu}, used: {used_cpu}, capacity: {alloc_cpu}")
        if used_mem + mem > alloc_mem:
            return (False, "OutOfmemory",
                    f"Node didn't have enough resource: memory, requested: "
                    f"{mem}Ki, used: {used_mem}Ki, capacity: {alloc_mem}Ki")
        return True, "", ""


def pod_extended_requests(pod: Obj) -> Dict[str, int]:
    """Integer requests for non-core resources (device-plugin resources
    like example.com/tpu, extended resources generally)."""
    out: Dict[str, int] = {}
    for c in (pod.get("spec", {}) or {}).get("containers", []) or []:
        req = (c.get("resources", {}) or {}).get("requests", {}) or {}
        for name, qty in req.items():
            if name in ("cpu", "memory", "ephemeral-storage", "pods"):
                continue
            try:
                n = int(str(qty))
            except ValueError:
                continue  # extended resources are integral by definition
            if n > 0:    # negative requests are invalid — never count them
                out[name] = out.get(name, 0) + n
    return out


class DevicePluginManager:
    """The device-plugin seat (`pkg/kubelet/cm/devicemanager/manager.go`):
    plugins register a resource name with concrete device IDs; the kubelet
    advertises healthy counts as node capacity, admission counts requests
    against them, and admitted containers get SPECIFIC device ids
    allocated (the Allocate RPC) — released when the pod leaves."""

    def __init__(self):
        import threading

        self._mu = threading.Lock()
        #: resource → {device_id: healthy}
        self._devices: Dict[str, Dict[str, bool]] = {}
        #: pod uid → {resource: [device ids]}
        self._allocations: Dict[str, Dict[str, List[str]]] = {}

    def register(self, resource: str, device_ids: List[str]) -> None:
        """Plugin registration (ListAndWatch's initial inventory)."""
        with self._mu:
            self._devices[resource] = {d: True for d in device_ids}

    def set_health(self, resource: str, device_id: str,
                   healthy: bool) -> None:
        """A plugin reporting device health (ListAndWatch updates):
        unhealthy devices leave capacity and are never allocated."""
        with self._mu:
            devs = self._devices.get(resource)
            if devs is not None and device_id in devs:
                devs[device_id] = healthy

    def capacity(self) -> Dict[str, int]:
        with self._mu:
            return {res: sum(1 for ok in devs.values() if ok)
                    for res, devs in self._devices.items()}

    def _used_locked(self, resource: str) -> set:
        return {d for alloc in self._allocations.values()
                for d in alloc.get(resource, [])}

    def available(self) -> Dict[str, int]:
        with self._mu:
            out = {}
            for res, devs in self._devices.items():
                used = self._used_locked(res)
                out[res] = sum(1 for d, ok in devs.items()
                               if ok and d not in used)
            return out

    def allocate(self, pod_uid: str, requests: Dict[str, int]) -> bool:
        """Allocate concrete devices for every requested resource, or
        nothing (all-or-nothing, as the reference's Allocate). Idempotent
        per pod: a re-admission after a failed sync (CRIError retry path)
        reuses the pod's existing allocation instead of counting it as
        someone else's and spuriously rejecting."""
        with self._mu:
            mine = self._allocations.get(pod_uid, {})
            plan: Dict[str, List[str]] = {}
            for res, want in requests.items():
                if want <= 0:
                    continue  # negative/zero requests allocate nothing
                if res not in self._devices:
                    return False
                if len(mine.get(res, [])) >= want:
                    plan[res] = mine[res][:want]
                    continue
                used = self._used_locked(res) - set(mine.get(res, []))
                free = [d for d, ok in self._devices[res].items()
                        if ok and d not in used]
                if len(free) < want:
                    return False
                plan[res] = free[:want]
            if plan:
                self._allocations[pod_uid] = plan
            return True

    def deallocate(self, pod_uid: str) -> None:
        with self._mu:
            self._allocations.pop(pod_uid, None)

    def allocations(self, pod_uid: str) -> Dict[str, List[str]]:
        """The devices a pod holds (the PodResources API surface)."""
        with self._mu:
            return {r: list(ds) for r, ds in
                    self._allocations.get(pod_uid, {}).items()}


class ImageGCManager:
    """High/low watermark GC over the runtime's image store
    (image_gc_manager.go:83 ImageGCPolicy + realImageGCManager
    GarbageCollect/freeSpace): above the high threshold, delete unused
    images oldest-last-used first until usage is below the low threshold;
    images referenced by any container are exempt; images younger than
    min_age are skipped."""

    def __init__(self, cri, high_threshold_percent: int = 85,
                 low_threshold_percent: int = 80, min_age: float = 0.0,
                 clock=None):
        self.cri = cri
        self.high = high_threshold_percent
        self.low = low_threshold_percent
        self.min_age = min_age
        # a socket-backed CRIClient has no clock; monotonic matches the
        # FakeCRI default
        self.clock = clock or getattr(cri, "clock", time.monotonic)
        self.last_freed_bytes = 0

    def delete_unused_images(self) -> int:
        """Delete EVERY unused image regardless of thresholds — what the
        eviction manager's reclaimNodeLevelResources calls
        (eviction_manager.go → imageGC.DeleteUnusedImages). Returns bytes
        freed."""
        freed = 0
        for img in self.cri.list_images():
            if not img.get("inUse"):
                self.cri.remove_image(img["name"])
                freed += int(img.get("sizeBytes", 0))
        return freed

    def garbage_collect(self) -> int:
        """One GC pass; returns bytes freed (0 when below the high mark)."""
        fs = self.cri.image_fs_info()
        capacity = max(int(fs.get("capacityBytes", 0)), 1)
        used = int(fs.get("usedBytes", 0))
        usage_pct = 100 * used / capacity
        self.last_freed_bytes = 0
        if usage_pct <= self.high:
            return 0
        target = capacity * self.low // 100
        to_free = used - target
        now = self.clock()
        candidates = sorted(
            (img for img in self.cri.list_images()
             if not img.get("inUse")
             and now - float(img.get("lastUsed", 0.0)) >= self.min_age),
            key=lambda i: float(i.get("lastUsed", 0.0)))
        freed = 0
        for img in candidates:
            if freed >= to_free:
                break
            self.cri.remove_image(img["name"])
            freed += int(img.get("sizeBytes", 0))
        self.last_freed_bytes = freed
        return freed
