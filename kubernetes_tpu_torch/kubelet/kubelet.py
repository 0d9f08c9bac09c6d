"""The node agent: syncLoop → pod workers → CRI; status + heartbeats.

Analog of `pkg/kubelet/kubelet.go`: `Run` (:1395) registers the node and
starts the loops; `syncLoop`/`syncLoopIteration` (:1818,:1892) select over
the pod config source (here: a watch on pods bound to this node), PLEG
events, and housekeeping ticks; `syncPod` (:1478) drives the CRI. Status
writes go through a status manager that dedupes; node heartbeats ride the
Ready condition + a kube-node-lease Lease, which the nodelifecycle
controller consumes.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..client.informers import SharedInformer
from ..kubelet.checkpoint import CheckpointManager
from ..kubelet.cri import (
    CONTAINER_CREATED,
    CONTAINER_EXITED,
    CONTAINER_RUNNING,
    FakeCRI,
)
from ..kubelet.criserver import CRIError
from ..machinery import errors, meta

Obj = Dict[str, Any]


class Kubelet:
    """One node agent. `hollow=True` is the kubemark configuration: fake CRI,
    real everything else (hollow-node.go)."""

    def __init__(self, client, node_name: str,
                 capacity: Optional[Dict[str, str]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 cri: Optional[FakeCRI] = None,
                 heartbeat_interval: float = 10.0,
                 housekeeping_interval: float = 0.5,
                 checkpoint_dir: Optional[str] = None,
                 eviction_hard: Optional[Dict[str, str]] = None,
                 eviction_soft: Optional[Dict[str, str]] = None,
                 eviction_soft_grace_period: Optional[Dict[str, str]] = None,
                 system_reserved: Optional[Dict[str, str]] = None,
                 kube_reserved: Optional[Dict[str, str]] = None,
                 image_gc_high_percent: int = 85,
                 image_gc_low_percent: int = 80,
                 image_gc_period: float = 10.0,
                 clock=time.time):
        from ..kubelet.cm import (
            ContainerManager, DevicePluginManager, ImageGCManager)
        from ..kubelet.volumemanager import VolumeManager

        self.client = client
        self.node_name = node_name
        self.capacity = capacity or {"cpu": "8", "memory": "16Gi",
                                     "pods": "110"}
        self.labels = dict(labels or {})
        self.labels.setdefault("kubernetes.io/hostname", node_name)
        self.cri = cri or FakeCRI()
        self.heartbeat_interval = heartbeat_interval
        self.housekeeping_interval = housekeeping_interval
        self.clock = clock
        self.checkpoints = CheckpointManager(checkpoint_dir) \
            if checkpoint_dir else None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._informer: Optional[SharedInformer] = None
        self._status_mu = threading.Lock()
        self._last_status: Dict[str, Obj] = {}  # pod key → last written status
        # serializes syncPod across the informer and housekeeping threads
        # (the reference gives each pod a single worker goroutine)
        self._pod_mu = threading.Lock()
        self._sandbox_by_uid: Dict[str, str] = {}
        self._containers_by_uid: Dict[str, List[str]] = {}
        # teardowns that failed because the runtime was unreachable: the pod
        # is already gone from the API (no more informer events), so the
        # housekeeping loop owns the retry
        self._pending_teardowns: Dict[str, Obj] = {}
        # prober manager (pkg/kubelet/prober): per-(uid, container, kind)
        # consecutive-count state; readiness gates the Ready condition,
        # liveness failure restarts the container
        self._probe_state: Dict[tuple, Dict[str, float]] = {}
        self._restart_counts: Dict[tuple, int] = {}
        self._container_started: Dict[str, float] = {}
        # eviction manager (pkg/kubelet/eviction/eviction_manager.go):
        # evictionHard thresholds, e.g. {"memory.available": "1Gi"} — when
        # this node's CRI-reported memory usage leaves less available than
        # the threshold, MemoryPressure goes True (+ NoSchedule taint) and
        # pods are evicted lowest-priority-first until below threshold
        self.eviction_hard = dict(eviction_hard or {})
        # soft thresholds must hold CONTINUOUSLY for their grace period
        # before acting (eviction/helpers.go thresholdsMetGracePeriod);
        # observation start times live in _soft_observed_since
        self.eviction_soft = dict(eviction_soft or {})
        self.eviction_soft_grace = dict(eviction_soft_grace_period or {})
        self._soft_observed_since: Dict[str, float] = {}
        self.under_memory_pressure = False
        self.under_disk_pressure = False
        # uids this kubelet evicted: blocks resync-resurrection while the
        # Failed status propagates through the watch (cleared at teardown)
        self._evicted: set = set()
        self._pending_evict_writes: Dict[str, tuple] = {}  # uid → (pod, res)
        # container manager (kubelet/cm.py): node allocatable = capacity -
        # reservations, and the canAdmitPod gate _sync_pod runs before a
        # sandbox exists. Rejected uids behave like evicted ones: no
        # resurrection while the Failed status propagates.
        self.container_manager = ContainerManager(
            self.capacity, system_reserved, kube_reserved)
        self._rejected: set = set()
        self._pending_reject_writes: Dict[str, tuple] = {}
        self.image_gc = ImageGCManager(self.cri, image_gc_high_percent,
                                       image_gc_low_percent)
        self._image_gc_period = image_gc_period
        self._last_image_gc = 0.0
        # device plugins (cm/devicemanager) + volume manager
        # (kubelet/volumemanager): device capacity rides the heartbeat,
        # admission allocates concrete device ids, the attach gate holds
        # containers until the controller attaches, volumesInUse is OUR
        # report
        self.device_manager = DevicePluginManager()
        self.volume_manager = VolumeManager()

    # ------------------------------------------------------------------ #
    # node registration + heartbeat (kubelet_node_status.go)
    # ------------------------------------------------------------------ #

    def register_node(self) -> None:
        node = {
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": self.node_name, "labels": dict(self.labels)},
            "spec": {},
            "status": {
                "capacity": self._capacity_with_devices(),
                "allocatable": {**self.container_manager.allocatable(),
                                **self._device_capacity()},
                "conditions": [self._ready_condition()],
                "nodeInfo": {"kubeletVersion": "v1.17.0-tpu.1"},
                "addresses": [{"type": "Hostname",
                               "address": self.node_name}],
            },
        }
        try:
            self.client.nodes.create(node)
        except errors.StatusError as e:
            if not errors.is_already_exists(e):
                raise
            # re-registration keeps the existing object, refreshes status
            self._heartbeat()

    def _device_capacity(self) -> Dict[str, str]:
        return {res: str(n)
                for res, n in self.device_manager.capacity().items()}

    def _capacity_with_devices(self) -> Dict[str, str]:
        return {**self.capacity, **self._device_capacity()}

    def _ready_condition(self) -> Obj:
        return {"type": "Ready", "status": "True", "reason": "KubeletReady",
                "heartbeatUnix": self.clock(),
                "lastHeartbeatTime": meta.now_rfc3339()}

    def _heartbeat(self) -> None:
        try:
            node = self.client.nodes.get(self.node_name, "")
            conds = [c for c in node.get("status", {}).get("conditions", [])
                     if c.get("type") not in ("Ready", "MemoryPressure",
                                              "DiskPressure")]
            conds.append(self._ready_condition())
            thresholds = {**self.eviction_hard, **self.eviction_soft}
            if "memory.available" in thresholds:
                # the eviction manager's verdict rides the heartbeat
                # (kubelet_node_status.go setNodeMemoryPressureCondition)
                conds.append({
                    "type": "MemoryPressure",
                    "status": "True" if self.under_memory_pressure
                    else "False",
                    "reason": "KubeletHasInsufficientMemory"
                    if self.under_memory_pressure
                    else "KubeletHasSufficientMemory"})
            if "nodefs.available" in thresholds:
                conds.append({
                    "type": "DiskPressure",
                    "status": "True" if self.under_disk_pressure
                    else "False",
                    "reason": "KubeletHasDiskPressure"
                    if self.under_disk_pressure
                    else "KubeletHasNoDiskPressure"})
            node.setdefault("status", {})["conditions"] = conds
            node["status"]["capacity"] = self._capacity_with_devices()
            node["status"]["allocatable"] = {
                **self.container_manager.allocatable(),
                **self._device_capacity()}
            # volume manager halves of the attach/detach protocol: learn
            # what the controller attached, report what we hold mounted
            self.volume_manager.note_attached(node.get("status", {}))
            node["status"]["volumesInUse"] = self.volume_manager.in_use()
            self.client.nodes.update_status(node, "")
        except errors.StatusError:
            pass
        # node lease (kube-node-lease), the cheap heartbeat path
        lease = {
            "apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
            "metadata": {"name": self.node_name,
                         "namespace": "kube-node-lease"},
            "spec": {"holderIdentity": self.node_name,
                     "renewTime": self.clock(),
                     "leaseDurationSeconds": 40}}
        try:
            cur = self.client.leases.get(self.node_name, "kube-node-lease")
            cur["spec"] = lease["spec"]
            self.client.leases.update(cur, "kube-node-lease")
        except errors.StatusError:
            try:
                self.client.leases.create(lease, "kube-node-lease")
            except errors.StatusError:
                pass

    # ------------------------------------------------------------------ #
    # syncLoop (kubelet.go:1818): pod source + PLEG + housekeeping
    # ------------------------------------------------------------------ #

    def start(self) -> "Kubelet":
        self.register_node()
        self._informer = SharedInformer(
            self.client.pods,
            field_selector=f"spec.nodeName={self.node_name}")
        self._informer.add_handlers(
            on_add=self._pod_changed,
            on_update=lambda o, n: self._pod_changed(n),
            on_delete=self._pod_deleted)
        self._informer.start()
        self._informer.wait_for_sync()
        for target, name, period in (
                (self._heartbeat_loop, "heartbeat", None),
                (self._housekeeping_loop, "housekeeping", None)):
            t = threading.Thread(target=target, daemon=True,
                                 name=f"kubelet-{self.node_name}-{name}")
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._informer is not None:
            self._informer.stop()
        for t in self._threads:
            t.join(timeout=2)

    def _heartbeat_loop(self) -> None:
        """One heartbeat a tick. A transport failure (a reset or refused
        connection, a timeout: OSError) skips that tick and the next one
        tries again, as the reference kubelet logs a failed node status
        update and retries (kubelet_node_status.go): the loop must not die
        with one request, or the node goes NotReady while its kubelet
        runs. (The JAX package's loop dies; ROADMAP §C, C6.)"""
        while True:
            try:
                self._heartbeat()
            except OSError:
                pass
            if self._stop.wait(self.heartbeat_interval):
                return

    def _housekeeping_loop(self) -> None:
        """PLEG relist + pod reconciliation (syncLoopIteration's 1 s/2 s
        housekeeping + PLEG channels collapsed into one tick). The loop body
        is guarded — a raising sync must not kill the node's PLEG forever."""
        while not self._stop.wait(self.housekeeping_interval):
            try:
                self.cri.tick()
                # reconcile every pod each tick, not only on CRI changes: a
                # conflicted status write would otherwise never retry (the
                # status dedupe map makes the no-change case free)
                for pod in list(self._informer.lister.list()):
                    self._pod_changed(pod)
                with self._pod_mu:
                    parked = list(self._pending_teardowns.values())
                    evict_writes = list(self._pending_evict_writes.items())
                for pod in parked:
                    self._pod_deleted(pod)
                for uid, (pod, resource) in evict_writes:
                    if self._write_evicted_status(pod, resource):
                        with self._pod_mu:
                            self._pending_evict_writes.pop(uid, None)
                with self._pod_mu:
                    reject_writes = list(
                        self._pending_reject_writes.items())
                for uid, (pod, reason, message) in reject_writes:
                    if self._write_failed_status(pod, reason, message):
                        with self._pod_mu:
                            self._pending_reject_writes.pop(uid, None)
                if self.eviction_hard or self.eviction_soft:
                    self._check_eviction()
                now = self.clock()
                if now - self._last_image_gc >= self._image_gc_period:
                    self._last_image_gc = now
                    self.image_gc.garbage_collect()
            except Exception:  # noqa: BLE001 — node loops never die
                pass

    # ------------------------------------------------------------------ #
    # syncPod (kubelet.go:1478) — one pod's reconcile against the CRI
    # ------------------------------------------------------------------ #

    def _pod_changed(self, pod: Obj) -> None:
        try:
            self._sync_pod(pod)
        except CRIError:
            # runtime down (the socket boundary, kubelet/criserver.py): the
            # reference kubelet logs the sync error and retries on the next
            # housekeeping/PLEG tick — the node must not die with its runtime
            pass

    def _sync_pod(self, pod: Obj) -> None:
        if meta.is_being_deleted(pod):
            self._teardown(pod, deleted_from_api=False)
            return
        uid = meta.uid(pod)
        phase = pod.get("status", {}).get("phase", "")
        if phase in ("Succeeded", "Failed") or uid in self._evicted \
                or uid in self._rejected:
            return
        with self._pod_mu:
            if uid in self._evicted or uid in self._rejected:
                # re-checked UNDER the lock: a sync that passed the outer
                # guard while _evict_pod held the lock must not recreate
                # the sandbox it just destroyed
                return
            sid = self._sandbox_by_uid.get(uid)
            if sid is None:
                # canAdmitPod (kubelet.go HandlePodAdditions): the NODE
                # enforces allocatable against already-admitted pods —
                # the scheduler's arithmetic is advisory (stale caches,
                # static pods, competing schedulers can all overcommit)
                active = [p for p in self._informer.lister.list()
                          if meta.uid(p) in self._sandbox_by_uid
                          and meta.uid(p) not in self._evicted
                          and p.get("status", {}).get("phase", "")
                          not in ("Succeeded", "Failed")] \
                    if self._informer else []
                ok, reason, message = self.container_manager.admit(
                    pod, active)
                if ok:
                    # device-plugin resources allocate CONCRETE device ids
                    # at admission (devicemanager Allocate) — exhaustion
                    # rejects like any other resource
                    from ..kubelet.cm import (
                        pod_extended_requests)

                    plugin_caps = self.device_manager.capacity()
                    dev_req = {r: n for r, n in
                               pod_extended_requests(pod).items()
                               if r in plugin_caps}
                    if dev_req and not self.device_manager.allocate(
                            uid, dev_req):
                        ok = False
                        worst = sorted(dev_req)[0]
                        reason = f"OutOf{worst}"
                        message = (f"Node didn't have enough resource: "
                                   f"{worst} (device plugin)")
                if not ok:
                    # rejectPod: no sandbox is ever created; the Failed
                    # status (reason OutOfcpu/OutOfmemory/OutOfpods)
                    # writes outside the lock, housekeeping re-drives it
                    self._rejected.add(uid)
                    self._pending_reject_writes[uid] = (pod, reason,
                                                        message)
                    rejection = (pod, reason, message)
                else:
                    rejection = None
                    sid = self.cri.run_pod_sandbox(meta.name(pod),
                                                   meta.namespace(pod), uid)
                    # recorded IMMEDIATELY so a CRIError later in this
                    # sync leaves resumable bookkeeping, never a leaked
                    # sandbox
                    self._sandbox_by_uid[uid] = sid
                    self._containers_by_uid[uid] = []
            else:
                rejection = None
        if rejection is not None:
            if self._write_failed_status(*rejection):
                with self._pod_mu:
                    self._pending_reject_writes.pop(uid, None)
            return
        with self._pod_mu:
            if uid in self._evicted or self._sandbox_by_uid.get(uid) is None:
                return
            # volumesInUse marks BEFORE the attach gate and UNDER the pod
            # lock (reference order: markVolumesInUse precedes mounting):
            # the in-use report must cover a pod still WAITING for its
            # attach, or a delete between heartbeats detaches under an
            # active mount; and marking after the evicted/sandbox check
            # means a concurrent teardown's unmount can't be overwritten
            # by a stale sync (permanent attach leak otherwise)
            self.volume_manager.mark_mounted(uid, pod)
            # WaitForAttachAndMount: containers hold until the attach/
            # detach controller attached every attach-requiring volume;
            # housekeeping retries the sync
            ok_vols, _missing = \
                self.volume_manager.wait_for_attach_and_mount(pod)
            if not ok_vols:
                return
            sid = self._sandbox_by_uid[uid]
            cids = self._containers_by_uid.setdefault(uid, [])
            spec_containers = pod.get("spec", {}).get("containers", []) or []
            # resume container creation where a partial sync stopped (the
            # runtime died mid-loop): containers are created in spec order,
            # so the tail beyond len(cids) is exactly what's missing
            created = False
            for c in spec_containers[len(cids):]:
                cid = self.cri.create_container(sid, c.get("name", "c"),
                                                c.get("image", ""))
                cids.append(cid)
                created = True
                self.cri.start_container(cid)
                self._container_started[cid] = self.clock()
            if created and self.checkpoints:
                self.checkpoints.create_checkpoint(
                    f"pod-{uid}", {"sandbox": sid, "containers": list(cids)})
            if not created:
                self._restart_failed_containers(pod, uid)
            self._run_probes(pod, uid, cids)
        self._write_status(pod)

    # ------------------------------------------------------------------ #
    # eviction manager (pkg/kubelet/eviction/eviction_manager.go)
    # ------------------------------------------------------------------ #

    @staticmethod
    def _parse_threshold(value: str, capacity_bytes: int) -> float:
        """Threshold quantity: absolute ("1Gi") or percentage of capacity
        ("10%") — both forms the reference accepts (eviction/api/types)."""
        from ..api.types import parse_mem_kib

        value = str(value).strip()
        if value.endswith("%"):
            return capacity_bytes * float(value[:-1]) / 100.0
        return parse_mem_kib(value) * 1024.0

    @staticmethod
    def _parse_grace(value: str) -> float:
        """Duration string: '90s', '1m30s', '2h' (metav1.Duration subset)."""
        import re as _re

        total = 0.0
        # ms before m/s: the alternation is first-match (500ms ≠ 500 min)
        for num, unit in _re.findall(r"([0-9.]+)(ms|h|m|s)", str(value)):
            total += float(num) * {"h": 3600.0, "m": 60.0, "s": 1.0,
                                   "ms": 0.001}[unit]
        return total

    def _signal_under_pressure(self, signal: str, avail: float,
                               cap: float, now: float) -> bool:
        """Hard threshold: immediate. Soft threshold: only after holding
        continuously for its grace period."""
        hard = self.eviction_hard.get(signal)
        if hard and avail < self._parse_threshold(hard, int(cap)):
            return True
        soft = self.eviction_soft.get(signal)
        if soft and avail < self._parse_threshold(soft, int(cap)):
            since = self._soft_observed_since.setdefault(signal, now)
            grace = self._parse_grace(
                self.eviction_soft_grace.get(signal, "0s"))
            return now - since >= grace
        self._soft_observed_since.pop(signal, None)
        return False

    def _check_eviction(self) -> None:
        """synchronize() analog over two signals: memory.available (CRI
        container stats) and nodefs.available (imagefs). Under memory
        pressure, evict the rankMemoryPressure victim; under disk
        pressure, reclaim node-level resources FIRST (delete unused
        images — eviction_manager.go reclaimNodeLevelResources) and evict
        only if that does not clear the signal. Conditions ride the
        heartbeat; nodelifecycle converts them to NoSchedule taints. One
        stats snapshot feeds both the availability sum and the ranking,
        so the verdict and the victim come from the same observation."""
        from ..api.types import parse_mem_kib

        now = self.clock()
        with self._pod_mu:
            uids = set(self._sandbox_by_uid)
        usage: Dict[str, int] = {}
        for s in self.cri.list_stats():
            uid = s.get("podUid", "")
            if uid in uids:
                usage[uid] = usage.get(uid, 0) + s["memoryBytes"]
        cap_b = parse_mem_kib(self.capacity.get("memory", "0")) * 1024
        avail = cap_b - sum(usage.values())

        # nodefs.available over the image filesystem (the only fs here)
        disk_signals = ("nodefs.available" in self.eviction_hard
                        or "nodefs.available" in self.eviction_soft)
        if disk_signals:
            try:
                fs = self.cri.image_fs_info()
            except Exception:  # noqa: BLE001 — runtime down: skip this tick
                fs = None
            if fs is not None:
                fs_cap = int(fs.get("capacityBytes", 0))
                fs_avail = fs_cap - int(fs.get("usedBytes", 0))
                under_disk = self._signal_under_pressure(
                    "nodefs.available", fs_avail, fs_cap, now)
                if under_disk:
                    # reclaim node-level resources first: delete unused
                    # images, then re-measure before evicting anything.
                    # Same runtime-down policy as the first probe: a
                    # CRIError mid-reclaim skips the DISK verdict for this
                    # tick but must not abort the memory check below.
                    try:
                        self.image_gc.delete_unused_images()
                        fs = self.cri.image_fs_info()
                        fs_avail = int(fs.get("capacityBytes", 0)) - \
                            int(fs.get("usedBytes", 0))
                        under_disk = self._signal_under_pressure(
                            "nodefs.available", fs_avail, fs_cap, now)
                        self.under_disk_pressure = under_disk
                    except Exception:  # noqa: BLE001
                        pass
                else:
                    self.under_disk_pressure = under_disk

        mem_pressure = self._signal_under_pressure(
            "memory.available", avail, cap_b, now)
        self.under_memory_pressure = mem_pressure
        if mem_pressure:
            starved = "memory"
        elif self.under_disk_pressure:
            # disk pressure unresolved by image reclaim: evict one pod.
            # FakeCRI models no per-pod disk usage (PARITY #9b), so the
            # memory ranking below doubles as the disk ranking.
            starved = "ephemeral-storage"
        else:
            return
        from ..kubelet.cm import pod_requests

        victims = []
        for pod in self._informer.lister.list() if self._informer else []:
            phase = pod.get("status", {}).get("phase", "")
            uid = meta.uid(pod)
            if phase in ("Succeeded", "Failed") or uid in self._evicted:
                continue
            if uid not in usage:
                continue
            # rankMemoryPressure (eviction/helpers.go): pods whose usage
            # EXCEEDS their request evict first, then lower priority, then
            # the largest usage-over-request
            _, req_kib = pod_requests(pod)
            over = usage[uid] - req_kib * 1024
            victims.append((0 if over > 0 else 1,
                            int(pod.get("spec", {}).get("priority", 0) or 0),
                            -over, meta.namespaced_key(pod), pod))
        if not victims:
            return
        # key excludes the pod dict: rank ties must not fall through to
        # (unorderable) dict comparison
        victims.sort(key=lambda v: v[:4])
        self._evict_pod(victims[0][4], resource=starved)

    def _evict_pod(self, pod: Obj, resource: str = "memory") -> None:
        """Kill the pod's containers and report Failed/Evicted — the
        reference's evictPod (the object survives in Failed state; a
        controller replaces it elsewhere). The uid is marked evicted so a
        stale lister copy (watch lag) cannot resurrect the sandbox before
        the Failed status round-trips."""
        uid = meta.uid(pod)
        with self._pod_mu:
            self._evicted.add(uid)
            sid = self._sandbox_by_uid.pop(uid, None)
            cids = self._containers_by_uid.pop(uid, [])
            for cid in cids:
                self._container_started.pop(cid, None)
            for d in (self._probe_state, self._restart_counts):
                for k in [k for k in d if k[0] == uid]:
                    del d[k]
        self.device_manager.deallocate(uid)
        self.volume_manager.unmount(uid)
        if sid is not None:
            try:
                self.cri.stop_pod_sandbox(sid)
                self.cri.remove_pod_sandbox(sid)
            except CRIError:
                pass
        if not self._write_evicted_status(pod, resource):
            # parked: the housekeeping loop re-drives the write until it
            # lands — the sandbox is already gone, so the pod must not be
            # left reporting Running forever
            with self._pod_mu:
                self._pending_evict_writes[meta.uid(pod)] = (pod, resource)

    def _write_evicted_status(self, pod: Obj,
                              resource: str = "memory") -> bool:
        return self._write_failed_status(
            pod, "Evicted", f"The node was low on resource: {resource}.")

    def _write_failed_status(self, pod: Obj, reason: str,
                             message: str) -> bool:
        for _ in range(5):  # CAS-retry: informer status writes race this
            try:
                cur = self.client.pods.get(meta.name(pod),
                                           meta.namespace(pod))
                cur["status"] = {**cur.get("status", {}),
                                 "phase": "Failed", "reason": reason,
                                 "message": message}
                self.client.pods.update_status(cur, meta.namespace(pod))
                return True
            except errors.StatusError as e:
                if errors.is_not_found(e):
                    return True  # gone from the API — nothing left to mark
                if not errors.is_conflict(e):
                    # transient server error (500, auth, ...): park and let
                    # housekeeping retry — only NotFound means done
                    return False
            except Exception:  # noqa: BLE001 - transport error: park, retry
                return False
        return False

    # ------------------------------------------------------------------ #
    # prober manager (pkg/kubelet/prober/prober_manager.go): readiness
    # results gate the Ready condition; liveness failure past the
    # threshold restarts the container (worker.go doProbe)
    # ------------------------------------------------------------------ #

    def _run_probes(self, pod: Obj, uid: str, cids: List[str]) -> None:
        spec_containers = pod.get("spec", {}).get("containers", []) or []
        now = self.clock()
        for c, cid in zip(spec_containers, cids):
            status = self.cri.container_status(cid)
            if status is None or status.state != CONTAINER_RUNNING:
                # the reference stops probe workers for terminated
                # containers — restartPolicy, not liveness, owns their fate
                continue
            for kind in ("readiness", "liveness"):
                probe = c.get(f"{kind}Probe")
                if not probe:
                    continue
                key = (uid, c.get("name", "c"), kind)
                st = self._probe_state.setdefault(
                    key, {"ok": False, "fails": 0, "passes": 0, "last": 0.0})
                delay = float(probe.get("initialDelaySeconds", 0) or 0)
                period = float(probe.get("periodSeconds", 10) or 10)
                started = self._container_started.get(cid, now)
                if now - started < delay or now - st["last"] < period:
                    continue
                st["last"] = now
                ok = self.cri.probe(cid, kind)
                if ok:
                    st["passes"] += 1
                    st["fails"] = 0
                    if st["passes"] >= int(probe.get("successThreshold", 1)
                                           or 1):
                        st["ok"] = True
                else:
                    st["fails"] += 1
                    st["passes"] = 0
                    if st["fails"] >= int(probe.get("failureThreshold", 3)
                                          or 3):
                        st["ok"] = False
                        if kind == "liveness":
                            # the kubelet KILLS on liveness failure; whether
                            # it restarts is restartPolicy's call
                            # (kuberuntime_manager computePodActions:
                            # Never → the container stays terminated and
                            # the pod settles via getPhase)
                            self.cri.stop_container(cid, 137)
                            st.update(fails=0, passes=0)
                            policy = pod.get("spec", {}).get(
                                "restartPolicy", "Always")
                            if policy != "Never":
                                self._restart_container(uid, c.get(
                                    "name", "c"), cid, now)

    def _ready_gate(self, uid: str, name: str, pod: Obj) -> bool:
        """Readiness verdict for one container: True unless a readinessProbe
        is defined and has not (yet) passed."""
        for c in pod.get("spec", {}).get("containers", []) or []:
            if c.get("name", "c") == name and c.get("readinessProbe"):
                return bool(self._probe_state.get(
                    (uid, name, "readiness"), {}).get("ok", False))
        return True

    def _restart_container(self, uid: str, name: str, cid: str,
                           now: float) -> None:
        """The single restart chokepoint: starts the container and does the
        bookkeeping EVERY restart needs — count it, restamp the start time
        (initialDelaySeconds measures from here), and drop the readiness
        verdict (a restarted container is not ready until its probe passes
        again)."""
        self.cri.start_container(cid)
        rkey = (uid, name)
        self._restart_counts[rkey] = self._restart_counts.get(rkey, 0) + 1
        self._container_started[cid] = now
        self._probe_state.pop((uid, name, "readiness"), None)

    def _restart_failed_containers(self, pod: Obj, uid: str) -> None:
        """Container restarts per restartPolicy (SyncPod's computePodActions):
        Always restarts any exit; OnFailure restarts nonzero exits."""
        policy = pod.get("spec", {}).get("restartPolicy", "Always")
        for cid in self._containers_by_uid.get(uid, []):
            c = self.cri.container_status(cid)
            if c is None:
                continue
            if c.state == CONTAINER_CREATED:
                # created but never started (a partial sync lost the start):
                # repaired regardless of restartPolicy — this is first
                # start, not a restart, so no bookkeeping
                self.cri.start_container(cid)
            elif c.state == CONTAINER_EXITED and policy != "Never" and (
                    policy == "Always" or c.exit_code != 0):
                self._restart_container(uid, c.name, cid, self.clock())

    def _pod_deleted(self, pod: Obj) -> None:
        try:
            self._teardown(pod, deleted_from_api=True)
        except CRIError:
            pass  # parked in _pending_teardowns; housekeeping retries

    def _teardown(self, pod: Obj, deleted_from_api: bool) -> None:
        uid = meta.uid(pod)
        with self._pod_mu:
            sid = self._sandbox_by_uid.get(uid)
        if sid is not None:
            try:
                self.cri.stop_pod_sandbox(sid)
                self.cri.remove_pod_sandbox(sid)
            except CRIError:
                # keep the bookkeeping: the sandbox is still running on the
                # far side, and only this map can find it again — park the
                # pod so the housekeeping loop retries the teardown
                with self._pod_mu:
                    self._pending_teardowns[uid] = pod
                raise
        with self._pod_mu:
            for cid in self._containers_by_uid.get(uid, []):
                self._container_started.pop(cid, None)
            self._sandbox_by_uid.pop(uid, None)
            self._containers_by_uid.pop(uid, None)
            self._pending_teardowns.pop(uid, None)
            self._pending_evict_writes.pop(uid, None)
            self._evicted.discard(uid)
            self._rejected.discard(uid)
            self._pending_reject_writes.pop(uid, None)
            for d in (self._probe_state, self._restart_counts):
                for k in [k for k in d if k[0] == uid]:
                    del d[k]
        self.device_manager.deallocate(uid)
        self.volume_manager.unmount(uid)
        with self._status_mu:
            self._last_status.pop(meta.namespaced_key(pod), None)
        if self.checkpoints:
            self.checkpoints.remove_checkpoint(f"pod-{uid}")
        if not deleted_from_api and meta.is_being_deleted(pod):
            # confirm graceful deletion (the kubelet's final delete with
            # grace 0 once containers are down, status_manager.go)
            try:
                self.client.pods.delete(meta.name(pod), meta.namespace(pod))
            except errors.StatusError:
                pass

    # ------------------------------------------------------------------ #
    # stats (pkg/kubelet/server/stats /stats/summary): the scrape surface
    # the resource-metrics pipeline aggregates from
    # ------------------------------------------------------------------ #

    def stats_summary(self) -> Obj:
        """Per-pod cpu/memory usage from the CRI (ListContainerStats),
        summed across containers and tagged with this node — the
        /stats/summary payload metrics-server scrapes."""
        try:
            stats = self.cri.list_stats()
        except CRIError:
            return {"node": self.node_name, "pods": []}
        by_pod: Dict[tuple, Obj] = {}
        for s in stats:
            key = (s["podNamespace"], s["podName"])
            agg = by_pod.setdefault(key, {
                "namespace": s["podNamespace"], "name": s["podName"],
                "uid": s.get("podUid", ""), "cpuMilli": 0, "memoryBytes": 0,
                "containers": []})
            agg["cpuMilli"] += s["cpuMilli"]
            agg["memoryBytes"] += s["memoryBytes"]
            agg["containers"].append({"name": s["name"],
                                      "cpuMilli": s["cpuMilli"],
                                      "memoryBytes": s["memoryBytes"]})
        return {"node": self.node_name, "pods": list(by_pod.values())}

    # ------------------------------------------------------------------ #
    # status manager (pkg/kubelet/status): compute + dedupe + write
    # ------------------------------------------------------------------ #

    def _compute_status(self, pod: Obj) -> Obj:
        uid = meta.uid(pod)
        sb = self.cri.sandbox_for_pod(uid)
        cids = self._containers_by_uid.get(uid, [])
        statuses = []
        n_running = n_succeeded = n_failed = 0
        for cid in cids:
            c = self.cri.container_status(cid)
            if c is None:
                continue
            restarts = self._restart_counts.get((uid, c.name), 0)
            if c.state == CONTAINER_RUNNING:
                n_running += 1
                statuses.append({
                    "name": c.name,
                    # readiness probes gate Ready (prober results manager)
                    "ready": self._ready_gate(uid, c.name, pod),
                    "state": {"running": {}},
                    "restartCount": restarts, "image": c.image})
            elif c.state == CONTAINER_EXITED:
                if c.exit_code == 0:
                    n_succeeded += 1
                else:
                    n_failed += 1
                statuses.append({"name": c.name, "ready": False,
                                 "state": {"terminated":
                                           {"exitCode": c.exit_code}},
                                 "restartCount": restarts, "image": c.image})
        # PodPhase rules (pkg/kubelet/kubelet_pods.go getPhase): all
        # succeeded → Succeeded; any failed with restartPolicy Never →
        # Failed; otherwise Running while anything runs or will restart
        total = len(cids)
        policy = pod.get("spec", {}).get("restartPolicy", "Always")
        if total and n_succeeded == total:
            phase = "Succeeded"
        elif n_failed and policy == "Never":
            phase = "Failed"
        elif n_running or (n_failed and policy == "OnFailure"):
            # failed-under-OnFailure counts as Running: the kubelet restarts
            # the container (see _restart_failed_containers)
            phase = "Running"
        else:
            phase = "Pending"
        # pod Ready requires every container running AND readiness-passing
        # (status_manager GeneratePodReadyCondition)
        ready = (phase == "Running" and n_running == total
                 and all(s.get("ready", False) for s in statuses))
        return {
            "phase": phase,
            "podIP": sb.ip if sb else "",
            "hostIP": self.node_name,
            "conditions": [
                {"type": "PodScheduled", "status": "True"},
                {"type": "Ready", "status": "True" if ready else "False"},
                {"type": "ContainersReady",
                 "status": "True" if ready else "False"},
            ],
            "containerStatuses": statuses,
            "startTime": pod.get("status", {}).get("startTime")
            or meta.now_rfc3339(),
        }

    def _write_status(self, pod: Obj) -> None:
        key = meta.namespaced_key(pod)
        status = self._compute_status(pod)
        with self._status_mu:
            if self._last_status.get(key) == status:
                return
        cur = meta.deep_copy(pod)
        # keep scheduler-written conditions (PodScheduled) that we restate
        cur["status"] = {**pod.get("status", {}), **status}
        try:
            self.client.pods.update_status(cur, meta.namespace(pod))
        except errors.StatusError:
            return  # NOT cached: a failed write must be retried next sync
        with self._status_mu:
            self._last_status[key] = status
