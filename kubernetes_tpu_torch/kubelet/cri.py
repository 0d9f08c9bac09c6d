"""Fake CRI runtime: the container-runtime process boundary, in-process.

Analog of the CRI gRPC surface the kubelet drives
(`staging/src/k8s.io/cri-api/` RuntimeService) backed by the fake runtime
kubemark uses (`cmd/kubemark/hollow-node.go` wires kubelet to
`containertest.FakeRuntime`-family fakes). Sandboxes and containers are
state machines on the host clock; a policy decides whether containers run
forever (hollow service pods) or exit (job pods).
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

SANDBOX_READY = "SANDBOX_READY"
SANDBOX_NOTREADY = "SANDBOX_NOTREADY"

CONTAINER_CREATED = "CONTAINER_CREATED"
CONTAINER_RUNNING = "CONTAINER_RUNNING"
CONTAINER_EXITED = "CONTAINER_EXITED"


@dataclass
class FakeContainer:
    id: str
    name: str
    image: str
    sandbox_id: str
    state: str = CONTAINER_CREATED
    exit_code: int = 0
    started_at: float = 0.0
    finished_at: float = 0.0
    # None = run forever; else exit with (code) after (seconds)
    exit_after: Optional[float] = None


@dataclass
class FakeSandbox:
    id: str
    pod_name: str
    pod_namespace: str
    pod_uid: str
    ip: str
    state: str = SANDBOX_READY
    containers: Dict[str, FakeContainer] = field(default_factory=dict)


class FakeCRI:
    """RuntimeService + ImageService double. Thread-safe; time-driven."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 ip_prefix: str = "10.88"):
        self._mu = threading.Lock()
        self.clock = clock
        self.sandboxes: Dict[str, FakeSandbox] = {}
        self.images: Dict[str, int] = {}
        self._ip_seq = 0
        self.ip_prefix = ip_prefix
        # policy hook: containers whose image matches return exit_after secs
        self.exit_policy: Callable[[str], Optional[float]] = lambda image: None
        # stats hook (ListContainerStats): image → (cpu milli, memory bytes);
        # the fake's stand-in for cadvisor-fed usage, overridable per test
        self.usage_policy: Callable[[str], tuple] = \
            lambda image: (100, 64 << 20)
        # probe hook: (image, kind) → bool; the fake's stand-in for
        # exec/http/tcp probe outcomes ("readiness" | "liveness")
        self.probe_policy: Callable[[str, str], bool] = \
            lambda image, kind: True
        # ImageService accounting (images dict holds name → sizeBytes):
        # size_policy sizes newly-pulled images; last-used times feed the
        # image GC manager's LRU ordering; imagefs capacity bounds usage
        self.size_policy: Callable[[str], int] = lambda image: 256 << 20
        self.image_last_used: Dict[str, float] = {}
        self.image_fs_capacity: int = 100 << 30

    # -- RuntimeService ----------------------------------------------------- #

    def run_pod_sandbox(self, pod_name: str, pod_namespace: str,
                        pod_uid: str) -> str:
        with self._mu:
            sid = f"sandbox-{uuid.uuid4().hex[:12]}"
            self._ip_seq += 1
            ip = f"{self.ip_prefix}.{(self._ip_seq >> 8) & 255}.{self._ip_seq & 255}"
            self.sandboxes[sid] = FakeSandbox(sid, pod_name, pod_namespace,
                                              pod_uid, ip)
            return sid

    def stop_pod_sandbox(self, sid: str) -> None:
        with self._mu:
            sb = self.sandboxes.get(sid)
            if sb is None:
                return
            sb.state = SANDBOX_NOTREADY
            now = self.clock()
            for c in sb.containers.values():
                if c.state == CONTAINER_RUNNING:
                    c.state = CONTAINER_EXITED
                    c.exit_code = 137  # SIGKILL, like a real stop
                    c.finished_at = now

    def remove_pod_sandbox(self, sid: str) -> None:
        with self._mu:
            self.sandboxes.pop(sid, None)

    def create_container(self, sid: str, name: str, image: str) -> str:
        with self._mu:
            sb = self.sandboxes[sid]
            cid = f"container-{uuid.uuid4().hex[:12]}"
            self._pull_locked(image)
            self.image_last_used[image] = self.clock()
            sb.containers[cid] = FakeContainer(
                cid, name, image, sid, exit_after=self.exit_policy(image))
            return cid

    def start_container(self, cid: str) -> None:
        with self._mu:
            c = self._container(cid)
            c.state = CONTAINER_RUNNING
            c.started_at = self.clock()

    def stop_container(self, cid: str, exit_code: int = 137) -> None:
        with self._mu:
            c = self._container(cid)
            if c.state == CONTAINER_RUNNING:
                c.state = CONTAINER_EXITED
                c.exit_code = exit_code
                c.finished_at = self.clock()

    def remove_container(self, cid: str) -> None:
        with self._mu:
            for sb in self.sandboxes.values():
                sb.containers.pop(cid, None)

    def _container(self, cid: str) -> FakeContainer:
        for sb in self.sandboxes.values():
            if cid in sb.containers:
                return sb.containers[cid]
        raise KeyError(cid)

    def container_status(self, cid: str) -> Optional[FakeContainer]:
        """Thread-safe snapshot read for status computation."""
        with self._mu:
            try:
                c = self._container(cid)
            except KeyError:
                return None
            return FakeContainer(c.id, c.name, c.image, c.sandbox_id, c.state,
                                 c.exit_code, c.started_at, c.finished_at,
                                 c.exit_after)

    def sandbox_for_pod(self, pod_uid: str) -> Optional[FakeSandbox]:
        with self._mu:
            for sb in self.sandboxes.values():
                if sb.pod_uid == pod_uid and sb.state == SANDBOX_READY:
                    return sb
            return None

    def probe(self, cid: str, kind: str) -> bool:
        """One probe attempt against a container (the prober's exec/http/tcp
        check collapsed to the policy hook). Non-running containers fail."""
        c = self.container_status(cid)
        if c is None or c.state != CONTAINER_RUNNING:
            return False
        return bool(self.probe_policy(c.image, kind))

    # -- ImageService (api.proto ImageService) ------------------------------ #

    def _pull_locked(self, image: str) -> None:
        if image not in self.images:
            self.images[image] = int(self.size_policy(image))

    def pull_image(self, image: str) -> None:
        """PullImage: materialize the image on the node's imagefs."""
        with self._mu:
            self._pull_locked(image)
            self.image_last_used[image] = self.clock()

    def list_images(self) -> List[dict]:
        """ListImages: name/size/lastUsed, plus whether any container
        (running or not) still references the image — GC exempts those
        (image_gc_manager.go detectImages imagesInUse)."""
        with self._mu:
            in_use = {c.image for sb in self.sandboxes.values()
                      for c in sb.containers.values()}
            return [{"name": name, "sizeBytes": size,
                     "lastUsed": self.image_last_used.get(name, 0.0),
                     "inUse": name in in_use}
                    for name, size in self.images.items()]

    def remove_image(self, image: str) -> None:
        with self._mu:
            self.images.pop(image, None)
            self.image_last_used.pop(image, None)

    def image_fs_info(self) -> dict:
        """ImageFsInfo: capacity/used bytes of the image filesystem — the
        signal both the image GC thresholds and the nodefs eviction signal
        read."""
        with self._mu:
            return {"capacityBytes": self.image_fs_capacity,
                    "usedBytes": sum(self.images.values())}

    def list_stats(self) -> List[dict]:
        """ListContainerStats (api.proto RuntimeService): per-running-container
        cpu/memory usage, synthesized by `usage_policy` — the source the
        kubelet's resource-metrics endpoint aggregates from."""
        out: List[dict] = []
        with self._mu:
            for sb in self.sandboxes.values():
                for c in sb.containers.values():
                    if c.state != CONTAINER_RUNNING:
                        continue
                    cpu, mem = self.usage_policy(c.image)
                    out.append({
                        "containerId": c.id, "name": c.name,
                        "podUid": sb.pod_uid, "podName": sb.pod_name,
                        "podNamespace": sb.pod_namespace,
                        "cpuMilli": int(cpu), "memoryBytes": int(mem),
                    })
        return out

    # -- the PLEG source: advance clocks, report states --------------------- #

    def tick(self) -> List[str]:
        """Advance container lifecycles; returns ids that changed state
        (what the real PLEG derives by relisting the runtime)."""
        changed: List[str] = []
        now = self.clock()
        with self._mu:
            for sb in self.sandboxes.values():
                for c in sb.containers.values():
                    if (c.state == CONTAINER_RUNNING
                            and c.exit_after is not None
                            and now - c.started_at >= c.exit_after):
                        c.state = CONTAINER_EXITED
                        c.exit_code = 0
                        c.finished_at = now
                        changed.append(c.id)
        return changed
