"""kube-controller-manager: bundle the controllers behind leader election.

Analog of `cmd/kube-controller-manager/app` — NewControllerInitializers
lists each controller's constructor; the manager shares one InformerFactory
across all of them (the reference shares one SharedInformerFactory) and runs
only while holding the leadership lease.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..client.informers import InformerFactory
from ..client.leaderelection import (
    LeaderElectionConfig,
    LeaderElector,
)
from ..controllers.base import Controller
from ..controllers.infra import (
    DisruptionController,
    EndpointSliceController,
    EndpointsController,
    GarbageCollector,
    NamespaceController,
    NodeLifecycleController,
    PodGCController,
    ResourceQuotaController,
)
from ..controllers.autoscale import (
    AttachDetachController,
    HorizontalPodAutoscalerController,
    NodeIpamController,
    VolumeExpansionController,
)
from ..controllers.certificates import (
    BootstrapSignerController,
    ClusterRoleAggregationController,
    CSRApprovingController,
    CSRSigningController,
    TokenCleanerController,
)
from ..controllers.workloads import (
    CronJobController,
    DaemonSetController,
    DeploymentController,
    JobController,
    TTLAfterFinishedController,
    ReplicaSetController,
    StatefulSetController,
)

DEFAULT_CONTROLLERS: Dict[str, Callable] = {
    "replicaset": lambda c, f: ReplicaSetController(c, f),
    "replicationcontroller": lambda c, f: ReplicaSetController(
        c, f, attr="replicationcontrollers", owner_kind="ReplicationController"),
    "deployment": DeploymentController,
    "statefulset": StatefulSetController,
    "daemonset": DaemonSetController,
    "job": JobController,
    "cronjob": CronJobController,
    "endpoints": EndpointsController,
    "endpointslice": EndpointSliceController,
    "ttlafterfinished": TTLAfterFinishedController,
    "nodelifecycle": NodeLifecycleController,
    "namespace": NamespaceController,
    "garbagecollector": GarbageCollector,
    "podgc": PodGCController,
    "disruption": DisruptionController,
    "resourcequota": ResourceQuotaController,
    "horizontalpodautoscaler": HorizontalPodAutoscalerController,
    "attachdetach": AttachDetachController,
    "volumeexpand": VolumeExpansionController,
    "nodeipam": NodeIpamController,
    "csrsigning": CSRSigningController,
    "csrapproving": CSRApprovingController,
    "clusterroleaggregation": ClusterRoleAggregationController,
    "tokencleaner": TokenCleanerController,
    "bootstrapsigner": BootstrapSignerController,
}


class ControllerManager:
    """Run a set of controllers over one shared informer factory."""

    def __init__(self, client, controllers: Optional[List[str]] = None,
                 leader_elect: bool = False,
                 poll_interval: float = 1.0):
        self.client = client
        self.factory = InformerFactory(client)
        names = controllers or list(DEFAULT_CONTROLLERS)
        self.controllers: Dict[str, Controller] = {
            n: DEFAULT_CONTROLLERS[n](client, self.factory) for n in names}
        self.poll_interval = poll_interval
        self._stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        self.elector: Optional[LeaderElector] = None
        if leader_elect:
            self.elector = LeaderElector(client, LeaderElectionConfig(
                lock_name="kube-controller-manager",
                on_started_leading=self._start_controllers,
                on_stopped_leading=self._stop_controllers))

    # -- lifecycle ---------------------------------------------------------- #

    def start(self) -> "ControllerManager":
        self.factory.start()
        self.factory.wait_for_sync()
        if self.elector is not None:
            self.elector.start()
        else:
            self._start_controllers()
        return self

    def _start_controllers(self) -> None:
        if self._stop.is_set():
            self._stop = threading.Event()  # leadership regained: new term
        for c in self.controllers.values():
            c.start()
        self._poll_thread = threading.Thread(
            target=self._poll_loop, args=(self._stop,), daemon=True,
            name="cm-poll")
        self._poll_thread.start()
        # initial full resync: every controller sees every object
        self.resync()

    def _poll_loop(self, stop: threading.Event) -> None:
        """Periodic sweeps for poll-driven controllers (node monitor 5 s,
        cronjob 10 s, podgc 20 s in the reference). `stop` is this term's
        event so a previous term's poll thread exits on leadership change.
        Every 10th tick also re-enqueues everything — the informer resync
        that repairs any event-ordering gap (shared_informer resyncPeriod)."""
        tick = 0
        while not stop.wait(self.poll_interval):
            tick += 1
            if tick % 10 == 0:
                try:
                    self.resync()
                except Exception:  # noqa: BLE001
                    pass
            for name in ("nodelifecycle", "cronjob", "podgc", "job",
                         "ttlafterfinished", "daemonset", "tokencleaner"):
                c = self.controllers.get(name)
                if c is not None and hasattr(c, "poll_once"):
                    try:
                        c.poll_once()
                    except Exception:  # noqa: BLE001
                        pass
            gc = self.controllers.get("garbagecollector")
            if gc is not None:
                gc.sweep()

    def resync(self) -> None:
        for c in self.controllers.values():
            if isinstance(c, GarbageCollector):
                c.sweep()
                continue
            informers = [getattr(c, a) for a in dir(c) if a.endswith("_informer")]
            for inf in informers:
                for o in inf.lister.list():
                    c.enqueue(o)

    def _stop_controllers(self) -> None:
        self._stop.set()
        for c in self.controllers.values():
            c.stop()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=2)

    def stop(self) -> None:
        if self.elector is not None:
            self.elector.stop()
        self._stop_controllers()
        self.factory.stop()

    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Test helper: wait until every controller queue drains."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(len(c.queue) == 0 for c in self.controllers.values()):
                time.sleep(0.15)
                if all(len(c.queue) == 0 for c in self.controllers.values()):
                    return True
            time.sleep(0.05)
        return False
