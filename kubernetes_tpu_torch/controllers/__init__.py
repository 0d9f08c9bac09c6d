"""Controllers: desired-state convergence loops.

The port's copy of the JAX package's controllers/: analog of SURVEY.md
layer 6 (`pkg/controller`, `cmd/kube-controller-manager`).
"""

from ..controllers.base import (
    Controller,
    is_pod_active,
    is_pod_ready,
    pod_from_template,
)
from ..controllers.infra import (
    DisruptionController,
    EndpointSliceController,
    EndpointsController,
    GarbageCollector,
    NamespaceController,
    NodeLifecycleController,
    PodGCController,
    ResourceQuotaController,
    TAINT_NOT_READY,
    TAINT_UNREACHABLE,
)
from ..controllers.manager import (
    ControllerManager,
    DEFAULT_CONTROLLERS,
)
from ..controllers.workloads import (
    CronJobController,
    DaemonSetController,
    DeploymentController,
    JobController,
    ReplicaSetController,
    StatefulSetController,
    TTLAfterFinishedController,
    pod_template_hash,
)

__all__ = [
    "Controller", "ControllerManager", "CronJobController",
    "DaemonSetController", "DEFAULT_CONTROLLERS", "DeploymentController",
    "DisruptionController", "EndpointSliceController", "EndpointsController",
    "GarbageCollector",
    "JobController", "NamespaceController", "NodeLifecycleController",
    "PodGCController", "ReplicaSetController", "ResourceQuotaController",
    "StatefulSetController", "TAINT_NOT_READY", "TAINT_UNREACHABLE",
    "TTLAfterFinishedController",
    "is_pod_active", "is_pod_ready", "pod_from_template", "pod_template_hash",
]
