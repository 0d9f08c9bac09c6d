"""Node agent: kubelet, fake CRI, checkpoint manager.

The port's copy of the JAX package's kubelet/: analog of SURVEY.md layer 8
(`pkg/kubelet`, `cmd/kubelet`, `staging/src/k8s.io/cri-api`).
"""

from ..kubelet.checkpoint import (
    CheckpointManager,
    CorruptCheckpointError,
)
from ..kubelet.cri import (
    CONTAINER_CREATED,
    CONTAINER_EXITED,
    CONTAINER_RUNNING,
    FakeCRI,
)
from ..kubelet.kubelet import Kubelet

__all__ = ["CheckpointManager", "CorruptCheckpointError",
           "CONTAINER_CREATED", "CONTAINER_EXITED", "CONTAINER_RUNNING",
           "FakeCRI", "Kubelet"]
