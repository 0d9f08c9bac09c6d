"""CLI + cluster bootstrap.

The port's copy of the JAX package's cli/: analog of SURVEY.md layer 10
(`staging/src/k8s.io/kubectl`, `cmd/kubeadm`). `Cluster` stands the
control plane up in one process; its scheduler runs on the card unless
`ClusterConfig(device="cpu")` names the CPU. explain.py holds the
field-documentation tree /openapi/v2 is built from.
"""

from ..cli.cluster import Cluster, ClusterConfig
from ..cli.kubectl import Kubectl, main

__all__ = ["Cluster", "ClusterConfig", "Kubectl", "main"]
