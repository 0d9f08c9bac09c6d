"""kubemark: hollow nodes at scale.

Analog of `cmd/kubemark/hollow-node.go` + `pkg/kubemark/hollow_kubelet.go`:
real kubelet wiring against fake CRI, many per process, for control-plane
scale testing without machines.
"""

from ..kubemark.hollow import HollowCluster

__all__ = ["HollowCluster"]
