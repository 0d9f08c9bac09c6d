"""HollowCluster: N hollow nodes (real Kubelet + FakeCRI) in one process.

`cmd/kubemark/hollow-node.go` builds exactly this shape: the production
kubelet object wired to cadvisortest/fakeiptables/fakeexec doubles; the
control plane cannot tell hollow nodes from real ones. Here each hollow node
is a Kubelet thread bundle sharing one API client.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..kubelet.cri import FakeCRI
from ..kubelet.kubelet import Kubelet


class HollowCluster:
    def __init__(self, client, n_nodes: int,
                 name_prefix: str = "hollow-node",
                 capacity: Optional[Dict[str, str]] = None,
                 labels_fn=None,
                 heartbeat_interval: float = 5.0,
                 housekeeping_interval: float = 0.5,
                 cri_socket: Optional[str] = None):
        """`cri_socket` switches every hollow kubelet from an in-process
        FakeCRI to dialing a shared runtime over the unix-socket boundary
        (kubelet/criserver.py) — the configuration where the kubelet and the
        runtime genuinely sit in different processes."""
        self.client = client
        self.kubelets: List[Kubelet] = []
        for i in range(n_nodes):
            name = f"{name_prefix}-{i}"
            labels = labels_fn(i) if labels_fn else {}
            if cri_socket:
                from ..kubelet.criserver import RemoteCRI

                cri = RemoteCRI(cri_socket)
            else:
                cri = FakeCRI()
            self.kubelets.append(Kubelet(
                client, name,
                capacity=dict(capacity or {"cpu": "8", "memory": "16Gi",
                                           "pods": "110"}),
                labels=labels,
                cri=cri,
                heartbeat_interval=heartbeat_interval,
                housekeeping_interval=housekeeping_interval))

    def start(self) -> "HollowCluster":
        for k in self.kubelets:
            k.start()
        return self

    def stop(self) -> None:
        for k in self.kubelets:
            k.stop()

    def __len__(self) -> int:
        return len(self.kubelets)
