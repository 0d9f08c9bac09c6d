"""Client machinery: the typed client, informers, the watch multiplexer the
fleet's watch plane rides, events, leader election (a copy of the JAX
package's client/, less its workqueues, which the scheduler does not use:
ROADMAP A11b, second half)."""

from .events import EventRecorder
from .informers import (
    Indexer,
    InformerFactory,
    Lister,
    SharedInformer,
    pods_by_node_index,
)
from .leaderelection import LeaderElectionConfig, LeaderElector
from .rest import Client, HTTPTransport, LocalTransport, ResourceClient, RetryPolicy
from .watchmux import TENANT_LABEL, MuxRoute, WatchMux

__all__ = [
    "Client", "EventRecorder", "HTTPTransport", "Indexer", "InformerFactory",
    "LeaderElectionConfig", "LeaderElector", "Lister", "LocalTransport",
    "MuxRoute", "ResourceClient", "RetryPolicy", "SharedInformer",
    "TENANT_LABEL", "WatchMux", "pods_by_node_index",
]
