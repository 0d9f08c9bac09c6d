"""Client machinery: the typed client, informers, events, leader election
(a copy of the JAX package's client/, less its watch multiplexer and
workqueues, which the scheduler does not use: ROADMAP A11b, second half)."""

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

__all__ = [
    "Client", "EventRecorder", "HTTPTransport", "Indexer", "InformerFactory",
    "LeaderElectionConfig", "LeaderElector", "Lister", "LocalTransport",
    "ResourceClient", "RetryPolicy", "SharedInformer", "pods_by_node_index",
]
