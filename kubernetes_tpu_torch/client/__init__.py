"""Client machinery: the typed client, informers, workqueues, the watch
multiplexer the fleet's watch plane rides, events, leader election (a copy
of the JAX package's client/)."""

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
from .workqueue import DelayingQueue, RateLimiter, RateLimitingQueue, WorkQueue

__all__ = [
    "Client", "DelayingQueue", "EventRecorder", "HTTPTransport", "Indexer",
    "InformerFactory", "LeaderElectionConfig", "LeaderElector", "Lister",
    "LocalTransport", "MuxRoute", "RateLimiter", "RateLimitingQueue",
    "ResourceClient", "RetryPolicy", "SharedInformer", "TENANT_LABEL",
    "WatchMux", "WorkQueue", "pods_by_node_index",
]
