"""metrics-server: the resource-metrics API (metrics.k8s.io/v1beta1),
served through the aggregation layer.

The reference's HPA never reads kubelet stats directly: the kubelet serves
/stats/summary, the out-of-tree metrics-server scrapes every node, and the
aggregator exposes the result as PodMetrics/NodeMetrics under
`metrics.k8s.io` (an APIService), which the HPA's metrics client queries
(`pkg/controller/podautoscaler/horizontal.go:96` via
`pkg/controller/podautoscaler/metrics`). This module fills the
metrics-server seat:

  * scrapes a set of kubelets' `stats_summary()` on an interval,
  * registers APIService `v1beta1.metrics.k8s.io` with an in-process
    backend (apiserver/aggregator.py `register_local_backend` — the same
    deviation family as PARITY #13: backends are in-process handles, not
    cluster-IP HTTPS endpoints),
  * serves GET /apis/metrics.k8s.io/v1beta1/{namespaces/{ns}/}pods[/{name}]
    and /nodes[/{name}] in the reference wire shape
    (PodMetrics.containers[].usage {cpu: "Nm", memory: "NKi"}).

So the pipeline is the reference's, end to end: CRI ListContainerStats →
kubelet stats_summary → metrics-server scrape → aggregated API → HPA
metrics client (controllers/autoscale.py ResourceMetricsProvider).

(A copy of the JAX package's component/metrics_server.py. Its backend sits
in the port's own aggregator registry, apart from the JAX package's.)
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..apiserver import aggregator
from ..machinery import errors, meta

Obj = Dict[str, Any]

APISERVICE_NAME = "v1beta1.metrics.k8s.io"
GROUP = "metrics.k8s.io"
VERSION = "v1beta1"


class MetricsServer:
    """Scrape loop + aggregated-API backend."""

    def __init__(self, client,
                 kubelets: Sequence = (),
                 scrape_interval: float = 2.0,
                 clock: Callable[[], float] = time.time):
        self.client = client
        self._kubelets = list(kubelets)
        self.scrape_interval = scrape_interval
        self.clock = clock
        self._mu = threading.Lock()
        # (ns, pod) → PodMetrics;  node → NodeMetrics
        self._pods: Dict[Tuple[str, str], Obj] = {}
        self._nodes: Dict[str, Obj] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_kubelet(self, kubelet) -> None:
        with self._mu:
            self._kubelets.append(kubelet)

    # -- scrape ---------------------------------------------------------- #

    def scrape_once(self) -> None:
        now = meta.now_rfc3339()
        pods: Dict[Tuple[str, str], Obj] = {}
        nodes: Dict[str, Obj] = {}
        with self._mu:
            kubelets = list(self._kubelets)
        for k in kubelets:
            try:
                summary = k.stats_summary()
            except Exception:  # noqa: BLE001 — a dead node skips a window
                continue
            node_cpu = node_mem = 0
            for p in summary.get("pods", []):
                node_cpu += p["cpuMilli"]
                node_mem += p["memoryBytes"]
                pods[(p["namespace"], p["name"])] = {
                    "kind": "PodMetrics",
                    "apiVersion": f"{GROUP}/{VERSION}",
                    "metadata": {"name": p["name"],
                                 "namespace": p["namespace"]},
                    "timestamp": now,
                    "window": f"{self.scrape_interval:g}s",
                    "containers": [
                        {"name": c["name"],
                         "usage": {"cpu": f'{c["cpuMilli"]}m',
                                   "memory":
                                   f'{c["memoryBytes"] // 1024}Ki'}}
                        for c in p.get("containers", [])],
                }
            nodes[summary.get("node", "")] = {
                "kind": "NodeMetrics",
                "apiVersion": f"{GROUP}/{VERSION}",
                "metadata": {"name": summary.get("node", "")},
                "timestamp": now,
                "window": f"{self.scrape_interval:g}s",
                "usage": {"cpu": f"{node_cpu}m",
                          "memory": f"{node_mem // 1024}Ki"},
            }
        with self._mu:
            self._pods = pods
            self._nodes = nodes

    def _loop(self) -> None:
        self.scrape_once()
        while not self._stop.wait(self.scrape_interval):
            self.scrape_once()

    # -- aggregated-API surface ------------------------------------------ #

    def _handle(self, method: str, path: str, query: Dict[str, str],
                body: Optional[Obj]) -> Tuple[int, Obj]:
        if method != "GET":
            raise errors.new_method_not_supported("podmetrics", method)
        parts = [p for p in path.split("/") if p]
        # /apis/metrics.k8s.io/v1beta1/...
        rest = parts[3:]
        ns = ""
        if rest and rest[0] == "namespaces" and len(rest) >= 2:
            ns, rest = rest[1], rest[2:]
        kind = rest[0] if rest else ""
        name = rest[1] if len(rest) > 1 else ""
        with self._mu:
            if kind == "nodes":
                if name:
                    m = self._nodes.get(name)
                    if m is None:
                        raise errors.new_not_found("nodes.metrics.k8s.io",
                                                   name)
                    return 200, m
                return 200, {"kind": "NodeMetricsList",
                             "apiVersion": f"{GROUP}/{VERSION}",
                             "items": sorted(self._nodes.values(),
                                             key=lambda m:
                                             meta.name(m))}
            if kind == "pods":
                if name:
                    m = self._pods.get((ns or "default", name))
                    if m is None:
                        raise errors.new_not_found("pods.metrics.k8s.io",
                                                   name)
                    return 200, m
                items = [m for (pns, _), m in self._pods.items()
                         if not ns or pns == ns]
                return 200, {"kind": "PodMetricsList",
                             "apiVersion": f"{GROUP}/{VERSION}",
                             "items": sorted(items,
                                             key=lambda m: meta.name(m))}
        raise errors.new_not_found("metrics.k8s.io", kind)

    # -- lifecycle ------------------------------------------------------- #

    def install(self) -> "MetricsServer":
        """Register the APIService + in-process backend (the kubectl-visible
        face of metrics-server)."""
        aggregator.register_local_backend(APISERVICE_NAME, self._handle)
        svc = {"apiVersion": "apiregistration.k8s.io/v1",
               "kind": "APIService",
               "metadata": {"name": APISERVICE_NAME},
               "spec": {"group": GROUP, "version": VERSION,
                        "groupPriorityMinimum": 100, "versionPriority": 100}}
        try:
            self.client.resource("apiregistration.k8s.io", "v1",
                                 "apiservices", False).create(svc, "")
        except errors.StatusError as e:
            if not errors.is_already_exists(e):
                raise
        return self

    def start(self) -> "MetricsServer":
        self.install()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="metrics-server-scrape")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        aggregator.unregister_local_backend(APISERVICE_NAME)
        try:
            self.client.resource("apiregistration.k8s.io", "v1",
                                 "apiservices", False).delete(
                                     APISERVICE_NAME, "")
        except errors.StatusError:
            pass
