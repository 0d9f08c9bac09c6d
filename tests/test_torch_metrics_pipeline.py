"""The port's resource-metrics pipeline (kubernetes_tpu_torch/component/
metrics_server.py behind the port's aggregator, the hollow kubelets'
stats_summary, the HPA's metrics client, `kubectl top`), held against the
JAX package's.

tests/test_metrics_pipeline.py's cases, each run on both packages
(tests/test_torch_twin.py `mirror`, every SchedulerServer on the CPU): the
reference's own assertions hold on the port, every kubectl verb returned
the same on both, and the set of creates and Bindings the apiserver
accepted from every thread, with the deletes the case made, is the same on
both (WriteLog), as are the metrics server's start, install, scrape and
stop calls the case made. Each package's metrics server registers its
backend in its own aggregator's registry, so neither run can answer the
other's metrics.k8s.io requests.
"""

from test_torch_cli import KUBECTL_VERBS
from test_torch_twin import mirror

mirror(globals(), "test_metrics_pipeline", writes=True,
       record=[f"cli.kubectl.Kubectl.{v}" for v in KUBECTL_VERBS]
       + [f"component.metrics_server.MetricsServer.{m}"
          for m in ("start", "install", "scrape_once", "stop")],
       subs=[("SchedulerServer(client)",
              "SchedulerServer(client, device='cpu')"),
             ("SchedulerServer(client, telemetry_port=0)",
              "SchedulerServer(client, telemetry_port=0, device='cpu')")])


def test_backends_sit_in_each_packages_own_registry():
    """The two aggregators' local-backend registries are separate objects:
    a metrics server of one package is invisible to the other's."""
    from kubernetes_tpu.apiserver import aggregator as jagg
    from kubernetes_tpu_torch.apiserver import aggregator as tagg

    assert jagg._LOCAL_BACKENDS is not tagg._LOCAL_BACKENDS
    tagg.register_local_backend("v1beta1.metrics.k8s.io", lambda *a: None)
    try:
        assert "v1beta1.metrics.k8s.io" not in jagg._LOCAL_BACKENDS
    finally:
        tagg.unregister_local_backend("v1beta1.metrics.k8s.io")
