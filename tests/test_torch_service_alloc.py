"""The port's ClusterIP/NodePort allocation
(kubernetes_tpu_torch/apiserver/service_alloc.py, the last plugin of
admission.py's default chain), held against the JAX package's.

tests/test_service_alloc.py's cases, each run on both packages
(tests/test_torch_twin.py `mirror`): allocation within the CIDR and the
port range, headless services, a requested IP or port and its conflict,
release on delete and on update, the repair from storage after a restart,
the refusals. Every apiserver request and allocator call returns the same
address, port or status code on both. Beyond them: the two default
admission chains name the same plugins in the same order. All host code:
equality is exact.
"""

from test_torch_twin import mirror

from kubernetes_tpu.apiserver import admission as jadm
from kubernetes_tpu_torch.apiserver import admission as tadm

mirror(globals(), "test_service_alloc", record=[
    "apiserver.server.handle_rest", "apiserver.registry.Store.create",
    "apiserver.registry.Store.update", "apiserver.registry.Store.delete",
    "apiserver.service_alloc.IPAllocator.allocate",
    "apiserver.service_alloc.PortAllocator.allocate",
    "apiserver.service_alloc.repair"])


def test_default_admission_chain_matches():
    names = lambda m: [type(p).__name__ for p in m.default_plugins()]  # noqa: E731
    assert names(tadm) == names(jadm)
    assert names(tadm)[-1] == "ServiceAllocatorPlugin"
