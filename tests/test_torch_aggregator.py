"""The port's aggregation layer (kubernetes_tpu_torch/apiserver/
aggregator.py, routed from apiserver/server.py for a group no local
registry serves), held against the JAX package's.

tests/test_aggregator_debugger.py's aggregator cases, each run on both
packages (tests/test_torch_twin.py `mirror`): an unclaimed group stays 404,
an APIService proxies to a local backend and over HTTP, an unreachable
backend answers 503. Every request and proxied answer is the same on both.
Its cache-debugger cases wait for the port's sched/debugger.py. All host
code: equality is exact.
"""

from test_torch_twin import mirror

mirror(globals(), "test_aggregator_debugger",
       select=lambda cls, name: cls == "TestAggregator",
       record=["apiserver.server.handle_rest", "apiserver.aggregator.proxy",
               "apiserver.aggregator.find_apiservice"])
