"""The port's scheduler process under scheduler_perf's density shapes, held
against the JAX package's.

tests/test_perf_integration.py's cases, each run on both packages
(tests/test_torch_twin.py `mirror`, every SchedulerServer on the CPU), with
the reference's floors as they are: 3,000 pods over 100 nodes at no less
than PERF_MIN_THROUGHPUT (60 pods/s) on each, the steady-state wave
latency bound, the kubemark hollow-node density case (a Deployment fanned
out to Running through the controllers and hollow kubelets), and the bench
stages' cycle budgets. The set of creates and Bindings the apiserver
accepted through a client (the scheduler's Bindings, the controllers' and
kubelets' writes), with the deletes the case made, is the same on both
(WriteLog).
"""

from test_torch_twin import mirror

mirror(globals(), "test_perf_integration", writes=True,
       subs=[("client, cycle_interval=0.01, batch_window=0.1)",
              "client, cycle_interval=0.01, batch_window=0.1, device='cpu')"),
             ("SchedulerServer(client, cycle_interval=0.01, batch_window=0.05)",
              "SchedulerServer(client, cycle_interval=0.01, batch_window=0.05,"
              " device='cpu')")])
