"""The slice as a whole: the port's apiserver, ControllerManager,
SchedulerServer (on the CPU) and kubemark's hollow nodes together, held
against the JAX package's.

tests/test_e2e.py's cases, each run on both packages (tests/test_torch_twin.py
`mirror`): a Deployment rolled out to Running pods, a Job completed through
the fake CRI's exit, an unschedulable pod scheduled once a node fits, node
affinity, the FailedScheduling event, readiness and liveness probes, memory
pressure eviction and its taint, the kubelet's checkpoint, an evicted pod's
status write retried. The reference's own assertions hold on the port, and
the set of creates and Bindings the apiserver accepted from every thread
(the case's, the controllers', the kubelets', the scheduler's), with the
deletes the case made, is the same on both (tests/test_torch_twin.py
WriteLog). All host code: equality is exact.
"""

from test_torch_twin import mirror

mirror(globals(), "test_e2e", writes=True,
       subs=[("SchedulerServer(client)",
              "SchedulerServer(client, device='cpu')")])
