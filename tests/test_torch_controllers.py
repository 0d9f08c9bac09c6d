"""The port's controllers (kubernetes_tpu_torch/controllers/: the workqueue
sync loop of base.py, the workload, infrastructure and autoscaling
controllers, the ControllerManager), held against the JAX package's.

tests/test_controllers.py's cases and tests/test_client.py's
TestControllerRestart, each run on both packages (tests/test_torch_twin.py
`mirror`, its DaemonSet case's SchedulerServer on the CPU): the reference's
own assertions hold on the port, and the set of creates and Bindings the
apiserver accepted from every thread (the case's, the controllers', the
scheduler's), with the deletes the case made, is the same on both
(tests/test_torch_twin.py WriteLog). All host code: equality is exact.

One case is left out: TestVolumeExpansion::test_pvc_growth_expands_pv
rides a race of the reference (its expansion controller writes the claim's
grown status while the PV is not yet in its lister, and the PV then never
grows; ROADMAP §C, C3), which the port closes. tests/test_torch_volume.py
holds both orders of the two events instead.

Beyond the mirror: the DaemonSet controller's node handler on both
packages, a heartbeat-only update included.
"""

import importlib

import pytest
from test_torch_twin import mirror

C3_CASE = ("TestVolumeExpansion", "test_pvc_growth_expands_pv")

mirror(globals(), "test_controllers", writes=True,
       select=lambda cls, name: (cls, name) != C3_CASE,
       subs=[("SchedulerServer(client)",
              "SchedulerServer(client, device='cpu')")])
mirror(globals(), "test_client", writes=True,
       select=lambda cls, name: cls == "TestControllerRestart")


# --------------------------------------------------------------------- #
# the DaemonSet controller's node handler
# --------------------------------------------------------------------- #

def _node(labels=None, taints=None, heartbeat=0):
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": "n0", "labels": dict(labels or {})},
            "spec": {"taints": list(taints or [])},
            "status": {"conditions": [{"type": "Ready", "status": "True",
                                       "lastHeartbeatTime": heartbeat}]}}


@pytest.mark.parametrize("change", ["heartbeat", "labels", "taints"])
def test_daemonset_resyncs_on_node_update(change):
    """Both packages' DaemonSet controllers re-sync every set on every node
    update, a heartbeat that changes neither labels nor taints included
    (the reference's handler; upstream's shouldIgnoreNodeUpdate would skip
    the heartbeat). The node informer's handler is called directly, on a
    controller over an idle apiserver."""
    old = _node({"zone": "a"})
    new = {"heartbeat": _node({"zone": "a"}, heartbeat=5),
           "labels": _node({"zone": "b"}),
           "taints": _node({"zone": "a"}, [{"key": "k",
                                            "effect": "NoSchedule"}])}[change]
    got = {}
    for pkg in ("kubernetes_tpu", "kubernetes_tpu_torch"):
        m = {n: importlib.import_module(f"{pkg}.{n}") for n in (
            "apiserver", "client", "controllers.workloads")}
        api = m["apiserver"].APIServer()
        try:
            client = m["client"].Client.local(api)
            factory = m["client"].InformerFactory(client)
            ctl = m["controllers.workloads"].DaemonSetController(client,
                                                                 factory)
            calls = []
            ctl._enqueue_all = lambda: calls.append(1)
            for _add, on_update, _delete in ctl.node_informer._handlers:
                on_update(old, new)
            got[pkg] = bool(calls)
        finally:
            api.close()
    assert got == {"kubernetes_tpu": True, "kubernetes_tpu_torch": True}
