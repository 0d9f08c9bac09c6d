"""The port's node agent (kubernetes_tpu_torch/kubelet/: the Kubelet over a
CRI, its container manager — allocatable, admission, QoS, the device-plugin
manager, image GC — eviction and the volume manager), held against the JAX
package's.

tests/test_kubelet_cm.py's cases, each run on both packages
(tests/test_torch_twin.py `mirror`; its SchedulerServer on the CPU): the
reference's own assertions hold on the port; every call the case makes into
the container, device-plugin and image-GC managers answers the same (pod
uids scrubbed); and the set of creates and Bindings the apiserver accepted
from every thread (the case's, the kubelets', the controllers', the
scheduler's), with the deletes the case made, is the same on both
(tests/test_torch_twin.py WriteLog). All host code: equality is exact.
"""

from test_torch_twin import mirror

mirror(globals(), "test_kubelet_cm", writes=True,
       subs=[("SchedulerServer(client)",
              "SchedulerServer(client, device='cpu')")],
       record=["kubelet.cm.ContainerManager.allocatable",
               "kubelet.cm.ContainerManager.admit",
               "kubelet.cm.DevicePluginManager.register",
               "kubelet.cm.DevicePluginManager.capacity",
               "kubelet.cm.DevicePluginManager.allocate",
               "kubelet.cm.DevicePluginManager.deallocate",
               "kubelet.cm.DevicePluginManager.allocations",
               "kubelet.cm.ImageGCManager.garbage_collect",
               "kubelet.cm.ImageGCManager.delete_unused_images"],
       scrub=[(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}",
               "<uid>")])
