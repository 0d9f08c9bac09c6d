"""The port's CRI boundary (kubernetes_tpu_torch/kubelet/criserver.py: the
RuntimeService on a unix socket, RemoteCRI, `python -m
kubernetes_tpu_torch.kubelet.criserver --socket PATH`), held against the
JAX package's.

tests/test_criserver.py's cases, each run on both packages
(tests/test_torch_twin.py `mirror`; its SchedulerServer on the CPU; its
runtime-process case spawns the port's module on the port's side): the
reference's own assertions hold on the port; every RemoteCRI call the case
makes answers the same (the runtime's random sandbox and container ids and
the containers' clock readings scrubbed); and the set of creates and
Bindings the apiserver accepted from every thread, with the deletes the
case made, is the same on both (tests/test_torch_twin.py WriteLog). All
host code: equality is exact.
"""

from test_torch_twin import mirror

VERBS = ("version", "run_pod_sandbox", "stop_pod_sandbox",
         "remove_pod_sandbox", "create_container", "start_container",
         "stop_container", "remove_container", "container_status",
         "sandbox_for_pod", "tick", "list_stats", "probe", "pull_image",
         "list_images", "remove_image", "image_fs_info", "set_exit_rules")

mirror(globals(), "test_criserver", writes=True,
       subs=[("SchedulerServer(client)",
              "SchedulerServer(client, device='cpu')")],
       record=[f"kubelet.criserver.RemoteCRI.{v}" for v in VERBS],
       scrub=[(r"(sandbox|container)-[0-9a-f]{12}", r"\1-<id>")],
       drop=("started_at", "finished_at"))
