"""The port's cluster bootstrap policy (kubernetes_tpu_torch/cli/cluster.py
`_seed_rbac_policy`), held against the JAX package's.

tests/test_host_pipeline.py's cluster case, TestSatellites::
test_rbac_confines_bootstrap_tokens, run on both packages
(tests/test_torch_twin.py `mirror`): the authenticated topology's seeded
RBAC lets a bootstrap token post and read CSRs and read
kube-public/cluster-info, and nothing else, and every decision the
RBAC authorizer made is the same on both. The case builds no scheduler, so it needs no device.
"""

from test_torch_twin import mirror

mirror(globals(), "test_host_pipeline",
       select=lambda cls, name: (cls, name) == (
           "TestSatellites", "test_rbac_confines_bootstrap_tokens"),
       record=["apiserver.auth.RBACAuthorizer.authorize",
               "cli.cluster.Cluster._seed_rbac_policy"])
