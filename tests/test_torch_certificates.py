"""The port's credential controllers (kubernetes_tpu_torch/controllers/
certificates.py: the cluster CA, CSR signing and approving, ClusterRole
aggregation, bootstrap tokens, the token cleaner and the bootstrap signer),
held against the JAX package's.

tests/test_certificates.py's cases, each run on both packages
(tests/test_torch_twin.py `mirror`): the reference's own assertions hold on
the port; the set of creates the apiserver accepted from every thread,
with the deletes the case made, is the same on both
(tests/test_torch_twin.py WriteLog), as is every answer of the
bootstrap-token authenticator (a token's random id and secret scrubbed).
The X.509 cases skip, on both, where `cryptography` is missing, as the
reference's do. TestKubeadmJoinTLSBootstrap's two cases stand a Cluster up
(cli/cluster.py), its scheduler on the CPU (`device='cpu'`), and join
nodes through TLS bootstrap.
"""

from test_torch_twin import mirror

mirror(globals(), "test_certificates",
       subs=[("Cluster(ClusterConfig(\n",
              "Cluster(ClusterConfig(device='cpu',\n")],
       writes=True,
       scrub=[(r"\b[0-9a-z]{6}\.[0-9a-z]{16}\b", "<token>"),
              (r"(bootstrap-token-|bootstrap:)[0-9a-z]{6}\b", r"\1<id>")],
       record=["controllers.certificates.BootstrapTokenAuthenticator"
               ".authenticate"])
