"""The port's admission chain, authentication and RBAC
(kubernetes_tpu_torch/apiserver/auth.py) and CustomResourceDefinitions
(apiserver/crd.py, the conversion chokepoint in apiserver/server.py), held
against the JAX package's.

tests/test_admission_auth_crd.py's cases, each run on both packages
(tests/test_torch_twin.py `mirror`): namespace lifecycle, default
tolerations, priority classes, LimitRange, ResourceQuota (also under
concurrent creates), PDB-guarded eviction, RBAC in process and over HTTP,
CRD registration with schema validation, multi-version conversion through a
webhook and with strategy None, unserved storage versions, a CRD across an
apiserver restart, its update and delete. Every store call, apiserver
request, authorization decision and CRD conversion returns the same object,
status code or verdict on both. All host code: equality is exact.
"""

from test_torch_twin import mirror

mirror(globals(), "test_admission_auth_crd", record=[
    "apiserver.server.handle_rest", "apiserver.registry.Store.create",
    "apiserver.registry.Store.get", "apiserver.registry.Store.list",
    "apiserver.registry.Store.update", "apiserver.registry.Store.delete",
    "apiserver.auth.RBACAuthorizer.authorize",
    "apiserver.auth.TokenAuthenticator.authenticate",
    "apiserver.auth.AuthGate.check", "apiserver.crd.ConversionEntry.convert",
    "client.rest.HTTPTransport.request"])
