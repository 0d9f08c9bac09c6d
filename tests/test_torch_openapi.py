"""The port's OpenAPI document (kubernetes_tpu_torch/apiserver/openapi.py,
over cli/explain.py's field tree, served at /openapi/v2), held against the
JAX package's.

tests/test_openapi.py's cases, each run on both packages
(tests/test_torch_twin.py `mirror`): a definition and paths for every
served resource, the curated descriptions, a plain HTTP client reading the
document, a CRD's schema on install. build_openapi and find_definition
return the same document on both. Beyond them: the whole document of a
fresh apiserver, and after a CRD install, is equal across packages, and so
is the explain tree. All host code: equality is exact.
"""

from test_torch_twin import mirror, norm

from kubernetes_tpu.apiserver import APIServer as JAPIServer
from kubernetes_tpu.apiserver import openapi as jopenapi
from kubernetes_tpu.cli import explain as jexplain
from kubernetes_tpu_torch.apiserver import APIServer as TAPIServer
from kubernetes_tpu_torch.apiserver import openapi as topenapi
from kubernetes_tpu_torch.cli import explain as texplain

mirror(globals(), "test_openapi", record=[
    "apiserver.openapi.build_openapi", "apiserver.openapi.find_definition",
    "apiserver.server.handle_rest"])

CRD = {"apiVersion": "apiextensions.k8s.io/v1",
       "kind": "CustomResourceDefinition",
       "metadata": {"name": "widgets.example.com"},
       "spec": {"group": "example.com", "scope": "Namespaced",
                "names": {"plural": "widgets", "kind": "Widget"},
                "versions": [{"name": "v1", "served": True, "storage": True,
                              "schema": {"openAPIV3Schema": {
                                  "type": "object",
                                  "properties": {"spec": {
                                      "type": "object",
                                      "properties": {"size": {
                                          "type": "integer"}}}}}}}]}}


def test_whole_document_matches():
    docs = []
    for APIServer, openapi in ((JAPIServer, jopenapi),
                               (TAPIServer, topenapi)):
        api = APIServer()
        try:
            before = openapi.build_openapi(api)
            api.store("apiextensions.k8s.io",
                      "customresourcedefinitions").create("", CRD)
            docs.append((before, openapi.build_openapi(api)))
        finally:
            api.close()
    (jb, ja), (tb, ta) = docs
    assert norm(tb) == norm(jb)
    assert norm(ta) == norm(ja)
    assert ta["definitions"] != tb["definitions"]


def test_explain_tree_matches():
    assert texplain._TREE == jexplain._TREE
    for res, path in (("pods", []), ("pods", ["spec"]),
                      ("pods", ["spec", "containers"]), ("nodes", []),
                      ("deployments", ["spec"]), ("nosuch", []),
                      ("pods", ["nosuch"])):
        assert texplain.explain_text(res, "", "v1", path) == \
            jexplain.explain_text(res, "", "v1", path)
