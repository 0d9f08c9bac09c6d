"""The port's patch dialects (kubernetes_tpu_torch/machinery/strategicpatch.py
and registry.py's `patch(patch_type="strategic"|"json")`), held against the
JAX package's.

tests/test_strategicpatch.py's cases, each run on both packages
(tests/test_torch_twin.py `mirror`): strategic merge by patch merge key,
the $patch / $deleteFromPrimitiveList / $setElementOrder / $retainKeys
directives, RFC 6902 op lists, the three dialects served by the apiserver,
the 415 for a strategic patch on a custom resource, a CR patched at its
request version through the conversion chokepoint. Every merge, op list and
apiserver request returns the same object or the same status code on both.
Its `kubectl apply` cases wait for the CLI (ROADMAP A17). All host code:
equality is exact.
"""

import copy

import pytest
from test_torch_twin import mirror, norm

from kubernetes_tpu.machinery import strategicpatch as jsp
from kubernetes_tpu_torch.machinery import strategicpatch as tsp

RECORD = ["machinery.strategicpatch.strategic_merge",
          "machinery.strategicpatch.json_patch",
          "apiserver.server.handle_rest", "apiserver.registry.Store.create",
          "apiserver.registry.Store.get", "apiserver.registry.Store.patch",
          "apiserver.registry.Store.update"]

mirror(globals(), "test_strategicpatch", record=RECORD,
       select=lambda cls, name: "apply" not in name)

POD = {"apiVersion": "v1", "kind": "Pod",
       "metadata": {"name": "p", "labels": {"a": "1", "b": "2"}},
       "spec": {"containers": [
           {"name": "c0", "image": "i0", "ports": [{"containerPort": 80}],
            "env": [{"name": "A", "value": "1"}]},
           {"name": "c1", "image": "i1"}],
           "volumes": [{"name": "v0", "emptyDir": {}}],
           "tolerations": [{"key": "k", "operator": "Exists"}]}}

PATCHES = [
    {"spec": {"containers": [{"name": "c1", "image": "i1b"}]}},
    {"spec": {"containers": [{"name": "c2", "image": "i2"}]}},
    {"spec": {"containers": [{"name": "c0", "$patch": "delete"}]}},
    {"spec": {"containers": [{"name": "c0", "env": [
        {"name": "B", "value": "2"}]}]}},
    {"metadata": {"labels": {"a": None, "c": "3"}}},
    {"spec": {"$setElementOrder/containers": [{"name": "c1"},
                                               {"name": "c0"}]}},
    {"spec": {"volumes": [{"name": "v1", "hostPath": {"path": "/x"}}]}},
    {"spec": {"tolerations": [{"key": "z", "operator": "Exists"}]}},
]

OPS = [
    [{"op": "add", "path": "/metadata/labels/c", "value": "3"}],
    [{"op": "remove", "path": "/spec/containers/1"}],
    [{"op": "replace", "path": "/spec/containers/0/image", "value": "x"}],
    [{"op": "test", "path": "/metadata/name", "value": "q"}],
    [{"op": "move", "from": "/metadata/labels/a",
      "path": "/metadata/labels/z"}],
    [{"op": "copy", "from": "/spec/containers/0",
      "path": "/spec/containers/-"}],
    [{"op": "add", "path": "/spec/containers/9", "value": {}}],
]


def outcome(fn, *args):
    try:
        return norm(fn(*copy.deepcopy(args)))
    except Exception as e:  # noqa: BLE001 - compared by class and code
        return norm(e)


@pytest.mark.parametrize("i", range(len(PATCHES)))
def test_strategic_merge_same_object(i):
    assert outcome(tsp.strategic_merge, POD, PATCHES[i]) == \
        outcome(jsp.strategic_merge, POD, PATCHES[i])


@pytest.mark.parametrize("i", range(len(OPS)))
def test_json_patch_same_object_or_error(i):
    assert outcome(tsp.json_patch, POD, OPS[i]) == \
        outcome(jsp.json_patch, POD, OPS[i])
