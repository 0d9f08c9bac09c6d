"""The port's apiserver (kubernetes_tpu_torch/apiserver/) and its storage
(kubernetes_tpu_torch/storage/store.py), held against the JAX package's.

One request script runs through both packages' `handle_rest` on a fresh
APIServer each, and every response is compared field by field, less the
uid and the timestamps (which differ from run to run): CRUD, label and field
selectors, the list order (by key: `p-1`, `p-10`, `p-2`), the binding and
eviction subresources, the Lease fence refusing a stale token, a watch
resumed from a compacted revision answering 410, and the admission chain's
defaults (priority from a PriorityClass, the default tolerations). The
resourceVersions are compared too: both stores count one revision per
write. A second script holds the port's full Storage (watch hub, watch
cache, bookmarks) against the JAX package's Storage over its PyKV:
revisions, events and list order.
"""

import json
import threading
import urllib.request

import pytest

from kubernetes_tpu.apiserver import APIServer as JAPIServer
from kubernetes_tpu.apiserver import handle_rest as j_handle_rest
from kubernetes_tpu.machinery import errors as jerrors
from kubernetes_tpu.storage.native import PyKV as JPyKV
from kubernetes_tpu.storage.store import Storage as JStorage
from kubernetes_tpu_torch.apiserver import APIServer as TAPIServer
from kubernetes_tpu_torch.apiserver import HTTPGateway as THTTPGateway
from kubernetes_tpu_torch.apiserver import handle_rest as t_handle_rest
from kubernetes_tpu_torch.machinery import errors as terrors
from kubernetes_tpu_torch.storage.store import Storage as TStorage

NS = "/api/v1/namespaces/default"
VOLATILE = {"uid", "creationTimestamp", "lastTransitionTime",
            "firstTimestamp", "lastTimestamp", "eventTime", "renewTime",
            "acquireTime", "deletionTimestamp"}

SIDES = {
    "jax": (lambda: JAPIServer(storage=JStorage(kv=JPyKV())),
            j_handle_rest, jerrors.StatusError),
    "port": (TAPIServer, t_handle_rest, terrors.StatusError),
}


def strip(obj):
    """The object less the fields that differ from run to run."""
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [strip(v) for v in obj]
    return obj


def pod(name, labels=None, node="", **spec):
    p = {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": name, "namespace": "default"},
         "spec": {"containers": [{"name": "c", "image": "img",
                                  "resources": {"requests": {
                                      "cpu": "100m", "memory": "64Mi"}}}],
                  **spec}}
    if labels:
        p["metadata"]["labels"] = labels
    if node:
        p["spec"]["nodeName"] = node
    return p


def lease(transitions):
    return {"apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
            "metadata": {"name": "kube-scheduler", "namespace": "kube-system"},
            "spec": {"holderIdentity": "a", "leaseTransitions": transitions}}


def fenced_binding(name, node, token):
    return {"apiVersion": "v1", "kind": "Binding",
            "metadata": {"name": name, "namespace": "default",
                         "annotations": {
                             "ktpu.io/fencing-token": str(token),
                             "ktpu.io/fencing-lease":
                                 "kube-system/kube-scheduler"}},
            "target": {"kind": "Node", "name": node}}


def node(name, cpu="4"):
    return {"apiVersion": "v1", "kind": "Node", "metadata": {
        "name": name, "labels": {"zone": "a" if name < "n2" else "b"}},
        "status": {"capacity": {"cpu": cpu, "memory": "8Gi", "pods": "110"}}}


SCRIPT = [
    # nodes, and pods created out of key order: the list is by key
    ("POST", "/api/v1/nodes", {}, node("n0")),
    ("POST", "/api/v1/nodes", {}, node("n1")),
    ("POST", "/api/v1/nodes", {}, node("n2")),
    ("POST", NS + "/pods", {}, pod("p-2", {"app": "a"})),
    ("POST", NS + "/pods", {}, pod("p-10", {"app": "b"})),
    ("POST", NS + "/pods", {}, pod("p-1", {"app": "a", "tier": "db"})),
    ("POST", NS + "/pods", {}, pod("p-1", {"app": "a"})),        # 409
    ("POST", NS + "/pods", {}, {"apiVersion": "v1", "kind": "Pod",
                                "metadata": {"name": "bad"}, "spec": {}}),
    ("GET", NS + "/pods", {}, None),
    ("GET", "/api/v1/pods", {}, None),
    ("GET", "/api/v1/nodes", {"labelSelector": "zone=a"}, None),
    ("GET", NS + "/pods", {"labelSelector": "app=a"}, None),
    ("GET", NS + "/pods", {"labelSelector": "app in (a,b),!tier"}, None),
    ("GET", NS + "/pods", {"fieldSelector": "metadata.name=p-10"}, None),
    ("GET", NS + "/pods/p-2", {}, None),
    ("GET", NS + "/pods/nope", {}, None),                         # 404
    # update, merge patch, status
    ("PATCH", NS + "/pods/p-2", {}, {"metadata": {"labels": {"x": "1"}}}),
    ("PATCH", "/api/v1/nodes/n0/status", {},
     {"status": {"phase": "Running"}}),
    # admission: a PriorityClass resolves into spec.priority, the default
    # tolerations are added, an unknown class is refused
    ("POST", "/apis/scheduling.k8s.io/v1/priorityclasses", {},
     {"apiVersion": "scheduling.k8s.io/v1", "kind": "PriorityClass",
      "metadata": {"name": "vip"}, "value": 1000}),
    ("POST", NS + "/pods", {}, pod("v-1", {"app": "v"},
                                   priorityClassName="vip")),
    ("POST", NS + "/pods", {}, pod("v-2", priorityClassName="nope")),
    # binding: the scheduler's write; a second one is refused
    ("POST", NS + "/pods/p-1/binding", {},
     {"apiVersion": "v1", "kind": "Binding",
      "metadata": {"name": "p-1", "namespace": "default"},
      "target": {"kind": "Node", "name": "n0"}}),
    ("POST", NS + "/pods/p-1/binding", {},
     {"apiVersion": "v1", "kind": "Binding",
      "metadata": {"name": "p-1", "namespace": "default"},
      "target": {"kind": "Node", "name": "n1"}}),
    ("GET", NS + "/pods", {"fieldSelector": "spec.nodeName=n0"}, None),
    ("GET", NS + "/pods", {"fieldSelector": "spec.nodeName="}, None),
    # the Lease fence: a token older than the Lease's generation is refused,
    # the current one lands
    ("POST", "/apis/coordination.k8s.io/v1/namespaces/kube-system/leases",
     {}, lease(3)),
    ("POST", NS + "/pods/p-2/binding", {}, fenced_binding("p-2", "n1", 2)),
    ("GET", NS + "/pods/p-2", {}, None),
    ("POST", NS + "/pods/p-2/binding", {}, fenced_binding("p-2", "n1", 3)),
    # eviction: a PDB with no disruption left refuses, then one allowed
    ("POST", "/apis/policy/v1beta1/namespaces/default/poddisruptionbudgets",
     {}, {"apiVersion": "policy/v1beta1", "kind": "PodDisruptionBudget",
          "metadata": {"name": "b", "namespace": "default"},
          "spec": {"minAvailable": 1,
                   "selector": {"matchLabels": {"app": "b"}}},
          "status": {"disruptionsAllowed": 0}}),
    ("POST", NS + "/pods/p-10/eviction", {},
     {"apiVersion": "policy/v1beta1", "kind": "Eviction",
      "metadata": {"name": "p-10", "namespace": "default"}}),
    ("PUT", "/apis/policy/v1beta1/namespaces/default/poddisruptionbudgets"
     "/b/status", {}, None),   # body filled from the live object below
    ("POST", NS + "/pods/p-10/eviction", {},
     {"apiVersion": "policy/v1beta1", "kind": "Eviction",
      "metadata": {"name": "p-10", "namespace": "default"}}),
    ("GET", "/apis/policy/v1beta1/namespaces/default/poddisruptionbudgets"
     "/b", {}, None),
    # delete with a stale precondition, then for real
    ("DELETE", NS + "/pods/v-1", {},
     {"preconditions": {"resourceVersion": "1"}}),
    ("DELETE", NS + "/pods/v-1", {}, None),
    ("GET", NS + "/pods", {}, None),
    ("GET", "/api", {}, None),
]


def run_script(side):
    """Every response of SCRIPT on one package: (code, stripped object) or
    ("error", code, reason)."""
    make, handle, status_error = SIDES[side]
    api = make()
    out = []
    try:
        for method, path, query, body in SCRIPT:
            if method == "PUT" and body is None:
                # a status write carrying the live object (CAS on its RV)
                _, cur = handle(api, "GET", path.rsplit("/", 1)[0], {}, None)
                cur["status"] = {"disruptionsAllowed": 1}
                body = cur
            try:
                code, obj = handle(api, method, path, dict(query), body)
                out.append((code, strip(obj)))
            except status_error as e:
                out.append(("error", e.code, e.reason))
    finally:
        api.close()
    return out


def test_request_script_matches_jax():
    jax_out, port_out = run_script("jax"), run_script("port")
    assert len(port_out) == len(SCRIPT)
    for (m, p, _, _), a, b in zip(SCRIPT, jax_out, port_out):
        assert b == a, f"{m} {p}"
    # the script reaches what it is meant to reach
    codes = [o[1] if o[0] == "error" else o[0] for o in port_out]
    assert codes.count(409) == 4 and 404 in codes and 422 in codes
    assert 429 in codes and 403 in codes
    listed = port_out[8][1]["items"]
    assert [i["metadata"]["name"] for i in listed] == ["p-1", "p-10", "p-2"]
    vip = port_out[19][1]
    assert vip["spec"]["priority"] == 1000
    assert {t["key"] for t in vip["spec"]["tolerations"]} == {
        "node.kubernetes.io/not-ready", "node.kubernetes.io/unreachable"}


@pytest.mark.parametrize("side", ["jax", "port"])
def test_watch_resumed_from_a_compacted_revision_answers_410(side):
    make, handle, status_error = SIDES[side]
    api = make()
    try:
        _, first = handle(api, "POST", NS + "/pods", {}, pod("w-1"))
        rv = first["metadata"]["resourceVersion"]
        for i in range(2, 5):
            handle(api, "POST", NS + "/pods", {}, pod(f"w-{i}"))
        # a resume within history replays what came after
        tag, w = handle(api, "GET", NS + "/pods",
                        {"watch": "true", "resourceVersion": rv}, None)
        assert tag == "WATCH"
        seen = [w.next(timeout=2) for _ in range(3)]
        w.stop()
        assert [(e.type, e.object["metadata"]["name"]) for e in seen] == [
            ("ADDED", "w-2"), ("ADDED", "w-3"), ("ADDED", "w-4")]
        api.storage.compact_to(api.storage.kv.rev())
        with pytest.raises(status_error) as ei:
            handle(api, "GET", NS + "/pods",
                   {"watch": "true", "resourceVersion": rv}, None)
        assert ei.value.code == 410
    finally:
        api.close()


def test_watch_streams_and_410_match_jax():
    """The same watch on both packages: the events of a write sequence, in
    order, with their resourceVersions; then the compacted resume."""
    got = {}
    for side in SIDES:
        make, handle, status_error = SIDES[side]
        api = make()
        try:
            tag, w = handle(api, "GET", NS + "/pods",
                            {"watch": "true", "labelSelector": "app=a"},
                            None)
            handle(api, "POST", NS + "/pods", {}, pod("a-1", {"app": "a"}))
            handle(api, "POST", NS + "/pods", {}, pod("b-1", {"app": "b"}))
            handle(api, "PATCH", NS + "/pods/a-1", {},
                   {"metadata": {"annotations": {"k": "v"}}})
            handle(api, "DELETE", NS + "/pods/a-1", {}, None)
            evs = [w.next(timeout=2) for _ in range(3)]
            w.stop()
            rv = evs[0].object["metadata"]["resourceVersion"]
            api.storage.compact_to(api.storage.kv.rev())
            try:
                handle(api, "GET", NS + "/pods",
                       {"watch": "true", "resourceVersion": str(int(rv) - 1)},
                       None)
                refused = None
            except status_error as e:
                refused = (e.code, e.reason)
            got[side] = ([(e.type, strip(e.object)) for e in evs], refused)
        finally:
            api.close()
    assert got["port"] == got["jax"]
    assert got["port"][1] == (410, "Expired")


def test_http_gateway_serves_the_same_objects():
    """The port's HTTPGateway: JSON in and out, a 404 Status, and a chunked
    watch stream of {"type", "object"} lines."""
    api = TAPIServer()
    gw = THTTPGateway(api).start()
    try:
        req = urllib.request.Request(
            gw.url + NS + "/pods", method="POST",
            data=json.dumps(pod("h-1")).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 201
            created = json.loads(r.read())
        with urllib.request.urlopen(gw.url + NS + "/pods/h-1",
                                    timeout=10) as r:
            assert json.loads(r.read()) == created
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(gw.url + NS + "/pods/nope", timeout=10)
        assert ei.value.code == 404
        assert json.loads(ei.value.read())["reason"] == "NotFound"
        lines = []

        def read_watch():
            url = (gw.url + NS + "/pods?watch=true&timeoutSeconds=5"
                   f"&resourceVersion={created['metadata']['resourceVersion']}")
            with urllib.request.urlopen(url, timeout=10) as r:
                for raw in r:
                    lines.append(json.loads(raw))
                    if len(lines) == 1:
                        return

        t = threading.Thread(target=read_watch)
        t.start()
        api.store("", "pods").create("default", pod("h-2"))
        t.join(timeout=10)
        assert lines and lines[0]["type"] == "ADDED"
        assert lines[0]["object"]["metadata"]["name"] == "h-2"
    finally:
        gw.stop()
        api.close()


def _storage_script(st):
    """One event script on a Storage: revisions, list order, the events a
    watcher from revision 0 sees (the watch cache's replay, then live)."""
    out = []
    w = st.watch("/registry/pods/", since_rv="0")
    for name in ("default/p-2", "default/p-10", "kube-system/p-1",
                 "default/p-1"):
        o = st.create(f"/registry/pods/{name}", {
            "metadata": {"name": name.split("/")[1],
                         "namespace": name.split("/")[0]}}, "pods")
        out.append(("create", o["metadata"]["resourceVersion"]))
    out.append(("conflict", _code(lambda: st.create(
        "/registry/pods/default/p-1", {"metadata": {"name": "p-1"}},
        "pods"))))

    def bump(o):
        o.setdefault("spec", {})["nodeName"] = "n1"
        return o

    o = st.guaranteed_update("/registry/pods/default/p-2", bump, "pods")
    out.append(("update", o["metadata"]["resourceVersion"]))
    out.append(("stale", _code(lambda: st.guaranteed_update(
        "/registry/pods/default/p-2", bump, "pods", expected_rv="1"))))
    d = st.delete("/registry/pods/default/p-10", "pods")
    out.append(("delete", d["metadata"]["resourceVersion"]))
    out.append(("gone", _code(lambda: st.get("/registry/pods/default/p-10",
                                              "pods"))))
    items, rv = st.list("/registry/pods/")
    out.append(("list", rv, [(i["metadata"]["namespace"],
                              i["metadata"]["name"],
                              i["metadata"]["resourceVersion"])
                             for i in items]))
    items, rv = st.list("/registry/pods/default/")
    out.append(("list-ns", rv, [i["metadata"]["name"] for i in items]))
    # a second watcher resuming mid-history (served from the watch cache)
    w2 = st.watch("/registry/pods/default/", since_rv="3")
    for ww, n in ((w, 6), (w2, 3)):
        evs = [ww.next(timeout=2) for _ in range(n)]
        out.append(("watch", [(e.type, e.object["metadata"]["name"],
                               e.object["metadata"]["resourceVersion"])
                              for e in evs]))
        ww.stop()
    st.compact_to(st.kv.rev())
    out.append(("compacted", _code(lambda: st.watch("/registry/pods/",
                                                    since_rv="2"))))
    return out


def _code(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - both packages' StatusError
        return getattr(e, "code", repr(e))
    return None


def test_storage_event_script_matches_jax():
    jst, tst = JStorage(kv=JPyKV()), TStorage()
    try:
        a, b = _storage_script(jst), _storage_script(tst)
    finally:
        jst.close()
        tst.close()
    assert b == a
    assert ("conflict", 409) in b and ("stale", 409) in b
    assert ("gone", 404) in b and ("compacted", 410) in b


def test_durable_storage_is_refused_not_faked(tmp_path):
    """A durable store (the JAX package's WAL) is not ported yet: asking for
    one raises rather than serving from memory."""
    with pytest.raises(NotImplementedError, match="A11b"):
        TStorage(data_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="A11b"):
        TAPIServer(data_dir=str(tmp_path))


def test_pykv_matches_jax_on_a_random_script():
    """The port's PyKV (a sorted key index, log reads from an offset)
    against the JAX package's on a seeded script of creates, updates,
    deletes and compactions: every range, count and log read agree."""
    import numpy as np

    from kubernetes_tpu_torch.storage.store import PyKV as TPyKV

    rng = np.random.default_rng(0)
    jkv, tkv = JPyKV(), TPyKV()
    names = [f"/registry/{r}/{ns}/p-{i}" for r in ("pods", "podsx", "nodes")
             for ns in ("a", "b") for i in range(12)]
    prefixes = ["", "/registry/", "/registry/pods", "/registry/pods/",
                "/registry/pods/a/", "/registry/pods/a/p-1", "/zzz"]
    for step in range(600):
        key = names[rng.integers(len(names))]
        op = rng.integers(10)
        if op < 6:
            cur = jkv.get(key)
            exp = (cur.mod_rev if cur is not None else 0) \
                if rng.integers(4) else -1
            val = f"v{step}".encode()
            assert tkv.txn_put(key, exp, val) == jkv.txn_put(key, exp, val)
        elif op < 9:
            assert tkv.txn_delete(key) == jkv.txn_delete(key)
        else:
            at = int(rng.integers(max(1, jkv.rev())))
            assert tkv.compact(at) == jkv.compact(at)
        if step % 25 == 0:
            for pre in prefixes:
                a, b = jkv.range(pre), tkv.range(pre)
                assert [tuple(vars(r).values()) for r in a[0]] == \
                    [tuple(r) for r in b[0]] and a[1] == b[1]
                assert tkv.count(pre) == jkv.count(pre)
                since = int(rng.integers(jkv.rev() + 1))
                try:
                    ja = [tuple(vars(e).values())
                          for e in jkv.events_since(since, pre)]
                except Exception:  # noqa: BLE001 - compacted on both
                    ja = "compacted"
                try:
                    tb = [tuple(e) for e in tkv.events_since(since, pre)]
                except Exception:  # noqa: BLE001
                    tb = "compacted"
                assert tb == ja
