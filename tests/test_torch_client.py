"""The port's client machinery (kubernetes_tpu_torch/client/): clientset
verbs, informers, leader election and events — tests/test_client.py's cases,
each run unchanged on both packages: the JAX package's client over its own
in-process apiserver and the port's over the port's (both transports).
Its workqueue and controller-restart cases are not ported: the port has
no workqueue (client/workqueue.py) and no controllers.
"""

import importlib
import time
import types as pytypes

import pytest

PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")


@pytest.fixture(params=PACKAGES)
def side(request):
    """One package's client surface, under the same names on both sides."""
    m = lambda name: importlib.import_module(f"{request.param}.{name}")  # noqa: E731
    client = m("client")
    return pytypes.SimpleNamespace(
        APIServer=m("apiserver").APIServer,
        HTTPGateway=m("apiserver").HTTPGateway,
        Client=client.Client, EventRecorder=client.EventRecorder,
        InformerFactory=client.InformerFactory,
        LeaderElectionConfig=client.LeaderElectionConfig,
        LeaderElector=client.LeaderElector,
        SharedInformer=client.SharedInformer,
        pods_by_node_index=client.pods_by_node_index,
        errors=m("machinery.errors"))


@pytest.fixture
def api(side):
    a = side.APIServer()
    yield a
    a.close()


@pytest.fixture(params=["local", "http"])
def client(request, side, api):
    if request.param == "local":
        yield side.Client.local(api)
    else:
        gw = side.HTTPGateway(api).start()
        yield side.Client.http(gw.url)
        gw.stop()


def wait_for_watch(inf, timeout=5.0):
    """Poll until the informer's live watch exists (it is established after
    _synced is set, so wait_for_sync alone does not guarantee it)."""
    deadline = time.monotonic() + timeout
    while inf._watch is None and time.monotonic() < deadline:
        time.sleep(0.02)
    assert inf._watch is not None, "informer watch not established in time"
    return inf._watch


def mkpod(name, ns="default", node="", labels=None):
    p = {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": name, "namespace": ns},
         "spec": {"containers": [{"name": "c", "image": "img"}]}}
    if labels:
        p["metadata"]["labels"] = labels
    if node:
        p["spec"]["nodeName"] = node
    return p


class TestClientVerbs:
    def test_crud_and_bind(self, side, client):
        client.pods.create(mkpod("a"))
        got = client.pods.get("a")
        assert got["metadata"]["name"] == "a"
        client.pods.bind("a", "n1", uid=got["metadata"]["uid"])
        assert client.pods.get("a")["spec"]["nodeName"] == "n1"
        lst = client.pods.list(field_selector="spec.nodeName=n1")
        assert len(lst["items"]) == 1
        client.pods.delete("a")
        with pytest.raises(side.errors.StatusError):
            client.pods.get("a")

    def test_status_and_patch(self, side, client):
        client.nodes.create({"apiVersion": "v1", "kind": "Node",
                             "metadata": {"name": "n1"},
                             "status": {"capacity": {"cpu": "4"}}})
        client.nodes.patch_status("n1", {"status": {"phase": "Running"}},
                                  namespace="")
        got = client.nodes.get("n1", namespace="")
        assert got["status"]["phase"] == "Running"
        assert got["status"]["capacity"]["cpu"] == "4"

    def test_watch_via_client(self, side, client):
        w = client.pods.watch(namespace="default")
        time.sleep(0.2)
        client.pods.create(mkpod("w1"))
        ev = w.next(timeout=5)
        assert ev is not None and ev.type == "ADDED"
        assert ev.object["metadata"]["name"] == "w1"
        w.stop()


class TestInformer:
    def test_sync_dispatch_and_index(self, side, api):
        client = side.Client.local(api)
        client.pods.create(mkpod("pre", node="n1"))
        adds, updates, deletes = [], [], []
        inf = side.SharedInformer(client.pods,
                             index_fns={"byNode": side.pods_by_node_index})
        inf.add_handlers(
            on_add=lambda o: adds.append(o["metadata"]["name"]),
            on_update=lambda o, n: updates.append(n["metadata"]["name"]),
            on_delete=lambda o: deletes.append(o["metadata"]["name"]))
        inf.start()
        assert inf.wait_for_sync()
        assert adds == ["pre"]
        client.pods.create(mkpod("live", node="n1"))
        time.sleep(0.5)
        assert "live" in adds
        assert [p["metadata"]["name"] for p in
                inf.indexer.by_index("byNode", "n1")] == ["pre", "live"] or \
               sorted(p["metadata"]["name"] for p in
                      inf.indexer.by_index("byNode", "n1")) == ["live", "pre"]
        got = client.pods.get("live")
        got["metadata"]["labels"] = {"x": "1"}
        client.pods.update(got)
        time.sleep(0.5)
        assert "live" in updates
        client.pods.delete("pre")
        time.sleep(0.5)
        assert deletes == ["pre"]
        assert inf.lister.get("default", "pre") is None
        inf.stop()

    def test_relist_after_stream_end(self, side, api):
        client = side.Client.local(api)
        inf = side.SharedInformer(client.pods, relist_backoff=0.1)
        inf.start()
        assert inf.wait_for_sync()
        # kill the live watch; the reflector must relist and keep going
        wait_for_watch(inf).stop()
        time.sleep(0.5)
        client.pods.create(mkpod("after-relist"))
        time.sleep(0.8)
        assert inf.lister.get("default", "after-relist") is not None
        inf.stop()

    def test_factory_shares_informers(self, side, api):
        client = side.Client.local(api)
        f = side.InformerFactory(client)
        a = f.informer("pods")
        b = f.informer("pods")
        assert a is b
        f.start()
        assert f.wait_for_sync()
        f.stop()


class TestLeaderElection:
    def test_single_leader_and_failover(self, side, api):
        client = side.Client.local(api)
        events = []

        def mk(ident):
            return side.LeaderElector(client, side.LeaderElectionConfig(
                lock_name="sched", identity=ident,
                lease_duration=0.8, renew_deadline=0.5, retry_period=0.1,
                on_started_leading=lambda: events.append(("up", ident)),
                on_stopped_leading=lambda: events.append(("down", ident))))

        a, b = mk("a"), mk("b")
        a.start()
        assert a.wait_for_leadership(5)
        b.start()
        time.sleep(0.5)
        assert not b.is_leader  # live lease blocks b
        a.stop()  # a stops renewing; b must take over after expiry
        assert b.wait_for_leadership(5)
        assert ("up", "a") in events and ("up", "b") in events
        b.stop()


class TestEvents:
    def test_record_and_aggregate(self, side, api):
        client = side.Client.local(api)
        rec = side.EventRecorder(client, component="scheduler")
        pod = client.pods.create(mkpod("evt"))
        rec.event(pod, "Warning", "FailedScheduling", "0/3 nodes available")
        rec.event(pod, "Warning", "FailedScheduling", "0/3 nodes available")
        evs = client.events.list("default")["items"]
        assert len(evs) == 1
        assert evs[0]["count"] == 2
        assert evs[0]["reason"] == "FailedScheduling"
        assert evs[0]["source"]["component"] == "scheduler"


class TestInformerFactoryKeys:
    def test_namespace_scoped_informers_not_conflated(self, side, api):
        client = side.Client.local(api)
        client.pods.create(mkpod("in-default"))
        f = side.InformerFactory(client)
        scoped = f.informer("pods", namespace="kube-system")
        unscoped = f.informer("pods")
        assert scoped is not unscoped
        f.start()
        assert f.wait_for_sync()
        assert unscoped.lister.get("default", "in-default") is not None
        assert scoped.lister.get("default", "in-default") is None
        f.stop()

    def test_late_index_fns_backfilled(self, side, api):
        client = side.Client.local(api)
        client.pods.create(mkpod("idx", node="n9"))
        f = side.InformerFactory(client)
        f.informer("pods")
        f.start()
        assert f.wait_for_sync()
        inf = f.informer("pods", index_fns={"byNode": side.pods_by_node_index})
        got = inf.indexer.by_index("byNode", "n9")
        assert [p["metadata"]["name"] for p in got] == ["idx"]
        f.stop()


class TestRelistTombstones:
    def test_delete_during_relist_carries_last_known_object(self, side, api):
        client = side.Client.local(api)
        client.pods.create(mkpod("t1", labels={"app": "x"}))
        inf = side.SharedInformer(client.pods, relist_backoff=0.1)
        deletes = []
        inf.add_handlers(on_delete=lambda o: deletes.append(o))
        inf.start()
        assert inf.wait_for_sync()
        # kill the watch, delete while the informer is blind, let it relist
        wait_for_watch(inf).stop()
        client.pods.delete("t1")
        time.sleep(1.0)
        assert deletes, "relist did not synthesize the delete"
        assert deletes[-1].get("metadata", {}).get("labels") == {"app": "x"}
        inf.stop()


class TestEventRecreate:
    def test_event_recreated_after_server_side_delete(self, side, api):
        client = side.Client.local(api)
        rec = side.EventRecorder(client)
        pod = client.pods.create(mkpod("edel"))
        rec.event(pod, "Warning", "X", "msg")
        name = client.events.list("default")["items"][0]["metadata"]["name"]
        client.events.delete(name, "default")
        rec.event(pod, "Warning", "X", "msg")
        evs = client.events.list("default")["items"]
        assert len(evs) == 1 and evs[0]["count"] == 1
