"""Parity of the port's scheduler-extender boundary (kubernetes_tpu_torch/
extender/, api/v1.py and the Scheduler's per-pod extender path) with the JAX
package's (kubernetes_tpu/extender/, api/v1.py, sched/scheduler.py).

tests/test_extender.py's eleven cases run on both packages (the port's
ExtenderBackend and Scheduler with device="cpu"). Then both backends mirror
one random cluster and answer the same ExtenderArgs: every verb's JSON
answer — Filter's passing list and failure reasons, Prioritize's integer
scores, ProcessPreemption's surviving victims, Bind — is equal. Last, the
wire both ways over real HTTP: the JAX package's HTTPExtender against the
port's ExtenderServer, and the port's HTTPExtender against the JAX
package's server.
"""

import json
import random
import urllib.request

import pytest

import kubernetes_tpu.api.types as JT
import kubernetes_tpu.api.v1 as JV1
import kubernetes_tpu.extender as JE
import kubernetes_tpu_torch.api.types as TT
import kubernetes_tpu_torch.api.v1 as TV1
import kubernetes_tpu_torch.extender as TE
from kubernetes_tpu.sched.scheduler import RecordingBinder as JBinder
from kubernetes_tpu.sched.scheduler import Scheduler as JScheduler
from kubernetes_tpu_torch.sched.scheduler import RecordingBinder as TBinder
from kubernetes_tpu_torch.sched.scheduler import Scheduler as TScheduler
from test_golden import rand_node, rand_pod

SIDES = ("jax", "port")


class Side:
    def __init__(self, name):
        jx = name == "jax"
        self.name = name
        self.T, self.V1, self.E = (JT, JV1, JE) if jx else (TT, TV1, TE)
        self.Binder = JBinder if jx else TBinder

    def backend(self, **kw):
        if self.name == "jax":
            return self.E.ExtenderBackend(**kw)
        return self.E.ExtenderBackend(device="cpu", **kw)

    def scheduler(self, **kw):
        if self.name == "jax":
            s = JScheduler(**kw)
            s.prewarmer.enabled = False  # compile-ahead only
            return s
        return TScheduler(device="cpu", **kw)


def mknode(T, name, cpu=4, mem="8Gi", labels=None, **kw):
    return T.Node(name=name, labels=labels or {},
                  allocatable=T.Resources.make(cpu=cpu, memory=mem, pods=110),
                  **kw)


def mkpod(T, name, cpu="500m", mem="256Mi", **kw):
    return T.Pod(name=name, requests=T.Resources.make(cpu=cpu, memory=mem),
                 **kw)


# --------------------------------------------------------------------- #
# tests/test_extender.py's eleven cases, each on both packages
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("side", SIDES)
def test_v1_pod_roundtrip(side):
    S = Side(side)
    T = S.T
    pod = T.Pod(
        name="web-0", namespace="prod", uid="u-123",
        labels={"app": "web", "tier": "fe"},
        requests=T.Resources.make(cpu="1500m", memory="2Gi"),
        node_selector={"disktype": "ssd"},
        affinity=T.Affinity(anti_required=(T.PodAffinityTerm(
            selector=T.LabelSelector.of({"app": "web"}),
            topology_key="kubernetes.io/hostname"),)),
        tolerations=(T.Toleration(key="gpu", op=T.TolerationOp.EXISTS,
                                  effect=T.TaintEffect.NO_SCHEDULE),),
        priority=100)
    rt = S.V1.pod_from_v1(S.V1.pod_to_v1(pod))
    assert rt.key == pod.key and rt.uid == "u-123"
    assert rt.requests.milli_cpu == 1500
    assert rt.requests.memory_kib == 2 * 1024 * 1024
    assert rt.node_selector == {"disktype": "ssd"}
    assert rt.affinity.anti_required[0].topology_key == "kubernetes.io/hostname"
    assert rt.tolerations[0].op == T.TolerationOp.EXISTS
    assert rt.priority == 100


@pytest.mark.parametrize("side", SIDES)
def test_v1_pod_init_container_max_rule(side):
    S = Side(side)
    obj = {"metadata": {"name": "p", "namespace": "d"}, "spec": {
        "containers": [
            {"name": "a", "resources": {"requests": {"cpu": "200m",
                                                     "memory": "100Mi"}}},
            {"name": "b", "resources": {"requests": {"cpu": "300m",
                                                     "memory": "100Mi"}}}],
        "initContainers": [
            {"name": "init", "resources": {"requests": {"cpu": "1",
                                                        "memory": "50Mi"}}}]}}
    pod = S.V1.pod_from_v1(obj)
    assert pod.requests.milli_cpu == 1000
    assert pod.requests.memory_kib == 200 * 1024


@pytest.mark.parametrize("side", SIDES)
def test_v1_node_roundtrip(side):
    S = Side(side)
    T = S.T
    n = T.Node(name="n0", labels={"zone": "a"},
               allocatable=T.Resources.make(cpu=8, memory="16Gi", pods=110),
               taints=(T.Taint(key="dedicated", value="ml",
                               effect=T.TaintEffect.NO_SCHEDULE),),
               unschedulable=True)
    rt = S.V1.node_from_v1(S.V1.node_to_v1(n))
    assert rt.name == "n0" and rt.labels == {"zone": "a"}
    assert rt.allocatable.milli_cpu == 8000
    assert rt.taints[0].key == "dedicated"
    assert rt.unschedulable


def _backend_with_cluster(S):
    T = S.T
    be = S.backend()
    be.sync_nodes([
        mknode(T, "big", cpu=8), mknode(T, "small", cpu=1),
        mknode(T, "tainted", cpu=8, taints=(T.Taint(
            key="dedicated", value="x", effect=T.TaintEffect.NO_SCHEDULE),))])
    return be


@pytest.mark.parametrize("side", SIDES)
def test_backend_filter_cache_capable(side):
    S = Side(side)
    be = _backend_with_cluster(S)
    res = be.filter(S.E.ExtenderArgs(
        pod=S.V1.pod_to_v1(mkpod(S.T, "p", cpu="2")),
        node_names=["big", "small", "tainted", "ghost"]))
    assert res.node_names == ["big"]
    assert "Insufficient" in res.failed_nodes["small"]
    assert "taint" in res.failed_nodes["tainted"]
    assert res.failed_nodes["ghost"] == "node not found in extender cache"


@pytest.mark.parametrize("side", SIDES)
def test_backend_filter_full_nodes_mode(side):
    S = Side(side)
    T = S.T
    res = S.backend().filter(S.E.ExtenderArgs(
        pod=S.V1.pod_to_v1(mkpod(T, "p", cpu="2")),
        nodes=[S.V1.node_to_v1(mknode(T, "a", cpu=8)),
               S.V1.node_to_v1(mknode(T, "b", cpu=1))]))
    assert [n["metadata"]["name"] for n in res.nodes] == ["a"]
    assert "b" in res.failed_nodes


@pytest.mark.parametrize("side", SIDES)
def test_backend_prioritize_prefers_empty_node(side):
    S = Side(side)
    T = S.T
    be = S.backend()
    be.sync_nodes([mknode(T, "empty", cpu=8), mknode(T, "busy", cpu=8)])
    busy = mkpod(T, "occupant", cpu="6")
    busy.node_name = "busy"
    be.sync_scheduled_pods([busy])
    scores = {p.host: p.score for p in be.prioritize(S.E.ExtenderArgs(
        pod=S.V1.pod_to_v1(mkpod(T, "p", cpu="1")),
        node_names=["empty", "busy"]))}
    assert scores["empty"] > scores["busy"]
    assert 0 <= scores["busy"] <= 10 and scores["empty"] <= 10


@pytest.mark.parametrize("side", SIDES)
def test_backend_preemption_verifies_victims(side):
    S = Side(side)
    T = S.T
    be = S.backend()
    be.sync_nodes([mknode(T, "n0", cpu=2)])
    victim = mkpod(T, "victim", cpu="1500m")
    victim.node_name = "n0"
    be.sync_scheduled_pods([victim])
    res = be.process_preemption(S.E.ExtenderPreemptionArgs(
        pod=S.V1.pod_to_v1(mkpod(T, "p", cpu="1")),
        node_name_to_victims={"n0": S.E.Victims(
            pods=[S.V1.pod_to_v1(victim)])}))
    assert "n0" in res.node_name_to_meta_victims
    res2 = be.process_preemption(S.E.ExtenderPreemptionArgs(
        pod=S.V1.pod_to_v1(mkpod(T, "p2", cpu="1")),
        node_name_to_victims={"n0": S.E.Victims(pods=[])}))
    assert "n0" not in res2.node_name_to_meta_victims


@pytest.mark.parametrize("side", SIDES)
def test_http_extender_end_to_end(side):
    S = Side(side)
    T = S.T
    be = _backend_with_cluster(S)
    with S.E.ExtenderServer(be) as srv:
        ext = S.E.HTTPExtender(S.E.ExtenderConfig(
            url_prefix=srv.url, filter_verb="filter",
            prioritize_verb="prioritize", preempt_verb="preemption",
            bind_verb="bind", weight=2, node_cache_capable=True))
        nodes = [mknode(T, "big", cpu=8), mknode(T, "small", cpu=1)]
        passing, failed = ext.filter(mkpod(T, "p", cpu="2"), nodes)
        assert passing == ["big"] and "small" in failed
        scores, weight = ext.prioritize(mkpod(T, "p", cpu="2"), nodes)
        assert weight == 2 and set(scores) == {"big", "small"}
        ext.bind(mkpod(T, "p", cpu="2"), "big")
        assert be.bound == [("default/p", "big")]
    assert srv.requests_served == 3


@pytest.mark.parametrize("side", SIDES)
def test_http_server_speaks_reference_wire_format(side):
    """A raw POST shaped like the Go HTTPExtender's (capitalized JSON keys)
    gets a correctly shaped reply; /healthz answers."""
    S = Side(side)
    be = S.backend()
    be.sync_nodes([mknode(S.T, "n0", cpu=4)])
    with S.E.ExtenderServer(be) as srv:
        payload = json.dumps({
            "Pod": S.V1.pod_to_v1(mkpod(S.T, "p", cpu="1")),
            "NodeNames": ["n0"], "Nodes": None}).encode()
        req = urllib.request.Request(
            srv.url + "/filter", data=payload,
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=5) as resp:
            out = json.loads(resp.read())
        assert out["NodeNames"] == ["n0"]
        assert out["FailedNodes"] == {} and out["Error"] == ""
        with urllib.request.urlopen(
                srv.url.rsplit("/", 1)[0] + "/healthz") as resp:
            assert resp.read() == b"ok"


@pytest.mark.parametrize("side", SIDES)
def test_http_extender_ignorable_and_managed_resources(side):
    S = Side(side)
    ext = S.E.HTTPExtender(S.E.ExtenderConfig(
        url_prefix="http://127.0.0.1:1/dead", filter_verb="filter",
        managed_resources=("example.com/tpu",), ignorable=True))
    assert not ext.is_interested(mkpod(S.T, "plain"))
    rich = mkpod(S.T, "rich")
    rich.requests = S.T.Resources(milli_cpu=100,
                                  scalars=(("example.com/tpu", 4),))
    assert ext.is_interested(rich)


@pytest.mark.parametrize("side", SIDES)
def test_scheduler_with_extender_in_cycle(side):
    """A second backend acts as the external webhook; the Scheduler consults
    it per pod: its filter veto and its bind verb both take effect."""
    S = Side(side)
    T = S.T

    class VetoBackend(S.E.ExtenderBackend):
        def filter(self, args):
            res = super().filter(args)
            res.node_names = [n for n in (res.node_names or [])
                              if n == "allowed"]
            return res

    ext_be = (VetoBackend() if side == "jax"
              else VetoBackend(device="cpu"))
    ext_be.sync_nodes([mknode(T, "allowed", cpu=8),
                       mknode(T, "forbidden", cpu=8)])
    with S.E.ExtenderServer(ext_be) as srv:
        cfg = S.E.ExtenderConfig(url_prefix=srv.url, filter_verb="filter",
                                 prioritize_verb="prioritize",
                                 bind_verb="bind", node_cache_capable=True)
        binder = S.Binder()
        s = S.scheduler(binder=binder, extenders=[S.E.HTTPExtender(cfg)])
        s.on_node_add(mknode(T, "allowed", cpu=8))
        s.on_node_add(mknode(T, "forbidden", cpu=8))
        for i in range(3):
            s.on_pod_add(mkpod(T, f"p{i}", cpu="1"))
        assert s.schedule_pending().scheduled == 3
        assert all(n == "allowed" for _, n in ext_be.bound)
        assert len(ext_be.bound) == 3 and binder.bound == []


# --------------------------------------------------------------------- #
# every verb's JSON answer, both backends on one mirrored cluster
# --------------------------------------------------------------------- #


def _to_port(obj, kind):
    """A JAX-package object as the port's, through the v1 wire form."""
    if kind == "pod":
        return TV1.pod_from_v1(JV1.pod_to_v1(obj))
    return TV1.node_from_v1(JV1.node_to_v1(obj))


def _mirrored(seed):
    """Both backends mirroring one random cluster (test_golden's nodes,
    bound pods and pending pods, each as the wire carries it)."""
    rng = random.Random(4000 + seed)
    nodes = [rand_node(rng, i) for i in range(rng.randint(6, 12))]
    bound = [rand_pod(rng, 100 + i, bound_to=rng.choice(nodes).name)
             for i in range(rng.randint(4, 12))]
    pending = [rand_pod(rng, i) for i in range(6)]
    # what the wire carries (no pod volumes, no node volume limits), so both
    # mirrors hold the same objects
    nodes = [JV1.node_from_v1(JV1.node_to_v1(n)) for n in nodes]
    bound = [JV1.pod_from_v1(JV1.pod_to_v1(p)) for p in bound]
    pending = [JV1.pod_from_v1(JV1.pod_to_v1(p)) for p in pending]
    jbe, tbe = JE.ExtenderBackend(), TE.ExtenderBackend(device="cpu")
    jbe.sync_nodes(nodes)
    tbe.sync_nodes([_to_port(n, "node") for n in nodes])
    jbe.sync_scheduled_pods(bound)
    tbe.sync_scheduled_pods([_to_port(p, "pod") for p in bound])
    return jbe, tbe, nodes, bound, pending


@pytest.mark.parametrize("seed", range(4))
def test_verb_answers_equal_jax(seed):
    """Filter (cache-capable and full-node forms, reasons included),
    Prioritize, ProcessPreemption (both victim forms) and Bind answer
    byte-for-byte alike on both backends."""
    jbe, tbe, nodes, bound, pending = _mirrored(seed)
    names = [n.name for n in nodes] + ["ghost"]
    for pod in pending:
        pj = JV1.pod_to_v1(pod)
        for args in (JE.ExtenderArgs(pod=pj, node_names=names),
                     JE.ExtenderArgs(pod=pj, nodes=[
                         JV1.node_to_v1(n) for n in nodes[:4]])):
            jout = jbe.filter(JE.ExtenderArgs.from_json(args.to_json()))
            tout = tbe.filter(TE.ExtenderArgs.from_json(args.to_json()))
            assert tout.to_json() == jout.to_json()
        args = JE.ExtenderArgs(pod=pj, node_names=names)
        jp = [h.to_json() for h in jbe.prioritize(args)]
        tp = [h.to_json() for h in tbe.prioritize(
            TE.ExtenderArgs.from_json(args.to_json()))]
        assert tp == jp
    by_node = {}
    for p in bound:
        by_node.setdefault(p.node_name, []).append(p)
    vip = JV1.pod_to_v1(JT.Pod(name="vip", priority=1000,
                               requests=JT.Resources.make(cpu="2",
                                                          memory="2Gi")))
    for pre in (
            JE.ExtenderPreemptionArgs(pod=vip, node_name_to_victims={
                n: JE.Victims(pods=[JV1.pod_to_v1(p) for p in ps])
                for n, ps in by_node.items()}),
            JE.ExtenderPreemptionArgs(pod=vip, node_name_to_meta_victims={
                n: JE.MetaVictims(pods=[p.uid for p in ps[:1]])
                for n, ps in by_node.items()})):
        jout = jbe.process_preemption(
            JE.ExtenderPreemptionArgs.from_json(pre.to_json()))
        tout = tbe.process_preemption(
            TE.ExtenderPreemptionArgs.from_json(pre.to_json()))
        assert tout.to_json() == jout.to_json()
    b = JE.ExtenderBindingArgs(pod_name="vip", pod_namespace="default",
                               pod_uid="u", node=nodes[0].name)
    assert tbe.bind(TE.ExtenderBindingArgs.from_json(b.to_json())).to_json() \
        == jbe.bind(b).to_json()
    assert tbe.bound == jbe.bound


# --------------------------------------------------------------------- #
# the wire, both ways
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax")])
def test_wire_compatible_both_ways(client, server):
    """One package's HTTPExtender against the other's ExtenderServer: the
    four verbs round-trip, and the answers equal those of the client's own
    package's backend on the same cluster."""
    C, Sv = Side(client), Side(server)

    def cluster(S):
        T = S.T
        be = S.backend()
        be.sync_nodes([mknode(T, "big", cpu=8), mknode(T, "small", cpu=1),
                       mknode(T, "mid", cpu=4)])
        occ = mkpod(T, "occ", cpu="3")
        occ.node_name = "mid"
        be.sync_scheduled_pods([occ])
        return be, occ

    remote, _ = cluster(Sv)
    local, occ = cluster(C)
    T = C.T
    nodes = [mknode(T, "big", cpu=8), mknode(T, "small", cpu=1),
             mknode(T, "mid", cpu=4)]
    pod = mkpod(T, "p", cpu="2")
    with Sv.E.ExtenderServer(remote) as srv, C.E.ExtenderServer(local) as ref:
        for cache_capable in (True, False):
            got, want = (C.E.HTTPExtender(C.E.ExtenderConfig(
                url_prefix=u, filter_verb="filter",
                prioritize_verb="prioritize", preempt_verb="preemption",
                bind_verb="bind", weight=3,
                node_cache_capable=cache_capable))
                for u in (srv.url, ref.url))
            assert got.filter(pod, nodes) == want.filter(pod, nodes)
            assert got.prioritize(pod, nodes) == want.prioritize(pod, nodes)
            victims = {"mid": [occ]}
            assert got.process_preemption(pod, victims) \
                == want.process_preemption(pod, victims)
        got.bind(pod, "big")
    assert remote.bound == [("default/p", "big")]


def test_backend_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """ExtenderBackend() defaults to the CUDA device and raises without one
    unless device="cpu" is passed, as BatchScheduler and Scheduler do."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.ExtenderBackend()
    assert TE.ExtenderBackend(device="cpu").device.type == "cpu"
