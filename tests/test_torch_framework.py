"""Parity of the port's scheduling framework (kubernetes_tpu_torch/framework/,
its wiring into sched/cycle.py and the serving Scheduler) with the JAX
package's (kubernetes_tpu/framework/, sched/cycle.py, sched/scheduler.py).

Each of tests/test_framework.py's twelve cases is written once against a
`Side` (the package's types, framework, cycle and Scheduler — the port's
with device="cpu", the JAX package's with its prewarmer off) and runs on
both packages. Then, on one encoding handed to both packages
(tests/torch_parity.py): every in-tree plugin's [P, N] row and mask, the
jnp.interp rebuild on RequestedToCapacityRatio's edge shapes, and a seeded
sweep of configurations (random plugin sets, disabled filters, weights f32
cannot hold exactly, random shapes with zero-width segments and points
outside 0–100, NodeLabel keys missing from the vocabulary) through
`_feasible` (exact), `_scores` (F32_ATOL) and `schedule_batch` placements
(exact) on a 200-node × 1,000-pod cluster. Also tests/test_waves.py's
NodePreferAvoidPods case on both packages.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.api.types as JT
import kubernetes_tpu.framework as JF
import kubernetes_tpu.framework.plugins as JP
import kubernetes_tpu_torch.api.types as TT
import kubernetes_tpu_torch.framework as TF
import kubernetes_tpu_torch.framework.plugins as TP
from kubernetes_tpu.sched import cycle as JC
from kubernetes_tpu.sched.config import load_config as j_load_config
from kubernetes_tpu.sched.scheduler import RecordingBinder as JBinder
from kubernetes_tpu.sched.scheduler import Scheduler as JScheduler
from kubernetes_tpu.state.encode import Encoder as JEncoder
from kubernetes_tpu_torch.sched import cycle as TC
from kubernetes_tpu_torch.sched.config import load_config as t_load_config
from kubernetes_tpu_torch.sched.scheduler import RecordingBinder as TBinder
from kubernetes_tpu_torch.sched.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.state.arrays import tables_to_torch
from kubernetes_tpu_torch.state.encode import Encoder as TEncoder
from torch_parity import F32_ATOL, as_np, assert_same, encode

CPU = torch.device("cpu")
UNSCHED = JC.UNSCHEDULABLE_TAINT_KEY
HOSTNAME = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"


class Side:
    """One package's surface for the cases below."""

    def __init__(self, name: str):
        self.name = name
        jx = name == "jax"
        self.T = JT if jx else TT
        self.F = JF if jx else TF
        self.P = JP if jx else TP
        self.C = JC if jx else TC
        self.Binder = JBinder if jx else TBinder

    def scheduler(self, **kw):
        if self.name == "jax":
            s = JScheduler(**kw)
            s.prewarmer.enabled = False  # compile-ahead only
            return s
        return TScheduler(device="cpu", **kw)

    def encode(self, nodes, existing, pending):
        enc = (JEncoder if self.name == "jax" else TEncoder)()
        enc.vocabs.label_keys.intern(UNSCHED)
        enc.vocabs.label_vals.intern("")
        tables, ex, pe, d = enc.encode_cluster(nodes, existing, pending, None)
        keys = (enc.vocabs.label_keys.get(UNSCHED),
                enc.vocabs.label_vals.get(""))
        if self.name == "jax":
            return (jax.device_put(tables), jax.device_put(ex),
                    jax.device_put(pe), d,
                    (jnp.int32(keys[0]), jnp.int32(keys[1])))
        tt, (ext, pet) = tables_to_torch(tables, (ex, pe), CPU)
        return tt, ext, pet, d, keys

    # --- tensors a custom plugin returns, in the package's own ops --- #
    def first_node_mask(self, P, N):
        if self.name == "jax":
            return (jnp.arange(N) == 0)[None, :] & jnp.ones((P, 1), bool)
        return (torch.arange(N) == 0)[None, :].expand(P, N)

    def full(self, P, N, v):
        if self.name == "jax":
            return jnp.full((P, N), v)
        return torch.full((P, N), v)

    def fused(self, fw, tables, pe, keys, D, ex):
        """build_context → RunFilterPlugins, RunScorePlugins (under jit on
        the JAX package, as its test runs them)."""
        state = self.F.CycleState()

        def run(tables, pending, keys, D, existing):
            ctx = self.F.build_context(tables, existing, pending, keys[0],
                                       keys[1], D)
            return (fw.run_filter_plugins(state, ctx),
                    fw.run_score_plugins(state, ctx))

        if self.name == "jax":
            run = jax.jit(run, static_argnums=(3,))
        return run(tables, pe, keys, D, ex)


SIDES = ("jax", "port")


def mknode(T, name, cpu=4, mem="8Gi", **kw):
    return T.Node(name=name,
                  allocatable=T.Resources.make(cpu=cpu, memory=mem, pods=110),
                  **kw)


def mkpod(T, name, cpu="500m", mem="256Mi", **kw):
    return T.Pod(name=name, requests=T.Resources.make(cpu=cpu, memory=mem),
                 **kw)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# --------------------------------------------------------------------- #
# tests/test_framework.py's twelve cases, each on both packages
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("side", SIDES)
def test_default_framework_matches_monolithic_lattice(side):
    """The AND/Σ over the default in-tree plugins equals the monolithic
    _feasible/_scores."""
    S = Side(side)
    nodes = [mknode(S.T, f"n{i}", cpu=2 + i) for i in range(5)]
    pending = [mkpod(S.T, "a", cpu="1"), mkpod(S.T, "b", cpu="6")]
    tables, ex, pe, d, keys = S.encode(nodes, [], pending)
    mask_fw, score_fw = (as_np(x) for x in S.fused(
        S.F.default_framework(), tables, pe, keys, d.D, ex))
    mask_ref = as_np(S.C._feasible(tables, pe, keys, d.D, ex))
    score_ref = as_np(S.C._scores(tables, pe, keys, d.D, ex))
    np.testing.assert_array_equal(mask_fw, mask_ref)
    np.testing.assert_allclose(np.where(mask_ref, score_fw, 0.0),
                               np.where(mask_ref, score_ref, 0.0), rtol=1e-5)


@pytest.mark.parametrize("side", SIDES)
def test_custom_filter_plugin_vetoes(side):
    S = Side(side)

    class OnlyFirstNode(S.F.FilterPlugin):
        def filter_mask(self, state, ctx):
            return S.first_node_mask(ctx.pending.valid.shape[0],
                                     ctx.tables.nodes.valid.shape[0])

    reg = dict(S.F.default_registry(), OnlyFirstNode=lambda cfg: OnlyFirstNode())
    plugins = S.F.default_plugins()
    plugins.filter.enabled.append("OnlyFirstNode")
    fw = S.F.Framework(registry=reg, plugins=plugins)
    tables, ex, pe, d, keys = S.encode(
        [mknode(S.T, f"n{i}") for i in range(4)], [], [mkpod(S.T, "a")])
    ctx = S.F.build_context(tables, ex, pe, keys[0], keys[1], d.D)
    mask = as_np(fw.run_filter_plugins(S.F.CycleState(), ctx))
    assert mask[0, 0] and not mask[0, 1:].any()


@pytest.mark.parametrize("side", SIDES)
def test_score_plugin_weighting(side):
    S = Side(side)

    class ConstantScore(S.F.ScorePlugin):
        def score_matrix(self, state, ctx):
            return S.full(ctx.pending.valid.shape[0],
                          ctx.tables.nodes.valid.shape[0], 10.0)

    fw = S.F.Framework(registry={"Const": lambda cfg: ConstantScore()},
                       plugins=S.F.Plugins(score=S.F.PluginSet(
                           enabled=["Const"])),
                       score_weights={"Const": 3})
    tables, ex, pe, d, keys = S.encode([mknode(S.T, "n0")], [],
                                       [mkpod(S.T, "a")])
    ctx = S.F.build_context(tables, ex, pe, keys[0], keys[1], d.D)
    assert float(as_np(fw.run_score_plugins(S.F.CycleState(), ctx))[0, 0]) \
        == 30.0


@pytest.mark.parametrize("side", SIDES)
def test_permit_wait_allow_and_timeout(side):
    """Permit WAIT parks the pod assumed; Allow releases and binds; timeout
    rejects back to the queue (waiting_pods_map semantics)."""
    S = Side(side)

    class Gate(S.F.PermitPlugin):
        def permit(self, state, pod, node):
            return S.F.Status(S.F.Code.WAIT), 30.0

    clock = FakeClock()
    fw = S.F.Framework(registry={"Gate": lambda cfg: Gate()},
                       plugins=S.F.Plugins(permit=S.F.PluginSet(
                           enabled=["Gate"])), clock=clock)
    binder = S.Binder()
    s = S.scheduler(binder=binder, framework=fw, clock=clock)
    s.on_node_add(mknode(S.T, "n0"))
    s.on_pod_add(mkpod(S.T, "w"))
    stats = s.schedule_pending()
    assert stats.scheduled == 0 and binder.bound == []
    assert [p.key for p in fw.waiting_pods()] == ["default/w"]
    assert s.cache.is_assumed("default/w")
    assert fw.allow_waiting_pod("default/w", "Gate")
    assert s.complete_waiting("default/w")
    assert binder.bound == [("default/w", "n0")]

    s.on_pod_add(mkpod(S.T, "t"))
    s.schedule_pending()
    assert [p.key for p in fw.waiting_pods()] == ["default/t"]
    clock.t = 100.0
    assert s.expire_waiting() == 1
    assert not s.cache.is_assumed("default/t")
    assert s.queue.lengths()[1] + s.queue.lengths()[2] >= 1


@pytest.mark.parametrize("side", SIDES)
def test_reserve_failure_rolls_back(side):
    S = Side(side)
    calls = []

    class BadReserve(S.F.ReservePlugin):
        def reserve(self, state, pod, node):
            return S.F.Status(S.F.Code.ERROR, "volume attach failed")

    class Undo(S.F.UnreservePlugin):
        def unreserve(self, state, pod, node):
            calls.append(pod.key)

    fw = S.F.Framework(
        registry={"BadReserve": lambda cfg: BadReserve(),
                  "Undo": lambda cfg: Undo()},
        plugins=S.F.Plugins(reserve=S.F.PluginSet(enabled=["BadReserve"]),
                            unreserve=S.F.PluginSet(enabled=["Undo"])))
    s = S.scheduler(binder=S.Binder(), framework=fw)
    s.on_node_add(mknode(S.T, "n0"))
    s.on_pod_add(mkpod(S.T, "p"))
    stats = s.schedule_pending()
    assert stats.scheduled == 0 and stats.unschedulable == 1
    assert calls == ["default/p"]
    assert not s.cache.is_assumed("default/p")


@pytest.mark.parametrize("side", SIDES)
def test_bind_plugin_overrides_binder(side):
    S = Side(side)
    bound = []

    class MyBinder(S.F.BindPlugin):
        def bind(self, state, pod, node):
            bound.append((pod.key, node))
            return None

    fw = S.F.Framework(registry={"MyBinder": lambda cfg: MyBinder()},
                       plugins=S.F.Plugins(bind=S.F.PluginSet(
                           enabled=["MyBinder"])))
    binder = S.Binder()
    s = S.scheduler(binder=binder, framework=fw)
    s.on_node_add(mknode(S.T, "n0"))
    s.on_pod_add(mkpod(S.T, "p"))
    assert s.schedule_pending().scheduled == 1
    assert bound == [("default/p", "n0")]
    assert binder.bound == []


@pytest.mark.parametrize("side", SIDES)
def test_waiting_bind_failure_requeues_unpinned(side):
    """A bind failure after Permit release requeues the ORIGINAL pod, not
    the cache's node_name-stamped copy."""
    S = Side(side)

    class Gate(S.F.PermitPlugin):
        calls = 0

        def permit(self, state, pod, node):
            Gate.calls += 1
            if Gate.calls == 1:
                return S.F.Status(S.F.Code.WAIT), 30.0
            return None, 0.0

    clock = FakeClock()
    fw = S.F.Framework(registry={"Gate": lambda cfg: Gate()},
                       plugins=S.F.Plugins(permit=S.F.PluginSet(
                           enabled=["Gate"])), clock=clock)
    binder = S.Binder(fail_keys=["default/w"])
    s = S.scheduler(binder=binder, framework=fw, clock=clock)
    s.on_node_add(mknode(S.T, "n0"))
    s.on_node_add(mknode(S.T, "n1"))
    s.on_pod_add(mkpod(S.T, "w"))
    s.schedule_pending()
    fw.allow_waiting_pod("default/w", "Gate")
    assert not s.complete_waiting("default/w")
    assert s.waiting_bind_errors == 1
    binder.fail_keys.clear()
    clock.t = 100.0
    s.queue.move_all_to_active(clock.t)
    assert s.schedule_pending().scheduled == 1
    assert binder.bound[0][0] == "default/w"


@pytest.mark.parametrize("side", SIDES)
def test_reject_waiting_pod_cleans_up(side):
    S = Side(side)
    undone = []

    class Gate(S.F.PermitPlugin):
        def permit(self, state, pod, node):
            return S.F.Status(S.F.Code.WAIT), 30.0

    class Undo(S.F.UnreservePlugin):
        def unreserve(self, state, pod, node):
            undone.append(pod.key)

    fw = S.F.Framework(
        registry={"Gate": lambda cfg: Gate(), "Undo": lambda cfg: Undo()},
        plugins=S.F.Plugins(permit=S.F.PluginSet(enabled=["Gate"]),
                            unreserve=S.F.PluginSet(enabled=["Undo"])))
    s = S.scheduler(binder=S.Binder(), framework=fw)
    s.on_node_add(mknode(S.T, "n0"))
    s.on_pod_add(mkpod(S.T, "r"))
    s.schedule_pending()
    assert s.cache.is_assumed("default/r")
    assert s.reject_waiting("default/r")
    assert undone == ["default/r"]
    assert not s.cache.is_assumed("default/r")
    assert not fw.waiting_pods()
    assert sum(s.queue.lengths()) >= 1


@pytest.mark.parametrize("side", SIDES)
def test_deleted_waiting_pod_is_not_resurrected(side):
    S = Side(side)

    class Gate(S.F.PermitPlugin):
        def permit(self, state, pod, node):
            return S.F.Status(S.F.Code.WAIT), 30.0

    clock = FakeClock()
    fw = S.F.Framework(registry={"Gate": lambda cfg: Gate()},
                       plugins=S.F.Plugins(permit=S.F.PluginSet(
                           enabled=["Gate"])), clock=clock)
    binder = S.Binder()
    s = S.scheduler(binder=binder, framework=fw, clock=clock)
    s.on_node_add(mknode(S.T, "n0"))
    pod = mkpod(S.T, "doomed")
    s.on_pod_add(pod)
    s.schedule_pending()
    assert s.cache.is_assumed("default/doomed")
    s.on_pod_delete(pod)
    assert not s.cache.is_assumed("default/doomed")
    assert fw.waiting_pods() == []
    clock.t = 100.0
    assert s.expire_waiting() == 0
    s.schedule_pending()
    assert binder.bound == []
    assert sum(s.queue.lengths()) == 0


@pytest.mark.parametrize("side", SIDES)
def test_raising_bind_plugin_in_complete_waiting_rolls_back(side):
    S = Side(side)

    class Gate(S.F.PermitPlugin):
        def permit(self, state, pod, node):
            return S.F.Status(S.F.Code.WAIT), 30.0

    class Bomb(S.F.BindPlugin):
        def bind(self, state, pod, node):
            raise RuntimeError("apiserver down")

    fw = S.F.Framework(
        registry={"Gate": lambda cfg: Gate(), "Bomb": lambda cfg: Bomb()},
        plugins=S.F.Plugins(permit=S.F.PluginSet(enabled=["Gate"]),
                            bind=S.F.PluginSet(enabled=["Bomb"])))
    s = S.scheduler(binder=S.Binder(), framework=fw)
    s.on_node_add(mknode(S.T, "n0"))
    s.on_pod_add(mkpod(S.T, "w"))
    s.schedule_pending()
    fw.allow_waiting_pod("default/w", "Gate")
    assert not s.complete_waiting("default/w")
    assert not s.cache.is_assumed("default/w")
    assert s.waiting_bind_errors == 1
    assert sum(s.queue.lengths()) == 1


@pytest.mark.parametrize("side", SIDES)
def test_merge_plugins_disabled_semantics(side):
    S = Side(side)
    defaults = S.F.default_plugins()
    custom = S.F.Plugins(
        score=S.F.PluginSet(enabled=["MyScore"],
                            disabled=["NodePreferAvoidPods"]),
        filter=S.F.PluginSet(disabled=["*"], enabled=["OnlyFilter"]))
    merged = S.F.merge_plugins(defaults, custom)
    assert "MyScore" in merged.score.enabled
    assert "NodePreferAvoidPods" not in merged.score.enabled
    assert any(n != "MyScore" for n in merged.score.enabled)
    assert merged.filter.enabled == ["OnlyFilter"]
    assert merged.pre_filter.enabled == defaults.pre_filter.enabled


@pytest.mark.parametrize("side", SIDES)
def test_node_prefer_avoid_pods_shape(side):
    S = Side(side)
    nodes = [mknode(S.T, "n0"),
             dataclasses.replace(mknode(S.T, "n1"), prefer_avoid_pods=True)]
    tables, ex, pe, d, keys = S.encode(
        nodes, [], [mkpod(S.T, "a"), mkpod(S.T, "b"), mkpod(S.T, "c")])
    ctx = S.F.build_context(tables, ex, pe, keys[0], keys[1], d.D)
    got = as_np(S.P.NodePreferAvoidPods().score_matrix(S.F.CycleState(), ctx))
    assert got.shape == (pe.valid.shape[0], tables.nodes.valid.shape[0])
    assert (got[:, 0] == 100.0).all() and (got[:, 1] == 0.0).all()


# --------------------------------------------------------------------- #
# tests/test_waves.py's NodePreferAvoidPods case, both packages
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("side", SIDES)
def test_decisive_score_gap_not_steamrolled_by_spreading(side):
    """EngineConfig.w_window: a node trailing the class max by more than
    the window gets no same-wave spillover while the preferred node has
    room (a NodePreferAvoidPods gap at weight 100)."""
    S = Side(side)
    T = S.T
    from kubernetes_tpu.state.cache import SchedulerCache as JCache
    from kubernetes_tpu_torch.state.cache import SchedulerCache as TCache

    c = JCache() if side == "jax" else TCache()
    enc = JEncoder() if side == "jax" else TEncoder()
    c.add_node(dataclasses.replace(
        T.Node(name="avoided",
               allocatable=T.Resources.make(cpu="8", memory="16Gi", pods=110)),
        prefer_avoid_pods=True))
    c.add_node(T.Node(name="normal", allocatable=T.Resources.make(
        cpu="8", memory="16Gi", pods=110)))
    pods = [T.Pod(name=f"p{i}", requests=T.Resources.make(cpu="100m",
                                                           memory="64Mi"),
                  creation_index=i) for i in range(6)]
    if side == "jax":
        snap, keys = JC.snapshot_with_keys(c, enc, pods, None)
        res = JC._schedule_batch(snap.tables, snap.pending, keys, snap.dims.D,
                                 snap.existing,
                                 extra_plugins=(JP.NodePreferAvoidPods(),),
                                 extra_weights=(100.0,))
    else:
        snap, keys = TC.snapshot_with_keys(c, enc, pods, None, device=CPU)
        res = TC.schedule_batch(snap.tables, snap.pending, keys, snap.dims.D,
                                snap.existing,
                                extra_plugins=(TP.NodePreferAvoidPods(),),
                                extra_weights=(100.0,))
    names = [snap.node_order[i] for i in as_np(res.node)[:6]]
    assert names == ["normal"] * 6, names


# --------------------------------------------------------------------- #
# the plugin rows, cross-package, on one encoding
# --------------------------------------------------------------------- #


def _interp_case(xs, ys, x):
    got = TP.interp(torch.tensor(x, dtype=torch.float32),
                    torch.tensor(xs, dtype=torch.float32),
                    torch.tensor(ys, dtype=torch.float32))
    ref = jnp.interp(jnp.asarray(x, jnp.float32),
                     jnp.asarray(xs, jnp.float32),
                     jnp.asarray(ys, jnp.float32))
    np.testing.assert_array_equal(as_np(got), as_np(ref))


@pytest.mark.parametrize("shape", [
    [(0, 0), (50, 80), (100, 100)],
    [(0, 100), (100, 0)],                       # one segment
    [(0, 10), (50, 30), (50, 90), (100, 0)],    # a zero-width segment
    [(-20, 5), (0, 0), (0, 60), (120, 100)],    # points outside 0–100
    [(30, 7)],                                  # a single point
    [(0, 0), (33.3, 17.1), (66.7, 93.9), (100, 41.5)],
])
def test_interp_equals_jnp_interp_bitwise(shape):
    """RequestedToCapacityRatio's broken-linear shape: the port's rebuild
    of jnp.interp agrees bit for bit, including at the knots, on repeated
    x and beyond either end."""
    rs = np.random.RandomState(7)
    xs = [float(p[0]) for p in shape]
    ys = [float(p[1]) for p in shape]
    x = np.concatenate([rs.uniform(-50, 150, 512), np.asarray(xs),
                        np.asarray(xs) + 1e-3, [0.0, 100.0, 49.99, 50.0]])
    _interp_case(xs, ys, x.astype(np.float32))


def sweep_cluster(seed, n_nodes=200, n_pods=1000, n_existing=300):
    """A 200-node cluster and a 1,000-pod backlog from 24 numpy-drawn pod
    templates (requests, limits, nodeSelector disktype, a dedicated-taint
    toleration, zone spread, hostname anti-affinity), 300 of them bound;
    nodes with disktype/gpu labels, the preferAvoidPods annotation,
    unschedulable and tainted ones (JAX package types)."""
    rs = np.random.RandomState(seed)
    T = JT
    nodes = []
    for i in range(n_nodes):
        labels = {HOSTNAME: f"n{i}", ZONE: f"z{rs.randint(4)}"}
        if rs.rand() < 0.3:
            labels["disktype"] = "ssd"
        if rs.rand() < 0.2:
            labels["gpu"] = "true"
        taints = ((T.Taint("dedicated", "infra", T.TaintEffect.NO_SCHEDULE),)
                  if rs.rand() < 0.1 else ())
        nodes.append(T.Node(
            name=f"n{i}", labels=labels, taints=taints,
            unschedulable=bool(rs.rand() < 0.03),
            prefer_avoid_pods=bool(rs.rand() < 0.1),
            allocatable=T.Resources.make(
                cpu=str(rs.choice([4, 8, 16])),
                memory=str(rs.choice(["8Gi", "16Gi", "32Gi"])), pods=110)))
    templates = []
    for k in range(24):
        app = {"app": f"t{k}"}
        kw = {}
        if rs.rand() < 0.4:
            kw["limits"] = T.Resources.make(
                cpu=str(rs.choice(["1", "4", "12", "20"])),
                memory=str(rs.choice(["0", "1Gi", "20Gi", "40Gi"])))
        if rs.rand() < 0.2:
            kw["node_selector"] = {"disktype": "ssd"}
        if rs.rand() < 0.2:
            kw["tolerations"] = (T.Toleration(
                key="dedicated", op=T.TolerationOp.EQUAL, value="infra",
                effect=T.TaintEffect.NO_SCHEDULE),)
        if rs.rand() < 0.3:
            kw["topology_spread"] = (T.TopologySpreadConstraint(
                max_skew=int(rs.randint(1, 3)), topology_key=ZONE,
                when_unsatisfiable=list(T.UnsatisfiableAction)[
                    rs.randint(2)],
                selector=T.LabelSelector.of(match_labels=app)),)
        if rs.rand() < 0.2:
            kw["affinity"] = T.Affinity(anti_required=(T.PodAffinityTerm(
                selector=T.LabelSelector.of(match_labels=app),
                topology_key=HOSTNAME),))
        templates.append(dict(
            labels=app,
            requests=T.Resources.make(
                cpu=str(rs.choice(["100m", "250m", "500m", "1", "2"])),
                memory=str(rs.choice(["128Mi", "512Mi", "1Gi", "2Gi"]))),
            priority=int(rs.choice([0, 0, 100])), **kw))
    pick = rs.randint(len(templates), size=n_pods + n_existing)
    pods = [T.Pod(name=f"p{i}", creation_index=i, **templates[pick[i]])
            for i in range(n_pods)]
    existing = [T.Pod(name=f"e{i}", creation_index=n_pods + i,
                      node_name=f"n{rs.randint(n_nodes)}",
                      **templates[pick[n_pods + i]])
                for i in range(n_existing)]
    return nodes, existing, pods


DEFAULT_FILTERS = ("NodeUnschedulable", "NodeName", "NodePorts",
                   "NodeAffinity", "NodeResourcesFit", "TaintToleration",
                   "InterPodAffinity", "PodTopologySpread",
                   "VolumeRestrictions", "NodeVolumeLimits")
DEFAULT_SCORES = ("NodeResourcesLeastAllocated",
                  "NodeResourcesBalancedAllocation", "NodeAffinityScore",
                  "TaintToleration", "InterPodAffinity", "PodTopologySpread",
                  "SelectorSpread", "ImageLocality")
EXTRA_SCORES = ("NodeResourcesMostAllocated", "NodeLabel",
                "RequestedToCapacityRatio", "NodeResourcesResourceLimits",
                "NodePreferAvoidPods")
# weights f32 cannot hold exactly beside ones it can
WEIGHTS = (0.1, 1.0 / 3.0, 0.7, 1.1, 7.3, 1e-3, 2.0, 3.0, 2.5)


def sweep_config(seed) -> dict:
    """A random KubeSchedulerConfiguration dict from a numpy seed."""
    rs = np.random.RandomState(1000 + seed)
    enabled = [{"name": n, "weight": float(rs.choice(WEIGHTS))}
               for n in EXTRA_SCORES if rs.rand() < 0.7]
    enabled += [{"name": n, "weight": float(rs.choice(WEIGHTS))}
                for n in DEFAULT_SCORES if rs.rand() < 0.3]
    xs = sorted(float(x) for x in rs.choice(
        [-20, 0, 0, 30, 50, 50, 70, 100, 120], size=rs.randint(2, 5)))
    shape = [{"utilization": x, "score": float(rs.randint(0, 101))}
             for x in xs]
    present = [k for k in ("disktype", "gpu", "no-such-key") if rs.rand() < 0.6]
    absent = [k for k in ("gpu", "missing", "disktype") if rs.rand() < 0.5]
    return {
        "kind": "KubeSchedulerConfiguration",
        "hardPodAffinitySymmetricWeight": int(rs.choice([1, 2, 5])),
        "scoreAdmissionWindow": float(rs.choice([100.0, 37.5, 0.0])),
        "plugins": {
            "filter": {"disabled": [f for f in DEFAULT_FILTERS
                                    if rs.rand() < 0.2]},
            "score": {"disabled": [s for s in DEFAULT_SCORES
                                   if rs.rand() < 0.3],
                      "enabled": enabled},
        },
        "pluginConfig": [
            {"name": "RequestedToCapacityRatio", "args": {"shape": shape}},
            {"name": "NodeLabel", "args": {"present": present,
                                           "absent": absent}},
        ],
    }


def _composition(load, cfg_dict, vocab):
    """(engine config, hard weight, extras, weights) of one package's
    loaded config, NodeLabel's keys resolved against the shared vocab."""
    cfg = load(cfg_dict)
    fw = cfg.build_framework()
    for pl in fw.score_plugins:
        if type(pl).__name__ == "NodeLabel":
            pl._present_ids = tuple(vocab.get(k) for k in pl.present)
            pl._absent_ids = tuple(vocab.get(k) for k in pl.absent)
    mod = JP if load is j_load_config else TP
    extra = mod.extra_score_plugins(fw)
    return (cfg.engine_config(), cfg.hard_pod_affinity_symmetric_weight,
            tuple(p for p, _ in extra), tuple(w for _, w in extra))


@functools.lru_cache(maxsize=None)
def _sweep_encoding(seed):
    return encode(*sweep_cluster(seed))


@pytest.mark.parametrize("seed", range(6))
def test_configured_sweep_matches_jax(seed):
    """A random configuration on a 200-node × 1,000-pod cluster: _feasible
    equal, _scores within F32_ATOL with -inf where the JAX package's is,
    and schedule_batch's placements equal (the wave engine with the
    configured flags, weights, hard weight and extras bias)."""
    enc = _sweep_encoding(seed)
    vocab = enc["encoder"].vocabs.label_keys
    cfg = sweep_config(seed)
    jcfg, hw, jex, jw = _composition(j_load_config, cfg, vocab)
    tcfg, hw2, tex, tw = _composition(t_load_config, cfg, vocab)
    assert hw == hw2 and jw == tw
    assert [type(p).__name__ for p in jex] == [type(p).__name__ for p in tex]
    assert_same(jcfg, tcfg, "engine_config")
    jt, jxe, jpe = enc["jax"]
    tt, txe, tpe = enc["torch"]
    uk, ev = enc["keys"]
    jkeys, d = (jnp.int32(uk), jnp.int32(ev)), enc["dims"]

    jm = as_np(JC._feasible(jt, jpe, jkeys, d.D, jxe, hw, jcfg))
    tm = as_np(TC._feasible(tt, tpe, (uk, ev), d.D, txe, hw, tcfg))
    np.testing.assert_array_equal(tm, jm)
    js = as_np(JC._scores(jt, jpe, jkeys, d.D, jxe, hw, jcfg, jex, jw))
    ts = as_np(TC._scores(tt, tpe, (uk, ev), d.D, txe, hw, tcfg, tex, tw))
    np.testing.assert_array_equal(np.isinf(ts), np.isinf(js))
    fin = np.isfinite(js)
    # F32_ATOL, or two f32 ulps of the JAX package's value where that is
    # larger (|score| ≥ 512): XLA's CPU backend contracts some of the
    # engine's weighted sum `s + w·x + …` into fused multiply-adds, as its
    # fusion decides, so with weights f32 cannot hold a row may differ in
    # its last bits (measured: ≤ 2 ulps; ROADMAP §C). The plugin rows
    # themselves are bit-equal (test_plugin_rows_match_jax).
    tol = np.maximum(F32_ATOL, 2 * np.spacing(np.abs(js[fin])))
    assert (np.abs(ts[fin] - js[fin]) <= tol).all(), \
        float(np.abs(ts[fin] - js[fin]).max())

    jres = JC._schedule_batch(jt, jpe, jkeys, d.D, jxe,
                              has_node_name=d.has_node_name, hard_weight=hw,
                              ecfg=jcfg, extra_plugins=jex, extra_weights=jw)
    tres = TC.schedule_batch(tt, tpe, (uk, ev), d.D, txe,
                             has_node_name=d.has_node_name, hard_weight=hw,
                             ecfg=tcfg, extra_plugins=tex, extra_weights=tw)
    np.testing.assert_array_equal(as_np(tres.node), as_np(jres.node))
    assert_same(jres.state.used, tres.state.used, "used")
    assert int((as_np(jres.node) >= 0).sum()) > 0


@functools.lru_cache(maxsize=None)
def _rows_contexts():
    """One 40-node × 60-pod encoding and both packages' TensorContexts."""
    nodes, existing, pods = sweep_cluster(11, n_nodes=40, n_pods=60,
                                          n_existing=50)
    enc = encode(nodes, existing, pods)
    jt, jxe, jpe = enc["jax"]
    tt, txe, tpe = enc["torch"]
    uk, ev = enc["keys"]
    D = enc["dims"].D
    jctx = jax.jit(JF.build_context, static_argnums=(5,))(
        jt, jxe, jpe, jnp.int32(uk), jnp.int32(ev), D)
    return enc, jctx, TF.build_context(tt, txe, tpe, uk, ev, D)


@pytest.mark.parametrize("name,cfg", [
    ("NodeResourcesFit", {}), ("NodeAffinity", {}), ("NodeName", {}),
    ("NodePorts", {}), ("NodeUnschedulable", {}), ("TaintToleration", {}),
    ("InterPodAffinity", {}), ("PodTopologySpread", {}),
    ("VolumeRestrictions", {}), ("NodeVolumeLimits", {}),
    ("NodeResourcesLeastAllocated", {}),
    ("NodeResourcesBalancedAllocation", {}),
    ("NodeResourcesMostAllocated", {}), ("NodePreferAvoidPods", {}),
    ("NodeAffinityScore", {}), ("SelectorSpread", {}), ("ImageLocality", {}),
    ("NodeLabel", {"present": ["disktype", "nope"],
                   "absent": ["gpu", "missing"]}),
    ("RequestedToCapacityRatio",
     {"shape": [{"utilization": 0, "score": 0},
                {"utilization": 50, "score": 80},
                {"utilization": 100, "score": 100}]}),
    ("NodeResourcesResourceLimits", {}),
])
def test_plugin_rows_match_jax(name, cfg):
    """Every in-tree plugin on one encoding: filter masks equal, score rows
    bit-equal (the B15 rows, framework/plugins.py; F32_ATOL would do)."""
    enc, jctx, tctx = _rows_contexts()
    vocab = enc["encoder"].vocabs.label_keys
    jp = JP.default_registry()[name](dict(cfg))
    tp = TP.default_registry()[name](dict(cfg))
    for pl in (jp, tp):
        if name == "NodeLabel":
            pl._present_ids = tuple(vocab.get(k) for k in pl.present)
            pl._absent_ids = tuple(vocab.get(k) for k in pl.absent)
    state = JF.CycleState()
    if isinstance(jp, JF.FilterPlugin):
        assert_same(jp.filter_mask(state, jctx),
                    tp.filter_mask(TF.CycleState(), tctx), name)
    if isinstance(jp, JF.ScorePlugin):
        ref = jp.score_matrix(state, jctx)
        got = tp.score_matrix(TF.CycleState(), tctx)
        assert got.dtype == torch.float32
        assert_same(ref, got, name, atol=0.0)


def test_default_framework_composition_matches_jax():
    """RunFilterPlugins / RunScorePlugins of the default framework at
    weights f32 cannot hold: the [P, N] AND equal, the weighted sum within
    F32_ATOL."""
    _enc, jctx, tctx = _rows_contexts()
    weights = dict(zip(DEFAULT_SCORES, WEIGHTS))
    jfw = JF.default_framework(score_weights=weights)
    tfw = TF.default_framework(score_weights=weights)
    assert_same(jfw.run_filter_plugins(JF.CycleState(), jctx),
                tfw.run_filter_plugins(TF.CycleState(), tctx), "filter")
    assert_same(jfw.run_score_plugins(JF.CycleState(), jctx),
                tfw.run_score_plugins(TF.CycleState(), tctx), "score")
