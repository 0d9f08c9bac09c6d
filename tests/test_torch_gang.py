"""Parity of the port's gang engine (kubernetes_tpu_torch/ops/gang.py, its
wiring in sched/cycle.py and the serving Scheduler) with the JAX package's
(kubernetes_tpu/ops/gang.py and sched/cycle.py).

The JAX package runs the rejection rounds in two routes: a lax.while_loop
(`assign_gang`) and, above 65,536 pending pods, one dispatch per round
(`_schedule_gang_host_rounds`). The port's single host loop is held against
both on the same encoded inputs: node, feasible, the dead-group mask and the
wave index per pod, exactly. Also here, on both packages:
tests/test_gang.py's all-or-nothing and contention cases through
BatchScheduler, its randomized soundness seeds, a nodeName gang batch on the
scan route, its stateful-Scheduler cases, and its Coscheduling Permit cases
(the host waiting-map path of the framework's Coscheduling plugin).
"""

import dataclasses
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu as kt
import kubernetes_tpu.api.types as JT
import kubernetes_tpu_torch as ktt
import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu.ops.assign import initial_state as j_initial_state
from kubernetes_tpu.ops.gang import assign_gang as j_assign_gang
from kubernetes_tpu.ops.lattice import build_cycle as j_build_cycle
from kubernetes_tpu.sched.cycle import (UNSCHEDULABLE_TAINT_KEY,
                                        _schedule_batch,
                                        _schedule_gang_host_rounds)
from kubernetes_tpu.sched.scheduler import RecordingBinder as JBinder
from kubernetes_tpu.sched.scheduler import Scheduler as JScheduler
from kubernetes_tpu.state.dims import Dims
from kubernetes_tpu.state.encode import Encoder
from kubernetes_tpu_torch.ops.assign import initial_state as t_initial_state
from kubernetes_tpu_torch.ops.gang import GangArrays, assign_gang
from kubernetes_tpu_torch.ops.lattice import build_cycle as t_build_cycle
from kubernetes_tpu_torch.sched.cycle import schedule_batch
from kubernetes_tpu_torch.sched.scheduler import RecordingBinder as TBinder
from kubernetes_tpu_torch.sched.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.state.arrays import tables_to_torch, to_device
from test_golden import rand_node, rand_pod
from torch_parity import as_np

CPU = torch.device("cpu")
PKGS = {"jax": (JT, lambda: kt.BatchScheduler()),
        "port": (TT, lambda: ktt.BatchScheduler(device="cpu"))}


def mknodes(T, n, cpu="4"):
    return [T.Node(name=f"n{i}",
                   allocatable=T.Resources.make(cpu=cpu, memory="8Gi",
                                                pods=110))
            for i in range(n)]


def gang_pods(T, prefix, count, group, min_member, cpu="1", priority=0,
              base=0):
    return [T.Pod(name=f"{prefix}{i}", requests=T.Resources.make(cpu=cpu),
                  pod_group=group, min_member=min_member,
                  priority=priority, creation_index=base + i)
            for i in range(count)]


# --------------------------------------------------------------------- #
# tests/test_gang.py TestAllOrNothing and TestContention, both packages
# --------------------------------------------------------------------- #


def feasible_group_places_fully(T):
    return mknodes(T, 4), [], gang_pods(T, "a", 4, "jobA", 4), \
        lambda r: r.scheduled == 4 and r.failed == 0


def infeasible_group_places_nothing(T):
    return mknodes(T, 4), [], gang_pods(T, "b", 6, "jobB", 6, cpu="3"), \
        lambda r: r.scheduled == 0 and r.failed == 6


def min_member_below_count_allows_partial_above_min(T):
    return mknodes(T, 4), [], gang_pods(T, "c", 6, "jobC", 4, cpu="3"), \
        lambda r: r.scheduled == 4 and r.failed == 2


def ungrouped_pods_unaffected_by_rejections(T):
    pods = gang_pods(T, "d", 6, "jobD", 6, cpu="3") + [
        T.Pod(name="solo", requests=T.Resources.make(cpu="1"),
              creation_index=50)]
    return mknodes(T, 4), [], pods, lambda r: (
        r.assignments[-1] is not None
        and all(a is None for a in r.assignments[:6]))


def bound_members_count_toward_quorum(T):
    bound = [dataclasses.replace(p, node_name=f"n{i}") for i, p in
             enumerate(gang_pods(T, "e", 2, "jobE", 4, cpu="3"))]
    return mknodes(T, 4), bound, \
        gang_pods(T, "f", 2, "jobE", 4, cpu="3", base=10), \
        lambda r: r.scheduled == 2


def older_group_wins_resource_pocket(T):
    pods = (gang_pods(T, "a", 8, "jobA", 8, cpu="2", base=0)
            + gang_pods(T, "b", 8, "jobB", 8, cpu="2", base=100))
    return mknodes(T, 4), [], pods, lambda r: (
        all(x is not None for x in r.assignments[:8])
        and all(x is None for x in r.assignments[8:]))


def higher_priority_group_wins(T):
    pods = (gang_pods(T, "a", 8, "jobA", 8, cpu="2", base=0)
            + gang_pods(T, "c", 8, "jobC", 8, cpu="2", base=200,
                        priority=100))
    return mknodes(T, 4), [], pods, lambda r: (
        all(x is None for x in r.assignments[:8])
        and all(x is not None for x in r.assignments[8:]))


def three_way_contention_converges(T):
    pods = [p for i, g in enumerate("xyz")
            for p in gang_pods(T, g, 8, f"job{g}", 8, cpu="2", base=i * 100)]

    def check(r):
        placed = [sum(a is not None for a in r.assignments[i * 8:(i + 1) * 8])
                  for i in range(3)]
        return sorted(placed) == [0, 0, 8] and placed[0] == 8
    return mknodes(T, 4), [], pods, check


BATCH_CASES = [feasible_group_places_fully, infeasible_group_places_nothing,
               min_member_below_count_allows_partial_above_min,
               ungrouped_pods_unaffected_by_rejections,
               bound_members_count_toward_quorum,
               older_group_wins_resource_pocket, higher_priority_group_wins,
               three_way_contention_converges]


@pytest.mark.parametrize("case", BATCH_CASES, ids=lambda c: c.__name__)
def test_gang_batch_matches_jax(case):
    out = {}
    for side, (T, make) in PKGS.items():
        nodes, existing, pending, check = case(T)
        out[side] = make().schedule(nodes, existing, pending)
        assert check(out[side]), side
    assert out["port"].assignments == out["jax"].assignments
    assert (out["port"].scheduled, out["port"].failed) == \
        (out["jax"].scheduled, out["jax"].failed)


def test_gang_workload_matches_jax():
    """BASELINE config 5's workload at a small scale: 1,600 gang pods in 50
    jobs of 8 to 64 members, one of them a 'monster' no node can hold, on
    32 nodes: the same placements, and the same groups placed nowhere."""
    from kubernetes_tpu.models import workloads as JW
    from kubernetes_tpu_torch.models import workloads as TW

    out = {}
    for side, W in (("jax", JW), ("port", TW)):
        nodes = W.make_nodes(32, zones=4, racks_per_zone=2)
        pods = W.gang_workload_pods(1600)
        res = PKGS[side][1]().schedule(nodes, [], pods)
        placed = {}
        for p, a in zip(pods, res.assignments):
            placed[p.pod_group] = placed.get(p.pod_group, 0) + (a is not None)
        out[side] = (res.assignments,
                     sorted(g for g, n in placed.items() if n == 0))
    assert out["port"] == out["jax"]
    assert "job-49" in out["port"][1]          # the monster
    assert 0 < sum(a is not None for a in out["port"][0]) < 1600


# --------------------------------------------------------------------- #
# assign_gang against both JAX routes, on tests/test_gang.py's seeds
# --------------------------------------------------------------------- #


# one capacity set for all six seeds (their union): the JAX side compiles
# each route once
SEED_DIMS = Dims(N=8, P=16, E=8, R=8, S=18, SR=16, SL=16, SN=16, STL=16,
                 SC=18, SV=8, GR=8)


def _encode(nodes, existing, pending, base=None):
    enc = Encoder()
    enc.vocabs.label_keys.intern(UNSCHEDULABLE_TAINT_KEY)
    enc.vocabs.label_vals.intern("")
    tables, ex, pe, d = enc.encode_cluster(nodes, existing, pending, base)
    uk = enc.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY)
    ev = enc.vocabs.label_vals.get("")
    return tables, ex, pe, enc.build_gang_arrays(pending, d), uk, ev, d


@functools.partial(jax.jit, static_argnums=(6, 7))
def _j_device_loop(tables, ex, pe, gang, uk, ev, D, soft_rounds=4):
    cyc = j_build_cycle(tables, ex, uk, ev, D)
    init = j_initial_state(tables, cyc)
    return j_assign_gang(tables, cyc, pe, init, gang,
                         soft_rounds=soft_rounds, return_waves=True)


def _port_gang(tables, ex, pe, gang, uk, ev, D, **kw):
    tt, (ext, pet) = tables_to_torch(tables, (ex, pe), CPU)
    g = GangArrays(*(to_device(a, CPU) for a in gang))
    cyc = t_build_cycle(tt, ext, uk, ev, D)
    return assign_gang(tt, cyc, pet, t_initial_state(tt, cyc), g, **kw)


def _soundness_case(seed):
    """tests/test_gang.py test_gang_soundness_randomized's draws."""
    rng = random.Random(7000 + seed)
    n_nodes = rng.randint(4, 8)
    nodes = [rand_node(rng, i) for i in range(n_nodes)]
    existing = [rand_pod(rng, 100 + i, bound_to=rng.choice(nodes).name)
                for i in range(rng.randint(0, 4))]
    pending = [rand_pod(rng, i) for i in range(rng.randint(8, 14))]
    n_groups = rng.randint(1, 3)
    for i, p in enumerate(pending):
        if rng.random() < 0.6:
            g = rng.randrange(n_groups)
            pending[i] = dataclasses.replace(
                p, pod_group=f"g{g}", min_member=rng.randint(1, 4))
    return nodes, existing, pending


@pytest.mark.parametrize("seed", range(6))
def test_assign_gang_matches_both_jax_routes(seed):
    nodes, existing, pending = _soundness_case(seed)
    tables, ex, pe, gang, uk, ev, d = _encode(nodes, existing, pending,
                                              SEED_DIMS)
    assert gang is not None and d == SEED_DIMS, d
    jx = (jax.device_put(tables), jax.device_put(ex), jax.device_put(pe))
    ref, ref_dead, ref_waves = _j_device_loop(*jx, gang, jnp.int32(uk),
                                              jnp.int32(ev), d.D)
    host, host_waves = _schedule_gang_host_rounds(
        jx[0], jx[2], (jnp.int32(uk), jnp.int32(ev)), d.D, jx[1], 1.0, None,
        (), (), gang)
    got, dead, waves = _port_gang(tables, ex, pe, gang, uk, ev, d.D,
                                  return_waves=True)
    for name, want in (("device loop", (ref, ref_waves)),
                       ("host rounds", (host, host_waves))):
        np.testing.assert_array_equal(as_np(got.node), as_np(want[0].node),
                                      err_msg=name)
        np.testing.assert_array_equal(as_np(got.feasible),
                                      as_np(want[0].feasible), err_msg=name)
        np.testing.assert_array_equal(as_np(waves), as_np(want[1]),
                                      err_msg=name)
    np.testing.assert_array_equal(as_np(dead), as_np(ref_dead))
    for f in ("used", "CNT", "HOLD"):
        np.testing.assert_array_equal(as_np(getattr(got.state, f)),
                                      as_np(getattr(ref.state, f)), err_msg=f)

    # no partial group commits (keyed by namespaced group)
    node_idx = as_np(got.node)[: len(pending)]
    groups = {}
    for i, p in enumerate(pending):
        if p.pod_group:
            groups.setdefault(f"{p.namespace}/{p.pod_group}", []).append(i)
    for members in groups.values():
        placed = sum(node_idx[i] >= 0 for i in members)
        needed = max(pending[i].min_member for i in members)
        assert placed == 0 or placed >= needed


def test_soft_rounds_bulk_tail_matches_jax():
    """Contention where it matters when the single rejections give way to the
    bulk tail: 7 jobs of 3 to 5 members on 5 nodes. Rejecting every
    underfilled group at once from the first rejection round (soft_rounds
    0) places other pods than rejecting one partial group first (1, 4); the
    port equals the JAX package at each."""
    rng = random.Random(0)
    pods = []
    for i in range(rng.randint(4, 7)):
        size = rng.choice([3, 4, 5])
        pods += gang_pods(JT, f"j{i}-", size, f"job{i}", size,
                          cpu=rng.choice(["1", "2", "3"]), base=10 * i,
                          priority=rng.randrange(3))
    tables, ex, pe, gang, uk, ev, d = _encode(
        mknodes(JT, rng.randint(3, 6)), [], pods)
    jx = (jax.device_put(tables), jax.device_put(ex), jax.device_put(pe))
    nodes = {}
    for soft in (0, 1, 4):
        ref, ref_dead, ref_waves = _j_device_loop(
            *jx, gang, jnp.int32(uk), jnp.int32(ev), d.D, soft)
        got, dead, waves = _port_gang(tables, ex, pe, gang, uk, ev, d.D,
                                      return_waves=True, soft_rounds=soft)
        np.testing.assert_array_equal(as_np(got.node), as_np(ref.node))
        np.testing.assert_array_equal(as_np(dead), as_np(ref_dead))
        np.testing.assert_array_equal(as_np(waves), as_np(ref_waves))
        assert int(as_np(dead).sum()) > 0
        nodes[soft] = as_np(got.node).tolist()
    assert nodes[0] != nodes[1]


def test_node_name_gang_batch_takes_the_scan_route():
    """A gang batch holding a spec.nodeName pod runs the gang rounds over
    the sequential scan (JAX sched/cycle.py:172-183), with no wave
    indices."""
    nodes = mknodes(JT, 4)
    pods = (gang_pods(JT, "a", 4, "jobA", 4, cpu="3")
            + gang_pods(JT, "b", 3, "jobB", 3, cpu="2", base=10)
            + [JT.Pod(name="pinned", requests=JT.Resources.make(cpu="1"),
                      node_name="n1", creation_index=50)])
    tables, ex, pe, gang, uk, ev, d = _encode(nodes, [], pods)
    assert d.has_node_name
    ref, ref_waves = _schedule_batch(
        jax.device_put(tables), jax.device_put(pe),
        (jnp.int32(uk), jnp.int32(ev)), d.D, jax.device_put(ex),
        has_node_name=True, gang=gang, return_waves=True)
    assert ref_waves is None
    tt, (ext, pet) = tables_to_torch(tables, (ex, pe), CPU)
    got, waves = schedule_batch(
        tt, pet, (uk, ev), d.D, ext, has_node_name=True,
        gang=GangArrays(*(to_device(a, CPU) for a in gang)),
        return_waves=True)
    assert waves is None
    np.testing.assert_array_equal(as_np(got.node), as_np(ref.node))
    assert as_np(got.node)[len(pods) - 1] == 1


# --------------------------------------------------------------------- #
# tests/test_gang.py TestStatefulScheduler on both packages' Scheduler
# --------------------------------------------------------------------- #

SCHEDS = {"jax": (JT, JScheduler, JBinder), "port": (TT, TScheduler, TBinder)}


def _scheduler(side, clock=None):
    T, sched_cls, binder_cls = SCHEDS[side]
    kw = {"device": "cpu"} if side == "port" else {}
    if clock is not None:
        kw["clock"] = clock
    s = sched_cls(binder=binder_cls(), **kw)
    if side == "jax":
        s.prewarmer.enabled = False
    return T, s


def gang_via_snapshot_path(side):
    T, s = _scheduler(side)
    for n in mknodes(T, 4):
        s.on_node_add(n)
    for p in gang_pods(T, "a", 4, "jobA", 4):
        s.on_pod_add(p)
    for p in gang_pods(T, "b", 6, "jobB", 6, cpu="3", base=10):
        s.on_pod_add(p)
    st = s.schedule_pending()
    assert (st.scheduled, st.unschedulable) == (4, 6)
    assert {k for k, _ in s.binder.bound} == {f"default/a{i}"
                                              for i in range(4)}
    return [(st.scheduled, st.unschedulable, sorted(st.failed_keys))], s


def rejected_gang_retries_when_capacity_frees(side):
    now = [0.0]
    T, s = _scheduler(side, clock=lambda: now[0])
    for n in mknodes(T, 2):
        s.on_node_add(n)
    blocker = [T.Pod(name=f"x{i}", requests=T.Resources.make(cpu="4"),
                     node_name=f"n{i}", creation_index=i) for i in range(2)]
    for p in blocker:
        s.on_pod_add(p)
    for p in gang_pods(T, "g", 2, "jobG", 2, cpu="3", base=10):
        s.on_pod_add(p)
    first = s.schedule_pending()
    assert first.scheduled == 0
    for p in blocker:
        s.on_pod_delete(p)
    now[0] = 60.0
    st = s.run_until_idle()
    assert len(s.binder.bound) == 2
    return [(first.scheduled, first.unschedulable),
            (st.scheduled, st.unschedulable)], s


def gang_bound_counts_net_out_in_cache(side):
    T, s = _scheduler(side)
    for n in mknodes(T, 4):
        s.on_node_add(n)
    for i, p in enumerate(gang_pods(T, "e", 2, "jobE", 4, cpu="3")):
        s.on_pod_add(dataclasses.replace(p, node_name=f"n{i}"))
    for p in gang_pods(T, "f", 2, "jobE", 4, cpu="3", base=10):
        s.on_pod_add(p)
    st = s.schedule_pending()
    assert st.scheduled == 2
    assert s.cache.group_bound_count("default/jobE") == 4
    return [(st.scheduled, st.unschedulable)], s


@pytest.mark.parametrize("scenario", [
    gang_via_snapshot_path, rejected_gang_retries_when_capacity_frees,
    gang_bound_counts_net_out_in_cache], ids=lambda f: f.__name__)
def test_stateful_gang_matches_jax(scenario):
    out = {}
    for side in SCHEDS:
        stats, s = scenario(side)
        out[side] = (stats, list(s.binder.bound), s.cache.counts(),
                     s.queue.lengths())
    assert out["port"] == out["jax"]


def test_snapshot_gang_lives_on_the_device_as_a_copy():
    """The serving snapshot's GangArrays are tensors on the snapshot's device,
    copied from the encoder's arrays (state/arrays.py to_device)."""
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    from kubernetes_tpu_torch.state.encode import Encoder as TEncoder

    cache, enc = SchedulerCache(), TEncoder()
    for n in mknodes(TT, 2):
        cache.add_node(n)
    pods = gang_pods(TT, "a", 3, "jobA", 3)
    snap = cache.snapshot(enc, pods, device="cpu")
    g = snap.gang
    assert isinstance(g, GangArrays)
    assert all(isinstance(t, torch.Tensor) for t in g)
    assert g.group.dtype == torch.int32 and g.valid.dtype == torch.bool
    assert g.group[:3].tolist() == [0, 0, 0] and int(g.needed[0]) == 3
    plain = cache.snapshot(enc, [TT.Pod(name="solo")], device="cpu")
    assert plain.gang is None


# --------------------------------------------------------------------- #
# tests/test_gang.py TestCoschedulingPermitPlugin, both packages: the host
# per-pod path — Permit WAIT until quorum, then release
# (framework/plugins.py Coscheduling; waiting_pods_map semantics)
# --------------------------------------------------------------------- #


class TestCoschedulingPermitPlugin:
    def _mk(self, side, timeout=30.0):
        import kubernetes_tpu.framework as JF
        import kubernetes_tpu_torch.framework as TF

        T, sched_cls, binder_cls = SCHEDS[side]
        F = JF if side == "jax" else TF
        plugins = dataclasses.replace(
            F.default_plugins(),
            reserve=F.PluginSet(enabled=["Coscheduling"]),
            permit=F.PluginSet(enabled=["Coscheduling"]),
            unreserve=F.PluginSet(enabled=["Coscheduling"]))
        fw = F.default_framework(plugins=plugins)
        binder = binder_cls()
        kw = {"device": "cpu"} if side == "port" else {}
        s = sched_cls(binder=binder, framework=fw, batch_size=1, **kw)
        if side == "jax":
            s.prewarmer.enabled = False
        cos = next(p for p in fw.permit_plugins if p.name == "Coscheduling")
        cos.on_release = s.complete_waiting
        cos.timeout = timeout
        # the Coscheduling plugin owns the groups: no device gang engine
        assert s._device_gangs is False
        return T, s, binder, cos

    @pytest.mark.parametrize("side", ["jax", "port"])
    def test_members_wait_then_release_on_quorum(self, side):
        self._quorum(side)

    def _quorum(self, side):
        T, s, binder, cos = self._mk(side)
        cos.register_group("default/jobP", 3)
        for n in mknodes(T, 4):
            s.on_node_add(n)
        members = gang_pods(T, "p", 3, "jobP", 3)
        s.on_pod_add(members[0])
        s.schedule_pending()
        assert len(binder.bound) == 0
        assert len(s.framework.waiting_pods()) == 1
        s.on_pod_add(members[1])
        s.schedule_pending()
        assert len(binder.bound) == 0
        assert len(s.framework.waiting_pods()) == 2
        s.on_pod_add(members[2])
        s.schedule_pending()
        assert len(binder.bound) == 3
        assert len(s.framework.waiting_pods()) == 0
        return list(binder.bound)

    @pytest.mark.parametrize("side", ["jax", "port"])
    def test_timeout_rejects_and_requeues_waiters(self, side):
        import time as _time

        T, s, binder, cos = self._mk(side, timeout=5.0)
        cos.register_group("default/jobQ", 3)
        for n in mknodes(T, 4):
            s.on_node_add(n)
        s.on_pod_add(gang_pods(T, "q", 1, "jobQ", 3)[0])
        s.schedule_pending()
        assert len(s.framework.waiting_pods()) == 1
        base = _time.monotonic()
        s.clock = lambda: base + 10_000.0
        s.expire_waiting()
        assert len(s.framework.waiting_pods()) == 0
        assert len(binder.bound) == 0
        assert not cos._reserved.get("default/jobQ")

    def test_release_order_matches_jax(self):
        """The binder's order through quorum equals the JAX package's."""
        out = {side: self._quorum(side) for side in ("jax", "port")}
        assert out["port"] == out["jax"]
