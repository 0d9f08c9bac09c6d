"""Parity of the port's run-collapsed engine (kubernetes_tpu_torch/ops/runs.py
and its wiring) with the JAX package's (kubernetes_tpu/ops/runs.py).

tests/test_runs.py's cases on both packages, on the CPU, each from one
encoded input: the port's assign_runs against the JAX package's, with the
placements and the integer planes (used, CNT, HOLD, the port and volume
words) exact and WSYM compared with == (the sign of zeros ignored), and
the port's runs against its own scan. Then the three traps of the port's
host-side epoch: the running argmax's tie-break by node index (not
position), a -0.0 WSYM cell, and a class whose weight column is all zero
(the commit skips it, as the JAX runs engine does: its WSYM matches that
engine's sign of zeros, not the scan's). test_runs.py's mesh case waits
for the port's mesh (ROADMAP A13).
"""

import dataclasses
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import kubernetes_tpu as kt
import kubernetes_tpu.api.types as JT
import kubernetes_tpu_torch as ktt
import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu.api.types import (Affinity, HostPort, LabelSelector, Node,
                                      Pod, PodAffinityTerm, Resources)
from kubernetes_tpu.ops.assign import assign_batch as j_scan
from kubernetes_tpu.ops.assign import initial_state as j_initial_state
from kubernetes_tpu.ops.lattice import build_cycle as j_build_cycle
from kubernetes_tpu.ops.runs import assign_runs as j_assign_runs
from kubernetes_tpu.ops.runs import plan_runs as j_plan_runs
from kubernetes_tpu.ops.runs import \
    self_interaction_vector as j_self_interaction
from kubernetes_tpu_torch.ops import runs as R
from kubernetes_tpu_torch.ops.assign import assign_batch as t_scan
from kubernetes_tpu_torch.ops.assign import initial_state as t_initial_state
from kubernetes_tpu_torch.ops.lattice import build_cycle as t_build_cycle
from kubernetes_tpu_torch.state.arrays import PodArrays as TPodArrays
from test_golden import rand_node, rand_pod
from torch_parity import as_np, encode

HOSTNAME = "kubernetes.io/hostname"
INT_PLANES = ("used", "ppa", "ppw", "ppt", "CNT", "HOLD", "vol_any", "vol_rw")


@functools.partial(jax.jit, static_argnums=(0, 6, 7))
def _jax_run(engine, tables, ex, pe, uk, ev, D, rc, wsym=None):
    cyc = j_build_cycle(tables, ex, uk, ev, D)
    init = j_initial_state(tables, cyc)
    if wsym is not None:
        init = init._replace(WSYM=wsym)
    if engine == "scan":
        return j_scan(tables, cyc, pe, init)
    return j_assign_runs(tables, cyc, pe, init, rc)


def _plan(pe):
    return j_plan_runs(*(np.asarray(x) for x in (
        pe.cls, pe.priority, pe.creation, pe.valid, pe.node_name_req)))


def _port_run(enc, engine, wsym=None):
    tables, ex, pe = enc["torch"]
    uk, ev = enc["keys"]
    cyc = t_build_cycle(tables, ex, uk, ev, enc["dims"].D)
    init = t_initial_state(tables, cyc)
    if wsym is not None:
        init = init._replace(WSYM=torch.from_numpy(np.array(wsym)))
    if engine == "scan":
        return t_scan(tables, cyc, pe, init)
    return R.assign_runs(tables, cyc, pe, init, _plan(enc["np"][2]).rc)


def _jax(enc, engine, wsym=None):
    tables, ex, pe = enc["jax"]
    uk, ev = enc["keys"]
    return _jax_run(engine, tables, ex, pe, jnp.int32(uk), jnp.int32(ev),
                    enc["dims"].D, _plan(enc["np"][2]).rc,
                    None if wsym is None else jnp.asarray(wsym))


def _assert_runs_agree(nodes, existing, pending):
    """The port's runs against the JAX package's runs (placements, integer
    planes exact, WSYM ==) and against the port's scan (placements)."""
    enc = encode(nodes, existing, pending)
    ref = _jax(enc, "runs")
    got = _port_run(enc, "runs")
    np.testing.assert_array_equal(as_np(got.node), as_np(ref.node))
    np.testing.assert_array_equal(as_np(got.feasible), as_np(ref.feasible))
    for f in INT_PLANES:
        np.testing.assert_array_equal(as_np(getattr(got.state, f)),
                                      as_np(getattr(ref.state, f)), f)
    assert (as_np(got.state.WSYM) == as_np(ref.state.WSYM)).all()
    np.testing.assert_array_equal(as_np(got.node),
                                  as_np(_port_run(enc, "scan").node))
    return as_np(got.node)[:len(pending)]


def _replica(template, i):
    return dataclasses.replace(template, name=f"p{i}", creation_index=i)


# --------------------------------------------------------------------- #
# tests/test_runs.py: golden, boundary, tiers
# --------------------------------------------------------------------- #


def test_runs_match_scan_homogeneous_spread():
    nodes = [Node(name=f"n{i}",
                  allocatable=Resources.make(cpu="4", memory="8Gi", pods=110))
             for i in range(8)]
    pods = [Pod(name=f"p{i}",
                requests=Resources.make(cpu="500m", memory="512Mi"),
                creation_index=i)
            for i in range(24)]
    R.reset_run_stats()
    node = _assert_runs_agree(nodes, [], pods)
    assert (node >= 0).all()
    # one run, closed form, admitted over several epochs (ties on every
    # head score)
    assert R.assign_runs.stats["closed"] == 1
    assert R.assign_runs.stats["fallback"] == 0
    assert R.assign_runs.stats["epochs"] > 1


def test_runs_match_scan_capacity_exhaustion_boundary():
    nodes = [Node(name=f"n{i}",
                  allocatable=Resources.make(cpu="2", memory="2Gi", pods=3))
             for i in range(3)]
    big = Pod(name="t", requests=Resources.make(cpu="900m", memory="900Mi"))
    small = Pod(name="s", requests=Resources.make(cpu="300m", memory="100Mi"))
    pods = [_replica(big, i) for i in range(6)] \
        + [_replica(dataclasses.replace(small, creation_index=0), 10 + i)
           for i in range(8)]
    node = _assert_runs_agree(nodes, [], pods)
    assert (node >= 0).any() and (node < 0).any()


@pytest.mark.parametrize("seed", range(6))
def test_runs_match_scan_golden_random_bursts(seed):
    rng = random.Random(3000 + seed)
    nodes = [rand_node(rng, i) for i in range(rng.randint(3, 7))]
    existing = [rand_pod(rng, 100 + i, bound_to=rng.choice(nodes).name)
                for i in range(rng.randint(0, 5))]
    pending = []
    i = 0
    while len(pending) < 18:
        t = rand_pod(rng, i)
        for _ in range(rng.randint(1, 6)):
            pending.append(_replica(t, i))
            i += 1
    _assert_runs_agree(nodes, existing, pending)


def test_runs_priority_tiers_keep_blocks_contiguous():
    nodes = [Node(name=f"n{i}",
                  allocatable=Resources.make(cpu="4", memory="8Gi", pods=10))
             for i in range(4)]
    lo = Pod(name="lo", requests=Resources.make(cpu="250m", memory="256Mi"),
             priority=0)
    hi = Pod(name="hi", requests=Resources.make(cpu="500m", memory="512Mi"),
             priority=5)
    pods = [dataclasses.replace(hi if i % 2 else lo, name=f"p{i}",
                                creation_index=i) for i in range(12)]
    enc = encode(nodes, [], pods)
    pe = enc["np"][2]
    plan = R.plan_runs(pe.cls, pe.priority, pe.creation, pe.valid,
                       pe.node_name_req)
    assert plan.n_runs == 2 and tuple(plan) == tuple(_plan(pe))
    _assert_runs_agree(nodes, [], pods)


# --------------------------------------------------------------------- #
# tests/test_runs.py: the adversarial runs
# --------------------------------------------------------------------- #


def test_adversarial_self_anti_affinity_zero_slack():
    nodes = [Node(name=f"n{i}", labels={HOSTNAME: f"n{i}"},
                  allocatable=Resources.make(cpu="8", memory="16Gi",
                                             pods=110))
             for i in range(4)]
    sel = LabelSelector.of(match_labels={"app": "db"})
    t = Pod(name="t", labels={"app": "db"},
            requests=Resources.make(cpu="100m", memory="64Mi"),
            affinity=Affinity(anti_required=(
                PodAffinityTerm(selector=sel, topology_key=HOSTNAME),)))
    R.reset_run_stats()
    node = _assert_runs_agree(nodes, [], [_replica(t, i) for i in range(6)])
    assert (node >= 0).sum() == 4 and (node < 0).sum() == 2
    assert R.assign_runs.stats["fallback"] == 1     # self-interacting


def test_adversarial_port_conflicting_replicas():
    nodes = [Node(name=f"n{i}",
                  allocatable=Resources.make(cpu="8", memory="16Gi",
                                             pods=110))
             for i in range(3)]
    t = Pod(name="t", requests=Resources.make(cpu="100m", memory="64Mi"),
            host_ports=(HostPort(8080, "TCP", ""),))
    node = _assert_runs_agree(nodes, [], [_replica(t, i) for i in range(5)])
    placed = node[node >= 0]
    assert len(placed) == 3 and len(set(placed.tolist())) == 3


def test_adversarial_nodename_pinned_mid_run():
    nodes = [Node(name=f"n{i}",
                  allocatable=Resources.make(cpu="4", memory="8Gi",
                                             pods=110))
             for i in range(4)]
    t = Pod(name="t", requests=Resources.make(cpu="250m", memory="256Mi"))
    pods = []
    for i in range(8):
        p = _replica(t, i)
        if i in (3, 4):
            p = dataclasses.replace(p, node_name="n2")
        pods.append(p)
    enc = encode(nodes, [], pods)
    assert _plan(enc["np"][2]).n_runs == 3
    R.reset_run_stats()
    node = _assert_runs_agree(nodes, [], pods)
    assert node[3] == 2 and node[4] == 2
    assert R.assign_runs.stats["fallback"] == 1     # the pinned stretch


def _soft_affinity_case():
    nodes = [Node(name=f"n{i}", labels={HOSTNAME: f"n{i}"},
                  allocatable=Resources.make(cpu="8", memory="16Gi",
                                             pods=110))
             for i in range(5)]
    web_sel = LabelSelector.of(match_labels={"app": "web"})
    existing = [Pod(name=f"w{i}", labels={"app": "web"},
                    requests=Resources.make(cpu="100m", memory="64Mi"),
                    node_name=f"n{i % 2}", creation_index=i)
                for i in range(2)]
    puller = Pod(
        name="t", labels={"app": "cache"},
        requests=Resources.make(cpu="100m", memory="64Mi"),
        affinity=Affinity(pod_preferred=(
            JT.WeightedPodAffinityTerm(
                weight=37,
                term=PodAffinityTerm(selector=web_sel,
                                     topology_key=HOSTNAME)),)))
    web = Pod(name="t2", labels={"app": "web"},
              requests=Resources.make(cpu="150m", memory="96Mi"))
    pods = [_replica(puller, i) for i in range(6)] \
        + [dataclasses.replace(web, name=f"q{i}", creation_index=10 + i)
           for i in range(4)]
    return nodes, existing, pods


def test_adversarial_cross_class_soft_affinity_weight_flow():
    nodes, existing, pods = _soft_affinity_case()
    R.reset_run_stats()
    _assert_runs_agree(nodes, existing, pods)
    assert R.assign_runs.stats["closed"] == 2


def test_adversarial_rw_volume_replicas_cap_one_per_node():
    nodes = [Node(name=f"n{i}",
                  allocatable=Resources.make(cpu="8", memory="16Gi",
                                             pods=110))
             for i in range(3)]
    t = Pod(name="t", requests=Resources.make(cpu="100m", memory="64Mi"),
            volumes=(JT.VolumeRef(vol_id="shared", driver="pd",
                                  read_only=False),))
    node = _assert_runs_agree(nodes, [], [_replica(t, i) for i in range(5)])
    placed = node[node >= 0]
    assert len(placed) == 3 and len(set(placed.tolist())) == 3


# --------------------------------------------------------------------- #
# tests/test_runs.py: gang batches and the preemption drill, both packages
# --------------------------------------------------------------------- #


def test_gang_batches_bit_equal(monkeypatch):
    """The run-collapsed engine inside the gang rounds: the port under runs
    equals the JAX package under runs and the port under the scan."""
    from kubernetes_tpu.models.workloads import gang_workload_pods, make_nodes

    nodes = make_nodes(12, zones=3, racks_per_zone=2, cpu="16",
                       memory="64Gi")
    pods = gang_workload_pods(120)

    def run(engine, sched):
        monkeypatch.setenv("KTPU_ASSIGN", engine)
        return sched().schedule(nodes, [], pods).assignments

    port_runs = run("runs", lambda: ktt.BatchScheduler(device="cpu"))
    assert port_runs == run("runs", kt.BatchScheduler)
    assert port_runs == run("scan", lambda: ktt.BatchScheduler(device="cpu"))
    assert sum(1 for x in port_runs if x is not None) > 0


@pytest.mark.parametrize("engine", ["scan", "runs"])
def test_preemption_drill_bit_equal(monkeypatch, engine):
    """test_runs.py's preemption drill through each package's Scheduler
    with a Preemptor: the same binds and victims under `engine`, and the
    port's runs the same as its scan."""
    from kubernetes_tpu.sched.preemption import Preemptor as JPreemptor
    from kubernetes_tpu.sched.scheduler import RecordingBinder as JBinder
    from kubernetes_tpu.sched.scheduler import Scheduler as JScheduler
    from kubernetes_tpu_torch.sched.preemption import Preemptor as TPreemptor
    from kubernetes_tpu_torch.sched.scheduler import RecordingBinder as TBinder
    from kubernetes_tpu_torch.sched.scheduler import Scheduler as TScheduler

    def drill(T, Sched, Binder, Pre, eng, **kw):
        monkeypatch.setenv("KTPU_ASSIGN", eng)
        clock = {"t": 0.0}
        preemptor = Pre()
        s = Sched(binder=Binder(), clock=lambda: clock["t"],
                  preemptor=preemptor, **kw)
        for i in range(2):
            s.on_node_add(T.Node(
                name=f"n{i}", labels={HOSTNAME: f"n{i}"},
                allocatable=T.Resources.make(cpu="2", memory="4Gi",
                                             pods=10)))
        for i in range(4):
            s.on_pod_add(T.Pod(
                name=f"f{i}", node_name=f"n{i % 2}",
                requests=T.Resources.make(cpu="900m", memory="1800Mi"),
                priority=0, creation_index=i))
        for i in range(3):
            s.on_pod_add(T.Pod(
                name=f"vip{i}", priority=1000,
                requests=T.Resources.make(cpu="1500m", memory="3Gi"),
                creation_index=10 + i))
        for _ in range(4):
            s.schedule_pending()
            clock["t"] += 10.0
        return sorted(s.binder.bound), sorted(preemptor.evictor.evicted)

    got = drill(TT, TScheduler, TBinder, TPreemptor, engine, device="cpu")
    assert got == drill(JT, JScheduler, JBinder, JPreemptor, engine)
    assert got[1], "the drill must evict"
    if engine == "runs":
        assert got == drill(TT, TScheduler, TBinder, TPreemptor, "scan",
                            device="cpu")


# --------------------------------------------------------------------- #
# tests/test_runs.py: the plan and the classifier
# --------------------------------------------------------------------- #


def test_plan_runs_counts_and_bound():
    cls = np.array([0, 0, 0, 1, 1, 2, 0, 0], np.int32)
    pri = np.zeros(8, np.int32)
    cre = np.arange(8, dtype=np.int32)
    valid = np.ones(8, bool)
    nnr = np.full(8, -1, np.int32)
    plan = R.plan_runs(cls, pri, cre, valid, nnr)
    assert tuple(plan) == tuple(j_plan_runs(cls, pri, cre, valid, nnr))
    assert plan.n_runs == 4 and plan.n_valid == 8
    assert plan.rc >= plan.n_runs
    assert plan.collapse_ratio == pytest.approx(2.0)
    valid[5] = False
    plan2 = R.plan_runs(cls, pri, cre, valid, nnr)
    assert tuple(plan2) == tuple(j_plan_runs(cls, pri, cre, valid, nnr))
    assert plan2.n_valid == 7 and plan2.n_runs == 3


def test_plan_runs_extreme_negative_priority_matches_device_order():
    """INT32_MIN priorities wrap alike on the host plan and in the device
    encoding (queue_order's -INT32_MIN == INT32_MIN), in both packages."""
    cls = np.array([0, 1, 0, 1], np.int32)
    pri = np.array([-(2**31), 0, -(2**31), 0], np.int32)
    cre = np.arange(4, dtype=np.int32)
    valid = np.ones(4, bool)
    nnr = np.full(4, -1, np.int32)
    plan = R.plan_runs(cls, pri, cre, valid, nnr)
    assert tuple(plan) == tuple(j_plan_runs(cls, pri, cre, valid, nnr))
    assert plan.n_runs >= 2
    pods = TPodArrays(
        valid=torch.from_numpy(valid), name_id=torch.zeros(4, dtype=torch.int32),
        ns=torch.zeros(4, dtype=torch.int32), cls=torch.from_numpy(cls),
        priority=torch.from_numpy(pri), creation=torch.from_numpy(cre),
        node_id=torch.full((4,), -1, dtype=torch.int32),
        node_name_req=torch.from_numpy(nnr))
    order, start, length, rcls, _nnr, n_runs = R._encode_runs(pods, plan.rc)
    assert int(n_runs) == plan.n_runs
    # -INT32_MIN wraps to INT32_MIN, so those pods sort first
    assert order.tolist() == [0, 2, 1, 3]
    assert length[:plan.n_runs].tolist() == [2, 2]
    assert rcls[:plan.n_runs].tolist() == [0, 1]
    assert start[:plan.n_runs].tolist() == [0, 2]


def test_self_interaction_vector_classifies():
    nodes = [Node(name=f"n{i}", labels={HOSTNAME: f"n{i}"},
                  allocatable=Resources.make(cpu="8", memory="16Gi",
                                             pods=110))
             for i in range(3)]
    sel = LabelSelector.of(match_labels={"app": "db"})
    plain = Pod(name="a", labels={"app": "web"},
                requests=Resources.make(cpu="100m", memory="64Mi"),
                creation_index=0)
    selfanti = Pod(name="b", labels={"app": "db"},
                   requests=Resources.make(cpu="100m", memory="64Mi"),
                   affinity=Affinity(anti_required=(
                       PodAffinityTerm(selector=sel,
                                       topology_key=HOSTNAME),)),
                   creation_index=1)
    other = Pod(name="c", labels={"app": "cache"},
                requests=Resources.make(cpu="120m", memory="64Mi"),
                affinity=Affinity(anti_required=(
                    PodAffinityTerm(selector=sel, topology_key=HOSTNAME),)),
                creation_index=2)
    enc = encode(nodes, [], [plain, selfanti, other])
    tables, ex, _ = enc["torch"]
    uk, ev = enc["keys"]
    got = R.self_interaction_vector(
        tables, t_build_cycle(tables, ex, uk, ev, enc["dims"].D)).numpy()
    jt, jex, _ = enc["jax"]
    ref = np.asarray(jax.jit(
        lambda t, e: j_self_interaction(t, j_build_cycle(
            t, e, jnp.int32(uk), jnp.int32(ev), enc["dims"].D)))(jt, jex))
    np.testing.assert_array_equal(got, ref)
    cls = enc["np"][2].cls[:3]
    assert not got[cls[0]] and got[cls[1]] and not got[cls[2]]


# --------------------------------------------------------------------- #
# the port's traps: the running argmax, -0.0 and the zero weight column
# --------------------------------------------------------------------- #


def _jax_prefix(cur, plus, remaining):
    """The JAX package's epoch admission (ops/runs.py _closed_run's epoch,
    line for line): stable argsort, associative_scan of the lexicographic
    max (value desc, node index asc), the all-true prefix."""
    N = cur.shape[0]
    iota_n = jnp.arange(N, dtype=jnp.int32)
    ordn = jnp.argsort(-cur, stable=True)
    e, ep = cur[ordn], plus[ordn]

    def comb(a, b):
        av, ai = a
        bv, bi = b
        take_b = (bv > av) | ((bv == av) & (bi < ai))
        return (jnp.where(take_b, bv, av), jnp.where(take_b, bi, ai))

    Mv, Mi = lax.associative_scan(comb, (ep, ordn.astype(jnp.int32)))
    prevMv = jnp.concatenate([jnp.full((1,), -jnp.inf, cur.dtype), Mv[:-1]])
    prevMi = jnp.concatenate([jnp.full((1,), N, jnp.int32), Mi[:-1]])
    beats = (e > prevMv) | ((e == prevMv) & (ordn < prevMi))
    okpos = beats & (e != -jnp.inf) & (iota_n < remaining)
    return ordn, jnp.cumprod(okpos.astype(jnp.int32)).sum()


@pytest.mark.parametrize("seed", range(12))
def test_admission_prefix_breaks_ties_by_node_index(seed):
    """Head scores drawn from a few values (ties everywhere, +0.0 and -0.0,
    -inf): the port's epoch admits the JAX package's prefix in its order.
    torch.cummax would break the running argmax's ties by position; the
    ordered key breaks them by node index, as JAX's comb does."""
    rng = np.random.default_rng(seed)
    vals = np.array([-np.inf, -0.0, 0.0, 1.0, 2.0, 2.0, 3.5], np.float32)
    N = int(rng.integers(2, 40))
    cur = vals[rng.integers(0, len(vals), N)]
    # a node's head after one more replica is at most its head now
    plus = np.minimum(cur, vals[rng.integers(0, len(vals), N)])
    for remaining in (1, 3, N):
        ordn, T = R.admission_prefix(torch.from_numpy(cur),
                                     torch.from_numpy(plus), remaining)
        jo, jT = _jax_prefix(jnp.asarray(cur), jnp.asarray(plus), remaining)
        assert T == int(jT)
        np.testing.assert_array_equal(ordn.numpy(), np.asarray(jo))


def test_admission_prefix_tie_on_a_later_node_index():
    """The case position-order cummax gets wrong: two post-placement heads
    tie, the later position holding the lower node index — the running
    argmax must be that node, so the next position (a higher index at the
    same value) does not beat it."""
    cur = torch.tensor([5.0, 5.0, 5.0], dtype=torch.float32)
    plus = torch.tensor([3.0, 4.0, 4.0], dtype=torch.float32)
    jo, jT = _jax_prefix(jnp.asarray(cur.numpy()), jnp.asarray(plus.numpy()),
                         3)
    ordn, T = R.admission_prefix(cur, plus, 3)
    assert T == int(jT) and ordn.tolist() == np.asarray(jo).tolist()


def _neg_zero_wsym(enc):
    cyc = t_build_cycle(*enc["torch"][:2], *enc["keys"], enc["dims"].D)
    return np.full(tuple(cyc.WSYM.shape), -0.0, np.float32)


def test_runs_minus_zero_wsym_cell():
    """WSYM cells at -0.0 going in, a class with symmetric weight placed:
    the port's runs equals the JAX runs engine in placements and WSYM,
    sign of zeros included."""
    nodes, existing, pods = _soft_affinity_case()
    enc = encode(nodes, existing, pods)
    w0 = _neg_zero_wsym(enc)
    ref = _jax(enc, "runs", wsym=w0)
    got = _port_run(enc, "runs", wsym=w0)
    np.testing.assert_array_equal(as_np(got.node), as_np(ref.node))
    rw, gw = as_np(ref.state.WSYM), as_np(got.state.WSYM)
    assert (rw == gw).all()
    np.testing.assert_array_equal(np.signbit(gw), np.signbit(rw))


def test_runs_zero_weight_class_skips_wsym_commit():
    """A class whose weight column is all zero: the runs engine skips its
    WSYM commit (-0.0 cells stay -0.0) where the scan adds 0.0 at every
    placement (+0.0 there). The port's runs keeps the JAX runs engine's
    signs; the scan's differ, so the trap is reached."""
    nodes = [Node(name=f"n{i}",
                  allocatable=Resources.make(cpu="4", memory="8Gi", pods=110))
             for i in range(6)]
    web_sel = LabelSelector.of(match_labels={"app": "web"})
    # a preferring pod gives the cycle a WSYM term; the pending plain
    # replicas carry no weight
    existing = [Pod(name="pref", labels={"app": "x"}, node_name="n0",
                    requests=Resources.make(cpu="100m", memory="64Mi"),
                    affinity=Affinity(pod_preferred=(
                        JT.WeightedPodAffinityTerm(
                            weight=5, term=PodAffinityTerm(
                                selector=web_sel, topology_key=HOSTNAME)),)))]
    for n in nodes:
        n.labels[HOSTNAME] = n.name
    t = Pod(name="t", labels={"app": "plain"},
            requests=Resources.make(cpu="500m", memory="512Mi"))
    pods = [_replica(t, i) for i in range(9)]
    enc = encode(nodes, existing, pods)
    w0 = _neg_zero_wsym(enc)
    assert w0.size > 0
    ref = _jax(enc, "runs", wsym=w0)
    got = _port_run(enc, "runs", wsym=w0)
    scan = _jax(enc, "scan", wsym=w0)
    np.testing.assert_array_equal(as_np(got.node), as_np(ref.node))
    np.testing.assert_array_equal(as_np(got.node), as_np(scan.node))
    gw = as_np(got.state.WSYM)
    np.testing.assert_array_equal(np.signbit(gw),
                                  np.signbit(as_np(ref.state.WSYM)))
    assert np.signbit(gw).all()
    assert not np.signbit(as_np(scan.state.WSYM)).all()


# --------------------------------------------------------------------- #
# the wiring: snapshots' run plans and the Scheduler's telemetry
# --------------------------------------------------------------------- #


def test_scheduler_run_plans_and_telemetry_match_jax(monkeypatch):
    """A deployment backlog drained through both packages' Scheduler under
    KTPU_ASSIGN=runs (full snapshots, then patches, then a micro wave):
    per wave the same placements, class runs and collapse ratio; every
    run of the port's took the closed form."""
    from kubernetes_tpu.sched.scheduler import RecordingBinder as JBinder
    from kubernetes_tpu.sched.scheduler import Scheduler as JScheduler
    from kubernetes_tpu_torch.sched.scheduler import RecordingBinder as TBinder
    from kubernetes_tpu_torch.sched.scheduler import Scheduler as TScheduler

    monkeypatch.setenv("KTPU_ASSIGN", "runs")
    monkeypatch.setenv("KTPU_OVERLOAD", "0")

    def drain(T, W, Sched, Binder, **kw):
        s = Sched(binder=Binder(), batch_size=64, microwave=True,
                  clock=lambda: 0.0, **kw)
        if hasattr(s, "prewarmer"):
            s.prewarmer.enabled = False
        for n in W.make_nodes(12, zones=3, racks_per_zone=2):
            s.on_node_add(n)
        for p in W.deployment_backlog_pods(150, deployments=10):
            s.on_pod_add(p)
        waves = []
        for _ in range(6):
            st = s.schedule_pending()
            waves.append((st.attempted, st.scheduled, st.class_runs,
                          st.collapse_ratio, st.micro))
        s.on_pod_add(T.Pod(name="fresh", creation_index=10**6,
                           requests=T.Resources.make(cpu="100m",
                                                     memory="64Mi")))
        st = s.schedule_pending()
        waves.append((st.attempted, st.scheduled, st.class_runs,
                      st.collapse_ratio, st.micro))
        return waves, s.binder.bound

    import kubernetes_tpu.models.workloads as JW
    import kubernetes_tpu_torch.models.workloads as TW

    R.reset_run_stats()
    got = drain(TT, TW, TScheduler, TBinder, device="cpu")
    ref = drain(JT, JW, JScheduler, JBinder)
    assert got == ref
    assert got[0][0][2] > 1 and got[0][-1][4] == 1
    assert R.assign_runs.stats["fallback"] == 0
    assert R.assign_runs.stats["closed"] > 0
