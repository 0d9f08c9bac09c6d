"""Parity of the port's preemption (kubernetes_tpu_torch/ops/preempt.py,
sched/preemption.py, the K3 reprieve scan's plain version) with the JAX
package's (kubernetes_tpu/ops/preempt.py, sched/preemption.py).

  (a) tests/test_preempt.py's scenarios but the server one (which needs the
      apiserver, ROADMAP A11), each written once and run through both
      packages' Scheduler with a Preemptor: the evicted keys in order, the
      nominations, the per-wave outcome, the later binding and
      `last_pdb_violations` must be equal, and the reference test's own
      expectations must hold;
  (b) `preempt_batch` directly on seeded random small clusters (host ports
      with a wildcard IP, anti-affinity both ways, hard spread, PDB bits, a
      nodeName preemptor, a lane with no candidate), B = 8 lanes with padded
      ones: node, victims, n_candidates and n_pdb_violations exactly equal;
  (c) K3 on CPU tensors (its plain version) against literal per-pod loops
      that mirror the JAX package's per-lane what-if step for step: pass
      1, the reprieve scan in the lane's own order and the per-node
      summaries; the lane-independent reprieve order against each lane's
      lexsort;
  (d) five scalar resources (R = 16, the width of K3's wide variant):
      `preempt_batch` on (b)'s clusters with scalar requests and capacities,
      and a Scheduler preemption pass that scalar requests decide.

Everything runs on the CPU (the port with device="cpu", where the K3
wrapper takes its plain version). The random clusters share one fixed Dims,
so the JAX side compiles its burst program once.
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.api.types as JT
import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu.ops.lattice import build_cycle as j_build_cycle
from kubernetes_tpu.ops.preempt import preempt_batch as j_preempt_batch
from kubernetes_tpu.sched.cycle import UNSCHEDULABLE_TAINT_KEY
from kubernetes_tpu.sched.preemption import Preemptor as JPreemptor
from kubernetes_tpu.sched.scheduler import RecordingBinder as JBinder
from kubernetes_tpu.sched.scheduler import Scheduler as JScheduler
from kubernetes_tpu.state.dims import Dims
from kubernetes_tpu.state.encode import Encoder
from kubernetes_tpu_torch.ops import kernels as K
from kubernetes_tpu_torch.ops.lattice import build_cycle as t_build_cycle
from kubernetes_tpu_torch.ops.preempt import (preempt_batch as t_preempt_batch,
                                              preempt_for_pod, reprieve_order)
from kubernetes_tpu_torch.sched.preemption import Preemptor as TPreemptor
from kubernetes_tpu_torch.sched.scheduler import RecordingBinder as TBinder
from kubernetes_tpu_torch.sched.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.state.arrays import tables_to_torch
from torch_parity import as_np

HOSTNAME = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"
CPU = torch.device("cpu")

SIDES = {"jax": (JT, JScheduler, JBinder, JPreemptor),
         "port": (TT, TScheduler, TBinder, TPreemptor)}


class FakeClock:
    t = 0.0

    def __call__(self):
        return self.t


class Side:
    """One package's scheduler with a Preemptor, driven through its own
    types; `record()` is what both sides must agree on."""

    def __init__(self, side, pdbs=None):
        self.T, sched_cls, binder_cls, pre_cls = SIDES[side]
        self.clock = FakeClock()
        pre = pre_cls(pdb_source=(lambda: pdbs) if pdbs is not None else None)
        kw = {"device": "cpu"} if side == "port" else {}
        self.s = sched_cls(binder=binder_cls(), clock=self.clock,
                           preemptor=pre, **kw)
        if side == "jax":
            self.s.prewarmer.enabled = False
        self.waves = []

    def node(self, name, cpu=2, mem="4Gi"):
        return self.T.Node(name=name, labels={HOSTNAME: name},
                           allocatable=self.T.Resources.make(
                               cpu=cpu, memory=mem, pods=110))

    def bound(self, name, node, cpu="500m", mem="256Mi", priority=0, **kw):
        p = self.T.Pod(name=name, requests=self.T.Resources.make(
            cpu=cpu, memory=mem), priority=priority, **kw)
        p.node_name = node
        return p

    def pod(self, name, cpu, mem, priority, **kw):
        return self.T.Pod(name=name, priority=priority,
                          requests=self.T.Resources.make(cpu=cpu, memory=mem),
                          **kw)

    def anti(self, app):
        T = self.T
        return T.Affinity(anti_required=(T.PodAffinityTerm(
            selector=T.LabelSelector.of(match_labels={"app": app}),
            topology_key=HOSTNAME),))

    def wave(self):
        st = self.s.schedule_pending()
        self.waves.append((st.attempted, st.scheduled, st.unschedulable,
                           dict(st.assignments)))
        return st

    @property
    def evicted(self):
        return list(self.s.preemptor.evictor.evicted)

    def record(self, keys=("default/vip",)):
        pre = self.s.preemptor
        return dict(waves=self.waves, evicted=self.evicted,
                    nominated={k: self.s.queue.nominated_node(k)
                               for k in keys},
                    bound=list(self.s.binder.bound),
                    pdb_violations=pre.last_pdb_violations,
                    attempts=pre.attempts, successes=pre.successes,
                    counts=self.s.cache.counts(),
                    lengths=self.s.queue.lengths())


def run_both(scenario, pdbs_of=None):
    recs = {}
    for side in SIDES:
        pdbs = pdbs_of(SIDES[side][0]) if pdbs_of is not None else None
        d = Side(side, pdbs)
        scenario(d)
        recs[side] = d.record()
    assert recs["port"] == recs["jax"]
    return recs["port"]


def guarded_pdb(T, allowed=0):
    return [("default", T.LabelSelector.of(match_labels={"app": "guarded"}),
             allowed)]


# --------------------------------------------------------------------- #
# (a) tests/test_preempt.py's scenarios on both packages
# --------------------------------------------------------------------- #


def preempts_lower_priority_and_schedules_after_eviction(d):
    d.s.on_node_add(d.node("n0", cpu=1))
    d.s.on_pod_add(d.bound("victim", "n0", cpu="800m", priority=0))
    d.s.on_pod_add(d.pod("vip", "800m", "256Mi", 100))
    assert d.wave().scheduled == 0
    assert d.evicted == ["default/victim"]
    assert d.s.queue.nominated_node("default/vip") == "n0"
    assert d.s.cache.get_pod("default/victim") is None
    d.clock.t = 5.0
    assert d.wave().assignments.get("default/vip") == "n0"
    assert d.s.queue.nominated_node("default/vip") is None


def no_preemption_of_equal_or_higher_priority(d):
    d.s.on_node_add(d.node("n0", cpu=1))
    d.s.on_pod_add(d.bound("peer", "n0", cpu="800m", priority=100))
    d.s.on_pod_add(d.pod("vip", "800m", "256Mi", 100))
    assert d.wave().unschedulable == 1
    assert d.evicted == []
    assert d.s.cache.get_pod("default/peer") is not None


def zero_priority_pod_never_preempts(d):
    d.s.on_node_add(d.node("n0", cpu=1))
    d.s.on_pod_add(d.bound("victim", "n0", cpu="800m", priority=-5))
    d.s.on_pod_add(d.pod("plain", "800m", "256Mi", 0))
    assert d.wave().unschedulable == 1
    assert d.evicted == []


def minimal_victim_set_reprieve(d):
    d.s.on_node_add(d.node("n0", cpu=2))
    for name, prio in (("a", 1), ("b", 2), ("c", 3)):
        d.s.on_pod_add(d.bound(name, "n0", cpu="600m", priority=prio))
    d.s.on_pod_add(d.pod("vip", "500m", "128Mi", 100))
    d.wave()
    assert d.evicted == ["default/a"]


def picks_node_with_lowest_max_victim_priority(d):
    d.s.on_node_add(d.node("n0", cpu=1))
    d.s.on_node_add(d.node("n1", cpu=1))
    d.s.on_pod_add(d.bound("hi", "n0", cpu="900m", priority=50))
    d.s.on_pod_add(d.bound("lo", "n1", cpu="900m", priority=5))
    d.s.on_pod_add(d.pod("vip", "500m", "128Mi", 100))
    d.wave()
    assert d.evicted == ["default/lo"]
    assert d.s.queue.nominated_node("default/vip") == "n1"


def preemption_helps_anti_affinity_block(d):
    d.s.on_node_add(d.node("n0"))
    blocker = d.bound("blocker", "n0", cpu="100m", priority=1)
    blocker.labels = {"app": "blue"}
    blocker.affinity = d.anti("red")
    d.s.on_pod_add(blocker)
    d.s.on_pod_add(d.pod("vip", "100m", "64Mi", 100, labels={"app": "red"}))
    assert d.wave().scheduled == 0
    assert d.evicted == ["default/blocker"]
    d.clock.t = 5.0
    assert d.wave().assignments.get("default/vip") == "n0"


def no_candidate_when_pod_cannot_fit_even_empty(d):
    d.s.on_node_add(d.node("n0", cpu=1))
    d.s.on_pod_add(d.bound("v", "n0", cpu="500m", priority=0))
    d.s.on_pod_add(d.pod("huge", 8, "256Mi", 100))
    assert d.wave().unschedulable == 1
    assert d.evicted == []


def pdb_protected_node_avoided(d):
    d.s.on_node_add(d.node("n0", cpu=1))
    d.s.on_node_add(d.node("n1", cpu=1))
    guarded = d.bound("guarded", "n0", cpu="900m", priority=5)
    guarded.labels = {"app": "guarded"}
    d.s.on_pod_add(guarded)
    d.s.on_pod_add(d.bound("plain", "n1", cpu="900m", priority=5))
    d.s.on_pod_add(d.pod("vip", "500m", "128Mi", 100))
    d.wave()
    assert d.evicted == ["default/plain"]
    assert d.s.queue.nominated_node("default/vip") == "n1"
    assert d.s.preemptor.last_pdb_violations == 0


def pdb_with_budget_left_does_not_block(d):
    d.s.on_node_add(d.node("n0", cpu=1))
    guarded = d.bound("guarded", "n0", cpu="900m", priority=5)
    guarded.labels = {"app": "guarded"}
    d.s.on_pod_add(guarded)
    d.s.on_pod_add(d.pod("vip", "500m", "128Mi", 100))
    d.wave()
    assert d.evicted == ["default/guarded"]


def pdb_violating_victim_reprieved_first(d):
    d.s.on_node_add(d.node("n0", cpu=2))
    guarded = d.bound("guarded", "n0", cpu="900m", priority=5)
    guarded.labels = {"app": "guarded"}
    d.s.on_pod_add(guarded)
    d.s.on_pod_add(d.bound("plain", "n0", cpu="900m", priority=5))
    d.s.on_pod_add(d.pod("vip", "1", "128Mi", 100))
    d.wave()
    assert d.evicted == ["default/plain"]
    assert d.s.preemptor.last_pdb_violations == 0


def unavoidable_pdb_violation_is_counted(d):
    d.s.on_node_add(d.node("n0", cpu=1))
    guarded = d.bound("guarded", "n0", cpu="900m", priority=5)
    guarded.labels = {"app": "guarded"}
    d.s.on_pod_add(guarded)
    d.s.on_pod_add(d.pod("vip", "500m", "128Mi", 100))
    d.wave()
    assert d.evicted == ["default/guarded"]
    assert d.s.preemptor.last_pdb_violations == 1


def latest_start_time_tiebreak(d):
    d.s.on_node_add(d.node("n0", cpu=1))
    d.s.on_node_add(d.node("n1", cpu=1))
    old = d.bound("old", "n0", cpu="900m", priority=5)
    old.creation_index = 1
    young = d.bound("young", "n1", cpu="900m", priority=5)
    young.creation_index = 99
    d.s.on_pod_add(old)
    d.s.on_pod_add(young)
    d.s.on_pod_add(d.pod("vip", "500m", "128Mi", 100))
    d.wave()
    assert d.evicted == ["default/young"]


SCENARIOS = [
    (preempts_lower_priority_and_schedules_after_eviction, None),
    (no_preemption_of_equal_or_higher_priority, None),
    (zero_priority_pod_never_preempts, None),
    (minimal_victim_set_reprieve, None),
    (picks_node_with_lowest_max_victim_priority, None),
    (preemption_helps_anti_affinity_block, None),
    (no_candidate_when_pod_cannot_fit_even_empty, None),
    (pdb_protected_node_avoided, guarded_pdb),
    (pdb_with_budget_left_does_not_block, lambda T: guarded_pdb(T, 2)),
    (pdb_violating_victim_reprieved_first, guarded_pdb),
    (unavoidable_pdb_violation_is_counted, guarded_pdb),
    (latest_start_time_tiebreak, None),
]


@pytest.mark.parametrize("scenario,pdbs_of", SCENARIOS,
                         ids=[s.__name__ for s, _ in SCENARIOS])
def test_preempt_scenario_matches_jax(scenario, pdbs_of):
    run_both(scenario, pdbs_of)


def test_reprieve_conservatism_trials_match_jax():
    """tests/test_preempt.py's randomized reprieve trials (the same seed and
    draws): per trial, both packages evict the same pods in the same order
    and nominate the same node. (The JAX package's test holds its result
    against the pure-Python oracle; equal results carry that over.)"""

    def trials(side):
        rng = random.Random(7)
        out = []
        for _ in range(6):
            d = Side(side)
            n_nodes = rng.randint(1, 3)
            for i in range(n_nodes):
                d.s.on_node_add(d.node(f"n{i}", cpu=2))
            for i in range(rng.randint(1, 5)):
                v = d.bound(f"e{i}", f"n{rng.randrange(n_nodes)}",
                            cpu=rng.choice(["400m", "800m", "1200m"]),
                            priority=rng.randrange(3))
                v.labels = {"app": rng.choice(["red", "blue"])}
                if rng.random() < 0.4:
                    v.affinity = d.anti(rng.choice(["red", "blue"]))
                v.creation_index = i
                d.s.on_pod_add(v)
            d.s.on_pod_add(d.pod("vip", "1500m", "128Mi", 100,
                                 labels={"app": "red"}))
            d.wave()
            out.append(d.record())
        return out

    ref, got = trials("jax"), trials("port")
    assert got == ref
    assert sum(len(r["evicted"]) for r in got) > 0


# --------------------------------------------------------------------- #
# (b) preempt_batch on random clusters, B = 8 lanes
# --------------------------------------------------------------------- #

B = 8
# one capacity set for every random cluster: the JAX side compiles once
BASE = Dims(N=16, P=16, E=64, S=16, SC=16, SL=16, SR=16, SPP=8, PP=2,
            AN=1, AT=1, TS=1, D=16)


def _random_cluster(seed):
    """≤ 12 nodes in 3 zones, ≤ 40 existing pods on them (priorities 0-4,
    labels app a/b/c, some with host ports — one on the wildcard IP — some
    anti-affine to another app, some with a hard zone spread), and 8
    preemptors of priority 2-6: host ports, anti-affinity, a hard spread, a
    nodeName one and one that fits nowhere."""
    rng = random.Random(9000 + seed)
    n_nodes = rng.randint(4, 12)
    nodes = [JT.Node(name=f"n{i}", labels={HOSTNAME: f"n{i}",
                                           ZONE: f"z{i % 3}"},
                     allocatable=JT.Resources.make(cpu=4, memory="8Gi",
                                                   pods=110))
             for i in range(n_nodes)]
    apps = ("a", "b", "c")

    def port(k):
        return (JT.HostPort(port=8000 + k % 3,
                            host_ip="" if k % 2 else f"10.0.0.{k % 4}"),)

    def spread(app):
        return (JT.TopologySpreadConstraint(
            max_skew=1, topology_key=ZONE,
            when_unsatisfiable=JT.UnsatisfiableAction.DO_NOT_SCHEDULE,
            selector=JT.LabelSelector.of(match_labels={"app": app})),)

    def anti(app, key=HOSTNAME):
        return JT.Affinity(anti_required=(JT.PodAffinityTerm(
            selector=JT.LabelSelector.of(match_labels={"app": app}),
            topology_key=key),))

    existing = []
    for i in range(rng.randint(10, 40)):
        kw = {}
        r = rng.random()
        if r < 0.2:
            kw["host_ports"] = port(rng.randrange(8))
        elif r < 0.35:
            kw["affinity"] = anti(rng.choice(apps))
        elif r < 0.45:
            kw["topology_spread"] = spread(rng.choice(apps))
        existing.append(JT.Pod(
            name=f"e{i}", labels={"app": rng.choice(apps)},
            requests=JT.Resources.make(
                cpu=rng.choice(["250m", "500m", "1", "1500m"]),
                memory=rng.choice(["256Mi", "1Gi"])),
            priority=rng.randrange(5), creation_index=i,
            node_name=nodes[rng.randrange(n_nodes)].name))
    pending = []
    for i in range(B - 1):
        kw = {}
        if i % 4 == 0:
            kw["host_ports"] = port(rng.randrange(8))
        if i % 4 == 1:
            kw["affinity"] = anti(rng.choice(apps))
        if i % 4 == 2:
            kw["topology_spread"] = spread(rng.choice(apps))
        if i == 3:
            kw["node_name"] = nodes[rng.randrange(n_nodes)].name
        pending.append(JT.Pod(
            name=f"p{i}", labels={"app": rng.choice(apps)},
            requests=JT.Resources.make(cpu=rng.choice(["1", "2", "3"]),
                                       memory="1Gi"),
            priority=rng.randint(2, 6), creation_index=100 + i, **kw))
    # a preemptor no node can hold even empty: its lane has no candidate
    pending.append(JT.Pod(name="huge", requests=JT.Resources.make(
        cpu=64, memory="1Gi"), priority=9, creation_index=200))
    pdb = np.array([rng.random() < 0.3 for _ in range(BASE.E)])
    return nodes, existing, pending, pdb


@jax.jit
def _j_burst(tables, ex, cls, nnr, prio, pdb, uk, ev):
    cyc = j_build_cycle(tables, ex, uk, ev, BASE.D)
    return j_preempt_batch(tables, cyc, ex, cls, nnr, prio, BASE.D, pdb)


@pytest.mark.parametrize("seed", range(8))
def test_preempt_batch_matches_jax(seed):
    nodes, existing, pending, pdb = _random_cluster(seed)
    enc = Encoder()
    enc.vocabs.label_keys.intern(UNSCHEDULABLE_TAINT_KEY)
    enc.vocabs.label_vals.intern("")
    tables, ex, pe, d = enc.encode_cluster(nodes, existing, pending, BASE)
    assert (d.N, d.E, d.D) == (BASE.N, BASE.E, BASE.D), d
    uk = enc.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY)
    ev = enc.vocabs.label_vals.get("")
    # lanes: the 8 pending pods, the last two padded with a copy of lane 5
    rows = [0, 1, 2, 3, 4, 5, 5, 7]
    cls = np.asarray(pe.cls)[rows].astype(np.int32)
    nnr = np.asarray(pe.node_name_req)[rows].astype(np.int32)
    prio = np.asarray(pe.priority)[rows].astype(np.int32)
    assert nnr[3] >= 0
    ref = _j_burst(jax.device_put(tables), jax.device_put(ex),
                   jnp.asarray(cls), jnp.asarray(nnr), jnp.asarray(prio),
                   jnp.asarray(pdb), jnp.int32(uk), jnp.int32(ev))

    tt, (ext,) = tables_to_torch(tables, (ex,), CPU)
    cyc = t_build_cycle(tt, ext, uk, ev, BASE.D)
    got = t_preempt_batch(tt, cyc, ext, torch.from_numpy(cls),
                          torch.from_numpy(nnr), torch.from_numpy(prio),
                          BASE.D, torch.from_numpy(pdb))
    for f in ref._fields:
        np.testing.assert_array_equal(as_np(getattr(got, f)),
                                      as_np(getattr(ref, f)), err_msg=f)
    node = as_np(got.node)
    assert node[7] == -1 and as_np(got.n_candidates)[7] == 0
    # the single-pod what-if is lane 0 of the burst
    one = preempt_for_pod(tt, cyc, ext, int(cls[0]), int(nnr[0]),
                          int(prio[0]), BASE.D, torch.from_numpy(pdb))
    assert int(one.node) == node[0]
    assert torch.equal(one.victims, got.victims[0])


def test_random_clusters_exercise_each_criterion():
    """The seeds above reach what they are meant to: victims, a PDB
    violation counted, and candidates on most lanes."""
    seen = {"victims": 0, "pdb": 0, "cands": 0}
    for seed in range(8):
        nodes, existing, pending, pdb = _random_cluster(seed)
        enc = Encoder()
        enc.vocabs.label_keys.intern(UNSCHEDULABLE_TAINT_KEY)
        enc.vocabs.label_vals.intern("")
        tables, ex, pe, _ = enc.encode_cluster(nodes, existing, pending, BASE)
        uk = enc.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY)
        ev = enc.vocabs.label_vals.get("")
        tt, (ext, pet) = tables_to_torch(tables, (ex, pe), CPU)
        cyc = t_build_cycle(tt, ext, uk, ev, BASE.D)
        res = t_preempt_batch(tt, cyc, ext, pet.cls[:B], pet.node_name_req[:B],
                              pet.priority[:B], BASE.D, torch.from_numpy(pdb))
        seen["victims"] += int(res.victims.sum())
        seen["pdb"] += int(res.n_pdb_violations.sum())
        seen["cands"] += int((res.n_candidates > 0).sum())
    assert seen["victims"] > 0 and seen["pdb"] > 0 and seen["cands"] > 8


# --------------------------------------------------------------------- #
# (c) K3's plain version against the JAX what-if, step for step
# --------------------------------------------------------------------- #

I32_MAX, I32_MIN = 2**31 - 1, -2**31


def _fit_np(vec, free):
    """ops/fit.py _fit on one request vector, in Python ints (int32)."""
    R = len(vec)
    pods_ok = vec[3] <= free[3]
    zero_all = max([0] + [vec[r] for r in range(R) if r != 3]) == 0
    res_ok = all(r == 3 or (r >= 4 and vec[r] == 0) or vec[r] <= free[r]
                 for r in range(R))
    return pods_ok and (zero_all or res_ok)


def _wrap(x):
    return (x + 2**31) % 2**32 - 2**31


def _scan_reference(c):
    """The JAX package's per-lane what-if as literal loops over the pods:
    pass 1 (ops/preempt.py:128-156, but for the candidate test's other
    rows, here cand_rest), the reprieve step (:183-200) over the lane's own
    lexsort order, and the per-node summaries of the node choice
    (:205-217). Returns K3's seven outputs."""
    req_e, req_p, alloc, used = c["req_e"], c["req_p"], c["alloc"], c["used"]
    vict_pot, c_e, reblock = c["vict_pot"], c["c_e"], c["reblock"]
    node, prio, pdb, creation = c["node"], c["prio"], c["pdb"], c["creation"]
    B, E = vict_pot.shape
    N, R = used.shape
    out = dict(victim=np.zeros((B, E), bool), cand=np.zeros((B, N), bool),
               num_v=np.zeros((B, N), np.int64),
               sum_p=np.zeros((B, N), np.int64),
               max_p=np.full((B, N), -I32_MAX, np.int64),
               num_pdb=np.zeros((B, N), np.int64),
               est=np.full((B, N), I32_MAX, np.int64))
    neg = np.where(prio == I32_MIN, prio, -prio.astype(np.int64))  # jnp's -x
    for b in range(B):
        # pass 1: every potential victim removed
        used_wo = used.astype(np.int64).copy()
        conflict = np.zeros(N, bool)
        for e in range(E):
            n = node[e]
            if n >= N:
                continue
            if vict_pot[b, e]:
                used_wo[n] = [_wrap(int(used_wo[n, r]) - int(req_e[e, r]))
                              for r in range(R)]
            elif c_e[b, e]:
                conflict[n] = True
        cand = out["cand"][b]
        for n in range(N):
            free = [_wrap(int(alloc[n, r]) - int(used_wo[n, r]))
                    for r in range(R)]
            cand[n] = (c["cand_rest"][b, n] and c["valid"][n]
                       and not conflict[n]
                       and _fit_np([int(v) for v in req_p[b]], free))
        # pass 2: the reprieve scan
        order = np.lexsort((np.arange(E), neg, ~pdb, ~vict_pot[b]))
        victim = out["victim"][b]
        for e in order:
            n = min(node[e], N - 1)
            is_v = vict_pot[b, e] and cand[n]
            new_used = [_wrap(int(used_wo[n, r]) + int(req_e[e, r]))
                        for r in range(R)]
            free = [_wrap(int(alloc[n, r]) - new_used[r]) for r in range(R)]
            fit_n = _fit_np([int(v) for v in req_p[b]], free)
            new_conf = conflict[n] or c_e[b, e]
            keep = is_v and fit_n and not new_conf and not reblock[b, e]
            if keep:
                used_wo[n] = new_used
                conflict[n] = new_conf
            victim[e] = is_v and not keep
        # the node choice's per-node summaries
        vmask = victim & (node < N)
        for e in np.flatnonzero(vmask):
            n = node[e]
            out["num_v"][b, n] += 1
            out["sum_p"][b, n] = _wrap(int(out["sum_p"][b, n]) + int(prio[e]))
            out["max_p"][b, n] = max(out["max_p"][b, n], prio[e])
            out["num_pdb"][b, n] += bool(pdb[e])
        for e in np.flatnonzero(vmask):
            n = node[e]
            if prio[e] == out["max_p"][b, n]:
                out["est"][b, n] = min(out["est"][b, n], creation[e])
    return out


def _k3_case(seed, B, N, E, R, p_vict=0.7, p_reblock=0.2, extreme=False,
             prios=None, p_pdb=0.3, p_off=None):
    """Random K3 inputs as numpy arrays. `extreme` draws requests,
    allocatable and used from int32 edge values, so the sums wrap;
    `prios` draws each pod's priority from the given values."""
    rng = np.random.default_rng(seed)
    node = rng.integers(0, N + 1, E).astype(np.int32)    # N: on no node
    if p_off is not None:
        node = rng.integers(0, N, E).astype(np.int32)
        node[rng.random(E) < p_off] = N
    if extreme:
        edge = np.array([0, 1, -1, I32_MAX, I32_MIN, 2**30, 7], np.int64)
        pick = lambda *s: edge[rng.integers(0, len(edge), s)].astype(np.int32)
        req_e, alloc, used = pick(E, R), pick(N, R), pick(N, R)
        # the preemptor's requests from the lower edges, so that some
        # nodes pass the candidate test and the walk's sums wrap
        req_p = edge[[0, 1, 2, 4, 6]][rng.integers(0, 5, (B, R))].astype(
            np.int32)
    else:
        req_e = rng.integers(0, 1500, (E, R)).astype(np.int32)
        req_e[:, 3] = 1
        req_p = rng.integers(0, 3000, (B, R)).astype(np.int32)
        req_p[:, 3] = 1
        # used: a base plus the node's pods' requests; alloc leaves room
        # for part of them, so some victims are reprieved and some not
        total = np.zeros((N, R), np.int64)
        np.add.at(total, node[node < N], req_e[node < N])
        base = rng.integers(0, 1000, (N, R))
        base[:, 3] = 0
        used = (base + total).astype(np.int32)
        alloc = (base + total * rng.uniform(0.4, 1.0, (N, R))
                 + rng.integers(1000, 4000, (N, R))).astype(np.int32)
        alloc[:, 3] = 110
    if R > 4:   # zero scalar requests are ignored by the fit test
        req_p[:, 4:] *= rng.random((B, R - 4)) < 0.5
    prio = (rng.integers(0, 5, E) if prios is None else
            np.asarray(prios, np.int64)[rng.integers(0, len(prios), E)])
    return dict(
        req_e=req_e, req_p=req_p, alloc=alloc, used=used,
        valid=rng.random(N) < 0.9, cand_rest=rng.random((B, N)) < 0.8,
        vict_pot=(rng.random((B, E)) < p_vict) & (node < N)[None],
        c_e=rng.random((B, E)) < 0.05, reblock=rng.random((B, E)) < p_reblock,
        node=node, prio=prio.astype(np.int32), pdb=rng.random(E) < p_pdb,
        creation=rng.integers(0, 1000, E).astype(np.int32))


def _k3_args(c):
    """K3's arguments (ops/kernels.py K3_ARGS) for a case, with the
    lane-independent reprieve order built as preempt_batch builds it."""
    t = torch.from_numpy
    N = c["used"].shape[0]
    seg_ptr, seg_e = reprieve_order(t(c["node"]), t(c["prio"]), t(c["pdb"]),
                                    N)
    return (seg_ptr, seg_e, t(c["req_e"]), t(c["prio"]), t(c["pdb"]),
            t(c["creation"]), t(c["req_p"]), t(c["vict_pot"]), t(c["c_e"]),
            t(c["reblock"]), t(c["used"]), t(c["alloc"]), t(c["valid"]),
            t(c["cand_rest"]))


EDGE_PRIOS = (I32_MIN, -I32_MAX, 0, 1, 5, I32_MAX)

K3_CASES = {
    "B8 N12 E60 R4": dict(seed=1, B=8, N=12, E=60, R=4),
    "B3 N5 E200 R8 long segments": dict(seed=2, B=3, N=5, E=200, R=8),
    "B2 N40 E30 R5 empty segments": dict(seed=3, B=2, N=40, E=30, R=5),
    "B4 N3 E50 all reblocked": dict(seed=4, B=4, N=3, E=50, R=4,
                                    p_reblock=1.0),
    "B5 N7 E80 R6 extreme int32": dict(seed=5, B=5, N=7, E=80, R=6,
                                       extreme=True),
    "B1 N1 E110 one 110-pod segment": dict(seed=6, B=1, N=1, E=110, R=4,
                                           p_vict=1.0),
    "B4 N6 E90 INT32_MIN in PDB groups": dict(seed=7, B=4, N=6, E=90, R=4,
                                              prios=EDGE_PRIOS, p_pdb=0.5),
    "B3 N4 E40 only INT32_MIN victims": dict(seed=8, B=3, N=4, E=40, R=4,
                                             prios=(I32_MIN,)),
    "B2 N3 E60 wrapping priority sums": dict(
        seed=9, B=2, N=3, E=60, R=4, prios=(I32_MAX, 2**30, -2**30)),
    "B33 N5 E120 R7": dict(seed=10, B=33, N=5, E=120, R=7, p_off=0.05),
}

K3_OUTPUTS = ("victim", "cand", "num_v", "sum_p", "max_p", "num_pdb", "est")


@pytest.mark.parametrize("case", list(K3_CASES))
def test_reprieve_scan_plain_matches_jax_scan(case):
    c = _k3_case(**K3_CASES[case])
    want = _scan_reference(c)
    args = _k3_args(c)
    got = K.reprieve_scan(*args)
    assert got._fields == K3_OUTPUTS
    for f in K3_OUTPUTS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[f],
                                      err_msg=f)
    plain = K.reprieve_scan_plain(*args)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


def test_reprieve_cases_reach_both_outcomes():
    """The K3 cases keep some potential victims and evict others, on
    candidate nodes and beside non-candidate ones, and the trap cases reach
    their traps: a victim at INT32_MIN, a max_p left at -I32_MAX by
    victims, and a priority sum that wraps."""
    kept = evicted = non_cand = 0
    for case in K3_CASES.values():
        c = _k3_case(**case)
        out = _scan_reference(c)
        v, cand, node = out["victim"], out["cand"], c["node"]
        evicted += int(v.sum())
        on_cand = np.stack([cand[b][np.minimum(node, cand.shape[1] - 1)]
                            for b in range(cand.shape[0])])
        kept += int((c["vict_pot"] & on_cand & ~v).sum())
        non_cand += int((~cand).sum())
    assert kept > 0 and evicted > 0 and non_cand > 0
    trap = _scan_reference(_k3_case(**K3_CASES[
        "B3 N4 E40 only INT32_MIN victims"]))
    hit = trap["num_v"] > 0
    assert hit.any() and (trap["max_p"][hit] == -I32_MAX).all()
    assert (trap["est"][hit] == I32_MAX).all()
    wrap = _k3_case(**K3_CASES["B2 N3 E60 wrapping priority sums"])
    out = _scan_reference(wrap)
    exact = np.zeros_like(out["sum_p"])
    for b, e in zip(*np.nonzero(out["victim"])):
        exact[b, wrap["node"][e]] += int(wrap["prio"][e])
    assert (exact != out["sum_p"]).any()
    pdbg = _k3_case(**K3_CASES["B4 N6 E90 INT32_MIN in PDB groups"])
    low = pdbg["vict_pot"] & (pdbg["prio"] == I32_MIN) & pdbg["pdb"]
    assert low.any()


def _one_node_case(prio, pdb, req_cpu, keep):
    """One lane on one node of 1000 milli-cpu holding len(prio) pods of
    req_cpu each, all potential victims; the preemptor asks for what is
    left beside `keep` of them, so the walk reprieves the first `keep`."""
    E = len(prio)
    req_e = np.zeros((E, 4), np.int32)
    req_e[:, 0], req_e[:, 3] = req_cpu, 1
    alloc = np.array([[1000, 1000, 1000, 110]], np.int32)
    used = req_e.sum(0, dtype=np.int64)[None].astype(np.int32)
    req_p = np.array([[1000 - keep * req_cpu, 0, 0, 1]], np.int32)
    return dict(req_e=req_e, req_p=req_p, alloc=alloc, used=used,
                valid=np.ones(1, bool), cand_rest=np.ones((1, 1), bool),
                vict_pot=np.ones((1, E), bool), c_e=np.zeros((1, E), bool),
                reblock=np.zeros((1, E), bool),
                node=np.zeros(E, np.int32), prio=np.array(prio, np.int32),
                pdb=np.array(pdb, bool),
                creation=np.arange(E, dtype=np.int32)[::-1].copy())


def _run_k3(c):
    got = K.reprieve_scan(*_k3_args(c))
    want = _scan_reference(c)
    for f in K3_OUTPUTS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[f],
                                      err_msg=f)
    return got


def test_reprieve_order_trap_int32_min_sorts_first_in_its_pdb_group():
    """jnp's -priority wraps: within the PDB-blocked group the victim at
    INT32_MIN is walked FIRST, as if it had the highest priority, and is
    the one reprieved; the priority-5 pod is evicted."""
    got = _run_k3(_one_node_case([5, I32_MIN], [True, True], 300, 1))
    assert got.victim[0].tolist() == [True, False]
    assert got.num_pdb.item() == 1 and got.max_p.item() == 5


def test_reprieve_int32_min_victims_leave_max_p_and_est_unset():
    """Victims only at INT32_MIN never raise max_p above -I32_MAX, so none
    is a top victim: est stays I32_MAX; their sum wraps to 0."""
    got = _run_k3(_one_node_case([I32_MIN, I32_MIN], [False, True], 600, 0))
    assert got.victim[0].tolist() == [True, True]
    assert got.num_v.item() == 2 and got.sum_p.item() == 0
    assert got.max_p.item() == -I32_MAX and got.est.item() == I32_MAX


def test_reprieve_est_resets_when_max_p_rises():
    """est is the least creation among the victims AT the final max_p: the
    PDB-blocked victim walked first sets it, and the higher-priority ones
    walked after it start it afresh."""
    c = _one_node_case([1, 7, 7], [True, False, False], 400, 0)
    c["creation"] = np.array([0, 9, 4], np.int32)
    got = _run_k3(c)
    assert got.victim[0].all() and got.max_p.item() == 7
    assert got.est.item() == 4 and got.sum_p.item() == 15


@pytest.mark.parametrize("seed", range(3))
def test_reprieve_order_is_each_lanes_lexsort_on_its_potential_victims(seed):
    """One order over [E] serves every lane: on each node, restricted to a
    lane's potential victims, it equals that lane's own JAX order
    lexsort((e, -prio, ~pdb, ~vict_pot[b])); pods on no node come last."""
    c = _k3_case(seed=20 + seed, B=6, N=7, E=150, R=4, prios=EDGE_PRIOS,
                 p_pdb=0.5)
    node, prio, pdb, vp = c["node"], c["prio"], c["pdb"], c["vict_pot"]
    seg_ptr, seg_e = reprieve_order(torch.from_numpy(node),
                                    torch.from_numpy(prio),
                                    torch.from_numpy(pdb), 7)
    ptr, seg = seg_ptr.tolist(), seg_e.tolist()
    assert sorted(seg) == list(range(150))
    assert sorted(seg[ptr[7]:]) == sorted(np.flatnonzero(node == 7).tolist())
    neg = np.where(prio == I32_MIN, prio, -prio.astype(np.int64))
    for b in range(6):
        order = np.lexsort((np.arange(150), neg, ~pdb, ~vp[b]))
        for n in range(7):
            want = [e for e in order if node[e] == n and vp[b, e]]
            got = [e for e in seg[ptr[n]:ptr[n + 1]] if vp[b, e]]
            assert got == want


def test_reprieve_segments_group_the_order_by_node():
    node = torch.tensor([1, 0, 1, 2, 0, 2], dtype=torch.int32)  # 2 = no node
    prio = torch.tensor([3, 1, 9, 0, 4, 2], dtype=torch.int32)
    pdb = torch.tensor([False, False, False, False, True, False])
    seg_ptr, seg_e = reprieve_order(node, prio, pdb, 2)
    assert seg_ptr.tolist() == [0, 2, 4]
    # node 0: the PDB-blocked pod 4 first; node 1: priority 9 before 3;
    # the pods on no node last, in the same order
    assert seg_e.tolist() == [4, 1, 2, 0, 5, 3]
    assert seg_ptr.dtype == seg_e.dtype == torch.int32


# --------------------------------------------------------------------- #
# C1: five scalar resources (R = 9 slots, bucketed to 16) — the width K3's
# wide variant takes on the card; here the plain version, both packages
# --------------------------------------------------------------------- #

SCALARS = ("example.com/fpga", "hugepages-1Gi", "hugepages-2Mi",
           "nvidia.com/gpu", "vendor.example/nic")


def _with_scalars(res, rng, node):
    """`res` with the five scalar resources: a node holds 8 of each, a pod
    asks for 0-3 of each (0 is ignored by the fit test)."""
    amounts = {s: 8 if node else rng.randrange(4) for s in SCALARS}
    return dataclasses.replace(res, scalars=tuple(sorted(amounts.items())))


def _r16_cluster(seed):
    nodes, existing, pending, pdb = _random_cluster(seed)
    rng = random.Random(seed)
    nodes = [dataclasses.replace(n, allocatable=_with_scalars(
        n.allocatable, rng, True)) for n in nodes]
    existing = [dataclasses.replace(p, requests=_with_scalars(
        p.requests, rng, False)) for p in existing]
    pending = [dataclasses.replace(p, requests=_with_scalars(
        p.requests, rng, False)) for p in pending]
    return nodes, existing, pending, pdb


@pytest.mark.parametrize("seed", range(4))
def test_preempt_batch_matches_jax_at_r16(seed):
    """preempt_batch at R = 16 (five scalar resources): the port's what-if
    (K3's plain version on the CPU) against the JAX package's, every
    field exact, with scalar requests deciding some fits."""
    nodes, existing, pending, pdb = _r16_cluster(seed)
    enc = Encoder()
    enc.vocabs.label_keys.intern(UNSCHEDULABLE_TAINT_KEY)
    enc.vocabs.label_vals.intern("")
    base = dataclasses.replace(BASE, R=16)
    tables, ex, pe, d = enc.encode_cluster(nodes, existing, pending, base)
    assert d.R == 16 and (d.N, d.E, d.D) == (BASE.N, BASE.E, BASE.D)
    uk = enc.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY)
    ev = enc.vocabs.label_vals.get("")
    rows = [0, 1, 2, 3, 4, 5, 5, 7]
    cls = np.asarray(pe.cls)[rows].astype(np.int32)
    nnr = np.asarray(pe.node_name_req)[rows].astype(np.int32)
    prio = np.asarray(pe.priority)[rows].astype(np.int32)
    ref = _j_burst(jax.device_put(tables), jax.device_put(ex),
                   jnp.asarray(cls), jnp.asarray(nnr), jnp.asarray(prio),
                   jnp.asarray(pdb), jnp.int32(uk), jnp.int32(ev))
    tt, (ext,) = tables_to_torch(tables, (ex,), CPU)
    assert tt.nodes.alloc.shape[1] == 16
    cyc = t_build_cycle(tt, ext, uk, ev, BASE.D)
    got = t_preempt_batch(tt, cyc, ext, torch.from_numpy(cls),
                          torch.from_numpy(nnr), torch.from_numpy(prio),
                          BASE.D, torch.from_numpy(pdb))
    for f in ref._fields:
        np.testing.assert_array_equal(as_np(getattr(got, f)),
                                      as_np(getattr(ref, f)), err_msg=f)


def test_r16_clusters_reach_victims_and_scalar_misfits():
    """The R = 16 seeds above evict, and the scalar slots bind: with them
    taken away some lanes' victims differ."""
    moved = victims = 0
    for seed in range(4):
        for scal in (True, False):
            nodes, existing, pending, pdb = (_r16_cluster(seed) if scal
                                             else _random_cluster(seed))
            enc = Encoder()
            enc.vocabs.label_keys.intern(UNSCHEDULABLE_TAINT_KEY)
            enc.vocabs.label_vals.intern("")
            base = dataclasses.replace(BASE, R=16)
            tables, ex, pe, _ = enc.encode_cluster(nodes, existing, pending,
                                                   base)
            uk = enc.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY)
            ev = enc.vocabs.label_vals.get("")
            tt, (ext,) = tables_to_torch(tables, (ex,), CPU)
            cyc = t_build_cycle(tt, ext, uk, ev, BASE.D)
            rows = [0, 1, 2, 3, 4, 5, 5, 7]
            out = t_preempt_batch(
                tt, cyc, ext, torch.from_numpy(np.asarray(pe.cls)[rows]),
                torch.from_numpy(np.asarray(pe.node_name_req)[rows]),
                torch.from_numpy(np.asarray(pe.priority)[rows]), BASE.D,
                torch.from_numpy(pdb))
            if scal:
                with_s = out.victims.clone()
                victims += int(out.victims.sum())
            elif not torch.equal(with_s, out.victims):
                moved += 1
    assert victims > 0 and moved > 0


def five_scalar_resources_preempt(d):
    """The Scheduler's preemption pass at R = 16: a vip needs two GPUs and
    a hugepage on a full node; the low-priority holders are evicted."""
    T = d.T

    def res(cpu, gpu, huge):
        return T.Resources.make(cpu=cpu, memory="1Gi", scalars={
            "nvidia.com/gpu": gpu, "hugepages-2Mi": huge,
            "example.com/fpga": 0, "hugepages-1Gi": 0,
            "vendor.example/nic": 1})

    for i in range(2):
        d.s.on_node_add(T.Node(name=f"n{i}", labels={HOSTNAME: f"n{i}"},
                               allocatable=T.Resources.make(
                                   cpu=4, memory="8Gi", pods=110, scalars={
                                       "nvidia.com/gpu": 2,
                                       "hugepages-2Mi": 4,
                                       "example.com/fpga": 1,
                                       "hugepages-1Gi": 1,
                                       "vendor.example/nic": 4})))
    for i, (node, prio) in enumerate((("n0", 1), ("n0", 3), ("n1", 2),
                                      ("n1", 2))):
        p = T.Pod(name=f"g{i}", requests=res("500m", 1, 1), priority=prio,
                  creation_index=i)
        p.node_name = node
        d.s.on_pod_add(p)
    d.s.on_pod_add(T.Pod(name="vip", requests=res("500m", 2, 1),
                         priority=100, creation_index=10))
    d.wave()
    d.clock.t = 5.0
    d.wave()


def test_preempt_scenario_with_five_scalar_resources_matches_jax():
    rec = run_both(five_scalar_resources_preempt)
    # n1's victims top out at priority 2, n0's at 3
    assert rec["evicted"] == ["default/g2", "default/g3"]
    assert rec["bound"] == [("default/vip", "n1")]
