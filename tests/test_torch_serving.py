"""Parity of the port's serving Scheduler (kubernetes_tpu_torch/sched/
scheduler.py) with the JAX package's (kubernetes_tpu/sched/scheduler.py).

Each scenario is written once against a `Drive`, which builds one side's
Scheduler (the JAX package's with its defaults; the port's with
device="cpu") on a shared FakeClock, and the package's own Pod/Node types.
Both sides run the same events; per wave they must agree on CycleStats
(attempted, scheduled, unschedulable, bind_errors, micro, assignments), and
at the end on the binder's order, `cache.counts()` and the queue lengths.
The nine scenarios are tests/test_scheduler.py's, the arbitration cases
tests/test_microwave.py's TestArbitration; a multi-wave churn case drives
the patch path with node add/update/remove and pod confirm/delete between
waves. Also held here: the copied PriorityQueue and overload governor fed
identical inputs, and every unported argument or switch raising.
"""

import dataclasses
import hashlib
import random

import numpy as np
import pytest
import torch

import kubernetes_tpu.api.types as JT
import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu.sched.overload import OverloadConfig as JConfig
from kubernetes_tpu.sched.overload import OverloadGovernor as JGovernor
from kubernetes_tpu.sched.queue import PriorityQueue as JQueue
from kubernetes_tpu.sched.scheduler import RecordingBinder as JBinder
from kubernetes_tpu.sched.scheduler import Scheduler as JScheduler
from kubernetes_tpu.state.dims import Dims as JDims
from kubernetes_tpu_torch.sched.overload import OverloadConfig as TConfig
from kubernetes_tpu_torch.sched.overload import OverloadGovernor as TGovernor
from kubernetes_tpu_torch.sched.queue import PriorityQueue as TQueue
from kubernetes_tpu_torch.sched.scheduler import RecordingBinder as TBinder
from kubernetes_tpu_torch.sched.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.state.dims import Dims as TDims
from torch_parity import as_np

HOSTNAME = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"

SIDES = {"jax": (JT, JScheduler, JBinder, JDims),
         "port": (TT, TScheduler, TBinder, TDims)}


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


class Drive:
    """One side's scheduler, driven through its package's own types."""

    def __init__(self, side, fail_keys=(), base_dims=None, **kw):
        self.T, sched_cls, binder_cls, dims_cls = SIDES[side]
        self.clock = FakeClock()
        if base_dims is not None:
            kw["base_dims"] = dims_cls(**base_dims)
        if side == "port":
            kw["device"] = "cpu"
        self.s = sched_cls(binder=binder_cls(fail_keys=fail_keys),
                           clock=self.clock, **kw)
        if side == "jax":
            self.s.prewarmer.enabled = False
        self.waves = []

    def node(self, name, cpu=4, mem="8Gi", zone=None, **kw):
        labels = dict(kw.pop("labels", {}))
        labels.setdefault(HOSTNAME, name)
        if zone is not None:
            labels[ZONE] = zone
        taints = tuple(self.T.Taint(*t) for t in kw.pop("taints", ()))
        return self.T.Node(name=name, labels=labels, taints=taints,
                           allocatable=self.T.Resources.make(
                               cpu=cpu, memory=mem, pods=110), **kw)

    def pod(self, name, cpu="500m", mem="256Mi", app=None, anti=False,
            spread=False, **kw):
        T = self.T
        if app is not None:
            sel = T.LabelSelector.of(match_labels={"app": app})
            kw["labels"] = {"app": app}
            if anti:
                kw["affinity"] = T.Affinity(anti_required=(
                    T.PodAffinityTerm(selector=sel, topology_key=HOSTNAME),))
            if spread:
                kw["topology_spread"] = (T.TopologySpreadConstraint(
                    max_skew=2, topology_key=ZONE,
                    when_unsatisfiable=T.UnsatisfiableAction.DO_NOT_SCHEDULE,
                    selector=sel),)
        return T.Pod(name=name, requests=T.Resources.make(cpu=cpu, memory=mem),
                     **kw)

    def wave(self, now=None):
        return self._note(self.s.schedule_pending(now))

    def idle(self, **kw):
        return self._note(self.s.run_until_idle(**kw))

    def _note(self, st):
        self.waves.append((st.attempted, st.scheduled, st.unschedulable,
                           st.bind_errors, st.micro, st.requeued,
                           dict(st.assignments)))
        return st

    def record(self):
        return dict(waves=self.waves, bound=list(self.s.binder.bound),
                    counts=self.s.cache.counts(),
                    lengths=self.s.queue.lengths(),
                    micro_waves=self.s.micro_waves,
                    mode=self.s.cache.last_snapshot_mode)


def run_both(scenario, **kw):
    recs = {}
    for side in SIDES:
        d = Drive(side, **kw)
        scenario(d)
        recs[side] = d.record()
    assert recs["port"] == recs["jax"]
    return recs["port"]


# --------------------------------------------------------------------- #
# tests/test_scheduler.py's nine scenarios
# --------------------------------------------------------------------- #


def happy_path(d):
    for i in range(3):
        d.s.on_node_add(d.node(f"n{i}"))
    for i in range(10):
        d.s.on_pod_add(d.pod(f"p{i}", cpu="100m"))
    st = d.wave()
    assert st.attempted == st.scheduled == 10
    assert d.s.cache.counts()[1] == 10


def assume_feedback_across_waves(d):
    d.s.on_node_add(d.node("n0", cpu=1))
    d.s.on_pod_add(d.pod("a", cpu="600m"))
    assert d.wave().scheduled == 1
    d.s.on_pod_add(d.pod("b", cpu="600m"))
    st = d.wave()
    assert st.scheduled == 0 and st.unschedulable == 1


def unschedulable_retries_after_node_add(d):
    d.s.on_pod_add(d.pod("a"))
    assert d.wave().unschedulable == 1
    assert d.s.queue.lengths() == (0, 0, 1)
    d.clock.t = 5.0
    d.s.on_node_add(d.node("n0"))
    d.s.queue.pump(d.clock.t)
    assert d.wave().scheduled == 1


def bind_failure_rolls_back_assume(d):
    d.s.on_node_add(d.node("n0"))
    d.s.on_pod_add(d.pod("a"))
    assert d.wave().bind_errors == 1
    assert d.s.cache.get_pod("default/a") is None
    assert d.s.queue.lengths()[2] + d.s.queue.lengths()[1] == 1


def informer_confirmation_and_delete(d):
    d.s.on_node_add(d.node("n0", cpu=1))
    d.s.on_pod_add(d.pod("a", cpu="800m"))
    d.wave()
    bound = d.pod("a", cpu="800m", node_name="n0")
    d.s.on_pod_add(bound)
    assert not d.s.cache.is_assumed("default/a")
    d.s.on_pod_add(d.pod("b", cpu="800m"))
    assert d.wave().unschedulable == 1
    d.s.on_pod_delete(bound)
    d.clock.t = 5.0
    assert d.wave().scheduled == 1


def foreign_scheduler_pods_ignored(d):
    d.s.on_node_add(d.node("n0"))
    d.s.on_pod_add(d.pod("mine"))
    d.s.on_pod_add(d.pod("theirs", scheduler_name="other-scheduler"))
    assert d.wave().attempted == 1
    assert [k for k, _ in d.s.binder.bound] == ["default/mine"]


def priority_order_within_wave(d):
    d.s.on_node_add(d.node("n0", cpu=1))
    d.s.on_pod_add(d.pod("low", cpu="600m", priority=1, creation_index=0))
    d.s.on_pod_add(d.pod("high", cpu="600m", priority=10, creation_index=1))
    st = d.wave()
    assert st.assignments.get("default/high") == "n0"
    assert "default/low" not in st.assignments


def tainted_node_rejected_without_toleration(d):
    d.s.on_node_add(d.node("bad", taints=(
        ("dedicated", "gpu", d.T.TaintEffect.NO_SCHEDULE),)))
    d.s.on_pod_add(d.pod("a"))
    assert d.wave().unschedulable == 1
    d.clock.t = 5.0
    d.s.on_node_add(d.node("good"))
    assert d.wave().scheduled == 1


def run_until_idle_drains_queue(d):
    for i in range(4):
        d.s.on_node_add(d.node(f"n{i}"))
    for i in range(10):
        d.s.on_pod_add(d.pod(f"p{i}", cpu="100m"))
    assert d.idle().scheduled == 10


SCENARIOS = [happy_path, assume_feedback_across_waves,
             unschedulable_retries_after_node_add,
             bind_failure_rolls_back_assume,
             informer_confirmation_and_delete,
             foreign_scheduler_pods_ignored, priority_order_within_wave,
             tainted_node_rejected_without_toleration,
             run_until_idle_drains_queue]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scheduler_scenario(scenario):
    kw = {}
    if scenario is bind_failure_rolls_back_assume:
        kw["fail_keys"] = ["default/a"]
    if scenario is run_until_idle_drains_queue:
        kw["batch_size"] = 4
    run_both(scenario, **kw)


# --------------------------------------------------------------------- #
# multi-wave churn on the patch path
# --------------------------------------------------------------------- #


def churn(seed):
    """About 64 nodes in 4 zones and 600 pods in 12 groups (hostname
    anti-affinity on a quarter, zone spread on a third): 300 pods up front,
    25 more before each wave. Between waves: informer confirmations of half
    the wave's bindings, a confirmed pod deleted, and a node added, updated
    or removed — so the patch path carries node, existing-pod and pending
    rows."""
    def scenario(d):
        rng = random.Random(seed)
        next_pod = 0

        def arrive(n, first_group=0):
            nonlocal next_pod
            for i in range(next_pod, next_pod + n):
                g = first_group + rng.randrange(12)
                d.s.on_pod_add(d.pod(
                    f"p{i}", cpu=rng.choice(["100m", "250m", "500m", "1"]),
                    app=f"g{g}", anti=(g % 4 == 0), spread=(g % 3 == 0),
                    priority=g % 3, creation_index=i))
            next_pod += n

        for i in range(64):
            d.s.on_node_add(d.node(f"n{i}", cpu=rng.choice([2, 4, 8]),
                                   zone=f"z{i % 4}"))
        arrive(300)
        confirmed = []
        next_node = 64
        for w in range(12):
            # later arrivals bring groups of their own (new classes), with
            # a deep backlog behind them: the ids the next wave's snapshot
            # sees depend on what was interned while this one ran
            arrive(25, first_group=w)
            st = d.wave(now=d.clock.advance(2.0))
            for key, node in sorted(st.assignments.items())[::2]:
                p = dataclasses.replace(d.s.cache.get_pod(key),
                                        node_name=node)
                d.s.on_pod_add(p)
                confirmed.append(p)
            if confirmed and rng.random() < 0.7:
                d.s.on_pod_delete(
                    confirmed.pop(rng.randrange(len(confirmed))))
            op = rng.choice(["add", "update", "remove"])
            if op == "add":
                d.s.on_node_add(d.node(f"n{next_node}", cpu=4,
                                       zone=f"z{next_node % 4}"))
                next_node += 1
            elif op == "update":
                i = rng.randrange(next_node)
                if d.s.cache.get_node(f"n{i}") is not None:
                    d.s.on_node_update(d.node(f"n{i}", cpu=8,
                                              zone=f"z{i % 4}"))
            else:
                live = sorted(n.name for n in d.s.cache.nodes())
                d.s.on_node_delete(rng.choice(live))
            d.waves[-1] += (snapshot_digest(d.s.cache._snapshot),
                            d.s.cache.last_snapshot_mode,
                            d.s.cache.last_patch_rows)
    return scenario


def snapshot_digest(snap):
    """sha256 over every plane of a snapshot's tables, existing and pending
    (uint32 words as their int32 view), so two packages' snapshots compare
    by value."""
    h = hashlib.sha256()
    for part in (snap.tables, snap.existing, snap.pending):
        for leaf in _leaves(part):
            a = np.ascontiguousarray(as_np(leaf))
            h.update(str((a.dtype.kind, a.shape)).encode())
            h.update(a.astype(np.int64).tobytes())
    return h.hexdigest()


def _leaves(x):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return [leaf for f in x._fields for leaf in _leaves(getattr(x, f))]
    return [x]


@pytest.mark.parametrize("seed", [0, 1])
def test_multi_wave_churn_equal_wave_by_wave(seed):
    rec = run_both(churn(seed), batch_size=128,
                   base_dims=dict(N=128, P=128, E=1024, D=128, SC=128, S=32,
                                  SL=64))
    assert len(rec["waves"]) == 12
    assert sum(w[1] for w in rec["waves"]) > 300
    assert [w[-2] for w in rec["waves"]][1:] == ["patch"] * 11


# --------------------------------------------------------------------- #
# micro-wave arbitration (tests/test_microwave.py TestArbitration)
# --------------------------------------------------------------------- #


def _micro_nodes(d, n=4):
    for i in range(n):
        d.s.on_node_add(d.node(f"n{i}"))


def fresh_deltas_admit_as_micro_wave(d):
    _micro_nodes(d)
    for i in range(3):
        d.s.on_pod_add(d.pod(f"p{i}", cpu="100m", mem="64Mi",
                             creation_index=i))
    st = d.wave()
    assert st.micro == 1 and st.scheduled == 3 and d.s.micro_waves == 1


def mixed_lane_forces_bulk(d):
    _micro_nodes(d)
    d.s.on_pod_add(d.pod("fresh", cpu="100m", creation_index=0))
    d.s.queue.add_prompt_retry(d.pod("retry", cpu="100m", creation_index=1),
                               attempts=2, now=d.clock.t)
    st = d.wave(now=d.clock.advance(0.1))
    assert st.micro == 0 and st.scheduled == 2


def deep_lane_forces_bulk(d):
    _micro_nodes(d)
    for i in range(9):
        d.s.on_pod_add(d.pod(f"p{i}", cpu="100m", creation_index=i))
    st = d.wave()
    assert st.micro == 0 and st.scheduled == 8
    d.idle()
    assert len(d.s.binder.bound) == 9


def micro_probe_noop_when_lane_not_ready(d):
    _micro_nodes(d)
    for i in range(9):
        d.s.on_pod_add(d.pod(f"p{i}", cpu="100m", creation_index=i))
    st = d.s.schedule_micro()
    assert st.micro == 0 and st.attempted == 0
    assert d.s.queue.lengths()[0] == 9 and d.s.binder.bound == []


def micro_between_bulk_waves(d):
    """Bulk waves then micro waves on the same resident state: the micro
    graft's placements see the bulk assumes, and the next bulk wave sees
    the micro assumes."""
    _micro_nodes(d, 6)
    for i in range(20):
        d.s.on_pod_add(d.pod(f"b{i}", cpu="250m", app=f"g{i % 3}",
                             anti=(i % 3 == 0), creation_index=i))
    d.wave()
    d.wave()
    for i in range(3):
        d.s.on_pod_add(d.pod(f"m{i}", cpu="500m", app="g0", anti=True,
                             creation_index=100 + i))
    st = d.wave()
    assert st.micro == 1
    d.s.on_node_update(d.node("n2", cpu=8))
    d.s.on_pod_add(d.pod("m3", cpu="500m", creation_index=200))
    assert d.wave().micro == 1


MICRO = [fresh_deltas_admit_as_micro_wave, mixed_lane_forces_bulk,
         deep_lane_forces_bulk, micro_probe_noop_when_lane_not_ready,
         micro_between_bulk_waves]


@pytest.mark.parametrize("scenario", MICRO, ids=lambda f: f.__name__)
def test_micro_wave_arbitration_and_placements(scenario):
    run_both(scenario, batch_size=8, microwave=True)


def test_micro_coalesce_window_holds_then_admits(monkeypatch):
    monkeypatch.setenv("KTPU_MICRO_COALESCE_S", "0.5")

    def scenario(d):
        _micro_nodes(d)
        d.s.on_pod_add(d.pod("p0", cpu="100m", creation_index=0))
        st = d.wave(now=d.clock.advance(0.1))
        assert st.micro == 0 and st.attempted == 0
        st = d.wave(now=d.clock.advance(0.6))
        assert st.micro == 1 and st.scheduled == 1

    run_both(scenario, batch_size=8, microwave=True)


@pytest.mark.parametrize("val,on", [("1", True), ("0", False), ("", False)])
def test_microwave_env_opt_in(monkeypatch, val, on):
    monkeypatch.setenv("KTPU_MICROWAVE", val)
    assert TScheduler(binder=TBinder(), device="cpu").microwave is on
    assert JScheduler(binder=JBinder()).microwave is on


# --------------------------------------------------------------------- #
# the copied queue and governor
# --------------------------------------------------------------------- #


def test_priority_queue_copies_agree():
    def drive(T, q):
        out = []
        for i in range(12):
            q.add(T.Pod(name=f"p{i}", priority=i % 3, creation_index=i,
                        requests=T.Resources.make(cpu="100m", memory="1Mi")),
                  now=0.0)
        out.append([(p.key, a) for p, a in q.pop_batch(5, now=1.0)])
        for p, a in q.pop_batch(3, now=1.0):
            q.add_unschedulable(p, a, 1.0, cycle=q.current_cycle())
        out.append(q.lengths())
        out.append(q.micro_stats())
        out.append([p.key for p in q.peek_active(10)])
        q.move_all_to_active(2.0)
        out.append(q.depths())
        q.pump(30.0)
        out.append(q.depths())
        pods = q.pop_micro(2, now=30.0)
        out.append([(p.key, a) for p, a in pods])
        for p, a in q.pop_batch(3, now=30.0):
            q.park_deferred(p, a, now=30.0)
        out.append(sorted(q.deferred_keys()))
        out.append(q.release_deferred(31.0))
        out.append([(p.key, a) for p, a in q.pop_batch(100, now=31.0)])
        out.append(q.lengths())
        return out

    assert drive(TT, TQueue()) == drive(JT, JQueue())


def test_overload_governor_copies_shrink_alike():
    """Over-deadline waves under queue pressure drive both governors into
    SHED_LOW and halve the wave limit alike; healthy waves grow it back."""
    seq = []
    for side, (cfg_cls, gov_cls) in {"jax": (JConfig, JGovernor),
                                     "port": (TConfig, TGovernor)}.items():
        gov = gov_cls(512, cfg=cfg_cls(), clock=lambda: 0.0)
        out = []
        depths = {"active": 4096, "backoff": 0, "unschedulable": 0,
                  "deferred": 0}
        for w in range(10):
            dec = gov.begin_wave(float(w), depths)
            out.append((dec.mode, dec.wave_limit, dec.shed_below))
            gov.end_wave(float(w), 256, 6.0 if w < 6 else 1.0)
            out.append(gov.wave_limit())
        out.append(gov.snapshot())
        seq.append(out)
    assert seq[0] == seq[1]
    limits = [x for x in seq[1] if isinstance(x, int)]
    assert min(limits) < 512 and "SHED_LOW" in str(seq[1])


def test_governor_gates_the_port_scheduler_like_the_jax_one():
    """A breaker opened by failed commits pauses both schedulers' next
    wave (no pop); the half-open probe then admits it."""
    def scenario(d):
        cfg_cls, gov_cls = ((TConfig, TGovernor) if d.T is TT
                            else (JConfig, JGovernor))
        d.s.governor = gov_cls(8, cfg=cfg_cls(fail_threshold=3,
                                              cooldown_s=1.0),
                               clock=d.clock)
        for _ in range(3):
            d.s.governor.note_commit(False, 0.01)
        _micro_nodes(d)
        d.s.on_pod_add(d.pod("p0", cpu="100m"))
        st = d.wave(now=d.clock.advance(0.1))
        assert st.commit_paused == 1 and st.attempted == 0
        assert d.wave(now=d.clock.advance(1.1)).scheduled == 1

    run_both(scenario, batch_size=8)


# --------------------------------------------------------------------- #
# what the port refuses
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("kw,item", [
    (dict(preemptor=object()), "A9"),
    (dict(extenders=[object()]), "A11"),
    (dict(framework=object()), "A11"),
    (dict(mesh=2), "A13"),
    (dict(ledger=object()), "A14"),
    (dict(fence_source=lambda: 0), "A14"),
])
def test_unported_arguments_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        TScheduler(binder=TBinder(), device="cpu", **kw)


@pytest.mark.parametrize("env,val,item", [
    ("KTPU_EXPLAIN", "1", "A9"),
    ("KTPU_MESH", "auto", "A13"),
    ("KTPU_MESH", "4", "A13"),
])
def test_unported_switches_raise(monkeypatch, env, val, item):
    monkeypatch.setenv(env, val)
    with pytest.raises(NotImplementedError, match=item):
        TScheduler(binder=TBinder(), device="cpu")


def test_gang_batch_and_runs_engine_raise(monkeypatch):
    s = TScheduler(binder=TBinder(), device="cpu")
    s.on_node_add(TT.Node(name="n0", allocatable=TT.Resources.make(
        cpu="4", memory="8Gi", pods=110)))
    s.on_pod_add(TT.Pod(name="g0", pod_group="job", min_member=2,
                        requests=TT.Resources.make(cpu="1", memory="1Gi")))
    with pytest.raises(NotImplementedError, match="A9"):
        s.schedule_pending()
    s2 = TScheduler(binder=TBinder(), device="cpu")
    s2.on_node_add(TT.Node(name="n0", allocatable=TT.Resources.make(
        cpu="4", memory="8Gi", pods=110)))
    s2.on_pod_add(TT.Pod(name="p0", requests=TT.Resources.make(
        cpu="1", memory="1Gi")))
    monkeypatch.setenv("KTPU_ASSIGN", "runs")
    with pytest.raises(NotImplementedError, match="A9"):
        s2.schedule_pending()


def test_cache_refuses_a_mesh():
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    from kubernetes_tpu_torch.state.encode import Encoder

    with pytest.raises(NotImplementedError, match="A13"):
        SchedulerCache().snapshot(Encoder(), [], device="cpu", mesh=object())


def test_scheduler_and_cache_raise_without_a_gpu(monkeypatch):
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    from kubernetes_tpu_torch.state.encode import Encoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TScheduler(binder=TBinder())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SchedulerCache().snapshot(Encoder(), [])
