"""The port's bucket prewarmer (kubernetes_tpu_torch/sched/prewarm.py) held
against the JAX package's (kubernetes_tpu/sched/prewarm.py):
tests/test_prewarm.py's TestTriggerPolicy — the same observe() sequence
fires the same target signatures in both packages — and
TestGrowthAcrossBucketBoundary — a cluster growing across a Dims bucket
keeps placing pods, and its placements equal the JAX package's and the
port's own with the prewarmer off. Also held: the warm dispatch itself on
the CPU (built from a fresh Encoder at the target Dims, never the live
cache, launching K1/K2 — K3 for the preemption burst — through their
wrappers), and warm_patch_ladder's rung count against the JAX package's on
the same snapshot, and test_prewarm.py's fleet cases: the fleet key slot
never crosses a single-cluster one, and a fleet warm runs the stacked
dispatch (fleet/cycle.py). Its mesh cases wait for ROADMAP item 13.
"""

import dataclasses
import threading

import pytest

import kubernetes_tpu.api.types as JT
import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu.sched.prewarm import BucketPrewarmer as JPrewarmer
from kubernetes_tpu.state.dims import Dims as JDims
from kubernetes_tpu_torch.sched.prewarm import BucketPrewarmer as TPrewarmer
from kubernetes_tpu_torch.state.dims import Dims as TDims


def mknode(T, i, cpu="8"):
    return T.Node(name=f"n{i}",
                  allocatable=T.Resources.make(cpu=cpu, memory="16Gi",
                                               pods=110))


def spy():
    calls = []
    ev = threading.Event()

    def jax_compile(d, engine, extras, gang, mesh=None, rc=0, fleet=None):
        calls.append((dataclasses.astuple(d), engine, gang))
        ev.set()

    def port_compile(d, engine, extras, gang, rc=0, fleet=None):
        calls.append((dataclasses.astuple(d), engine, gang))
        ev.set()

    return calls, ev, jax_compile, port_compile


def both(min_axis, sequence, Dims_kw):
    """Feed one observe() sequence to each package's prewarmer; returns the
    port's fired targets after asserting they equal the JAX package's."""
    fired = {}
    for side in ("jax", "port"):
        calls, ev, jc, pc = spy()
        if side == "jax":
            pw = JPrewarmer(threshold=0.8, min_axis=min_axis, compile_fn=jc)
            d = JDims().grown_for(**Dims_kw)
        else:
            pw = TPrewarmer(threshold=0.8, min_axis=min_axis, compile_fn=pc,
                            device="cpu")
            d = TDims().grown_for(**Dims_kw)
        for kw in sequence:
            pw.observe(d, **kw)
            pw.wait(5)
        fired[side] = calls
    assert fired["port"] == fired["jax"]
    return fired["port"]


class TestTriggerPolicy:
    def test_fires_at_threshold_once_per_signature(self):
        calls = both(8, [dict(n_nodes=4, n_existing=4),     # 25% — quiet
                         dict(n_nodes=13, n_existing=4),    # 81% of N
                         dict(n_nodes=14, n_existing=4)],   # same target
                     dict(N=16, E=16))
        assert len(calls) == 1
        assert calls[0][0][0] > 16                           # the NEXT N

    def test_multi_axis_crossing_warms_each_target(self):
        calls = both(8, [dict(n_nodes=14, n_existing=14)] * 5,
                     dict(N=16, E=16))
        warmed = {(c[0][0], c[0][2]) for c in calls}
        assert {(32, 16), (16, 32), (32, 32)} <= warmed

    def test_gang_traces_warm_separately(self):
        calls = both(8, [dict(n_nodes=14, n_existing=1, gang=True),
                         dict(n_nodes=14, n_existing=1, gang=False)],
                     dict(N=16))
        assert [c[2] for c in calls] == [True, False]

    def test_small_axes_never_warm(self):
        assert both(256, [dict(n_nodes=16, n_existing=16)],
                    dict(N=16, E=16)) == []

    def test_existing_axis_growth_fires(self):
        calls = both(8, [dict(n_nodes=2, n_existing=30)], dict(N=16, E=32))
        assert calls and calls[0][0][2] > 32

    def test_failed_warm_clears_ledger_for_retry(self, monkeypatch):
        """A failed background warm never propagates and clears the warmed
        ledger so a later cycle retries."""
        import kubernetes_tpu_torch.sched.prewarm as pm

        def boom(*a, **k):
            raise RuntimeError("warm backend down")

        monkeypatch.setattr(pm, "warm_cycle", boom)
        pw = TPrewarmer(threshold=0.8, min_axis=8, device="cpu")
        pw.observe(TDims().grown_for(N=16), n_nodes=13, n_existing=1)
        pw.wait(10)
        assert not pw._warmed and pw.warm == {}


def grow(side, prewarmer=None):
    """Node count grows 8 → 24 across the N=16 bucket while each step's
    wave places two pods; returns the binder's order."""
    if side == "jax":
        from kubernetes_tpu.sched.scheduler import RecordingBinder, Scheduler
        T, Dims, kw = JT, JDims, {}
    else:
        from kubernetes_tpu_torch.sched.scheduler import (RecordingBinder,
                                                          Scheduler)
        T, Dims, kw = TT, TDims, {"device": "cpu"}
    s = Scheduler(binder=RecordingBinder(),
                  base_dims=Dims().grown_for(N=16, E=16), **kw)
    if prewarmer is not None:
        s.prewarmer = prewarmer
        s.supervisor.prewarmer = prewarmer
    for i in range(8):
        s.on_node_add(mknode(T, i))
    pod_i = 0
    for n in range(8, 24):
        s.on_node_add(mknode(T, n))
        for _ in range(2):
            s.on_pod_add(T.Pod(name=f"p{pod_i}",
                               requests=T.Resources.make(cpu="100m"),
                               creation_index=pod_i))
            pod_i += 1
        assert s.schedule_pending().scheduled == 2, f"stall at {n + 1} nodes"
    s.prewarmer.wait(30)
    assert len(s.binder.bound) == pod_i
    return list(s.binder.bound)


class TestGrowthAcrossBucketBoundary:
    def test_cycles_keep_running_while_cluster_grows(self):
        calls, _, jc, pc = spy()
        ref = grow("jax", JPrewarmer(threshold=0.8, min_axis=8,
                                     compile_fn=jc))
        jax_calls, calls[:] = list(calls), []
        got = grow("port", TPrewarmer(threshold=0.8, min_axis=8,
                                      compile_fn=pc, device="cpu"))
        assert got == ref
        assert calls == jax_calls
        assert any(c[0][0] > 16 for c in calls)

    def test_real_warms_leave_placements_as_without_prewarmer(self):
        warm = TPrewarmer(threshold=0.8, min_axis=8, device="cpu")
        off = TPrewarmer(device="cpu")
        off.enabled = False
        assert grow("port", warm) == grow("port", off)
        assert any(d.N > 16 for d, eng in warm.warm_log)
        assert all(eng == "waves" for _, eng in warm.warm_log)


# --------------------------------------------------------------------- #
# the warm dispatch itself
# --------------------------------------------------------------------- #


def test_warm_cycle_runs_k1_k2_at_the_target_dims(monkeypatch):
    """The warm runs at the target Dims from a fresh Encoder, and reaches
    K1 and K2 through their wrappers (their plain versions on the CPU)."""
    import torch

    from kubernetes_tpu_torch.ops import waves as W
    from kubernetes_tpu_torch.sched.prewarm import warm_cycle, warm_preempt
    from kubernetes_tpu_torch.ops import preempt as OP

    seen = []
    for mod, name in ((W, "contention_scan"), (W, "domain_rank"),
                      (OP, "reprieve_scan")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name:
                            seen.append(_n) or _f(*a))
    d = TDims().grown_for(N=300, P=64, E=600)
    assert warm_cycle(d, torch.device("cpu")) == d
    assert {"contention_scan", "domain_rank"} <= set(seen)
    seen.clear()
    assert warm_cycle(d, torch.device("cpu"), gang=True).N == d.N
    assert "contention_scan" in seen
    seen.clear()
    assert warm_preempt(d, 8, torch.device("cpu")).N == d.N
    assert seen == ["reprieve_scan"]


def test_observe_preempt_warms_once_per_signature():
    p = TPrewarmer(min_axis=8, device="cpu")
    d = TDims().grown_for(N=16, P=16, E=16)
    p.observe_preempt(d, 8)
    p.wait(60)
    p.observe_preempt(dataclasses.replace(d, P=32), 8)   # P never splits it
    p.wait(60)
    assert [eng for _, eng in p.warm_log] == ["preempt"]
    assert p.lookup_preempt(d, 8)


def test_patch_ladder_rung_count_matches_jax():
    """warm_patch_ladder drives one no-op index_copy per rung of each
    resident plane — the same count as the JAX package's for the same
    snapshot — and a repeat call drives nothing."""
    from kubernetes_tpu.state.cache import SchedulerCache as JCache
    from kubernetes_tpu.state.encode import Encoder as JEncoder
    from kubernetes_tpu_torch.state.cache import SchedulerCache as TCache
    from kubernetes_tpu_torch.state.encode import Encoder as TEncoder

    counts = {}
    for side, T, Cache, Enc, Dims, kw in (
            ("jax", JT, JCache, JEncoder, JDims, {}),
            ("port", TT, TCache, TEncoder, TDims, {"device": "cpu"})):
        cache, enc = Cache(), Enc()
        for i in range(12):
            cache.add_node(mknode(T, i))
        pods = [T.Pod(name=f"p{i}", requests=T.Resources.make(cpu="10m"))
                for i in range(5)]
        snap = cache.snapshot(enc, pods, Dims(N=16, P=16, E=300), **kw)
        counts[side] = (cache.warm_patch_ladder(snap),
                        cache.warm_patch_ladder(snap))
    assert counts["port"] == counts["jax"]
    assert counts["port"][0] >= 6 and counts["port"][1] == 0


class TestFleetKey:
    def test_fleet_and_single_cluster_never_cross(self):
        """The tenant-stack signature is a key slot of its own: a K-tenant
        fleet entry is invisible to a single-cluster lookup at identical
        dims (and vice versa), across every K."""
        pw = TPrewarmer(threshold=0.8, min_axis=8, device="cpu")
        d = TDims().grown_for(N=16, E=16)
        pw.warm[pw._key(d, "waves", (), False, 0, 8)] = 0.5
        assert pw.lookup(d, "waves", (), False, fleet=8)
        assert not pw.lookup(d, "waves", (), False)
        assert not pw.lookup(d, "waves", (), False, fleet=16)
        pw.warm.clear()
        pw.warm[pw._key(d, "waves", (), False, 0)] = 0.5
        assert pw.lookup(d, "waves", (), False)
        assert not pw.lookup(d, "waves", (), False, fleet=8)

    def test_fleet_warm_runs_the_stacked_dispatch(self):
        """ensure_warm(fleet=K) runs a throwaway fleet dispatch of K probe
        tenants at the signature's dims and records it under the fleet
        key; the single-cluster slot stays empty, and the warm is
        idempotent per signature."""
        import kubernetes_tpu_torch.fleet.cycle as FC

        calls = []
        orig = FC.dispatch_fleet

        def spy(tables, pending, keys_host, D, existing, engine, quota,
                **kw):
            calls.append((tuple(pending.valid.shape), engine))
            return orig(tables, pending, keys_host, D, existing, engine,
                        quota, **kw)

        FC.dispatch_fleet = spy
        try:
            d = TDims().grown_for(N=16, P=16, E=16)
            pw = TPrewarmer(threshold=0.8, min_axis=8, device="cpu")
            assert pw.ensure_warm(d, "waves", fleet=4)
            pw.wait(120)
        finally:
            FC.dispatch_fleet = orig
        assert calls == [((4, 16), "waves")]
        assert pw.lookup(d, "waves", (), False, fleet=4)
        assert not pw.lookup(d, "waves", (), False)
        assert not pw.ensure_warm(d, "waves", fleet=4)
