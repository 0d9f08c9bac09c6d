"""The port's dispatch supervisor (kubernetes_tpu_torch/sched/supervisor.py)
under injected device faults, held against the JAX package's
(kubernetes_tpu/sched/supervisor.py): tests/test_chaos.py's supervisor
cases — a hang, an error and an OOM mid-dispatch, the abandoned wave, the
supervised preemption burst, the readmission rewarm, snapshot-device
routing, a prewarm invalidate that fences an in-flight warm.

The JAX package's fallback always finds its CPU backend; the port degrades
only when the operator configures `fallback_device`. So the port runs the
fallback cases with fallback_device="cpu", and its placements (the binder's
order) equal the JAX package's on the same events. One more case holds
that WITHOUT that setting an injected error abandons the wave, requeues
every pod and runs nothing on a fallback; others hold the CUDA failure
classes (OOM recoverable, a failed kernel launch or sticky CUDA error lost
for good, and abandoned even with a fallback configured) and that a dispatch on the worker thread places exactly as one on
the calling thread. Warm dispatches get a 0.75 s deadline, the prober
retries every 50 ms, and the scheduler clock is a fake one.
"""

import threading

import pytest
import torch

import kubernetes_tpu.api.types as JT
import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu.sched.preemption import Preemptor as JPreemptor
from kubernetes_tpu.sched.scheduler import RecordingBinder as JBinder
from kubernetes_tpu.sched.scheduler import Scheduler as JScheduler
from kubernetes_tpu.state.dims import Dims as JDims
from kubernetes_tpu.utils import faultline as jfaultline
from kubernetes_tpu_torch.ops.kernels import KernelLaunchError
from kubernetes_tpu_torch.sched.preemption import Preemptor as TPreemptor
from kubernetes_tpu_torch.sched.scheduler import RecordingBinder as TBinder
from kubernetes_tpu_torch.sched.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.sched.supervisor import (DispatchAbandonedError,
                                                   DispatchSupervisor)
from kubernetes_tpu_torch.state.dims import Dims as TDims
from kubernetes_tpu_torch.utils import faultline as tfaultline

pytestmark = pytest.mark.chaos

HOSTNAME = "kubernetes.io/hostname"
SIDES = {
    "jax": (JT, JScheduler, JBinder, JDims, jfaultline, JPreemptor),
    "port": (TT, TScheduler, TBinder, TDims, tfaultline, TPreemptor),
}


@pytest.fixture(autouse=True)
def _fast_watchdog(monkeypatch):
    monkeypatch.setenv("KTPU_DISPATCH_DEADLINE", "0.75")
    monkeypatch.setenv("KTPU_PROBE_BACKOFF", "0.05")
    yield
    jfaultline.uninstall()
    tfaultline.uninstall()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def mknode(T, name, cpu=4, mem="8Gi"):
    return T.Node(name=name, labels={HOSTNAME: name},
                  allocatable=T.Resources.make(cpu=cpu, memory=mem,
                                               pods=110))


def mkpod(T, name, cpu="100m", mem="64Mi", **kw):
    return T.Pod(name=name, requests=T.Resources.make(cpu=cpu, memory=mem),
                 **kw)


def mksched(side, fallback=True, **kw):
    T, Sched, Binder, Dims, _fl, _pre = SIDES[side]
    kw.setdefault("base_dims", Dims(N=16, P=16, E=64))
    kw.setdefault("batch_size", 8)
    kw.setdefault("clock", FakeClock())
    if side == "port":
        kw["device"] = "cpu"
        if fallback:
            kw["fallback_device"] = "cpu"
    return Sched(binder=Binder(), **kw)


def assert_ledger(s, total_pods):
    """Every pod bound exactly once, the cache mirrors the binder, the
    queues are empty, the snapshot generation converged."""
    keys = [k for k, _ in s.binder.bound]
    assert len(keys) == total_pods, f"lost pods: {total_pods - len(keys)}"
    assert len(set(keys)) == len(keys), "double-bound pods"
    assert s.cache.counts()[1] == total_pods
    assert s.queue.lengths() == (0, 0, 0)
    dev = {"device": "cpu"} if isinstance(s, TScheduler) else {}
    snap1 = s.cache.snapshot(s.encoder, [], s.base_dims, **dev)
    snap2 = s.cache.snapshot(s.encoder, [], s.base_dims, **dev)
    assert snap2 is snap1 and s.cache.last_snapshot_mode == "cached"


def both(scenario):
    """Run `scenario(side)` on both packages; the port's binder order must
    equal the JAX package's. Returns the port's result."""
    out = {side: scenario(side) for side in ("jax", "port")}
    assert out["port"][0] == out["jax"][0]
    return out["port"]


# --------------------------------------------------------------------- #
# device faults → the degradation ladder (fallback configured)
# --------------------------------------------------------------------- #


def test_device_hang_degrades_to_cpu_and_recovers():
    """device.hang@cycle:2: the watchdog abandons wave 2 within one deadline,
    the configured fallback completes it, the prober re-admits."""
    def scenario(side):
        T, fl = SIDES[side][0], SIDES[side][4]
        fl.install("device.hang@cycle:2")
        s = mksched(side)
        for i in range(8):
            s.on_node_add(mknode(T, f"n{i}"))
        for i in range(24):
            s.on_pod_add(mkpod(T, f"p{i}"))
        total = s.run_until_idle()
        fl.uninstall()
        st = s.supervisor.stats
        assert st.watchdog_timeouts == 1
        assert st.degraded_cycles >= 1 and st.fallback_dispatches >= 1
        assert total.scheduled == 24
        assert_ledger(s, 24)
        assert max(st.degraded_cycle_seconds) < 30.0
        assert s.supervisor.wait_recovered(15), "prober never re-admitted"
        assert st.recoveries == 1 and st.last_recovery_s is not None
        s.prewarmer.wait(timeout=60)
        return list(s.binder.bound), st

    both(scenario)


def test_device_error_falls_back_without_losing_the_wave():
    def scenario(side):
        T, fl = SIDES[side][0], SIDES[side][4]
        fl.install("device.error@cycle:2,device.oom@cycle:3")
        s = mksched(side)
        for i in range(8):
            s.on_node_add(mknode(T, f"n{i}"))
        for i in range(32):
            s.on_pod_add(mkpod(T, f"p{i}"))
        total = s.run_until_idle()
        fl.uninstall()
        st = s.supervisor.stats
        assert st.device_errors >= 1 and st.fallback_dispatches >= 1
        assert total.scheduled == 32
        assert_ledger(s, 32)
        assert s.supervisor.wait_recovered(15)
        s.prewarmer.wait(timeout=60)
        return list(s.binder.bound), st

    both(scenario)


def test_dispatch_abandoned_forgets_cleanly_and_requeues():
    """Primary AND fallback fail for one wave: nothing assumed, nothing
    bound, every popped pod requeued; the next wave places them."""
    def scenario(side):
        T, fl = SIDES[side][0], SIDES[side][4]
        fl.install("device.error@cycle:2,device.fallback@cycle:1")
        s = mksched(side)
        for i in range(8):
            s.on_node_add(mknode(T, f"n{i}"))
        for i in range(8):
            s.on_pod_add(mkpod(T, f"p{i}"))
        assert s.schedule_pending().scheduled == 8
        for i in range(8, 16):
            s.on_pod_add(mkpod(T, f"p{i}"))
        aborted = s.schedule_pending()
        assert aborted.aborted == 8 and aborted.scheduled == 0
        assert s.supervisor.stats.abandoned == 1
        assert s.cache.counts()[2] == 8
        assert len(s.binder.bound) == 8
        assert s.queue.lengths()[0] == 8
        fl.uninstall()
        assert s.run_until_idle().scheduled >= 8
        assert_ledger(s, 16)
        assert s.supervisor.wait_recovered(15)
        return list(s.binder.bound), None

    both(scenario)


def test_unconfigured_error_abandons_and_requeues_without_fallback():
    """The port's deliberate difference: with no fallback configured, an
    injected device error abandons the wave — the whole batch requeued, no
    partial effect, nothing run on a fallback — and once the prober
    re-admits the device the next wave binds every pod."""
    tfaultline.install("device.error@cycle:2")
    s = mksched("port", fallback=False)
    assert s.supervisor.fallback_device is None
    ran_fallback = []
    real_submit = s.supervisor.submit

    def spy(kind, key, fn, fallback=None):
        return real_submit(kind, key, fn,
                           lambda *a: ran_fallback.append(a) or fallback(*a))

    s.supervisor.submit = spy
    for i in range(8):
        s.on_node_add(mknode(TT, f"n{i}"))
    for i in range(8):
        s.on_pod_add(mkpod(TT, f"p{i}"))
    assert s.schedule_pending().scheduled == 8
    for i in range(8, 16):
        s.on_pod_add(mkpod(TT, f"p{i}"))
    st = s.schedule_pending()
    assert st.aborted == 8 and st.scheduled == 0
    sup = s.supervisor.stats
    assert sup.abandoned == 1 and sup.device_errors == 1
    assert sup.fallback_dispatches == 0 and sup.degraded_cycles == 0
    assert ran_fallback == []
    assert s.cache.counts()[2] == 8 and len(s.binder.bound) == 8
    assert s.queue.lengths()[0] == 8
    events = [k for k, _ in
              s.telemetry.recorder.records()[-1]["supervisor_events"]]
    assert "degraded" in events and "abandoned" in events
    assert s.supervisor.wait_recovered(15)
    assert s.run_until_idle().scheduled == 8
    assert_ledger(s, 16)
    assert sup.fallback_dispatches == 0


@pytest.mark.parametrize("err", [
    KernelLaunchError("contention_scan launch failed: invalid argument"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
], ids=["launch-failure", "sticky-cuda-error"])
def test_lost_backend_abandons_even_with_a_fallback(monkeypatch, err):
    """A kernel that failed to launch, or a dead context, never moves the
    wave off the device, even with fallback_device configured: the wave is
    abandoned and requeued, the fallback never runs, and every later wave
    is abandoned the same way (no prober re-admits a lost backend)."""
    from kubernetes_tpu_torch.sched import scheduler as S

    s = mksched("port")
    assert s.supervisor.fallback_device == torch.device("cpu")
    ran_fallback = []
    real_submit = s.supervisor.submit

    def spy(kind, key, fn, fallback=None):
        return real_submit(kind, key, fn,
                           lambda *a: ran_fallback.append(a) or fallback(*a))

    s.supervisor.submit = spy
    for i in range(8):
        s.on_node_add(mknode(TT, f"n{i}"))
    for i in range(8):
        s.on_pod_add(mkpod(TT, f"p{i}"))
    assert s.schedule_pending().scheduled == 8
    real = S.schedule_batch

    def fail(*a, **kw):
        raise err

    monkeypatch.setattr(S, "schedule_batch", fail)
    for i in range(8, 16):
        s.on_pod_add(mkpod(TT, f"p{i}"))
    st = s.schedule_pending()
    sup = s.supervisor.stats
    assert st.aborted == 8 and st.scheduled == 0
    assert sup.lost and sup.abandoned == 1 and sup.device_errors == 1
    monkeypatch.setattr(S, "schedule_batch", real)
    # the backend stays lost: the next wave skips it and still abandons
    assert s.supervisor.snapshot_device() == s.device
    st = s.schedule_pending()
    assert st.aborted == 8 and st.scheduled == 0 and sup.abandoned == 2
    assert ran_fallback == []
    assert sup.fallback_dispatches == 0 and sup.degraded_cycles == 0
    assert len(s.binder.bound) == 8 and s.queue.lengths()[0] == 8
    events = [k for r in s.telemetry.recorder.records()
              for k, _ in r.get("supervisor_events", ())]
    assert "fallback" not in events and events.count("abandoned") == 2


def test_preempt_burst_supervised_fallback():
    """A device error inside the preemption burst degrades to the
    configured fallback and still evicts and nominates."""
    def scenario(side):
        T, _S, _B, Dims, fl, Pre = SIDES[side]
        fl.install("device.error@preempt:1")
        clock = FakeClock()
        s = mksched(side, clock=clock, preemptor=Pre(), batch_size=4096)
        s.on_node_add(mknode(T, "n0", cpu=1))
        victim = mkpod(T, "victim", cpu="800m")
        victim.node_name = "n0"
        s.on_pod_add(victim)
        s.on_pod_add(T.Pod(name="vip", priority=100,
                           requests=T.Resources.make(cpu="800m",
                                                     memory="256Mi")))
        assert s.schedule_pending().scheduled == 0
        assert s.preemptor.evictor.evicted == ["default/victim"]
        assert s.queue.nominated_node("default/vip") == "n0"
        assert s.supervisor.stats.fallback_dispatches >= 1
        fl.uninstall()
        clock.t = 5.0
        st2 = s.schedule_pending()
        assert st2.assignments.get("default/vip") == "n0"
        assert s.supervisor.wait_recovered(15)
        s.prewarmer.wait(timeout=60)
        return list(s.binder.bound), None

    both(scenario)


def test_preempt_burst_without_fallback_evicts_nothing():
    tfaultline.install("device.error@preempt:1")
    s = mksched("port", fallback=False, preemptor=TPreemptor())
    s.on_node_add(mknode(TT, "n0", cpu=1))
    victim = mkpod(TT, "victim", cpu="800m")
    victim.node_name = "n0"
    s.on_pod_add(victim)
    s.on_pod_add(TT.Pod(name="vip", priority=100, requests=TT.Resources.make(
        cpu="800m", memory="256Mi")))
    st = s.schedule_pending()
    assert st.unschedulable == 1 and s.preemptor.evictor.evicted == []
    assert s.supervisor.stats.abandoned == 1
    assert s.supervisor.wait_recovered(15)


def test_backend_readmission_rewarm():
    """Recovery re-warms the cycle signature in the background."""
    tfaultline.install("device.error@cycle:2")
    s = mksched("port", prewarm=True)
    s.prewarmer.min_axis = 1  # let the tiny test shape rewarm
    for i in range(4):
        s.on_node_add(mknode(TT, f"n{i}"))
    for i in range(16):
        s.on_pod_add(mkpod(TT, f"p{i}"))
    s.run_until_idle()
    assert s.supervisor.wait_recovered(15)
    s.prewarmer.wait(timeout=120)
    assert s.supervisor.stats.rewarms == 1
    assert any(eng == "waves" for _, eng in s.prewarmer.warm_log)
    assert_ledger(s, 16)


def test_snapshot_device_routing_rebuilds_on_placement_change():
    """Degraded mode routes snapshots to the fallback device: a placement
    change forces a full host re-encode, the same placement serves from
    cache again, and recovery re-encodes back onto the primary. (The CPU
    stands in for both devices here, as cpu and cpu:0.)"""
    s = mksched("port", fallback=False)
    sup = s.supervisor
    sup.fallback_device = torch.device("cpu", 0)
    for i in range(4):
        s.on_node_add(mknode(TT, f"n{i}"))
    cache, enc = s.cache, s.encoder
    assert sup.snapshot_device() == torch.device("cpu")
    snap_a = cache.snapshot(enc, [], s.base_dims,
                            device=sup.snapshot_device())
    sup._healthy = False  # degraded, as _mark_unhealthy leaves it
    assert sup.snapshot_device() == torch.device("cpu", 0)
    snap_b = cache.snapshot(enc, [], s.base_dims,
                            device=sup.snapshot_device())
    assert snap_b is not snap_a and cache.last_snapshot_mode == "full"
    assert snap_b.device == torch.device("cpu", 0)
    assert cache.snapshot(enc, [], s.base_dims,
                          device=sup.snapshot_device()) is snap_b
    sup._healthy = True
    snap_c = cache.snapshot(enc, [], s.base_dims,
                            device=sup.snapshot_device())
    assert snap_c is not snap_b and cache.last_snapshot_mode == "full"
    # without a configured fallback a degraded wave stays on the primary
    sup.fallback_device, sup._healthy = None, False
    assert sup.snapshot_device() == torch.device("cpu")


def test_prewarm_invalidate_fences_inflight_warm(monkeypatch):
    """A warm that STARTED before a backend loss must not register after
    invalidate(); a post-recovery rewarm redoes it cleanly."""
    import kubernetes_tpu_torch.sched.prewarm as pw

    p = pw.BucketPrewarmer(device="cpu")
    d = TDims()
    real = pw.warm_cycle

    def invalidate_mid_warm(dd, device, gang=False):
        p.invalidate()  # the backend dies while this warm is running
        return real(dd, device, gang=gang)

    monkeypatch.setattr(pw, "warm_cycle", invalidate_mid_warm)
    p._compile(d, "waves", (), False)
    assert p.warm == {}, "stale warm registered past invalidate()"
    assert not p._warmed, "stale warm record survived the fence"
    monkeypatch.setattr(pw, "warm_cycle", real)
    p.min_axis = 1
    assert p.rewarm(d)
    p.wait(timeout=120)
    assert len(p.warm) == 1 and p.lookup(d, "waves", (), False)


# --------------------------------------------------------------------- #
# CUDA failure classes (raised by the dispatched function on the CPU)
# --------------------------------------------------------------------- #


def _raise(err):
    def fn():
        raise err
    return fn


@pytest.mark.parametrize("err,lost", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), False),
    (KernelLaunchError("contention_scan launch failed: invalid argument"),
     True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     True),
])
def test_cuda_failure_classes(err, lost):
    """OOM is recoverable (the prober re-admits); a failed kernel launch or
    a sticky CUDA error marks the backend lost for good — one event naming
    the error, no prober — and every later call abandons."""
    events = []
    sup = DispatchSupervisor("cpu")
    sup.event_sink = lambda k, d: events.append((k, d))
    with pytest.raises(DispatchAbandonedError):
        sup.run("cycle", "k", _raise(err))
    assert sup.stats.device_errors == 1 and sup.stats.lost is lost
    assert [k for k, _ in events] == ["degraded", "abandoned"]
    if lost:
        assert type(err).__name__ in events[0][1] or "CUDA" in events[0][1]
        assert sup._prober is None
        assert not sup.wait_recovered(0.3)
        with pytest.raises(DispatchAbandonedError):
            sup.run("cycle", "k", lambda: 1)
    else:
        assert sup.wait_recovered(15)
        assert sup.run("cycle", "k", lambda: 1) == 1


def test_a_bug_in_the_dispatch_propagates_unchanged():
    sup = DispatchSupervisor("cpu", fallback_device="cpu")
    with pytest.raises(ValueError, match="bug"):
        sup.run("cycle", "k", _raise(ValueError("bug")), lambda d, h: 0)
    assert sup.healthy and sup.stats.device_errors == 0


def test_worker_runs_the_dispatch_off_the_serving_thread():
    """The dispatch runs on the supervisor's worker, and the placements
    equal those of the same waves dispatched on the calling thread."""
    threads = []

    def drain(inline):
        s = mksched("port", fallback=False, batch_size=6)
        if inline:
            sup = s.supervisor
            sup.submit = lambda kind, key, fn, fb=None: type(
                "H", (), {"result": staticmethod(lambda r=fn(): r)})()
        else:
            from kubernetes_tpu_torch.sched import scheduler as S

            real = S.schedule_batch

            def spy(*a, **kw):
                threads.append(threading.current_thread().name)
                return real(*a, **kw)

            S.schedule_batch = spy
        try:
            for i in range(6):
                s.on_node_add(mknode(TT, f"n{i}", cpu=2))
            for i in range(30):
                s.on_pod_add(mkpod(TT, f"p{i}", cpu=f"{100 + 37 * i}m"))
            s.run_until_idle()
        finally:
            if not inline:
                S.schedule_batch = real
        return list(s.binder.bound), s.cache.counts()

    assert drain(False) == drain(True)
    assert threads and all(t == "ktpu-dispatch-cycle" for t in threads)
