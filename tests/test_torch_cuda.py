"""Card tests of the port: the CUDA kernels against their plain versions and
the CUDA cycle against the CPU cycle. They need a CUDA device — a CUDA kernel
has no CPU mode — and skip without one. On a machine with a GPU:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import importlib.util
from pathlib import Path

import pytest
import torch

import kubernetes_tpu_torch as ktt
from kubernetes_tpu_torch.models.workloads import flagship_pods, make_nodes

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kernels_match_plain_versions_exactly(cuda):
    cs = _chip_smoke()
    errs = cs.check_kernels(cuda, *cs.edge_cases(cuda, seed=1))
    assert errs == {"contention_scan": 0, "domain_rank": 0}


def test_reprieve_scan_matches_plain_version_exactly(cuda):
    """K3 on chip_smoke.py's cases (the storm's widths, empty, 110-pod and
    2,000-pod segments, all reblocked, R = 7 and 8, 33 lanes, INT32_MIN
    priorities, extreme int32, no pods; the wide variant at R = 9, 16, 20
    and 64) against its plain version, all seven outputs."""
    cs = _chip_smoke()
    assert cs.check_k3(cuda, cs.k3_edge_cases(cuda, seed=1)) == 0


def test_cuda_cycle_matches_cpu_cycle(cuda):
    nodes = make_nodes(100, zones=4, racks_per_zone=5)
    pods = flagship_pods(1000, groups=24)
    gpu = ktt.BatchScheduler(device="cuda")
    cpu = ktt.BatchScheduler(device="cpu")
    assert gpu.schedule(nodes, [], pods).assignments == \
        cpu.schedule(nodes, [], pods).assignments
    for f in ("used", "ppa", "ppw", "ppt", "CNT", "HOLD", "vol_any", "vol_rw"):
        assert torch.equal(getattr(gpu.last_result.state, f).cpu(),
                           getattr(cpu.last_result.state, f)), f


def test_cuda_port_volume_cycle_matches_cpu_cycle(cuda):
    """chip_smoke.py's port-and-volume workload at 200 nodes: real host-port
    and volume words through K1 (its shared-memory variant: five volume
    words), CUDA against CPU."""
    nodes, pods = _chip_smoke().port_volume_workload(200, 2000)
    gpu = ktt.BatchScheduler(device="cuda")
    cpu = ktt.BatchScheduler(device="cpu")
    assert gpu.schedule(nodes, [], pods).assignments == \
        cpu.schedule(nodes, [], pods).assignments
    for f in ("used", "ppa", "ppw", "ppt", "CNT", "HOLD", "vol_any", "vol_rw"):
        assert torch.equal(getattr(gpu.last_result.state, f).cpu(),
                           getattr(cpu.last_result.state, f)), f


def test_cuda_serving_drain_matches_cpu_drain(cuda, monkeypatch):
    """chip_smoke.py's phase-5b wave loop at 200 nodes × 3,000 pods in waves
    of 512: the port's Scheduler on the card against the same drain on the
    CPU — per-wave counts, snapshot modes, the binder's order, the micro
    wave — and the resident tensors' patches (bool planes included) on the
    card."""
    monkeypatch.setenv("KTPU_OVERLOAD", "0")
    cs = _chip_smoke()
    runs = [cs.serving_drain(cs.port_serving_api(torch.device(d)), 200, 3000,
                             batch_size=512) for d in ("cuda", "cpu")]
    assert runs[0] == runs[1]
    assert runs[0]["waves"][-1]["micro"] == 1
    assert "patch" in [w["mode"] for w in runs[0]["waves"]]


def test_cuda_preempt_storm_matches_cpu_storm(cuda, monkeypatch):
    """chip_smoke.py's phase-6 storm at 200 nodes: a 3,000-pod drain in
    waves of 512, then 64 vips over 3 waves, the port's Scheduler with a
    Preemptor on the card (K3) against the same script on the CPU."""
    monkeypatch.setenv("KTPU_OVERLOAD", "0")
    cs = _chip_smoke()
    runs = []
    for d in ("cuda", "cpu"):
        api = cs.port_serving_api(torch.device(d))
        bound = []
        cs.serving_drain(api, 200, 3000, batch_size=512, keep_bound=bound)
        runs.append(cs.preempt_storm(api, 200, bound, n_pods=3000, vips=64,
                                     waves=3, batch_size=512))
    assert runs[0] == runs[1]
    assert runs[0]["evicted"] > 0


def test_cuda_gang_cycle_matches_cpu_cycle(cuda):
    """BASELINE config 5's workload at 100 nodes x 3,200 pods (one monster
    job): the gang engine's rounds on the card against the CPU."""
    from kubernetes_tpu_torch.models.workloads import gang_workload_pods

    nodes, pods = make_nodes(100, zones=4, racks_per_zone=5), \
        gang_workload_pods(3200)
    gpu = ktt.BatchScheduler(device="cuda")
    cpu = ktt.BatchScheduler(device="cpu")
    assert gpu.schedule(nodes, [], pods).assignments == \
        cpu.schedule(nodes, [], pods).assignments


def _scalar_storm(device, record=None):
    """A small preemption storm with five scalar resources (R = 16, K3's
    wide variant): 40 nodes full of low-priority pods holding GPUs and
    hugepages, then 12 vips asking for two GPUs each, through the port's
    Scheduler with a Preemptor on `device`."""
    from kubernetes_tpu_torch.api import types as T
    from kubernetes_tpu_torch.sched.preemption import Preemptor
    from kubernetes_tpu_torch.sched.scheduler import RecordingBinder, Scheduler

    names = ("example.com/fpga", "hugepages-1Gi", "hugepages-2Mi",
             "nvidia.com/gpu", "vendor.example/nic")

    def res(cpu, gpu, prio_mod=0):
        return T.Resources.make(cpu=cpu, memory="1Gi", scalars=dict(
            zip(names, (prio_mod % 2, 0, 1 + prio_mod % 3, gpu, 1))))

    clock = {"t": 0.0}
    s = Scheduler(binder=RecordingBinder(), clock=lambda: clock["t"],
                  preemptor=Preemptor(), device=device)
    for i in range(40):
        s.on_node_add(T.Node(
            name=f"n{i}", labels={"kubernetes.io/hostname": f"n{i}"},
            allocatable=T.Resources.make(cpu=8, memory="32Gi", pods=110,
                                         scalars=dict(zip(names,
                                                          (2, 1, 8, 4, 8))))))
    for i in range(160):
        p = T.Pod(name=f"low{i}", requests=res("1", 1, i), priority=i % 4,
                  creation_index=i)
        p.node_name = f"n{i % 40}"
        s.on_pod_add(p)
    for i in range(12):
        s.on_pod_add(T.Pod(name=f"vip{i}", requests=res("2", 2, i),
                           priority=100, creation_index=1000 + i))
    waves = []
    for _ in range(4):
        st = s.schedule_pending()
        waves.append((st.attempted, st.scheduled, st.unschedulable))
        clock["t"] += 61.0
    return dict(waves=waves, bound=list(s.binder.bound),
                evicted=list(s.preemptor.evictor.evicted))


def test_cuda_preempt_storm_at_r16_matches_cpu(cuda, monkeypatch):
    """C1: a storm at R = 16 (five scalar resources) on the card — K3's
    wide variant in every burst — equals the same storm on the CPU, and K3
    equals its plain version on the first burst's inputs."""
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops import preempt as OP

    monkeypatch.setenv("KTPU_OVERLOAD", "0")
    cs = _chip_smoke()
    rec = cs.Recorder(OP, "reprieve_scan")
    K.reset_launch_counts()
    try:
        gpu = _scalar_storm("cuda")
    finally:
        rec.restore()
    assert K.launch_counts()["reprieve_scan"] > 0
    assert rec.args[2].shape[1] == 16       # req_e [E, R]
    assert K.k3_launch_config(rec.args[10].shape[0], 16).variant == "wide"
    assert gpu == _scalar_storm("cpu")
    assert gpu["evicted"]
    assert cs.k3_diff(K.reprieve_scan(*rec.args),
                      K.reprieve_scan_plain(*rec.args)) == 0


def _serving_drain(device, inline: bool):
    """A 200-node x 1,000-pod drain through Scheduler(device) in waves of
    256; `inline` runs each supervised dispatch on the calling thread
    instead of the supervisor's worker."""
    from kubernetes_tpu_torch.api.types import Pod, Resources

    s = ktt.Scheduler(binder=ktt.RecordingBinder(), device=device,
                      batch_size=256)
    if inline:
        s.supervisor.submit = lambda kind, key, fn, fb=None: type(
            "H", (), {"result": staticmethod(lambda r=fn(): r)})()
    for n in make_nodes(200, zones=4, racks_per_zone=5):
        s.on_node_add(n)
    for p in flagship_pods(1000, groups=24):
        s.on_pod_add(p)
    s.run_until_idle()
    return list(s.binder.bound)


def test_worker_thread_dispatch_matches_main_thread_on_the_card(cuda,
                                                                monkeypatch):
    """The supervised dispatch on its worker thread (the scheduler's device
    and dispatch stream) places exactly as the same waves dispatched on the
    main thread, and as the CPU run."""
    monkeypatch.setenv("KTPU_OVERLOAD", "0")
    worker = _serving_drain(cuda, inline=False)
    assert worker == _serving_drain(cuda, inline=True)
    assert worker == _serving_drain(torch.device("cpu"), inline=False)


def test_prewarm_on_a_side_stream_matches_the_main_thread(cuda):
    """The prewarmer's warm dispatch, from its thread on its own stream,
    gives the K1/K2 results of the same warm run on the main thread."""
    from kubernetes_tpu_torch.ops import waves as W
    from kubernetes_tpu_torch.sched.prewarm import BucketPrewarmer, warm_cycle
    from kubernetes_tpu_torch.state.dims import Dims

    calls = {"main": [], "warm": []}
    fn = {n: getattr(W, n) for n in ("contention_scan", "domain_rank")}

    def spy(name):
        def run(*a):
            out = fn[name](*a)
            side = "main" if torch.cuda.current_stream(cuda) == \
                torch.cuda.default_stream(cuda) else "warm"
            flat, todo = [], [out]
            while todo:
                t = todo.pop(0)
                if isinstance(t, torch.Tensor):
                    flat.append(t.cpu())
                elif isinstance(t, tuple):
                    todo.extend(t)
            calls[side].append((name, flat))
            return out
        return run

    d = Dims().grown_for(N=600, P=64, E=1200)
    try:
        for n in fn:
            setattr(W, n, spy(n))
        warm_cycle(d, cuda)
        p = BucketPrewarmer(device=cuda, min_axis=1)
        assert p.rewarm(d)
        p.wait(120)
    finally:
        for n, f in fn.items():
            setattr(W, n, f)
    assert p.lookup(d, "waves", (), False)
    assert calls["warm"] and len(calls["warm"]) == len(calls["main"])
    for (na, ta), (nb, tb) in zip(calls["main"], calls["warm"]):
        assert na == nb and all(torch.equal(x, y) for x, y in zip(ta, tb))


def test_extender_verbs_on_the_card_match_cpu(cuda, monkeypatch):
    """chip_smoke.py's phases 10b and 10c at 200 nodes after a 3,000-pod
    drain: ExtenderBackend(device="cuda") behind the ExtenderServer answers
    the port's HTTPExtender — Filter and Prioritize naming every node,
    ProcessPreemption, Bind — and the Scheduler's per-pod extender path
    places its pods exactly as the same script on the CPU."""
    monkeypatch.setenv("KTPU_OVERLOAD", "0")
    cs = _chip_smoke()
    runs = []
    for d in ("cuda", "cpu"):
        api = cs.port_serving_api(torch.device(d))
        bound = []
        cs.serving_drain(api, 200, 3000, batch_size=512, keep_bound=bound)
        runs.append(cs.extender_phase(api, bound, 200, 3000)[0])
    assert runs[0] == runs[1]
    assert runs[0]["filter"]["passing"] > 0 and runs[0]["sched"]["bound"] > 0


def test_framework_and_cosched_drains_on_the_card_match_cpu(cuda,
                                                             monkeypatch):
    """chip_smoke.py's phases 10a and 10d at a small size: the configured
    profile's drain (framework_drain) and the Coscheduling Permit path
    (cosched_drain) on the card equal the same scripts on the CPU."""
    monkeypatch.setenv("KTPU_OVERLOAD", "0")
    cs = _chip_smoke()
    runs = [(cs.framework_drain(api, 200, 3000),
             cs.cosched_drain(api, 300, 3000, batch_size=1024))
            for api in (cs.port_serving_api(torch.device(d))
                        for d in ("cuda", "cpu"))]
    assert runs[0] == runs[1]
    assert runs[0][1]["released"] > 0


def test_cuda_fleet_ticks_match_cpu_ticks(cuda):
    """A small mixed-engine fleet (waves, runs, scan; one tenant under a
    tight DRF quota) ticked to idle on the card and on the CPU: every
    tenant's bound (pod, node) list and every tick's clamp counts equal,
    K1/K2 launched on the card, and the scan tenant and the runs tenant's
    fallback (the flagship's spread pods) through K4, the plain scan never
    called there; the stack patched in place."""
    from kubernetes_tpu_torch.fleet import FleetServer
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.state.dims import Dims

    def run(device):
        clk = {"t": 0.0}
        srv = FleetServer(batch_size=64, base_dims=Dims(N=64, P=64, E=256),
                          clock=lambda: clk["t"], device=device,
                          engines={"t00": "waves", "t01": "runs",
                                   "t02": "scan", "t03": "waves"})
        binders, clamped = {}, []
        for k in range(4):
            name = f"t{k:02d}"
            binders[name] = ktt.RecordingBinder()
            t = srv.add_tenant(name, binder=binders[name],
                               quota=0.01 if k == 0 else 1.0)
            for n in make_nodes(48):
                t.on_node_add(n)
            for p in flagship_pods(150):
                t.on_pod_add(p)
        for _ in range(8):
            tk = srv.tick()
            clk["t"] += 1.0
            clamped.append({n: s.drf_clamped
                            for n, s in tk.per_tenant.items()})
            if tk.scheduled == 0:
                break
        assert srv.total_drf_violations == 0
        assert srv.total_cross_tenant == 0
        stacks = srv.stacks.values()
        assert sum(st.donation_failures for st in stacks) == 0
        if device != "cpu":
            assert sum(st.donated_patches for st in stacks) > 0
        return {n: b.bound for n, b in binders.items()}, clamped

    from kubernetes_tpu_torch.ops import assign as A

    K.reset_launch_counts()
    A.assign_scan_plain.calls = 0
    got = run(cuda)
    counts = K.launch_counts()
    assert A.assign_scan_plain.calls == 0
    assert got == run("cpu")
    assert counts.get("contention_scan", 0) and counts.get("domain_rank", 0)
    assert counts.get("assign_scan", 0) > 1
    assert sum(got[1][0].values()) > 0


def test_cuda_fleet_grid_tick_matches_cpu_tick(cuda):
    """A small mixed-engine fleet on the (4, 2) grid over [cuda:0] * 8
    against the same fleet meshless on the CPU: every tenant's bound list
    and every tick's clamp counts equal, K1, K2 and K4 launched inside the
    grid's threads, the grid's rows taking collectives."""
    from kubernetes_tpu_torch.fleet import FleetServer
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import axis
    from kubernetes_tpu_torch.parallel.mesh import fleet_mesh_shape
    from kubernetes_tpu_torch.state.dims import Dims

    def run(device, **kw):
        clk = {"t": 0.0}
        srv = FleetServer(batch_size=64, base_dims=Dims(N=64, P=64, E=256),
                          clock=lambda: clk["t"], device=device,
                          engines={"t00": "waves", "t01": "runs",
                                   "t02": "scan", "t03": "waves"}, **kw)
        binders, clamped = {}, []
        for k in range(4):
            name = f"t{k:02d}"
            binders[name] = ktt.RecordingBinder()
            t = srv.add_tenant(name, binder=binders[name],
                               quota=0.01 if k == 0 else 1.0)
            for n in make_nodes(48):
                t.on_node_add(n)
            for p in flagship_pods(150):
                t.on_pod_add(p)
        for _ in range(8):
            tk = srv.tick()
            clk["t"] += 1.0
            clamped.append({n: s.drf_clamped
                            for n, s in tk.per_tenant.items()})
            if tk.scheduled == 0:
                break
        assert srv.total_drf_violations == 0
        assert srv.total_cross_tenant == 0
        return srv, ({n: b.bound for n, b in binders.items()}, clamped)

    K.reset_launch_counts()
    srv, got = run(cuda, mesh=8, node_shards=2, mesh_devices=[cuda] * 8)
    counts = K.launch_counts()
    assert fleet_mesh_shape(srv.mesh) == (4, 2)
    assert srv.max_dispatches_per_tick == 3
    assert axis.LAST_RUN["grid"] == [4, 2] and axis.LAST_RUN["all_reduce"]
    _, want = run("cpu")
    assert got == want
    assert counts.get("contention_scan", 0) and counts.get("domain_rank", 0)
    assert counts.get("assign_scan", 0) > 1


def test_assign_scan_matches_plain_version_exactly(cuda):
    """K4 on chip_smoke.py's phase-2 cases (ties, a pod that fits nowhere,
    one pinned to a missing node, invalid rows, each Filter flag off, R =
    16, N = 1, 1,023, 1,025, 5,120 and 29,000 on the hostname key, no
    terms) against its plain version, through the wrapper (the cluster
    size it picks) and on one CTA: every node and all nine planes, WSYM
    bitwise, the initial state untouched."""
    cs = _chip_smoke()
    assert cs.check_k4(cuda, cs.k4_edge_cases(cuda, seed=1),
                       clusters=(1,)) == 0


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_assign_scan_at_every_cluster_size(cuda, cluster):
    """K4 at an explicit cluster size on the phase-2 cases — N below the
    cluster size (N = 1), N not a multiple of the CTA's threads (60, 1,023,
    1,025, 29,000) — against its plain version: every node, all nine
    planes, WSYM bitwise, the initial state untouched."""
    cs = _chip_smoke()
    assert cs.check_k4(cuda, cs.k4_edge_cases(cuda, seed=2),
                       clusters=(cluster,)) == 0


def test_assign_scan_from_several_threads_at_different_shapes(cuda):
    """K4 launched from several threads at once, each on a phase-2 case of
    its own launch shape (its own cluster and shared-memory size), as the
    dispatch worker, the bucket prewarmer and the fleet's dispatch may:
    every launch goes through and equals its plain version."""
    import threading

    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops.assign import assign_scan_plain

    cs = _chip_smoke()
    by_shape = {}
    for name, args in cs.k4_edge_cases(cuda, seed=3):
        by_shape.setdefault(cs.k4_config(args).smem_bytes, (name, args))
    cases = list(by_shape.values())
    assert len(cases) >= 2
    wants = [assign_scan_plain(*args) for _, args in cases]
    errors = []

    def run(i):
        name, args = cases[i]
        try:
            for _ in range(20):
                got = K.assign_scan(*args)
                torch.cuda.synchronize(cuda)
                if cs.k4_diff(got, wants[i]):
                    errors.append(f"{name}: differs from the plain version")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"{name}: {e!r}")

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors


def test_assign_scan_refuses_the_even_spread_case_at_cluster_16(cuda):
    """k4_even_bound_case at 16 CTAs: each CTA's share of the eligible
    total stays under 2^24 (tests/test_torch_scan.py), only the cluster's
    total passes it, and the launch still raises on the even-spread bit."""
    cs = _chip_smoke()
    with pytest.raises(ValueError, match="even-spread total"):
        cs.k4_at(cs.k4_even_bound_case(cuda), 16)


def test_assign_scan_refuses_an_even_spread_total_past_2_24(cuda):
    """chip_smoke.py's k4_even_bound_case: every node's own even-spread
    count far below 2^24, the eligible nodes' total past it (the plain
    version's f32 sum would round). K4 sums the total over the whole block
    and the wrapper raises, naming the even-spread bit."""
    from kubernetes_tpu_torch.ops import kernels as K

    cs = _chip_smoke()
    with pytest.raises(ValueError, match="even-spread total"):
        K.assign_scan(*cs.k4_even_bound_case(cuda))


def test_node_name_route_on_the_card_matches_cpu(cuda):
    """Phase 13a's shape at 200 nodes: flagship pods with every hundredth
    pinned by spec.nodeName take the scan; on the card that is one K4
    launch and no plain scan, and the placements and planes equal the
    CPU's."""
    from kubernetes_tpu_torch.models import workloads
    from kubernetes_tpu_torch.ops import assign as A
    from kubernetes_tpu_torch.ops import kernels as K

    cs = _chip_smoke()
    nodes, pods = cs.pinned_flagship(workloads, 200, 1500)
    gpu = ktt.BatchScheduler(device="cuda")
    cpu = ktt.BatchScheduler(device="cpu")
    K.reset_launch_counts()
    A.assign_scan_plain.calls = 0
    got = gpu.schedule(nodes, [], pods)
    assert K.launch_counts()["assign_scan"] == 1
    assert A.assign_scan_plain.calls == 0
    assert got.assignments == cpu.schedule(nodes, [], pods).assignments
    for f in ("used", "ppa", "ppw", "ppt", "CNT", "HOLD", "vol_any", "vol_rw",
              "WSYM"):
        assert torch.equal(getattr(gpu.last_result.state, f).cpu(),
                           getattr(cpu.last_result.state, f)), f
