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
