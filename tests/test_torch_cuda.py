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
