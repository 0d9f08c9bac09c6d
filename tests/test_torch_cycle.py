"""The port's BatchScheduler end to end against the JAX package's, on the CPU
(device="cpu"): exact assignments on the flagship workload, the nodeName
batch (sequential-scan route), the run-collapsed engine (KTPU_ASSIGN=runs, for a
gang batch too) against the JAX package's, the CUDA default refusing to run
without a GPU, and the port's import boundary: neither kubernetes_tpu_torch
nor its scripts (chip_smoke.py, scripts/torch_cycle_profile.py) import JAX
or the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import kubernetes_tpu as kt
import kubernetes_tpu_torch as ktt
from kubernetes_tpu.models.workloads import (flagship_pods,
                                             gang_workload_pods, make_nodes)

REPO = Path(__file__).resolve().parents[1]

# one intra-op thread, as in tests/torch_parity.py
torch.set_num_threads(1)


def _both(nodes, existing, pending):
    ref = kt.BatchScheduler().schedule(nodes, existing, pending)
    got = ktt.BatchScheduler(device="cpu").schedule(nodes, existing, pending)
    return ref, got


@pytest.mark.parametrize("n_nodes,n_pods,zones,racks,groups", [
    (64, 512, 4, 4, 12),
    (100, 1000, 4, 5, 24),
])
def test_flagship_assignments_match_jax(n_nodes, n_pods, zones, racks, groups):
    nodes = make_nodes(n_nodes, zones=zones, racks_per_zone=racks)
    pending = flagship_pods(n_pods, groups=groups)
    ref, got = _both(nodes, [], pending)
    assert got.assignments == ref.assignments
    assert (got.scheduled, got.failed) == (ref.scheduled, ref.failed)
    assert got.scheduled > n_pods // 4


def test_node_name_batch_takes_the_scan_route():
    """A pending pod with spec.nodeName reroutes the batch through the
    sequential scan in both packages; placements agree and the pinned pod
    lands on its node."""
    nodes = make_nodes(16, zones=4, racks_per_zone=2)
    existing = flagship_pods(12, groups=4)[:6]
    for i, p in enumerate(existing):
        p.node_name = nodes[i].name
    pending = flagship_pods(60, groups=6)
    pending[7].node_name = nodes[11].name
    ref, got = _both(nodes, existing, pending)
    assert got.assignments == ref.assignments
    assert got.assignments[7] == nodes[11].name


def test_scan_engine_env_matches_jax(monkeypatch):
    monkeypatch.setenv("KTPU_ASSIGN", "scan")
    nodes = make_nodes(16, zones=4, racks_per_zone=2)
    ref, got = _both(nodes, [], flagship_pods(48, groups=6))
    assert got.assignments == ref.assignments


def test_gang_batch_raises(monkeypatch):
    """A gang batch runs its rejection rounds on the engine KTPU_ASSIGN
    names; under the run-collapsed one (which raised before it was
    ported) the rounds give the JAX package's placements (the rounds on
    the wave engine: tests/test_torch_gang.py)."""
    monkeypatch.setenv("KTPU_ASSIGN", "runs")
    nodes = make_nodes(8, zones=2, racks_per_zone=2)
    ref, got = _both(nodes, [], gang_workload_pods(16))
    assert got.assignments == ref.assignments


def test_runs_engine_raises(monkeypatch):
    """KTPU_ASSIGN=runs (which raised before the run-collapsed engine was
    ported) gives the JAX package's placements."""
    monkeypatch.setenv("KTPU_ASSIGN", "runs")
    nodes = make_nodes(8, zones=2, racks_per_zone=2)
    ref, got = _both(nodes, [], flagship_pods(8, groups=2))
    assert got.assignments == ref.assignments


def test_default_device_is_cuda_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ktt.BatchScheduler()
    assert ktt.BatchScheduler(device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when no CUDA
    device is visible — from the checkout and from a directory holding only
    the script."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_and_its_scripts_import_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "kubernetes_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "scripts" / "torch_cycle_profile.py"]
    # scripts/flagship_reference.py imports the JAX package on purpose: it
    # records the reference result chip_smoke.py checks against
    assert len(files) > 10
    bad = [(f.relative_to(REPO), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu")]
    assert not bad, bad
