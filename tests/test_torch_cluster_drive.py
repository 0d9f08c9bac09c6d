"""chip_smoke.py's phase 16 at a small size on both packages: the cluster
and the CLI (cluster_drive) — a Cluster of 8 hollow nodes with the
deployment, replicaset, endpoints and nodelifecycle controllers (the port's
scheduler on the CPU), kubectl apply of the Deployment web (24 replicas
spread with maxSkew 1 over the hostnames) and its Service as JSON
manifests, rollout status, the proxier's rule for the Service and its
/healthz, the metrics server and kubectl top, upgrade plan and apply,
join 2 nodes and kubectl scale to 30.

The drive itself checks the phase's gates on each package (every pod
Running and Ready, exactly 3 on each node before and after the scale, no
overcommit, the rule holding the pods' ip:port, the top rows, the
restarted scheduler binding the 6 new pods, no unhealthy taint, no thread
raised); here the two packages' timing-free results are held equal, as
phase 16 holds the card's run to JAX_CLUSTER, and the phase itself
(cluster_phase: the kernel checks on the recorded inputs, the settle) runs
on the CPU against the JAX package's run. All host code: equality is
exact.
"""

import importlib.util
import os
import tempfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
NODES, REPLICAS = 8, 24


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs():
    import torch

    cs = _load("chip_smoke", "chip_smoke.py")
    ref = _load("flagship_reference", "scripts/flagship_reference.py")
    saved = os.environ.get("KTPU_OVERLOAD")
    os.environ["KTPU_OVERLOAD"] = "0"
    try:
        out = {}
        for name, api in (("jax", ref.jax_server_api()),
                          ("port", cs.port_server_api(torch.device("cpu")))):
            with tempfile.TemporaryDirectory() as workdir:
                out[name] = cs.cluster_drive(api, workdir, NODES, REPLICAS)
    finally:
        if saved is None:
            os.environ.pop("KTPU_OVERLOAD", None)
        else:
            os.environ["KTPU_OVERLOAD"] = saved
    return cs, out


def test_cluster_reference_equal(runs):
    """Per-node counts after 16b and 16f, the joined nodes' pods, the
    rule's endpoint count, the top rows, the upgrade phases, what kubectl
    apply answered and the Deployment's status: equal on both packages."""
    cs, out = runs
    assert cs.cluster_reference(out["port"]) == \
        cs.cluster_reference(out["jax"])


def test_cluster_outcome(runs):
    _cs, out = runs
    port = out["port"]
    per = REPLICAS // NODES
    assert set(port["per_node_16b"].values()) == {per}
    assert len(port["per_node_16b"]) == NODES
    assert set(port["per_node_16f"].values()) == {per}
    assert port["joined"] == {f"joined-node-b0-{i}": per for i in range(2)}
    assert port["endpoints"] == REPLICAS
    assert port["top_rows"] == {"nodes": NODES, "pods": REPLICAS}
    assert port["restarted_scheduled"] == 2 * per
    assert port["restarted_device"] == "cpu"
    assert port["apply"] == ["deployment/web created", "service/web created"]
    assert set(port["sync_errors"].values()) == {0}


@pytest.mark.parametrize("key", ["upgrade_phases", "healthz", "version",
                                 "sync_errors", "restarted_scheduled"])
def test_drive_fields_equal(runs, key):
    """The fields the reference leaves out, timing-free too: the upgraded
    version is the one kubeadm-config records (v1.18.0) on both."""
    _cs, out = runs
    assert out["port"][key] == out["jax"][key]


def test_phase_16_on_the_cpu(runs, monkeypatch):
    """cluster_phase itself at this size, the port on the CPU against the
    JAX package's run: the drive, the gates against the reference, the
    first K1/K2 launch of the phase against the plain versions (on CPU
    tensors both are the plain version), the settle."""
    import torch

    cs, out = runs
    monkeypatch.setattr(cs, "CLUSTER_NODES", NODES)
    monkeypatch.setattr(cs, "CLUSTER_REPLICAS", REPLICAS)
    monkeypatch.setattr(cs, "JAX_CLUSTER", cs.cluster_reference(out["jax"]))
    monkeypatch.setenv("KTPU_OVERLOAD", "0")
    res = cs.cluster_phase(torch.device("cpu"), "cpu")
    assert res["out"]["per_node_16f"] == out["port"]["per_node_16f"]
    assert set(res["errs"]["16"]) <= {"contention_scan", "domain_rank"}
    assert not any(res["errs"]["16"].values())
