"""chip_smoke.py's phase 15 at a small size on both packages: the kubemark
rollout (kubemark_drive) — an in-process apiserver, a HollowCluster of 8
hollow nodes, each in a zone of its own, a ControllerManager with the deployment,
replicaset, daemonset and nodelifecycle controllers, a Deployment of 24
replicas spread with maxSkew 1 over the zones and a DaemonSet, then a
SchedulerServer (the port's on the CPU) draining them behind the wave
barrier until every pod is Running and Ready.

The drive itself checks the phase's gates on each package (the workloads'
statuses, each daemon pod on its target node and one a node, the spread,
no overcommit, no unhealthy taint, no wave and no thread raised); here the
two packages' bound maps and per-wave counts are held equal, as phase 15
holds the card's run to JAX_KUBEMARK. All host code: equality is exact.
"""

import importlib.util
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
    import os

    import torch

    cs = _load("chip_smoke", "chip_smoke.py")
    ref = _load("flagship_reference", "scripts/flagship_reference.py")
    saved = os.environ.get("KTPU_OVERLOAD")
    os.environ["KTPU_OVERLOAD"] = "0"
    try:
        out = {name: cs.kubemark_drive(api, NODES, REPLICAS)
               for name, api in (("jax", ref.jax_server_api()),
                                 ("port", cs.port_server_api(
                                     torch.device("cpu"))))}
    finally:
        if saved is None:
            os.environ.pop("KTPU_OVERLOAD", None)
        else:
            os.environ["KTPU_OVERLOAD"] = saved
    return cs, out


def test_bound_maps_and_waves_equal(runs):
    cs, out = runs
    assert cs.kubemark_reference(out["port"]) == \
        cs.kubemark_reference(out["jax"])
    assert out["port"]["bound"] == NODES + REPLICAS


@pytest.mark.parametrize("key", ["statuses", "zone_counts",
                                 "max_node_pods", "sync_errors"])
def test_rollout_outcome_equal(runs, key):
    """The workloads' statuses, the Deployment's pods per zone, the fullest
    node and the controllers' sync errors (none) agree."""
    _cs, out = runs
    assert out["port"][key] == out["jax"][key]


def test_rollout_complete(runs):
    _cs, out = runs
    assert out["port"]["statuses"] == (REPLICAS, REPLICAS, NODES, NODES)
    assert set(out["port"]["sync_errors"].values()) == {0}
    zones = out["port"]["zone_counts"]
    assert len(zones) == NODES and max(zones.values()) - \
        min(zones.values()) <= 1
