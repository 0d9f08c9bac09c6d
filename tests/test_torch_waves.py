"""Port parity of the engines: kubernetes_tpu_torch's assign_waves (the
default engine, both CUDA kernels' plain versions inside) and assign_batch
(the sequential spec) against the JAX package's, on the workloads of
tests/test_waves.py: exact `node`, exact `wave_out`, and the final
AssignState (integer planes exact, WSYM within F32_ATOL). The randomized
clusters of tests/test_waves.py live in tests/test_torch_waves_random.py.
"""

import random

import jax
import numpy as np
import pytest

from kubernetes_tpu.api.types import Node, Pod, Resources
from kubernetes_tpu.models.workloads import flagship_pods, make_nodes
from kubernetes_tpu_torch.ops import assign as tassign
from kubernetes_tpu_torch.ops import waves as twaves
from kubernetes_tpu_torch.ops.assign import assign_batch, initial_state
from kubernetes_tpu_torch.ops.lattice import build_cycle

from test_golden import rand_node, rand_pod
from test_waves import _run
from torch_parity import assert_same, encode


def _port(engine, enc):
    tables, ex, pe = enc["torch"]
    uk, ev = enc["keys"]
    cyc = build_cycle(tables, ex, uk, ev, enc["dims"].D)
    init = initial_state(tables, cyc)
    if engine == "scan":
        return assign_batch(tables, cyc, pe, init), None
    return twaves.assign_waves(tables, cyc, pe, init, return_waves=True)


def _check(engine, nodes, existing, pending):
    """Run both packages on one encoding; assert equal results; return the
    port's (node, waves) for further checks."""
    enc = encode(nodes, existing, pending)
    tables, ex, pe = enc["jax"]
    uk, ev = enc["keys"]
    ref, ref_waves = _run(engine, tables, ex, pe, jax.numpy.int32(uk),
                          jax.numpy.int32(ev), enc["dims"].D)
    got, got_waves = _port(engine, enc)
    assert_same(ref.node, got.node, f"{engine}.node")
    assert_same(ref.feasible, got.feasible, f"{engine}.feasible")
    assert_same(ref.state, got.state, f"{engine}.state")
    if engine == "waves":
        assert_same(ref_waves, got_waves, "waves.wave_out")
    return got.node.numpy(), (None if got_waves is None
                              else got_waves.numpy())


def _homogeneous():
    nodes = [Node(name=f"n{i}",
                  allocatable=Resources.make(cpu="4", memory="8Gi", pods=110))
             for i in range(8)]
    pods = [Pod(name=f"p{i}", requests=Resources.make(cpu="500m",
                                                      memory="512Mi"),
                creation_index=i) for i in range(24)]
    return nodes, [], pods


def _singleton_high_class_index():
    nodes = [Node(name=f"n{i}",
                  allocatable=Resources.make(cpu="8", memory="16Gi", pods=110))
             for i in range(8)]
    existing = [
        Pod(name="e0", requests=Resources.make(cpu="1", memory="1Gi"),
            node_name="n5", creation_index=0),
        Pod(name="e1", requests=Resources.make(cpu="2", memory="2Gi"),
            node_name="n6", creation_index=1),
    ]
    pending = [Pod(name="p", labels={"fresh": "yes"},
                   requests=Resources.make(cpu="500m", memory="512Mi"),
                   creation_index=10)]
    return nodes, existing, pending


def _priority_tiers():
    nodes = [Node(name="n0",
                  allocatable=Resources.make(cpu="1", memory="1Gi", pods=10))]
    return nodes, [], [
        Pod(name="low", requests=Resources.make(cpu="1", memory="1Gi"),
            priority=0, creation_index=0),
        Pod(name="high", requests=Resources.make(cpu="1", memory="1Gi"),
            priority=10, creation_index=1)]


def _extreme_negative_priorities():
    nodes = [Node(name=f"n{i}",
                  allocatable=Resources.make(cpu="4", memory="8Gi", pods=10))
             for i in range(2)]
    return nodes, [], [
        Pod(name=f"p{i}", requests=Resources.make(cpu="100m", memory="64Mi"),
            priority=-(2**31) + i, creation_index=i) for i in range(3)]


FIXED = {
    "homogeneous": _homogeneous,
    "singleton_high_class_index": _singleton_high_class_index,
    "priority_tiers": _priority_tiers,
    "extreme_negative_priorities": _extreme_negative_priorities,
}


@pytest.mark.parametrize("engine", ["waves", "scan"])
@pytest.mark.parametrize("name", sorted(FIXED))
def test_fixed_workloads_match_jax(name, engine):
    node, waves = _check(engine, *FIXED[name]())
    if name == "priority_tiers":
        assert node[1] == 0 and node[0] == -1
    if name == "extreme_negative_priorities":
        assert (node[:3] >= 0).all()
        if engine == "waves":
            assert int(waves.max()) < 6


@pytest.mark.parametrize("seed", range(2))
def test_singletons_match_jax(seed):
    rng = random.Random(2000 + seed)
    nodes = [rand_node(rng, i) for i in range(5)]
    existing = [rand_pod(rng, 100 + i, bound_to=rng.choice(nodes).name)
                for i in range(3)]
    for j in range(6):
        pod = rand_pod(rng, j)
        w, _ = _check("waves", nodes, existing, [pod])
        s, _ = _check("scan", nodes, existing, [pod])
        assert w[0] == s[0]


def test_flagship_64x512_matches_jax():
    """The fixed CPU shape of tests/test_waves.py's engine-speed guard."""
    nodes = make_nodes(64, zones=4, racks_per_zone=4)
    node, _ = _check("waves", nodes, [], flagship_pods(512, groups=12))
    assert (node >= 0).sum() > 300


def test_class_axis_tiling_bit_identical(monkeypatch):
    """~40 distinct classes: the port's class-block tiling of the dense
    evaluation gives the same placements at any block size, equal to JAX."""
    rng = random.Random(42)
    nodes = [rand_node(rng, i) for i in range(8)]
    pending = []
    for i in range(40):
        p = rand_pod(rng, i)
        p.labels = {**p.labels, "uniq": f"u{i}"}
        pending.append(p)
    ref, _ = _check("waves", nodes, [], pending)
    monkeypatch.setattr(tassign, "ROW_BLOCK", 8)
    tiled, _ = _port("waves", encode(nodes, [], pending))
    np.testing.assert_array_equal(tiled.node.numpy(), ref)
