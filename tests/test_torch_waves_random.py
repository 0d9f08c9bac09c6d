"""Port parity of the engines on tests/test_waves.py's randomized clusters
(affinity, anti-affinity, spread, taints, ports, volumes): kubernetes_tpu_torch's
assign_waves and assign_batch equal the JAX package's (node, wave_out, final
AssignState), and the port's wave output replays through the pure-Python
oracle as a valid greedy execution of the reference's per-pod loop.
"""

import dataclasses
import random

import pytest

from test_golden import oracle_fits, rand_node, rand_pod
from test_torch_waves import _check


@pytest.mark.parametrize("seed", range(8))
def test_random_clusters_match_jax_and_replay(seed):
    """tests/test_waves.py's randomized clusters (affinity, anti-affinity,
    spread, taints, ports, volumes): both engines equal to JAX, and the
    port's wave output is a valid greedy execution under the oracle."""
    rng = random.Random(1000 + seed)
    nodes = [rand_node(rng, i) for i in range(rng.randint(4, 8))]
    existing = [rand_pod(rng, 100 + i, bound_to=rng.choice(nodes).name)
                for i in range(rng.randint(0, 6))]
    pending = [rand_pod(rng, i) for i in range(rng.randint(8, 16))]
    _check("scan", nodes, existing, pending)
    node, waves = _check("waves", nodes, existing, pending)

    placed = sorted((int(waves[i]), -pending[i].priority,
                     pending[i].creation_index, i)
                    for i in range(len(pending)) if node[i] >= 0)
    world = list(existing)
    for _, _, _, i in placed:
        target = nodes[int(node[i])]
        assert oracle_fits(pending[i], target, nodes, world), (
            f"seed={seed}: {pending[i].name} on {target.name} violates the "
            f"oracle at replay time")
        world.append(dataclasses.replace(pending[i], node_name=target.name))
