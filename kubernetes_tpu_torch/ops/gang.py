"""Gang/co-scheduling: all-or-nothing pod groups on the wave engine (port of
the JAX package's ops/gang.py, whose docstring sets out the semantics: a
group either gets ≥ `needed` members placed or none, rejected groups'
pods are masked out and the wave fixpoint restarts from the cycle's initial
state, lowest-ranked groups are rejected first).

The JAX package has two routes with one rejection policy: a lax.while_loop
around the wave fixpoint (one dispatch) and, above 65,536 pending pods, a
host loop of one dispatch per round (its sched/cycle.py
_schedule_gang_host_rounds). The port has one route: a host loop of
rounds, each a call of the wave engine (or of `engine_fn`) on the batch
with the rejected groups' pods masked out, reading back the per-group fill
counts the policy needs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..state.arrays import Array, ClusterTables, GangArrays, PodArrays
from .assign import AssignResult, AssignState
from .lattice import CycleArrays
from .waves import assign_waves


def _placed_per_group(gang: GangArrays, pods: PodArrays,
                      feasible: Array) -> Array:
    GR = gang.needed.shape[0]
    g_safe = torch.where(gang.group >= 0, gang.group, GR).long()
    hit = (feasible & pods.valid).to(torch.int32)
    return torch.zeros((GR + 1,), dtype=torch.int32,
                       device=hit.device).index_add_(0, g_safe, hit)[:GR]


def assign_gang(
    tables: ClusterTables,
    cyc: CycleArrays,
    pods: PodArrays,
    init: AssignState,
    gang: GangArrays,
    max_waves: int | None = None,
    soft_rounds: int = 4,
    engine_fn=None,
    return_waves: bool = False,
):
    """Wave assignment with group-atomic admission. Returns the result plus
    the [GR] dead-group mask (and the wave index per pod with
    `return_waves`). Pods of dead groups come back node=-1/infeasible.

    The rejection policy, round by round: the first round rejects nothing;
    then zero-placed underfilled groups are rejected all at once (they hold
    no capacity), partially filled ones one per round — the highest `rank`,
    the first index on ties — until `soft_rounds` rounds have run, then all
    together; at most GR + 2 rounds. `engine_fn(tables, cyc, pods, init)`
    replaces the wave engine (the sequential scan for a nodeName batch)."""
    GR = gang.needed.shape[0]
    P = pods.valid.shape[0]
    dev = pods.valid.device
    g_clip = gang.group.clamp(0, GR - 1).long()
    rank = gang.rank.cpu().numpy()

    def run(rejected: Array):
        ok = (gang.group < 0) | ~rejected[g_clip]
        masked = pods._replace(valid=pods.valid & ok)
        if engine_fn is not None:
            res = engine_fn(tables, cyc, masked, init)
            waves = torch.full((P,), -1, dtype=torch.int32, device=dev)
        else:
            res, waves = assign_waves(tables, cyc, masked, init, max_waves,
                                      return_waves=True)
        placed = _placed_per_group(gang, masked, res.feasible)
        under = gang.valid & ~rejected & (placed < gang.needed)
        return res, waves, under, placed

    rejected = np.zeros((GR,), bool)
    rounds = 0
    while True:
        res, waves, under_d, placed_d = run(torch.from_numpy(rejected).to(dev))
        under = under_d.cpu().numpy()
        placed = placed_d.cpu().numpy()
        rounds += 1
        if not under.any() or rounds >= GR + 2:
            break
        zero = under & (placed == 0)
        partial = under & (placed > 0)
        newly = zero.copy()
        if rounds > soft_rounds:
            newly |= partial
        elif partial.any():
            newly[int(np.argmax(np.where(partial, rank, -1)))] = True
        rejected |= newly

    dead = torch.from_numpy(rejected | under).to(dev)
    ok = (gang.group < 0) | ~dead[g_clip]
    result = AssignResult(node=torch.where(ok, res.node, -1),
                          feasible=res.feasible & ok, state=res.state)
    if return_waves:
        return result, dead, waves
    return result, dead
