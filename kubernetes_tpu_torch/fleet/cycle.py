"""The fleet tick's device work: K tenant cycles under one DRF clamp (port of
the JAX package's fleet/cycle.py).

The JAX package vmaps the single-cluster cycle body over the tenant axis and
runs the whole group as one XLA program. Here the clamp (fleet/quota.py) is
computed once for the whole stack, then the body — build_cycle →
initial_state → the engine ('waves', 'scan' or 'runs') → the class-granular
attribution when asked — runs per tenant, in turn, on views `block[k]` of
the resident stack at the fleet bucket. Tenants are independent: nothing
crosses the tenant axis but the clamp's shared arithmetic, so each tenant's
placements equal its solo run under the same clamp.

A vmap over tenants is not possible with the port's wave engine, which reads
back to the host after every wave to decide whether another is needed (one
device loop running until every tenant is done would be a redesign of the
engine, ROADMAP B12b). So one fleet dispatch here is one call that runs the
group's K tenant cycles on one stream.

On a fleet mesh (parallel/mesh.py `ShardedFleet`) the same call runs every
tenant row, the rows in turn (parallel/axis.py spmd_grid): position (r, s)
walks row r's tenants in order on its own device, under its row's node
axis — no collective on the 1-D tenant mesh; on the grid the
single-cluster sharded cycle (sched/cycle.py) over the row's kn devices
(K1 per shard, K2 and the runs engine's epochs on the row lead, K4
replicated on the row lead). The clamp runs per row: its column sums
are f32 sums of KiB far above 2^24, not exact in any grouping, so the row
gathers its tenants' valid/alloc/used planes [Kr, N, …] to its lead and
computes the clamp there in the one-device order (`row_clamp`); the
admission mask comes back to every shard. The outputs are gathered to the
mesh's lead device as [K, …] in tenant order.

'runs' takes the shared run capacity `rc` (the max of the tenants' RunPlans;
masking merges or shrinks runs, never splits them, so a shared upper bound
is sound for every tenant). Gang-bearing and nodeName-bearing tenant batches
never come here: the server routes those tenants through their own
single-cluster wave.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from ..ops.assign import assign_batch, explain_assignments, initial_state
from ..ops.runs import assign_runs
from ..ops.waves import assign_waves
from ..parallel import axis
from ..parallel.axis import Shard
from ..parallel.mesh import ShardedFleet, gather_full
from ..sched.cycle import _cycle
from .quota import drf_admission_planes, drf_admission_rows
from .tables import tenant_view

Array = torch.Tensor


class FleetResult(NamedTuple):
    """One fleet dispatch's outputs, all [K, …]."""

    node: Array      # [K, P] i32 chosen node row per tenant, -1 none
    feasible: Array  # [K, P] bool
    admitted: Array  # [K, P] bool — the DRF pre-mask (valid ∧ under-quota);
                     # valid ∧ ¬admitted pods were quota-clamped this tick
                     # (requeue promptly, no failure verdict)
    share: Array     # [K] f32 pre-tick dominant share per tenant
    dom: Array       # [K, P] f32 per-pod dominant demand (violation check)


def fleet_signature(K: int) -> int:
    """The tenant-stack signature in every prewarm key (sched/prewarm.py
    `fleet=` slot): the padded stack width. Its presence alone keeps fleet
    entries apart from single-cluster ones."""
    return int(K)


def dispatch_fleet(tables, pending, keys_host: Sequence[Tuple[int, int]],
                   D: int, existing, engine: str, quota,
                   hard_weight: float = 1.0, ecfg=None, rc: int = 0,
                   explain: bool = False):
    """One fleet dispatch, which in the port is one call running the
    group's K tenant cycles: the DRF clamp over the stacked [K, …] tables
    and pending pods, then each tenant's cycle on its view of the stack.
    `keys_host` holds each tenant's interned taint-key pair as host ints.
    On a fleet mesh `tables` is the ShardedFleet (which holds the pending
    and existing pods too: `pending` and `existing` are None), and each
    tenant row takes its slice of `quota` onto its lead device. Returns a
    FleetResult, or (FleetResult, [K] ExplainResult) with `explain`."""
    if isinstance(tables, ShardedFleet):
        return _dispatch_sharded(tables, keys_host, D, engine, quota,
                                 hard_weight, ecfg, rc, explain)
    admitted, share, dom = drf_admission_rows(tables, pending, quota)
    nodes, feas, exps = _tenant_cycles(tables, pending, existing, keys_host,
                                       admitted, D, engine, hard_weight,
                                       ecfg, rc, explain)
    out = FleetResult(node=torch.stack(nodes), feasible=torch.stack(feas),
                      admitted=admitted, share=share, dom=dom)
    return (out, exps) if explain else out


def _tenant_cycles(tables, pending, existing, keys_host, admitted, D,
                   engine, hard_weight, ecfg, rc, explain):
    """Each tenant's cycle of a stack, in turn, under the clamp's mask —
    under the calling thread's node axis (the whole node axis off a mesh,
    a shard of it on the grid). Returns the per-tenant (nodes, feasible,
    attributions); on the grid every shard gets the same nodes, and the
    attributions are the lead's (None elsewhere)."""
    nodes: List[Array] = []
    feas: List[Array] = []
    exps: List[object] = []
    for k in range(admitted.shape[0]):
        t = tenant_view(tables, k)
        ex = tenant_view(existing, k)
        pe = tenant_view(pending, k)._replace(valid=admitted[k])
        cyc = _cycle(t, ex, keys_host[k], D, hard_weight, ecfg)
        init = initial_state(t, cyc)
        if engine == "scan":
            res = assign_batch(t, cyc, pe, init)
        elif engine == "runs":
            res = assign_runs(t, cyc, pe, init, rc)
        else:
            res = assign_waves(t, cyc, pe, init)
        nodes.append(res.node)
        feas.append(res.feasible)
        if explain:
            # per-tenant attribution in the same dispatch; quota-clamped
            # pods carry valid=False and zero out
            exps.append(_explain(t, cyc, pe, res))
    return nodes, feas, exps


def _explain(t, cyc, pe, res):
    ax = axis.current()
    if not ax.sharded:
        return explain_assignments(t, cyc, pe, res, granularity="class")
    # the attribution ranks every node of a row: on the lead device, over
    # the gathered tables, lattice and state (sched/cycle.py's rule)
    ft, fc, fs = gather_full(t, cyc, res.state)
    return ax.lead(lambda: explain_assignments(
        ft, fc, pe, res._replace(state=fs), granularity="class"))


def row_clamp(tables, pending, quota: Array) -> Tuple[Array, Array, Array]:
    """The DRF clamp of one tenant row's stack [Kr, …] on the calling
    thread's node axis: each tenant's valid/alloc/used planes gathered over
    the row's shards on its lead device, the clamp computed there exactly
    as on one device, and (admitted, share, dom) handed to every shard. Off
    a mesh, and on a 1-D tenant mesh's row, the planes are already whole."""
    nodes = tables.nodes

    def clamp(valid, alloc, used):
        return drf_admission_planes(valid, alloc, used, tables.classes.rid,
                                    tables.reqs.vec, pending, quota)

    return axis.current().lead(clamp, Shard(nodes.valid, 1),
                               Shard(nodes.alloc, 1), Shard(nodes.used, 1))


def _dispatch_sharded(sf: ShardedFleet, keys_host, D, engine, quota,
                      hard_weight, ecfg, rc, explain):
    """dispatch_fleet on a fleet mesh: row r's positions walk tenants
    [r·Kr, (r+1)·Kr) in order; the row leads' outputs gathered to the
    mesh's lead device."""
    kr = sf.k_row

    def position(r: int, s: int, cell):
        tables, pending, existing = cell
        dev = tables.nodes.valid.device
        admitted, share, dom = row_clamp(
            tables, pending, quota[r * kr:(r + 1) * kr].to(dev))
        nodes, feas, exps = _tenant_cycles(
            tables, pending, existing, keys_host[r * kr:(r + 1) * kr],
            admitted, D, engine, hard_weight, ecfg, rc, explain)
        if s:
            return None
        return (torch.stack(nodes), torch.stack(feas), admitted, share,
                dom, exps)

    leads = [row[0] for row in sf.run(position)]
    lead = sf.mesh.lead
    out = FleetResult(*(torch.cat([row[i].to(lead) for row in leads])
                        for i in range(5)))
    if not explain:
        return out
    return out, [e for row in leads for e in row[5]]
