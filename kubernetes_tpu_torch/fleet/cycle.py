"""The fleet tick's device work: K tenant cycles under one DRF clamp (port of
the JAX package's fleet/cycle.py, single device).

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
from ..sched.cycle import _cycle
from .quota import drf_admission_rows
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
                   D: int, existing, engine: str, quota: Array,
                   hard_weight: float = 1.0, ecfg=None, rc: int = 0,
                   explain: bool = False):
    """One fleet dispatch, which in the port is one call running the
    group's K tenant cycles on one stream (the current one): the DRF clamp
    over the stacked [K, …] tables and pending pods, then each tenant's
    cycle on its view of the stack. `keys_host` holds each tenant's
    interned taint-key pair as host ints. Returns a FleetResult, or
    (FleetResult, [K] ExplainResult) with `explain`."""
    admitted, share, dom = drf_admission_rows(tables, pending, quota)
    K = admitted.shape[0]
    nodes: List[Array] = []
    feas: List[Array] = []
    exps: List[object] = []
    for k in range(K):
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
            exps.append(explain_assignments(t, cyc, pe, res,
                                            granularity="class"))
    out = FleetResult(node=torch.stack(nodes), feasible=torch.stack(feas),
                      admitted=admitted, share=share, dom=dom)
    return (out, exps) if explain else out
