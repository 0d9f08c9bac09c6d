"""Taints/tolerations as tensor ops (port of the JAX package's ops/taints.py).

Reference semantics: PodToleratesNodeTaints (predicates.go:1543-1549) filters on
NoSchedule + NoExecute taints; PreferNoSchedule feeds the taint_toleration.go
score. node.spec.unschedulable acts as a synthetic NoSchedule taint with a
well-known key (CheckNodeUnschedulablePredicate, predicates.go:1522-1541).
"""

from __future__ import annotations

import torch

from ..api.types import TaintEffect, TolerationOp
from ..state.arrays import Array, NodeArrays, TolSetTable


def _tolerates(tol_valid, tol_keys, tol_ops, tol_vals, tol_effects,
               taint_key, taint_val, taint_effect) -> Array:
    """[...] bool: any toleration in the set ([..., TL]) tolerates the taint."""
    tk, tv, te = taint_key[..., None], taint_val[..., None], taint_effect[..., None]
    eff_ok = (tol_effects < 0) | (tol_effects == te)
    key_ok = (tol_keys < 0) | (tol_keys == tk)
    val_ok = (tol_ops == int(TolerationOp.EXISTS)) | (tol_vals == tv)
    return (tol_valid & eff_ok & key_ok & val_ok).any(-1)


def taint_matrices(
    tolsets: TolSetTable, nodes: NodeArrays, unschedulable_key: int, empty_val: int
) -> tuple[Array, Array, Array]:
    """Returns:
      ok        [STL, N] bool — all NoSchedule/NoExecute taints tolerated
      prefer    [STL, N] i32  — count of intolerable PreferNoSchedule taints
      unsched_ok[STL]    bool — tolerates the synthetic unschedulable taint
    """
    tol = lambda a: a[:, None, None, :]  # [STL, 1, 1, TL] vs taints [1, N, TT]
    per_taint = _tolerates(
        tol(tolsets.valid), tol(tolsets.keys), tol(tolsets.ops),
        tol(tolsets.vals), tol(tolsets.effects),
        nodes.taint_keys[None], nodes.taint_vals[None], nodes.taint_effects[None],
    )  # [STL, N, TT]
    eff = nodes.taint_effects[None]
    present = nodes.taint_keys[None] >= 0
    filtering = present & ((eff == int(TaintEffect.NO_SCHEDULE))
                           | (eff == int(TaintEffect.NO_EXECUTE)))
    ok = (~filtering | per_taint).all(-1)
    prefer = (present & (eff == int(TaintEffect.PREFER_NO_SCHEDULE))
              & ~per_taint).sum(-1, dtype=torch.int32)

    STL = tolsets.valid.shape[0]
    full = lambda v: torch.full((STL,), int(v), dtype=torch.int32,
                                device=tolsets.valid.device)
    unsched_ok = _tolerates(
        tolsets.valid, tolsets.keys, tolsets.ops, tolsets.vals, tolsets.effects,
        full(unschedulable_key), full(empty_val), full(TaintEffect.NO_SCHEDULE),
    )  # [STL]
    return ok, prefer, unsched_ok


def taint_toleration_score(prefer_counts: Array) -> Array:
    """[..., N] i32 counts → 0..100 score per row, reversed max-normalization
    (taint_toleration.go via NormalizeReduce(MaxNodeScore, reverse=true))."""
    c = prefer_counts.float()
    mx = c.amax(-1, keepdim=True)
    return torch.where(mx > 0, 100.0 * (1.0 - c / torch.clamp(mx, min=1.0)),
                       100.0)
