"""NodeResourcesFit and resource-based scores (port of the JAX package's
ops/fit.py).

PodFitsResources (predicates.go:789-845): the pod-count check always applies;
UNLESS the pod requests zero of everything, every resource must satisfy
request ≤ allocatable − used — except scalar resources, which are only checked
when requested. Scores (least/most requested, balanced allocation) are float32
on 0..100, computed op for op as in the JAX package so they round alike.
"""

from __future__ import annotations

import torch

from ..api.types import NUM_FIXED_RES, RES_PODS
from ..state.arrays import Array

MAX_NODE_SCORE = 100.0  # framework/v1alpha1/interface.go:87


def _fit(vec: Array, free: Array) -> Array:
    """vec: [..., R], free: [..., R] → [...] bool per PodFitsResources.
    cpu/mem/ephemeral are checked even at zero request (0 > negative free
    fails on an overcommitted node); zero scalar requests are ignored; the
    pods slot has its own rule. Oracle: api/semantics.py pod_fits_resources."""
    R = vec.shape[-1]
    idx = torch.arange(R, device=vec.device)
    is_pods = idx == RES_PODS
    is_scalar = idx >= NUM_FIXED_RES
    pods_ok = (torch.where(is_pods, vec, 0) <= torch.where(is_pods, free, 0)).all(-1)
    zero_all = torch.where(is_pods, 0, vec).amax(-1) == 0
    res_ok = (is_pods | (is_scalar & (vec == 0)) | (vec <= free)).all(-1)
    return pods_ok & (zero_all | res_ok)


def fit_row(req_vec: Array, used: Array, alloc: Array, valid: Array) -> Array:
    """[B, N] bool for request vectors [B, R] against live used [N, R]."""
    return _fit(req_vec[:, None, :], (alloc - used)[None]) & valid


def _frac(total: Array, cap: Array) -> Array:
    cap_f = cap.float()
    return torch.where(cap > 0, total.float() / torch.clamp(cap_f, min=1.0), 0.0)


def resource_scores(total: Array, alloc: Array
                    ) -> tuple[Array, Array, Array]:
    """(least_requested, balanced_allocation, most_requested), each f32 on
    0..100, for the requests `total` [..., R] a node would hold against
    its allocatable `alloc` [..., R] (least_requested.go:60-77,
    balanced_resource_allocation.go:68-102, most_requested.go:52-70)."""
    cpu_cap, mem_cap = alloc[..., 0], alloc[..., 1]
    cpu_t, mem_t = total[..., 0], total[..., 1]

    def least(t, cap):
        s = (cap.float() - t.float()) * MAX_NODE_SCORE
        s = s / torch.clamp(cap.float(), min=1.0)
        return torch.where((cap > 0) & (t <= cap), s, 0.0)

    def most(t, cap):
        s = t.float() * MAX_NODE_SCORE / torch.clamp(cap.float(), min=1.0)
        return torch.where((cap > 0) & (t <= cap), s, 0.0)

    least_score = (least(cpu_t, cpu_cap) + least(mem_t, mem_cap)) / 2.0
    most_score = (most(cpu_t, cpu_cap) + most(mem_t, mem_cap)) / 2.0

    cf, mf = _frac(cpu_t, cpu_cap), _frac(mem_t, mem_cap)
    balanced = torch.where(
        (cf >= 1.0) | (mf >= 1.0), 0.0,
        MAX_NODE_SCORE - torch.abs(cf - mf) * MAX_NODE_SCORE)
    return least_score, balanced, most_score


def resource_scores_row(
    req_vec: Array, used: Array, alloc: Array
) -> tuple[Array, Array, Array]:
    """resource_scores, each [B, N], for request vectors [B, R] against
    used/alloc [N, R]."""
    return resource_scores(used[None] + req_vec[:, None, :], alloc)
