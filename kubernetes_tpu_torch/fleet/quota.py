"""Dominant-resource-fairness quotas as tensor ops over the stacked batch
(port of the JAX package's fleet/quota.py).

A tenant's quota is a fraction of its own cluster's capacity, its *dominant
share* is the max over resource dims of used/capacity, and admission is
clamped so one tick can never push a tenant past its quota: a tenant at
quota contributes inert rows this tick, exactly as an invalid pod would.

The clamp is a pure pre-mask on `pending.valid`: downstream the engines see
a smaller valid set and nothing else, so a tenant's placements equal its
solo run under the same clamp. The per-pod shape is a prefix waterfill in
queue order (priority desc, creation asc — ops/assign.py queue_order): pod i
admits iff the tenant's pre-tick dominant share plus the cumulative dominant
demand of pods 0..i stays within quota + DRF_EPS.

`drf_admission_rows` runs once for the whole stack ([K, …] planes, one pass
for every tenant); on a fleet mesh once per tenant row, over the row's
node planes gathered on its lead device (fleet/cycle.py). The two float32
reductions reproduce the JAX package's compiled order on XLA's CPU backend
bit for bit, from elementwise float32 adds that round the same on the CPU
and the card:

  * the column sums over nodes (`capacity_usage_planes`) follow XLA's tree
    reduction rewrite: windows of 32 consecutive rows, the padding split
    evenly before and after, each window summed in row order, repeated on
    the window totals until 32 or fewer remain, then summed in order;
  * the prefix sum (`prefix_sum_f32`) follows XLA's cumsum: blocks of 16,
    a sequential prefix inside each block, the same scan recursively on the
    block totals, each block's exclusive prefix added to its elements.

Neither `torch.sum` nor `torch.cumsum` on floats is used: their orders are
their own (and differ between the CPU and CUDA).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.assign import queue_order
from ..state.arrays import ClusterTables, PodArrays

Array = torch.Tensor

# slack on the quota comparison: float32 shares accumulate over the prefix
# sum, and a tenant sitting EXACTLY at quota must not flap on the last ulp
# of a sum
DRF_EPS = 1e-6

_REDUCE_WINDOW = 32   # XLA CPU's tree-reduction window
_SCAN_BLOCK = 16      # XLA's cumsum block


def column_sum_f32(x: Array) -> Array:
    """Sum float32 `x` [..., N, R] over N in XLA's CPU order (module
    docstring): windows of 32 rows with the padding split evenly before and
    after, each summed in row order, until at most 32 rows remain."""
    while x.shape[-2] > _REDUCE_WINDOW:
        n = x.shape[-2]
        nb = -(-n // _REDUCE_WINDOW)
        pad = nb * _REDUCE_WINDOW - n
        lo = pad // 2
        w = F.pad(x, (0, 0, lo, pad - lo)).reshape(
            *x.shape[:-2], nb, _REDUCE_WINDOW, x.shape[-1])
        acc = w[..., 0, :]
        for j in range(1, _REDUCE_WINDOW):
            acc = acc + w[..., j, :]
        x = acc
    acc = torch.zeros_like(x[..., 0, :])
    for j in range(x.shape[-2]):
        acc = acc + x[..., j, :]
    return acc


def prefix_sum_f32(x: Array) -> Array:
    """Inclusive prefix sum of float32 `x` [..., P] along the last axis in
    XLA's cumsum order (module docstring): 16 elementwise column steps per
    level on a [..., ⌈P/16⌉, 16] view, then the same scan on the block
    totals."""
    P = x.shape[-1]
    nb = -(-P // _SCAN_BLOCK)
    blk = F.pad(x, (0, nb * _SCAN_BLOCK - P)).reshape(
        *x.shape[:-1], nb, _SCAN_BLOCK)
    cols = [blk[..., 0]]
    for j in range(1, _SCAN_BLOCK):
        cols.append(cols[-1] + blk[..., j])
    inc = torch.stack(cols, dim=-1)
    if nb > 1:
        # block 0 adds nothing; block b adds the inclusive prefix of the
        # totals of blocks 0..b-1
        carry = prefix_sum_f32(inc[..., :-1, -1])
        inc = torch.cat([inc[..., :1, :],
                         inc[..., 1:, :] + carry[..., None]], dim=-2)
    return inc.reshape(*x.shape[:-1], nb * _SCAN_BLOCK)[..., :P]


def capacity_usage_planes(tables: ClusterTables) -> Tuple[Array, Array]:
    """Per-resource totals over each tenant's LIVE nodes: ([..., R]
    capacity, [..., R] used), float32 (KiB sums overflow int32 at ~60 nodes
    of 64Gi; the shares these feed are ratios)."""
    nodes = tables.nodes
    return _capacity_usage(nodes.valid, nodes.alloc, nodes.used)


def _capacity_usage(valid: Array, alloc: Array, used: Array
                    ) -> Tuple[Array, Array]:
    live = valid[..., None]
    zero = torch.zeros((), dtype=alloc.dtype, device=alloc.device)
    cap = column_sum_f32(torch.where(live, alloc, zero).float())
    use = column_sum_f32(torch.where(live, used, zero).float())
    return cap, use


def _share(cap: Array, used: Array) -> Array:
    safe = torch.clamp(cap, min=1.0)
    zero = torch.zeros((), dtype=torch.float32, device=cap.device)
    return torch.where(cap > 0, used / safe, zero).amax(dim=-1)


def dominant_share(tables: ClusterTables) -> Array:
    """The DRF dominant share: max over resource dims of used/capacity, 0
    where the tenant has no capacity at all (an empty or pad tenant)."""
    return _share(*capacity_usage_planes(tables))


def drf_admission_rows(tables: ClusterTables, pending: PodArrays,
                       quota: Array) -> Tuple[Array, Array, Array]:
    """The DRF clamp for a stack of tenants: tables/pending with a leading
    tenant axis [K, …], `quota` [K] float32. Returns (admission mask [K, P],
    pre-tick dominant share [K], per-pod dominant demand [K, P])."""
    nodes = tables.nodes
    return drf_admission_planes(nodes.valid, nodes.alloc, nodes.used,
                                tables.classes.rid, tables.reqs.vec,
                                pending, quota)


def drf_admission_planes(valid: Array, alloc: Array, used: Array,
                         rid_table: Array, vec: Array, pending: PodArrays,
                         quota: Array) -> Tuple[Array, Array, Array]:
    """`drf_admission_rows` on the planes it reads: each tenant's node
    validity [K, N], alloc and used [K, N, R] — every node row of the
    tenant at once, since the column sums are not exact in any grouping
    (KiB sums far above 2^24), so a node-sharded row gathers them first
    (fleet/cycle.py) — its class → request-vector ids [K, SC] and request
    vectors [K, SR, R]."""
    cap, use = _capacity_usage(valid, alloc, used)             # [K, R]
    return clamp_from_totals(cap, use, rid_table, vec, pending, quota)


def clamp_from_totals(cap: Array, use: Array, rid_table: Array, vec: Array,
                      pending: PodArrays, quota: Array
                      ) -> Tuple[Array, Array, Array]:
    """The clamp given each tenant's capacity and usage totals [K, R]."""
    safe = torch.clamp(cap, min=1.0)
    live = cap > 0
    share = _share(cap, use)                                   # [K]

    cls = torch.clamp(pending.cls, min=0).long()               # [K, P]
    rid = torch.clamp(torch.gather(rid_table, 1, cls), min=0).long()
    R = vec.shape[-1]
    req = torch.gather(vec, 1, rid[..., None].expand(-1, -1, R)).float()
    zero = torch.zeros((), dtype=torch.float32, device=req.device)
    dom = torch.where(live[:, None, :], req / safe[:, None, :],
                      zero).amax(dim=-1)                       # [K, P]

    # prefix waterfill in queue order: the clamp admits exactly the pods the
    # wave would pop first, so clamping commutes with the engines' own
    # ordering and the tick equals a solo run
    order = queue_order(pending)                               # [K, P]
    dom_sorted = torch.where(torch.gather(pending.valid, 1, order),
                             torch.gather(dom, 1, order), zero)
    cum = prefix_sum_f32(dom_sorted)
    ok_sorted = share[:, None] + cum <= (quota + DRF_EPS)[:, None]
    ok = torch.zeros_like(pending.valid).scatter(1, order, ok_sorted)
    return pending.valid & ok, share, dom


def drf_admission_row(tables: ClusterTables, pending: PodArrays,
                      quota) -> Tuple[Array, Array, Array]:
    """One tenant's DRF clamp (K-free tables/pending, scalar quota): the
    stacked clamp on a stack of one. For goldens and the single-tenant
    reference."""
    from .tables import tree_map

    q = torch.as_tensor(quota, dtype=torch.float32,
                        device=pending.valid.device).reshape(1)
    admitted, share, dom = drf_admission_rows(
        tree_map(lambda a: a[None], tables),
        tree_map(lambda a: a[None], pending), q)
    return admitted[0], share[0], dom[0]


def violation_headroom(share, dom, admitted, quota, xp=torch):
    """Per-tenant DRF invariant check, computed from the dispatch's own
    outputs: the admitted prefix's total dominant demand must fit the
    tenant's remaining headroom. True = violated. Shapes: share/quota [K],
    dom/admitted [K, P].

    `xp` picks the array module: the fleet commit loop passes numpy so the
    check runs as host arithmetic on already-fetched outputs."""
    demand = xp.where(admitted, dom, xp.zeros_like(dom)).sum(axis=-1)
    headroom = xp.maximum(quota - share, xp.zeros_like(share))
    return demand > headroom + DRF_EPS
