"""The benchmark's fixed arithmetic: the card's published peaks, the
operations and bytes of the two hand kernels a wave launches, the union of
device intervals and the gaps between them.

Frozen copies: the peaks and the K1/K2 counts are chip_smoke.py's
(`HBM_BYTES_PER_S`, `CUDA_CORE_OPS_PER_S`, `k1_bound`, `k2_bound`), the
interval union is scripts/torch_cycle_profile.py's `busy_us`. The program
may change; what it is measured against does not.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM, data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12   # float32 outside the tensor cores


def nbytes(shapes_and_sizes: Iterable[Tuple[Sequence[int], int]]) -> int:
    """Bytes of tensors given as (shape, element size)."""
    return sum(math.prod(s) * e for s, e in shapes_and_sizes)


def k1_counts(args, out) -> Tuple[int, int]:
    """(bytes, operations) of one contention_scan launch: each input read
    once and each output written once; per (class, node) a fit test and a
    running sum over R slots, the port and volume word tests and the
    per-driver popcounts. `args`/`out` are (shape, element size) pairs in
    the launch's argument order."""
    A, req, _hp, pw, _ww, tw, _hv, va = (a[0] for a in args[:8])
    SC, N = A
    R, PW, PT, VW = req[1], pw[1], tw[1], va[1]
    DR = args[13][0][0]
    b = nbytes(args) + nbytes(out)
    ops = SC * N * (6 * R + 4 * (2 * PW + PT) + 8 * VW + 3 * DR * VW + 10)
    return b, ops


def k2_counts(dom) -> Tuple[int, int]:
    """(bytes, operations) of one domain_rank launch over `dom` (shape,
    element size): the rows read once, the ranks written once, a handful of
    operations an element."""
    n = math.prod(dom[0])
    return 2 * n * dom[1], 6 * n


def bound_s(b: int, ops: int) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(b / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S)


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if e <= cur:
            continue
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]
