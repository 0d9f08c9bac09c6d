"""The scheduling-cycle driver: host objects in, placements out (port of the
JAX package's sched/cycle.py, batch path).

encode (state/encode.py) → tensors on the device (state/arrays.py
tables_to_torch) → build_cycle → initial_state → assign_waves (or the
sequential scan for a batch with a `spec.nodeName` pod) → node names.

The port has no gang engine, run-collapsed engine, extra score plugins,
prewarmer or mesh yet: a gang batch and KTPU_ASSIGN=runs raise
NotImplementedError naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from ..api.types import Node, Pod
from ..ops.assign import AssignResult, assign_batch, initial_state
from ..ops.lattice import build_cycle
from ..ops.waves import assign_waves
from ..state.arrays import ClusterTables, PodArrays, tables_to_torch
from ..state.dims import Dims
from ..state.encode import Encoder

UNSCHEDULABLE_TAINT_KEY = "node.kubernetes.io/unschedulable"  # predicates.go:1522-1541


def _engine() -> str:
    """Assignment engine from KTPU_ASSIGN: 'waves' (default, ops/waves.py)
    or 'scan' (the sequential spec, ops/assign.py). 'runs' is not ported yet;
    unrecognized values normalize to 'waves', as in the JAX package."""
    eng = os.environ.get("KTPU_ASSIGN", "waves")
    if eng == "runs":
        raise NotImplementedError(
            "KTPU_ASSIGN=runs: the run-collapsed engine (ops/runs.py) is not "
            "ported yet — ROADMAP A9")
    return eng if eng == "scan" else "waves"


def schedule_batch(tables: ClusterTables, pending: PodArrays, keys: tuple,
                   D: int, existing: PodArrays,
                   has_node_name: bool = False) -> AssignResult:
    """One cycle on tensors: build_cycle → initial_state → the engine. A
    batch holding a `spec.nodeName` pod runs through the sequential scan:
    the class-granular wave path cannot express a per-pod host constraint."""
    engine = _engine()
    if engine == "waves" and has_node_name:
        engine = "scan"
    uk, ev = keys
    cyc = build_cycle(tables, existing, uk, ev, D)
    init = initial_state(tables, cyc)
    if engine == "scan":
        return assign_batch(tables, cyc, pending, init)
    return assign_waves(tables, cyc, pending, init)


@dataclass
class CycleResult:
    """Placements for one cycle. `assignments[i]` is the node name for
    pending[i], or None if unschedulable (FitError analog)."""

    assignments: List[Optional[str]]
    scheduled: int
    failed: int


class BatchScheduler:
    """Stateless-per-call batch scheduler: give it the world, get placements
    (genericScheduler analog).

    Runs on the CUDA device unless `device="cpu"` is asked for; with no
    usable GPU and no explicit CPU device it raises, never moving to the CPU
    on its own."""

    def __init__(self, device="cuda") -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BatchScheduler(device='cuda'): no CUDA device is available; "
                "pass device='cpu' to run on the CPU")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.encoder = Encoder()
        self.last_result: Optional[AssignResult] = None

    def schedule(
        self,
        nodes: Sequence[Node],
        existing: Sequence[Pod],
        pending: Sequence[Pod],
        base_dims: Optional[Dims] = None,
    ) -> CycleResult:
        enc = self.encoder
        # the synthetic unschedulable taint must be interned before matching
        enc.vocabs.label_keys.intern(UNSCHEDULABLE_TAINT_KEY)
        enc.vocabs.label_vals.intern("")
        tables, ex, pe, d = enc.encode_cluster(nodes, existing, pending, base_dims)
        bound: Dict[int, int] = {}
        for p in existing:
            g = enc.group_id(p)
            if g >= 0:
                bound[g] = bound.get(g, 0) + 1
        if enc.build_gang_arrays(list(pending), d, bound) is not None:
            raise NotImplementedError(
                "gang-grouped pods: the gang engine (ops/gang.py) is not "
                "ported yet — ROADMAP A9")
        uk = enc.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY)
        ev = enc.vocabs.label_vals.get("")
        tables_t, (ex_t, pe_t) = tables_to_torch(tables, (ex, pe), self.device)
        res = schedule_batch(tables_t, pe_t, (uk, ev), d.D, ex_t,
                             has_node_name=d.has_node_name)
        self.last_result = res
        node_idx = res.node.cpu().tolist()

        assignments: List[Optional[str]] = []
        for i in range(len(pending)):
            ni = node_idx[i]
            assignments.append(nodes[ni].name if ni >= 0 else None)
        scheduled = sum(a is not None for a in assignments)
        return CycleResult(assignments=assignments, scheduled=scheduled,
                           failed=len(pending) - scheduled)
