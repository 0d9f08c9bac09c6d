"""The scheduling-cycle driver: host objects in, placements out (port of the
JAX package's sched/cycle.py).

encode (state/encode.py) → tensors on the device (state/arrays.py
tables_to_torch) → build_cycle → initial_state → assign_waves (or the
sequential scan for a batch with a `spec.nodeName` pod; either inside the
gang engine's rounds, ops/gang.py, for a batch with gang-grouped pods) →
node names. The serving path (sched/scheduler.py) takes its tensors from
the resident cache instead (state/cache.py, through `snapshot_with_keys`).

The port has no run-collapsed engine, extra score plugins, prewarmer or mesh
yet: KTPU_ASSIGN=runs raises NotImplementedError naming the ROADMAP item
that ports it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from ..api.types import Node, Pod
from ..ops.assign import AssignResult, assign_batch, initial_state
from ..ops.gang import GangArrays, assign_gang
from ..ops.lattice import build_cycle
from ..ops.waves import assign_waves
from ..state.arrays import ClusterTables, PodArrays, tables_to_torch, to_device
from ..state.dims import Dims
from ..state.encode import Encoder

UNSCHEDULABLE_TAINT_KEY = "node.kubernetes.io/unschedulable"  # predicates.go:1522-1541


def snapshot_with_keys(cache, encoder: Encoder, pending, base_dims,
                       device=None):
    """Snapshot + the interned synthetic-taint key ids every dispatch needs
    — the single home for the UNSCHEDULABLE_TAINT_KEY interning ritual.
    `device` is where the snapshot's tensors live (the CUDA card when
    None)."""
    snap = cache.snapshot(encoder, pending, base_dims,
                          extra_intern=(UNSCHEDULABLE_TAINT_KEY,),
                          device=device)
    return snap, _taint_scalars(encoder)


def micro_snapshot_with_keys(cache, encoder: Encoder, pending, base_dims,
                             micro_p: int, device=None):
    """Micro-wave snapshot: bring the RESIDENT cluster state current through
    the ordinary generation-diffed snapshot — with an EMPTY pending batch,
    so node/existing-pod deltas ride the same patch path as a bulk wave —
    then graft a small standalone [micro_p] pending block holding just the
    watch-delta pods (state/cache.py micro_graft). The pods are interned
    FIRST so any registry/capacity growth they cause lands in the base
    snapshot's dims/tables before the graft reads them (and so the vocab
    and class ids come out in the JAX package's order)."""
    encoder.intern_pods(pending)
    base = cache.snapshot(encoder, [], base_dims,
                          extra_intern=(UNSCHEDULABLE_TAINT_KEY,),
                          device=device)
    snap = cache.micro_graft(encoder, pending, base, micro_p, device=device)
    return snap, _taint_scalars(encoder)


def _taint_scalars(encoder: Encoder):
    """The interned synthetic-taint pair every dispatch carries, as the two
    Python ints `schedule_batch` takes."""
    encoder.vocabs.label_vals.intern("")
    return (encoder.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY),
            encoder.vocabs.label_vals.get(""))


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
                   has_node_name: bool = False,
                   gang: Optional[GangArrays] = None,
                   return_waves: bool = False):
    """One cycle on tensors: build_cycle → initial_state → the engine. A
    batch holding a `spec.nodeName` pod runs through the sequential scan:
    the class-granular wave path cannot express a per-pod host constraint.
    With `gang` (gang-grouped pods in the batch) the engine runs inside the
    gang engine's rejection rounds. With `return_waves` the result comes
    with the wave index per pod — None where the scan ran (the JAX
    package's contract)."""
    engine = _engine()
    if engine == "waves" and has_node_name:
        engine = "scan"
    uk, ev = keys
    cyc = build_cycle(tables, existing, uk, ev, D)
    init = initial_state(tables, cyc)
    waves = None
    if gang is not None:
        if return_waves and engine == "waves":
            res, _, waves = assign_gang(tables, cyc, pending, init, gang,
                                        return_waves=True)
        else:
            res, _ = assign_gang(
                tables, cyc, pending, init, gang,
                engine_fn=assign_batch if engine == "scan" else None)
    elif engine == "scan":
        res = assign_batch(tables, cyc, pending, init)
    elif return_waves:
        res, waves = assign_waves(tables, cyc, pending, init,
                                  return_waves=True)
    else:
        res = assign_waves(tables, cyc, pending, init)
    return (res, waves) if return_waves else res


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
        gang = enc.build_gang_arrays(list(pending), d, bound)
        if gang is not None:
            gang = to_device(gang, self.device)
        uk = enc.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY)
        ev = enc.vocabs.label_vals.get("")
        tables_t, (ex_t, pe_t) = tables_to_torch(tables, (ex, pe), self.device)
        res = schedule_batch(tables_t, pe_t, (uk, ev), d.D, ex_t,
                             has_node_name=d.has_node_name, gang=gang)
        self.last_result = res
        node_idx = res.node.cpu().tolist()

        assignments: List[Optional[str]] = []
        for i in range(len(pending)):
            ni = node_idx[i]
            assignments.append(nodes[ni].name if ni >= 0 else None)
        scheduled = sum(a is not None for a in assignments)
        return CycleResult(assignments=assignments, scheduled=scheduled,
                           failed=len(pending) - scheduled)
