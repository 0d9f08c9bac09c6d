"""The scheduling-cycle driver: host objects in, placements out (port of the
JAX package's sched/cycle.py).

encode (state/encode.py) → tensors on the device (state/arrays.py
tables_to_torch) → build_cycle → initial_state → the engine KTPU_ASSIGN
names — with a configured plugin composition (EngineConfig flags and
weights, hardPodAffinitySymmetricWeight, the out-of-set score plugins
folded into the static score as one per-class bias) — assign_waves (the
default), the run-collapsed assign_runs
(KTPU_ASSIGN=runs) or the sequential scan (KTPU_ASSIGN=scan, and every
waves batch with a `spec.nodeName` pod); any of them inside the gang
engine's rounds (ops/gang.py) for a batch with gang-grouped pods → node
names, and with `explain` the decision attribution of the wave
(ops/assign.py explain_assignments). The serving path
(sched/scheduler.py) takes its tensors from the resident cache instead
(state/cache.py, through `snapshot_with_keys`); the extender verbs
evaluate one pod through `_feasible`, `_scores` and `_diagnose`.

On a mesh (parallel/mesh.py) `schedule_batch` takes `ShardedTables`: the
same cycle runs on every shard's node rows under its node axis, with the
pending and existing pods (and the gang arrays) replicated to the shards'
devices, and the placements, the final state and the attribution come back
on the lead device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from ..api.types import Node, Pod
from ..ops.assign import (AssignResult, assign_batch, explain_assignments,
                          feasible_matrix, initial_state, mask_components,
                          score_matrix)
from ..ops.gang import GangArrays, assign_gang
from ..ops.lattice import (EngineConfig, build_cycle, default_engine_config,
                           f32_scalar, fma_f32, strong_engine_config)
from ..ops.runs import assign_runs, plan_runs
from ..ops.waves import assign_waves
from ..parallel import axis
from ..parallel.mesh import (ShardedTables, gather_full, gather_state,
                             replicate)
from ..state.arrays import ClusterTables, PodArrays, tables_to_torch, to_device
from ..state.dims import Dims
from ..state.encode import Encoder

UNSCHEDULABLE_TAINT_KEY = "node.kubernetes.io/unschedulable"  # predicates.go:1522-1541


def snapshot_with_keys(cache, encoder: Encoder, pending, base_dims,
                       device=None, mesh=None):
    """Snapshot + the interned synthetic-taint key ids every dispatch needs
    — the single home for the UNSCHEDULABLE_TAINT_KEY interning ritual.
    `device` is where the snapshot's tensors live (the CUDA card when
    None); with a `mesh` the node planes are resident per shard."""
    snap = cache.snapshot(encoder, pending, base_dims,
                          extra_intern=(UNSCHEDULABLE_TAINT_KEY,),
                          device=device, mesh=mesh)
    return snap, _taint_scalars(encoder)


def micro_snapshot_with_keys(cache, encoder: Encoder, pending, base_dims,
                             micro_p: int, device=None, mesh=None):
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
                          device=device, mesh=mesh)
    snap = cache.micro_graft(encoder, pending, base, micro_p, device=device,
                             mesh=mesh)
    return snap, _taint_scalars(encoder)


def _taint_scalars(encoder: Encoder):
    """The interned synthetic-taint pair every dispatch carries, as the two
    Python ints `schedule_batch` takes. The JAX package places its two
    scalars on its mesh, replicated; here they are host ints that every
    shard's thread reads, so a mesh needs no branch."""
    encoder.vocabs.label_vals.intern("")
    return (encoder.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY),
            encoder.vocabs.label_vals.get(""))


def _engine() -> str:
    """Assignment engine from KTPU_ASSIGN: 'waves' (default, ops/waves.py),
    'runs' (the run-collapsed engine, ops/runs.py) or 'scan' (the
    sequential spec, ops/assign.py); unrecognized values normalize to
    'waves', as in the JAX package."""
    eng = os.environ.get("KTPU_ASSIGN", "waves")
    return eng if eng in ("waves", "runs", "scan") else "waves"


# gang batches at least this large take the JAX package's host-rounds route
# there, which attributes nothing under explain (its sched/cycle.py
# _schedule_gang_host_rounds); the port's one gang route keeps that contract
_GANG_HOST_THRESHOLD = int(os.environ.get(
    "KTPU_GANG_HOST_ROUNDS_ABOVE", "65536"))


def _resolve_rc(pending: PodArrays, runs) -> int:
    """The run-collapsed engine's run capacity: the snapshot's RunPlan when
    the cache emitted one, else planned from the pending arrays (one [P]
    readback per column)."""
    if runs is not None:
        return runs.rc
    return plan_runs(*(t.cpu().numpy() for t in (
        pending.cls, pending.priority, pending.creation, pending.valid,
        pending.node_name_req))).rc


def _apply_extra_plugins(tables: ClusterTables, cyc, extra_plugins: tuple,
                         extra_weights: tuple):
    """Fold configured out-of-set score plugins (NodeLabel, RTCR, …) into the
    static score lattice as a per-class bias — the engines' analog of
    RunScorePlugins for plugins EngineConfig has no fixed slot for. They
    are evaluated against a per-CLASS identity pending view (their scores
    are class-pure); the bias is summed from zeros in plugin order and
    added to the static score once, as in the JAX package."""
    if not extra_plugins:
        return cyc
    from ..framework.interface import CycleState, TensorContext

    classes = tables.classes
    SC = classes.valid.shape[0]
    dev = classes.valid.device
    none = torch.full((SC,), -1, dtype=torch.int32, device=dev)
    zero = torch.zeros((SC,), dtype=torch.int32, device=dev)
    ident = PodArrays(
        valid=classes.valid, name_id=none, ns=classes.ns,
        cls=torch.arange(SC, dtype=torch.int32, device=dev),
        priority=zero, creation=zero, node_id=none, node_name_req=none)
    ctx = TensorContext(tables=tables, cyc=cyc, pending=ident)
    bias = torch.zeros_like(cyc.static.score)
    for pl, w in zip(extra_plugins, extra_weights):
        # bias + w·row as the JAX package's compiled fold computes it: one
        # fused multiply-add per plugin
        bias = fma_f32(bias, f32_scalar(w),
                       pl.score_matrix(CycleState(), ctx).float())
    return cyc._replace(static=cyc.static._replace(
        score=cyc.static.score + bias))


def _cycle(tables: ClusterTables, existing: PodArrays, keys: tuple, D: int,
           hard_weight: float = 1.0, ecfg: Optional[EngineConfig] = None,
           extra_plugins: tuple = (), extra_weights: tuple = ()):
    """build_cycle with the configured composition: the EngineConfig and
    hardPodAffinitySymmetricWeight as f32 values (the JAX package's strong
    f32 scalars), then the extra score plugins' bias."""
    uk, ev = keys
    ecfg = strong_engine_config(ecfg if ecfg is not None
                                else default_engine_config())
    cyc = build_cycle(tables, existing, uk, ev, D, f32_scalar(hard_weight),
                      ecfg)
    return _apply_extra_plugins(tables, cyc, extra_plugins, extra_weights)


def schedule_batch(tables: ClusterTables, pending: PodArrays, keys: tuple,
                   D: int, existing: PodArrays,
                   has_node_name: bool = False,
                   hard_weight: float = 1.0,
                   ecfg: Optional[EngineConfig] = None,
                   extra_plugins: tuple = (),
                   extra_weights: tuple = (),
                   gang: Optional[GangArrays] = None,
                   return_waves: bool = False,
                   runs=None,
                   explain: bool = False):
    """One cycle on tensors: build_cycle (with the configured composition:
    `ecfg`, `hard_weight`, the `extra_plugins` at `extra_weights`) →
    initial_state → the engine. A
    waves batch holding a `spec.nodeName` pod runs through the sequential
    scan: the class-granular wave path cannot express a per-pod host
    constraint (the runs engine keeps such a batch: it splits runs on
    nodeName and takes those pods one by one). With `gang` (gang-grouped
    pods in the batch) the engine runs inside the gang engine's rejection
    rounds. `runs` is the snapshot's RunPlan (ops/runs.py) for the runs
    engine. With `return_waves` the result comes with the wave index per
    pod — None where another engine ran; with `explain` with the wave's
    ExplainResult ("pod" granularity for the scan, "class" otherwise; None
    for a gang batch of the JAX package's host-rounds size). The two cannot
    be combined."""
    if explain and return_waves:
        raise ValueError("explain and return_waves cannot be combined")
    if isinstance(tables, ShardedTables):
        return _schedule_sharded(
            tables, pending, keys, D, existing, has_node_name=has_node_name,
            hard_weight=hard_weight, ecfg=ecfg, extra_plugins=extra_plugins,
            extra_weights=extra_weights, gang=gang,
            return_waves=return_waves, runs=runs, explain=explain)
    engine = _engine()
    if engine == "waves" and has_node_name:
        engine = "scan"
    rc = _resolve_rc(pending, runs) if engine == "runs" else 0

    def runs_fn(t, cy, pe, ini):
        return assign_runs(t, cy, pe, ini, rc)

    cyc = _cycle(tables, existing, keys, D, hard_weight, ecfg,
                 extra_plugins, extra_weights)
    init = initial_state(tables, cyc)
    waves = None
    if gang is not None:
        if return_waves and engine == "waves":
            res, _, waves = assign_gang(tables, cyc, pending, init, gang,
                                        return_waves=True)
        else:
            res, _ = assign_gang(
                tables, cyc, pending, init, gang,
                engine_fn={"scan": assign_batch, "runs": runs_fn}.get(engine))
    elif engine == "scan":
        res = assign_batch(tables, cyc, pending, init)
    elif engine == "runs":
        res = runs_fn(tables, cyc, pending, init)
    elif return_waves:
        res, waves = assign_waves(tables, cyc, pending, init,
                                  return_waves=True)
    else:
        res = assign_waves(tables, cyc, pending, init)
    if explain:
        if gang is not None and engine == "waves" \
                and pending.valid.shape[0] >= _GANG_HOST_THRESHOLD:
            return res, None
        gran = "pod" if engine == "scan" else "class"
        ax = axis.current()
        if ax.sharded:
            # the attribution ranks every node of a row: on the lead device,
            # over the gathered tables, lattice and state
            ft, fc, fs = gather_full(tables, cyc, res.state)
            return res, ax.lead(lambda: explain_assignments(
                ft, fc, pending, res._replace(state=fs), granularity=gran))
        return res, explain_assignments(tables, cyc, pending, res,
                                        granularity=gran)
    return (res, waves) if return_waves else res


def _schedule_sharded(st: ShardedTables, pending: PodArrays, keys: tuple,
                      D: int, existing: PodArrays, **kw):
    """schedule_batch on a mesh: the cycle on every shard (parallel/mesh.py
    ShardedTables.run), the pods replicated to the shards' devices; the
    lead shard's outputs, its result carrying the gathered final state."""
    mesh = st.mesh
    gang = kw.pop("gang")
    pair = kw["explain"] or kw["return_waves"]

    def shard(tables, pe, ex, g):
        out = schedule_batch(tables, pe, keys, D, ex, gang=g, **kw)
        res = out[0] if pair else out
        res = res._replace(state=gather_state(res.state))
        return (res, out[1]) if pair else res

    return st.run(shard, replicate(pending, mesh), replicate(existing, mesh),
                  replicate(gang, mesh))[0]


def _node_rows(fn):
    """A [P, N]-valued verb (`fn(tables, pending, keys, D, existing, ...)`)
    on ShardedTables: every shard evaluates its node columns, the rows come
    back gathered on the lead device."""
    def wrapped(tables, pending, keys, D, existing, *args):
        if not isinstance(tables, ShardedTables):
            return fn(tables, pending, keys, D, existing, *args)
        mesh = tables.mesh
        return tables.run(
            lambda t, pe, ex: axis.current().gather_tree(
                fn(t, pe, keys, D, ex, *args), 1),
            replicate(pending, mesh), replicate(existing, mesh))[0]

    wrapped.__doc__ = fn.__doc__
    return wrapped


@_node_rows
def _feasible(tables: ClusterTables, pending: PodArrays, keys: tuple, D: int,
              existing: PodArrays, hard_weight: float = 1.0,
              ecfg: Optional[EngineConfig] = None):
    """[P, N] Filter mask — findNodesThatFit for every pending pod at once
    (the extender's Filter and ProcessPreemption verbs)."""
    return feasible_matrix(
        tables, _cycle(tables, existing, keys, D, hard_weight, ecfg),
        pending)


@_node_rows
def _scores(tables: ClusterTables, pending: PodArrays, keys: tuple, D: int,
            existing: PodArrays, hard_weight: float = 1.0,
            ecfg: Optional[EngineConfig] = None, extra_plugins: tuple = (),
            extra_weights: tuple = ()):
    """[P, N] Score matrix, -inf where infeasible — prioritizeNodes for
    every pending pod at once (the extender's Prioritize verb, the
    Scheduler's per-pod extender path), with the batch path's composition
    including the out-of-set plugins."""
    return score_matrix(
        tables, _cycle(tables, existing, keys, D, hard_weight, ecfg,
                       extra_plugins, extra_weights), pending)


@_node_rows
def _diagnose(tables: ClusterTables, pending: PodArrays, keys: tuple, D: int,
              existing: PodArrays, hard_weight: float = 1.0,
              ecfg: Optional[EngineConfig] = None):
    """Per-predicate [P, N] component masks (PredicateFailureReason
    analog) against the cycle's initial state."""
    return mask_components(
        tables, _cycle(tables, existing, keys, D, hard_weight, ecfg),
        pending)


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
