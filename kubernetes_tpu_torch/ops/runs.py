"""Run-length-collapsed admission: schedule replica RUNS, not pods (port of
the JAX package's ops/runs.py, whose module docstring sets out the
algorithm and why its placements are bit-equal to the per-pod scan).

In short: the queue-ordered wave factors into runs of consecutive
same-class pods (a Deployment's replicas); per run the class's expensive
row context is evaluated once, and the run's replicas are placed by
admission epochs over the exact per-node head scores — each epoch admits
the longest prefix of distinct nodes, in (score desc, node index asc)
order, whose heads provably reproduce the per-pod argmax chain. Runs whose
class reads or writes terms that match itself, and runs pinned by
spec.nodeName, take the per-pod fallback through the scan itself: one K4
launch over the run's slice of the queue order (ops/kernels.py
assign_scan; its plain version, `assign_step` pod by pod, on the CPU).

The JAX package runs the run loop as a lax.scan over a static capacity
`rc`, the epochs as a while_loop and the closed-form/fallback choice as a
lax.cond; here all three are host control flow. The run table and the
self-interaction flags are read back once per dispatch, the admitted
prefix length T once per epoch. The JAX package's inactive scan steps
(r >= n_runs) are identities, so looping over the actual runs is exact.

WSYM, the one float plane a run commits: the fl(x + w) add is replayed
j[n] times per column, never j·w, and skipped when the class's weight
column is all zero — as the JAX runs engine does, so this engine matches
it (not the scan) in the sign of zero cells.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..parallel import axis
from ..parallel.axis import Shard
from ..state.arrays import Array, ClusterTables, PodArrays
from ..state.dims import bucket
from .assign import (AssignResult, AssignState, mask_context_row,
                     mask_dynamic_row, queue_order, scan_rows,
                     score_combine_row, score_context_row)
from .kernels import assign_scan

# floor for the bucketed run capacity (the JAX package's compile-signature
# floor; here it only sizes the run table's scatter)
RC_MIN = 16


class RunPlan(NamedTuple):
    """Host-side sizing of one run-collapsed dispatch: `rc` bounds the run
    count of every gang round; the rest is telemetry
    (CycleStats.class_runs / collapse_ratio). Emitted with the pending
    arrays by the snapshot (state/cache.py)."""

    rc: int       # run-axis capacity (bucketed, >= n_runs)
    n_runs: int   # actual class runs in the unmasked wave
    n_valid: int  # valid pending pods covered by those runs

    @property
    def collapse_ratio(self) -> float:
        """Scan-step reduction vs the per-pod engine: P_valid / runs."""
        return self.n_valid / max(self.n_runs, 1)


def plan_runs(cls, priority, creation, valid, node_name_req) -> RunPlan:
    """Count the class runs of the queue-ordered wave on the host (numpy
    over the staging columns) and bucket the count. The sort replicates
    queue_order exactly — including the int32 wrap of -INT32_MIN — so the
    count matches the device's run-length encoding; masking (gang rounds)
    only merges or shrinks runs, so this bounds every round."""
    cls = np.asarray(cls)
    valid = np.asarray(valid).astype(bool)
    nnr = np.asarray(node_name_req)
    negpri = (-(np.asarray(priority).astype(np.int64))).astype(np.int32)
    order = np.lexsort((np.asarray(creation), negpri, ~valid))
    v = valid[order]
    n_valid = int(v.sum())
    if n_valid == 0:
        return RunPlan(rc=RC_MIN, n_runs=0, n_valid=0)
    c = cls[order][:n_valid]
    nn = nnr[order][:n_valid]
    brk = np.ones((n_valid,), bool)
    brk[1:] = (c[1:] != c[:-1]) | (nn[1:] != nn[:-1])
    n_runs = int(brk.sum())
    return RunPlan(rc=bucket(n_runs, minimum=RC_MIN),
                   n_runs=n_runs, n_valid=n_valid)


def self_interaction_vector(tables: ClusterTables, cyc) -> Array:
    """[SC] bool: classes whose own placements can feed back into their own
    Filter/Score rows — a read term (required/anti affinity, preferred
    affinity/anti, topology spread, SelectorSpread owners) that matches the
    class, or an anti-term / symmetric weight it writes on a term that
    matches it. Such runs take the per-pod fallback."""
    classes = tables.classes
    TM = cyc.TM  # [S, SC]
    SC = classes.valid.shape[0]
    cid = torch.arange(SC, device=TM.device)

    def own_hit(ids: Array) -> Array:  # [SC, A] term slots → [SC]
        hit = TM[ids.clamp(min=0).long(), cid[:, None]] & (ids >= 0)
        return hit.any(1)

    reads_self = (
        own_hit(classes.aff_terms) | own_hit(classes.anti_terms)
        | own_hit(classes.paff_terms) | own_hit(classes.panti_terms)
        | own_hit(classes.tsc_term) | own_hit(classes.ssel_terms))
    writes_self = (TM.T & (cyc.has_anti | (cyc.WCOLS.T != 0.0))).any(1)
    return reads_self | writes_self


def _encode_runs(pods: PodArrays, rc: int):
    """Run-length encoding of the queue-ordered wave: maximal stretches of
    consecutive (class, nodeName-requirement)-identical valid pods, as the
    JAX package's scatters into `rc` slots (a discard slot for invalid
    pods, trimmed). Returns (order, run_start, run_len, run_cls, run_nnr,
    n_runs), the last a 0-d tensor."""
    P = pods.valid.shape[0]
    dev = pods.valid.device
    i32 = torch.int32
    order = queue_order(pods)
    valid_s = pods.valid[order]
    cls_s = torch.where(valid_s, pods.cls[order], -1)
    nnr_s = pods.node_name_req[order]
    pos = torch.arange(P, dtype=i32, device=dev)
    lead = torch.full((1,), -2, dtype=i32, device=dev)
    prev_cls = torch.cat([lead, cls_s[:-1]])
    prev_nnr = torch.cat([lead, nnr_s[:-1]])
    newrun = valid_s & ((cls_s != prev_cls) | (nnr_s != prev_nnr))
    rid = torch.cumsum(newrun.to(i32), 0) - 1
    rid = torch.where(valid_s, rid, rc).long()

    def scatter(fill, values, reduce):
        out = torch.full((rc + 1,), fill, dtype=i32, device=dev)
        return out.scatter_reduce_(0, rid, values, reduce=reduce,
                                   include_self=True)[:rc]

    run_len = scatter(0, torch.ones_like(pos), "sum")
    run_start = scatter(P, pos, "amin")
    run_cls = scatter(0, cls_s.clamp(min=0), "amax")
    run_nnr = scatter(-1, nnr_s, "amax")
    return order, run_start, run_len, run_cls, run_nnr, newrun.sum()


def _perpod_run(tables, cyc, pods, state, node_out, order_d, order, k,
                start):
    """Fallback: the run's pods one at a time through the scan —
    self-interacting classes and nodeName-pinned runs. One call of the
    scan (K4 on a CUDA device) over the run's slice of the queue order
    `order_d` (int32 on the device; `order` the same as a host list);
    the run's nodes come back once."""
    rows = order_d[start:start + k]
    node, state = scan_rows(tables, cyc, pods, rows, state, assign_scan)
    for idx, nd in zip(order[start:start + k], node[rows.long()].tolist()):
        node_out[idx] = nd
    return state


def admission_prefix(cur: Array, plus: Array, remaining: int):
    """One admission epoch over the [N] head scores `cur` (the class's next
    replica's masked score per node) and `plus` (each node's head after it
    admits one replica): the nodes in argmax order (score desc, node index
    asc) and the length T of the longest prefix whose every position beats
    the running argmax of the post-placement heads before it (value desc,
    then NODE index asc), is feasible and within `remaining`. Replica i < T
    of the epoch goes to node ordn[i]: the per-pod scan's choices."""
    N = cur.shape[0]
    dev = cur.device
    # ties → lowest node index; +0.0 turns a -0.0 head into +0.0, as jnp's
    # sort treats the two as equal
    ordn = torch.argsort(-(cur + 0.0), stable=True)
    e = cur[ordn]     # head score of the i-th best node
    ep = plus[ordn]   # that node's head after it admits one replica
    # the running argmax (JAX's associative_scan of a lexicographic max)
    # breaks ties by node index, not position as torch.cummax does: one
    # ordered int64 key per node, the f32 value's order in the high word
    # (-0.0 and +0.0 alike, -inf below every finite value) and the flipped
    # node index in the low one — distinct keys, so cummax's positions
    # name the lexicographic maximum
    bits = ep.view(torch.int32).to(torch.int64)
    key = torch.where(bits >= 0, bits, -(2**31) - bits)
    pos = torch.cummax(key * 2**32 + (N - 1 - ordn), 0).indices
    prev_v = torch.cat([torch.full((1,), -torch.inf, device=dev),
                        ep[pos[:-1]]])
    prev_i = torch.cat([torch.full((1,), N, dtype=torch.int64, device=dev),
                        ordn[pos[:-1]]])
    beats = (e > prev_v) | ((e == prev_v) & (ordn < prev_i))
    okpos = beats & (e != -torch.inf) & (torch.arange(N, device=dev)
                                         < remaining)
    return ordn, int(torch.cumprod(okpos.to(torch.int32), 0).sum())


def _closed_run(tables, cyc, state: AssignState, node_out: list,
                order: list, c: int, k: int, start: int, wsym: bool,
                stats: dict) -> AssignState:
    """The waterfill for one self-interaction-free run of `k` replicas of
    class `c`: admission epochs over the exact per-node head scores. Every
    float flows through the expression tree the scan evaluates
    (score_combine_row / mask_dynamic_row on per-node planes after j
    replicas), so the admitted node sequence is bit-equal to the per-pod
    argmax chain. Writes the run's nodes into the host list node_out and
    returns the state with the whole run committed."""
    classes = tables.classes
    N = tables.nodes.valid.shape[0]
    dev = state.used.device
    ax = axis.current()
    cls1 = torch.tensor([c], dtype=torch.int64, device=dev)
    req_vec = tables.reqs.vec[int(classes.rid[c])]  # [R]
    ps, vs = int(classes.portset[c]), int(classes.volset[c])
    own = {}
    if ps >= 0:
        own.update(ppa=tables.portsets.pair_words[ps],
                   ppw=tables.portsets.wild_words[ps],
                   ppt=tables.portsets.trip_words[ps])
    if vs >= 0:
        own.update(vol_any=tables.volsets.any_words[vs],
                   vol_rw=tables.volsets.rw_words[vs])

    # the frozen per-run context: one expensive row evaluation per RUN
    ctx_mask = mask_context_row(
        tables, cyc, state, cls1,
        torch.full((1,), -1, dtype=torch.int32, device=dev),
        torch.ones((1,), dtype=torch.bool, device=dev))[0]
    sctx = score_context_row(tables, cyc, state, cls1)

    def words(name, placed):
        # node n's port/volume words after its own placements: an
        # idempotent OR, so one placement and j synthesize alike
        base = getattr(state, name)
        if name not in own:
            return base
        return base | torch.where(placed[:, None], own[name][None, :], 0)

    def row_at(j, placed):
        """The class's next replica's masked score row [N] when node n
        already took j[n] replicas of this run."""
        used_j = state.used + j[:, None] * req_vec[None, :]
        dyn = mask_dynamic_row(
            tables, cyc, cls1, used_j, *(words(f, placed) for f in
                                          ("ppa", "ppw", "ppt", "vol_any",
                                           "vol_rw")))[0]
        m = ctx_mask & dyn
        s = score_combine_row(tables, cyc, cls1, used_j, sctx)[0]
        return torch.where(m, s, -torch.inf)

    j = torch.zeros((N,), dtype=torch.int32, device=dev)
    all_placed = torch.ones((N,), dtype=torch.bool, device=dev)
    remaining, consumed = k, 0
    while remaining > 0:
        stats["epochs"] += 1
        # the epoch orders every node: on the lead device of a mesh, each
        # shard then counts the admitted nodes among its own rows
        def epoch(cur, plus):
            ordn, t = admission_prefix(cur, plus, remaining)
            return ordn[:t], t

        head, T = ax.lead(epoch, Shard(row_at(j, j > 0), 0),
                          Shard(row_at(j + 1, all_placed), 0))
        if T == 0:
            break
        # replica (consumed + i) of the run → node head[i], i < T
        for i, nd in enumerate(head.tolist()):
            node_out[order[start + consumed + i]] = nd
        row, inside = ax.local_rows(head, N)
        j[row[inside]] += 1
        remaining -= T
        consumed += T

    # commit the whole run: integer and word planes in closed form; WSYM
    # replays the scan's per-placement add chain (j·w would round otherwise)
    placed = j > 0
    WSYM = state.WSYM
    if wsym:
        w_vec = cyc.WCOLS[:, c]
        for t in range(int(ax.amax(j, 0))):
            WSYM = WSYM + torch.where((j > t)[None, :], w_vec[:, None], 0.0)
    return AssignState(
        used=state.used + j[:, None] * req_vec[None, :],
        ppa=words("ppa", placed), ppw=words("ppw", placed),
        ppt=words("ppt", placed),
        CNT=state.CNT + cyc.TM[:, c].to(torch.int32)[:, None] * j[None, :],
        HOLD=state.HOLD
        + cyc.has_anti[c].to(torch.int32)[:, None] * j[None, :],
        WSYM=WSYM,
        vol_any=words("vol_any", placed), vol_rw=words("vol_rw", placed))


def assign_runs(tables: ClusterTables, cyc, pods: PodArrays,
                init: AssignState, rc: int) -> AssignResult:
    """assign_batch's contract plus the run capacity `rc` (plan_runs):
    placements bit-equal to the per-pod scan, one step per RUN. Counts the
    runs that took the closed form, those that fell back and the epochs in
    `assign_runs.stats`."""
    P = pods.valid.shape[0]
    stats = assign_runs.stats
    stats["dispatches"] += 1
    order, run_start, run_len, run_cls, run_nnr, n_runs = _encode_runs(
        pods, int(rc))
    n = int(n_runs)
    table = torch.stack([run_start, run_len, run_cls, run_nnr])[:, :n]
    starts, lens, clss, nnrs = table.tolist()
    selfi = self_interaction_vector(tables, cyc).tolist()
    wsym = (cyc.WCOLS != 0.0).any(0).tolist()
    order_d = order.to(torch.int32)
    order = order.tolist()
    node_out = [-1] * P
    state = init
    for start, k, c, nnr in zip(starts, lens, clss, nnrs):
        if not selfi[c] and nnr < 0:
            stats["closed"] += 1
            state = _closed_run(tables, cyc, state, node_out, order, c, k,
                                start, wsym[c], stats)
        else:
            stats["fallback"] += 1
            state = _perpod_run(tables, cyc, pods, state, node_out, order_d,
                                order, k, start)
    node = torch.tensor(node_out, dtype=torch.int32, device=pods.valid.device)
    return AssignResult(node=node, feasible=node >= 0, state=state)


def reset_run_stats() -> None:
    assign_runs.stats = {"dispatches": 0, "closed": 0, "fallback": 0,
                         "epochs": 0}


reset_run_stats()
