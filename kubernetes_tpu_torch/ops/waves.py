"""Wave-parallel batched assignment: the scheduling cycle as a fixpoint of
dense [SC, N] evaluations (port of the JAX package's ops/waves.py, whose
module docstring sets out the algorithm and its soundness invariant).

Per wave: every class with pending pods evaluates its Filter mask and Score
row against the committed state; classes admit in queue-rank order through
the [SC, SC] interaction graph and per-domain quotas (K2 `domain_rank`
computes the rank-in-domain); same-node contention between classes resolves
in rank order (K1 `contention_scan`); failed runs consume eagerly. The JAX
package runs the waves as one lax.while_loop; here the loop runs on the host
with the same condition and cap, one readback of the condition per wave.

Integer products stay exact: the commit of requests into `used` and the
count products (CNT, HOLD, the interaction graph) run as float64 GEMMs of
0/1 matrices with int32 values — every partial sum is an integer below
2^53, so the result is exact (CUDA has no int32 GEMM), then wraps to int32
as XLA's int32 product does. The f32 WSYM product runs with TF32 off.

On a sharded node axis (parallel/axis.py) each shard runs this loop on its
own node columns: the Filter mask and Score rows, K1 and the commit are
shard-local; the per-class `best`, `infeasible`, the escape count and the
admitted counts are cross-shard reductions; the steps that order every node
of a class row — the rotated score sort, the domain quotas (K2, whose
domains span shards), the top-r cut and the map back to pods — run on the
lead device over the gathered [SC, N] score and admission rows (as GSPMD
replicates a sort over a sharded axis), and each shard takes its columns of
the admission matrix back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..parallel import axis
from ..parallel.axis import Shard
from ..state.arrays import Array, ClusterTables, PodArrays
from .assign import (AssignResult, AssignState, I32_MIN, lexsort, neg_i32,
                     pod_mask_row, row_blocks, score_row)
from .interpod import class_term_membership, domain_agg
from .kernels import contention_scan, domain_rank
from .lattice import CycleArrays

I32_MAX = 2**31 - 1


def exact_int_matmul(a: Array, b: Array) -> Array:
    """a @ b for 0/1 `a` and int32 `b`, exact, wrapped to int32."""
    return (a.double() @ b.double()).to(torch.int64).to(torch.int32)


def f32_matmul(a: Array, b: Array) -> Array:
    """a @ b in full float32: TF32 explicitly off for the product."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def interaction_graph(tables: ClusterTables, cyc: CycleArrays) -> Array:
    """G [SC, SC]: classes whose same-wave admissions could interact through
    affinity/anti-affinity/hard-spread terms. Symmetric, no self-edges."""
    classes = tables.classes
    S = cyc.TM.shape[0]
    M = cyc.TM.to(torch.int32)  # [S, SC] term matches class

    def edges(member: Array) -> Array:  # member: [SC, S]
        return exact_int_matmul(member, M) > 0

    anti = edges(cyc.has_anti)
    hard_spread_ids = torch.where(classes.tsc_hard, classes.tsc_term, -1)
    spread = edges(class_term_membership(hard_spread_ids, S))
    aff = edges(class_term_membership(classes.aff_terms, S))
    G = anti | anti.T | spread | spread.T | aff | aff.T
    G = G & classes.valid[:, None] & classes.valid[None, :]
    return G & ~torch.eye(G.shape[0], dtype=torch.bool, device=G.device)


def _class_mask_score(tables, cyc, state):
    """[SC, N] Filter mask + Score for every class against `state`, with
    -inf where infeasible, evaluated in class blocks of ROW_BLOCK."""
    classes = tables.classes
    dev = classes.valid.device
    masks, scores = [], []
    for b in row_blocks(classes.valid.shape[0]):
        cls = torch.arange(b.start, b.stop, device=dev)
        nnr = torch.full(cls.shape, -1, dtype=torch.int32, device=dev)
        mask = pod_mask_row(tables, cyc, state, cls, nnr, classes.valid[cls])
        masks.append(mask)
        scores.append(torch.where(mask, score_row(tables, cyc, state, cls),
                                  -torch.inf))
    return torch.cat(masks), torch.cat(scores)


class QuotaSlots(NamedTuple):
    """Which domain-quota families have an active slot anywhere in the
    cycle's classes (static per cycle, read once on the host)."""

    spread: bool
    anti: bool


def quota_slots(tables: ClusterTables) -> QuotaSlots:
    classes = tables.classes
    return QuotaSlots(
        spread=bool(((classes.tsc_term >= 0) & classes.tsc_hard
                     & classes.valid[:, None]).any()),
        anti=bool(((classes.anti_terms >= 0) & classes.valid[:, None]).any()))


def _domain_quota_pass(tables, cyc, state, order_n, allowed_sorted,
                       slots: QuotaSlots):
    """AND per-domain admission quotas into `allowed_sorted` [SC, N] (nodes
    in per-class score order): hard-spread slots allow maxSkew + min − count
    new pods per domain, self-matching anti-affinity one per domain. The
    rank-in-domain of every (class, slot) row comes from one K2 launch."""
    classes, nodes, terms = tables.classes, tables.nodes, tables.terms
    D = cyc.ELD.shape[2] - 1
    SC, N = allowed_sorted.shape
    cidx = torch.arange(SC, device=order_n.device)[:, None]   # [SC, 1]

    def domains(topo_key):  # [SC, A] → [SC, A, N] domain per node, -1 absent
        return torch.where((topo_key[..., None] >= 0) & nodes.valid,
                           nodes.domain.T[topo_key.clamp(min=0).long()], -1)

    def in_score_order(dom):  # → dsafe [SC, A, N], absent → discard bucket D
        dom_sorted = torch.gather(
            dom, 2, order_n[:, None, :].expand(-1, dom.shape[1], -1))
        return torch.where(dom_sorted >= 0, dom_sorted, D)

    families = []  # (active [SC, A], quota [SC, A, D+1], dsafe [SC, A, N])
    if slots.spread:
        # only self-matching classes move their own counts; the others are
        # quota-free here and guarded by the interaction graph
        s_id = classes.tsc_term
        s = s_id.clamp(min=0).long()
        eld = cyc.ELD[..., :D]                                # [SC, TS, D]
        active = ((s_id >= 0) & classes.tsc_hard & cyc.TM[s, cidx]
                  & eld.any(-1))
        dom = domains(terms.topo_key[s])
        seg = domain_agg(state.CNT[s], dom, D,
                         eligible=cyc.static.node_match[:, None, :])
        min_cnt = torch.where(eld, seg[..., :D], I32_MAX).amin(-1)
        quota = torch.clamp(
            classes.tsc_maxskew[..., None] + min_cnt[..., None] - seg,
            0, I32_MAX)
        quota = torch.where(active[..., None], quota, I32_MAX)
        families.append((active, quota, in_score_order(dom)))
    if slots.anti:
        s_id = classes.anti_terms
        k = terms.topo_key[s_id.clamp(min=0).long()]
        active = (s_id >= 0) & cyc.TM[s_id.clamp(min=0).long(), cidx] & (k >= 0)
        quota = torch.where(active[..., None],
                            torch.ones((1, 1, D + 1), dtype=torch.int32,
                                       device=k.device), I32_MAX)
        families.append((active, quota, in_score_order(domains(k))))
    if not families:
        return allowed_sorted

    dsafe = torch.cat([f[2] for f in families], 1)            # [SC, A, N]
    A_ = dsafe.shape[1]
    rank = domain_rank(dsafe.reshape(SC * A_, N).contiguous(), D + 1)
    rank = rank.reshape(SC, A_, N)
    active = torch.cat([f[0] for f in families], 1)
    quota = torch.cat([f[1] for f in families], 1)
    ok = ~active[..., None] | (rank < torch.gather(quota, 2, dsafe.long()))
    return allowed_sorted & ok.all(1)


def _escape_cap(tables, cyc, state, r):
    """Required-affinity first-pod escape (predicates.go:1436-1440): a class
    whose required terms have zero potential matches admits at most ONE pod
    this wave, so its followers see its counts next wave."""
    classes, terms, nodes = tables.classes, tables.terms, tables.nodes
    ats = classes.aff_terms
    s = ats.clamp(min=0).long()
    active = ats >= 0
    has_key = (terms.topo_key[s][..., None] >= 0) & nodes.valid  # [SC, AT, N]
    total = axis.current().sum(
        torch.where(active[..., None] & has_key, state.CNT[s], 0), (1, 2))
    escape = active.any(1) & (total == 0)
    return torch.where(escape, torch.clamp(r, max=1), r)


def queue_rank_key(nxt_ok: Array, nxt_pri: Array, nxt_cre: Array) -> Array:
    """[SC] permutation of classes in queue order of their next pod: active
    first, then priority descending, then creation ascending. Priority
    descending sorts the uint32 bits of ~(pri ^ 0x80000000) as unsigned —
    the JAX package's order-preserving bias, so INT32_MIN needs no x64."""
    pri_desc = (~(nxt_pri ^ I32_MIN)).to(torch.int64) & 0xFFFFFFFF
    return lexsort((nxt_cre, pri_desc, (~nxt_ok).to(torch.int32)))


def score_order(score: Array, crank: Array) -> Array:
    """[SC, N] nodes of each class row by score descending; equal scores
    keep a rotated node order starting at (queue rank · 97) mod N — the
    reference's round-robin start index (generic_scheduler.go:502). The
    stable sort keeps that rotation among ties, as jnp.argsort does."""
    N = score.shape[1]
    offs = (crank * 97) % N
    node_ids = torch.arange(N, device=score.device)
    rot = (node_ids[None, :] + offs[:, None]) % N
    order_rot = torch.argsort(-torch.gather(score, 1, rot), dim=1, stable=True)
    return torch.gather(rot, 1, order_rot)


def assign_waves(
    tables: ClusterTables,
    cyc: CycleArrays,
    pods: PodArrays,
    init: AssignState,
    max_waves: int | None = None,
    return_waves: bool = False,
):
    """Drop-in replacement for ops/assign.py:assign_batch (same signature,
    same result type)."""
    classes, nodes = tables.classes, tables.nodes
    dev = classes.valid.device
    SC = classes.valid.shape[0]
    P = pods.valid.shape[0]
    i32 = torch.int32
    ax = axis.current()

    G = interaction_graph(tables, cyc)
    req_by_class = tables.reqs.vec[classes.rid.clamp(min=0).long()]  # [SC, R]
    slots = quota_slots(tables)
    # what the lead step's domain quotas read of the node axis: the node
    # planes and the spread eligibility, static per cycle, gathered once
    tables_q, cyc_q = tables, cyc
    if ax.sharded and (slots.spread or slots.anti):
        from ..parallel.mesh import gather_tables

        tables_q = gather_tables(tables)
        nm = ax.gather(cyc.static.node_match, 1)
        if ax.rank == 0:
            cyc_q = cyc._replace(static=cyc.static._replace(node_match=nm))
    # classes whose Filter feasibility only tightens within a cycle (no
    # required pod-affinity, no hard spread): once infeasible everywhere,
    # they stay infeasible
    mono = (~(classes.aff_terms >= 0).any(1)
            & ~((classes.tsc_term >= 0) & classes.tsc_hard).any(1))

    # --- queue order, grouped by class (activeQ comparator within class) ---
    cls_safe = torch.where(pods.valid, pods.cls, SC)
    sorted_pods = lexsort((pods.creation, neg_i32(pods.priority), cls_safe))
    class_total = torch.zeros((SC + 1,), dtype=i32, device=dev).index_add_(
        0, cls_safe.long(), torch.ones_like(cls_safe))[:SC]
    class_offset = torch.cumsum(class_total, 0, dtype=i32) - class_total
    sorted_pods_pad = torch.cat(
        [sorted_pods, torch.full((1,), P, dtype=torch.int64, device=dev)])
    cls_sorted = torch.clamp(cls_safe[sorted_pods], max=SC - 1).long()
    pos_in_class = torch.arange(P, dtype=i32, device=dev) - class_offset[cls_sorted]
    pri_sorted = pods.priority[sorted_pods]
    sorted_valid = pods.valid[sorted_pods]

    state = init
    cursor = torch.zeros((SC,), dtype=i32, device=dev)
    node_out = torch.full((P + 1,), -1, dtype=i32, device=dev)
    wave_out = torch.full((P + 1,), -1, dtype=i32, device=dev)
    cap = max_waves if max_waves is not None else 2 * P + 2
    waves = 0
    while waves < cap and bool(((class_total - cursor > 0) & classes.valid).any()):
        remaining = class_total - cursor
        active = classes.valid & (remaining > 0)

        nxt = sorted_pods_pad[torch.clamp(class_offset + cursor, max=P).long()]
        nxt_ok = active & (nxt < P)
        nxt_safe = torch.clamp(nxt, max=P - 1)
        # i32 min is the neutral element (run counts also require nxt_ok)
        nxt_pri = torch.where(nxt_ok, pods.priority[nxt_safe], I32_MIN)
        nxt_cre = torch.where(nxt_ok, pods.creation[nxt_safe], I32_MAX)

        # length of each class's current priority run
        run_pod = (sorted_valid & (pri_sorted == nxt_pri[cls_sorted])
                   & (pos_in_class >= cursor[cls_sorted]))
        run_cnt = torch.zeros((SC,), dtype=i32, device=dev).index_add_(
            0, cls_sorted, run_pod.to(i32))
        r = torch.where(nxt_ok, torch.minimum(remaining, run_cnt), 0)

        mask, score = _class_mask_score(tables, cyc, state)
        mask = mask & nxt_ok[:, None]
        # score-window admission (EngineConfig.w_window)
        best = ax.amax(torch.where(mask, score, -torch.inf), 1, keepdim=True)
        adm_mask = mask & (score >= best - cyc.ecfg.w_window)
        r = _escape_cap(tables, cyc, state, r)

        # independent set over the interaction graph in queue-rank order
        rank_key = queue_rank_key(nxt_ok, nxt_pri, nxt_cre)          # [SC]
        crank = torch.empty((SC,), dtype=i32, device=dev)
        crank[rank_key] = torch.arange(SC, dtype=i32, device=dev)
        earlier = crank[None, :] < crank[:, None]
        blocked = (G & earlier & nxt_ok[None, :]).any(1)
        attempted = nxt_ok & ~blocked & (r > 0)
        r = torch.where(attempted, r, 0)

        # per-class admission: top-r feasible nodes by score, equal scores
        # rotated by queue rank (generic_scheduler.go:502), domain quotas —
        # over every node of the row, so on the lead device of a mesh
        def admit(score_f, adm_f, cnt_f):
            order_n = score_order(score_f, crank)                   # [SC, N]
            feas_sorted = torch.gather(adm_f, 1, order_n)
            allowed = _domain_quota_pass(
                tables_q, cyc_q, state._replace(CNT=cnt_f), order_n,
                feas_sorted, slots)
            grank = torch.cumsum(allowed.to(i32), 1) - 1
            adm_sorted = allowed & (grank < r[:, None])
            return torch.zeros_like(adm_f).scatter_(1, order_n, adm_sorted)

        A = ax.split(ax.lead(admit, Shard(score, 1), Shard(adm_mask, 1),
                             Shard(state.CNT, 1) if slots.spread
                             else state.CNT), 1)

        # per-node cross-class resolution in queue-rank order (K1)
        cord = rank_key
        ps_ord = classes.portset[cord]
        psafe = ps_ord.clamp(min=0).long()
        vs_ord = classes.volset[cord]
        vsafe = vs_ord.clamp(min=0).long()
        keep, (orp, orw, ort, orva, orvr) = contention_scan(
            A[cord], req_by_class[cord], ps_ord >= 0,
            tables.portsets.pair_words[psafe], tables.portsets.wild_words[psafe],
            tables.portsets.trip_words[psafe], vs_ord >= 0,
            tables.volsets.any_words[vsafe], tables.volsets.rw_words[vsafe],
            nodes.alloc, state.used, state.vol_any, state.vol_rw,
            tables.drv_masks, nodes.vol_limit)

        A_final = torch.zeros_like(A)
        A_final[cord] = keep
        m = ax.sum(A_final, 1, dtype=i32)                           # [SC]
        total = int(m.sum())

        # ---- commit ----
        Ai = A_final.to(i32)
        state = AssignState(
            used=state.used + exact_int_matmul(Ai.T, req_by_class),
            ppa=state.ppa | orp, ppw=state.ppw | orw, ppt=state.ppt | ort,
            CNT=state.CNT + exact_int_matmul(cyc.TM.to(i32), Ai),
            HOLD=state.HOLD + exact_int_matmul(cyc.has_anti.T.to(i32), Ai),
            WSYM=state.WSYM + f32_matmul(cyc.WCOLS, Ai.float()),
            vol_any=state.vol_any | orva, vol_rw=state.vol_rw | orvr,
        )

        # ---- map admissions back to pods (rank among kept, score order;
        # the node outputs live on the lead device) ----
        def map_back(a_f, score_f):
            N = a_f.shape[1]
            sck = torch.where(a_f, score_f, -torch.inf)
            ordk = torch.argsort(-sck, dim=1, stable=True)
            kept_sorted = torch.gather(a_f, 1, ordk)
            rank_sorted = torch.cumsum(kept_sorted.to(i32), 1, dtype=i32) - 1
            rank = torch.zeros((SC, N), dtype=i32, device=dev).scatter_(
                1, ordk, rank_sorted)
            tgt = torch.where(a_f, class_offset[:, None] + cursor[:, None]
                              + rank, P)
            pod_id = torch.where(
                a_f, sorted_pods_pad[torch.clamp(tgt, max=P).long()], P)
            pod_id = pod_id.reshape(-1)
            node_ids = torch.arange(N, dtype=i32, device=dev)
            node_out[pod_id] = node_ids.expand(SC, N).reshape(-1)
            wave_out[pod_id] = waves

        ax.lead(map_back, Shard(A_final, 1), Shard(score, 1))

        # failure consumption (see the JAX package's comment at this step):
        # zero progress fails every attempting class's run; an attempted,
        # Filter-infeasible class fails early when monotone or in the
        # failing prefix of the rank order
        infeasible = attempted & ~ax.any(mask, 1)
        ord_fail = (infeasible | ~nxt_ok)[rank_key]
        prefix = torch.cumprod(ord_fail.to(i32), 0) > 0
        in_prefix = torch.zeros((SC,), dtype=torch.bool, device=dev)
        in_prefix[rank_key] = prefix
        early_fail = infeasible & (mono | in_prefix)
        run_left = torch.minimum(run_cnt, remaining)
        consume = torch.where(
            infeasible & mono, remaining,
            torch.where(((total == 0) & attempted) | early_fail, run_left, m))
        cursor = cursor + consume
        waves += 1

    node, wave = ax.lead(lambda: (node_out[:P], wave_out[:P]))
    result = AssignResult(node=node, feasible=node >= 0, state=state)
    if return_waves:
        return result, wave
    return result
