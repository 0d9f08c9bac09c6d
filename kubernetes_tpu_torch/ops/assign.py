"""Per-pod sequential assignment and the Filter/Score rows both engines share
(port of the main-path half of the JAX package's ops/assign.py).

The reference schedules one pod per `scheduleOne` call (scheduler.go:596-763):
filter → score → selectHost → assume, each placement visible to the next pod.
`assign_batch` reproduces that literally, pod by pod in queue order (priority
desc, creation asc — scheduling_queue.go:119-138): on a CUDA device as one
launch of the hand kernel K4 (ops/kernels.py assign_scan), on the CPU as its
plain version `assign_scan_plain`, a host loop of `assign_step`. It is the
executable spec the wave engine is held against, and it serves batches with
a `spec.nodeName` pod.

The row functions take a vector of class ids `cls` [B] and return [B, N]
rows (the JAX package vmaps the same per-class rows over classes). Ties in
the max score pick the lowest node index (docs/PARITY.md).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..parallel import axis
from ..state.arrays import Array, ClusterTables, PodArrays
from .fit import fit_row, resource_scores, resource_scores_row
from .interpod import affinity_rows, soft_affinity_row
from .kernels import _COUNT_LOCK, assign_scan
from .lattice import CycleArrays, _on
from .ports import port_conflict_row
from .scores import even_spread_soft_row, selector_spread_row
from .topospread import spread_row
from .volumes import volume_components_row, volume_ok_row

I32_MIN = -(2**31)


class AssignState(NamedTuple):
    used: Array  # [N, R] i32
    ppa: Array   # [N, PWp] i32 words — (proto,port) pairs in use (any IP)
    ppw: Array   # [N, PWp] i32 words — wildcard-IP pairs in use
    ppt: Array   # [N, PWt] i32 words — exact triples in use
    CNT: Array   # [S, N] i32 — per-node term match counts
    HOLD: Array  # [S, N] i32 — per-node anti-term holders
    WSYM: Array  # [S, N] f32 — signed symmetric soft-affinity weights
    vol_any: Array  # [N, VW] i32 words — attached volumes
    vol_rw: Array   # [N, VW] i32 words — attached read-write


class AssignResult(NamedTuple):
    node: Array       # [P] i32 — chosen node index, -1 unschedulable
    feasible: Array   # [P] bool
    state: AssignState


def neg_i32(x: Array) -> Array:
    """int32 negation that wraps like jnp's: -INT32_MIN == INT32_MIN."""
    return torch.where(x == I32_MIN, x, -x)


def lexsort(keys: Sequence[Array]) -> Array:
    """numpy/jnp lexsort along the last axis (so [B, n] keys sort each row):
    the LAST key is primary. torch has none, so chain stable sorts from the
    least significant key up."""
    order = torch.argsort(keys[0], dim=-1, stable=True)
    for k in keys[1:]:
        order = torch.gather(order, -1, torch.argsort(
            torch.gather(k, -1, order), dim=-1, stable=True))
    return order


def queue_order(pods: PodArrays) -> Array:
    """activeQ pop order: valid first, then priority desc, then creation asc
    (scheduling_queue.go activeQComp)."""
    return lexsort((pods.creation, neg_i32(pods.priority),
                    (~pods.valid).to(torch.int32)))


def mask_context_row(tables, cyc: CycleArrays, state: AssignState, cls: Array,
                     node_name_req: Array, valid: Array) -> Array:
    """Filter components other than resources/ports/volumes: the static
    lattice, inter-pod affinity, hard topology spread, spec.nodeName and pod
    validity → [B, N]."""
    nodes, classes, terms = tables.nodes, tables.classes, tables.terms
    ecfg = cyc.ecfg
    D = cyc.ELD.shape[2] - 1
    cl = cls.long()
    aff_ok, anti_ok = affinity_rows(
        cl, classes, terms, cyc.TM, state.CNT, state.HOLD, nodes, D)
    interpod_ok = (aff_ok & anti_ok) | (not _on(ecfg.f_interpod))
    spread_ok = spread_row(
        cl, classes, terms, cyc.TM, state.CNT, cyc.ELD,
        cyc.static.node_match[cl], nodes, D) | (not _on(ecfg.f_spread))
    nnr = node_name_req[:, None]
    host_ok = (nnr < 0) | (nodes.name_id[None, :] == nnr) \
        | (not _on(ecfg.f_name))
    return (cyc.static.mask[cl] & interpod_ok & spread_ok & host_ok
            & valid[:, None])


def fit_plane(tables, cyc: CycleArrays, cls: Array, used: Array) -> Array:
    """PodFitsResources plane [B, N] incl. the plugin flag — the one
    composition the engines' dynamic mask and the explain attribution
    share."""
    req_vec = tables.reqs.vec[tables.classes.rid[cls.long()].long()]
    return fit_row(req_vec, used, tables.nodes.alloc, tables.nodes.valid) \
        | (not _on(cyc.ecfg.f_fit))


def ports_plane(tables, cyc: CycleArrays, cls: Array, ppa: Array,
                ppw: Array, ppt: Array) -> Array:
    """PodFitsHostPorts plane [B, N] incl. the plugin flag."""
    ps = tables.classes.portset[cls.long()]
    psafe = ps.clamp(min=0).long()
    conflict = port_conflict_row(
        tables.portsets.wild_words[psafe], tables.portsets.pair_words[psafe],
        tables.portsets.trip_words[psafe], ppa, ppw, ppt)
    return (ps < 0)[:, None] | ~conflict | (not _on(cyc.ecfg.f_ports))


def volumes_plane(tables, cyc: CycleArrays, cls: Array, vol_any: Array,
                  vol_rw: Array) -> Array:
    """NoDiskConflict + volume-limits plane [B, N] incl. the plugin flags."""
    vconf_free, vlimit_ok = volume_components_row(
        tables, vol_any, vol_rw, cls.long())
    return ((vconf_free | (not _on(cyc.ecfg.f_volrestrict)))
            & (vlimit_ok | (not _on(cyc.ecfg.f_vollimits))))


def mask_dynamic_row(tables, cyc: CycleArrays, cls: Array, used: Array,
                     ppa: Array, ppw: Array, ppt: Array, vol_any: Array,
                     vol_rw: Array) -> Array:
    """The Filter components that move as replicas of one class land —
    resources, host ports, volumes — over explicit state planes → [B, N].
    The per-pod scan passes the live carry; the run-collapsed engine
    (ops/runs.py) the planes after j replicas per node."""
    return (fit_plane(tables, cyc, cls, used)
            & ports_plane(tables, cyc, cls, ppa, ppw, ppt)
            & volumes_plane(tables, cyc, cls, vol_any, vol_rw))


def pod_mask_row(tables, cyc, state, cls, node_name_req, valid) -> Array:
    """Full Filter mask [B, N] against an assume-state — podFitsOnNode
    (generic_scheduler.go:628-706); each component honors its plugin flag."""
    return (mask_context_row(tables, cyc, state, cls, node_name_req, valid)
            & mask_dynamic_row(tables, cyc, cls, state.used, state.ppa,
                               state.ppw, state.ppt, state.vol_any,
                               state.vol_rw))


class ScoreContext(NamedTuple):
    """The Score components that stay fixed across a self-interaction-free
    replica run (ops/runs.py): rows whose inputs (CNT/WSYM at the terms the
    class reads) its own placements cannot move. Each [B, N]."""

    soft_ip: Array    # soft inter-pod affinity, min/max-normalized
    even_soft: Array  # EvenPodsSpread ScheduleAnyway score
    ssel: Array       # SelectorSpread score


def score_context_row(tables, cyc: CycleArrays, state: AssignState,
                      cls: Array) -> ScoreContext:
    nodes, classes, terms = tables.nodes, tables.classes, tables.terms
    D = cyc.ELD.shape[2] - 1
    cl = cls.long()
    return ScoreContext(
        soft_ip=soft_affinity_row(cl, classes, terms, state.CNT, nodes, D,
                                  TM=cyc.TM, WSYM=state.WSYM),
        even_soft=even_spread_soft_row(cl, classes, terms, state.CNT, nodes,
                                       cyc.static.node_match[cl], D),
        ssel=selector_spread_row(cl, classes, state.CNT, nodes,
                                 tables.zone_keys, D))


def score_combine_row(tables, cyc: CycleArrays, cls: Array, used: Array,
                      ctx: ScoreContext) -> Array:
    """The Score row's weighted sum over a given `used` plane, summed in
    the JAX package's order so each row rounds alike. Every engine goes
    through it — the run-collapsed engine with used-after-j-replicas
    planes — so their argmax chains are bit-equal."""
    w = cyc.ecfg
    cl = cls.long()
    least, balanced, most = resource_scores_row(
        tables.reqs.vec[tables.classes.rid[cl].long()], used,
        tables.nodes.alloc)
    return (cyc.static.score[cl] + least * w.w_least
            + balanced * w.w_balanced + most * w.w_most
            + ctx.soft_ip * w.w_interpod + ctx.even_soft * w.w_even
            + ctx.ssel * w.w_ssel)


def score_row(tables: ClusterTables, cyc: CycleArrays, state: AssignState,
              cls: Array) -> Array:
    """Full Score rows [B, N] against a live assume-state — prioritizeNodes'
    weighted sum (generic_scheduler.go:714-869)."""
    return score_combine_row(tables, cyc, cls, state.used,
                             score_context_row(tables, cyc, state, cls))


def assign_step(tables, cyc, state: AssignState, c: int, p_valid: bool,
                node_name_req: int):
    """ONE pod's Filter → Score → selectHost → assume against a live state.
    Returns (new state, node index or -1)."""
    dev = state.used.device
    cls = torch.tensor([c], dtype=torch.int64, device=dev)
    nnr = torch.tensor([node_name_req], dtype=torch.int32, device=dev)
    valid = torch.tensor([p_valid], device=dev)
    mask = pod_mask_row(tables, cyc, state, cls, nnr, valid)[0]
    score = torch.where(mask, score_row(tables, cyc, state, cls)[0], -torch.inf)
    if not bool(mask.any()):
        return state, -1
    n = int(torch.argmax(score))

    # ---- assume: commit to the state (cache.AssumePod analog) ----
    classes = tables.classes
    used = state.used.clone()
    used[n] += tables.reqs.vec[int(classes.rid[c])]
    ppa, ppw, ppt = state.ppa, state.ppw, state.ppt
    ps = int(classes.portset[c])
    if ps >= 0:
        ppa, ppw, ppt = ppa.clone(), ppw.clone(), ppt.clone()
        ppa[n] |= tables.portsets.pair_words[ps]
        ppw[n] |= tables.portsets.wild_words[ps]
        ppt[n] |= tables.portsets.trip_words[ps]
    CNT, HOLD, WSYM = state.CNT.clone(), state.HOLD.clone(), state.WSYM.clone()
    CNT[:, n] += cyc.TM[:, c].to(torch.int32)
    HOLD[:, n] += cyc.has_anti[c].to(torch.int32)
    WSYM[:, n] += cyc.WCOLS[:, c]
    vol_any, vol_rw = state.vol_any, state.vol_rw
    vs = int(classes.volset[c])
    if vs >= 0:
        vol_any, vol_rw = vol_any.clone(), vol_rw.clone()
        vol_any[n] |= tables.volsets.any_words[vs]
        vol_rw[n] |= tables.volsets.rw_words[vs]
    return AssignState(used, ppa, ppw, ppt, CNT, HOLD, WSYM,
                       vol_any, vol_rw), n


def assign_scan_plain(tables, cyc, pods: PodArrays, rows: Array,
                      init: AssignState):
    """The plain version of K4 (ops/kernels.py assign_scan): the pods
    `rows` [Q] (indices into `pods`) one at a time through assign_step,
    each against the state every earlier one left. An invalid row (a
    padding slot, a quota-clamped pod) has an empty mask, places nowhere
    and leaves the state as it was, so the loop skips it. Returns (node [P]
    int32, -1 where a pod placed nowhere or was not walked; the final
    state). Counts its calls in `assign_scan_plain.calls`."""
    with _COUNT_LOCK:
        assign_scan_plain.calls += 1
    cls = pods.cls.tolist()
    valid = pods.valid.tolist()
    nnr = pods.node_name_req.tolist()
    node = [-1] * len(cls)
    state = init
    for i in rows.tolist():
        if valid[i]:
            state, node[i] = assign_step(tables, cyc, state, cls[i], True,
                                         nnr[i])
    return (torch.tensor(node, dtype=torch.int32, device=init.used.device),
            state)


assign_scan_plain.calls = 0


def scan_rows(tables: ClusterTables, cyc: CycleArrays, pods: PodArrays,
              rows: Array, init: AssignState, scan=None):
    """`scan` (kernels.assign_scan unless the caller passes the name it
    calls it by) over the pods `rows`. K4 keeps each step's node state
    inside one thread-block cluster and cannot reduce across devices within
    a launch, so on a sharded node axis the scan is REPLICATED, not
    sharded: the node planes and the state are gathered on the lead device,
    K4 runs there once, and each shard takes its rows of the final state
    back."""
    scan = scan or assign_scan
    ax = axis.current()
    if not ax.sharded:
        return scan(tables, cyc, pods, rows, init)
    from ..parallel.mesh import gather_full, split_state

    ft, fc, fs = gather_full(tables, cyc, init)
    node, full = ax.lead(lambda: scan(ft, fc, pods, rows, fs))
    return node, split_state(full, init)


def assign_batch(tables: ClusterTables, cyc: CycleArrays, pods: PodArrays,
                 init: AssignState) -> AssignResult:
    """The sequential-assume scan (the spec): pods in queue order, each
    against the state every earlier placement left — one launch of K4 on a
    CUDA device, assign_scan_plain on the CPU. `init` is never written."""
    node, state = scan_rows(tables, cyc, pods,
                            queue_order(pods).to(torch.int32), init)
    return AssignResult(node=node, feasible=node >= 0, state=state)


# rows (classes or pods) evaluated together by the [rows, N] surfaces —
# here and in the wave engine's dense pass: bounds the [block, S, N]
# temporaries of the affinity rows (the JAX package tiles its class axis
# under lax.map for the same reason)
ROW_BLOCK = 256


def row_blocks(n: int):
    for lo in range(0, n, ROW_BLOCK):
        yield slice(lo, min(lo + ROW_BLOCK, n))


def feasible_matrix(tables, cyc, pods: PodArrays) -> Array:
    """[P, N] Filter mask for every pending pod against the initial state —
    findNodesThatFit (generic_scheduler.go:473) for all pods at once."""
    state = initial_state(tables, cyc)
    return torch.cat([
        pod_mask_row(tables, cyc, state, pods.cls[b], pods.node_name_req[b],
                     pods.valid[b])
        for b in row_blocks(pods.valid.shape[0])])


def score_matrix(tables, cyc, pods: PodArrays) -> Array:
    """[P, N] Score for every pending pod against the initial state;
    infeasible nodes score -inf (prioritizeNodes, generic_scheduler.go:
    714-869)."""
    state = initial_state(tables, cyc)
    rows = []
    for b in row_blocks(pods.valid.shape[0]):
        mask = pod_mask_row(tables, cyc, state, pods.cls[b],
                            pods.node_name_req[b], pods.valid[b])
        rows.append(torch.where(mask, score_row(tables, cyc, state, pods.cls[b]),
                                -torch.inf))
    return torch.cat(rows)


class MaskComponents(NamedTuple):
    """Per-predicate [P, N] masks for failure diagnosis — the tensor analog
    of PredicateFailureReason lists (algorithm/predicates/error.go names)."""

    node_match: Array   # MatchNodeSelector / node affinity
    taints: Array       # PodToleratesNodeTaints (incl. CheckNodeUnschedulable)
    fit: Array          # PodFitsResources
    ports: Array        # PodFitsHostPorts
    affinity: Array     # MatchInterPodAffinity (required affinity half)
    anti: Array         # MatchInterPodAffinity (anti-affinity half)
    spread: Array       # EvenPodsSpread
    host: Array         # PodFitsHost (spec.nodeName)
    volumes: Array      # NoDiskConflict + max-volume-count family


def mask_components(tables, cyc: CycleArrays, pods: PodArrays
                    ) -> MaskComponents:
    """Decomposed feasibility of every pending pod against the initial
    state, the plugin flags not applied (the JAX package's contract)."""
    state = initial_state(tables, cyc)
    nodes, classes, terms = tables.nodes, tables.classes, tables.terms
    D = cyc.ELD.shape[2] - 1
    parts = []
    for b in row_blocks(pods.valid.shape[0]):
        c = pods.cls[b].long()
        nnr = pods.node_name_req[b][:, None]
        fit = fit_row(tables.reqs.vec[classes.rid[c].long()], state.used,
                      nodes.alloc, nodes.valid)
        ps = classes.portset[c]
        psafe = ps.clamp(min=0).long()
        conflict = port_conflict_row(
            tables.portsets.wild_words[psafe],
            tables.portsets.pair_words[psafe],
            tables.portsets.trip_words[psafe], state.ppa, state.ppw,
            state.ppt)
        aff_ok, anti_ok = affinity_rows(c, classes, terms, cyc.TM, state.CNT,
                                        state.HOLD, nodes, D)
        nm = cyc.static.node_match[c]
        parts.append((
            nm & pods.valid[b][:, None],
            # static.mask = node_match ∧ taint_ok ∧ unsched_pass ∧ class
            # valid: the taint/unschedulable part by division
            cyc.static.mask[c] | ~nm,
            fit, (ps < 0)[:, None] | ~conflict, aff_ok, anti_ok,
            spread_row(c, classes, terms, cyc.TM, state.CNT, cyc.ELD, nm,
                       nodes, D),
            (nnr < 0) | (nodes.name_id[None, :] == nnr),
            volume_ok_row(tables, state.vol_any, state.vol_rw, c)))
    return MaskComponents(*(torch.cat(f) for f in zip(*parts)))


# --------------------------------------------------------------------------- #
# decision provenance: per-pod unschedulability attribution and the winning
# score's decomposition, as reductions over the mask/score expressions the
# engines evaluate (the JAX package's ops/assign.py explain section)
# --------------------------------------------------------------------------- #

#: predicate order of ExplainResult.reasons — the PredicateFailureReason
#: names sched/explain.py renders (algorithm/predicates/error.go)
EXPLAIN_PREDICATES = ("node_match", "taints", "fit", "ports", "affinity",
                      "anti", "spread", "host", "volumes")
#: score-component order of ExplainResult.score_parts (prioritizeNodes'
#: weighted sum, decomposed)
EXPLAIN_SCORE_COMPONENTS = ("static", "least", "balanced", "most",
                            "interpod", "even", "ssel")
#: candidate nodes reported per pod (clamped to N)
EXPLAIN_TOPK = 3


class ExplainResult(NamedTuple):
    """Per-pod decision attribution for one wave against the POST-wave
    assume state: why each pod is pending now. Counts are over valid nodes;
    invalid (padding) pods zero out."""

    reasons: Array         # [P, 9] i32 — nodes rejected per predicate
    valid_nodes: Array     # [P] i32 — "0/N nodes are available"
    feasible_nodes: Array  # [P] i32 — nodes passing every predicate
    rejected_any: Array    # [P] i32 — valid_nodes - feasible_nodes
    top_nodes: Array       # [P, K] i32 — best feasible nodes (-1 pad)
    top_scores: Array      # [P, K] f32
    score_parts: Array     # [P, 7] f32 — component breakdown at part_node
    part_node: Array       # [P] i32 — chosen node if scheduled, else the
    #                        best feasible node, else -1


def _explain_mask_row(tables, cyc: CycleArrays, state: AssignState,
                      c: Array):
    """Attribution's cheap half for classes `c` [B] against `state`: the 8
    class-granular predicate planes reduced to rejected-node counts [B, 8]
    (spec.nodeName, per pod, is folded by the caller) and the mask [B, N].
    Each plane honors its plugin flag as pod_mask_row composes it, so the
    counts reconcile with the engines' verdicts."""
    nodes, classes, terms = tables.nodes, tables.classes, tables.terms
    ecfg = cyc.ecfg
    D = cyc.ELD.shape[2] - 1
    cl = c.long()
    nm = cyc.static.node_match[cl]
    aff_ok, anti_ok = affinity_rows(cl, classes, terms, cyc.TM, state.CNT,
                                    state.HOLD, nodes, D)
    off_interpod = not _on(ecfg.f_interpod)
    planes = torch.stack([
        nm, cyc.static.mask[cl] | ~nm,
        fit_plane(tables, cyc, cl, state.used),
        ports_plane(tables, cyc, cl, state.ppa, state.ppw, state.ppt),
        aff_ok | off_interpod, anti_ok | off_interpod,
        spread_row(cl, classes, terms, cyc.TM, state.CNT, cyc.ELD, nm,
                   nodes, D) | (not _on(ecfg.f_spread)),
        volumes_plane(tables, cyc, cl, state.vol_any, state.vol_rw),
    ], 1)                                                    # [B, 8, N]
    nv = nodes.valid
    reasons8 = (nv & ~planes).sum(-1, dtype=torch.int32)
    return reasons8, planes.all(1) & nv


def _explain_score_row(tables, cyc: CycleArrays, state: AssignState,
                       c: Array):
    """Attribution's expensive half for classes `c` [B]: the composed score
    rows [B, N] and the context components [B, 3, N] (soft inter-pod
    affinity, even spread, selector spread)."""
    ctx = score_context_row(tables, cyc, state, c)
    score = score_combine_row(tables, cyc, c, state.used, ctx)
    return score, torch.stack([ctx.soft_ip, ctx.even_soft, ctx.ssel], 1)


def _row_topk(masked: Array, K: int):
    """Top-K (node, score) of each masked score row [B, N] by K argmax
    passes — the engines' tie-break, the first index — where torch.topk's
    order among ties differs. Dead slots (-inf: fewer than K feasible
    nodes) report node -1 and score 0."""
    iota = torch.arange(masked.shape[1], device=masked.device)
    tops, topi = [], []
    cur = masked
    for _ in range(K):
        i = torch.argmax(cur, dim=1)
        tops.append(cur.gather(1, i[:, None])[:, 0])
        topi.append(i)
        cur = torch.where(iota == i[:, None], -torch.inf, cur)
    tops_t, topi_t = torch.stack(tops, 1), torch.stack(topi, 1)
    live = tops_t > -torch.inf
    return (torch.where(live, topi_t.to(torch.int32), -1),
            torch.where(live, tops_t, 0.0))


def explain_assignments(tables, cyc: CycleArrays, pods: PodArrays,
                        result: AssignResult, granularity: str = "class"
                        ) -> ExplainResult:
    """The attribution reduction for one wave against result.state. Two
    granularities, bit-equal by shared code: "pod" evaluates a row per pod
    (the scan's); "class" evaluates each class once and gathers per pod,
    with the per-pod host fold only when a pinned (spec.nodeName) pod is in
    the batch. The reason counts always run; the score decomposition
    (ranking and per-component parts, an extra score pass) only when some
    pod failed — the JAX package's failure-gated lax.cond, a host branch
    here."""
    state, chosen = result.state, result.node
    nodes = tables.nodes
    nv = nodes.valid
    SC = tables.classes.valid.shape[0]
    P = pods.valid.shape[0]
    dev = nv.device
    i32 = torch.int32
    K = min(EXPLAIN_TOPK, int(nv.shape[0]))
    cls_safe = pods.cls.clamp(0, SC - 1).long()
    validn = nv.sum(dtype=i32)
    any_failed = bool(((chosen < 0) & pods.valid).any())
    pinned = bool(((pods.node_name_req >= 0) & pods.valid).any())
    off_name = not _on(cyc.ecfg.f_name)

    def host_plane(nnr):  # [B] → [B, N]
        return (nnr[:, None] < 0) | (nodes.name_id[None, :] == nnr[:, None]) \
            | off_name

    def fold(r8, m8, nnr):
        # spec.nodeName: the 8th reason and the per-pod mask
        host_ok = host_plane(nnr)
        host_rej = (nv & ~host_ok).sum(1, dtype=i32)
        reasons = torch.cat([r8[:, :7], host_rej[:, None], r8[:, 7:]], 1)
        full = m8 & host_ok
        return reasons, full.sum(1, dtype=i32), full

    def parts_stage(pn, ctx_at):
        """The score decomposition at the explained node ([P] gathers and
        the pointwise resource scores)."""
        w = cyc.ecfg
        j = pn.clamp(min=0).long()
        req = tables.reqs.vec[tables.classes.rid[cls_safe].long()]  # [P, R]
        least, balanced, most = resource_scores(state.used[j] + req,
                                                nodes.alloc[j])
        parts = torch.stack([
            cyc.static.score[cls_safe, j], least * w.w_least,
            balanced * w.w_balanced, most * w.w_most,
            ctx_at[:, 0] * w.w_interpod, ctx_at[:, 1] * w.w_even,
            ctx_at[:, 2] * w.w_ssel], 1)                         # [P, 7]
        return torch.where((pn >= 0)[:, None], parts, 0.0)

    if granularity == "pod":
        reasons, feas, topn, tops, ctx_at = [], [], [], [], []
        for b in row_blocks(P):
            c = cls_safe[b]
            r8, m8 = _explain_mask_row(tables, cyc, state, c)
            r, f, full = fold(r8, m8, pods.node_name_req[b])
            reasons.append(r)
            feas.append(f)
            if any_failed:
                sc, cx = _explain_score_row(tables, cyc, state, c)
                tn, ts = _row_topk(torch.where(full, sc, -torch.inf), K)
                pn_b = torch.where(chosen[b] >= 0, chosen[b], tn[:, 0])
                topn.append(tn)
                tops.append(ts)
                ctx_at.append(cx[torch.arange(len(c), device=dev), :,
                                 pn_b.clamp(min=0).long()])
        reasons, feas = torch.cat(reasons), torch.cat(feas)
        if any_failed:
            topn, tops = torch.cat(topn), torch.cat(tops)
            ctx_at = torch.cat(ctx_at)
    else:
        r8, m8 = (torch.cat(x) for x in zip(*(
            _explain_mask_row(tables, cyc, state,
                              torch.arange(b.start, b.stop, device=dev))
            for b in row_blocks(SC))))
        if pinned:
            reasons, feas, _ = fold(r8[cls_safe], m8[cls_safe],
                                    pods.node_name_req)
        else:
            # no pinned pod: the host plane is all true, so the class-level
            # reductions are the per-pod answers
            reasons = torch.cat([r8[:, :7], torch.zeros((SC, 1), dtype=i32,
                                                        device=dev),
                                 r8[:, 7:]], 1)[cls_safe]
            feas = m8.sum(1, dtype=i32)[cls_safe]
        if any_failed:
            sc, cx = (torch.cat(x) for x in zip(*(
                _explain_score_row(tables, cyc, state,
                                   torch.arange(b.start, b.stop, device=dev))
                for b in row_blocks(SC))))
            if pinned:
                full = m8[cls_safe] & host_plane(pods.node_name_req)
                topn, tops = _row_topk(
                    torch.where(full, sc[cls_safe], -torch.inf), K)
            else:
                topn, tops = (x[cls_safe] for x in _row_topk(
                    torch.where(m8, sc, -torch.inf), K))
            pn = torch.where(chosen >= 0, chosen, topn[:, 0])
            ctx_at = cx[cls_safe, :, pn.clamp(min=0).long()]
    if any_failed:
        pn = torch.where(chosen >= 0, chosen, topn[:, 0])
        parts = parts_stage(pn, ctx_at)
    else:
        # a wave with nothing to explain: no candidates, zeroed parts
        topn = torch.full((P, K), -1, dtype=i32, device=dev)
        tops = torch.zeros((P, K), device=dev)
        parts = torch.zeros((P, len(EXPLAIN_SCORE_COMPONENTS)), device=dev)
        pn = torch.where(chosen >= 0, chosen, -1)

    # invalid (padding) pods zero out across the board
    v = pods.valid
    vi, vf = v.to(i32), v.float()
    return ExplainResult(
        reasons=reasons * vi[:, None],
        valid_nodes=validn * vi,
        feasible_nodes=feas * vi,
        rejected_any=(validn - feas) * vi,
        top_nodes=torch.where(v[:, None], topn, -1),
        top_scores=tops * vf[:, None],
        score_parts=parts * vf[:, None],
        part_node=torch.where(v, pn, -1).to(i32))


def initial_state(tables: ClusterTables, cyc: CycleArrays) -> AssignState:
    n = tables.nodes
    return AssignState(
        used=n.used, ppa=n.port_pair_any, ppw=n.port_pair_wild,
        ppt=n.port_triple, CNT=cyc.CNT, HOLD=cyc.HOLD, WSYM=cyc.WSYM,
        vol_any=n.vol_any, vol_rw=n.vol_rw,
    )
