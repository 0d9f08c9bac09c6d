"""Per-pod sequential assignment and the Filter/Score rows both engines share
(port of the main-path half of the JAX package's ops/assign.py).

The reference schedules one pod per `scheduleOne` call (scheduler.go:596-763):
filter → score → selectHost → assume, each placement visible to the next pod.
`assign_batch` reproduces that literally, as a host loop of `assign_step` in
queue order (priority desc, creation asc — scheduling_queue.go:119-138). It is
the executable spec the wave engine is held against, and it serves batches
with a `spec.nodeName` pod.

The row functions take a vector of class ids `cls` [B] and return [B, N]
rows (the JAX package vmaps the same per-class rows over classes). Ties in
the max score pick the lowest node index (docs/PARITY.md).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..state.arrays import Array, ClusterTables, PodArrays
from .fit import fit_row, resource_scores_row
from .interpod import affinity_rows, soft_affinity_row
from .lattice import CycleArrays, _on
from .ports import port_conflict_row
from .scores import even_spread_soft_row, selector_spread_row
from .topospread import spread_row
from .volumes import volume_components_row

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


def mask_dynamic_row(tables, cyc: CycleArrays, cls: Array, state: AssignState) -> Array:
    """The Filter components that move as replicas of one class land:
    resources, host ports, volumes → [B, N]."""
    classes, ecfg = tables.classes, cyc.ecfg
    cl = cls.long()
    fit = fit_row(tables.reqs.vec[classes.rid[cl].long()], state.used,
                  tables.nodes.alloc, tables.nodes.valid) | (not _on(ecfg.f_fit))
    ps = classes.portset[cl]
    psafe = ps.clamp(min=0).long()
    conflict = port_conflict_row(
        tables.portsets.wild_words[psafe], tables.portsets.pair_words[psafe],
        tables.portsets.trip_words[psafe], state.ppa, state.ppw, state.ppt)
    ports = (ps < 0)[:, None] | ~conflict | (not _on(ecfg.f_ports))
    vconf_free, vlimit_ok = volume_components_row(
        tables, state.vol_any, state.vol_rw, cl)
    vols = ((vconf_free | (not _on(ecfg.f_volrestrict)))
            & (vlimit_ok | (not _on(ecfg.f_vollimits))))
    return fit & ports & vols


def pod_mask_row(tables, cyc, state, cls, node_name_req, valid) -> Array:
    """Full Filter mask [B, N] against an assume-state — podFitsOnNode
    (generic_scheduler.go:628-706); each component honors its plugin flag."""
    return (mask_context_row(tables, cyc, state, cls, node_name_req, valid)
            & mask_dynamic_row(tables, cyc, cls, state))


def score_row(tables: ClusterTables, cyc: CycleArrays, state: AssignState,
              cls: Array) -> Array:
    """Full Score rows [B, N] against a live assume-state — prioritizeNodes'
    weighted sum (generic_scheduler.go:714-869), summed in the JAX package's
    order so each row rounds alike."""
    nodes, classes, terms = tables.nodes, tables.classes, tables.terms
    D = cyc.ELD.shape[2] - 1
    w = cyc.ecfg
    cl = cls.long()
    soft_ip = soft_affinity_row(cl, classes, terms, state.CNT, nodes, D,
                                TM=cyc.TM, WSYM=state.WSYM)
    even_soft = even_spread_soft_row(cl, classes, terms, state.CNT, nodes,
                                     cyc.static.node_match[cl], D)
    ssel = selector_spread_row(cl, classes, state.CNT, nodes,
                               tables.zone_keys, D)
    least, balanced, most = resource_scores_row(
        tables.reqs.vec[classes.rid[cl].long()], state.used, nodes.alloc)
    return (cyc.static.score[cl] + least * w.w_least
            + balanced * w.w_balanced + most * w.w_most
            + soft_ip * w.w_interpod + even_soft * w.w_even
            + ssel * w.w_ssel)


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


def assign_batch(tables: ClusterTables, cyc: CycleArrays, pods: PodArrays,
                 init: AssignState) -> AssignResult:
    """The sequential-assume scan (the spec): pods in queue order, each
    against the state every earlier placement left."""
    order = queue_order(pods).tolist()
    cls = pods.cls.tolist()
    valid = pods.valid.tolist()
    nnr = pods.node_name_req.tolist()
    P = len(cls)
    node = [-1] * P
    state = init
    for i in order:
        state, node[i] = assign_step(tables, cyc, state, cls[i], valid[i],
                                     nnr[i])
    node_t = torch.tensor(node, dtype=torch.int32, device=init.used.device)
    return AssignResult(node=node_t, feasible=node_t >= 0, state=state)


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


def initial_state(tables: ClusterTables, cyc: CycleArrays) -> AssignState:
    n = tables.nodes
    return AssignState(
        used=n.used, ppa=n.port_pair_any, ppw=n.port_pair_wild,
        ppt=n.port_triple, CNT=cyc.CNT, HOLD=cyc.HOLD, WSYM=cyc.WSYM,
        vol_any=n.vol_any, vol_rw=n.vol_rw,
    )
