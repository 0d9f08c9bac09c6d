"""Inter-pod affinity/anti-affinity as tensor ops over interned terms (port of
the JAX package's ops/interpod.py, which documents the design: terms are
interned, matching factors through label-set classes as TM[S, SC], and live
state is per-NODE counts CNT[S, N] / HOLD[S, N] aggregated over topology
domains on demand).

The row functions take a vector of class ids `cls` [B] and return [B, N]
rows: the JAX package vmaps the same per-class rows over classes.

Predicate semantics (satisfiesPodsAffinityAntiAffinity, predicates.go:
1421-1520): affinity needs every term's domain count > 0 (with the first-pod
escape, :1436-1440); anti-affinity needs no matching pod in-domain; existing
pods' anti-affinity blocks by symmetry (:1319-1360).
"""

from __future__ import annotations

import torch

from ..parallel import axis
from ..state.arrays import (
    Array,
    LabelSetTable,
    NodeArrays,
    PodArrays,
    PodClassTable,
    TermTable,
)
from .labels import ns_bit, term_labelset_matrix


def term_class_matrix(
    terms: TermTable, labelsets: LabelSetTable, classes: PodClassTable
) -> Array:
    """TM [S, SC] bool: term s (selector ∧ namespaces) matches pod-class c."""
    M = term_labelset_matrix(terms, labelsets)          # [S, SL]
    sel = M[:, classes.labelset.clamp(min=0).long()]    # [S, SC]
    nsok = ns_bit(terms.ns_words[:, None, :], classes.ns[None, :])  # [S, SC]
    return sel & nsok & classes.valid[None, :] & terms.valid[:, None]


def class_term_membership(term_ids: Array, S: int) -> Array:
    """[SC, A] term-id slots → [SC, S] multi-hot membership (-1 pads dropped)."""
    s = torch.arange(S, device=term_ids.device)
    hot = (term_ids[..., None] == s) & (term_ids[..., None] >= 0)
    return hot.any(dim=1)


def per_node_counts(TM_or_membership: Array, pods: PodArrays, N: int) -> Array:
    """[S, SC] term-matches-class, scattered by each existing pod's node →
    [S, N] i32 counts of matching existing pods per node. On a sharded
    node axis N is the shard's row count and only its own nodes' pods
    count."""
    vals = TM_or_membership
    S = vals.shape[0]
    row, inside = axis.current().local_rows(pods.node_id, N)
    on_node = inside & pods.valid
    per_e = vals[:, pods.cls.clamp(min=0).long()] & on_node[None, :]  # [S, E]
    idx = torch.where(on_node, row, N).long()[None, :].expand(S, -1)
    out = torch.zeros((S, N + 1), dtype=torch.int32, device=vals.device)
    out.scatter_add_(1, idx, per_e.to(torch.int32))
    return out[:, :N]


def domain_of_term(nodes: NodeArrays, topo_key: Array) -> tuple[Array, Array]:
    """topo_key: [...] → (dom [..., N] compact domain index with -1 absent,
    has_key [..., N])."""
    k = topo_key.clamp(min=0).long()
    dom = nodes.domain.T[k]                                   # [..., N]
    dom = torch.where((topo_key[..., None] >= 0) & nodes.valid, dom, -1)
    return dom, dom >= 0


def domain_agg(cnt_rows: Array, dom: Array, D: int, eligible=None) -> Array:
    """Aggregate per-node counts over topology domains: [..., N] → [..., D+1]
    (slot D is the discard bucket). Optionally restrict to eligible nodes.
    Integer rows sum exactly; f32 rows hold integer weights here, so the
    atomic order of a CUDA scatter-add does not change them — nor does the
    cross-shard sum of a sharded node axis, which adds the shards' domain
    partials."""
    vals = cnt_rows
    if eligible is not None:
        vals = torch.where(eligible, vals, 0)
    idx = torch.where(dom >= 0, dom, D).long()
    vals, idx = torch.broadcast_tensors(vals, idx)
    seg = torch.zeros(vals.shape[:-1] + (D + 1,), dtype=vals.dtype,
                      device=vals.device)
    return axis.current().all_reduce(seg.scatter_add_(-1, idx, vals), "sum")


def _at_domain(seg: Array, dom: Array, D: int) -> Array:
    """Gather each node's domain aggregate back: [..., D+1] → [..., N]."""
    return torch.gather(seg, -1, torch.where(dom >= 0, dom, D).long())


def affinity_rows(
    cls: Array, classes: PodClassTable, terms: TermTable, TM: Array,
    CNT_node: Array, HOLD_node: Array, nodes: NodeArrays, D: int,
) -> tuple[Array, Array]:
    """(affinity_ok [B, N], anti_ok [B, N]) for classes `cls` [B] against
    live counts."""
    cl = cls.long()

    # --- required affinity (:1431-1444) ---
    ats = classes.aff_terms[cl]                         # [B, AT]
    s = ats.clamp(min=0).long()
    dom, has_key = domain_of_term(nodes, terms.topo_key[s])  # [B, AT, N]
    cnt = _at_domain(domain_agg(CNT_node[s], dom, D), dom, D)
    term_ok = has_key & (cnt > 0)
    active = ats >= 0
    all_terms = (~active[..., None] | term_ok).all(1)   # [B, N]
    total = axis.current().sum(
        torch.where(active[..., None] & has_key, CNT_node[s], 0), (1, 2))
    self_all = (~active | TM[s, cl[:, None]]).all(1)
    escape = (total == 0) & self_all
    has_any = active.any(1)
    aff_ok = (~has_any | escape)[:, None] | all_terms

    # --- incoming pod's anti-affinity (:1447-1456) ---
    ans = classes.anti_terms[cl]                        # [B, AN]
    sa = ans.clamp(min=0).long()
    dom_a, has_key_a = domain_of_term(nodes, terms.topo_key[sa])
    cnt_a = _at_domain(domain_agg(CNT_node[sa], dom_a, D), dom_a, D)
    blocked_own = ((ans >= 0)[..., None] & has_key_a & (cnt_a > 0)).any(1)

    # --- existing pods' anti-affinity symmetry (:1319-1360) ---
    dom_s, _ = domain_of_term(nodes, terms.topo_key)    # [S, N]
    hold = _at_domain(domain_agg(HOLD_node, dom_s, D), dom_s, D)
    held = (dom_s >= 0) & (hold > 0)                    # [S, N]
    blocked_sym = (TM[:, cl].T[:, :, None] & held[None]).any(1)  # [B, N]

    return aff_ok, ~(blocked_own | blocked_sym)


def soft_affinity_row(
    cls: Array, classes: PodClassTable, terms: TermTable, CNT_node: Array,
    nodes: NodeArrays, D: int, TM=None, WSYM=None,
) -> Array:
    """Preferred inter-pod (anti)affinity score [B, N] f32, 0..100 after
    min/max normalization (interpod_affinity.go:119-215), both directions
    summed into the raw counts before normalization."""
    cl = cls.long()

    def contrib(term_slots: Array, weights: Array, sign: float) -> Array:
        s = term_slots.clamp(min=0).long()
        dom, has_key = domain_of_term(nodes, terms.topo_key[s])
        cnt = _at_domain(domain_agg(CNT_node[s], dom, D), dom, D)
        w = torch.where(term_slots >= 0, weights, 0).float()
        return sign * (w[..., None] * torch.where(has_key, cnt, 0)).sum(1)

    raw = contrib(classes.paff_terms[cl], classes.paff_w[cl], 1.0) + contrib(
        classes.panti_terms[cl], classes.panti_w[cl], -1.0)
    if TM is not None and WSYM is not None:
        from .scores import sym_affinity_contrib

        raw = raw + sym_affinity_contrib(cl, TM, WSYM, terms, nodes, D)
    ax = axis.current()
    lo = ax.amin(torch.where(nodes.valid, raw, torch.inf), -1, keepdim=True)
    hi = ax.amax(torch.where(nodes.valid, raw, -torch.inf), -1, keepdim=True)
    return torch.where(
        hi > lo, 100.0 * (raw - lo) / torch.clamp(hi - lo, min=1e-9), 0.0)
