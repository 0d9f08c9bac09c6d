"""Score components beyond the resource/affinity basics (port of the JAX
package's ops/scores.py):

  * symmetric preferred inter-pod affinity weighting (interpod_affinity.go:
    119-215);
  * EvenPodsSpread score for ScheduleAnyway constraints
    (priorities/even_pods_spread.go:106,139,175);
  * SelectorSpread (priorities/selector_spreading.go:58-165, zoneWeighting
    2/3);
  * ImageLocality (priorities/image_locality.go:39-92).

Row functions take class ids `cls` [B] and return [B, N] rows.
"""

from __future__ import annotations

import torch

from ..state.arrays import (
    Array,
    ClusterTables,
    NodeArrays,
    PodArrays,
    PodClassTable,
    TermTable,
)
from .interpod import _at_domain, domain_agg, domain_of_term

MAX_NODE_SCORE = 100.0

# hardPodAffinitySymmetricWeight default (apis/config/types.go:45-112)
DEFAULT_HARD_POD_AFFINITY_WEIGHT = 1

# image size thresholds (image_locality.go:33-35), converted to KiB
IMG_MIN_KIB = 23 * 1024
IMG_MAX_KIB = 1000 * 1024

# selector_spreading.go:33 — zone score weight when zone info is present
ZONE_WEIGHTING = 2.0 / 3.0


def symmetric_weight_cols(
    classes: PodClassTable, S: int,
    hard_weight: float = DEFAULT_HARD_POD_AFFINITY_WEIGHT,
) -> Array:
    """WCOLS [S, SC] f32: the signed symmetric-preference weight an existing
    pod of class c contributes through term s: +w preferred affinity, −w
    preferred anti-affinity, +hard_weight required affinity
    (interpod_affinity.go:156-185)."""
    SC = classes.valid.shape[0]
    dev = classes.valid.device
    cols = torch.arange(SC, device=dev)[None, :]

    def scatter(term_ids, w):  # [SC, A], [SC, A] → [S, SC]
        rows = torch.where(term_ids >= 0, term_ids, S).T.long()
        val = torch.where(term_ids >= 0, w, 0).float().T
        add = torch.zeros((S + 1, SC), dtype=torch.float32, device=dev)
        add.index_put_((rows, cols.expand_as(rows)), val, accumulate=True)
        return add[:S]

    out = torch.zeros((S, SC), dtype=torch.float32, device=dev)
    out = out + scatter(classes.paff_terms, classes.paff_w)
    out = out - scatter(classes.panti_terms, classes.panti_w)
    hard = scatter(classes.aff_terms, torch.ones_like(classes.aff_terms))
    out = out + hard * float(hard_weight)
    return out * classes.valid[None, :]


def weighted_per_node(WCOLS: Array, pods: PodArrays, N: int) -> Array:
    """WSYM seed [S, N] f32: Σ over existing pods of their class's signed
    symmetric weights, scattered by node (processExistingPod,
    interpod_affinity.go:124-185)."""
    per_e = WCOLS[:, pods.cls.clamp(min=0).long()]        # [S, E]
    on_node = (pods.node_id >= 0) & pods.valid
    per_e = torch.where(on_node[None, :], per_e, 0.0)
    idx = torch.where(on_node, pods.node_id, N).long()
    S = WCOLS.shape[0]
    out = torch.zeros((S, N + 1), dtype=torch.float32, device=WCOLS.device)
    out.scatter_add_(1, idx[None, :].expand(S, -1), per_e)
    return out[:, :N]


def sym_affinity_contrib(
    cls: Array, TM: Array, WSYM: Array, terms: TermTable, nodes: NodeArrays,
    D: int,
) -> Array:
    """[B, N] f32 raw symmetric contribution: for every term s a class
    matches, credit every node sharing the topology domain of a contributing
    existing pod (interpod_affinity.go:87-117)."""
    dom, has_key = domain_of_term(nodes, terms.topo_key)  # [S, N]
    per_term = _at_domain(domain_agg(WSYM, dom, D), dom, D)
    credit = torch.where(TM[:, cls.long()].T[:, :, None] & has_key[None],
                         per_term[None], 0.0)             # [B, S, N]
    return credit.sum(1)


def even_spread_soft_row(
    cls: Array, classes: PodClassTable, terms: TermTable, CNT: Array,
    nodes: NodeArrays, node_match_row: Array, D: int,
) -> Array:
    """[B, N] f32 0..100: EvenPodsSpread score over ScheduleAnyway
    constraints (even_pods_spread.go:106-227), normalized inverted
    (total−raw)/(total−min); ineligible nodes score 0."""
    cl = cls.long()
    s_ids = classes.tsc_term[cl]                       # [B, TS]
    s = s_ids.clamp(min=0).long()
    soft = (s_ids >= 0) & ~classes.tsc_hard[cl]

    dom, has_key = domain_of_term(nodes, terms.topo_key[s])  # [B, TS, N]
    seg = domain_agg(CNT[s], dom, D, eligible=node_match_row[:, None, :])
    cnt = _at_domain(seg, dom, D)
    raw = torch.where(soft[..., None] & has_key, cnt, 0).sum(1)  # [B, N]

    elig = (node_match_row & nodes.valid
            & (~soft[..., None] | has_key).all(1))
    any_soft = soft.any(1, keepdim=True)
    rawf = raw.float()
    total = torch.where(elig, rawf, 0.0).sum(-1, keepdim=True)
    mn = torch.where(elig, rawf, torch.inf).amin(-1, keepdim=True)
    denom = total - torch.where(torch.isinf(mn), 0.0, mn)
    score = torch.where(
        denom > 0,
        MAX_NODE_SCORE * (total - rawf) / torch.clamp(denom, min=1e-9),
        MAX_NODE_SCORE)
    return torch.where(any_soft & elig, score, 0.0)


def selector_spread_row(
    cls: Array, classes: PodClassTable, CNT: Array, nodes: NodeArrays,
    zone_keys: Array, D: int,
) -> Array:
    """[B, N] f32 0..100: SelectorSpread (selector_spreading.go:62-165):
    100·(maxCount−count)/maxCount per node, blended 1/3:2/3 with the same
    statistic by zone when zone labels exist."""
    s_ids = classes.ssel_terms[cls.long()]             # [B, SS]
    s = s_ids.clamp(min=0).long()
    cnt = torch.where((s_ids >= 0)[..., None], CNT[s], 0).sum(1)  # [B, N]
    cntf = cnt.float()
    has_sel = (s_ids >= 0).any(1, keepdim=True)

    valid = nodes.valid
    max_n = torch.where(valid, cntf, 0.0).amax(-1, keepdim=True)
    node_score = torch.where(
        max_n > 0, MAX_NODE_SCORE * (max_n - cntf) / max_n, MAX_NODE_SCORE)

    # zone aggregation: modern zone label wins, legacy fills the gaps; the
    # two keys' compact domains live in disjoint halves of a 2D+1 bucket
    def zdom_of(kslot):
        k = zone_keys[kslot]
        col = nodes.domain[:, k.clamp(min=0).long()]
        return torch.where((k >= 0) & valid, col, -1)

    z0, z1 = zdom_of(0), zdom_of(1)
    zdom = torch.where(z0 >= 0, z0, torch.where(z1 >= 0, D + z1, -1))  # [N]
    has_zone = zdom >= 0
    idx = torch.where(has_zone, zdom, 2 * D).long()
    zcounts = torch.zeros((cntf.shape[0], 2 * D + 1), dtype=torch.float32,
                          device=cntf.device)
    zcounts.scatter_add_(1, idx[None, :].expand_as(cntf),
                         torch.where(has_zone, cntf, 0.0))
    zcnt = zcounts[:, idx]                                # [B, N]
    max_z = zcounts[:, : 2 * D].amax(-1, keepdim=True)
    zone_score = torch.where(
        max_z > 0, MAX_NODE_SCORE * (max_z - zcnt) / max_z, MAX_NODE_SCORE)
    have_zones = has_zone.any()

    blended = torch.where(
        have_zones & has_zone,
        node_score * (1.0 - ZONE_WEIGHTING) + ZONE_WEIGHTING * zone_score,
        node_score)
    return torch.where(has_sel & valid, blended, 0.0)


def image_locality_static(tables: ClusterTables) -> Array:
    """[SC, N] f32 0..100: ImageLocality (image_locality.go:39-92):
    Σ_{img ∈ class} present·size·(nodesWithImage/totalNodes), clamped to
    [23MiB, 1000MiB] then scaled. Static per cycle."""
    nodes, classes, images = tables.nodes, tables.classes, tables.images
    img_ids = classes.img_ids                      # [SC, CI]
    has_img = img_ids >= 0
    safe = img_ids.clamp(min=0)
    words = nodes.img_words[:, (safe >> 5).long()]  # [N, SC, CI]
    bits = ((words >> (safe & 31)[None]) & 1).to(torch.int32)
    bits = bits * nodes.valid[:, None, None]
    present = bits.bool().permute(1, 2, 0) & has_img[..., None]  # [SC, CI, N]

    total_nodes = torch.clamp(nodes.valid.sum(dtype=torch.int32), min=1).float()
    num_nodes = bits.sum(0, dtype=torch.int32) * has_img         # [SC, CI]
    spread = num_nodes.float() / total_nodes
    size = images.size_kib[safe.long()].float() * has_img
    scaled = size * spread                                       # [SC, CI]
    sums = (present * scaled[..., None]).sum(1)                  # [SC, N]
    clamped = torch.clamp(sums, IMG_MIN_KIB, IMG_MAX_KIB)
    return (MAX_NODE_SCORE * (clamped - IMG_MIN_KIB)
            / float(IMG_MAX_KIB - IMG_MIN_KIB))
