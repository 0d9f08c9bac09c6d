"""PodTopologySpread (EvenPodsSpread) as tensor ops (port of the JAX package's
ops/topospread.py).

EvenPodsSpreadPredicate (predicates.go:1643-1703) with metadata
(metadata.go:114-176): for each hard (DoNotSchedule) constraint,
  skew = matchNum(node's domain) + selfMatch − minMatchNum  must be ≤ maxSkew,
counting only pods on nodes eligible for the incoming pod, with the minimum
over eligible domains. A node lacking the key fails; a pod whose
eligible-domain map is empty passes everywhere (predicates.go:1661-1663).
"""

from __future__ import annotations

import torch

from ..state.arrays import Array, NodeArrays, PodClassTable, TermTable
from .interpod import _at_domain, domain_agg, domain_of_term

I32_MAX = 2**31 - 1


def eligible_domains(
    node_match: Array,     # [SC, N] — nodeSelector ∧ node-affinity only
    classes: PodClassTable,
    nodes: NodeArrays,
    D: int,
) -> Array:
    """ELD [SC, TS, D+1] bool: domains (of each constraint's key) containing
    at least one node eligible for the class (metadata.go:145-151)."""
    SC, TS = classes.tsc_key.shape
    N = node_match.shape[1]
    k = classes.tsc_key.clamp(min=0).long()
    dom = nodes.domain.T[k]                                # [SC, TS, N]
    ok = (node_match[:, None, :] & (dom >= 0)
          & (classes.tsc_key >= 0)[..., None] & nodes.valid)
    idx = torch.where(ok, dom, D).long().reshape(SC * TS, N)
    eld = torch.zeros((SC * TS, D + 1), dtype=torch.int32,
                      device=node_match.device)
    eld.scatter_reduce_(1, idx, ok.reshape(SC * TS, N).to(torch.int32),
                        reduce="amax", include_self=True)
    return eld.reshape(SC, TS, D + 1) > 0


def spread_row(
    cls: Array,            # [B] class ids
    classes: PodClassTable,
    terms: TermTable,
    TM: Array,             # [S, SC]
    CNT_node: Array,       # [S, N] live per-node match counts
    ELD: Array,            # [SC, TS, D+1]
    node_match_row: Array, # [B, N] — each class's selector/affinity eligibility
    nodes: NodeArrays,
    D: int,
) -> Array:
    """[B, N] bool: all hard spread constraints satisfied on each node."""
    cl = cls.long()
    s_ids = classes.tsc_term[cl]                       # [B, TS]
    s = s_ids.clamp(min=0).long()
    hard = classes.tsc_hard[cl] & (s_ids >= 0)
    skew_max = classes.tsc_maxskew[cl]

    dom, has_key = domain_of_term(nodes, terms.topo_key[s])  # [B, TS, N]
    seg = domain_agg(CNT_node[s], dom, D,
                     eligible=node_match_row[:, None, :])    # [B, TS, D+1]
    cnt = _at_domain(seg, dom, D)

    eld = ELD[cl]                                      # [B, TS, D+1]
    any_eligible = eld[..., :D].any(-1)
    min_cnt = torch.where(eld[..., :D], seg[..., :D], I32_MAX).amin(-1)
    self_match = TM[s, cl[:, None]]                    # [B, TS]

    skew = cnt + self_match.to(torch.int32)[..., None] - min_cnt[..., None]
    ok = has_key & (skew <= skew_max[..., None])
    per_constraint = torch.where((hard & any_eligible)[..., None], ok, True)
    return per_constraint.all(1)
