"""Preemption as a batched device what-if (port of the JAX package's
ops/preempt.py, whose docstring sets out the reference semantics: the
five-criteria node choice of pickOneNodeForPreemption, the PDB-aware
reprieve order, and the documented conservatism of the reblock bits).

The JAX package vmaps `preempt_for_pod` over the B preemptor lanes of a
burst. Here the lanes are a leading [B] axis. The term counts with every
potential victim removed (CNT_wo, HOLD_wo) and the affinity and spread
rows built from them depend on the lane only through its priority, so they
are computed once per distinct priority in the burst. The per-node half of
the what-if — pass 1 of selectVictimsOnNode (every potential victim
removed, the fit and port-clash half of the candidate test), the reprieve
scan (a lax.scan over all E existing pods in the JAX package) and the
per-node summaries the node choice ranks — is K3 `reprieve_scan`
(csrc/reprieve_scan.cu), one launch per burst over every (lane, node). Its
reprieve order is the same in every lane, so it is built once per burst
over [E] (`reprieve_order`). The node choice is the lexicographic argmin
over five keys, as a chain of stable sorts over [B, N].
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..state.arrays import Array, ClusterTables, PodArrays
from .assign import lexsort, neg_i32
from .interpod import affinity_rows, domain_of_term, per_node_counts
from ..parallel import axis
from ..parallel.axis import Shard
from .kernels import reprieve_scan
from .lattice import CycleArrays
from .topospread import spread_row

I32_MAX = 2**31 - 1


class PreemptResult(NamedTuple):
    node: Array      # [B] i32 — chosen node index per lane, -1 if preemption can't help
    victims: Array   # [B, E] bool — victims on the chosen node
    n_candidates: Array  # [B] i32 — nodes where preemption would work
    n_pdb_violations: Array  # [B] i32 — PDB-violating victims on the node


def _pairwise_port_conflict(tables: ClusterTables, cls: Array,
                            cls_e: Array) -> Array:
    """[B, E] bool: lane b's preemptor's port set conflicts with existing pod
    e's. Words are the int32 view of the encoder's uint32 words: `&` then
    `!= 0` reads the same bits."""
    psets = tables.portsets
    ps_p = tables.classes.portset[cls.long()]                  # [B]
    ps_e = tables.classes.portset[cls_e.clamp(min=0).long()]   # [E]
    pp = ps_p.clamp(min=0).long()
    pe = ps_e.clamp(min=0).long()
    wild_p, pair_p, trip_p = (psets.wild_words[pp], psets.pair_words[pp],
                              psets.trip_words[pp])
    any_e, wild_e, trip_e = (psets.pair_words[pe], psets.wild_words[pe],
                             psets.trip_words[pe])
    # conflict iff a shared (proto,port) pair where either side is wildcard,
    # or a shared exact (proto,port,ip) triple — port_conflict_row pairwise
    hits = (((wild_p[:, None, :] & any_e[None]) != 0)
            | ((pair_p[:, None, :] & wild_e[None]) != 0)).any(-1)
    trip = ((trip_p[:, None, :] & trip_e[None]) != 0).any(-1)
    return (hits | trip) & (ps_p >= 0)[:, None] & (ps_e >= 0)[None, :]


def reprieve_order(node_e_safe: Array, priority: Array, pdb_blocked: Array,
                   N: int):
    """K3's reprieve order, the same for every lane, as a CSR over [E]: node
    n's pods are seg_e[seg_ptr[n] : seg_ptr[n + 1]], PDB-blocked ones first
    (generic_scheduler.go:1149-1156), each group by priority descending
    through jnp's wrapped negation (a pod at INT32_MIN sorts first, as in
    the JAX package), then by index; pods on no node (node N) come last.
    Restricted to one lane's potential victims on a node, it is that lane's
    JAX order lexsort((e, -prio, ~pdb_blocked, ~vict_pot[b])): the walk
    skips every other pod. Two stable sorts over [E]."""
    key = ((~pdb_blocked).long() << 32) | (neg_i32(priority).long() + 2**31)
    order = torch.argsort(key, stable=True)
    order = order[torch.argsort(node_e_safe[order], stable=True)]
    counts = torch.bincount(node_e_safe.long(), minlength=N + 1)[:N]
    seg_ptr = torch.zeros((N + 1,), dtype=torch.int64, device=order.device)
    seg_ptr[1:] = torch.cumsum(counts, 0)
    return seg_ptr.to(torch.int32), order.to(torch.int32)


def preempt_batch(
    tables: ClusterTables,
    cyc: CycleArrays,
    existing: PodArrays,
    cls: Array,            # [B] i32: preemptor class ids
    node_name_req: Array,  # [B] i32: spec.nodeName ids or -1
    priority: Array,       # [B] i32: preemptor priorities
    D: int,
    pdb_blocked: Optional[Array] = None,   # [E] bool — shared across the burst
) -> PreemptResult:
    """The whole preemption burst: every lane's what-if against the same
    cycle lattice, existing-pod arrays and PDB mask. Each lane's result is
    what the single-pod what-if computes against that snapshot; the host
    commit (sched/preemption.py) resolves victim overlap between lanes.

    On a sharded node axis (parallel/axis.py) each shard's K3 launch walks
    its own nodes' pods (a per-node what-if needs nothing of another
    node); the node choice ranks every node, on the lead device over the
    gathered summaries, and the victim flags merge across shards."""
    ax = axis.current()
    nodes, classes, terms = tables.nodes, tables.classes, tables.terms
    dev = nodes.valid.device
    N = nodes.valid.shape[0]
    E = existing.valid.shape[0]
    B = cls.shape[0]
    i32 = torch.int32
    if pdb_blocked is None:
        pdb_blocked = torch.zeros((E,), dtype=torch.bool, device=dev)
    cl = cls.long()

    cls_e = existing.cls.clamp(min=0).long()
    node_e = existing.node_id
    on_node = existing.valid & (node_e >= 0)
    vict_pot = on_node[None, :] & (existing.priority[None, :]
                                   < priority[:, None])          # [B, E]
    # this shard's rows; a pod on another shard's node walks nowhere here
    row_e, inside = ax.local_rows(node_e, N)
    node_e_safe = torch.where(on_node & inside, row_e, N)
    n_idx = node_e_safe.clamp(max=N - 1).long()                  # [E]

    req_e = tables.reqs.vec[classes.rid[cls_e].long()]           # [E, R]
    req_p = tables.reqs.vec[classes.rid[cl].long()]              # [B, R]
    # ports: c_e[b, e] = pod e's ports clash with lane b's preemptor
    c_e = _pairwise_port_conflict(tables, cls, cls_e)            # [B, E]

    # the candidate test with all victims gone, but for the fit and the
    # port clash (K3's pass 1)
    aff_ok = torch.empty((B, N), dtype=torch.bool, device=dev)
    anti_ok = torch.empty_like(aff_ok)
    spread_ok = torch.empty_like(aff_ok)
    # the survivors, and so the term counts, depend on the lane only
    # through its priority
    prios = priority.tolist()
    for p in sorted(set(prios)):
        lanes = torch.tensor([b for b in range(B) if prios[b] == p],
                             dtype=torch.long, device=dev)
        survivors = existing._replace(valid=existing.valid & ~vict_pot[lanes[0]])
        CNT_wo = per_node_counts(cyc.TM, survivors, N)           # [S, N]
        HOLD_wo = per_node_counts(cyc.has_anti.T, survivors, N)
        a, b_ = affinity_rows(cls[lanes], classes, terms, cyc.TM, CNT_wo,
                              HOLD_wo, nodes, D)
        aff_ok[lanes], anti_ok[lanes] = a, b_
        spread_ok[lanes] = spread_row(
            cls[lanes], classes, terms, cyc.TM, CNT_wo, cyc.ELD,
            cyc.static.node_match[cl[lanes]], nodes, D)
    host_ok = ((node_name_req < 0)[:, None]
               | (nodes.name_id[None, :] == node_name_req[:, None]))
    cand_rest = (cyc.static.mask[cl] & aff_ok & anti_ok & spread_ok
                 & host_ok)                                      # [B, N]

    # ---- precompute "restoring pod e would re-block the preemptor" [B, E]
    # own anti-affinity: an anti term of ours matches e's class and e's node
    # carries the term's key
    ans = classes.anti_terms[cl]                                 # [B, AN]
    sa = ans.clamp(min=0).long()
    _, hk_anti = domain_of_term(nodes, terms.topo_key[sa])       # [B, AN, N]
    m_own = (ans >= 0)[..., None] & cyc.TM[sa]                   # [B, AN, SC]
    own_block = (m_own[:, :, cls_e] & hk_anti[:, :, n_idx]).any(1)
    # symmetry: e holds an anti term that matches us, key present on e's node
    _, hk_s = domain_of_term(nodes, terms.topo_key)              # [S, N]
    held = cyc.has_anti[cls_e] & hk_s[:, n_idx].T                # [E, S]
    sym_block = (held[None] & cyc.TM[:, cl].T[:, None, :]).any(-1)
    # hard topology-spread: restoring a matching pod bumps the domain count —
    # conservatively never reprieve such victims
    ts_ids = classes.tsc_term[cl]                                # [B, TS]
    ts = ts_ids.clamp(min=0).long()
    hard_ts = (ts_ids >= 0) & classes.tsc_hard[cl]
    spread_block = (hard_ts[..., None] & cyc.TM[ts][:, :, cls_e]).any(1)
    reblock = own_block | sym_block | spread_block

    # ---- selectVictimsOnNode on every (lane, node): pass 1, the candidate
    # test, the reprieve walk in the lane-independent order (PDB-violating
    # victims reprieved FIRST, generic_scheduler.go:1149-1156, each group
    # in priority-descending order) and the node's victim summaries ----
    seg_ptr, seg_e = reprieve_order(node_e_safe, existing.priority,
                                    pdb_blocked, N)
    k3 = reprieve_scan(
        seg_ptr, seg_e, req_e.contiguous(), existing.priority.contiguous(),
        pdb_blocked.contiguous(), existing.creation.contiguous(),
        req_p.contiguous(), vict_pot.contiguous(), c_e.contiguous(),
        reblock.contiguous(), nodes.used.contiguous(),
        nodes.alloc.contiguous(), nodes.valid.contiguous(),
        cand_rest.contiguous())
    victim, cand = k3.victim, k3.cand

    # ---- pickOneNodeForPreemption (:903): lexicographic over
    # (1) PDB violations, (2) highest victim priority, (3) priority sum,
    # (4) victim count, (5) latest earliest start of highest-prio victims
    # (GetEarliestPodStartTime, :1000-1028) ----
    big = I32_MAX
    key0 = torch.where(cand, k3.num_pdb, big)
    key1 = torch.where(cand, torch.where(k3.num_v > 0, k3.max_p, -I32_MAX),
                       big)
    key2 = torch.where(cand, k3.sum_p, big)
    key3 = torch.where(cand, k3.num_v, big)
    key4 = torch.where(cand, neg_i32(k3.est), big)  # latest start wins

    def choose(k0, k1, k2, k3_, k4, cand_f):
        Nf = cand_f.shape[1]
        arange_n = torch.arange(Nf, dtype=i32, device=dev).expand(B, Nf)
        best = lexsort((arange_n, k4, k3_, k2, k1, k0))[:, 0]
        any_cand = cand_f.any(-1)
        return (torch.where(any_cand, best, -1).to(i32), any_cand,
                cand_f.sum(-1, dtype=i32))

    node, any_cand, n_cand = ax.lead(
        choose, *(Shard(k, 1) for k in (key0, key1, key2, key3, key4, cand)))
    # each pod's victim flag comes from the one shard that walked it
    victim = ax.all_reduce(victim, "any")
    victims = victim & (node_e[None] == node[:, None]) & any_cand[:, None]
    nv = (victims & pdb_blocked[None]).sum(-1, dtype=i32)
    return PreemptResult(node=node, victims=victims, n_candidates=n_cand,
                         n_pdb_violations=nv)


def preempt_for_pod(
    tables: ClusterTables,
    cyc: CycleArrays,
    existing: PodArrays,
    cls: int,              # preemptor's class id
    node_name_req: int,    # spec.nodeName id or -1
    priority: int,         # preemptor's priority
    D: int,
    pdb_blocked: Optional[Array] = None,   # [E] bool — eviction violates a PDB
) -> PreemptResult:
    """The single-pod what-if: a burst of one lane, its result unbatched
    (node, n_candidates and n_pdb_violations scalars, victims [E])."""
    dev = tables.nodes.valid.device
    one = lambda v: torch.tensor([int(v)], dtype=torch.int32, device=dev)
    res = preempt_batch(tables, cyc, existing, one(cls), one(node_name_req),
                        one(priority), D, pdb_blocked)
    return PreemptResult(*(t[0] for t in res))
