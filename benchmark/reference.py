"""The plain reference of the serving scheduler's placements.

It replays a run's event log: the pods that filled the cluster bound, then
wave by wave the pods each wave held and the pods deleted after it. For
every wave it works out, on its own state, where each pod goes, and the
harness compares that with what the scheduler bound and left unschedulable.

What it computes is the wave engine's placement rule, as the JAX package's
ops/waves.py states it and kubernetes_tpu_torch/ops/waves.py ports it (the
port's tests hold the two equal): per engine step every class with pending
pods evaluates its Filter mask and Score row against the committed state;
classes admit in queue-rank order through the interaction graph, the
per-domain quotas and the score window; same-node contention resolves in
rank order; runs that cannot progress fail. Filter is resources and the pod
count, required inter-pod affinity (with the first-pod escape),
anti-affinity in both directions and hard topology spread; Score is
LeastAllocated + BalancedAllocation + the symmetric inter-pod affinity
weight, over the constant TaintToleration score, in float32.

Everything is derived again from the plain `traffic.Cluster`: the classes
(label keys that no term reads fold out of a class, as the scheduler's
encoder folds them), the terms, the per-node planes and the domains. It
imports torch and nothing of the program; it runs on any device, in plain
torch ops. `fdtype` sets the precision of the Score arithmetic (float32 is
the program's); `scored=False` leaves the Score out, so each pod takes the
feasible nodes in the tie rotation's order: the check's control.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .traffic import Cluster

I32_MAX = 2**31 - 1
I32_MIN = -(2**31)
MAX_NODE_SCORE = 100.0
# TaintToleration on untainted nodes scores every node 100; NodeAffinity
# (no preferred terms) and ImageLocality (no images) add 0
STATIC_SCORE = 100.0
# the engine's score window (EngineConfig.w_window): one plugin's full swing
SCORE_WINDOW = 100.0
# the tie rotation's stride per queue rank (generic_scheduler.go:502)
ROTATION = 97
R_CPU, R_MEM, R_EPH, R_PODS = 0, 1, 2, 3


def bucket(n: int) -> int:
    """The node axis's capacity: a power of two up to 256, above it the
    next multiple of 2^(bit_length − 4) (eight buckets an octave); never
    below 8. The tie rotation runs over this many slots."""
    if n <= 256:
        return max(8, 1 << max(n - 1, 1).bit_length())
    step = 1 << (n.bit_length() - 4)
    return ((n + step - 1) // step) * step


def _domain_rank(dom: torch.Tensor) -> torch.Tensor:
    """rank[m, p] = how many earlier positions of row m hold dom[m, p]."""
    M, N = dom.shape
    pos = torch.arange(N, device=dom.device)
    order = torch.argsort(dom.long() * N + pos, dim=1)
    ds = torch.gather(dom, 1, order)
    first = torch.ones_like(ds, dtype=torch.bool)
    first[:, 1:] = ds[:, 1:] != ds[:, :-1]
    start = torch.where(first, pos.expand(M, N), torch.zeros_like(order))
    start = torch.cummax(start, dim=1).values
    rank = torch.empty_like(order)
    rank.scatter_(1, order, pos.expand(M, N) - start)
    return rank


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """numpy.lexsort: the last key is the primary one."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


class Model:
    """Classes, terms and node planes of a Cluster, worked out again."""

    def __init__(self, cluster: Cluster, device, fdtype=torch.float32,
                 scored: bool = True):
        self.cluster = cluster
        self.device = device = torch.device(device)
        self.fdtype = fdtype
        self.scored = scored
        groups = cluster.groups
        # terms: (topology key, selected group), interned in group order
        terms: Dict[Tuple[str, int], int] = {}
        for g in groups:
            for t in ([(g.spread[0], g.index)] if g.spread else []) + \
                     ([(g.anti, g.index)] if g.anti else []) + \
                     ([g.affinity] if g.affinity else []):
                terms.setdefault(t, len(terms))
        self.terms = list(terms)
        # the app label is part of a class only where some term reads it
        keep_app = bool(terms)
        classes: Dict[tuple, int] = {}
        self.class_of_group = []
        for g in groups:
            label = g.index if keep_app and g.labelled else None
            key = (g.cpu_milli, g.mem_kib, label, g.spread, g.anti,
                   g.affinity)
            self.class_of_group.append(classes.setdefault(key, len(classes)))
        SC, S = len(classes), len(self.terms)
        self.SC, self.S = SC, S
        rep = {}
        for g in groups:
            rep.setdefault(self.class_of_group[g.index], g)
        self.rep = [rep[c] for c in range(SC)]

        def tens(x, dt=torch.int64):
            return torch.tensor(x, dtype=dt, device=device)

        self.req = tens([[g.cpu_milli, g.mem_kib, 0, 1] for g in self.rep])
        # TM[s, c]: term s's selector matches class c's labels
        tm = [[keep_app and self.rep[c].labelled
               and self.rep[c].index == self.terms[s][1]
               for c in range(SC)] for s in range(S)]
        self.TM = tens(tm, torch.bool).reshape(S, SC)
        self.anti_term = tens([terms[(g.anti, g.index)] if g.anti else -1
                               for g in self.rep])
        self.aff_term = tens([terms[g.affinity] if g.affinity else -1
                              for g in self.rep])
        self.spread_term = tens([terms[(g.spread[0], g.index)] if g.spread
                                 else -1 for g in self.rep])
        self.max_skew = tens([g.spread[1] if g.spread else 0
                              for g in self.rep])
        # HOLDERS[s, c]: class c holds anti-affinity term s; WCOLS[s, c]: the
        # symmetric weight (hardPodAffinitySymmetricWeight 1) an existing
        # pod of class c gives through its required affinity term s
        hold = torch.zeros((S, SC), dtype=torch.float64, device=device)
        wcols = torch.zeros((S, SC), dtype=torch.float64, device=device)
        for c in range(SC):
            if self.anti_term[c] >= 0:
                hold[self.anti_term[c], c] = 1
            if self.aff_term[c] >= 0:
                wcols[self.aff_term[c], c] += 1
        self.HOLDERS, self.WCOLS = hold, wcols
        self.TMd = self.TM.double()
        # interaction graph: anti, hard spread and affinity terms of one
        # class matching the other, both ways, no self-edges
        G = torch.zeros((SC, SC), dtype=torch.bool, device=device)
        for col in (self.anti_term, self.spread_term, self.aff_term):
            for c in range(SC):
                if col[c] >= 0:
                    G[c] |= self.TM[col[c]]
        G = G | G.T
        self.G = G & ~torch.eye(SC, dtype=torch.bool, device=device)
        self.aff_self = torch.tensor(
            [bool(self.aff_term[c] >= 0 and self.TM[self.aff_term[c], c])
             for c in range(SC)], device=device)
        # monotone classes: no required affinity, no hard spread
        self.mono = (self.aff_term < 0) & (self.spread_term < 0)

        N = cluster.nodes
        self.N, self.Np = N, bucket(N)
        Np = self.Np
        self.valid = torch.arange(Np, device=device) < N
        alloc = torch.zeros((Np, 4), dtype=torch.int64, device=device)
        alloc[:N, R_CPU] = cluster.cpu_milli
        alloc[:N, R_MEM] = cluster.mem_kib
        alloc[:N, R_PODS] = cluster.pods_cap
        self.alloc = alloc
        # each term's domain of every node (-1 on the padding slots), the
        # domains' count Dm (slot Dm collects what has none), and which
        # domains hold a node
        doms = {}
        for key in {t[0] for t in self.terms}:
            d = torch.full((Np,), -1, dtype=torch.int64, device=device)
            d[:N] = tens(cluster.domains(key))
            doms[key] = d
        self.Dm = max([int(d.max()) + 1 for d in doms.values()] or [1])
        self.domS = torch.stack([doms[k] for k, _ in self.terms]) \
            if S else torch.zeros((0, Np), dtype=torch.int64, device=device)
        self.idxS = torch.where(self.domS >= 0, self.domS, self.Dm)
        elig = torch.zeros((S, self.Dm + 1), dtype=torch.bool, device=device)
        elig.scatter_(1, self.idxS, self.valid.expand(S, Np))
        self.eligS = elig[:, :self.Dm]
        ar = torch.arange(SC, device=device)
        self.spread_self = (self.spread_term >= 0) & \
            self.TM[self.spread_term.clamp(min=0), ar] if S else \
            torch.zeros((SC,), dtype=torch.bool, device=device)
        self.anti_self = (self.anti_term >= 0) & \
            self.TM[self.anti_term.clamp(min=0), ar] if S else \
            torch.zeros((SC,), dtype=torch.bool, device=device)

    # ---- per-term domain aggregates ----

    def _seg(self, plane: torch.Tensor) -> torch.Tensor:
        """plane [S, Np] per node → [S, Dm+1] per domain of each term's
        key."""
        out = torch.zeros((self.S, self.Dm + 1), dtype=plane.dtype,
                          device=plane.device)
        return out.scatter_add_(1, self.idxS, plane)

    def _at(self, seg: torch.Tensor) -> torch.Tensor:
        return torch.gather(seg, 1, self.idxS)

    # ---- one engine step's Filter and Score for every class ----

    def mask_score(self, used, ccount):
        SC, Np, dev, fdt = self.SC, self.Np, self.device, self.fdtype
        valid = self.valid
        free = self.alloc - used                             # [Np, 4]
        req = self.req
        pods_ok = req[:, None, R_PODS] <= free[None, :, R_PODS]
        zero_all = req[:, :R_PODS].amax(1) == 0
        res_ok = (req[:, None, :R_PODS] <= free[None, :, :R_PODS]).all(-1)
        mask = pods_ok & (zero_all[:, None] | res_ok) & valid[None]
        cnt = (self.TMd @ ccount.double()).long()            # [S, Np]
        if self.S:
            hold = (self.HOLDERS @ ccount.double()).long()
            wsym = self.WCOLS @ ccount.double()              # integer-valued
            cnt_seg = self._seg(cnt)
            cnt_at = self._at(cnt_seg)
            # required affinity, with the first-pod escape
            a = self.aff_term.clamp(min=0)
            total = torch.where(valid[None], cnt, 0).sum(1)[a]
            escape = (total == 0) & self.aff_self
            aff_ok = (self.aff_term < 0)[:, None] | escape[:, None] \
                | (cnt_at[a] > 0)
            # the pod's own anti-affinity
            s = self.anti_term.clamp(min=0)
            anti_ok = (self.anti_term < 0)[:, None] | ~(cnt_at[s] > 0)
            # hard topology spread: count + self − min over eligible
            # domains ≤ maxSkew
            s = self.spread_term.clamp(min=0)
            elig = self.eligS[s]
            mn = torch.where(elig, cnt_seg[s, :self.Dm], I32_MAX).amin(1)
            self_m = self.TM[s, torch.arange(SC, device=dev)].long()
            skew = cnt_at[s] + self_m[:, None] - mn[:, None]
            spread_ok = ((self.spread_term < 0) | ~elig.any(1))[:, None] \
                | (skew <= self.max_skew[:, None])
            # existing pods' anti-affinity, by symmetry
            held = (self._at(self._seg(hold)) > 0) & valid[None]
            blocked = (self.TMd.T @ held.double()) > 0
            mask &= aff_ok & anti_ok & spread_ok & ~blocked

        # Score
        t = used[None] + req[:, None, :]                       # [SC, Np, 4]
        zero0 = torch.zeros((), dtype=fdt, device=dev)

        def f(x):
            return x.to(fdt)

        def least(tt, cap):
            sc = (f(cap) - f(tt)) * MAX_NODE_SCORE
            sc = sc / torch.clamp(f(cap), min=1.0)
            return torch.where((cap > 0) & (tt <= cap), sc, zero0)

        def most(tt, cap):
            sc = f(tt) * MAX_NODE_SCORE / torch.clamp(f(cap), min=1.0)
            return torch.where((cap > 0) & (tt <= cap), sc, zero0)

        def frac(tt, cap):
            return torch.where(cap > 0, f(tt) / torch.clamp(f(cap), min=1.0),
                               zero0)

        cap_c, cap_m = self.alloc[None, :, R_CPU], self.alloc[None, :, R_MEM]
        t_c, t_m = t[..., R_CPU], t[..., R_MEM]
        least_s = (least(t_c, cap_c) + least(t_m, cap_m)) / 2.0
        most_s = (most(t_c, cap_c) + most(t_m, cap_m)) / 2.0
        cf, mf = frac(t_c, cap_c), frac(t_m, cap_m)
        balanced = torch.where((cf >= 1.0) | (mf >= 1.0), zero0,
                               MAX_NODE_SCORE - torch.abs(cf - mf)
                               * MAX_NODE_SCORE)

        # symmetric inter-pod affinity: for every term a class matches, the
        # weight of the term's holders in the node's domain, then min/max
        # normalized over the nodes
        if self.S:
            per_term = self._at(self._seg(wsym))               # [S, Np]
            raw = f(self.TMd.T @ per_term)                     # [SC, Np]
        else:
            raw = torch.zeros((SC, Np), dtype=fdt, device=dev)
        inf = torch.tensor(float("inf"), dtype=fdt, device=dev)
        lo = torch.where(valid[None], raw, inf).amin(-1, keepdim=True)
        hi = torch.where(valid[None], raw, -inf).amax(-1, keepdim=True)
        soft = torch.where(hi > lo, MAX_NODE_SCORE * (raw - lo)
                           / torch.clamp(hi - lo, min=1e-9), zero0)

        zero = torch.zeros((SC, Np), dtype=fdt, device=dev)
        score = torch.full((SC, Np), STATIC_SCORE, dtype=fdt, device=dev)
        score = score + least_s * 1.0
        score = score + balanced * 1.0
        score = score + most_s * 0.0
        score = score + soft * 1.0
        score = score + zero   # PodTopologySpread ScheduleAnyway: none
        score = score + zero   # SelectorSpread: no owner selectors
        if not self.scored:
            score = torch.full((SC, Np), STATIC_SCORE, dtype=fdt, device=dev)
        return mask, torch.where(mask, score, -inf), cnt

    # ---- the wave ----

    def wave(self, used, ccount, cls: List[int], pri: List[int],
             cre: List[int]) -> List[int]:
        """Place one wave's pods (class, priority, creation each) against
        the state `used` [Np, 4], `ccount` [SC, Np] (updated in place).
        Returns the node of each pod, -1 where it stays unschedulable."""
        SC, Np, dev = self.SC, self.Np, self.device
        P = len(cls)
        out = [-1] * P
        if P == 0:
            return out
        # each class's pods in queue order (priority desc, creation asc)
        per_class: List[List[int]] = [[] for _ in range(SC)]
        for i in sorted(range(P), key=lambda i: (cls[i], -pri[i], cre[i])):
            per_class[cls[i]].append(i)
        cursor = [0] * SC
        steps, cap = 0, 2 * P + 2
        while steps < cap and any(cursor[c] < len(per_class[c])
                                  for c in range(SC)):
            nxt_ok = [cursor[c] < len(per_class[c]) for c in range(SC)]
            nxt_pri = [pri[per_class[c][cursor[c]]] if nxt_ok[c] else I32_MIN
                       for c in range(SC)]
            nxt_cre = [cre[per_class[c][cursor[c]]] if nxt_ok[c] else I32_MAX
                       for c in range(SC)]
            run_cnt = [sum(1 for i in per_class[c][cursor[c]:]
                           if pri[i] == nxt_pri[c]) if nxt_ok[c] else 0
                       for c in range(SC)]
            remaining = [len(per_class[c]) - cursor[c] for c in range(SC)]
            r = [min(remaining[c], run_cnt[c]) if nxt_ok[c] else 0
                 for c in range(SC)]
            ok_t = torch.tensor(nxt_ok, device=dev)

            mask, score, cnt = self.mask_score(used, ccount)
            mask = mask & ok_t[:, None]
            best = torch.where(mask, score, -torch.inf).amax(1, keepdim=True)
            adm = mask & (score >= best - SCORE_WINDOW)
            for c in range(SC):
                a = int(self.aff_term[c])
                if a >= 0 and \
                        int(torch.where(self.valid, cnt[a], 0).sum()) == 0:
                    r[c] = min(r[c], 1)

            rank_key = _lexsort((
                torch.tensor(nxt_cre, device=dev),
                torch.tensor([-p for p in nxt_pri], device=dev),
                (~ok_t).long()))
            crank = torch.empty((SC,), dtype=torch.int64, device=dev)
            crank[rank_key] = torch.arange(SC, device=dev)
            blocked = (self.G & (crank[None, :] < crank[:, None])
                       & ok_t[None, :]).any(1).tolist()
            attempted = [nxt_ok[c] and not blocked[c] and r[c] > 0
                         for c in range(SC)]
            r = [r[c] if attempted[c] else 0 for c in range(SC)]

            # per class: nodes by score, equal scores rotated by queue rank
            node_ids = torch.arange(Np, device=dev)
            offs = (crank * ROTATION) % Np
            rot = (node_ids[None, :] + offs[:, None]) % Np
            o = torch.argsort(-torch.gather(score, 1, rot), dim=1, stable=True)
            order_n = torch.gather(rot, 1, o)                  # [SC, Np]
            allowed = torch.gather(adm, 1, order_n)
            allowed = allowed & self._quota_ok(order_n, cnt)
            grank = torch.cumsum(allowed.long(), 1) - 1
            r_t = torch.tensor(r, device=dev)
            adm_sorted = allowed & (grank < r_t[:, None])
            A = torch.zeros_like(adm).scatter_(1, order_n, adm_sorted)

            # same-node contention in queue-rank order: a class keeps a node
            # where its request fits what the node has left after every
            # earlier-ranked admission there
            A_r = A[rank_key]
            req_r = self.req[rank_key]
            claim = A_r[..., None].long() * req_r[:, None, :]   # [SC, Np, 4]
            before = torch.cumsum(claim, 0) - claim
            free = (self.alloc - used)[None] - before
            pods_ok = req_r[:, None, R_PODS] <= free[..., R_PODS]
            zero_all = req_r[:, :R_PODS].amax(1) == 0
            res_ok = (req_r[:, None, :R_PODS] <= free[..., :R_PODS]).all(-1)
            keep = A_r & pods_ok & (zero_all[:, None] | res_ok)
            A_final = torch.zeros_like(A)
            A_final[rank_key] = keep
            m = A_final.sum(1).tolist()
            total_m = sum(m)

            # commit
            used += (A_final.T.double() @ self.req.double()).long()
            ccount += A_final.long()

            # map back: a class's kept nodes by score (ties: lowest node)
            # go to its next pods in queue order
            sck = torch.where(A_final, score, -torch.inf)
            ordk = torch.argsort(-sck, dim=1, stable=True)
            for c in range(SC):
                if m[c]:
                    nodes_c = ordk[c, :m[c]].tolist()
                    for j, n in enumerate(nodes_c):
                        out[per_class[c][cursor[c] + j]] = n

            # failure consumption
            infeasible = [attempted[c] and not bool(mask[c].any())
                          for c in range(SC)]
            in_prefix = [False] * SC
            for c in rank_key.tolist():
                if infeasible[c] or not nxt_ok[c]:
                    in_prefix[c] = True
                else:
                    break
            for c in range(SC):
                early = infeasible[c] and (bool(self.mono[c]) or in_prefix[c])
                run_left = min(run_cnt[c], remaining[c])
                if infeasible[c] and bool(self.mono[c]):
                    consume = remaining[c]
                elif (total_m == 0 and attempted[c]) or early:
                    consume = run_left
                else:
                    consume = m[c]
                cursor[c] += consume
            steps += 1
        return out

    def _quota_ok(self, order_n: torch.Tensor, cnt: torch.Tensor):
        """[SC, Np] in score order: the per-domain admission quotas. A
        self-matching hard spread term allows maxSkew + min − count new pods
        in a domain, a self-matching anti-affinity term one a domain. The
        rank in a domain counts every earlier node of the row."""
        SC, Np = order_n.shape
        dev = self.device
        ok = torch.ones((SC, Np), dtype=torch.bool, device=dev)
        if not self.S:
            return ok
        cnt_seg = self._seg(cnt)
        ar = torch.arange(SC, device=dev)
        for term, active, spread in (
                (self.spread_term, self.spread_self, True),
                (self.anti_term, self.anti_self, False)):
            s = term.clamp(min=0)
            if spread:
                active = active & self.eligS[s].any(1)
            rows = ar[active]
            if rows.numel() == 0:
                continue
            sr = s[rows]
            dsafe = torch.gather(self.idxS[sr], 1, order_n[rows])
            if spread:
                elig = self.eligS[sr]
                seg = cnt_seg[sr]
                mn = torch.where(elig, seg[:, :self.Dm], I32_MAX).amin(1)
                quota = torch.clamp(self.max_skew[rows, None] + mn[:, None]
                                    - seg, 0, I32_MAX)
            else:
                quota = torch.ones((rows.numel(), self.Dm + 1),
                                   dtype=torch.int64, device=dev)
            rank = _domain_rank(dsafe)
            ok[rows] &= rank < torch.gather(quota, 1, dsafe)
        return ok


def replay(cluster: Cluster, log: dict, device="cpu",
           fdtype=torch.float32, scored: bool = True
           ) -> List[Dict[int, int]]:
    """Replay a run's log on the reference's own state: the fill, then per
    wave the wave's pods placed by the reference and the pods the harness
    deleted after it. Returns per wave {pod id: node or -1}."""
    model = Model(cluster, device, fdtype, scored)
    dev = model.device
    used = torch.zeros((model.Np, 4), dtype=torch.int64, device=dev)
    ccount = torch.zeros((model.SC, model.Np), dtype=torch.int64, device=dev)
    group = log["group"]
    where: Dict[int, int] = {}

    def place(pid, node):
        c = model.class_of_group[group[pid]]
        used[node] += model.req[c]
        ccount[c, node] += 1
        where[pid] = node

    def remove(pid):
        node = where.pop(pid, None)
        if node is None:
            return
        c = model.class_of_group[group[pid]]
        used[node] -= model.req[c]
        ccount[c, node] -= 1

    for pid, node in log["fill"]:
        place(pid, node)
    out = []
    for w in log["waves"]:
        members = w["members"]
        cls = [model.class_of_group[group[p]] for p in members]
        pri = [cluster.groups[group[p]].priority for p in members]
        got = model.wave(used, ccount, cls, pri, list(members)) \
            if members else []
        # the engine committed into used/ccount; record where
        res = {}
        for p, n in zip(members, got):
            res[p] = n
            if n >= 0:
                where[p] = n
        out.append(res)
        for p in w["deleted"]:
            remove(p)
    return out
