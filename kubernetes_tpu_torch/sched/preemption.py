"""Host-side preemption driver: wires the device what-if (ops/preempt.py)
into the scheduling wave (port of the JAX package's sched/preemption.py).

Flow mirrors scheduler.go:453-523 + core Preempt (generic_scheduler.go:325):
a pod that failed Filter everywhere triggers one preemption dispatch; if a
candidate node exists, the victims are evicted (async API deletes in the
reference — here a pluggable evictor), the preemptor is *nominated* onto the
node (queue bookkeeping, scheduling_queue.go:136-138) and requeued; the actual
placement happens in a later wave once the victims' resources are released.

PodEligibleToPreemptOthers (generic_scheduler.go:1085): a pod that already has
a nominated node is assumed to be waiting for its victims to exit and does not
preempt again.

Each burst runs under the scheduler's dispatch supervisor
(sched/supervisor.py), on its worker thread and the snapshot's device; a
failed burst re-runs on the configured fallback device, or — with none
configured, or a hung primary — evicts nothing, and the un-handled pods take
the ordinary unschedulable path. The what-if honours the scheduler's
configured composition (`engine_config`, `hard_pod_affinity_weight`), as
in the JAX package. `APIEvictor` deletes victims through the API (the
scheduler process's evictor, sched/server.py); `CacheEvictor` only drops
them from the scheduler's cache.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import Callable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..api.types import Pod
from ..ops.lattice import (build_cycle, default_engine_config, f32_scalar,
                           strong_engine_config)
from ..ops.preempt import PreemptResult, preempt_batch
from ..parallel.mesh import ShardedTables, mesh_key, replicate
from ..state.arrays import to_device
from ..state.cache import Snapshot

# preemptor lanes per burst dispatch: bursts larger than this chunk; unused
# lanes are padded with the last real preemptor and their results discarded
PREEMPT_BURST = int(os.environ.get("KTPU_PREEMPT_BURST", "8"))


def _preempt(tables, existing, cls, nnr, prio, D, keys,
             pdb_blocked, hard_weight: float = 1.0,
             ecfg=None) -> PreemptResult:
    """One burst of [B] preemptors: build the cycle lattice once (with the
    configured EngineConfig and hardPodAffinitySymmetricWeight), evaluate
    every lane's five-criteria what-if (ops/preempt.py preempt_batch)."""
    if isinstance(tables, ShardedTables):
        # per shard: the lattice and K3 on its nodes, the node choice on
        # the lead device (ops/preempt.py)
        mesh = tables.mesh
        return tables.run(
            lambda t, ex, c, n, p, pdb: _preempt(t, ex, c, n, p, D, keys, pdb,
                                                 hard_weight, ecfg),
            *(replicate(x, mesh) for x in (existing, cls, nnr, prio,
                                           pdb_blocked)))[0]
    uk, ev = keys
    cyc = build_cycle(tables, existing, uk, ev, D, f32_scalar(hard_weight),
                      strong_engine_config(ecfg if ecfg is not None
                                           else default_engine_config()))
    return preempt_batch(tables, cyc, existing, cls, nnr, prio, D,
                         pdb_blocked)


def _readback(res: PreemptResult):
    """A burst's result on the host: chosen nodes, victim masks and PDB
    violation counts per lane."""
    return (res.node.cpu().numpy(), res.victims.cpu().numpy(),
            res.n_pdb_violations.cpu().numpy())


class CacheEvictor:
    """Default evictor: delete the victim from the scheduler's world (the
    reference issues pod DELETE API calls, generic_scheduler.go:352-364)."""

    def __init__(self) -> None:
        self.evicted: List[str] = []

    def evict(self, scheduler, victim_key: str) -> bool:
        pod = scheduler.cache.get_pod(victim_key)
        if pod is None:
            return False
        scheduler.cache.remove_pod(victim_key)
        self.evicted.append(victim_key)
        return True


class APIEvictor(CacheEvictor):
    """Live-cluster evictor: DELETE the victim through the API (the
    reference's generic_scheduler.go:352-364 pod deletes), then drop it
    from the cache optimistically — the informer's delete event is the
    authoritative confirmation. A victim that is already gone (404) counts
    as evicted; any other API failure leaves the cache untouched so the
    what-if's arithmetic never diverges from the real world."""

    def __init__(self, client) -> None:
        super().__init__()
        self.client = client

    def evict(self, scheduler, victim_key: str) -> bool:
        from ..machinery import errors

        pod = scheduler.cache.get_pod(victim_key)
        if pod is None:
            return False
        ns, _, name = victim_key.partition("/")
        try:
            self.client.pods.delete(name, ns)
        except errors.StatusError as e:
            if not errors.is_not_found(e):
                return False
        scheduler.cache.remove_pod(victim_key)
        self.evicted.append(victim_key)
        return True


class Preemptor:
    def __init__(self, evictor: Optional[CacheEvictor] = None,
                 pdb_source: Optional[Callable[[], list]] = None) -> None:
        self.evictor = evictor or CacheEvictor()
        # pdb_source() → iterable of (namespace, LabelSelector,
        # disruptions_allowed) triples — the PDB lister the reference hands to
        # genericScheduler. Victims whose eviction would violate a PDB
        # (allowed ≤ 0) become the what-if's pdb_blocked bits
        # (filterPodsWithPDBViolation semantics).
        self.pdb_source = pdb_source
        self.attempts = 0
        self.successes = 0
        self.last_pdb_violations = 0
        # zero-victim prompt retries already granted, per pod key: the FIRST
        # "candidate with zero victims" is burst/wave staleness and retries
        # promptly; a REPEAT is a real host/device filter discrepancy and
        # takes the backoff path, or it would hot-loop at wave frequency
        self._zero_victim_retries: dict = {}

    def _pdb_blocked(self, scheduler, snap: Snapshot) -> np.ndarray:
        E = len(snap.existing_keys)
        blocked = np.zeros((max(E, 1),), bool)
        if self.pdb_source is None:
            return blocked
        from ..api.semantics import selector_matches

        # reference-faithful matching (generic_scheduler.go:1080-1098): a
        # nil/EMPTY selector matches NOTHING, and unlabeled pods are skipped
        # ("A pod with no labels will not match any PDB")
        pdbs = [(ns, sel, allowed) for ns, sel, allowed in self.pdb_source()
                if allowed <= 0 and sel is not None
                and getattr(sel, "requirements", ())]
        if not pdbs:
            return blocked
        for i, key in enumerate(snap.existing_keys):
            if not key:
                continue
            pod = scheduler.cache.get_pod(key)
            if pod is None or not pod.labels:
                continue
            for ns, sel, _ in pdbs:
                if ns == pod.namespace and selector_matches(sel, pod.labels):
                    blocked[i] = True
                    break
        return blocked

    def try_preempt(self, scheduler, pod: Pod, attempts: int,
                    snap: Snapshot, now: float) -> bool:
        """Single-preemptor convenience: a burst of one. Returns True iff
        preemption was performed (victims evicted and the pod nominated +
        requeued)."""
        return pod.key in self.preempt_burst(
            scheduler, [(pod, attempts)], snap, now)

    def preempt_burst(self, scheduler, burst: Sequence[Tuple[Pod, int]],
                      snap: Snapshot, now: float) -> Set[str]:
        """The wave's preemption pass, chunked at PREEMPT_BURST lanes per
        dispatch: every unschedulable priority pod's what-if against the same
        snapshot, then the host commit in batch order. Returns the keys that
        preempted (victims evicted, pod nominated + requeued) or were sent to
        a prompt retry; the caller requeues the rest as unschedulable.

        Lanes are evaluated against the PRE-burst state, so two lanes can
        name the same victim. The commit evicts each victim once; a lane none
        of whose victims remain evictable does not count as preempting — an
        earlier lane freed its space, and it retries promptly."""
        from .cycle import UNSCHEDULABLE_TAINT_KEY

        # ---- host-side eligibility (PodEligibleToPreemptOthers) ---- #
        row_of = {k: i for i, (k, _) in enumerate(snap.pending_keys)}
        eligible: List[Tuple[Pod, int, int]] = []  # (pod, attempts, row)
        for pod, attempts in burst:
            if pod.priority <= 0:
                continue  # only priority pods preempt
            if scheduler.queue.nominated_node(pod.key) is not None:
                # it failed even on its nominated node: the evictors remove
                # victims synchronously, so the space is truly gone — clear
                # the nomination and re-evaluate in THIS burst
                scheduler.queue.delete_nominated(pod.key)
            row = row_of.get(pod.key)
            if row is None:
                continue
            eligible.append((pod, attempts, row))
        if not eligible:
            return set()
        self.attempts += len(eligible)

        enc = scheduler.encoder
        keys = (enc.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY),
                enc.vocabs.label_vals.get(""))
        device = snap.device
        blocked = self._pdb_blocked(scheduler, snap)
        pdb_arr = np.zeros((snap.existing.valid.shape[0],), bool)
        pdb_arr[: blocked.shape[0]] = blocked
        pdb_dev = torch.from_numpy(pdb_arr).to(device)

        hw = getattr(scheduler, "hard_pod_affinity_weight", 1.0)
        ecfg = getattr(scheduler, "engine_config", None)
        pend_cls = snap.pending.cls.cpu().numpy()
        pend_nnr = snap.pending.node_name_req.cpu().numpy()

        handled: Set[str] = set()
        retry_soon: Set[str] = set()  # candidates whose space another lane
                                      # freed this burst: retry promptly
        B = PREEMPT_BURST
        for lo in range(0, len(eligible), B):
            chunk = eligible[lo: lo + B]
            pad = chunk + [chunk[-1]] * (B - len(chunk))
            rows = [r for _, _, r in pad]
            lane = lambda a, dev=device: torch.from_numpy(
                np.ascontiguousarray(a, np.int32)).to(dev)
            cls_b = pend_cls[rows]
            nnr_b = pend_nnr[rows]
            prio_b = [p.priority for p, _, _ in pad]

            def _primary():
                return _readback(_preempt(
                    snap.tables, snap.existing, lane(cls_b), lane(nnr_b),
                    lane(prio_b), snap.dims.D, keys, pdb_dev, hw, ecfg))

            def _fallback(dev, hung=False):
                # the same burst on the fallback device. A wedged primary's
                # tensors are untouchable: abort crash-consistently
                # (nothing evicted), the pods requeue
                if hung:
                    raise RuntimeError("preempt fallback: primary tensors "
                                       "unreachable (hung backend)")
                tables = snap.tables.gather() \
                    if isinstance(snap.tables, ShardedTables) else snap.tables
                return _readback(_preempt(
                    to_device(tables, dev), to_device(snap.existing, dev),
                    lane(cls_b, dev), lane(nnr_b, dev), lane(prio_b, dev),
                    snap.dims.D, keys, pdb_dev.to(dev), hw, ecfg))

            supervisor = getattr(scheduler, "supervisor", None)
            if supervisor is None:
                nodes_b, victims_b, npdb_b = _primary()
            else:
                from .supervisor import DispatchAbandonedError

                try:
                    nodes_b, victims_b, npdb_b = supervisor.run(
                        "preempt",
                        # the burst is keyed by its mesh as well: a sharded
                        # burst is a different dispatch from a single-device
                        # one at the same dims
                        (replace(snap.dims, has_node_name=False, P=1), B,
                         mesh_key(snap.mesh)),
                        _primary, _fallback)
                except DispatchAbandonedError:
                    # nothing in this chunk (or the remaining ones) was
                    # evaluated, so nothing is evicted — every un-handled
                    # pod takes the ordinary unschedulable path upstream
                    break

            for lane_i, (pod, attempts, _row) in enumerate(chunk):
                node_idx = int(nodes_b[lane_i])
                if node_idx < 0:
                    continue
                victim_keys = [
                    snap.existing_keys[i]
                    for i in np.flatnonzero(
                        victims_b[lane_i][: len(snap.existing_keys)])
                ]
                if not victim_keys:
                    # a candidate with zero victims: the pod should simply
                    # fit. Once per pod that is burst staleness — retry
                    # promptly; a repeat is a real host/device filter
                    # discrepancy and takes the backoff path.
                    if self._zero_victim_retries.get(pod.key, 0) < 1:
                        if len(self._zero_victim_retries) > 4096:
                            # bound the ledger by dropping the OLDEST half
                            # (dict keeps insertion order), never the pod
                            # just recorded
                            for k in list(self._zero_victim_retries)[:2048]:
                                del self._zero_victim_retries[k]
                        self._zero_victim_retries[pod.key] = 1
                        retry_soon.add(pod.key)
                    continue
                evicted_any = False
                for vk in victim_keys:
                    evicted_any |= self.evictor.evict(scheduler, vk)
                if not evicted_any:
                    # every victim was already evicted for an earlier lane:
                    # that lane's commit freed this space — retry promptly
                    retry_soon.add(pod.key)
                    continue
                self.last_pdb_violations = int(npdb_b[lane_i])
                scheduler.queue.add_nominated(pod.key,
                                              snap.node_order[node_idx])
                handled.add(pod.key)
                self._zero_victim_retries.pop(pod.key, None)
                self.successes += 1

        if not handled:
            # no lane evicted anything: a zero-victim candidate here is a
            # genuine filter discrepancy, not burst overlap — every pod takes
            # the ordinary unschedulable/backoff path
            return set()
        # cache changed → move event for everyone else; the nominated
        # preemptors (and the lanes whose space an earlier lane freed) go
        # straight back to activeQ, attempt counts preserved
        scheduler.queue.move_all_to_active(now)
        for pod, attempts, _row in eligible:
            if pod.key in handled or pod.key in retry_soon:
                scheduler.queue.add_prompt_retry(
                    pod, attempts=attempts, now=now)
        return handled | retry_soon
