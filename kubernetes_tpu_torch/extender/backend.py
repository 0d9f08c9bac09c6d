"""The extender backend: the device lattice behind the extender verbs (port of
the JAX package's extender/backend.py).

This is the north-star integration surface: a stock kube-scheduler
configured with an Extender (apis/config/legacy_types.go:194 — URLPrefix/
FilterVerb/PrioritizeVerb/PreemptVerb/BindVerb/NodeCacheCapable) POSTs
ExtenderArgs JSON per pod; we answer from the same watch-fed mirror
(state/cache.py SchedulerCache) + (pods × nodes) lattice that the
standalone scheduler uses, on the backend's device.

Verb semantics mirrored from the reference's HTTPExtender client
(core/extender.go):
  * Filter (:289): return the feasible subset (names when nodeCacheCapable,
    full nodes otherwise) + FailedNodes reasons.
  * Prioritize (:355): HostPriorityList with scores 0..MaxExtenderPriority=10;
    the caller rescales ×weight×(100/10) (generic_scheduler.go:868).
  * ProcessPreemption (:166): given candidate victim sets, re-verify each
    node's viability with our own predicates and return the surviving subset
    (possibly shrunk per node).
  * Bind (:397): commit the placement through our binder (apiserver write).

The backend is also 'cache capable' in the reference sense (extender.go:454
IsInterested / managedResources): `interested()` lets deployments scope us to
pods carrying a managed resource.

Runs on the CUDA device unless `device="cpu"` is asked for; with no usable
GPU and no explicit CPU device it raises. The verbs may arrive on several
server threads at once: one lock serialises them, so the mirror, the
encoder and the device's default stream see one verb at a time.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..api.types import Node, Pod
from ..api.v1 import node_from_v1, pod_from_v1
from ..sched.cycle import _diagnose, _feasible, _scores, snapshot_with_keys
from ..state.arrays import resolve_device
from ..state.cache import SchedulerCache
from ..state.dims import Dims
from ..state.encode import Encoder
from .wire import (
    ExtenderArgs,
    ExtenderBindingArgs,
    ExtenderBindingResult,
    ExtenderFilterResult,
    ExtenderPreemptionArgs,
    ExtenderPreemptionResult,
    HostPriority,
    MAX_EXTENDER_PRIORITY,
    MetaVictims,
)

# reference predicate failure reason strings (algorithm/predicates/error.go),
# keyed by MaskComponents field order (ops/assign.py); the ninth field,
# volumes, never fails for a wire pod (api/v1.py carries no pod volumes)
_REASONS = (
    "node(s) didn't match node selector",
    "node(s) had taints that the pod didn't tolerate",
    "Insufficient resources",
    "node(s) didn't have free ports for the requested pod ports",
    "node(s) didn't match pod affinity rules",
    "node(s) didn't match pod anti-affinity rules",
    "node(s) didn't match pod topology spread constraints",
    "node(s) didn't match the requested hostname",
)


class ExtenderBackend:
    """Watch-fed mirror + lattice evaluation for one extender deployment."""

    def __init__(
        self,
        cache: Optional[SchedulerCache] = None,
        base_dims: Optional[Dims] = None,
        managed_resources: Sequence[str] = (),
        binder: Optional[Callable[[Pod, str], bool]] = None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.cache = cache or SchedulerCache()
        self.encoder = Encoder()
        self.base_dims = base_dims
        self.managed_resources = frozenset(managed_resources)
        self.binder = binder
        self._mu = threading.Lock()
        self.bound: List[Tuple[str, str]] = []  # (pod key, node) — audit trail

    # ------------------------------------------------------------------ #
    # mirror feed (in production: informer events; in tests: direct calls)
    # ------------------------------------------------------------------ #

    def sync_nodes(self, nodes: Sequence[Node]) -> None:
        """Full reconcile: `nodes` is the complete node set (informer relist)."""
        known = {n.name for n in self.cache.nodes()}
        incoming = {n.name for n in nodes}
        for n in nodes:
            (self.cache.update_node if n.name in known else self.cache.add_node)(n)
        for gone in known - incoming:
            self.cache.remove_node(gone)

    def upsert_nodes(self, nodes: Sequence[Node]) -> None:
        """Partial refresh: update/insert only — used for the node objects
        riding a non-cache-capable ExtenderArgs, which carry just the subset
        that survived the caller's earlier predicates for one pod and must NOT
        prune the rest of the mirror."""
        known = {n.name for n in self.cache.nodes()}
        for n in nodes:
            (self.cache.update_node if n.name in known else self.cache.add_node)(n)

    def sync_scheduled_pods(self, pods: Sequence[Pod]) -> None:
        known = {p.key for p in self.cache.scheduled_pods()}
        incoming = set()
        for p in pods:
            if not p.node_name:
                continue
            incoming.add(p.key)
            if p.key in known:
                self.cache.update_pod(p)
            else:
                self.cache.add_pod(p)
        for gone in known - incoming:
            self.cache.remove_pod(gone)

    # ------------------------------------------------------------------ #
    # IsInterested (extender.go:454-470)
    # ------------------------------------------------------------------ #

    def interested(self, pod: Pod) -> bool:
        if not self.managed_resources:
            return True
        for name, _ in pod.requests.scalars:
            if name in self.managed_resources:
                return True
        return False

    # ------------------------------------------------------------------ #
    # verb: Filter
    # ------------------------------------------------------------------ #

    def _snapshot_for(self, pod: Pod, cache: Optional[SchedulerCache] = None):
        return snapshot_with_keys(cache or self.cache, self.encoder, [pod],
                                  self.base_dims, device=self.device)

    def filter(self, args: ExtenderArgs) -> ExtenderFilterResult:
        with self._mu:
            try:
                pod = pod_from_v1(args.pod)
            except Exception as e:  # noqa: BLE001 — wire boundary
                return ExtenderFilterResult(error=f"bad pod: {e}")

            cache_capable = args.node_names is not None
            if not cache_capable and args.nodes is not None:
                # non-cache-capable callers ship full node objects; refresh the
                # mirror from them so the lattice reflects the caller's view
                self.upsert_nodes([node_from_v1(n) for n in args.nodes])

            snap, keys = self._snapshot_for(pod)
            mask = _feasible(snap.tables, snap.pending, keys, snap.dims.D,
                             snap.existing)[0].cpu().tolist()

            if cache_capable:
                candidates = args.node_names or []
            elif args.nodes is not None:
                candidates = [n["metadata"]["name"] for n in args.nodes]
            else:
                # neither form present: evaluate every mirrored node
                candidates = list(snap.node_order)
            index = {name: i for i, name in enumerate(snap.node_order)}

            passing: List[str] = []
            failed: Dict[str, str] = {}
            need_reasons = False
            for name in candidates:
                i = index.get(name)
                if i is not None and mask[i]:
                    passing.append(name)
                else:
                    failed[name] = ""
                    need_reasons = True

            if need_reasons:
                comp = [part[0].cpu().tolist() for part in _diagnose(
                    snap.tables, snap.pending, keys, snap.dims.D,
                    snap.existing)]
                for name in failed:
                    i = index.get(name)
                    if i is None:
                        failed[name] = "node not found in extender cache"
                        continue
                    # zip stops at the eighth reason: the volumes component
                    # has no reason string (and no wire pod fails it)
                    reasons = [r for r, part in zip(_REASONS, comp)
                               if not part[i]]
                    failed[name] = "; ".join(reasons) or "node is not feasible"

            if cache_capable:
                return ExtenderFilterResult(node_names=passing, failed_nodes=failed)
            by_name = {n["metadata"]["name"]: n for n in (args.nodes or [])}
            return ExtenderFilterResult(
                nodes=[by_name[n] for n in passing if n in by_name],
                failed_nodes=failed,
            )

    # ------------------------------------------------------------------ #
    # verb: Prioritize
    # ------------------------------------------------------------------ #

    def prioritize(self, args: ExtenderArgs) -> List[HostPriority]:
        with self._mu:
            pod = pod_from_v1(args.pod)
            snap, keys = self._snapshot_for(pod)
            # the f32 row as Python floats (each f32 exactly)
            raw = _scores(snap.tables, snap.pending, keys, snap.dims.D,
                          snap.existing)[0].cpu().tolist()

            candidates = (args.node_names if args.node_names is not None
                          else [n["metadata"]["name"] for n in (args.nodes or [])])
            index = {name: i for i, name in enumerate(snap.node_order)}
            vals: List[Tuple[str, float]] = []
            for name in candidates or []:
                i = index.get(name)
                s = float(raw[i]) if i is not None else float("-inf")
                vals.append((name, s))

            finite = [s for _, s in vals if s != float("-inf")]
            hi = max(finite) if finite else 0.0
            lo = min(finite) if finite else 0.0
            span = (hi - lo) or 1.0
            out: List[HostPriority] = []
            for name, s in vals:
                if s == float("-inf"):
                    out.append(HostPriority(host=name, score=0))
                else:
                    out.append(HostPriority(
                        host=name,
                        score=round((s - lo) / span * MAX_EXTENDER_PRIORITY),
                    ))
            return out

    # ------------------------------------------------------------------ #
    # verb: ProcessPreemption (extender.go:166-230)
    # ------------------------------------------------------------------ #

    def process_preemption(self, args: ExtenderPreemptionArgs) -> ExtenderPreemptionResult:
        with self._mu:
            pod = pod_from_v1(args.pod)

            # normalize both arg forms to {node: [victim pod keys or uids]}
            victims_by_node: Dict[str, List[str]] = {}
            if args.node_name_to_meta_victims:
                uid_to_key = {p.uid: p.key for p in self.cache.scheduled_pods()}
                for node, mv in args.node_name_to_meta_victims.items():
                    victims_by_node[node] = [uid_to_key.get(u, u) for u in mv.pods]
            else:
                for node, v in args.node_name_to_victims.items():
                    victims_by_node[node] = [pod_from_v1(p).key for p in v.pods]

            # one what-if dispatch per candidate node (victim sets differ per
            # node, so the existing-pod tensors differ), each on a fresh
            # probe cache and a full snapshot. This verb is the reference's
            # own cold path — the scheduler calls it once per preemption
            # attempt, not per cycle; the in-process preemptor
            # (sched/preemption.py) batches its what-ifs instead.
            result: Dict[str, MetaVictims] = {}
            all_scheduled = {p.key: p for p in self.cache.scheduled_pods()}
            key_to_uid = {p.key: p.uid for p in all_scheduled.values()}
            for node_name, victim_keys in victims_by_node.items():
                gone = set(victim_keys)
                keep = [p for k, p in all_scheduled.items() if k not in gone]
                probe = SchedulerCache()
                for n in self.cache.nodes():
                    probe.add_node(n)
                for p in keep:
                    probe.add_pod(p)
                snap, keys = self._snapshot_for(pod, cache=probe)
                try:
                    i = snap.node_order.index(node_name)
                except ValueError:
                    continue
                mask = _feasible(snap.tables, snap.pending, keys, snap.dims.D,
                                 snap.existing)[0]
                if bool(mask[i]):
                    result[node_name] = MetaVictims(
                        pods=[key_to_uid.get(k, k) for k in victim_keys]
                    )
            return ExtenderPreemptionResult(node_name_to_meta_victims=result)

    # ------------------------------------------------------------------ #
    # verb: Bind
    # ------------------------------------------------------------------ #

    def bind(self, args: ExtenderBindingArgs) -> ExtenderBindingResult:
        with self._mu:
            key = f"{args.pod_namespace}/{args.pod_name}"
            ok = True
            if self.binder is not None:
                pod = self.cache.get_pod(key) or Pod(
                    name=args.pod_name, namespace=args.pod_namespace, uid=args.pod_uid
                )
                try:
                    ok = self.binder(pod, args.node)
                except Exception as e:  # noqa: BLE001 — wire boundary
                    return ExtenderBindingResult(error=str(e))
            if not ok:
                return ExtenderBindingResult(error=f"bind {key} -> {args.node} failed")
            self.bound.append((key, args.node))
            return ExtenderBindingResult()
