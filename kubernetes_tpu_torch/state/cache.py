"""Scheduler cache: the host-side mirror of cluster state with the
assume/confirm/expire pod lifecycle and generation-diffed snapshots (port of
the JAX package's state/cache.py, single-device half).

Mirrors the semantics of the reference's schedulerCache
(pkg/scheduler/internal/cache/cache.go):

  * AssumePod / FinishBinding / ForgetPod  (cache.go:283,304,328) — optimistic
    commit: the scheduler marks a pod as placed *before* the API write lands so
    the next cycle sees its resources; a TTL reaps assumed pods whose bind
    confirmation never arrives (expiry goroutine, cache.go:634-667 — here an
    explicit `cleanup(now)` with an injected clock, testable without sleeping).
  * AddPod confirms an assumed pod (cache.go:394-427); Update/RemovePod keep
    the mirror in sync with informer events (cache.go:429-517).
  * Add/Update/RemoveNode (cache.go:519-567).
  * UpdateNodeInfoSnapshot (cache.go:204-255): one monotonic `generation`
    plus dirty node/pod sets. `snapshot()` returns the cached `Snapshot`
    untouched when nothing changed, re-encodes only the dirty rows into the
    host staging mirrors and scatters them into the resident device tensors
    when the change fits the existing capacities, and re-encodes everything
    only when a capacity (Dims) grows.

Device half. The resident tensors live on the snapshot's device (the CUDA
card by default). Every move from host staging onto the device COPIES
(state/arrays.py `to_device`): the staging mirrors are rewritten in place by
later snapshots, and on a CPU device a plain `.to()` would alias them. A
patch is an out-of-place `index_copy` per leaf that returns new tensors, so
every `Snapshot` stays immutable: callers keep old snapshots (micro_graft
shares `base.tables`, tests compare two), exactly as the JAX package's
non-donated jit patch leaves its inputs intact.

Mesh-resident mode (`snapshot(mesh=...)`, parallel/mesh.py): the node
capacity pads to a multiple of the mesh, the node planes live per shard
(`ShardedTables`, keyed by the Mesh object: a new mesh re-shards from the
host staging), and a steady-state patch writes each shard's own dirty rows
IN PLACE (`index_copy_`) — the port of the JAX package's donated patch —
while no dispatch holds the resident planes (`mark_dispatch_start/done`);
a snapshot taken while a dispatch is in flight (the scheduler's prestage)
takes the out-of-place copy path into new planes instead. The counters
`resident_full_uploads`, `resident_donated_patches` and
`resident_copy_patches` count the three. `warm_patch_ladder` drives the
patch shapes once each (the JAX package compiles them; the port has no
compile step).
Under KTPU_ASSIGN=runs every snapshot carries the
run-collapsed engine's RunPlan (ops/runs.py), counted on the host from the
same staging columns as the pending tensors.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..api.types import Node, Pod
from ..parallel.mesh import ShardedTables, padded_node_count, shard_tables
from .arrays import (ClusterTables, NodeArrays, PodArrays, resolve_device,
                     to_device)
from .dims import Dims
from .encode import Encoder

DEFAULT_ASSUME_TTL = 30.0  # durationToExpireAssumedPod, scheduler.go:268 (30s)

I32 = np.int32


def _patch_rows(tree, idx: torch.Tensor, rows):
    """Scatter `rows` (a NamedTuple of [k, …] tensors) into the device
    `tree` at row indices `idx` — the device half of the incremental
    snapshot (cache.go:204-255's per-NodeInfo copy). Out of place: returns a
    new tuple of new tensors and leaves `tree` as it was."""
    return type(tree)(*(a.index_copy(0, idx, r) for a, r in zip(tree, rows)))


class ResidentDonationError(RuntimeError):
    """An in-place resident patch did not write the resident planes (the
    JAX package's donation check: the old buffers must be consumed)."""


def _patch_resident(tree, idx: torch.Tensor, rows, donate: bool):
    """One resident scatter of a mesh snapshot. `donate=True` writes
    `tree`'s tensors in place (`index_copy_`: the planes keep their storage,
    as a donated XLA buffer is aliased into the output) and checks that they
    did; `donate=False` is the out-of-place `_patch_rows`."""
    if not donate:
        return _patch_rows(tree, idx, rows)
    ptrs = [a.data_ptr() for a in tree]
    out = type(tree)(*(a.index_copy_(0, idx, r) for a, r in zip(tree, rows)))
    if [a.data_ptr() for a in out] != ptrs:
        raise ResidentDonationError(
            "mesh-resident patch did not write the resident planes in place")
    return out


def _patch_index(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    """The padded int32 row indices as the int64 tensor `index_copy` needs,
    on the snapshot's device."""
    return torch.from_numpy(idx.astype(np.int64)).to(device)


def _pad_patch(idx: List[int], k_bucket: int) -> np.ndarray:
    """Pad the dirty-row index list to a bucketed length by repeating the
    first index — the repeated copy of identical rows is idempotent, and the
    bucket keeps the patch shapes (and `last_patch_rows` accounting) equal
    to the JAX package's."""
    out = np.full((k_bucket,), idx[0], I32)
    out[: len(idx)] = idx
    return out


def _patch_bucket(n: int) -> int:
    """Patch-scatter index bucket: pure powers of two, FLOORED at 64 (the
    JAX package's ladder, which bounds its compile count; here it only fixes
    the padded shapes)."""
    p = 64
    while p < n:
        p <<= 1
    return p


@dataclass
class _PodState:
    """podState (cache.go:52-58): the pod plus its assume bookkeeping."""

    pod: Pod
    assumed: bool = False
    binding_finished: bool = False
    deadline: Optional[float] = None  # set by finish_binding; None = no expiry


class CacheError(RuntimeError):
    """Raised on lifecycle violations the reference treats as logic errors
    (cache.go returns errors / Fatalf on cache corruption, cache.go:445,473)."""


@dataclass
class Snapshot:
    """An immutable per-cycle view (nodeinfo/snapshot/snapshot.go): encoded
    device tables + the node-name order they were built in + the generation
    they reflect."""

    generation: int
    node_order: List[str]
    tables: object            # ClusterTables (device tensors)
    existing: object          # PodArrays (device tensors)
    pending: object           # PodArrays (device tensors)
    dims: Dims
    pending_keys: Tuple[Tuple[str, int], ...]  # (pod key, object identity)
    existing_keys: Tuple[str, ...] = ()  # row order of `existing`
    gang: object = None  # GangArrays (ops/gang.py) on the snapshot's
                         # device when any pending pod is gang-grouped; None
                         # routes the plain engines
    device: Optional[torch.device] = None  # where the tensors live
    runs: object = None  # ops/runs.py RunPlan when KTPU_ASSIGN=runs: the
                         # host-counted run-length encoding of the pending
                         # wave (run capacity + collapse telemetry)
    mesh: object = None  # parallel/mesh.py Mesh when `tables` is
                         # ShardedTables (node planes resident per shard);
                         # keyed by IDENTITY: a reformed mesh re-shards


class SchedulerCache:
    """Thread-safe pod/node mirror. A single writer (the event-handler thread)
    and a single reader (the scheduling loop) is the expected pattern, matching
    the reference's `cache.mu` discipline."""

    def __init__(self, ttl: float = DEFAULT_ASSUME_TTL) -> None:
        self._mu = threading.RLock()
        self._ttl = ttl
        self._nodes: Dict[str, Node] = {}
        self._pods: Dict[str, _PodState] = {}
        self._generation = 0
        self._snapshot: Optional[Snapshot] = None
        # ---- incremental snapshot state (cache.go:204-255 analog) ----
        # pods grouped by node: the unit of row re-encode is one node row
        self._by_node: Dict[str, Dict[str, Pod]] = {}
        self._dirty_nodes: Set[str] = set()           # rows to re-encode
        self._dirty_pods: Dict[str, Optional[Pod]] = {}  # key → Pod | None(del)
        # stable slot assignment: device row index per node / existing pod
        self._node_slot: Dict[str, int] = {}
        self._node_names: List[str] = []              # slot → name ("" freed)
        self._free_node_slots: List[int] = []
        self._pod_slot: Dict[str, int] = {}
        self._pod_keys: List[str] = []                # slot → key ("" freed)
        self._free_pod_slots: List[int] = []
        # host numpy staging mirrors of the device tensors
        self._staging_nodes: Optional[NodeArrays] = None
        self._staging_pod_rows: Optional[np.ndarray] = None   # [E, 6] i32
        self._staging_pod_valid: Optional[np.ndarray] = None  # [E] bool
        self._staging_pod_node: Optional[np.ndarray] = None   # [E] i32
        self._encoder: Optional[Encoder] = None
        self._reg_sizes: Dict[str, int] = {}
        self._n_topo_keys = 0
        # pending-batch staging (see _pending_block)
        self._pending_stage = None
        self._pending_stage_keys: Optional[Tuple] = None
        # introspection for tests/bench: how the last snapshot was produced
        self.last_snapshot_mode: str = ""   # "cached" | "patch" | "full"
        self.last_patch_rows: int = 0
        # gang groups: bound/assumed member count per group key (the gang
        # engine nets snapshot `needed` against these)
        self._group_bound: Dict[str, int] = {}
        # (plane shapes, index bucket) rungs warm_patch_ladder has driven
        self._ladder_warmed: Set[Tuple] = set()
        # ---- mesh-resident accounting (the JAX package's donation
        # contract): full shard_tables uploads (cold, capacity growth, a
        # new mesh); steady-state patches written in place; patches that
        # took the copy path because a dispatch held the planes
        self.resident_full_uploads: int = 0
        self.resident_donated_patches: int = 0
        self.resident_copy_patches: int = 0
        # dispatches now holding the current snapshot's planes
        self._dispatch_inflight: int = 0
        # did the last _pending_block scatter into the resident block
        self._last_pending_patched = False

    # -- dirty-tracking helpers (callers hold self._mu) -- #

    def _pod_placed(self, pod: Pod) -> None:
        if pod.node_name:
            self._by_node.setdefault(pod.node_name, {})[pod.key] = pod
            self._dirty_nodes.add(pod.node_name)
        self._dirty_pods[pod.key] = pod
        gk = pod.group_key
        if gk:
            self._group_bound[gk] = self._group_bound.get(gk, 0) + 1

    def _pod_unplaced(self, pod: Pod) -> None:
        if pod.node_name:
            self._by_node.get(pod.node_name, {}).pop(pod.key, None)
            self._dirty_nodes.add(pod.node_name)
        self._dirty_pods[pod.key] = None
        gk = pod.group_key
        if gk:
            c = self._group_bound.get(gk, 0) - 1
            if c > 0:
                self._group_bound[gk] = c
            else:
                self._group_bound.pop(gk, None)

    @property
    def node_count(self) -> int:
        with self._mu:
            return len(self._nodes)

    @property
    def pod_count(self) -> int:
        with self._mu:
            return len(self._pods)

    def group_bound_count(self, group_key: str) -> int:
        """Bound/assumed members of a gang group."""
        with self._mu:
            return self._group_bound.get(group_key, 0)

    # ------------------------------------------------------------------ #
    # pod lifecycle (cache.go:283-517)
    # ------------------------------------------------------------------ #

    def assume_pod(self, pod: Pod, node_name: str) -> None:
        """AssumePod (cache.go:283): optimistic placement of a scheduled pod."""
        with self._mu:
            key = pod.key
            if key in self._pods:
                raise CacheError(f"pod {key} is already in the cache")
            p = replace(pod, node_name=node_name)
            self._pods[key] = _PodState(pod=p, assumed=True)
            self._pod_placed(p)
            self._generation += 1

    def finish_binding(self, key: str, now: float) -> None:
        """FinishBinding (cache.go:304): the async bind goroutine completed its
        API write; start the expiry clock in case the confirming informer event
        never arrives."""
        with self._mu:
            st = self._pods.get(key)
            if st is None or not st.assumed:
                return  # finished binding for a pod no longer assumed: no-op
            st.binding_finished = True
            st.deadline = now + self._ttl

    def forget_pod(self, key: str) -> None:
        """ForgetPod (cache.go:328): bind/permit/volume failure rollback."""
        with self._mu:
            st = self._pods.get(key)
            if st is None:
                return
            if not st.assumed:
                raise CacheError(f"pod {key} is bound, cannot forget")
            del self._pods[key]
            self._pod_unplaced(st.pod)
            self._generation += 1

    def add_pod(self, pod: Pod) -> None:
        """AddPod (cache.go:394): informer confirmation. Confirms an assumed
        pod (clears its deadline) or inserts a pod scheduled by someone else."""
        with self._mu:
            key = pod.key
            st = self._pods.get(key)
            if st is not None and st.assumed:
                # confirmation — possibly onto a different node than assumed
                # (cache.go:404-410 logs and corrects)
                self._pod_unplaced(st.pod)
                self._pods[key] = _PodState(pod=pod)
            elif st is None:
                self._pods[key] = _PodState(pod=pod)
            else:
                raise CacheError(f"pod {key} was already added")
            self._pod_placed(pod)
            self._generation += 1

    def update_pod(self, pod: Pod) -> None:
        """UpdatePod (cache.go:429). Assumed pods are not updatable — the
        reference treats an update event for an assumed pod as corruption."""
        with self._mu:
            st = self._pods.get(pod.key)
            if st is None or st.assumed:
                raise CacheError(f"pod {pod.key} is not bound in the cache")
            self._pod_unplaced(st.pod)
            st.pod = pod
            self._pod_placed(pod)
            self._generation += 1

    def remove_pod(self, key: str) -> None:
        """RemovePod (cache.go:457)."""
        with self._mu:
            st = self._pods.get(key)
            if st is None:
                raise CacheError(f"pod {key} is not in the cache")
            del self._pods[key]
            self._pod_unplaced(st.pod)
            self._generation += 1

    def is_assumed(self, key: str) -> bool:
        with self._mu:
            st = self._pods.get(key)
            return bool(st and st.assumed)

    def forget_assumed(self) -> List[Pod]:
        """Drop EVERY assumed-but-unconfirmed pod (takeover reconciliation):
        a new leader rebuilds its optimistic state from informer truth.
        Returns the forgotten Pod objects (their node_name still carries the
        assumed placement) so the caller can requeue them."""
        dropped: List[Pod] = []
        with self._mu:
            for key, st in list(self._pods.items()):
                if st.assumed:
                    del self._pods[key]
                    self._pod_unplaced(st.pod)
                    dropped.append(st.pod)
            if dropped:
                self._generation += 1
        return dropped

    def pods_on_node(self, name: str) -> List[Pod]:
        """All pods (bound + assumed) occupying one node."""
        with self._mu:
            return list(self._by_node.get(name, {}).values())

    def get_node(self, name: str) -> Optional[Node]:
        with self._mu:
            return self._nodes.get(name)

    def invalidate_snapshot(self) -> None:
        """Force the next snapshot onto the FULL re-encode path (scratch
        staging + one device transfer), discarding the incremental state."""
        with self._mu:
            self._snapshot = None
            self._staging_nodes = None
            self._staging_pod_rows = None
            self._staging_pod_valid = None
            self._staging_pod_node = None
            self._pending_stage = None
            self._pending_stage_keys = None
            self._generation += 1

    def get_pod(self, key: str) -> Optional[Pod]:
        with self._mu:
            st = self._pods.get(key)
            return st.pod if st else None

    # ------------------------------------------------------------------ #
    # node lifecycle (cache.go:519-567)
    # ------------------------------------------------------------------ #

    def add_node(self, node: Node) -> None:
        with self._mu:
            self._nodes[node.name] = node
            self._dirty_nodes.add(node.name)
            self._generation += 1

    def update_node(self, node: Node) -> None:
        with self._mu:
            self._nodes[node.name] = node
            self._dirty_nodes.add(node.name)
            self._generation += 1

    def remove_node(self, name: str) -> None:
        with self._mu:
            if name not in self._nodes:
                raise CacheError(f"node {name} is not in the cache")
            del self._nodes[name]
            self._dirty_nodes.add(name)
            self._generation += 1

    # ------------------------------------------------------------------ #
    # expiry (cache.go:634-667)
    # ------------------------------------------------------------------ #

    def cleanup(self, now: float) -> List[str]:
        """cleanupAssumedPods: drop assumed pods whose bind finished but whose
        confirming watch event never arrived within the TTL. Returns the
        expired keys (the reference logs a warning per pod, cache.go:657)."""
        expired: List[str] = []
        with self._mu:
            for key, st in list(self._pods.items()):
                if st.assumed and st.binding_finished and st.deadline is not None \
                        and now >= st.deadline:
                    del self._pods[key]
                    self._pod_unplaced(st.pod)
                    expired.append(key)
            if expired:
                self._generation += 1
        return expired

    # ------------------------------------------------------------------ #
    # snapshot (cache.go:204-255)
    # ------------------------------------------------------------------ #

    def scheduled_pods(self) -> List[Pod]:
        """All pods occupying node resources: bound + assumed."""
        with self._mu:
            return [st.pod for st in self._pods.values()]

    def nodes(self) -> List[Node]:
        with self._mu:
            return list(self._nodes.values())

    @property
    def generation(self) -> int:
        with self._mu:
            return self._generation

    def counts(self) -> Tuple[int, int, int]:
        """(nodes, total pods, assumed pods) — the cache-size gauges
        (cache.go:692-696)."""
        with self._mu:
            assumed = sum(1 for s in self._pods.values() if s.assumed)
            return len(self._nodes), len(self._pods), assumed

    def mark_dispatch_start(self) -> None:
        """A dispatch now holds the current snapshot's tensors (the
        scheduler calls this before handing them to the dispatch worker).
        While one is in flight, mesh-resident patches take the copy path."""
        with self._mu:
            self._dispatch_inflight += 1

    def mark_dispatch_done(self) -> None:
        with self._mu:
            self._dispatch_inflight = max(self._dispatch_inflight - 1, 0)

    def snapshot(
        self,
        encoder: Encoder,
        pending: Sequence[Pod],
        base_dims: Optional[Dims] = None,
        extra_intern: Sequence[str] = (),
        device: object = None,
        mesh: object = None,
    ) -> Snapshot:
        """UpdateNodeInfoSnapshot analog (cache.go:204-255): return the cached
        encoded view when nothing changed; re-encode ONLY the dirty node/pod
        rows and scatter them into the resident device tensors when the
        change fits the existing capacities; fall back to a full encode +
        transfer only when a capacity (Dims) actually grows.

        `device` is where the tensors live: the CUDA card when None (raising
        without one), or the device named. The pending signature includes
        object identity, not just pod keys: a spec update flows through the
        queue as a *new* Pod object with the same namespace/name
        (queue.update), and scheduling it against the cached encoding of the
        old spec would pin it unschedulable forever.

        With a `mesh` the node planes are resident per shard (see the module
        docstring); the pod tensors and the gang arrays live on `device`."""
        device = resolve_device(device)
        pending_keys = tuple((p.key, id(p)) for p in pending)
        with self._mu:
            gen = self._generation
            snap = self._snapshot
            if snap is not None and snap.generation == gen \
                    and snap.pending_keys == pending_keys \
                    and snap.device == device and snap.mesh is mesh \
                    and (base_dims is None
                         or snap.dims == snap.dims.union(base_dims)) \
                    and self._reg_sizes == self._registry_sizes(encoder):
                # the base_dims guard: a caller may GROW the floor between
                # calls — a cached snapshot at the old capacities must not
                # short-circuit the re-encode that pads up to it. The
                # registry-sizes guard: the micro path interns its
                # watch-delta pods BEFORE asking for the base snapshot with
                # an EMPTY pending batch — generation and pending signature
                # both unchanged — so a first-seen request/labelset/class
                # must fall through to the patch path's grown-table rebuild,
                # or the graft would score the new pods against interned
                # tables that end before their ids.
                self.last_snapshot_mode = "cached"
                return snap

            for s in extra_intern:
                encoder.vocabs.label_keys.intern(s)
            projection_widened = False
            converged = False
            for _walk_pass in range(8):  # referenced keys grow monotonically
                encoder.intern_pods(pending)  # memoized batch: O(new)
                if (self._staging_nodes is None
                        or self._encoder is not encoder
                        or projection_widened):
                    # cold: walk everything (batch path)
                    encoder.intern_pods(
                        [st.pod for st in self._pods.values()])
                else:
                    encoder.intern_pods(
                        [p for p in self._dirty_pods.values()
                         if p is not None])   # steady state: O(changed)
                if not encoder.classes_stale:
                    converged = True
                    break
                # a selector referenced a new pod-label key mid-walk:
                # projected class identities (encode.py class_id) changed
                # for every pod — drop memos, re-walk ALL pods, and force
                # the full snapshot path (staged rows hold old class ids).
                encoder.projection_rewalk()
                projection_widened = True
            if not converged:
                # staged class ids would be stale: fail loud instead of
                # silently mis-placing
                from .encode import ProjectionUnconvergedError

                raise ProjectionUnconvergedError(
                    "label projection did not converge after 8 re-walk "
                    "passes; "
                    f"{len(encoder.referenced_label_keys)} referenced keys")
            for name in self._dirty_nodes:
                n = self._nodes.get(name)
                if n is not None:
                    encoder.intern_node(n)

            # slot releases for removed nodes come FIRST so a same-window
            # remove+add nets out instead of growing capacity; then slot
            # allocation in node-insertion order so the lattice's node-index
            # tie-breaks are a deterministic function of event order. Slots
            # are decided here (not in the mutators) so they stay consistent
            # with the staging arrays even when snapshots are skipped.
            released_nodes: List[int] = []
            for name in [nm for nm in self._dirty_nodes
                         if nm not in self._nodes]:
                slot = self._node_slot.pop(name, None)
                if slot is None:
                    continue
                self._node_names[slot] = ""
                self._free_node_slots.append(slot)
                released_nodes.append(slot)
                if self._staging_nodes is not None:
                    for f in self._staging_nodes:
                        f[slot] = False if f.dtype == bool else (
                            0 if f.dtype == np.uint32 else -1)
                    self._staging_nodes.alloc[slot] = 0
                    self._staging_nodes.used[slot] = 0
                    self._staging_nodes.label_ints[slot] = 0
                # pods still bound to the vanished node must stop pointing at
                # the freed slot (a later node may reuse it); re-row them
                for key, p in self._by_node.get(name, {}).items():
                    self._dirty_pods.setdefault(key, p)
            for name in self._nodes:
                if name in self._dirty_nodes and name not in self._node_slot:
                    if self._free_node_slots:
                        slot = self._free_node_slots.pop()
                        self._node_names[slot] = name
                    else:
                        slot = len(self._node_names)
                        self._node_names.append(name)
                    self._node_slot[name] = slot
                    # pods that bound to this node while it had no slot (watch
                    # ordering / node re-add) carry node_id=-1 rows; re-row
                    # them so counts and victim discovery see them again
                    for key, p in self._by_node.get(name, {}).items():
                        self._dirty_pods.setdefault(key, p)
            pod_frees = len(self._free_pod_slots) + sum(
                1 for k, p in self._dirty_pods.items()
                if p is None and k in self._pod_slot)
            new_pods = sum(1 for k, p in self._dirty_pods.items()
                           if p is not None and k not in self._pod_slot)
            n_pod_slots = len(self._pod_keys) + max(new_pods - pod_frees, 0)

            d = encoder.dims(
                len(self._node_names), n_pod_slots, len(pending),
                list(self._nodes.values()),
                # capacities are monotonic ACROSS cycles: seed from the live
                # snapshot so a smaller pending batch doesn't shrink P and
                # masquerade as a capacity change; the seed is the UNION of
                # the live snapshot's dims and the caller's base_dims
                snap.dims.union(base_dims) if snap is not None
                else base_dims,
            )
            # the engine-routing flag is per-batch, not a capacity: it must
            # not force a full re-encode when it flips
            d = replace(d, has_node_name=any(p.node_name for p in pending))
            if mesh is not None and d.N % mesh.size:
                # each shard owns N / mesh.size rows: pad the CAPACITY (the
                # extra slots are inert like any unoccupied slot), so the
                # staging and resident shapes agree and patches stay stable
                d = replace(d, N=padded_node_count(d.N, mesh.size))

            full = (
                snap is None
                or self._staging_nodes is None
                or self._encoder is not encoder
                or projection_widened
                # placement change: the resident tensors live on the other
                # device; rebuild from the host staging
                or snap.device != device
                # a mesh change (first shard, reform, drop to one device):
                # the resident planes carry the old layout
                or snap.mesh is not mesh
                or replace(d, has_node_name=False)
                != replace(snap.dims, has_node_name=False)
            )
            if full:
                return self._full_snapshot(encoder, pending, pending_keys,
                                           gen, d, base_dims, device, mesh)
            return self._patch_snapshot(encoder, pending, pending_keys,
                                        gen, d, snap, released_nodes, device)

    def warm_patch_ladder(self, snap: Snapshot) -> int:
        """Drive one no-op `index_copy` per rung of the patch ladder of
        `snap`'s resident planes (nodes / existing / pending) — each rung a
        `_patch_bucket` index length {64, 128, ..., capacity}, the shapes
        the incremental snapshot dispatches. The port of the JAX package's
        warm_patch_ladder, whose rungs are jit compiles; here each rung runs
        the scatter once at its shape (the allocator's blocks, the launch).
        The copies are out of place and discarded, so the live tensors are
        never written. Runs on the caller's current stream (the prewarmer's,
        which waits for the default stream first); on CUDA each live input
        is recorded on that stream so the allocator keeps it alive until the
        warm's reads finish. Returns the number of rungs driven by THIS
        call — the same count as the JAX package's for the same snapshot;
        repeat calls are memoized on plane shapes."""
        driven = 0
        node_trees = ([s.nodes for s in snap.tables.shards]
                      if isinstance(snap.tables, ShardedTables)
                      else [snap.tables.nodes])
        for tree in (*node_trees, snap.existing, snap.pending):
            leaves = list(tree)
            if not leaves:
                continue
            device = leaves[0].device
            side = None
            if device.type == "cuda":
                side = torch.cuda.current_stream(device)
                if side == torch.cuda.default_stream(device):
                    side = None
            # top rung: _patch_bucket(cap), not cap — capacities are
            # eight-per-octave (dims.bucket), and the live ladder rounds
            # up past them
            top = _patch_bucket(int(leaves[0].shape[0]))
            shapes = tuple((tuple(a.shape), str(a.dtype)) for a in leaves)
            kb = 64
            while True:
                key = (shapes, kb)
                if key not in self._ladder_warmed:
                    self._ladder_warmed.add(key)
                    idx = torch.zeros((kb,), dtype=torch.int64,
                                      device=device)
                    rows = type(tree)(*(
                        torch.zeros((kb,) + tuple(a.shape[1:]),
                                    dtype=a.dtype, device=device)
                        for a in leaves))
                    try:
                        if side is not None:
                            for a in leaves:
                                a.record_stream(side)
                        _patch_rows(tree, idx, rows)
                        driven += 1
                    except Exception:  # noqa: BLE001 - warm is an
                        # optimization, never fatal
                        self._ladder_warmed.discard(key)
                if kb >= top:
                    break
                kb *= 2
        return driven

    def micro_graft(self, encoder: Encoder, pending: Sequence[Pod],
                    base: Snapshot, micro_p: int,
                    device: object = None, mesh: object = None) -> Snapshot:
        """Micro-wave pending graft (streaming admission): an EPHEMERAL
        Snapshot sharing `base`'s resident cluster tables and existing-pod
        tensors (the caller just brought them current via the ordinary
        generation-diffed `snapshot()` with an empty pending batch) with a
        small standalone [micro_p] pending block for the watch-delta pods.

        The graft is NOT stored as `_snapshot`: the cached resident view
        keeps diffing against the bulk pipeline's snapshots, so a micro
        wave between two bulk waves costs the bulk path nothing. Dims are
        `base.dims` with only P swapped to the fixed micro capacity (and
        has_node_name False — queue eligibility excludes pinned pods). The
        caller must have interned `pending` into `encoder` BEFORE building
        `base` (cycle.micro_snapshot_with_keys does), so any registry or
        capacity growth the new pods cause is already reflected in
        `base.dims`/`base.tables`. The graft keeps `base`'s mesh (`mesh`
        names the same one: the caller's snapshot placement)."""
        device = resolve_device(device)
        d = replace(base.dims, P=micro_p, has_node_name=False)
        with self._mu:
            pe_host = encoder.build_pod_arrays(
                list(pending), d, self._node_slot, capacity=d.P)
            runs_plan = self._run_plan_from_cols(
                pe_host.cls, pe_host.priority, pe_host.creation,
                pe_host.valid, pe_host.node_name_req) \
                if self._runs_wanted() else None
            gang = self._gang_arrays(encoder, pending, d, device)
        return Snapshot(
            generation=base.generation,
            node_order=base.node_order,
            tables=base.tables,
            existing=base.existing,
            pending=to_device(pe_host, device),
            dims=d,
            pending_keys=tuple((p.key, id(p)) for p in pending),
            existing_keys=base.existing_keys,
            gang=gang,
            device=device,
            runs=runs_plan,
            mesh=base.mesh,
        )

    @staticmethod
    def _runs_wanted() -> bool:
        return os.environ.get("KTPU_ASSIGN") == "runs"

    @staticmethod
    def _run_plan_from_cols(cls, priority, creation, valid, nnr):
        """RunPlan over host staging columns (numpy, no device readback)."""
        from ..ops.runs import plan_runs

        return plan_runs(cls, priority, creation, valid, nnr)

    def _run_plan_from_stage(self):
        stage = self._pending_stage
        if stage is None:
            return None
        rows = stage.rows
        return self._run_plan_from_cols(rows[:, 2], rows[:, 3], rows[:, 4],
                                        stage.valid, rows[:, 5])

    @staticmethod
    def _registry_sizes(encoder: Encoder) -> Dict[str, int]:
        return {
            "reqs": len(encoder.req_reg),
            "labelsets": len(encoder.labelset_reg),
            "nterms": len(encoder.nterm_reg),
            "tolsets": len(encoder.tolset_reg),
            "portsets": len(encoder.portset_reg),
            "terms": len(encoder.term_reg),
            "classes": len(encoder.class_reg),
            "images": len(encoder.vocabs.images),
            "volsets": len(encoder.volset_reg),
        }

    def _gang_arrays(self, encoder: Encoder, pending, d: Dims, device):
        """Per-cycle GangArrays for the pending batch on `device` (copies, as
        every table: `to_device`), netting each group's `needed` against
        members already bound/assumed here."""
        bound = {encoder.pod_groups.get(gk): c
                 for gk, c in self._group_bound.items()
                 if encoder.pod_groups.get(gk) >= 0}
        g = encoder.build_gang_arrays(list(pending), d, bound)
        return None if g is None else to_device(g, device)

    def _existing_pod_arrays(self, d: Dims) -> PodArrays:
        rows = self._staging_pod_rows
        return PodArrays(
            valid=self._staging_pod_valid[: d.E],
            name_id=rows[: d.E, 0], ns=rows[: d.E, 1], cls=rows[: d.E, 2],
            priority=rows[: d.E, 3], creation=rows[: d.E, 4],
            node_id=self._staging_pod_node[: d.E],
            node_name_req=rows[: d.E, 5],
        )

    def _full_snapshot(self, encoder, pending, pending_keys, gen, d,
                       base_dims: Optional[Dims], device,
                       mesh=None) -> Snapshot:
        """Cold path: rebuild staging + every device table. Runs when
        capacities grow or on first use."""
        self.last_snapshot_mode = "full"
        # compact, stable slot assignment
        live_nodes = [nm for nm in self._node_names if nm in self._nodes]
        for nm in self._nodes:
            if nm not in self._node_slot:
                live_nodes.append(nm)
        self._node_names = live_nodes
        self._node_slot = {nm: i for i, nm in enumerate(live_nodes)}
        self._free_node_slots = []
        self._pod_keys = list(self._pods.keys())
        self._pod_slot = {k: i for i, k in enumerate(self._pod_keys)}
        self._free_pod_slots = []

        nodes = [self._nodes[nm] for nm in self._node_names]
        # full re-encode rebuilds every row anyway — the free moment to
        # compact churn-accumulated domain ids (hostname-keyed spread makes
        # every node name ever seen a domain otherwise) and shrink D back
        from .dims import bucket
        encoder.rebuild_domain_maps(nodes)
        max_dom = max((len(dm) for dm in encoder.domain_maps), default=1)
        floor_d = (base_dims.D if base_dims is not None else Dims().D)
        new_D = max(bucket(max_dom), floor_d)
        if new_D < d.D:
            d = replace(d, D=new_D)
        # same for gang group ids: finished jobs would otherwise grow GR
        # (and the full-re-encode cadence) forever
        encoder.compact_groups(
            [st.pod for st in self._pods.values()] + list(pending))
        floor_gr = (base_dims.GR if base_dims is not None else Dims().GR)
        new_GR = max(bucket(max(len(encoder.pod_groups), 1)), floor_gr)
        if new_GR < d.GR:
            d = replace(d, GR=new_GR)
        self._staging_nodes = encoder.empty_node_arrays(d)
        for i, n in enumerate(nodes):
            encoder.encode_node_row(
                self._staging_nodes, i, n,
                list(self._by_node.get(n.name, {}).values()), d)

        self._staging_pod_rows = np.zeros((d.E, 6), I32)
        self._staging_pod_rows[:, 0] = -1
        self._staging_pod_rows[:, 1] = -1
        self._staging_pod_rows[:, 5] = -1
        self._staging_pod_valid = np.zeros((d.E,), bool)
        self._staging_pod_node = np.full((d.E,), -1, I32)
        for i, k in enumerate(self._pod_keys):
            p = self._pods[k].pod
            self._staging_pod_rows[i] = encoder.pod_row(p)
            self._staging_pod_valid[i] = True
            self._staging_pod_node[i] = self._node_slot.get(p.node_name, -1)

        tables = ClusterTables(
            nodes=self._staging_nodes,
            reqs=encoder.build_req_table(d),
            labelsets=encoder.build_labelset_table(d),
            nterms=encoder.build_nterm_table(d),
            tolsets=encoder.build_tolset_table(d),
            portsets=encoder.build_portset_table(d),
            terms=encoder.build_term_table(d),
            classes=encoder.build_class_table(d),
            images=encoder.build_image_table(d),
            zone_keys=encoder.build_zone_keys(),
            volsets=encoder.build_volset_table(d),
            drv_masks=encoder.build_drv_masks(d),
        )
        pe = encoder.build_pod_arrays(list(pending), d, self._node_slot,
                                      capacity=d.P)
        runs_plan = self._run_plan_from_cols(
            pe.cls, pe.priority, pe.creation, pe.valid,
            pe.node_name_req) if self._runs_wanted() else None
        if mesh is not None:
            tables_dev = shard_tables(tables, mesh)
            self.resident_full_uploads += 1
        else:
            tables_dev = to_device(tables, device)
        snap = Snapshot(
            generation=gen,
            node_order=list(self._node_names),
            tables=tables_dev,
            existing=to_device(self._existing_pod_arrays(d), device),
            pending=to_device(pe, device),
            dims=d,
            pending_keys=pending_keys,
            existing_keys=tuple(self._pod_keys),
            gang=self._gang_arrays(encoder, pending, d, device),
            device=device,
            runs=runs_plan,
            mesh=mesh,
        )
        self._encoder = encoder
        self._reg_sizes = self._registry_sizes(encoder)
        self._n_topo_keys = len(encoder.vocabs.topo_keys)
        # the pending stage holds rows interned under THIS encoder's
        # vocabularies; a full re-encode (possibly with a fresh encoder)
        # makes them unusable for diffing
        self._pending_stage = None
        self._pending_stage_keys = None
        self._dirty_nodes.clear()
        self._dirty_pods.clear()
        self.last_patch_rows = len(self._node_names)
        self._snapshot = snap
        return snap

    def _patch_snapshot(self, encoder, pending, pending_keys, gen, d,
                        snap: Snapshot, released_nodes: Sequence[int],
                        device) -> Snapshot:
        """Steady-state path: O(changed) host work, O(changed) device scatter
        — no full re-encode, no full re-upload. Every scatter is out of
        place, so `snap` keeps its tensors."""
        self.last_snapshot_mode = "patch"

        # --- new topology keys: backfill only the new [N] topo column(s) ---
        # As long as the key fits the existing K/D capacities (Dims
        # unchanged — the caller already checked), the column is a pure
        # function of node labels the staging mirror already holds: derive
        # it host-side and ship the [N, K] topo/domain planes, keeping an
        # adversarial label stream on the patch path.
        nk = len(encoder.vocabs.topo_keys)
        topo_grew = nk != self._n_topo_keys
        if topo_grew:
            for ki in range(self._n_topo_keys, nk):
                key = encoder.vocabs.topo_keys.lookup(ki)
                dm = (encoder.domain_maps[ki]
                      if ki < len(encoder.domain_maps) else {})
                for slot, nm in enumerate(self._node_names):
                    n = self._nodes.get(nm)
                    val = n.labels.get(key) if n is not None else None
                    if val is None:
                        continue
                    vid = encoder.vocabs.label_vals.get(val)
                    # both planes, exactly as encode_node_row writes them:
                    # `topo` (label-value id) and `domain` (compact domain
                    # id — what the interpod/topospread ops read)
                    self._staging_nodes.topo[slot, ki] = vid
                    self._staging_nodes.domain[slot, ki] = dm.get(vid, -1)
            self._n_topo_keys = nk

        # --- node rows (removed nodes were already cleared in snapshot()) ---
        node_idx: List[int] = list(released_nodes)
        for name in sorted(self._dirty_nodes):
            n = self._nodes.get(name)
            if n is None:
                continue
            slot = self._node_slot[name]
            encoder.encode_node_row(
                self._staging_nodes, slot, n,
                list(self._by_node.get(name, {}).values()), d)
            node_idx.append(slot)

        # mesh-resident: in place while no dispatch holds the tensors (the
        # JAX package's donation), else the copy path; one count per patch
        donate = snap.mesh is not None and self._dispatch_inflight == 0
        patched = False
        tables = snap.tables
        if snap.mesh is not None:
            tables, patched = self._patch_sharded_nodes(
                tables, node_idx, topo_grew, encoder, donate)
        else:
            if topo_grew:
                tables = tables._replace(
                    nodes=tables.nodes._replace(
                        topo=to_device(self._staging_nodes.topo, device),
                        domain=to_device(self._staging_nodes.domain, device)),
                    zone_keys=to_device(encoder.build_zone_keys(), device))
            if node_idx:
                kb = _patch_bucket(len(node_idx))
                idx = _pad_patch(node_idx, kb)
                rows = NodeArrays(*[f[idx] for f in self._staging_nodes])
                tables = tables._replace(
                    nodes=_patch_rows(tables.nodes, _patch_index(idx, device),
                                      to_device(rows, device)))

        # --- small interned tables: rebuild only the ones whose registry grew
        sizes = self._registry_sizes(encoder)
        if sizes != self._reg_sizes:
            builders = {
                "reqs": encoder.build_req_table,
                "labelsets": encoder.build_labelset_table,
                "nterms": encoder.build_nterm_table,
                "tolsets": encoder.build_tolset_table,
                "portsets": encoder.build_portset_table,
                "terms": encoder.build_term_table,
                "classes": encoder.build_class_table,
                "images": encoder.build_image_table,
                "volsets": encoder.build_volset_table,
            }
            grown = {k: builders[k](d) for k in builders
                     if sizes[k] != self._reg_sizes[k]}
            if snap.mesh is not None:
                tables = self._replace_replicated(tables, grown)
            else:
                tables = tables._replace(**{
                    k: to_device(v, device) for k, v in grown.items()})
            self._reg_sizes = sizes

        # --- existing-pod rows: removals first so a same-window remove+add
        # reuses the freed slot instead of growing past capacity ---
        pod_idx: List[int] = []
        for key in sorted(self._dirty_pods):
            if self._dirty_pods[key] is not None:
                continue
            slot = self._pod_slot.pop(key, None)
            if slot is None:
                continue
            self._pod_keys[slot] = ""
            self._free_pod_slots.append(slot)
            self._staging_pod_valid[slot] = False
            self._staging_pod_rows[slot] = (-1, -1, 0, 0, 0, -1)
            self._staging_pod_node[slot] = -1
            pod_idx.append(slot)
        for key in sorted(self._dirty_pods):
            pod = self._dirty_pods[key]
            if pod is None:
                continue
            slot = self._pod_slot.get(key)
            if slot is None:
                if self._free_pod_slots:
                    slot = self._free_pod_slots.pop()
                    self._pod_keys[slot] = key
                else:
                    slot = len(self._pod_keys)
                    self._pod_keys.append(key)
                self._pod_slot[key] = slot
            self._staging_pod_rows[slot] = encoder.pod_row(pod)
            self._staging_pod_valid[slot] = True
            self._staging_pod_node[slot] = self._node_slot.get(
                pod.node_name, -1)
            pod_idx.append(slot)

        existing = snap.existing
        if pod_idx:
            kb = _patch_bucket(len(pod_idx))
            idx = _pad_patch(pod_idx, kb)
            host = self._existing_pod_arrays(d)
            rows = PodArrays(*[f[idx] for f in host])
            existing = _patch_resident(existing, _patch_index(idx, device),
                                       to_device(rows, device), donate)
            patched = True

        # --- pending: identity-diffed against the previous batch ---
        # The unschedulable/backoff queues feed largely the SAME pod
        # objects cycle after cycle (the encoder memoizes rows by object
        # identity), so when the batch mostly repeats, only the changed
        # slots are re-derived on a persistent staging block.
        if pending_keys == snap.pending_keys:
            pe = snap.pending
        else:
            self._last_pending_patched = False
            pe = self._pending_block(encoder, pending, pending_keys, d,
                                     snap.pending, device, donate)
            patched = patched or self._last_pending_patched
        if snap.mesh is not None and patched:
            if donate:
                self.resident_donated_patches += 1
            else:
                self.resident_copy_patches += 1
        runs_plan = None
        if self._runs_wanted():
            # an identical batch keeps its plan; otherwise the pending stage
            # (just brought current) has the columns
            if pending_keys == snap.pending_keys and snap.runs is not None:
                runs_plan = snap.runs
            else:
                runs_plan = self._run_plan_from_stage()

        new_snap = Snapshot(
            generation=gen,
            node_order=list(self._node_names),
            tables=tables,
            existing=existing,
            pending=pe,
            dims=d,
            pending_keys=pending_keys,
            existing_keys=tuple(self._pod_keys),
            gang=self._gang_arrays(encoder, pending, d, device),
            device=device,
            runs=runs_plan,
            mesh=snap.mesh,
        )
        self._dirty_nodes.clear()
        self._dirty_pods.clear()
        self.last_patch_rows = len(node_idx) + len(pod_idx)
        self._snapshot = new_snap
        return new_snap

    @staticmethod
    def _replace_replicated(st: ShardedTables, fields: Dict) -> ShardedTables:
        """Rebuilt replicated tables (host numpy) copied once per distinct
        device of the mesh and swapped into every shard."""
        per_dev: Dict[torch.device, Dict] = {}
        shards = []
        for sh, dev in zip(st.shards, st.mesh.devices):
            if dev not in per_dev:
                per_dev[dev] = {k: to_device(v, dev)
                                for k, v in fields.items()}
            shards.append(sh._replace(**per_dev[dev]))
        return st._replace(shards=tuple(shards))

    def _patch_sharded_nodes(self, st: ShardedTables, node_idx: List[int],
                             topo_grew: bool, encoder, donate: bool):
        """The mesh-resident node patch: each shard scatters its OWN dirty
        rows (global slot − its row offset) from the host staging — in place
        when `donate`, else into new planes. Returns (tables, whether any
        resident row was written)."""
        if topo_grew:
            st = self._replace_replicated(
                st, {"zone_keys": encoder.build_zone_keys()})
        if not node_idx and not topo_grew:
            return st, False
        staging = self._staging_nodes
        n = st.n_nodes // st.mesh.size
        shards = []
        for sh, off, dev in zip(st.shards, st.offsets, st.mesh.devices):
            nodes = sh.nodes
            if topo_grew:
                # a new topology key: the [n, K] topo/domain planes of the
                # shard's rows, shipped whole (new tensors either way)
                nodes = nodes._replace(
                    topo=to_device(staging.topo[off:off + n], dev),
                    domain=to_device(staging.domain[off:off + n], dev))
            own = [s - off for s in node_idx if off <= s < off + n]
            if own:
                idx = _pad_patch(own, _patch_bucket(len(own)))
                rows = NodeArrays(*[f[idx + off] for f in staging])
                nodes = _patch_resident(nodes, _patch_index(idx, dev),
                                        to_device(rows, dev), donate)
            shards.append(sh._replace(nodes=nodes))
        return st._replace(shards=tuple(shards)), True

    def _pending_block(self, encoder, pending, pending_keys, d: Dims,
                       prev_device, device, donate: bool = False):
        """Pending PodArrays, identity-diffed against the previous batch:
        when the batch largely repeats, only the changed slots re-derive on
        the persistent host stage and scatter into a copy of the resident
        device tensors — the same bucketed-index pattern the node and
        existing-pod rows use. Falls back to the full vectorized assembly
        when the shape changed or most slots differ."""
        prev_keys = self._pending_stage_keys
        stage = self._pending_stage
        # nodeName-bearing batches route to the scan engine and carry slot
        # references that can go stale when node slots churn — they take
        # the full assembly, not the diff
        if (stage is not None and prev_keys is not None
                and not d.has_node_name
                and stage.valid.shape[0] == d.P
                and len(prev_keys) == len(pending_keys)):
            changed = [i for i, (a, b) in enumerate(
                zip(prev_keys, pending_keys)) if a != b]
            if len(changed) <= max(len(pending_keys) // 8, 32):
                for i in changed:
                    p = pending[i]
                    stage.rows[i] = encoder.pod_row(p)
                    stage.node_id[i] = self._node_slot.get(
                        p.node_name, -1) if p.node_name else -1
                    stage.valid[i] = True
                self._pending_stage_keys = pending_keys
                kb = _patch_bucket(len(changed))
                idx = _pad_patch(changed, kb)
                rows = PodArrays(
                    valid=stage.valid[idx],
                    name_id=stage.rows[idx, 0],
                    ns=stage.rows[idx, 1],
                    cls=stage.rows[idx, 2],
                    priority=stage.rows[idx, 3],
                    creation=stage.rows[idx, 4],
                    node_id=stage.node_id[idx],
                    node_name_req=stage.rows[idx, 5],
                )
                self._last_pending_patched = True
                return _patch_resident(prev_device, _patch_index(idx, device),
                                       to_device(rows, device), donate)
        pe_host = encoder.build_pod_arrays(
            list(pending), d, self._node_slot, capacity=d.P)
        self._pending_stage = _PendingStage.from_pod_arrays(pe_host)
        self._pending_stage_keys = pending_keys
        return to_device(pe_host, device)


class _PendingStage:
    """Persistent host staging for the pending batch ([P, 6] rows +
    node_id + valid), patched in place across cycles."""

    __slots__ = ("rows", "node_id", "valid")

    def __init__(self, rows, node_id, valid):
        self.rows = rows
        self.node_id = node_id
        self.valid = valid

    @classmethod
    def from_pod_arrays(cls, pe: PodArrays) -> "_PendingStage":
        rows = np.stack([pe.name_id, pe.ns, pe.cls, pe.priority,
                         pe.creation, pe.node_name_req], axis=1)
        return cls(rows=np.ascontiguousarray(rows),
                   node_id=np.array(pe.node_id, copy=True),
                   valid=np.array(pe.valid, copy=True))


class FakeCache(SchedulerCache):
    """Test double in the spirit of internal/cache/fake/fake_cache.go — a real
    cache with a controllable clock convenience."""

    def expire_all_assumed(self) -> List[str]:
        with self._mu:
            expired = [k for k, s in self._pods.items()
                       if s.assumed and s.binding_finished]
            for k in expired:
                st = self._pods.pop(k)
                self._pod_unplaced(st.pod)
            if expired:
                self._generation += 1
        return expired
