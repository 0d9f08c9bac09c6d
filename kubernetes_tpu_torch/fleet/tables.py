"""Tenant stacking: K per-tenant ClusterTables behind one leading axis (port
of the JAX package's fleet/tables.py).

Every tenant's encoded cluster shares ONE capacity shape — the fleet bucket
— so one stacked tree holds all of them. That bucket is the field-wise union
of the tenants' Dims (`fleet_dims`), fed back into every tenant's cache
snapshot as `base_dims`: state/cache.py seeds its capacity growth from the
union, so when ANY tenant grows an axis, every other tenant's next snapshot
pads up to match. Unoccupied slots are inert rows (valid=False, zero
capacity, -1 ids) that no engine can admit a pod onto.

`FleetStack` keeps the STACKED tensors resident on the device, or on a
fleet mesh (parallel/mesh.py FleetMesh: K padded to a multiple of the
tenant rows, each row's tenants on its devices, on a grid each tenant's
node planes cut across the row — `ShardedFleet`). A tenant whose snapshot
object changed since the last tick has its row written IN PLACE into every
resident leaf (`index_copy_` at the changed tenants' rows: the JAX
package's donated patch, fleet/tables.py:294-298) — on a mesh only into
its own row's devices, each shard taking only its own node rows —
unchanged tenants cost nothing, and a shape change restacks.
"""

from __future__ import annotations

import threading
from dataclasses import replace
from typing import List, Optional, Sequence, Tuple

import torch

from ..parallel.mesh import (ShardedFleet, fleet_mesh_shape,
                             padded_tenant_count, shard_fleet, tree_map)
from ..state.dims import Dims

# floor on the padded tenant axis: K pads to a multiple of the fleet mesh's
# tenant rows, or stays exact on one device
RC_TENANT_MIN = 1


def fleet_dims(tenant_dims: Sequence[Dims],
               base: Optional[Dims] = None) -> Dims:
    """The shared fleet bucket: field-wise union of every tenant's Dims
    (and the configured floor). `has_node_name` is cleared — it is a
    per-tick routing fact the server re-derives, not a capacity."""
    d = base or Dims()
    for td in tenant_dims:
        d = d.union(td)
    return replace(d, has_node_name=False)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for x in tree for leaf in _leaves(x)]


def stack_blocks(blocks: Sequence[Tuple]):
    """Stack per-tenant trees (tables, pending, existing) into one tree
    with a leading tenant axis on every leaf."""
    return tree_map(lambda *xs: torch.stack(xs), *blocks)


def tenant_view(tree, k: int):
    """Tenant k's row of a stacked tree: views, no copies."""
    return tree_map(lambda a: a[k], tree)


def empty_tenant_block(d: Dims, device):
    """An inert PAD tenant: an empty cluster at the fleet bucket — every
    node row invalid, every pending/existing slot invalid — so it can never
    admit a pod."""
    from ..state.arrays import ClusterTables, to_device
    from ..state.encode import Encoder

    enc = Encoder()
    tables = ClusterTables(
        nodes=enc.empty_node_arrays(d),
        reqs=enc.build_req_table(d),
        labelsets=enc.build_labelset_table(d),
        nterms=enc.build_nterm_table(d),
        tolsets=enc.build_tolset_table(d),
        portsets=enc.build_portset_table(d),
        terms=enc.build_term_table(d),
        classes=enc.build_class_table(d),
        images=enc.build_image_table(d),
        zone_keys=enc.build_zone_keys(),
        volsets=enc.build_volset_table(d),
        drv_masks=enc.build_drv_masks(d),
    )
    pending = enc.build_pod_arrays([], d, capacity=d.P)
    existing = enc.build_pod_arrays([], d, capacity=d.E)
    return (to_device(tables, device), to_device(pending, device),
            to_device(existing, device))


def probe_fleet_args(d: Dims, K: int, device, gang: bool = False):
    """What the prewarmer needs to warm a fleet dispatch at (dims, engine,
    rc, fleet=K): K copies of the prewarm probe tenant (one node, two
    self-anti-affine pods, so K1 and K2 launch) stacked at dims `d`, as
    ((tables, pending, existing), each tenant's taint-key pair, quota [K],
    the dims the probe needed)."""
    from ..sched.cycle import UNSCHEDULABLE_TAINT_KEY
    from ..sched.prewarm import _probe_encoder, _probe_objects
    from ..state.arrays import tables_to_torch

    enc = _probe_encoder()
    node, pods = _probe_objects(2, gang)
    tables, ex, pe, dd = enc.encode_cluster([node], [], pods,
                                            replace(d, has_node_name=False))
    tt, (ext, pet) = tables_to_torch(tables, (ex, pe), device)
    kh = (enc.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY),
          enc.vocabs.label_vals.get(""))
    stacked = stack_blocks([(tt, pet, ext)] * K)
    quota = torch.ones((K,), dtype=torch.float32, device=device)
    return stacked, [kh] * K, quota, dd


class FleetStack:
    """The resident stacked fleet state and its per-tenant patch path.

    `refresh` compares each tenant's Snapshot by object identity (the cache
    returns the SAME object when nothing changed), so idle tenants cost zero
    device work per tick; changed tenants' rows are written in place into
    the resident leaves, one `index_copy_` per leaf for every changed
    tenant (`row_patches` counts the tenant rows written, `donated_patches`
    those written in place; `index_copy_` never moves a leaf's storage, so
    `donation_failures`, the JAX package's count of patches XLA could not
    donate, stays 0). On a fleet `mesh` (1-D or the grid) the block is a
    `ShardedFleet` and a changed tenant is written only into its own row's
    devices, each shard taking only its node rows.

    The in-place write needs that no dispatch still reads the stack:
    `mark_dispatch_start/done` bracket each dispatch on it, and a refresh
    while one is in flight copies instead (`copy_patches`: new tensors, the
    dispatch keeps the old ones). An abandoned dispatch's worker may still
    read the stack, so the server also invalidates it then (its
    supervisor-epoch check and its DispatchAbandonedError handler) and the
    next refresh restacks onto fresh tensors. Shape changes (the fleet
    bucket grew, a tenant joined, a mesh came or went) rebuild the whole
    stack — the fleet analog of the cache's full-snapshot path — and so
    does every refresh while the grid's node-shard width does not divide
    the bucket's N (the resident rows are node-padded, the snapshots not).
    Each tenant's interned taint-key pair stays on the host (`keys_host`):
    the engines take it as two ints."""

    def __init__(self, device, mesh=None):
        self.device = torch.device(device)
        # parallel/mesh.py FleetMesh, or None (one device)
        self.mesh = mesh
        self.block = None           # (tables, pending, existing) or
                                    # a ShardedFleet on the mesh
        self.dims: Optional[Dims] = None
        self.K = 0                  # padded leading dim (the stack's K)
        self.live = 0               # live (unpadded) tenant count
        self._snaps: List = []
        self.keys_host: List[Tuple[int, int]] = []
        self.full_restacks = 0
        self.row_patches = 0
        self.donated_patches = 0
        self.copy_patches = 0
        self.donation_failures = 0
        self._inflight = 0
        self._mu = threading.Lock()

    def invalidate(self) -> None:
        """Drop the resident stacked tree. Called when it may still be read
        by an abandoned dispatch's worker, or lives on a lost backend: the
        next refresh restacks onto fresh tensors (the abandoned worker keeps
        the old ones)."""
        self.block = None
        self.dims = None
        self._snaps = []
        self.keys_host = []

    def mark_dispatch_start(self) -> None:
        with self._mu:
            self._inflight += 1

    def mark_dispatch_done(self) -> None:
        with self._mu:
            self._inflight = max(self._inflight - 1, 0)

    def padded_k(self, live: int) -> int:
        """K pads to the mesh's TENANT-axis width (not its device count: on
        the grid a tenant row spans node-shard devices)."""
        if self.mesh is None:
            return max(live, RC_TENANT_MIN)
        kt, _ = fleet_mesh_shape(self.mesh)
        return padded_tenant_count(max(live, RC_TENANT_MIN), kt)

    def _node_shards(self) -> int:
        return 1 if self.mesh is None else fleet_mesh_shape(self.mesh)[1]

    @staticmethod
    def _row(snap):
        return (snap.tables, snap.pending, snap.existing)

    def _place(self, blocks):
        stacked = stack_blocks(blocks)
        if self.mesh is None:
            return stacked
        return shard_fleet(stacked, self.mesh)

    def refresh(self, snaps: Sequence, keys: Sequence[Tuple], d: Dims) -> int:
        """Bring the resident stack current with this tick's per-tenant
        snapshots. Returns the padded tenant count K of the stacked tree."""
        live = len(snaps)
        Kp = self.padded_k(live)
        keys_host = [(int(uk), int(ev)) for uk, ev in keys]
        base = replace(d, has_node_name=False)
        kn = self._node_shards()
        n_padded = kn > 1 and int(d.N) % kn != 0
        if (self.block is None or self.dims != base or self.K != Kp
                or self.live != live or n_padded):
            blocks = [self._row(s) for s in snaps]
            if Kp > live:
                blocks.extend([empty_tenant_block(d, self.device)]
                              * (Kp - live))
            self.block = self._place(blocks)
            self.dims = base
            self.K = Kp
            self.live = live
            self.full_restacks += 1
        else:
            changed = [
                (k, snap, kh)
                for k, (snap, kh) in enumerate(zip(snaps, keys_host))
                if not (snap is self._snaps[k]
                        and kh == self.keys_host[k])]
            if changed:
                self._patch([k for k, _, _ in changed],
                            [self._row(s) for _, s, _ in changed])
        self._snaps = list(snaps)
        # pad tenants carry the (0, 0) pair (nothing interned)
        self.keys_host = keys_host + [(0, 0)] * (self.K - live)
        return self.K

    def _patch(self, ks: List[int], rows: Sequence[Tuple]) -> None:
        """Write the tenants' rows `rows` at stack rows `ks` into the
        resident leaves: in place while no dispatch holds them, else into
        copies."""
        with self._mu:
            in_place = self._inflight == 0
        src = stack_blocks(rows)
        if self.mesh is None:
            idx = torch.tensor(ks, dtype=torch.int64, device=self.device)
            self.block = _write(self.block, idx, src, in_place)
        else:
            self.block = self._patch_sharded(ks, src, in_place)
        self.row_patches += len(ks)
        if in_place:
            self.donated_patches += len(ks)
        else:
            self.copy_patches += len(ks)

    def _patch_sharded(self, ks: List[int], src, in_place: bool
                       ) -> ShardedFleet:
        """The patch on a ShardedFleet: tenant k goes only to row k // Kr's
        positions, at local row k % Kr; each position takes its own node
        rows of it, and each distinct device of the row its copy of the
        other leaves once."""
        sf = self.block
        kr, kn = sf.k_row, self.mesh.node_shards
        n = sf.n_nodes // kn
        cells = list(sf.cells)
        by_row = {}
        for j, k in enumerate(ks):
            by_row.setdefault(k // kr, []).append((k % kr, j))
        for r, pairs in by_row.items():
            rest = {}
            for s in range(kn):
                i = r * kn + s
                tables, pending, existing = cells[i]
                dev = self.mesh.devices[i]
                idx = torch.tensor([kk for kk, _ in pairs],
                                   dtype=torch.int64, device=dev)
                sel = torch.tensor([j for _, j in pairs], dtype=torch.int64,
                                   device=src[0].nodes.valid.device)
                rows = tree_map(lambda a: a.index_select(0, sel).to(dev),
                                src)
                if dev not in rest:
                    rt = rows[0]
                    rest[dev] = (
                        _write(tables._replace(nodes=()), idx,
                               rt._replace(nodes=()), in_place),
                        _write(pending, idx, rows[1], in_place),
                        _write(existing, idx, rows[2], in_place))
                others, pe, ex = rest[dev]
                nodes = _write(tables.nodes, idx, type(tables.nodes)(
                    *(a[:, s * n:(s + 1) * n] for a in rows[0].nodes)),
                    in_place)
                cells[i] = (others._replace(nodes=nodes), pe, ex)
        return sf._replace(cells=tuple(cells))

    # accessors for the dispatch layer: on a mesh `tables` is the whole
    # ShardedFleet and `pending`/`existing` are None (it holds them)
    @property
    def tables(self):
        return self.block if self.mesh is not None else self.block[0]

    @property
    def pending(self):
        return None if self.mesh is not None else self.block[1]

    @property
    def existing(self):
        return None if self.mesh is not None else self.block[2]


def _write(tree, idx: torch.Tensor, rows, in_place: bool):
    """`rows` [k, …] at leading indices `idx` of every leaf of `tree`:
    `index_copy_` into the leaves themselves, or `index_copy` into new
    ones."""
    if in_place:
        return tree_map(lambda a, r: a.index_copy_(0, idx, r), tree, rows)
    return tree_map(lambda a, r: a.index_copy(0, idx, r), tree, rows)
