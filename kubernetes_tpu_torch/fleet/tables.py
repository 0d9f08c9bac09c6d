"""Tenant stacking: K per-tenant ClusterTables behind one leading axis (port
of the JAX package's fleet/tables.py, single device).

Every tenant's encoded cluster shares ONE capacity shape — the fleet bucket
— so one stacked tree holds all of them. That bucket is the field-wise union
of the tenants' Dims (`fleet_dims`), fed back into every tenant's cache
snapshot as `base_dims`: state/cache.py seeds its capacity growth from the
union, so when ANY tenant grows an axis, every other tenant's next snapshot
pads up to match. Unoccupied slots are inert rows (valid=False, zero
capacity, -1 ids) that no engine can admit a pod onto.

`FleetStack` keeps the STACKED tensors resident on the device. A tenant
whose snapshot object changed since the last tick has its row written IN
PLACE into every resident leaf (`index_copy_` at the changed tenants'
rows: the JAX package's donated patch, fleet/tables.py:294-298, on one
device), unchanged tenants cost nothing, and a shape change restacks. Not
ported: the fleet mesh (ROADMAP A13b).
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Sequence, Tuple

import torch

from ..state.dims import Dims

# floor on the padded tenant axis (exact on a single device)
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


def _rebuild(like, it):
    """`like`'s structure (NamedTuples, tuples, tensors) with its leaves
    taken in order from the iterator `it`."""
    if isinstance(like, torch.Tensor):
        return next(it)
    kids = [_rebuild(x, it) for x in like]
    return type(like)(*kids) if hasattr(like, "_fields") else tuple(kids)


def tree_map(fn, *trees):
    """`fn` over the matching leaves of trees of one structure."""
    leaves = [fn(*xs) for xs in zip(*(_leaves(t) for t in trees))]
    return _rebuild(trees[0], iter(leaves))


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
    tenant (`row_patches` and `donated_patches` count the tenant rows
    written; `index_copy_` never moves a leaf's storage, so
    `donation_failures`, the JAX package's count of patches XLA could not
    donate, stays 0). The in-place write needs that no dispatch still
    reads the stack: refresh runs on the tick path, between dispatches,
    and an abandoned dispatch's worker may still read it, so the server
    invalidates the stack then (its supervisor-epoch check and its
    DispatchAbandonedError handler) and the next refresh restacks onto
    fresh tensors. Shape changes (the fleet
    bucket grew, a tenant joined) rebuild the whole stack — the fleet
    analog of the cache's full-snapshot path. Each tenant's interned
    taint-key pair stays on the host (`keys_host`): the engines take it as
    two ints."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.block = None           # (tables, pending, existing)
        self.dims: Optional[Dims] = None
        self.K = 0                  # padded leading dim (the stack's K)
        self.live = 0               # live (unpadded) tenant count
        self._snaps: List = []
        self.keys_host: List[Tuple[int, int]] = []
        self.full_restacks = 0
        self.row_patches = 0
        self.donated_patches = 0
        self.donation_failures = 0

    def invalidate(self) -> None:
        """Drop the resident stacked tree. Called when it may still be read
        by an abandoned dispatch's worker, or lives on a lost backend: the
        next refresh restacks onto fresh tensors (the abandoned worker keeps
        the old ones)."""
        self.block = None
        self.dims = None
        self._snaps = []
        self.keys_host = []

    def padded_k(self, live: int) -> int:
        return max(live, RC_TENANT_MIN)

    @staticmethod
    def _row(snap):
        return (snap.tables, snap.pending, snap.existing)

    def refresh(self, snaps: Sequence, keys: Sequence[Tuple], d: Dims) -> int:
        """Bring the resident stack current with this tick's per-tenant
        snapshots. Returns the padded tenant count K of the stacked tree."""
        live = len(snaps)
        Kp = self.padded_k(live)
        keys_host = [(int(uk), int(ev)) for uk, ev in keys]
        base = replace(d, has_node_name=False)
        if (self.block is None or self.dims != base or self.K != Kp
                or self.live != live):
            blocks = [self._row(s) for s in snaps]
            if Kp > live:
                blocks.extend([empty_tenant_block(d, self.device)]
                              * (Kp - live))
            self.block = stack_blocks(blocks)
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
                self._patch_in_place([k for k, _, _ in changed],
                                     [self._row(s) for _, s, _ in changed])
        self._snaps = list(snaps)
        self.keys_host = keys_host
        return self.K

    def _patch_in_place(self, ks: List[int], rows: Sequence[Tuple]) -> None:
        """Write the tenants' rows `rows` at stack rows `ks` into every
        resident leaf in place."""
        idx = torch.tensor(ks, dtype=torch.int64, device=self.device)
        for leaf, row in zip(_leaves(self.block),
                             _leaves(stack_blocks(rows))):
            leaf.index_copy_(0, idx, row)
        self.row_patches += len(ks)
        self.donated_patches += len(ks)

    # convenience accessors for the dispatch layer
    @property
    def tables(self):
        return self.block[0]

    @property
    def pending(self):
        return self.block[1]

    @property
    def existing(self):
        return self.block[2]
