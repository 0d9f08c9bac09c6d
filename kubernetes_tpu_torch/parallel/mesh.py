"""Node-axis sharding of the single cluster (port of the single-cluster half
of the JAX package's parallel/mesh.py, whose docstring sets out the design:
the node axis of every node plane — NodeArrays rows, the static [SC, N]
lattice, the CNT/HOLD/WSYM carries — is split across devices, the class and
term tables are small and replicated).

A `Mesh` here is an ordered tuple of torch devices on the node axis, and the
sharded cycle is single-controller: one process, one thread per shard
running the single-device engines on its rows, the cross-shard steps
explicit (parallel/axis.py). A device may repeat — `make_mesh(4,
devices=[torch.device("cuda", 0)] * 4)` is four shards on one card, the
counterpart of the JAX package's virtual CPU mesh; `[torch.device("cpu")] *
8` is the tests' mesh.

`ShardedTables` holds the node planes cut into contiguous row blocks, one per
shard, each on its device, and a copy of every other table per device;
`ShardedTables.run` runs a cycle over them. `MeshState` is the serving
scheduler's mesh lifecycle (sched/supervisor.py drives it): drop on a
backend loss, reform narrower, restore full width after a full probe.

The fleet half (the JAX package's parallel/mesh.py:202-334): K tenant
clusters stacked on a leading axis (fleet/tables.py) split across the rows
of a `FleetMesh`. `make_fleet_mesh(n)` is the 1-D tenant mesh, each device
a row owning K/n whole tenants (no collective); `make_fleet_mesh(n,
node_shards=kn)` the (TENANT_AXIS, NODE_AXIS) grid of shape (n/kn, kn),
each row's tenants with their node planes cut into kn row blocks across
the row — the single-cluster sharding above, per tenant row.
`shard_fleet` places a stacked tree (`ShardedFleet`), `ShardedFleet.run`
runs a function on every position of the grid (parallel/axis.py
spmd_grid: the rows in turn, one collective group per row, none across
rows).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..state.arrays import ClusterTables, NodeArrays, to_device
from . import axis

NODE_AXIS = "nodes"

MESH_HINT = (
    "pass devices=[torch.device('cuda', 0)] * n (or "
    "[torch.device('cpu')] * n) for a virtual mesh of n shards on one device")


class Mesh:
    """An ordered tuple of devices on the node axis: shard i owns the i-th
    block of node rows on `devices[i]`. Identity matters: the resident
    cache keys its sharded planes on the Mesh object (a reform builds a new
    one)."""

    axis_names = (NODE_AXIS,)

    def __init__(self, devices: Sequence) -> None:
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Tuple[int]:
        return (len(self.devices),)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({', '.join(str(d) for d in self.devices)})"


def _cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of `n_devices` shards: over `devices` when given (repeats
    allowed — a virtual mesh), else over cuda:0..n-1. Too few devices
    raises, with the virtual-mesh form in the error's notes: a sharding
    proof on fewer devices than asked for would prove nothing."""
    pool = list(devices) if devices is not None else _cuda_devices()
    n = n_devices or len(pool)
    if n < 1 or len(pool) < n:
        err = RuntimeError(
            f"make_mesh({n}): only {len(pool)} devices visible — a "
            "multi-device run on fewer devices than requested would "
            "validate nothing")
        err.__notes__ = [MESH_HINT]
        raise err
    return Mesh(pool[:n])


def mesh_key(mesh: Optional[Mesh]) -> Optional[Tuple]:
    """Hashable signature of a mesh for program and budget keys: its axis
    names, its shape and each position's device. Two meshes over different
    devices never share a key; two built alike do; and a node mesh, a 1-D
    tenant mesh and a tenant × node-shard grid over the same devices are
    three keys."""
    if mesh is None:
        return None
    return (mesh.axis_names, mesh.shape,
            tuple((i, d.type, d.index) for i, d in enumerate(mesh.devices)))


def padded_node_count(n: int, n_devices: int) -> int:
    """Smallest multiple of n_devices ≥ n."""
    return ((n + n_devices - 1) // n_devices) * n_devices


# the inert-row fill of each node plane: id planes -1 (absent), counts and
# bitset words 0, `unschedulable` True — the JAX package's rule, where the
# word planes are uint32 (zero-filled) and here their int32 view
_FILL = dict(
    valid=False, name_id=-1, alloc=0, used=0, label_keys=-1, label_vals=-1,
    label_ints=0, unschedulable=True, taint_keys=-1, taint_vals=-1,
    taint_effects=-1, topo=-1, domain=-1, port_pair_any=0, port_pair_wild=0,
    port_triple=0, img_words=0, vol_any=0, vol_rw=0, vol_limit=-1,
    avoid=False)


def _pad_node_arrays(nodes: NodeArrays, pad: int, axis_: int = 0
                     ) -> NodeArrays:
    """`pad` inert node rows appended along `axis_` of every plane. Every
    consumer is gated on `nodes.valid`, so an inert row admits no pod."""

    def cat(name: str, a: torch.Tensor) -> torch.Tensor:
        shape = list(a.shape)
        shape[axis_] = pad
        return torch.cat([a, torch.full(shape, _FILL[name], dtype=a.dtype,
                                        device=a.device)], axis_)

    return NodeArrays(*(cat(f, getattr(nodes, f)) for f in NodeArrays._fields))


def pad_node_tables(tables: ClusterTables, n_devices: int) -> ClusterTables:
    """Pad the node axis with inert rows so N divides the mesh; divisible
    tables come back as they are."""
    N = int(tables.nodes.valid.shape[0])
    Np = padded_node_count(N, n_devices)
    if Np == N:
        return tables
    nodes = tables.nodes
    if not isinstance(nodes.valid, torch.Tensor):  # the encoder's numpy
        nodes = to_device(nodes, torch.device("cpu"))
    return tables._replace(nodes=_pad_node_arrays(nodes, Np - N))


class Replicated(NamedTuple):
    """A tree copied onto every device of a mesh: `copies[i]` is shard i's
    (shards on one device share its copy)."""

    mesh: Mesh
    copies: Tuple[Any, ...]


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)


def _home(tree) -> Optional[torch.device]:
    """The one device every tensor of `tree` lives on, else None."""
    devs = {t.device for t in _leaves(tree)}
    return devs.pop() if len(devs) == 1 else None


def replicate(tree, mesh: Mesh) -> Replicated:
    """`tree` (a NamedTuple of tensors, or None) on each distinct device of
    the mesh — the explicit broadcast of the replicated tables: a copy per
    device, except that shards on the device the tree already lives on read
    it in place (shards never write their inputs)."""
    home = None if tree is None else _home(tree)
    per_dev = {}
    copies = []
    for d in mesh.devices:
        if d not in per_dev:
            per_dev[d] = tree if tree is None or d == home \
                else to_device(tree, d)
        copies.append(per_dev[d])
    return Replicated(mesh, tuple(copies))


class ShardedTables(NamedTuple):
    """ClusterTables on a mesh: shard i's tables hold node rows
    [offsets[i], offsets[i] + n_local) on mesh.devices[i] and a copy of
    every other table."""

    mesh: Mesh
    shards: Tuple[ClusterTables, ...]
    offsets: Tuple[int, ...]
    n_nodes: int  # global (padded) N

    def run(self, fn: Callable, *args) -> List[Any]:
        """`fn(tables_i, *args_i)` on every shard under its node axis
        (parallel/axis.py spmd); a `Replicated` argument passes each shard
        its copy. Returns the shards' results in order."""
        def body(r: int):
            return fn(self.shards[r], *(
                a.copies[r] if isinstance(a, Replicated) else a
                for a in args))
        return axis.spmd(self.mesh.devices, self.offsets, self.n_nodes, body)

    def gather(self) -> ClusterTables:
        """The unsharded tables on the lead device."""
        lead = self.mesh.lead
        nodes = NodeArrays(*(torch.cat([getattr(s.nodes, f).to(lead)
                                        for s in self.shards])
                             for f in NodeArrays._fields))
        return self.shards[0]._replace(nodes=nodes)


def shard_tables(tables: ClusterTables, mesh: Mesh) -> ShardedTables:
    """Place tables on the mesh: the node axis padded to a multiple of the
    mesh and cut into contiguous row blocks, one per shard, each COPIED
    onto its device; every other table replicated."""
    nd = mesh.size
    tables = pad_node_tables(tables, nd)
    N = int(tables.nodes.valid.shape[0])
    n = N // nd
    rest = {}
    shards = []
    for i, d in enumerate(mesh.devices):
        if d not in rest:
            rest[d] = {f: to_device(getattr(tables, f), d)
                       for f in ClusterTables._fields if f != "nodes"}
        nodes = NodeArrays(*(to_device(a[i * n:(i + 1) * n], d)
                             for a in tables.nodes))
        shards.append(ClusterTables(nodes=nodes, **rest[d]))
    return ShardedTables(mesh, tuple(shards),
                         tuple(i * n for i in range(nd)), N)


# ----------------------------------------------------------------------- #
# collectives over whole engine trees, for use inside a sharded run
# ----------------------------------------------------------------------- #

# node-axis dimension of each AssignState field
STATE_DIMS = dict(used=0, ppa=0, ppw=0, ppt=0, CNT=1, HOLD=1, WSYM=1,
                  vol_any=0, vol_rw=0)


def _state_pairs(state):
    return [(getattr(state, f), STATE_DIMS[f]) for f in state._fields]


def _cycle_pairs(cyc):
    return [(a, 1) for a in cyc.static] + [
        (getattr(cyc, f), 1) for f in ("CNT", "HOLD", "WSYM")]


def gather_full(tables=None, cyc=None, state=None) -> tuple:
    """The unsharded ClusterTables, CycleArrays and AssignState (each one
    given) on the lead device, in ONE rendezvous; Nones on the other
    shards. The tables' node planes are [N, …], the static lattice and the
    CNT/HOLD/WSYM seeds [·, N], the state's planes as STATE_DIMS says."""
    ax = axis.current()
    if not ax.sharded:
        return tables, cyc, state
    parts = [[(a, 0) for a in tables.nodes] if tables is not None else [],
             _cycle_pairs(cyc) if cyc is not None else [],
             _state_pairs(state) if state is not None else []]
    got = ax.gather_many([p for part in parts for p in part])
    if ax.rank != 0:
        return None, None, None
    n_t, n_c = len(parts[0]), len(parts[1])
    t, c, s = got[:n_t], got[n_t:n_t + n_c], got[n_t + n_c:]
    return (tables._replace(nodes=NodeArrays(*t)) if tables is not None
            else None,
            cyc._replace(static=type(cyc.static)(*c[:-3]), CNT=c[-3],
                         HOLD=c[-2], WSYM=c[-1]) if cyc is not None
            else None,
            type(state)(*s) if state is not None else None)


def gather_state(state):
    """The full AssignState on the lead device (None on other shards)."""
    return gather_full(state=state)[2]


def split_state(full, like):
    """This shard's block of a full AssignState handed back by a lead step
    (`like` gives the type)."""
    ax = axis.current()
    if not ax.sharded:
        return full
    return type(like)(*(ax.split(getattr(full, f), STATE_DIMS[f])
                        for f in like._fields))


def gather_tables(tables: ClusterTables):
    """The unsharded ClusterTables on the lead device (None elsewhere)."""
    return gather_full(tables=tables)[0]


def gather_cycle(cyc):
    """The unsharded CycleArrays on the lead device (None elsewhere): the
    static lattice and the CNT/HOLD/WSYM seeds are [·, N]."""
    return gather_full(cyc=cyc)[1]


def memory_report(sharded: ShardedTables, single: ClusterTables) -> dict:
    """Per-device bytes of the sharded tables against the unsharded ones
    (the JAX package's dryrun memory_report, measured on these tensors):
    the node-axis share, which the mesh divides, and the replicated rest."""
    def nbytes(tree) -> int:
        if isinstance(tree, torch.Tensor):
            return tree.numel() * tree.element_size()
        return sum(nbytes(v) for v in tree)

    total = nbytes(single)
    node_axis = nbytes(single.nodes)
    per_dev = nbytes(sharded.shards[0])
    return {
        "n_nodes": sharded.n_nodes, "n_devices": sharded.mesh.size,
        "table_bytes_single_device": total,
        "table_bytes_per_device_sharded": per_dev,
        "node_axis_bytes": node_axis,
        "replicated_bytes": total - node_axis,
    }


def tree_map(fn, *trees):
    """`fn` over the matching tensors of trees of one structure (tensors,
    tuples and NamedTuples)."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    kids = [tree_map(fn, *xs) for xs in zip(*trees)]
    return type(t0)(*kids) if hasattr(t0, "_fields") else tuple(kids)


def _copy(a: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`a` (often a slice of a stacked leaf) as its own contiguous tensor on
    `device`."""
    return a.to(device, copy=True, memory_format=torch.contiguous_format)


# ----------------------------------------------------------------------- #
# the fleet half: tenant rows × node shards (the JAX package's
# parallel/mesh.py:202-334)
# ----------------------------------------------------------------------- #

TENANT_AXIS = "tenants"


class FleetMesh(Mesh):
    """The fleet's mesh: `devices` in row-major order over a grid of
    (tenant rows, node shards). Row r, devices[r·kn:(r+1)·kn], owns the
    r-th block of K/kt stacked tenants, each tenant's node planes cut into
    kn contiguous row blocks across the row. With kn = 1 it is the 1-D
    tenant mesh (axis names (TENANT_AXIS,), shape (n,)): every device a row
    of whole tenants, no collective. Otherwise the 2-D grid
    ((TENANT_AXIS, NODE_AXIS), shape (kt, kn))."""

    def __init__(self, devices: Sequence, node_shards: int = 1) -> None:
        super().__init__(devices)
        kn = int(node_shards)
        if kn < 1 or len(self.devices) % kn:
            raise ValueError(
                f"FleetMesh: node_shards={kn} must divide the "
                f"{len(self.devices)} devices — the grid is a (tenants, "
                "node-shards) reshape")
        self.node_shards = kn
        self.axis_names = ((TENANT_AXIS,) if kn == 1
                           else (TENANT_AXIS, NODE_AXIS))

    @property
    def shape(self) -> Tuple[int, ...]:
        n, kn = len(self.devices), self.node_shards
        return (n,) if kn == 1 else (n // kn, kn)

    @property
    def rows(self) -> Tuple[Tuple[torch.device, ...], ...]:
        kn = self.node_shards
        return tuple(self.devices[i:i + kn]
                     for i in range(0, len(self.devices), kn))

    def __repr__(self) -> str:
        kt, kn = fleet_mesh_shape(self)
        return (f"FleetMesh({kt} x {kn}: "
                f"{', '.join(str(d) for d in self.devices)})")


def make_fleet_mesh(n_devices: Optional[int] = None, node_shards: int = 1,
                    devices: Optional[Sequence] = None) -> FleetMesh:
    """The fleet mesh over `n_devices` of `devices` (repeats allowed), else
    of cuda:0..n-1: the 1-D tenant mesh when `node_shards` is 1, else the
    (n/kn, kn) grid. Too few devices raises with the virtual-mesh form in
    the error's notes, as `make_mesh` does; a node-shard width that does
    not divide n raises ValueError."""
    pool = list(devices) if devices is not None else _cuda_devices()
    n = n_devices or len(pool)
    if n < 1 or len(pool) < n:
        err = RuntimeError(
            f"make_fleet_mesh({n}): only {len(pool)} devices visible")
        err.__notes__ = [MESH_HINT]
        raise err
    kn = int(node_shards or 1)
    if kn > 1 and (kn > n or n % kn):
        raise ValueError(
            f"make_fleet_mesh({n}, node_shards={kn}): node_shards must "
            "divide the device count — the 2-D mesh is a (tenants, "
            "node-shards) reshape of the same devices")
    return FleetMesh(pool[:n], max(kn, 1))


def fleet_mesh_shape(mesh: Mesh) -> Tuple[int, int]:
    """(tenant-axis width, node-shard width) of a fleet mesh: a 1-D tenant
    mesh reads as (n, 1). The tenant width, not the device count, is what
    the stack's K pads to (fleet/tables.py FleetStack.padded_k)."""
    kn = getattr(mesh, "node_shards", 1)
    return mesh.size // kn, kn


def padded_tenant_count(k: int, n_rows: int) -> int:
    """Smallest multiple of n_rows ≥ k: inert tenants pad the difference,
    the inert-row rule one axis up."""
    return padded_node_count(k, n_rows)


def pad_fleet_node_tables(tables: ClusterTables,
                          node_shards: int) -> ClusterTables:
    """Pad a STACKED [K, N, …] ClusterTables so each tenant's node axis
    (axis 1) divides `node_shards`, with `_FILL`'s inert rows per tenant.
    The serving path never needs it (FleetServer grows the bucket's N to a
    node-shard multiple first); a directly built stack must not crash."""
    N = int(tables.nodes.valid.shape[1])
    Np = padded_node_count(N, node_shards)
    if Np == N:
        return tables
    return tables._replace(
        nodes=_pad_node_arrays(tables.nodes, Np - N, axis_=1))


class ShardedFleet(NamedTuple):
    """A stacked fleet tree (tables, pending, existing; every leaf [K, …])
    on a FleetMesh. `cells[r·kn + s]` is position (r, s): tenant rows
    [r·K/kt, (r+1)·K/kt), with each tenant's node rows [offsets[s],
    offsets[s] + n_local) on mesh.devices[r·kn + s] and the row's copy of
    every other leaf (one per distinct device of the row: positions on one
    device share it, and never write it)."""

    mesh: FleetMesh
    cells: Tuple[Tuple[Any, Any, Any], ...]
    K: int
    offsets: Tuple[int, ...]
    n_nodes: int  # each tenant's (padded) N

    @property
    def k_row(self) -> int:
        return self.K // fleet_mesh_shape(self.mesh)[0]

    def run(self, fn: Callable) -> List[List[Any]]:
        """`fn(r, s, cell)` on every position of the grid under its row's
        node axis (parallel/axis.py spmd_grid). Returns the results as
        [row][shard]."""
        kn = self.mesh.node_shards
        return axis.spmd_grid(self.mesh.rows, self.offsets, self.n_nodes,
                              lambda r, s: fn(r, s, self.cells[r * kn + s]))


def shard_fleet(tree, mesh: FleetMesh) -> ShardedFleet:
    """Place a stacked (tables, pending, existing) tree on a fleet mesh,
    every part COPIED: row r takes tenant block [r·K/kt, (r+1)·K/kt), and on
    a grid each of that block's node planes is cut into kn contiguous row
    blocks, one per device of the row; every other leaf gets one copy per
    distinct device of the row. K must already be a multiple of the tenant
    width (FleetStack pads with inert tenants); a per-tenant N the
    node-shard width does not divide is padded with inert rows."""
    tables, pending, existing = tree
    kt, kn = fleet_mesh_shape(mesh)
    K = int(tables.nodes.valid.shape[0])
    if K % kt:
        raise ValueError(
            f"shard_fleet: K={K} is not a multiple of the tenant width "
            f"{kt} — pad with inert tenants first (fleet/tables.py)")
    if kn > 1:
        tables = pad_fleet_node_tables(tables, kn)
    N = int(tables.nodes.valid.shape[1])
    n, kr = N // kn, K // kt
    cells = []
    for r, row in enumerate(mesh.rows):
        blk = slice(r * kr, (r + 1) * kr)
        rest = {}
        for s, d in enumerate(row):
            if d not in rest:
                rest[d] = (
                    {f: tree_map(lambda a: _copy(a[blk], d),
                                 getattr(tables, f))
                     for f in ClusterTables._fields if f != "nodes"},
                    tree_map(lambda a: _copy(a[blk], d), pending),
                    tree_map(lambda a: _copy(a[blk], d), existing))
            fields, pe, ex = rest[d]
            nodes = NodeArrays(*(_copy(a[blk, s * n:(s + 1) * n], d)
                                 for a in tables.nodes))
            cells.append((ClusterTables(nodes=nodes, **fields), pe, ex))
    return ShardedFleet(mesh, tuple(cells), K,
                        tuple(s * n for s in range(kn)), N)


class MeshState:
    """The serving scheduler's mesh lifecycle (the JAX package's MeshState):

      * `mesh` — the mesh the next snapshot and dispatch use, or None
        (single-device serving);
      * `on_backend_loss()` — a device of the mesh failed: the whole mesh is
        dropped (every collective spans all shards) and its width is
        remembered;
      * `reform(full=False)` — re-admission: a new Mesh object from the
        pool, half the lost width unless the prober proved full width
        (`full=True`). The cache keys residency on mesh identity, so a
        reform re-shards from the host staging.

    Widths stay powers of two. The pool of available devices is the one the
    caller gave (`devices`, repeats allowed), else every CUDA device.

    Fleet mode (`fleet_node_shards` not None): the meshes are FleetMeshes
    (`make_fleet_mesh`), the node-shard width a power of two clamped to the
    mesh width, so a loss drops the whole grid and a reform rebuilds it
    2-D (narrower after an unproven loss)."""

    def __init__(self, n_devices: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 fleet_node_shards: Optional[int] = None) -> None:
        self._mu = threading.Lock()
        self._requested = n_devices
        self._pool = list(devices) if devices is not None \
            else _cuda_devices()
        self._fleet_ns = fleet_node_shards
        self._lost_width: Optional[int] = None
        self.reforms = 0
        self.demotions = 0
        m = None
        avail = len(self._pool)
        want = n_devices or avail
        if want > 1 and avail >= 2:
            m = self._build(self._pow2_floor(min(want, avail)))
        self.mesh: Optional[Mesh] = m

    def _build(self, width: int) -> Mesh:
        if self._fleet_ns is None:
            return make_mesh(width, devices=self._pool)
        ns = self._pow2_floor(max(int(self._fleet_ns), 1))
        return make_fleet_mesh(width, node_shards=min(ns, width),
                               devices=self._pool)

    @staticmethod
    def _pow2_floor(n: int) -> int:
        return 1 << (max(n, 1).bit_length() - 1)

    @property
    def n_devices(self) -> int:
        with self._mu:
            return self.mesh.size if self.mesh is not None else 1

    def on_backend_loss(self) -> None:
        with self._mu:
            if self.mesh is None:
                return
            self._lost_width = self.mesh.size
            self.mesh = None
            self.demotions += 1

    def reform(self, full: bool = False) -> Optional[Mesh]:
        with self._mu:
            avail = len(self._pool)
            want = self._requested or avail
            if not full and self._lost_width is not None:
                want = min(want, max(self._lost_width // 2, 1))
            want = self._pow2_floor(min(want, avail))
            if want <= 1:
                self.mesh = None
                return None
            self.mesh = self._build(want)
            if full:
                self._lost_width = None
            self.reforms += 1
            return self.mesh
