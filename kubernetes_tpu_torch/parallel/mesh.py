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
    """Hashable signature of a mesh for program and budget keys: its shape
    and each position's device. Two meshes over different devices never
    share a key; two built alike do."""
    if mesh is None:
        return None
    return (mesh.shape, tuple((i, d.type, d.index)
                              for i, d in enumerate(mesh.devices)))


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


def gather_state(state):
    """The full AssignState on the lead device (None on other shards)."""
    ax = axis.current()
    if not ax.sharded:
        return state
    parts = [ax.gather(getattr(state, f), STATE_DIMS[f])
             for f in state._fields]
    return type(state)(*parts) if ax.rank == 0 else None


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
    ax = axis.current()
    if not ax.sharded:
        return tables
    nodes = [ax.gather(a, 0) for a in tables.nodes]
    return tables._replace(nodes=NodeArrays(*nodes)) if ax.rank == 0 \
        else None


def gather_cycle(cyc):
    """The unsharded CycleArrays on the lead device (None elsewhere): the
    static lattice and the CNT/HOLD/WSYM seeds are [·, N]."""
    ax = axis.current()
    if not ax.sharded:
        return cyc
    static = [ax.gather(a, 1) for a in cyc.static]
    seeds = {f: ax.gather(getattr(cyc, f), 1) for f in ("CNT", "HOLD", "WSYM")}
    if ax.rank != 0:
        return None
    return cyc._replace(static=type(cyc.static)(*static), **seeds)


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
    caller gave (`devices`, repeats allowed), else every CUDA device."""

    def __init__(self, n_devices: Optional[int] = None,
                 devices: Optional[Sequence] = None) -> None:
        self._mu = threading.Lock()
        self._requested = n_devices
        self._pool = list(devices) if devices is not None \
            else _cuda_devices()
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
        return make_mesh(width, devices=self._pool)

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
