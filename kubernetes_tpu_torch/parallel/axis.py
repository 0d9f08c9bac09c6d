"""The node axis as seen by one shard: the collectives a sharded cycle takes
where the JAX package lets XLA GSPMD insert them.

A sharded cycle is single-controller SPMD: `spmd` starts one thread per
shard of a mesh (parallel/mesh.py), each running the SAME single-device code
(ops/lattice.py, ops/waves.py, ops/runs.py, ops/gang.py, ops/preempt.py) on
its own contiguous block of node rows, on its own device. Wherever that code
reduces over the node axis it asks the thread's node axis — `current()` —
instead of reducing locally:

  * `all_reduce(x, op)`: elementwise max / min / sum / any across shards,
    combined in shard order on every shard. A max, min or any is exact in
    any grouping; the sums the engines take over N are integer counts, or
    f32 sums of integer-valued terms below 2^24 — exact in any grouping too
    (ops/interpod.py domain_agg, ops/scores.py);
  * `lead(fn, *args)`: the steps that need every node at once (the score
    sort and the rank-in-domain pass of the wave engine, the runs engine's
    admission prefix, the sequential scan K4, the preemption node choice)
    run on the mesh's lead device: arguments wrapped in `Shard(x, dim)` are
    gathered there in shard order, `fn` runs once with a local axis, and
    its result is handed to every shard. However many tensors one step
    gathers (`gather_many`, `gather_tree`, the Shard arguments of one
    `lead`), they cross in one rendezvous: under one interpreter lock
    every rendezvous costs its waiting threads a wake-up behind the busy
    ones;
  * `local_rows(ids)`: a global node id as this shard's row (existing pods'
    node ids, the scan's and the runs engine's choices);
  * `split(x, dim)`: this shard's block of a full node-axis tensor.

Outside `spmd` the axis is `LOCAL`: every collective is the local reduction
and `lead` calls `fn` directly, so the single-device path runs the same
expressions it always did.

Each collective is a rendezvous of all shard threads (`_Group.exchange`);
the shards' programs take the same collectives in the same order because
every host decision they make reads replicated values only. A shard that
raises aborts the group, and the others raise `MeshAborted` at their next
collective; `spmd` re-raises the first real error.

The fleet's grid (parallel/mesh.py FleetMesh) runs through `spmd_grid`: its
tenant rows in turn, each row of kn > 1 shards a collective group of its
own, so no collective crosses rows; a row of one device (the 1-D tenant
mesh) runs under a `RowAxis`, which takes no collective at all.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch

Array = torch.Tensor


class MeshAborted(RuntimeError):
    """A sibling shard failed (or finished early): this shard's collective
    cannot complete."""


class Shard(NamedTuple):
    """An argument of `lead`: a node-axis tensor split across the
    shards along `dim`, gathered on the lead device before `fn` runs."""

    x: Any
    dim: int


def _combine(op: str, a: Array, b: Array) -> Array:
    if op == "max":
        return torch.maximum(a, b)
    if op == "min":
        return torch.minimum(a, b)
    if op == "sum":
        return a + b
    if op == "any":
        return a | b
    raise ValueError(f"unknown reduction {op!r}")


def _to(tree, device: torch.device):
    """A result tree (tensors, tuples, lists, scalars) as this shard's own
    copy on `device`: shards of one device never share a tensor, so no
    shard's in-place write reaches another's."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


class LocalAxis:
    """The whole node axis on one device: every collective is local."""

    sharded = False
    in_mesh = False  # inside a sharded run (a shard, or its lead step)
    rank = 0
    size = 1
    offset = 0
    group = None

    def all_reduce(self, x: Array, op: str) -> Array:
        return x

    def amax(self, x: Array, dim, keepdim: bool = False) -> Array:
        return self.all_reduce(x.amax(dim, keepdim=keepdim), "max")

    def amin(self, x: Array, dim, keepdim: bool = False) -> Array:
        return self.all_reduce(x.amin(dim, keepdim=keepdim), "min")

    def sum(self, x: Array, dim=None, keepdim: bool = False,
            dtype=None) -> Array:
        s = x.sum(dtype=dtype) if dim is None \
            else x.sum(dim, keepdim=keepdim, dtype=dtype)
        return self.all_reduce(s, "sum")

    def any(self, x: Array, dim=None, keepdim: bool = False) -> Array:
        a = x.any() if dim is None else x.any(dim, keepdim=keepdim)
        return self.all_reduce(a, "any")

    def lead(self, fn: Callable, *args, **kwargs):
        return fn(*(a.x if isinstance(a, Shard) else a for a in args),
                  **{k: v.x if isinstance(v, Shard) else v
                     for k, v in kwargs.items()})

    def gather(self, x: Array, dim: int) -> Array:
        return x

    def gather_many(self, pairs) -> List[Array]:
        """`gather` of each (tensor, dim) of `pairs`, in one rendezvous."""
        return [x for x, _ in pairs]

    def gather_tree(self, x, dim: int):
        """`gather` over every tensor of a NamedTuple or tuple."""
        return x

    def split(self, x: Array, dim: int) -> Array:
        return x

    def local_rows(self, ids: Array, n_local: int):
        """(row index into this shard's node planes, in-shard mask) for
        global node ids `ids` (-1 = none)."""
        return ids, ids >= 0


class _LeadStep(LocalAxis):
    """The lead shard's axis while it runs a `lead` step over gathered
    tensors: local reductions, but still inside the sharded run."""

    in_mesh = True


LOCAL = LocalAxis()
_LEAD = _LeadStep()
_TLS = threading.local()

# what the last finished sharded run moved across shards: collectives by
# kind and the bytes each kind carried (all_reduce: the partials every
# shard read; gather: the blocks copied to the lead; lead: the results
# handed to the other shards), and the lead shard's host seconds waiting
# in collectives (`wait_s`) and running lead steps (`lead_s`). Read by the
# dryrun, chip_smoke.py and scripts/torch_cycle_profile.py. After a
# spmd_grid run the keys hold the totals over its rows, `grid` its shape
# and `rows` each row's own tally.
LAST_RUN: dict = {}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(v) for v in x)
    return 0


def current():
    """The calling thread's node axis (LOCAL outside a sharded run)."""
    return getattr(_TLS, "axis", LOCAL)


class _Group:
    """The rendezvous of one sharded run's threads."""

    def __init__(self, size: int) -> None:
        self.size = size
        self._cv = threading.Condition()
        self._slots: List[Any] = [None] * size
        self._arrived = 0
        self._gen = 0
        self._result: List[Any] = []
        self._failed: Optional[str] = None
        self._done = 0
        self.exchanges = 0
        self.stats = {"all_reduce": 0, "all_reduce_bytes": 0, "gather": 0,
                      "gather_bytes": 0, "lead": 0, "lead_bytes": 0,
                      "wait_s": 0.0, "lead_s": 0.0}

    def count(self, kind: str, nbytes: int) -> None:
        """Tally one collective (called by shard 0 only)."""
        self.stats[kind] += 1
        self.stats[kind + "_bytes"] += nbytes

    def exchange(self, rank: int, value) -> List[Any]:
        """Every shard's `value`, in shard order, once all have arrived."""
        t0 = time.perf_counter()
        try:
            return self._exchange(rank, value)
        finally:
            if rank == 0:
                self.stats["wait_s"] += time.perf_counter() - t0

    def _exchange(self, rank: int, value) -> List[Any]:
        with self._cv:
            if self._failed or self._done:
                raise MeshAborted(self._failed or "a shard finished while "
                                  "another still takes collectives")
            gen = self._gen
            self._slots[rank] = value
            self._arrived += 1
            if self._arrived == self.size:
                self._result = self._slots
                self._slots = [None] * self.size
                self._arrived = 0
                self._gen += 1
                self.exchanges += 1
                self._cv.notify_all()
                return self._result
            while self._gen == gen and not self._failed and not self._done:
                self._cv.wait()
            if self._gen == gen:
                raise MeshAborted(self._failed or "a shard finished while "
                                  "another still takes collectives")
            return self._result

    def finish(self) -> None:
        with self._cv:
            self._done += 1
            self._cv.notify_all()

    def fail(self, why: str) -> None:
        with self._cv:
            if not self._failed:
                self._failed = why
            self._cv.notify_all()


class ShardAxis(LocalAxis):
    """Shard `rank` of a sharded run: node rows [offset, offset + n) of
    `n_global`, on `device`; `lead_device` is shard 0's."""

    sharded = True
    in_mesh = True

    def __init__(self, group: _Group, rank: int, offsets: Sequence[int],
                 n_global: int, devices: Sequence[torch.device]) -> None:
        self.group = group
        self.rank = rank
        self.size = group.size
        self.offsets = tuple(offsets)
        self.offset = self.offsets[rank]
        self.n_global = n_global
        self.devices = tuple(devices)
        self.device = self.devices[rank]
        self.lead_device = self.devices[0]

    def all_reduce(self, x: Array, op: str) -> Array:
        vals = self.group.exchange(self.rank, x)
        if self.rank == 0:
            self.group.count("all_reduce", self.size * _nbytes(x))
        acc = vals[0].to(self.device)
        for v in vals[1:]:
            acc = _combine(op, acc, v.to(self.device))
        return acc

    def gather(self, x: Array, dim: int) -> Optional[Array]:
        """The full node axis of `x` on the lead device (None on the other
        shards)."""
        return self.gather_many([(x, dim)])[0]

    def gather_many(self, pairs) -> List[Optional[Array]]:
        """Each (tensor, dim) of `pairs` gathered on the lead device, all in
        ONE rendezvous (each still counted as a gather of its own); Nones
        on the other shards."""
        vals = self.group.exchange(self.rank, [x for x, _ in pairs])
        if self.rank != 0:
            return [None] * len(pairs)
        out = []
        for i, (_, dim) in enumerate(pairs):
            self.group.count("gather", sum(_nbytes(v[i]) for v in vals[1:]))
            out.append(torch.cat([v[i].to(self.lead_device) for v in vals],
                                 dim))
        return out

    def gather_tree(self, x, dim: int):
        return self._gather_trees([(x, dim)])[0]

    def _gather_trees(self, trees) -> list:
        """Each (tree, dim) of `trees` gathered leaf by leaf, all of them in
        one rendezvous; the trees rebuilt around the gathered leaves (around
        Nones on the other shards)."""
        pairs = []

        def flat(t, dim):
            if isinstance(t, tuple):
                for v in t:
                    flat(v, dim)
            else:
                pairs.append((t, dim))

        for t, dim in trees:
            flat(t, dim)
        it = iter(self.gather_many(pairs))

        def build(t):
            if isinstance(t, tuple):
                kids = [build(v) for v in t]
                return type(t)(*kids) if hasattr(t, "_fields") else \
                    tuple(kids)
            return next(it)

        return [build(t) for t, _ in trees]

    def lead(self, fn: Callable, *args, **kwargs):
        keys = list(kwargs)
        vals = list(args) + [kwargs[k] for k in keys]
        shards = [i for i, a in enumerate(vals) if isinstance(a, Shard)]
        full = self._gather_trees([(vals[i].x, vals[i].dim)
                                   for i in shards])
        for i, g in zip(shards, full):
            vals[i] = g
        gathered, kw = vals[:len(args)], dict(zip(keys, vals[len(args):]))
        out = None
        if self.rank == 0:
            _TLS.axis = _LEAD
            t0 = time.perf_counter()
            try:
                out = fn(*gathered, **kw)
            except BaseException as e:
                self.group.fail(f"lead step failed: {e!r}")
                raise
            finally:
                _TLS.axis = self
                self.group.stats["lead_s"] += time.perf_counter() - t0
            self.group.count("lead", (self.size - 1) * _nbytes(out))
        out = self.group.exchange(self.rank, out)[0]
        return out if self.rank == 0 else _to(out, self.device)

    def split(self, x: Array, dim: int) -> Array:
        """This shard's block of `x` along `dim`, as its own contiguous
        copy on its device."""
        return x.narrow(dim, self.offset, self._n_local()).to(
            self.device, copy=True, memory_format=torch.contiguous_format)

    def _n_local(self) -> int:
        nxt = (self.offsets[self.rank + 1] if self.rank + 1 < self.size
               else self.n_global)
        return nxt - self.offset

    def local_rows(self, ids: Array, n_local: int):
        inside = (ids >= self.offset) & (ids < self.offset + n_local)
        return torch.where(inside, ids - self.offset, -1), inside


def _run(axes: Sequence[LocalAxis], groups: Sequence[_Group],
         fn: Callable[[int], Any]) -> List[Any]:
    """Run `fn(i)` once per position, each in its own thread under
    `axes[i]` (CUDA positions with their device current); position 0 runs
    in the caller's thread. A position that raises fails every group, so
    the others raise MeshAborted at their next collective. Returns the
    results in order; raises the first real error."""
    size = len(axes)
    prev = current()
    results: List[Any] = [None] * size
    errors: List[Optional[BaseException]] = [None] * size

    def body(i: int) -> None:
        ax = axes[i]
        _TLS.axis = ax
        dev = ax.device
        try:
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    results[i] = fn(i)
            else:
                results[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[i] = e
            for g in groups:
                g.fail(f"shard {i} raised {type(e).__name__}: {e}")
        finally:
            # a shard that finishes while another of its group still waits
            # in a collective means the programs diverged: that one fails
            if ax.group is not None:
                ax.group.finish()
            _TLS.axis = prev if i == 0 else LOCAL

    threads = [threading.Thread(target=body, args=(i,), daemon=True,
                                name=f"ktpu-shard-{i}")
               for i in range(1, size)]
    for t in threads:
        t.start()
    body(0)
    for t in threads:
        t.join()
    real = [e for e in errors if e is not None
            and not isinstance(e, MeshAborted)]
    if real:
        raise real[0]
    if any(e is not None for e in errors):
        raise next(e for e in errors if e is not None)
    return results


def spmd(devices: Sequence[torch.device], offsets: Sequence[int],
         n_global: int, fn: Callable[[int], Any]) -> List[Any]:
    """Run `fn(rank)` once per shard, each in its own thread under that
    shard's ShardAxis (CUDA shards with their device current). Returns the
    results in shard order; raises the first shard's error."""
    group = _Group(len(devices))
    axes = [ShardAxis(group, r, offsets, n_global, devices)
            for r in range(len(devices))]
    try:
        return _run(axes, [group], fn)
    finally:
        LAST_RUN.clear()
        LAST_RUN.update(group.stats, shards=len(devices),
                        exchanges=group.exchanges)


class RowAxis(LocalAxis):
    """A 1-D tenant mesh's row: one device holding its tenants whole, so
    every collective is local, but the thread is inside a fleet run."""

    in_mesh = True

    def __init__(self, device: torch.device) -> None:
        self.device = device


def spmd_grid(rows: Sequence[Sequence[torch.device]],
              offsets: Sequence[int], n_global: int,
              fn: Callable[[int, int], Any]) -> List[List[Any]]:
    """Run `fn(r, s)` once per position of a (rows × shards) grid. The rows
    run in turn: a row of kn > 1 shards in kn threads (the caller's and kn
    - 1 of its own) under the row's node axis, a ShardAxis group whose
    collectives never reach another row; a one-shard row (the 1-D tenant
    mesh) in the calling thread under a RowAxis, with no collective.

    In turn, not all rows at once: every shard thread is host-bound under
    one interpreter lock, and a rendezvous among all the grid's busy
    threads waits behind the others' launches — on the card a 4 × 2 grid's
    runs-engine tick took 19.4 s with every row at once and 7.7 s with
    the rows in turn, one device 3.4 s (scripts/fleet_grid_layouts.py).
    A row that raises ends the run there. Returns the results as
    [row][shard]; LAST_RUN gets the totals over the rows and each row's
    own tally under "rows"."""
    kn = len(rows[0])
    if any(len(row) != kn for row in rows):
        raise ValueError("spmd_grid: every row needs the same shard count")
    blank = _Group(1).stats
    out: List[List[Any]] = []
    per_row: List[dict] = []
    try:
        for r, row in enumerate(rows):
            if kn == 1:
                per_row.append(dict(blank, exchanges=0))
                out.append(_run([RowAxis(torch.device(row[0]))], [],
                                lambda _i: fn(r, 0)))
                continue
            group = _Group(kn)
            axes = [ShardAxis(group, s, offsets, n_global, row)
                    for s in range(kn)]
            try:
                out.append(_run(axes, [group], lambda s: fn(r, s)))
            finally:
                per_row.append(dict(group.stats, exchanges=group.exchanges))
    finally:
        LAST_RUN.clear()
        LAST_RUN.update({k: sum(x[k] for x in per_row) for k in blank},
                        shards=len(rows) * kn, grid=[len(rows), kn],
                        exchanges=sum(x["exchanges"] for x in per_row),
                        rows=per_row)
    return out
