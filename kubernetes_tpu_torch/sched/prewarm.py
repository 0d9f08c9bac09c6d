"""Warm-ahead for capacity-bucket growth (port of the JAX package's
sched/prewarm.py).

Capacities bucket to coarse shapes (state/dims.py), and crossing a bucket
(the cluster grows past 4,096 nodes, existing pods double past E) swaps
every tensor shape of the cycle. In the JAX package that is a fresh XLA
compile, which its prewarmer pays ahead of time from abstract shapes. The
port compiles nothing per shape — its CUDA kernels are built once per source
(ops/kernels.py) — so here the "compile" is a real throwaway dispatch at the
target Dims, in a background thread on the prewarmer's own CUDA stream: the
cycle (K1/K2) for `observe`/`ensure_warm`/`rewarm`, the preemption burst
(K3) for `observe_preempt`. It builds and loads any kernel not built yet and
runs the allocator and the kernels once at the new shapes, so the first live
wave past the boundary pays neither. Its inputs come from a fresh Encoder —
one probe node and self-anti-affine probe pods, so both K1 and K2 launch —
never from the live cache. Whether the warm buys anything on a given card is
a measurement (chip_smoke.py phase 9c); on the H100 it bought nothing and
slowed the serving loop, so the Scheduler builds its prewarmer disabled
unless given `prewarm=True`.

The trigger policy is the JAX package's line for line: growth axes N and E,
threshold 0.8, KTPU_PREWARM_MIN_AXIS, once per signature, gang signatures
warm separately, one warm in flight at a time (the preemption burst on its
own slot), a failed warm clears its entry so a later cycle retries, and
`invalidate()` fences out a warm that started before a backend loss.
Nothing here blocks the serving loop.

Every key carries the mesh signature (parallel/mesh.py mesh_key, None on
one device), as the JAX package's keys do (its `_mesh_sig`): a warm on one
mesh never answers a lookup for another width or for single-device serving,
and a warm with a mesh runs its probe cycle sharded on that mesh — a fleet
warm (`fleet=K`) its probe dispatch on that fleet mesh, so fleet × mesh is
a key slot of its own.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import replace
from typing import Callable, Optional

import torch

from ..api.types import (Affinity, LabelSelector, Node, Pod, PodAffinityTerm,
                         Resources)
from ..state.arrays import tables_to_torch, to_device
from ..state.dims import Dims
from ..state.encode import Encoder
from ..utils import faultline
from ..utils.faultline import InjectedDeviceError

# axes that grow monotonically in a live cluster and cross buckets: nodes,
# bound pods. (P — the pending batch — is bounded by batch_size and churns
# rather than grows.)
_GROWTH_AXES = ("N", "E")

_HOSTNAME = "kubernetes.io/hostname"
_PROBE = "ktpu-warm"


def _probe_objects(n_pods: int, gang: bool):
    """One probe node and `n_pods` probe pods that repel each other by
    hostname (a self-matching required anti-affinity: the wave engine's
    domain-quota pass, K2, runs for them; K1 runs every wave)."""
    node = Node(name=f"{_PROBE}-node", labels={_HOSTNAME: f"{_PROBE}-node"},
                allocatable=Resources.make(cpu="4", memory="8Gi", pods=110))
    anti = Affinity(anti_required=(PodAffinityTerm(
        selector=LabelSelector.of(match_labels={"app": _PROBE}),
        topology_key=_HOSTNAME),))
    pods = [Pod(name=f"{_PROBE}-{i}", labels={"app": _PROBE},
                requests=Resources.make(cpu="100m", memory="64Mi"),
                affinity=anti, creation_index=i,
                pod_group=_PROBE if gang else "",
                min_member=1 if gang else 0)
            for i in range(n_pods)]
    return node, pods


def _probe_encoder() -> Encoder:
    from .cycle import UNSCHEDULABLE_TAINT_KEY

    enc = Encoder()
    enc.vocabs.label_keys.intern(UNSCHEDULABLE_TAINT_KEY)
    enc.vocabs.label_vals.intern("")
    return enc


def _sig(mesh):
    """A mesh (or an already-computed mesh_key, or None) as its key."""
    if mesh is None or isinstance(mesh, tuple):
        return mesh
    from ..parallel.mesh import mesh_key

    return mesh_key(mesh)


def warm_cycle(d: Dims, device: torch.device, gang: bool = False,
               extras: tuple = (), mesh=None) -> Dims:
    """One throwaway cycle at dims `d` on the current stream: a fresh
    Encoder's tables at `d` holding the probe node and two probe pods,
    through sched/cycle.py schedule_batch (the engine KTPU_ASSIGN names)
    with the signature's out-of-set score plugins `extras` folded in, read
    back. Returns the dims it ran at (`d` unless the probe needs a larger
    capacity somewhere)."""
    from .cycle import UNSCHEDULABLE_TAINT_KEY, schedule_batch

    enc = _probe_encoder()
    node, pods = _probe_objects(2, gang)
    tables, ex, pe, dd = enc.encode_cluster([node], [], pods,
                                            replace(d, has_node_name=False))
    gang_arrays = enc.build_gang_arrays(pods, dd, {}) if gang else None
    tt, (ext, pet) = tables_to_torch(tables, (ex, pe), device)
    if mesh is not None:
        from ..parallel.mesh import shard_tables

        tt = shard_tables(tt, mesh)
    keys = (enc.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY),
            enc.vocabs.label_vals.get(""))
    res = schedule_batch(
        tt, pet, keys, dd.D, ext, extra_plugins=extras,
        extra_weights=tuple(float(getattr(p, "weight", 1)) for p in extras),
        gang=(to_device(gang_arrays, device) if gang_arrays is not None
              else None))
    res.node.cpu()
    return dd


def warm_fleet(d: Dims, K: int, device: torch.device, engine: str = "waves",
               rc: int = 0, mesh=None) -> Dims:
    """One throwaway fleet dispatch (fleet/cycle.py) at dims `d` for a stack
    of `K` probe tenants on the current stream, read back — what a fleet
    signature's first live tick would otherwise pay. With a fleet `mesh`
    the probe stack is placed on it (K is already a multiple of its tenant
    rows: the key's stack count is the padded one) and the dispatch runs on
    the grid."""
    from ..fleet.cycle import dispatch_fleet
    from ..fleet.tables import probe_fleet_args

    (tables, pending, existing), keys_host, quota, dd = \
        probe_fleet_args(d, K, device)
    if mesh is not None:
        from ..parallel.mesh import shard_fleet

        tables = shard_fleet((tables, pending, existing), mesh)
        pending = existing = None
    res = dispatch_fleet(tables, pending, keys_host, dd.D, existing, engine,
                         quota, rc=rc)
    res.node.cpu()
    return dd


def warm_preempt(d: Dims, burst: int, device: torch.device,
                 mesh=None) -> Dims:
    """One throwaway preemption burst of `burst` lanes at dims `d` (P=1) on
    the current stream: the probe node holding one bound probe pod, a
    priority preemptor, through sched/preemption.py's burst (K3)."""
    import numpy as np

    from .cycle import UNSCHEDULABLE_TAINT_KEY
    from .preemption import _preempt, _readback

    enc = _probe_encoder()
    node, (victim, vip) = _probe_objects(2, False)
    victim = replace(victim, node_name=node.name, affinity=Affinity())
    vip = replace(vip, priority=1000, affinity=Affinity())
    tables, ex, pe, dd = enc.encode_cluster(
        [node], [victim], [vip], replace(d, has_node_name=False, P=1))
    tt, (ext, pet) = tables_to_torch(tables, (ex, pe), device)
    if mesh is not None:
        from ..parallel.mesh import shard_tables

        tt = shard_tables(tt, mesh)
    keys = (enc.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY),
            enc.vocabs.label_vals.get(""))
    lane = lambda v: torch.full((burst,), int(v), dtype=torch.int32,
                                device=device)
    pdb = torch.from_numpy(np.zeros((dd.E,), bool)).to(device)
    _readback(_preempt(tt, ext, lane(pe.cls[0]), lane(pe.node_name_req[0]),
                       lane(vip.priority), dd.D, keys, pdb))
    return dd


class BucketPrewarmer:
    """Watches per-cycle occupancy and warms the next bucket ahead of need.
    One warm in flight at a time (the preemption burst on its own slot);
    each (dims, engine, extras, gang, rc, fleet) signature is warmed at most
    once until `invalidate()`. `fleet` is the tenant-stack count K of a
    fleet dispatch (fleet/cycle.py), None for a single cluster: a fleet entry
    never answers a single-cluster lookup, nor the reverse.

    `warm` maps each warmed signature to the seconds its warm dispatch took;
    `lookup` is "is this signature warm" — the dispatch supervisor reads it
    for the cold-versus-warm deadline of a signature's first live call."""

    def __init__(self, threshold: float = 0.8, min_axis: int = 256,
                 compile_fn: Optional[Callable] = None, device="cuda"):
        # min_axis: below this capacity a cold first call is cheap enough
        # that warming would just burn host and device time — skip.
        # KTPU_PREWARM_MIN_AXIS overrides.
        self.threshold = threshold
        self.min_axis = int(os.environ.get("KTPU_PREWARM_MIN_AXIS", min_axis))
        self.device = torch.device(device)
        self.enabled = True   # bench/test gate: observe() is a no-op when off
        self._warmed: set = set()
        self._mu = threading.Lock()
        self._inflight: Optional[threading.Thread] = None
        self._inflight_preempt: Optional[threading.Thread] = None
        self._compile_fn = compile_fn or self._compile
        self.warm_log: list = []   # (dims, engine) actually warmed
        self.warm: dict = {}
        # the prewarm stream (CUDA only), made on first use
        self.stream = None
        # bumped by invalidate(): a warm that STARTED before a backend loss
        # must not register afterward
        self._epoch = 0
        # dispatch supervisor (sched/supervisor.py): warm failures that look
        # like backend loss are reported to it
        self.supervisor = None

    @staticmethod
    def _key(d: Dims, engine: str, extras: tuple, gang: bool, rc: int,
             fleet=None, mesh=None):
        return (replace(d, has_node_name=False), engine, extras, gang, rc,
                fleet, _sig(mesh))

    @staticmethod
    def _mesh_kw(mesh) -> dict:
        # compile functions without a mesh keep their mesh-free signature
        return {} if mesh is None else {"mesh": mesh}

    def _on_stream(self):
        """The warm thread's context: the prewarmer's device and its own
        stream, which first waits for the work already queued on the
        device's default stream."""
        stack = contextlib.ExitStack()
        if self.device.type == "cuda":
            stack.enter_context(torch.cuda.device(self.device))
            if self.stream is None:
                self.stream = torch.cuda.Stream(self.device)
            self.stream.wait_stream(torch.cuda.default_stream(self.device))
            stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def observe(self, d: Dims, n_nodes: int, n_existing: int,
                engine: str = "waves", extras: tuple = (),
                gang: bool = False, rc: int = 0, fleet=None,
                mesh=None) -> None:
        """Call once per cycle with live occupancy (and whether batches are
        gang-bearing — a gang batch runs a different program). Cheap when
        nothing is near a boundary. Warms one target per call; multiple
        crossing axes warm on successive cycles (single-axis targets first,
        then the joint one)."""
        if not self.enabled:
            return
        live = {"N": n_nodes, "E": n_existing}
        crossing = [ax for ax in _GROWTH_AXES
                    if getattr(d, ax) >= self.min_axis
                    and live[ax] >= self.threshold * getattr(d, ax)]
        if not crossing:
            return
        targets = [d.grown_for(**{ax: getattr(d, ax) + 1}) for ax in crossing]
        if len(crossing) > 1:
            targets.append(d.grown_for(
                **{ax: getattr(d, ax) + 1 for ax in crossing}))
        for target in targets:
            if target == d:
                continue
            key = self._key(target, engine, extras, gang, rc, fleet, mesh)
            with self._mu:
                if key in self._warmed:
                    continue
                if self._inflight is not None and self._inflight.is_alive():
                    return  # one warm at a time; retry next cycle
                self._warmed.add(key)
                t = threading.Thread(
                    target=self._compile_fn,
                    args=(target, engine, extras, gang, rc, fleet),
                    kwargs=self._mesh_kw(mesh),
                    name=f"ktpu-prewarm-{target.N}x{target.E}", daemon=True)
                # start BEFORE publishing: wait() joins _inflight without
                # the lock, and joining a not-yet-started thread raises
                t.start()
                self._inflight = t
            return

    def _compile(self, d: Dims, engine: str, extras: tuple, gang: bool,
                 rc: int = 0, fleet=None, mesh=None) -> None:
        """The warm of one cycle signature (the JAX package's background
        compile): a throwaway dispatch at `d` on the prewarm stream — a
        fleet dispatch of `fleet` probe tenants when that slot is set, a
        sharded one on `mesh`."""
        key = self._key(d, engine, extras, gang, rc, fleet, mesh)
        epoch = self._epoch
        try:
            if faultline.should("device.error", "prewarm"):
                raise InjectedDeviceError("injected device error at prewarm")
            t0 = time.perf_counter()
            with self._on_stream():
                if fleet is not None:
                    warm_fleet(d, int(fleet), self.device, engine, rc,
                               mesh=mesh)
                else:
                    warm_cycle(d, self.device, gang=gang, extras=extras,
                               mesh=mesh)
            seconds = time.perf_counter() - t0
            with self._mu:
                if epoch != self._epoch:
                    # invalidate() ran mid-warm (backend loss): drop it and
                    # let a post-recovery warm redo the work
                    self._warmed.discard(key)
                    return
                self.warm[key] = seconds
            self.warm_log.append((d, engine))
        except Exception as e:
            # warming is an optimization: a failed warm must never take down
            # the scheduling loop; a failure that smells like backend loss
            # IS reported to the supervisor
            with self._mu:
                self._warmed.discard(key)
            if self.supervisor is not None:
                self.supervisor.note_compile_failure(e)

    def lookup(self, d: Dims, engine: str, extras: tuple, gang: bool,
               rc: int = 0, fleet=None, mesh=None) -> bool:
        """Is this cycle signature warm (on this mesh)?"""
        return self._key(d, engine, extras, gang, rc, fleet, mesh) \
            in self.warm

    def invalidate(self) -> None:
        """Drop every warm record and fence out in-flight warms (epoch bump:
        one that started before the loss must not register afterward).
        Called on backend loss (sched/supervisor.py)."""
        with self._mu:
            self._epoch += 1
            self.warm.clear()
            self._warmed.clear()

    def rewarm(self, d: Dims, engine: str = "waves", extras: tuple = (),
               gang: bool = False, rc: int = 0, fleet=None,
               mesh=None) -> bool:
        """Force a background warm of the CURRENT dims regardless of
        occupancy thresholds — the backend re-admission path. If a warm is
        already in flight the rewarm CHAINS behind it. Returns True when
        the warm ran or was scheduled."""
        if not self.enabled:
            return False
        if max(d.N, d.E) < self.min_axis:
            return False  # small shapes run cold in milliseconds
        key = self._key(d, engine, extras, gang, rc, fleet, mesh)
        args = (d, engine, extras, gang, rc, fleet)
        kw = self._mesh_kw(mesh)
        with self._mu:
            self._warmed.add(key)
            prev = self._inflight
            if prev is not None and prev.is_alive():
                def chained():
                    prev.join()
                    self._compile_fn(*args, **kw)

                t = threading.Thread(
                    target=chained,
                    name=f"ktpu-prewarm-re-{d.N}x{d.E}", daemon=True)
            else:
                t = threading.Thread(
                    target=self._compile_fn,
                    args=args, kwargs=kw,
                    name=f"ktpu-prewarm-re-{d.N}x{d.E}", daemon=True)
            t.start()  # before publishing: see observe()
            self._inflight = t
        return True

    def ensure_warm(self, d: Dims, engine: str = "waves", extras: tuple = (),
                    gang: bool = False, rc: int = 0, fleet=None,
                    mesh=None) -> bool:
        """The warm-standby beat (Scheduler.warm_standby): warm this exact
        signature in the background IF it is neither warm nor warming —
        idempotent, unlike rewarm. Returns True when a warm was
        scheduled."""
        if not self.enabled or max(d.N, d.E) < self.min_axis:
            return False
        with self._mu:
            if self._key(d, engine, extras, gang, rc, fleet, mesh) \
                    in self._warmed:
                return False
        return self.rewarm(d, engine, extras, gang, rc, fleet, mesh)

    def ensure_patch_ladder(self, cache, snap) -> bool:
        """Background warm of the resident patch ladder (state/cache.py
        warm_patch_ladder): one no-op index_copy per rung of each resident
        plane, keyed by plane shapes. Returns True when a pass was
        scheduled."""
        if not self.enabled or snap is None \
                or max(snap.dims.N, snap.dims.E) < self.min_axis:
            return False
        key = ("patch-ladder", snap.dims.N, snap.dims.E, snap.dims.P)
        with self._mu:
            if key in self._warmed:
                return False
            if self._inflight is not None and self._inflight.is_alive():
                return False  # one warm at a time; retry next cycle
            self._warmed.add(key)

            def _run():
                try:
                    with self._on_stream():
                        cache.warm_patch_ladder(snap)
                except Exception as e:  # noqa: BLE001 - an optimization
                    with self._mu:
                        self._warmed.discard(key)
                    if self.supervisor is not None:
                        self.supervisor.note_compile_failure(e)

            t = threading.Thread(target=_run, daemon=True,
                                 name=f"ktpu-prewarm-ladder-{snap.dims.N}"
                                      f"x{snap.dims.E}")
            t.start()
            self._inflight = t
        return True

    # ---- preemption burst (sched/preemption.py _preempt, K3) ---- #

    @staticmethod
    def _preempt_key(d: Dims, burst: int, mesh=None):
        # the burst never sees the pending arrays, so P (and the per-batch
        # has_node_name flag) must not split the key
        return ("preempt", replace(d, has_node_name=False, P=1), burst,
                _sig(mesh))

    def observe_preempt(self, d: Dims, burst: int, mesh=None) -> None:
        """Warm the preemption burst for the CURRENT dims in the background,
        once per (dims, burst) — nothing else runs it before the first
        preemption storm."""
        if not self.enabled:
            return
        if max(d.N, d.E) < self.min_axis:
            return
        key = self._preempt_key(d, burst, mesh)
        with self._mu:
            if key in self._warmed:
                return
            if self._inflight_preempt is not None \
                    and self._inflight_preempt.is_alive():
                return  # one preempt warm at a time; retry next cycle
            self._warmed.add(key)
            t = threading.Thread(
                target=self._compile_preempt, args=(d, burst, mesh),
                name=f"ktpu-prewarm-preempt-{d.N}x{d.E}", daemon=True)
            t.start()  # before publishing: see observe()
            self._inflight_preempt = t

    def _compile_preempt(self, d: Dims, burst: int, mesh=None) -> None:
        key = self._preempt_key(d, burst, mesh)
        epoch = self._epoch
        try:
            if faultline.should("device.error", "prewarm"):
                raise InjectedDeviceError("injected device error at prewarm")
            t0 = time.perf_counter()
            with self._on_stream():
                warm_preempt(d, burst, self.device, mesh=mesh)
            seconds = time.perf_counter() - t0
            with self._mu:
                if epoch != self._epoch:
                    self._warmed.discard(key)  # invalidated mid-warm
                    return
                self.warm[key] = seconds
            self.warm_log.append((d, "preempt"))
        except Exception as e:
            with self._mu:
                self._warmed.discard(key)
            if self.supervisor is not None:
                self.supervisor.note_compile_failure(e)

    def lookup_preempt(self, d: Dims, burst: int, mesh=None) -> bool:
        return self._preempt_key(d, burst, mesh) in self.warm

    def wait(self, timeout: Optional[float] = None) -> None:
        """Test/shutdown helper: join the in-flight warms."""
        with self._mu:
            threads = (self._inflight, self._inflight_preempt)
        for t in threads:
            if t is not None:
                t.join(timeout)
