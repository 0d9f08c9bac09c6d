"""FleetServer: K virtual tenant clusters behind one resident scheduler (port
of the JAX package's fleet/server.py).

Ownership model:

  * ONE supervisor — every fleet dispatch runs under the watchdog/fallback
    ladder (sched/supervisor.py), keyed by the fleet signature.
  * ONE prewarmer — a fleet dispatch warms under the fleet key slot
    (sched/prewarm.py `fleet=`), so a K-tenant entry and a single-cluster
    one never cross. Built disabled (`prewarmer.enabled = True` turns it
    on), as the Scheduler builds its own.
  * ONE event-ingest surface — callers route watch events to
    `tenant(name).on_pod_add(...)` etc., or attach the watch plane
    (`attach_watch_plane`): one multiplexed stream per resource for every
    tenant, routed by tenant label (client/watchmux.py).
  * K per-tenant Schedulers — each tenant keeps its OWN cache, queue,
    encoder, BindIntentLedger and fencing token. The intent namespace is
    `/registry/ktpu.io/bindintents/<tenant>/<sched>/…` (`tenant_ledger`),
    so one tenant's crash replay or fenced takeover cannot touch another
    tenant's binds; `recover()` replays each tenant's ledger through its
    own Scheduler.

A `tick()` is the fleet analog of `Scheduler.schedule_pending`: pump every
tenant's queue, pop per-tenant batches, snapshot each tenant at the SHARED
fleet bucket (fleet/tables.py `fleet_dims` — state/cache.py grows every
tenant up to the union), refresh each engine group's resident stack (one
batched row patch for the changed tenants), then ONE fleet dispatch per
engine group with the DRF clamp computed over the whole stack
(fleet/cycle.py), and finally the per-tenant commit loops — intent write →
assume → fenced bind → retire, through each tenant's own Scheduler.

The server runs on the CUDA device unless `device="cpu"` is asked for; with
no GPU and no explicit CPU device it raises. A failed or hung dispatch is
abandoned and every popped pod requeued, unless the constructor names a
`fallback_device` (sched/supervisor.py).

The fleet mesh (`mesh=`, `node_shards=` or KTPU_FLEET_NODE_SHARDS): an int n
builds a fleet-mode MeshState over n CUDA devices, or over the pool the
caller gives (`mesh_devices`, repeats allowed), raising with the mesh note
when there are fewer; a FleetMesh or a fleet-mode MeshState is taken as
given; garbage clamps to no mesh. On the 1-D tenant mesh each device is a
row of whole tenants; with node_shards = kn > 1 the devices form the
(n/kn, kn) grid and each tenant's node planes are cut across its row
(parallel/mesh.py). The stacks live on the mesh (fleet/tables.py), the
bucket's N grows to a node-shard multiple, each row takes its slice of the
quota vector at dispatch, and the prewarmer's and the supervisor's keys
carry the mesh. A backend loss drops the whole mesh: the degraded tick
never touches the resident stacks, the fallback re-encodes meshless onto
`fallback_device`, and a reform is adopted at the next tick (the stacks
restack onto it).
Gang- and nodeName-bearing tenants take their solo waves meshless, as in
the reference.

Chaos: the `tenant.storm@<tenant>` seam (utils/faultline.py) simulates a
per-tenant watch storm — that tenant's snapshot is invalidated (full
re-encode next tick) and its batch stays queued; only ITS CycleStats
degrade.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..sched.scheduler import CycleStats, Scheduler
from ..state.arrays import resolve_device
from ..state.dims import Dims
from ..utils import faultline
from .cycle import FleetResult, dispatch_fleet, fleet_signature
from .quota import violation_headroom
from .tables import FleetStack, fleet_dims


class _TenantIngest:
    """The v1-dict → typed conversion shim between one tenant's mux routes
    and its Scheduler — the per-tenant half of SchedulerServer's event
    handlers (eventhandlers.go), minus everything the fleet owns."""

    def __init__(self, tenant: "FleetTenant"):
        # resolved once here, not per event: these handlers sit on the
        # ingest hot path
        from ..api.v1 import node_from_v1, pod_from_v1
        from ..machinery import meta
        from ..sched.server import apply_pod_update_v1, pod_schedulable_v1

        self.tenant = tenant
        self._seq = 0
        self._pod_from_v1 = pod_from_v1
        self._node_from_v1 = node_from_v1
        self._meta_name = meta.name
        self._pod_schedulable_v1 = pod_schedulable_v1
        self._apply_pod_update_v1 = apply_pod_update_v1

    def _to_pod(self, obj):
        p = self._pod_from_v1(obj)
        self._seq += 1
        p.creation_index = self._seq
        return p

    # every handler holds the tenant's ingest lock — the per-tenant
    # "event handlers vs waves" serialization SchedulerServer._mu provides
    # for the single-cluster path

    def on_pod_add(self, obj) -> None:
        if self._pod_schedulable_v1(obj):
            with self.tenant.ingest_mu:
                self.tenant.on_pod_add(self._to_pod(obj))

    def on_pod_update(self, old, new) -> None:
        # the SAME transition logic as SchedulerServer's informer handler
        with self.tenant.ingest_mu:
            self._apply_pod_update_v1(self.tenant.sched, old, new,
                                      self._to_pod)

    def on_pod_delete(self, obj) -> None:
        with self.tenant.ingest_mu:
            self.tenant.on_pod_delete(self._pod_from_v1(obj))

    def on_node_add(self, obj) -> None:
        with self.tenant.ingest_mu:
            self.tenant.on_node_add(self._node_from_v1(obj))

    def on_node_update(self, old, new) -> None:
        with self.tenant.ingest_mu:
            self.tenant.on_node_update(self._node_from_v1(new))

    def on_node_delete(self, obj) -> None:
        with self.tenant.ingest_mu:
            self.tenant.on_node_delete(self._meta_name(obj))


class FleetWatchPlane:
    """ONE multiplexed watch stream per resource for the whole fleet. Two
    `WatchMux`es (pods, nodes) each own a single bookmark-resumable
    SharedInformer; every tenant gets a bounded route keyed by the tenant
    label. K tenants therefore put exactly 2 watch streams on the
    apiserver — not 2×K — and a disruption costs at most one resume (or,
    beneath the compaction floor, ONE relist) fleet-wide.

    A mux-stream death does not drop ticks: tenants keep scheduling from
    cached state while `tenant_staleness_seconds` grows; `maintain()`
    (called from FleetServer.tick) narrates the death, revives the stream
    (restart-as-resume), and the staleness decays back to ~0."""

    def __init__(self, server: "FleetServer", client,
                 tenant_label: Optional[str] = None, namespace: str = "",
                 buffer: int = 4096, auto_revive: bool = True):
        from ..client.informers import SharedInformer
        from ..client.watchmux import TENANT_LABEL, WatchMux

        self.server = server
        self.client = client
        self.tenant_label = tenant_label or TENANT_LABEL
        self.auto_revive = auto_revive
        self.pod_mux = WatchMux(
            SharedInformer(client.pods, namespace=namespace),
            tenant_label=self.tenant_label, buffer=buffer, name="pods")
        self.node_mux = WatchMux(
            SharedInformer(client.nodes),
            tenant_label=self.tenant_label, buffer=buffer, name="nodes")
        self._ingests: Dict[str, _TenantIngest] = {}
        self.mux_failovers = 0       # deaths maintain() recovered from
        self.max_staleness = 0.0     # worst staleness ever exported
        self._dead_noted: set = set()  # mux_die narration latch
        self._started = False

    @property
    def muxes(self):
        return (self.pod_mux, self.node_mux)

    def add_route(self, tenant: "FleetTenant") -> None:
        ing = _TenantIngest(tenant)
        self._ingests[tenant.name] = ing
        self.pod_mux.route(tenant.name, on_add=ing.on_pod_add,
                           on_update=ing.on_pod_update,
                           on_delete=ing.on_pod_delete)
        self.node_mux.route(tenant.name, on_add=ing.on_node_add,
                            on_update=ing.on_node_update,
                            on_delete=ing.on_node_delete)

    def start(self) -> "FleetWatchPlane":
        for t in self.server.tenants.values():
            if t.name not in self._ingests:
                self.add_route(t)
        for m in self.muxes:
            m.start()
        for m in self.muxes:
            if not m.wait_for_sync(30.0):
                # a sync timeout must not read as a healthy start: narrate
                # it and let staleness carry the ongoing signal
                self.server.telemetry.note_supervisor_event(
                    "mux_unsynced",
                    f"{m.name}: initial list+watch did not sync within "
                    "30s; ticking against unsynced caches until it does")
        self._started = True
        return self

    def stop(self) -> None:
        # a deliberate stop must not read as a death: maintain() guards on
        # _started, so clearing it keeps the next tick from reviving muxes
        # whose route threads have already exited
        self._started = False
        for m in self.muxes:
            m.stop()
        if self.server.watch_plane is self:
            self.server.watch_plane = None

    def staleness(self) -> float:
        """Seconds since the LEAST-recently-heard-from upstream stream —
        bookmarks count, so a healthy quiet fleet sits near the bookmark
        interval's remainder, never growing."""
        now = time.monotonic()
        return max(0.0, now - min(m.last_signal for m in self.muxes))

    def tenant_staleness(self) -> Dict[str, float]:
        """Per-tenant staleness: the upstream-stream staleness, PLUS a
        route-local penalty for any tenant whose route still has
        undelivered backlog (its serving state is only as fresh as the last
        event it actually applied)."""
        now = time.monotonic()
        fleet = self.staleness()
        out: Dict[str, float] = {}
        # snapshot: a late add_tenant() inserts into _ingests from another
        # thread mid-tick
        for name in list(self._ingests):
            stale = fleet
            for m in self.muxes:
                r = m.routes.get(name)
                if r is not None and r.depth() > 0:
                    stale = max(stale, now - r.last_event)
            out[name] = max(0.0, stale)
        return out

    def maintain(self) -> float:
        """Per-tick upkeep: export staleness, revive dead streams. Returns
        the worst staleness exported (pre-revive, so the tick that
        discovers a death records how stale its serving state was)."""
        from ..sched.metrics import observe_tenant_staleness

        if not self._started:
            return 0.0
        per_tenant = self.tenant_staleness()
        stale = max(per_tenant.values(), default=self.staleness())
        self.max_staleness = max(self.max_staleness, stale)
        observe_tenant_staleness(per_tenant)
        for m in self.muxes:
            if not m.alive:
                # edge-triggered narration: a stream left dead across ticks
                # narrates once
                if m.name not in self._dead_noted:
                    self._dead_noted.add(m.name)
                    self.server.telemetry.note_supervisor_event(
                        "mux_die", f"{m.name}: stream dead, serving cached "
                        f"state ({stale:.1f}s stale)")
                if self.auto_revive:
                    try:
                        m.revive()
                    except RuntimeError as e:
                        # a wedged informer thread must not become a
                        # fleet-wide tick exception: narrate, serve cached
                        # state, retry next tick
                        self.server.telemetry.note_supervisor_event(
                            "mux_revive_failed", f"{m.name}: {e}")
                        continue
                    self.mux_failovers += 1
                    self._dead_noted.discard(m.name)
                    self.server.telemetry.note_supervisor_event(
                        "mux_revive",
                        f"{m.name}: resumed (relists={m.informer.relists}, "
                        f"resumes={m.informer.resumes})")
            else:
                self._dead_noted.discard(m.name)
        return stale

    def stats(self) -> Dict[str, object]:
        return {
            "upstream_watches_per_resource": 1,
            "mux_failovers": self.mux_failovers,
            "max_staleness_seconds": round(self.max_staleness, 3),
            "pods": self.pod_mux.stats(),
            "nodes": self.node_mux.stats(),
        }


def tenant_ledger(storage, tenant: str,
                  scheduler_name: str = "default-scheduler"):
    """A per-tenant BindIntentLedger: intents live under
    `/registry/ktpu.io/bindintents/<tenant>/<scheduler>/…` — disjoint
    prefixes per tenant, so replay and unretired listings are tenant-scoped
    by construction."""
    from ..sched.ledger import BindIntentLedger

    return BindIntentLedger(storage,
                            scheduler_name=f"{tenant}/{scheduler_name}")


class FleetTenant:
    """One virtual cluster: a full Scheduler whose DISPATCH the fleet owns.
    The wrapped Scheduler contributes its cache/queue/encoder, the commit
    path (`_commit`, `_write_intent`/`_retire_intent`), intent replay
    (`recover`), the event handlers and its own wave for the solo route —
    everything except the stacked device cycle, which `FleetServer.tick`
    runs."""

    def __init__(self, name: str, binder, quota: float = 1.0,
                 ledger=None, fence_source=None,
                 clock: Callable[[], float] = time.monotonic,
                 device="cuda", fallback_device=None):
        self.name = name
        self.quota = float(quota)
        # mesh=0 pins the tenant's own state to one device (KTPU_MESH is
        # not read): the fleet's stacks carry its residency and sharding
        self.sched = Scheduler(binder=binder, ledger=ledger,
                               fence_source=fence_source, clock=clock,
                               device=device, mesh=0,
                               fallback_device=fallback_device)
        # the fleet's prewarmer owns warm-ahead
        self.sched.prewarmer.enabled = False
        if self.sched.governor is not None:
            # per-tenant governor series label by TENANT, not the shared
            # scheduler name
            self.sched.governor.name = name
            self.sched.governor.breaker.name = name
        self.storm_ticks = 0
        # serializes THIS tenant's event ingest (watch-plane route threads)
        # against the tick's mutating phases on the same tenant
        self.ingest_mu = threading.Lock()

    # -- event-ingest passthrough (the informer routing surface) -- #

    def on_pod_add(self, pod):
        self.sched.on_pod_add(pod)

    def on_pod_update(self, old, new):
        self.sched.on_pod_update(old, new)

    def on_pod_delete(self, pod):
        self.sched.on_pod_delete(pod)

    def on_node_add(self, node):
        self.sched.on_node_add(node)

    def on_node_update(self, node):
        self.sched.on_node_update(node)

    def on_node_delete(self, name):
        self.sched.on_node_delete(name)


@dataclass
class FleetTickStats:
    """One tick's outcome, per tenant plus the fleet-wide invariants."""

    per_tenant: Dict[str, CycleStats] = field(default_factory=dict)
    dispatches: int = 0               # fleet dispatches this tick (one per
                                      # ENGINE GROUP, plus one per solo
                                      # tenant wave)
    engine_groups: int = 0            # distinct per-tenant engines this tick
    drf_violations: int = 0           # tenants whose admitted demand broke
                                      # their headroom (budget: 0)
    drf_clamped: int = 0              # pods deferred by the quota pre-mask
    cross_tenant_placements: int = 0  # placements onto a node row outside
                                      # the tenant's own cluster (budget: 0)
    tick_seconds: float = 0.0
    staleness_seconds: float = 0.0    # watch-plane staleness at tick start
    # CUDA-event time from the start to the end of each group dispatch's
    # device work on the dispatch stream, summed (0.0 on the CPU)
    execute_seconds: float = 0.0

    @property
    def scheduled(self) -> int:
        return sum(s.scheduled for s in self.per_tenant.values())

    @property
    def attempted(self) -> int:
        return sum(s.attempted for s in self.per_tenant.values())


class FleetServer:
    """One resident scheduler serving K virtual tenant clusters per tick.
    See the module docstring for the ownership model."""

    #: the engines a per-tenant config may name
    ENGINES = ("waves", "runs", "scan")

    def __init__(self, batch_size: int = 1024,
                 base_dims: Optional[Dims] = None, mesh=None,
                 node_shards: Optional[int] = None,
                 engines: Optional[Dict[str, str]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 scheduler_name: str = "default-scheduler",
                 storage=None, device="cuda", fallback_device=None,
                 mesh_devices=None):
        from ..sched.prewarm import BucketPrewarmer
        from ..sched.supervisor import DispatchSupervisor
        from ..sched.telemetry import SchedulerTelemetry
        from ..utils.envparse import env_int

        if node_shards is None:
            node_shards = env_int("KTPU_FLEET_NODE_SHARDS", 1, 1, 64)
        self.node_shards = int(node_shards)
        self.device = resolve_device(device)
        self.mesh, self.mesh_state = self._make_fleet_mesh(
            mesh, self.node_shards, mesh_devices)
        self.fallback_device = fallback_device
        self.batch_size = batch_size
        self.clock = clock
        self.scheduler_name = scheduler_name
        self.storage = storage
        # per-tenant engine config: tenants grouped by engine run as
        # sub-dispatches of the same tick; unlisted tenants follow the fleet
        # default (KTPU_ASSIGN). An explicit config naming an unknown engine
        # is a caller bug and raises.
        engines = dict(engines or {})
        bad = {n: e for n, e in engines.items() if e not in self.ENGINES}
        if bad:
            raise ValueError(
                f"unknown engine(s) in per-tenant config: {bad!r} — "
                f"valid engines: {self.ENGINES}")
        self.engines: Dict[str, str] = engines
        self.prewarmer = BucketPrewarmer(device=self.device)
        self.prewarmer.enabled = False
        self.dispatch_stream = (torch.cuda.default_stream(self.device)
                                if self.device.type == "cuda" else None)
        self.supervisor = DispatchSupervisor(
            self.device, prewarmer=self.prewarmer,
            stream=self.dispatch_stream, fallback_device=fallback_device,
            mesh_state=self.mesh_state)
        self.prewarmer.supervisor = self.supervisor
        # re-admission rewarms under the FLEET mesh's key: a fleet-mode
        # MeshState reforms the grid itself; the provider answers for a
        # mesh adopted without one
        self.supervisor.mesh_provider = lambda: self.mesh
        # fleet-level flight recorder (sched/telemetry.py): per-tick phase
        # spans + per-TENANT stats on each record; storms and abandoned
        # dispatches auto-dump
        self.telemetry = SchedulerTelemetry(name="fleet")
        self.supervisor.event_sink = self.telemetry.note_supervisor_event
        # one resident FleetStack PER ENGINE GROUP, created lazily
        self.stacks: Dict[str, FleetStack] = {}
        self._fleet_dims: Dims = replace(base_dims or Dims(),
                                         has_node_name=False)
        self.tenants: Dict[str, FleetTenant] = {}
        # cumulative fleet-wide invariants
        self.ticks = 0
        self.total_drf_violations = 0
        self.total_cross_tenant = 0
        self.total_drf_clamped = 0
        self.max_dispatches_per_tick = 0
        self.max_engine_groups = 1
        self._super_epoch = self._supervisor_epoch()
        # the shared watch plane (attach_watch_plane)
        self.watch_plane: Optional[FleetWatchPlane] = None

    def _supervisor_epoch(self):
        """Changes whenever a primary dispatch hung/failed or the backend
        was re-admitted — i.e. whenever an abandoned worker might still read
        the resident stacked tensors."""
        st = self.supervisor.stats
        return (st.degraded_cycles, st.abandoned, st.recoveries)

    @staticmethod
    def _make_fleet_mesh(mesh, node_shards: int = 1, devices=None):
        """→ (mesh, mesh_state). An int (or int string) n > 1 builds a
        fleet-mode MeshState over n devices of `devices`, else of the CUDA
        devices — raising, with the mesh note, when there are fewer — whose
        node-shard width is `node_shards` clamped to a power of two ≤ n;
        the degrade → reform ladder owns the mesh from then on. A fleet-mode
        MeshState is taken as it is; a Mesh is adopted as a fleet mesh over
        its devices, with no state to reform. None, 0, 1 and garbage clamp
        to no mesh."""
        from ..parallel.mesh import (FleetMesh, Mesh, MeshState,
                                     make_fleet_mesh)
        from ..utils.envparse import clamped_int

        if mesh is None:
            return None, None
        if isinstance(mesh, MeshState):
            if mesh._fleet_ns is None:
                raise ValueError("a fleet takes a fleet-mode MeshState "
                                 "(MeshState(..., fleet_node_shards=k))")
            return mesh.mesh, mesh
        if isinstance(mesh, FleetMesh):
            return mesh, None
        if isinstance(mesh, Mesh):
            return make_fleet_mesh(mesh.size, node_shards=node_shards,
                                   devices=mesh.devices), None
        n = clamped_int(mesh, 0, 0, 4096)
        if n <= 1:
            return None, None
        make_fleet_mesh(n, devices=devices)  # raises when short
        ns = clamped_int(node_shards, 1, 1, 64)
        state = MeshState(n, devices=devices, fleet_node_shards=ns)
        if state.mesh is None:
            return None, None
        return state.mesh, state

    # ------------------------------------------------------------------ #
    # per-engine-group residency
    # ------------------------------------------------------------------ #

    def _engine_for(self, name: str) -> str:
        from ..sched.cycle import _engine

        return self.engines.get(name) or _engine()

    def _stack_for(self, engine: str) -> FleetStack:
        st = self.stacks.get(engine)
        if st is None:
            st = self.stacks[engine] = FleetStack(self.device,
                                                  mesh=self.mesh)
        return st

    @property
    def stack(self) -> FleetStack:
        """The default-engine group's stack — THE stack of a uniform-engine
        fleet."""
        from ..sched.cycle import _engine

        if len(self.stacks) == 1:
            return next(iter(self.stacks.values()))
        return self._stack_for(_engine())

    def _invalidate_stacks(self) -> None:
        for st in self.stacks.values():
            st.invalidate()

    def _node_shard_width(self) -> int:
        from ..parallel.mesh import fleet_mesh_shape

        return 1 if self.mesh is None else fleet_mesh_shape(self.mesh)[1]

    def _sync_mesh(self) -> None:
        """Adopt the MeshState's current mesh (a loss dropped it; a reform
        built a new one, possibly narrower): every group stack re-homes and
        restacks onto the new placement."""
        if self.mesh_state is None or self.mesh_state.mesh is self.mesh:
            return
        self.mesh = self.mesh_state.mesh
        for st in self.stacks.values():
            st.mesh = self.mesh
            st.invalidate()

    # ------------------------------------------------------------------ #
    # tenant lifecycle
    # ------------------------------------------------------------------ #

    def add_tenant(self, name: str, binder=None, quota: float = 1.0,
                   ledger=None, fence_source=None) -> FleetTenant:
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} already registered")
        if binder is None:
            from ..sched.scheduler import RecordingBinder

            binder = RecordingBinder()
        if ledger is None and self.storage is not None:
            ledger = tenant_ledger(self.storage, name, self.scheduler_name)
        t = FleetTenant(name, binder, quota=quota, ledger=ledger,
                        fence_source=fence_source, clock=self.clock,
                        device=self.device,
                        fallback_device=self.fallback_device)
        self.tenants[name] = t
        if self.watch_plane is not None:
            # a late tenant joins the EXISTING streams: its routes resync
            # from the mux indexers — the apiserver sees no new watch
            self.watch_plane.add_route(t)
        return t

    def tenant(self, name: str) -> FleetTenant:
        return self.tenants[name]

    def attach_watch_plane(self, client, tenant_label: Optional[str] = None,
                           namespace: str = "", buffer: int = 4096,
                           auto_revive: bool = True,
                           start: bool = True) -> FleetWatchPlane:
        """Wire the fleet to a live apiserver through ONE multiplexed watch
        stream per resource. Registers a route per existing tenant; tenants
        added later join the same streams."""
        if self.watch_plane is not None:
            # silently replacing a live plane would leave the old one's
            # informer + route threads running — double ingest per event
            raise ValueError("a watch plane is already attached; stop() "
                             "it first")
        self.watch_plane = FleetWatchPlane(
            self, client, tenant_label=tenant_label, namespace=namespace,
            buffer=buffer, auto_revive=auto_revive)
        if start:
            self.watch_plane.start()
        return self.watch_plane

    def recover(self, now: Optional[float] = None) -> Dict[str, object]:
        """Startup/takeover reconciliation, per tenant through its OWN
        ledger namespace."""
        out = {}
        for name, t in self.tenants.items():
            with t.ingest_mu:
                out[name] = t.sched.recover(now=now)
        return out

    # ------------------------------------------------------------------ #
    # the fleet tick
    # ------------------------------------------------------------------ #

    def _snapshot_round(self, tlist, batches, device=None):
        """Snapshot every tenant at the shared fleet bucket, growing the
        bucket (and re-snapshotting) until all tenants agree — at most two
        passes in practice (one tenant grew, everyone follows)."""
        from ..sched.cycle import snapshot_with_keys

        device = device or self.supervisor.snapshot_device()
        snaps: Dict[str, object] = {}
        keys: Dict[str, Tuple] = {}
        kn = self._node_shard_width()
        for _ in range(4):
            for t in tlist:
                pending = [p for p, _ in batches[t.name]]
                snaps[t.name], keys[t.name] = snapshot_with_keys(
                    t.sched.cache, t.sched.encoder, pending,
                    self._fleet_dims, device=device)
            union = fleet_dims([snaps[t.name].dims for t in tlist],
                               base=self._fleet_dims)
            if kn > 1:
                # the grid: the bucket's N must divide the node-shard row
                # so the stacked planes split without padding (a no-op for
                # the bucketed N; the guard covers raw shapes)
                from ..parallel.mesh import padded_node_count

                union = replace(union, N=padded_node_count(union.N, kn))
            if all(replace(snaps[t.name].dims, has_node_name=False)
                   == union for t in tlist):
                self._fleet_dims = union
                return snaps, keys
            self._fleet_dims = union
        raise RuntimeError("fleet bucket did not converge in 4 passes")

    def micro_pass(self, now: Optional[float] = None,
                   tick: Optional[FleetTickStats] = None
                   ) -> Dict[str, CycleStats]:
        """Streaming micro-admission across the fleet: each micro-ready
        tenant admits its fresh-delta lane through ITS OWN scheduler under
        its ingest lock. Tenants with mixed/deep/empty backlogs are
        untouched; those pods ride the stacked bulk dispatch. When `tick`
        is given, each tenant's micro outcome is merged into its per-tenant
        stats."""
        now = self.clock() if now is None else now
        out: Dict[str, CycleStats] = {}
        for t in list(self.tenants.values()):
            if not t.sched.microwave:
                continue
            with t.ingest_mu:
                st = t.sched.schedule_micro(now)
            if not st.micro:
                continue
            out[t.name] = st
            agg = tick.per_tenant.get(t.name) if tick is not None else None
            if agg is not None:
                agg.attempted += st.attempted
                agg.scheduled += st.scheduled
                agg.unschedulable += st.unschedulable
                agg.bind_errors += st.bind_errors
                agg.aborted += st.aborted
                agg.requeued += st.requeued
                agg.shed += st.shed
                agg.micro += st.micro
                agg.assignments.update(st.assignments)
                agg.failed_keys.extend(st.failed_keys)
        return out

    def tick(self, now: Optional[float] = None) -> FleetTickStats:
        now = self.clock() if now is None else now
        t0 = time.perf_counter()
        tick = FleetTickStats()
        tlist = list(self.tenants.values())
        if not tlist:
            return tick
        for t in tlist:
            tick.per_tenant[t.name] = CycleStats()
        span = self.telemetry.wave_span("fleet-tick")
        if self.micro_pass(now, tick=tick):
            span.mark("micro")
        if self.watch_plane is not None:
            # staleness export first (a dead stream's tick records HOW stale
            # it served), then the dead-stream revive
            tick.staleness_seconds = self.watch_plane.maintain()

        # ---- pump + storm seam + governed pop, each under its tenant's
        # ingest lock ---- #
        batches: Dict[str, List] = {}
        for t in tlist:
            with t.ingest_mu:
                batches[t.name] = self._pop_tenant(t, tick, now)
        span.mark("pump")

        from ..sched.supervisor import DispatchAbandonedError

        # batches are popped: from here to the dispatch result, EVERY
        # failure path must hand them back to their queues
        try:
            out, snaps = self._dispatch_tick(tlist, batches, tick, now,
                                             span)
        except DispatchAbandonedError:
            # an abandoned worker may still read the resident stacked
            # tensors — never patch them again; the next healthy tick
            # restacks. Earlier engine groups' uncommitted results are
            # discarded with the requeue.
            self._invalidate_stacks()
            self._requeue_batches(tlist, batches, tick, now)
            span.mark("requeue")
            tick.tick_seconds = time.perf_counter() - t0
            self._finish_tick(tick, span)
            return tick
        except Exception:
            # any other post-pop failure: requeue everything, drop the
            # possibly half-patched stacks, and re-raise for visibility
            self._invalidate_stacks()
            self._requeue_batches(tlist, batches, tick, now)
            span.mark("requeue")
            tick.tick_seconds = time.perf_counter() - t0
            self._finish_tick(tick, span)
            raise

        self._commit_tick(out, batches, snaps, tick, now)
        span.mark("bind-commit")
        tick.tick_seconds = time.perf_counter() - t0
        # per-tenant governor feedback: the shared tick's wall time is every
        # tenant's deadline signal
        for t in tlist:
            if t.sched.governor is not None:
                t.sched.governor.end_wave(
                    now, tick.per_tenant[t.name].attempted,
                    tick.tick_seconds)
        self._finish_tick(tick, span)
        return tick

    def _pop_tenant(self, t: FleetTenant, tick: FleetTickStats,
                    now: float) -> List:
        """One tenant's pump, storm seam, overload-governor gate and batch
        pop (the caller holds its ingest lock)."""
        s = t.sched
        st = tick.per_tenant[t.name]
        s.queue.pump(now)
        s.cache.cleanup(now)
        if faultline.should("tenant.storm", t.name):
            # injected per-tenant watch storm: the tenant's resident encoding
            # is no longer trusted (full re-encode next tick) and this tick
            # admits nothing for it — purely ITS degradation
            t.storm_ticks += 1
            st.degraded += 1
            self.telemetry.note_supervisor_event("storm", t.name)
            s.cache.invalidate_snapshot()
            return []
        # per-TENANT overload governor (sched/overload.py): one tenant's
        # storm sheds/pauses only that tenant
        gov = s.governor
        decision = None
        pop_limit = self.batch_size
        if gov is not None:
            decision = gov.begin_wave(now, s.queue.depths())
            if decision.release_deferred:
                released = s.queue.release_deferred(now)
                if released:
                    self.telemetry.note_supervisor_event(
                        "deferred_release",
                        f"{t.name}: {released} pods re-admitted")
            if not decision.dispatch_allowed:
                st.commit_paused += 1
                return []
            if decision.wave_limit:
                pop_limit = min(pop_limit, decision.wave_limit)
        batch = s.queue.pop_batch(pop_limit, now=now)
        if decision is not None and decision.shed_below is not None \
                and batch:
            kept = []
            shed_n = 0
            for pod, attempts in batch:
                if pod.priority < decision.shed_below \
                        and s.queue.park_deferred(pod, attempts, now=now):
                    shed_n += 1
                else:
                    kept.append((pod, attempts))
            batch = kept
            if shed_n:
                st.shed += shed_n
                gov.note_shed(shed_n)
        # += : a micro_pass admission above already counted here
        st.attempted += len(batch)
        return batch

    @staticmethod
    def _pad_quota(tlist, width: int) -> List[float]:
        """Pad tenants carry quota 0.0: with zero capacity their share and
        demand are zero, so they can neither admit nor flag."""
        return [t.quota for t in tlist] + [0.0] * (width - len(tlist))

    @staticmethod
    def _requeue_batches(tlist, batches, tick, now) -> None:
        """Hand every still-unconsumed popped batch back to its tenant's
        queue (prompt retry, no failure verdict)."""
        for t in tlist:
            with t.ingest_mu:
                st = tick.per_tenant[t.name]
                for pod, attempts in batches[t.name]:
                    st.aborted += 1
                    st.requeued += 1
                    t.sched.queue.add_prompt_retry(pod, attempts=attempts,
                                                   now=now)

    def _run_solo(self, t: FleetTenant, batches, tick, now) -> None:
        """A gang- or nodeName-bearing tenant batch runs as the tenant's own
        single-cluster wave (one extra dispatch): group-atomic admission
        needs host rejection rounds, and a pinned pod in the shared
        dispatch would take every tenant to the sequential scan. Held under
        the tenant's ingest lock, as SchedulerServer holds its lock across
        a wave."""
        s = t.sched
        for pod, attempts in batches[t.name]:
            # attempts-1: the fleet pop and the solo wave's own pop are ONE
            # real attempt
            s.queue.add_prompt_retry(pod, attempts=attempts - 1, now=now)
        solo = s.schedule_pending(now)
        st = tick.per_tenant[t.name]
        st.scheduled += solo.scheduled
        st.unschedulable += solo.unschedulable
        st.bind_errors += solo.bind_errors
        st.aborted += solo.aborted
        st.requeued += solo.requeued
        st.failed_keys.extend(solo.failed_keys)
        st.assignments.update(solo.assignments)
        tick.dispatches += 1
        batches[t.name] = []

    def _dispatch_tick(self, tlist, batches, tick, now, span):
        """Everything between the batch pop and the device results: the
        snapshot convergence round, solo routing, per-engine-group resident
        stack refresh and ONE fleet dispatch per engine group. Raises
        propagate to tick()'s requeue guard — this method never loses a
        popped pod."""
        # adopt a dropped or reformed mesh BEFORE snapshotting: the bucket's
        # node-shard divisibility and the stacks' placement follow it
        self._sync_mesh()
        snaps, keys = self._snapshot_round(tlist, batches)
        span.mark("snapshot")

        solo_ran = False
        for t in tlist:
            with t.ingest_mu:
                needs_solo = (snaps[t.name].gang is not None
                              or snaps[t.name].dims.has_node_name)
                if not needs_solo or not batches[t.name]:
                    continue
                self._run_solo(t, batches, tick, now)
                solo_ran = True
        if solo_ran:
            # the solo waves consumed those batches, mutated their tenants'
            # caches, and may have grown the fleet bucket — re-snapshot
            # EVERY tenant so the whole stack agrees on the converged bucket
            snaps, keys = self._snapshot_round(tlist, batches)
            span.mark("solo")

        # ---- per-tenant engine grouping ---- #
        groups: Dict[str, List] = {}
        for t in tlist:
            groups.setdefault(self._engine_for(t.name), []).append(t)
        order = {e: i for i, e in enumerate(self.ENGINES)}
        group_items = sorted(groups.items(),
                             key=lambda kv: order.get(kv[0], len(order)))
        tick.engine_groups = len(group_items)

        d = self._fleet_dims
        if self.supervisor.healthy:
            epoch = self._supervisor_epoch()
            if epoch != self._super_epoch:
                # the primary hung/failed or the backend was re-admitted
                # since the stacks' last refresh: restack fresh instead of
                # patching tensors an abandoned worker may still read
                self._invalidate_stacks()
                self._super_epoch = epoch

        results: List[Tuple] = []
        for engine, gts in group_items:
            results.append(self._dispatch_group(
                engine, gts, batches, snaps, keys, d, tick, span))
        return results, snaps

    def _dispatch_group(self, engine, gts, batches, snaps, keys, d, tick,
                        span):
        """One engine group's dispatch: refresh ITS resident stack, pad ITS
        quota vector, sign under ITS fleet key, submit and read back.
        Returns (gts, out, exp) for _commit_tick."""
        from ..sched.cycle import _resolve_rc

        rc = 0
        if engine == "runs":
            for t in gts:
                sn = snaps[t.name]
                rc = max(rc, _resolve_rc(sn.pending, sn.runs))
                if sn.runs is not None:
                    tick.per_tenant[t.name].class_runs = sn.runs.n_runs

        stack = self._stack_for(engine)
        if self.supervisor.healthy:
            Kp = stack.refresh([snaps[t.name] for t in gts],
                               [keys[t.name] for t in gts], d)
        else:
            # degraded: the resident tensors live on the lost backend. Drop
            # the stack (restack on re-admission) and let the fallback
            # re-encode from host staging
            stack.invalidate()
            Kp = stack.padded_k(len(gts))
        span.mark("stack-refresh")

        fsig = fleet_signature(Kp)
        mesh = stack.mesh
        self.prewarmer.observe(
            d, n_nodes=max(t.sched.cache.node_count for t in gts),
            n_existing=max(t.sched.cache.pod_count for t in gts),
            engine=engine, rc=rc, fleet=fsig, mesh=mesh)
        self.prewarmer.ensure_warm(d, engine, rc=rc, fleet=fsig, mesh=mesh)
        self.supervisor.note_cycle_signature(d, engine, (), False, rc=rc,
                                             fleet=fsig)
        span.mark("prewarm")

        # decision provenance: one flag for the whole group; attribution
        # fans back out per tenant in _commit_group
        explain_on = any(t.sched.explainer is not None for t in gts)
        quota_host = self._pad_quota(gts, Kp)

        def _run(tables, pending, keys_host, existing, dev):
            quota = torch.tensor(quota_host, dtype=torch.float32, device=dev)
            out = dispatch_fleet(tables, pending, keys_host, d.D, existing,
                                 engine, quota, rc=rc, explain=explain_on)
            res, exp = out if explain_on else (out, None)
            res = FleetResult(*(a.cpu().numpy() for a in res))
            if exp is not None:
                exp = [type(e)(*(a.cpu().numpy() for a in e)) for e in exp]
            return res, exp

        def _primary():
            if stack.block is None:
                # the stack was invalidated after the health check above (a
                # re-admission flipped health in between): restack from
                # THIS tick's snapshots
                stack.refresh([snaps[t.name] for t in gts],
                              [keys[t.name] for t in gts], d)
            cuda = self.device.type == "cuda"
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            stack.mark_dispatch_start()
            try:
                res = _run(stack.tables, stack.pending, stack.keys_host,
                           stack.existing, self.device)
            finally:
                stack.mark_dispatch_done()
            if cuda:
                ev[1].record()
                ev[1].synchronize()
                tick.execute_seconds += ev[0].elapsed_time(ev[1]) / 1e3
            return res

        def _fallback(dev, hung=False):
            # degraded fleet tick: re-encode this group's tenants onto the
            # fallback device from host staging and dispatch the stack
            # there — no resident tensor of the lost backend is touched
            from ..sched.cycle import snapshot_with_keys
            from .tables import empty_tenant_block, stack_blocks

            blocks, keys_host = [], []
            for t in gts:
                sn, ky = snapshot_with_keys(
                    t.sched.cache, t.sched.encoder,
                    [p for p, _ in batches[t.name]], self._fleet_dims,
                    device=dev)
                snaps[t.name] = sn
                keys_host.append(ky)
                blocks.append((sn.tables, sn.pending, sn.existing))
            if Kp > len(blocks):
                blocks.extend([empty_tenant_block(d, dev)]
                              * (Kp - len(blocks)))
                keys_host.extend([(0, 0)] * (Kp - len(keys_host)))
            tb, pe, ex = stack_blocks(blocks)
            return _run(tb, pe, keys_host, ex, dev)

        from ..parallel.mesh import mesh_key

        handle = self.supervisor.submit(
            "cycle", (replace(d, has_node_name=False), engine, (), False,
                      rc, fsig, mesh_key(mesh)),
            _primary, _fallback)
        span.mark("dispatch")
        out, exp = handle.result()
        span.mark("readback")
        tick.dispatches += 1
        return (gts, out, exp)

    def _commit_tick(self, results, batches, snaps, tick, now) -> None:
        """The per-tenant commit loops: intent write → assume → fenced bind
        → retire, through each tenant's own Scheduler, plus the DRF
        violation check over each dispatch's own outputs."""
        for gts, out, exp in results:
            self._commit_group(gts, out, exp, batches, snaps, tick, now)

    def _commit_group(self, tlist, out, exp, batches, snaps, tick,
                      now) -> None:
        node, admitted, share, dom = out.node, out.admitted, out.share, \
            out.dom
        # the DRF invariant, checked through the same helper the quota tests
        # golden, as host arithmetic on the fetched outputs (pad tenants
        # have zero admitted demand and can never flag)
        viol = violation_headroom(
            share, dom, admitted,
            np.asarray(self._pad_quota(tlist, int(share.shape[0])),
                       np.float32), xp=np)
        tick.drf_violations += int(viol[:len(tlist)].sum())
        for k, t in enumerate(tlist):
            with t.ingest_mu:  # commit phase vs this tenant's route threads
                self._commit_tenant(k, t, node, admitted, exp, batches,
                                    snaps, tick, now)

    def _commit_tenant(self, k, t, node, admitted, exp, batches, snaps,
                       tick, now) -> None:
        s = t.sched
        st = tick.per_tenant[t.name]
        order = snaps[t.name].node_order
        cycle = s.queue.current_cycle()
        batch = batches[t.name]
        # per-TENANT decision provenance: tenant k's attribution feeds ITS
        # explainer; quota-clamped pods (admitted=False) carry no verdict
        # this tick and are left out
        if exp is not None and s.explainer is not None and batch:
            idx = [i for i in range(len(batch)) if admitted[k, i]]
            if idx:
                sl = type(exp[k])(*(a[idx] for a in exp[k]))
                try:
                    rec = s.explainer.observe_wave(
                        [batch[i] for i in idx], node[k][idx], sl, order,
                        now=now)
                except Exception:  # noqa: BLE001 - provenance must never
                    rec = None     # take down a tick
                if rec:
                    self.telemetry.note_supervisor_event(
                        "explain", f"{t.name}: "
                        f"{rec.get('unschedulable', 0)} attributed")
        commits: List[Tuple] = []
        failures: List[Tuple] = []
        for i, (pod, attempts) in enumerate(batch):
            if not admitted[k, i]:
                # quota-clamped, not unschedulable: the tenant's headroom
                # wasn't there — defer promptly. The count rides CycleStats
                # into the tenant-labelled DRF_CLAMPED series.
                st.requeued += 1
                st.drf_clamped += 1
                tick.drf_clamped += 1
                s.queue.add_prompt_retry(pod, attempts=attempts, now=now)
                continue
            ni = int(node[k, i])
            if ni < 0:
                failures.append((pod, attempts))
                continue
            if s.cache.get_pod(pod.key) is not None:
                continue  # skipPodSchedule (stale queue entry)
            if ni >= len(order) or not order[ni]:
                # a placement onto a node row outside this tenant's own
                # cluster — the inert-row contract broke
                tick.cross_tenant_placements += 1
                failures.append((pod, attempts))
                continue
            commits.append((pod, order[ni], attempts))
        try:
            intent = s._write_intent(cycle, commits)
        except Exception:  # noqa: BLE001 - ledger storage unavailable
            for pod, _node, attempts in commits:
                st.aborted += 1
                st.requeued += 1
                s.queue.add_prompt_retry(pod, attempts=attempts, now=now)
            commits = []
            intent = None
        bound_keys: List[str] = []
        for ci, (pod, node_name, attempts) in enumerate(commits):
            if s.governor is not None and not s.governor.commit_allowed():
                # this tenant's breaker opened mid-commit: its remaining
                # commits requeue promptly (per-tenant breakers)
                for pod2, _n2, attempts2 in commits[ci:]:
                    st.requeued += 1
                    s.queue.add_prompt_retry(pod2, attempts=attempts2,
                                             now=now)
                break
            s._commit(pod, node_name, attempts, now, cycle, st,
                      latency_keys=bound_keys)
        if bound_keys:
            s.telemetry.record_bound_many(bound_keys, s.clock())
        s._retire_intent(intent)
        for pod, attempts in failures:
            st.unschedulable += 1
            st.failed_keys.append(pod.key)
            s.queue.add_unschedulable(pod, attempts, now, cycle=cycle)

    def _finish_tick(self, tick: FleetTickStats, span=None) -> None:
        from ..sched.metrics import observe_fleet_tick

        self.ticks += 1
        self.total_drf_violations += tick.drf_violations
        self.total_cross_tenant += tick.cross_tenant_placements
        self.total_drf_clamped += tick.drf_clamped
        self.max_dispatches_per_tick = max(self.max_dispatches_per_tick,
                                           tick.dispatches)
        self.max_engine_groups = max(self.max_engine_groups,
                                     tick.engine_groups)
        # per-tenant attribution through CycleStats into the
        # tenant-labelled metrics
        observe_fleet_tick(tick.per_tenant)
        if span is not None:
            self.telemetry.finish_wave(
                span, engine="fleet", dims=self._fleet_dims,
                fleet={name: {"attempted": st.attempted,
                              "scheduled": st.scheduled,
                              "requeued": st.requeued,
                              "degraded": st.degraded,
                              "drf_clamped": st.drf_clamped,
                              "shed": st.shed,
                              "aborted": st.aborted}
                       for name, st in tick.per_tenant.items()},
                extra={"dispatches": tick.dispatches,
                       "engine_groups": tick.engine_groups,
                       "drf_violations": tick.drf_violations,
                       "cross_tenant_placements":
                           tick.cross_tenant_placements})

    def run_until_idle(self, max_ticks: int = 64,
                       stall_ticks: int = 2) -> FleetTickStats:
        """Tick until every tenant's active queue drains, or nothing has
        scheduled for `stall_ticks` consecutive ticks (a quota-clamped
        tenant's deferred pods requeue promptly, so its active queue never
        empties — headroom, not the scheduler, is what it waits on)."""
        total = FleetTickStats()
        for t in self.tenants.values():
            total.per_tenant[t.name] = CycleStats()
        stalled = 0
        for _ in range(max_ticks):
            tk = self.tick()
            stalled = stalled + 1 if tk.scheduled == 0 else 0
            total.dispatches += tk.dispatches
            total.engine_groups = max(total.engine_groups, tk.engine_groups)
            total.drf_violations += tk.drf_violations
            total.drf_clamped += tk.drf_clamped
            total.cross_tenant_placements += tk.cross_tenant_placements
            total.tick_seconds += tk.tick_seconds
            total.execute_seconds += tk.execute_seconds
            for name, st in tk.per_tenant.items():
                agg = total.per_tenant[name]
                agg.attempted += st.attempted
                agg.scheduled += st.scheduled
                agg.unschedulable += st.unschedulable
                agg.bind_errors += st.bind_errors
                agg.aborted += st.aborted
                agg.requeued += st.requeued
                agg.degraded += st.degraded
                agg.drf_clamped += st.drf_clamped
                agg.assignments.update(st.assignments)
            if all(t.sched.queue.lengths()[0] == 0
                   for t in self.tenants.values()):
                break
            if stalled >= stall_ticks:
                break
        return total
