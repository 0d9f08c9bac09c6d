"""The stateful, watch-driven scheduler: cache + queue + batched device cycle
(port of the JAX package's sched/scheduler.py, serving path).

The analog of the reference's Scheduler struct and its wiring
(pkg/scheduler/scheduler.go:79-122, eventhandlers.go:335-441), with the
per-pod scheduleOne loop (scheduler.go:596-763) replaced by a per-*wave*
batched cycle: pop up to `batch_size` pods, snapshot the resident cache
(state/cache.py: full, patch or cached), run one cycle on the device
(sched/cycle.py schedule_batch: the wave engine with the K1/K2 kernels, or
the engine KTPU_ASSIGN names), read the placements back, then assume and
bind.

Event handlers mirror eventhandlers.go:
  * assigned-pod add/update/delete      → cache            (:360-362)
  * unassigned-pod add/update/delete    → queue            (:367-385, filtered
    by `responsible_for` — the schedulerName check, :277-282)
  * node add/update/delete              → cache + queue.move_all_to_active
                                                           (:392-396)
Failures feed the backoff/unschedulable queues exactly as FitError handling
does (scheduler.go:436-448); bind errors roll back via cache.forget_pod
(scheduler.go:717,732).

Pods that fail a wave may preempt (sched/preemption.py, when a `preemptor`
is given): after the wave's commits, one fresh snapshot and one burst of
what-ifs for every failed priority pod that is not gang-grouped. A batch
with gang-grouped pods runs the gang engine (ops/gang.py); pods of rejected
groups take the ordinary unschedulable path.

Decision provenance (sched/explain.py; KTPU_EXPLAIN or `enable_explain`)
runs the attribution reduction in each wave's dispatch and renders it into
metrics, events and the why-pending map.

Every wave's dispatch runs under the dispatch supervisor
(sched/supervisor.py): on a watchdog worker thread, on the scheduler's
device and dispatch stream, while the serving thread interns the next
wave's backlog; a hung or failed dispatch is abandoned and its whole batch
requeued, or — only when the operator configured `fallback_device`, and
never once the card is lost — re-run on the CPU. The bucket prewarmer
(sched/prewarm.py), when asked for (`prewarm=True`), warms the next
capacity bucket in the background; it is off by default because on the
card its throwaway warm dispatch slowed the serving loop and bought nothing
at a new bucket (chip_smoke.py phase 9c). Telemetry (sched/telemetry.py,
on unless KTPU_TELEMETRY=0) records each wave's phase spans, device split
and watch→bind latency.

With a bind-intent ledger (sched/ledger.py) each wave's placements go
durable before the first Binding write and are retired after the last;
`recover()` replays what a crashed incarnation left, and `warm_standby()`
keeps a non-leading incarnation's snapshot and warm state hot.

A scheduling framework (framework/) configures the device cycle — the
caller sets `engine_config` and `hard_pod_affinity_weight` from its
KubeSchedulerConfiguration (sched/config.py), and score plugins outside
the engine's fixed set fold in as a per-class bias — and guards the commit
path: assume → Reserve → Permit (the waiting map, Coscheduling) → PreBind
→ Bind → PostBind, with Unreserve on rollback. Pods an extender
(extender/client.py HTTPExtender) is interested in take a per-pod path
after the wave: one score dispatch, then each extender's Filter and
Prioritize over HTTP, then the commit (or the extender's Bind).

Mesh serving is not ported yet and is refused with NotImplementedError
naming its ROADMAP item (A13).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Protocol, Sequence, Tuple

import torch

from ..api.semantics import pod_fits_resources
from ..api.types import DEFAULT_SCHEDULER_NAME, Node, Pod, Resources
from ..state.arrays import resolve_device, to_device
from ..state.cache import SchedulerCache
from ..state.dims import Dims, bucket
from ..state.encode import Encoder
from ..utils import faultline
from .cycle import (UNSCHEDULABLE_TAINT_KEY, _engine,
                    micro_snapshot_with_keys, schedule_batch,
                    snapshot_with_keys)
from .explain import build_explainer
from .overload import build_governor
from .prewarm import BucketPrewarmer
from .queue import PriorityQueue
from .supervisor import DispatchAbandonedError, DispatchSupervisor
from .telemetry import SchedulerTelemetry


class Binder(Protocol):
    """The Binding write (scheduler.go:565 b.Client.CoreV1().Pods(...).Bind).
    Returns True on success; False/raise → rollback via ForgetPod."""

    def bind(self, pod: Pod, node_name: str) -> bool: ...


class RecordingBinder:
    """Test binder in the spirit of the fake clientset: records bindings and
    optionally fails selected pods."""

    def __init__(self, fail_keys: Sequence[str] = ()) -> None:
        self.bound: List[Tuple[str, str]] = []
        self.fail_keys = set(fail_keys)

    def bind(self, pod: Pod, node_name: str) -> bool:
        if pod.key in self.fail_keys:
            return False
        self.bound.append((pod.key, node_name))
        return True


@dataclass
class CycleStats:
    """Per-wave outcome; feeds the scheduling metrics
    (metrics/metrics.go:32-99). The JAX package's fields."""

    attempted: int = 0
    scheduled: int = 0
    unschedulable: int = 0
    bind_errors: int = 0
    # pods whose wave dispatch was abandoned (no fallback, or it failed
    # too): requeued promptly with attempts preserved — not failures of the
    # pods
    aborted: int = 0
    # run-collapsed engine telemetry (ops/runs.py, KTPU_ASSIGN=runs): how
    # many class runs the queue-ordered wave factored into, and the
    # scan-step reduction P_valid/runs the collapse bought this wave
    class_runs: int = 0
    collapse_ratio: float = 0.0
    # fleet-tick telemetry (fleet/server.py, per TENANT per tick): pods
    # sent back to the queue without a failure verdict this tick (DRF
    # quota clamp, storm requeue, abort, the rest of a wave whose commit
    # breaker opened mid-wave — they retry promptly, unlike
    # `unschedulable`), and whether this tenant's tick was degraded (its
    # injected watch storm forced a full re-encode + requeue). The chaos
    # tests assert tenant ISOLATION from these counters instead of scraping
    # logs.
    requeued: int = 0
    degraded: int = 0
    # overload governor (sched/overload.py): pods parked in the deferred
    # lane this wave (SHED_LOW — deferred, never dropped), and whether the
    # wave was paused outright by the open commit breaker (no pop, no
    # device time)
    shed: int = 0
    commit_paused: int = 0
    # 1 when this wave was a micro-wave — a small fresh-delta batch grafted
    # onto the resident snapshot between bulk cycles
    micro: int = 0
    # pods deferred by the DRF quota pre-mask this tick (fleet/server.py; a
    # subset of `requeued`) — routed through sched/metrics.py
    # observe_fleet_tick into the tenant-labelled DRF_CLAMPED counter
    drf_clamped: int = 0
    cycle_seconds: float = 0.0
    assignments: Dict[str, str] = field(default_factory=dict)
    # pod keys that failed this wave (feeds FailedScheduling events)
    failed_keys: List[str] = field(default_factory=list)


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet — ROADMAP {item}")


def _make_mesh_state(mesh):
    """The serving mesh from the `mesh` argument or KTPU_MESH (the JAX
    package's `_make_mesh_state`): a MeshState as given; a Mesh adopted as
    the live mesh, its devices the pool; an int n > 1 or "auto" a MeshState
    over the CUDA devices (n of them, or all), which raises when there are
    fewer; unset, "0", "off", 1 or an unparseable KTPU_MESH serve on one
    device."""
    from ..parallel.mesh import Mesh, MeshState, make_mesh

    if mesh is None:
        env = os.environ.get("KTPU_MESH", "")
        if not env or env in ("0", "off"):
            return None
        mesh = env
    if isinstance(mesh, MeshState):
        return mesh
    if isinstance(mesh, Mesh):
        ms = MeshState(mesh.size, devices=mesh.devices)
        ms.mesh = mesh
        return ms
    if isinstance(mesh, str):
        if mesh == "auto":
            ms = MeshState(None)
            return ms if ms.mesh is not None else None
        try:
            mesh = int(mesh)
        except ValueError:
            return None
    if isinstance(mesh, int):
        if mesh <= 1:
            return None
        make_mesh(mesh)  # raises, with the virtual-mesh hint, when short
        return MeshState(mesh)
    raise TypeError(f"mesh: {mesh!r} is not an int, 'auto', a Mesh or a "
                    "MeshState")


class Scheduler:
    """Single-profile scheduler. `schedule_pending` is the wave analog of
    scheduleOne; call it from a loop (or `run_until_idle`).

    Runs on the CUDA device unless `device="cpu"` is asked for; with no
    usable GPU and no explicit CPU device it raises, never moving to the CPU
    on its own. `fallback_device` names where a timed-out or failed
    dispatch re-runs; unset, or once a kernel launch failed or the CUDA
    context died, a failed wave is abandoned and requeued. `prewarm=True`
    turns the bucket prewarmer on.

    `mesh` (an int, "auto", a parallel/mesh.py Mesh or MeshState; else
    KTPU_MESH) shards the node axis: the cache keeps the node planes
    resident per shard and each wave runs sharded (sched/cycle.py); a
    backend loss drops the mesh until the supervisor re-forms it."""

    def __init__(
        self,
        binder: Binder,
        cache: Optional[SchedulerCache] = None,
        queue: Optional[PriorityQueue] = None,
        scheduler_name: str = DEFAULT_SCHEDULER_NAME,
        batch_size: int = 4096,
        base_dims: Optional[Dims] = None,
        clock: Callable[[], float] = time.monotonic,
        preemptor: Optional[object] = None,
        extenders: Sequence[object] = (),
        framework: Optional[object] = None,
        mesh: object = None,
        ledger: Optional[object] = None,
        fence_source: Optional[Callable[[], int]] = None,
        microwave: Optional[bool] = None,
        device="cuda",
        fallback_device=None,
        prewarm: bool = False,
    ) -> None:
        self.device = resolve_device(device)
        self.mesh_state = _make_mesh_state(mesh)
        self.binder = binder
        # exactly-once binding across crash/restart (sched/ledger.py): with
        # a BindIntentLedger every wave's placements are durably recorded
        # BEFORE the first Binding write and retired after the last — a
        # crash anywhere in between is recoverable via `recover()`
        self.ledger = ledger
        # fencing token source (the lease generation), stamped into every
        # intent record; None = token 0
        self.fence_source = fence_source
        self.preemptor = preemptor
        self.cache = cache or SchedulerCache()
        self.queue = queue or PriorityQueue()
        self.scheduler_name = scheduler_name
        self.batch_size = batch_size
        self.base_dims = base_dims
        self.clock = clock
        self.encoder = Encoder()
        # HTTPExtender list (generic_scheduler.go:547-574,834-869). When any
        # extender is configured, pods it is interested in take the per-pod
        # path (`_schedule_one_with_extenders`) — the extender protocol is
        # per-pod HTTP anyway, so the reference's own round-trip cost applies
        self.extenders = list(extenders)
        # framework host lifecycle points (Reserve/Permit/PreBind/Bind/
        # PostBind/Unreserve) guard the commit path (scheduler.go:660-762);
        # None keeps the plain path
        self.framework = framework
        # hardPodAffinitySymmetricWeight (apis/config/types.go:70) and the
        # engines' plugin composition (ops/lattice.py EngineConfig; None =
        # the default provider's), both set from a KubeSchedulerConfiguration
        # by the caller
        self.hard_pod_affinity_weight = 1.0
        self.engine_config = None
        # configured score plugins outside the engine's fixed set reach the
        # dispatch as a static per-class bias (framework/plugins.py
        # extra_score_plugins)
        from ..framework.plugins import extra_score_plugins

        self._extra_score = extra_score_plugins(framework)
        # gang mechanism selection: the device gang engine (ops/gang.py)
        # owns pod groups UNLESS the Coscheduling Permit plugin is enabled —
        # then the host waiting-map path does (one mechanism per config;
        # both holding the same group would double-gate it). The plugin is
        # wired here: releases complete through complete_waiting, and quorum
        # counts come from the cache's group accounting.
        self._device_gangs = True
        if framework is not None:
            for p in getattr(framework, "permit_plugins", ()):
                if getattr(p, "name", "") == "Coscheduling":
                    self._device_gangs = False
                    if getattr(p, "on_release", None) is None:
                        p.on_release = self.complete_waiting
                    if getattr(p, "bound_count", None) is None:
                        p.bound_count = self.cache.group_bound_count
        # key → (attempts, CycleState, node_name, original pod, binder_ext)
        self._waiting_meta: Dict[str, Tuple] = {}
        self.waiting_bind_errors = 0  # bind failures on the waiting-release path
        # warm-ahead on capacity growth (sched/prewarm.py): the next Dims
        # bucket warms in the background before occupancy crosses it. Off
        # unless asked for: each warm is a whole eager cycle in a second
        # thread, which competes with the serving thread for the
        # interpreter and the card
        self.prewarmer = BucketPrewarmer(device=self.device)
        self.prewarmer.enabled = prewarm
        # the stream every supervised dispatch runs on: the device's default
        # stream, which the snapshot's tensors were written on
        self.dispatch_stream = (torch.cuda.default_stream(self.device)
                                if self.device.type == "cuda" else None)
        # every device call of the serving loop runs under the dispatch
        # supervisor: deadline watchdog, opt-in fallback, prober
        # re-admission (sched/supervisor.py)
        self.supervisor = DispatchSupervisor(
            self.device, prewarmer=self.prewarmer,
            stream=self.dispatch_stream, fallback_device=fallback_device,
            mesh_state=self.mesh_state)
        self.prewarmer.supervisor = self.supervisor
        # observability (sched/telemetry.py): watch→bind latency (stamps in
        # THIS scheduler's clock domain via the queue's tracker hook), wave
        # phase spans + flight recorder, the supervisor's event narration.
        # KTPU_TELEMETRY=0 disables all of it.
        self.telemetry = SchedulerTelemetry(name=scheduler_name)
        if self.telemetry.enabled:
            self.queue.tracker = self.telemetry.tracker
        self.supervisor.event_sink = self.telemetry.note_supervisor_event
        # decision provenance (sched/explain.py): with KTPU_EXPLAIN on (or
        # enable_explain()), every wave's dispatch also runs the
        # attribution reduction and this explainer renders it; None keeps
        # the dispatch without it
        self.explainer = build_explainer(name=scheduler_name,
                                         clock=self.clock)
        # overload governor (sched/overload.py): brownout modes,
        # priority-aware shedding into the queue's deferred lane, adaptive
        # wave sizing, and the commit-path circuit breaker. None when
        # KTPU_OVERLOAD=0.
        self.governor = build_governor(
            batch_size, clock=self.clock,
            event_sink=self.telemetry.note_supervisor_event,
            name=scheduler_name)
        # streaming micro-waves: when the live backlog is nothing but a
        # handful of FRESH watch deltas, admit them through a small
        # fixed-capacity wave grafted onto the resident snapshot
        # (state/cache.py micro_graft) instead of parking them until a bulk
        # cycle pops. Opt-in: KTPU_MICROWAVE=1 (or the ctor flag).
        if microwave is None:
            microwave = os.environ.get(
                "KTPU_MICROWAVE", "") not in ("", "0", "off")
        self.microwave = bool(microwave)
        # lane capacity: a fresh backlog deeper than this is bulk work;
        # clamped to the configured batch
        self.micro_max_batch = min(
            int(os.environ.get("KTPU_MICRO_MAX_BATCH", "128")),
            max(int(batch_size), 1))
        # coalesce window: hold a not-yet-full lane this long so
        # near-simultaneous deltas share one dispatch (0 admits at once)
        self.micro_coalesce_s = float(
            os.environ.get("KTPU_MICRO_COALESCE_S", "0"))
        # every micro wave encodes at ONE fixed pending capacity
        self._micro_p = bucket(self.micro_max_batch)
        self.micro_waves = 0

    def enable_explain(self, sink=None) -> None:
        """Force decision provenance on for this scheduler (the
        KubeSchedulerConfiguration `decisionProvenance: true` path)."""
        if self.explainer is None:
            self.explainer = build_explainer(
                name=self.scheduler_name, clock=self.clock, enabled=True,
                sink=sink)
        elif sink is not None and self.explainer.sink is None:
            self.explainer.sink = sink

    # ------------------------------------------------------------------ #
    # event handlers (eventhandlers.go)
    # ------------------------------------------------------------------ #

    def responsible_for(self, pod: Pod) -> bool:
        """responsibleForPod (eventhandlers.go:282)."""
        return pod.scheduler_name == self.scheduler_name

    def on_pod_add(self, pod: Pod) -> None:
        if pod.node_name:                       # assignedPod (:277)
            if self.cache.is_assumed(pod.key) or self.cache.get_pod(pod.key) is None:
                self.cache.add_pod(pod)
            # a new pod landing may unblock anti-affinity waiters etc.
            self.queue.move_all_to_active(self.clock())
        elif self.responsible_for(pod):
            self.queue.add(pod, now=self.clock())

    def on_pod_update(self, old: Pod, new: Pod) -> None:
        if new.node_name:
            if self.cache.get_pod(new.key) is not None and not self.cache.is_assumed(new.key):
                self.cache.update_pod(new)
            else:
                self.cache.add_pod(new)
            # label changes on bound pods can unblock affinity waiters
            self.queue.move_all_to_active(self.clock())
        elif self.responsible_for(new):
            self.queue.update(new, now=self.clock())

    def on_pod_delete(self, pod: Pod) -> None:
        if pod.node_name:
            if self.cache.get_pod(pod.key) is not None:
                self.cache.remove_pod(pod.key)
            # freed resources may unblock pending pods (eventhandlers.go:222)
            self.queue.move_all_to_active(self.clock())
        else:
            self.queue.delete(pod.key)
            # a pod parked in the Permit waiting map is assumed in the cache;
            # deletion must unwind that state, not leave it to expire into a
            # requeue of a pod that no longer exists
            meta = self._waiting_meta.pop(pod.key, None)
            if meta is not None:
                _, state, node_name, orig, _ = meta
                if self.framework is not None:
                    self.framework.pop_waiting(pod.key)
                    self.framework.run_unreserve_plugins(state, orig,
                                                         node_name)
                if self.cache.is_assumed(pod.key):
                    self.cache.forget_pod(pod.key)

    def on_node_add(self, node: Node) -> None:
        self.cache.add_node(node)
        self.queue.move_all_to_active(self.clock())

    def on_node_update(self, node: Node) -> None:
        self.cache.update_node(node)
        self.queue.move_all_to_active(self.clock())

    def on_node_delete(self, name: str) -> None:
        self.cache.remove_node(name)

    # ------------------------------------------------------------------ #
    # the scheduling wave
    # ------------------------------------------------------------------ #

    def _snapshot_keys(self, pending: List[Pod]):
        # degraded mode routes the snapshot onto the fallback device: host
        # staging is the ground truth, so nothing on this path touches the
        # lost backend's tensors
        return snapshot_with_keys(self.cache, self.encoder, pending,
                                  self.base_dims,
                                  device=self.supervisor.snapshot_device(),
                                  mesh=self.supervisor.snapshot_mesh())

    def _preempt_snapshot(self, pending: List[Pod]):
        """The preemption pass's fresh snapshot: it sees the pods this wave
        assumed, so no preemptor evicts for space the wave consumed."""
        return self.cache.snapshot(
            self.encoder, pending, self.base_dims,
            extra_intern=(UNSCHEDULABLE_TAINT_KEY,),
            device=self.supervisor.snapshot_device(),
            mesh=self.supervisor.snapshot_mesh())

    def _micro_snapshot_keys(self, pending: List[Pod]):
        # sync the resident tables with an EMPTY pending patch, then graft
        # a small fixed-P pending block for just these deltas
        return micro_snapshot_with_keys(
            self.cache, self.encoder, pending, self.base_dims,
            self._micro_p, device=self.supervisor.snapshot_device(),
            mesh=self.supervisor.snapshot_mesh())

    def _micro_mode(self, now: float) -> str:
        """Micro/bulk arbitration, decided once per wave after the
        governor gate: "micro" only when the ENTIRE live backlog is the
        micro lane (fresh, ungrouped, unpinned deltas) and fits one micro
        wave — anything mixed or deep is bulk work. "hold" keeps a
        not-yet-full lane waiting out the coalesce window (never when the
        window is off or the lane is full)."""
        if not self.microwave or self.extenders:
            return "bulk"
        micro_depth, active_depth, oldest = self.queue.micro_stats()
        if micro_depth == 0 or micro_depth != active_depth \
                or micro_depth > self.micro_max_batch:
            return "bulk"
        if self.micro_coalesce_s > 0.0 \
                and micro_depth < self.micro_max_batch \
                and (now - oldest) < self.micro_coalesce_s:
            return "hold"
        return "micro"

    def schedule_micro(self, now: Optional[float] = None) -> CycleStats:
        """At most one micro-wave: admit the fresh-delta lane if (and only
        if) arbitration says "micro"; empty stats otherwise."""
        return self.schedule_pending(now, micro_only=True)

    def schedule_pending(self, now: Optional[float] = None,
                         micro_only: bool = False) -> CycleStats:
        """One wave: pump → pop batch → snapshot → device cycle → commit.

        Sequential assume semantics hold *within* the wave (the engine
        carries the assume state pod to pod) and *across* waves (assumed
        pods are in cache.scheduled_pods() for the next snapshot)."""
        now = self.clock() if now is None else now
        t0 = time.perf_counter()
        # per-wave phase spans (sched/telemetry.py): each mark() closes the
        # phase that just ran
        span = self.telemetry.wave_span()
        ctx: Dict[str, object] = {}
        try:
            return self._run_wave(span, now, t0, ctx, micro_only=micro_only)
        except Exception:
            # a wave that dies mid-flight is the tick the flight recorder
            # exists to explain: record what ran before the raise, dump,
            # re-raise. InjectedCrash (a BaseException — the SIGKILL
            # analog) punches through unrecorded, as a real kill would.
            stats = ctx.get("stats") or CycleStats()
            stats.cycle_seconds = time.perf_counter() - t0
            span.mark("exception")
            self.telemetry.finish_wave(
                span, stats=stats, engine=ctx.get("engine", ""),
                dims=ctx.get("dims"), rc=ctx.get("rc", 0),
                extra={"exception": True})
            if self.telemetry.enabled:
                self.telemetry.dump("exception")
            raise

    def _drain_idle_events(self, span, stats, engine: str = "idle") -> None:
        """Supervisor events (a prewarm failure, a prober recovery, a
        breaker transition) can land while the queue is idle; an idle or
        paused wave drains them into a record instead of leaving them to be
        misattributed to the next busy wave. Event-free idle waves record
        nothing."""
        if self.telemetry.has_pending_events():
            span.mark(engine)
            self.telemetry.finish_wave(span, stats=stats, engine=engine)

    def _run_wave(self, span, now: float, t0: float,
                  ctx: Dict[str, object],
                  micro_only: bool = False) -> CycleStats:
        self.queue.pump(now)
        self.cache.cleanup(now)
        self.expire_waiting(now)
        span.mark("pump")
        # ---- overload governor gate (sched/overload.py): mode ladder,
        # breaker pause, wave-size clamp — decided BEFORE the pop so a
        # paused wave burns no device time and pops nothing it cannot
        # commit (intents are only written downstream of this gate) ---- #
        gov = self.governor
        decision = None
        pop_limit = self.batch_size
        if gov is not None:
            decision = gov.begin_wave(now, self.queue.depths())
            if decision.release_deferred:
                released = self.queue.release_deferred(now)
                if released:
                    self.telemetry.note_supervisor_event(
                        "deferred_release", f"{released} pods re-admitted")
            if not decision.dispatch_allowed:
                stats = CycleStats(commit_paused=1)
                ctx["stats"] = stats
                stats.cycle_seconds = time.perf_counter() - t0
                self._drain_idle_events(span, stats, engine="paused")
                return stats
            if decision.wave_limit:
                pop_limit = min(pop_limit, decision.wave_limit)
        # ---- micro/bulk arbitration: AFTER the governor gate, so a
        # breaker pause dominates and a deferred release lands in the
        # depths the decision reads ---- #
        mode = self._micro_mode(now)
        if mode == "hold" or (micro_only and mode != "micro"):
            # coalesce window open, or a schedule_micro probe with no
            # micro-ready lane: leave the backlog to the bulk cadence
            stats = CycleStats()
            ctx["stats"] = stats
            stats.cycle_seconds = time.perf_counter() - t0
            self._drain_idle_events(
                span, stats, engine="hold" if mode == "hold" else "idle")
            return stats
        micro = mode == "micro"
        if micro:
            batch = self.queue.pop_micro(
                min(pop_limit, self.micro_max_batch), now=now)
        else:
            batch = self.queue.pop_batch(pop_limit, now=now)
        cycle = self.queue.current_cycle()
        span.mark("pop")
        # ---- priority-aware shedding (SHED_LOW/TRICKLE): park sheddable
        # pods in the deferred lane — deferred, never dropped, no failure
        # verdict, no backoff escalation ---- #
        shed_n = 0
        if decision is not None and decision.shed_below is not None and batch:
            kept: List[Tuple[Pod, int]] = []
            for pod, attempts in batch:
                if pod.priority < decision.shed_below \
                        and self.queue.park_deferred(pod, attempts, now=now):
                    shed_n += 1
                else:
                    kept.append((pod, attempts))
            batch = kept
            if shed_n:
                gov.note_shed(shed_n)
        stats = CycleStats(attempted=len(batch), shed=shed_n,
                           micro=1 if micro else 0)
        ctx["stats"] = stats

        # pods an extender is interested in take the per-pod extender path
        # after the batched wave (they must see the wave's assumes)
        ext_batch: List[Tuple[Pod, int]] = []
        if self.extenders:
            ext_keys = {p.key for p, _ in batch
                        if any(e.is_interested(p) for e in self.extenders)}
            ext_batch = [(p, a) for p, a in batch if p.key in ext_keys]
            batch = [(p, a) for p, a in batch if p.key not in ext_keys]

        if not batch and not ext_batch:
            self._drain_idle_events(span, stats)
            return stats
        if not batch:
            for pod, attempts in ext_batch:
                self._schedule_one_with_extenders(pod, attempts, now, cycle,
                                                  stats)
            stats.cycle_seconds = time.perf_counter() - t0
            if gov is not None:
                gov.end_wave(now, stats.attempted, stats.cycle_seconds)
            # an extender-only wave did real work (per-pod dispatches that
            # can degrade or be abandoned): it gets its own record
            span.mark("extenders")
            self.telemetry.finish_wave(span, stats=stats, engine="extenders")
            return stats

        pending = [p for p, _ in batch]
        snap, keys = (self._micro_snapshot_keys(pending) if micro
                      else self._snapshot_keys(pending))
        span.mark("snapshot")
        # the engine from KTPU_ASSIGN; a nodeName-bearing batch reroutes
        # the wave engine to the literal scan (the runs engine keeps it);
        # gang-grouped pods run the gang engine's rounds
        # (sched/cycle.py schedule_batch)
        extras = tuple(p for p, _ in self._extra_score)
        extra_w = tuple(w for _, w in self._extra_score)
        eng = _engine()
        wave_engine = "scan" if (snap.dims.has_node_name
                                 and eng == "waves") else eng
        # the Coscheduling Permit plugin owns pod groups when configured:
        # the wave then runs without the device gang engine
        gang_arrays = snap.gang if self._device_gangs else None
        gang = gang_arrays is not None
        rc = 0
        if wave_engine == "runs" and snap.runs is not None:
            rc = snap.runs.rc
            stats.class_runs = snap.runs.n_runs
            stats.collapse_ratio = round(snap.runs.collapse_ratio, 2)
        ctx.update(engine=wave_engine, dims=snap.dims, rc=rc)
        self.prewarmer.observe(
            snap.dims, n_nodes=self.cache.node_count,
            n_existing=self.cache.pod_count, engine=wave_engine,
            extras=extras, gang=gang, rc=rc, mesh=snap.mesh)
        self.supervisor.note_cycle_signature(snap.dims, wave_engine, extras,
                                             gang, rc=rc)
        if self.microwave and not micro and snap.runs is None:
            # keep the micro signature warm from the bulk cadence: the first
            # delta after a quiet period must not run cold
            self.prewarmer.ensure_warm(
                replace(snap.dims, P=self._micro_p, has_node_name=False),
                eng, extras, False, rc=0, mesh=snap.mesh)
        if self.microwave:
            self.prewarmer.ensure_patch_ladder(self.cache, snap)
        span.mark("prewarm")

        explain_on = self.explainer is not None
        # the commit loop maps node indices through the node_order of the
        # snapshot that was ACTUALLY dispatched: a fallback re-encode
        # reflects newer cluster state
        wave_ctx = {"node_order": snap.node_order}

        def _cycle(tables, pend, exist, dims, gang_t, runs):
            out = schedule_batch(tables, pend, keys, dims.D, exist,
                                 has_node_name=dims.has_node_name,
                                 hard_weight=self.hard_pod_affinity_weight,
                                 ecfg=self.engine_config,
                                 extra_plugins=extras, extra_weights=extra_w,
                                 gang=gang_t, runs=runs,
                                 explain=explain_on)
            return out if explain_on else (out, None)

        def _readback(res, exp):
            node_idx = res.node.cpu().tolist()
            if exp is not None:
                exp = type(exp)(*(t.cpu().numpy() for t in exp))
            return node_idx, exp

        def _primary():
            args = (snap.tables, snap.pending, snap.existing, snap.dims,
                    gang_arrays, snap.runs)
            tel = self.telemetry
            if not tel.enabled:
                return _readback(*_cycle(*args))
            # tier-3 device split (on the watchdog worker): the host time
            # to enqueue the cycle, CUDA events on the dispatch stream
            # around it (read after the readback's own synchronize — no
            # synchronize is added), the copy of the placements
            cuda = self.device.type == "cuda"
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            tp0 = time.perf_counter()
            res, exp = _cycle(*args)
            if cuda:
                ev[1].record()
            tp1 = time.perf_counter()
            out = _readback(res, exp)
            tp2 = time.perf_counter()
            execute = ev[0].elapsed_time(ev[1]) / 1e3 if cuda else 0.0
            tel.note_device_split(tp1 - tp0, execute, tp2 - tp1, token=span)
            return out

        def _fallback(dev, hung=False):
            # the operator's fallback device. Preferred: copy the SAME
            # encoded wave there. A wedged runtime's tensors are untouchable
            # (hung=True: a copy could block forever) and a dead one's
            # raise — then the wave RE-ENCODES onto the fallback from the
            # cache's host staging (snapshot_device() is the fallback now).
            # A mesh wave re-encodes too: the mesh is dropped on the loss
            # and its shards are never read again.
            args = None
            if not hung and snap.mesh is None:
                try:
                    args = (to_device(snap.tables, dev),
                            to_device(snap.pending, dev),
                            to_device(snap.existing, dev), snap.dims,
                            None if gang_arrays is None
                            else to_device(gang_arrays, dev), snap.runs)
                except Exception:  # noqa: BLE001 - dead-source copy
                    args = None
            if args is None:
                fsnap, _fkeys = self._snapshot_keys(pending)
                args = (fsnap.tables, fsnap.pending, fsnap.existing,
                        fsnap.dims,
                        fsnap.gang if self._device_gangs else None,
                        fsnap.runs)
                wave_ctx["node_order"] = fsnap.node_order
            return _readback(*_cycle(*args))

        from ..parallel.mesh import mesh_key

        shape_key = (replace(snap.dims, has_node_name=False), wave_engine,
                     extras, gang, rc)
        if snap.mesh is not None:
            shape_key += (None, mesh_key(snap.mesh))
        # the dispatch worker is about to hold this snapshot's tensors: a
        # snapshot taken before its readback (the mesh prestage below) takes
        # the cache's copy path, never the in-place one. Everything up to
        # the readback sits inside the try, so no path leaks the count.
        self.cache.mark_dispatch_start()
        try:
            wave = self._dispatch_wave(span, now, t0, snap, batch, ext_batch,
                                       stats, wave_engine, rc, micro,
                                       shape_key, _primary, _fallback)
        finally:
            self.cache.mark_dispatch_done()
        if wave is None:
            return stats  # abandoned: every popped pod requeued
        node_idx, wave_exp = wave
        wave_order = wave_ctx["node_order"]

        # ---- decision provenance: render the wave's attribution (events,
        # metrics, the why-pending map); the returned record rides this
        # wave's telemetry record ---- #
        explain_rec = None
        if wave_exp is not None:
            try:
                explain_rec = self.explainer.observe_wave(
                    batch, node_idx, wave_exp, wave_order, now=now)
            except Exception:  # noqa: BLE001 - provenance must never
                explain_rec = None  # take down a wave

        failures: List[Tuple[Pod, int]] = []
        commits: List[Tuple[Pod, str, int]] = []
        for i, (pod, attempts) in enumerate(batch):
            ni = node_idx[i]
            if ni < 0:
                failures.append((pod, attempts))
                continue
            if self.cache.get_pod(pod.key) is not None:
                # skipPodSchedule: a stale queue entry for a pod that is
                # already assumed/bound — do not double-assume
                continue
            commits.append((pod, wave_order[ni], attempts))
        # write-ahead intent: the whole wave's placements go durable in ONE
        # CAS create before the first Binding write; retired after the last.
        # A crash at pre_intent leaves nothing (pods re-deliver as pending),
        # at post_intent an intent recover() completes-or-releases, at
        # post_bind an intent recover() retires against informer truth.
        try:
            intent = self._write_intent(cycle, commits)
        except Exception:  # noqa: BLE001 - ledger storage unavailable
            # no durable intent → no Binding may commit: prompt-requeue the
            # would-be commits, crash-consistently
            for pod, _node, attempts in commits:
                stats.aborted += 1
                self.queue.add_prompt_retry(pod, attempts=attempts, now=now)
            commits = []
            intent = None
        span.mark("intent-write")
        bound_keys: List[str] = []
        for ci, (pod, node_name, attempts) in enumerate(commits):
            if gov is not None and not gov.commit_allowed():
                # the breaker OPENED mid-wave (this wave's own commits
                # tripped it): the rest of the wave requeues promptly, no
                # failure verdict; the intent stays valid and is retired
                # below as usual
                for pod2, _n2, attempts2 in commits[ci:]:
                    stats.requeued += 1
                    self.queue.add_prompt_retry(pod2, attempts=attempts2,
                                                now=now)
                break
            self._commit(pod, node_name, attempts, now, cycle, stats,
                         latency_keys=bound_keys)
        # e2e watch→bind spans close in ONE batched call per wave
        if bound_keys:
            self.telemetry.record_bound_many(bound_keys, self.clock())
        span.mark("bind-commit")
        self._retire_intent(intent)
        span.mark("retire")

        # ---- preemption pass: AFTER commits, against ONE fresh snapshot so
        # the what-if sees pods assumed earlier in this very wave; the whole
        # burst of unschedulable pods is evaluated in bursts of what-ifs
        # (sched/preemption.py preempt_burst) ----
        handled_keys: set = set()
        if failures and self.preemptor is not None:
            # gang pods never preempt individually: evicting victims to place
            # ONE member of an all-or-nothing group would trade running pods
            # for a pod that may never commit
            eligible = [(p, a) for p, a in failures if not p.pod_group]
            if eligible:
                fresh = self._preempt_snapshot([p for p, _ in failures])
                handled_keys = self.preemptor.preempt_burst(
                    self, eligible, fresh, now)
        for pod, attempts in failures:
            if pod.key in handled_keys:
                continue
            stats.unschedulable += 1
            stats.failed_keys.append(pod.key)
            self.queue.add_unschedulable(pod, attempts, now, cycle=cycle)

        for pod, attempts in ext_batch:
            self._schedule_one_with_extenders(pod, attempts, now, cycle, stats)
        span.mark("requeue")
        stats.cycle_seconds = time.perf_counter() - t0
        if gov is not None:
            # micro=True keeps the ingest estimate fed but fences micro
            # timings out of the slow-streak/wave-sizing control loop
            gov.end_wave(now, stats.attempted, stats.cycle_seconds,
                         micro=micro)
        if micro:
            self.micro_waves += 1
            from .metrics import MICRO_WAVES

            MICRO_WAVES.inc(scheduler=self.scheduler_name)
        self.telemetry.finish_wave(
            span, stats=stats, engine=wave_engine, dims=snap.dims, rc=rc,
            micro=micro,
            extra={"explain": explain_rec} if explain_rec else None)
        return stats

    def _dispatch_wave(self, span, now, t0, snap, batch, ext_batch, stats,
                       wave_engine, rc, micro, shape_key, _primary,
                       _fallback):
        """Submit the wave's cycle to the dispatch supervisor, overlap the
        next wave's host work with it, and read it back: (node indices,
        attribution), or None when the dispatch was abandoned and every
        popped pod was requeued."""
        with self.telemetry.device_annotation("cycle"):
            handle = self.supervisor.submit("cycle", shape_key, _primary,
                                            _fallback)

            # ---- host/device overlap: the dispatch runs on the watchdog
            # worker, so while the device evaluates THIS wave the serving
            # thread interns the NEXT wave's backlog — the vocabulary and
            # class ids (tie-breaks in the wave engine) come out in the JAX
            # package's order. A micro wave skips it: interning a bulk
            # backlog would put the bulk cost back on its latency path.
            if self.preemptor is not None:
                from .preemption import PREEMPT_BURST

                # warm the preemption burst at the current dims before the
                # first storm
                self.prewarmer.observe_preempt(snap.dims, PREEMPT_BURST,
                                               mesh=snap.mesh)
            backlog = [] if micro else self.queue.peek_active(self.batch_size)
            if backlog:
                self.encoder.intern_pods(backlog)
                if snap.mesh is not None:
                    # the mesh prestage (the JAX package's double buffer):
                    # scatter the deltas that accrued since the dispatched
                    # snapshot into NEW resident planes (the copy path —
                    # the dispatch holds the current ones) while the device
                    # runs this wave; the post-readback snapshot then ships
                    # only the wave's own assumes, in place. An
                    # optimization: a failure leaves that work to it.
                    try:
                        self._snapshot_keys(backlog)
                    except Exception:  # noqa: BLE001 - never fatal
                        pass
            span.mark("dispatch")
            try:
                out = handle.result()
                span.mark("readback")
            except DispatchAbandonedError:
                span.mark("readback")
                # crash-consistent wave abort: nothing was assumed and
                # nothing may be committed — requeue every popped pod
                # (attempts preserved, prompt retry: the pods are fine, the
                # backend wasn't)
                for pod, attempts in batch + ext_batch:
                    stats.aborted += 1
                    self.queue.add_prompt_retry(pod, attempts=attempts,
                                                now=now)
                span.mark("requeue")
                stats.cycle_seconds = time.perf_counter() - t0
                # the supervisor's "abandoned" event auto-dumps the ring
                self.telemetry.finish_wave(span, stats=stats,
                                           engine=wave_engine,
                                           dims=snap.dims, rc=rc,
                                           micro=micro)
                return None
        return out

    def _schedule_one_with_extenders(
        self, pod: Pod, attempts: int, now: float, cycle: int,
        stats: CycleStats
    ) -> None:
        """Per-pod path with extender round-trips: lattice mask+score →
        extender Filter per extender (generic_scheduler.go:547-574) →
        extender Prioritize rescaled ×weight×(MaxNodeScore/
        MaxExtenderPriority) (:834-869) → selectHost → assume → bind
        (extender Bind if one offers it, :397). The score dispatch runs
        under the dispatch supervisor like every device call of the serving
        loop."""
        from ..extender.client import ExtenderError
        from .cycle import _scores

        if self.cache.get_pod(pod.key) is not None:
            return  # stale queue entry (skipPodSchedule)

        snap, keys = self._snapshot_keys([pod])
        extras = tuple(p for p, _ in self._extra_score)
        extra_w = tuple(w for _, w in self._extra_score)
        # the feasible/score iteration below walks the node_order of the
        # snapshot that actually dispatched — a fallback re-encode reflects
        # newer cluster state (see the wave path)
        score_ctx = {"node_order": snap.node_order}

        def _score_on(tables, pend, exist, D):
            # one dispatch: infeasible nodes are -inf in the score row; the
            # row comes back as Python floats (each f32 exactly)
            return _scores(tables, pend, keys, D, exist,
                           self.hard_pod_affinity_weight, self.engine_config,
                           extras, extra_w)[0].cpu().tolist()

        def _score_fallback(dev, hung=False):
            args = None
            if not hung and snap.mesh is None:
                try:
                    args = (to_device(snap.tables, dev),
                            to_device(snap.pending, dev),
                            to_device(snap.existing, dev), snap.dims.D)
                except Exception:  # noqa: BLE001 - dead-source copy
                    args = None
            if args is None:
                # host re-encode onto the fallback (the wave path's ladder)
                fsnap, _fkeys = self._snapshot_keys([pod])
                args = (fsnap.tables, fsnap.pending, fsnap.existing,
                        fsnap.dims.D)
                score_ctx["node_order"] = fsnap.node_order
            return _score_on(*args)

        try:
            raw = self.supervisor.run(
                "scores", (replace(snap.dims, has_node_name=False), extras),
                lambda: _score_on(snap.tables, snap.pending, snap.existing,
                                  snap.dims.D),
                _score_fallback)
        except DispatchAbandonedError:
            # the wave path's crash-consistency contract: nothing was
            # assumed — requeue promptly instead of losing the pod
            stats.aborted += 1
            self.queue.add_prompt_retry(pod, attempts=attempts, now=now)
            return

        nodes_by_name = {n.name: n for n in self.cache.nodes()}
        feasible: List[str] = []
        combined: Dict[str, float] = {}
        for i, name in enumerate(score_ctx["node_order"]):
            if raw[i] != float("-inf"):
                feasible.append(name)
                combined[name] = raw[i]

        failed = False
        for ext in self.extenders:
            if not ext.is_interested(pod):
                continue
            try:
                names, _ = ext.filter(pod, [nodes_by_name[n] for n in feasible])
                allowed = set(names)
                feasible = [n for n in feasible if n in allowed]
                escore, weight = ext.prioritize(
                    pod, [nodes_by_name[n] for n in feasible])
                for n in feasible:
                    # extender scores 0-10 rescale to the 0-100 plugin range
                    combined[n] = combined.get(n, 0.0) \
                        + escore.get(n, 0) * weight * 10.0
            except ExtenderError:
                if getattr(ext.config, "ignorable", False):
                    continue  # extender.go:153-157 Ignorable
                failed = True
                break
            if not feasible:
                break

        if failed or not feasible:
            # FitError → preemption, as on the batched path (scheduler.go:629)
            handled = False
            if not failed and self.preemptor is not None:
                fresh = self._preempt_snapshot([pod])
                handled = self.preemptor.try_preempt(self, pod, attempts,
                                                     fresh, now)
            if not handled:
                stats.unschedulable += 1
                stats.failed_keys.append(pod.key)
                self.queue.add_unschedulable(pod, attempts, now, cycle=cycle)
            return

        best = max(feasible, key=lambda n: combined.get(n, float("-inf")))
        binder_ext = next(
            (e for e in self.extenders if e.is_binder and e.is_interested(pod)),
            None)
        try:
            intent = self._write_intent(cycle, [(pod, best, attempts)])
        except Exception:  # noqa: BLE001 - same contract as the wave path
            stats.aborted += 1
            self.queue.add_prompt_retry(pod, attempts=attempts, now=now)
            return
        self._commit(pod, best, attempts, now, cycle, stats,
                     binder_ext=binder_ext)
        self._retire_intent(intent)

    # ------------------------------------------------------------------ #
    # exactly-once plumbing: intent ledger + fencing + crash recovery
    # (sched/ledger.py)
    # ------------------------------------------------------------------ #

    def _fence_token(self) -> int:
        """The current fencing token (lease generation); 0 without leader
        election."""
        return int(self.fence_source()) if self.fence_source is not None \
            else 0

    def _write_intent(self, cycle: int,
                      commits: Sequence[Tuple[Pod, str, int]]):
        """Durably record the wave's placements before any Binding write
        (no-op without a ledger). Crashpoints bracket the write so the kill
        matrix can die exactly before/after it."""
        if self.ledger is None or not commits:
            return None
        faultline.crashpoint("pre_intent")
        intent = self.ledger.write_intent(
            cycle=cycle, token=self._fence_token(),
            bindings={p.key: node for p, node, _ in commits})
        faultline.crashpoint("post_intent")
        return intent

    def _retire_intent(self, intent) -> None:
        if intent is None:
            return
        faultline.crashpoint("post_bind")
        try:
            self.ledger.retire(intent)
        except Exception:  # noqa: BLE001 - a failed retire is SAFE: the
            # next recover() replays the record against informer truth and
            # finds every entry already settled — never double-bound
            pass

    def node_fits(self, pod: Pod, node_name: str) -> bool:
        """Host-side feasibility for intent replay: does `node_name` still
        hold the pod's requests given everything bound/assumed there NOW?
        Deliberately resource-only (api/semantics.py pod_fits_resources):
        replay completes a crashed leader's decision when it is still sane,
        and releases to the queue — where the full device evaluation reruns
        — when in doubt."""
        node = self.cache.get_node(node_name)
        if node is None:
            return False
        occupants = self.cache.pods_on_node(node_name)
        used_sc: Dict[str, int] = {}
        for p in occupants:
            for k, v in p.requests.scalars:
                used_sc[k] = used_sc.get(k, 0) + v
        used = Resources(
            milli_cpu=sum(p.requests.milli_cpu for p in occupants),
            memory_kib=sum(p.requests.memory_kib for p in occupants),
            ephemeral_kib=sum(p.requests.ephemeral_kib for p in occupants),
            scalars=tuple(sorted(used_sc.items())))
        ok, _fails = pod_fits_resources(pod, node, used, len(occupants))
        return ok

    def commit_recovered(self, pod: Pod, node_name: str,
                         now: Optional[float] = None) -> bool:
        """Complete one replayed intent entry: assume → bind →
        finish_binding, with the plain rollback on refusal (most commonly
        the apiserver's already-assigned guard when our informer lagged the
        crashed leader's committed write).

        Only valid on the PLAIN pipeline: with a framework (Reserve/Permit/
        PreBind gates) or extenders configured, the crashed wave's intent
        was written BEFORE those points ran, so completing the bind here
        would commit a placement a plugin might have refused — refuse
        instead, and let the release path re-run the full gauntlet."""
        now = self.clock() if now is None else now
        if self.framework is not None or self.extenders:
            return False  # gates must re-run: release → full pipeline
        if self.cache.get_pod(pod.key) is not None:
            return False  # already assumed/bound in this incarnation
        self.cache.assume_pod(pod, node_name)
        try:
            ok = bool(self.binder.bind(pod, node_name))
        except Exception:  # noqa: BLE001 - a raising binder is a refusal
            ok = False
        if ok:
            self.cache.finish_binding(pod.key, now)
            # close the span BEFORE queue.delete discards the stamp
            self.telemetry.record_bound(pod.key, now)
            self.queue.delete(pod.key)
            return True
        self.cache.forget_pod(pod.key)
        return False

    def recover(self, lookup=None, now: Optional[float] = None):
        """Startup/takeover reconciliation: replay every unretired bind
        intent against informer truth (sched/ledger.py replay — the full
        decision table lives there). `lookup(pod_key)` must return the live
        Pod (node_name = the apiserver's view) or None; the default reads
        this scheduler's own cache+queue. Returns a RecoveryReport (None
        without a ledger)."""
        if self.ledger is None:
            return None
        if lookup is None:
            lookup = self._cache_lookup
        return self.ledger.replay(self, lookup, now=now)

    def _cache_lookup(self, pod_key: str) -> Optional[Pod]:
        pod = self.cache.get_pod(pod_key)
        if pod is not None:
            return pod
        # not bound: an unbound pending pod lives in SOME queue lane —
        # including backoff/unschedulable
        return self.queue.get_pod(pod_key)

    def warm_standby(self) -> None:
        """One warm-standby beat (the non-leading half of HA failover): keep
        the encoder, the resident snapshot and the prewarmer's warm state
        HOT from informer truth without popping, assuming or binding
        anything. A takeover then skips the full re-ingest — the first led
        wave patches an already-resident snapshot. Strictly read-only
        against queue and binder."""
        backlog = self.queue.peek_active(self.batch_size)
        self.encoder.intern_pods(backlog)
        snap, _keys = self._snapshot_keys(backlog)
        eng = _engine()
        wave_engine = "scan" if (snap.dims.has_node_name
                                 and eng == "waves") else eng
        extras = tuple(p for p, _ in self._extra_score)
        gang = self._device_gangs and snap.gang is not None
        rc = snap.runs.rc if (wave_engine == "runs"
                              and snap.runs is not None) else 0
        # warm the signature the first led wave WILL dispatch (idempotent),
        # and keep the growth-boundary lookahead running
        self.prewarmer.ensure_warm(snap.dims, wave_engine, extras, gang,
                                   rc=rc, mesh=snap.mesh)
        self.prewarmer.observe(
            snap.dims, n_nodes=self.cache.node_count,
            n_existing=self.cache.pod_count, engine=wave_engine,
            extras=extras, gang=gang, rc=rc, mesh=snap.mesh)

    # ------------------------------------------------------------------ #
    # commit path: assume → Reserve → Permit → PreBind → Bind → PostBind
    # (scheduler.go:660-762)
    # ------------------------------------------------------------------ #

    def _commit(self, pod: Pod, node_name: str, attempts: int, now: float,
                cycle: int, stats: CycleStats,
                binder_ext: Optional[object] = None,
                latency_keys: Optional[List[str]] = None) -> None:
        fw = self.framework
        state = None
        self.cache.assume_pod(pod, node_name)
        self.queue.delete_nominated(pod.key)

        def rollback(as_bind_error: bool) -> None:
            # scheduler.go:717,732 — Unreserve + ForgetPod + requeue
            if fw is not None and state is not None:
                fw.run_unreserve_plugins(state, pod, node_name)
            self.cache.forget_pod(pod.key)
            if as_bind_error:
                stats.bind_errors += 1
            else:
                stats.unschedulable += 1
            stats.failed_keys.append(pod.key)
            self.queue.add_unschedulable(pod, attempts, now, cycle=cycle)

        if fw is not None:
            from ..framework.interface import Code, CycleState

            state = CycleState()
            st = fw.run_reserve_plugins(state, pod, node_name)  # scheduler.go:669
            if st is not None and not st.is_success:
                rollback(as_bind_error=False)
                return
            # register the waiting metadata BEFORE the permit plugins run:
            # run_permit_plugins publishes a WAITing pod in the framework's
            # cross-thread waiting map, and a permit controller may allow +
            # complete_waiting() in that window — the meta must already be
            # there to consume. Keep the ORIGINAL (unstamped) pod for
            # requeue-on-failure — the cached copy carries node_name and
            # would pin retries to this node. dict.pop is the atomic
            # exactly-one-consumer handoff.
            self._waiting_meta[pod.key] = (attempts, state, node_name,
                                           pod, binder_ext)
            st = fw.run_permit_plugins(state, pod, node_name)   # scheduler.go:707
            if st.code == Code.WAIT:
                return  # parked (or already completed by a racing allow)
            self._waiting_meta.pop(pod.key, None)
            if not st.is_success:
                rollback(as_bind_error=False)
                return
        tb0 = time.perf_counter()
        ok = self._run_bind(state, pod, node_name, binder_ext)
        if self.governor is not None:
            # commit-path breaker feed: outcome + wall latency of the
            # Binding write
            self.governor.note_commit(ok, time.perf_counter() - tb0)
        if ok:
            self.cache.finish_binding(pod.key, now)
            # watch→bind: wave callers close their spans in one batched
            # call; the per-pod extender path closes this one now
            if latency_keys is not None:
                latency_keys.append(pod.key)
            else:
                self.telemetry.record_bound(pod.key, self.clock())
            stats.scheduled += 1
            stats.assignments[pod.key] = node_name
            if fw is not None and state is not None:
                fw.run_post_bind_plugins(state, pod, node_name)
        else:
            rollback(as_bind_error=True)

    def _run_bind(self, state, pod: Pod, node_name: str,
                  binder_ext: Optional[object] = None) -> bool:
        """The shared PreBind → Bind tail of the commit sequence
        (scheduler.go:727-741). Everything — raising plugins, a raising
        binder — is contained here so every caller rolls back identically
        on failure."""
        fw = self.framework
        try:
            if fw is not None and state is not None:
                from ..framework.interface import Code

                st = fw.run_pre_bind_plugins(state, pod, node_name)
                if st is not None and not st.is_success:
                    return False
                bst = fw.run_bind_plugins(state, pod, node_name)
                if bst.code != Code.SKIP:
                    return bst.is_success
            if binder_ext is not None:
                binder_ext.bind(pod, node_name)
                return True
            return self.binder.bind(pod, node_name)
        except Exception:
            return False

    def complete_waiting(self, key: str, now: Optional[float] = None) -> bool:
        """Finish the bind for a pod released from the Permit waiting map
        (frameworkHandle.IterateOverWaitingPods → Allow flow). Call after
        framework.allow_waiting_pod returns True."""
        now = self.clock() if now is None else now
        meta = self._waiting_meta.pop(key, None)
        if meta is None:
            return False
        attempts, state, node_name, pod, binder_ext = meta
        if self.cache.get_pod(key) is None:
            return False
        fw = self.framework
        ok = self._run_bind(state, pod, node_name, binder_ext)
        if ok:
            self.cache.finish_binding(key, now)
            self.telemetry.record_bound(key, now)
            fw.run_post_bind_plugins(state, pod, node_name)
            return True
        self.waiting_bind_errors += 1
        fw.run_unreserve_plugins(state, pod, node_name)
        self.cache.forget_pod(key)
        self.queue.add_unschedulable(pod, attempts, now,
                                     cycle=self.queue.current_cycle())
        return False

    def reject_waiting(self, key: str, now: Optional[float] = None) -> bool:
        """Reject a Permit-waiting pod (WaitingPod.Reject flow): unreserve,
        forget the assume, requeue for retry."""
        if self.framework is None:
            return False
        now = self.clock() if now is None else now
        w = self.framework.pop_waiting(key)
        meta = self._waiting_meta.pop(key, None)
        if w is None and meta is None:
            return False
        attempts = meta[0] if meta else 0
        pod = meta[3] if meta else w.pod
        state = meta[1] if meta else w.state
        node_name = meta[2] if meta else w.node_name
        self.framework.run_unreserve_plugins(state, pod, node_name)
        if self.cache.is_assumed(key):
            self.cache.forget_pod(key)
        self.queue.add_unschedulable(pod, attempts, now,
                                     cycle=self.queue.current_cycle())
        return True

    def expire_waiting(self, now: Optional[float] = None) -> int:
        """Reject Permit-waiting pods past their deadline: unreserve, forget,
        requeue (waiting_pods_map timeout semantics)."""
        if self.framework is None:
            return 0
        now = self.clock() if now is None else now
        expired = self.framework.expire_waiting(now)
        for w in expired:
            meta = self._waiting_meta.pop(w.pod.key, None)
            attempts = meta[0] if meta else 0
            pod = meta[3] if meta else w.pod  # original unstamped pod
            self.framework.run_unreserve_plugins(w.state, pod, w.node_name)
            if self.cache.is_assumed(w.pod.key):
                self.cache.forget_pod(w.pod.key)
            self.queue.add_unschedulable(pod, attempts, now,
                                         cycle=self.queue.current_cycle())
        return len(expired)

    def run_until_idle(self, max_waves: int = 100) -> CycleStats:
        """Drive waves until the active queue drains (integration-test helper;
        the production loop is wait.Until(scheduleOne) — scheduler.go:425-431)."""
        total = CycleStats()
        for _ in range(max_waves):
            s = self.schedule_pending()
            total.attempted += s.attempted
            total.scheduled += s.scheduled
            total.unschedulable += s.unschedulable
            total.bind_errors += s.bind_errors
            total.aborted += s.aborted
            total.shed += s.shed
            total.requeued += s.requeued
            total.commit_paused += s.commit_paused
            if s.class_runs:
                # run-collapse telemetry: keep the last non-empty wave's
                total.class_runs = s.class_runs
                total.collapse_ratio = s.collapse_ratio
            total.assignments.update(s.assignments)
            if self.queue.lengths()[0] == 0:
                break
        return total
