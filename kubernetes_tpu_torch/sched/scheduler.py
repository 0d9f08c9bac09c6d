"""The stateful, watch-driven scheduler: cache + queue + batched device cycle
(port of the JAX package's sched/scheduler.py, serving path).

The analog of the reference's Scheduler struct and its wiring
(pkg/scheduler/scheduler.go:79-122, eventhandlers.go:335-441), with the
per-pod scheduleOne loop (scheduler.go:596-763) replaced by a per-*wave*
batched cycle: pop up to `batch_size` pods, snapshot the resident cache
(state/cache.py: full, patch or cached), run one cycle on the device
(sched/cycle.py schedule_batch: the wave engine with the K1/K2 kernels),
read the placements back, then assume and bind.

Event handlers mirror eventhandlers.go:
  * assigned-pod add/update/delete      → cache            (:360-362)
  * unassigned-pod add/update/delete    → queue            (:367-385, filtered
    by `responsible_for` — the schedulerName check, :277-282)
  * node add/update/delete              → cache + queue.move_all_to_active
                                                           (:392-396)
Failures feed the backoff/unschedulable queues exactly as FitError handling
does (scheduler.go:436-448); bind errors roll back via cache.forget_pod
(scheduler.go:717,732).

The dispatch runs on the calling thread: no watchdog, no CPU fallback. Not
ported yet, each refused with NotImplementedError naming its ROADMAP item:
preemption and decision provenance (A9), extenders and framework plugins
(A11), mesh serving (A13), the bind-intent ledger and fencing (A14); gang
batches and KTPU_ASSIGN=runs (A9) raise at the first wave that needs them.
The prewarmer, the dispatch supervisor and real telemetry (A10) are absent;
telemetry keeps its disabled path (sched/telemetry.py).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol, Sequence, Tuple

from ..api.types import DEFAULT_SCHEDULER_NAME, Node, Pod
from ..state.arrays import resolve_device
from ..state.cache import SchedulerCache
from ..state.dims import Dims, bucket
from ..state.encode import Encoder
from .cycle import (micro_snapshot_with_keys, schedule_batch,
                    snapshot_with_keys)
from .overload import build_governor
from .queue import PriorityQueue
from .telemetry import NullTelemetry


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
    (metrics/metrics.go:32-99). The JAX package's fields, less those only
    its unported paths fill (aborted dispatches, run-collapse telemetry,
    fleet ticks)."""

    attempted: int = 0
    scheduled: int = 0
    unschedulable: int = 0
    bind_errors: int = 0
    # pods sent back to the queue without a failure verdict: the rest of a
    # wave whose commit breaker opened mid-wave
    requeued: int = 0
    # overload governor (sched/overload.py): pods parked in the deferred
    # lane this wave (SHED_LOW — deferred, never dropped), and whether the
    # wave was paused outright by the open commit breaker (no pop, no
    # device time)
    shed: int = 0
    commit_paused: int = 0
    # 1 when this wave was a micro-wave — a small fresh-delta batch grafted
    # onto the resident snapshot between bulk cycles
    micro: int = 0
    cycle_seconds: float = 0.0
    assignments: Dict[str, str] = field(default_factory=dict)
    # pod keys that failed this wave (feeds FailedScheduling events)
    failed_keys: List[str] = field(default_factory=list)


def _mesh_env_on() -> bool:
    """KTPU_MESH asks for mesh serving when the JAX package would build a
    mesh from it: "auto" or a device count above 1."""
    env = os.environ.get("KTPU_MESH", "")
    if env == "auto":
        return True
    try:
        return int(env) > 1
    except ValueError:
        return False


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet — ROADMAP {item}")


class Scheduler:
    """Single-profile scheduler. `schedule_pending` is the wave analog of
    scheduleOne; call it from a loop (or `run_until_idle`).

    Runs on the CUDA device unless `device="cpu"` is asked for; with no
    usable GPU and no explicit CPU device it raises, never moving to the CPU
    on its own."""

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
    ) -> None:
        if preemptor is not None:
            raise _unported("preemption (sched/preemption.py)", "A9")
        if os.environ.get("KTPU_EXPLAIN", "0") not in ("", "0", "off"):
            raise _unported("KTPU_EXPLAIN: decision provenance "
                            "(sched/explain.py)", "A9")
        if extenders:
            raise _unported("extenders (extender/)", "A11")
        if framework is not None:
            raise _unported("framework plugins (framework/)", "A11")
        if mesh is not None or _mesh_env_on():
            raise _unported("mesh serving (parallel/mesh.py, KTPU_MESH)",
                            "A13")
        if ledger is not None or fence_source is not None:
            raise _unported("the bind-intent ledger and fencing "
                            "(sched/ledger.py)", "A14")
        self.device = resolve_device(device)
        self.binder = binder
        self.cache = cache or SchedulerCache()
        self.queue = queue or PriorityQueue()
        self.scheduler_name = scheduler_name
        self.batch_size = batch_size
        self.base_dims = base_dims
        self.clock = clock
        self.encoder = Encoder()
        self.telemetry = NullTelemetry()
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
        return snapshot_with_keys(self.cache, self.encoder, pending,
                                  self.base_dims, device=self.device)

    def _micro_snapshot_keys(self, pending: List[Pod]):
        # sync the resident tables with an EMPTY pending patch, then graft
        # a small fixed-P pending block for just these deltas
        return micro_snapshot_with_keys(
            self.cache, self.encoder, pending, self.base_dims,
            self._micro_p, device=self.device)

    def _micro_mode(self, now: float) -> str:
        """Micro/bulk arbitration, decided once per wave after the
        governor gate: "micro" only when the ENTIRE live backlog is the
        micro lane (fresh, ungrouped, unpinned deltas) and fits one micro
        wave — anything mixed or deep is bulk work. "hold" keeps a
        not-yet-full lane waiting out the coalesce window (never when the
        window is off or the lane is full)."""
        if not self.microwave:
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
        span = self.telemetry.wave_span()
        return self._run_wave(span, now, t0, micro_only=micro_only)

    def _run_wave(self, span, now: float, t0: float,
                  micro_only: bool = False) -> CycleStats:
        self.queue.pump(now)
        self.cache.cleanup(now)
        span.mark("pump")
        # ---- overload governor gate (sched/overload.py): mode ladder,
        # breaker pause, wave-size clamp — decided BEFORE the pop so a
        # paused wave burns no device time and pops nothing it cannot
        # commit ---- #
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
                stats.cycle_seconds = time.perf_counter() - t0
                return stats
            if decision.wave_limit:
                pop_limit = min(pop_limit, decision.wave_limit)
        # ---- micro/bulk arbitration: AFTER the governor gate, so a
        # breaker pause dominates and a deferred release lands in the
        # depths the decision reads ---- #
        mode = self._micro_mode(now)
        if micro_only and mode != "micro":
            # schedule_micro probe: the lane isn't micro-ready — leave the
            # backlog to the bulk cadence
            stats = CycleStats()
            stats.cycle_seconds = time.perf_counter() - t0
            return stats
        if mode == "hold":
            # coalesce window open: near-simultaneous deltas share the next
            # micro dispatch
            stats = CycleStats()
            stats.cycle_seconds = time.perf_counter() - t0
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
        if not batch:
            return stats

        pending = [p for p, _ in batch]
        snap, keys = (self._micro_snapshot_keys(pending) if micro
                      else self._snapshot_keys(pending))
        span.mark("snapshot")
        if snap.gang is not None:
            raise _unported("gang-grouped pods: the gang engine (ops/gang.py)",
                            "A9")
        # the engine from KTPU_ASSIGN; a nodeName-bearing batch takes the
        # literal scan (sched/cycle.py schedule_batch)
        res = schedule_batch(snap.tables, snap.pending, keys, snap.dims.D,
                             snap.existing,
                             has_node_name=snap.dims.has_node_name)
        # intern the NEXT wave's backlog before reading this one back (the
        # JAX package does it while its dispatch runs): the vocabulary and
        # class ids — tie-breaks in the wave engine — come out in its order.
        # A micro wave skips it: interning a bulk backlog would put the bulk
        # cost back on the latency path
        backlog = [] if micro else self.queue.peek_active(self.batch_size)
        if backlog:
            self.encoder.intern_pods(backlog)
        span.mark("dispatch")
        node_idx = res.node.cpu().tolist()
        span.mark("readback")

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
            commits.append((pod, snap.node_order[ni], attempts))
        bound_keys: List[str] = []
        for ci, (pod, node_name, attempts) in enumerate(commits):
            if gov is not None and not gov.commit_allowed():
                # the breaker OPENED mid-wave (this wave's own commits
                # tripped it): the rest of the wave requeues promptly, no
                # failure verdict
                for pod2, _n2, attempts2 in commits[ci:]:
                    stats.requeued += 1
                    self.queue.add_prompt_retry(pod2, attempts=attempts2,
                                                now=now)
                break
            self._commit(pod, node_name, attempts, now, cycle, stats,
                         latency_keys=bound_keys)
        if bound_keys:
            self.telemetry.record_bound_many(bound_keys, self.clock())
        span.mark("bind-commit")

        for pod, attempts in failures:
            stats.unschedulable += 1
            stats.failed_keys.append(pod.key)
            self.queue.add_unschedulable(pod, attempts, now, cycle=cycle)
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
        self.telemetry.finish_wave(span, stats=stats, dims=snap.dims,
                                   micro=micro)
        return stats

    # ------------------------------------------------------------------ #
    # commit path: assume → Bind (scheduler.go:660-762, no framework)
    # ------------------------------------------------------------------ #

    def _commit(self, pod: Pod, node_name: str, attempts: int, now: float,
                cycle: int, stats: CycleStats,
                latency_keys: List[str]) -> None:
        self.cache.assume_pod(pod, node_name)
        self.queue.delete_nominated(pod.key)
        tb0 = time.perf_counter()
        ok = self._run_bind(pod, node_name)
        if self.governor is not None:
            # commit-path breaker feed: outcome + wall latency of the
            # Binding write
            self.governor.note_commit(ok, time.perf_counter() - tb0)
        if ok:
            self.cache.finish_binding(pod.key, now)
            latency_keys.append(pod.key)
            stats.scheduled += 1
            stats.assignments[pod.key] = node_name
            return
        # scheduler.go:717,732 — ForgetPod + requeue
        self.cache.forget_pod(pod.key)
        stats.bind_errors += 1
        stats.failed_keys.append(pod.key)
        self.queue.add_unschedulable(pod, attempts, now, cycle=cycle)

    def _run_bind(self, pod: Pod, node_name: str) -> bool:
        """The Bind tail of the commit sequence (scheduler.go:727-741); a
        raising binder is a failed bind."""
        try:
            return self.binder.bind(pod, node_name)
        except Exception:
            return False

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
            total.shed += s.shed
            total.requeued += s.requeued
            total.commit_paused += s.commit_paused
            total.assignments.update(s.assignments)
            if self.queue.lengths()[0] == 0:
                break
        return total
