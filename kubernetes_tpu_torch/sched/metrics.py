"""Scheduler metrics (pkg/scheduler/metrics/metrics.go:29-99).

Same metric names as the reference so dashboards port over:
scheduling_duration_seconds / e2e_scheduling_duration_seconds histograms,
attempt counters by result, queue depth and cache size gauges
(cache.go:692-696, scheduling_queue.go:237-243), preemption counters.
"""

from __future__ import annotations

from ..component.metrics import DEFAULT_REGISTRY as REG

SCHEDULING_DURATION = REG.histogram(
    "scheduler_scheduling_duration_seconds",
    "Scheduling cycle latency (one batched wave)", labels=("operation",))
E2E_SCHEDULING_DURATION = REG.histogram(
    "scheduler_e2e_scheduling_duration_seconds",
    "End-to-end scheduling latency per wave")
BINDING_DURATION = REG.histogram(
    "scheduler_binding_duration_seconds", "Binding latency")
POD_SCHEDULE_ATTEMPTS = REG.counter(
    "scheduler_pod_scheduling_attempts_total",
    "Pods attempted, by result", labels=("result",))
PENDING_PODS = REG.gauge(
    "scheduler_pending_pods", "Pending pods by queue",
    labels=("queue",))
CACHE_SIZE = REG.gauge(
    "scheduler_cache_size", "Scheduler cache objects", labels=("type",))
PREEMPTION_VICTIMS = REG.counter(
    "scheduler_pod_preemption_victims_total", "Preemption victims")
PREEMPTION_ATTEMPTS = REG.counter(
    "scheduler_total_preemption_attempts_total", "Preemption attempts")
WAVE_SIZE = REG.histogram(
    "scheduler_wave_batch_size", "Pods per batched device wave",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192))
# cache-consistency sweep (sched/debugger.py ConsistencySweeper — the kube
# cacheComparer made periodic): divergences found between the resident
# encoded state and informer truth, and self-heal re-encodes taken
CACHE_CONSISTENCY_SWEEPS = REG.counter(
    "scheduler_cache_consistency_sweeps_total",
    "Cache-vs-informer consistency sweeps run")
CACHE_CONSISTENCY_DIVERGENCES = REG.counter(
    "scheduler_cache_consistency_divergences_total",
    "Divergences found by the consistency sweep", labels=("kind",))
CACHE_CONSISTENCY_HEALS = REG.counter(
    "scheduler_cache_consistency_heals_total",
    "Self-heal full re-encodes triggered by the sweep")
# restart/HA (sched/ledger.py): intent replay outcomes per recovery pass
RECOVERED_INTENTS = REG.counter(
    "scheduler_recovered_bind_intents_total",
    "Unretired bind intents replayed at startup/takeover",
    labels=("outcome",))
# fleet serving (fleet/server.py): per-TENANT per-tick counters, so the
# chaos suite and the fleet bench stage prove tenant isolation from
# metrics (one tenant's storm degrades only its own series)
TENANT_ADMITTED = REG.counter(
    "scheduler_fleet_tenant_admitted_total",
    "Pods admitted (bound) per tenant per fleet tick", labels=("tenant",))
TENANT_REQUEUED = REG.counter(
    "scheduler_fleet_tenant_requeued_total",
    "Pods requeued without a failure verdict (quota clamp, storm, abort) "
    "per tenant", labels=("tenant",))
TENANT_DEGRADED = REG.counter(
    "scheduler_fleet_tenant_degraded_ticks_total",
    "Fleet ticks in which the tenant was storm-degraded",
    labels=("tenant",))
DRF_CLAMPED = REG.counter(
    "scheduler_fleet_drf_clamped_total",
    "Pending pods clamped inert by the DRF quota pre-mask",
    labels=("tenant",))
# flight-recorder + e2e latency (sched/telemetry.py): the per-pod
# watch→bind histogram ROADMAP item 2's p99 target is defined in. With
# streaming micro-waves the operating regime is sub-100 ms, so
# the ladder is densest from 5–100 ms (where the micro p50/p99 live —
# roughly one bucket per 1.3–1.5× step, enough to read a p99 shift of
# tens of ms straight off /metrics) and still extends to 60 s so a
# brownout's cycle-granular latencies land inside a bounded bucket.
POD_E2E_LATENCY = REG.histogram(
    "scheduler_pod_e2e_latency_seconds",
    "Per-pod end-to-end latency: informer ingest / queue add (first seen, "
    "surviving requeues) to Binding commit",
    buckets=(0.001, 0.0025, 0.005, 0.0075, 0.01, 0.015, 0.02, 0.03, 0.04,
             0.05, 0.065, 0.08, 0.1, 0.15, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
             30.0, 60.0))
# streaming micro-waves (sched/scheduler.py): how many waves were
# micro admissions — small fresh-delta batches grafted onto the resident
# snapshot between bulk cycles. Ratio against wave counts elsewhere tells
# whether the streaming path is actually carrying the watch traffic.
MICRO_WAVES = REG.counter(
    "scheduler_micro_waves_total",
    "Micro-waves dispatched (streaming sub-cycle admission of fresh watch "
    "deltas; bulk backlog waves are not counted)",
    labels=("scheduler",))
FLIGHT_DUMPS = REG.counter(
    "scheduler_flight_recorder_dumps_total",
    "Flight-recorder ring dumps, by trigger (abandoned, watchdog_timeout, "
    "degraded, storm, takeover, debug-endpoint, ...)", labels=("trigger",))
# overload governor (sched/overload.py): the brownout mode ladder,
# the commit-path circuit breaker, and priority-aware shedding — the
# governor's OWN control signals (per-lane depths ride PENDING_PODS above,
# now including the deferred lane) must be scrapeable from /metrics. All
# series carry the GOVERNOR label (the scheduler's name; fleet = the
# tenant) — per-tenant governors share one registry, and an unlabeled
# gauge would let tenant B's NORMAL overwrite tenant A's live brownout.
OVERLOAD_MODE = REG.gauge(
    "scheduler_overload_mode",
    "Brownout mode ladder position (0=NORMAL, 1=SHED_LOW, 2=TRICKLE)",
    labels=("governor",))
MODE_TRANSITIONS = REG.counter(
    "scheduler_overload_mode_transitions_total",
    "Brownout mode transitions, by destination mode",
    labels=("governor", "to"))
BREAKER_STATE = REG.gauge(
    "scheduler_commit_breaker_state",
    "Commit-path circuit breaker (0=closed, 1=half_open, 2=open)",
    labels=("governor",))
BREAKER_TRANSITIONS = REG.counter(
    "scheduler_commit_breaker_transitions_total",
    "Commit-path breaker transitions, by destination state",
    labels=("governor", "to"))
SHED_PODS = REG.counter(
    "scheduler_overload_shed_pods_total",
    "Low-priority pods parked in the deferred lane by the governor "
    "(deferred, never dropped — they re-admit when shedding ends)",
    labels=("governor",))
# decision provenance (sched/explain.py): per-predicate rejection
# attribution for unschedulable pods and the winning node's score-component
# decomposition for scheduled ones — the on-device reduction's metric sinks.
UNSCHEDULABLE_REASONS = REG.counter(
    "scheduler_unschedulable_reasons_total",
    "Rejected-node attributions for unschedulable pods, by predicate "
    "(one increment per rejected node per unschedulable pod-wave — the "
    "tensor analog of FailedScheduling reason counts)",
    labels=("predicate",))
SCORE_SHARE = REG.counter(
    "scheduler_scheduled_score_share",
    "Accumulated score-component contribution at the winning node of every "
    "scheduled pod (a component's share = its value / the sum across "
    "components) — the explainability signal the learned-scoring roadmap "
    "items train against",
    labels=("component",))
FAILED_EVENTS = REG.counter(
    "scheduler_failed_scheduling_events_total",
    "FailedScheduling event dispositions from the decision-provenance "
    "pipeline: emitted (written through the apiserver), deduped (suppressed "
    "by the per-(pod, fingerprint) exponential backoff), capped (deferred "
    "by the per-wave write budget; re-qualifies next occurrence), error "
    "(write failed past the retry budget), unsinked (no sink attached)",
    labels=("outcome",))
# fleet watch plane (fleet/server.py FleetWatchPlane): how far
# behind live watch truth each tenant's serving state is. ~0 on a healthy
# stream (bookmarks refresh it even when the resource is quiet); grows while
# the mux stream is dead (tenants keep serving from cached state instead of
# dropping ticks); decays back to ~0 after the revive's resume.
TENANT_STALENESS = REG.gauge(
    "tenant_staleness_seconds",
    "Seconds since the tenant's watch route last heard from upstream "
    "(event, bookmark, or list)", labels=("tenant",))


def observe_tenant_staleness(staleness_by_tenant) -> None:
    """Export per-tenant watch staleness ({tenant → seconds}) — called from
    FleetWatchPlane.maintain() every fleet tick."""
    for name, s in staleness_by_tenant.items():
        TENANT_STALENESS.set(round(float(s), 3), tenant=name)


def observe_fleet_tick(per_tenant) -> None:
    """Record one fleet tick's per-tenant outcomes (fleet/server.py calls
    this with {tenant name → CycleStats}). DRF clamp counts route through
    CycleStats.drf_clamped so the fleet bench asserts `drf_clamped >= 1`
    from the metric, not from FleetServer internals."""
    for name, st in per_tenant.items():
        if st.scheduled:
            TENANT_ADMITTED.inc(st.scheduled, tenant=name)
        if st.requeued:
            TENANT_REQUEUED.inc(st.requeued, tenant=name)
        if st.degraded:
            TENANT_DEGRADED.inc(st.degraded, tenant=name)
        if getattr(st, "drf_clamped", 0):
            DRF_CLAMPED.inc(st.drf_clamped, tenant=name)


def observe_queue_depths(depths) -> None:
    """Export every queue lane (activeQ/backoffQ/unschedulableQ/deferred)
    as a `scheduler_pending_pods{queue=...}` gauge — `depths` is
    `PriorityQueue.depths()`. The overload governor consumes these same
    numbers; exporting them makes its control signals scrapeable."""
    for lane, n in depths.items():
        PENDING_PODS.set(n, queue=lane)


def observe_wave(stats, queue_lengths, cache_counts) -> None:
    """Record one wave's outcome (called from the scheduler server loop).
    `queue_lengths` is the legacy (active, backoff, unschedulable) tuple
    or a `PriorityQueue.depths()` dict (which adds the deferred lane)."""
    if stats.attempted:
        SCHEDULING_DURATION.observe(stats.cycle_seconds, operation="wave")
        E2E_SCHEDULING_DURATION.observe(stats.cycle_seconds)
        WAVE_SIZE.observe(stats.attempted)
    if stats.scheduled:
        POD_SCHEDULE_ATTEMPTS.inc(stats.scheduled, result="scheduled")
    if stats.unschedulable:
        POD_SCHEDULE_ATTEMPTS.inc(stats.unschedulable, result="unschedulable")
    if stats.bind_errors:
        POD_SCHEDULE_ATTEMPTS.inc(stats.bind_errors, result="error")
    if isinstance(queue_lengths, dict):
        observe_queue_depths(queue_lengths)
    else:
        active, backoff, unsched = queue_lengths
        PENDING_PODS.set(active, queue="active")
        PENDING_PODS.set(backoff, queue="backoff")
        PENDING_PODS.set(unsched, queue="unschedulable")
    nodes, pods = cache_counts
    CACHE_SIZE.set(nodes, type="nodes")
    CACHE_SIZE.set(pods, type="pods")
