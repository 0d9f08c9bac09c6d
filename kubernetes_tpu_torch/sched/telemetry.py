"""Flight recorder + end-to-end latency telemetry for the serving scheduler.

Three tiers (docs/OBSERVABILITY.md is the operator-facing manual):

  1. **Per-pod e2e latency** — every pending pod is stamped at informer-
     ingest/queue-add time (`PodLatencyTracker`, first-seen semantics: a
     backoff requeue, a prompt retry or a crash-recovery re-admission keeps
     the ORIGINAL stamp) and recorded at Binding-commit into the
     `scheduler_pod_e2e_latency_seconds` histogram — the metric ROADMAP
     item 2's "p99 watch→bind < 100 ms" target is defined in. Stamps live
     in the *scheduler's* clock domain (the injected, possibly
     deterministic per-tick clock), so tests and the mesh/fleet
     bit-equality suites measure exact virtual latencies.
  2. **Per-wave phase spans** — `SchedulerTelemetry.wave_span()` wraps a
     `component/trace.py` Trace (injected clock) around one serving wave;
     the scheduler marks pump → pop → snapshot → prewarm → dispatch →
     readback → intent-write → bind-commit → retire, each span feeding the
     `scheduler_scheduling_duration_seconds{operation=<phase>}` histogram
     and the bounded in-memory **flight recorder ring**. Supervisor events
     (degraded / fallback / watchdog_timeout / abandoned / rewarm /
     recovery — sched/supervisor.py `event_sink`) and per-tenant fleet
     stats attach to the wave record, and the ring dumps structured JSON
     on demand (`/debug/flightrecorder`, `dump()`) and automatically on an
     abandoned dispatch, a watchdog budget violation, a tenant storm or a
     takeover — a bad tick in bench/chaos is explainable from the
     artifact, not from logs.
  3. **Device-time split** — the primary dispatch separately times the
     launch (the host time to enqueue the cycle) vs execution (CUDA events
     recorded on the dispatch stream at its first and last op) vs readback
     (the copy of the placements to the host); `KTPU_PROFILE=<dir>`
     additionally runs a `torch.profiler` trace with a `cycle` range around
     every supervised wave dispatch, exported as a Chrome trace on
     `stop_profile()`.

Port of the JAX package's sched/telemetry.py: the same tiers, records,
phase names, dump format and knobs; tier 3 reads CUDA events and
torch.profiler where the JAX package reads jax.profiler.

Kill switch: ``KTPU_TELEMETRY=0`` turns every tier into a no-op (the
`latency` bench stage uses it to bound telemetry overhead at <2% of the
untelemetered flagship pods/s).
"""

from __future__ import annotations

import gzip
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..component.trace import Trace, device_step_marker
from .metrics import FLIGHT_DUMPS, POD_E2E_LATENCY, SCHEDULING_DURATION

#: supervisor/tick event kinds that auto-dump the ring when they appear on
#: a wave record (the "explainable without logs" triggers),
#: most severe first — the dump is labelled with the worst event present
DUMP_TRIGGERS = ("abandoned", "watchdog_timeout", "storm", "breaker_open",
                 "degraded")

#: canonical serving-wave phase order (the scheduler marks a subset; fleet
#: ticks add stack-refresh/solo phases) — tests assert ordering against it
WAVE_PHASES = ("pump", "pop", "snapshot", "prewarm", "dispatch", "readback",
               "intent-write", "bind-commit", "retire", "requeue")

#: per-record payload caps, applied at SERIALIZATION time (snapshot/dump —
#: the in-memory ring keeps full records): a large fleet's per-tick tenant
#: map and a storm's event burst were most of FLIGHT_rNN.json's ~4.6k
#: lines per bench run. Overridable via KTPU_FLIGHT_FLEET_CAP /
#: KTPU_FLIGHT_EVENT_CAP (bounds-checked; garbage → default).
FLIGHT_FLEET_TENANT_CAP = 8
FLIGHT_EVENT_CAP = 32


def _cap_record(rec: Dict[str, Any]) -> Dict[str, Any]:
    """A serialization-bounded copy of one wave record: the fleet map keeps
    the `tenant cap` busiest tenants (by attempted, ties by name) plus one
    aggregate "..." row summing every numeric field of the omitted rest —
    fleet-wide totals stay reconstructable from the capped form; the
    supervisor-event list keeps its head and tail around an explicit
    truncation marker. Records already under the caps pass through
    unchanged (same content, fresh dict)."""
    from ..utils.envparse import env_int

    out = dict(rec)
    fleet = out.get("fleet")
    tcap = env_int("KTPU_FLIGHT_FLEET_CAP", FLIGHT_FLEET_TENANT_CAP,
                   1, 4096)
    if isinstance(fleet, dict) and len(fleet) > tcap:
        busiest = sorted(
            fleet, key=lambda n: (-(fleet[n].get("attempted", 0)
                                    if isinstance(fleet[n], dict) else 0),
                                  str(n)))
        keep = set(busiest[:tcap])
        agg: Dict[str, Any] = {"tenants_omitted": len(fleet) - len(keep)}
        for n, v in fleet.items():
            if n in keep or not isinstance(v, dict):
                continue
            for k2, x in v.items():
                if isinstance(x, (int, float)):
                    agg[k2] = agg.get(k2, 0) + x
        capped = {n: v for n, v in fleet.items() if n in keep}
        capped["..."] = agg
        out["fleet"] = capped
    ev = out.get("supervisor_events")
    ecap = env_int("KTPU_FLIGHT_EVENT_CAP", FLIGHT_EVENT_CAP, 1, 4096)
    if isinstance(ev, list) and len(ev) > ecap:
        head = ev[:max(ecap // 2, 1)]
        tail = ev[len(ev) - max(ecap - len(head) - 1, 0):]
        out["supervisor_events"] = (
            head
            + [("truncated",
                f"{len(ev) - len(head) - len(tail)} events omitted")]
            + tail)
    return out


def _write_dump(doc: Dict[str, Any], path: str) -> None:
    """Write a flight document compactly: one JSON line per wave record
    instead of `indent=1`'s line-per-scalar (which made FLIGHT_rNN.json
    ~4.6k lines per bench run). Still a single valid JSON object —
    `json.load` reconstructs it unchanged. A `.gz` path gzips the same
    bytes (KTPU_FLIGHT_GZIP policy appends the suffix)."""
    opener = (lambda p: gzip.open(p, "wt")) if path.endswith(".gz") else \
        (lambda p: open(p, "w"))
    with opener(path) as f:
        f.write("{\n")
        for k, v in doc.items():
            if k == "records":
                continue
            f.write(f" {json.dumps(k)}: {json.dumps(v)},\n")
        recs = doc.get("records", [])
        f.write(' "records": [\n')
        f.write(",\n".join("  " + json.dumps(r) for r in recs))
        f.write("\n ]\n}\n" if recs else " ]\n}\n")


class PodLatencyTracker:
    """First-seen ingest stamps, keyed by pod key, in the caller's clock
    domain. `stamp` is idempotent — requeues (backoff, prompt retry,
    crash-recovery re-admission) keep the ORIGINAL stamp, so the recorded
    latency is the true watch→bind span, not the last-retry span."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._first_seen: Dict[str, float] = {}

    def stamp(self, key: str, now: float) -> None:
        with self._mu:
            self._first_seen.setdefault(key, now)

    def first_seen(self, key: str) -> Optional[float]:
        with self._mu:
            return self._first_seen.get(key)

    def discard(self, key: str) -> None:
        """Pod deleted while pending — the span will never complete."""
        with self._mu:
            self._first_seen.pop(key, None)

    def pop_latency(self, key: str, now: float) -> Optional[float]:
        """Binding committed: consume the stamp, return the e2e span."""
        with self._mu:
            t0 = self._first_seen.pop(key, None)
        return None if t0 is None else max(now - t0, 0.0)

    def pop_latencies(self, keys, now: float) -> List[float]:
        """Batch `pop_latency`: one lock round-trip for a whole wave's
        Binding commits (never-stamped keys are skipped). The per-pod
        lock+call overhead of the scalar path was a measurable slice of
        the ≤2% telemetry budget at thousands of binds per wave."""
        out: List[float] = []
        with self._mu:
            pop = self._first_seen.pop
            for k in keys:
                t0 = pop(k, None)
                if t0 is not None:
                    out.append(max(now - t0, 0.0))
        return out

    def __len__(self) -> int:
        with self._mu:
            return len(self._first_seen)


class FlightRecorder:
    """Bounded ring of wave/tick records. Append-only; `dump()` snapshots
    the ring into one structured-JSON document (optionally to a file)."""

    def __init__(self, capacity: int = 64) -> None:
        self.capacity = capacity
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._seq = 0
        self.evicted = 0  # records pushed out of the ring

    def record(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        with self._mu:
            self._seq += 1
            rec["seq"] = self._seq
            if len(self._ring) == self.capacity:
                self.evicted += 1
            self._ring.append(rec)
        return rec

    def records(self) -> List[Dict[str, Any]]:
        with self._mu:
            return list(self._ring)

    def snapshot(self, trigger: str) -> Dict[str, Any]:
        with self._mu:
            return {
                "trigger": trigger,
                "capacity": self.capacity,
                "evicted": self.evicted,
                "last_seq": self._seq,
                "records": [_cap_record(r) for r in self._ring],
            }


class _NullSpan:
    """No-op span when telemetry is disabled (KTPU_TELEMETRY=0)."""

    __slots__ = ()
    enabled = False

    def mark(self, name: str) -> None:  # noqa: ARG002 - interface
        pass


class _WaveSpan:
    """One serving wave's phase timeline: a component/trace.py Trace with
    the telemetry clock injected. `mark(name)` closes the phase that just
    ran; phase durations are derived from consecutive steps."""

    __slots__ = ("trace",)
    enabled = True

    def __init__(self, clock: Callable[[], float], name: str,
                 threshold: float) -> None:
        self.trace = Trace(name, clock=clock, threshold=threshold)

    def mark(self, name: str) -> None:
        self.trace.step(name)

    def phases(self) -> List[Tuple[str, float]]:
        out: List[Tuple[str, float]] = []
        prev = self.trace.start
        for ts, msg in self.trace.steps:
            out.append((msg, max(ts - prev, 0.0)))
            prev = ts
        return out


_NULL_SPAN = _NullSpan()

#: flight-recorder ring bounds for KTPU_FLIGHT_RING (a ring of 0 would
#: record nothing silently; an unbounded one defeats "bounded")
FLIGHT_RING_DEFAULT = 64
FLIGHT_RING_MIN = 1
FLIGHT_RING_MAX = 65536


def flight_ring_capacity(default: int = FLIGHT_RING_DEFAULT) -> int:
    """Bounds-checked KTPU_FLIGHT_RING parse: the flight-recorder ring
    size. Unset/empty/garbage → the default; numeric values clamp into
    [FLIGHT_RING_MIN, FLIGHT_RING_MAX] — an operator typo must degrade to
    a sane ring, never crash the scheduler or disable recording."""
    raw = os.environ.get("KTPU_FLIGHT_RING", "")
    if not raw:
        return default
    try:
        v = int(raw)
    except ValueError:
        return default
    return min(max(v, FLIGHT_RING_MIN), FLIGHT_RING_MAX)


class SchedulerTelemetry:
    """The scheduler-wide observability layer: one per Scheduler (and one
    per FleetServer). Thread-aware: supervisor events and the device-time
    split arrive from watchdog worker threads; everything else runs on the
    serving loop."""

    def __init__(self, name: str = "scheduler", capacity: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 enabled: Optional[bool] = None,
                 slow_wave_threshold: float = 30.0) -> None:
        if enabled is None:
            enabled = os.environ.get("KTPU_TELEMETRY", "1") not in ("0", "off")
        if capacity is None:
            # KTPU_FLIGHT_RING: ring size, bounds-checked (explicit ctor
            # capacities — tests — win over the env)
            capacity = flight_ring_capacity()
        self.name = name
        self.enabled = enabled
        self.clock = clock
        self.slow_wave_threshold = slow_wave_threshold
        self.tracker = PodLatencyTracker()
        self.recorder = FlightRecorder(capacity)
        # exact-quantile reservoir beside the Prometheus histogram: the
        # latency bench and tests read precise p50/p99 from here while
        # dashboards use histogram_quantile on the exposed buckets
        self.latency_samples: deque = deque(maxlen=8192)
        self._mu = threading.Lock()
        self._pending_events: List[Tuple[str, str]] = []
        # token (wave span) → readings; see note_device_split. Keyed by
        # the token OBJECT (strong ref — an id() key could be reused by a
        # GC'd span), bounded below so abandoned waves' entries can't leak
        self._device_split: Dict[object, Dict[str, float]] = {}
        self.last_dump: Optional[Dict[str, Any]] = None
        self.dumps = 0
        # KTPU_PROFILE=<dir>: torch.profiler trace around dispatches
        self.profile_dir = os.environ.get("KTPU_PROFILE") or None
        self._profiler = None

    # ------------------------------------------------------------------ #
    # tier 1: per-pod e2e latency (watch→bind)
    # ------------------------------------------------------------------ #

    def record_bound(self, key: str, now: float) -> Optional[float]:
        """Binding-commit: close the pod's watch→bind span and feed the
        e2e histogram. `now` must be in the SAME clock domain the queue
        stamped with (the scheduler's injected clock)."""
        if not self.enabled:
            return None
        lat = self.tracker.pop_latency(key, now)
        if lat is None:
            return None
        POD_E2E_LATENCY.observe(lat)
        with self._mu:
            # under _mu: the debug endpoint's quantile read iterates the
            # deque from the gateway thread, and a concurrent append would
            # raise "deque mutated during iteration"
            self.latency_samples.append(lat)
        return lat

    def record_bound_many(self, keys, now: float) -> int:
        """Batch `record_bound` for one wave's commit loop: one tracker
        lock, one histogram lock, one reservoir lock for the whole batch —
        ~3× cheaper per pod than the scalar path, which at 2.7 µs/call was
        most of the measured telemetry overhead on a 2500-pod wave. Same
        clock-domain contract as `record_bound`; returns how many spans
        actually closed."""
        if not self.enabled or not keys:
            return 0
        lats = self.tracker.pop_latencies(keys, now)
        if not lats:
            return 0
        POD_E2E_LATENCY.observe_many(lats)
        with self._mu:
            self.latency_samples.extend(lats)
        return len(lats)

    def latency_quantiles(self, qs=(0.5, 0.99)) -> Dict[float, float]:
        """Exact quantiles (seconds) over the bounded sample reservoir."""
        with self._mu:
            samples = sorted(self.latency_samples)
        if not samples:
            return {q: 0.0 for q in qs}
        return {q: samples[min(int(q * len(samples)), len(samples) - 1)]
                for q in qs}

    # ------------------------------------------------------------------ #
    # tier 2: wave spans + flight recorder
    # ------------------------------------------------------------------ #

    def wave_span(self, name: str = "wave"):
        if not self.enabled:
            return _NULL_SPAN
        return _WaveSpan(self.clock, name, self.slow_wave_threshold)

    def has_pending_events(self) -> bool:
        with self._mu:
            return bool(self._pending_events)

    def note_supervisor_event(self, kind: str, detail: str = "") -> None:
        """sched/supervisor.py `event_sink`: called from the serving loop
        AND from watchdog/prober threads — events accumulate until the
        current wave's `finish_wave` drains them onto its record."""
        if not self.enabled:
            return
        with self._mu:
            self._pending_events.append((kind, str(detail)[:200]))

    def note_device_split(self, launch: float, execute: float,
                          readback: float, token: object = None) -> None:
        """Tier 3 readings from the dispatch worker for the wave in flight:
        `launch` is the host time to enqueue the dispatch; `execute` is the
        elapsed time between CUDA events recorded on the dispatch stream at
        its first and last op, read only after the readback's own
        synchronize — it includes the device's idle gaps while the host
        launches (device busy time comes only from a KTPU_PROFILE trace);
        `readback` is the copy of the placements to the host. On the CPU
        the ops run inside the launch, so `execute` is 0. `token` is the
        wave's span: a watchdog-ABANDONED primary's zombie thread may
        finish minutes later and report its timings — keyed to its own
        (long-finished) span they can neither attach to a later wave's
        record nor clobber that wave's own pending reading."""
        if not self.enabled:
            return
        with self._mu:
            if len(self._device_split) >= 8:
                # stale entries from abandoned waves whose spans never
                # finished — drop them all rather than leak
                self._device_split.clear()
            self._device_split[token] = {
                "launch_s": round(launch, 6),
                "execute_s": round(execute, 6),
                "readback_s": round(readback, 6),
            }

    def finish_wave(self, span, *, stats=None, engine: str = "",
                    dims=None, rc: int = 0, micro: bool = False,
                    fleet: Optional[Dict[str, Any]] = None,
                    extra: Optional[Dict[str, Any]] = None) -> Optional[Dict]:
        """Close one wave: derive phase durations, feed the per-phase
        histograms, attach drained supervisor events + device split, ring
        the record, and auto-dump when a trigger event is present."""
        if not self.enabled or not getattr(span, "enabled", False):
            return None
        phases = span.phases()
        for phase, dt in phases:
            SCHEDULING_DURATION.observe(dt, operation=phase)
        with self._mu:
            events, self._pending_events = self._pending_events, []
            # this wave's own reading (or an untokened caller's); entries
            # keyed to OTHER spans are abandoned waves' zombie reports —
            # left behind and bounded-cleared by note_device_split
            split = self._device_split.pop(span, None) \
                or self._device_split.pop(None, None)
        rec: Dict[str, Any] = {
            "recorder": self.name,
            "t_start": round(span.trace.start, 6),
            "duration_s": round(span.trace.duration(), 6),
            "phases": [(p, round(dt, 6)) for p, dt in phases],
            "engine": engine,
            "rc": rc,
        }
        if micro:
            # micro-waves are first-class flight-recorder
            # citizens: the flag lets an incident reader separate the
            # streaming admissions from the bulk cadence at a glance
            rec["micro"] = True
        if dims is not None:
            rec["bucket"] = {"N": dims.N, "P": dims.P, "E": dims.E,
                             "D": dims.D}
        if stats is not None:
            rec["stats"] = {
                "attempted": stats.attempted,
                "scheduled": stats.scheduled,
                "unschedulable": stats.unschedulable,
                "bind_errors": stats.bind_errors,
                "aborted": stats.aborted,
                "requeued": getattr(stats, "requeued", 0),
                "degraded": getattr(stats, "degraded", 0),
                "shed": getattr(stats, "shed", 0),
            }
        if events:
            rec["supervisor_events"] = events
        if split is not None:
            rec["device_split"] = split
        if fleet is not None:
            rec["fleet"] = fleet
        if extra:
            rec.update(extra)
        self.recorder.record(rec)
        span.trace.log_if_long(self.slow_wave_threshold)
        present = {k for k, _ in events}
        trigger = next((t for t in DUMP_TRIGGERS if t in present), None)
        if trigger is not None:
            self.dump(trigger)
        return rec

    def snapshot_doc(self, trigger: str) -> Dict[str, Any]:
        """The dump DOCUMENT without the dump SIDE EFFECTS — what a
        read-only consumer (the /debug/flightrecorder endpoint) serves. A
        scrape loop must neither clobber `last_dump` (the incident
        artifact an auto-dump left behind), count as a dump, nor write
        KTPU_FLIGHT_DIR files."""
        doc = self.recorder.snapshot(trigger)
        doc["recorder"] = self.name
        q = self.latency_quantiles()
        doc["latency_p50_s"] = round(q[0.5], 6)
        doc["latency_p99_s"] = round(q[0.99], 6)
        return doc

    def dump(self, trigger: str, path: Optional[str] = None) -> Dict[str, Any]:
        """Snapshot the ring into one structured-JSON document. Written to
        `path` when given, else to KTPU_FLIGHT_DIR (one file per dump) when
        set; always retained as `last_dump` and counted per trigger.
        Side-effect-free while disabled: KTPU_TELEMETRY=0 must not let an
        unconditional call site (the takeover pass) clobber a prior
        incident artifact with an empty-ring document."""
        doc = self.snapshot_doc(trigger)
        if not self.enabled:
            return doc
        self.last_dump = doc
        self.dumps += 1
        FLIGHT_DUMPS.inc(trigger=trigger)
        if path is None:
            flight_dir = os.environ.get("KTPU_FLIGHT_DIR")
            if flight_dir:
                # KTPU_FLIGHT_GZIP: gzip auto-dumped artifacts (the bloat
                # knob for long soak runs; explicit `path` callers opt in
                # by passing a .gz path themselves)
                suffix = ".json.gz" if os.environ.get(
                    "KTPU_FLIGHT_GZIP", "") not in ("", "0") else ".json"
                path = os.path.join(
                    flight_dir,
                    f"flight-{self.name}-{trigger}-{doc['last_seq']}{suffix}")
        if path:
            try:
                _write_dump(doc, path)
            except OSError:
                pass  # a full disk must never take down the serving loop
        return doc

    # ------------------------------------------------------------------ #
    # tier 3: device-time profiling (KTPU_PROFILE)
    # ------------------------------------------------------------------ #

    def device_annotation(self, name: str):
        """Context for the serving thread around a supervised dispatch: a
        torch.profiler range when KTPU_PROFILE is set (starting the
        profiler lazily on first use, on this thread; where the installed
        torch supports it, every thread's ops are recorded), else a null
        context. The CUDA kernels of the dispatch run inside the range's
        time span. Never raises."""
        import contextlib

        if not self.enabled or self.profile_dir is None:
            return contextlib.nullcontext()
        try:
            import torch
            from torch.profiler import ProfilerActivity

            if self._profiler is None:
                acts = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(ProfilerActivity.CUDA)
                try:
                    cfg = torch._C._profiler._ExperimentalConfig(
                        profile_all_threads=True)
                    prof = torch.profiler.profile(activities=acts,
                                                  experimental_config=cfg)
                except Exception:  # noqa: BLE001 - older torch: this thread
                    prof = torch.profiler.profile(activities=acts)
                prof.start()
                self._profiler = prof
            return device_step_marker(name)
        except Exception:  # noqa: BLE001 - profiling must never break a wave
            return contextlib.nullcontext()

    def stop_profile(self) -> Optional[str]:
        """Stop the KTPU_PROFILE trace (on the thread that started it) and
        export it as a Chrome trace into the profile directory; returns the
        file's path, or None when nothing was profiled."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return None
        try:
            prof.stop()
            os.makedirs(self.profile_dir, exist_ok=True)
            path = os.path.join(self.profile_dir,
                                f"ktpu-{self.name}-{os.getpid()}.trace.json")
            prof.export_chrome_trace(path)
            return path
        except Exception:  # noqa: BLE001 - shutdown must never raise
            return None
