"""Overload governor: priority-aware shedding, adaptive wave sizing, and
commit-path circuit breaking under storm traffic.

The measurement substrate (queue-depth gauges, per-pod e2e
latency, per-wave phase spans, flight recorder) told us *when* the control
plane was drowning; this module is what *acts* on those signals. Three
cooperating mechanisms, all consulted once per serving wave from
`Scheduler.schedule_pending` (and per tenant from `FleetServer.tick`):

**1. Graded brownout modes with hysteresis** (`OverloadGovernor`)::

    NORMAL ──enter──▶ SHED_LOW ──enter──▶ TRICKLE
       ▲                 │                   │
       └───exit (dwell)──┴──exit (dwell)─────┘

  * NORMAL    — pass-through; the governor provably changes nothing
                (the KTPU_OVERLOAD=0 bit-equality acceptance).
  * SHED_LOW  — pods below `shed_priority_cutoff` are PARKED in the
                queue's deferred lane (never dropped, never failed);
                high-priority pods keep flowing bit-for-bit through the
                unchanged pipeline. Parked pods re-admit in one batch
                when the governor exits shedding (plus a safety flush in
                `queue.pump` so a wedged governor can never strand them).
  * TRICKLE   — minimal waves (`trickle_wave`) so each cycle stays cheap
                while the breaker's commit probes test the path.

  Enter thresholds sit ABOVE exit thresholds (classic hysteresis) and
  exits additionally require `exit_dwell_s` of continuous health, so a
  storm that oscillates around a threshold cannot flap the mode.

**2. Adaptive wave sizing.** Under deadline pressure (observed wave
  seconds > `target_cycle_s`) the pending bucket shrinks by powers of two
  toward `min_wave`, bounding cycle time so the control loop keeps
  sampling its signals; sustained healthy waves grow it back toward the
  configured batch. Limits are quantized to the power-of-two ladder the
  Dims bucketing already compiles (state/dims.py `bucket`), and shrunk
  waves stay inside the SAME (P-floored) bucket signature, so mode shifts
  reuse prewarmed executables and never cold-compile on-path.

**3. Commit-path circuit breaker** (`CommitBreaker`). Every Binding
  commit's outcome + latency feeds it. It OPENS on `fail_threshold`
  consecutive failures or an EWMA latency above `latency_slo_s`; while
  open the scheduler PAUSES dispatch entirely — no device time burned on
  waves whose bindings can't land, and since intents are written only
  when the breaker permits commit, the bind-intent ledger is never
  orphaned by a brownout. After `cooldown_s` it goes HALF_OPEN and admits
  one trickle-sized probe wave; consecutive probe successes close it,
  any probe failure re-opens with doubled (capped) cooldown.

Every mode/breaker transition is narrated into the flight recorder via
the `event_sink` hook (`mode` / `breaker_open` / `breaker_close` events;
`breaker_open` is a ring-dump trigger), and mirrored into the
`scheduler_overload_*` metrics — a brownout is explainable from the
artifact, not from logs.

Kill switch: ``KTPU_OVERLOAD=0`` builds no governor at all — the wave
pipeline is byte-for-byte the pre-governor code path.

Fleet: each `FleetTenant`'s Scheduler owns its OWN governor (built in
`Scheduler.__init__`), so one tenant's storm sheds only that tenant —
composing with, not replacing, the DRF quota clamp.

Clock domain: the governor runs on the SCHEDULER'S injected clock, so
deterministic-clock tests drive the hysteresis windows exactly.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

# mode ladder, mild → severe (index IS the severity used for metrics)
NORMAL = "NORMAL"
SHED_LOW = "SHED_LOW"
TRICKLE = "TRICKLE"
MODES = (NORMAL, SHED_LOW, TRICKLE)

# breaker states
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


def overload_enabled() -> bool:
    """The KTPU_OVERLOAD kill switch (default on). When off, Scheduler
    builds NO governor and the wave path is the exact pre-governor code."""
    return os.environ.get("KTPU_OVERLOAD", "1") not in ("0", "off")


@dataclass
class OverloadConfig:
    """Thresholds for the mode ladder, the wave sizer and the breaker.
    Defaults are deliberately conservative: a healthy scheduler (every
    tier-1 test, every pre-existing bench stage) never leaves NORMAL."""

    # -- mode ladder (hysteresis: enter > exit, exits need dwell) -- #
    # queue-pressure units: multiples of the configured batch size
    # (active + backoff depth / batch_size)
    shed_enter_pressure: float = 6.0
    shed_exit_pressure: float = 1.0
    trickle_enter_pressure: float = 24.0
    trickle_exit_pressure: float = 6.0
    exit_dwell_s: float = 2.0          # continuous health before stepping down
    # pods with priority < cutoff are sheddable (defer, never drop);
    # pods at/above it are ALWAYS admitted
    shed_priority_cutoff: int = 1

    # -- adaptive wave sizing -- #
    target_cycle_s: float = 5.0        # deadline pressure reference
    min_wave: int = 64
    trickle_wave: int = 64
    grow_after_waves: int = 2          # healthy waves before growing back
    # ladder ascent needs BOTH queue pressure and this many consecutive
    # over-deadline waves (a bulk backlog drained at full speed has high
    # pressure but healthy cycles — that is throughput, not overload;
    # likewise one cold-compile wave is a compile, not a brownout)
    slow_streak: int = 3

    # -- commit-path circuit breaker -- #
    fail_threshold: int = 5            # consecutive commit failures → OPEN
    latency_slo_s: float = 5.0         # commit-latency EWMA breach → OPEN
    latency_min_samples: int = 8
    cooldown_s: float = 2.0            # OPEN → HALF_OPEN wait (doubles on
    cooldown_cap_s: float = 30.0       # re-open, capped)
    probe_successes: int = 3           # HALF_OPEN probes needed to close


@dataclass
class WaveDecision:
    """What one serving wave may do, decided before its pop."""

    mode: str = NORMAL
    dispatch_allowed: bool = True      # False = breaker OPEN: pause, no pop
    wave_limit: Optional[int] = None   # None = the configured batch size
    shed_below: Optional[int] = None   # park pods with priority < this
    release_deferred: bool = False     # shedding over: re-admit the lane
    probe: bool = False                # HALF_OPEN trickle probe wave


class CommitBreaker:
    """Three-state circuit breaker over the Binding commit path. Not
    thread-safe on its own — called under the scheduler's wave lock, in
    the scheduler's clock domain."""

    def __init__(self, cfg: OverloadConfig,
                 clock: Callable[[], float] = time.monotonic,
                 sink: Optional[Callable[[str, str], None]] = None,
                 name: str = "scheduler"):
        self.cfg = cfg
        self.clock = clock
        self.sink = sink               # (kind, detail) → flight recorder
        self.name = name               # metric `governor` label
        self.state = CLOSED
        self.consecutive_failures = 0
        self.latency_ewma = 0.0
        self._samples = 0
        self._cooldown = cfg.cooldown_s
        self._open_until = 0.0
        self._half_open_oks = 0
        self.opens = 0
        self.closes = 0
        self.last_reason = ""

    def _transition(self, state: str, reason: str) -> None:
        if state == self.state:
            return
        prev, self.state = self.state, state
        self.last_reason = reason
        if state == OPEN:
            self.opens += 1
        elif state == CLOSED:
            self.closes += 1
        from .metrics import BREAKER_STATE, BREAKER_TRANSITIONS

        BREAKER_TRANSITIONS.inc(governor=self.name, to=state)
        BREAKER_STATE.set({CLOSED: 0, HALF_OPEN: 1, OPEN: 2}[state],
                          governor=self.name)
        if self.sink is not None:
            kind = "breaker_open" if state == OPEN else "breaker_close" \
                if state == CLOSED else "breaker_half_open"
            self.sink(kind, f"{prev}->{state}: {reason}")

    def note(self, ok: bool, latency_s: float) -> None:
        """One commit outcome (Binding write success/failure + wall time),
        from `Scheduler._commit`. Drives every state change except the
        cooldown expiry (which `allow()` applies lazily)."""
        self._samples += 1
        a = 0.3  # EWMA weight: reactive but not single-sample twitchy
        self.latency_ewma = latency_s if self._samples == 1 \
            else a * latency_s + (1 - a) * self.latency_ewma
        if ok:
            self.consecutive_failures = 0
            if self.state == HALF_OPEN:
                if latency_s > self.cfg.latency_slo_s:
                    # a slow-but-successful probe is NOT recovery: the
                    # commit path is still degraded — back off harder.
                    # Judged on the SAMPLE, not the EWMA: the EWMA is
                    # still polluted by the brownout and would hold the
                    # breaker open long after the path got fast.
                    self._cooldown = min(self._cooldown * 2,
                                         self.cfg.cooldown_cap_s)
                    self._open(f"probe commit slow "
                               f"({latency_s:.2f}s > SLO)")
                    return
                self._half_open_oks += 1
                if self._half_open_oks >= self.cfg.probe_successes:
                    self._cooldown = self.cfg.cooldown_s
                    # the probes prove the live path is fast again — the
                    # brownout's EWMA must not re-open a healthy breaker
                    self.latency_ewma = latency_s
                    self._transition(
                        CLOSED, f"{self._half_open_oks} probe commits ok")
            elif self.state == CLOSED and self._breached_slo():
                self._open(f"commit latency EWMA "
                           f"{self.latency_ewma:.2f}s > SLO "
                           f"{self.cfg.latency_slo_s}s")
            return
        self.consecutive_failures += 1
        if self.state == HALF_OPEN:
            self._cooldown = min(self._cooldown * 2,
                                 self.cfg.cooldown_cap_s)
            self._open("probe commit failed")
        elif self.state == CLOSED and (
                self.consecutive_failures >= self.cfg.fail_threshold
                or self._breached_slo()):
            self._open(f"{self.consecutive_failures} consecutive commit "
                       "failures")

    def _breached_slo(self) -> bool:
        return (self._samples >= self.cfg.latency_min_samples
                and self.latency_ewma > self.cfg.latency_slo_s)

    def _open(self, reason: str) -> None:
        self._open_until = self.clock() + self._cooldown
        self._half_open_oks = 0
        self._transition(OPEN, reason)

    def allow(self, now: float) -> Tuple[bool, bool]:
        """(dispatch allowed, is a half-open probe). OPEN past its
        cooldown steps to HALF_OPEN and admits one probe wave."""
        if self.state == CLOSED:
            return True, False
        if self.state == OPEN and now >= self._open_until:
            self._transition(HALF_OPEN, "cooldown expired")
        if self.state == HALF_OPEN:
            return True, True
        return False, False


class OverloadGovernor:
    """One per Scheduler (fleet: one per tenant). Consulted at the top of
    every wave (`begin_wave`), fed at the bottom (`end_wave`) and per
    commit (`note_commit`). All calls run under the scheduler's wave
    lock, in the scheduler's clock domain."""

    def __init__(self, batch_size: int,
                 cfg: Optional[OverloadConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 event_sink: Optional[Callable[[str, str], None]] = None,
                 name: str = "scheduler"):
        self.cfg = cfg or OverloadConfig()
        self.batch_size = max(int(batch_size), 1)
        self.clock = clock
        self.event_sink = event_sink
        self.name = name
        self.mode = NORMAL
        self.breaker = CommitBreaker(self.cfg, clock=clock,
                                     sink=self._emit, name=name)
        self.transitions: List[Tuple[float, str, str, str]] = []
        self.mode_transitions = 0
        self.shed_total = 0
        self.paused_waves = 0
        self._wave_limit = self.batch_size
        self._healthy_waves = 0
        self._healthy_since: Optional[float] = None
        self._slow_streak = 0
        # ingest-rate estimate (events/s) from successive depth samples:
        # rate ≈ (Δ depth + pods the wave consumed) / Δt — the governor's
        # own view of the watch-ingest signal, no informer hook needed
        self._last_depth: Optional[int] = None
        self._last_t: Optional[float] = None
        self._consumed = 0
        self.ingest_rate = 0.0

    # ------------------------------------------------------------------ #
    # transitions + narration
    # ------------------------------------------------------------------ #

    def _emit(self, kind: str, detail: str) -> None:
        if self.event_sink is not None:
            self.event_sink(kind, detail)

    def _set_mode(self, mode: str, reason: str) -> None:
        if mode == self.mode:
            return
        prev, self.mode = self.mode, mode
        self.mode_transitions += 1
        self.transitions.append((self.clock(), prev, mode, reason))
        from .metrics import MODE_TRANSITIONS, OVERLOAD_MODE

        MODE_TRANSITIONS.inc(governor=self.name, to=mode)
        OVERLOAD_MODE.set(MODES.index(mode), governor=self.name)
        self._emit("mode", f"{prev}->{mode}: {reason}")

    # ------------------------------------------------------------------ #
    # the per-wave control loop
    # ------------------------------------------------------------------ #

    def _pressure(self, depths: Dict[str, int]) -> float:
        """Queue pressure in wave-capacity units: how many FULL waves the
        live backlog (active + backoff — deferred is already parked and
        unschedulable waits on cluster events, not capacity) represents."""
        return (depths.get("active", 0)
                + depths.get("backoff", 0)) / self.batch_size

    def begin_wave(self, now: float,
                   depths: Dict[str, int]) -> WaveDecision:
        """Mode ladder + breaker gate + wave limit for the wave about to
        pop. Called once per `schedule_pending`."""
        cfg = self.cfg
        pressure = self._pressure(depths)
        self._observe_ingest(now, depths)

        # ---- ladder ascent: a breaker trip ascends immediately; queue
        # pressure ascends only when the deadline streak proves the
        # backlog is OUTRUNNING the waves (a bulk drain at full speed has
        # high pressure but healthy cycles — throughput, not overload) --- #
        breaker_open = self.breaker.state == OPEN
        falling_behind = self._slow_streak >= cfg.slow_streak
        if self.mode != TRICKLE and (
                breaker_open or (falling_behind
                                 and pressure >= cfg.trickle_enter_pressure)):
            self._set_mode(
                TRICKLE,
                "breaker open" if breaker_open else
                f"pressure {pressure:.1f} >= {cfg.trickle_enter_pressure} "
                f"with {self._slow_streak} slow waves")
            self._healthy_since = None
        elif self.mode == NORMAL and falling_behind \
                and pressure >= cfg.shed_enter_pressure:
            self._set_mode(
                SHED_LOW,
                f"pressure {pressure:.1f} >= {cfg.shed_enter_pressure} "
                f"with {self._slow_streak} slow waves")
            self._healthy_since = None

        # ---- ladder descent (hysteresis: below exit threshold AND
        # breaker closed, sustained for the dwell) ---- #
        release = False
        exit_bound = (cfg.trickle_exit_pressure if self.mode == TRICKLE
                      else cfg.shed_exit_pressure)
        healthy = (self.mode != NORMAL
                   and pressure < exit_bound
                   and self.breaker.state == CLOSED)
        if healthy:
            if self._healthy_since is None:
                self._healthy_since = now
            if now - self._healthy_since >= cfg.exit_dwell_s:
                prev = self.mode
                self._set_mode(
                    SHED_LOW if prev == TRICKLE else NORMAL,
                    f"pressure {pressure:.1f} < {exit_bound} for "
                    f"{cfg.exit_dwell_s}s")
                self._healthy_since = None
                # leaving shedding entirely: re-admit the deferred lane
                release = self.mode == NORMAL
        else:
            self._healthy_since = None

        # ---- breaker gate ---- #
        allowed, probe = self.breaker.allow(now)
        if not allowed:
            self.paused_waves += 1
            return WaveDecision(mode=self.mode, dispatch_allowed=False,
                                release_deferred=release)

        limit = self._wave_limit
        if probe or self.mode == TRICKLE:
            limit = min(limit, self.cfg.trickle_wave)
        # a HALF_OPEN probe never sheds: it exists to push commits through
        # the path under test, and with an all-low-priority backlog a
        # shedding probe would have nothing to probe with — the breaker
        # could never close. The probe is trickle-sized anyway.
        shed = self.cfg.shed_priority_cutoff \
            if self.mode in (SHED_LOW, TRICKLE) and not probe else None
        return WaveDecision(mode=self.mode, wave_limit=limit,
                            shed_below=shed, release_deferred=release,
                            probe=probe)

    def _observe_ingest(self, now: float, depths: Dict[str, int]) -> None:
        depth = depths.get("active", 0) + depths.get("backoff", 0)
        if self._last_depth is not None and self._last_t is not None:
            dt = now - self._last_t
            if dt > 0:
                arrived = max(depth - self._last_depth, 0) + self._consumed
                rate = arrived / dt
                self.ingest_rate = rate if self.ingest_rate == 0.0 \
                    else 0.3 * rate + 0.7 * self.ingest_rate
        self._last_depth, self._last_t, self._consumed = depth, now, 0

    def end_wave(self, now: float, attempted: int,
                 cycle_seconds: float, micro: bool = False) -> None:
        """Deadline-streak tracking + adaptive wave sizing. Sizing only
        acts while BROWNED OUT (mode != NORMAL): in NORMAL the governor is
        a pure observer, so healthy runs stay bit-equal to the pre-
        governor pipeline. Limits move on the power-of-two ladder the
        Dims bucketing compiles, so a grown-back wave lands on a bucket
        signature that is already warm (shrunk waves stay inside the
        P-floored bucket — no recompile in either direction).

        `micro=True` (micro-waves) feeds the ingest estimate —
        micro-consumed pods are real consumption — but is FENCED OUT of
        the deadline streak and the sizer: a micro wave is sub-cycle by
        construction, so its timing says nothing about whether BULK waves
        meet the deadline; letting it clear the slow streak (or bank
        healthy-wave credit) would mask a bulk brownout behind a stream
        of fast micro admissions."""
        del now  # symmetry with begin_wave; sizing is wave-count paced
        self._consumed += attempted
        cfg = self.cfg
        if attempted == 0 or micro:
            return
        slow = cycle_seconds > cfg.target_cycle_s
        self._slow_streak = self._slow_streak + 1 if slow else 0
        if self.mode == NORMAL:
            self._wave_limit = self.batch_size
            self._healthy_waves = 0
            return
        if slow:
            shrunk = max(cfg.min_wave, self._wave_limit // 2)
            if shrunk != self._wave_limit:
                self._wave_limit = shrunk
                self._emit("wave_resize",
                           f"shrink->{shrunk} (cycle {cycle_seconds:.2f}s "
                           f"> target {cfg.target_cycle_s}s)")
            self._healthy_waves = 0
        elif cycle_seconds < 0.5 * cfg.target_cycle_s \
                and self._wave_limit < self.batch_size:
            self._healthy_waves += 1
            if self._healthy_waves >= cfg.grow_after_waves:
                grown = min(self.batch_size, self._wave_limit * 2)
                self._wave_limit = grown
                self._healthy_waves = 0
                self._emit("wave_resize", f"grow->{grown}")

    def note_commit(self, ok: bool, latency_s: float) -> None:
        self.breaker.note(ok, latency_s)

    def commit_allowed(self) -> bool:
        """Mid-wave gate: False the moment the breaker opens, so a wave
        whose own commits tripped it stops burning the commit path and
        requeues its remainder promptly."""
        return self.breaker.state != OPEN

    def note_shed(self, n: int) -> None:
        if n <= 0:
            return
        self.shed_total += n
        from .metrics import SHED_PODS

        SHED_PODS.inc(n, governor=self.name)

    # ------------------------------------------------------------------ #
    # introspection (bench/tests/flight recorder)
    # ------------------------------------------------------------------ #

    def wave_limit(self) -> int:
        return self._wave_limit

    def snapshot(self) -> Dict[str, object]:
        return {
            "mode": self.mode,
            "wave_limit": self._wave_limit,
            "breaker": self.breaker.state,
            "breaker_opens": self.breaker.opens,
            "breaker_closes": self.breaker.closes,
            "mode_transitions": self.mode_transitions,
            "shed_total": self.shed_total,
            "paused_waves": self.paused_waves,
            "ingest_rate": round(self.ingest_rate, 1),
        }


def build_governor(batch_size: int, clock, event_sink,
                   name: str = "scheduler",
                   cfg: Optional[OverloadConfig] = None
                   ) -> Optional[OverloadGovernor]:
    """The Scheduler's construction seam: None when KTPU_OVERLOAD=0 —
    the kill switch restores the exact pre-governor wave pipeline."""
    if not overload_enabled():
        return None
    return OverloadGovernor(batch_size, cfg=cfg, clock=clock,
                            event_sink=event_sink, name=name)
