"""Dispatch supervisor: deadline watchdog, opt-in CPU degradation, GPU
re-admission (port of the JAX package's sched/supervisor.py).

Every device call the serving scheduler makes — the wave dispatch
(sched/cycle.py schedule_batch), the preemption burst (sched/preemption.py)
— runs under this supervisor, and the prewarmer's background warm reports
its failures here. The failure model: the device runtime can HANG
mid-dispatch, fail with a CUDA error, or run out of memory. None of those may
cost the cluster a pod.

Mechanics:

  * ``submit(kind, shape_key, fn, fallback)`` runs ``fn`` (dispatch +
    blocking readback) on a watchdog worker thread, under the scheduler's
    device (``torch.cuda.device``) and on the stream the scheduler names,
    and returns a handle; the caller overlaps host work and calls
    ``handle.result()``, which enforces a per-shape deadline. The deadline
    is budgeted per (kind, shape): the first call at a shape gets the cold
    budget (it may build and load kernels) unless the prewarmer already
    warmed that signature; later calls get ``mult × best-observed`` clamped
    to a floor (the ``KTPU_DISPATCH_*`` knobs), so a hang at a warm shape is
    detected in seconds.
  * A genuinely hung worker thread cannot be cancelled from Python — it is
    abandoned (daemon thread, result discarded). Work that the abandoned
    worker already queued on the dispatch stream still runs on the device,
    ahead of the next wave's work on that stream.
  * Failure classes: ``torch.cuda.OutOfMemoryError`` (and an injected
    ``device.oom``) is recoverable — the cached blocks are freed and the
    prober may re-admit the card. A kernel launch failure
    (ops/kernels.py KernelLaunchError) or any other CUDA error is sticky:
    the context is unusable, the backend is marked lost for good with one
    event naming the error, and no prober runs against it. A timeout or an
    injected ``device.error`` marks the backend unhealthy; a background
    prober re-admits it with exponential backoff (one tiny dispatch per
    probe) and re-warms the last cycle signature through the prewarmer.
  * **The one deliberate difference from the JAX package**, whose fallback
    always finds the XLA CPU backend: the port degrades only when the
    operator asks for it — the constructor's ``fallback_device="cpu"``.
    Without it a failed dispatch raises ``DispatchAbandonedError``; with it,
    a timed-out, failed or out-of-memory wave re-runs on the CPU, and while
    the card awaits re-admission every later call skips it and runs there.
    Each degraded wave is counted (``fallback_dispatches``,
    ``degraded_cycles``) and narrated to the flight record. A lost backend
    never degrades: after a kernel failed to launch, or the context died,
    every call abandons, fallback or not, so no work moves off the card
    because a kernel could not run on it.

Crash consistency is split with the scheduler: a wave either returns
placements or raises ``DispatchAbandonedError`` with NO partial effects
(assumes happen only after readback), and ``Scheduler.schedule_pending``
requeues the whole popped batch on abandonment.

Chaos seams (utils/faultline.py): ``device.hang`` / ``device.error`` /
``device.oom`` fire per supervised kind (sites ``cycle``, ``preempt``,
``prewarm``, ``probe``), ``device.fallback`` fails the fallback path.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..ops.kernels import KernelLaunchError
from ..utils import faultline
from ..utils.faultline import InjectedDeviceError


class DispatchAbandonedError(RuntimeError):
    """The primary dispatch failed and no fallback ran it (none configured,
    or the fallback failed too). The wave produced NO results and had NO
    side effects — the caller must requeue its inputs."""


def _classify(err: BaseException) -> Optional[str]:
    """How a dispatch failure bears on the backend: "oom" (recoverable
    after freeing the cached blocks), "error" (recoverable: the prober may
    re-admit), "lost" (a sticky CUDA error or a failed kernel launch: the
    context is unusable for the life of the process), or None — a bug in
    the dispatched function, which propagates to the caller unchanged."""
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return "oom"
    if isinstance(err, InjectedDeviceError):
        return "oom" if "RESOURCE_EXHAUSTED" in str(err) else "error"
    if isinstance(err, KernelLaunchError):
        return "lost"
    accel = getattr(torch, "AcceleratorError", None)
    if (accel is not None and isinstance(err, accel)) or (
            isinstance(err, RuntimeError) and "CUDA error" in str(err)):
        return "lost"
    return None


@dataclass
class SupervisorStats:
    """Operational counters, read by the chip smoke's phase 9 and tests."""

    watchdog_timeouts: int = 0
    device_errors: int = 0
    fallback_dispatches: int = 0
    degraded_cycles: int = 0          # cycle-kind dispatches served by fallback
    abandoned: int = 0                # no fallback, or it failed too
    probes: int = 0
    recoveries: int = 0
    rewarms: int = 0
    last_recovery_s: Optional[float] = None
    unhealthy_since: Optional[float] = None
    last_failure: str = ""
    lost: bool = False                # a sticky error: never re-admitted
    # wall seconds of fallback cycle dispatches — the degraded-mode latency
    degraded_cycle_seconds: List[float] = field(default_factory=list)


class _Handle:
    """One supervised dispatch in flight."""

    __slots__ = ("kind", "shape_key", "fallback", "deadline", "_done",
                 "_abandoned", "_result", "_error", "_t0", "_t_done", "sup",
                 "_primary_skipped")

    def __init__(self, sup: "DispatchSupervisor", kind: str, shape_key,
                 fallback, deadline: float):
        self.sup = sup
        self.kind = kind
        self.shape_key = shape_key
        self.fallback = fallback
        self.deadline = deadline
        self._done = threading.Event()
        # set when the watchdog gives up on the worker: a simulated hang
        # parks on this so the zombie exits promptly after abandonment
        self._abandoned = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._t0 = time.perf_counter()
        self._t_done: Optional[float] = None
        self._primary_skipped = False

    def _set_result(self, value: Any) -> None:
        self._t_done = time.perf_counter()
        self._result = value
        self._done.set()

    def _set_error(self, err: BaseException) -> None:
        self._t_done = time.perf_counter()
        self._error = err
        self._done.set()

    def result(self) -> Any:
        return self.sup._resolve(self)


class DispatchSupervisor:
    """Per-scheduler supervisor. Creates NO threads until a dispatch is
    submitted; the prober thread exists only while the backend is
    unhealthy (and not lost)."""

    def __init__(self, device: torch.device, prewarmer=None,
                 clock: Callable[[], float] = time.monotonic,
                 stream=None, fallback_device=None,
                 mesh_state=None) -> None:
        self.device = torch.device(device)
        # the serving mesh's lifecycle (parallel/mesh.py MeshState), or None
        self.mesh_state = mesh_state
        # the mesh a re-admission rewarms on when there is no MeshState to
        # reform (the fleet server sets it to its adopted mesh)
        self.mesh_provider: Optional[Callable[[], Any]] = None
        # the stream the worker dispatches on (None on the CPU)
        self.stream = stream
        self.prewarmer = prewarmer
        self.clock = clock
        # the operator's degrade target; None = abandon instead
        self.fallback_device = (torch.device(fallback_device)
                                if fallback_device is not None else None)
        # flight-recorder event sink (sched/telemetry.py
        # SchedulerTelemetry.note_supervisor_event); called from the serving
        # loop AND worker threads; a raising sink never takes the ladder down
        self.event_sink: Optional[Callable[[str, str], None]] = None
        self.stats = SupervisorStats()
        self._mu = threading.Lock()
        self._healthy = True
        # (kind, shape_key) → best observed successful primary duration
        self._budgets: Dict[Tuple[str, Any], float] = {}
        self._prober: Optional[threading.Thread] = None
        self._probe_worker: Optional[threading.Thread] = None
        # last cycle signature (dims, engine, extras, gang, rc) — what
        # re-warms on re-admission
        self._cycle_sig: Optional[Tuple] = None

    # ------------------------------------------------------------------ #
    # deadline budgets
    # ------------------------------------------------------------------ #

    def deadline_for(self, kind: str, shape_key) -> float:
        rec = self._budgets.get((kind, shape_key))
        if rec is None and not self._prewarmed(kind, shape_key):
            # cold: the call may build and load kernels
            return float(os.environ.get("KTPU_DISPATCH_COLD_DEADLINE", "900"))
        env = os.environ.get("KTPU_DISPATCH_DEADLINE")
        if env:
            return float(env)
        mult = float(os.environ.get("KTPU_DISPATCH_DEADLINE_MULT", "8"))
        floor = float(os.environ.get("KTPU_DISPATCH_DEADLINE_FLOOR", "10"))
        return max(floor, mult * rec) if rec is not None else floor

    def _prewarmed(self, kind: str, shape_key) -> bool:
        """A signature the prewarmer already warmed gets the warm budget on
        its first live call."""
        if self.prewarmer is None:
            return False
        if kind == "cycle":
            # a fleet dispatch's key carries the stack count K next, a mesh
            # dispatch its mesh signature after that
            dims, engine, extras, gang, rc, *rest = shape_key
            return self.prewarmer.lookup(
                dims, engine, extras, gang, rc=rc,
                fleet=rest[0] if rest else None,
                mesh=rest[1] if len(rest) > 1 else None)
        if kind == "preempt":
            return self.prewarmer.lookup_preempt(*shape_key)
        return False

    def _record_success(self, kind: str, shape_key, duration: float) -> None:
        with self._mu:
            key = (kind, shape_key)
            prev = self._budgets.get(key)
            self._budgets[key] = duration if prev is None \
                else min(prev, duration)

    # ------------------------------------------------------------------ #
    # health
    # ------------------------------------------------------------------ #

    @property
    def healthy(self) -> bool:
        return self._healthy

    def snapshot_device(self) -> torch.device:
        """Where cache snapshots go: the scheduler's device while healthy,
        the configured fallback while degraded — so a degraded wave is
        encoded onto the fallback from host staging and never reads the
        lost backend's buffers. A lost backend degrades nothing."""
        if self._healthy or self.fallback_device is None or self.stats.lost:
            return self.device
        return self.fallback_device

    def snapshot_mesh(self):
        """The mesh cache snapshots are sharded on: the live mesh while
        healthy, None while degraded (a degraded wave runs on one device —
        a collective over a mesh holding a failed device cannot
        complete)."""
        if not self._healthy or self.mesh_state is None:
            return None
        return self.mesh_state.mesh

    def note_cycle_signature(self, dims, engine: str, extras: tuple,
                             gang: bool, rc: int = 0, fleet=None) -> None:
        """Remember what the live cycle looks like so re-admission can warm
        exactly it (`fleet`: the tenant-stack count of a fleet dispatch)."""
        self._cycle_sig = (dims, engine, extras, gang, rc, fleet)

    def _emit(self, kind: str, detail: str = "") -> None:
        sink = self.event_sink
        if sink is None:
            return
        try:
            sink(kind, detail)
        except Exception:  # noqa: BLE001 - telemetry never breaks dispatch
            pass

    def _mark_unhealthy(self, reason: str, lost: bool = False) -> None:
        self._emit("degraded", f"backend lost: {reason}" if lost else reason)
        with self._mu:
            self.stats.last_failure = reason
            if lost:
                self.stats.lost = True
            if not self._healthy:
                return
            self._healthy = False
            self.stats.unhealthy_since = self.clock()
            # a mesh holding the failed device is wholly untrusted: drop it
            # now, so snapshot_mesh() routes the next waves to one device
            if self.mesh_state is not None:
                try:
                    self.mesh_state.on_backend_loss()
                except Exception:  # noqa: BLE001 - health flip must not die
                    pass
            # warm state may be tied to the lost backend: drop it; the
            # rewarm on re-admission repopulates
            if self.prewarmer is not None:
                try:
                    self.prewarmer.invalidate()
                except Exception:  # noqa: BLE001 - health flip must not die
                    pass
            if self.stats.lost:
                return  # a dead context: no prober spins against it
            t = threading.Thread(target=self._probe_loop,
                                 name="ktpu-backend-prober", daemon=True)
            self._prober = t
            t.start()

    def _probe_loop(self) -> None:
        """Re-admit the primary backend with exponential backoff."""
        backoff = float(os.environ.get("KTPU_PROBE_BACKOFF", "0.25"))
        cap = float(os.environ.get("KTPU_PROBE_BACKOFF_CAP", "30"))
        while not self._healthy and not self.stats.lost:
            time.sleep(backoff)
            self.stats.probes += 1
            if self._probe_once():
                self._readmit()
                return
            backoff = min(backoff * 2, cap)

    def _probe_once(self) -> bool:
        if faultline.should("device.hang", "probe") or \
                faultline.should("device.error", "probe"):
            return False
        prev = self._probe_worker
        if prev is not None and prev.is_alive():
            # the last probe is still wedged inside the runtime: that IS
            # the answer (still hung) — never leak a thread per round
            return False
        done = threading.Event()
        ok = [False]

        def probe() -> None:
            try:
                with self._on_device():
                    x = torch.ones((1,), dtype=torch.int32,
                                   device=self.device)
                    ok[0] = int((x + 1).item()) == 2
            except Exception:  # noqa: BLE001 - probe failure = still down
                pass
            finally:
                done.set()

        t = threading.Thread(target=probe, name="ktpu-probe-dispatch",
                             daemon=True)
        self._probe_worker = t
        t.start()
        done.wait(float(os.environ.get("KTPU_PROBE_DEADLINE", "10")))
        return ok[0]

    def _probe_mesh_full(self) -> bool:
        """Can the mesh come back at full width? One small all-reduce over
        every shard of the full-width mesh (parallel/axis.py spmd), on a
        worker under the probe deadline: a device that answers alone but
        cannot join the collective keeps the mesh narrow. The
        `mesh.degrade@probe` fault forces the narrow path."""
        if faultline.should("mesh.degrade", "probe"):
            return False
        done = threading.Event()
        ok = [False]

        def probe() -> None:
            try:
                from ..parallel import axis
                from ..parallel.mesh import make_mesh

                ms = self.mesh_state
                want = ms._requested or len(ms._pool)
                if want <= 1:
                    return
                m = make_mesh(ms._pow2_floor(min(want, len(ms._pool))),
                              devices=ms._pool)
                n = m.size

                def shard(r: int) -> int:
                    x = torch.tensor([r], dtype=torch.int32,
                                     device=m.devices[r])
                    return int(axis.current().all_reduce(x, "sum").item())

                totals = axis.spmd(m.devices, tuple(range(n)), n, shard)
                ok[0] = all(t == n * (n - 1) // 2 for t in totals)
            except Exception:  # noqa: BLE001 - probe failure = stay narrow
                pass
            finally:
                done.set()

        t = threading.Thread(target=probe, name="ktpu-mesh-full-probe",
                             daemon=True)
        t.start()
        done.wait(float(os.environ.get("KTPU_PROBE_DEADLINE", "10")))
        return ok[0]

    def _readmit(self) -> None:
        with self._mu:
            if self._healthy or self.stats.lost:
                return
            self._healthy = True
            self._emit("recovery", self.stats.last_failure)
            self.stats.recoveries += 1
            if self.stats.unhealthy_since is not None:
                self.stats.last_recovery_s = round(
                    self.clock() - self.stats.unhealthy_since, 3)
            self.stats.unhealthy_since = None
            sig = self._cycle_sig
        mesh = None
        if self.mesh_state is not None:
            # reform from the pool: full width when a whole-mesh collective
            # answers, else narrower. The Mesh object is new either way, so
            # the cache re-shards the resident planes from host staging.
            try:
                mesh = self.mesh_state.reform(full=self._probe_mesh_full())
            except Exception:  # noqa: BLE001 - one device is always a
                mesh = None    # legal landing spot
            self._emit("mesh_reform", f"width {mesh.size if mesh else 1}")
        elif self.mesh_provider is not None:
            try:
                mesh = self.mesh_provider()
            except Exception:  # noqa: BLE001 - rewarm is an optimization
                mesh = None
        if self.prewarmer is not None and sig is not None:
            dims, engine, extras, gang, rc, fleet = sig
            try:
                if self.prewarmer.rewarm(dims, engine=engine, extras=extras,
                                         gang=gang, rc=rc, fleet=fleet,
                                         mesh=mesh):
                    self.stats.rewarms += 1
                    self._emit("rewarm", f"{engine} rc={rc}")
            except Exception:  # noqa: BLE001 - rewarm is an optimization
                pass

    def note_compile_failure(self, exc: BaseException) -> None:
        """Called by the prewarmer's background warm: a device-class
        failure there is the same backend loss a dispatch would see."""
        self._note_failure(f"prewarm: {exc!r}", exc)

    def _note_failure(self, reason: str, exc: BaseException) -> bool:
        """Count and act on a device-class failure; False for a bug."""
        cls = _classify(exc)
        if cls is None:
            return False
        self.stats.device_errors += 1
        if cls == "oom" and self.device.type == "cuda":
            try:
                torch.cuda.empty_cache()
            except Exception:  # noqa: BLE001 - a dead allocator is loss
                cls = "lost"
        self._mark_unhealthy(reason, lost=cls == "lost")
        return True

    # ------------------------------------------------------------------ #
    # dispatch
    # ------------------------------------------------------------------ #

    def _on_device(self):
        """The worker's context: the scheduler's device and stream."""
        import contextlib

        stack = contextlib.ExitStack()
        if self.device.type == "cuda":
            stack.enter_context(torch.cuda.device(self.device))
            if self.stream is not None:
                stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def submit(self, kind: str, shape_key, fn: Callable[[], Any],
               fallback: Optional[Callable[..., Any]] = None) -> _Handle:
        """Start ``fn`` (dispatch + blocking readback) on a watchdog worker.
        Returns a handle; ``handle.result()`` enforces the deadline and runs
        the degradation ladder. While unhealthy the primary is skipped.

        ``fallback(device, hung)`` re-runs the work on the fallback device;
        ``hung=True`` means the primary's tensors are untouchable (a copy
        from a wedged runtime may block forever) — rebuild the inputs from
        host state instead of copying them."""
        deadline = self.deadline_for(kind, shape_key)
        h = _Handle(self, kind, shape_key, fallback, deadline)
        if not self._healthy:
            h._primary_skipped = True
            return h

        def work() -> None:
            try:
                if faultline.should("device.hang", kind):
                    # simulated mid-dispatch hang: park until the watchdog
                    # abandons us (plus a margin), then exit quietly
                    h._abandoned.wait(deadline + 30.0)
                    raise InjectedDeviceError(
                        f"injected device hang at {kind}")
                if faultline.should("device.error", kind):
                    raise InjectedDeviceError(
                        f"injected device error at {kind}")
                if faultline.should("device.oom", kind):
                    raise InjectedDeviceError(
                        f"RESOURCE_EXHAUSTED: injected device OOM at {kind}")
                with self._on_device():
                    h._set_result(fn())
            except BaseException as e:  # noqa: BLE001 - ferried to caller
                h._set_error(e)

        threading.Thread(target=work, name=f"ktpu-dispatch-{kind}",
                         daemon=True).start()
        return h

    def run(self, kind: str, shape_key, fn: Callable[[], Any],
            fallback: Optional[Callable[..., Any]] = None) -> Any:
        """Blocking convenience: submit + result."""
        return self.submit(kind, shape_key, fn, fallback).result()

    def _resolve(self, h: _Handle) -> Any:
        if h._primary_skipped:
            return self._run_fallback(h, reason="backend unhealthy")
        # the deadline counts from dispatch start, not from result(): the
        # caller's overlapped host work must neither extend a hang's
        # detection nor leak into the recorded warm budget
        remaining = h.deadline - (time.perf_counter() - h._t0)
        if not h._done.wait(max(remaining, 0.001)):
            h._abandoned.set()
            self.stats.watchdog_timeouts += 1
            self._emit("watchdog_timeout",
                       f"{h.kind} exceeded {h.deadline:.3g}s")
            self._mark_unhealthy(
                f"{h.kind} dispatch exceeded {h.deadline:.3g}s deadline")
            return self._run_fallback(
                h, reason=f"watchdog timeout after {h.deadline:.3g}s",
                hung=True)
        if h._error is not None:
            if self._note_failure(f"{h.kind}: {h._error!r}", h._error):
                return self._run_fallback(h, reason=repr(h._error))
            raise h._error  # a bug in fn, not a backend failure
        self._record_success(h.kind, h.shape_key,
                             (h._t_done or time.perf_counter()) - h._t0)
        return h._result

    def _run_fallback(self, h: _Handle, reason: str,
                      hung: bool = False) -> Any:
        dev = self.fallback_device
        if self.stats.lost:
            # a failed launch or a dead context: the work runs on the card
            # or not at all — abandoned, whatever fallback is configured
            self.stats.abandoned += 1
            self._emit("abandoned", f"{h.kind}: backend lost ({reason})")
            raise DispatchAbandonedError(
                f"{h.kind} dispatch abandoned ({reason}); a lost backend "
                f"never falls back")
        if h.fallback is None or dev is None:
            self.stats.abandoned += 1
            self._emit("abandoned", f"{h.kind}: no fallback ({reason})")
            raise DispatchAbandonedError(
                f"{h.kind} dispatch abandoned ({reason}); no fallback "
                f"configured")
        t0 = time.perf_counter()
        try:
            if faultline.should("device.fallback", h.kind):
                raise InjectedDeviceError(
                    f"injected fallback failure at {h.kind}")
            out = h.fallback(dev, hung)
        except Exception as e:  # noqa: BLE001 - the ladder ends here
            self.stats.abandoned += 1
            self._emit("abandoned",
                       f"{h.kind}: primary ({reason}), fallback ({e!r})")
            raise DispatchAbandonedError(
                f"{h.kind} dispatch abandoned: primary failed ({reason}), "
                f"fallback failed ({e!r})") from e
        self.stats.fallback_dispatches += 1
        self._emit("fallback", f"{h.kind}: {reason}")
        if h.kind == "cycle":
            self.stats.degraded_cycles += 1
            if len(self.stats.degraded_cycle_seconds) < 1024:
                self.stats.degraded_cycle_seconds.append(
                    round(time.perf_counter() - t0, 4))
        return out

    # ------------------------------------------------------------------ #
    # lifecycle helpers (tests / shutdown)
    # ------------------------------------------------------------------ #

    def wait_recovered(self, timeout: float = 10.0) -> bool:
        """Block until the prober re-admits the primary (tests)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._healthy:
                return True
            if self.stats.lost:
                return False
            time.sleep(0.02)
        return self._healthy
