"""Scheduler telemetry, disabled path only.

The JAX package's sched/telemetry.py records per-wave phase spans, a
flight-recorder ring, watch→bind latency and the dispatch's device-time
split; with KTPU_TELEMETRY=0 every one of those calls does nothing. The port
keeps that disabled path — the same call sites in sched/scheduler.py, no
records — until real spans (torch.profiler ranges, CUDA events) are ported
(ROADMAP A10). Nothing here reads a clock or touches the device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class _NullSpan:
    """No-op span when telemetry is disabled (KTPU_TELEMETRY=0)."""

    __slots__ = ()
    enabled = False

    def mark(self, name: str) -> None:  # noqa: ARG002 - interface
        pass


_NULL_SPAN = _NullSpan()


class NullTelemetry:
    """The SchedulerTelemetry interface with every method a no-op — what the
    JAX package's scheduler runs under KTPU_TELEMETRY=0."""

    def wave_span(self, name: str = "wave") -> _NullSpan:  # noqa: ARG002
        return _NULL_SPAN

    def note_supervisor_event(self, kind: str, detail: str = "") -> None:
        pass

    def record_bound_many(self, keys, now: float) -> int:  # noqa: ARG002
        return 0

    def finish_wave(self, span, **_kw) -> Optional[Dict[str, Any]]:
        return None
