"""What the per-layer readers share: the scheduler's own wave spans
(sched/telemetry.py flight records: pump, pop, snapshot, prewarm, dispatch,
readback, intent-write, bind-commit, retire, requeue), read from every
window wave the profiler did not slow."""

from __future__ import annotations

from typing import Iterable, Optional


def window_waves(ctx: dict, traffic: str):
    if ctx["traffic"] != traffic:
        return None
    return [w for w in ctx["window_waves"]
            if w.get("record") and not w.get("traced")]


def span_ms(ctx: dict, traffic: str, phases: Iterable[str],
            events: bool = False) -> Optional[float]:
    """The phases' total over the window's waves ÷ the waves, in ms; with
    `events`, plus the seconds the harness spent inside the scheduler's
    event handlers (on_pod_add, on_pod_delete) for each wave."""
    waves = window_waves(ctx, traffic)
    if not waves:
        return None
    phases = set(phases)
    total = sum(dt for w in waves for p, dt in w["record"]["phases"]
                if p in phases)
    if events:
        total += sum(w["events_s"] for w in waves)
    return total / len(waves) * 1e3


def roofline_pct(ctx: dict, traffic: str, kernel: str) -> Optional[float]:
    """100 × the kernel's least time (the larger of its bytes and
    operations bounds) ÷ its device time, per launch, over the traced
    stretch; None where it did not launch there."""
    prof = ctx.get("profile")
    if ctx["traffic"] != traffic or not prof or not prof.get(kernel):
        return None
    k = prof[kernel]
    return 100.0 * k["bound_s"] / k["device_s"]


def idle_pct(ctx: dict, traffic: str) -> Optional[float]:
    prof = ctx.get("profile")
    if ctx["traffic"] != traffic or not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
