"""Bounds-checked parsing for integer env knobs.

Every integer knob the scheduler or bench reads from the environment
(`KTPU_FLEET_TENANTS`, `KTPU_MESH`, `KTPU_FLEET_NODE_SHARDS`, bench shape
overrides, …) routes through one clamp helper — the
`storage/store._parse_watch_buffer` discipline generalized: garbage or an
unset value falls back to the default, out-of-range values clamp to a sane
range, and nothing ever crashes `int()` or builds a degenerate (0- or
negative-sized) mesh because an operator exported `KTPU_FLEET_TENANTS=lots`.
"""

from __future__ import annotations

import os
from typing import Optional


def clamped_int(value, default: int, lo: int, hi: int) -> int:
    """`value` as an int clamped to [lo, hi]; `default` (also clamped) when
    value is None, empty, or not an integer literal."""
    try:
        n = int(str(value).strip())
    except (TypeError, ValueError):
        n = default
    return max(lo, min(hi, n))


def env_int(name: str, default: int, lo: int, hi: int) -> int:
    """The env knob `name` parsed through `clamped_int`. Unset → default."""
    return clamped_int(os.environ.get(name), default, lo, hi)


def env_opt_int(name: str, lo: int, hi: int) -> Optional[int]:
    """Like `env_int` but unset/garbage → None (knob not configured) rather
    than a numeric default — for knobs whose absence selects a different
    code path entirely (e.g. `KTPU_MESH` unset = single-device serving)."""
    raw = os.environ.get(name)
    if raw is None or not str(raw).strip():
        return None
    try:
        n = int(str(raw).strip())
    except (TypeError, ValueError):
        return None
    return max(lo, min(hi, n))
