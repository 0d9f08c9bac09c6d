"""Seam-level chaos fault injection (a copy of the JAX package's
utils/faultline.py: the same spec grammar and switchboard; its own process-
global injector, so a spec installed here never fires in the JAX package).

Production cluster schedulers are judged on what happens when the
infrastructure under them misbehaves: the device runtime hangs mid-dispatch,
the watch stream drops under a compaction storm, the apiserver restarts
between two requests. This module is the single switchboard those seams
consult, so the same build that serves traffic can be driven through every
failure mode deterministically — in tests, in the chaos bench stage, and in a
live canary via one environment variable.

Spec grammar (comma-separated entries in ``FAULT_SPEC``)::

    FAULT_SPEC="device.hang@cycle:3,watch.drop@0.1,store.cas_conflict@0.05,native.dlopen"

    entry     := fault [ "@" qualifier ]
    qualifier := site ":" N        fire exactly on the N-th should() call
                                   naming that site (one-shot)
               | site ":" N "+"    fire on every call at that site from the
                                   N-th on (persistent fault)
               | float in (0,1)    fire with that probability per call
                                   (seeded RNG — FAULT_SEED, default 0)
               | int N             fire exactly on the N-th call, any site
               | site              fire on every call at that site — the
                                   count is split off the RIGHT, so sites
                                   may themselves contain colons
                                   (proc.crash@wal:post_append:1 = the
                                   first hit at site "wal:post_append";
                                   wal.torn@tail = every hit at "tail")
    (no qualifier)                 fire on every call (e.g. native.dlopen)

    A qualifier segment that starts with a digit but parses as neither a
    count nor a probability (``wal:0.5`` missing its site, ``3x``) raises
    FaultSpecError instead of silently becoming a never-matching site.

Seams wired in this package (fault name → injection point):

    device.hang / device.error / device.oom   sched/supervisor.py (per-kind
                                              sites: cycle, preempt,
                                              prewarm, probe)
    device.fallback                           sched/supervisor.py fallback
                                              path (total-loss drills; only
                                              reached when a fallback
                                              device is configured)
    proc.crash                                sched/scheduler.py bind
                                              lifecycle + sched/ledger.py
                                              reconciliation (sites:
                                              pre_intent, post_intent,
                                              post_bind, takeover) — raises
                                              InjectedCrash, a BaseException
                                              that punches through every
                                              `except Exception` guard the
                                              way SIGKILL punches through a
                                              process (restart drills)

The hot-path contract: when no spec is installed, ``should()`` is one global
read and a ``None`` check — safe to call per storage CAS or per watch event.
"""

from __future__ import annotations

import os
import random
import re
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class InjectedDeviceError(RuntimeError):
    """Stand-in for a device runtime error raised by a chaos-injected device
    fault. The dispatch supervisor treats it exactly like the real thing."""


class InjectedCrash(BaseException):
    """Simulated abrupt process death (the SIGKILL analog) at a `proc.crash`
    crashpoint. Deliberately a BaseException: a real kill does not run
    `except Exception` recovery handlers, so neither does this — it unwinds
    straight out of the scheduling loop, leaving whatever durable state the
    crashed point had already committed (the bind-intent ledger, Binding
    writes) exactly as a power cut would. Restart drills catch it at the
    test/bench harness level and bring up a fresh scheduler incarnation."""


class FaultSpecError(ValueError):
    """Malformed FAULT_SPEC entry."""


_FLOAT_RE = re.compile(r"^0?\.\d+$|^0$|^1\.0$")


def _reject_numeric_site(entry: str, seg: str) -> None:
    """A would-be site segment that starts with a digit is a typo'd count or
    probability (proc.crash@wal:0.5, fault@3x) — no wired seam site begins
    with a digit. Installing it as an always-fire rule for a site that never
    matches would let a chaos drill pass without injecting anything, so
    refuse loudly instead."""
    if seg and seg[0].isdigit():
        raise FaultSpecError(
            f"{entry!r}: qualifier segment {seg!r} looks numeric but is not "
            "a valid count (N / N+) or probability in (0,1); site names "
            "never start with a digit")


@dataclass
class _Rule:
    fault: str
    site: str = ""          # "" = any site
    nth: int = 0            # 0 = not hit-count gated
    persistent: bool = False  # nth+: keep firing from the N-th hit on
    prob: float = 0.0       # 0 = not probability gated
    always: bool = False
    hits: int = 0           # should() calls matching this rule's site filter
    fired: int = 0


def parse_spec(spec: str) -> List[_Rule]:
    rules: List[_Rule] = []
    for raw in (spec or "").split(","):
        entry = raw.strip()
        if not entry:
            continue
        fault, _, qual = entry.partition("@")
        fault = fault.strip()
        if not fault:
            raise FaultSpecError(f"empty fault name in {entry!r}")
        if not qual:
            rules.append(_Rule(fault=fault, always=True))
        elif ":" in qual:
            # the count splits off the RIGHT so sites may contain colons
            # (proc.crash@wal:post_append:1); a qualifier whose final
            # segment is not a count is a bare colon-bearing SITE
            # (proc.crash@wal:post_append = always at that site)
            site, _, n = qual.rpartition(":")
            persistent = n.endswith("+")
            n = n[:-1] if persistent else n
            try:
                nth = int(n)
            except ValueError:
                _reject_numeric_site(entry, n)
                rules.append(_Rule(fault=fault, site=qual.strip(),
                                   always=True))
            else:
                rules.append(_Rule(fault=fault, site=site.strip(), nth=nth,
                                   persistent=persistent))
        elif _FLOAT_RE.match(qual):
            rules.append(_Rule(fault=fault, prob=float(qual)))
        else:
            try:
                nth = int(qual)
            except ValueError:
                # a bare site name (wal.torn@tail, disk.full@wal):
                # fire on every should() call naming that site
                _reject_numeric_site(entry, qual)
                rules.append(_Rule(fault=fault, site=qual.strip(),
                                   always=True))
            else:
                rules.append(_Rule(fault=fault, nth=nth))
    return rules


class FaultLine:
    """One parsed spec plus its firing state. Thread-safe: seams are consulted
    from the watch pump, reflector threads, the dispatch worker, and the
    scheduling loop concurrently."""

    def __init__(self, spec: str = "", seed: Optional[int] = None):
        self.spec = spec
        self._rules = parse_spec(spec)
        if seed is None:
            seed = int(os.environ.get("FAULT_SEED", "0") or 0)
        self._rng = random.Random(seed)
        self._mu = threading.Lock()

    def should(self, fault: str, site: str = "") -> bool:
        """Consult the spec for one potential fault at one seam. Increments
        hit counters for matching rules; returns True when any rule fires."""
        fire = False
        with self._mu:
            for r in self._rules:
                if r.fault != fault:
                    continue
                if r.site and r.site != site:
                    continue
                r.hits += 1
                hit = False
                if r.always:
                    hit = True
                elif r.nth:
                    hit = (r.hits >= r.nth if r.persistent
                           else r.hits == r.nth)
                elif r.prob:
                    hit = self._rng.random() < r.prob
                if hit:
                    r.fired += 1
                    fire = True
        return fire

    def fired(self, fault: str, site: str = "") -> int:
        """Total firings for a fault (optionally one site) — test assertions
        read this to prove the seam was actually exercised."""
        with self._mu:
            return sum(r.fired for r in self._rules
                       if r.fault == fault and (not site or r.site == site))

    def counts(self) -> Dict[str, int]:
        with self._mu:
            out: Dict[str, int] = {}
            for r in self._rules:
                key = f"{r.fault}@{r.site}" if r.site else r.fault
                out[key] = out.get(key, 0) + r.fired
            return out


# ---- process-global switchboard ---------------------------------------- #

_active: Optional[FaultLine] = None
_install_mu = threading.Lock()


def install(spec: Optional[str] = None, seed: Optional[int] = None) -> FaultLine:
    """Install a FaultLine as the process-global injector. spec=None reads
    FAULT_SPEC from the environment (empty env → inactive no-op line)."""
    global _active
    if spec is None:
        spec = os.environ.get("FAULT_SPEC", "")
    with _install_mu:
        _active = FaultLine(spec, seed=seed)
        return _active


def uninstall() -> None:
    global _active
    with _install_mu:
        _active = None


def active() -> Optional[FaultLine]:
    return _active


def should(fault: str, site: str = "") -> bool:
    """The seam entry point. Near-zero cost when no injector is installed."""
    fl = _active
    return fl is not None and fl.should(fault, site)


def crashpoint(site: str) -> None:
    """A `proc.crash@site` seam in the bind lifecycle: when the spec names
    this site, the process "dies" here (InjectedCrash). Sites wired:
    pre_intent / post_intent / post_bind (sched/scheduler.py wave commit)
    and takeover (sched/ledger.py reconciliation replay)."""
    if should("proc.crash", site):
        raise InjectedCrash(f"proc.crash@{site}")


# env-driven startup: a process launched with FAULT_SPEC set is under chaos
# from its first request, no code change required
if os.environ.get("FAULT_SPEC"):
    install()
