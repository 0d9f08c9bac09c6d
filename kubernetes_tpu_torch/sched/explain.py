"""Decision provenance, host side (port of the JAX package's
sched/explain.py): render the device attribution reduction (ops/assign.py
`explain_assignments` — per-predicate rejected-node counts for
unschedulable pods, the winning node's score decomposition for scheduled
ones) into operator-facing surfaces:

  * kube-style FailedScheduling messages — "0/5000 nodes are available:
    3200 Insufficient resources, 1800 node(s) had taints …" — deduped and
    rate-limited per (pod, reason-fingerprint) EventCorrelator-style (first
    occurrence emits, then exponential backoff by occurrence count), and
    written as v1 Events through any client with the apiserver client's
    event calls (`client.events.create/get/update`) under a retry budget
    (429/503 absorbed, everything else fails fast — `APIEventSink`);
  * the `scheduler_unschedulable_reasons_total{predicate}` /
    `scheduler_scheduled_score_share{component}` metric series;
  * the wave record: `observe_wave`'s return value rides the telemetry's
    `finish_wave(extra=...)` into the flight recorder;
  * the why-pending surface: `why(key)` returns the pod's latest
    attribution (served over HTTP at /debug/why/<ns>/<pod> by
    sched/server.py TelemetryGateway).

Kill switch: ``KTPU_EXPLAIN`` (default off — `build_explainer` returns None
and the wave dispatch runs without the attribution). The
KubeSchedulerConfiguration `decisionProvenance: true` flag enables it per
process without the env (`Scheduler.enable_explain`).
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..client.rest import RetryPolicy, status_code
from ..ops.assign import EXPLAIN_PREDICATES, EXPLAIN_SCORE_COMPONENTS
from .metrics import FAILED_EVENTS, SCORE_SHARE, UNSCHEDULABLE_REASONS

#: kube-flavored reason text per predicate plane (error.go ErrReason*) —
#: what the FailedScheduling message renders per nonzero count
REASON_TEXT = {
    "node_match": "node(s) didn't match node selector",
    "taints": "node(s) had taints that the pod didn't tolerate",
    "fit": "Insufficient resources",
    "ports": "node(s) didn't have free ports for the requested pod ports",
    "affinity": "node(s) didn't match pod affinity rules",
    "anti": "node(s) didn't satisfy inter-pod anti-affinity rules",
    "spread": "node(s) didn't match pod topology spread constraints",
    "host": "node(s) didn't match the requested hostname",
    "volumes": "node(s) had volume conflicts or exceeded volume limits",
}


def render_unschedulable(valid_nodes: int, reasons: Dict[str, int],
                         feasible_nodes: int = 0) -> str:
    """The FailedScheduling message body. Predicate-unschedulable
    (feasible_nodes == 0): kube-style '0/N nodes are available: <count>
    <reason>, …' with reasons ordered count-desc (the dominant predicate
    leads) then name for determinism. Pods that are individually FEASIBLE
    but still came back node == -1 (group-atomic gang rejection, same-wave
    contention) must NOT claim 'zero nodes available' — the message says
    what actually happened."""
    if feasible_nodes > 0:
        return (f"{feasible_nodes}/{valid_nodes} nodes are available but "
                f"the pod was not admitted this wave (group-atomic gang "
                f"admission or same-wave contention); it will retry.")
    parts = [f"{c} {REASON_TEXT.get(p, p)}"
             for p, c in sorted(reasons.items(), key=lambda kv: (-kv[1], kv[0]))
             if c > 0]
    if not parts:
        return f"0/{valid_nodes} nodes are available."
    return f"0/{valid_nodes} nodes are available: " + ", ".join(parts) + "."


def reason_fingerprint(reasons: Dict[str, int],
                       feasible_nodes: int = 0) -> str:
    """Dedupe key for a pod's failure shape: the SET of rejecting predicates
    plus the dominant one — count jitter between waves (a node drained, two
    more filled) must not defeat the correlator, while a genuinely new
    failure mode (taints appeared where fit dominated) must re-emit. A
    feasible-but-not-admitted verdict (gang rejection, contention) is its
    own mode."""
    if feasible_nodes > 0:
        return "not-admitted"
    nz = sorted(p for p, c in reasons.items() if c > 0)
    dom = max(reasons.items(), key=lambda kv: (kv[1], kv[0]))[0] \
        if nz else "none"
    return dom + "|" + ",".join(nz)


class ReasonCorrelator:
    """EventCorrelator-style emission gate, per (pod, fingerprint): the
    first occurrence emits; afterwards occurrence counts 2, 4, 8, … (doubling,
    capped at every `cap`th) emit — exponential backoff keyed on occurrence
    COUNT, not wall time, so injected-clock tests and storm replays are
    deterministic. Bounded LRU over keys."""

    def __init__(self, cap: int = 64, max_keys: int = 4096):
        self.cap = cap
        self.max_keys = max_keys
        self._mu = threading.Lock()
        # (pod_key, fp) -> [occurrences, next_emit_at]
        self._seen: "OrderedDict[Tuple[str, str], List[int]]" = OrderedDict()

    def should_emit(self, pod_key: str, fp: str) -> bool:
        with self._mu:
            ent = self._seen.get((pod_key, fp))
            if ent is None:
                self._seen[(pod_key, fp)] = [1, 2]
                while len(self._seen) > self.max_keys:
                    self._seen.popitem(last=False)
                return True
            self._seen.move_to_end((pod_key, fp))
            ent[0] += 1
            if ent[0] >= ent[1]:
                ent[1] = min(ent[0] * 2, ent[0] + self.cap)
                return True
            return False

    def defer(self, pod_key: str, fp: str) -> None:
        """An emission that qualified but was CAPPED by the per-wave write
        budget re-arms for the very next occurrence instead of waiting out
        the doubled threshold — without this, pods that always lose the
        budget race to earlier-indexed pods at the same power-of-two
        occurrence counts would starve forever."""
        with self._mu:
            ent = self._seen.get((pod_key, fp))
            if ent is not None:
                ent[1] = ent[0] + 1

    def occurrences(self, pod_key: str, fp: str) -> int:
        with self._mu:
            ent = self._seen.get((pod_key, fp))
            return ent[0] if ent else 0

    def forget(self, pod_key: str) -> None:
        with self._mu:
            for k in [k for k in self._seen if k[0] == pod_key]:
                del self._seen[k]


def _now_rfc3339() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


class APIEventSink:
    """FailedScheduling events through the apiserver: creates v1 Events
    through `client.events` (create/get/update, the JAX package's REST
    client's calls) under a RetryPolicy — 429 (max-inflight shed) and 503
    (restart window) absorbed by a capped-exponential budget, every other
    status error fails fast and is counted, never raised into the wave.
    Repeat emissions for the same (pod, fingerprint) bump the existing
    Event's `count` (EventSeries aggregation) instead of creating a new
    object."""

    def __init__(self, client, component: str = "default-scheduler",
                 retry=None, pod_lookup: Optional[Callable] = None):
        self.client = client
        self.component = component
        self.pod_lookup = pod_lookup  # (ns, name) -> live pod dict or None
        self.retry = retry or RetryPolicy(attempts=3, base_s=0.05,
                                          cap_s=1.0, deadline_s=3.0)
        self.writes = 0     # Events created or count-bumped server-side
        self.errors = 0
        self._mu = threading.Lock()
        # dedup -> Event name, LRU-bounded: pod churn (failed batch jobs
        # deleted and replaced forever) must not grow this without bound —
        # an evicted entry just means the next emission creates a fresh
        # Event instead of bumping the old one's count
        self._names: "OrderedDict[Tuple[str, str, str], str]" = OrderedDict()
        self._names_cap = 4096

    def emit(self, namespace: str, pod_name: str, reason: str,
             message: str, fingerprint: str = "") -> bool:
        ns = namespace or "default"
        dedup = (ns, pod_name, fingerprint or reason)
        with self._mu:
            existing = self._names.get(dedup)
        try:
            if existing:
                bumped = self._bump(existing, ns, message)
                if bumped is False:
                    # transient failure bumping the EXISTING event: give
                    # up this emission (keep the name mapping) — creating
                    # a fresh object beside the live one would duplicate
                    # the series
                    return False
                if bumped is not None:
                    self.writes += 1
                    return True
                # None: the event is GONE server-side (TTL sweep, GC) —
                # forget the stale name and create afresh
                with self._mu:
                    self._names.pop(dedup, None)
            involved = {"kind": "Pod", "namespace": ns, "name": pod_name}
            if self.pod_lookup is not None:
                obj = self.pod_lookup(ns, pod_name)
                if obj is not None:
                    involved["uid"] = obj.get("metadata", {}).get("uid", "")
            name = f"{pod_name}.{str(uuid.uuid4())[:13]}"
            self.retry.run(lambda: self.client.events.create({
                "apiVersion": "v1", "kind": "Event",
                "metadata": {"name": name, "namespace": ns},
                "involvedObject": involved,
                "reason": reason, "message": message, "type": "Warning",
                "source": {"component": self.component},
                "firstTimestamp": _now_rfc3339(),
                "lastTimestamp": _now_rfc3339(),
                "count": 1,
            }, ns))
            with self._mu:
                self._names[dedup] = name
                self._names.move_to_end(dedup)
                while len(self._names) > self._names_cap:
                    self._names.popitem(last=False)
            self.writes += 1
            return True
        except Exception as e:  # noqa: BLE001 - status errors only
            if status_code(e) is None:
                raise
            self.errors += 1
            return False

    def _bump(self, name: str, ns: str, message: str):
        """The updated Event on success; None when the event no longer
        exists (caller recreates); False on any other failure (caller
        gives up this emission — recreating beside a live object would
        duplicate the series)."""
        try:
            cur = self.retry.run(lambda: self.client.events.get(name, ns))
            cur["count"] = int(cur.get("count", 1)) + 1
            cur["message"] = message  # latest counts win
            cur["lastTimestamp"] = _now_rfc3339()
            return self.retry.run(lambda: self.client.events.update(cur, ns))
        except Exception as e:  # noqa: BLE001 - status errors only
            if status_code(e) is None:
                raise
            if status_code(e) == 404:
                return None  # TTL-swept or GC'd: recreate
            self.errors += 1
            return False


class DecisionExplainer:
    """One per Scheduler. Consumes the wave's device attribution, feeds the
    three sinks, and keeps a bounded latest-attribution map for `why`.
    Thread-aware only as far as needed: observe_wave runs on the serving
    loop; `why()` may be read from another thread, under `_mu`."""

    #: failed pods whose per-pod reasons ride the flight-recorder record
    #: (the record must stay bounded; totals always ride)
    RECORD_PODS = 16
    #: max synchronous event writes per wave (see _maybe_emit)
    WAVE_EVENT_BUDGET = 64

    def __init__(self, name: str = "scheduler",
                 clock: Callable[[], float] = time.monotonic,
                 sink: Optional[APIEventSink] = None,
                 keep: int = 4096):
        self.name = name
        self.clock = clock
        self.sink = sink
        self.keep = keep
        self.correlator = ReasonCorrelator()
        self._mu = threading.Lock()
        self._latest: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.events_emitted = 0
        self.events_deduped = 0
        self.waves_observed = 0
        self.unschedulable_observed = 0  # pod-wave failure verdicts seen

    # ------------------------------------------------------------------ #
    # the wave feed
    # ------------------------------------------------------------------ #

    def observe_wave(self, batch, node_idx, exp, node_order,
                     now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Consume one wave's attribution. `batch` is the popped
        [(pod, attempts)] list, `node_idx` the engine's per-pod verdicts,
        `exp` the device ExplainResult (host numpy after device_get),
        `node_order` the dispatched snapshot's node-name order. Returns the
        wave-record dict for the flight recorder (None when nothing to
        say). Aggregates are vectorized; per-pod python work happens for
        FAILED pods only (the why-pending surface)."""
        if not batch or exp is None:
            return None
        now = self.clock() if now is None else now
        self.waves_observed += 1
        n = len(batch)
        node = np.asarray(node_idx)[:n]
        reasons = np.asarray(exp.reasons)[:n]
        validn = np.asarray(exp.valid_nodes)[:n]
        feas = np.asarray(exp.feasible_nodes)[:n]
        topn = np.asarray(exp.top_nodes)[:n]
        tops = np.asarray(exp.top_scores)[:n]
        parts = np.asarray(exp.score_parts)[:n]
        pnode = np.asarray(exp.part_node)[:n]
        failed = node < 0
        sched = ~failed

        rec: Dict[str, Any] = {}
        wave_budget = [self.WAVE_EVENT_BUDGET]
        # ---- metric sinks, one labeled inc per wave (not per pod) ---- #
        if failed.any():
            totals = reasons[failed].sum(axis=0)
            for p, c in zip(EXPLAIN_PREDICATES, totals):
                if c:
                    UNSCHEDULABLE_REASONS.inc(int(c), predicate=p)
            rec["reasons_total"] = {
                p: int(c) for p, c in zip(EXPLAIN_PREDICATES, totals) if c}
            rec["unschedulable"] = int(failed.sum())
        if sched.any():
            ptot = parts[sched].sum(axis=0)
            for comp, v in zip(EXPLAIN_SCORE_COMPONENTS, ptot):
                if v:
                    SCORE_SHARE.inc(float(v), component=comp)
            rec["score_parts_total"] = {
                comp: round(float(v), 3)
                for comp, v in zip(EXPLAIN_SCORE_COMPONENTS, ptot) if v}

        # ---- per-failed-pod: latest attribution + events ---- #
        pods_rec: Dict[str, Any] = {}
        for i in np.nonzero(failed)[0]:
            pod, attempts = batch[i]
            rmap = {p: int(c) for p, c in zip(EXPLAIN_PREDICATES, reasons[i])
                    if c}
            cands = [{"node": node_order[j] if 0 <= j < len(node_order)
                      else int(j),
                      "score": round(float(s), 3)}
                     for j, s in zip(topn[i], tops[i]) if j >= 0]
            doc = {
                "outcome": "unschedulable",
                "reasons": rmap,
                "valid_nodes": int(validn[i]),
                "feasible_nodes": int(feas[i]),
                "candidates": cands,
                "score_parts": {
                    comp: round(float(v), 3)
                    for comp, v in zip(EXPLAIN_SCORE_COMPONENTS, parts[i])},
                "message": render_unschedulable(int(validn[i]), rmap,
                                                feasible_nodes=int(feas[i])),
                "attempts": attempts,
                "t_observed": round(now, 3),
            }
            self.unschedulable_observed += 1
            self._remember(pod.key, doc)
            if len(pods_rec) < self.RECORD_PODS:
                pods_rec[pod.key] = {"reasons": rmap,
                                     "feasible": int(feas[i]),
                                     "valid": int(validn[i])}
            self._maybe_emit(pod, doc, wave_budget)
        # scheduled pods that PREVIOUSLY attributed as unschedulable get
        # their resolution written over the stale failure doc (the
        # why-pending mystery closes with the winning breakdown). Pods
        # that bound first try stay out of the map — per-pod python work
        # on the happy path would be the attribution overhead budget's
        # biggest line item, for a surface nobody queries about them.
        if sched.any():
            idxs = np.nonzero(sched)[0]
            with self._mu:
                # membership checks under ONE lock acquisition — a full
                # set(self._latest) copy per happy-path wave was measurable
                # against the attribution overhead budget
                tracked = [int(i) for i in idxs
                           if batch[int(i)][0].key in self._latest]
            for i in tracked:
                pod, attempts = batch[i]
                j = int(pnode[i])
                self._remember(pod.key, {
                    "outcome": "scheduled",
                    "node": node_order[j] if 0 <= j < len(node_order)
                    else int(j),
                    "score_parts": {
                        comp: round(float(v), 3)
                        for comp, v in zip(EXPLAIN_SCORE_COMPONENTS,
                                           parts[i])},
                    "attempts": attempts,
                    "t_observed": round(now, 3),
                })
        if pods_rec:
            rec["pods"] = pods_rec
        return rec or None

    def _remember(self, key: str, doc: Dict[str, Any]) -> None:
        with self._mu:
            self._latest[key] = doc
            self._latest.move_to_end(key)
            while len(self._latest) > self.keep:
                self._latest.popitem(last=False)

    def _maybe_emit(self, pod, doc: Dict[str, Any],
                    wave_budget: List[int]) -> None:
        fp = reason_fingerprint(doc["reasons"],
                                feasible_nodes=doc["feasible_nodes"])
        if not self.correlator.should_emit(pod.key, fp):
            self.events_deduped += 1
            FAILED_EVENTS.inc(outcome="deduped")
            return
        if self.sink is None:
            FAILED_EVENTS.inc(outcome="unsinked")
            return
        if wave_budget[0] <= 0:
            # sink writes are synchronous apiserver round-trips on the
            # serving loop: a storm's first wave of thousands of DISTINCT
            # newly-failing pods (every correlator check a first
            # occurrence) must not stall the wave for minutes. Capped
            # pods re-arm for their NEXT occurrence (defer — not the
            # doubled threshold, which would let budget-race losers
            # starve), so emission spreads over subsequent waves instead
            # of being lost.
            self.correlator.defer(pod.key, fp)
            FAILED_EVENTS.inc(outcome="capped")
            return
        wave_budget[0] -= 1
        ok = self.sink.emit(pod.namespace, pod.name, "FailedScheduling",
                            doc["message"], fingerprint=fp)
        if ok:
            self.events_emitted += 1
            FAILED_EVENTS.inc(outcome="emitted")
        else:
            FAILED_EVENTS.inc(outcome="error")

    # ------------------------------------------------------------------ #
    # the why-pending surface
    # ------------------------------------------------------------------ #

    def why(self, key: str) -> Optional[Dict[str, Any]]:
        """The pod's latest attribution document, or None."""
        with self._mu:
            doc = self._latest.get(key)
            return dict(doc) if doc is not None else None

    def forget(self, key: str) -> None:
        with self._mu:
            self._latest.pop(key, None)
        self.correlator.forget(key)


def build_explainer(name: str = "scheduler",
                    clock: Callable[[], float] = time.monotonic,
                    enabled: Optional[bool] = None,
                    sink: Optional[APIEventSink] = None
                    ) -> Optional[DecisionExplainer]:
    """The KTPU_EXPLAIN kill-switch gate: None (the default — env unset, 0
    or off) keeps the wave dispatch without the attribution; anything else
    builds the explainer, and the Scheduler then dispatches with
    explain=True."""
    if enabled is None:
        enabled = os.environ.get("KTPU_EXPLAIN", "0") not in ("", "0", "off")
    if not enabled:
        return None
    return DecisionExplainer(name=name, clock=clock, sink=sink)
