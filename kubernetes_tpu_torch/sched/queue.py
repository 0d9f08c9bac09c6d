"""Scheduling queue: the 3-queue design of the reference's PriorityQueue
(pkg/scheduler/internal/queue/scheduling_queue.go:119-138).

  * activeQ    — heap ordered by (priority desc, creation asc): the pods the
                 next cycle will take (activeQComp; pop at Pop()).
  * backoffQ   — heap ordered by backoff expiry: pods that failed recently and
                 must wait out an exponential backoff (1s initial, 10s max —
                 scheduling_queue.go:60,64) before re-entering activeQ.
  * unschedulableQ — map of pods that found no feasible node; they re-enter
                 activeQ when a cluster event might have made them schedulable
                 (MoveAllToActiveQueue, eventhandlers.go:392-441) or after the
                 60s flush (unschedulableQTimeInterval, scheduling_queue.go:51).

Differences from the reference, by design:
  * No background goroutines. The reference pumps flushBackoffQCompleted every
    1s and flushUnschedulableQLeftover every 30s (scheduling_queue.go:252-253);
    here `pump(now)` does both with an injected clock — the scheduling loop
    calls it once per cycle, and tests drive time explicitly.
  * Batch pop: `pop_batch(max_n)` drains up to max_n pods in comparator order,
    because the TPU backend schedules a whole wave per device dispatch instead
    of one pod per loop iteration (scheduler.go:596 scheduleOne).

The nominated-pods map (scheduling_queue.go:136-138, preemption's "I will fit
once the victims die" bookkeeping) lives here too, as in the reference.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..api.types import Pod

INITIAL_BACKOFF = 1.0            # podInitialBackoffDuration, scheduling_queue.go:60
MAX_BACKOFF = 10.0               # podMaxBackoffDuration, scheduling_queue.go:64
UNSCHEDULABLE_FLUSH_INTERVAL = 60.0  # unschedulableQTimeInterval, :51
# safety flush for the governor-owned deferred lane (sched/overload.py):
# shedding parks pods here and releases them when the brownout ends; if the
# governor never does (process reconfigured mid-flight, KTPU_OVERLOAD
# toggled), pump() re-admits them after this long — deferred means
# deferred, never dropped
DEFERRED_FLUSH_INTERVAL = 300.0


@dataclass
class _Entry:
    pod: Pod
    attempts: int = 0           # scheduling failures so far (backoff exponent)
    timestamp: float = 0.0      # last time the pod entered a queue


def _active_key(e: _Entry) -> Tuple[int, int]:
    """activeQComp: higher priority first, then earlier creation."""
    return (-e.pod.priority, e.pod.creation_index)


class PriorityQueue:
    """Thread-safe. All mutation under one lock, as the reference's `p.lock`."""

    def __init__(self, initial_backoff: float = INITIAL_BACKOFF,
                 max_backoff: float = MAX_BACKOFF) -> None:
        # podInitialBackoffSeconds/podMaxBackoffSeconds
        # (apis/config/types.go:96-101) — config-surface overridable
        self.initial_backoff = initial_backoff
        self.max_backoff = max_backoff
        # e2e-latency ingest stamps (sched/telemetry.py PodLatencyTracker,
        # attached by the Scheduler): every admission path stamps the pod's
        # FIRST-seen time — requeues are idempotent no-ops, so the recorded
        # watch→bind span survives backoff/prompt-retry/crash-recovery
        # round-trips. The tracker never calls back into the queue, so
        # stamping under `_mu` cannot deadlock.
        self.tracker = None
        self._mu = threading.Lock()
        self._cond = threading.Condition(self._mu)
        self._seq = itertools.count()
        # heaps hold (key..., seq, entry); maps give O(1) membership
        self._active: List[Tuple[int, int, int, _Entry]] = []
        self._active_keys: Dict[str, _Entry] = {}
        self._backoff: List[Tuple[float, int, _Entry]] = []
        self._backoff_keys: Dict[str, _Entry] = {}
        self._unschedulable: Dict[str, _Entry] = {}
        # governor-owned shed parking (sched/overload.py SHED_LOW): pods
        # deferred under overload — never dropped, never failed; released
        # in one batch when the brownout ends (plus pump()'s safety flush)
        self._deferred: Dict[str, _Entry] = {}
        # micro-eligible lane (streaming micro-waves): an
        # insertion-ordered SUBSET VIEW over activeQ entries that arrived
        # via fresh watch deltas (add/update) and can be admitted by a
        # small sub-cycle wave — no gang membership (a gang quorum is a
        # bulk-wave concern) and no spec.nodeName (that reroutes the wave
        # to the scan engine). Entries here are ALSO in _active_keys;
        # pop_batch draining a pod evicts its view entry, so with
        # micro-waves disabled the lane is pure passive bookkeeping and
        # the bulk pipeline is byte-for-byte unchanged.
        self._micro: Dict[str, _Entry] = {}
        self._nominated: Dict[str, str] = {}  # pod key -> nominated node name
        # schedulingCycle / moveRequestCycle (scheduling_queue.go:139-147):
        # if a move request happened at-or-after the cycle a pod was popped in,
        # its failure verdict is stale — retry via backoffQ, not unschedulableQ.
        self._cycle = 0
        self._move_cycle = -1

    # ------------------------------------------------------------------ #
    # membership helpers
    # ------------------------------------------------------------------ #

    def _delete_everywhere(self, key: str) -> Optional[_Entry]:
        self._micro.pop(key, None)
        e = self._active_keys.pop(key, None)
        if e is None:
            e = self._backoff_keys.pop(key, None)
        if e is None:
            e = self._unschedulable.pop(key, None)
        if e is None:
            e = self._deferred.pop(key, None)
        # heap entries are lazily discarded at pop time via the key maps
        return e

    @staticmethod
    def _micro_eligible(pod: Pod) -> bool:
        return not pod.pod_group and not pod.node_name

    def _push_active(self, e: _Entry) -> None:
        k = _active_key(e)
        heapq.heappush(self._active, (k[0], k[1], next(self._seq), e))
        self._active_keys[e.pod.key] = e
        self._cond.notify_all()

    # ------------------------------------------------------------------ #
    # public API (scheduling_queue.go Add/AddUnschedulableIfNotPresent/
    # Pop/Update/Delete/MoveAllToActiveQueue)
    # ------------------------------------------------------------------ #

    def _stamp(self, key: str, now: float) -> None:
        if self.tracker is not None:
            self.tracker.stamp(key, now)

    def add(self, pod: Pod, now: float = 0.0) -> None:
        """Add a new pending pod straight to activeQ. Fresh watch-delta
        admissions are the micro-wave feedstock: eligible pods land in the
        micro view too (requeue paths deliberately do not — a pod with
        scheduling history belongs to the bulk pipeline's backoff/fairness
        machinery)."""
        with self._mu:
            self._stamp(pod.key, now)
            self._delete_everywhere(pod.key)
            e = _Entry(pod=pod, timestamp=now)
            self._push_active(e)
            if self._micro_eligible(pod):
                self._micro[pod.key] = e

    def add_unschedulable(
        self, pod: Pod, attempts: int, now: float, cycle: Optional[int] = None
    ) -> None:
        """AddUnschedulableIfNotPresent (scheduling_queue.go:287): a pod that
        just failed. If a move request arrived at-or-after the cycle the pod
        was popped in (cluster state changed mid-flight), it goes to backoffQ
        for a prompt retry instead of parking in unschedulableQ."""
        with self._mu:
            self._stamp(pod.key, now)
            if pod.key in self._active_keys or pod.key in self._backoff_keys:
                return
            # single-lane rule: a failure verdict supersedes a shed park
            self._deferred.pop(pod.key, None)
            e = _Entry(pod=pod, attempts=attempts, timestamp=now)
            popped_cycle = self._cycle if cycle is None else cycle
            if self._move_cycle >= popped_cycle:
                heapq.heappush(
                    self._backoff, (now + self._backoff_for(e), next(self._seq), e)
                )
                self._backoff_keys[pod.key] = e
            else:
                self._unschedulable[pod.key] = e

    def _backoff_for(self, e: _Entry) -> float:
        return self.backoff_duration(e.attempts)

    def backoff_duration(self, attempts: int) -> float:
        """Exponential: initial * 2^(attempts-1) capped at max (getBackoffTime,
        scheduling_queue.go:60-64; bounds from config types.go:96-101).
        The exponent clamps BEFORE exponentiating: a storm-requeued pod can
        accumulate attempts in the thousands, and `2.0 ** 1024` raises
        OverflowError — the cap must clamp the duration, not crash the
        queue mid-requeue."""
        exp = min(max(attempts - 1, 0), 1023)
        return min(self.initial_backoff * (2.0 ** exp), self.max_backoff)

    def update(self, pod: Pod, now: float = 0.0) -> None:
        """Update (scheduling_queue.go:331): spec changes reset the pod's
        queue position; an unschedulable pod whose spec changed may now fit,
        so it moves to activeQ."""
        with self._mu:
            self._stamp(pod.key, now)
            old = self._delete_everywhere(pod.key)
            attempts = old.attempts if old else 0
            e = _Entry(pod=pod, attempts=attempts, timestamp=now)
            self._push_active(e)
            # an update is a fresh watch delta; first-attempt pods stay
            # micro-eligible (a retried pod keeps bulk-lane routing)
            if attempts == 0 and self._micro_eligible(pod):
                self._micro[pod.key] = e

    def delete(self, key: str) -> None:
        with self._mu:
            self._delete_everywhere(key)
            self._nominated.pop(key, None)
            if self.tracker is not None:
                # a deleted pending pod's watch→bind span never completes;
                # the scheduler's commit path pops bound pods' stamps itself
                # (queue.delete is NOT on the bind path)
                self.tracker.discard(key)

    def pop_batch(self, max_n: int, now: float = 0.0) -> List[Tuple[Pod, int]]:
        """Drain up to max_n pods from activeQ in comparator order. Returns
        (pod, attempts) pairs; attempts feeds the next backoff on failure."""
        out: List[Tuple[Pod, int]] = []
        with self._mu:
            self._cycle += 1
            while self._active and len(out) < max_n:
                _, _, _, e = heapq.heappop(self._active)
                if self._active_keys.get(e.pod.key) is not e:
                    continue  # stale heap entry
                del self._active_keys[e.pod.key]
                self._micro.pop(e.pod.key, None)
                e.attempts += 1
                out.append((e.pod, e.attempts))
        return out

    def pop_micro(self, max_n: int, now: float = 0.0) -> List[Tuple[Pod, int]]:
        """Drain up to max_n micro-eligible pods: same contract
        as pop_batch — comparator order, attempts incremented, the
        scheduling-cycle counter bumped so mid-flight move requests route
        failures to backoffQ exactly as for a bulk wave — but selecting
        only from the micro view. The selected pods leave activeQ too (one
        pod is in flight through exactly one wave)."""
        out: List[Tuple[Pod, int]] = []
        with self._mu:
            self._cycle += 1
            # INVARIANT: every _micro entry IS its _active_keys entry —
            # all removal paths (_delete_everywhere, pop_batch, pop_micro)
            # evict the view eagerly, so no identity re-validation here
            live = sorted(self._micro.values(), key=_active_key)
            for e in live[:max_n]:
                del self._active_keys[e.pod.key]
                del self._micro[e.pod.key]
                e.attempts += 1
                out.append((e.pod, e.attempts))
            # stale heap tuples for the popped keys are lazily discarded
            # by pop_batch's identity check, as for every other promotion
        return out

    def micro_stats(self) -> Tuple[int, int, float]:
        """(micro-eligible depth, activeQ depth, oldest micro admission
        timestamp) — the scheduler's micro/bulk arbitration signal, O(1)
        (it runs on every schedule_pending call). The oldest stamp bounds
        the coalesce window (0.0 when the lane is empty); depths
        diverging means activeQ holds micro-INeligible pods and the next
        wave must be a bulk wave. Insertion order of the view tracks
        admission time, so the first entry is the oldest."""
        with self._mu:
            oldest = (next(iter(self._micro.values())).timestamp
                      if self._micro else 0.0)
            return (len(self._micro), len(self._active_keys), oldest)

    def add_prompt_retry(self, pod: Pod, attempts: int,
                         now: float = 0.0) -> None:
        """Requeue straight to activeQ, KEEPING the attempt count — for
        preemptors that just got a node nominated: their next attempt is
        expected to succeed the moment the victims exit, and serving the
        accumulated exponential backoff first (1 s, 2 s, 4 s…) only delays
        reuse of space already evicted for them (documented deviation,
        docs/PERF.md round 6: the reference routes them through backoffQ).
        Spin safety lives in sched/preemption.py: a retried pod that finds
        NO preemption candidate takes the ordinary backoff path, and the
        zero-victim (filter-discrepancy) case gets at most one prompt
        retry per pod (Preemptor._zero_victim_retries)."""
        with self._mu:
            self._stamp(pod.key, now)
            if pod.key in self._active_keys or pod.key in self._backoff_keys:
                return
            self._unschedulable.pop(pod.key, None)
            # a prompt retry PROMOTES a shed-parked pod (single-lane rule:
            # the deferred entry dies; active wins)
            self._deferred.pop(pod.key, None)
            e = _Entry(pod=pod, attempts=attempts, timestamp=now)
            self._push_active(e)

    def requeue_recovered(self, pod: Pod, attempts: int = 1,
                          now: float = 0.0) -> str:
        """Crash-recovery re-admission (sched/ledger.py replay): a pod
        released from an unretired bind intent must end up in EXACTLY ONE
        queue lane, and that lane must be activeQ — recovery wants a prompt
        retry, and the pod may ALREADY sit in backoff/unschedulable on this
        incarnation (a standby's informers delivered it as pending, a prior
        wave failed it) when the replay re-admits it. Rules:

          already active         → keep that entry (no duplicate)
          parked in backoff      → promote to activeQ (crash recovery does
                                   not wait out a backoff served against a
                                   DEAD leader's verdicts)
          parked unschedulable   → promote to activeQ
          absent                 → add to activeQ

        Attempt counts merge (max) so the promoted entry keeps its backoff
        history for the NEXT failure. Returns the lane the pod ended in
        ("active" always) — callers assert, tests introspect via lanes()."""
        with self._mu:
            self._stamp(pod.key, now)
            if pod.key in self._active_keys:
                return "active"
            e = self._backoff_keys.pop(pod.key, None)
            if e is None:
                e = self._unschedulable.pop(pod.key, None)
            if e is None:
                e = self._deferred.pop(pod.key, None)
            attempts = max(attempts, e.attempts if e else 0)
            # the popped backoff-heap tuple (if any) becomes stale and is
            # lazily discarded at pump time via the identity check
            self._push_active(_Entry(pod=pod, attempts=attempts,
                                     timestamp=now))
            return "active"

    def park_deferred(self, pod: Pod, attempts: int, now: float = 0.0) -> bool:
        """Shed parking (sched/overload.py SHED_LOW): a popped low-priority
        pod is DEFERRED — not failed, not backed off, not dropped — until
        the governor releases the lane (or pump()'s safety flush does).
        `attempts` keeps the pre-shed count MINUS the shedding pop itself:
        being shed is not a scheduling failure, so the pod's next real
        attempt must not serve escalated backoff for it. Dedupe: a pod
        already live in another lane keeps that entry (it is on a path to
        being scheduled; parking it would be a demotion)."""
        with self._mu:
            self._stamp(pod.key, now)
            if (pod.key in self._active_keys or pod.key in self._backoff_keys
                    or pod.key in self._unschedulable):
                return False
            self._deferred[pod.key] = _Entry(
                pod=pod, attempts=max(attempts - 1, 0), timestamp=now)
            return True

    def deferred_keys(self) -> List[str]:
        """Keys currently parked in the deferred lane — the bench/tests
        prove "deferred then admitted" by intersecting this with the
        eventually-bound set."""
        with self._mu:
            return list(self._deferred)

    def release_deferred(self, now: float = 0.0) -> int:
        """Brownout over: re-admit the whole deferred lane to activeQ in
        one batch (the governor's NORMAL-exit action). Attempts carry."""
        with self._mu:
            n = 0
            for key, e in list(self._deferred.items()):
                del self._deferred[key]
                if key in self._active_keys:
                    continue
                e.timestamp = now
                self._push_active(e)
                n += 1
            return n

    def get_pod(self, key: str) -> Optional[Pod]:
        """The pod behind `key` in WHICHEVER lane holds it (active, backoff,
        unschedulable or deferred), else None. Intent replay's default
        informer-truth lookup reads this: a pod parked in backoff at crash
        time is still a live pending pod, not a deleted one."""
        with self._mu:
            e = (self._active_keys.get(key)
                 or self._backoff_keys.get(key)
                 or self._unschedulable.get(key)
                 or self._deferred.get(key))
            return e.pod if e is not None else None

    def describe(self, key: str) -> Tuple[Optional[str], int]:
        """(lane name, attempts) for `key` — the /debug/why surface's queue
        half (sched/explain.py). Lane is one of "active"/"backoff"/
        "unschedulable"/"deferred", or None when the pod is in no lane
        (bound, deleted, or never seen)."""
        with self._mu:
            for lane, m in (("active", self._active_keys),
                            ("backoff", self._backoff_keys),
                            ("unschedulable", self._unschedulable),
                            ("deferred", self._deferred)):
                e = m.get(key)
                if e is not None:
                    return lane, e.attempts
            return None, 0

    def lanes(self, key: str) -> Tuple[bool, bool, bool]:
        """(in activeQ, in backoffQ, in unschedulableQ) membership — the
        dedupe introspection the crash-requeue tests assert with (a pod must
        never be live in two lanes; heap leftovers don't count, the key maps
        are the ground truth the pop paths honor). The deferred lane is
        introspected via depths()/get_pod (this tuple's shape is a stable
        test contract)."""
        with self._mu:
            return (key in self._active_keys, key in self._backoff_keys,
                    key in self._unschedulable)

    def peek_active(self, max_n: int) -> List[Pod]:
        """Non-destructive view of up to max_n pods waiting in activeQ (heap
        order, approximately). The scheduler's double-buffer uses this to
        intern the NEXT wave's pods while the device evaluates the current
        one — order does not matter for interning, so no heap pop/repair."""
        out: List[Pod] = []
        with self._mu:
            for _, _, _, e in self._active:
                if self._active_keys.get(e.pod.key) is e:
                    out.append(e.pod)
                    if len(out) >= max_n:
                        break
        return out

    def wait_nonempty(self, timeout: Optional[float] = None) -> bool:
        """Block until activeQ is non-empty (the reference's Pop blocks on a
        condition variable, scheduling_queue.go Pop); the wave loop then
        drains with pop_batch."""
        with self._mu:
            while not self._active:
                if not self._cond.wait(timeout):
                    return False
            return True

    def move_all_to_active(self, now: float = 0.0) -> int:
        """MoveAllToActiveQueue (scheduling_queue.go:358): a cluster event
        (node add, PV create, …) may have unblocked anything — move the whole
        unschedulableQ to activeQ/backoffQ and bump the move counter."""
        with self._mu:
            self._move_cycle = self._cycle
            n = len(self._unschedulable)
            for key, e in list(self._unschedulable.items()):
                del self._unschedulable[key]
                remaining = self._backoff_for(e) - (now - e.timestamp)
                if remaining > 0:
                    heapq.heappush(
                        self._backoff, (e.timestamp + self._backoff_for(e),
                                        next(self._seq), e)
                    )
                    self._backoff_keys[key] = e
                else:
                    self._push_active(e)
            return n

    def pump(self, now: float) -> None:
        """flushBackoffQCompleted + flushUnschedulableQLeftover
        (scheduling_queue.go:252-253, 1s/30s background pumps)."""
        with self._mu:
            # backoff → active
            while self._backoff:
                expiry, _, e = self._backoff[0]
                if expiry > now:
                    break
                heapq.heappop(self._backoff)
                if self._backoff_keys.get(e.pod.key) is not e:
                    continue
                del self._backoff_keys[e.pod.key]
                self._push_active(e)
            # stale unschedulable → active (60s)
            for key, e in list(self._unschedulable.items()):
                if now - e.timestamp >= UNSCHEDULABLE_FLUSH_INTERVAL:
                    del self._unschedulable[key]
                    self._push_active(e)
            # deferred safety flush: a wedged/removed governor must never
            # strand shed pods — deferred means deferred, not dropped
            for key, e in list(self._deferred.items()):
                if now - e.timestamp >= DEFERRED_FLUSH_INTERVAL:
                    del self._deferred[key]
                    if key not in self._active_keys:
                        self._push_active(e)

    # ------------------------------------------------------------------ #
    # nominated pods (preemption bookkeeping, scheduling_queue.go:136-138)
    # ------------------------------------------------------------------ #

    def add_nominated(self, pod_key: str, node_name: str) -> None:
        with self._mu:
            self._nominated[pod_key] = node_name

    def delete_nominated(self, pod_key: str) -> None:
        with self._mu:
            self._nominated.pop(pod_key, None)

    def nominated_on(self, node_name: str) -> List[str]:
        with self._mu:
            return [k for k, n in self._nominated.items() if n == node_name]

    def nominated_node(self, pod_key: str) -> Optional[str]:
        with self._mu:
            return self._nominated.get(pod_key)

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #

    def current_cycle(self) -> int:
        """The scheduling-cycle counter of the most recent pop — callers pass
        this back into add_unschedulable for the moveRequestCycle comparison."""
        with self._mu:
            return self._cycle

    def lengths(self) -> Tuple[int, int, int]:
        """(active, backoff, unschedulable) — the pending-pods queue-depth
        recorders (scheduling_queue.go:237-243). Kept a 3-tuple (a stable
        contract across callers/tests); the deferred lane rides depths()."""
        with self._mu:
            return (len(self._active_keys), len(self._backoff_keys),
                    len(self._unschedulable))

    def depths(self) -> Dict[str, int]:
        """Every lane's depth, by name — the overload governor's pressure
        signal and the `scheduler_pending_pods{queue=...}` gauge source
        (sched/metrics.py observe_queue_depths), deferred included."""
        with self._mu:
            return {"active": len(self._active_keys),
                    "backoff": len(self._backoff_keys),
                    "unschedulable": len(self._unschedulable),
                    "deferred": len(self._deferred)}
