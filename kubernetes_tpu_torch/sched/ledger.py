"""Durable bind-intent ledger: exactly-once binding across crash/restart.

The scheduler's assume → bind → confirm pipeline is all in-memory until the
Binding write lands, so a crash between "the wave decided placements" and
"the Binding writes committed" either loses pods (decided, never bound) or —
worse, with a deposed leader still running — double-places them. This module
closes both holes with a write-ahead intent record, the same shape as the
reference's two-phase assume/bind split (scheduler.go:660-762) made durable:

  1. Before any Binding write of a wave commits, `schedule_pending` writes ONE
     compact intent record through `storage/store.py` (CAS create): cycle id,
     the leader's fencing token (lease generation), and the full
     pod_key → node map the wave decided.
  2. The Binding writes commit (each stamped with the same fencing token —
     the apiserver rejects stale tokens, apiserver/server.py `bind_pod`).
  3. The intent is retired (CAS delete). A crash at ANY point leaves a state
     a restarted/succeeding scheduler can reconcile by construction:

       crashed before 1 → nothing durable happened; informers re-deliver the
                          pods as pending and they reschedule normally.
       crashed 1..2     → unretired intent, pods unbound: `replay` completes
                          the bind (node still fits) or releases the pod back
                          to the active queue.
       crashed 2..3     → unretired intent, pods bound: `replay` observes the
                          informer truth and just retires the record. The
                          apiserver's "pod is already assigned" guard makes a
                          replayed Binding write idempotent — exactly-once
                          holds even when the restart raced the watch stream.

The ledger talks to the raw `Storage` tier (the analog of the scheduler
writing its own coordination objects through etcd), NOT through the REST
client: intents are scheduler-internal bookkeeping, not API objects, and the
CAS create/delete pair is the whole protocol.

Port of the JAX package's sched/ledger.py: the same records under the same
keys, the same replay decision table. The storage is injected — the port's
own (storage/store.py) or any store with `create/list/delete` that raises a
status error carrying `code` 404 for a missing key — so an intent written by
either package's scheduler is replayed by the other's.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..machinery import errors, meta
from ..utils import faultline
from .metrics import RECOVERED_INTENTS

INTENT_PREFIX = "/registry/ktpu.io/bindintents/"


@dataclass
class BindIntent:
    """One wave's durable placement decision (decoded form)."""

    name: str                     # storage key suffix
    cycle: int                    # queue scheduling-cycle counter at pop
    token: int                    # fencing token (lease generation) stamped
    holder: str                   # leader identity that wrote it (debugging)
    bindings: Dict[str, str]      # pod key → node name
    resource_version: str = ""

    @property
    def key(self) -> str:
        return INTENT_PREFIX + self.name


@dataclass
class RecoveryReport:
    """What one reconciliation pass (startup or takeover) did with the
    unretired intents it found — the decision-table counters the restart
    drill asserts on (docs/RESILIENCE.md §Restart/HA)."""

    replayed_intents: int = 0     # unretired intents processed + retired
    already_bound: int = 0        # entries the informer truth showed bound
    completed: int = 0            # entries bound NOW (node still fit)
    released: int = 0             # entries released back to the active queue
    dropped: int = 0              # entries whose pod no longer exists
    stale_skipped: int = 0        # intents with a NEWER token than ours —
    # a newer leader owns them; touching them would be the stale side of
    # the fence (left unretired for the rightful owner)
    forgotten_assumes: int = 0    # in-memory assumes dropped on takeover
    errors: List[str] = field(default_factory=list)


class BindIntentLedger:
    """CAS-backed intent records under one storage prefix, namespaced by
    scheduler name so parallel schedulers (profiles) never cross streams."""

    def __init__(self, storage,
                 scheduler_name: str = "default-scheduler",
                 identity: str = "") -> None:
        self.storage = storage
        self.scheduler_name = scheduler_name
        self.identity = identity or f"{os.getpid()}-{uuid.uuid4().hex[:6]}"
        self._seq = itertools.count()
        # observability: the restart drill + bench failover stage read these
        self.intents_written = 0
        self.intents_retired = 0

    def _prefix(self) -> str:
        return f"{INTENT_PREFIX}{self.scheduler_name}/"

    # ------------------------------------------------------------------ #
    # the write-ahead half (schedule_pending calls these around commits)
    # ------------------------------------------------------------------ #

    def write_intent(self, cycle: int, token: int,
                     bindings: Dict[str, str]) -> BindIntent:
        """Durably record a wave's placement decision BEFORE any Binding
        write commits. CAS create: the key embeds a per-process sequence +
        uuid, so two incarnations can never silently overwrite each other's
        records."""
        name = (f"{self.scheduler_name}/c{cycle:08d}-"
                f"{next(self._seq):04d}-{uuid.uuid4().hex[:8]}")
        obj = {
            "apiVersion": "ktpu.io/v1", "kind": "BindIntent",
            "metadata": {"name": name.rsplit('/', 1)[-1]},
            "spec": {"cycle": int(cycle), "token": int(token),
                     "holder": self.identity, "writtenAt": time.time(),
                     "bindings": dict(bindings)},
        }
        out = self.storage.create(INTENT_PREFIX + name, obj, "bindintents")
        self.intents_written += 1
        return BindIntent(name=name, cycle=int(cycle), token=int(token),
                          holder=self.identity, bindings=dict(bindings),
                          resource_version=meta.resource_version(out))

    def retire(self, intent: BindIntent) -> bool:
        """CAS delete the record once the wave's Binding writes are settled
        (bound, rolled back, or requeued — all recoverable states). Not
        found is success: a reconciler may have retired it for us."""
        try:
            self.storage.delete(intent.key, "bindintents", intent.name)
        except Exception as e:  # noqa: BLE001 - an injected store's error
            if getattr(e, "code", None) != 404:  # class need not be ours
                raise
            return False
        self.intents_retired += 1
        return True

    # ------------------------------------------------------------------ #
    # the recovery half (startup / takeover reconciliation)
    # ------------------------------------------------------------------ #

    def unretired(self) -> List[BindIntent]:
        """All intents still on record for this scheduler name, oldest
        first — the replay set a restart/takeover must reconcile."""
        items, _ = self.storage.list(self._prefix())
        out: List[BindIntent] = []
        for obj in items:
            spec = obj.get("spec", {}) or {}
            out.append(BindIntent(
                name=(f"{self.scheduler_name}/"
                      f"{obj.get('metadata', {}).get('name', '')}"),
                cycle=int(spec.get("cycle", 0)),
                token=int(spec.get("token", 0)),
                holder=str(spec.get("holder", "")),
                bindings=dict(spec.get("bindings", {}) or {}),
                resource_version=str(
                    obj.get("metadata", {}).get("resourceVersion", "")),
            ))
        out.sort(key=lambda i: (i.cycle, i.name))
        return out

    def replay(self, scheduler, lookup, now: Optional[float] = None,
               token: Optional[int] = None) -> RecoveryReport:
        """Reconcile every unretired intent against informer truth — the
        takeover/startup pass that makes binding exactly-once by
        construction. `lookup(pod_key)` returns the live api.types.Pod (its
        node_name reflects the apiserver's view) or None when deleted.

        Decision table per (pod_key → node) entry:
          pod bound (any node)       → already done; nothing to do
          pod gone                   → dropped
          pod unbound, node fits     → complete the bind NOW (with OUR
                                       token — the old leader's write may
                                       be in flight, the apiserver's
                                       already-assigned guard arbitrates)
          pod unbound, doesn't fit   → release to the active queue
        The intent is retired after its entries resolve; an intent carrying
        a NEWER token than ours is a newer leader's in-flight wave — it is
        skipped, never retired (we are the stale one)."""
        report = RecoveryReport()
        now = scheduler.clock() if now is None else now
        our_token = scheduler._fence_token() if token is None else int(token)
        # a takeover must not trust its own in-memory assumes: any assumed-
        # unconfirmed pod predates the fence (a deposed reign, a stale
        # standby view) — drop them and let intent replay + informer truth
        # rebuild the state (cache/queue are rebuilt, not trusted). A
        # forgotten assume whose bind never committed gets NO further
        # informer event (the pod object never changed), so it is requeued
        # HERE — forgetting without requeueing would strand it forever.
        forgotten = scheduler.cache.forget_assumed()
        report.forgotten_assumes = len(forgotten)
        for dropped in forgotten:
            pod = lookup(dropped.key)
            if pod is not None and getattr(pod, "node_name", ""):
                # the bind DID land: restore the confirmed pod instead of
                # waiting for a watch event that may never come
                try:
                    scheduler.cache.add_pod(pod)
                except Exception:  # noqa: BLE001 - racing informer add
                    pass
                continue
            if pod is None:
                # truth can't see it (the default cache+queue lookup never
                # can — the pod was popped from every lane before being
                # assumed): requeue the dropped object itself, with the
                # assumed placement STRIPPED so the retry is a plain
                # reschedule. If the pod really was deleted, the informer
                # delete event (queue.delete) or a failed bind cleans up —
                # one wasted attempt beats a silently lost pod.
                pod = dataclasses.replace(dropped, node_name="")
            scheduler.queue.requeue_recovered(pod, attempts=1, now=now)
        for intent in self.unretired():
            if intent.token > our_token:
                report.stale_skipped += 1
                continue
            faultline.crashpoint("takeover")
            for pod_key, node_name in sorted(intent.bindings.items()):
                try:
                    self._replay_entry(scheduler, lookup, pod_key,
                                       node_name, now, report)
                except errors.StatusError as e:
                    report.errors.append(f"{pod_key}: {e}")
            self.retire(intent)
            report.replayed_intents += 1
        for outcome in ("already_bound", "completed", "released", "dropped"):
            n = getattr(report, outcome)
            if n:
                RECOVERED_INTENTS.inc(n, outcome=outcome)
        return report

    def _replay_entry(self, scheduler, lookup, pod_key: str,
                      node_name: str, now: float,
                      report: RecoveryReport) -> None:
        pod = lookup(pod_key)
        if pod is None:
            report.dropped += 1
            return
        if getattr(pod, "node_name", ""):
            # informer truth says bound (by the crashed incarnation, or by
            # anyone else) — the intent entry is settled
            report.already_bound += 1
            return
        # unbound: complete against a FRESH view — the crashed wave's
        # placement is only honored if the node still fits the pod
        if scheduler.node_fits(pod, node_name):
            if scheduler.commit_recovered(pod, node_name, now):
                report.completed += 1
                return
            # bind refused: most often "already assigned" (our informer
            # lagged the crashed leader's committed write) — fall through
            # to the release path; the pod is requeued, never lost, and a
            # stale queue entry for an actually-bound pod is skipped by
            # the wave's skipPodSchedule check
        scheduler.queue.requeue_recovered(pod, attempts=1, now=now)
        report.released += 1
