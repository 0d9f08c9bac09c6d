"""Lease-based leader election.

Analog of client-go `tools/leaderelection/leaderelection.go:76` over
coordination.k8s.io/v1 Leases: acquire by CAS-creating/claiming the Lease,
renew on a timer, yield when renewal fails; callbacks mirror
LeaderCallbacks{OnStartedLeading, OnStoppedLeading, OnNewLeader}.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..machinery import errors
from ..machinery.wait import jittered

# client-go leaderelection.JitterFactor: each retry sleeps
# retry_period × [1, 1 + JITTER) so a fleet of candidates doesn't CAS the
# same Lease in lockstep every period
JITTER = 0.2


@dataclass
class LeaderElectionConfig:
    """tools/leaderelection.LeaderElectionConfig (+ the reference defaults,
    apis/config/types.go LeaderElectionConfiguration: 15s/10s/2s)."""

    lock_name: str
    lock_namespace: str = "kube-system"
    identity: str = ""
    lease_duration: float = 15.0
    renew_deadline: float = 10.0
    retry_period: float = 2.0
    on_started_leading: Callable[[], None] = lambda: None
    on_stopped_leading: Callable[[], None] = lambda: None
    on_new_leader: Callable[[str], None] = lambda ident: None


class LeaderElector:
    def __init__(self, client, config: LeaderElectionConfig):
        self.client = client
        self.cfg = config
        if not self.cfg.identity:
            import os
            import uuid
            self.cfg.identity = f"{os.uname().nodename}_{uuid.uuid4().hex[:8]}"
        self._stop = threading.Event()
        self._leading = threading.Event()
        self._observed_leader = ""
        self._thread: Optional[threading.Thread] = None
        # fencing token: the Lease's leaseTransitions at OUR acquisition.
        # Monotonic across holders (every holder change increments it), so
        # stamping it into Binding/intent writes lets the apiserver fence
        # off a deposed leader (apiserver/server.py bind_pod). Kept across
        # loss on purpose: a stale incarnation keeps stamping its OLD token
        # and gets rejected — that is the mechanism working.
        self._fence_token = 0
        # set by _try_acquire_or_renew when leadership is PROVABLY gone
        # (another live holder observed, or our renew CAS conflicted): the
        # renew loop must drop leadership immediately, not ride the
        # retry-until-deadline window with a second fencing token live
        self._deposed = False
        # crash() sets this: the run loop's exit path must then skip both
        # the release and the callbacks — a killed process runs neither
        self._crashed = False

    # -- lease record ------------------------------------------------------- #

    def _try_acquire_or_renew(self) -> bool:
        leases = self.client.leases
        was_leading = self._leading.is_set()
        now = time.time()
        try:
            lease = leases.get(self.cfg.lock_name, self.cfg.lock_namespace)
        except errors.StatusError as e:
            if not errors.is_not_found(e):
                return False
            try:
                created = leases.create({
                    "apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
                    "metadata": {"name": self.cfg.lock_name,
                                 "namespace": self.cfg.lock_namespace},
                    "spec": self._record(now)})
                self._fence_token = int(
                    created.get("spec", {}).get("leaseTransitions", 0))
                self._observe(self.cfg.identity)
                return True
            except errors.StatusError:
                return False

        spec = lease.get("spec", {})
        holder = spec.get("holderIdentity", "")
        renew = float(spec.get("renewTime", 0) or 0)
        # expiry honors the HOLDER's advertised duration, not ours — a
        # candidate with a shorter configured lease must not steal early
        holder_duration = float(spec.get("leaseDurationSeconds",
                                         self.cfg.lease_duration) or 0)
        if (holder and holder != self.cfg.identity
                and renew + holder_duration > now):
            self._observe(holder)
            if was_leading:
                # we thought we led, the record says someone else does and
                # their lease is LIVE: leadership is already lost — waiting
                # out renew_deadline would keep two fencing tokens active
                self._deposed = True
            return False  # someone else holds a live lease
        # claim/renew via CAS on resourceVersion
        transitions = int(spec.get("leaseTransitions", 0)) \
            + (0 if holder == self.cfg.identity else 1)
        lease["spec"] = self._record(
            now, transitions=transitions,
            acquire=spec.get("acquireTime", now)
            if holder == self.cfg.identity else now)
        try:
            leases.update(lease, self.cfg.lock_namespace)
            self._fence_token = transitions
            self._observe(self.cfg.identity)
            return True
        except errors.StatusError as e:
            if was_leading and errors.is_conflict(e):
                # a CAS conflict while RENEWING means a concurrent writer
                # touched our lease — the only writers are candidates who
                # judged it expired (and may already have claimed it). The
                # reference treats this as immediate loss; retrying until
                # the deadline would leave a window where the usurper's
                # fencing token and ours are both live.
                self._deposed = True
            return False

    def _record(self, now: float, transitions: int = 0,
                acquire: Optional[float] = None) -> dict:
        return {"holderIdentity": self.cfg.identity,
                "leaseDurationSeconds": self.cfg.lease_duration,
                "acquireTime": acquire if acquire is not None else now,
                "renewTime": now,
                "leaseTransitions": transitions}

    def _observe(self, leader: str) -> None:
        if leader != self._observed_leader:
            self._observed_leader = leader
            self.cfg.on_new_leader(leader)

    def _release(self) -> bool:
        """Release the Lease on graceful stop (client-go le.release()):
        zero renewTime and clear the holder via a CAS update, so the next
        candidate acquires immediately instead of waiting out a full
        lease_duration of a holder that is already gone."""
        leases = self.client.leases
        try:
            lease = leases.get(self.cfg.lock_name, self.cfg.lock_namespace)
        except errors.StatusError:
            return False
        spec = lease.get("spec", {})
        if spec.get("holderIdentity", "") != self.cfg.identity:
            return False  # not ours (lost it already) — never stomp a peer
        lease["spec"] = {
            "holderIdentity": "",
            "leaseDurationSeconds": 1,
            "renewTime": 0,
            "acquireTime": 0,
            "leaseTransitions": int(spec.get("leaseTransitions", 0)),
        }
        try:
            # resourceVersion rides along from the get → the update is a CAS:
            # if a peer claimed the lease in between, the write conflicts and
            # their claim stands
            leases.update(lease, self.cfg.lock_namespace)
            return True
        except errors.StatusError:
            return False

    def _jittered(self, period: float) -> float:
        return jittered(period, JITTER)

    # -- run loop (leaderelection.go Run: acquire → renew → lost) ----------- #

    def run(self) -> None:
        try:
            self._run_loop()
        finally:
            # the release belongs to the thread that can still be renewing:
            # stop()'s own release can race an in-flight acquire/renew here
            # (release lands, THIS thread's CAS then re-acquires the freshly
            # cleared lease, and the process exits holding it). Releasing on
            # loop exit closes that window; _release() no-ops unless the
            # lease carries our identity. A crash()ed elector releases
            # NOTHING — a dead process cannot — so failover waits out the
            # lease like real takeover does.
            if not self._crashed:
                self._release()

    def _run_loop(self) -> None:
        while not self._stop.is_set():
            # acquire phase
            while not self._stop.is_set():
                if self._try_acquire_or_renew():
                    break
                if self._stop.wait(self._jittered(self.cfg.retry_period)):
                    return
            if self._stop.is_set():
                return
            self._deposed = False
            self._leading.set()
            self.cfg.on_started_leading()
            # renew phase
            deadline = time.monotonic() + self.cfg.renew_deadline
            while not self._stop.is_set():
                if self._try_acquire_or_renew():
                    deadline = time.monotonic() + self.cfg.renew_deadline
                elif self._deposed or time.monotonic() > deadline:
                    # deposed: PROOF of loss (live usurper observed, or our
                    # renew CAS conflicted) — drop leadership now instead
                    # of serving out the deadline with a stale token live
                    break
                if self._stop.wait(self._jittered(self.cfg.retry_period)):
                    break
            self._leading.clear()
            if self._crashed:
                return  # a killed process runs no callbacks
            self.cfg.on_stopped_leading()

    def start(self) -> "LeaderElector":
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name=f"leader-{self.cfg.lock_name}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread_done = True
        if self._thread is not None:
            self._thread.join(timeout=3)
            thread_done = not self._thread.is_alive()
        if self._leading.is_set():
            self._leading.clear()
            self.cfg.on_stopped_leading()
        # graceful handoff: failover shouldn't wait out lease_duration.
        # Released here only once the run thread has actually exited — a
        # still-running thread could re-acquire right after our release
        # (its in-flight CAS sees the cleared holder) and orphan the lease;
        # in that case run()'s own on-exit release is the one that counts.
        # _release() no-ops unless the Lease carries OUR identity.
        if thread_done:
            self._release()

    def crash(self) -> None:
        """Simulated abrupt process death (restart drills, the bench
        `failover` stage): the election thread stops WITHOUT releasing the
        Lease and WITHOUT firing on_stopped_leading — exactly what SIGKILL
        leaves behind. The next candidate must wait out lease_duration, and
        this incarnation's fencing token goes stale the moment they claim."""
        self._crashed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=3)
        self._leading.clear()

    @property
    def is_leader(self) -> bool:
        return self._leading.is_set()

    @property
    def fencing_token(self) -> int:
        """The lease generation (leaseTransitions) of this elector's most
        recent acquisition — stamp it into every write that must not
        survive a leadership change. Deliberately NOT gated on is_leader:
        a deposed incarnation keeps its stale token so its in-flight
        writes are rejected rather than silently unstamped."""
        return self._fence_token

    def wait_for_leadership(self, timeout: float = 10.0) -> bool:
        return self._leading.wait(timeout)
