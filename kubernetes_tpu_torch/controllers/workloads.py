"""Workload controllers: ReplicaSet/RC, Deployment, StatefulSet, DaemonSet,
Job, CronJob.

Analog of `pkg/controller/{replicaset,deployment,statefulset,daemon,job,
cronjob}`. Each follows the sync(key) contract: lister reads → diff desired
vs actual → clientset writes → status update with observedGeneration.
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Optional

from ..client.informers import InformerFactory, pods_by_node_index
from ..controllers.base import (
    Controller,
    Expectations,
    is_pod_active,
    is_pod_ready,
    pod_from_template,
)
from ..machinery import errors, labels as mlabels, meta


def _selector_fn(sel: Optional[Dict]):
    s = mlabels.from_label_selector(sel)
    return lambda o: s.matches(meta.labels_of(o))


class ReplicaSetController(Controller):
    """replica_set.go:610 syncReplicaSet + manageReplicas. Also serves
    ReplicationControllers when attr='replicationcontrollers' (the reference
    RC controller is the same code behind an adapter)."""

    name = "replicaset"
    burst_replicas = 500

    def __init__(self, client, factory: InformerFactory,
                 attr: str = "replicasets", owner_kind: str = "ReplicaSet"):
        super().__init__(client, factory)
        self.attr = attr
        self.owner_kind = owner_kind
        self.expectations = Expectations()
        self.rs_informer = self.watch_resource(attr)
        self.pod_informer = self.watch_owned("pods", owner_kind,
                                             expectations=self.expectations)

    def _rc(self):
        return getattr(self.client, self.attr)

    def sync(self, key: str) -> None:
        ns, name = meta.split_key(key)
        rs = self.rs_informer.lister.get(ns, name)
        if rs is None:
            self.expectations.forget(key)
            return
        if meta.is_being_deleted(rs):
            return
        if not self.expectations.satisfied(key):
            return  # prior creations/deletions not yet observed; event-driven
            # observation re-enqueues this key (replica_set.go:610 needsSync)
        spec = rs.get("spec", {})
        desired = int(spec.get("replicas", 1))
        match = _selector_fn(spec.get("selector")
                             or {"matchLabels":
                                 (spec.get("template", {}).get("metadata", {})
                                  .get("labels") or {})})
        my_uid = meta.uid(rs)

        pods = [p for p in self.pod_informer.lister.list(ns)
                if match(p) and is_pod_active(p)
                and (meta.controller_ref(p) or {}).get("uid") == my_uid]

        diff = desired - len(pods)
        if diff > 0:
            n = min(diff, self.burst_replicas)
            self.expectations.expect_creations(key, n)
            created = 0
            for _ in range(n):
                try:
                    self.client.pods.create(
                        pod_from_template(rs, spec.get("template", {})), ns)
                    created += 1
                except errors.StatusError:
                    break
            for _ in range(n - created):  # lower expectations for failures
                self.expectations.creation_observed(key)
        elif diff < 0:
            # prefer deleting not-ready, then youngest (getPodsToDelete
            # ranking: newer pods go first among equally-ready ones)
            victims = sorted(
                pods, key=lambda p: p["metadata"].get("creationTimestamp", ""),
                reverse=True)
            victims.sort(key=is_pod_ready)  # stable: not-ready first
            victims = victims[:(-diff)]
            self.expectations.expect_deletions(key, len(victims))
            for p in victims:
                try:
                    self.client.pods.delete(meta.name(p), ns)
                except errors.StatusError:
                    self.expectations.deletion_observed(key)

        ready = sum(1 for p in pods if is_pod_ready(p))
        status = {
            "replicas": len(pods),
            "fullyLabeledReplicas": len(pods),
            "readyReplicas": ready,
            "availableReplicas": ready,
            "observedGeneration": meta.generation(rs),
        }
        if rs.get("status", {}) != status:
            cur = meta.deep_copy(rs)
            cur["status"] = status
            try:
                self._rc().update_status(cur, ns)
            except errors.StatusError:
                pass


def pod_template_hash(template: Dict) -> str:
    """deployment util ComputeHash: stable hash of the pod template."""
    import json
    raw = json.dumps(template, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(raw.encode()).hexdigest()[:10]


REVISION_ANN = "deployment.kubernetes.io/revision"


def rs_revision(rs: Dict) -> int:
    """A ReplicaSet's deployment revision (deployment_util.go Revision):
    the one parse shared by the controller and kubectl rollout."""
    try:
        return int((rs.get("metadata", {}).get("annotations") or {})
                   .get(REVISION_ANN, 0) or 0)
    except (TypeError, ValueError):
        return 0


class DeploymentController(Controller):
    """deployment_controller.go syncDeployment: own ReplicaSets keyed by
    pod-template-hash; rolling update scales new up / old down within
    maxSurge/maxUnavailable."""

    name = "deployment"

    def __init__(self, client, factory: InformerFactory):
        super().__init__(client, factory)
        self.d_informer = self.watch_resource("deployments")
        self.rs_informer = self.watch_owned("replicasets", "Deployment")

    def sync(self, key: str) -> None:
        ns, name = meta.split_key(key)
        d = self.d_informer.lister.get(ns, name)
        if d is None or meta.is_being_deleted(d):
            return
        spec = d.get("spec", {})
        desired = int(spec.get("replicas", 1))
        template = meta.deep_copy(spec.get("template", {}))
        thash = pod_template_hash(template)
        my_uid = meta.uid(d)

        all_rs = [rs for rs in self.rs_informer.lister.list(ns)
                  if (meta.controller_ref(rs) or {}).get("uid") == my_uid]
        new_rs = next((rs for rs in all_rs
                       if rs["metadata"].get("labels", {})
                       .get("pod-template-hash") == thash), None)
        max_rev = max((rs_revision(rs) for rs in all_rs), default=0)

        if new_rs is None:
            tmpl = meta.deep_copy(template)
            tmpl.setdefault("metadata", {}).setdefault("labels", {})[
                "pod-template-hash"] = thash
            sel = meta.deep_copy(spec.get("selector", {}))
            sel.setdefault("matchLabels", {})["pod-template-hash"] = thash
            rs_obj = {
                "apiVersion": "apps/v1", "kind": "ReplicaSet",
                "metadata": {
                    "name": f"{name}-{thash}", "namespace": ns,
                    "labels": dict(tmpl["metadata"]["labels"]),
                    # revision history (deployment_util.go Revision/
                    # SetNewReplicaSetAnnotations): every template change
                    # gets the next revision; rollout history/undo read it
                    "annotations": {REVISION_ANN: str(max_rev + 1)},
                    "ownerReferences": [meta.owner_reference(d)],
                },
                "spec": {"replicas": 0, "selector": sel, "template": tmpl},
            }
            try:
                new_rs = self.client.replicasets.create(rs_obj, ns)
            except errors.StatusError as e:
                if not errors.is_already_exists(e):
                    raise
                new_rs = self.client.replicasets.get(f"{name}-{thash}", ns)
            self.enqueue_key(key)  # reconcile scaling next pass
        else:
            my_rev = rs_revision(new_rs)
            if my_rev < max_rev:
                # a rollback re-activated an old template: it becomes the
                # NEWEST revision (deployment_util.go: revision bumps, the
                # history never rewinds)
                try:
                    cur = self.client.replicasets.get(meta.name(new_rs), ns)
                    cur["metadata"].setdefault("annotations", {})[
                        REVISION_ANN] = str(max_rev + 1)
                    self.client.replicasets.update(cur, ns)
                except errors.StatusError:
                    pass

        old_rses = [rs for rs in all_rs
                    if meta.name(rs) != meta.name(new_rs)]
        strategy = spec.get("strategy", {})
        if strategy.get("type") == "Recreate":
            # scale all old to 0 first; scale new up once old report 0
            for rs in old_rses:
                if int(rs["spec"].get("replicas", 0)) != 0:
                    self._scale(rs, 0, ns)
            if all(int(rs.get("status", {}).get("replicas", 0)) == 0
                   for rs in old_rses):
                if int(new_rs["spec"].get("replicas", 0)) != desired:
                    self._scale(new_rs, desired, ns)
        else:
            ru = strategy.get("rollingUpdate", {})
            max_surge = _resolve_pct(ru.get("maxSurge", "25%"), desired)
            max_unavail = _resolve_pct(
                ru.get("maxUnavailable", "25%"), desired, round_up=False)
            if max_surge == 0 and max_unavail == 0:
                max_unavail = 1
            total = sum(int(rs["spec"].get("replicas", 0))
                        for rs in all_rs)
            new_want = int(new_rs["spec"].get("replicas", 0))
            # scale up new within surge budget
            allowed_up = desired + max_surge - total
            if new_want < desired and allowed_up > 0:
                self._scale(new_rs, min(desired, new_want + allowed_up), ns)
                self.enqueue_key(key)
            # scale down old within availability budget
            ready_total = sum(int(rs.get("status", {}).get("readyReplicas", 0))
                              for rs in all_rs)
            can_remove = ready_total - (desired - max_unavail)
            for rs in sorted(old_rses,
                             key=lambda r: meta.name(r)):
                cur = int(rs["spec"].get("replicas", 0))
                if cur == 0 or can_remove <= 0:
                    continue
                step = min(cur, can_remove)
                self._scale(rs, cur - step, ns)
                can_remove -= step
                self.enqueue_key(key)

        # status roll-up (calculateStatus)
        replicas = sum(int(rs.get("status", {}).get("replicas", 0))
                       for rs in all_rs)
        ready = sum(int(rs.get("status", {}).get("readyReplicas", 0))
                    for rs in all_rs)
        updated = int(new_rs.get("status", {}).get("replicas", 0))
        status = {"replicas": replicas, "updatedReplicas": updated,
                  "readyReplicas": ready, "availableReplicas": ready,
                  "observedGeneration": meta.generation(d)}
        if d.get("status", {}) != status:
            cur = meta.deep_copy(d)
            cur["status"] = status
            try:
                self.client.deployments.update_status(cur, ns)
            except errors.StatusError:
                pass

    def _scale(self, rs: Dict, replicas: int, ns: str) -> None:
        for _ in range(3):  # retry optimistic-concurrency conflicts
            try:
                cur = self.client.replicasets.get(meta.name(rs), ns)
                cur["spec"]["replicas"] = replicas
                self.client.replicasets.update(cur, ns)
                return
            except errors.StatusError as e:
                if not errors.is_conflict(e):
                    return


def _resolve_pct(v, total: int, round_up: bool = True) -> int:
    """GetValueFromIntOrPercent: maxSurge rounds up, maxUnavailable rounds
    DOWN so availability never dips below the requested floor
    (deployment/util ResolveFenceposts)."""
    if isinstance(v, str) and v.endswith("%"):
        import math
        frac = total * int(v[:-1]) / 100
        return math.ceil(frac) if round_up else math.floor(frac)
    return int(v)


class StatefulSetController(Controller):
    """statefulset: ordered, stable-identity pods <name>-<ordinal>
    (stateful_set_control.go), OrderedReady semantics."""

    name = "statefulset"

    def __init__(self, client, factory: InformerFactory):
        super().__init__(client, factory)
        self.ss_informer = self.watch_resource("statefulsets")
        self.pod_informer = self.watch_owned("pods", "StatefulSet")

    def _ensure_claims(self, ss: Dict, ns: str, name: str, ordinal: int,
                       pod: Dict) -> None:
        """volumeClaimTemplates → one PVC per template per ordinal,
        `<tmpl>-<sts>-<ordinal>` (stateful_set_utils.go getPersistentVolume
        Claims), wired into the pod's volumes. Claims are RETAINED across
        pod deletion and scale-down — the stable-storage contract — so an
        ordinal that comes back rebinds its old data."""
        for vct in ss.get("spec", {}).get("volumeClaimTemplates", []) or []:
            cname = (vct.get("metadata", {}) or {}).get("name", "data")
            claim_name = f"{cname}-{name}-{ordinal}"
            try:
                self.client.persistentvolumeclaims.get(claim_name, ns)
            except errors.StatusError:
                tmpl_labels = ((ss.get("spec", {}).get("template", {})
                                .get("metadata", {}) or {})
                               .get("labels") or {})
                claim = {
                    "apiVersion": "v1", "kind": "PersistentVolumeClaim",
                    "metadata": {"name": claim_name, "namespace": ns,
                                 "labels": dict(tmpl_labels)},
                    "spec": meta.deep_copy(vct.get("spec", {})),
                }
                try:
                    self.client.persistentvolumeclaims.create(claim, ns)
                except errors.StatusError as e:
                    if not errors.is_already_exists(e):
                        raise
            # the claim OWNS its name: a same-named template volume is
            # replaced, not shadowed (stateful_set_utils.go updateStorage)
            vols = pod["spec"].setdefault("volumes", [])
            vols[:] = [v for v in vols if v.get("name") != cname]
            vols.append({"name": cname,
                         "persistentVolumeClaim":
                         {"claimName": claim_name}})

    def sync(self, key: str) -> None:
        ns, name = meta.split_key(key)
        ss = self.ss_informer.lister.get(ns, name)
        if ss is None or meta.is_being_deleted(ss):
            return
        spec = ss.get("spec", {})
        desired = int(spec.get("replicas", 1))
        ordered = spec.get("podManagementPolicy", "OrderedReady") == "OrderedReady"
        my_uid = meta.uid(ss)
        owned = {meta.name(p): p for p in self.pod_informer.lister.list(ns)
                 if (meta.controller_ref(p) or {}).get("uid") == my_uid}

        # create missing ordinals in order; OrderedReady waits for readiness
        for i in range(desired):
            pname = f"{name}-{i}"
            pod = owned.get(pname)
            if pod is None:
                tmpl = spec.get("template", {})
                p = pod_from_template(ss, tmpl, name=pname)
                p["metadata"].setdefault("labels", {})[
                    "statefulset.kubernetes.io/pod-name"] = pname
                p["spec"]["hostname"] = pname
                p["spec"]["subdomain"] = spec.get("serviceName", "")
                self._ensure_claims(ss, ns, name, i, p)
                try:
                    self.client.pods.create(p, ns)
                except errors.StatusError as e:
                    if not errors.is_already_exists(e):
                        raise
                if ordered:
                    return  # wait for this one before the next ordinal
            elif ordered and not is_pod_ready(pod) and is_pod_active(pod):
                return

        # delete extra ordinals from the top down (numeric ordinal order —
        # lexicographic would delete web-9 before web-10)
        def _ordinal(pname: str) -> int:
            try:
                return int(pname.rsplit("-", 1)[1])
            except (IndexError, ValueError):
                return -1

        for pname in sorted(owned, key=_ordinal, reverse=True):
            ordinal = _ordinal(pname)
            if ordinal >= desired:
                try:
                    self.client.pods.delete(pname, ns)
                except errors.StatusError:
                    pass
                if ordered:
                    break

        ready = sum(1 for p in owned.values() if is_pod_ready(p))
        status = {"replicas": len(owned), "readyReplicas": ready,
                  "currentReplicas": len(owned),
                  "updatedReplicas": len(owned),
                  "observedGeneration": meta.generation(ss)}
        if ss.get("status", {}) != status:
            cur = meta.deep_copy(ss)
            cur["status"] = status
            try:
                self.client.statefulsets.update_status(cur, ns)
            except errors.StatusError:
                pass


DAEMON_TOLERATIONS = [
    # util/daemonset_util.go AddOrUpdateDaemonPodTolerations: daemons ride
    # out node conditions ordinary pods are evicted/repelled by
    {"key": "node.kubernetes.io/not-ready",
     "operator": "Exists", "effect": "NoExecute"},
    {"key": "node.kubernetes.io/unreachable",
     "operator": "Exists", "effect": "NoExecute"},
    {"key": "node.kubernetes.io/memory-pressure",
     "operator": "Exists", "effect": "NoSchedule"},
    {"key": "node.kubernetes.io/disk-pressure",
     "operator": "Exists", "effect": "NoSchedule"},
    {"key": "node.kubernetes.io/unschedulable",
     "operator": "Exists", "effect": "NoSchedule"},
]


def _daemon_pod_target(p: Dict) -> str:
    """The node a daemon pod is FOR: spec.nodeName once bound, else the
    metadata.name node-affinity target it was created with — a pending
    daemon pod must count against its node or the controller would spawn
    duplicates every sync while the scheduler works."""
    nn = p.get("spec", {}).get("nodeName", "")
    if nn:
        return nn
    from ..api.v1 import node_names_from_terms

    names = node_names_from_terms(
        ((p.get("spec", {}).get("affinity") or {})
         .get("nodeAffinity") or {}).get(
            "requiredDuringSchedulingIgnoredDuringExecution", {}).get(
            "nodeSelectorTerms", []))
    return names[0] if names else ""


class DaemonSetController(Controller):
    """daemon/daemon_controller.go: one pod per eligible node, each bound by
    the default scheduler through metadata.name node affinity
    (ScheduleDaemonSetPods)."""

    name = "daemonset"

    def __init__(self, client, factory: InformerFactory, clock=time.time):
        super().__init__(client, factory)
        self.clock = clock
        self.ds_informer = self.watch_resource("daemonsets")
        self.pod_informer = self.watch_owned("pods", "DaemonSet")
        # failed-daemon backoff (daemon_controller.go failedPodsBackoff,
        # 1s→2^n capped): a crash-failing daemon must not delete/create in
        # a tight loop as fast as events arrive. Bumps once per failed POD
        # (by uid, not per sync observing the cached corpse); resets when
        # the node's daemon turns Ready; pruned with its DaemonSet.
        self._failed_backoff: Dict[tuple, tuple] = {}  # (key,node)→(n,next)
        self._counted_failures: set = set()            # pod uids
        # node changes re-sync every daemonset — registered ONCE here:
        # registering in poll_once would append a fresh handler triple to
        # the shared node informer every tick (unbounded growth, O(nodes)
        # synthetic on_add replays per tick)
        self.node_informer = self.factory.informer("nodes")
        self.node_informer.add_handlers(
            on_add=lambda o: self._enqueue_all(),
            on_update=lambda o, n: self._enqueue_all(),
            on_delete=lambda o: self._enqueue_all())

    def poll_once(self, now=None) -> None:
        """Backoff-expiry retries: nothing re-enqueues a DaemonSet when a
        replacement window lapses (no AddAfter machinery), so the manager's
        poll tick drives it — only for sets that actually hold backoffs."""
        pending = {k for (k, _n) in self._failed_backoff}
        for ds in self.ds_informer.lister.list():
            if meta.namespaced_key(ds) in pending:
                self.enqueue(ds)

    def _enqueue_all(self) -> None:
        for ds in self.ds_informer.lister.list():
            self.enqueue(ds)

    def _node_eligible(self, ds: Dict, node: Dict) -> bool:
        """Simulate the scheduling gates the reference checks
        (nodeShouldRunDaemonPod): nodeSelector, NoSchedule taints not
        tolerated. Cordons do NOT exclude: daemon pods carry the
        unschedulable toleration (ScheduleDaemonSetPods semantics — a
        cordoned node keeps its daemon), so unschedulable is left to the
        scheduler's taint filter."""
        nsel = (ds.get("spec", {}).get("template", {}).get("spec", {})
                .get("nodeSelector") or {})
        nlabels = meta.labels_of(node)
        if any(nlabels.get(k) != v for k, v in nsel.items()):
            return False
        # evaluate taints WITH the daemon toleration set the controller
        # itself adds at creation — otherwise eligibility would delete the
        # very pods those tolerations exist to keep (e.g. an unreachable
        # NoExecute taint during a heartbeat gap)
        tolerations = list(
            ds.get("spec", {}).get("template", {}).get("spec", {})
            .get("tolerations") or []) + DAEMON_TOLERATIONS
        for t in node.get("spec", {}).get("taints", []) or []:
            if t.get("effect") not in ("NoSchedule", "NoExecute"):
                continue
            tolerated = any(
                (tol.get("key") in (t.get("key"), "", None)
                 and (tol.get("operator", "Equal") == "Exists"
                      or tol.get("value", "") == t.get("value", "")))
                for tol in tolerations)
            if not tolerated:
                return False
        return True

    def sync(self, key: str) -> None:
        ns, name = meta.split_key(key)
        ds = self.ds_informer.lister.get(ns, name)
        if ds is None or meta.is_being_deleted(ds):
            for bk in [bk for bk in self._failed_backoff if bk[0] == key]:
                del self._failed_backoff[bk]
            if len(self._counted_failures) > 4096:
                self._counted_failures.clear()  # bounded: uids are one-shot
            return
        my_uid = meta.uid(ds)
        owned_by_node: Dict[str, List[Dict]] = {}
        for p in self.pod_informer.lister.list(ns):
            if (meta.controller_ref(p) or {}).get("uid") != my_uid:
                continue
            phase = p.get("status", {}).get("phase")
            if phase in ("Succeeded", "Failed"):
                # a terminated daemon pod is deleted and replaced, never
                # counted (podsShouldBeOnNode) — replacement honors the
                # per-node failure backoff below
                if phase == "Failed" and meta.uid(p) not in \
                        self._counted_failures:
                    self._counted_failures.add(meta.uid(p))
                    bkey = (key, _daemon_pod_target(p))
                    n, _ = self._failed_backoff.get(bkey, (0, 0.0))
                    self._failed_backoff[bkey] = (
                        n + 1, self.clock() + min(2.0 ** n, 300.0))
                try:
                    self.client.pods.delete(meta.name(p), ns)
                except errors.StatusError:
                    pass
                continue
            owned_by_node.setdefault(_daemon_pod_target(p), []).append(p)

        eligible = [n for n in self.node_informer.lister.list()
                    if self._node_eligible(ds, n)]
        for node in eligible:
            nname = meta.name(node)
            node_pods = owned_by_node.get(nname)
            if node_pods and any(is_pod_ready(p) for p in node_pods):
                # the replacement runs: the slate is clean
                # (failedPodsBackoff resets after sustained success)
                self._failed_backoff.pop((key, nname), None)
            if not node_pods:
                _, until = self._failed_backoff.get((key, nname), (0, 0.0))
                if self.clock() < until:
                    # the manager's periodic resync re-enqueues after the
                    # backoff window; an immediate re-enqueue here would be
                    # the busy loop the backoff exists to prevent
                    continue
                p = pod_from_template(ds, ds["spec"].get("template", {}),
                                      generate_name=f"{name}-")
                # ScheduleDaemonSetPods (GA at the reference's vintage,
                # daemon_controller.go nodeAffinity path): the pod targets
                # its node through required node affinity on
                # metadata.name and is bound by the DEFAULT SCHEDULER —
                # resources, ports and the full filter chain apply — with
                # the daemon toleration set letting it land on pressured
                # or not-ready nodes (util/daemonset_util.go
                # AddOrUpdateDaemonPodTolerations)
                aff = p["spec"].setdefault("affinity", {}).setdefault(
                    "nodeAffinity", {})
                aff["requiredDuringSchedulingIgnoredDuringExecution"] = {
                    "nodeSelectorTerms": [{"matchFields": [{
                        "key": "metadata.name", "operator": "In",
                        "values": [nname]}]}]}
                p["spec"].setdefault("tolerations", []).extend(
                    dict(t) for t in DAEMON_TOLERATIONS)
                self.client.pods.create(p, ns)
        eligible_names = {meta.name(n) for n in eligible}
        for nname, pods in owned_by_node.items():
            # keep the best duplicate: bound beats pending, ready beats
            # not-ready (the reference ranks duplicates the same way) — a
            # create/lister race must not kill the RUNNING daemon in favor
            # of its pending twin
            pods.sort(key=lambda p: (bool(p.get("spec", {})
                                          .get("nodeName")),
                                     is_pod_ready(p)), reverse=True)
            extra = pods[1:] if nname in eligible_names else pods
            for p in extra:
                try:
                    self.client.pods.delete(meta.name(p), ns)
                except errors.StatusError:
                    pass

        scheduled = sum(
            1 for n, ps in owned_by_node.items()
            if n and any(p.get("spec", {}).get("nodeName") for p in ps))
        ready = sum(1 for ps in owned_by_node.values()
                    for p in ps if is_pod_ready(p))
        status = {"desiredNumberScheduled": len(eligible),
                  "currentNumberScheduled": scheduled,
                  "numberReady": ready,
                  "numberMisscheduled": 0,
                  "observedGeneration": meta.generation(ds)}
        if ds.get("status", {}) != status:
            cur = meta.deep_copy(ds)
            cur["status"] = status
            try:
                self.client.daemonsets.update_status(cur, ns)
            except errors.StatusError:
                pass


class JobController(Controller):
    """job/job_controller.go syncJob: run parallelism pods until completions
    succeed; backoffLimit failures → Failed condition."""

    name = "job"

    def __init__(self, client, factory: InformerFactory, clock=time.time):
        super().__init__(client, factory)
        self.expectations = Expectations()
        self.clock = clock
        self.job_informer = self.watch_resource("jobs")
        self.pod_informer = self.watch_owned("pods", "Job",
                                             expectations=self.expectations)

    def poll_once(self, now=None) -> None:
        """Deadline sweep (the reference re-enqueues at the deadline via
        AddAfter; here the manager's poll tick drives it). Finished jobs
        are skipped — the sweep stays proportional to in-flight work."""
        for job in self.job_informer.lister.list():
            if job.get("spec", {}).get("activeDeadlineSeconds") is None:
                continue
            if any(c.get("type") in ("Complete", "Failed")
                   and c.get("status") == "True"
                   for c in job.get("status", {}).get("conditions", [])):
                continue
            self.enqueue(job)

    def sync(self, key: str) -> None:
        ns, name = meta.split_key(key)
        job = self.job_informer.lister.get(ns, name)
        if job is None or meta.is_being_deleted(job):
            self.expectations.forget(key)
            return
        if not self.expectations.satisfied(key):
            return  # await informer observation of dispatched creations
        spec = job.get("spec", {})
        completions = int(spec.get("completions", 1))
        parallelism = int(spec.get("parallelism", 1))
        backoff_limit = int(spec.get("backoffLimit", 6))
        my_uid = meta.uid(job)
        pods = [p for p in self.pod_informer.lister.list(ns)
                if (meta.controller_ref(p) or {}).get("uid") == my_uid]
        succeeded = sum(1 for p in pods
                        if p.get("status", {}).get("phase") == "Succeeded")
        failed = sum(1 for p in pods
                     if p.get("status", {}).get("phase") == "Failed")
        active = [p for p in pods if is_pod_active(p)]

        conditions = list(job.get("status", {}).get("conditions", []))
        done = any(c.get("type") in ("Complete", "Failed")
                   and c.get("status") == "True" for c in conditions)

        now = self.clock()
        start_unix = job.get("status", {}).get("startUnix") or now
        deadline = spec.get("activeDeadlineSeconds")
        past_deadline = (
            not done and deadline is not None
            and now - start_unix >= float(deadline))

        if not done:
            if past_deadline:
                # syncJob pastActiveDeadline: the job fails wholesale and
                # its active pods are killed (job_controller.go)
                conditions.append({"type": "Failed", "status": "True",
                                   "reason": "DeadlineExceeded",
                                   "message": "Job was active longer than "
                                              "specified deadline",
                                   "lastTransitionTime": meta.now_rfc3339()})
                for p in active:
                    try:
                        self.client.pods.delete(meta.name(p), ns)
                    except errors.StatusError:
                        pass
            elif failed > backoff_limit:
                conditions.append({"type": "Failed", "status": "True",
                                   "reason": "BackoffLimitExceeded",
                                   "lastTransitionTime": meta.now_rfc3339()})
                for p in active:
                    try:
                        self.client.pods.delete(meta.name(p), ns)
                    except errors.StatusError:
                        pass
            elif succeeded >= completions:
                conditions.append({"type": "Complete", "status": "True",
                                   "lastTransitionTime": meta.now_rfc3339()})
            else:
                want_active = min(parallelism, completions - succeeded)
                n = max(0, want_active - len(active))
                if n:
                    self.expectations.expect_creations(key, n)
                    created = 0
                    for _ in range(n):
                        try:
                            self.client.pods.create(
                                pod_from_template(job,
                                                  spec.get("template", {})), ns)
                            created += 1
                        except errors.StatusError:
                            break
                    for _ in range(n - created):
                        self.expectations.creation_observed(key)

        status = {"active": len(active), "succeeded": succeeded,
                  "failed": failed, "conditions": conditions,
                  # startUnix/completionUnix: the float-clock carriers this
                  # codebase uses beside RFC3339 strings (cf. the kubelet's
                  # heartbeatUnix) — deadline + TTL math reads them
                  "startUnix": job.get("status", {}).get("startUnix", now)}
        if any(c.get("type") in ("Complete", "Failed")
               and c.get("status") == "True" for c in conditions):
            status["completionUnix"] = job.get("status", {}).get(
                "completionUnix", now)
        if job.get("status", {}) != status:
            cur = meta.deep_copy(job)
            cur["status"] = status
            try:
                self.client.jobs.update_status(cur, ns)
            except errors.StatusError:
                pass


class CronJobController(Controller):
    """cronjob_controller.go: poll-driven (the reference syncs every 10 s
    rather than watching); spawns Jobs on schedule."""

    name = "cronjob"

    def __init__(self, client, factory: InformerFactory,
                 clock=time.time):
        super().__init__(client, factory)
        self.clock = clock
        self.cj_informer = self.watch_resource("cronjobs")

    def poll_once(self, now: Optional[float] = None) -> None:
        """One sweep over all CronJobs (syncAll)."""
        now = self.clock() if now is None else now
        for cj in self.cj_informer.lister.list():
            self._sync_one(cj, now)

    def sync(self, key: str) -> None:
        ns, name = meta.split_key(key)
        cj = self.cj_informer.lister.get(ns, name)
        if cj is not None:
            self._sync_one(cj, self.clock())

    def _sync_one(self, cj: Dict, now: float) -> None:
        ns, name = meta.namespace(cj), meta.name(cj)
        spec = cj.get("spec", {})
        if spec.get("suspend"):
            return
        period = cron_period_seconds(spec.get("schedule", ""))
        if period is None:
            return
        last = float(cj.get("status", {}).get("lastScheduleUnix", 0) or 0)
        if now - last < period:
            return
        job_name = f"{name}-{int(now)}"
        job = {
            "apiVersion": "batch/v1", "kind": "Job",
            "metadata": {"name": job_name, "namespace": ns,
                         "ownerReferences": [meta.owner_reference(cj)]},
            "spec": meta.deep_copy(
                spec.get("jobTemplate", {}).get("spec", {})),
        }
        try:
            self.client.jobs.create(job, ns)
        except errors.StatusError as e:
            if not errors.is_already_exists(e):
                return
        cur = meta.deep_copy(cj)
        cur["status"] = {"lastScheduleTime": meta.now_rfc3339(),
                         "lastScheduleUnix": now}
        try:
            self.client.cronjobs.update_status(cur, ns)
        except errors.StatusError:
            pass


def cron_period_seconds(schedule: str) -> Optional[float]:
    """Minimal cron cadence: supports '@every Ns/Nm/Nh' and the classic
    '*/N * * * *' minute-step form (the shapes our tests and tooling emit)."""
    s = schedule.strip()
    if s.startswith("@every "):
        unit = s[-1]
        try:
            n = float(s[7:-1])
        except ValueError:
            return None
        return n * {"s": 1, "m": 60, "h": 3600}.get(unit, 0) or None
    fields = s.split()
    if len(fields) == 5:
        minute = fields[0]
        if minute.startswith("*/"):
            try:
                return float(minute[2:]) * 60
            except ValueError:
                return None
        if minute == "*":
            return 60.0
        return 3600.0  # fixed minute ⇒ hourly cadence
    return None


class TTLAfterFinishedController(Controller):
    """ttlafterfinished/ttlafterfinished_controller.go: finished Jobs
    carrying spec.ttlSecondsAfterFinished are deleted once the TTL since
    completion elapses (the pods follow through ownerRef GC). Poll-driven
    here, like the reference's AddAfter requeues collapsed onto the
    manager's tick."""

    name = "ttlafterfinished"

    def __init__(self, client, factory: InformerFactory, clock=time.time):
        super().__init__(client, factory)
        self.clock = clock
        self.job_informer = self.watch_resource("jobs")

    def poll_once(self, now=None) -> None:
        # `now` is the manager's poll signature; the sync path reads the
        # controller clock itself at decision time
        for job in self.job_informer.lister.list():
            if job.get("spec", {}).get("ttlSecondsAfterFinished") is None:
                continue
            if any(c.get("type") in ("Complete", "Failed")
                   and c.get("status") == "True"
                   for c in job.get("status", {}).get("conditions", [])):
                self.enqueue(job)

    def sync(self, key: str) -> None:
        ns, name = meta.split_key(key)
        job = self.job_informer.lister.get(ns, name)
        if job is None or meta.is_being_deleted(job):
            return
        ttl = job.get("spec", {}).get("ttlSecondsAfterFinished")
        if ttl is None:
            return
        st = job.get("status", {})
        if not any(c.get("type") in ("Complete", "Failed")
                   and c.get("status") == "True"
                   for c in st.get("conditions", [])):
            return
        finished = st.get("completionUnix")
        if finished is None:
            return  # pre-TTL-era status; next job sync stamps it
        if self.clock() - float(finished) >= float(ttl):
            try:
                self.client.jobs.delete(name, ns)
            except errors.StatusError:
                pass
