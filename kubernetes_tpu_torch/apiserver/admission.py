"""Admission control: the mutating/validating chain in front of the registry.

Analog of `plugin/pkg/admission/` compiled into the apiserver: each plugin
sees (operation, resource, object, old object) and may mutate or reject.
Implemented plugins mirror the reference's default-enabled set that our
resource surface exercises:

  NamespaceLifecycle       plugin/pkg/admission/namespace/lifecycle
  Priority                 plugin/pkg/admission/priority (priorityClassName →
                           spec.priority resolution)
  DefaultTolerationSeconds plugin/pkg/admission/defaulttolerationseconds
  ServiceAccount           plugin/pkg/admission/serviceaccount (default SA)
  LimitRanger              plugin/pkg/admission/limitranger (default requests)
  ResourceQuota            plugin/pkg/admission/resourcequota
  PodDisruptionBudget gate the Eviction subresource's disruption check
                           (registry/core/pod/storage/eviction.go)
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..machinery import errors, labels as mlabels, meta
from ..machinery import quantity as mq
from ..machinery.scheme import ResourceInfo

Obj = Dict[str, Any]

CREATE = "CREATE"
UPDATE = "UPDATE"
DELETE = "DELETE"
EVICT = "EVICT"


class AdmissionPlugin:
    """Two-phase plugin, mirroring the reference's MutationInterface /
    ValidationInterface split (apiserver/pkg/admission/interfaces.go):
    `admit` may mutate; `validate` may only reject. The server runs all
    mutators (built-in, then mutating webhooks) before any validator, so
    validators always see the final patched object."""

    name = "plugin"

    def admit(self, api, op: str, info: ResourceInfo, obj: Optional[Obj],
              old: Optional[Obj]) -> Optional[Obj]:
        return obj

    def validate(self, api, op: str, info: ResourceInfo, obj: Optional[Obj],
                 old: Optional[Obj]) -> None:
        return None


class AdmissionChain:
    """Runs plugins in order; mutations flow forward, rejections raise."""

    def __init__(self, api=None, plugins: Optional[List[AdmissionPlugin]] = None):
        self.api = api  # set by attach()
        self.plugins = plugins if plugins is not None else default_plugins()

    def attach(self, api) -> "AdmissionChain":
        self.api = api
        return self

    def mutate(self, op: str, info: ResourceInfo, obj: Optional[Obj],
               old: Optional[Obj]) -> Optional[Obj]:
        for p in self.plugins:
            out = p.admit(self.api, op, info, obj, old)
            if out is not None:
                obj = out
        return obj

    def validate(self, op: str, info: ResourceInfo, obj: Optional[Obj],
                 old: Optional[Obj]) -> None:
        for p in self.plugins:
            p.validate(self.api, op, info, obj, old)

    def __call__(self, op: str, info: ResourceInfo, obj: Optional[Obj],
                 old: Optional[Obj]) -> Optional[Obj]:
        obj = self.mutate(op, info, obj, old)
        self.validate(op, info, obj, old)
        return obj


# --------------------------------------------------------------------------- #
# plugins
# --------------------------------------------------------------------------- #


class NamespaceLifecycle(AdmissionPlugin):
    """Reject creates in missing/terminating namespaces; protect the
    default namespaces from deletion (lifecycle/admission.go)."""

    name = "NamespaceLifecycle"
    PROTECTED = ("default", "kube-system", "kube-public")

    def validate(self, api, op, info, obj, old):
        # pure validator in the reference too (lifecycle implements only
        # ValidationInterface) — runs after all mutation, webhooks included
        if info.resource == "namespaces":
            if op == DELETE and old is not None and \
                    meta.name(old) in self.PROTECTED:
                raise errors.new_forbidden(
                    "namespaces", meta.name(old),
                    "this namespace may not be deleted")
            return
        if op != CREATE or not info.namespaced or obj is None:
            return
        ns = meta.namespace(obj) or "default"
        try:
            ns_obj = api.store("", "namespaces").get("", ns)
        except errors.StatusError:
            raise errors.new_forbidden(
                info.resource, meta.name(obj),
                f'namespace "{ns}" not found')
        if meta.is_being_deleted(ns_obj) or \
                ns_obj.get("status", {}).get("phase") == "Terminating":
            raise errors.new_forbidden(
                info.resource, meta.name(obj),
                f'unable to create new content in namespace {ns} because '
                f'it is being terminated')


class PriorityAdmission(AdmissionPlugin):
    """Resolve pod.spec.priorityClassName → spec.priority + preemptionPolicy
    (priority/admission.go). Unknown class names reject; the two built-in
    system classes always exist."""

    name = "Priority"
    BUILTINS = {"system-cluster-critical": 2000000000,
                "system-node-critical": 2000001000}

    def admit(self, api, op, info, obj, old):
        if info.resource != "pods" or op != CREATE or obj is None:
            return obj
        spec = obj.setdefault("spec", {})
        cls = spec.get("priorityClassName", "")
        if not cls:
            if "priority" not in spec:
                # globalDefault priority class, if any
                default = self._global_default(api)
                spec["priority"] = default
            return obj
        if cls in self.BUILTINS:
            spec["priority"] = self.BUILTINS[cls]
            return obj
        try:
            pc = api.store("scheduling.k8s.io", "priorityclasses").get("", cls)
        except errors.StatusError:
            raise errors.new_forbidden(
                "pods", meta.name(obj),
                f'no PriorityClass with name {cls} was found')
        spec["priority"] = int(pc.get("value", 0))
        return obj

    @staticmethod
    def _global_default(api) -> int:
        try:
            lst, _ = api.store("scheduling.k8s.io",
                               "priorityclasses").storage.list(
                api.store("scheduling.k8s.io", "priorityclasses").key_root())
            for pc in lst:
                if pc.get("globalDefault"):
                    return int(pc.get("value", 0))
        except errors.StatusError:
            pass
        return 0


class DefaultTolerationSeconds(AdmissionPlugin):
    """Add the 300 s not-ready/unreachable NoExecute tolerations every pod
    gets (defaulttolerationseconds/admission.go)."""

    name = "DefaultTolerationSeconds"
    KEYS = ("node.kubernetes.io/not-ready", "node.kubernetes.io/unreachable")
    SECONDS = 300

    def admit(self, api, op, info, obj, old):
        if info.resource != "pods" or op != CREATE or obj is None:
            return obj
        spec = obj.setdefault("spec", {})
        tolerations = spec.setdefault("tolerations", [])
        for key in self.KEYS:
            if not any(t.get("key") == key for t in tolerations):
                tolerations.append({"key": key, "operator": "Exists",
                                    "effect": "NoExecute",
                                    "tolerationSeconds": self.SECONDS})
        return obj


class ServiceAccountAdmission(AdmissionPlugin):
    """Default spec.serviceAccountName (serviceaccount/admission.go)."""

    name = "ServiceAccount"

    def admit(self, api, op, info, obj, old):
        if info.resource == "pods" and op == CREATE and obj is not None:
            obj.setdefault("spec", {}).setdefault("serviceAccountName",
                                                  "default")
        return obj


class LimitRanger(AdmissionPlugin):
    """Apply LimitRange container defaults (mutate phase) + max checks
    (validate phase — re-run on the final object so a mutating webhook that
    inflates requests cannot dodge the limit; limitranger/admission.go
    implements both interfaces the same way)."""

    name = "LimitRanger"

    def _limits(self, api, ns: str):
        store = api.store("", "limitranges")
        try:
            items, _ = store.storage.list(store.prefix_for(ns))
        except errors.StatusError:
            return
        for lr in items:
            for limit in lr.get("spec", {}).get("limits", []) or []:
                if limit.get("type", "Container") == "Container":
                    yield limit

    def admit(self, api, op, info, obj, old):
        if info.resource != "pods" or op != CREATE or obj is None:
            return obj
        for limit in self._limits(api, meta.namespace(obj) or "default"):
            defaults = limit.get("defaultRequest") or {}
            for c in obj.get("spec", {}).get("containers", []) or []:
                reqs = c.setdefault("resources", {}).setdefault("requests", {})
                for k, v in defaults.items():
                    reqs.setdefault(k, v)
        return obj

    def validate(self, api, op, info, obj, old):
        if info.resource != "pods" or op != CREATE or obj is None:
            return
        for limit in self._limits(api, meta.namespace(obj) or "default"):
            maxes = limit.get("max") or {}
            for c in obj.get("spec", {}).get("containers", []) or []:
                reqs = (c.get("resources", {}) or {}).get("requests") or {}
                for k, vmax in maxes.items():
                    v = reqs.get(k)
                    if v is not None and mq.cmp(v, vmax) > 0:
                        raise errors.new_forbidden(
                            "pods", meta.name(obj),
                            f"maximum {k} usage per Container is "
                            f"{vmax}, but request is {v}")


class ResourceQuotaAdmission(AdmissionPlugin):
    """Enforce quota hard limits on pod creation by atomically RESERVING
    usage in quota status (resourcequota/admission.go evaluates + the quota
    accessor's CAS update): the check and the usage bump happen inside one
    guaranteed_update, so concurrent creates cannot jointly exceed the hard
    limit. The quota controller recomputes true usage on its resync (which
    also releases reservations for creates that later failed).

    Runs in the VALIDATE phase (the reference registers ResourceQuota as a
    validating plugin, last in the order): the reservation is computed from
    the final object, after mutating webhooks — a webhook inflating
    spec.resources cannot bypass quota."""

    name = "ResourceQuota"

    @staticmethod
    def _pod_request(obj: Obj, field_: str) -> mq.Quantity:
        total = mq.Quantity(0)
        for c in obj.get("spec", {}).get("containers", []) or []:
            v = (c.get("resources", {}).get("requests") or {}).get(field_)
            if v is not None:
                total = total + mq.parse(v)
        return total

    def validate(self, api, op, info, obj, old):
        if info.resource != "pods" or op != CREATE or obj is None:
            return obj
        ns = meta.namespace(obj) or "default"
        qstore = api.store("", "resourcequotas")
        try:
            quotas, _ = qstore.storage.list(qstore.prefix_for(ns))
        except errors.StatusError:
            return obj
        for quota in quotas:
            hard = quota.get("spec", {}).get("hard", {})
            if not hard:
                continue

            def reserve(q: Obj) -> Obj:
                st = q.setdefault("status", {})
                st["hard"] = dict(hard)
                used = st.setdefault("used", {})
                if "pods" in hard:
                    cur = mq.parse(used.get("pods", "0")).value()
                    if cur + 1 > mq.parse(hard["pods"]).value():
                        raise errors.new_forbidden(
                            "pods", meta.name(obj),
                            f"exceeded quota: {meta.name(q)}, requested: "
                            f"pods=1, used: pods={cur}, "
                            f"limited: pods={hard['pods']}")
                    used["pods"] = str(cur + 1)
                for res_key, field_ in (("requests.cpu", "cpu"),
                                        ("requests.memory", "memory")):
                    if res_key not in hard:
                        continue
                    req = self._pod_request(obj, field_)
                    cur_q = mq.parse(used.get(res_key, "0"))
                    if (cur_q + req).milli > mq.parse(hard[res_key]).milli:
                        raise errors.new_forbidden(
                            "pods", meta.name(obj),
                            f"exceeded quota: {meta.name(q)}: {res_key} "
                            f"request {req} plus used {cur_q} exceeds hard "
                            f"limit {hard[res_key]}")
                    used[res_key] = str(cur_q + req)
                return q

            qstore.storage.guaranteed_update(
                qstore.key_for(ns, meta.name(quota)), reserve,
                "resourcequotas", meta.name(quota))
        return obj


def pdbs_for_pod(api, pod: Obj) -> List[Obj]:
    """PodDisruptionBudgets whose selector matches this pod."""
    ns = meta.namespace(pod) or "default"
    store = api.store("policy", "poddisruptionbudgets")
    try:
        pdbs, _ = store.storage.list(store.prefix_for(ns))
    except errors.StatusError:
        return []
    return [p for p in pdbs
            if mlabels.from_label_selector(p.get("spec", {}).get("selector"))
            .matches(meta.labels_of(pod))]


def credit_pdb_disruption(api, pod: Obj) -> None:
    """Return a consumed disruption slot (the compensation when an eviction's
    delete fails after the gate already decremented)."""
    ns = meta.namespace(pod) or "default"
    store = api.store("policy", "poddisruptionbudgets")
    for pdb in pdbs_for_pod(api, pod):
        def inc(o: Obj) -> Obj:
            st = o.setdefault("status", {})
            st["disruptionsAllowed"] = int(st.get("disruptionsAllowed", 0)) + 1
            return o
        try:
            store.storage.guaranteed_update(
                store.key_for(ns, meta.name(pdb)), inc,
                "poddisruptionbudgets", meta.name(pdb))
        except errors.StatusError:
            pass


class EvictionPDBGate(AdmissionPlugin):
    """Evictions respect PodDisruptionBudgets: 0 allowed disruptions →
    429 TooManyRequests (eviction.go checkAndDecrement). Validate-phase:
    the decrement is a gate, not a mutation of the admitted object."""

    name = "EvictionPDBGate"

    def validate(self, api, op, info, obj, old):
        if op != EVICT or old is None:
            return obj
        ns = meta.namespace(old) or "default"
        store = api.store("policy", "poddisruptionbudgets")
        pdbs = pdbs_for_pod(api, old)
        if not pdbs:
            return obj
        if len(pdbs) > 1:
            # the reference refuses multi-PDB evictions outright
            # (eviction.go: "This pod has more than one PodDisruptionBudget")
            # — which also makes the decrement below single-budget atomic
            raise errors.StatusError(
                500, "InternalError",
                "This pod has more than one PodDisruptionBudget, which the "
                "Eviction subresource does not support.")
        pdb = pdbs[0]

        # the CAS inside guaranteed_update is the one authoritative check:
        # N concurrent evictions serialize on it and cannot all pass
        def dec(o):
            st = o.setdefault("status", {})
            cur = int(st.get("disruptionsAllowed", 0))
            if cur <= 0:
                raise errors.new_too_many_requests(
                    "Cannot evict pod as it would violate the pod's "
                    "disruption budget.")
            st["disruptionsAllowed"] = cur - 1
            return o

        store.storage.guaranteed_update(
            store.key_for(ns, meta.name(pdb)), dec,
            "poddisruptionbudgets", meta.name(pdb))
        return obj


def default_plugins() -> List[AdmissionPlugin]:
    """The default-enabled chain, in the reference's ordering
    (options/plugins.go AllOrderedPlugins, reduced to our surface). The
    JAX package's last plugin, ClusterIP/NodePort allocation
    (apiserver/service_alloc.py), is not ported yet (ROADMAP A11b, second
    half)."""
    return [
        NamespaceLifecycle(),
        LimitRanger(),
        ServiceAccountAdmission(),
        DefaultTolerationSeconds(),
        PriorityAdmission(),
        EvictionPDBGate(),
        ResourceQuotaAdmission(),
    ]
