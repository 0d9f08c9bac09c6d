"""The served resource catalog: core + apps + batch + policy + coordination +
storage + scheduling + rbac groups, with defaulting and validation.

Capability analog of the reference's resource install: `pkg/master/master.go`
(legacy API) + `pkg/registry/<group>/rest/storage_<group>.go` per group, with
defaulting from `pkg/apis/<group>/<version>/defaults.go` and validation from
`pkg/apis/<group>/validation/` — reduced to the fields our control plane
acts on.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..machinery import labels as mlabels
from ..machinery.scheme import ResourceInfo, Scheme

Obj = Dict[str, Any]


# --------------------------------------------------------------------------- #
# defaulters (pkg/apis/core/v1/defaults.go etc.)
# --------------------------------------------------------------------------- #


def default_pod(o: Obj) -> None:
    spec = o.setdefault("spec", {})
    spec.setdefault("restartPolicy", "Always")
    spec.setdefault("dnsPolicy", "ClusterFirst")
    spec.setdefault("schedulerName", "default-scheduler")
    spec.setdefault("terminationGracePeriodSeconds", 30)
    spec.setdefault("enableServiceLinks", True)
    for c in spec.get("containers", []) or []:
        c.setdefault("imagePullPolicy",
                     "Always" if str(c.get("image", "")).endswith(":latest")
                     or ":" not in str(c.get("image", "")) else "IfNotPresent")
        c.setdefault("terminationMessagePath", "/dev/termination-log")
        c.setdefault("resources", {})
    status = o.setdefault("status", {})
    status.setdefault("phase", "Pending")


def default_node(o: Obj) -> None:
    o.setdefault("spec", {})
    status = o.setdefault("status", {})
    status.setdefault("allocatable", dict(status.get("capacity", {})))


def default_service(o: Obj) -> None:
    spec = o.setdefault("spec", {})
    spec.setdefault("type", "ClusterIP")
    spec.setdefault("sessionAffinity", "None")
    for p in spec.get("ports", []) or []:
        p.setdefault("protocol", "TCP")
        p.setdefault("targetPort", p.get("port"))


def default_namespace(o: Obj) -> None:
    spec = o.setdefault("spec", {})
    fins = spec.setdefault("finalizers", [])
    if "kubernetes" not in fins:
        fins.append("kubernetes")
    o.setdefault("status", {}).setdefault("phase", "Active")


def default_replicas_1(o: Obj) -> None:
    o.setdefault("spec", {}).setdefault("replicas", 1)


def default_deployment(o: Obj) -> None:
    spec = o.setdefault("spec", {})
    spec.setdefault("replicas", 1)
    spec.setdefault("revisionHistoryLimit", 10)
    spec.setdefault("progressDeadlineSeconds", 600)
    strat = spec.setdefault("strategy", {})
    strat.setdefault("type", "RollingUpdate")
    if strat["type"] == "RollingUpdate":
        ru = strat.setdefault("rollingUpdate", {})
        ru.setdefault("maxUnavailable", "25%")
        ru.setdefault("maxSurge", "25%")


def default_statefulset(o: Obj) -> None:
    spec = o.setdefault("spec", {})
    spec.setdefault("replicas", 1)
    spec.setdefault("podManagementPolicy", "OrderedReady")
    spec.setdefault("updateStrategy", {}).setdefault("type", "RollingUpdate")
    spec.setdefault("serviceName", "")


def default_daemonset(o: Obj) -> None:
    spec = o.setdefault("spec", {})
    us = spec.setdefault("updateStrategy", {})
    us.setdefault("type", "RollingUpdate")


def default_job(o: Obj) -> None:
    spec = o.setdefault("spec", {})
    spec.setdefault("parallelism", 1)
    spec.setdefault("completions", 1)
    spec.setdefault("backoffLimit", 6)
    tmpl_spec = spec.setdefault("template", {}).setdefault("spec", {})
    tmpl_spec.setdefault("restartPolicy", "OnFailure")


def default_cronjob(o: Obj) -> None:
    spec = o.setdefault("spec", {})
    spec.setdefault("concurrencyPolicy", "Allow")
    spec.setdefault("suspend", False)
    spec.setdefault("successfulJobsHistoryLimit", 3)
    spec.setdefault("failedJobsHistoryLimit", 1)


# --------------------------------------------------------------------------- #
# validators (pkg/apis/*/validation — the load-bearing subset)
# --------------------------------------------------------------------------- #


def validate_pod(o: Obj) -> List[str]:
    # the full core-validation corpus (api/validation.py — the
    # pkg/apis/core/validation seat): metadata grammar, containers,
    # resources, ports, tolerations, affinity weights, spread constraints
    from ..api.validation import validate_pod as _vp

    return _vp(o)


def validate_node_full(o: Obj) -> List[str]:
    from ..api.validation import validate_node as _vn

    return _vn(o)


def validate_selector_matches_template(o: Obj) -> List[str]:
    """apps validation: selector is required and must match template labels."""
    errs = []
    spec = o.get("spec", {})
    sel = spec.get("selector")
    if not sel or not (sel.get("matchLabels") or sel.get("matchExpressions")):
        errs.append("spec.selector: Required value")
        return errs
    tmpl_labels = (spec.get("template", {}).get("metadata", {})
                   .get("labels") or {})
    try:
        if not mlabels.from_label_selector(sel).matches(tmpl_labels):
            errs.append("spec.template.metadata.labels: Invalid value: "
                        "`selector` does not match template `labels`")
    except mlabels.SelectorParseError as e:
        errs.append(f"spec.selector: Invalid value: {e}")
    return errs


def validate_service(o: Obj) -> List[str]:
    spec = o.get("spec", {})
    if spec.get("type") != "ExternalName" and not spec.get("ports"):
        return ["spec.ports: Required value"]
    return []


def validate_job(o: Obj) -> List[str]:
    spec = o.get("spec", {})
    rp = spec.get("template", {}).get("spec", {}).get("restartPolicy")
    if rp == "Always":
        return ['spec.template.spec.restartPolicy: Unsupported value: "Always"']
    return []


def validate_cronjob(o: Obj) -> List[str]:
    if not o.get("spec", {}).get("schedule"):
        return ["spec.schedule: Required value"]
    return []


def validate_pdb(o: Obj) -> List[str]:
    spec = o.get("spec", {})
    if "minAvailable" in spec and "maxUnavailable" in spec:
        return ["spec: Invalid value: minAvailable and maxUnavailable "
                "are mutually exclusive"]
    return []


# --------------------------------------------------------------------------- #
# the catalog
# --------------------------------------------------------------------------- #


def build_scheme() -> Scheme:
    s = Scheme()
    R = ResourceInfo

    # ---- core/v1 (legacy API, served under /api/v1) ----
    s.register(R("", "v1", "Pod", "pods", short_names=("po",),
                 subresources=("status", "binding", "eviction"),
                 defaulter=default_pod, validator=validate_pod))
    s.register(R("", "v1", "Node", "nodes", namespaced=False,
                 short_names=("no",), subresources=("status",),
                 defaulter=default_node, validator=validate_node_full))
    s.register(R("", "v1", "Namespace", "namespaces", namespaced=False,
                 short_names=("ns",), subresources=("status", "finalize"),
                 defaulter=default_namespace))
    s.register(R("", "v1", "Service", "services", short_names=("svc",),
                 subresources=("status",), defaulter=default_service,
                 validator=validate_service))
    s.register(R("", "v1", "Endpoints", "endpoints", short_names=("ep",)))
    s.register(R("", "v1", "Event", "events", short_names=("ev",)))
    s.register(R("", "v1", "ConfigMap", "configmaps", short_names=("cm",)))
    s.register(R("", "v1", "Secret", "secrets"))
    s.register(R("", "v1", "ServiceAccount", "serviceaccounts",
                 short_names=("sa",)))
    s.register(R("", "v1", "PersistentVolume", "persistentvolumes",
                 namespaced=False, short_names=("pv",),
                 subresources=("status",)))
    s.register(R("", "v1", "PersistentVolumeClaim", "persistentvolumeclaims",
                 short_names=("pvc",), subresources=("status",)))
    s.register(R("", "v1", "ReplicationController", "replicationcontrollers",
                 short_names=("rc",), subresources=("status", "scale"),
                 defaulter=default_replicas_1,
                 validator=lambda o: []))
    s.register(R("", "v1", "LimitRange", "limitranges"))
    s.register(R("", "v1", "ResourceQuota", "resourcequotas",
                 short_names=("quota",), subresources=("status",)))
    s.register(R("", "v1", "PodTemplate", "podtemplates"))
    s.register(R("", "v1", "Binding", "bindings"))

    # ---- apps/v1 ----
    s.register(R("apps", "v1", "Deployment", "deployments",
                 short_names=("deploy",), subresources=("status", "scale"),
                 defaulter=default_deployment,
                 validator=validate_selector_matches_template))
    s.register(R("apps", "v1", "ReplicaSet", "replicasets",
                 short_names=("rs",), subresources=("status", "scale"),
                 defaulter=default_replicas_1,
                 validator=validate_selector_matches_template))
    s.register(R("apps", "v1", "StatefulSet", "statefulsets",
                 short_names=("sts",), subresources=("status", "scale"),
                 defaulter=default_statefulset,
                 validator=validate_selector_matches_template))
    s.register(R("apps", "v1", "DaemonSet", "daemonsets",
                 short_names=("ds",), subresources=("status",),
                 defaulter=default_daemonset,
                 validator=validate_selector_matches_template))
    s.register(R("apps", "v1", "ControllerRevision", "controllerrevisions"))

    # ---- batch ----
    s.register(R("batch", "v1", "Job", "jobs", subresources=("status",),
                 defaulter=default_job, validator=validate_job))
    s.register(R("batch", "v1beta1", "CronJob", "cronjobs",
                 short_names=("cj",), subresources=("status",),
                 defaulter=default_cronjob, validator=validate_cronjob))

    # ---- policy ----
    s.register(R("policy", "v1beta1", "PodDisruptionBudget",
                 "poddisruptionbudgets", short_names=("pdb",),
                 subresources=("status",), validator=validate_pdb))

    # ---- coordination (leader-election leases) ----
    s.register(R("coordination.k8s.io", "v1", "Lease", "leases"))

    # ---- discovery (EndpointSlice, v1beta1 at the reference's vintage) ----
    s.register(R("discovery.k8s.io", "v1beta1", "EndpointSlice",
                 "endpointslices"))

    # --- admission webhooks (admissionregistration.k8s.io) ---
    s.register(R("admissionregistration.k8s.io", "v1",
                 "MutatingWebhookConfiguration",
                 "mutatingwebhookconfigurations", namespaced=False))
    s.register(R("admissionregistration.k8s.io", "v1",
                 "ValidatingWebhookConfiguration",
                 "validatingwebhookconfigurations", namespaced=False))

    # --- aggregation (kube-aggregator APIService registry) ---
    s.register(R("apiregistration.k8s.io", "v1", "APIService", "apiservices",
                 namespaced=False, subresources=("status",)))

    # --- autoscaling ---
    s.register(R("autoscaling", "v1", "HorizontalPodAutoscaler",
                 "horizontalpodautoscalers", short_names=("hpa",),
                 subresources=("status",)))

    # ---- storage ----
    s.register(R("storage.k8s.io", "v1", "StorageClass", "storageclasses",
                 namespaced=False, short_names=("sc",)))
    s.register(R("storage.k8s.io", "v1", "CSINode", "csinodes",
                 namespaced=False))

    # ---- scheduling ----
    s.register(R("scheduling.k8s.io", "v1", "PriorityClass",
                 "priorityclasses", namespaced=False, short_names=("pc",)))

    # ---- rbac ----
    s.register(R("rbac.authorization.k8s.io", "v1", "Role", "roles"))
    s.register(R("rbac.authorization.k8s.io", "v1", "RoleBinding",
                 "rolebindings"))
    s.register(R("rbac.authorization.k8s.io", "v1", "ClusterRole",
                 "clusterroles", namespaced=False))
    s.register(R("rbac.authorization.k8s.io", "v1", "ClusterRoleBinding",
                 "clusterrolebindings", namespaced=False))

    # ---- certificates (the kubelet credential path:
    # pkg/apis/certificates, CSR create → approve → sign) ----
    s.register(R("certificates.k8s.io", "v1beta1",
                 "CertificateSigningRequest", "certificatesigningrequests",
                 namespaced=False, short_names=("csr",),
                 subresources=("status", "approval")))

    # ---- apiextensions (CRD registration; dynamic install handled by the
    # server's CRD hook) ----
    s.register(R("apiextensions.k8s.io", "v1", "CustomResourceDefinition",
                 "customresourcedefinitions", namespaced=False,
                 short_names=("crd",)))

    return s
