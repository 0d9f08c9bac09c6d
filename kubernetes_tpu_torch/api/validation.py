"""Core-type validation corpus — the pkg/apis/core/validation seat.

The reference validates every inbound object against a large hand-written
rule set (`pkg/apis/core/validation/validation.go`, ~6k LoC;
`apimachinery/pkg/util/validation/validation.go` for the name/label
grammars). This module carries the shape-defining subset for the types this
framework serves — metadata name/label grammar, pod spec structure,
container resources/ports, node taints and quantities — returning the
reference's `field.ErrorList`-style strings ("path: kind: detail") that the
registry turns into 422 Invalid responses.

Grammar rules mirrored exactly (validation.go):
  * DNS-1123 label:      [a-z0-9]([-a-z0-9]*[a-z0-9])?          ≤ 63
  * DNS-1123 subdomain:  label(.label)*                          ≤ 253
  * qualified name:      [prefix/]name, prefix a subdomain, name
                         [A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])? ≤ 63
  * label value:         empty or qualified-name body             ≤ 63
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

from .types import parse_cpu_milli, parse_mem_kib

Obj = Dict[str, Any]

_DNS1123_LABEL = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
_DNS1123_SUB = re.compile(
    r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*$")
_QUAL_NAME = re.compile(r"^[A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?$")

_PROTOCOLS = ("TCP", "UDP", "SCTP")
_RESTART_POLICIES = ("Always", "OnFailure", "Never")
_TAINT_EFFECTS = ("NoSchedule", "PreferNoSchedule", "NoExecute")
_UNSATISFIABLE = ("DoNotSchedule", "ScheduleAnyway")


def is_dns1123_label(s: str) -> bool:
    return isinstance(s, str) and len(s) <= 63 and bool(
        _DNS1123_LABEL.match(s))


def is_dns1123_subdomain(s: str) -> bool:
    return isinstance(s, str) and len(s) <= 253 and bool(
        _DNS1123_SUB.match(s))


def is_qualified_name(s: str) -> bool:
    if not isinstance(s, str) or not s:
        return False
    parts = s.split("/")
    if len(parts) > 2:
        return False
    if len(parts) == 2:
        prefix, name = parts
        if not is_dns1123_subdomain(prefix):
            return False
    else:
        name = parts[0]
    return len(name) <= 63 and bool(_QUAL_NAME.match(name))


def is_label_value(s: str) -> bool:
    if not isinstance(s, str):
        return False
    if s == "":
        return True
    return len(s) <= 63 and bool(_QUAL_NAME.match(s))


def _as_int(v: Any):
    """Untrusted-input int coercion: None instead of ValueError — a
    malformed field must become a 422 field error, never a 500."""
    try:
        return int(v)
    except (TypeError, ValueError):
        return None


def _valid_quantity(q: Any, mem: bool = False) -> bool:
    try:
        (parse_mem_kib if mem else parse_cpu_milli)(q)
        return True
    except (ValueError, TypeError, AttributeError):
        return False


def validate_object_meta(obj: Obj, namespaced: bool = True,
                         path: str = "metadata") -> List[str]:
    """ValidateObjectMeta (validation.go): name/namespace grammar, label and
    annotation key/value grammar."""
    errs: List[str] = []
    md = obj.get("metadata") or {}
    name = md.get("name", "")
    if not name:
        errs.append(f"{path}.name: Required value")
    elif not is_dns1123_subdomain(name):
        errs.append(f"{path}.name: Invalid value: {name!r}: a lowercase "
                    "RFC 1123 subdomain must consist of lower case "
                    "alphanumeric characters, '-' or '.'")
    ns = md.get("namespace", "")
    if namespaced and ns and not is_dns1123_label(ns):
        errs.append(f"{path}.namespace: Invalid value: {ns!r}")
    for k, v in (md.get("labels") or {}).items():
        if not is_qualified_name(k):
            errs.append(f"{path}.labels: Invalid value: {k!r}: "
                        "name part must consist of alphanumeric characters")
        if not is_label_value(v):
            errs.append(f"{path}.labels: Invalid value: {v!r}: must be 63 "
                        "characters or less")
    for k in (md.get("annotations") or {}):
        if not is_qualified_name(k):
            errs.append(f"{path}.annotations: Invalid value: {k!r}")
    return errs


def _validate_resources(res: Obj, path: str) -> List[str]:
    """ValidateResourceRequirements: quantities parse; requests ≤ limits for
    cpu/memory (validation.go ValidateResourceRequirements)."""
    errs: List[str] = []
    reqs = res.get("requests") or {}
    lims = res.get("limits") or {}
    for side, d in (("requests", reqs), ("limits", lims)):
        for rname, q in d.items():
            mem = rname in ("memory", "ephemeral-storage") \
                or "hugepages" in str(rname)
            if not _valid_quantity(q, mem=mem):
                errs.append(f"{path}.{side}[{rname}]: Invalid value: {q!r}: "
                            "quantities must match the regular expression")
    for rname in ("cpu", "memory"):
        if rname in reqs and rname in lims \
                and _valid_quantity(reqs[rname], mem=rname == "memory") \
                and _valid_quantity(lims[rname], mem=rname == "memory"):
            mem = rname == "memory"
            parse = parse_mem_kib if mem else parse_cpu_milli
            if parse(reqs[rname]) > parse(lims[rname]):
                errs.append(f"{path}.requests[{rname}]: Invalid value: "
                            "must be less than or equal to "
                            f"{rname} limit")
    return errs


def validate_pod_spec(spec: Obj, path: str = "spec") -> List[str]:
    """ValidatePodSpec: containers present, names unique DNS-1123 labels,
    images present, ports/protocols in range, restartPolicy enum,
    affinity weights, spread constraints (validation.go ValidatePodSpec /
    validateContainers / validateTopologySpreadConstraints)."""
    errs: List[str] = []
    containers = spec.get("containers")
    if not containers:
        errs.append(f"{path}.containers: Required value")
    seen = set()
    for i, c in enumerate(containers or []):
        cp = f"{path}.containers[{i}]"
        if not isinstance(c, dict):
            errs.append(f"{cp}: Invalid value: expected an object")
            continue
        nm = c.get("name", "")
        if not nm:
            errs.append(f"{cp}.name: Required value")
        elif not is_dns1123_label(nm):
            errs.append(f"{cp}.name: Invalid value: {nm!r}")
        elif nm in seen:
            errs.append(f"{cp}.name: Duplicate value: {nm!r}")
        seen.add(nm)
        if not c.get("image"):
            errs.append(f"{cp}.image: Required value")
        for j, p in enumerate(c.get("ports") or []):
            if not isinstance(p, dict):
                errs.append(f"{cp}.ports[{j}]: Invalid value: "
                            "expected an object")
                continue
            for fld in ("containerPort", "hostPort"):
                v = p.get(fld)
                if v is None:
                    continue
                iv = _as_int(v)
                if iv is None or not 0 < iv <= 65535:
                    errs.append(f"{cp}.ports[{j}].{fld}: Invalid value: "
                                f"{v!r}: must be between 1 and 65535")
            proto = p.get("protocol", "TCP")
            if proto not in _PROTOCOLS:
                errs.append(f"{cp}.ports[{j}].protocol: Unsupported value: "
                            f"{proto!r}")
        errs.extend(_validate_resources(c.get("resources") or {},
                                        f"{cp}.resources"))
    rp = spec.get("restartPolicy")
    if rp is not None and rp not in _RESTART_POLICIES:
        errs.append(f"{path}.restartPolicy: Unsupported value: {rp!r}")
    pri = spec.get("priority")
    if pri is not None and not isinstance(pri, int):
        errs.append(f"{path}.priority: Invalid value: {pri!r}: "
                    "must be an integer")
    for i, t in enumerate(spec.get("tolerations") or []):
        op = t.get("operator", "Equal")
        if op not in ("Equal", "Exists"):
            errs.append(f"{path}.tolerations[{i}].operator: "
                        f"Unsupported value: {op!r}")
        if op == "Exists" and t.get("value"):
            errs.append(f"{path}.tolerations[{i}].value: Invalid value: "
                        "value must be empty when `operator` is 'Exists'")
        eff = t.get("effect")
        if eff and eff not in _TAINT_EFFECTS:
            errs.append(f"{path}.tolerations[{i}].effect: "
                        f"Unsupported value: {eff!r}")
    aff = (spec.get("affinity") or {})
    for kind in ("podAffinity", "podAntiAffinity"):
        for i, w in enumerate((aff.get(kind) or {}).get(
                "preferredDuringSchedulingIgnoredDuringExecution") or []):
            wt = _as_int(w.get("weight", 0)) if isinstance(w, dict) else None
            if wt is None or not 1 <= wt <= 100:
                errs.append(f"{path}.affinity.{kind}.preferred[{i}].weight: "
                            "Invalid value: must be in the range 1-100")
    for i, c in enumerate(spec.get("topologySpreadConstraints") or []):
        tp = f"{path}.topologySpreadConstraints[{i}]"
        if not isinstance(c, dict):
            errs.append(f"{tp}: Invalid value: expected an object")
            continue
        skew = _as_int(c.get("maxSkew", 0) or 0)
        if skew is None or skew < 1:
            errs.append(f"{tp}.maxSkew: Invalid value: must be greater "
                        "than zero")
        if not c.get("topologyKey"):
            errs.append(f"{tp}.topologyKey: Required value")
        wu = c.get("whenUnsatisfiable", "DoNotSchedule")
        if wu not in _UNSATISFIABLE:
            errs.append(f"{tp}.whenUnsatisfiable: Unsupported value: {wu!r}")
    return errs


def validate_pod(obj: Obj) -> List[str]:
    return validate_object_meta(obj) + validate_pod_spec(
        obj.get("spec") or {})


def validate_node(obj: Obj) -> List[str]:
    """ValidateNode: metadata, taints (qualified key + effect enum),
    capacity/allocatable quantities."""
    errs = validate_object_meta(obj, namespaced=False)
    for i, t in enumerate((obj.get("spec") or {}).get("taints") or []):
        tp = f"spec.taints[{i}]"
        if not is_qualified_name(t.get("key", "")):
            errs.append(f"{tp}.key: Invalid value: {t.get('key')!r}")
        if t.get("value") and not is_label_value(t["value"]):
            errs.append(f"{tp}.value: Invalid value: {t['value']!r}")
        if t.get("effect") not in _TAINT_EFFECTS:
            errs.append(f"{tp}.effect: Unsupported value: "
                        f"{t.get('effect')!r}")
    status = obj.get("status") or {}
    for side in ("capacity", "allocatable"):
        for rname, q in (status.get(side) or {}).items():
            mem = rname in ("memory", "ephemeral-storage") \
                or "hugepages" in str(rname)
            if rname == "pods":
                ok = str(q).isdigit()
            else:
                ok = _valid_quantity(q, mem=mem)
            if not ok:
                errs.append(f"status.{side}[{rname}]: Invalid value: {q!r}")
    return errs
