"""kubectl: the CLI verbs against the REST API.

Analog of `staging/src/k8s.io/kubectl` (get/describe/create/apply/delete/
scale/cordon/drain/label/taint/api-resources/version) over the same REST
paths, with table printers and -o json|yaml|name|wide. Entry point:
`python -m kubernetes_tpu_torch.cli <verb> ...`.

(A copy of the JAX package's cli/kubectl.py, but for PyYAML: imported only
where a YAML text is read or written, so the module, JSON manifests and
-o json work without it. A JSON manifest gives the documents
`yaml.safe_load_all` would give it: `_json_documents`.)
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Any, Dict, List, Optional

from ..api.types import parse_cpu_milli, parse_mem_kib
from ..client.rest import Client
from ..machinery import errors, meta

Obj = Dict[str, Any]


def _yaml():
    """PyYAML, for a YAML text (a manifest, a patch body, -o yaml,
    describe); ImportError naming it where it is not installed."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "reading or writing YAML needs PyYAML (the `yaml` module), "
            "which is not installed; give JSON instead") from e
    return yaml


# What PyYAML reads otherwise than JSON does, in a text json.loads takes:
# a character its reader refuses, a tab (no token starts with one), the
# line breaks it folds inside a quoted scalar (U+0085, U+2028, U+2029),
# and a \u escape of a UTF-16 surrogate (PyYAML keeps the halves apart)
_YAML_DIFFERS = re.compile(
    "[^\n\r\x20-\x7e\xa0-\ud7ff\ue000-\ufffd\U00010000-\U0010ffff]"
    "|[\u2028\u2029]|\\\\u[dD][89a-fA-F]")
# YAML 1.1's float (PyYAML's resolver) on JSON's number grammar: a point,
# and an exponent only with a sign; any other JSON fraction or exponent
# (1e5, 2E3) is a string there
_YAML_FLOAT = re.compile(r"-?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?")


def _yaml_float(literal: str):
    return float(literal) if _YAML_FLOAT.fullmatch(literal) else literal


def _json_documents(text: str) -> Optional[List[Any]]:
    """The documents `yaml.safe_load_all(text)` gives a JSON text, read
    without PyYAML; None when `text` is not JSON, or holds one of the few
    things PyYAML reads otherwise (_YAML_DIFFERS). JSON's true, false,
    null, ints and strings are YAML's; its NaN and Infinity are strings
    there."""
    if _YAML_DIFFERS.search(text):
        return None
    try:
        return [json.loads(text, parse_float=_yaml_float,
                           parse_constant=str)]
    except ValueError:
        return None


# --------------------------------------------------------------------------- #
# printers (kubectl's printers.HumanReadablePrinter, abbreviated columns)
# --------------------------------------------------------------------------- #


def _age(obj: Obj) -> str:
    return obj.get("metadata", {}).get("creationTimestamp", "")[-9:-1] or "?"


_COLUMNS = {
    "pods": (("NAME", lambda o: meta.name(o)),
             ("READY", lambda o: _pod_ready(o)),
             ("STATUS", lambda o: o.get("status", {}).get("phase", "")),
             ("NODE", lambda o: o.get("spec", {}).get("nodeName", "<none>"))),
    "nodes": (("NAME", lambda o: meta.name(o)),
              ("STATUS", lambda o: _node_status(o)),
              ("TAINTS", lambda o: str(len(o.get("spec", {})
                                          .get("taints", []) or []))),
              ("CPU", lambda o: o.get("status", {}).get("capacity", {})
               .get("cpu", "?"))),
    "deployments": (("NAME", lambda o: meta.name(o)),
                    ("READY", lambda o: f"{o.get('status', {}).get('readyReplicas', 0)}"
                                        f"/{o.get('spec', {}).get('replicas', 0)}"),
                    ("UP-TO-DATE", lambda o: str(o.get("status", {})
                                                 .get("updatedReplicas", 0))),
                    ("AVAILABLE", lambda o: str(o.get("status", {})
                                                .get("availableReplicas", 0)))),
    "services": (("NAME", lambda o: meta.name(o)),
                 ("TYPE", lambda o: o.get("spec", {}).get("type", "")),
                 ("CLUSTER-IP", lambda o: o.get("spec", {})
                  .get("clusterIP", "<auto>")),
                 ("PORTS", lambda o: ",".join(
                     f"{p.get('port')}/{p.get('protocol', 'TCP')}"
                     for p in o.get("spec", {}).get("ports", []) or []))),
}

_DEFAULT_COLUMNS = (("NAME", lambda o: meta.name(o)),
                    ("AGE", _age))


def _pod_ready(o: Obj) -> str:
    cs = o.get("status", {}).get("containerStatuses", []) or []
    total = len(o.get("spec", {}).get("containers", []) or [])
    ready = sum(1 for c in cs if c.get("ready"))
    return f"{ready}/{total}"


def _node_status(o: Obj) -> str:
    status = "NotReady"
    for c in o.get("status", {}).get("conditions", []) or []:
        if c.get("type") == "Ready":
            status = {"True": "Ready", "False": "NotReady"}.get(
                c.get("status"), "Unknown")
    if o.get("spec", {}).get("unschedulable"):
        status += ",SchedulingDisabled"
    return status


def render_rows(header: List[str], rows: List[List[str]],
                out=sys.stdout) -> None:
    """Column-aligned table text (the HumanReadablePrinter's layout)."""
    widths = [max(len(header[i]), *(len(r[i]) for r in rows))
              if rows else len(header[i]) for i in range(len(header))]
    for r in [header] + rows:
        out.write("  ".join(v.ljust(w)
                            for v, w in zip(r, widths)).rstrip() + "\n")


def print_table(resource: str, items: List[Obj], namespaced: bool,
                all_namespaces: bool, out=sys.stdout) -> None:
    cols = list(_COLUMNS.get(resource, _DEFAULT_COLUMNS))
    if all_namespaces and namespaced:
        cols.insert(0, ("NAMESPACE", lambda o: meta.namespace(o)))
    render_rows([h for h, _ in cols],
                [[fn(o) for _, fn in cols] for o in items], out)


def print_obj(obj: Obj, fmt: str, out=sys.stdout) -> None:
    if fmt == "json":
        json.dump(obj, out, indent=2)
        out.write("\n")
    elif fmt == "yaml":
        _yaml().safe_dump(obj, out, sort_keys=False)
    elif fmt == "name":
        out.write(f"{obj.get('kind', '').lower()}/{meta.name(obj)}\n")


def describe(obj: Obj, out=sys.stdout) -> None:
    out.write(f"Name:         {meta.name(obj)}\n")
    if meta.namespace(obj):
        out.write(f"Namespace:    {meta.namespace(obj)}\n")
    if meta.labels_of(obj):
        out.write(f"Labels:       "
                  f"{','.join(f'{k}={v}' for k, v in sorted(meta.labels_of(obj).items()))}\n")
    out.write(f"UID:          {meta.uid(obj)}\n")
    for section in ("spec", "status"):
        if obj.get(section):
            out.write(f"{section.capitalize()}:\n")
            dumped = _yaml().safe_dump(obj[section], sort_keys=False)
            for line in dumped.splitlines():
                out.write(f"  {line}\n")


# --------------------------------------------------------------------------- #
# command implementation
# --------------------------------------------------------------------------- #


class Kubectl:
    def __init__(self, client: Client, out=sys.stdout, err=sys.stderr):
        self.client = client
        self.out = out
        self.err = err
        # discovery is static within one invocation: sweep once, reuse
        # (kubectl's CachedDiscoveryClient)
        self._discovery: Optional[List[tuple]] = None

    def _rc(self, resource: str):
        """Resolve short names through the server's discovery."""
        rc = getattr(self.client, resource, None)
        if rc is not None:
            return rc
        for group, version, r in self._discovered_resources():
            if resource in ((r["name"],) + tuple(r.get("shortNames", []))) \
                    or resource == r["kind"].lower() \
                    or resource == r["name"].rstrip("s"):
                return self.client.resource(group, version, r["name"],
                                            r.get("namespaced", True))
        raise errors.new_bad_request(
            f'the server doesn\'t have a resource type "{resource}"')

    def _group_versions(self):
        yield "", "v1"
        groups = self.client.transport.request("GET", "/apis", {}, None)
        for g in groups.get("groups", []):
            for v in g.get("versions", []):
                yield g["name"], v["version"]

    def _discovered_resources(self) -> List[tuple]:
        """[(group, version, APIResource dict)] — one sweep per invocation."""
        if self._discovery is None:
            out = []
            for group, version in self._group_versions():
                rl = self.client.transport.request(
                    "GET",
                    f"/apis/{group}/{version}" if group else f"/api/{version}",
                    {}, None)
                for r in rl.get("resources", []):
                    out.append((group, version, r))
            self._discovery = out
        return self._discovery

    # -- verbs -------------------------------------------------------------- #

    def get(self, resource: str, name: str = "", namespace: str = "default",
            all_namespaces: bool = False, selector: str = "",
            output: str = "") -> int:
        rc = self._rc(resource)
        if name:
            obj = rc.get(name, namespace if rc.namespaced else "")
            if output in ("", "wide"):
                print_table(rc.resource, [obj], rc.namespaced, False, self.out)
            else:
                print_obj(obj, output, self.out)
            return 0
        ns = "" if (all_namespaces or not rc.namespaced) else namespace
        lst = rc.list(ns, label_selector=selector)
        items = lst.get("items", [])
        if output == "json":
            print_obj(lst, "json", self.out)
        elif output == "yaml":
            print_obj(lst, "yaml", self.out)
        elif output == "name":
            for o in items:
                print_obj(o, "name", self.out)
        else:
            print_table(rc.resource, items, rc.namespaced, all_namespaces,
                        self.out)
        return 0

    def describe_cmd(self, resource: str, name: str,
                     namespace: str = "default") -> int:
        rc = self._rc(resource)
        describe(rc.get(name, namespace if rc.namespaced else ""), self.out)
        return 0

    def _load_manifests(self, path: str) -> List[Obj]:
        if path == "-":
            text = sys.stdin.read()
        else:
            with open(path) as f:
                text = f.read()
        docs = _json_documents(text)
        if docs is None:
            docs = list(_yaml().safe_load_all(text))
        return [d for d in docs if d]

    def _rc_for_obj(self, obj: Obj):
        group, version, kind = meta.gvk(obj)
        for g, v, r in self._discovered_resources():
            if g == group and r["kind"] == kind and "/" not in r["name"]:
                return self.client.resource(g, v, r["name"],
                                            r.get("namespaced", True))
        raise errors.new_bad_request(f"no resource mapping for kind {kind!r}")

    def create(self, filename: str, namespace: str = "default") -> int:
        for obj in self._load_manifests(filename):
            rc = self._rc_for_obj(obj)
            out = rc.create(obj, namespace if rc.namespaced else "")
            self.out.write(f"{out.get('kind', '').lower()}/"
                           f"{meta.name(out)} created\n")
        return 0

    def apply(self, filename: str, namespace: str = "default") -> int:
        """Three-way apply (apply.go): the patch body is the full desired
        state PLUS deletions computed against the live object's
        last-applied-configuration annotation — removing a container/env
        entry (or a map key) from the manifest removes it from the live
        object, while fields set by controllers stay. Built-ins patch with
        strategic merge; custom resources fall back to 3-way JSON merge
        (lists replace wholesale) when the server answers 415."""
        import json as _json

        from ..machinery.strategicpatch import (
            LAST_APPLIED_ANNOTATION, apply_patch_body)

        for obj in self._load_manifests(filename):
            rc = self._rc_for_obj(obj)
            ns = meta.namespace(obj) or namespace
            desired = {k: v for k, v in meta.deep_copy(obj).items()
                       if k != "status"}
            record = _json.dumps(desired, sort_keys=True,
                                 separators=(",", ":"))
            meta.ensure_meta(desired).setdefault("annotations", {})[
                LAST_APPLIED_ANNOTATION] = record
            try:
                live = rc.get(meta.name(obj), ns if rc.namespaced else "")
                try:
                    last = _json.loads(
                        (live.get("metadata", {}).get("annotations") or {})
                        .get(LAST_APPLIED_ANNOTATION, "") or "{}")
                except _json.JSONDecodeError:
                    last = {}
                body = apply_patch_body(last if isinstance(last, dict)
                                        else {}, desired)
                try:
                    rc.patch(meta.name(obj), body,
                             ns if rc.namespaced else "",
                             patch_type="strategic")
                except errors.StatusError as e:
                    if e.code != 415:
                        raise
                    body = apply_patch_body(
                        last if isinstance(last, dict) else {},
                        desired, merge_lists=False)
                    rc.patch(meta.name(obj), body,
                             ns if rc.namespaced else "")
                self.out.write(f"{obj.get('kind', '').lower()}/"
                               f"{meta.name(obj)} configured\n")
            except errors.StatusError as e:
                if not errors.is_not_found(e):
                    raise
                rc.create(desired, ns if rc.namespaced else "")
                self.out.write(f"{obj.get('kind', '').lower()}/"
                               f"{meta.name(obj)} created\n")
        return 0

    def patch_cmd(self, resource: str, name: str, patch_str: str,
                  patch_type: str = "strategic",
                  namespace: str = "default") -> int:
        """kubectl patch (staging/src/k8s.io/kubectl/pkg/cmd/patch): apply a
        strategic-merge (default), RFC 7386 merge, or RFC 6902 json patch
        through the server's PATCH dialects (apiserver/registry.py patch —
        machinery/strategicpatch.py implements all three)."""
        rc = self._rc(resource)
        try:
            body = json.loads(patch_str)
        except json.JSONDecodeError:
            # kubectl accepts YAML patch bodies too (-p 'spec:\n  replicas: 3')
            yaml = _yaml()
            try:
                body = yaml.safe_load(patch_str)
            except yaml.YAMLError:
                raise errors.new_bad_request(
                    f"unable to parse patch {patch_str!r}: not JSON or YAML"
                ) from None
        if patch_type == "json":
            if not isinstance(body, list):
                raise errors.new_bad_request(
                    "a json patch body must be an array of operations")
        elif not isinstance(body, dict):
            raise errors.new_bad_request(
                f"a {patch_type} patch body must be a JSON object")
        rc.patch(name, body, namespace if rc.namespaced else "",
                 patch_type=patch_type)
        self.out.write(f"{rc.resource.rstrip('s')}/{name} patched\n")
        return 0

    def delete(self, resource: str, name: str,
               namespace: str = "default") -> int:
        rc = self._rc(resource)
        rc.delete(name, namespace if rc.namespaced else "")
        self.out.write(f"{rc.resource.rstrip('s')} \"{name}\" deleted\n")
        return 0

    def scale(self, resource: str, name: str, replicas: int,
              namespace: str = "default") -> int:
        rc = self._rc(resource)
        rc.put_scale(name, replicas, namespace)
        self.out.write(f"{rc.resource.rstrip('s')}/{name} scaled\n")
        return 0

    def cordon(self, node: str, on: bool = True) -> int:
        self.client.nodes.patch(node, {"spec": {"unschedulable": on or None}},
                                namespace="")
        self.out.write(f"node/{node} {'cordoned' if on else 'uncordoned'}\n")
        return 0

    def drain(self, node: str) -> int:
        self.cordon(node, True)
        pods = self.client.pods.list(
            "", field_selector=f"spec.nodeName={node}")["items"]
        for p in pods:
            ref = meta.controller_ref(p)
            if ref and ref.get("kind") == "DaemonSet":
                continue  # kubectl drain --ignore-daemonsets default
            try:
                self.client.pods.evict(meta.name(p), meta.namespace(p))
                self.out.write(f"pod/{meta.name(p)} evicted\n")
            except errors.StatusError as e:
                self.err.write(f"error evicting pod {meta.name(p)}: "
                               f"{e.message}\n")
        self.out.write(f"node/{node} drained\n")
        return 0

    def label(self, resource: str, name: str, kv: List[str],
              namespace: str = "default") -> int:
        rc = self._rc(resource)
        patch: Dict[str, Any] = {}
        for pair in kv:
            # only `key-` (no '=') is a removal; a VALUE ending in '-' is
            # a legitimate assignment (kubectl parseLabels)
            if "=" not in pair and pair.endswith("-"):
                patch[pair[:-1]] = None
            else:
                k, _, v = pair.partition("=")
                patch[k] = v
        rc.patch(name, {"metadata": {"labels": patch}},
                 namespace if rc.namespaced else "")
        self.out.write(f"{rc.resource.rstrip('s')}/{name} labeled\n")
        return 0

    def taint(self, node: str, spec: str) -> int:
        """kubectl taint nodes n1 key=value:NoSchedule (or key:NoSchedule-)."""
        cur = self.client.nodes.get(node, "")
        taints = [t for t in cur.get("spec", {}).get("taints", []) or []]
        if spec.endswith("-"):
            body = spec[:-1]
            key = body.split("=")[0].split(":")[0]
            taints = [t for t in taints if t.get("key") != key]
            action = "untainted"
        else:
            kv, _, effect = spec.rpartition(":")
            key, _, value = kv.partition("=")
            taints = [t for t in taints if t.get("key") != key]
            taints.append({"key": key, "value": value, "effect": effect})
            action = "tainted"
        cur.setdefault("spec", {})["taints"] = taints
        self.client.nodes.update(cur, "")
        self.out.write(f"node/{node} {action}\n")
        return 0

    def diff(self, filename: str, namespace: str = "default") -> int:
        """kubectl diff (staging/src/k8s.io/kubectl/pkg/cmd/diff): show what
        apply WOULD change, without changing it. The merged result is
        computed with the server's own JSON-merge semantics
        (apiserver/registry.py `_merge_patch` — the reference does this as
        a server-side dry-run apply) and printed as a unified diff of live
        vs merged. Exit code 1 when differences exist, 0 when none — the
        reference's contract."""
        import difflib

        from ..apiserver.registry import _merge_patch

        changed = False
        for obj in self._load_manifests(filename):
            rc = self._rc_for_obj(obj)
            ns = (meta.namespace(obj) or namespace) if rc.namespaced else ""
            name = meta.name(obj)
            desired = {k: v for k, v in obj.items() if k != "status"}
            try:
                live = rc.get(name, ns)
                merged = _merge_patch(meta.deep_copy(live), desired)
            except errors.StatusError as e:
                if not errors.is_not_found(e):
                    raise
                live, merged = {}, desired  # would be created
            def strip(o: Obj) -> Obj:
                o = meta.deep_copy(o)
                md = o.get("metadata", {})
                for k in ("resourceVersion", "uid", "creationTimestamp",
                          "generation"):
                    md.pop(k, None)
                return o
            a = json.dumps(strip(live), indent=2, sort_keys=True)
            b = json.dumps(strip(merged), indent=2, sort_keys=True)
            if a == b:
                continue
            changed = True
            tag = f"{obj.get('kind', '').lower()}/{name}"
            self.out.write("".join(difflib.unified_diff(
                a.splitlines(keepends=True), b.splitlines(keepends=True),
                fromfile=f"live/{tag}", tofile=f"merged/{tag}")))
            # json.dumps never ends in a newline, so the diff's final line
            # is always unterminated
            self.out.write("\n")
        return 1 if changed else 0

    def explain(self, path: str) -> int:
        """kubectl explain (staging/src/k8s.io/kubectl/pkg/cmd/explain):
        walk a dotted field path through the SERVED OpenAPI document
        (/openapi/v2 — the same walk the reference does), falling back to
        the in-process doc trees only if the server has no /openapi/v2."""
        from ..cli.explain import (
            _META, _from_openapi, explain_text)

        segs = path.split(".")
        rc = self._rc(segs[0])
        node = None
        try:
            doc = self.client.transport.request("GET", "/openapi/v2",
                                                {}, None)
        except Exception:  # noqa: BLE001 — older server: in-process docs
            doc = None
        if isinstance(doc, dict) and doc.get("definitions"):
            from ..apiserver.openapi import find_definition

            schema = find_definition(doc, rc.group, rc.version,
                                     resource=rc.resource)
            if schema is not None:
                node = _from_openapi(schema)
                node["fields"].setdefault("metadata", _META)
        if node is None and rc.group not in ("", "apps", "batch", "policy"):
            # find_definition's kind→plural match is naive (irregular
            # plurals miss), and an older server may serve no /openapi/v2
            # at all: fetch the CRD's schema by its exact stored name
            try:
                crd = self.client.customresourcedefinitions.get(
                    f"{rc.resource}.{rc.group}", "")
                versions = crd.get("spec", {}).get("versions") or []
                v = next((x for x in versions
                          if x.get("name") == rc.version), None) \
                    or (versions[0] if versions else None)
                crd_schema = ((v or {}).get("schema") or {}).get(
                    "openAPIV3Schema") or (crd.get("spec", {})
                                           .get("validation") or {}).get(
                                               "openAPIV3Schema")
                if crd_schema is not None:
                    node = _from_openapi(
                        crd_schema, f"Custom resource {rc.resource}")
                    node["fields"].setdefault("metadata", _META)
            except errors.StatusError:
                pass
        text = explain_text(rc.resource, rc.group, rc.version, segs[1:],
                            node=node)
        if text is None:
            self.err.write(f"error: field {'.'.join(segs)!r} does not "
                           "exist\n")
            return 1
        self.out.write(text)
        return 0

    def _deployment_rses(self, name: str, ns: str):
        from ..controllers.workloads import rs_revision

        d = self.client.deployments.get(name, ns)
        uid = d["metadata"]["uid"]
        rses = [rs for rs in self.client.replicasets.list(ns)["items"]
                if any(o.get("uid") == uid and o.get("controller")
                       for o in rs["metadata"].get("ownerReferences", []))]
        return d, sorted(rses, key=rs_revision), rs_revision

    def rollout(self, subverb: str, target: str,
                namespace: str = "default", to_revision: int = 0,
                timeout: float = 60.0) -> int:
        """kubectl rollout status|restart|history|undo for deployments
        (staging/src/k8s.io/kubectl/pkg/cmd/rollout + polymorphichelpers):
        status polls the observed rollout, restart stamps the template's
        restartedAt annotation, history lists ReplicaSet revisions, undo
        re-applies a previous revision's template (becoming the newest
        revision)."""
        res, _, name = target.partition("/")
        if res not in ("deployment", "deployments", "deploy") or not name:
            self.err.write("error: rollout supports deployment/<name>\n")
            return 1
        if subverb == "status":
            import time as _time

            deadline = _time.monotonic() + timeout
            while _time.monotonic() < deadline:
                d = self.client.deployments.get(name, namespace)
                want = int(d["spec"].get("replicas", 1))
                st = d.get("status", {})
                if (st.get("observedGeneration", 0)
                        >= d["metadata"].get("generation", 0)
                        and st.get("updatedReplicas", 0) == want
                        and st.get("readyReplicas", 0) == want
                        and st.get("replicas", 0) == want):
                    self.out.write(
                        f'deployment "{name}" successfully rolled out\n')
                    return 0
                _time.sleep(0.2)
            self.err.write(f'error: deployment "{name}" did not roll out '
                           f"within {timeout:g}s\n")
            return 1
        if subverb == "restart":
            stamp = meta.now_rfc3339()
            self.client.deployments.patch(name, {"spec": {"template": {
                "metadata": {"annotations": {
                    "kubectl.kubernetes.io/restartedAt": stamp}}}}},
                namespace)
            self.out.write(f"deployment.apps/{name} restarted\n")
            return 0
        if subverb == "history":
            _, rses, rev = self._deployment_rses(name, namespace)
            self.out.write("REVISION  CHANGE-CAUSE\n")
            for rs in rses:
                cause = (rs["metadata"].get("annotations") or {}).get(
                    "kubernetes.io/change-cause", "<none>")
                self.out.write(f"{rev(rs)}         {cause}\n")
            return 0
        if subverb == "undo":
            d, rses, rev = self._deployment_rses(name, namespace)
            if to_revision:
                target_rs = next((rs for rs in rses
                                  if rev(rs) == to_revision), None)
                if target_rs is None:
                    self.err.write(f"error: unable to find revision "
                                   f"{to_revision} of deployment "
                                   f"{name!r}\n")
                    return 1
            else:
                if len(rses) < 2:
                    self.err.write("error: no rollout history found\n")
                    return 1
                target_rs = rses[-2]  # previous revision
            tmpl = meta.deep_copy(target_rs["spec"]["template"])
            tmpl.get("metadata", {}).get("labels", {}).pop(
                "pod-template-hash", None)
            # full-object PUT, not a merge patch: the server's RFC 7386
            # merge cannot REMOVE template fields added after the target
            # revision (annotations, env, labels), which would leave a
            # hybrid spec matching neither revision
            for _ in range(5):
                cur = self.client.deployments.get(name, namespace)
                cur["spec"]["template"] = meta.deep_copy(tmpl)
                try:
                    self.client.deployments.update(cur, namespace)
                    break
                except errors.StatusError as e:
                    if not errors.is_conflict(e):
                        raise
            else:
                self.err.write("error: rollback write kept conflicting; "
                               "retry\n")
                return 1
            self.out.write(f"deployment.apps/{name} rolled back\n")
            return 0
        self.err.write(f"error: unknown rollout subcommand {subverb!r}\n")
        return 1

    def top(self, kind: str, namespace: str = "default") -> int:
        """kubectl top pods|nodes (staging/src/k8s.io/kubectl top_*.go):
        reads the aggregated resource-metrics API the metrics-server
        publishes (component/metrics_server.py)."""
        if kind not in ("pods", "nodes", "pod", "node", "po", "no"):
            self.err.write(f"error: unknown resource {kind!r}\n")
            return 1
        nodes = kind.startswith("no")
        try:
            rc = self.client.resource("metrics.k8s.io", "v1beta1",
                                      "nodes" if nodes else "pods",
                                      not nodes)
            items = rc.list("" if nodes else namespace).get("items", [])
        except errors.StatusError as e:
            if errors.is_not_found(e):
                # the group genuinely isn't served (no metrics-server);
                # RBAC denials / server errors surface as themselves
                self.err.write("error: Metrics API not available\n")
                return 1
            raise
        rows = []
        for m in items:
            if nodes:
                usage = m.get("usage", {})
            else:
                cpu = sum(parse_cpu_milli(
                    (c.get("usage") or {}).get("cpu", 0))
                    for c in m.get("containers", []))
                memk = sum(parse_mem_kib(
                    (c.get("usage") or {}).get("memory", 0))
                    for c in m.get("containers", []))
                usage = {"cpu": f"{cpu}m", "memory": f"{memk}Ki"}
            rows.append([meta.name(m), str(usage.get("cpu", "0")),
                         str(usage.get("memory", "0"))])
        render_rows(["NAME", "CPU(cores)", "MEMORY(bytes)"], rows, self.out)
        return 0

    def api_resources(self) -> int:
        self.out.write("NAME  SHORTNAMES  APIGROUP  NAMESPACED  KIND\n")
        for group, _, r in self._discovered_resources():
            if "/" in r["name"]:
                continue
            self.out.write(
                f"{r['name']}  {','.join(r.get('shortNames', []))}  "
                f"{group}  {r.get('namespaced', True)}  {r['kind']}\n")
        return 0

    def version(self) -> int:
        v = self.client.version()
        self.out.write(f"Server Version: {v.get('gitVersion', '?')}\n")
        return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kubectl",
                                description="kubernetes-tpu CLI")
    p.add_argument("-s", "--server", default="http://127.0.0.1:6443")
    p.add_argument("-n", "--namespace", default="default")
    sub = p.add_subparsers(dest="verb", required=True)

    g = sub.add_parser("get")
    g.add_argument("resource")
    g.add_argument("name", nargs="?", default="")
    g.add_argument("-A", "--all-namespaces", action="store_true")
    g.add_argument("-l", "--selector", default="")
    g.add_argument("-o", "--output", default="",
                   choices=["", "json", "yaml", "name", "wide"])

    d = sub.add_parser("describe")
    d.add_argument("resource")
    d.add_argument("name")

    for verb in ("create", "apply", "diff"):
        c = sub.add_parser(verb)
        c.add_argument("-f", "--filename", required=True)

    ex = sub.add_parser("explain")
    ex.add_argument("path", help="resource[.field.field...]")

    tp = sub.add_parser("top")
    tp.add_argument("kind", help="pods|nodes")

    ro = sub.add_parser("rollout")
    ro.add_argument("subverb", choices=["status", "restart", "history",
                                        "undo"])
    ro.add_argument("target", help="deployment/<name>")
    ro.add_argument("--to-revision", type=int, default=0)
    ro.add_argument("--timeout", type=float, default=60.0)

    pa = sub.add_parser("patch")
    pa.add_argument("resource")
    pa.add_argument("name")
    pa.add_argument("-p", "--patch", required=True)
    pa.add_argument("--type", default="strategic", dest="patch_type",
                    choices=["strategic", "merge", "json"])

    de = sub.add_parser("delete")
    de.add_argument("resource")
    de.add_argument("name")

    sc = sub.add_parser("scale")
    sc.add_argument("resource_slash_name")
    sc.add_argument("--replicas", type=int, required=True)

    for verb in ("cordon", "uncordon", "drain"):
        cn = sub.add_parser(verb)
        cn.add_argument("node")

    lb = sub.add_parser("label")
    lb.add_argument("resource")
    lb.add_argument("name")
    lb.add_argument("kv", nargs="+")

    tn = sub.add_parser("taint")
    tn.add_argument("nodes_literal")  # "nodes"
    tn.add_argument("node")
    tn.add_argument("spec")

    sub.add_parser("api-resources")
    sub.add_parser("version")
    return p


def main(argv: Optional[List[str]] = None, client: Optional[Client] = None,
         out=sys.stdout, err=sys.stderr) -> int:
    args = build_parser().parse_args(argv)
    cl = client or Client.http(args.server)
    k = Kubectl(cl, out=out, err=err)
    try:
        if args.verb == "get":
            return k.get(args.resource, args.name, args.namespace,
                         args.all_namespaces, args.selector, args.output)
        if args.verb == "describe":
            return k.describe_cmd(args.resource, args.name, args.namespace)
        if args.verb == "create":
            return k.create(args.filename, args.namespace)
        if args.verb == "apply":
            return k.apply(args.filename, args.namespace)
        if args.verb == "diff":
            return k.diff(args.filename, args.namespace)
        if args.verb == "explain":
            return k.explain(args.path)
        if args.verb == "top":
            return k.top(args.kind, args.namespace)
        if args.verb == "rollout":
            return k.rollout(args.subverb, args.target, args.namespace,
                             to_revision=args.to_revision,
                             timeout=args.timeout)
        if args.verb == "patch":
            return k.patch_cmd(args.resource, args.name, args.patch,
                               args.patch_type, args.namespace)
        if args.verb == "delete":
            return k.delete(args.resource, args.name, args.namespace)
        if args.verb == "scale":
            res, _, name = args.resource_slash_name.partition("/")
            return k.scale(res, name, args.replicas, args.namespace)
        if args.verb == "cordon":
            return k.cordon(args.node, True)
        if args.verb == "uncordon":
            return k.cordon(args.node, False)
        if args.verb == "drain":
            return k.drain(args.node)
        if args.verb == "label":
            return k.label(args.resource, args.name, args.kv, args.namespace)
        if args.verb == "taint":
            return k.taint(args.node, args.spec)
        if args.verb == "api-resources":
            return k.api_resources()
        if args.verb == "version":
            return k.version()
    except errors.StatusError as e:
        err.write(f"Error from server ({e.reason}): {e.message}\n")
        # kubectl diff reserves rc 1 for "differences found"; errors are >1
        return 2 if args.verb == "diff" else 1
    return 0
