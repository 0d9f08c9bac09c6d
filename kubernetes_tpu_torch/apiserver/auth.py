"""Authentication + RBAC authorization.

Analog of the apiserver handler chain's authn/authz stages
(`staging/src/k8s.io/apiserver/pkg/server/config.go` DefaultBuildHandlerChain)
with the RBAC evaluator from `plugin/pkg/auth/authorizer/rbac`: bearer
tokens map to users/groups; Roles/ClusterRoles grant (verbs × apiGroups ×
resources[/names]) and bind via Role/ClusterRoleBindings.

(A copy of the JAX package's apiserver/auth.py.)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..machinery import errors, meta

Obj = Dict[str, Any]


@dataclass(frozen=True)
class UserInfo:
    name: str
    groups: Tuple[str, ...] = ()


ANONYMOUS = UserInfo("system:anonymous", ("system:unauthenticated",))


class TokenAuthenticator:
    """Static token file analog (--token-auth-file), optionally chained
    with token authenticators consulted on a static-map miss — the
    union authenticator seat (bootstrap tokens plug in here,
    plugin/pkg/auth/authenticator/token/bootstrap)."""

    def __init__(self, tokens: Optional[Dict[str, UserInfo]] = None):
        self.tokens = dict(tokens or {})
        self.chain: list = []  # objects with authenticate(token) → UserInfo|None

    def add(self, token: str, user: str, groups: Tuple[str, ...] = ()) -> None:
        self.tokens[token] = UserInfo(user, tuple(groups) +
                                      ("system:authenticated",))

    def authenticate(self, headers: Dict[str, str]) -> UserInfo:
        auth = headers.get("Authorization", "") or headers.get(
            "authorization", "")
        if auth.startswith("Bearer "):
            token = auth[7:]
            user = self.tokens.get(token)
            if user is not None:
                return user
            for delegate in self.chain:
                user = delegate.authenticate(token)
                if user is not None:
                    return user
            raise errors.new_unauthorized("invalid bearer token")
        return ANONYMOUS


@dataclass(frozen=True)
class Attributes:
    """authorizer.Attributes: one request's identity + action."""

    user: UserInfo
    verb: str          # get|list|watch|create|update|patch|delete|...
    api_group: str
    resource: str
    namespace: str = ""
    name: str = ""
    path: str = ""     # for non-resource URLs


def _rule_matches(rule: Obj, attrs: Attributes) -> bool:
    """rbac/v1 PolicyRule match (rbac validation.go RuleAllows)."""
    def has(values: List[str], want: str) -> bool:
        return "*" in values or want in values

    if attrs.resource:
        return (has(rule.get("verbs") or [], attrs.verb)
                and has(rule.get("apiGroups") or [], attrs.api_group)
                and has(rule.get("resources") or [], attrs.resource)
                and (not rule.get("resourceNames")
                     or attrs.name in rule["resourceNames"]))
    # non-resource URL rule
    urls = rule.get("nonResourceURLs") or []
    return (has(rule.get("verbs") or [], attrs.verb)
            and any(u == "*" or u == attrs.path
                    or (u.endswith("*") and attrs.path.startswith(u[:-1]))
                    for u in urls))


class RBACAuthorizer:
    """Evaluate Role/ClusterRole bindings straight from storage (the
    reference keeps informer caches; our registry reads are cheap)."""

    def __init__(self, api):
        self.api = api

    def _subject_matches(self, subject: Obj, user: UserInfo) -> bool:
        kind = subject.get("kind", "")
        name = subject.get("name", "")
        if kind == "User":
            return name == user.name
        if kind == "Group":
            return name in user.groups
        if kind == "ServiceAccount":
            ns = subject.get("namespace", "")
            return user.name == f"system:serviceaccount:{ns}:{name}"
        return False

    def _rules_for_role(self, ref: Obj, binding_ns: str) -> List[Obj]:
        kind = ref.get("kind", "")
        name = ref.get("name", "")
        g = "rbac.authorization.k8s.io"
        try:
            if kind == "ClusterRole":
                role = self.api.store(g, "clusterroles").get("", name)
            else:
                role = self.api.store(g, "roles").get(binding_ns, name)
        except errors.StatusError:
            return []
        return role.get("rules") or []

    def authorize(self, attrs: Attributes) -> bool:
        g = "rbac.authorization.k8s.io"
        # cluster-wide bindings apply everywhere
        crb_store = self.api.store(g, "clusterrolebindings")
        bindings, _ = crb_store.storage.list(crb_store.key_root())
        for b in bindings:
            if any(self._subject_matches(s, attrs.user)
                   for s in b.get("subjects") or []):
                rules = self._rules_for_role(b.get("roleRef") or {}, "")
                if any(_rule_matches(r, attrs) for r in rules):
                    return True
        # namespaced bindings apply only inside their namespace
        if attrs.namespace:
            rb_store = self.api.store(g, "rolebindings")
            nbindings, _ = rb_store.storage.list(
                rb_store.prefix_for(attrs.namespace))
            for b in nbindings:
                if any(self._subject_matches(s, attrs.user)
                       for s in b.get("subjects") or []):
                    rules = self._rules_for_role(b.get("roleRef") or {},
                                                 attrs.namespace)
                    if any(_rule_matches(r, attrs) for r in rules):
                        return True
        return False


_VERB_BY_METHOD = {"GET": "get", "POST": "create", "PUT": "update",
                   "PATCH": "patch", "DELETE": "delete"}


def attributes_from_request(user: UserInfo, method: str, path: str,
                            query: Dict[str, str]) -> Attributes:
    """RequestInfoFactory (apiserver pkg/endpoints/request/requestinfo.go):
    method+path → authorization attributes."""
    parts = [p for p in path.split("/") if p]
    verb = _VERB_BY_METHOD.get(method, method.lower())
    if not parts or parts[0] not in ("api", "apis"):
        return Attributes(user, verb, "", "", path=path)
    if parts[0] == "api":
        group, rest = "", parts[2:]
    else:
        group, rest = (parts[1] if len(parts) > 1 else ""), parts[3:]
    namespace = ""
    if rest and rest[0] == "namespaces" and len(rest) >= 3 and not (
            len(rest) == 3 and rest[2] in ("finalize", "status")):
        namespace, rest = rest[1], rest[2:]
    resource = rest[0] if rest else ""
    name = rest[1] if len(rest) > 1 else ""
    sub = rest[2] if len(rest) > 2 else ""
    if sub:
        resource = f"{resource}/{sub}"
    if method == "GET":
        # ?watch=true is the watch verb even with a name: this server streams
        # single-object watches directly, so they must require the watch
        # permission. DIVERGES from the reference RequestInfoFactory, which
        # rewrites the verb only for nameless requests (requestinfo.go:210,
        # single-object watch there goes through a fieldSelector list) —
        # see docs/PARITY.md. Plain named GET stays "get".
        if query.get("watch") in ("true", "1"):
            verb = "watch"
        elif not name:
            verb = "list"
    return Attributes(user, verb, group, resource, namespace, name, path)


class AuthGate:
    """The authn→authz stage for the HTTP gateway. None members = disabled
    (matching --authorization-mode=AlwaysAllow)."""

    def __init__(self, authenticator: Optional[TokenAuthenticator] = None,
                 authorizer: Optional[RBACAuthorizer] = None,
                 always_allow_paths: Tuple[str, ...] = ("/healthz", "/readyz",
                                                        "/livez", "/version"),
                 allow_anonymous: bool = True):
        self.authenticator = authenticator
        self.authorizer = authorizer
        self.always_allow_paths = always_allow_paths
        # --anonymous-auth=false: credential-less requests are 401s rather
        # than the system:anonymous identity
        self.allow_anonymous = allow_anonymous

    def check(self, method: str, path: str, query: Dict[str, str],
              headers: Dict[str, str]) -> str:
        """Raises on deny; returns the authenticated username (audit
        attribution — the reference threads user.Info through the request
        context for exactly this). `check_info` returns the full UserInfo
        for callers that need groups (CSR identity stamping)."""
        info = self.check_info(method, path, query, headers)
        return info.name if info is not None else ""

    def check_info(self, method: str, path: str, query: Dict[str, str],
                   headers: Dict[str, str]) -> Optional[UserInfo]:
        if self.authenticator is None:
            return None
        if path in self.always_allow_paths:
            return None
        user = self.authenticator.authenticate(headers)
        if not self.allow_anonymous and user is ANONYMOUS:
            raise errors.new_unauthorized(
                "anonymous requests are disabled")
        if self.authorizer is None:
            return user
        attrs = attributes_from_request(user, method, path, query)
        if not self.authorizer.authorize(attrs):
            raise errors.new_forbidden(
                attrs.resource or attrs.path, attrs.name,
                f'User "{user.name}" cannot {attrs.verb} resource '
                f'"{attrs.resource}" in API group "{attrs.api_group}"'
                + (f' in the namespace "{attrs.namespace}"'
                   if attrs.namespace else ""))
        return user
