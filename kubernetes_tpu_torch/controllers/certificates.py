"""Credential lifecycle: CSR signing/approval + ClusterRole aggregation.

Analogs:
  * `pkg/controller/certificates/signer/signer.go` — watch approved CSRs
    without a certificate, issue one from the cluster CA;
  * `pkg/controller/certificates/approver/sarapprover.go` — auto-approve
    kubelet client CSRs from bootstrap identities;
  * `pkg/controller/clusterroleaggregation/clusterroleaggregation_controller.go`
    — ClusterRoles with an aggregationRule get their rules recomputed as
    the union of the selected ClusterRoles' rules.

Certificates are REAL X.509 (the `cryptography` package): kubeadm init
mints an RSA CA; joiners generate a key, build a PKCS#10 CSR with the
kubelet identity (CN=system:node:<name>, O=system:nodes), post it, and
receive a CA-signed cert — verifiable against the CA by any TLS stack.
"""

from __future__ import annotations

import base64
import datetime
import time
from typing import Dict, List, Optional, Tuple

from ..controllers.base import Controller
from ..machinery import errors, meta

Obj = Dict

NODE_CLIENT_USAGES = {"digital signature", "key encipherment",
                      "client auth"}
BOOTSTRAP_GROUP = "system:bootstrappers"
NODES_GROUP = "system:nodes"


# --------------------------------------------------------------------- #
# CA + CSR crypto (cryptography-backed)
# --------------------------------------------------------------------- #


class ClusterCA:
    """The cluster certificate authority (kubeadm's phases/certs seat)."""

    def __init__(self, common_name: str = "kubernetes"):
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import rsa
        from cryptography.x509.oid import NameOID

        self.key = rsa.generate_private_key(public_exponent=65537,
                                            key_size=2048)
        subject = x509.Name([
            x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
        now = datetime.datetime.now(datetime.timezone.utc)
        self.cert = (
            x509.CertificateBuilder()
            .subject_name(subject).issuer_name(subject)
            .public_key(self.key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=3650))
            .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                           critical=True)
            .sign(self.key, hashes.SHA256()))

    def ca_pem(self) -> bytes:
        from cryptography.hazmat.primitives import serialization

        return self.cert.public_bytes(serialization.Encoding.PEM)

    def sign_csr(self, csr_pem: bytes,
                 duration: datetime.timedelta =
                 datetime.timedelta(days=365)) -> bytes:
        """Issue a client certificate for a PKCS#10 request (signer.go
        sign()): subject comes from the CSR, validity from the signer."""
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes

        csr = x509.load_pem_x509_csr(csr_pem)
        if not csr.is_signature_valid:
            raise ValueError("CSR signature does not verify")
        now = datetime.datetime.now(datetime.timezone.utc)
        cert = (
            x509.CertificateBuilder()
            .subject_name(csr.subject)
            .issuer_name(self.cert.subject)
            .public_key(csr.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + duration)
            .add_extension(x509.ExtendedKeyUsage(
                [x509.oid.ExtendedKeyUsageOID.CLIENT_AUTH]), critical=False)
            .sign(self.key, hashes.SHA256()))
        from cryptography.hazmat.primitives import serialization

        return cert.public_bytes(serialization.Encoding.PEM)


def make_node_csr(node_name: str) -> Tuple[bytes, bytes]:
    """A kubelet identity keypair + PKCS#10 CSR (kubeadm join's
    phases/kubelet TLS bootstrap): CN=system:node:<name>, O=system:nodes.
    Returns (key_pem, csr_pem)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    csr = (x509.CertificateSigningRequestBuilder()
           .subject_name(x509.Name([
               x509.NameAttribute(NameOID.ORGANIZATION_NAME, NODES_GROUP),
               x509.NameAttribute(NameOID.COMMON_NAME,
                                  f"system:node:{node_name}")]))
           .sign(key, hashes.SHA256()))
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption())
    return key_pem, csr.public_bytes(serialization.Encoding.PEM)


def csr_object(name: str, csr_pem: bytes, username: str,
               groups: List[str]) -> Obj:
    return {
        "apiVersion": "certificates.k8s.io/v1beta1",
        "kind": "CertificateSigningRequest",
        "metadata": {"name": name},
        "spec": {
            "request": base64.b64encode(csr_pem).decode(),
            "usages": sorted(NODE_CLIENT_USAGES),
            "username": username,
            "groups": list(groups),
            "signerName": "kubernetes.io/kube-apiserver-client-kubelet",
        },
    }


def _condition(csr: Obj, cond_type: str) -> bool:
    return any(c.get("type") == cond_type
               for c in csr.get("status", {}).get("conditions", []) or [])


# --------------------------------------------------------------------- #
# controllers
# --------------------------------------------------------------------- #


class CSRSigningController(Controller):
    """signer.go: approved + unsigned → issue; denied → ignore."""

    name = "csrsigning"

    def __init__(self, client, factory, ca: Optional[ClusterCA] = None):
        super().__init__(client, factory)
        # the CA resolves LAZILY on first use: csrsigning is in the default
        # roster, and most clusters never post a CSR — RSA keygen + a
        # Secret round-trip do not belong on every manager's startup path
        self._ca = ca
        self.csr_informer = self.watch_resource("certificatesigningrequests")

    @property
    def ca(self) -> ClusterCA:
        if self._ca is None:
            self._ca = _shared_ca(self.client)
        return self._ca

    #: signers this controller serves (signer.go handles only its own
    #: signerName; "" covers pre-signerName legacy-unknown requests)
    SIGNER_NAMES = ("kubernetes.io/kube-apiserver-client-kubelet",
                    "kubernetes.io/legacy-unknown", "")

    def sync(self, key: str) -> None:
        name = key.rsplit("/", 1)[-1]
        try:
            csr = self.client.certificatesigningrequests.get(name, "")
        except errors.StatusError:
            return
        if csr.get("spec", {}).get("signerName", "") not in \
                self.SIGNER_NAMES:
            return  # some other signer's request — never preempt it
        if not _condition(csr, "Approved") or _condition(csr, "Denied") \
                or _condition(csr, "Failed"):
            # Failed is terminal: re-signing the same malformed request
            # would hot-loop (each status write re-enqueues via informer)
            return
        if csr.get("status", {}).get("certificate"):
            return  # already issued
        req_b64 = csr.get("spec", {}).get("request", "")
        try:
            cert_pem = self.ca.sign_csr(base64.b64decode(req_b64))
        except Exception as e:  # noqa: BLE001 — malformed request: flag it
            csr.setdefault("status", {}).setdefault("conditions", []).append(
                {"type": "Failed", "reason": "SigningError",
                 "message": str(e)})
            self.client.certificatesigningrequests.update_status(csr, "")
            return
        csr.setdefault("status", {})["certificate"] = \
            base64.b64encode(cert_pem).decode()
        self.client.certificatesigningrequests.update_status(csr, "")


class CSRApprovingController(Controller):
    """sarapprover.go reduced to its recognizers: auto-approve kubelet
    CLIENT csrs — a bootstrap identity requesting a node client cert
    (CN=system:node:..., O=system:nodes, client usages only)."""

    name = "csrapproving"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.csr_informer = self.watch_resource("certificatesigningrequests")

    def _is_node_client_csr(self, csr: Obj) -> bool:
        from cryptography import x509
        from cryptography.x509.oid import NameOID

        spec = csr.get("spec", {})
        usages = set(spec.get("usages") or [])
        if not usages or not usages <= NODE_CLIENT_USAGES:
            return False
        try:
            req = x509.load_pem_x509_csr(
                base64.b64decode(spec.get("request", "")))
        except Exception:  # noqa: BLE001
            return False
        cn = [a.value for a in
              req.subject.get_attributes_for_oid(NameOID.COMMON_NAME)]
        orgs = [a.value for a in
                req.subject.get_attributes_for_oid(
                    NameOID.ORGANIZATION_NAME)]
        return bool(cn) and cn[0].startswith("system:node:") \
            and orgs == [NODES_GROUP]

    def sync(self, key: str) -> None:
        name = key.rsplit("/", 1)[-1]
        try:
            csr = self.client.certificatesigningrequests.get(name, "")
        except errors.StatusError:
            return
        if _condition(csr, "Approved") or _condition(csr, "Denied"):
            return
        groups = set(csr.get("spec", {}).get("groups") or [])
        requester_ok = bool(groups & {BOOTSTRAP_GROUP, NODES_GROUP})
        if not (requester_ok and self._is_node_client_csr(csr)):
            return  # left for a human/other approver, as in the reference
        csr.setdefault("status", {}).setdefault("conditions", []).append({
            "type": "Approved", "reason": "AutoApproved",
            "message": "Auto approving kubelet client certificate after "
                       "validating bootstrap identity."})
        self.client.certificatesigningrequests.update_status(csr, "")


class ClusterRoleAggregationController(Controller):
    """clusterroleaggregation_controller.go: a ClusterRole carrying an
    aggregationRule owns no rules of its own — its rules are recomputed as
    the concatenation of every selected ClusterRole's rules, in sorted
    name order, whenever any ClusterRole changes."""

    name = "clusterroleaggregation"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.role_informer = self.watch_resource(
            "clusterroles", enqueue_fn=self._role_changed)

    def _role_changed(self, obj: Obj) -> None:
        # ANY role change can affect every aggregated role's selection
        for role in self.role_informer.lister.list():
            if role.get("aggregationRule"):
                self.enqueue(role)

    def _selected(self, selectors: List[Obj]) -> List[Obj]:
        from ..machinery.labels import from_label_selector

        out = []
        for role in self.role_informer.lister.list():
            if role.get("aggregationRule"):
                continue  # aggregated roles never aggregate each other
            lbls = meta.labels_of(role)
            if any(from_label_selector(sel).matches(lbls)
                   for sel in selectors):
                out.append(role)
        return sorted(out, key=meta.name)

    def sync(self, key: str) -> None:
        name = key.rsplit("/", 1)[-1]
        try:
            role = self.client.clusterroles.get(name, "")
        except errors.StatusError:
            return
        rule = role.get("aggregationRule") or {}
        selectors = rule.get("clusterRoleSelectors") or []
        if not selectors:
            return
        want: List[Obj] = []
        for src in self._selected(selectors):
            want.extend(src.get("rules") or [])
        if role.get("rules") == want:
            return
        role["rules"] = want
        self.client.clusterroles.update(role, "")


# --------------------------------------------------------------------- #
# bootstrap tokens (plugin/pkg/auth/authenticator/token/bootstrap)
# --------------------------------------------------------------------- #

BOOTSTRAP_SECRET_TYPE = "bootstrap.kubernetes.io/token"


def make_bootstrap_token() -> Tuple[str, Obj]:
    """A kubeadm bootstrap token + its kube-system Secret
    (bootstraputil.GenerateBootstrapToken): format <id>.<secret>."""
    import secrets as pysecrets

    alphabet = "0123456789abcdefghijklmnopqrstuvwxyz"
    tid = "".join(pysecrets.choice(alphabet) for _ in range(6))
    tsecret = "".join(pysecrets.choice(alphabet) for _ in range(16))
    secret = {
        "apiVersion": "v1", "kind": "Secret",
        "metadata": {"name": f"bootstrap-token-{tid}",
                     "namespace": "kube-system"},
        "type": BOOTSTRAP_SECRET_TYPE,
        "stringData": {
            "token-id": tid,
            "token-secret": tsecret,
            "usage-bootstrap-authentication": "true",
            "usage-bootstrap-signing": "true",
            "auth-extra-groups": BOOTSTRAP_GROUP,
        },
    }
    return f"{tid}.{tsecret}", secret


class BootstrapTokenAuthenticator:
    """Validate `Bearer <id>.<secret>` against kube-system bootstrap-token
    Secrets (bootstrap/token_authenticator.go): usable tokens authenticate
    as system:bootstrap:<id> in system:bootstrappers."""

    def __init__(self, api):
        self.api = api

    def authenticate(self, token: str):
        from ..apiserver.auth import UserInfo

        if "." not in token:
            return None
        tid, _, tsecret = token.partition(".")
        try:
            store = self.api.store("", "secrets")
            secret = store.get("kube-system", f"bootstrap-token-{tid}")
        except errors.StatusError:
            return None
        if secret.get("type") != BOOTSTRAP_SECRET_TYPE:
            return None
        data = _bootstrap_secret_data(secret)
        if data.get("token-secret") != tsecret:
            return None
        if data.get("usage-bootstrap-authentication") != "true":
            return None
        exp = data.get("expiration", "")
        if exp:
            try:
                when = datetime.datetime.fromisoformat(
                    exp.replace("Z", "+00:00"))
                if when.tzinfo is None:  # naive timestamps read as UTC
                    when = when.replace(tzinfo=datetime.timezone.utc)
                if when <= datetime.datetime.now(datetime.timezone.utc):
                    return None
            except (ValueError, TypeError):
                return None
        groups = tuple(g for g in
                       data.get("auth-extra-groups", "").split(",") if g)
        return UserInfo(f"system:bootstrap:{tid}",
                        ("system:authenticated",) + groups)


def _bootstrap_secret_data(secret: Obj) -> Dict[str, str]:
    """Decode a bootstrap Secret's data tolerantly: a key with invalid
    base64 / non-UTF-8 bytes is skipped, never allowed to abort the
    caller's whole pass."""
    out: Dict[str, str] = dict(secret.get("stringData") or {})
    for k, v in (secret.get("data") or {}).items():
        try:
            out[k] = base64.b64decode(v).decode()
        except Exception:  # noqa: BLE001 — malformed entry: skip the key
            continue
    return out


class TokenCleanerController(Controller):
    """`pkg/controller/bootstrap/tokencleaner.go`: kube-system
    bootstrap-token Secrets past their expiration are deleted — an
    expired token must stop authenticating AND disappear. Scoped to
    kube-system, as the reference: user Secrets of the same type in
    other namespaces are never touched."""

    name = "tokencleaner"

    def __init__(self, client, factory, clock=time.time):
        super().__init__(client, factory)
        self.clock = clock
        self.secret_informer = self.watch_resource("secrets")

    def poll_once(self, now=None) -> None:
        # expiry is time-driven, not event-driven: re-scan on the manager's
        # poll tick so a token expires without needing a Secret event
        for s in self.secret_informer.lister.list():
            if s.get("type") == BOOTSTRAP_SECRET_TYPE and \
                    meta.namespace(s) == "kube-system":
                self.enqueue(s)

    def sync(self, key: str) -> None:
        ns, _, name = key.partition("/")
        if ns != "kube-system":
            return
        try:
            secret = self.client.secrets.get(name, ns)
        except errors.StatusError:
            return
        if secret.get("type") != BOOTSTRAP_SECRET_TYPE:
            return
        exp = _bootstrap_secret_data(secret).get("expiration", "")
        if not exp:
            return
        try:
            when = datetime.datetime.fromisoformat(
                exp.replace("Z", "+00:00"))
            if when.tzinfo is None:
                when = when.replace(tzinfo=datetime.timezone.utc)
        except (ValueError, TypeError):
            # unparseable expirations are treated as expired (the
            # reference logs and deletes — a token that cannot prove
            # validity must not live forever)
            when = datetime.datetime.fromtimestamp(
                0, datetime.timezone.utc)
        now = datetime.datetime.fromtimestamp(self.clock(),
                                              datetime.timezone.utc)
        if when <= now:
            try:
                self.client.secrets.delete(name, ns)
            except errors.StatusError:
                pass


def jws_sign_claim(content: str, token_id: str, token_secret: str) -> str:
    """Compact JWS (HS256) over the cluster-info payload, keyed by the
    bootstrap token — `pkg/controller/bootstrap/jws.go computeDetachedSig`
    (the kid claim carries the token id so joiners can pick their sig)."""
    import hashlib
    import hmac
    import json as _json

    def b64url(b: bytes) -> str:
        return base64.urlsafe_b64encode(b).rstrip(b"=").decode()

    header = b64url(_json.dumps(
        {"alg": "HS256", "kid": token_id},
        separators=(",", ":"), sort_keys=True).encode())
    payload = b64url(content.encode())
    mac = hmac.new(token_secret.encode(),
                   f"{header}.{payload}".encode(), hashlib.sha256).digest()
    # detached signature: the payload travels in the ConfigMap itself
    return f"{header}..{b64url(mac)}"


class BootstrapSignerController(Controller):
    """`pkg/controller/bootstrap/bootstrapsigner.go`: keep the kube-public
    cluster-info ConfigMap signed with a JWS per usable bootstrap token
    (`jws-kubeadm-<tokenid>` keys), so joiners can verify the cluster CA
    they are told about USING ONLY their token."""

    name = "bootstrapsigner"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        # only bootstrap-token churn (kube-system) re-signs: unrelated
        # secret events must not each trigger a GET + full HMAC pass
        self.secret_informer = self.watch_resource(
            "secrets", enqueue_fn=lambda o: (
                self.enqueue_key("cluster-info")
                if o.get("type") == BOOTSTRAP_SECRET_TYPE
                and meta.namespace(o) == "kube-system" else None))
        self.cm_informer = self.watch_resource(
            "configmaps", enqueue_fn=lambda o: (
                self.enqueue_key("cluster-info")
                if meta.name(o) == "cluster-info" else None))

    def sync(self, key: str) -> None:
        # the manager's resync enqueues raw object keys; anything other
        # than cluster-info or a kube-system bootstrap token is noise
        # (the pass itself is keyed on nothing — dedup to one real run)
        ns, _, name = key.rpartition("/")
        if ns not in ("", "kube-system", "kube-public"):
            return
        if ns == "kube-system" and not name.startswith("bootstrap-token-"):
            return
        if ns == "kube-public" and name != "cluster-info":
            return
        try:
            cm = self.client.configmaps.get("cluster-info", "kube-public")
        except errors.StatusError:
            return  # nothing to sign until kubeadm publishes it
        content = (cm.get("data") or {}).get("kubeconfig", "")
        if not content:
            return
        want = {}
        for s in self.secret_informer.lister.list():
            if s.get("type") != BOOTSTRAP_SECRET_TYPE or \
                    meta.namespace(s) != "kube-system":
                continue
            data = _bootstrap_secret_data(s)
            if data.get("usage-bootstrap-signing") != "true":
                continue
            tid, tsecret = data.get("token-id"), data.get("token-secret")
            if tid and tsecret:
                want[f"jws-kubeadm-{tid}"] = jws_sign_claim(
                    content, tid, tsecret)
        have = {k: v for k, v in (cm.get("data") or {}).items()
                if k.startswith("jws-kubeadm-")}
        if have == want:
            return
        new_data = {k: v for k, v in (cm.get("data") or {}).items()
                    if not k.startswith("jws-kubeadm-")}
        new_data.update(want)
        cm["data"] = new_data
        try:
            self.client.configmaps.update(cm, "kube-public")
        except errors.StatusError:
            pass  # conflict: informer re-enqueues with the fresh copy


# --------------------------------------------------------------------- #
# the join protocol helper (phases/kubelet TLS bootstrap)
# --------------------------------------------------------------------- #


def _shared_ca(client) -> ClusterCA:
    """One CA per control plane: minted on first use and persisted as the
    kube-system `cluster-ca` Secret so every signer instance (and restart)
    issues from the same root. The private key living in a Secret is the
    reference's own layout (kubeadm's certs upload)."""
    from cryptography.hazmat.primitives import serialization

    try:
        existing = client.secrets.get("cluster-ca", "kube-system")
        data = existing.get("data") or {}
        key_pem = base64.b64decode(data.get("tls.key", ""))
        cert_pem = base64.b64decode(data.get("tls.crt", ""))
        if key_pem and cert_pem:
            ca = ClusterCA.__new__(ClusterCA)
            ca.key = serialization.load_pem_private_key(key_pem,
                                                       password=None)
            from cryptography import x509

            ca.cert = x509.load_pem_x509_certificate(cert_pem)
            return ca
    except errors.StatusError:
        pass
    ca = ClusterCA()
    key_pem = ca.key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption())
    secret = {"apiVersion": "v1", "kind": "Secret",
              "metadata": {"name": "cluster-ca",
                           "namespace": "kube-system"},
              "type": "kubernetes.io/tls",
              "data": {"tls.key": base64.b64encode(key_pem).decode(),
                       "tls.crt": base64.b64encode(ca.ca_pem()).decode()}}
    try:
        client.secrets.create(secret, "kube-system")
    except errors.StatusError as e:
        if errors.is_already_exists(e):
            return _shared_ca(client)  # lost the race: load the winner's
        raise
    return ca


def post_node_csr(client, node_name: str, username: str,
                  groups: List[str]) -> bytes:
    """Posting half of TLS bootstrap: generate key+CSR, create the CSR
    object; returns the private key PEM. Split from collection so a batch
    join can post every CSR first and overlap the controllers' approve/
    sign latency across nodes."""
    key_pem, csr_pem = make_node_csr(node_name)
    obj = csr_object(f"node-csr-{node_name}", csr_pem, username, groups)
    for attempt in range(3):
        try:
            client.certificatesigningrequests.create(obj, "")
            break
        except errors.StatusError as e:
            if not errors.is_already_exists(e) or attempt == 2:
                raise
            # a leftover CSR belongs to a PREVIOUS key — collecting its
            # certificate against our fresh key would hand back a
            # mismatched pair. Re-join semantics: replace it (kubectl
            # delete csr + retry, what kubeadm prescribes for re-joins).
            # A concurrent racer may delete first: NotFound is fine.
            try:
                client.certificatesigningrequests.delete(
                    f"node-csr-{node_name}", "")
            except errors.StatusError as de:
                if not errors.is_not_found(de):
                    raise
    return key_pem


def collect_node_identity(client, node_name: str, key_pem: bytes,
                          timeout: float = 30.0) -> Dict[str, bytes]:
    """Collection half: wait for the issued certificate, return
    {key, cert, ca}."""
    name = f"node-csr-{node_name}"
    deadline = time.time() + timeout
    cert_b64 = ""
    while time.time() < deadline:
        csr = client.certificatesigningrequests.get(name, "")
        cert_b64 = csr.get("status", {}).get("certificate", "")
        if cert_b64:
            break
        time.sleep(0.1)
    if not cert_b64:
        raise TimeoutError(f"CSR {name} was not issued within {timeout}s")
    # CA certificate: kube-public/cluster-info first — the only CA source a
    # bootstrap-token identity may read under RBAC (the kube-system
    # cluster-ca Secret also holds the CA PRIVATE KEY and is admin-only);
    # fall back to the Secret for admin callers / unauthenticated clusters
    ca_pem = b""
    try:
        cm = client.configmaps.get("cluster-info", "kube-public")
        ca_pem = ((cm.get("data") or {}).get("ca.crt") or "").encode()
    except errors.StatusError:
        pass
    if not ca_pem:
        ca_secret = client.secrets.get("cluster-ca", "kube-system")
        ca_pem = base64.b64decode((ca_secret.get("data") or {})
                                  .get("tls.crt", ""))
    return {"key": key_pem, "cert": base64.b64decode(cert_b64),
            "ca": ca_pem}


def bootstrap_node_identity(client, node_name: str, username: str,
                            groups: List[str],
                            timeout: float = 30.0) -> Dict[str, bytes]:
    """The joiner's half of TLS bootstrap: generate key+CSR, post, wait for
    the approve/sign controllers, return {key, cert, ca}. The caller's
    client should be authenticated as the bootstrap identity."""
    key_pem = post_node_csr(client, node_name, username, groups)
    return collect_node_identity(client, node_name, key_pem, timeout)
