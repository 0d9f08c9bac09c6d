"""Cluster lifecycle: the kubeadm workflow for the port's control plane.

Analog of `cmd/kubeadm` phases reduced to what a single-process control
plane needs:

  init  (`up`)    storage → apiserver (+HTTP gateway) → scheduler →
                  controller-manager → optional hollow nodes, in dependency
                  order (cmd/kubeadm/app/cmd/init.go phase runner).
  join  (`join`)  add worker nodes to a RUNNING cluster over its URL —
                  the kubeadm-join flow with hollow kubelets standing in
                  for real ones (cmd/kubeadm/app/cmd/join.go).
  reset (`down`)  tear everything down in reverse order.

A KubeSchedulerConfiguration file/dict flows through `scheduler_config`
into the scheduler exactly as `--config` does for the reference binary.
`python -m kubernetes_tpu_torch.cli cluster up` serves until interrupted.

(A copy of the JAX package's cli/cluster.py. `ClusterConfig.device` is
where every scheduler the cluster builds runs — the one `up` starts and
the one `upgrade_apply` restarts: the card unless the caller names
another, as `JAX_PLATFORMS` picks the JAX package's backend. With no card
and no explicit `device="cpu"`, `up` raises before it starts anything.)
"""

from __future__ import annotations

import base64
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..apiserver import APIServer, HTTPGateway
from ..client import Client
from ..controllers import ControllerManager
from ..kubemark import HollowCluster
from ..sched.server import SchedulerServer
from ..state.arrays import resolve_device


@dataclass
class ClusterConfig:
    """The kubeadm ClusterConfiguration analog."""

    host: str = "127.0.0.1"
    port: int = 0  # 0 = ephemeral
    hollow_nodes: int = 0
    hollow_capacity: Dict[str, str] = field(default_factory=lambda: {
        "cpu": "8", "memory": "16Gi", "pods": "110"})
    leader_elect: bool = False
    controllers: Optional[List[str]] = None
    # authenticated=True puts an AuthGate on the gateway: components use a
    # minted admin token, and joiners' bootstrap tokens are VALIDATED by
    # the BootstrapTokenAuthenticator chain (the kubeadm topology; off by
    # default to keep the open integration-test surface)
    authenticated: bool = False
    scheduler_name: str = "default-scheduler"
    # KubeSchedulerConfiguration: a path, YAML/JSON string, or dict
    # (sched/config.py load_config) — the kube-scheduler --config analog
    scheduler_config: Optional[object] = None
    # where the scheduler runs: None is the CUDA card, "cpu" the CPU
    # (state/arrays.py resolve_device)
    device: Optional[str] = None


def _parse_version(v: str):
    """'v1.17.0-tpu.1' → (1, 17, 0); None if unparseable."""
    core = v.lstrip("v").split("-")[0]
    try:
        parts = [int(x) for x in core.split(".")[:3]]
        while len(parts) < 3:
            parts.append(0)
        return tuple(parts)
    except ValueError:
        return None


def _skew_allows(cur: str, target: str):
    """kubeadm's version-skew policy (phases/upgrade/policy.go): no
    downgrades, at most one minor-version jump."""
    c, t = _parse_version(cur), _parse_version(target)
    if c is None or t is None:
        return False, f"unparseable version: {cur!r} -> {target!r}"
    if t < c:
        return False, f"downgrade {cur} -> {target} is not supported"
    if t[0] != c[0]:
        return False, f"major version change {cur} -> {target} not supported"
    if t[1] > c[1] + 1:
        return False, (f"cannot skip minor versions: {cur} -> {target} "
                       "(one minor at a time)")
    return True, ""


class Cluster:
    """All control-plane components in one process (the integration-test /
    local-dev topology; each component still talks REST through the gateway
    so the process boundary semantics hold)."""

    def __init__(self, config: Optional[ClusterConfig] = None):
        self.config = config or ClusterConfig()
        self.api: Optional[APIServer] = None
        self.gateway: Optional[HTTPGateway] = None
        self.client: Optional[Client] = None
        self.scheduler: Optional[SchedulerServer] = None
        self.manager: Optional[ControllerManager] = None
        self.hollow: Optional[HollowCluster] = None
        self._joined: List[HollowCluster] = []
        self.bootstrap_token: str = ""
        self.admin_token: str = ""
        self.node_credentials: Dict[str, Dict[str, bytes]] = {}

    # -- phases (kubeadm init workflow) ------------------------------------- #

    def up(self) -> "Cluster":
        cfg = self.config
        # before anything starts: no card and no explicit CPU raises here,
        # with no apiserver or gateway left behind
        device = resolve_device(cfg.device)
        self.api = APIServer()
        auth_gate = None
        self.admin_token = ""
        if cfg.authenticated:
            import secrets as pysecrets

            from ..apiserver.auth import (
                AuthGate, RBACAuthorizer, TokenAuthenticator)
            from ..controllers.certificates import (
                BootstrapTokenAuthenticator)

            self.admin_token = pysecrets.token_hex(16)
            ta = TokenAuthenticator()
            ta.add(self.admin_token, "kubernetes-admin",
                   ("system:masters",))
            ta.chain.append(BootstrapTokenAuthenticator(self.api))
            # RBAC at the gateway: without an authorizer every
            # authenticated identity — including a joiner's bootstrap
            # token — had unrestricted access (e.g. GET of the kube-system
            # cluster-ca Secret holding the CA private key). The reference
            # confines system:bootstrappers to posting/collecting CSRs;
            # _seed_rbac_policy writes the same confinement
            self._seed_rbac_policy()
            auth_gate = AuthGate(authenticator=ta,
                                 authorizer=RBACAuthorizer(self.api),
                                 allow_anonymous=False)
        self.gateway = HTTPGateway(self.api, host=cfg.host, port=cfg.port,
                                   auth_gate=auth_gate).start()
        self.client = Client.http(self.gateway.url,
                                  token=self.admin_token)
        self.scheduler = SchedulerServer(
            self.client,
            scheduler_name=cfg.scheduler_name,
            leader_elect=cfg.leader_elect,
            config=cfg.scheduler_config,
            device=device).start()
        self.manager = ControllerManager(
            self.client, controllers=cfg.controllers,
            leader_elect=cfg.leader_elect).start()
        # bootstrap-token phase (kubeadm init phase bootstrap-token): mint
        # the token joiners authenticate with; the CSR controllers serve
        # the other half of TLS bootstrap
        from ..controllers.certificates import (
            make_bootstrap_token)
        from ..machinery import errors as merrors

        self.bootstrap_token, secret = make_bootstrap_token()
        try:
            self.client.secrets.create(secret, "kube-system")
        except merrors.StatusError as e:
            if not merrors.is_already_exists(e):
                raise
        if cfg.authenticated:
            # kube-public/cluster-info (kubeadm init phase bootstrap-token):
            # the CA CERTIFICATE published where bootstrappers may read it —
            # under RBAC they can no longer GET the kube-system cluster-ca
            # Secret (which also holds the CA private key)
            self._publish_cluster_info()
        if cfg.hollow_nodes:
            self.hollow = HollowCluster(
                self.client, cfg.hollow_nodes,
                capacity=cfg.hollow_capacity).start()
        return self

    def _seed_rbac_policy(self) -> None:
        """Write the authenticated topology's RBAC policy straight into
        storage (before the gateway opens): system:masters is cluster-admin,
        and system:bootstrappers gets EXACTLY the reference's
        system:node-bootstrapper surface — CSR create/get/list/watch plus a
        read of kube-public/cluster-info — so a leaked bootstrap token can
        request a node certificate but cannot read the CA private key, list
        Secrets, or touch workloads."""
        from ..controllers.certificates import BOOTSTRAP_GROUP

        g = "rbac.authorization.k8s.io"
        gv = f"{g}/v1"
        objs = [
            ("clusterroles", "", {
                "apiVersion": gv, "kind": "ClusterRole",
                "metadata": {"name": "cluster-admin"},
                "rules": [
                    {"verbs": ["*"], "apiGroups": ["*"],
                     "resources": ["*"]},
                    {"verbs": ["*"], "nonResourceURLs": ["*"]},
                ]}),
            ("clusterrolebindings", "", {
                "apiVersion": gv, "kind": "ClusterRoleBinding",
                "metadata": {"name": "cluster-admin"},
                "subjects": [{"kind": "Group", "name": "system:masters"}],
                "roleRef": {"kind": "ClusterRole", "name": "cluster-admin"}}),
            ("clusterroles", "", {
                "apiVersion": gv, "kind": "ClusterRole",
                "metadata": {"name": "system:node-bootstrapper"},
                "rules": [
                    {"verbs": ["create", "get", "list", "watch"],
                     "apiGroups": ["certificates.k8s.io"],
                     "resources": ["certificatesigningrequests"]},
                ]}),
            ("clusterrolebindings", "", {
                "apiVersion": gv, "kind": "ClusterRoleBinding",
                "metadata": {"name": "kubeadm:node-bootstrappers"},
                "subjects": [{"kind": "Group", "name": BOOTSTRAP_GROUP}],
                "roleRef": {"kind": "ClusterRole",
                            "name": "system:node-bootstrapper"}}),
            ("roles", "kube-public", {
                "apiVersion": gv, "kind": "Role",
                "metadata": {"name": "kubeadm:bootstrap-signer-clusterinfo",
                             "namespace": "kube-public"},
                "rules": [{"verbs": ["get"], "apiGroups": [""],
                           "resources": ["configmaps"],
                           "resourceNames": ["cluster-info"]}]}),
            ("rolebindings", "kube-public", {
                "apiVersion": gv, "kind": "RoleBinding",
                "metadata": {"name": "kubeadm:bootstrap-signer-clusterinfo",
                             "namespace": "kube-public"},
                "subjects": [{"kind": "Group", "name": BOOTSTRAP_GROUP}],
                "roleRef": {"kind": "Role",
                            "name": "kubeadm:bootstrap-signer-clusterinfo"}}),
        ]
        from ..machinery import errors as merrors

        for resource, ns, obj in objs:
            try:
                self.api.store(g, resource).create(ns, obj)
            except merrors.StatusError as e:
                if not merrors.is_already_exists(e):
                    raise

    def _publish_cluster_info(self) -> None:
        """kube-public/cluster-info: the CA certificate + a minimal
        kubeconfig, readable by bootstrappers (and signed per usable token
        by the BootstrapSignerController when it runs)."""
        import json as _json

        from ..controllers.certificates import _shared_ca
        from ..machinery import errors as merrors

        try:
            ca_pem = _shared_ca(self.client).ca_pem().decode()
        except ImportError:
            # no `cryptography` in this environment: there is no CA to
            # publish (CSR signing is equally unavailable) — skip the
            # ConfigMap rather than fail the whole control-plane bringup
            return
        kubeconfig = _json.dumps({
            "apiVersion": "v1", "kind": "Config",
            "clusters": [{"name": "", "cluster": {
                "server": self.gateway.url if self.gateway else "",
                "certificate-authority-data": base64.b64encode(
                    ca_pem.encode()).decode()}}]})
        cm = {"apiVersion": "v1", "kind": "ConfigMap",
              "metadata": {"name": "cluster-info",
                           "namespace": "kube-public"},
              "data": {"ca.crt": ca_pem, "kubeconfig": kubeconfig}}
        try:
            self.client.configmaps.create(cm, "kube-public")
        except merrors.StatusError as e:
            if not merrors.is_already_exists(e):
                raise

    def join(self, n_nodes: int = 1, name_prefix: Optional[str] = None,
             capacity: Optional[Dict[str, str]] = None) -> "HollowCluster":
        """kubeadm join: each worker runs TLS BOOTSTRAP first — authenticate
        with the init-minted bootstrap token, post a node-client CSR, wait
        for the approve/sign controllers to issue a CA-signed X.509
        identity (phases/kubelet TLS bootstrap) — then registers against
        the control plane over the public URL. Issued credentials land in
        `self.node_credentials[name]` = {key, cert, ca} PEM bytes. Each
        join batch gets a unique default prefix so repeated joins ADD
        nodes instead of re-registering the previous batch's names."""
        from ..controllers.certificates import (
            BOOTSTRAP_GROUP, collect_node_identity, post_node_csr)

        if self.gateway is None:
            raise RuntimeError("cluster is not up")
        if name_prefix is None:
            name_prefix = f"joined-node-b{len(self._joined)}"
        # TLS bootstrap requires the approve/sign controllers; a manager
        # configured without them (custom controller subsets are a
        # supported topology) joins token-only, as before
        roster = set(self.manager.controllers) if self.manager else set()
        if {"csrsigning", "csrapproving"} <= roster:
            join_client = Client.http(self.gateway.url,
                                      token=self.bootstrap_token)
            tid = self.bootstrap_token.partition(".")[0]
            # post every CSR first, THEN collect: the approve/sign
            # round-trips overlap across the batch instead of serializing
            keys = {}
            for i in range(n_nodes):
                name = f"{name_prefix}-{i}"
                keys[name] = post_node_csr(
                    join_client, name,
                    username=f"system:bootstrap:{tid}",
                    groups=[BOOTSTRAP_GROUP])
            for name, key_pem in keys.items():
                self.node_credentials[name] = collect_node_identity(
                    join_client, name, key_pem)
        extra = HollowCluster(
            Client.http(self.gateway.url, token=self.admin_token), n_nodes,
            name_prefix=name_prefix,
            capacity=capacity or self.config.hollow_capacity).start()
        self._joined.append(extra)
        return extra

    # -- upgrade (cmd/kubeadm/app/phases/upgrade) --------------------------- #

    def _stored_cluster_config(self) -> Dict:
        """The kubeadm-config ConfigMap in kube-system — where kubeadm
        persists ClusterConfiguration (incl. kubernetesVersion)."""
        try:
            return self.client.configmaps.get("kubeadm-config", "kube-system")
        except Exception:  # noqa: BLE001 — absent on pre-upgrade clusters
            return {}

    def current_version(self) -> str:
        cm = self._stored_cluster_config()
        stored = (cm.get("data") or {}).get("kubernetesVersion", "")
        if stored:
            return stored
        return self.client.version().get("gitVersion", "")

    def upgrade_plan(self, target: str) -> Dict:
        """`kubeadm upgrade plan`: health + skew preflight, no mutation
        (phases/upgrade/plan.go: current/target versions, component health,
        per-node kubelet versions)."""
        cur = self.current_version()
        components = {
            "apiserver": self._healthz(),
            "scheduler": self.scheduler is not None,
            "controller-manager": self.manager is not None,
        }
        nodes = []
        for n in self.client.nodes.list("").get("items", []):
            ready = any(c.get("type") == "Ready" and c.get("status") == "True"
                        for c in n.get("status", {}).get("conditions", []))
            nodes.append({
                "name": n["metadata"]["name"], "ready": ready,
                "kubeletVersion": n.get("status", {})
                .get("nodeInfo", {}).get("kubeletVersion", "")})
        ok, reason = _skew_allows(cur, target)
        return {"currentVersion": cur, "targetVersion": target,
                "components": components, "nodes": nodes,
                "canUpgrade": ok and all(components.values()),
                "reason": reason if not ok else "", }

    def _healthz(self) -> bool:
        try:
            return self.client.transport.request(
                "GET", "/healthz", {}, None) is not None
        except Exception:  # noqa: BLE001
            return False

    def upgrade_apply(self, target: str) -> Dict:
        """`kubeadm upgrade apply <target>`: preflight → ComponentConfig
        migration → control-plane restart (scheduler, then controller
        manager, against the same durable storage — no placement loss) →
        record the new version in kubeadm-config. Each phase is recorded
        the way kubeadm's phase runner reports them."""
        phases: List[str] = []
        plan = self.upgrade_plan(target)
        if not plan["canUpgrade"]:
            raise RuntimeError(
                f"preflight failed: {plan.get('reason') or plan['components']}")
        phases.append("preflight")

        # config migration: the scheduler config must still load under the
        # new version (phases/upgrade/postupgrade.go ComponentConfig check)
        if self.config.scheduler_config is not None:
            from ..sched.config import load_config

            load_config(self.config.scheduler_config)
        phases.append("config")

        # control plane, one component at a time; the apiserver (storage)
        # stays up throughout, as in a real rolling control-plane upgrade.
        # The new scheduler runs where the old one ran
        device = self.scheduler.scheduler.device
        self.scheduler.stop()
        self.scheduler = SchedulerServer(
            self.client, scheduler_name=self.config.scheduler_name,
            leader_elect=self.config.leader_elect,
            config=self.config.scheduler_config,
            device=device).start()
        phases.append("control-plane/scheduler")
        self.manager.stop()
        self.manager = ControllerManager(
            self.client, controllers=self.config.controllers,
            leader_elect=self.config.leader_elect).start()
        phases.append("control-plane/controller-manager")

        # persist the new ClusterConfiguration version (uploadconfig phase)
        cm = self._stored_cluster_config()
        if cm:
            cm.setdefault("data", {})["kubernetesVersion"] = target
            self.client.configmaps.update(cm, "kube-system")
        else:
            self.client.configmaps.create(
                {"apiVersion": "v1", "kind": "ConfigMap",
                 "metadata": {"name": "kubeadm-config",
                              "namespace": "kube-system"},
                 "data": {"kubernetesVersion": target}}, "kube-system")
        phases.append("upload-config")

        if not self._healthz():
            raise RuntimeError("post-upgrade health check failed")
        phases.append("health")
        return {"from": plan["currentVersion"], "to": target,
                "phases": phases}

    def down(self) -> None:
        for extra in reversed(self._joined):
            extra.stop()
        self._joined.clear()
        for c in (self.hollow, self.manager, self.scheduler):
            if c is not None:
                c.stop()
        if self.gateway is not None:
            self.gateway.stop()
        if self.api is not None:
            self.api.close()

    @property
    def url(self) -> str:
        return self.gateway.url if self.gateway else ""

    def __enter__(self) -> "Cluster":
        return self.up()

    def __exit__(self, *exc) -> None:
        self.down()


def cluster_main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="cluster")
    p.add_argument("action", choices=["up"])
    p.add_argument("--port", type=int, default=6443)
    p.add_argument("--hollow-nodes", type=int, default=0)
    p.add_argument("--leader-elect", action="store_true")
    p.add_argument("--scheduler-config", default=None,
                   help="KubeSchedulerConfiguration file (YAML/JSON)")
    p.add_argument("--device", default=None,
                   help="where the scheduler runs: cuda (the default) or "
                        "cpu")
    args = p.parse_args(argv)
    cluster = Cluster(ClusterConfig(port=args.port,
                                    hollow_nodes=args.hollow_nodes,
                                    leader_elect=args.leader_elect,
                                    scheduler_config=args.scheduler_config,
                                    device=args.device)).up()
    print(f"control plane ready at {cluster.url} "
          f"({args.hollow_nodes} hollow nodes, scheduler on "
          f"{cluster.scheduler.scheduler.device})")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        cluster.down()
    return 0
