"""Proxier: Services × Endpoints → a service VIP rule table.

Analog of `pkg/proxy/iptables/proxier.go:251` reduced to its essential
computation: track Service/Endpoints changes (the serviceChanges/
endpointsChanges trackers), and on each syncProxyRules pass rebuild only
what changed into a routing table mapping (clusterIP, port) → backend
endpoints with round-robin selection and sessionAffinity ClientIP pinning.
The kernel-programming half (iptables-restore writes) is environment
plumbing, not semantics; `RuleTable.render_iptables()` emits the equivalent
restore input for inspection/tests.

(A copy of the JAX package's proxy/proxier.py.)
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..client.informers import InformerFactory
from ..machinery import meta

Obj = dict

ServicePortKey = Tuple[str, str, str]  # (namespace, service, port name)


@dataclass
class ServicePortRules:
    cluster_ip: str
    port: int
    protocol: str
    node_port: int = 0
    session_affinity: str = "None"
    affinity_timeout: int = 10800
    endpoints: List[str] = field(default_factory=list)  # "ip:port"
    _rr: int = 0
    _affinity: Dict[str, Tuple[str, float]] = field(default_factory=dict)

    def pick(self, client_ip: str = "", now: Optional[float] = None) -> Optional[str]:
        """One balancing decision (round robin; ClientIP affinity pins)."""
        if not self.endpoints:
            return None
        now = time.monotonic() if now is None else now
        if self.session_affinity == "ClientIP" and client_ip:
            pinned = self._affinity.get(client_ip)
            if pinned and pinned[0] in self.endpoints and \
                    now - pinned[1] < self.affinity_timeout:
                self._affinity[client_ip] = (pinned[0], now)
                return pinned[0]
        choice = self.endpoints[self._rr % len(self.endpoints)]
        self._rr += 1
        if self.session_affinity == "ClientIP" and client_ip:
            self._affinity[client_ip] = (choice, now)
        return choice


class RuleTable:
    """The programmed dataplane state."""

    def __init__(self):
        self._mu = threading.Lock()
        self.by_port: Dict[ServicePortKey, ServicePortRules] = {}
        self.by_vip: Dict[Tuple[str, int], ServicePortKey] = {}
        self.sync_count = 0

    def replace_service(self, key_ns: str, key_name: str,
                        rules: Dict[str, ServicePortRules]) -> None:
        with self._mu:
            # drop this service's old ports, install the new set; active
            # session-affinity pins and the round-robin cursor survive a
            # reprogram (the kernel's conntrack does in the reference)
            old_rules: Dict[str, ServicePortRules] = {}
            for (ns, name, pname) in [k for k in self.by_port
                                      if k[0] == key_ns and k[1] == key_name]:
                old = self.by_port.pop((ns, name, pname))
                old_rules[pname] = old
                self.by_vip.pop((old.cluster_ip, old.port), None)
            for pname, r in rules.items():
                prev = old_rules.get(pname)
                if prev is not None:
                    r._affinity = {ip: pin for ip, pin in
                                   prev._affinity.items()
                                   if pin[0] in r.endpoints}
                    r._rr = prev._rr
                self.by_port[(key_ns, key_name, pname)] = r
                if r.cluster_ip:
                    self.by_vip[(r.cluster_ip, r.port)] = (key_ns, key_name,
                                                           pname)
            self.sync_count += 1

    def drop_service(self, ns: str, name: str) -> None:
        self.replace_service(ns, name, {})

    def lookup(self, vip: str, port: int,
               client_ip: str = "") -> Optional[str]:
        """Route one connection: VIP:port → endpoint ip:port."""
        with self._mu:
            key = self.by_vip.get((vip, port))
            if key is None:
                return None
            return self.by_port[key].pick(client_ip)

    def render_iptables(self) -> str:
        """The iptables-restore document the reference writes
        (proxier.go syncProxyRules chain layout, abbreviated)."""
        with self._mu:
            lines = ["*nat", ":KUBE-SERVICES - [0:0]"]
            for (ns, name, pname), r in sorted(self.by_port.items()):
                svc_chain = f"KUBE-SVC-{ns}-{name}-{pname}".upper()[:28]
                lines.append(
                    f"-A KUBE-SERVICES -d {r.cluster_ip}/32 -p "
                    f"{r.protocol.lower()} --dport {r.port} -j {svc_chain}")
                n = len(r.endpoints)
                for i, ep in enumerate(r.endpoints):
                    sep_chain = f"KUBE-SEP-{ns}-{name}-{pname}-{i}".upper()[:28]
                    if i < n - 1:
                        lines.append(
                            f"-A {svc_chain} -m statistic --mode random "
                            f"--probability {1.0 / (n - i):.5f} -j {sep_chain}")
                    else:
                        lines.append(f"-A {svc_chain} -j {sep_chain}")
                    lines.append(f"-A {sep_chain} -p {r.protocol.lower()} "
                                 f"-m {r.protocol.lower()} -j DNAT "
                                 f"--to-destination {ep}")
            lines.append("COMMIT")
            return "\n".join(lines)

    def render_ipvs(self) -> str:
        """The ipvsadm-restore document of the ipvs proxier
        (pkg/proxy/ipvs/proxier.go:318 syncProxyRules): one virtual server
        per ClusterIP:port with rr scheduling, the persistence flag for
        ClientIP session affinity (ipvs VirtualServer.Flags persistence,
        matching the reference — scheduling stays rr), and one masqueraded
        real server per endpoint."""
        with self._mu:
            lines = []
            proto_flag = {"TCP": "-t", "UDP": "-u", "SCTP": "--sctp-service"}
            for (ns, name, pname), r in sorted(self.by_port.items()):
                if not r.cluster_ip:
                    continue
                proto = proto_flag.get(r.protocol.upper(), "-t")
                sched = "rr"
                persist = ""
                if r.session_affinity == "ClientIP":
                    # ipvs persistence replaces the iptables recent-match
                    persist = f" -p {r.affinity_timeout}"
                lines.append(f"-A {proto} {r.cluster_ip}:{r.port} "
                             f"-s {sched}{persist}")
                for ep in r.endpoints:
                    lines.append(f"-a {proto} {r.cluster_ip}:{r.port} "
                                 f"-r {ep} -m")
            return "\n".join(lines)


class Proxier:
    """Watch-driven sync loop over Services + Endpoints."""

    def __init__(self, client, factory: Optional[InformerFactory] = None,
                 cluster_ip_prefix: str = "10.96",
                 node_name: str = "",
                 health_server=None, healthz=None):
        self.client = client
        self.factory = factory or InformerFactory(client)
        self.table = RuleTable()
        self._ip_seq = 0
        self._ip_by_svc: Dict[str, str] = {}
        self.cluster_ip_prefix = cluster_ip_prefix
        # healthCheckNodePort serving (proxy/healthcheck.py): this node's
        # identity decides which endpoints count as LOCAL
        self.node_name = node_name
        self.health_server = health_server
        self.healthz = healthz
        # conntrack cleanup ledger (pkg/util/conntrack ClearEntriesForIP /
        # ClearEntriesForPort): UDP flows pin DNAT decisions in the kernel
        # conntrack table, so deleting a UDP service VIP or any of its
        # endpoints must flush matching entries or traffic keeps flowing
        # to dead backends. Render-not-program (PARITY #8): the commands
        # are recorded, not executed.
        self.conntrack_commands: List[str] = []
        self._udp_state: Dict[ServicePortKey, Tuple[str, int, tuple]] = {}
        # desired healthcheck registrations, owned HERE (the server only
        # mirrors it): (ns, name) → (hc port, local endpoint count)
        self._hc_state: Dict[Tuple[str, str], Tuple[int, int]] = {}
        self._pending: set = set()
        self._pending_mu = threading.Lock()
        self.svc_informer = self.factory.informer("services")
        self.ep_informer = self.factory.informer("endpoints")
        for inf in (self.svc_informer, self.ep_informer):
            inf.add_handlers(on_add=self._changed,
                             on_update=lambda o, n: self._changed(n),
                             on_delete=self._changed)

    def _changed(self, obj: Obj) -> None:
        with self._pending_mu:
            self._pending.add(meta.namespaced_key(obj))
        if self.healthz is not None:
            self.healthz.queued_update()

    def _cluster_ip(self, svc: Obj) -> str:
        """Allocate/remember a ClusterIP (the apiserver's allocator role)."""
        explicit = svc.get("spec", {}).get("clusterIP", "")
        if explicit and explicit != "None":
            return explicit
        if explicit == "None":
            return ""  # headless
        key = meta.namespaced_key(svc)
        if key not in self._ip_by_svc:
            self._ip_seq += 1
            self._ip_by_svc[key] = (f"{self.cluster_ip_prefix}."
                                    f"{(self._ip_seq >> 8) & 255}."
                                    f"{self._ip_seq & 255}")
        return self._ip_by_svc[key]

    def sync(self) -> int:
        """One syncProxyRules pass over changed services. Returns the number
        of services reprogrammed."""
        with self._pending_mu:
            pending, self._pending = self._pending, set()
        n = 0
        hc_changed = False
        for key in pending:
            ns, name = meta.split_key(key)
            svc = self.svc_informer.lister.get(ns, name)
            if svc is None:
                self.table.drop_service(ns, name)
                self._conntrack_reconcile(ns, name, {})
                # the deleted service's healthCheckNodePort listener must
                # close too, or an external LB keeps getting 200s for a
                # service that no longer exists
                hc_changed |= self._hc_state.pop((ns, name), None) \
                    is not None
                n += 1
                continue
            ep = self.ep_informer.lister.get(ns, name)
            subsets = (ep or {}).get("subsets") or []
            rules: Dict[str, ServicePortRules] = {}
            local_counts: Dict[str, int] = {}
            cluster_ip = self._cluster_ip(svc)
            for p in svc.get("spec", {}).get("ports", []) or []:
                pname = p.get("name", "")
                tp = p.get("targetPort", p.get("port", 0))
                if isinstance(tp, str) and tp.isdigit():
                    tp = int(tp)  # IntOrString: numeric strings are ports
                backends: List[str] = []
                local = 0
                for ss in subsets:
                    eps_port = next(
                        (int(sp.get("port", 0)) for sp in ss.get("ports", [])
                         if sp.get("name", "") == pname),
                        # fall back to the literal target port; a NAMED
                        # target port unresolvable via endpoints port names
                        # keeps the service port (nothing better is known)
                        tp if isinstance(tp, int) else int(p.get("port", 0)))
                    for addr in ss.get("addresses", []) or []:
                        backends.append(f"{addr['ip']}:{eps_port}")
                        if self.node_name and \
                                addr.get("nodeName") == self.node_name:
                            local += 1
                rules[pname] = ServicePortRules(
                    cluster_ip=cluster_ip,
                    port=int(p.get("port", 0)),
                    protocol=p.get("protocol", "TCP"),
                    node_port=int(p.get("nodePort", 0) or 0),
                    session_affinity=svc.get("spec", {})
                    .get("sessionAffinity", "None"),
                    endpoints=backends)
                local_counts[pname] = local
            self.table.replace_service(ns, name, rules)
            self._conntrack_reconcile(ns, name, rules)
            hc_changed |= self._healthcheck_reconcile(ns, name, svc,
                                                      local_counts)
            n += 1
        if hc_changed and self.health_server is not None:
            # one listener reconcile per PASS, not per service
            self.health_server.sync(dict(self._hc_state))
        if self.healthz is not None:
            # every completed pass counts — an idle proxier with nothing
            # to program is healthy, not "never synced" (healthcheck.go
            # calls Updated() after each syncProxyRules)
            self.healthz.updated()
            # …but updated() also CLEARS the queued-update stamp, and an
            # event that arrived after this pass popped _pending is not
            # programmed yet: re-stamp it, or a sync loop that wedges right
            # after this pass would report 200 forever for a change it
            # never programmed
            with self._pending_mu:
                still_pending = bool(self._pending)
            if still_pending:
                self.healthz.queued_update()
        return n

    def _conntrack_reconcile(self, ns: str, name: str,
                             rules: Dict[str, ServicePortRules]) -> None:
        """Record the conntrack deletions endpoint/service changes imply
        (proxier.go deleteEndpointConnections + the stale-services /
        stale-nodePorts sweeps in syncProxyRules). UDP only: TCP flows
        reset themselves; UDP conntrack entries must be flushed or
        clients keep hitting a deleted backend."""
        old = {k: v for k, v in self._udp_state.items()
               if k[0] == ns and k[1] == name}
        new: Dict[ServicePortKey, Tuple[str, int, tuple]] = {}
        for pname, r in rules.items():
            # headless services (no VIP) have no conntrack DNAT entries to
            # flush — and an empty --orig-dst would match EVERY UDP flow
            if r.protocol.upper() == "UDP" and r.cluster_ip:
                new[(ns, name, pname)] = (r.cluster_ip, r.port,
                                          tuple(sorted(r.endpoints)))
        for k, (vip, port, endpoints) in old.items():
            if k not in new:
                # service port gone: flush everything to its VIP
                self.conntrack_commands.append(
                    f"conntrack -D --orig-dst {vip} -p udp --dport {port}")
                self._udp_state.pop(k, None)
                continue
            gone = set(endpoints) - set(new[k][2])
            for ep in sorted(gone):
                ip = ep.rsplit(":", 1)[0]
                self.conntrack_commands.append(
                    f"conntrack -D --orig-dst {vip} --dst-nat {ip} -p udp")
        self._udp_state.update(new)

    def _healthcheck_reconcile(self, ns: str, name: str, svc: Obj,
                               local_counts: Dict[str, int]) -> bool:
        """externalTrafficPolicy: Local services with a healthCheckNodePort
        get a per-service health listener reporting this node's LOCAL
        endpoint count (healthcheck.go SyncServices/SyncEndpoints). The
        desired set lives in self._hc_state; the caller pushes it to the
        server ONCE per sync pass. Returns whether this entry changed."""
        if self.health_server is None:
            return False
        spec = svc.get("spec", {}) or {}
        hc_port = int(spec.get("healthCheckNodePort", 0) or 0)
        old = self._hc_state.get((ns, name))
        if hc_port and spec.get("externalTrafficPolicy") == "Local":
            new = (hc_port, sum(local_counts.values()))
            self._hc_state[(ns, name)] = new
            return old != new
        self._hc_state.pop((ns, name), None)
        return old is not None

    def sync_all(self) -> int:
        for svc in self.svc_informer.lister.list():
            self._changed(svc)
        return self.sync()
