"""Service ClusterIP / NodePort allocation — the registry/core/service seat.

The reference's service registry allocates ClusterIPs from the service CIDR
(`pkg/registry/core/service/ipallocator`, bitmap-backed) and NodePorts from
the node-port range (`portallocator`), rejects requests for addresses
already in use ("provided IP is already allocated"), releases on delete,
keeps ClusterIP immutable across updates, and runs a repair controller
(`ipallocator/controller/repair.go`) that rebuilds the bitmaps from stored
Services so leaks from failed writes heal.

Here the same behavior hangs off the compiled-in admission chain (the
mutation point after defaulting, before validation — PARITY #17): CREATE
allocates (or reserves a user-specified address), DELETE releases, UPDATE
enforces immutability and allocates newly-added node ports. The allocators
live on the APIServer instance and are seeded by `repair()` — a sweep of
persisted Services — on first use, which also makes restart-over-durable-
storage work; an exhausted range triggers one repair-and-retry before
failing, the lazy analog of the reference's periodic repair loop.

(A copy of the JAX package's apiserver/service_alloc.py.)
"""

from __future__ import annotations

import ipaddress
import threading
from typing import Any, Dict, Optional, Set, Tuple

from ..machinery import errors, meta

Obj = Dict[str, Any]

DEFAULT_SERVICE_CIDR = "10.96.0.0/16"
DEFAULT_NODE_PORT_RANGE = (30000, 32767)


class AllocationError(Exception):
    pass


class IPAllocator:
    """Bitmap-free set allocator over a CIDR (the bitmap's contract at this
    scale): network/broadcast and the first address (the apiserver VIP, as
    in the reference) are never handed out."""

    def __init__(self, cidr: str = DEFAULT_SERVICE_CIDR):
        self.net = ipaddress.ip_network(cidr)
        self._mu = threading.Lock()
        self._used: Set[int] = set()
        self._first = int(self.net.network_address) + 2  # skip net + VIP
        self._last = int(self.net.broadcast_address) - 1
        self._next = self._first

    def allocate(self, ip: Optional[str] = None) -> str:
        with self._mu:
            if ip:
                addr = ipaddress.ip_address(ip)
                if addr not in self.net:
                    raise AllocationError(
                        f"{ip} is not in the service CIDR {self.net}")
                if not self._first <= int(addr) <= self._last:
                    # network/broadcast/VIP: auto-allocation skips these,
                    # so explicit requests must be rejected too (the
                    # reference's bitmap treats them as out of range)
                    raise AllocationError(
                        f"{ip} is a reserved address in {self.net}")
                if int(addr) in self._used:
                    raise AllocationError(
                        "provided IP is already allocated")
                self._used.add(int(addr))
                return ip
            for _ in range(self._last - self._first + 1):
                cand = self._next
                self._next = self._first if self._next >= self._last \
                    else self._next + 1
                if cand not in self._used:
                    self._used.add(cand)
                    return str(ipaddress.ip_address(cand))
            raise AllocationError("range is full")

    def release(self, ip: str) -> None:
        try:
            addr = int(ipaddress.ip_address(ip))
        except ValueError:
            return
        with self._mu:
            self._used.discard(addr)

    def reset(self) -> None:
        with self._mu:
            self._used.clear()


class PortAllocator:
    def __init__(self, port_range: Tuple[int, int] = DEFAULT_NODE_PORT_RANGE):
        self.low, self.high = port_range
        self._mu = threading.Lock()
        self._used: Set[int] = set()
        self._next = self.low

    def allocate(self, port: int = 0) -> int:
        with self._mu:
            if port:
                if not self.low <= port <= self.high:
                    raise AllocationError(
                        f"provided port is not in the valid range "
                        f"{self.low}-{self.high}")
                if port in self._used:
                    raise AllocationError(
                        "provided port is already allocated")
                self._used.add(port)
                return port
            for _ in range(self.high - self.low + 1):
                cand = self._next
                self._next = self.low if self._next >= self.high \
                    else self._next + 1
                if cand not in self._used:
                    self._used.add(cand)
                    return cand
            raise AllocationError("range is full")

    def release(self, port: int) -> None:
        with self._mu:
            self._used.discard(int(port))

    def reset(self) -> None:
        with self._mu:
            self._used.clear()


def _wants_node_ports(svc: Obj) -> bool:
    return (svc.get("spec", {}) or {}).get("type") in ("NodePort",
                                                       "LoadBalancer")


def _release(api, svc: Obj) -> None:
    spec = (svc or {}).get("spec", {}) or {}
    if spec.get("clusterIP") and spec["clusterIP"] != "None":
        api._svc_ip_alloc.release(spec["clusterIP"])
    for p in spec.get("ports", []) or []:
        if p.get("nodePort"):
            api._svc_port_alloc.release(int(p["nodePort"]))
    # drop any stranded pending-release stash (e.g. a rejected update)
    api._svc_pending_release.pop(
        f"{meta.namespace(svc)}/{meta.name(svc)}", None)


def _release_pending(api, svc: Obj) -> None:
    """after_update hook: the write COMMITTED — release the node ports the
    admitted transition dropped (stashed by _allocate_into)."""
    key = f"{meta.namespace(svc)}/{meta.name(svc)}"
    for port in api._svc_pending_release.pop(key, ()):
        api._svc_port_alloc.release(port)


def _allocators(api):
    if not hasattr(api, "_svc_ip_alloc"):
        api._svc_ip_alloc = IPAllocator()
        api._svc_port_alloc = PortAllocator()
        api._svc_pending_release = {}
        # release rides the store's after_delete hook, which fires when the
        # object actually LEAVES storage — both on immediate deletes and
        # when the last finalizer clears (registry.py
        # _finish_delete_if_ready). Releasing at DELETE admission would
        # free the address while a finalizer-bearing Service still exists.
        # Same post-commit principle for UPDATE-dropped ports: after_update.
        try:
            store = api.store("", "services")
            store.after_delete = lambda svc: _release(api, svc)
            store.after_update = lambda svc: _release_pending(api, svc)
        except errors.StatusError:
            pass
        repair(api)
    return api._svc_ip_alloc, api._svc_port_alloc


def repair(api) -> None:
    """Rebuild the bitmaps from persisted Services (repair.go): heals leaks
    from writes that failed after allocation and seeds the allocators on a
    restart over durable storage."""
    ip_alloc, port_alloc = api._svc_ip_alloc, api._svc_port_alloc
    ip_alloc.reset()
    port_alloc.reset()
    try:
        store = api.store("", "services")
        items, _ = store.storage.list(store.prefix_for(""))
    except errors.StatusError:
        return
    for svc in items:
        spec = svc.get("spec", {}) or {}
        ip = spec.get("clusterIP", "")
        if ip and ip != "None":
            try:
                ip_alloc.allocate(ip)
            except AllocationError:
                pass  # duplicate in storage — first one wins, as repair.go
        for p in spec.get("ports", []) or []:
            if p.get("nodePort"):
                try:
                    port_alloc.allocate(int(p["nodePort"]))
                except AllocationError:
                    pass


class ServiceAllocatorPlugin:
    """AdmissionPlugin shape (apiserver/admission.py): the allocation/release
    chokepoint for Services."""

    name = "ServiceIPAllocator"

    def admit(self, api, op: str, info, obj: Optional[Obj],
              old: Optional[Obj]) -> Optional[Obj]:
        if info.resource != "services":
            return None
        _allocators(api)  # init + install the after_delete release hook
        if op == "CREATE" and obj is not None:
            self._allocate_into(api, obj, None)
            return obj
        if op == "UPDATE" and obj is not None and old is not None:
            old_ip = (old.get("spec", {}) or {}).get("clusterIP", "")
            new_ip = (obj.get("spec", {}) or {}).get("clusterIP", "")
            if old_ip and new_ip != old_ip:
                raise errors.new_invalid(
                    "services", meta.name(obj),
                    "spec.clusterIP: Invalid value: field is immutable")
            self._allocate_into(api, obj, old)
            return obj
        # DELETE needs no admission action: release rides the services
        # store's after_delete hook (installed by _allocators above)
        return None

    def validate(self, api, op: str, info, obj: Optional[Obj],
                 old: Optional[Obj]) -> None:
        return None

    def _allocate_into(self, api, svc: Obj, old: Optional[Obj]) -> None:
        ip_alloc, port_alloc = api._svc_ip_alloc, api._svc_port_alloc
        spec = svc.setdefault("spec", {})
        old_spec = (old or {}).get("spec", {}) or {}
        ip = spec.get("clusterIP", "")
        if ip != "None" and not ip and not old_spec.get("clusterIP"):
            spec["clusterIP"] = self._with_repair(
                api, lambda: ip_alloc.allocate(), "clusterIPs")
        elif ip and ip != "None" and not old_spec.get("clusterIP"):
            try:
                # an "already allocated" verdict gets one repair sweep
                # first: a create that failed AFTER admission (validation,
                # quota, name conflict) left the address marked used with
                # no object holding it, and only repair can prove that
                self._with_specific_repair(api, lambda: ip_alloc.allocate(ip))
            except AllocationError as e:
                raise errors.new_invalid(
                    "services", meta.name(svc),
                    f"spec.clusterIP: Invalid value: {ip!r}: {e}")
        held = {int(p.get("nodePort")) for p in old_spec.get("ports", [])
                or [] if p.get("nodePort")}
        # intra-object duplicates are a validation error, not an allocator
        # question (the reference rejects them in service validation before
        # allocation; letting the second hit the allocator would trip the
        # repair sweep into freeing the first)
        requested = [int(p.get("nodePort", 0) or 0)
                     for p in spec.get("ports", []) or []]
        dups = {x for x in requested if x and requested.count(x) > 1}
        if dups and _wants_node_ports(svc):
            raise errors.new_invalid(
                "services", meta.name(svc),
                f"spec.ports.nodePort: Duplicate value: {sorted(dups)[0]}")
        if _wants_node_ports(svc):
            for p in spec.get("ports", []) or []:
                want = int(p.get("nodePort", 0) or 0)
                if want and want in held:
                    continue  # carried over from the old object
                try:
                    if want:
                        self._with_specific_repair(
                            api, lambda: port_alloc.allocate(want))
                    else:
                        p["nodePort"] = self._with_repair(
                            api, lambda: port_alloc.allocate(), "nodePorts")
                except AllocationError as e:
                    raise errors.new_invalid(
                        "services", meta.name(svc),
                        f"spec.ports.nodePort: Invalid value: {want}: {e}")
        if old is not None:
            # UPDATE: held ports the new spec no longer claims (dropped from
            # spec.ports, or the type stopped wanting node ports entirely,
            # NodePort→ClusterIP) release AFTER the write commits — the
            # after_update hook pops this stash. Releasing here would free
            # live ports when validation (which runs after admission,
            # registry.py) or the CAS rejects the update. A concurrent-
            # update race can strand a stash entry (never popped): that
            # leak heals via the lazy repair sweep, same as failed creates.
            keep = ({int(p.get("nodePort", 0) or 0)
                     for p in spec.get("ports", []) or []}
                    if _wants_node_ports(svc) else set())
            api._svc_pending_release[
                f"{meta.namespace(svc)}/{meta.name(svc)}"] = held - keep

    @staticmethod
    def _with_specific_repair(api, alloc):
        """User-specified address path: 'already allocated' may be a leak
        from a post-admission create failure — repair once and retry."""
        try:
            return alloc()
        except AllocationError:
            repair(api)
            return alloc()

    @staticmethod
    def _with_repair(api, alloc, what: str):
        """Exhaustion triggers one repair sweep (leaked addresses from failed
        writes are reclaimed) before giving up — the lazy repair loop."""
        try:
            return alloc()
        except AllocationError:
            repair(api)
            try:
                return alloc()
            except AllocationError:
                raise errors.StatusError(
                    500, "InternalError",
                    f"the service {what} range is exhausted")
