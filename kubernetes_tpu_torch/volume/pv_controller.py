"""PersistentVolume binder controller.

Analog of `pkg/controller/volume/persistentvolume/pv_controller.go`: match
pending PVCs to available PVs (storageClass, capacity, accessModes), bind by
writing claimRef + phase on both sides. StorageClasses with
volumeBindingMode=WaitForFirstConsumer are left for the scheduler-
coordinated path (volume/binder.py), exactly as the reference defers them
(shouldDelayBinding).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..client.informers import InformerFactory
from ..controllers.base import Controller
from ..machinery import errors, meta
from ..machinery import quantity as mq

Obj = dict

WFFC = "WaitForFirstConsumer"


def pv_matches_claim(pv: Obj, claim: Obj) -> bool:
    """findMatchingVolume (pv_controller): class, modes, capacity, phase."""
    if pv.get("status", {}).get("phase", "Available") not in ("Available",
                                                              "", None):
        return False
    if pv.get("spec", {}).get("claimRef"):
        return False
    want_class = claim.get("spec", {}).get("storageClassName", "") or ""
    have_class = pv.get("spec", {}).get("storageClassName", "") or ""
    if want_class != have_class:
        return False
    want_modes = set(claim.get("spec", {}).get("accessModes") or [])
    have_modes = set(pv.get("spec", {}).get("accessModes") or [])
    if not want_modes.issubset(have_modes):
        return False
    want = (claim.get("spec", {}).get("resources", {}).get("requests")
            or {}).get("storage", "0")
    have = (pv.get("spec", {}).get("capacity") or {}).get("storage", "0")
    return mq.parse(have).milli >= mq.parse(want).milli


def pv_allowed_nodes(pv: Obj) -> Optional[List[str]]:
    """Node names this PV is reachable from, via spec.nodeAffinity matchFields
    on metadata.name; None = no restriction. (Zone-label terms are resolved
    by the scheduler binder against node labels.)"""
    from ..api.v1 import node_names_from_terms

    return node_names_from_terms(
        (pv.get("spec", {}).get("nodeAffinity", {}).get("required", {})
         .get("nodeSelectorTerms") or []))


class PersistentVolumeController(Controller):
    name = "persistentvolume"

    def __init__(self, client, factory: InformerFactory):
        super().__init__(client, factory)
        self.pvc_informer = self.watch_resource("persistentvolumeclaims")
        self.pv_informer = self.factory.informer("persistentvolumes")
        self.sc_informer = self.factory.informer("storageclasses")
        # a new PV may satisfy waiting claims
        self.pv_informer.add_handlers(on_add=lambda o: self._enqueue_pending())

    def _enqueue_pending(self) -> None:
        for pvc in self.pvc_informer.lister.list():
            if pvc.get("status", {}).get("phase", "Pending") == "Pending":
                self.enqueue(pvc)

    def _delay_binding(self, claim: Obj) -> bool:
        cls = claim.get("spec", {}).get("storageClassName", "") or ""
        if not cls:
            return False
        sc = self.sc_informer.lister.get("", cls)
        return bool(sc) and sc.get("volumeBindingMode") == WFFC

    def sync(self, key: str) -> None:
        ns, name = meta.split_key(key)
        claim = self.pvc_informer.lister.get(ns, name)
        if claim is None or meta.is_being_deleted(claim):
            return
        if claim.get("status", {}).get("phase") == "Bound":
            return
        if self._delay_binding(claim):
            return  # the scheduler triggers binding at pod placement
        for pv in sorted(self.pv_informer.lister.list(),
                         key=lambda v: mq.parse(
                             (v.get("spec", {}).get("capacity") or {})
                             .get("storage", "0")).milli):
            if pv_matches_claim(pv, claim):
                self.bind(self.client, pv, claim)
                return
        # no match: stays Pending; a PV add re-enqueues

    @staticmethod
    def bind(client, pv: Obj, claim: Obj) -> None:
        """bindVolumeToClaim + bindClaimToVolume: PV first (the durable half),
        then the claim, matching the reference's ordering."""
        ns = meta.namespace(claim)
        try:
            cur_pv = client.persistentvolumes.get(meta.name(pv), "")
            cur_pv["spec"]["claimRef"] = {
                "kind": "PersistentVolumeClaim", "namespace": ns,
                "name": meta.name(claim), "uid": meta.uid(claim)}
            cur_pv.setdefault("status", {})["phase"] = "Bound"
            client.persistentvolumes.update(cur_pv, "")
            cur_claim = client.persistentvolumeclaims.get(meta.name(claim), ns)
            cur_claim["spec"]["volumeName"] = meta.name(pv)
            cur_claim.setdefault("status", {})["phase"] = "Bound"
            cur_claim["status"]["capacity"] = dict(
                cur_pv["spec"].get("capacity") or {})
            client.persistentvolumeclaims.update(cur_claim, ns)
        except errors.StatusError:
            pass  # retried on the next sync
