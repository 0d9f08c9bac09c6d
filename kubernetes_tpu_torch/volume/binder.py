"""Scheduler-coordinated volume binding.

Analog of `pkg/scheduler/volumebinder/volume_binder.go` over
`pkg/controller/volume/scheduling/scheduler_binder.go`:

  * decide(pod): CheckVolumeBinding — which nodes can satisfy the pod's
    PVCs. Bound claims constrain to their PV's reachable nodes
    (NoVolumeZoneConflict); unbound WaitForFirstConsumer claims constrain
    to nodes where a matching PV exists; unbound Immediate claims mean the
    pod must wait for the PV controller (FindPodVolumes "pod has unbound
    immediate PersistentVolumeClaims").
  * bind(pod, node): AssumePodVolumes + BindPodVolumes — at placement time,
    bind each WFFC claim to a PV reachable from the chosen node.

The node restriction feeds the device path as a synthetic matchFields
node-affinity term (metadata.name IN allowed), so the lattice evaluates it
with zero new kernel code.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ..machinery import errors, labels as mlabels, meta
from ..volume.pv_controller import (
    PersistentVolumeController,
    WFFC,
    pv_allowed_nodes,
    pv_matches_claim,
)

Obj = dict


@dataclass
class VolumeDecision:
    """Outcome of the filter half (FindPodVolumes)."""

    wait: bool = False                 # unbound Immediate PVC → pod waits
    reason: str = ""
    allowed_nodes: Optional[Set[str]] = None  # None = unrestricted
    wffc_claims: List[Obj] = field(default_factory=list)


def _pv_nodes_for(pv: Obj, nodes: List[Obj]) -> Optional[Set[str]]:
    """Nodes a PV is reachable from: matchFields names and/or zone-label
    terms in spec.nodeAffinity resolved against node labels."""
    names = pv_allowed_nodes(pv)
    allowed: Optional[Set[str]] = set(names) if names is not None else None
    terms = (pv.get("spec", {}).get("nodeAffinity", {}).get("required", {})
             .get("nodeSelectorTerms") or [])
    label_sets: List[Set[str]] = []
    for t in terms:
        exprs = t.get("matchExpressions") or []
        if not exprs:
            continue
        sel = mlabels.from_label_selector({"matchExpressions": exprs})
        label_sets.append({meta.name(n) for n in nodes
                           if sel.matches(meta.labels_of(n))})
    if label_sets:
        by_labels: Set[str] = set().union(*label_sets)
        allowed = by_labels if allowed is None else (allowed & by_labels)
    return allowed


class SchedulerVolumeBinder:
    """Host-side volume coordination for the scheduler server."""

    def __init__(self, client, pvc_lister, pv_lister, sc_lister, node_lister):
        self.client = client
        self.pvc_lister = pvc_lister
        self.pv_lister = pv_lister
        self.sc_lister = sc_lister
        self.node_lister = node_lister

    def _claims_of(self, pod: Obj) -> List[Obj]:
        out = []
        ns = meta.namespace(pod) or "default"
        for v in pod.get("spec", {}).get("volumes") or []:
            ref = v.get("persistentVolumeClaim")
            if ref:
                claim = self.pvc_lister.get(ns, ref.get("claimName", ""))
                out.append(claim if claim is not None
                           else {"metadata": {"name": ref.get("claimName"),
                                              "namespace": ns},
                                 "__missing__": True})
        return out

    def _is_wffc(self, claim: Obj) -> bool:
        cls = claim.get("spec", {}).get("storageClassName", "") or ""
        if not cls:
            return False
        sc = self.sc_lister.get("", cls)
        return bool(sc) and sc.get("volumeBindingMode") == WFFC

    def decide(self, pod: Obj) -> VolumeDecision:
        """FindPodVolumes: wait / node restriction / claims to bind later."""
        nodes = self.node_lister.list()
        allowed: Optional[Set[str]] = None
        wffc: List[Obj] = []
        for claim in self._claims_of(pod):
            if claim.get("__missing__"):
                return VolumeDecision(
                    wait=True,
                    reason=f'persistentvolumeclaim '
                           f'"{meta.name(claim)}" not found')
            phase = claim.get("status", {}).get("phase", "Pending")
            if phase == "Bound":
                pv = self.pv_lister.get(
                    "", claim.get("spec", {}).get("volumeName", ""))
                if pv is not None:
                    pv_nodes = _pv_nodes_for(pv, nodes)
                    if pv_nodes is not None:
                        allowed = pv_nodes if allowed is None \
                            else allowed & pv_nodes
                continue
            if self._is_wffc(claim):
                # nodes where at least one compatible PV is reachable
                claim_nodes: Set[str] = set()
                for pv in self.pv_lister.list():
                    if not pv_matches_claim(pv, claim):
                        continue
                    pv_nodes = _pv_nodes_for(pv, nodes)
                    claim_nodes |= (pv_nodes if pv_nodes is not None
                                    else {meta.name(n) for n in nodes})
                allowed = claim_nodes if allowed is None \
                    else allowed & claim_nodes
                wffc.append(claim)
            else:
                return VolumeDecision(
                    wait=True,
                    reason="pod has unbound immediate "
                           "PersistentVolumeClaims")
        return VolumeDecision(allowed_nodes=allowed, wffc_claims=wffc)

    def bind(self, pod: Obj, node_name: str) -> bool:
        """AssumePodVolumes+BindPodVolumes: bind each WFFC claim to a PV
        reachable from the chosen node. Returns False (→ scheduler rollback)
        if any claim cannot be satisfied there."""
        decision = self.decide(pod)
        if decision.wait:
            return False
        nodes = self.node_lister.list()
        for claim in decision.wffc_claims:
            chosen = None
            for pv in sorted(self.pv_lister.list(),
                             key=lambda v: meta.name(v)):
                if not pv_matches_claim(pv, claim):
                    continue
                pv_nodes = _pv_nodes_for(pv, nodes)
                if pv_nodes is None or node_name in pv_nodes:
                    chosen = pv
                    break
            if chosen is None:
                return False
            PersistentVolumeController.bind(self.client, chosen, claim)
        return True
