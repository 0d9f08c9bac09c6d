"""Attachable-volume identity — shared by the attach/detach controller and
the kubelet's volume manager (pkg/volume unique-volume-name helpers:
`kubernetes.io/<plugin>/<volume id>`)."""

from __future__ import annotations

from typing import Dict, List

_ATTACHABLE = ("gcePersistentDisk", "awsElasticBlockStore", "rbd", "iscsi",
               "csi")


def attachable_volume_ids(pod: Dict) -> List[str]:
    """Unique volume names for a pod's attach-requiring volumes."""
    out: List[str] = []
    for v in pod.get("spec", {}).get("volumes", []) or []:
        for k in _ATTACHABLE:
            src = v.get(k)
            if src:
                vid = (src.get("pdName") or src.get("volumeID")
                       or src.get("volumeHandle") or v.get("name", ""))
                out.append(f"kubernetes.io/{k}/{vid}")
                break
    return out
