"""Kubelet volume manager — `pkg/kubelet/volumemanager/volume_manager.go`
reduced to its control contract:

  * WaitForAttachAndMount: a pod with attach-requiring volumes does not
    start containers until the attach/detach controller has marked every
    one of them attached to this node (node.status.volumesAttached);
  * volumesInUse: the kubelet REPORTS the volumes its pods hold
    (kubelet_node_status.go setNodeVolumesInUseStatus) — the controller
    reads that to defer detach until unmount (safe detach);
  * mount bookkeeping: mounted volumes release at pod teardown, which is
    what makes the in-use report shrink and the deferred detach proceed.

There is no real filesystem to mount (FakeCRI runtime) — "mounted" is the
bookkeeping state the control protocol needs, same stance as PARITY #9.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Set, Tuple

from ..volume.names import attachable_volume_ids

Obj = Dict


class VolumeManager:
    def __init__(self):
        self._mu = threading.Lock()
        self._mounted: Dict[str, List[str]] = {}  # pod uid → volume names
        # the latest view of node.status.volumesAttached, fed by the
        # kubelet's heartbeat read of its own Node object
        self._attached: Set[str] = set()

    def note_attached(self, node_status: Obj) -> None:
        with self._mu:
            self._attached = {
                v.get("name", "") for v in
                (node_status or {}).get("volumesAttached", []) or []}

    def wait_for_attach_and_mount(self, pod: Obj) -> Tuple[bool, List[str]]:
        """Can this pod's containers start? Returns (ok, missing)."""
        need = attachable_volume_ids(pod)
        if not need:
            return True, []
        with self._mu:
            missing = [v for v in need if v not in self._attached]
        return not missing, missing

    def mark_mounted(self, pod_uid: str, pod: Obj) -> None:
        vols = attachable_volume_ids(pod)
        if vols:
            with self._mu:
                self._mounted[pod_uid] = vols

    def unmount(self, pod_uid: str) -> None:
        with self._mu:
            self._mounted.pop(pod_uid, None)

    def in_use(self) -> List[str]:
        with self._mu:
            return sorted({v for vols in self._mounted.values()
                           for v in vols})
