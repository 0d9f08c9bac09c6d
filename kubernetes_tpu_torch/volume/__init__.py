"""Volume machinery: PV/PVC binding + scheduler volume coordination.

The port's copy of the JAX package's volume/: analog of
`pkg/controller/volume/persistentvolume` (the PV binder controller) and `pkg/controller/volume/scheduling` +
`pkg/scheduler/volumebinder` (the scheduler-coordinated delayed-binding
path, SURVEY §2.1 volume binder row).
"""

from ..volume.binder import SchedulerVolumeBinder, VolumeDecision
from ..volume.pv_controller import (
    PersistentVolumeController,
    pv_matches_claim,
)

__all__ = ["PersistentVolumeController", "SchedulerVolumeBinder",
           "VolumeDecision", "pv_matches_claim"]
