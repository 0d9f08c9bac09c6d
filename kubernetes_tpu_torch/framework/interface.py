"""Scheduling-framework plugin interfaces — the tensor-native re-design of
framework/v1alpha1/interface.go (a copy of the JAX package's
framework/interface.py; the device hooks return torch tensors).

The reference defines 11 extension points with per-(pod,node) Go callbacks
(QueueSort :201, PreFilter :210-221, Filter :242, PostFilter :263, Score
:273-282, Reserve :299, PreBind :308, PostBind :317, Unreserve :330, Permit
:339, Bind :352). On the device the evaluated points (PreFilter/Filter/Score)
are *batched*: a plugin contributes a whole ``[P, N]`` mask or score tensor to
the fused cycle computation instead of being called P×N times. The host-side
lifecycle points (QueueSort, Reserve, Permit, PreBind, Bind, PostBind,
Unreserve) keep per-pod semantics — they guard the commit path, which is
host-side by nature (API writes, volume attach, external coordination).

Scores obey the reference's contract: each Score plugin produces values in
[MinNodeScore, MaxNodeScore] = [0, 100] (interface.go:86-90), multiplied by
the plugin's weight and summed (framework.go:391-… RunScorePlugins).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, NamedTuple, Optional, Protocol, runtime_checkable

from ..api.types import Pod

MAX_NODE_SCORE = 100  # interface.go:87
MIN_NODE_SCORE = 0    # interface.go:90


class Code(enum.IntEnum):
    """Status codes (interface.go:53-79)."""

    SUCCESS = 0
    ERROR = 1
    UNSCHEDULABLE = 2
    UNSCHEDULABLE_AND_UNRESOLVABLE = 3
    WAIT = 4
    SKIP = 5


@dataclass(frozen=True)
class Status:
    """interface.go:97-… Status. None is treated as Success everywhere, same
    as the reference's nil-status convention."""

    code: Code = Code.SUCCESS
    message: str = ""

    @property
    def is_success(self) -> bool:
        return self.code == Code.SUCCESS

    @property
    def is_unschedulable(self) -> bool:
        return self.code in (Code.UNSCHEDULABLE, Code.UNSCHEDULABLE_AND_UNRESOLVABLE)


SUCCESS = Status()


class CycleState:
    """Per-scheduling-cycle key-value scratchpad (cycle_state.go). Plugins
    stash cross-extension-point data here; `clone()` supports the preemption
    what-if path the same way the reference's CycleState.Clone does."""

    def __init__(self) -> None:
        self._data: Dict[str, Any] = {}

    def write(self, key: str, value: Any) -> None:
        self._data[key] = value

    def read(self, key: str) -> Any:
        if key not in self._data:
            raise KeyError(f"no cycle-state entry for {key!r}")
        return self._data[key]

    def delete(self, key: str) -> None:
        self._data.pop(key, None)

    def clone(self) -> "CycleState":
        c = CycleState()
        c._data = dict(self._data)
        return c


class TensorContext(NamedTuple):
    """What a device-evaluated plugin sees: the encoded cluster + the per-cycle
    precompute, as the port's tensor NamedTuples on one device
    (state/arrays.py ClusterTables and PodArrays, ops/lattice.py
    CycleArrays). `components` carries the per-predicate mask decomposition
    (ops/assign.py MaskComponents), computed once and shared by every
    in-tree filter plugin."""

    tables: Any           # state/arrays.py ClusterTables
    cyc: Any              # ops/lattice.py CycleArrays
    pending: Any          # state/arrays.py PodArrays
    components: Any = None  # ops/assign.py MaskComponents


class Plugin:
    """interface.go:165. `name` doubles as the registry key."""

    name: str = "Plugin"


@runtime_checkable
class QueueSortPlugin(Protocol):
    """interface.go:201. less(a, b) orders the active queue."""

    def less(self, a: "QueuedPodInfo", b: "QueuedPodInfo") -> bool: ...


@dataclass(frozen=True)
class QueuedPodInfo:
    """The comparator's view of a queued pod (queue.PodInfo analog)."""

    pod: Pod
    timestamp: float = 0.0


class PreFilterPlugin(Plugin):
    """interface.go:210-221. Batched: contribute per-cycle precompute into
    CycleState before the device dispatch (GetPredicateMetadata analog)."""

    def pre_filter(self, state: CycleState, pods: list) -> Optional[Status]:
        return None


class FilterPlugin(Plugin):
    """interface.go:242. Batched: return a [P, N] bool tensor (True =
    feasible) on the TensorContext's device."""

    def filter_mask(self, state: CycleState, ctx: TensorContext):
        raise NotImplementedError


class PostFilterPlugin(Plugin):
    """interface.go:263. Informational pass over the filter outcome (receives
    the combined [P, N] mask on host)."""

    def post_filter(self, state: CycleState, pods: list, mask) -> Optional[Status]:
        return None


class ScorePlugin(Plugin):
    """interface.go:273-282. Batched: return a [P, N] f32 tensor in [0, 100]
    (already normalized — the NormalizeScore extension folds into this hook)."""

    weight: int = 1

    def score_matrix(self, state: CycleState, ctx: TensorContext):
        raise NotImplementedError


class ReservePlugin(Plugin):
    """interface.go:299. Host-side, at assume time."""

    def reserve(self, state: CycleState, pod: Pod, node_name: str) -> Optional[Status]:
        return None


class UnreservePlugin(Plugin):
    """interface.go:330. Host-side rollback; must be idempotent."""

    def unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        return None


class PermitPlugin(Plugin):
    """interface.go:339. Return SUCCESS, UNSCHEDULABLE (reject), or WAIT with
    a timeout (waiting_pods_map analog)."""

    def permit(self, state: CycleState, pod: Pod, node_name: str
               ) -> tuple[Optional[Status], float]:
        """Returns (status, timeout_seconds); timeout only meaningful for WAIT."""
        return None, 0.0


class PreBindPlugin(Plugin):
    """interface.go:308."""

    def pre_bind(self, state: CycleState, pod: Pod, node_name: str) -> Optional[Status]:
        return None


class BindPlugin(Plugin):
    """interface.go:352. Return SKIP to pass to the next bind plugin."""

    def bind(self, state: CycleState, pod: Pod, node_name: str) -> Optional[Status]:
        return None


class PostBindPlugin(Plugin):
    """interface.go:317. Informational."""

    def post_bind(self, state: CycleState, pod: Pod, node_name: str) -> None:
        return None
