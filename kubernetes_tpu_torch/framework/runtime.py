"""Framework runner — framework/v1alpha1/framework.go re-designed for batched
device evaluation (port of the JAX package's framework/runtime.py).

RunFilterPlugins (framework.go:339) becomes one AND over every enabled
plugin's [P, N] bool tensor; RunScorePlugins (:391 — parallel per plugin,
normalize, weight, sum) becomes one weighted f32 sum of [P, N] score
tensors in plugin order, on the context's device. The host lifecycle points (Reserve/Permit/PreBind/Bind/PostBind/
Unreserve, :299-563) run per pod on the commit path, including the
waiting-pods map with Permit timeouts (waiting_pods_map.go).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.lattice import f32_scalar, fma_f32

from ..api.types import Pod
from .interface import (
    BindPlugin,
    Code,
    CycleState,
    FilterPlugin,
    PermitPlugin,
    Plugin,
    PostBindPlugin,
    PostFilterPlugin,
    PreBindPlugin,
    PreFilterPlugin,
    ReservePlugin,
    ScorePlugin,
    Status,
    SUCCESS,
    TensorContext,
    UnreservePlugin,
)


@dataclass
class PluginSet:
    """apis/config Plugins entry: enabled plugin names (+ weight for Score)."""

    enabled: List[str] = field(default_factory=list)
    # filters default plugins during merge_plugins(); "*" drops all defaults.
    # On a hand-built Plugins it filters exact names from `enabled`.
    disabled: List[str] = field(default_factory=list)


@dataclass
class Plugins:
    """Which plugins run at each extension point (apis/config/types.go:160
    Plugins struct, one PluginSet per point)."""

    pre_filter: PluginSet = field(default_factory=PluginSet)
    filter: PluginSet = field(default_factory=PluginSet)
    post_filter: PluginSet = field(default_factory=PluginSet)
    score: PluginSet = field(default_factory=PluginSet)
    reserve: PluginSet = field(default_factory=PluginSet)
    permit: PluginSet = field(default_factory=PluginSet)
    pre_bind: PluginSet = field(default_factory=PluginSet)
    bind: PluginSet = field(default_factory=PluginSet)
    post_bind: PluginSet = field(default_factory=PluginSet)
    unreserve: PluginSet = field(default_factory=PluginSet)

    POINTS = ("pre_filter", "filter", "post_filter", "score", "reserve",
              "permit", "pre_bind", "bind", "post_bind", "unreserve")


def merge_plugins(defaults: Plugins, custom: Plugins) -> Plugins:
    """Reference profile merging (apis/config Plugins.Apply): per extension
    point, custom.disabled filters the defaults ("*" drops them all), then
    custom.enabled is appended in order."""
    out = Plugins()
    for point in Plugins.POINTS:
        d: PluginSet = getattr(defaults, point)
        c: PluginSet = getattr(custom, point)
        if "*" in c.disabled:
            base: List[str] = []
        else:
            base = [n for n in d.enabled if n not in set(c.disabled)]
        merged = base + [n for n in c.enabled if n not in base]
        setattr(out, point, PluginSet(enabled=merged))
    return out


# factory: (args: dict) -> Plugin instance
Registry = Dict[str, Callable[[dict], Plugin]]


@dataclass
class _WaitingPod:
    """waiting_pods_map.go WaitingPod: a pod parked by a Permit WAIT."""

    pod: Pod
    node_name: str
    state: CycleState
    deadline: float
    pending_plugins: set  # plugin names still to allow


class Framework:
    """framework.go:96 framework struct + NewFramework (:145)."""

    def __init__(
        self,
        registry: Registry,
        plugins: Plugins,
        plugin_config: Optional[Dict[str, dict]] = None,
        score_weights: Optional[Dict[str, int]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.registry = dict(registry)
        self.plugins_config = plugins
        self.clock = clock
        cfg = plugin_config or {}

        instances: Dict[str, Plugin] = {}

        def get(name: str) -> Plugin:
            if name not in instances:
                if name not in self.registry:
                    raise KeyError(f"plugin {name!r} is not registered")
                instances[name] = self.registry[name](cfg.get(name, {}))
                instances[name].name = name
            return instances[name]

        def pick(ps: PluginSet) -> List[Plugin]:
            # ps.disabled is resolved against defaults by merge_plugins();
            # here it still filters exact names so a hand-built Plugins
            # behaves as documented
            return [get(n) for n in ps.enabled if n not in set(ps.disabled)]

        self.pre_filter_plugins: List[PreFilterPlugin] = pick(plugins.pre_filter)
        self.filter_plugins: List[FilterPlugin] = pick(plugins.filter)
        self.post_filter_plugins: List[PostFilterPlugin] = pick(plugins.post_filter)
        self.score_plugins: List[ScorePlugin] = pick(plugins.score)
        self.reserve_plugins: List[ReservePlugin] = pick(plugins.reserve)
        self.permit_plugins: List[PermitPlugin] = pick(plugins.permit)
        self.pre_bind_plugins: List[PreBindPlugin] = pick(plugins.pre_bind)
        self.bind_plugins: List[BindPlugin] = pick(plugins.bind)
        self.post_bind_plugins: List[PostBindPlugin] = pick(plugins.post_bind)
        self.unreserve_plugins: List[UnreservePlugin] = pick(plugins.unreserve)

        for p in self.score_plugins:
            w = (score_weights or {}).get(p.name, getattr(p, "weight", 1))
            if w <= 0:
                raise ValueError(f"score plugin {p.name} has non-positive weight {w}")
            p.weight = w

        # plugins declaring a `handle` slot get the framework itself — the
        # FrameworkHandle injection (framework.go:145 NewFramework passes the
        # handle to every factory; Coscheduling uses it to allow waiters)
        for p in instances.values():
            if hasattr(p, "handle") and p.handle is None:
                p.handle = self

        self._waiting: Dict[str, _WaitingPod] = {}
        self._wmu = threading.Lock()

    # ------------------------------------------------------------------ #
    # device-evaluated points (tensor ops on the context's device)
    # ------------------------------------------------------------------ #

    def run_pre_filter_plugins(self, state: CycleState, pods: list) -> Optional[Status]:
        """framework.go:260 RunPreFilterPlugins — host-side per-cycle
        precompute; an error status aborts the cycle."""
        for p in self.pre_filter_plugins:
            st = p.pre_filter(state, pods)
            if st is not None and not st.is_success:
                return Status(st.code, f"prefilter plugin {p.name}: {st.message}")
        return None

    def run_filter_plugins(self, state: CycleState, ctx: TensorContext):
        """framework.go:339 RunFilterPlugins — AND of [P, N] masks."""
        mask = None
        for p in self.filter_plugins:
            m = p.filter_mask(state, ctx)
            mask = m if mask is None else (mask & m)
        valid = ctx.pending.valid[:, None] & ctx.tables.nodes.valid[None, :]
        return valid if mask is None else mask & valid

    def run_score_plugins(self, state: CycleState, ctx: TensorContext):
        """framework.go:391 RunScorePlugins — Σ weight × normalized [P, N]."""
        P = ctx.pending.valid.shape[0]
        N = ctx.tables.nodes.valid.shape[0]
        total = torch.zeros((P, N), dtype=torch.float32,
                            device=ctx.pending.valid.device)
        for p in self.score_plugins:
            # total + w·row as the JAX package's compiled sum computes it:
            # the weight as an f32 value, each step one fused multiply-add
            total = fma_f32(total, f32_scalar(p.weight),
                            p.score_matrix(state, ctx).float())
        return total

    def run_post_filter_plugins(self, state: CycleState, pods: list, mask) -> Optional[Status]:
        for p in self.post_filter_plugins:
            st = p.post_filter(state, pods, mask)
            if st is not None and not st.is_success:
                return Status(st.code, f"postfilter plugin {p.name}: {st.message}")
        return None

    # ------------------------------------------------------------------ #
    # host lifecycle points (commit path)
    # ------------------------------------------------------------------ #

    def run_reserve_plugins(self, state: CycleState, pod: Pod, node: str) -> Optional[Status]:
        for p in self.reserve_plugins:
            st = p.reserve(state, pod, node)
            if st is not None and not st.is_success:
                return Status(Code.ERROR, f"reserve plugin {p.name}: {st.message}")
        return None

    def run_unreserve_plugins(self, state: CycleState, pod: Pod, node: str) -> None:
        for p in self.unreserve_plugins:
            p.unreserve(state, pod, node)

    def run_permit_plugins(self, state: CycleState, pod: Pod, node: str) -> Status:
        """framework.go:553 RunPermitPlugins: reject wins; any WAIT parks the
        pod in the waiting map with the max timeout."""
        pending: set = set()
        timeout = 0.0
        for p in self.permit_plugins:
            st, t = p.permit(state, pod, node)
            if st is None or st.is_success:
                continue
            if st.code == Code.WAIT:
                pending.add(p.name)
                timeout = max(timeout, t)
            else:
                return Status(Code.UNSCHEDULABLE,
                              f"pod rejected by permit plugin {p.name}: {st.message}")
        if pending:
            with self._wmu:
                self._waiting[pod.key] = _WaitingPod(
                    pod=pod, node_name=node, state=state,
                    deadline=self.clock() + timeout, pending_plugins=pending,
                )
            return Status(Code.WAIT, f"waiting on permit plugins {sorted(pending)}")
        return SUCCESS

    def run_pre_bind_plugins(self, state: CycleState, pod: Pod, node: str) -> Optional[Status]:
        for p in self.pre_bind_plugins:
            st = p.pre_bind(state, pod, node)
            if st is not None and not st.is_success:
                return Status(Code.ERROR, f"prebind plugin {p.name}: {st.message}")
        return None

    def run_bind_plugins(self, state: CycleState, pod: Pod, node: str) -> Status:
        """framework.go:487 RunBindPlugins: first non-SKIP result wins."""
        if not self.bind_plugins:
            return Status(Code.SKIP)
        for p in self.bind_plugins:
            st = p.bind(state, pod, node)
            if st is not None and st.code == Code.SKIP:
                continue
            if st is not None and not st.is_success:
                return Status(Code.ERROR, f"bind plugin {p.name}: {st.message}")
            return SUCCESS
        return Status(Code.SKIP)

    def run_post_bind_plugins(self, state: CycleState, pod: Pod, node: str) -> None:
        for p in self.post_bind_plugins:
            p.post_bind(state, pod, node)

    # ------------------------------------------------------------------ #
    # waiting pods (waiting_pods_map.go)
    # ------------------------------------------------------------------ #

    def waiting_pods(self) -> List[Pod]:
        with self._wmu:
            return [w.pod for w in self._waiting.values()]

    def allow_waiting_pod(self, key: str, plugin: str) -> bool:
        """A permit plugin allows the pod; when no plugins remain pending the
        pod is released (caller completes the bind). Returns released?"""
        with self._wmu:
            w = self._waiting.get(key)
            if w is None:
                return False
            w.pending_plugins.discard(plugin)
            if not w.pending_plugins:
                del self._waiting[key]
                return True
            return False

    def reject_waiting_pod(self, key: str) -> Optional[Pod]:
        with self._wmu:
            w = self._waiting.pop(key, None)
            return w.pod if w else None

    def pop_waiting(self, key: str) -> Optional[_WaitingPod]:
        with self._wmu:
            return self._waiting.pop(key, None)

    def expire_waiting(self, now: float) -> List[_WaitingPod]:
        """Timed-out waiting pods are rejected (waiting_pods_map timeout)."""
        out = []
        with self._wmu:
            for key in list(self._waiting):
                if now >= self._waiting[key].deadline:
                    out.append(self._waiting.pop(key))
        return out

    def has_filter_plugins(self) -> bool:
        return bool(self.filter_plugins)

    def has_score_plugins(self) -> bool:
        return bool(self.score_plugins)
