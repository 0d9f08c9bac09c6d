"""In-tree framework plugins — the tensor re-expression of
pkg/scheduler/framework/plugins/* over the lattice ops (port of the JAX
package's framework/plugins.py).

Each filter plugin selects its per-predicate component from the shared
MaskComponents decomposition (ops/assign.py mask_components, computed once
per context); each score plugin returns a 0..100-normalized [P, N] f32
tensor, evaluated for all rows at once where the JAX package vmaps over
them, in the same f32 operation order. Plugin names match the reference's
registry keys (framework/plugins/default_registry.go:57) so Plugins
configs written for the reference map 1:1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.assign import mask_components, row_blocks
from ..ops.fit import resource_scores_row
from ..ops.interpod import soft_affinity_row
from ..ops.lattice import build_cycle, fma_f32
from ..ops.scores import even_spread_soft_row, selector_spread_row
from .interface import (
    Code,
    CycleState,
    FilterPlugin,
    Plugin,
    ScorePlugin,
    Status,
    TensorContext,
)
from .runtime import Framework, Plugins, PluginSet, Registry


def build_context(tables, existing, pending, uk, ev, D) -> TensorContext:
    """Assemble the TensorContext for one cycle (PreFilter device half:
    build_cycle = GetPredicateMetadata analog, metadata.go:334)."""
    cyc = build_cycle(tables, existing, uk, ev, D)
    ctx = TensorContext(tables=tables, cyc=cyc, pending=pending)
    return ctx._replace(components=mask_components(tables, cyc, pending))


def _rows(ctx: TensorContext, fn):
    """fn(cls block) → [B, N] for the context's rows, in blocks that bound
    the [B, S, N] temporaries of the count-based rows."""
    cls = ctx.pending.cls.long()
    return torch.cat([fn(cls[b]) for b in row_blocks(cls.shape[0])])


def _broadcast(row: torch.Tensor, ctx: TensorContext) -> torch.Tensor:
    """A class-independent [N] row as the context's [P, N]."""
    return row[None, :].expand(ctx.pending.valid.shape[0], -1).contiguous()


# --------------------------------------------------------------------------- #
# Filter plugins (framework/plugins/<dir>; predicates.go semantics)
# --------------------------------------------------------------------------- #


class NodeResourcesFit(FilterPlugin):
    """noderesources/fit.go — PodFitsResources (predicates.go:789)."""

    def filter_mask(self, state: CycleState, ctx: TensorContext):
        return ctx.components.fit


class NodeAffinity(FilterPlugin):
    """nodeaffinity/ — PodMatchNodeSelector (predicates.go:914): spec.nodeSelector
    ∧ required node affinity."""

    def filter_mask(self, state: CycleState, ctx: TensorContext):
        return ctx.components.node_match


class NodeName(FilterPlugin):
    """nodename/ — PodFitsHost (predicates.go:926)."""

    def filter_mask(self, state: CycleState, ctx: TensorContext):
        return ctx.components.host


class NodePorts(FilterPlugin):
    """nodeports/ — PodFitsHostPorts (predicates.go:1104)."""

    def filter_mask(self, state: CycleState, ctx: TensorContext):
        return ctx.components.ports


class TaintToleration(FilterPlugin, ScorePlugin):
    """tainttoleration/ — PodToleratesNodeTaints (predicates.go:1543) filter +
    PreferNoSchedule-counting score (taint_toleration.go)."""

    def filter_mask(self, state: CycleState, ctx: TensorContext):
        return ctx.components.taints

    def score_matrix(self, state: CycleState, ctx: TensorContext):
        return ctx.cyc.static.taint_score[ctx.pending.cls.long()]


class NodeUnschedulable(FilterPlugin):
    """nodeunschedulable/ — CheckNodeUnschedulable (predicates.go:1522).
    Evaluated jointly with taints in the lattice (spec.unschedulable is the
    synthetic node.kubernetes.io/unschedulable taint); the shared component
    keeps both names live for config parity."""

    def filter_mask(self, state: CycleState, ctx: TensorContext):
        return ctx.components.taints


class VolumeRestrictions(FilterPlugin):
    """volumerestrictions/ — NoDiskConflict (predicates.go:156-221)."""

    def filter_mask(self, state: CycleState, ctx: TensorContext):
        return ctx.components.volumes


class NodeVolumeLimits(FilterPlugin):
    """nodevolumelimits/ — the max-volume-count family
    (csi_volume_predicate.go:89; shares the volumes component with
    VolumeRestrictions — both are exact subsets of it)."""

    def filter_mask(self, state: CycleState, ctx: TensorContext):
        return ctx.components.volumes


class InterPodAffinity(FilterPlugin, ScorePlugin):
    """interpodaffinity/ — MatchInterPodAffinity (predicates.go:1212) filter +
    soft (anti)affinity score (interpod_affinity.go:119-215)."""

    def filter_mask(self, state: CycleState, ctx: TensorContext):
        return ctx.components.affinity & ctx.components.anti

    def score_matrix(self, state: CycleState, ctx: TensorContext):
        tables, cyc = ctx.tables, ctx.cyc
        D = cyc.ELD.shape[2] - 1
        return _rows(ctx, lambda c: soft_affinity_row(
            c, tables.classes, tables.terms, cyc.CNT, tables.nodes, D,
            TM=cyc.TM, WSYM=cyc.WSYM))


class PodTopologySpread(FilterPlugin, ScorePlugin):
    """podtopologyspread/ — EvenPodsSpreadPredicate (predicates.go:1643)
    filter + the ScheduleAnyway score (even_pods_spread.go:106-227)."""

    def filter_mask(self, state: CycleState, ctx: TensorContext):
        return ctx.components.spread

    def score_matrix(self, state: CycleState, ctx: TensorContext):
        tables, cyc = ctx.tables, ctx.cyc
        D = cyc.ELD.shape[2] - 1
        return _rows(ctx, lambda c: even_spread_soft_row(
            c, tables.classes, tables.terms, cyc.CNT, tables.nodes,
            cyc.static.node_match[c], D))


class SelectorSpread(ScorePlugin):
    """defaultpodtopologyspread/ — SelectorSpread across hosts and zones
    (priorities/selector_spreading.go:62-165; Pod.spread_selectors carries the
    Service/RC/RS/StatefulSet owner selectors the reference resolves via
    listers)."""

    def score_matrix(self, state: CycleState, ctx: TensorContext):
        tables, cyc = ctx.tables, ctx.cyc
        D = cyc.ELD.shape[2] - 1
        return _rows(ctx, lambda c: selector_spread_row(
            c, tables.classes, cyc.CNT, tables.nodes, tables.zone_keys, D))


class ImageLocality(ScorePlugin):
    """imagelocality/ — spread-scaled image-size score
    (priorities/image_locality.go:39-92)."""

    def score_matrix(self, state: CycleState, ctx: TensorContext):
        return ctx.cyc.static.img_score[ctx.pending.cls.long()]


class NodeLabel(ScorePlugin):
    """nodelabel/ — presence/absence label preferences
    (priorities/node_label.go:46-71). Config: {"present": [...keys],
    "absent": [...keys]}; score = 100 × hits / #prefs."""

    def __init__(self, present=(), absent=()):
        self.present = tuple(present)
        self.absent = tuple(absent)

    def score_matrix(self, state: CycleState, ctx: TensorContext):
        nodes = ctx.tables.nodes
        prefs = len(self.present) + len(self.absent)
        hits = torch.zeros(nodes.valid.shape, dtype=torch.float32,
                           device=nodes.valid.device)
        if prefs == 0:
            return _broadcast(hits, ctx)
        # label-key ids resolved host-side by the config wiring (the caller
        # interns self.present/self.absent into _present_ids/_absent_ids).
        # A 'present' key missing from the vocab can match no node; an
        # 'absent' key missing from the vocab is absent from every node —
        # both handled without touching the -1 padding in label_keys.
        for kid in getattr(self, "_present_ids", ()):
            if kid >= 0:
                hits = hits + (nodes.label_keys == kid).any(-1)
        for kid in getattr(self, "_absent_ids", ()):
            if kid >= 0:
                hits = hits + ~((nodes.label_keys == kid).any(-1))
            else:
                hits = hits + 1.0
        return _broadcast(100.0 * hits / prefs, ctx)


# the spacing of f32 machine epsilon: jnp.interp takes the left value on a
# segment at most this wide (its guard against a zero-width segment)
_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
           ) -> torch.Tensor:
    """jnp.interp(x, xp, fp) with its default ends, in its f32 operation
    order: i = clip(searchsorted(xp, x, right), 1, len−1), fp[i−1] +
    ((x − xp[i−1]) / dx) · df — one fused multiply-add, as XLA compiles it
    — fp[i−1] where |dx| ≤ spacing(eps), fp[0] below xp[0] and fp[−1]
    above xp[−1]."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(
        min=1, max=xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= _INTERP_EPS
    f = torch.where(dx0, fp[i - 1],
                    fma_f32(fp[i - 1], delta / torch.where(dx0, 1.0, dx), df))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class RequestedToCapacityRatio(ScorePlugin):
    """requestedtocapacityratio/ — broken-linear utilization shape
    (priorities/requested_to_capacity_ratio.go:30-146). Config: shape points
    [(utilization%, score)], default [(0,100),(100,0)] = least-utilized."""

    def __init__(self, shape=((0, 100), (100, 0))):
        # accept both the reference arg format [{"utilization": u, "score" : s}]
        # and plain (u, s) pairs
        pts = []
        for p in shape:
            if isinstance(p, dict):
                pts.append((float(p["utilization"]), float(p["score"])))
            else:
                pts.append((float(p[0]), float(p[1])))
        self.shape = tuple(pts)

    def score_matrix(self, state: CycleState, ctx: TensorContext):
        tables = ctx.tables
        dev = tables.nodes.valid.device
        xs = torch.tensor([p[0] for p in self.shape], dtype=torch.float32,
                          device=dev)
        ys = torch.tensor([p[1] for p in self.shape], dtype=torch.float32,
                          device=dev)
        req = tables.reqs.vec[tables.classes.rid[ctx.pending.cls.long()]
                              .long()]                         # [P, R]
        total = tables.nodes.used[None] + req[:, None, :]      # [P, N, R]
        cap = tables.nodes.alloc[None].expand_as(total)

        def util(t, cp):
            return torch.where(
                cp > 0,
                100.0 * t.float() / torch.clamp(cp.float(), min=1.0), 0.0)

        def eval_shape(u):
            # buildBrokenLinearFunction: clamp below/above, interpolate
            return interp(torch.minimum(torch.maximum(u, xs[0]), xs[-1]),
                          xs, ys)

        s_cpu = eval_shape(util(total[..., 0], cap[..., 0]))
        s_mem = eval_shape(util(total[..., 1], cap[..., 1]))
        return (s_cpu + s_mem) / 2.0


class ResourceLimits(ScorePlugin):
    """noderesources/resource_limits.go — tie-break score 1 when the node can
    satisfy the pod's cpu or memory LIMITS, else 0 (feature-gated off by
    default in the reference, kube_features.go ResourceLimitsPriorityFunction)."""

    def score_matrix(self, state: CycleState, ctx: TensorContext):
        tables = ctx.tables
        lim = tables.classes.lim_rid[ctx.pending.cls.long()]    # [P]
        vec = tables.reqs.vec[lim.clamp(min=0).long()]          # [P, R]
        cap = tables.nodes.alloc[None]                          # [1, N, R]
        v = vec[:, None, :]
        cpu_ok = (v[..., 0] > 0) & (cap[..., 0] > 0) & (v[..., 0] <= cap[..., 0])
        mem_ok = (v[..., 1] > 0) & (cap[..., 1] > 0) & (v[..., 1] <= cap[..., 1])
        return torch.where((lim >= 0)[:, None] & (cpu_ok | mem_ok), 1.0, 0.0)


# --------------------------------------------------------------------------- #
# Score plugins
# --------------------------------------------------------------------------- #


class _ResourceScoreBase(ScorePlugin):
    _index = 0  # 0 = least, 1 = balanced, 2 = most

    def score_matrix(self, state: CycleState, ctx: TensorContext):
        tables = ctx.tables
        req = tables.reqs.vec[tables.classes.rid[ctx.pending.cls.long()]
                              .long()]
        return resource_scores_row(req, tables.nodes.used,
                                   tables.nodes.alloc)[self._index]


class NodeResourcesLeastAllocated(_ResourceScoreBase):
    """noderesources/least_allocated.go — spread by free capacity."""

    _index = 0


class NodeResourcesBalancedAllocation(_ResourceScoreBase):
    """noderesources/balanced_allocation.go — minimize cpu/mem fraction skew."""

    _index = 1


class NodeResourcesMostAllocated(_ResourceScoreBase):
    """noderesources/most_allocated.go — bin packing: (total/cap)×100 averaged
    over cpu+memory (most_requested.go:52-70); shares resource_scores_row with
    least/balanced so the formula lives once."""

    _index = 2


class NodePreferAvoidPods(ScorePlugin):
    """nodepreferavoidpods/ — nodes annotated avoid-pods score 0, others 100
    (node_prefer_avoid_pods.go). The annotation rides NodeArrays.avoid
    (encoded from scheduler.alpha.kubernetes.io/preferAvoidPods).
    Deviation: the reference applies the avoidance only to pods controlled
    by an RC/RS (checks the controllerRef kind); here every pod avoids the
    node — the annotation's operational intent (drain-ish bias) at class
    granularity."""

    def score_matrix(self, state: CycleState, ctx: TensorContext):
        return _broadcast(torch.where(ctx.tables.nodes.avoid, 0.0, 100.0),
                          ctx)


class NodeAffinityScore(ScorePlugin):
    """nodeaffinity preferred terms score (priorities/node_affinity.go:34)."""

    def score_matrix(self, state: CycleState, ctx: TensorContext):
        return ctx.cyc.static.pref_score[ctx.pending.cls.long()]


# --------------------------------------------------------------------------- #
# registry + defaults (default_registry.go:57 NewDefaultRegistry)
# --------------------------------------------------------------------------- #


# score plugins whose semantics are built INTO the engines via EngineConfig
# weights (ops/lattice.py); anything else configured at the score point
# reaches the engines as a per-class bias matrix (extra_score_plugins →
# sched/cycle.py)
FUSED_SCORE_PLUGINS = frozenset({
    "NodeResourcesLeastAllocated", "NodeResourcesBalancedAllocation",
    "NodeResourcesMostAllocated", "NodeAffinityScore", "TaintToleration",
    "InterPodAffinity", "PodTopologySpread", "SelectorSpread", "ImageLocality",
    # registry alias for SelectorSpread (default_registry.go keeps both
    # names); it must not leak into the class-pure extras path — its score
    # depends on in-cycle placements
    "DefaultPodTopologySpread",
})


class Coscheduling(Plugin):
    """Gang scheduling on the Permit machinery — the host per-pod analog of
    the device gang engine (ops/gang.py). Semantics follow the out-of-tree
    sig-scheduling coscheduling plugin (the reference ships none in-tree:
    the Permit wait/allow surface at framework/v1alpha1/interface.go:339 +
    waiting_pods_map.go IS its extension hook for exactly this):

      * Reserve tracks a group's assumed members;
      * Permit WAITs each member (with `timeout`) until the group's
        minMember count is reserved, then the arriving member ALLOWs every
        waiting sibling (allow_waiting_pod) and proceeds itself;
      * the waiting-map timeout rejecting a parked member unreserves it —
        a group that never fills releases everything it held.

    Wiring: the Scheduler auto-wires `on_release` (its complete_waiting) and
    `bound_count` (its cache's group_bound_count) when this plugin is in the
    permit set — see Scheduler.__init__; tests exercising the framework
    standalone can leave both unset and quorum falls back to the plugin's
    own reservation ledger."""

    name = "Coscheduling"

    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout
        self.handle = None        # Framework runtime (allow_waiting_pod)
        self.on_release = None    # Scheduler.complete_waiting
        self.groups: dict = {}    # group key → authoritative minMember
        self.bound_count = None   # callable: group key → assumed+bound members
        self._reserved: dict = {}  # group key → in-flight reserved pod keys

    def register_group(self, key: str, min_member: int) -> None:
        """PodGroup object registration (overrides pod-carried hints)."""
        self.groups[key] = int(min_member)

    def _min_member(self, gk: str, pod) -> int:
        return self.groups.get(gk) or max(pod.min_member, 1)

    def reserve(self, state, pod, node_name):
        gk = pod.group_key
        if gk:
            self._reserved.setdefault(gk, set()).add(pod.key)
        return None

    def unreserve(self, state, pod, node_name):
        gk = pod.group_key
        if gk:
            self._reserved.get(gk, set()).discard(pod.key)

    def permit(self, state, pod, node_name):
        gk = pod.group_key
        if not gk:
            return None, 0.0
        # quorum: members assumed in the cache (covers every reserved member
        # — assume precedes Reserve — PLUS members bound in earlier cycles,
        # and self-heals when group pods are deleted). The plugin's own
        # ledger is the fallback for cache-less standalone use.
        if self.bound_count is not None:
            have = int(self.bound_count(gk))
        else:
            have = len(self._reserved.get(gk, ()))
        if have >= self._min_member(gk, pod):
            # quorum reached: release every waiting sibling, admit this one,
            # and retire the group's in-flight ledger (released members are
            # bound from here on — bound_count keeps counting them)
            waiting = [k for k in self._reserved.pop(gk, ()) if k != pod.key]
            if self.handle is not None:
                for key in waiting:
                    if self.handle.allow_waiting_pod(key, self.name) and \
                            self.on_release is not None:
                        self.on_release(key)
            return None, 0.0
        return Status(Code.WAIT, f"gang {gk}: {have}/"
                      f"{self._min_member(gk, pod)} members reserved"), \
            self.timeout


def extra_score_plugins(framework) -> tuple:
    """(plugin, weight) pairs for configured score plugins OUTSIDE the fused
    set — NodeLabel, RequestedToCapacityRatio, ResourceLimits,
    NodePreferAvoidPods, or any custom registration. These are class-pure
    (their scores depend only on (class, node), not on in-cycle placement),
    so the dispatch evaluates them once per cycle as a [SC, N] bias added to
    the static score lattice."""
    if framework is None:
        return ()
    return tuple(
        (pl, float(getattr(pl, "weight", 1)))
        for pl in framework.score_plugins
        if getattr(pl, "name", type(pl).__name__) not in FUSED_SCORE_PLUGINS
    )


def _make_node_label(cfg: dict) -> "NodeLabel":
    """NodeLabel needs vocab ids for its configured label keys; the config
    loader resolves them (present_ids/absent_ids). String keys are kept for
    introspection."""
    p = NodeLabel(present=cfg.get("present", ()), absent=cfg.get("absent", ()))
    p._present_ids = tuple(cfg.get("present_ids", ()))
    p._absent_ids = tuple(cfg.get("absent_ids", ()))
    return p


def default_registry() -> Registry:
    return {
        "NodeResourcesFit": lambda cfg: NodeResourcesFit(),
        "NodeAffinity": lambda cfg: NodeAffinity(),
        "NodeName": lambda cfg: NodeName(),
        "NodePorts": lambda cfg: NodePorts(),
        "NodeUnschedulable": lambda cfg: NodeUnschedulable(),
        "TaintToleration": lambda cfg: TaintToleration(),
        "InterPodAffinity": lambda cfg: InterPodAffinity(),
        "PodTopologySpread": lambda cfg: PodTopologySpread(),
        "NodeResourcesLeastAllocated": lambda cfg: NodeResourcesLeastAllocated(),
        "NodeResourcesBalancedAllocation": lambda cfg: NodeResourcesBalancedAllocation(),
        "NodeResourcesMostAllocated": lambda cfg: NodeResourcesMostAllocated(),
        "NodePreferAvoidPods": lambda cfg: NodePreferAvoidPods(),
        "NodeAffinityScore": lambda cfg: NodeAffinityScore(),
        "VolumeRestrictions": lambda cfg: VolumeRestrictions(),
        "NodeVolumeLimits": lambda cfg: NodeVolumeLimits(),
        "SelectorSpread": lambda cfg: SelectorSpread(),
        "DefaultPodTopologySpread": lambda cfg: SelectorSpread(),
        "ImageLocality": lambda cfg: ImageLocality(),
        "NodeLabel": lambda cfg: _make_node_label(cfg or {}),
        "RequestedToCapacityRatio": lambda cfg: RequestedToCapacityRatio(
            shape=(cfg or {}).get("shape", ((0, 100), (100, 0)))),
        "NodeResourcesResourceLimits": lambda cfg: ResourceLimits(),
        "Coscheduling": lambda cfg: Coscheduling(
            timeout=float((cfg or {}).get("permitWaitingTimeSeconds", 30.0))),
    }


def default_plugins() -> Plugins:
    """The default provider's plugin set (algorithmprovider/defaults +
    default_registry.go ConfigProducer mapping)."""
    return Plugins(
        filter=PluginSet(enabled=[
            "NodeUnschedulable", "NodeName", "NodePorts", "NodeAffinity",
            "NodeResourcesFit", "TaintToleration", "InterPodAffinity",
            "PodTopologySpread", "VolumeRestrictions", "NodeVolumeLimits",
        ]),
        score=PluginSet(enabled=[
            "NodeResourcesLeastAllocated", "NodeResourcesBalancedAllocation",
            "NodeAffinityScore", "TaintToleration", "InterPodAffinity",
            "PodTopologySpread", "SelectorSpread", "ImageLocality",
        ]),
    )


def default_framework(
    plugins: Optional[Plugins] = None,
    plugin_config: Optional[dict] = None,
    score_weights: Optional[dict] = None,
) -> Framework:
    return Framework(
        registry=default_registry(),
        plugins=plugins or default_plugins(),
        plugin_config=plugin_config,
        score_weights=score_weights,
    )
