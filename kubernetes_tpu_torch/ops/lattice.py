"""Static (class × node) lattice: everything that does not change as pods land
(port of the JAX package's ops/lattice.py).

Filter/Score split into static parts — nodeSelector, node affinity, taints,
spec.unschedulable — evaluated ONCE per cycle as [SC, N] tensors here, and
dynamic parts re-evaluated against the assume state by the engines
(ops/assign.py, ops/waves.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..parallel import axis
from ..state.arrays import Array, ClusterTables, PodArrays
from .interpod import class_term_membership, per_node_counts, term_class_matrix
from .labels import node_term_matrix
from .scores import image_locality_static, symmetric_weight_cols, weighted_per_node
from .taints import taint_matrices, taint_toleration_score
from .topospread import eligible_domains


class EngineConfig(NamedTuple):
    """KubeSchedulerConfiguration's plugin composition as scalars: per-component
    filter enables (on at ≥ 0.5) and score weights. Components correspond 1:1
    to the in-tree plugin names (factory.go:309,387 CreateFromConfig)."""

    f_unsched: float        # NodeUnschedulable
    f_name: float           # NodeName (spec.nodeName)
    f_ports: float          # NodePorts
    f_node_affinity: float  # NodeAffinity (nodeSelector + required affinity)
    f_fit: float            # NodeResourcesFit
    f_taints: float         # TaintToleration
    f_interpod: float       # InterPodAffinity (required + symmetry)
    f_spread: float         # PodTopologySpread (DoNotSchedule)
    f_volrestrict: float    # VolumeRestrictions (NoDiskConflict)
    f_vollimits: float      # NodeVolumeLimits (max attach counts)
    w_node_affinity: float  # NodeAffinityScore (preferred terms)
    w_taint: float          # TaintToleration score
    w_img: float            # ImageLocality
    w_least: float          # NodeResourcesLeastAllocated
    w_balanced: float       # NodeResourcesBalancedAllocation
    w_most: float           # NodeResourcesMostAllocated (0 in defaults)
    w_interpod: float       # InterPodAffinity soft score (both directions)
    w_even: float           # PodTopologySpread ScheduleAnyway score
    w_ssel: float           # SelectorSpread
    # wave-admission score window (ops/waves.py): a class admits this wave
    # only on nodes scoring within `w_window` of its per-class feasible max
    # (MaxNodeScore=100, interface.go:87 — one plugin's full swing)
    w_window: float = 100.0


def f32_scalar(x) -> float:
    """A Python number as the double that holds its nearest f32 exactly:
    multiplying an f32 tensor by it gives the product of two f32 values
    whichever precision the op computes a Python scalar in, as a JAX f32
    op on a weak-typed scalar does."""
    return float(np.float32(x))


def fma_f32(a: Array, b, c: Array) -> Array:
    """a + b·c rounded once to f32, as XLA's CPU backend computes an f32
    `a + b * c` that it contracts into a fused multiply-add — which it does
    where both sit in one fusion, so inside jnp.interp and the JAX
    package's folds of weighted score rows: the
    product is exact in f64, the sum is rounded to odd in f64 (TwoSum's
    error decides the last bit), and rounding that to f32 is then correct
    (round-to-odd at ≥ 2 extra bits). The same ops on the CPU and the card,
    so both give the same bits. `b` may be a Python number (an f32 value)."""
    a64 = a.double()
    p = c.double() * (b.double() if isinstance(b, torch.Tensor) else float(b))
    s = a64 + p
    bb = s - a64
    err = (a64 - (s - bb)) + (p - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def strong_engine_config(cfg: EngineConfig) -> EngineConfig:
    """Each leaf as the double that holds its nearest f32 exactly — the JAX
    package casts every leaf to a strong f32 scalar at each dispatch
    boundary, so a weight such as 0.1 meets the f32 planes as that f32
    value; here it does so whichever precision an op computes a Python
    scalar in."""
    return EngineConfig(*(f32_scalar(x) for x in cfg))


def default_engine_config() -> EngineConfig:
    """The default provider's composition: every filter on, the default score
    set at weight 1, MostAllocated off (algorithmprovider/defaults)."""
    one, zero = 1.0, 0.0
    return EngineConfig(
        f_unsched=one, f_name=one, f_ports=one, f_node_affinity=one,
        f_fit=one, f_taints=one, f_interpod=one, f_spread=one,
        f_volrestrict=one, f_vollimits=one,
        w_node_affinity=one, w_taint=one, w_img=one, w_least=one,
        w_balanced=one, w_most=zero, w_interpod=one, w_even=one, w_ssel=one,
    )


def _on(flag: float) -> bool:
    """A filter component is enforced when its flag ≥ 0.5."""
    return float(flag) >= 0.5


class StaticLattice(NamedTuple):
    mask: Array        # [SC, N] — static Filter conjunction
    node_match: Array  # [SC, N] — nodeSelector ∧ node-affinity only (spread eligibility)
    score: Array       # [SC, N] f32 — static Score sum (pref + taint + image)
    pref_score: Array  # [SC, N] f32 — preferred node affinity, 0..100-normalized
    taint_score: Array # [SC, N] f32 — taint PreferNoSchedule score, 0..100
    img_score: Array   # [SC, N] f32 — ImageLocality, 0..100


class CycleArrays(NamedTuple):
    """Per-cycle precomputed tensors fed to the engines."""

    static: StaticLattice
    TM: Array        # [S, SC] term × class match
    has_anti: Array  # [SC, S] class anti-term membership
    CNT: Array       # [S, N] per-node term match counts (live carry seed)
    HOLD: Array      # [S, N] per-node anti-term holder counts (live carry seed)
    ELD: Array       # [SC, TS, D+1] eligible domains per class × constraint
    WCOLS: Array     # [S, SC] f32 signed symmetric-preference weights per class
    WSYM: Array      # [S, N] f32 symmetric weight seed from existing pods
    ecfg: EngineConfig


def _safe_row_gather(M: Array, ids: Array, default: bool) -> Array:
    """M: [SN, N]; ids: [...] with -1 ⇒ `default` row."""
    rows = M[ids.clamp(min=0).long()]
    return torch.where((ids >= 0)[..., None], rows, default)


def build_static(
    tables: ClusterTables, unschedulable_key: int, empty_val: int,
    ecfg: EngineConfig | None = None,
) -> StaticLattice:
    if ecfg is None:
        ecfg = default_engine_config()
    nodes, classes = tables.nodes, tables.classes

    MT = node_term_matrix(tables.nterms, nodes)  # [SN, N]

    # spec.nodeSelector (predicates.go:879-886)
    nsel_ok = _safe_row_gather(MT, classes.nsel_term, True)  # [SC, N]

    # node affinity required: OR of terms (predicates.go:894-906); present but
    # term-less affinity matches nothing
    term_rows = _safe_row_gather(MT, classes.nterm_ids, False)  # [SC, T, N]
    aff_ok = (~classes.aff_active)[:, None] | term_rows.any(1)

    node_match = nsel_ok & aff_ok & nodes.valid[None, :]
    # spread eligibility always uses the raw node_match; the FILTER honors
    # the NodeAffinity plugin flag
    node_match_f = (node_match | (not _on(ecfg.f_node_affinity))) \
        & nodes.valid[None, :]

    tol_ok, prefer_cnt, unsched_ok = taint_matrices(
        tables.tolsets, nodes, unschedulable_key, empty_val)
    ts = classes.tolset.long()
    taint_ok = tol_ok[ts]                                   # [SC, N]
    unsched_pass = (~nodes.unschedulable)[None, :] | unsched_ok[ts][:, None]

    taint_ok_f = taint_ok | (not _on(ecfg.f_taints))
    unsched_f = unsched_pass | (not _on(ecfg.f_unsched))
    mask = node_match_f & taint_ok_f & unsched_f & classes.valid[:, None]

    # preferred node affinity (node_affinity.go:34-80): Σ weight·match, then
    # NormalizeReduce(100, false) per class across nodes
    pref_rows = _safe_row_gather(MT, classes.pterm_ids, False)  # [SC, PT, N]
    w = torch.where(classes.pterm_ids >= 0, classes.pterm_w, 0).float()
    pref_raw = (w[:, :, None] * pref_rows).sum(1)              # [SC, N]
    mx = axis.current().amax(pref_raw, 1, keepdim=True)
    pref_score = torch.where(
        mx > 0, pref_raw * 100.0 / torch.clamp(mx, min=1e-9), 0.0)

    taint_score = taint_toleration_score(prefer_cnt[ts])       # [SC, N]
    img_score = image_locality_static(tables)                  # [SC, N]

    score = (pref_score * ecfg.w_node_affinity + taint_score * ecfg.w_taint
             + img_score * ecfg.w_img)
    return StaticLattice(mask=mask, node_match=node_match, score=score,
                         pref_score=pref_score, taint_score=taint_score,
                         img_score=img_score)


def build_cycle(
    tables: ClusterTables,
    existing: PodArrays,
    unschedulable_key: int,
    empty_val: int,
    D: int,
    hard_weight: float = 1.0,
    ecfg: EngineConfig | None = None,
) -> CycleArrays:
    """Everything the engines need, once per cycle (RunPreFilterPlugins +
    GetPredicateMetadata analog, generic_scheduler.go:206, metadata.go:334)."""
    if ecfg is None:
        ecfg = default_engine_config()
    static = build_static(tables, unschedulable_key, empty_val, ecfg)
    TM = term_class_matrix(tables.terms, tables.labelsets, tables.classes)
    S = TM.shape[0]
    N = tables.nodes.valid.shape[0]
    has_anti = class_term_membership(tables.classes.anti_terms, S)
    CNT = per_node_counts(TM, existing, N)
    HOLD = per_node_counts(has_anti.T, existing, N)
    ELD = eligible_domains(static.node_match, tables.classes, tables.nodes, D)
    WCOLS = symmetric_weight_cols(tables.classes, S, hard_weight)
    WSYM = weighted_per_node(WCOLS, existing, N)
    return CycleArrays(static=static, TM=TM, has_anti=has_anti, CNT=CNT,
                       HOLD=HOLD, ELD=ELD, WCOLS=WCOLS, WSYM=WSYM, ecfg=ecfg)
