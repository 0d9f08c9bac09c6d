"""Scheduler configuration surface: KubeSchedulerConfiguration + legacy Policy
(port of the JAX package's sched/config.py; `engine_config()` lowers into
the port's EngineConfig, ops/lattice.py).

Mirrors the reference's three config layers:

  1. `KubeSchedulerConfiguration` (ComponentConfig) —
     pkg/scheduler/apis/config/types.go:45-112: SchedulerName,
     AlgorithmSource (provider | policy file), HardPodAffinitySymmetricWeight,
     DisablePreemption (:76), PercentageOfNodesToScore (:86, default 50 with
     the adaptive formula at :229-231), BindTimeoutSeconds (:91), backoff
     bounds (:96-101), Plugins/PluginConfig (:108-112,160), LeaderElection.
  2. Legacy Policy JSON (factory.go:309 CreateFromConfig): named predicates/
     priorities + extenders, mapped onto framework plugins through the same
     name table as the reference's ConfigProducerRegistry
     (framework/plugins/default_registry.go:103-…).
  3. Feature gates (component/featuregate.py).

Files may be YAML or JSON (YAML through PyYAML, imported only when a
source is not JSON). `percentageOfNodesToScore` is accepted and stored; the
lattice evaluates every node (full masks are cheaper than sampling
bookkeeping on the device — docs/PARITY.md #2), so the knob only caps
nothing below O(10^4) nodes; it is surfaced on the loaded config for
operators and tests.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..component.featuregate import DEFAULT_FEATURE_GATES
from ..extender.client import ExtenderConfig
from ..framework.plugins import default_plugins, default_registry
from ..framework.runtime import Framework, Plugins, PluginSet

# Legacy predicate name → framework filter plugin (the ConfigProducerRegistry
# mapping, default_registry.go:103-…).
PREDICATE_TO_PLUGIN = {
    "PodFitsResources": "NodeResourcesFit",
    "GeneralPredicates": "NodeResourcesFit",
    "PodFitsHostPorts": "NodePorts",
    "HostName": "NodeName",
    "PodFitsHost": "NodeName",
    "MatchNodeSelector": "NodeAffinity",
    "PodToleratesNodeTaints": "TaintToleration",
    "CheckNodeUnschedulable": "NodeUnschedulable",
    "MatchInterPodAffinity": "InterPodAffinity",
    "EvenPodsSpread": "PodTopologySpread",
    "NoDiskConflict": "VolumeRestrictions",
    "MaxCSIVolumeCountPred": "NodeVolumeLimits",
    "MaxEBSVolumeCount": "NodeVolumeLimits",
    "MaxGCEPDVolumeCount": "NodeVolumeLimits",
    "MaxAzureDiskVolumeCount": "NodeVolumeLimits",
    "MaxCinderVolumeCount": "NodeVolumeLimits",
}

# Legacy priority name → framework score plugin.
PRIORITY_TO_PLUGIN = {
    "LeastRequestedPriority": "NodeResourcesLeastAllocated",
    "MostRequestedPriority": "NodeResourcesMostAllocated",
    "BalancedResourceAllocation": "NodeResourcesBalancedAllocation",
    "NodeAffinityPriority": "NodeAffinityScore",
    "TaintTolerationPriority": "TaintToleration",
    "InterPodAffinityPriority": "InterPodAffinity",
    "EvenPodsSpreadPriority": "PodTopologySpread",
    "SelectorSpreadPriority": "SelectorSpread",
    "ServiceSpreadingPriority": "SelectorSpread",
    "ImageLocalityPriority": "ImageLocality",
    "NodePreferAvoidPodsPriority": "NodePreferAvoidPods",
    "RequestedToCapacityRatioPriority": "RequestedToCapacityRatio",
    "ResourceLimitsPriority": "NodeResourcesResourceLimits",
    "NodeLabelPriority": "NodeLabel",
}


@dataclass
class LeaderElectionConfiguration:
    """types.go LeaderElection (component-base config)."""

    leader_elect: bool = False
    lease_duration_seconds: float = 15.0
    renew_deadline_seconds: float = 10.0
    retry_period_seconds: float = 2.0


@dataclass
class KubeSchedulerConfiguration:
    """apis/config/types.go:45-112, the fields this framework consumes."""

    scheduler_name: str = "default-scheduler"
    algorithm_provider: str = "DefaultProvider"
    policy: Optional[dict] = None          # inlined legacy Policy
    hard_pod_affinity_symmetric_weight: int = 1   # :70 (default 1)
    disable_preemption: bool = False       # :76
    percentage_of_nodes_to_score: int = 0  # :86; 0 = adaptive default
    # batched-engine extension (no reference analog — the BASELINE's opt-in
    # knobs live in ComponentConfig): the wave engine's per-class score
    # admission window (ops/lattice.py EngineConfig.w_window, PARITY #3).
    # Default MaxNodeScore=100; 0 = strict per-wave argmax tiers.
    score_admission_window: float = 100.0
    # batched-engine extension: decision provenance — the
    # on-device unschedulability attribution + FailedScheduling event
    # pipeline (sched/explain.py). Off by default; KTPU_EXPLAIN env is
    # the other switch.
    decision_provenance: bool = False
    bind_timeout_seconds: float = 600.0    # :91
    pod_initial_backoff_seconds: float = 1.0   # :96
    pod_max_backoff_seconds: float = 10.0      # :101
    leader_election: LeaderElectionConfiguration = field(
        default_factory=LeaderElectionConfiguration)
    plugins: Optional[Plugins] = None      # :108 (None = provider default)
    plugin_config: Dict[str, dict] = field(default_factory=dict)  # :112
    score_weights: Dict[str, float] = field(default_factory=dict)
    extenders: Tuple[ExtenderConfig, ...] = ()
    feature_gates: Dict[str, bool] = field(default_factory=dict)

    def effective_percentage_of_nodes_to_score(self, num_nodes: int) -> int:
        """numFeasibleNodesToFind's adaptive formula
        (core/generic_scheduler.go:450-469): 100% under 100 nodes; otherwise
        the configured value, defaulting to 50 − nodes/125 floored at 5."""
        if self.percentage_of_nodes_to_score:
            return min(self.percentage_of_nodes_to_score, 100)
        if num_nodes < 100:
            return 100
        adaptive = 50 - num_nodes // 125
        return max(adaptive, 5)

    def engine_config(self):
        """Lower the plugin composition into the engines' weights/flags
        (ops/lattice.py EngineConfig, each leaf an f32 value): a filter
        plugin absent from the set stops filtering; a score plugin absent
        scores 0; an enabled score plugin carries its configured weight."""
        from ..ops.lattice import (
            EngineConfig, default_engine_config, strong_engine_config)

        plugins = self.plugins or default_plugins()
        fset = set(plugins.filter.enabled)
        sset = set(plugins.score.enabled)

        def w(name: str) -> float:
            return float(self.score_weights.get(name, 1.0)) \
                if name in sset else 0.0

        return strong_engine_config(EngineConfig(
            f_unsched=1.0 if "NodeUnschedulable" in fset else 0.0,
            f_name=1.0 if "NodeName" in fset else 0.0,
            f_ports=1.0 if "NodePorts" in fset else 0.0,
            f_node_affinity=1.0 if "NodeAffinity" in fset else 0.0,
            f_fit=1.0 if "NodeResourcesFit" in fset else 0.0,
            f_taints=1.0 if "TaintToleration" in fset else 0.0,
            f_interpod=1.0 if "InterPodAffinity" in fset else 0.0,
            f_spread=1.0 if "PodTopologySpread" in fset else 0.0,
            f_volrestrict=1.0 if "VolumeRestrictions" in fset else 0.0,
            f_vollimits=1.0 if "NodeVolumeLimits" in fset else 0.0,
            w_node_affinity=w("NodeAffinityScore"),
            w_taint=w("TaintToleration"),
            w_img=w("ImageLocality"),
            w_least=w("NodeResourcesLeastAllocated"),
            w_balanced=w("NodeResourcesBalancedAllocation"),
            w_most=w("NodeResourcesMostAllocated"),
            w_interpod=w("InterPodAffinity"),
            w_even=w("PodTopologySpread"),
            w_ssel=max(w("SelectorSpread"), w("DefaultPodTopologySpread")),
            w_window=float(self.score_admission_window),
        )) if (self.plugins is not None or self.score_weights) \
            else strong_engine_config(default_engine_config()._replace(
                w_window=float(self.score_admission_window)))

    def build_framework(self) -> Framework:
        return Framework(
            registry=default_registry(),
            plugins=self.plugins or default_plugins(),
            plugin_config=self.plugin_config or None,
            score_weights=self.score_weights or None,
        )

    def apply_feature_gates(self) -> None:
        DEFAULT_FEATURE_GATES.set_from_map(self.feature_gates)


def _plugin_set(d: dict) -> PluginSet:
    return PluginSet(
        enabled=[p["name"] if isinstance(p, dict) else p
                 for p in d.get("enabled", [])],
        disabled=[p["name"] if isinstance(p, dict) else p
                  for p in d.get("disabled", [])],
    )


def _parse_plugins(d: Optional[dict]) -> Optional[Plugins]:
    """Reference semantics (apis/config/types.go:117-158) via the runtime's
    merge_plugins: enabled appends to the default set; disabled removes from
    it ('*' disables everything)."""
    if not d:
        return None
    from ..framework.runtime import merge_plugins

    custom = Plugins()
    for point in ("filter", "score"):
        if d.get(point):
            setattr(custom, point, _plugin_set(d[point]))
    return merge_plugins(default_plugins(), custom)


def _parse_extender(d: dict) -> ExtenderConfig:
    """legacy_types.go:75 Extender fields (TLS omitted — http only here)."""
    return ExtenderConfig(
        url_prefix=d.get("urlPrefix", d.get("url_prefix", "")),
        filter_verb=d.get("filterVerb", d.get("filter_verb", "")),
        prioritize_verb=d.get("prioritizeVerb", d.get("prioritize_verb", "")),
        preempt_verb=d.get("preemptVerb", d.get("preempt_verb", "")),
        bind_verb=d.get("bindVerb", d.get("bind_verb", "")),
        weight=int(d.get("weight", 1)),
        http_timeout=float(d.get("httpTimeout", d.get("http_timeout", 5.0))),
        node_cache_capable=bool(d.get("nodeCacheCapable",
                                      d.get("node_cache_capable", False))),
        managed_resources=tuple(
            (r.get("name") if isinstance(r, dict) else r)
            for r in d.get("managedResources", d.get("managed_resources", ()))),
        ignorable=bool(d.get("ignorable", False)),
    )


def load_config(source) -> KubeSchedulerConfiguration:
    """Parse a KubeSchedulerConfiguration from a dict, a YAML/JSON string, or
    a file path. Unknown keys are ignored (the reference's scheme drops
    unregistered fields on decode)."""
    data = _load_data(source)
    if data.get("kind") not in (None, "KubeSchedulerConfiguration"):
        raise ValueError(f"not a KubeSchedulerConfiguration: {data.get('kind')}")

    le = data.get("leaderElection", {}) or {}
    if int(data.get("percentageOfNodesToScore", 0) or 0):
        # accepted for config-surface parity, deliberately inert: the
        # engine evaluates the full (class × node) lattice — sampling saves
        # nothing on a dense device pass below O(10⁴) nodes (PARITY #2).
        # Said out loud so the knob never silently advertises work it
        # doesn't do.
        import logging

        logging.getLogger("ktpu.sched.config").warning(
            "percentageOfNodesToScore=%s is IGNORED: the engine "
            "evaluates the full node lattice (docs/PARITY.md #2)",
            data["percentageOfNodesToScore"])
    cfg = KubeSchedulerConfiguration(
        scheduler_name=data.get("schedulerName", "default-scheduler"),
        hard_pod_affinity_symmetric_weight=int(
            data.get("hardPodAffinitySymmetricWeight", 1)),
        disable_preemption=bool(data.get("disablePreemption", False)),
        percentage_of_nodes_to_score=int(
            data.get("percentageOfNodesToScore", 0)),
        # clamped non-negative (NaN → default): a negative window would
        # make even the per-class argmax inadmissible — a silent total
        # scheduling outage from a typo
        score_admission_window=(
            lambda v: v if v == v and v >= 0 else 100.0)(
                float(data.get("scoreAdmissionWindow", 100.0))),
        decision_provenance=bool(data.get("decisionProvenance", False)),
        bind_timeout_seconds=float(data.get("bindTimeoutSeconds", 600)),
        pod_initial_backoff_seconds=float(
            data.get("podInitialBackoffSeconds", 1)),
        pod_max_backoff_seconds=float(data.get("podMaxBackoffSeconds", 10)),
        leader_election=LeaderElectionConfiguration(
            leader_elect=bool(le.get("leaderElect", False)),
            lease_duration_seconds=float(le.get("leaseDuration", 15)),
            renew_deadline_seconds=float(le.get("renewDeadline", 10)),
            retry_period_seconds=float(le.get("retryPeriod", 2)),
        ),
        plugins=_parse_plugins(data.get("plugins")),
        plugin_config={
            pc["name"]: pc.get("args", {})
            for pc in data.get("pluginConfig", [])
        },
        score_weights={
            p["name"]: float(p["weight"])
            for ext in (data.get("plugins", {}) or {}).values()
            if isinstance(ext, dict)
            for p in ext.get("enabled", [])
            if isinstance(p, dict) and "weight" in p
        },
        extenders=tuple(_parse_extender(e) for e in data.get("extenders", [])),
        feature_gates={k: bool(v)
                       for k, v in (data.get("featureGates", {}) or {}).items()},
    )

    src = data.get("algorithmSource", {}) or {}
    if "provider" in src:
        cfg.algorithm_provider = src["provider"]
    pol = src.get("policy")
    if pol:
        pol_file = (pol.get("file") or {}).get("path")
        cfg.policy = _load_data(pol_file) if pol_file else pol.get("inline")
    if data.get("policy"):
        cfg.policy = data["policy"]
    if cfg.policy:
        apply_policy(cfg, cfg.policy)
    return cfg


def apply_policy(cfg: KubeSchedulerConfiguration, policy: dict) -> None:
    """Legacy Policy composition (factory.go:309 CreateFromConfig →
    CreateFromKeys :387): the named predicate/priority sets REPLACE the
    default plugin sets; priority weights carry over; extenders append."""
    if policy.get("kind") not in (None, "Policy"):
        raise ValueError(f"not a Policy: {policy.get('kind')}")
    filters: List[str] = []
    for pr in policy.get("predicates", []):
        name = pr["name"] if isinstance(pr, dict) else pr
        mapped = PREDICATE_TO_PLUGIN.get(name)
        if mapped is None:
            # factory.go CreateFromConfig errors on unknown names; silently
            # dropping a predicate would schedule onto ineligible nodes
            raise ValueError(f"invalid predicate name {name!r} in Policy")
        if mapped not in filters:
            filters.append(mapped)
    scores: List[str] = []
    weights: Dict[str, float] = {}
    for pr in policy.get("priorities", []):
        name = pr["name"] if isinstance(pr, dict) else pr
        w = float(pr.get("weight", 1)) if isinstance(pr, dict) else 1.0
        mapped = PRIORITY_TO_PLUGIN.get(name)
        if mapped is None:
            raise ValueError(f"invalid priority name {name!r} in Policy")
        if mapped not in scores:
            scores.append(mapped)
            weights[mapped] = w
    if policy.get("predicates") is not None:
        base = default_plugins()
        cfg.plugins = Plugins(
            filter=PluginSet(enabled=filters),
            score=(cfg.plugins or base).score,
        )
    if policy.get("priorities") is not None:
        base = cfg.plugins or default_plugins()
        cfg.plugins = Plugins(filter=base.filter,
                              score=PluginSet(enabled=scores))
        cfg.score_weights.update(weights)
    if policy.get("hardPodAffinitySymmetricWeight") is not None:
        cfg.hard_pod_affinity_symmetric_weight = int(
            policy["hardPodAffinitySymmetricWeight"])
    cfg.extenders = cfg.extenders + tuple(
        _parse_extender(e) for e in policy.get("extenders", []))


def _load_data(source) -> dict:
    if isinstance(source, dict):
        return source
    text = source
    if isinstance(source, str) and "\n" not in source and (
            source.endswith((".yaml", ".yml", ".json")) or "/" in source):
        with open(source) as f:
            text = f.read()
    try:
        return json.loads(text)
    except (json.JSONDecodeError, TypeError):
        import yaml

        out = yaml.safe_load(text)
        if not isinstance(out, dict):
            raise ValueError("config did not parse to a mapping")
        return out
