"""Parity of the port's configuration surface (kubernetes_tpu_torch/sched/
config.py: KubeSchedulerConfiguration, the legacy Policy, the plugin merge,
engine_config() lowered into the port's EngineConfig) with the JAX
package's (kubernetes_tpu/sched/config.py).

tests/test_config.py's fourteen cases that need no SchedulerServer run on
both packages (its two server cases wait for ROADMAP item 11b); where a case
drives a placement, the port's cycle and Scheduler run with device="cpu".
Then every case's loaded configuration is compared field by field across
the packages, the EngineConfig leaf by leaf as the same f32 values.
"""

import json
import logging

import numpy as np
import pytest

import kubernetes_tpu.api.types as JT
import kubernetes_tpu.sched.config as JCFG
import kubernetes_tpu_torch.api.types as TT
import kubernetes_tpu_torch.sched.config as TCFG
from kubernetes_tpu.sched import cycle as JC
from kubernetes_tpu.sched.scheduler import RecordingBinder as JBinder
from kubernetes_tpu.sched.scheduler import Scheduler as JScheduler
from kubernetes_tpu.state.cache import SchedulerCache as JCache
from kubernetes_tpu.state.encode import Encoder as JEncoder
from kubernetes_tpu_torch.sched import cycle as TC
from kubernetes_tpu_torch.sched.scheduler import RecordingBinder as TBinder
from kubernetes_tpu_torch.sched.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.state.cache import SchedulerCache as TCache
from kubernetes_tpu_torch.state.encode import Encoder as TEncoder
from torch_parity import as_np

SIDES = ("jax", "port")

YAML_CONFIG = """
apiVersion: kubescheduler.config.k8s.io/v1alpha1
kind: KubeSchedulerConfiguration
schedulerName: tpu-scheduler
disablePreemption: true
percentageOfNodesToScore: 70
hardPodAffinitySymmetricWeight: 3
podInitialBackoffSeconds: 2
podMaxBackoffSeconds: 20
leaderElection:
  leaderElect: true
featureGates:
  EvenPodsSpread: false
plugins:
  score:
    disabled:
      - ImageLocality
    enabled:
      - name: NodeResourcesMostAllocated
        weight: 5
  filter:
    disabled:
      - NodePorts
extenders:
  - urlPrefix: http://127.0.0.1:9998/scheduler
    filterVerb: filter
    prioritizeVerb: prioritize
    weight: 2
    nodeCacheCapable: true
    ignorable: true
pluginConfig:
  - name: NodeLabel
    args:
      present: ["zone"]
"""


def cfg_mod(side):
    return JCFG if side == "jax" else TCFG


def types(side):
    return JT if side == "jax" else TT


@pytest.mark.parametrize("side", SIDES)
def test_yaml_config_loads_fields(side):
    cfg = cfg_mod(side).load_config(YAML_CONFIG)
    assert cfg.scheduler_name == "tpu-scheduler"
    assert cfg.disable_preemption is True
    assert cfg.percentage_of_nodes_to_score == 70
    assert cfg.hard_pod_affinity_symmetric_weight == 3
    assert cfg.pod_initial_backoff_seconds == 2
    assert cfg.pod_max_backoff_seconds == 20
    assert cfg.leader_election.leader_elect is True
    assert cfg.feature_gates == {"EvenPodsSpread": False}
    assert cfg.plugin_config["NodeLabel"] == {"present": ["zone"]}
    assert len(cfg.extenders) == 1
    ext = cfg.extenders[0]
    assert ext.url_prefix.endswith(":9998/scheduler")
    assert ext.weight == 2 and ext.node_cache_capable and ext.ignorable


@pytest.mark.parametrize("side", SIDES)
def test_plugin_merge_semantics(side):
    cfg = cfg_mod(side).load_config(YAML_CONFIG)
    score = cfg.plugins.score.enabled
    assert "ImageLocality" not in score
    assert "NodeResourcesMostAllocated" in score
    assert "NodeResourcesLeastAllocated" in score
    assert "NodePorts" not in cfg.plugins.filter.enabled
    assert "NodeResourcesFit" in cfg.plugins.filter.enabled
    assert cfg.score_weights["NodeResourcesMostAllocated"] == 5.0


@pytest.mark.parametrize("side", SIDES)
def test_star_disable_clears_defaults(side):
    cfg = cfg_mod(side).load_config({
        "plugins": {"score": {"disabled": ["*"],
                              "enabled": ["NodeResourcesMostAllocated"]}}})
    assert cfg.plugins.score.enabled == ["NodeResourcesMostAllocated"]


@pytest.mark.parametrize("side", SIDES)
def test_percentage_of_nodes_to_score_adaptive_default(side):
    K = cfg_mod(side).KubeSchedulerConfiguration
    cfg = K()
    assert cfg.effective_percentage_of_nodes_to_score(50) == 100
    assert cfg.effective_percentage_of_nodes_to_score(1000) == 42
    assert cfg.effective_percentage_of_nodes_to_score(125 * 50) == 5
    explicit = K(percentage_of_nodes_to_score=70)
    assert explicit.effective_percentage_of_nodes_to_score(5000) == 70


@pytest.mark.parametrize("side", SIDES)
def test_percentage_of_nodes_to_score_warns_ignored(side, caplog):
    load = cfg_mod(side).load_config
    with caplog.at_level(logging.WARNING, logger="ktpu.sched.config"):
        load({"percentageOfNodesToScore": 70})
    assert any("IGNORED" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="ktpu.sched.config"):
        load({})
    assert not any("IGNORED" in r.message for r in caplog.records)


@pytest.mark.parametrize("side", SIDES)
def test_score_admission_window_flows_to_engine_config(side):
    load = cfg_mod(side).load_config
    assert float(load({}).engine_config().w_window) == 100.0
    cfg = load({"scoreAdmissionWindow": 0})
    assert cfg.score_admission_window == 0.0
    assert float(cfg.engine_config().w_window) == 0.0
    cfg = load({"scoreAdmissionWindow": 250,
                "plugins": {"score": {"enabled": ["ImageLocality"]}}})
    assert float(cfg.engine_config().w_window) == 250.0
    assert load({"scoreAdmissionWindow": -5}).score_admission_window == 100.0
    assert load({"scoreAdmissionWindow": float("nan")}) \
        .score_admission_window == 100.0


POLICY = {
    "kind": "Policy", "apiVersion": "v1",
    "predicates": [{"name": "PodFitsResources"},
                   {"name": "PodToleratesNodeTaints"},
                   {"name": "MatchInterPodAffinity"}],
    "priorities": [{"name": "LeastRequestedPriority", "weight": 2},
                   {"name": "SelectorSpreadPriority", "weight": 1}],
    "extenders": [{"urlPrefix": "http://e/x", "filterVerb": "f"}],
    "hardPodAffinitySymmetricWeight": 7,
}


@pytest.mark.parametrize("side", SIDES)
def test_policy_json_composition(side):
    cfg = cfg_mod(side).load_config({"policy": POLICY})
    assert cfg.plugins.filter.enabled == [
        "NodeResourcesFit", "TaintToleration", "InterPodAffinity"]
    assert cfg.plugins.score.enabled == [
        "NodeResourcesLeastAllocated", "SelectorSpread"]
    assert cfg.score_weights == {"NodeResourcesLeastAllocated": 2.0,
                                 "SelectorSpread": 1.0}
    assert cfg.hard_pod_affinity_symmetric_weight == 7
    assert cfg.extenders[0].url_prefix == "http://e/x"


@pytest.mark.parametrize("side", SIDES)
def test_policy_file_via_algorithm_source(side, tmp_path):
    pol = tmp_path / "policy.json"
    pol.write_text(json.dumps({
        "kind": "Policy", "predicates": [{"name": "HostName"}],
        "priorities": [{"name": "ImageLocalityPriority", "weight": 3}]}))
    cfg_file = tmp_path / "config.yaml"
    cfg_file.write_text(
        "kind: KubeSchedulerConfiguration\n"
        "algorithmSource:\n"
        "  policy:\n"
        f"    file:\n      path: {pol}\n")
    cfg = cfg_mod(side).load_config(str(cfg_file))
    assert cfg.plugins.filter.enabled == ["NodeName"]
    assert cfg.plugins.score.enabled == ["ImageLocality"]
    assert cfg.score_weights["ImageLocality"] == 3.0


@pytest.mark.parametrize("side", SIDES)
def test_name_tables_cover_reference_defaults(side):
    M = cfg_mod(side)
    for name in ("PodFitsResources", "PodFitsHostPorts", "HostName",
                 "MatchNodeSelector", "PodToleratesNodeTaints",
                 "CheckNodeUnschedulable", "MatchInterPodAffinity"):
        assert name in M.PREDICATE_TO_PLUGIN
    for name in ("LeastRequestedPriority", "BalancedResourceAllocation",
                 "SelectorSpreadPriority", "InterPodAffinityPriority",
                 "NodeAffinityPriority", "TaintTolerationPriority",
                 "ImageLocalityPriority", "NodePreferAvoidPodsPriority"):
        assert name in M.PRIORITY_TO_PLUGIN


@pytest.mark.parametrize("side", SIDES)
def test_build_framework_honors_config(side):
    fw = cfg_mod(side).load_config(YAML_CONFIG).build_framework()
    names = [type(p).__name__ for p in fw.score_plugins]
    assert "ImageLocality" not in names
    assert "NodeResourcesMostAllocated" in names


@pytest.mark.parametrize("side", SIDES)
def test_bad_kind_rejected(side):
    M = cfg_mod(side)
    with pytest.raises(ValueError):
        M.load_config({"kind": "Deployment"})
    with pytest.raises(ValueError):
        M.apply_policy(M.KubeSchedulerConfiguration(), {"kind": "NotAPolicy"})


def _placements(side, cfg_dict, nodes, existing, pending):
    """One cycle through the package's dispatch with the config's
    EngineConfig; node names per pending pod."""
    cache = JCache() if side == "jax" else TCache()
    for n in nodes:
        cache.add_node(n)
    for p in existing:
        cache.add_pod(p)
    cfg = cfg_mod(side).load_config(cfg_dict) if cfg_dict else None
    ecfg = cfg.engine_config() if cfg else None
    if side == "jax":
        snap, keys = JC.snapshot_with_keys(cache, JEncoder(), pending, None)
        res = JC._schedule_batch(snap.tables, snap.pending, keys, snap.dims.D,
                                 snap.existing,
                                 has_node_name=snap.dims.has_node_name,
                                 ecfg=ecfg)
    else:
        snap, keys = TC.snapshot_with_keys(cache, TEncoder(), pending, None,
                                           device="cpu")
        res = TC.schedule_batch(snap.tables, snap.pending, keys, snap.dims.D,
                                snap.existing,
                                has_node_name=snap.dims.has_node_name,
                                ecfg=ecfg)
    return [snap.node_order[i] if i >= 0 else None
            for i in as_np(res.node)[: len(pending)]]


@pytest.mark.parametrize("side", SIDES)
def test_engine_config_drives_fused_placement(side):
    """Disabling a filter plugin admits otherwise-blocked nodes; score
    weights flip spread (least-allocated) into packing (most-allocated)."""
    T = types(side)
    run = lambda *a: _placements(side, *a)  # noqa: E731
    tainted = T.Node(name="t0", taints=(T.Taint("gpu", "yes",
                                                T.TaintEffect.NO_SCHEDULE),),
                     allocatable=T.Resources.make(cpu="8", memory="16Gi",
                                                  pods=10))
    pod = T.Pod(name="p", requests=T.Resources.make(cpu="100m", memory="64Mi"))
    assert run(None, [tainted], [], [pod]) == [None]
    no_taints = {"plugins": {"filter": {"disabled": ["TaintToleration"]}}}
    assert run(no_taints, [tainted], [], [pod]) == ["t0"]
    n0, n1 = (T.Node(name=f"n{i}", allocatable=T.Resources.make(
        cpu="8", memory="16Gi", pods=20)) for i in range(2))
    heavy = T.Pod(name="h", requests=T.Resources.make(cpu="6", memory="12Gi"),
                  node_name="n0")
    assert run(None, [n0, n1], [heavy], [pod]) == ["n1"]
    packing = {"plugins": {"score": {
        "disabled": ["NodeResourcesLeastAllocated",
                     "NodeResourcesBalancedAllocation"],
        "enabled": [{"name": "NodeResourcesMostAllocated", "weight": 1}]}}}
    assert run(packing, [n0, n1], [heavy], [pod]) == ["n0"]


@pytest.mark.parametrize("side", SIDES)
def test_extra_score_plugin_reaches_fused_path(side):
    """NodeLabel (no fixed EngineConfig slot) shapes placement through the
    per-class bias; the caller interns its keys in the Scheduler's
    encoder, as the server wiring does."""
    T = types(side)
    cfg = cfg_mod(side).load_config({
        "kind": "KubeSchedulerConfiguration",
        "plugins": {"score": {"enabled": [{"name": "NodeLabel",
                                           "weight": 50}]}},
        "pluginConfig": [{"name": "NodeLabel", "args": {"present": ["ssd"]}}],
    })
    fw = cfg.build_framework()
    if side == "jax":
        s = JScheduler(binder=JBinder(), framework=fw)
        s.prewarmer.enabled = False
    else:
        s = TScheduler(binder=TBinder(), framework=fw, device="cpu")
    s.engine_config = cfg.engine_config()
    for pl in fw.score_plugins:
        if type(pl).__name__ == "NodeLabel":
            pl._present_ids = (s.encoder.vocabs.label_keys.intern("ssd"),)
    s.on_node_add(T.Node(name="plain", allocatable=T.Resources.make(
        cpu="4", memory="8Gi", pods=10)))
    s.on_node_add(T.Node(name="fast", labels={"ssd": "true"},
                         allocatable=T.Resources.make(cpu="4", memory="8Gi",
                                                      pods=10)))
    s.on_pod_add(T.Pod(name="p", requests=T.Resources.make(cpu="100m",
                                                           memory="64Mi")))
    assert s.schedule_pending().assignments.get("default/p") == "fast"


@pytest.mark.parametrize("side", SIDES)
def test_plugin_disable_reaches_engine_config(side):
    ec = cfg_mod(side).load_config({
        "apiVersion": "kubescheduler.config.k8s.io/v1alpha1",
        "kind": "KubeSchedulerConfiguration",
        "plugins": {"filter": {"disabled": [{"name": "NodePorts"}]},
                    "score": {"disabled": [{"name": "ImageLocality"}]}}}) \
        .engine_config()
    assert float(ec.f_ports) == 0.0
    assert float(ec.w_img) == 0.0
    assert float(ec.f_fit) == 1.0


# --------------------------------------------------------------------- #
# the loaded configurations, across the packages
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("source", [
    YAML_CONFIG, {"policy": POLICY}, {},
    {"scoreAdmissionWindow": 0.3, "hardPodAffinitySymmetricWeight": 4},
    {"plugins": {"score": {"disabled": ["*"], "enabled": [
        {"name": "NodeResourcesMostAllocated", "weight": 0.1},
        {"name": "RequestedToCapacityRatio", "weight": 1.0 / 3.0},
        {"name": "NodeLabel", "weight": 3},
        {"name": "SelectorSpread", "weight": 0.7}]},
        "filter": {"disabled": ["InterPodAffinity", "NodeVolumeLimits"]}},
     "pluginConfig": [{"name": "RequestedToCapacityRatio", "args": {
         "shape": [{"utilization": 0, "score": 0},
                   {"utilization": 50, "score": 80},
                   {"utilization": 100, "score": 100}]}}]},
])
def test_loaded_config_equals_jax(source):
    """Both loaders give the same configuration: every field, the plugin
    sets, the framework's plugins in order with their weights, and each
    EngineConfig leaf as the same f32 value (weights f32 cannot hold
    included)."""
    j, t = JCFG.load_config(source), TCFG.load_config(source)
    for f in ("scheduler_name", "hard_pod_affinity_symmetric_weight",
              "disable_preemption", "percentage_of_nodes_to_score",
              "score_admission_window", "plugin_config", "score_weights",
              "feature_gates", "bind_timeout_seconds",
              "pod_initial_backoff_seconds", "pod_max_backoff_seconds"):
        assert getattr(t, f) == getattr(j, f), f
    assert vars(t.leader_election) == vars(j.leader_election)
    assert [vars(e) for e in t.extenders] == [vars(e) for e in j.extenders]
    for point in ("filter", "score"):
        jp, tp = (getattr(c.plugins, point) if c.plugins else None
                  for c in (j, t))
        assert (vars(tp) if tp else None) == (vars(jp) if jp else None)
    jfw, tfw = j.build_framework(), t.build_framework()
    for pts in ("filter_plugins", "score_plugins", "permit_plugins"):
        assert [(type(p).__name__, getattr(p, "weight", None))
                for p in getattr(tfw, pts)] == \
            [(type(p).__name__, getattr(p, "weight", None))
             for p in getattr(jfw, pts)]
    je, te = j.engine_config(), t.engine_config()
    assert te._fields == je._fields
    for f in je._fields:
        assert np.float32(getattr(te, f)) == np.asarray(getattr(je, f),
                                                        np.float32), f
        assert getattr(te, f) == float(np.float32(getattr(te, f))), f
