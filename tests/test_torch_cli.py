"""The port's cluster and CLI (kubernetes_tpu_torch/cli/cluster.py and
kubectl.py), its proxy (proxy/proxier.py, proxy/healthcheck.py) and the
component-base cases beside them, held against the JAX package's.

tests/test_component_proxy_cli.py's cases, each run on both packages
(tests/test_torch_twin.py `mirror`): the reference's own assertions hold on
the port; every kubectl verb, rule-table lookup and rendering the case
made took the same arguments and returned the same value on both; and the
set of creates and Bindings the apiserver accepted from every thread (the
case's, kubectl's, the controllers', the hollow kubelets', the
scheduler's), with the deletes the case made, is the same on both
(WriteLog). All host code: equality is exact.

Two edits of the reference's source for the port: every scheduler runs on
the CPU (`device='cpu'` in each ClusterConfig and SchedulerServer; the
port's take the card by default), and `kubectl version` names the port's
server version, v1.17.0-torch.1, where the reference's names its own
(-tpu.1).

Beyond the mirror: `ClusterConfig.device` reaches every scheduler the
cluster builds, and a cluster with no card and no explicit CPU raises
before it starts anything.
"""

import importlib
from pathlib import Path

import pytest
import torch
from test_torch_twin import mirror

KUBECTL_VERBS = ("get", "describe_cmd", "create", "apply", "patch_cmd",
                 "delete", "scale", "cordon", "drain", "label", "taint",
                 "diff", "explain", "rollout", "top", "api_resources",
                 "version")
RECORD = ([f"cli.kubectl.Kubectl.{v}" for v in KUBECTL_VERBS]
          + [f"proxy.proxier.RuleTable.{m}" for m in (
              "lookup", "render_iptables", "render_ipvs")]
          + ["cli.cluster.Cluster.upgrade_plan",
             "cli.cluster.Cluster.upgrade_apply"])

# a bootstrap token's random id and secret (the cluster's init mints one),
# and the build suffix of a version: the port's apiserver serves
# v1.17.0-torch.1 where the JAX package's serves v1.17.0-tpu.1
SCRUB = [(r"\b[0-9a-z]{6}\.[0-9a-z]{16}\b", "<token>"),
         (r"(bootstrap-token-|bootstrap:)[0-9a-z]{6}\b", r"\1<id>"),
         (r"-(tpu|torch)\.1\b", "-<build>.1")]

SUBS = [("SchedulerServer(client)", "SchedulerServer(client, device='cpu')"),
        ("ClusterConfig(hollow_nodes=",
         "ClusterConfig(device='cpu', hollow_nodes="),
        ('assert "tpu" in out.getvalue()', 'assert "torch" in out.getvalue()')]
# `kubectl rollout restart` stamps the clock into the pod template, so the
# restarted revision's pod-template-hash (its ReplicaSet's and pods' names)
# differs from run to run: that case compares the names less the hash
RESTART = ("TestKubectlAndCluster", "test_kubectl_rollout_lifecycle")

mirror(globals(), "test_component_proxy_cli", writes=True, record=RECORD,
       scrub=SCRUB, subs=SUBS,
       select=lambda cls, name: (cls, name) != RESTART)
mirror(globals(), "test_component_proxy_cli", writes=True, record=RECORD,
       scrub=SCRUB + [(r"\bweb-[0-9a-f]{10}\b", "web-<hash>")], subs=SUBS,
       select=lambda cls, name: (cls, name) == RESTART)


# --------------------------------------------------------------------- #
# the cluster's device
# --------------------------------------------------------------------- #

def test_cluster_runs_every_scheduler_on_its_device():
    """`up` and `upgrade_apply` both build the scheduler on
    ClusterConfig.device; the restarted one is a new SchedulerServer."""
    from kubernetes_tpu_torch.cli import Cluster, ClusterConfig

    with Cluster(ClusterConfig(device="cpu")) as cluster:
        first = cluster.scheduler
        assert first.scheduler.device == torch.device("cpu")
        out = cluster.upgrade_apply("v1.18.0")
        assert out["phases"][2] == "control-plane/scheduler"
        assert cluster.scheduler is not first
        assert cluster.scheduler.scheduler.device == torch.device("cpu")


def test_cluster_without_a_card_raises_before_it_starts(monkeypatch):
    """No card and no explicit CPU: `up` raises from resolve_device, and
    no apiserver, gateway or component was started."""
    from kubernetes_tpu_torch.cli import Cluster, ClusterConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cluster = Cluster(ClusterConfig(hollow_nodes=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cluster.up()
    assert (cluster.api, cluster.gateway, cluster.scheduler,
            cluster.manager, cluster.hollow) == (None,) * 5


@pytest.mark.parametrize("argv, device", [
    (["up"], None), (["up", "--device", "cpu"], "cpu")])
def test_cluster_main_device_flag(monkeypatch, argv, device):
    """`python -m kubernetes_tpu_torch.cli cluster up` takes the card
    unless --device names another."""
    cluster_mod = importlib.import_module("kubernetes_tpu_torch.cli.cluster")
    seen = []

    class Stop(Exception):
        pass

    def up(self):
        seen.append(self.config.device)
        raise Stop

    monkeypatch.setattr(cluster_mod.Cluster, "up", up)
    with pytest.raises(Stop):
        cluster_mod.cluster_main(argv)
    assert seen == [device]


# --------------------------------------------------------------------- #
# manifests without PyYAML
# --------------------------------------------------------------------- #

# ints, floats (with and without a signed exponent: 1e5 and 2E3 are
# strings to YAML 1.1), nulls, booleans, nested lists, NaN, non-ASCII text
JSON_DEPLOYMENT = {
    "apiVersion": "apps/v1", "kind": "Deployment",
    "metadata": {"name": "web", "namespace": "default",
                 "labels": {"app": "web", "tier": "frönt"},
                 "annotations": None},
    "spec": {"replicas": 3, "revisionHistoryLimit": 0,
             "selector": {"matchLabels": {"app": "web"}},
             "template": {
                 "metadata": {"labels": {"app": "web"}},
                 "spec": {"containers": [{
                     "name": "c", "image": "img:v1",
                     "args": [["a", 1, -0, 2.5], [], [None, True, False]],
                     "resources": {"requests": {"cpu": "100m",
                                                "memory": "64Mi"}}}],
                     "terminationGracePeriodSeconds": 30}}}}
NUMBERS = ('{"kind": "ConfigMap", "apiVersion": "v1", "metadata": {"name":'
           ' "n"}, "data": {}, "x": [1.5, -0.0, 1e5, 2E3, 1.5e+3, 1.0E-2, '
           '12345678901234567890, NaN, -Infinity, "\\u00e9\\/"]}')
MULTI_YAML = """apiVersion: v1
kind: ConfigMap
metadata: {name: a, namespace: default}
data: {k: "1", n: 2.0}
---
---
apiVersion: v1
kind: Service
metadata: {name: b}
spec:
  ports:
  - {port: 80, targetPort: 8080}
  selector: {app: b}
"""

NO_YAML_CHILD = r"""
import importlib.abc, json, pickle, sys


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "yaml":
            raise ImportError(f"refused: {name}")
        return None


sys.meta_path.insert(0, Refuse())
from kubernetes_tpu_torch.cli.kubectl import Kubectl

k = Kubectl(None)
out = {}
for path in json.loads(sys.argv[1]):
    try:
        out[path] = ("docs", k._load_manifests(path))
    except ImportError as e:
        out[path] = ("ImportError", str(e))
out["yaml imported"] = "yaml" in sys.modules
sys.stdout.buffer.write(pickle.dumps(out))
"""


def _manifests(tmp_path):
    import json

    files = {
        "deploy.json": json.dumps(JSON_DEPLOYMENT),
        "deploy-indented.json": json.dumps(JSON_DEPLOYMENT, indent=2,
                                           ensure_ascii=False),
        "numbers.json": NUMBERS,
        "list.json": json.dumps([JSON_DEPLOYMENT, None, {}]),
        "multi.yaml": MULTI_YAML,
    }
    paths = {}
    for name, text in files.items():
        paths[name] = str(tmp_path / name)
        (tmp_path / name).write_text(text)
    return paths


def test_json_manifests_load_as_the_jax_package_loads_them_without_pyyaml(
        tmp_path):
    """Each JSON manifest gives, in a port process where PyYAML cannot be
    imported, exactly the documents the JAX package's kubectl reads with
    `yaml.safe_load_all` (types included: YAML 1.1 reads 1e5 as a string);
    the YAML file raises ImportError naming PyYAML there, and loads as the
    JAX package's where PyYAML is present."""
    import json
    import pickle
    import subprocess
    import sys

    from kubernetes_tpu.cli.kubectl import Kubectl as JKubectl
    from kubernetes_tpu_torch.cli.kubectl import Kubectl as TKubectl

    paths = _manifests(tmp_path)
    run = subprocess.run(
        [sys.executable, "-c", NO_YAML_CHILD, json.dumps(list(paths.values()))],
        cwd=str(Path(__file__).resolve().parent.parent),
        capture_output=True, timeout=120)
    assert run.returncode == 0, run.stderr.decode()[-3000:]
    got = pickle.loads(run.stdout)
    assert got.pop("yaml imported") is False
    ref = {p: JKubectl(None)._load_manifests(p) for p in paths.values()}
    for name, path in paths.items():
        if name.endswith(".json"):
            assert got[path] == ("docs", ref[path]), name
            # == alone does not tell 1 from 1.0 or True: repr shows the types
            assert repr(got[path][1]) == repr(ref[path]), name
        else:
            kind, msg = got[path]
            assert kind == "ImportError" and "PyYAML" in msg
            assert repr(TKubectl(None)._load_manifests(path)) == \
                repr(ref[path])
    assert len(ref[paths["multi.yaml"]]) == 2
    assert ref[paths["numbers.json"]][0]["x"][2:4] == ["1e5", "2E3"]


@pytest.mark.parametrize("seed", range(4))
def test_json_documents_equal_pyyaml_on_random_json(seed):
    """_json_documents against yaml.safe_load_all on random JSON texts
    (nested objects and lists, ints, floats in every JSON spelling, the
    three constants, strings with escapes and the characters PyYAML reads
    otherwise): wherever it answers, it answers PyYAML's documents, types
    included; it declines (None) every text that PyYAML reads otherwise."""
    import json
    import random

    import yaml

    from kubernetes_tpu_torch.cli.kubectl import _json_documents

    rng = random.Random(seed)
    alphabet = ("aZ09 _-.:/\\\"'#&*!|>%@`{}[],ü\u0085\t\x7f"
                " \U0001f600")

    def text():
        return "".join(rng.choice(alphabet) for _ in range(rng.randrange(6)))

    def number():
        return rng.choice([rng.randrange(-10 ** 20, 10 ** 20),
                           rng.uniform(-1e6, 1e6), 0.0, -0.0, 1e300,
                           float("inf"), float("nan"), rng.randrange(9)])

    def value(depth=0):
        c = rng.randrange(6 if depth < 4 else 3)
        if c == 0:
            return text()
        if c == 1:
            return number()
        if c == 2:
            return rng.choice([True, False, None])
        if c == 3:
            return [value(depth + 1) for _ in range(rng.randrange(4))]
        return {text(): value(depth + 1) for _ in range(rng.randrange(4))}

    answered = 0
    for _ in range(1500):
        src = json.dumps(value(), indent=rng.choice([None, 0, 2]),
                         ensure_ascii=rng.random() < 0.5)
        if rng.random() < 0.3:
            src = src.replace("1", rng.choice(["1e5", "1E+5", "1.5e-3"]), 1)
        try:
            ref = repr(list(yaml.safe_load_all(src)))
        except yaml.YAMLError:
            ref = None
        docs = _json_documents(src)
        if docs is not None:
            assert repr(docs) == ref, src
            answered += 1
    assert answered > 500
