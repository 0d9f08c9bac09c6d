"""The port's volume machinery (kubernetes_tpu_torch/volume/: the PV binder
controller, the scheduler's volume binder, attachable-volume names), the
volume expansion controller's two event orders (ROADMAP §C, C3), and the
volume binder on the port's APIBinder, held against the JAX package's.

No JAX test file drives the binder or the PV controller, so one API script
runs on both packages here: a static PV pinned to a node by name, bound to
its claim by the PV controller; a WaitForFirstConsumer claim bound to the
PV of the node the scheduler chose, at the pod's bind; a zone conflict in
which the volume binder refuses the bind and the Scheduler rolls back its
assume; a claim no PV matches, which stays Pending and makes its pod wait.
Every call into the binder, the PV controller and the APIBinder returns the
same on both (resourceVersions and uids left out: the scheduler's event
writes interleave), and so does the set of writes the apiserver accepted. All host
code: equality is exact.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import pytest
from test_torch_twin import PACKAGES, Recorder, WriteLog, first_difference

GI = 1024 * 1024  # KiB


def wait_for(cond, timeout=30.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def mods(side: str):
    pkg = PACKAGES[side]
    return {m: importlib.import_module(f"{pkg}.{m}") for m in (
        "apiserver", "client", "controllers.autoscale", "api.types",
        "api.v1", "volume", "volume.binder", "volume.pv_controller",
        "volume.names", "sched.scheduler", "sched.server", "state.dims")}


def pv(name, size="1Gi", cls="", node=None, zone=None):
    spec = {"capacity": {"storage": size}, "accessModes": ["ReadWriteOnce"]}
    if cls:
        spec["storageClassName"] = cls
    terms = []
    if node is not None:
        terms.append({"matchFields": [{"key": "metadata.name",
                                       "operator": "In", "values": [node]}]})
    if zone is not None:
        terms.append({"matchExpressions": [{
            "key": "topology.kubernetes.io/zone", "operator": "In",
            "values": [zone]}]})
    if terms:
        spec["nodeAffinity"] = {"required": {"nodeSelectorTerms": terms}}
    return {"apiVersion": "v1", "kind": "PersistentVolume",
            "metadata": {"name": name}, "spec": spec}


def pvc(name, size="1Gi", cls="", volume="", status=None):
    spec = {"accessModes": ["ReadWriteOnce"],
            "resources": {"requests": {"storage": size}}}
    if cls:
        spec["storageClassName"] = cls
    if volume:
        spec["volumeName"] = volume
    obj = {"apiVersion": "v1", "kind": "PersistentVolumeClaim",
           "metadata": {"name": name, "namespace": "default"}, "spec": spec}
    if status is not None:
        obj["status"] = status
    return obj


def pod(name, claim, node_selector=None):
    spec = {"containers": [{"name": "c", "image": "pause", "resources": {
                "requests": {"cpu": "100m", "memory": "64Mi"}}}],
            "volumes": [{"name": "v",
                         "persistentVolumeClaim": {"claimName": claim}}]}
    if node_selector:
        spec["nodeSelector"] = node_selector
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "default"}, "spec": spec}


def node(name, zone):
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": {
                "kubernetes.io/hostname": name,
                "topology.kubernetes.io/zone": zone}},
            "status": {"capacity": {"cpu": "8", "memory": "16Gi",
                                    "pods": "110"},
                       "allocatable": {"cpu": "8", "memory": "16Gi",
                                       "pods": "110"}}}


# --------------------------------------------------------------------- #
# C3: the expansion controller whichever event arrives first
# --------------------------------------------------------------------- #


def expansion(side: str, pv_first: bool, workers: bool):
    """One drive of VolumeExpansionController on `side`: a 1Gi PV and a
    claim bound to it asking for 2Gi (its status still 1Gi). With
    `pv_first` the PV is in the controller's lister before the claim
    exists; without, the claim is synced while the PV is absent, and the
    PV is created only then. `workers` runs the controller's own workers
    (the requeue path); without, the script calls sync itself, once before
    the PV exists and once after, as a requeue would. Returns the writes,
    the PV's and the claim's final sizes (KiB) and how the first sync
    ended."""
    m = mods(side)
    api = m["apiserver"].APIServer()
    client = m["client"].Client.local(api)
    factory = m["client"].InformerFactory(client)
    c = m["controllers.autoscale"].VolumeExpansionController(client, factory)
    parse = m["api.types"].parse_mem_kib
    out = {}
    try:
        with WriteLog(PACKAGES[side]) as wlog:
            factory.start()
            factory.wait_for_sync()

            def pv_size():
                return parse(client.persistentvolumes.get("pv1")["spec"]
                             ["capacity"]["storage"])

            def claim_size():
                return parse(client.persistentvolumeclaims.get(
                    "c1", "default")["status"]["capacity"]["storage"])

            if pv_first:
                client.persistentvolumes.create(pv("pv1"))
                assert wait_for(lambda: c.pv_informer.lister.get(
                    None, "pv1") is not None)
            if workers:
                c.start()
            client.persistentvolumeclaims.create(pvc(
                "c1", "2Gi", volume="pv1",
                status={"capacity": {"storage": "1Gi"}}))
            assert wait_for(lambda: c.pvc_informer.lister.get(
                "default", "c1") is not None)
            if not pv_first:
                if workers:
                    # the claim's first sync ran: the reference wrote the
                    # grown status, the port requeued the claim
                    assert wait_for(lambda: claim_size() == 2 * GI
                                    or c.sync_errors)
                else:
                    try:
                        c.sync("default/c1")
                        out["first_sync"] = "returned"
                    except Exception as e:  # noqa: BLE001
                        out["first_sync"] = type(e).__name__
                    assert wait_for(lambda: c.pvc_informer.lister.get(
                        "default", "c1")["status"]["capacity"]["storage"]
                        == client.persistentvolumeclaims.get(
                            "c1", "default")["status"]["capacity"]["storage"])
                client.persistentvolumes.create(pv("pv1"))
                assert wait_for(lambda: c.pv_informer.lister.get(
                    None, "pv1") is not None)
                if not workers:
                    c.sync("default/c1")
            if workers:
                # the port's requeue reaches the PV within its rate limiter's
                # backoff; the reference's claim is never synced again, so
                # a short wait shows that its PV stays as it is
                wait_for(lambda: pv_size() == 2 * GI and
                         claim_size() == 2 * GI,
                         timeout=30 if side == "port" or pv_first else 2)
            else:
                c.sync("default/c1")
            out["pv_kib"], out["claim_kib"] = pv_size(), claim_size()
    finally:
        c.stop()
        factory.stop()
        api.close()
    out["writes"] = wlog.keys
    return out


@pytest.mark.parametrize("workers", [False, True], ids=["sync", "workers"])
def test_expansion_pv_in_lister_first_equal_on_both(workers):
    """The PV reaches the lister before the claim: both packages grow the PV
    and the claim's status to 2Gi, with the same writes."""
    jax, port = (expansion(side, pv_first=True, workers=workers)
                 for side in ("jax", "port"))
    assert port == jax
    assert (port["pv_kib"], port["claim_kib"]) == (2 * GI, 2 * GI)


@pytest.mark.parametrize("workers", [False, True], ids=["sync", "workers"])
def test_expansion_claim_event_before_pv_event(workers):
    """The claim is synced while its PV is not in the lister (C3). The port
    requeues the claim, writes nothing, and grows the PV once it arrives.
    The reference writes the claim's grown status at once and never grows
    the PV: it stays at 1Gi, which is why the reference's own test of this
    controller is load-sensitive."""
    jax = expansion("jax", pv_first=False, workers=workers)
    port = expansion("port", pv_first=False, workers=workers)
    assert (port["pv_kib"], port["claim_kib"]) == (2 * GI, 2 * GI)
    assert (jax["pv_kib"], jax["claim_kib"]) == (1 * GI, 2 * GI)
    if not workers:
        assert jax["first_sync"] == "returned"
        assert port["first_sync"] == "PVNotSynced"


# --------------------------------------------------------------------- #
# the PV controller and the scheduler's volume binder on one API script
# --------------------------------------------------------------------- #

VOLUME_RECORD = ["volume.pv_controller.PersistentVolumeController.sync",
                 "volume.binder.SchedulerVolumeBinder.decide",
                 "volume.binder.SchedulerVolumeBinder.bind",
                 "sched.server.APIBinder.bind"]
PODS = {"p-static": ("c-static", {"kubernetes.io/hostname": "n-a"}),
        "p-wffc": ("c-wffc", {"topology.kubernetes.io/zone": "b"}),
        "p-conflict": ("c-conflict", {"topology.kubernetes.io/zone": "b"}),
        "p-none": ("c-none", None)}


def volume_script(side: str) -> dict:
    """The script of this file's docstring on `side`'s package, the
    scheduler on the CPU. Returns the recorded calls, the writes, the
    Scheduler's wave stats and the final PVs, claims and pods."""
    m = mods(side)
    api = m["apiserver"].APIServer()
    client = m["client"].Client.local(api)
    factory = m["client"].InformerFactory(client)
    ctl = m["volume.pv_controller"].PersistentVolumeController(client,
                                                                factory)
    informers = {"persistentvolumes": ctl.pv_informer,
                 "persistentvolumeclaims": ctl.pvc_informer,
                 "storageclasses": ctl.sc_informer,
                 "nodes": factory.informer("nodes")}

    def settle():
        """Until every lister holds what the apiserver holds."""
        def same(attr, inf):
            want = {(o["metadata"].get("namespace", ""), o["metadata"]["name"]):
                    o["metadata"]["resourceVersion"]
                    for o in getattr(client, attr).list("")["items"]}
            have = {(o["metadata"].get("namespace", ""), o["metadata"]["name"]):
                    o["metadata"]["resourceVersion"]
                    for o in inf.lister.list()}
            return want == have
        assert wait_for(lambda: all(same(a, i) for a, i in informers.items()))

    vb = m["volume.binder"].SchedulerVolumeBinder(
        client, ctl.pvc_informer.lister, ctl.pv_informer.lister,
        ctl.sc_informer.lister, informers["nodes"].lister)

    def lookup(ns, name):
        try:
            return client.pods.get(name, ns)
        except Exception:  # noqa: BLE001 - NotFound
            return None

    kw = {"device": "cpu"} if side == "port" else {}
    s = m["sched.scheduler"].Scheduler(
        binder=m["sched.server"].APIBinder(client, volume_binder=vb,
                                           pod_lookup=lookup),
        base_dims=m["state.dims"].Dims(N=16, P=16, E=64), batch_size=8,
        **kw)
    out = {}
    try:
        with WriteLog(PACKAGES[side]) as wlog, \
                Recorder(PACKAGES[side], VOLUME_RECORD,
                         drop=("resourceVersion", "uid")) as rec:
            factory.start()
            factory.wait_for_sync()
            for n in (node("n-a", "a"), node("n-b", "b")):
                client.nodes.create(n)
            client.storageclasses.create({
                "apiVersion": "storage.k8s.io/v1", "kind": "StorageClass",
                "metadata": {"name": "wffc"},
                "provisioner": "kubernetes.io/no-provisioner",
                "volumeBindingMode": "WaitForFirstConsumer"})
            for v in (pv("pv-static", "5Gi", node="n-a"),
                      pv("pv-wffc-a", "2Gi", cls="wffc", zone="a"),
                      pv("pv-wffc-b", "2Gi", cls="wffc", zone="b"),
                      pv("pv-big-a", "4Gi", cls="wffc", zone="a")):
                client.persistentvolumes.create(v)
            for c in (pvc("c-static", "1Gi"), pvc("c-wffc", "1Gi", "wffc"),
                      pvc("c-conflict", "3Gi", "wffc"),
                      pvc("c-none", "100Gi")):
                client.persistentvolumeclaims.create(c)
            for name, (claim, sel) in PODS.items():
                client.pods.create(pod(name, claim, sel))
            settle()
            for name in ("c-static", "c-wffc", "c-conflict", "c-none"):
                ctl.sync(f"default/{name}")
            settle()
            out["decisions"] = {name: rec.norm(vb.decide(client.pods.get(
                name, "default"))) for name in PODS}
            for n in client.nodes.list("")["items"]:
                s.on_node_add(m["api.v1"].node_from_v1(n))
            for p in client.pods.list("default")["items"]:
                s.on_pod_add(m["api.v1"].pod_from_v1(p))
            st = s.schedule_pending()
            out["wave"] = dict(attempted=st.attempted,
                               scheduled=st.scheduled,
                               bind_errors=st.bind_errors,
                               assignments=dict(st.assignments))
            out["assumed"] = sorted(k for k in (f"default/{n}" for n in PODS)
                                    if s.cache.is_assumed(k))
            out["pvs"] = rec.norm(sorted(
                client.persistentvolumes.list("")["items"],
                key=lambda o: o["metadata"]["name"]))
            out["claims"] = rec.norm(sorted(
                client.persistentvolumeclaims.list("default")["items"],
                key=lambda o: o["metadata"]["name"]))
            out["pods"] = {p["metadata"]["name"]: p["spec"].get("nodeName")
                           for p in client.pods.list("default")["items"]}
    finally:
        factory.stop()
        api.close()
    out["calls"], out["writes"] = rec.calls, wlog.keys
    return out


@pytest.fixture(scope="module")
def volume_runs():
    return {side: volume_script(side) for side in ("jax", "port")}


def test_volume_script_calls_equal(volume_runs):
    jax, port = volume_runs["jax"]["calls"], volume_runs["port"]["calls"]
    assert port == jax, first_difference(jax, port)
    # SchedulerVolumeBinder.bind runs inside APIBinder.bind, whose answer
    # and writes carry its outcome (the Recorder keeps outermost calls)
    assert {c[0] for c in port} == set(VOLUME_RECORD) - {
        "volume.binder.SchedulerVolumeBinder.bind"}


@pytest.mark.parametrize("part", ["decisions", "wave", "assumed", "pvs",
                                  "claims", "pods", "writes"])
def test_volume_script_outcome_equal(volume_runs, part):
    assert volume_runs["port"][part] == volume_runs["jax"][part]


def test_volume_script_outcome(volume_runs):
    """What the script is for, on the port: the static claim bound by the PV
    controller and its pod on the PV's node; the WFFC claim bound at the
    pod's bind to the PV of the chosen zone; the conflicting and the
    unmatched claims refused at the bind, their pods rolled back (not bound,
    not assumed) and their claims left Pending."""
    out = volume_runs["port"]
    assert out["pods"] == {"p-static": "n-a", "p-wffc": "n-b",
                           "p-conflict": None, "p-none": None}
    assert out["wave"]["scheduled"] == 2 and out["wave"]["bind_errors"] == 2
    # the bound pods stay assumed until the informer confirms them
    assert out["assumed"] == ["default/p-static", "default/p-wffc"]
    claims = {c["metadata"]["name"]: c for c in out["claims"]}
    assert claims["c-static"]["spec"]["volumeName"] == "pv-static"
    assert claims["c-wffc"]["spec"]["volumeName"] == "pv-wffc-b"
    for name in ("c-conflict", "c-none"):
        assert claims[name].get("status", {}).get("phase",
                                                  "Pending") == "Pending"
    assert out["decisions"]["p-none"][1]["wait"] is True
    assert out["decisions"]["p-wffc"][1]["allowed_nodes"] == \
        sorted(repr(n) for n in ("n-a", "n-b"))


# --------------------------------------------------------------------- #
# the pure helpers on seeded inputs, and the packages' exports
# --------------------------------------------------------------------- #


def random_volume_pairs(seed: int, n: int = 200):
    """Seeded PVs and claims over the fields pv_matches_claim reads."""
    rng = np.random.default_rng(seed)
    classes, modes = ["", "fast", "slow"], ["ReadWriteOnce", "ReadOnlyMany",
                                             "ReadWriteMany"]
    sizes = ["500Mi", "1Gi", "1536Mi", "2Gi", "10Gi", "1000M", "1G"]
    out = []
    for i in range(n):
        v = pv(f"pv{i}", str(rng.choice(sizes)), str(rng.choice(classes)))
        v["spec"]["accessModes"] = sorted({str(m) for m in rng.choice(
            modes, size=int(rng.integers(1, 3)))})
        if rng.random() < 0.2:
            v["status"] = {"phase": str(rng.choice(["Bound", "Released",
                                                    "Available"]))}
        if rng.random() < 0.1:
            v["spec"]["claimRef"] = {"name": "other"}
        c = pvc(f"c{i}", str(rng.choice(sizes)), str(rng.choice(classes)))
        c["spec"]["accessModes"] = [str(rng.choice(modes))]
        out.append((v, c))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_pv_matches_claim_seeded(seed):
    j = mods("jax")["volume.pv_controller"]
    t = mods("port")["volume.pv_controller"]
    pairs = random_volume_pairs(seed)
    got = [t.pv_matches_claim(v, c) for v, c in pairs]
    assert got == [j.pv_matches_claim(v, c) for v, c in pairs]
    assert 0 < sum(got) < len(got)


@pytest.mark.parametrize("seed", range(2))
def test_attachable_volume_ids_seeded(seed):
    rng = np.random.default_rng(seed)
    kinds = ["gcePersistentDisk", "awsElasticBlockStore", "rbd", "iscsi",
             "csi", "emptyDir", "hostPath", "configMap"]
    j = mods("jax")["volume.names"]
    t = mods("port")["volume.names"]
    for i in range(100):
        vols = []
        for k in rng.choice(kinds, size=int(rng.integers(0, 4))):
            src = {str(rng.choice(["pdName", "volumeID", "volumeHandle",
                                   "other"])): f"d{rng.integers(9)}"}
            vols.append({"name": f"v{rng.integers(9)}", str(k): src})
        p = {"spec": {"volumes": vols}}
        assert t.attachable_volume_ids(p) == j.attachable_volume_ids(p)


@pytest.mark.parametrize("package", ["controllers", "volume", "kubelet",
                                     "kubemark"])
def test_package_exports_match(package):
    j = importlib.import_module(f"kubernetes_tpu.{package}")
    t = importlib.import_module(f"kubernetes_tpu_torch.{package}")
    assert t.__all__ == j.__all__
    for name in t.__all__:
        obj, ref = getattr(t, name), getattr(j, name)
        if callable(obj):  # the port's own class or function
            assert obj.__module__.startswith("kubernetes_tpu_torch.")
        elif isinstance(obj, dict):  # a registry: the same names
            assert list(obj) == list(ref)
        else:  # a constant: the same value
            assert obj == ref
