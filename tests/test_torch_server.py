"""The scheduler process over the API on both packages: the port's
SchedulerServer (kubernetes_tpu_torch/sched/server.py, device="cpu") over
the port's apiserver and client, and the JAX package's over its own.

Each case runs on both sides with the same assertions:
tests/test_config.py's server cases (a config dict drives the live server;
disablePreemption round-trips), tests/test_preempt.py's victim deleted
through the API, tests/test_restart.py's apiserver cases (the fenced bind,
the two renew races, the kill → warm-standby takeover drill, the
consistency sweep healing an injected divergence, warm_standby being
read-only), and tests/test_explain.py's FailedScheduling events through the
real client and the /debug/why endpoint of TelemetryGateway. Last, one
200-node x 1,000-pod drain through chip_smoke.py's phase-11 script on
both packages: the (pod, node) maps the two apiservers hold are equal.

Every wait has a timeout and every server is stopped in `finally`; Lease
durations stay at or under 1.5 s.
"""

import importlib.util
import json
import threading
import time
import types as pytypes
import urllib.request
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
HOSTNAME = "kubernetes.io/hostname"


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _side(pkg: str):
    """One package's surface, under the same names on both sides."""
    import importlib

    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    types = m("api.types")
    ns = pytypes.SimpleNamespace(
        pkg=pkg, T=types,
        APIServer=m("apiserver").APIServer, Client=m("client").Client,
        LeaderElector=m("client").LeaderElector,
        LeaderElectionConfig=m("client").LeaderElectionConfig,
        RetryPolicy=m("client.rest").RetryPolicy,
        errors=m("machinery.errors"), meta=m("machinery.meta"),
        Ledger=m("sched.ledger").BindIntentLedger,
        ConsistencySweeper=m("sched.debugger").ConsistencySweeper,
        APIEventSink=m("sched.explain").APIEventSink,
        TelemetryGateway=m("sched.server").TelemetryGateway,
        RecordingBinder=m("sched.scheduler").RecordingBinder,
        Dims=m("state.dims").Dims, faultline=m("utils.faultline"),
        make_nodes=m("models.workloads").make_nodes,
        flagship_pods=m("models.workloads").flagship_pods,
        bucket=m("state.dims").bucket)
    server_cls = m("sched.server").SchedulerServer
    sched_cls = m("sched.scheduler").Scheduler
    if pkg == "kubernetes_tpu_torch":
        ns.server = lambda client, **kw: server_cls(client, device="cpu",
                                                    **kw)
        ns.scheduler = lambda **kw: sched_cls(device="cpu", **kw)
        ns.prewarm_kw = {"prewarm": True}
        ns.warmed = lambda pw: pw.warm      # signatures built ahead
    else:
        ns.server = server_cls
        ns.scheduler = lambda **kw: sched_cls(**kw)
        ns.prewarm_kw = {}
        ns.warmed = lambda pw: pw.compiled  # executables compiled ahead
    return ns


SIDES = {"jax": _side("kubernetes_tpu"), "port": _side("kubernetes_tpu_torch")}
side = pytest.fixture(params=["jax", "port"])(lambda request: SIDES[request.param])


@pytest.fixture(autouse=True)
def _clean_faultlines():
    yield
    for s in SIDES.values():
        s.faultline.uninstall()


def _until(cond, timeout, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


def mknode(S, name, cpu=4, mem="8Gi"):
    return S.T.Node(name=name, labels={HOSTNAME: name},
                    allocatable=S.T.Resources.make(cpu=cpu, memory=mem,
                                                   pods=110))


def mkpod(S, name, cpu="100m", mem="64Mi"):
    return S.T.Pod(name=name, requests=S.T.Resources.make(cpu=cpu,
                                                          memory=mem))


# --------------------------------------------------------------------- #
# tests/test_config.py
# --------------------------------------------------------------------- #

def test_scheduler_server_consumes_config(side):
    """A config dict drives the LIVE server: scheduler name, plugin set,
    queue backoff bounds, preemption toggle."""
    S = side
    api = S.APIServer()
    client = S.Client.local(api)
    try:
        srv = S.server(client, config={
            "kind": "KubeSchedulerConfiguration",
            "schedulerName": "cfg-sched",
            "disablePreemption": True,
            "podInitialBackoffSeconds": 3,
            "podMaxBackoffSeconds": 30,
            "plugins": {"score": {"disabled": ["ImageLocality"]}},
        })
        assert srv.scheduler.scheduler_name == "cfg-sched"
        assert srv.scheduler.queue.initial_backoff == 3
        assert srv.scheduler.queue.max_backoff == 30
        assert srv.scheduler.preemptor is None  # disablePreemption
        names = [type(p).__name__
                 for p in srv.scheduler.framework.score_plugins]
        assert "ImageLocality" not in names
        assert srv.config.effective_percentage_of_nodes_to_score(5000) == 10
    finally:
        api.close()


def test_disable_preemption_round_trips_into_server(side):
    """DisablePreemption defaults off, so the server installs a Preemptor
    evicting through the API; disablePreemption: true means it does not."""
    S = side
    api = S.APIServer()
    try:
        client = S.Client.local(api)
        default = S.server(client)
        assert default.scheduler.preemptor is not None
        assert type(default.scheduler.preemptor.evictor).__name__ == \
            "APIEvictor"
        on = S.server(client, config={
            "apiVersion": "kubescheduler.config.k8s.io/v1alpha1",
            "kind": "KubeSchedulerConfiguration"})
        assert on.scheduler.preemptor is not None
        off = S.server(client, config={
            "apiVersion": "kubescheduler.config.k8s.io/v1alpha1",
            "kind": "KubeSchedulerConfiguration",
            "disablePreemption": True})
        assert off.scheduler.preemptor is None
    finally:
        api.close()


def test_port_server_needs_the_card_unless_asked_for_the_cpu():
    """The port's SchedulerServer builds its Scheduler on the card: with no
    GPU and no explicit CPU it raises; a caller-built Scheduler keeps its
    own device."""
    import torch

    from kubernetes_tpu_torch.sched.server import SchedulerServer

    S = SIDES["port"]
    api = S.APIServer()
    try:
        client = S.Client.local(api)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                SchedulerServer(client)
        own = S.scheduler(binder=None)
        srv = SchedulerServer(client, scheduler=own)
        assert srv.scheduler is own and own.device.type == "cpu"
        assert type(own.binder).__name__ == "APIBinder"
    finally:
        api.close()


# --------------------------------------------------------------------- #
# tests/test_preempt.py:341
# --------------------------------------------------------------------- #

def test_server_preemption_deletes_victim_through_api(side):
    """The SchedulerServer's preemptor evicts THROUGH THE API: the victim
    is gone from the apiserver, not just from the scheduler's cache."""
    S = side
    api = S.APIServer()
    client = S.Client.local(api)
    caps = {"capacity": {"cpu": "4", "memory": "8Gi", "pods": "10"},
            "allocatable": {"cpu": "4", "memory": "8Gi", "pods": "10"}}
    client.nodes.create({"apiVersion": "v1", "kind": "Node",
                         "metadata": {"name": "only",
                                      "labels": {"pin": "y"}},
                         "status": caps})
    server = S.server(client, cycle_interval=0.02, batch_window=0.02).start()
    try:
        client.pods.create({
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "squatter", "namespace": "default"},
            "spec": {"nodeName": "only", "priority": 0,
                     "containers": [{"name": "c", "image": "i",
                                     "resources": {"requests": {
                                         "cpu": "3500m",
                                         "memory": "6Gi"}}}]}})
        assert _until(lambda: server.scheduler.cache.get_pod(
            "default/squatter") is not None, 10)
        client.pods.create({
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "vip", "namespace": "default"},
            "spec": {"priority": 1000, "nodeSelector": {"pin": "y"},
                     "containers": [{"name": "c", "image": "i",
                                     "resources": {"requests": {
                                         "cpu": "3", "memory": "4Gi"}}}]}})
        assert _until(lambda: client.pods.get("vip").get(
            "spec", {}).get("nodeName"), 60, step=0.1)
        assert client.pods.get("vip")["spec"]["nodeName"] == "only"
        with pytest.raises(S.errors.StatusError) as ei:
            client.pods.get("squatter")
        assert S.errors.is_not_found(ei.value)
        assert server.scheduler.preemptor.evictor.evicted == \
            ["default/squatter"]
    finally:
        server.stop()
        api.close()


# --------------------------------------------------------------------- #
# tests/test_restart.py: fencing (leader election + apiserver)
# --------------------------------------------------------------------- #

def _force_claim(S, client, name, holder="b"):
    """Stomp the Lease as a usurping holder, retrying the CAS until OUR
    write lands."""
    for _ in range(50):
        lease = client.leases.get(name, "kube-system")
        lease["spec"]["holderIdentity"] = holder
        lease["spec"]["renewTime"] = time.time() + 3600
        lease["spec"]["leaseDurationSeconds"] = 3600
        lease["spec"]["leaseTransitions"] = \
            int(lease["spec"].get("leaseTransitions", 0)) + 1
        try:
            client.leases.update(lease, "kube-system")
            return
        except S.errors.StatusError as e:
            if not S.errors.is_conflict(e):
                raise
    raise AssertionError("could not land the usurper's claim in 50 tries")


def test_stale_token_bind_rejected_by_apiserver(side):
    """After a leadership transition bumps the Lease generation, a Binding
    stamped with the OLD token is rejected with 409; the new token's
    Binding lands; an unstamped one passes."""
    S = side
    T = S.T
    api = S.APIServer()
    client = S.Client.local(api)
    a = b = None
    try:
        cfg = dict(lock_name="kube-scheduler", lease_duration=1.0,
                   renew_deadline=0.8, retry_period=0.1)
        a = S.LeaderElector(client, S.LeaderElectionConfig(identity="a",
                                                           **cfg))
        a.start()
        assert a.wait_for_leadership(5)
        token_a = a.fencing_token
        a.crash()
        b = S.LeaderElector(client, S.LeaderElectionConfig(identity="b",
                                                           **cfg))
        b.start()
        assert b.wait_for_leadership(10)
        assert b.fencing_token > token_a
        for i in range(2):
            client.pods.create({
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": f"f-{i}", "namespace": "default"},
                "spec": {"containers": [{"name": "c", "image": "i"}]}})
        client.nodes.create({"apiVersion": "v1", "kind": "Node",
                             "metadata": {"name": "n0"}})
        stale = {T.FENCING_TOKEN_ANNOTATION: str(token_a),
                 T.FENCING_LEASE_ANNOTATION: T.DEFAULT_FENCING_LEASE}
        with pytest.raises(S.errors.StatusError) as ei:
            client.pods.bind("f-0", "n0", "default", annotations=stale)
        assert ei.value.code == 409 and "fencing token" in str(ei.value)
        assert not client.pods.get("f-0").get("spec", {}).get("nodeName")
        live = {T.FENCING_TOKEN_ANNOTATION: str(b.fencing_token),
                T.FENCING_LEASE_ANNOTATION: T.DEFAULT_FENCING_LEASE}
        client.pods.bind("f-1", "n0", "default", annotations=live)
        assert client.pods.get("f-1")["spec"]["nodeName"] == "n0"
        client.pods.bind("f-0", "n0", "default")
    finally:
        if b is not None:
            b.stop()
        api.close()


def test_renew_cas_conflict_deposes_immediately(side):
    """A CAS conflict during renew IS leadership loss: the holder drops out
    within ~one retry period, not at the renew deadline."""
    S = side

    class ConflictOnce:
        def __init__(self, inner):
            self._inner = inner
            self.armed = False
            self.fired = False

        def get(self, *a, **k):
            return self._inner.get(*a, **k)

        def create(self, *a, **k):
            return self._inner.create(*a, **k)

        def update(self, *a, **k):
            if self.armed and not self.fired:
                self.fired = True
                raise S.errors.new_conflict(
                    "leases", "depose-drill",
                    "the object has been modified (simulated concurrent "
                    "writer winning the CAS race)")
            return self._inner.update(*a, **k)

    api = S.APIServer()
    client = S.Client.local(api)
    a = None
    try:
        proxy = ConflictOnce(client.leases)
        client.leases = proxy
        stopped = threading.Event()
        a = S.LeaderElector(client, S.LeaderElectionConfig(
            identity="a", lock_name="depose-drill", lease_duration=60.0,
            renew_deadline=30.0, retry_period=0.05,
            on_stopped_leading=stopped.set))
        a.start()
        assert a.wait_for_leadership(5)
        proxy.armed = True
        assert stopped.wait(10.0), (
            "holder kept leading after a renew CAS conflict")
        assert proxy.fired
    finally:
        if a is not None:
            a.stop()
        api.close()


def test_observed_live_usurper_deposes_immediately(side):
    """The lease record names another live holder: the same immediate
    deposition, and the usurper's live lease blocks re-acquisition."""
    S = side
    api = S.APIServer()
    client = S.Client.local(api)
    a = None
    try:
        stopped = threading.Event()
        a = S.LeaderElector(client, S.LeaderElectionConfig(
            identity="a", lock_name="usurp-drill", lease_duration=60.0,
            renew_deadline=30.0, retry_period=0.05,
            on_stopped_leading=stopped.set))
        a.start()
        assert a.wait_for_leadership(5)
        _force_claim(S, client, "usurp-drill")
        assert stopped.wait(10.0), (
            "holder kept leading after observing a live usurper")
        assert not a.is_leader
    finally:
        if a is not None:
            a.stop()
        api.close()


# --------------------------------------------------------------------- #
# tests/test_restart.py: the kill → warm-standby takeover drill
# --------------------------------------------------------------------- #

def test_kill_takeover_drill_end_to_end(side):
    """Two SchedulerServers over one apiserver: A leads, a kill takes it
    down after its Bindings and before the intent retires, B's warm standby
    takes over, reconciles the orphaned intent and drains the backlog:
    every pod bound exactly once, no intent left, and the consistency
    sweep on the survivor finds nothing to heal."""
    S = side
    n_pods = 24
    api = S.APIServer()
    client_a = S.Client.local(api)
    client_b = S.Client.local(api)
    lease_cfg = dict(lease_duration=1.5, renew_deadline=1.0,
                     retry_period=0.1)
    caps = {"capacity": {"cpu": "16", "memory": "64Gi", "pods": "110"},
            "allocatable": {"cpu": "16", "memory": "64Gi", "pods": "110"}}
    a = b = None
    try:
        for i in range(4):
            client_a.nodes.create({"apiVersion": "v1", "kind": "Node",
                                   "metadata": {"name": f"n{i}"},
                                   "status": caps})
        a = S.server(client_a, leader_elect=True, cycle_interval=0.02,
                     ledger=S.Ledger(api.storage, identity="a"),
                     lease_config=dict(identity="a", **lease_cfg),
                     standby_warm_interval=0.2).start()
        assert a.elector.wait_for_leadership(10)
        b = S.server(client_b, leader_elect=True, cycle_interval=0.02,
                     ledger=S.Ledger(api.storage, identity="b"),
                     lease_config=dict(identity="b", **lease_cfg),
                     standby_warm_interval=0.2).start()
        # the kill: after the leader's first Bindings, before its intent
        # retires
        S.faultline.install("proc.crash@post_bind:1")
        for i in range(n_pods):
            client_a.pods.create({
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": f"d-{i}", "namespace": "default"},
                "spec": {"containers": [{
                    "name": "c", "image": "i",
                    "resources": {"requests": {"cpu": "100m",
                                               "memory": "64Mi"}}}]}})

        def bound():
            return {p["metadata"]["name"]: p["spec"]["nodeName"]
                    for p in client_b.pods.list("default")["items"]
                    if p.get("spec", {}).get("nodeName")}

        assert _until(lambda: S.faultline.active().fired("proc.crash") > 0,
                      60), "the leader never reached post_bind"
        S.faultline.uninstall()
        a.crash()
        assert bound(), "the leader bound nothing before its kill"
        assert len(a.scheduler.ledger.unretired()) >= 1
        assert b.elector.wait_for_leadership(30), "standby never took over"
        assert _until(lambda: len(bound()) == n_pods, 120, step=0.1), (
            f"lost pods: {n_pods - len(bound())} after takeover")
        assert _until(lambda: b.takeovers > 0, 15), (
            f"recovery never ran: {b.last_recovery_error!r}")
        assert b.last_recovery is not None
        assert b.last_recovery.replayed_intents >= 1
        assert _until(lambda: b.scheduler.ledger.unretired() == [], 15)
        sweeper = S.ConsistencySweeper(b.scheduler, client_b)
        found = sweeper.sweep()
        assert sweeper.sweeps == 1
        assert all(v == 0 for v in found.values()), found
    finally:
        if a is not None:
            a.crash()
        if b is not None:
            b.stop()
        api.close()


def test_consistency_sweep_heals_injected_divergence(side):
    """The sweep detects a cache/apiserver divergence (a node the cache
    lost, a phantom pod), heals from apiserver truth and forces the next
    snapshot onto the full re-encode path."""
    S = side
    api = S.APIServer()
    client = S.Client.local(api)
    try:
        s = S.scheduler(binder=S.RecordingBinder(),
                        base_dims=S.Dims(N=16, P=16, E=64))
        caps = {"capacity": {"cpu": "4", "memory": "8Gi", "pods": "110"},
                "allocatable": {"cpu": "4", "memory": "8Gi", "pods": "110"}}
        for i in range(3):
            client.nodes.create({"apiVersion": "v1", "kind": "Node",
                                 "metadata": {"name": f"n{i}"},
                                 "status": caps})
            s.on_node_add(mknode(S, f"n{i}"))
        snap_kw = {"device": s.device} if S.pkg.endswith("torch") else {}
        s.cache.snapshot(s.encoder, [], s.base_dims, **snap_kw)
        s.cache.remove_node("n2")
        phantom = mkpod(S, "phantom")
        phantom.node_name = "n0"
        s.cache.add_pod(phantom)
        sweeper = S.ConsistencySweeper(s, client, log=lambda *_: None)
        found = sweeper.sweep()
        assert found["nodes_missing"] == 1
        assert found["pods_stale"] == 1
        assert sweeper.heals == 1
        assert {n.name for n in s.cache.nodes()} == {"n0", "n1", "n2"}
        assert s.cache.get_pod("default/phantom") is None
        s.cache.snapshot(s.encoder, [], s.base_dims, **snap_kw)
        assert s.cache.last_snapshot_mode == "full"
        found2 = sweeper.sweep()
        assert all(v == 0 for v in found2.values())
        assert sweeper.heals == 1
    finally:
        api.close()


def test_warm_standby_compiles_without_touching_state(side):
    """warm_standby keeps the snapshot (and, where it has one, the compiled
    program) hot but never pops, assumes or binds."""
    S = side
    binder = S.RecordingBinder()
    s = S.scheduler(binder=binder, base_dims=S.Dims(N=16, P=16, E=64),
                    **S.prewarm_kw)
    s.prewarmer.min_axis = 1
    for i in range(4):
        s.on_node_add(mknode(S, f"n{i}"))
    for i in range(8):
        s.on_pod_add(mkpod(S, f"p{i}"))
    before = s.queue.lengths()
    s.warm_standby()
    s.prewarmer.wait(timeout=120)
    assert s.queue.lengths() == before
    assert binder.bound == []
    assert s.cache.counts()[2] == 0
    assert len(S.warmed(s.prewarmer)) >= 1
    stats = s.schedule_pending()
    assert stats.scheduled == 8


# --------------------------------------------------------------------- #
# tests/test_explain.py: events through the real client, /debug/why
# --------------------------------------------------------------------- #

def _explain_scheduler(S, monkeypatch, clk):
    monkeypatch.setenv("KTPU_EXPLAIN", "1")
    s = S.scheduler(binder=S.RecordingBinder(), batch_size=64,
                    clock=lambda: clk["t"])
    s.prewarmer.enabled = False
    for n in S.make_nodes(8):
        s.on_node_add(n)
    return s


def _unfit(S):
    return S.T.Pod(name="p0", requests=S.T.Resources.make(
        cpu="99999", memory="16Mi"), creation_index=0)


def test_failed_scheduling_event_flow_and_dedupe(side, monkeypatch):
    S = side
    api = S.APIServer()
    client = S.Client.local(api)
    try:
        clk = {"t": 0.0}
        s = _explain_scheduler(S, monkeypatch, clk)
        s.explainer.sink = S.APIEventSink(client, component="test-sched")
        s.on_pod_add(_unfit(S))
        verdicts = 0
        for _ in range(9):
            st = s.schedule_pending()
            verdicts += st.unschedulable
            clk["t"] += 61.0
            s.queue.move_all_to_active(clk["t"])
            s.queue.pump(clk["t"])
        assert verdicts == 9
        evs = client.events.list("default")["items"]
        failed = [e for e in evs if e["reason"] == "FailedScheduling"]
        assert len(failed) == 1
        ev = failed[0]
        assert ev["count"] == 4
        assert ev["message"].startswith(
            "0/8 nodes are available: 8 Insufficient resources")
        assert ev["involvedObject"]["name"] == "p0"
        assert s.explainer.events_deduped == 9 - 4
    finally:
        api.close()


def test_events_store_is_ttl_bounded(side):
    S = side
    api = S.APIServer()
    client = S.Client.local(api)
    try:
        client.events.create({
            "apiVersion": "v1", "kind": "Event",
            "metadata": {"name": "old-ev", "namespace": "default"},
            "reason": "FailedScheduling", "message": "old",
            "lastTimestamp": "2000-01-01T00:00:00Z", "count": 1,
        }, "default")
        client.events.create({
            "apiVersion": "v1", "kind": "Event",
            "metadata": {"name": "fresh-ev", "namespace": "default"},
            "reason": "FailedScheduling", "message": "fresh", "count": 1,
        }, "default")
        names = [e["metadata"]["name"]
                 for e in client.events.list("default")["items"]]
        assert "fresh-ev" in names and "old-ev" not in names
        with pytest.raises(S.errors.StatusError) as ei:
            client.events.get("old-ev", "default")
        assert ei.value.code == 404
        # a pod with an ancient creationTimestamp is not TTL-swept
        client.pods.create({
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "ancient",
                         "creationTimestamp": "2000-01-01T00:00:00Z"},
            "spec": {"containers": [{"name": "c", "image": "i"}]},
        }, "default")
        assert client.pods.get("ancient", "default")
    finally:
        api.close()


def test_parse_rfc3339_offsets(side):
    parse = side.meta.parse_rfc3339
    base = parse("2026-08-04T12:00:00Z")
    assert base is not None
    assert parse("2026-08-04T12:00:00+05:00") == base - 5 * 3600
    assert parse("2026-08-04T12:00:00-02:30") == base + 2 * 3600 + 30 * 60
    assert parse("2026-08-04T12:00:00.123Z") == base
    assert parse("garbage") is None
    assert parse(None) is None


def test_sink_retry_budget_absorbs_pushback(side, monkeypatch):
    S = side
    api = S.APIServer()
    client = S.Client.local(api)
    try:
        calls = {"n": 0}
        real_create = client.events.create

        def flaky(body, ns):
            calls["n"] += 1
            if calls["n"] == 1:
                raise S.errors.new_too_many_requests("busy",
                                                     retry_seconds=0)
            return real_create(body, ns)

        sink = S.APIEventSink(client, retry=S.RetryPolicy(
            attempts=2, base_s=0.0, cap_s=0.0, deadline_s=5.0))
        monkeypatch.setattr(client.events, "create", flaky)
        assert sink.emit("default", "p0", "FailedScheduling", "msg", "fp")
        assert calls["n"] == 2
        assert sink.writes == 1 and sink.errors == 0
    finally:
        api.close()


def test_debug_why_endpoint_serves_attribution_and_queue_state(
        side, monkeypatch):
    S = side
    clk = {"t": 0.0}
    s = _explain_scheduler(S, monkeypatch, clk)
    s.on_pod_add(_unfit(S))
    clk["t"] = 5.0
    s.schedule_pending()
    gw = S.TelemetryGateway(s.telemetry, scheduler=s).start()
    try:
        clk["t"] = 7.0
        with urllib.request.urlopen(gw.url + "/debug/why/default/p0",
                                    timeout=10) as r:
            doc = json.loads(r.read())
        assert doc["pod"] == "default/p0"
        assert doc["explain_enabled"] is True
        assert doc["queue_lane"] == "unschedulable"
        assert doc["attempts"] == 1
        assert doc["first_seen_age_s"] == pytest.approx(7.0)
        att = doc["attribution"]
        assert att["reasons"] == {"fit": 8}
        assert att["message"].startswith("0/8 nodes are available")
        with pytest.raises(Exception) as ei:
            urllib.request.urlopen(gw.url + "/debug/why/default/ghost",
                                   timeout=10)
        assert getattr(ei.value, "code", None) == 404
        with urllib.request.urlopen(gw.url + "/metrics", timeout=10) as r:
            assert b"scheduler_" in r.read()
    finally:
        gw.stop()


# --------------------------------------------------------------------- #
# one drain through the API on both packages
# --------------------------------------------------------------------- #

def test_server_drain_matches_jax(monkeypatch):
    """chip_smoke.py's phase-11 script (server_drain, each wave behind its
    wave barrier) at 200 nodes x 1,000 flagship pods on both packages: the
    (pod, node) map each apiserver holds, the first wave's placements and
    the per-wave counts are equal. Without the barrier the retry wave's
    pods and placements depend on how many of the first wave's Binding
    confirmations the informer has delivered when it starts (ROADMAP §C)."""
    import torch

    monkeypatch.setenv("KTPU_OVERLOAD", "0")
    cs = _load("chip_smoke", "chip_smoke.py")
    ref = _load("flagship_reference", "scripts/flagship_reference.py")
    out = {}
    for name, api in (("jax", ref.jax_server_api()),
                      ("port", cs.port_server_api(torch.device("cpu")))):
        out[name] = cs.server_drain(api, 200, 1000)
    keys = ("pods", "bound", "bound_sha256", "first_wave_sha256", "waves")
    assert {k: out["port"][k] for k in keys} == \
        {k: out["jax"][k] for k in keys}
    assert out["port"]["bound"] == 1000


def _retry_wave(S, confirmed: float, later: float):
    """The 200 x 1,000 drain's two waves on one Scheduler and a still
    clock: the first wave, then `confirmed` of its Bindings confirmed
    (on_pod_update with the assumed pod itself), the failed pods moved
    back, the clock `later` seconds on, the second wave. Returns (first
    wave's count, second wave's count, second wave's sorted map)."""
    import dataclasses

    t = [0.0]
    s = S.scheduler(binder=S.RecordingBinder(), clock=lambda: t[0],
                    base_dims=S.Dims(N=S.bucket(200), P=4096,
                                     E=S.bucket(1000 + 256)))
    s.prewarmer.enabled = False
    for n in S.make_nodes(200):
        s.on_node_add(n)
    for i, p in enumerate(S.flagship_pods(1000)):
        s.on_pod_add(dataclasses.replace(p, creation_index=i + 1))
    first = s.schedule_pending()
    keys = sorted(first.assignments)
    for key in keys[:int(len(keys) * confirmed)]:
        pod = s.cache.get_pod(key)
        s.on_pod_update(pod, pod)
    s.queue.move_all_to_active(t[0])
    t[0] += later
    second = s.schedule_pending()
    return first.scheduled, second.scheduled, sorted(second.assignments.items())


def test_assumed_pod_weighs_as_a_confirmed_one(side):
    """Within the assume TTL a pod still assumed counts as a bound one (as
    in upstream's NodeInfo): with all, half or none of the first wave's
    680 Bindings confirmed, the second wave places the same 320 pods on
    the same nodes. Past the TTL (30 s, durationToExpireAssumedPod) the
    unconfirmed pods leave the cache (cleanupAssumedPods), and the failed
    pods lose the zone-affinity targets they wait for."""
    every = _retry_wave(side, 1.0, 2.0)
    assert every[:2] == (680, 320)
    assert _retry_wave(side, 0.5, 2.0) == every
    assert _retry_wave(side, 0.0, 2.0) == every
    assert _retry_wave(side, 0.0, 31.0)[1] == 0
