"""Exactly-once binding across scheduler crash/restart on the port
(kubernetes_tpu_torch/sched/ledger.py), held against the JAX package's
ledger (kubernetes_tpu/sched/ledger.py).

tests/test_restart.py's drills that need only a Storage, on the port's
Scheduler(device="cpu"): the kill matrix at pre_intent / post_intent /
post_bind (each also run on the JAX package's Scheduler, the two
RecoveryReports compared field by field, and the binders' logs equal), the
crash during takeover, the apiserver-death matrix over the JAX package's
WAL-backed Storage, release on no-fit, drop on delete, the skip of newer
tokens, the crash requeue landing in exactly one lane, and warm_standby
being read-only; tests/test_microwave.py's crash in a micro commit; and a
takeover across packages both ways — a JAX leader crashes at post_intent
and the port recovers, and the other way round — over one shared store.

Each package has its own fault switchboard (utils/faultline.py): a crash is
installed on the side that must die. The ledger takes its storage by
injection, so the port's runs over its own store and over the JAX
package's (in memory and WAL-backed).
"""

import dataclasses

import pytest

import kubernetes_tpu.api.types as JT
import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu.sched.ledger import BindIntentLedger as JLedger
from kubernetes_tpu.sched.scheduler import Scheduler as JScheduler
from kubernetes_tpu.state.dims import Dims as JDims
from kubernetes_tpu.storage.native import PyKV as JPyKV
from kubernetes_tpu.storage.store import Storage as JStorage
from kubernetes_tpu.utils import faultline as jfaultline
from kubernetes_tpu_torch.sched.ledger import BindIntentLedger as TLedger
from kubernetes_tpu_torch.sched.ledger import INTENT_PREFIX
from kubernetes_tpu_torch.sched.scheduler import RecordingBinder as TBinder
from kubernetes_tpu_torch.sched.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.state.dims import Dims as TDims
from kubernetes_tpu_torch.storage.store import Storage as TStorage
from kubernetes_tpu_torch.utils import faultline as tfaultline

pytestmark = pytest.mark.chaos

HOSTNAME = "kubernetes.io/hostname"
N_NODES = 4
N_PODS = 12

SIDES = {
    "jax": dict(T=JT, Scheduler=JScheduler, Ledger=JLedger, Dims=JDims,
                faultline=jfaultline, kw={}),
    "port": dict(T=TT, Scheduler=TScheduler, Ledger=TLedger, Dims=TDims,
                 faultline=tfaultline, kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _clean_faultlines():
    yield
    jfaultline.uninstall()
    tfaultline.uninstall()


def mknode(T, name, cpu=4, mem="8Gi"):
    return T.Node(name=name, labels={HOSTNAME: name},
                  allocatable=T.Resources.make(cpu=cpu, memory=mem,
                                               pods=110))


def mkpod(T, name, cpu="100m", mem="64Mi", **kw):
    return T.Pod(name=name, requests=T.Resources.make(cpu=cpu, memory=mem),
                 **kw)


def open_store(kind, tmp_path=None):
    if kind == "port":
        return TStorage()
    if kind == "jax":
        return JStorage(kv=JPyKV())
    return JStorage(data_dir=str(tmp_path / "etcd"), durability="always")


def close_store(st):
    if isinstance(st, JStorage):
        st.close()


class DurableBinder:
    """The Binding registry a crash cannot erase: binds survive process
    death, and — like the apiserver's already-assigned guard — a second
    bind of the same pod is REFUSED and counted."""

    def __init__(self):
        self.bound = {}            # pod key → node name
        self.double_bind_attempts = 0
        self.bind_log = []         # every accepted (key, node), in order

    def bind(self, pod, node_name):
        if pod.key in self.bound:
            self.double_bind_attempts += 1
            return False
        self.bound[pod.key] = node_name
        self.bind_log.append((pod.key, node_name))
        return True


class Cluster:
    """One durable store + Binding registry + informer truth, shared by
    every scheduler incarnation of a drill — of either package. Pods are
    kept as specs and built in the booting side's own types."""

    def __init__(self, store="port", n_nodes=N_NODES, n_pods=N_PODS,
                 tmp_path=None):
        self.kind, self.tmp_path = store, tmp_path
        self.storage = open_store(store, tmp_path)
        self.binder = DurableBinder()
        self.node_specs = [(f"n{i}", 4, "8Gi") for i in range(n_nodes)]
        # pod key → (name, cpu, mem, node_name preset)
        self.pod_specs = {f"default/p{i}": (f"p{i}", "100m", "64Mi", "")
                          for i in range(n_pods)}

    def reboot_storage(self):
        """The apiserver process is dead: quiesce its pump and recover a
        new store from the WAL on disk."""
        self.storage._stop.set()
        self.storage = open_store(self.kind, self.tmp_path)
        return self.storage

    def close(self):
        close_store(self.storage)

    def pod(self, side, key):
        name, cpu, mem, node = self.pod_specs[key]
        p = mkpod(SIDES[side]["T"], name, cpu=cpu, mem=mem)
        return dataclasses.replace(p, node_name=node) if node else p

    def lookup(self, side):
        """Informer truth in `side`'s types: the pod with its COMMITTED
        node, or None if deleted."""
        def look(key):
            if key not in self.pod_specs:
                return None
            pod = self.pod(side, key)
            node = self.binder.bound.get(key, "")
            return dataclasses.replace(pod, node_name=node) if node else pod
        return look

    def boot(self, side="port", **kw):
        """One scheduler incarnation of `side`: fresh in-memory state,
        informers replayed from truth, a ledger over the shared storage."""
        S = SIDES[side]
        kw.setdefault("base_dims", S["Dims"](N=16, P=16, E=64))
        kw.setdefault("batch_size", 8)
        s = S["Scheduler"](binder=self.binder,
                           ledger=S["Ledger"](self.storage), **S["kw"], **kw)
        if side == "jax":
            s.prewarmer.enabled = False
        for name, cpu, mem in self.node_specs:
            s.on_node_add(mknode(S["T"], name, cpu=cpu, mem=mem))
        for key in self.pod_specs:
            pod = self.lookup(side)(key)
            s.on_pod_add(pod)
        return s

    def unretired(self):
        return TLedger(self.storage).unretired()

    def assert_exactly_once(self, s):
        """Every pod bound exactly once, zero refused double-binds, no
        unretired intents, snapshot generation converged."""
        assert len(self.binder.bound) == len(self.pod_specs), (
            f"lost pods: {set(self.pod_specs) - set(self.binder.bound)}")
        assert self.binder.double_bind_attempts == 0
        keys = [k for k, _ in self.binder.bind_log]
        assert len(set(keys)) == len(keys), "double-bound pods"
        assert s.ledger.unretired() == [], "unretired intents survived"
        dev = {"device": "cpu"} if isinstance(s, TScheduler) else {}
        snap1 = s.cache.snapshot(s.encoder, [], s.base_dims, **dev)
        snap2 = s.cache.snapshot(s.encoder, [], s.base_dims, **dev)
        assert snap2 is snap1 and s.cache.last_snapshot_mode == "cached"
        assert snap1.generation == s.cache.generation


def crash(side, spec, fn):
    fl = SIDES[side]["faultline"]
    fl.install(spec)
    try:
        with pytest.raises(fl.InjectedCrash):
            fn()
    finally:
        fl.uninstall()


# --------------------------------------------------------------------- #
# the kill matrix, both packages, reports compared field by field
# --------------------------------------------------------------------- #


def kill_and_restart(side, site, store):
    cluster = Cluster(store)
    try:
        s1 = cluster.boot(side)
        crash(side, f"proc.crash@{site}:1", s1.schedule_pending)
        left = len(cluster.unretired())
        bound_at_crash = len(cluster.binder.bound)
        s2 = cluster.boot(side)
        report = s2.recover(lookup=cluster.lookup(side))
        s2.run_until_idle()
        cluster.assert_exactly_once(s2)
        return (left, bound_at_crash, dataclasses.asdict(report),
                list(cluster.binder.bind_log))
    finally:
        cluster.close()


@pytest.mark.parametrize("store", ["port", "jax"])
@pytest.mark.parametrize("site,binds_before_crash,intents_left", [
    ("pre_intent", 0, 0),     # decided, nothing durable yet
    ("post_intent", 0, 1),    # intent durable, no Binding committed
    ("post_bind", "all", 1),  # Bindings committed, intent unretired
])
def test_kill_matrix_restart_reconciles_exactly_once(
        site, binds_before_crash, intents_left, store):
    left, at_crash, report, log = kill_and_restart("port", site, store)
    assert left == intents_left
    if binds_before_crash == "all":
        assert at_crash > 0
    else:
        assert at_crash == binds_before_crash
    assert report["replayed_intents"] == intents_left
    if site == "post_bind":
        # informer truth showed every entry bound: retired, nothing re-bound
        assert report["already_bound"] > 0 and report["completed"] == 0
    ref = kill_and_restart("jax", site, "jax")
    assert (left, at_crash, report, log) == ref


def test_crash_during_takeover_second_successor_finishes():
    """The reconciler itself dies mid-replay: the intents it had not
    reached stay durable, and the NEXT successor's replay completes them."""
    cluster = Cluster()
    try:
        s1 = cluster.boot()
        crash("port", "proc.crash@post_intent:1", s1.schedule_pending)
        assert len(cluster.unretired()) == 1
        s2 = cluster.boot()
        crash("port", "proc.crash@takeover:1",
              lambda: s2.recover(lookup=cluster.lookup("port")))
        assert len(cluster.unretired()) == 1
        s3 = cluster.boot()
        report = s3.recover(lookup=cluster.lookup("port"))
        assert report.replayed_intents == 1
        s3.run_until_idle()
        cluster.assert_exactly_once(s3)
    finally:
        cluster.close()


# --------------------------------------------------------------------- #
# the apiserver-death matrix: the JAX package's WAL store dies mid-commit
# of the port's intent
# --------------------------------------------------------------------- #


@pytest.mark.durability
@pytest.mark.parametrize("site", [
    "wal:pre_fsync", "wal:post_fsync", "wal:post_append"])
def test_apiserver_death_matrix_reboot_reconciles(site, tmp_path):
    cluster = Cluster("wal", tmp_path=tmp_path)
    try:
        s1 = cluster.boot()
        # the WAL is the JAX package's code: its switchboard kills it
        crash("jax", f"proc.crash@{site}:1", s1.schedule_pending)
        assert len(cluster.binder.bound) == 0
        cluster.reboot_storage()
        assert cluster.storage.kv.recovered
        assert len(cluster.unretired()) == 1
        s2 = cluster.boot()
        report = s2.recover(lookup=cluster.lookup("port"))
        assert report.replayed_intents == 1
        s2.run_until_idle()
        cluster.assert_exactly_once(s2)
    finally:
        cluster.close()


@pytest.mark.durability
def test_double_kill_apiserver_then_takeover_crash(tmp_path):
    cluster = Cluster("wal", tmp_path=tmp_path)
    try:
        s1 = cluster.boot()
        crash("jax", "proc.crash@wal:post_append:1", s1.schedule_pending)
        cluster.reboot_storage()
        assert len(cluster.unretired()) == 1
        s2 = cluster.boot()
        crash("port", "proc.crash@takeover:1",
              lambda: s2.recover(lookup=cluster.lookup("port")))
        rev_before = cluster.storage.kv.rev()
        cluster.reboot_storage()
        assert cluster.storage.kv.rev() == rev_before
        assert len(cluster.unretired()) == 1
        s3 = cluster.boot()
        report = s3.recover(lookup=cluster.lookup("port"))
        assert report.replayed_intents == 1
        s3.run_until_idle()
        cluster.assert_exactly_once(s3)
    finally:
        cluster.close()


# --------------------------------------------------------------------- #
# the replay decision table
# --------------------------------------------------------------------- #


def test_replay_releases_when_node_no_longer_fits():
    """An intent whose chosen node was meanwhile filled RELEASES the pod
    to the active queue, and the next wave places it elsewhere."""
    cluster = Cluster(n_nodes=3, n_pods=2)
    try:
        s1 = cluster.boot()
        crash("port", "proc.crash@post_intent:1", s1.schedule_pending)
        intents = cluster.unretired()
        assert len(intents) == 1
        victim_nodes = set(intents[0].bindings.values())
        s2 = cluster.boot()
        for i, nn in enumerate(sorted(victim_nodes)):
            key = f"default/filler-{i}"
            cluster.pod_specs[key] = (f"filler-{i}", "3950m", "7Gi", nn)
            s2.on_pod_add(cluster.pod("port", key))
            cluster.binder.bound[key] = nn
            cluster.binder.bind_log.append((key, nn))
        report = s2.recover(lookup=cluster.lookup("port"))
        assert report.released == 2 and report.completed == 0
        for key in intents[0].bindings:
            assert s2.queue.lanes(key) == (True, False, False)
        s2.run_until_idle()
        cluster.assert_exactly_once(s2)
    finally:
        cluster.close()


def test_replay_drops_deleted_pods_and_skips_newer_tokens():
    cluster = Cluster(n_nodes=2, n_pods=2)
    try:
        s1 = cluster.boot()
        crash("port", "proc.crash@post_intent:1", s1.schedule_pending)
        cluster.pod_specs.clear()  # both pods deleted while down
        s2 = cluster.boot()
        # an intent from a NEWER leader: a stale reconciler must not touch it
        TLedger(cluster.storage).write_intent(
            cycle=99, token=10**6, bindings={"default/future": "n0"})
        report = s2.recover(lookup=cluster.lookup("port"))
        assert report.dropped == 2
        assert report.stale_skipped == 1
        left = cluster.unretired()
        assert len(left) == 1 and left[0].token == 10**6
    finally:
        cluster.close()


def test_crash_requeue_lands_in_exactly_one_lane():
    """A pod re-admitted from an unretired intent while ALSO parked in
    backoff ends up in exactly one lane — activeQ — with its attempt
    history preserved."""
    from kubernetes_tpu_torch.sched.queue import PriorityQueue

    q = PriorityQueue()
    pod = mkpod(TT, "dup")
    q.add(pod, now=0.0)
    q.pop_batch(8, now=0.0)
    q.move_all_to_active(now=0.0)
    q.add_unschedulable(pod, attempts=2, now=0.0)
    assert q.lanes(pod.key) == (False, True, False)
    assert q.requeue_recovered(pod, attempts=1, now=0.0) == "active"
    assert q.lanes(pod.key) == (True, False, False)
    batch = q.pop_batch(8, now=0.0)
    assert [(p.key, a) for p, a in batch] == [("default/dup", 3)]
    q.pump(now=100.0)
    assert q.lanes(pod.key) == (False, False, False)
    q.add(pod, now=100.0)
    q.requeue_recovered(pod, attempts=1, now=100.0)
    assert q.lanes(pod.key) == (True, False, False)
    assert len(q.pop_batch(8, now=100.0)) == 1
    q.add_unschedulable(pod, attempts=1, now=200.0)
    assert q.lanes(pod.key) == (False, False, True)
    q.requeue_recovered(pod, attempts=1, now=200.0)
    assert q.lanes(pod.key) == (True, False, False)


def test_warm_standby_warms_without_touching_state():
    """warm_standby keeps the snapshot resident and the signature warm but
    never pops, assumes or binds; the first led wave patches the resident
    snapshot."""
    binder = TBinder()
    s = TScheduler(binder=binder, base_dims=TDims(N=16, P=16, E=64),
                   device="cpu", prewarm=True)
    s.prewarmer.min_axis = 1  # allow the tiny test shape to warm
    for i in range(4):
        s.on_node_add(mknode(TT, f"n{i}"))
    for i in range(8):
        s.on_pod_add(mkpod(TT, f"p{i}"))
    before = s.queue.lengths()
    s.warm_standby()
    s.prewarmer.wait(timeout=120)
    assert s.queue.lengths() == before          # nothing popped
    assert binder.bound == []                   # nothing bound
    assert s.cache.counts()[2] == 0             # nothing assumed
    assert len(s.prewarmer.warm) >= 1           # the signature IS warm
    stats = s.schedule_pending()
    assert stats.scheduled == 8
    assert s.cache.last_snapshot_mode in ("patch", "cached")


def test_crash_mid_micro_commit_reconciles_exactly_once():
    """Ledger intents bracket micro commits exactly like bulk."""
    storage = TStorage()
    binder = DurableBinder()
    pod = mkpod(TT, "m0")

    def boot():
        s = TScheduler(binder=binder, ledger=TLedger(storage),
                       base_dims=TDims(N=16, P=16, E=64), batch_size=8,
                       microwave=True, device="cpu")
        for i in range(2):
            s.on_node_add(mknode(TT, f"n{i}"))
        bound = binder.bound.get(pod.key, "")
        s.on_pod_add(dataclasses.replace(pod, node_name=bound)
                     if bound else pod)
        return s

    def lookup(key):
        if key != pod.key:
            return None
        node = binder.bound.get(key, "")
        return dataclasses.replace(pod, node_name=node) if node else pod

    s1 = boot()
    crash("port", "proc.crash@post_intent:1", s1.schedule_pending)
    assert binder.bound == {}
    assert len(TLedger(storage).unretired()) == 1
    s2 = boot()
    report = s2.recover(lookup=lookup)
    assert report.replayed_intents == 1
    s2.run_until_idle()
    assert list(binder.bound) == [pod.key]
    assert binder.double_bind_attempts == 0
    assert s2.ledger.unretired() == []


# --------------------------------------------------------------------- #
# takeover across packages, and the records each writes
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("leader,successor,store", [
    ("jax", "port", "jax"),
    ("port", "jax", "port"),
])
def test_cross_package_takeover_is_exactly_once(leader, successor, store):
    """A leader of one package crashes at post_intent; a successor of the
    other reads its intent from the shared store, completes it, drains,
    and every pod is bound exactly once."""
    cluster = Cluster(store)
    try:
        s1 = cluster.boot(leader)
        crash(leader, "proc.crash@post_intent:1", s1.schedule_pending)
        intents = cluster.unretired()
        assert len(intents) == 1 and len(intents[0].bindings) == 8
        assert cluster.binder.bound == {}
        s2 = cluster.boot(successor)
        report = s2.recover(lookup=cluster.lookup(successor))
        assert report.replayed_intents == 1
        assert report.completed == 8 and report.released == 0
        assert dict(cluster.binder.bind_log) == intents[0].bindings
        s2.run_until_idle()
        cluster.assert_exactly_once(s2)
    finally:
        cluster.close()


def test_intent_records_match_the_jax_ledgers():
    """Both ledgers write the same record under the same key shape, and
    each reads the other's."""
    st = TStorage()
    t = TLedger(st, identity="me").write_intent(3, 5, {"default/a": "n0"})
    j = JLedger(st, identity="me").write_intent(3, 5, {"default/a": "n0"})
    for it in (t, j):
        assert it.key.startswith(INTENT_PREFIX + "default-scheduler/c00000003-")
    recs = {i.name: i for i in JLedger(st).unretired()}
    assert set(recs) == {t.name, j.name}
    strip = lambda i: (i.cycle, i.token, i.holder, i.bindings)
    assert strip(recs[t.name]) == strip(recs[j.name]) == (
        3, 5, "me", {"default/a": "n0"})
    body = lambda i: {k: v for k, v in st.get(i.key)["spec"].items()
                      if k != "writtenAt"}
    assert body(t) == body(j)
    assert TLedger(st).retire(j) and not TLedger(st).retire(j)
    assert [i.name for i in TLedger(st).unretired()] == [t.name]
