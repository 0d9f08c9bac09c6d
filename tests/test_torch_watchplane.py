"""The fleet watch plane on the port: tests/test_watchplane.py's cases.

The watch channel, storage, informer and WatchMux classes run unchanged on
both packages (the JAX package's client machinery over its own in-process
apiserver, the port's over the port's): the port's copies of those layers
had no test of their watch-plane paths, and client/watchmux.py is new here.
TestFleetWatchPlane runs on the port's FleetServer (`device="cpu"`) and its
FleetWatchPlane.
"""

import importlib
import threading
import time

import pytest

PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")
PORT = "kubernetes_tpu_torch"

# the package under test, set by the `side` fixture for each test
PKG = PORT
mwatch = Storage = PyKV = faultline = None


def mod(name: str):
    return importlib.import_module(f"{PKG}.{name}")


@pytest.fixture
def side(request):
    """Point this module's names at one package's watch-plane layers."""
    global PKG, mwatch, Storage, PyKV, faultline
    PKG = request.param
    mwatch = mod("machinery.watch")
    Storage = mod("storage.store").Storage
    PyKV = (mod("storage.store") if PKG == PORT
            else mod("storage.native")).PyKV
    faultline = mod("utils.faultline")
    yield PKG
    faultline.uninstall()


def on(*packages):
    """Run a test class once per package in `packages`."""
    def wrap(cls):
        cls = pytest.mark.usefixtures("side")(cls)
        return pytest.mark.parametrize("side", packages, indirect=True)(cls)
    return wrap


def v1pod(name, tenant=None, ns="default", cpu="100m"):
    labels = {"ktpu.io/tenant": tenant} if tenant else {}
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns, "labels": labels},
            "spec": {"containers": [{"name": "c", "image": "i",
                     "resources": {"requests": {"cpu": cpu,
                                                "memory": "64Mi"}}}]}}


def v1node(name, tenant=None, cpu="8"):
    labels = {"kubernetes.io/hostname": name}
    if tenant:
        labels["ktpu.io/tenant"] = tenant
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": labels},
            "status": {"allocatable": {"cpu": cpu, "memory": "16Gi",
                                       "pods": "32"}}}


def wait_until(cond, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


# --------------------------------------------------------------------- #
# machinery/watch.py: the bounded channel's terminal-event contract
# --------------------------------------------------------------------- #


@on(*PACKAGES)
class TestWatchChannel:
    def test_terminal_delivered_after_drain(self):
        w = mwatch.Watch(capacity=8)
        for i in range(3):
            w.send(mwatch.Event(mwatch.ADDED, {"i": i}))
        w.terminate(mwatch.Event(mwatch.ERROR, {"code": 410}))
        got = [w.next(timeout=1) for _ in range(4)]
        assert [e.type for e in got[:3]] == [mwatch.ADDED] * 3
        assert got[3].type == mwatch.ERROR and got[3].object["code"] == 410
        assert w.next(timeout=0.1) is None  # terminal delivered exactly once

    def test_terminal_survives_full_buffer(self):
        w = mwatch.Watch(capacity=2)
        assert w.send(mwatch.Event(mwatch.ADDED, {"i": 0}), timeout=0)
        assert w.send(mwatch.Event(mwatch.ADDED, {"i": 1}), timeout=0)
        # the buffer is full: a plain send fails (and stops the watch) —
        # but terminate() can still leave the WHY
        assert not w.send(mwatch.Event(mwatch.ADDED, {"i": 2}), timeout=0)
        w.terminate(mwatch.Event(mwatch.ERROR, {"code": 410}))
        types = []
        for ev in w:
            types.append(ev.type)
        assert types == [mwatch.ADDED, mwatch.ADDED, mwatch.ERROR]

    def test_depth(self):
        w = mwatch.Watch(capacity=8)
        assert w.depth() == 0
        w.send(mwatch.Event(mwatch.ADDED, {}))
        assert w.depth() == 1


# --------------------------------------------------------------------- #
# storage: deaf-watcher eviction + bookmark-on-compaction
# --------------------------------------------------------------------- #


@on(*PACKAGES)
class TestStorageWatchPlane:
    @pytest.fixture
    def st(self, side):
        st = Storage(kv=PyKV(), bookmark_interval=3600)
        yield st
        st.close()

    def test_deaf_watcher_evicted_with_too_old(self, st):
        w = st.watch("/registry/pods/", buffer=4)
        for i in range(20):
            st.create(f"/registry/pods/default/p{i}",
                      {"metadata": {"name": f"p{i}"}})
        assert wait_until(lambda: w.stopped, 5), "deaf watcher not evicted"
        assert st.deaf_evictions >= 1
        # drain: buffered events, then the terminal too-old ERROR
        evs = []
        while True:
            ev = w.next(timeout=0.2)
            if ev is None:
                break
            evs.append(ev)
        assert evs, "buffered events lost"
        assert evs[-1].type == mwatch.ERROR
        assert evs[-1].object.get("code") == 410
        assert "too old" in evs[-1].object.get("message", "")

    def test_broadcast_survives_deaf_sibling(self, st):
        deaf = st.watch("/registry/pods/", buffer=4)
        live = st.watch("/registry/pods/", buffer=1024)
        got = []
        t = threading.Thread(
            target=lambda: [got.append(e) for e in live], daemon=True)
        t.start()
        for i in range(50):
            st.create(f"/registry/pods/default/q{i}",
                      {"metadata": {"name": f"q{i}"}})
        assert wait_until(lambda: len(got) >= 50, 10), \
            f"live watcher starved behind deaf sibling: {len(got)}/50"
        assert deaf.stopped and st.deaf_evictions >= 1
        live.stop()
        t.join(timeout=3)

    def test_compaction_boundary_bookmark(self, st):
        wb = st.watch("/registry/pods/", bookmarks=True)
        plain = st.watch("/registry/pods/")
        for i in range(5):
            st.create(f"/registry/pods/default/c{i}",
                      {"metadata": {"name": f"c{i}"}})
        assert wait_until(
            lambda: st._dispatched_rev >= st.kv.rev(), 5)
        for _ in range(5):  # drain the creates
            wb.next(timeout=1)
        st.compact_to(st.kv.rev())
        # the boundary bookmark arrives IMMEDIATELY (interval is 1 h here)
        ev = wb.next(timeout=2)
        assert ev is not None and ev.type == mwatch.BOOKMARK
        rv = int(ev.object["metadata"]["resourceVersion"])
        assert rv >= st.kv.compacted_rev(), \
            "bookmark beneath the compaction floor cannot fund a resume"
        assert st.compaction_bookmarks >= 1
        # non-opted-in watcher: events only, no bookmark frame
        for _ in range(5):
            plain.next(timeout=0.5)
        assert plain.next(timeout=0.3) is None
        wb.stop()
        plain.stop()

    def test_watch_compact_floor_seam(self, st):
        # persistent (2+): the seam compacts at the PUMP'S dispatched rev,
        # which lags the kv head by up to one iteration — a one-shot could
        # fire while nothing has been dispatched yet and compact at 0
        faultline.install("watch.compact@floor:2+")
        wb = st.watch("/registry/pods/", bookmarks=True)
        st.create("/registry/pods/default/x", {"metadata": {"name": "x"}})
        assert wait_until(lambda: st.kv.compacted_rev() > 0, 10), \
            "seam never compacted"
        assert wait_until(lambda: st.compaction_bookmarks >= 1, 10)
        wb.stop()

    def test_drop_watchers_emits_terminal_503(self, st):
        w = st.watch("/registry/pods/")
        n = st.drop_watchers()
        assert n == 1
        ev = w.next(timeout=1)
        assert ev is not None and ev.type == mwatch.ERROR
        assert ev.object.get("code") == 503

    def test_apiserver_watch_buffer_param(self):
        APIServer = mod("apiserver").APIServer

        api = APIServer(watch_buffer=7)
        try:
            assert api.storage._watch_buffer == 7
        finally:
            api.close()


# --------------------------------------------------------------------- #
# informer: resume vs relist discipline
# --------------------------------------------------------------------- #


def _mkapi():
    APIServer = mod("apiserver").APIServer
    Client = mod("client").Client

    api = APIServer()
    return api, Client.local(api)


@on(*PACKAGES)
class TestInformerResume:
    def test_restart_503_resumes_by_rv_not_relist(self):
        """The apiserver-restart seam emits a terminal
        ERROR Status, so informers resume from their resourceVersion —
        the blind-relist path (socket-EOF-only death) is gone."""
        SharedInformer = mod("client").SharedInformer

        api, client = _mkapi()
        inf = SharedInformer(client.pods, namespace="default",
                             relist_backoff=0.02).start()
        try:
            assert inf.wait_for_sync(10)
            assert inf.relists == 1
            client.pods.create(v1pod("before"))
            assert wait_until(lambda: len(inf.indexer) == 1, 10)
            api.storage.drop_watchers()
            client.pods.create(v1pod("after"))
            assert wait_until(lambda: len(inf.indexer) == 2, 10), \
                "informer never recovered from the restart"
            assert inf.relists == 1, \
                "restart cost a relist — the 503 resume path regressed"
            assert inf.resumes >= 1
        finally:
            inf.stop()
            api.close()

    def test_genuine_410_relists_exactly_once(self):
        SharedInformer = mod("client").SharedInformer
        WatchCache = mod("storage.cacher").WatchCache

        api, client = _mkapi()
        inf = SharedInformer(client.pods, namespace="default",
                             relist_backoff=0.02).start()
        try:
            assert inf.wait_for_sync(10)
            client.pods.create(v1pod("a"))
            assert wait_until(lambda: len(inf.indexer) == 1, 10)
            inf.stop()
            # while the informer is away: more writes, then a compaction
            # that buries its resume token beneath the floor (the cacher
            # ring is reset too, so there is no memory catch-up window)
            client.pods.create(v1pod("b"))
            st = api.storage
            st.compact_to(st.kv.rev())
            st.watch_cache = WatchCache(horizon=st.kv.rev())
            inf.start()
            assert wait_until(lambda: len(inf.indexer) == 2, 15), \
                "informer never converged after the 410"
            assert inf.relists == 2, \
                f"a genuine 410 must cost exactly one relist, saw " \
                f"{inf.relists - 1}"
        finally:
            inf.stop()
            api.close()

    def test_bookmark_funds_resume_on_quiet_stream(self, monkeypatch):
        """A quiet resource + compaction: the boundary bookmark advances
        the resume token, so a stream death later resumes cleanly —
        bookmark_resumes counts it."""
        SharedInformer = mod("client").SharedInformer

        api, client = _mkapi()
        inf = SharedInformer(client.nodes, relist_backoff=0.02).start()
        try:
            assert inf.wait_for_sync(10)
            client.nodes.create(v1node("n0"))
            assert wait_until(lambda: len(inf.indexer) == 1, 10)
            # churn another resource, then compact: nodes saw NOTHING —
            # only the boundary bookmark keeps its token above the floor
            for i in range(5):
                client.pods.create(v1pod(f"churn-{i}"))
            st = api.storage
            assert wait_until(lambda: st._dispatched_rev >= st.kv.rev(), 5)
            st.compact_to(st.kv.rev())
            assert wait_until(lambda: inf.bookmarks_seen >= 1, 5), \
                "no bookmark reached the informer"
            assert wait_until(
                lambda: inf.last_sync_rv
                and int(inf.last_sync_rv) >= st.kv.compacted_rev(), 5)
            # now the stream dies (restart seam): resume must succeed from
            # the bookmarked RV — no relist, and the resume is
            # bookmark-funded
            st.drop_watchers()
            client.nodes.create(v1node("n1"))
            assert wait_until(lambda: len(inf.indexer) == 2, 10)
            assert inf.relists == 1
            assert inf.bookmark_resumes >= 1
        finally:
            inf.stop()
            api.close()


class _StubRC:
    """Minimal ResourceClient stand-in for reflector-loop unit tests."""

    group = ""
    resource = "stubs"

    def __init__(self, list_fn=None, watch_fn=None):
        self.lists = 0
        self.watches = 0
        self._list_fn = list_fn
        self._watch_fn = watch_fn

    def list(self, *a, **k):
        self.lists += 1
        if self._list_fn is not None:
            return self._list_fn()
        return {"items": [], "metadata": {"resourceVersion": "1"}}

    def watch(self, *a, **k):
        self.watches += 1
        if self._watch_fn is not None:
            return self._watch_fn()
        w = mwatch.Watch(capacity=4)
        w.terminate(mwatch.Event(mwatch.ERROR, {"code": 410}))
        return w


@on(*PACKAGES)
class TestRelistBackoffFix:
    def test_successful_list_collapses_decayed_ladder(self):
        """A watch that dies right after a SUCCESSFUL list
        must not keep retrying at the decayed cap — every successful
        list+replace collapses the ladder to its first rung (the failure
        the backoff priced is over), while an instantly-410ing watch
        phase still can't drive relists at the raw base cadence."""
        SharedInformer = mod("client").SharedInformer

        rc = _StubRC()  # list OK, watch 410s instantly → relist loop
        inf = SharedInformer(rc, relist_backoff=0.01)
        inf.backoff.attempts = 7  # pretend we're deep in the ladder
        inf.start()
        try:
            assert wait_until(lambda: rc.lists >= 4, 10), \
                f"relist loop stalled at {rc.lists} rounds (decayed-cap " \
                f"retry bug)"
            assert inf.backoff.attempts <= 2, \
                "backoff ladder not collapsed by the successful list"
        finally:
            inf.stop()

    def test_watch_signal_fully_resets_ladder(self):
        """The full reset happens once the watch phase actually delivers
        a signal — a healthy round ends with a clean slate."""
        SharedInformer = mod("client").SharedInformer

        def live_watch():
            w = mwatch.Watch(capacity=8)
            w.send(mwatch.Event(mwatch.BOOKMARK, {
                "metadata": {"resourceVersion": "7"}}))
            return w

        rc = _StubRC(watch_fn=live_watch)
        inf = SharedInformer(rc, relist_backoff=0.01)
        inf.backoff.attempts = 7
        inf.start()
        try:
            assert wait_until(lambda: inf.bookmarks_seen >= 1, 10)
            assert wait_until(lambda: inf.backoff.attempts == 0, 5), \
                "healthy watch signal did not reset the ladder"
        finally:
            inf.stop()

    def test_failing_list_still_escalates(self):
        SharedInformer = mod("client").SharedInformer

        def boom():
            raise RuntimeError("list down")

        rc = _StubRC(list_fn=boom)
        inf = SharedInformer(rc, relist_backoff=0.01)
        inf.start()
        try:
            assert wait_until(lambda: rc.lists >= 3, 10)
            assert inf.backoff.attempts >= 2  # no reset without success
        finally:
            inf.stop()

    def test_refused_watch_resumes_under_the_ladder(self):
        """A server refusing every watch re-establishment (429/503 as
        terminal ERROR frames) is pushback: resumes must pace on the
        capped-exponential ladder, not the bare 0.05 s resume cadence —
        ~20 attempts/s against a saturated apiserver would be the
        informer amplifying the very overload that refused it."""
        SharedInformer = mod("client").SharedInformer

        def refused():
            w = mwatch.Watch(capacity=4)
            w.terminate(mwatch.Event(mwatch.ERROR, {"code": 429}))
            return w

        rc = _StubRC(watch_fn=refused)
        inf = SharedInformer(rc, relist_backoff=0.2)
        inf.start()
        try:
            time.sleep(1.0)
            assert rc.watches <= 8, \
                f"{rc.watches} watch attempts in 1s — refused watches " \
                f"are not pacing on the backoff ladder"
            assert inf.backoff.attempts >= 2  # consecutive refusals escalate
        finally:
            inf.stop()

    def test_stop_join_is_bounded_mid_backoff(self):
        """stop() during the relist backoff sleep returns
        promptly — the sleep is interruptible, never a blocking wait up
        to the cap."""
        SharedInformer = mod("client").SharedInformer

        def boom():
            raise RuntimeError("list down")

        rc = _StubRC(list_fn=boom)
        inf = SharedInformer(rc, relist_backoff=20.0)  # cap 30 s
        inf.backoff.attempts = 4  # pretend we're deep in the ladder
        inf.start()
        assert wait_until(lambda: rc.lists >= 1, 5)
        time.sleep(0.1)  # let the thread enter the backoff wait
        t0 = time.monotonic()
        inf.stop()
        took = time.monotonic() - t0
        assert took < 2.0, f"stop() blocked {took:.1f}s in the relist sleep"
        assert not inf._thread.is_alive()


# --------------------------------------------------------------------- #
# WatchMux: routing, backpressure, resync, death
# --------------------------------------------------------------------- #


@on(*PACKAGES)
class TestWatchMux:
    def _mux(self, api, client, **kw):
        SharedInformer = mod("client").SharedInformer
        WatchMux = mod("client").WatchMux

        inf = SharedInformer(client.pods, namespace="default")
        return WatchMux(inf, **kw)

    def test_one_upstream_many_routes(self):
        api, client = _mkapi()
        mux = self._mux(api, client, buffer=256)
        got = {f"t{k}": [] for k in range(4)}
        for n in got:
            mux.route(n, on_add=lambda o, n=n: got[n].append(
                o["metadata"]["name"]))
        mux.start()
        try:
            assert mux.wait_for_sync(10)
            for i in range(40):
                client.pods.create(v1pod(f"p{i}", tenant=f"t{i % 4}"))
            assert wait_until(
                lambda: sum(len(v) for v in got.values()) == 40, 10)
            assert all(len(v) == 10 for v in got.values())
            # the acceptance number: 4 tenants, ONE apiserver stream
            assert api.storage.live_watchers("/registry/core/pods/") == 1
        finally:
            mux.stop()
            api.close()

    def test_late_route_synthesizes_from_indexer(self):
        api, client = _mkapi()
        mux = self._mux(api, client)
        mux.start()
        try:
            assert mux.wait_for_sync(10)
            client.pods.create(v1pod("early-bird", tenant="late"))
            assert wait_until(lambda: len(mux.informer.indexer) == 1, 10)
            relists = mux.informer.relists
            late = []
            r = mux.route("late", on_add=lambda o: late.append(
                o["metadata"]["name"]))
            assert wait_until(lambda: late == ["early-bird"], 5), late
            assert r.resyncs >= 1
            assert mux.informer.relists == relists, \
                "late-join resync must come from the indexer, not a relist"
        finally:
            mux.stop()
            api.close()

    def test_unrouted_events_counted_not_crashing(self):
        api, client = _mkapi()
        mux = self._mux(api, client)
        mux.route("t0")
        mux.start()
        try:
            assert mux.wait_for_sync(10)
            client.pods.create(v1pod("unlabeled"))
            assert wait_until(lambda: mux.unrouted_events >= 1, 5)
        finally:
            mux.stop()
            api.close()

    def test_tenant_label_move_is_delete_plus_add(self):
        api, client = _mkapi()
        mux = self._mux(api, client)
        a_events, b_events = [], []
        mux.route("a", on_add=lambda o: a_events.append(("add",)),
                  on_delete=lambda o: a_events.append(("del",)))
        mux.route("b", on_add=lambda o: b_events.append(("add",)))
        mux.start()
        try:
            assert mux.wait_for_sync(10)
            obj = client.pods.create(v1pod("mover", tenant="a"))
            assert wait_until(lambda: ("add",) in a_events, 5)
            obj["metadata"]["labels"]["ktpu.io/tenant"] = "b"
            client.pods.update(obj)
            assert wait_until(lambda: ("del",) in a_events, 5)
            assert wait_until(lambda: ("add",) in b_events, 5)
        finally:
            mux.stop()
            api.close()

    def test_slow_route_resyncs_from_indexer_not_apiserver(self):
        api, client = _mkapi()
        mux = self._mux(api, client, buffer=4)  # tiny route queues
        stall = threading.Event()
        seen = {}

        def on_add(o):
            if not stall.is_set():
                time.sleep(0.2)  # the slow consumer
            seen[o["metadata"]["name"]] = True

        mux.route("t0", on_add=on_add,
                  on_update=lambda o, n: seen.__setitem__(
                      n["metadata"]["name"], True))
        mux.start()
        try:
            assert mux.wait_for_sync(10)
            for i in range(30):
                client.pods.create(v1pod(f"s{i}", tenant="t0"))
            r = mux.routes["t0"]
            assert wait_until(lambda: r.evictions >= 1, 10), \
                "slow route never hit backpressure"
            stall.set()  # consumer recovers; resync converges the view
            assert wait_until(lambda: len(r.view) == 30, 15), \
                f"route never converged: {len(r.view)}/30"
            assert r.resyncs >= 1
            assert mux.informer.relists == 1, \
                "a route-local stall must never relist the apiserver"
            assert api.storage.live_watchers("/registry/core/pods/") == 1
        finally:
            mux.stop()
            api.close()

    def test_watch_stall_seam_breaks_one_route(self):
        api, client = _mkapi()
        faultline.install("watch.stall@t1:1")
        mux = self._mux(api, client)
        got = {"t0": [], "t1": []}
        for n in got:
            mux.route(n, on_add=lambda o, n=n: got[n].append(1))
        mux.start()
        try:
            assert mux.wait_for_sync(10)
            for i in range(10):
                client.pods.create(v1pod(f"w{i}", tenant=f"t{i % 2}"))
            assert wait_until(
                lambda: len(mux.routes["t1"].view) == 5
                and len(got["t0"]) == 5, 10)
            assert mux.routes["t1"].evictions >= 1
            assert mux.routes["t0"].evictions == 0  # isolation
        finally:
            mux.stop()
            api.close()

    def test_sequence_fence_discards_stale_inflight(self):
        MuxRoute = mod("client.watchmux").MuxRoute

        applied = []
        r = MuxRoute("t", on_add=lambda o: applied.append(o), capacity=8)
        try:
            # an event stamped at-or-below the fence (a racer from before a
            # break) must be discarded, not applied
            with r._cv:
                r.fence = r.seq = 5
                r._q.append((5, "ADDED", None,
                             {"metadata": {"name": "stale"}}))
                r._cv.notify()
            assert wait_until(lambda: r.discarded_stale == 1, 5)
            assert not applied and not r.view
            r.offer("ADDED", None, {"metadata": {"name": "fresh"}})
            assert wait_until(lambda: len(applied) == 1, 5)
        finally:
            r.stop()

    def test_handler_errors_counted_not_fatal(self):
        MuxRoute = mod("client.watchmux").MuxRoute

        applied = []

        def bad_add(o):
            raise RuntimeError("tenant handler bug")

        r = MuxRoute("t", on_add=bad_add, capacity=8)
        try:
            r.offer("ADDED", None, {"metadata": {"name": "x"}})
            assert wait_until(lambda: r.handler_errors == 1, 5)
            # the route thread survived: a later good event still flows
            r.on_add = lambda o: applied.append(o)
            r.offer("ADDED", None, {"metadata": {"name": "y"}})
            assert wait_until(lambda: len(applied) == 1, 5)
        finally:
            r.stop()

    def test_mux_die_seam_then_revive_resumes(self):
        api, client = _mkapi()
        faultline.install("mux.die@stream:3")
        mux = self._mux(api, client)
        got = []
        mux.route("t0", on_add=lambda o: got.append(o["metadata"]["name"]))
        mux.start()
        try:
            assert mux.wait_for_sync(10)
            for i in range(3):
                client.pods.create(v1pod(f"d{i}", tenant="t0"))
            assert wait_until(lambda: not mux.alive, 10), \
                "mux.die@stream never killed the stream"
            assert mux.deaths == 1
            relists = mux.informer.relists
            client.pods.create(v1pod("while-dead", tenant="t0"))
            faultline.uninstall()  # the drill is over; revive cleanly
            mux.revive()
            assert wait_until(lambda: "while-dead" in
                              [k.split("/")[-1] for k in
                               mux.routes["t0"].view], 10)
            assert mux.informer.relists == relists, \
                "revive must resume, not relist"
            assert mux.informer.resumes >= 1
        finally:
            mux.stop()
            api.close()


# --------------------------------------------------------------------- #
# the fleet plane: K tenants, 2 streams, staleness, storm drills
# --------------------------------------------------------------------- #


def _small_fleet(api, client, tenants=3, clk=None):
    FleetServer = mod("fleet").FleetServer
    RecordingBinder = mod("sched.scheduler").RecordingBinder
    Dims = mod("state.dims").Dims

    clk = clk or {"t": 0.0}
    srv = FleetServer(batch_size=16, base_dims=Dims(N=16, P=16, E=64),
                      clock=lambda: clk["t"], device="cpu")
    binders = {}
    for k in range(tenants):
        binders[f"t{k}"] = RecordingBinder()
        srv.add_tenant(f"t{k}", binder=binders[f"t{k}"])
    return srv, binders, clk


@on(PORT)
class TestFleetWatchPlane:
    def test_double_attach_raises(self):
        api, client = _mkapi()
        srv, binders, clk = _small_fleet(api, client, tenants=1)
        plane = srv.attach_watch_plane(client)
        try:
            with pytest.raises(ValueError):
                srv.attach_watch_plane(client)
        finally:
            plane.stop()
            api.close()

    def test_k_tenants_two_streams_total(self):
        api, client = _mkapi()
        srv, binders, clk = _small_fleet(api, client, tenants=6)
        plane = srv.attach_watch_plane(client)
        try:
            for k in range(6):
                client.nodes.create(v1node(f"t{k}-n0", tenant=f"t{k}"))
                client.pods.create(v1pod(f"t{k}-p0", tenant=f"t{k}"))
            assert wait_until(
                lambda: all(t.sched.queue.lengths()[0] == 1
                            for t in srv.tenants.values()), 15)
            # 6 tenants, 2 streams on the apiserver — not 12
            assert api.storage.live_watchers("/registry/core/pods/") == 1
            assert api.storage.live_watchers("/registry/core/nodes/") == 1
            assert plane.stats()["upstream_watches_per_resource"] == 1
        finally:
            plane.stop()
            api.close()

    @pytest.mark.chaos
    def test_mux_death_degrades_to_cached_state_and_recovers(self):
        """The watch plane's drill in miniature: storm in pods, kill
        the pod mux mid-flight, keep ticking (served from cached state,
        staleness visible), revive via maintain(), lose nothing, bind
        everything exactly once."""
        api, client = _mkapi()
        srv, binders, clk = _small_fleet(api, client, tenants=2)
        plane = srv.attach_watch_plane(client)
        try:
            for k in range(2):
                client.nodes.create(v1node(f"t{k}-n0", tenant=f"t{k}"))
            for i in range(6):
                for k in range(2):
                    client.pods.create(v1pod(f"t{k}-p{i}", tenant=f"t{k}"))
            assert wait_until(
                lambda: all(t.sched.queue.lengths()[0] == 6
                            for t in srv.tenants.values()), 15)
            plane.pod_mux.die()
            time.sleep(1.0)
            # pods created while the stream is dead arrive after revive
            for k in range(2):
                client.pods.create(v1pod(f"t{k}-late", tenant=f"t{k}"))
            tk = srv.tick()  # maintain(): records staleness, revives
            clk["t"] += 1.0
            assert tk.staleness_seconds > 0.5
            assert plane.mux_failovers >= 1
            assert plane.pod_mux.informer.relists == 1, "revive relisted"
            assert wait_until(
                lambda: all(t.sched.queue.lengths()[0] +
                            len(binders[t.name].bound) >= 7
                            for t in srv.tenants.values()), 15), \
                "late pods never arrived post-revive"
            for _ in range(12):
                srv.tick()
                clk["t"] += 1.0
                if all(len(binders[f"t{k}"].bound) == 7 for k in range(2)):
                    break
            for k in range(2):
                keys = [key for key, _ in binders[f"t{k}"].bound]
                assert len(keys) == 7, f"t{k} lost pods: {len(keys)}/7"
                assert len(set(keys)) == 7, f"t{k} double-bound"
            # staleness decays back once the stream is live again
            assert plane.staleness() < 15.0
        finally:
            plane.stop()
            api.close()

    @pytest.mark.chaos
    def test_compaction_storm_relists_O1_not_OK(self):
        """K tenants riding one mux through repeated
        compactions. Live streams ride the boundary bookmarks (zero
        relists); killing + reviving both muxes mid-storm resumes from
        bookmarked RVs (still zero); only a genuine floor-crossing while
        the stream is DOWN costs a relist — exactly ONE, not one per
        tenant. The ladder's jitter keeps even those from lockstep."""
        WatchCache = mod("storage.cacher").WatchCache

        api, client = _mkapi()
        K = 8
        srv, binders, clk = _small_fleet(api, client, tenants=K)
        plane = srv.attach_watch_plane(client)
        try:
            st = api.storage
            base_relists = sum(m.informer.relists for m in plane.muxes)
            assert base_relists == 2  # one initial sync per resource
            # ---- repeated compaction storm against LIVE streams ---- #
            for round_ in range(4):
                for k in range(K):
                    client.pods.create(
                        v1pod(f"r{round_}-t{k}", tenant=f"t{k}"))
                assert wait_until(
                    lambda: st._dispatched_rev >= st.kv.rev(), 5)
                st.compact_to(st.kv.rev())
            assert wait_until(
                lambda: all(len(m.informer.indexer) > 0
                            for m in (plane.pod_mux,)), 10)
            assert sum(m.informer.relists for m in plane.muxes) == 2, \
                "a compaction under a LIVE bookmarked stream must not relist"
            # ---- mux-kill mid-storm: resume from bookmarked RVs ---- #
            plane.pod_mux.die()
            plane.node_mux.die()
            st.compact_to(st.kv.rev())  # floor moves while they're dead...
            srv.tick()  # maintain revives both
            clk["t"] += 1.0
            assert plane.mux_failovers >= 2
            assert sum(m.informer.relists for m in plane.muxes) == 2, \
                "post-kill resume should ride the bookmarked RV (within " \
                "the cacher window), not relist"
            # a resume is only COUNTED once the re-established stream
            # delivers its first signal (an attempt that never delivers
            # resumed nothing) — nudge the pod stream and wait for it
            client.pods.create(v1pod("post-revive", tenant="t0"))
            assert wait_until(
                lambda: sum(m.informer.bookmark_resumes
                            for m in plane.muxes) >= 1, 10), \
                "no bookmark-funded resume in the drill"
            # ---- a GENUINE floor-crossing (cache gap) while down ---- #
            plane.pod_mux.die()
            client.pods.create(v1pod("gap", tenant="t0"))
            # let the pump dispatch past the write BEFORE compacting: the
            # drill targets the DEAD stream's stale token, not the pump's
            # own fell-behind-compaction path (which rightly 410s everyone)
            assert wait_until(lambda: st._dispatched_rev >= st.kv.rev(), 5)
            st.compact_to(st.kv.rev())
            st.watch_cache = WatchCache(horizon=st.kv.rev())
            srv.tick()
            clk["t"] += 1.0
            assert wait_until(
                lambda: any("gap" in key for key in
                            plane.pod_mux.routes["t0"].view), 15)
            relists = sum(m.informer.relists for m in plane.muxes)
            assert relists == 3, \
                f"one floor-crossing must cost ONE relist (got " \
                f"{relists - 2}) — O(1), not O(K={K})"
            # no-lockstep: the relist ladder is jittered by construction
            RelistBackoff = mod("client.informers").RelistBackoff

            delays = {RelistBackoff(base=0.5).next() for _ in range(16)}
            assert len(delays) > 1, "relist delays are lockstep-identical"
        finally:
            plane.stop()
            api.close()

    def test_staleness_metric_exported_per_tenant(self):
        DEFAULT_REGISTRY = mod("component.metrics").DEFAULT_REGISTRY

        api, client = _mkapi()
        srv, binders, clk = _small_fleet(api, client, tenants=2)
        plane = srv.attach_watch_plane(client)
        try:
            srv.tick()
            text = DEFAULT_REGISTRY.expose_text()
            for k in range(2):
                assert f'tenant_staleness_seconds{{tenant="t{k}"}}' in text
        finally:
            plane.stop()
            api.close()

    def test_buffer_depth_metric_exported(self):
        WATCH_BUFFER_DEPTH = mod("storage.store").WATCH_BUFFER_DEPTH

        st = Storage(kv=PyKV())
        try:
            w = st.watch("/registry/core/pods/")
            st.create("/registry/core/pods/default/a",
                      {"metadata": {"name": "a"}})
            assert wait_until(
                lambda: st._dispatched_rev >= st.kv.rev(), 5)
            # the gauge exists and carries the pods resource label
            assert WATCH_BUFFER_DEPTH.value(resource="pods") >= 0
            w.stop()
        finally:
            st.close()
