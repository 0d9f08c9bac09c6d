"""The port's telemetry (kubernetes_tpu_torch/sched/telemetry.py,
component/trace.py) held against the JAX package's: tests/test_telemetry.py's
cases other than fleet and DRF, tests/test_explain.py's
TestDegradedWaveReconstruction and TestFlightRing, one serving wave's
flight record against the JAX package's for the same wave (phase names in
order, counts, bucket; not times), the KTPU_TELEMETRY=0 kill switch, and a
KTPU_PROFILE trace's `cycle` range.

Everything runs under deterministic clocks: the scheduler clock (the
queue/event time domain the watch→bind stamps live in) and the telemetry
clock (the phase-span domain) are injected separately.
"""

import json
import logging
import threading

import pytest

import kubernetes_tpu.api.types as JT
import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu.models.workloads import make_nodes as jmake_nodes
from kubernetes_tpu.sched.scheduler import RecordingBinder as JBinder
from kubernetes_tpu.sched.scheduler import Scheduler as JScheduler
from kubernetes_tpu.sched.telemetry import WAVE_PHASES as JWAVE_PHASES
from kubernetes_tpu.utils import faultline as jfaultline
from kubernetes_tpu_torch.component.metrics import Registry
from kubernetes_tpu_torch.component.trace import Trace
from kubernetes_tpu_torch.models.workloads import make_nodes
from kubernetes_tpu_torch.sched.scheduler import RecordingBinder, Scheduler
from kubernetes_tpu_torch.sched.telemetry import (WAVE_PHASES, FlightRecorder,
                                                  PodLatencyTracker,
                                                  SchedulerTelemetry)
from kubernetes_tpu_torch.utils import faultline

pytestmark = pytest.mark.latency


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("KTPU_TELEMETRY", raising=False)
    yield
    faultline.uninstall()
    jfaultline.uninstall()


def _pod(i, T=TT, **kw):
    return T.Pod(name=f"p{i}",
                 requests=T.Resources.make(cpu="10m", memory="8Mi"),
                 creation_index=i, **kw)


def _scheduler(clk, batch_size=64, side="port", **kw):
    if side == "jax":
        s = JScheduler(binder=JBinder(), batch_size=batch_size,
                       clock=lambda: clk["t"], **kw)
        nodes = jmake_nodes(8)
    else:
        s = Scheduler(binder=RecordingBinder(), batch_size=batch_size,
                      clock=lambda: clk["t"], device="cpu", **kw)
        nodes = make_nodes(8)
    for n in nodes:
        s.on_node_add(n)
    return s


def _tick_clock():
    tick = {"n": 0}

    def clock():
        tick["n"] += 1
        return tick["n"] * 0.001
    return clock


# --------------------------------------------------------------------- #
# component/trace.py threshold + exception semantics
# --------------------------------------------------------------------- #

class TestTraceFix:
    def test_threshold_is_constructor_arg(self, caplog):
        t = [0.0]
        with caplog.at_level(logging.WARNING,
                             logger="kubernetes_tpu_torch.trace"):
            with Trace("slow-but-allowed", clock=lambda: t[0],
                       threshold=5.0):
                t[0] = 1.0
        assert not caplog.records
        with caplog.at_level(logging.WARNING,
                             logger="kubernetes_tpu_torch.trace"):
            with Trace("slow", clock=lambda: t[0], threshold=0.5) as tr:
                tr.step("work")
                t[0] = 2.0
        assert any("slow" in r.message for r in caplog.records)

    def test_exception_exit_skips_log_if_long(self, caplog):
        t = [0.0]
        with caplog.at_level(logging.WARNING,
                             logger="kubernetes_tpu_torch.trace"):
            with pytest.raises(RuntimeError):
                with Trace("doomed", clock=lambda: t[0], threshold=0.01):
                    t[0] = 99.0
                    raise RuntimeError("the failure path already reports")
        assert not caplog.records


class TestPodLatencyTracker:
    def test_first_seen_is_idempotent(self):
        tr = PodLatencyTracker()
        tr.stamp("a/x", 1.0)
        tr.stamp("a/x", 5.0)
        assert tr.pop_latency("a/x", 11.0) == 10.0
        assert tr.pop_latency("a/x", 12.0) is None

    def test_discard(self):
        tr = PodLatencyTracker()
        tr.stamp("a/x", 1.0)
        tr.discard("a/x")
        assert tr.pop_latency("a/x", 2.0) is None
        assert len(tr) == 0


class TestFlightRecorder:
    def test_ring_eviction(self):
        fr = FlightRecorder(capacity=4)
        for i in range(6):
            fr.record({"marker": i})
        recs = fr.records()
        assert [r["marker"] for r in recs] == [2, 3, 4, 5]
        assert [r["seq"] for r in recs] == [3, 4, 5, 6]
        assert fr.evicted == 2
        snap = fr.snapshot("manual")
        assert snap["trigger"] == "manual" and snap["last_seq"] == 6
        assert len(snap["records"]) == 4
        json.dumps(snap)


# --------------------------------------------------------------------- #
# wave spans through the real scheduler, against the JAX package's
# --------------------------------------------------------------------- #

def _one_wave_record(side):
    clk = {"t": 0.0}
    s = _scheduler(clk, side=side)
    if side == "jax":
        s.prewarmer.enabled = False
    s.telemetry.clock = _tick_clock()
    T = JT if side == "jax" else TT
    for i in range(5):
        s.on_pod_add(_pod(i, T))
    st = s.schedule_pending()
    assert st.scheduled == 5
    return s.telemetry.recorder.records()[-1]


class TestWaveSpans:
    def test_phase_span_ordering_and_durations(self):
        rec = _one_wave_record("port")
        names = [p for p, _ in rec["phases"]]
        assert names == ["pump", "pop", "snapshot", "prewarm", "dispatch",
                         "readback", "intent-write", "bind-commit",
                         "retire", "requeue"]
        assert set(names) <= set(WAVE_PHASES)
        assert all(dt > 0 for _, dt in rec["phases"])
        assert rec["stats"]["scheduled"] == 5
        assert rec["bucket"]["N"] >= 8
        split = rec["device_split"]
        assert set(split) == {"launch_s", "execute_s", "readback_s"}
        # on the CPU the cycle's ops run inside the launch
        assert split["launch_s"] > 0 and split["execute_s"] == 0.0

    def test_flight_record_matches_the_jax_packages(self):
        """The same wave on both packages: phase names in order, stats,
        engine, bucket and record keys agree (times differ by design)."""
        assert WAVE_PHASES == JWAVE_PHASES
        got, ref = _one_wave_record("port"), _one_wave_record("jax")
        drop = ("t_start", "duration_s", "phases", "device_split", "seq")
        assert [p for p, _ in got["phases"]] == [p for p, _ in ref["phases"]]
        assert {k: v for k, v in got.items() if k not in drop} == \
            {k: v for k, v in ref.items() if k not in drop}
        assert set(got["device_split"]) == set(ref["device_split"])

    def test_e2e_histogram_and_per_phase_series_fed(self):
        from kubernetes_tpu_torch.sched.metrics import (POD_E2E_LATENCY,
                                                        SCHEDULING_DURATION)

        clk = {"t": 0.0}
        s = _scheduler(clk)
        before = POD_E2E_LATENCY.count()
        phase_before = SCHEDULING_DURATION.count(operation="snapshot")
        for i in range(3):
            s.on_pod_add(_pod(i))
        clk["t"] = 2.0
        s.schedule_pending()
        assert POD_E2E_LATENCY.count() == before + 3
        assert SCHEDULING_DURATION.count(operation="snapshot") == \
            phase_before + 1
        assert s.telemetry.latency_quantiles()[0.5] == 2.0

    def test_disabled_telemetry_is_a_noop(self):
        clk = {"t": 0.0}
        s = Scheduler(binder=RecordingBinder(), batch_size=64,
                      clock=lambda: clk["t"], device="cpu")
        s.telemetry = SchedulerTelemetry(enabled=False)
        s.queue.tracker = None
        for n in make_nodes(4):
            s.on_node_add(n)
        s.on_pod_add(_pod(0))
        assert s.schedule_pending().scheduled == 1
        assert s.telemetry.recorder.records() == []
        assert len(s.telemetry.latency_samples) == 0

    def test_kill_switch_env(self, monkeypatch):
        """Telemetry is on by default, as in the JAX package;
        KTPU_TELEMETRY=0 keeps the disabled path."""
        clk = {"t": 0.0}
        assert _scheduler(clk).telemetry.enabled
        monkeypatch.setenv("KTPU_TELEMETRY", "0")
        s = _scheduler(clk)
        assert not s.telemetry.enabled and s.queue.tracker is None
        s.on_pod_add(_pod(0))
        assert s.schedule_pending().scheduled == 1
        assert s.telemetry.recorder.records() == []


class TestFirstSeenAcrossRequeue:
    def test_stamp_survives_unschedulable_backoff_round_trip(self):
        clk = {"t": 0.0}
        s = _scheduler(clk)
        s.on_pod_add(_pod(0, node_selector={"pool": "later"}))
        assert s.schedule_pending().unschedulable == 1
        assert len(s.telemetry.latency_samples) == 0
        clk["t"] = 40.0
        s.on_node_add(TT.Node(name="late", labels={"pool": "later"},
                              allocatable=TT.Resources.make(
                                  cpu="8", memory="16Gi", pods=110)))
        clk["t"] = 50.0
        assert s.schedule_pending().scheduled == 1
        assert s.telemetry.latency_samples[-1] == pytest.approx(50.0)

    def test_prompt_retry_keeps_stamp(self):
        clk = {"t": 3.0}
        s = _scheduler(clk)
        p = _pod(0)
        s.queue.add(p, now=3.0)
        s.queue.pop_batch(10, now=4.0)
        s.queue.add_prompt_retry(p, attempts=1, now=7.0)
        assert s.telemetry.tracker.first_seen(p.key) == 3.0

    def test_deleted_pending_pod_discards_stamp(self):
        clk = {"t": 0.0}
        s = _scheduler(clk)
        p = _pod(0)
        s.on_pod_add(p)
        s.on_pod_delete(p)
        assert s.telemetry.tracker.first_seen(p.key) is None


# --------------------------------------------------------------------- #
# dump-on-abandon: reconstruct the tick from the artifact alone
# --------------------------------------------------------------------- #

def _abandoned_record(side):
    clk = {"t": 0.0}
    s = _scheduler(clk, side=side)
    T = JT if side == "jax" else TT
    for i in range(7):
        s.on_pod_add(_pod(i, T))
    if side == "jax":
        # the JAX package always has a fallback: it must fail as well
        jfaultline.install("device.error@cycle:1,device.fallback@cycle:1")
    else:
        faultline.install("device.error@cycle:1")  # no fallback configured
    st = s.schedule_pending()
    assert st.aborted == 7 and st.scheduled == 0
    dump = s.telemetry.last_dump
    assert dump is not None and dump["trigger"] == "abandoned"
    return json.loads(json.dumps(dump))["records"][-1]


@pytest.mark.chaos
class TestDumpOnAbandon:
    def test_abandoned_dispatch_dumps_a_reconstructable_record(self):
        from kubernetes_tpu_torch.sched.metrics import FLIGHT_DUMPS

        rec = _abandoned_record("port")
        names = [p for p, _ in rec["phases"]]
        assert names[:5] == ["pump", "pop", "snapshot", "prewarm",
                             "dispatch"]
        assert "readback" in names and "requeue" in names
        assert "bind-commit" not in names
        kinds = [k for k, _ in rec["supervisor_events"]]
        assert "degraded" in kinds and "abandoned" in kinds
        assert rec["stats"]["attempted"] == 7
        assert rec["stats"]["aborted"] == 7
        assert rec["stats"]["scheduled"] == 0
        assert FLIGHT_DUMPS.value(trigger="abandoned") >= 1
        ref = _abandoned_record("jax")
        assert [p for p, _ in ref["phases"]] == names
        assert rec["stats"] == ref["stats"]
        assert [k for k, _ in ref["supervisor_events"]] == kinds

    def test_dump_to_file(self, tmp_path):
        clk = {"t": 0.0}
        s = _scheduler(clk)
        s.on_pod_add(_pod(0))
        s.schedule_pending()
        path = tmp_path / "flight.json"
        doc = s.telemetry.dump("manual", path=str(path))
        on_disk = json.loads(path.read_text())
        assert on_disk["trigger"] == "manual"
        assert on_disk["last_seq"] == doc["last_seq"]
        assert on_disk["records"]


class TestFlightArtifactCaps:
    def test_fleet_map_caps_to_busiest_with_aggregate(self):
        from kubernetes_tpu_torch.sched.telemetry import _cap_record

        rec = {"fleet": {f"t{i:02d}": {"attempted": i, "scheduled": i}
                         for i in range(12)}}
        out = _cap_record(rec)
        assert len(out["fleet"]) == 9
        agg = out["fleet"]["..."]
        assert agg["tenants_omitted"] == 4
        assert agg["attempted"] == 0 + 1 + 2 + 3
        assert "t11" in out["fleet"] and "t00" not in out["fleet"]
        assert len(rec["fleet"]) == 12

    def test_event_list_caps_head_and_tail_around_marker(self):
        from kubernetes_tpu_torch.sched.telemetry import _cap_record

        ev = [(f"k{i}", "d") for i in range(100)]
        capped = _cap_record({"supervisor_events": ev})["supervisor_events"]
        assert len(capped) == 32
        assert capped[0] == ("k0", "d") and capped[-1] == ("k99", "d")
        assert capped[16][0] == "truncated" and "omitted" in capped[16][1]

    def test_under_cap_records_pass_through_unchanged(self):
        from kubernetes_tpu_torch.sched.telemetry import _cap_record

        rec = {"fleet": {"t00": {"attempted": 3}},
               "supervisor_events": [("storm", "t00")], "rc": 1}
        assert _cap_record(rec) == rec

    def test_caps_are_env_tunable_and_clamped(self, monkeypatch):
        from kubernetes_tpu_torch.sched.telemetry import _cap_record

        monkeypatch.setenv("KTPU_FLIGHT_FLEET_CAP", "2")
        rec = {"fleet": {f"t{i}": {"attempted": i} for i in range(5)}}
        assert len(_cap_record(rec)["fleet"]) == 3
        monkeypatch.setenv("KTPU_FLIGHT_FLEET_CAP", "garbage")
        assert len(_cap_record(rec)["fleet"]) == 5

    def test_dump_is_record_per_line_and_reconstructable(self, tmp_path):
        clk = {"t": 0.0}
        s = _scheduler(clk)
        for i in range(5):
            s.on_pod_add(_pod(i))
            s.schedule_pending()
        path = tmp_path / "flight.json"
        doc = s.telemetry.dump("manual", path=str(path))
        text = path.read_text()
        on_disk = json.loads(text)
        assert on_disk["last_seq"] == doc["last_seq"]
        assert len(on_disk["records"]) == len(doc["records"])
        rec_lines = [ln for ln in text.splitlines() if ln.startswith("  ")]
        assert len(rec_lines) == len(on_disk["records"])
        assert len(text.splitlines()) <= len(on_disk["records"]) + 16

    def test_gzip_policy_for_flight_dir_dumps(self, tmp_path, monkeypatch):
        import gzip
        import os

        monkeypatch.setenv("KTPU_FLIGHT_DIR", str(tmp_path))
        monkeypatch.setenv("KTPU_FLIGHT_GZIP", "1")
        clk = {"t": 0.0}
        s = _scheduler(clk)
        s.on_pod_add(_pod(0))
        s.schedule_pending()
        doc = s.telemetry.dump("manual")
        files = [f for f in os.listdir(tmp_path) if f.endswith(".json.gz")]
        assert len(files) == 1
        with gzip.open(tmp_path / files[0], "rt") as f:
            on_disk = json.load(f)
        assert on_disk["last_seq"] == doc["last_seq"]
        assert on_disk["records"]


class TestCrashedAndIdleWaves:
    def test_exception_escaping_the_wave_still_records_and_dumps(self):
        clk = {"t": 0.0}
        s = _scheduler(clk)
        s.on_pod_add(_pod(0))

        def boom(pending):
            raise ValueError("encode exploded")

        s._snapshot_keys = boom
        with pytest.raises(ValueError):
            s.schedule_pending()
        rec = s.telemetry.recorder.records()[-1]
        assert rec["exception"] is True
        names = [p for p, _ in rec["phases"]]
        assert names[:2] == ["pump", "pop"] and names[-1] == "exception"
        assert rec["stats"]["attempted"] == 1
        assert s.telemetry.last_dump["trigger"] == "exception"

    def test_idle_wave_drains_pending_supervisor_events(self):
        clk = {"t": 0.0}
        s = _scheduler(clk)
        s.telemetry.note_supervisor_event("recovery", "prober re-admitted")
        assert s.schedule_pending().attempted == 0
        rec = s.telemetry.recorder.records()[-1]
        assert rec["engine"] == "idle"
        assert ("recovery", "prober re-admitted") in rec["supervisor_events"]
        n = len(s.telemetry.recorder.records())
        s.schedule_pending()
        assert len(s.telemetry.recorder.records()) == n

    def test_zombie_device_split_never_attaches_to_a_later_wave(self):
        tel = SchedulerTelemetry(enabled=True)
        span = tel.wave_span()
        span.mark("pump")
        tel.note_device_split(60.0, 60.0, 0.1, token=object())
        assert "device_split" not in tel.finish_wave(span, engine="waves")
        span2 = tel.wave_span()
        span2.mark("pump")
        tel.note_device_split(0.1, 0.2, 0.01, token=span2)
        rec2 = tel.finish_wave(span2, engine="waves")
        assert rec2["device_split"]["execute_s"] == 0.2


class TestMetricsConcurrency:
    def test_no_lost_increments_under_hammer(self):
        reg = Registry()
        c = reg.counter("hammer_total", labels=("who",))
        h = reg.histogram("hammer_seconds")
        g = reg.gauge("hammer_gauge")
        n_threads, n_iter = 8, 2000
        start = threading.Barrier(n_threads)

        def worker(i):
            start.wait()
            for k in range(n_iter):
                c.inc(who=f"w{i % 2}")
                h.observe(0.01 * (k % 7))
                g.inc()
                g.dec(0.5)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert c.value(who="w0") == n_threads // 2 * n_iter
        assert c.total() == n_threads * n_iter
        assert h.count() == n_threads * n_iter
        assert g.value() == pytest.approx(n_threads * n_iter * 0.5)
        assert f"hammer_seconds_count {n_threads * n_iter}" in \
            reg.expose_text()

    def test_registry_register_is_idempotent_under_races(self):
        reg = Registry()
        out = []
        barrier = threading.Barrier(8)

        def worker():
            barrier.wait()
            out.append(reg.counter("same_name"))

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(m is out[0] for m in out)


class TestQuantilesAndSplit:
    def test_latency_quantiles_exact(self):
        tel = SchedulerTelemetry(enabled=True)
        for v in (0.001, 0.002, 0.003, 0.004, 1.0):
            tel.latency_samples.append(v)
        q = tel.latency_quantiles((0.5, 0.99))
        assert q[0.5] == 0.003 and q[0.99] == 1.0

    def test_histogram_quantile_buckets(self):
        from kubernetes_tpu_torch.component.metrics import Histogram

        h = Histogram("q_test", "")
        for v in (0.003, 0.003, 0.003, 0.9):
            h.observe(v)
        assert h.quantile(0.5) == 0.005
        assert h.quantile(0.99) == 1.0


# --------------------------------------------------------------------- #
# tests/test_explain.py: TestDegradedWaveReconstruction, TestFlightRing
# --------------------------------------------------------------------- #

class TestDegradedWaveReconstruction:
    def test_last_dump_alone_reconstructs_what_and_why(self, monkeypatch):
        """A wave degraded onto the configured CPU fallback: the dump
        alone says what it placed and why the rest failed."""
        monkeypatch.setenv("KTPU_EXPLAIN", "1")
        clk = {"t": 0.0}
        s = _scheduler(clk, fallback_device="cpu")
        for i in range(5):
            s.on_pod_add(_pod(i))
        s.on_pod_add(TT.Pod(name="p9", requests=TT.Resources.make(
            cpu="99999", memory="8Mi"), creation_index=9))
        faultline.install("device.error@cycle:1")
        st = s.schedule_pending()
        assert st.scheduled == 5 and st.unschedulable == 1
        dump = s.telemetry.last_dump
        assert dump is not None and dump["trigger"] == "degraded"
        rec = json.loads(json.dumps(dump))["records"][-1]
        assert "degraded" in [k for k, _ in rec["supervisor_events"]]
        assert rec["stats"]["scheduled"] == 5
        assert rec["stats"]["unschedulable"] == 1
        assert rec["explain"]["reasons_total"] == {"fit": 8}
        assert rec["explain"]["pods"]["default/p9"]["reasons"] == {"fit": 8}
        assert rec["explain"]["pods"]["default/p9"]["feasible"] == 0
        assert s.supervisor.stats.degraded_cycles == 1
        assert s.supervisor.wait_recovered(15)


class TestFlightRing:
    def test_env_sets_capacity(self, monkeypatch):
        monkeypatch.setenv("KTPU_FLIGHT_RING", "7")
        tel = SchedulerTelemetry(enabled=True)
        assert tel.recorder.capacity == 7
        for i in range(10):
            tel.recorder.record({"i": i})
        assert len(tel.recorder.records()) == 7
        assert tel.recorder.evicted == 3

    @pytest.mark.parametrize("raw,expect", [
        ("", 64), ("garbage", 64), ("0", 1), ("-5", 1),
        ("1", 1), ("128", 128), ("9999999", 65536),
    ])
    def test_bounds_checked_parse(self, monkeypatch, raw, expect):
        from kubernetes_tpu_torch.sched.telemetry import flight_ring_capacity

        monkeypatch.setenv("KTPU_FLIGHT_RING", raw)
        assert flight_ring_capacity() == expect

    def test_explicit_capacity_wins_over_env(self, monkeypatch):
        monkeypatch.setenv("KTPU_FLIGHT_RING", "7")
        assert SchedulerTelemetry(capacity=3,
                                  enabled=True).recorder.capacity == 3


# --------------------------------------------------------------------- #
# KTPU_PROFILE: a torch.profiler trace with the wave's `cycle` range
# --------------------------------------------------------------------- #

def test_profile_trace_holds_the_cycle_range(tmp_path, monkeypatch):
    monkeypatch.setenv("KTPU_PROFILE", str(tmp_path))
    clk = {"t": 0.0}
    s = _scheduler(clk)
    for i in range(5):
        s.on_pod_add(_pod(i))
    assert s.schedule_pending().scheduled == 5
    path = s.telemetry.stop_profile()
    assert path is not None and path.startswith(str(tmp_path))
    events = json.load(open(path))["traceEvents"]
    cycles = [e for e in events if e.get("name") == "cycle"
              and e.get("ph") == "X"]
    assert len(cycles) == 1
    c = cycles[0]
    # the dispatch's ops (on the worker thread) fall inside the range
    inside = [e for e in events if e.get("ph") == "X"
              and str(e.get("name", "")).startswith("aten::")
              and c["ts"] <= e["ts"] <= c["ts"] + c["dur"]]
    assert inside
    assert s.telemetry.stop_profile() is None


def _fleet(side, quotas, n_pods=6):
    """test_telemetry.py's fleet: tenants on make_nodes(4) at base dims
    (8, 32, 64), 10m/8Mi pods, prewarmer off; returns (server, clock)."""
    if side == "jax":
        from kubernetes_tpu.fleet import FleetServer
        from kubernetes_tpu.state.dims import Dims
        T, nodes, kw = JT, jmake_nodes(4), {}
    else:
        from kubernetes_tpu_torch.fleet import FleetServer
        from kubernetes_tpu_torch.state.dims import Dims
        T, nodes, kw = TT, make_nodes(4), {"device": "cpu"}
    clk = {"t": 0.0}
    srv = FleetServer(batch_size=32, base_dims=Dims(N=8, P=32, E=64),
                      clock=lambda: clk["t"], **kw)
    srv.prewarmer.enabled = False
    for name, quota in quotas:
        t = srv.add_tenant(name, quota=quota)
        for n in nodes:
            t.on_node_add(n)
        for i in range(n_pods):
            t.on_pod_add(T.Pod(name=f"{name}-p{i}",
                               requests=T.Resources.make(cpu="10m",
                                                         memory="8Mi"),
                               creation_index=i))
    return srv, clk


@pytest.mark.chaos
class TestFleetStormDump:
    def test_storm_degraded_tick_dumps_with_tenant_attribution(self):
        srv, clk = _fleet("port", [("t00", 1.0), ("t01", 1.0)])
        srv.tick()
        clk["t"] += 1.0
        faultline.install("tenant.storm@t00:1")
        tk = srv.tick()
        assert tk.per_tenant["t00"].degraded == 1
        dump = srv.telemetry.last_dump
        assert dump is not None and dump["trigger"] == "storm"
        rec = dump["records"][-1]
        assert [tuple(e) for e in rec["supervisor_events"]] == \
            [("storm", "t00")]
        # per-tenant attribution on the record itself: ONLY t00 degraded
        assert rec["fleet"]["t00"]["degraded"] == 1
        assert rec["fleet"]["t01"]["degraded"] == 0


class TestDrfClampedMetric:
    def test_clamp_routes_through_cyclestats_to_metric(self):
        """The DRF clamp lands in the tenant-labelled metric through
        CycleStats → observe_fleet_tick, with the JAX package's per-tenant
        clamp counts."""
        from kubernetes_tpu_torch.sched.metrics import DRF_CLAMPED

        n_pods = 8
        # tenant 0 under a quota that funds roughly half its backlog (the
        # dominant demand at this shape is the implicit pod slot)
        tight = (n_pods / 2) * (1.0 / (4 * 110.0))
        quotas = [("q00", tight), ("q01", 1.0)]
        want = _fleet("jax", quotas, n_pods)[0].tick()
        srv, _ = _fleet("port", quotas, n_pods)
        before = DRF_CLAMPED.value(tenant="q00")
        before_other = DRF_CLAMPED.value(tenant="q01")
        tk = srv.tick()
        assert tk.per_tenant["q00"].drf_clamped >= 1
        assert tk.per_tenant["q01"].drf_clamped == 0
        assert {n: st.drf_clamped for n, st in tk.per_tenant.items()} == \
            {n: st.drf_clamped for n, st in want.per_tenant.items()}
        assert DRF_CLAMPED.value(tenant="q00") - before == \
            tk.per_tenant["q00"].drf_clamped
        assert DRF_CLAMPED.value(tenant="q01") == before_other
        assert DRF_CLAMPED.total() >= DRF_CLAMPED.value(tenant="q00")
