"""Parity of the port's decision provenance (kubernetes_tpu_torch/ops/assign.py
explain programs, sched/cycle.py explain and _diagnose, sched/explain.py and
the Scheduler's explainer) with the JAX package's.

tests/test_explain.py's cases that need only the engines, the scheduler and
a recording sink, on both packages on the CPU from one encoded input:
ExplainResult's integer fields (reasons, valid/feasible/rejected counts,
top nodes, part node) exactly equal, its f32 fields (top scores, score
parts) within torch_parity.F32_ATOL (both packages evaluate the same f32
expression tree op for op; the tolerance leaves room for a reduction-order
rounding). Also mask_components/_diagnose against the JAX package's. The
cases that need the apiserver's event store, the debug HTTP endpoint or
fleet tenants wait for ROADMAP items 11 and 12. TestDocDrift runs on both
packages through tests/test_torch_twin.py `mirror`: every scheduler_* and
apiserver_* series on each package's shared registry is in
docs/OBSERVABILITY.md's catalogue, and every one the catalogue names is
registered.
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.api.types as JT
import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu.ops.assign import assign_batch as j_assign_batch
from kubernetes_tpu.ops.assign import \
    explain_assignments as j_explain_assignments
from kubernetes_tpu.ops.assign import initial_state as j_initial_state
from kubernetes_tpu.ops.lattice import build_cycle as j_build_cycle
from kubernetes_tpu.ops.lattice import default_engine_config
from kubernetes_tpu.sched import cycle as JC
from kubernetes_tpu.sched import explain as JE
from kubernetes_tpu.sched.scheduler import RecordingBinder as JBinder
from kubernetes_tpu.sched.scheduler import Scheduler as JScheduler
from kubernetes_tpu_torch.ops import assign as TA
from kubernetes_tpu_torch.ops.lattice import build_cycle as t_build_cycle
from kubernetes_tpu_torch.sched import cycle as TC
from kubernetes_tpu_torch.sched import explain as TE
from kubernetes_tpu_torch.sched.scheduler import RecordingBinder as TBinder
from kubernetes_tpu_torch.sched.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.sched.telemetry import SchedulerTelemetry
from test_golden import rand_node, rand_pod
from test_torch_twin import mirror
from torch_parity import as_np, assert_same, encode

# the metric catalogue's drift gate on each package's shared registry (the
# port's sched.cycle has no _schedule_batch: the import is dropped, and
# only this class of the file is mirrored)
mirror(globals(), "test_explain",
       select=lambda cls, name: cls == "TestDocDrift",
       subs=[("    _schedule_batch,\n", "")])

INT_FIELDS = ("reasons", "valid_nodes", "feasible_nodes", "rejected_any",
              "top_nodes", "part_node")


def _nodes(T, n=5, cpu="2"):
    return [T.Node(name=f"n{i}",
                   allocatable=T.Resources.make(cpu=cpu, memory="8Gi",
                                                pods=110))
            for i in range(n)]


def _pod(T, i, cpu="100m", **kw):
    return T.Pod(name=f"p{i}", requests=T.Resources.make(cpu=cpu,
                                                          memory="16Mi"),
                 creation_index=i, **kw)


def _both(enc, explain=True):
    """(JAX (res, exp), port (res, exp)) of one explain-on dispatch."""
    tables, ex, pe = enc["jax"]
    uk, ev = enc["keys"]
    d = enc["dims"]
    ref = JC._schedule_batch(tables, pe, (jnp.int32(uk), jnp.int32(ev)), d.D,
                             ex, has_node_name=d.has_node_name,
                             explain=explain)
    tt, tex, tpe = enc["torch"]
    got = TC.schedule_batch(tt, tpe, (uk, ev), d.D, tex,
                            has_node_name=d.has_node_name, explain=explain)
    return ref, got


def _assert_explain_equal(ref_exp, got_exp):
    ref_exp = jax.device_get(ref_exp)
    assert got_exp._fields == ref_exp._fields
    for f in INT_FIELDS:
        np.testing.assert_array_equal(as_np(getattr(got_exp, f)),
                                      as_np(getattr(ref_exp, f)), f)
    # f32 fields: torch_parity.F32_ATOL
    assert_same(ref_exp.top_scores, got_exp.top_scores, "top_scores")
    assert_same(ref_exp.score_parts, got_exp.score_parts, "score_parts")


# --------------------------------------------------------------------- #
# tests/test_explain.py TestDeviceAttribution, both packages
# --------------------------------------------------------------------- #


def test_counts_reconcile_with_final_mask():
    enc = encode(_nodes(JT, 5), [],
                 [_pod(JT, i) for i in range(3)] + [_pod(JT, 9, cpu="64")])
    (jres, jexp), (res, exp) = _both(enc)
    np.testing.assert_array_equal(as_np(res.node), as_np(jres.node))
    _assert_explain_equal(jexp, exp)
    e = type(exp)(*(t.numpy() for t in exp))
    node = res.node.numpy()
    for i in range(4):
        assert e.rejected_any[i] == e.valid_nodes[i] - e.feasible_nodes[i]
        assert e.reasons[i].max(initial=0) <= e.rejected_any[i]
        assert e.rejected_any[i] <= e.reasons[i].sum()
    r = dict(zip(TA.EXPLAIN_PREDICATES, e.reasons[3]))
    assert node[3] == -1 and r["fit"] == e.valid_nodes[3] == 5
    assert e.feasible_nodes[3] == 0
    assert sum(v for k, v in r.items() if k != "fit") == 0
    assert node[0] >= 0 and e.part_node[0] == node[0]
    assert e.score_parts[0].sum() > 0


def test_pinned_pod_host_attribution():
    pods = [_pod(JT, 0), JT.Pod(name="pin", node_name="n2",
                                requests=JT.Resources.make(cpu="100m",
                                                           memory="16Mi"),
                                creation_index=1)]
    enc = encode(_nodes(JT, 4), [], pods)
    (_jres, jexp), (_res, exp) = _both(enc)
    _assert_explain_equal(jexp, exp)
    r = dict(zip(TA.EXPLAIN_PREDICATES, exp.reasons[1].tolist()))
    assert r["host"] == 3 and int(exp.feasible_nodes[1]) == 1


def _granularities(enc):
    tt, tex, tpe = enc["torch"]
    uk, ev = enc["keys"]
    cyc = t_build_cycle(tt, tex, uk, ev, enc["dims"].D)
    res = TA.assign_batch(tt, cyc, tpe, TA.initial_state(tt, cyc))
    return (TA.explain_assignments(tt, cyc, tpe, res, "pod"),
            TA.explain_assignments(tt, cyc, tpe, res, "class"))


def test_pod_vs_class_granularity_bit_equal():
    pods = ([_pod(JT, i) for i in range(4)] + [_pod(JT, 8, cpu="64")]
            + [JT.Pod(name="pin", node_name="n1",
                      requests=JT.Resources.make(cpu="100m", memory="16Mi"),
                      creation_index=9)])
    enc = encode(_nodes(JT, 6), [], pods)
    e_pod, e_cls = _granularities(enc)
    for name in e_pod._fields:
        assert torch.equal(getattr(e_pod, name), getattr(e_cls, name)), name
    # and the JAX package's pod granularity
    tables, ex, pe = enc["jax"]
    uk, ev = enc["keys"]
    cyc = j_build_cycle(tables, ex, jnp.int32(uk), jnp.int32(ev),
                        enc["dims"].D, 1.0, default_engine_config())
    res = j_assign_batch(tables, cyc, pe, j_initial_state(tables, cyc))
    _assert_explain_equal(
        j_explain_assignments(tables, cyc, pe, res, "pod"), e_pod)


def test_engines_attribution_agrees(monkeypatch):
    pods = [_pod(JT, i) for i in range(5)] + [_pod(JT, 9, cpu="64")]
    outs = {}
    for engine in ("scan", "runs", "waves"):
        monkeypatch.setenv("KTPU_ASSIGN", engine)
        enc = encode(_nodes(JT, 6), [], pods)
        (jres, jexp), (res, exp) = _both(enc)
        np.testing.assert_array_equal(as_np(res.node), as_np(jres.node))
        _assert_explain_equal(jexp, exp)
        outs[engine] = (res.node, exp)
    for engine in ("runs", "waves"):
        assert torch.equal(outs["scan"][0], outs[engine][0])
        for name in outs["scan"][1]._fields:
            assert torch.equal(getattr(outs["scan"][1], name),
                               getattr(outs[engine][1], name)), (engine, name)


def test_explain_off_placement_bit_equality_all_engines(monkeypatch):
    pods = [_pod(JT, i) for i in range(8)] + [_pod(JT, 20, cpu="64")]
    for engine in ("scan", "runs", "waves"):
        monkeypatch.setenv("KTPU_ASSIGN", engine)
        enc = encode(_nodes(JT, 6), [], pods)
        tt, tex, tpe = enc["torch"]
        d = enc["dims"]
        plain = TC.schedule_batch(tt, tpe, enc["keys"], d.D, tex,
                                  has_node_name=d.has_node_name)
        res, _exp = TC.schedule_batch(tt, tpe, enc["keys"], d.D, tex,
                                      has_node_name=d.has_node_name,
                                      explain=True)
        assert torch.equal(plain.node, res.node), engine


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("engine", ["scan", "waves"])
def test_explain_golden_random_clusters(monkeypatch, engine, seed):
    """tests/test_golden.py's random clusters (affinity, anti-affinity,
    spread, taints, ports, volumes) with replica bursts: the wave's
    attribution in both packages, every failing pod's score decomposed."""
    monkeypatch.setenv("KTPU_ASSIGN", engine)
    rng = random.Random(700 + seed)
    nodes = [rand_node(rng, i) for i in range(rng.randint(3, 7))]
    existing = [rand_pod(rng, 100 + i, bound_to=rng.choice(nodes).name)
                for i in range(rng.randint(0, 5))]
    pending = []
    while len(pending) < 24:
        t = rand_pod(rng, len(pending))
        for _ in range(rng.randint(1, 5)):
            pending.append(dataclasses.replace(
                t, name=f"p{len(pending)}", creation_index=len(pending)))
    enc = encode(nodes, existing, pending)
    (jres, jexp), (res, exp) = _both(enc)
    np.testing.assert_array_equal(as_np(res.node), as_np(jres.node))
    _assert_explain_equal(jexp, exp)


def test_gang_batch_of_host_rounds_size_attributes_nothing(monkeypatch):
    """The JAX package's host-rounds gang route (its threshold lowered
    here) returns no attribution; the port's one gang route keeps that
    contract at the same size."""
    from kubernetes_tpu.models.workloads import gang_workload_pods, make_nodes

    monkeypatch.setattr(JC, "_GANG_HOST_THRESHOLD", 16)
    monkeypatch.setattr(TC, "_GANG_HOST_THRESHOLD", 16)
    nodes = make_nodes(6, zones=2, racks_per_zone=1, cpu="16",
                       memory="64Gi")
    enc_pods = gang_workload_pods(32)
    enc = encode(nodes, [], enc_pods)
    gang = enc["encoder"].build_gang_arrays(enc_pods, enc["dims"], {})
    tables, ex, pe = enc["jax"]
    uk, ev = enc["keys"]
    d = enc["dims"]
    jres, jexp = JC._schedule_batch(tables, pe, (jnp.int32(uk),
                                                 jnp.int32(ev)), d.D, ex,
                                    gang=gang, explain=True)
    from kubernetes_tpu_torch.state.arrays import to_device

    tt, tex, tpe = enc["torch"]
    res, exp = TC.schedule_batch(tt, tpe, (uk, ev), d.D, tex,
                                 gang=to_device(gang, torch.device("cpu")),
                                 explain=True)
    assert jexp is None and exp is None
    np.testing.assert_array_equal(as_np(res.node), as_np(jres.node))


def test_explain_and_return_waves_cannot_be_combined():
    enc = encode(_nodes(JT, 2), [], [_pod(JT, 0)])
    tt, tex, tpe = enc["torch"]
    with pytest.raises(ValueError, match="cannot be combined"):
        TC.schedule_batch(tt, tpe, enc["keys"], enc["dims"].D, tex,
                          explain=True, return_waves=True)


# --------------------------------------------------------------------- #
# mask_components / _diagnose against the JAX package
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(3))
def test_diagnose_matches_jax(seed):
    rng = random.Random(900 + seed)
    nodes = [rand_node(rng, i) for i in range(rng.randint(3, 7))]
    existing = [rand_pod(rng, 100 + i, bound_to=rng.choice(nodes).name)
                for i in range(rng.randint(0, 5))]
    pending = [rand_pod(rng, i) for i in range(12)]
    pending.append(dataclasses.replace(pending[0], name="pin",
                                       node_name=nodes[0].name))
    enc = encode(nodes, existing, pending)
    tables, ex, pe = enc["jax"]
    uk, ev = enc["keys"]
    ref = JC._diagnose(tables, pe, (jnp.int32(uk), jnp.int32(ev)),
                       enc["dims"].D, ex)
    tt, tex, tpe = enc["torch"]
    got = TC._diagnose(tt, tpe, (uk, ev), enc["dims"].D, tex)
    assert got._fields == ref._fields
    for f in ref._fields:
        np.testing.assert_array_equal(as_np(getattr(got, f)),
                                      as_np(getattr(ref, f)), f)


def test_mask_components_reconcile_with_feasible_matrix():
    """The nine components AND to the Filter mask (every plugin on)."""
    rng = random.Random(5)
    nodes = [rand_node(rng, i) for i in range(6)]
    enc = encode(nodes, [], [rand_pod(rng, i) for i in range(16)])
    tt, tex, tpe = enc["torch"]
    uk, ev = enc["keys"]
    cyc = t_build_cycle(tt, tex, uk, ev, enc["dims"].D)
    mc = TA.mask_components(tt, cyc, tpe)
    every = mc[0]
    for plane in mc[1:]:
        every = every & plane
    assert torch.equal(every & tt.nodes.valid,
                       TA.feasible_matrix(tt, cyc, tpe))


# --------------------------------------------------------------------- #
# tests/test_explain.py TestRenderAndCorrelator, on both packages' text
# --------------------------------------------------------------------- #


def test_message_is_kube_style_dominant_first():
    args = (5000, {"fit": 3200, "taints": 1800})
    msg = TE.render_unschedulable(*args)
    assert msg == JE.render_unschedulable(*args)
    assert msg == ("0/5000 nodes are available: 3200 Insufficient "
                   "resources, 1800 node(s) had taints that the pod "
                   "didn't tolerate.")


def test_feasible_but_not_admitted_never_claims_zero_nodes():
    msg = TE.render_unschedulable(100, {}, feasible_nodes=40)
    assert msg == JE.render_unschedulable(100, {}, feasible_nodes=40)
    assert msg.startswith("40/100 nodes are available but")
    assert TE.reason_fingerprint({}, feasible_nodes=40) == "not-admitted"
    assert TE.reason_fingerprint({"fit": 5}, feasible_nodes=0) \
        != "not-admitted"


def test_wave_event_budget_caps_synchronous_writes():
    emitted = []
    expl = TE.DecisionExplainer(name="t")
    expl.WAVE_EVENT_BUDGET = 2

    class _Sink:
        def emit(self, ns, name, reason, message, fingerprint=""):
            emitted.append(name)
            return True

    expl.sink = _Sink()
    doc = {"reasons": {"fit": 3}, "feasible_nodes": 0, "message": "m"}
    wb = [expl.WAVE_EVENT_BUDGET]
    for i in range(5):
        expl._maybe_emit(_pod(TT, i), dict(doc), wb)
    assert len(emitted) == 2
    for _ in range(8):
        wb = [expl.WAVE_EVENT_BUDGET]
        for i in range(5):
            expl._maybe_emit(_pod(TT, i), dict(doc), wb)
        if {f"p{i}" for i in range(5)} <= set(emitted):
            break
    assert {f"p{i}" for i in range(5)} <= set(emitted)


def test_fingerprint_stable_under_count_jitter():
    a = TE.reason_fingerprint({"fit": 3200, "taints": 1800})
    assert a == TE.reason_fingerprint({"fit": 3100, "taints": 1900})
    assert a == JE.reason_fingerprint({"fit": 3200, "taints": 1800})
    assert a != TE.reason_fingerprint({"fit": 100, "taints": 1900})
    assert a != TE.reason_fingerprint({"fit": 3200})


def test_correlator_exponential_backoff_by_occurrence():
    c = TE.ReasonCorrelator()
    emitted = [i + 1 for i in range(40) if c.should_emit("default/p", "fp")]
    assert emitted == [1, 2, 4, 8, 16, 32]


def test_correlator_forget_and_bound():
    c = TE.ReasonCorrelator(max_keys=4)
    assert c.should_emit("k", "fp")
    assert c.should_emit("k", "fp")
    assert not c.should_emit("k", "fp")
    c.forget("k")
    assert c.should_emit("k", "fp")
    for i in range(8):
        c.should_emit(f"other{i}", "fp")
    assert len(c._seen) <= 4


# --------------------------------------------------------------------- #
# tests/test_explain.py TestExplainerWave, both packages' Scheduler
# --------------------------------------------------------------------- #


class _RecordingTelemetry(SchedulerTelemetry):
    """The disabled telemetry path, keeping each wave's `extra` record."""

    def __init__(self):
        super().__init__(enabled=False)
        self.records = []

    def finish_wave(self, span, **kw):
        self.records.append(kw.get("extra") or {})
        return None


def _scheduler(side, monkeypatch, explain=True, clk=None):
    monkeypatch.setenv("KTPU_EXPLAIN", "1" if explain else "0")
    kw = {"clock": (lambda: clk["t"])} if clk is not None else {}
    if side == "jax":
        s = JScheduler(binder=JBinder(), batch_size=64, **kw)
        s.prewarmer.enabled = False
        T = JT
    else:
        s = TScheduler(binder=TBinder(), batch_size=64, device="cpu", **kw)
        s.telemetry = _RecordingTelemetry()
        T = TT
    from kubernetes_tpu_torch.models.workloads import make_nodes as tmake
    from kubernetes_tpu.models.workloads import make_nodes as jmake

    for n in (jmake if side == "jax" else tmake)(8):
        s.on_node_add(n)
    return s, T


def _unschedulable_then_resolved(side, monkeypatch):
    clk = {"t": 0.0}
    s, T = _scheduler(side, monkeypatch, clk=clk)
    s.on_pod_add(_pod(T, 0))
    s.on_pod_add(_pod(T, 1, cpu="99999"))
    st = s.schedule_pending()
    doc = s.explainer.why("default/p1")
    first = s.explainer.why("default/p0")
    s.on_node_add(T.Node(name="big", allocatable=T.Resources.make(
        cpu="999999", memory="8Gi", pods=110)))
    clk["t"] += 61.0
    st2 = s.schedule_pending()
    doc2 = s.explainer.why("default/p1")
    return s, (st.scheduled, st.unschedulable, st2.scheduled), doc, first, \
        doc2


def test_unschedulable_pod_attribution_and_resolution(monkeypatch):
    from kubernetes_tpu_torch.sched.metrics import UNSCHEDULABLE_REASONS

    before = UNSCHEDULABLE_REASONS.total()
    s, counts, doc, first, doc2 = _unschedulable_then_resolved(
        "port", monkeypatch)
    ref = _unschedulable_then_resolved("jax", monkeypatch)[1:]
    assert (counts, doc, first, doc2) == ref
    assert counts == (1, 1, 1)
    assert doc["outcome"] == "unschedulable"
    assert doc["reasons"] == {"fit": 8}
    assert doc["valid_nodes"] == 8 and doc["feasible_nodes"] == 0
    assert doc["message"].startswith(
        "0/8 nodes are available: 8 Insufficient resources")
    assert UNSCHEDULABLE_REASONS.total() >= before + 8
    # the wave record carries the attribution
    rec = s.telemetry.records[0]["explain"]
    assert rec["reasons_total"] == {"fit": 8}
    assert "default/p1" in rec["pods"]
    assert first is None        # bound first try: off the why surface
    assert doc2["outcome"] == "scheduled" and doc2["node"] == "big"
    assert set(doc2["score_parts"]) == set(TA.EXPLAIN_SCORE_COMPONENTS)


def test_kill_switch_builds_no_explainer(monkeypatch):
    s, T = _scheduler("port", monkeypatch, explain=False)
    assert s.explainer is None
    s.on_pod_add(_pod(T, 0))
    assert s.schedule_pending().scheduled == 1
    assert "explain" not in s.telemetry.records[-1]


def test_build_explainer_env_parse(monkeypatch):
    monkeypatch.delenv("KTPU_EXPLAIN", raising=False)
    assert TE.build_explainer() is None
    monkeypatch.setenv("KTPU_EXPLAIN", "0")
    assert TE.build_explainer() is None
    monkeypatch.setenv("KTPU_EXPLAIN", "1")
    assert TE.build_explainer() is not None


def test_enable_explain_attaches_a_recording_sink(monkeypatch):
    """enable_explain (the decisionProvenance config flag) with a sink: a
    failing pod's FailedScheduling event reaches it once, then the
    correlator holds its repeats back."""
    monkeypatch.delenv("KTPU_EXPLAIN", raising=False)
    s = TScheduler(binder=TBinder(), batch_size=64, device="cpu")
    assert s.explainer is None
    events = []

    class _Sink:
        def emit(self, ns, name, reason, message, fingerprint=""):
            events.append((ns, name, reason, message, fingerprint))
            return True

    s.enable_explain(sink=_Sink())
    for n in _nodes(TT, 3):
        s.on_node_add(n)
    s.on_pod_add(_pod(TT, 0, cpu="64"))
    for t in range(3):
        s.schedule_pending(now=100.0 * t)
        s.queue.move_all_to_active(100.0 * t + 50)
    assert events[0][:3] == ("default", "p0", "FailedScheduling")
    assert events[0][3].startswith("0/3 nodes are available: 3 Insufficient")
    assert events[0][4] == "fit|fit"
    assert len(events) == 2     # occurrences 1 and 2 emit, 3 waits for 4


# --------------------------------------------------------------------- #
# the event sink's retry budget, on a client with the event calls
# --------------------------------------------------------------------- #


class _StatusError(Exception):
    def __init__(self, code, details=None):
        super().__init__(f"status {code}")
        self.code = code
        self.details = details or {}


class _Events:
    def __init__(self, fail_codes=()):
        self.fail = list(fail_codes)
        self.store = {}
        self.calls = 0

    def _maybe_fail(self):
        self.calls += 1
        if self.fail:
            raise _StatusError(self.fail.pop(0))

    def create(self, obj, ns):
        self._maybe_fail()
        self.store[obj["metadata"]["name"]] = dict(obj)
        return obj

    def get(self, name, ns):
        self._maybe_fail()
        if name not in self.store:
            raise _StatusError(404)
        return dict(self.store[name])

    def update(self, obj, ns):
        self._maybe_fail()
        self.store[obj["metadata"]["name"]] = dict(obj)
        return obj


class _Client:
    def __init__(self, events):
        self.events = events


def test_sink_retry_budget_absorbs_pushback():
    """429/503 retry within the budget; a repeat bumps the Event's count;
    any other status fails fast and is counted; an Event swept away is
    created afresh."""
    fast = TE.RetryPolicy(attempts=3, base_s=0.001, cap_s=0.002,
                          deadline_s=1.0)
    ev = _Events(fail_codes=(429, 503))
    sink = TE.APIEventSink(_Client(ev), retry=fast)
    assert sink.emit("default", "p0", "FailedScheduling", "m1", "fp")
    assert sink.writes == 1 and ev.calls == 3 and len(ev.store) == 1
    assert sink.emit("default", "p0", "FailedScheduling", "m2", "fp")
    (obj,) = ev.store.values()
    assert obj["count"] == 2 and obj["message"] == "m2"
    ev.fail = [500]
    assert not sink.emit("default", "p1", "FailedScheduling", "m", "fp")
    assert sink.errors == 1
    ev.store.clear()
    assert sink.emit("default", "p0", "FailedScheduling", "m3", "fp")
    assert len(ev.store) == 1 and sink.writes == 3
    ev.fail = [429] * 5
    assert not sink.emit("default", "p2", "FailedScheduling", "m", "fp2")
    assert sink.errors == 2


def _fleet_explain(side):
    """test_explain.py's TestFleetExplain on one package: t00's pod fits
    under its DRF headroom but on no single node; t01's fits."""
    if side == "jax":
        from kubernetes_tpu.fleet import FleetServer
        from kubernetes_tpu.models.workloads import make_nodes
        from kubernetes_tpu.state.dims import Dims
        T, kw = JT, {}
    else:
        from kubernetes_tpu_torch.fleet import FleetServer
        from kubernetes_tpu_torch.models.workloads import make_nodes
        from kubernetes_tpu_torch.state.dims import Dims
        T, kw = TT, {"device": "cpu"}
    clk = {"t": 0.0}
    srv = FleetServer(batch_size=32, base_dims=Dims(N=8, P=32, E=64),
                      clock=lambda: clk["t"], **kw)
    srv.prewarmer.enabled = False
    for k in range(2):
        t = srv.add_tenant(f"t{k:02d}")
        for n in make_nodes(4):
            t.on_node_add(n)
    srv.tenant("t00").on_pod_add(T.Pod(
        name="p0", requests=T.Resources.make(cpu="64", memory="16Mi"),
        creation_index=0))
    srv.tenant("t01").on_pod_add(_pod(T, 0))
    return srv, srv.tick()


class TestFleetExplain:
    def test_attribution_is_per_tenant(self, monkeypatch):
        monkeypatch.setenv("KTPU_EXPLAIN", "1")
        jsrv, _ = _fleet_explain("jax")
        srv, tick = _fleet_explain("port")
        assert tick.per_tenant["t00"].unschedulable == 1
        assert tick.per_tenant["t01"].scheduled == 1
        doc = srv.tenant("t00").sched.explainer.why("default/p0")
        assert doc is not None and doc["reasons"] == {"fit": 4}
        assert doc["reasons"] == \
            jsrv.tenant("t00").sched.explainer.why("default/p0")["reasons"]
        # tenant isolation: t01's explainer never saw t00's pod
        assert srv.tenant("t01").sched.explainer.why("default/p0") is None
