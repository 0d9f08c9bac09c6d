"""The sequential-assume scan (ROADMAP B7) on the CPU: the port's
`assign_scan_plain` and K4's wrapper (ops/kernels.py `assign_scan`, whose
CPU route is the plain version) against the JAX package's `assign_batch`,
on chip_smoke.py's phase-2 workloads (`scan_workload`, built from a seed)
shrunk to N ≤ 64 and encoded once by the JAX package's encoder for both.

Placements, the eight integer planes and WSYM are held exactly; the Score
rows against the final state within F32_ATOL or 2 ulps (XLA's CPU backend
contracts some weighted score sums into fused multiply-adds, ROADMAP §C).
Beside them: the initial state is never written, the runs engine with its
per-pod fallback (one scan call per self-interacting run) equals the scan,
gang rounds through the scan equal the JAX package's, and the wrapper
refuses tensors on another device, a non-contiguous table and a wrongly
typed plane. The kernel itself runs on the card only
(tests/test_torch_cuda.py).
"""

import dataclasses
import functools
import importlib.util
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.api.types as JT
from kubernetes_tpu.ops import assign as JA
from kubernetes_tpu.ops import lattice as JL
from kubernetes_tpu.ops.gang import assign_gang as j_assign_gang
from kubernetes_tpu.ops.runs import assign_runs as j_assign_runs
from kubernetes_tpu.ops.runs import plan_runs as j_plan_runs
from kubernetes_tpu_torch.ops import assign as A
from kubernetes_tpu_torch.ops import kernels as K
from kubernetes_tpu_torch.ops import runs as R
from kubernetes_tpu_torch.ops.gang import assign_gang
from kubernetes_tpu_torch.ops.lattice import default_engine_config
from kubernetes_tpu_torch.sched.cycle import _cycle
from kubernetes_tpu_torch.state.arrays import GangArrays, to_device
from test_golden import rand_node, rand_pod
from torch_parity import CPU, F32_ATOL, as_np, encode

REPO = Path(__file__).resolve().parents[1]
INT_PLANES = ("used", "ppa", "ppw", "ppt", "CNT", "HOLD", "vol_any", "vol_rw")
FLAGS = ("f_unsched", "f_name", "f_ports", "f_node_affinity", "f_fit",
         "f_taints", "f_interpod", "f_spread", "f_volrestrict", "f_vollimits")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()

# phase 2's cases (chip_smoke.py k4_edge_cases) at N ≤ 64: (id, workload
# arguments, EngineConfig overrides, hardPodAffinitySymmetricWeight, every
# how many pending rows is made invalid)
CASES = [
    ("mixed-invalid-rows", dict(n_nodes=40, n_pods=90, seed=0), {}, 1.0, 7),
    ("identical-nodes-ties", dict(n_nodes=33, n_pods=80, seed=1,
                                  identical=True), {}, 1.0, 0),
    *[(f"{f}-off", dict(n_nodes=24, n_pods=50, seed=10 + k), {f: 0.0}, 1.0,
       0) for k, f in enumerate(FLAGS)],
    ("weights-hard-weight-2", dict(n_nodes=24, n_pods=60, seed=2),
     dict(w_least=0.5, w_most=1.0, w_interpod=2.0, w_ssel=3.0), 2.0, 0),
    ("r16-scalars", dict(n_nodes=32, n_pods=80, seed=3, scalars=12), {}, 1.0,
     0),
    ("no-terms", dict(n_nodes=32, n_pods=80, seed=4, terms=False), {}, 1.0,
     0),
    ("one-node", dict(n_nodes=1, n_pods=12, seed=5), {}, 1.0, 0),
    ("hostname-key-d-eq-n", dict(n_nodes=63, n_pods=80, seed=6,
                                 hostname=True), {}, 1.0, 0),
]


@functools.partial(jax.jit, static_argnums=(5,))
def _jax_scan(tables, ex, pe, uk, ev, D, hw, ecfg):
    cyc = JL.build_cycle(tables, ex, uk, ev, D, hw, ecfg)
    res = JA.assign_batch(tables, cyc, pe, JA.initial_state(tables, cyc))
    SC = tables.classes.valid.shape[0]
    scores = jax.vmap(lambda c: JA.score_row(tables, cyc, res.state, c))(
        jnp.arange(SC))
    return res, scores


def _case_inputs(wl, invalid_every):
    nodes, existing, pending = CS.scan_workload(JT, **wl)
    enc = encode(nodes, existing, pending)
    if invalid_every:
        keep = np.arange(enc["np"][2].valid.shape[0]) % invalid_every != 0
        jt, jex, jpe = enc["jax"]
        enc["jax"] = (jt, jex, jpe._replace(valid=jpe.valid & keep))
        tt, tex, tpe = enc["torch"]
        enc["torch"] = (tt, tex, tpe._replace(
            valid=tpe.valid & torch.from_numpy(keep)))
    return enc


def _ulps_close(got, want, name):
    """|got - want| within F32_ATOL or 2 ulps of want."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = np.maximum(F32_ATOL, 2 * np.spacing(np.abs(want)))
    bad = ~(np.abs(got - want) <= tol)
    assert not bad.any(), f"{name}: {int(bad.sum())} cells off, first " \
        f"{got[bad][:3]} vs {want[bad][:3]}"


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_scan_matches_jax(case):
    _, wl, cfg_over, hw, invalid_every = case
    enc = _case_inputs(wl, invalid_every)
    tables, ex, pe = enc["torch"]
    D = enc["dims"].D
    cfg = default_engine_config()._replace(**cfg_over)
    cyc = _cycle(tables, ex, enc["keys"], D, hw, cfg)
    init = A.initial_state(tables, cyc)
    before = [t.clone() for t in init]
    rows = A.queue_order(pe).to(torch.int32)
    plain = A.assign_scan_plain(tables, cyc, pe, rows, init)
    wrapped = K.assign_scan(tables, cyc, pe, rows, init)
    batch = A.assign_batch(tables, cyc, pe, init)
    for b, t in zip(before, init):
        assert torch.equal(b, t), "the scan wrote its initial state"

    jt, jex, jpe = enc["jax"]
    uk, ev = enc["keys"]
    ref, ref_scores = _jax_scan(
        jt, jex, jpe, jnp.int32(uk), jnp.int32(ev), D, jnp.float32(hw),
        JL.EngineConfig(*(jnp.float32(x) for x in cfg)))
    for who, (node, state) in (("plain", plain), ("wrapper", wrapped),
                               ("assign_batch", (batch.node, batch.state))):
        np.testing.assert_array_equal(as_np(node), as_np(ref.node),
                                      err_msg=who)
        for f in INT_PLANES:
            np.testing.assert_array_equal(
                as_np(getattr(state, f)), as_np(getattr(ref.state, f)),
                err_msg=f"{who} {f}")
        assert (as_np(state.WSYM) == as_np(ref.state.WSYM)).all(), who
    assert int((as_np(plain[0]) >= 0).sum()) > 0
    SC = tables.classes.valid.shape[0]
    scores = A.score_row(tables, cyc, plain[1], torch.arange(SC))
    _ulps_close(as_np(scores), as_np(ref_scores), "score rows")


def test_scan_workloads_reach_every_part():
    """The phase-2 workloads reach what K4 must get right: a pod that fits
    nowhere and one pinned to a missing node stay unplaced, pinned pods
    land on their node, ports and volumes are committed, soft spread,
    preferred terms and SelectorSpread are encoded."""
    nodes, existing, pending = CS.scan_workload(JT, 40, 90, seed=0)
    enc = encode(nodes, existing, pending)
    tables, ex, pe = enc["torch"]
    cyc = _cycle(tables, ex, enc["keys"], enc["dims"].D)
    res = A.assign_batch(tables, cyc, pe, A.initial_state(tables, cyc))
    node = res.node.tolist()
    assert node[0] == -1 and node[1] == -1          # huge, ghost
    names = [n.name for n in nodes]
    for i, p in enumerate(pending[2:], 2):
        if p.node_name and node[i] >= 0:
            assert names[node[i]] == p.node_name
    st, cl = res.state, tables.classes
    assert bool((st.ppa != 0).any()) and bool((st.vol_any != 0).any())
    assert bool(((cl.tsc_term >= 0) & ~cl.tsc_hard).any())
    assert bool((cl.paff_terms >= 0).any()) and bool(
        (cl.panti_terms >= 0).any()) and bool((cl.ssel_terms >= 0).any())


def test_even_bound_case_passes_2_24_in_total_only():
    """chip_smoke.py's k4_even_bound_case, on which K4 must raise on the
    card (tests/test_torch_cuda.py): a soft zone spread whose per-node
    counts (the share any one thread of the kernel sums) stay far below
    2^24 while the eligible nodes' total, which the plain version sums in
    f32, passes it. The plain version runs it on the CPU."""
    tables, cyc, pe, rows, init = CS.k4_even_bound_case(CPU)
    cl, nodes = tables.classes, tables.nodes
    c = int(pe.cls[0])
    assert bool((pe.cls[pe.valid] == c).all())
    (slot,) = torch.nonzero(cl.tsc_term[c] >= 0).flatten().tolist()
    assert not bool(cl.tsc_hard[c, slot])
    s = int(cl.tsc_term[c, slot])
    dom = nodes.domain[:, int(tables.terms.topo_key[s])].long()
    elig = cyc.static.node_match[c] & nodes.valid & (dom >= 0)
    zone = torch.zeros(int(dom.max()) + 1, dtype=torch.int64).index_add_(
        0, dom[elig], init.CNT[s][elig].to(torch.int64))
    raw = zone[dom[elig]]
    assert int(raw.max()) < 2 ** 24 // 16
    assert int(raw.sum()) >= 2 ** 24
    node, _ = K.assign_scan(tables, cyc, pe, rows, init)
    assert int((node >= 0).sum()) == int(pe.valid.sum())


def test_even_bound_case_passes_2_24_only_over_the_cluster():
    """At cluster size 16 (where the card must still refuse it), every
    CTA's share of k4_even_bound_case's eligible total stays under 2^24:
    only the fold over the whole cluster passes it."""
    tables, cyc, pe, rows, init = CS.k4_even_bound_case(CPU)
    cl, nodes = tables.classes, tables.nodes
    c = int(pe.cls[0])
    s = int(cl.tsc_term[c][cl.tsc_term[c] >= 0][0])
    dom = nodes.domain[:, int(tables.terms.topo_key[s])].long()
    elig = cyc.static.node_match[c] & nodes.valid & (dom >= 0)
    zone = torch.zeros(int(dom.max()) + 1, dtype=torch.int64).index_add_(
        0, dom[elig], init.CNT[s][elig].to(torch.int64))
    raw = torch.where(elig, zone[dom.clamp(min=0)], 0)
    dims = K.k4_check(K.k4_inputs(tables, cyc, pe, rows, init), CPU)
    for cluster in (2, 4, 8, 16):
        cfg = K.k4_launch_config(dims, cluster=cluster)
        shares = [int(raw[r * cfg.slice:(r + 1) * cfg.slice].sum())
                  for r in range(cluster)]
        assert max(shares) < 2 ** 24 <= sum(shares), (cluster, shares)


def test_runs_fallback_equals_the_scan():
    """The runs engine on a backlog of plain replica runs, self-interacting
    (spread) pods and a pinned pod: the fallback runs go through the scan
    (one call per run), and the placements and planes equal the port's scan
    and the JAX package's runs engine."""
    T = JT
    spread = (T.TopologySpreadConstraint(
        max_skew=1, topology_key="topology.kubernetes.io/zone",
        when_unsatisfiable=T.UnsatisfiableAction.DO_NOT_SCHEDULE,
        selector=T.LabelSelector.of(match_labels={"app": "s"})),)
    nodes = CS.scan_workload(T, 24, 1, seed=7)[0]
    pending = []
    for i in range(120):
        if i % 10 == 0:
            pending.append(T.Pod(name=f"s{i}", labels={"app": "s"},
                                 topology_spread=spread, creation_index=i,
                                 requests=T.Resources.make(cpu="20m")))
        else:
            pending.append(T.Pod(name=f"d{i}", labels={"app": f"d{i // 30}"},
                                 creation_index=i,
                                 requests=T.Resources.make(
                                     cpu=f"{100 + i // 30}m")))
    pending[55] = dataclasses.replace(pending[55], node_name="n3")
    enc = encode(nodes, [], pending)
    tables, ex, pe = enc["torch"]
    cyc = _cycle(tables, ex, enc["keys"], enc["dims"].D)
    init = A.initial_state(tables, cyc)
    plan = j_plan_runs(*(np.asarray(x) for x in (
        enc["np"][2].cls, enc["np"][2].priority, enc["np"][2].creation,
        enc["np"][2].valid, enc["np"][2].node_name_req)))
    R.reset_run_stats()
    calls = A.assign_scan_plain.calls
    runs = R.assign_runs(tables, cyc, pe, init, plan.rc)
    assert R.assign_runs.stats["fallback"] >= 13
    assert A.assign_scan_plain.calls - calls == R.assign_runs.stats[
        "fallback"]
    scan = A.assign_batch(tables, cyc, pe, init)
    jt, jex, jpe = enc["jax"]
    uk, ev = enc["keys"]
    jcyc = JL.build_cycle(jt, jex, jnp.int32(uk), jnp.int32(ev),
                          enc["dims"].D)
    jruns = j_assign_runs(jt, jcyc, jpe, JA.initial_state(jt, jcyc),
                          plan.rc)
    for want in (scan, jruns):
        np.testing.assert_array_equal(as_np(runs.node), as_np(want.node))
        for f in INT_PLANES:
            np.testing.assert_array_equal(as_np(getattr(runs.state, f)),
                                          as_np(getattr(want.state, f)), f)


@functools.partial(jax.jit, static_argnums=(6,))
def _j_gang_scan(tables, ex, pe, gang, uk, ev, D):
    cyc = JL.build_cycle(tables, ex, uk, ev, D)
    return j_assign_gang(tables, cyc, pe, JA.initial_state(tables, cyc), gang,
                         engine_fn=JA.assign_batch)


@pytest.mark.parametrize("seed", range(3))
def test_gang_rounds_through_the_scan_match_jax(seed):
    """Gang rejection rounds whose engine is the scan (a nodeName batch's
    route): every round starts from the same initial state, which the scan
    never writes; placements, dead groups and planes equal the JAX
    package's."""
    rng = random.Random(9100 + seed)
    nodes = [rand_node(rng, i) for i in range(rng.randint(4, 8))]
    pending = [rand_pod(rng, i) for i in range(rng.randint(10, 16))]
    for i, p in enumerate(pending):
        if rng.random() < 0.6:
            pending[i] = dataclasses.replace(
                p, pod_group=f"g{rng.randrange(3)}",
                min_member=rng.randint(1, 4))
    enc = encode(nodes, [], pending)
    gang_np = enc["encoder"].build_gang_arrays(pending, enc["dims"])
    tables, ex, pe = enc["torch"]
    cyc = _cycle(tables, ex, enc["keys"], enc["dims"].D)
    init = A.initial_state(tables, cyc)
    before = [t.clone() for t in init]
    gang = GangArrays(*(to_device(a, CPU) for a in gang_np))
    got, dead = assign_gang(tables, cyc, pe, init, gang,
                            engine_fn=A.assign_batch)
    assert all(torch.equal(b, t) for b, t in zip(before, init))
    jt, jex, jpe = enc["jax"]
    uk, ev = enc["keys"]
    ref, ref_dead = _j_gang_scan(jt, jex, jpe, jax.device_put(gang_np),
                                 jnp.int32(uk), jnp.int32(ev),
                                 enc["dims"].D)
    np.testing.assert_array_equal(as_np(got.node), as_np(ref.node))
    np.testing.assert_array_equal(as_np(dead), as_np(ref_dead))
    for f in ("used", "CNT", "HOLD"):
        np.testing.assert_array_equal(as_np(getattr(got.state, f)),
                                      as_np(getattr(ref.state, f)), f)


def _small():
    enc = encode(*CS.scan_workload(JT, 8, 12, seed=3))
    tables, ex, pe = enc["torch"]
    cyc = _cycle(tables, ex, enc["keys"], enc["dims"].D)
    return (tables, cyc, pe, A.queue_order(pe).to(torch.int32),
            A.initial_state(tables, cyc))


@pytest.mark.parametrize("fault", ["device", "non-contiguous", "dtype",
                                   "shape", "rows-dtype"])
def test_wrapper_refuses_bad_inputs(fault):
    """K4's wrapper checks on both routes: every tensor on the state's
    device (a tensor elsewhere — the meta device beside CPU tensors, a CPU
    tensor beside CUDA ones on the card — raises), contiguous tables, each
    plane's dtype, dimensions that agree, int32 rows."""
    tables, cyc, pe, rows, init = _small()
    if fault == "device":
        cyc = cyc._replace(TM=cyc.TM.to("meta"))
    elif fault == "non-contiguous":
        mask = cyc.static.mask
        wide = torch.zeros((mask.shape[0], 2 * mask.shape[1]),
                           dtype=torch.bool)
        wide[:, ::2] = mask
        cyc = cyc._replace(static=cyc.static._replace(mask=wide[:, ::2]))
    elif fault == "dtype":
        init = init._replace(CNT=init.CNT.to(torch.int64))
    elif fault == "shape":
        init = init._replace(HOLD=init.HOLD[:, :-1])
    else:
        rows = rows.to(torch.int64)
    with pytest.raises(ValueError):
        K.assign_scan(tables, cyc, pe, rows, init)


def test_strided_state_planes_are_taken():
    """build_cycle's count planes are column slices of a wider scatter
    target; the wrapper takes them (the kernel writes contiguous clones)
    and the plain version equals a run on contiguous copies."""
    tables, cyc, pe, rows, init = _small()
    assert not init.CNT.is_contiguous()
    got = K.assign_scan(tables, cyc, pe, rows, init)
    want = K.assign_scan(tables, cyc, pe, rows, type(init)(
        *(t.contiguous() for t in init)))
    assert torch.equal(got[0], want[0])
    for x, y in zip(got[1], want[1]):
        assert torch.equal(x, y)


def test_k4_is_built_with_its_own_flags():
    """K4 adds -fmad=false to the shared nvcc flags and K1–K3's builds keep
    theirs: their library names (a hash of source and flags) do not move."""
    assert "assign_scan" in K.KERNELS
    assert K.nvcc_flags("assign_scan") == K.NVCC_FLAGS + ("-fmad=false",)
    for name in ("contention_scan", "domain_rank", "reprieve_scan"):
        assert K.nvcc_flags(name) == K.NVCC_FLAGS
    assert K.launch_counts()["assign_scan"] == K.assign_scan.launches
    import ctypes
    import re

    src = (K.CSRC / "assign_scan.cu").read_text()
    body = src[src.index("struct Args {"):]
    body = body[:body.index("};")]
    assert re.findall(r"\*\s*(\w+);", body) == list(K.K4_POINTERS)

    def names(kind):
        return [n.strip() for decl in re.findall(
            rf"^\s*{kind} ([^;(]+);", body, re.M) for n in decl.split(",")]

    assert names("int") == list(K.K4_INTS)
    assert names("float") == list(K.K4_FLOATS)
    packed = 8 * len(K.K4_POINTERS) + 4 * (len(K.K4_INTS)
                                           + len(K.K4_FLOATS))
    assert ctypes.sizeof(K.K4Args) == -(-packed // 8) * 8  # no inner padding
    # the fold and exchange slots' sizes (struct Red over the block's
    # warps, struct Xch over the cluster's CTAs), which k4_layout counts
    consts = dict(re.findall(r"constexpr int (kMaxThreads|kMaxCluster) = "
                             r"(\d+);", src))
    warps, ctas = int(consts["kMaxThreads"]) // 32, int(consts["kMaxCluster"])
    assert K.K4_RED_BYTES == warps * (3 * 4 + 2 * 8 + 2 * 4 + 8)
    assert K.K4_XCH_BYTES == ctas * (8 * 8 + 4) + 2 * 4 + 2 * 8
    assert K.K4_MAX_THREADS == int(consts["kMaxThreads"])
    assert K.K4_MAX_CLUSTER == ctas
    # the shared-memory placement bits, in K4_PLACE's order
    bits = dict(re.findall(r"constexpr int k(Node|Ring|Rows|Hist|Cnt|Dtot|"
                           r"Words) = (\d+);", src))
    assert [int(bits[n.capitalize()]) for n in K.K4_PLACE] == [
        1 << i for i in range(len(K.K4_PLACE))]


# 13a's dimensions (the flagship with pinned pods on make_nodes(5000))
K4_DIMS = dict(N=5120, R=4, K=4, DR=2, PWp=1, PWt=1, VW=1, S=72, SC=52, AT=2,
               AN=1, PAT=2, PAN=2, TS=1, SS=2, D=5120, Q=10240, P=10240)


@pytest.mark.parametrize("D", [0, 3, 5000])
@pytest.mark.parametrize("N", [1, 31, 1023, 1025, 5120, 29000])
def test_k4_launch_config_covers_every_node_once(N, D):
    """K4's launch shape from the shapes alone: a cluster of 1, 2, 4, 8 or
    16 CTAs whose slices hold every node exactly once, none empty when
    the cluster has more than one CTA; threads a multiple of 32, one a
    node up to K4_MAX_THREADS; the shared bytes per CTA within an H100's
    232,448 and equal to the layout of the regions placed there."""
    d = dict(K4_DIMS, N=N, D=D)
    cfg = K.k4_launch_config(d)
    assert cfg.cluster in (1, 2, 4, 8, 16)
    owner = np.zeros(N, dtype=np.int64)
    for r in range(cfg.cluster):
        owner[r * cfg.slice:min(N, (r + 1) * cfg.slice)] += 1
        if cfg.cluster > 1:
            assert r * cfg.slice < N, f"CTA {r} owns no node"
    assert (owner == 1).all()
    assert cfg.slice * cfg.cluster >= N
    assert cfg.threads % 32 == 0 and 32 <= cfg.threads <= K.K4_MAX_THREADS
    assert cfg.threads >= min(cfg.slice, K.K4_MAX_THREADS)
    assert cfg.smem_bytes <= 232448 == K.SMEM_MAX
    assert K.k4_layout(d, cfg.slice, cfg.cbw, cfg.place)[0] == cfg.smem_bytes
    assert cfg.cbw == K.k4_cbw(d)
    # a region left out did not fit beside the ones placed
    for bit in range(len(K.K4_PLACE)):
        if not cfg.place >> bit & 1:
            assert K.k4_layout(d, cfg.slice, cfg.cbw,
                               cfg.place | 1 << bit)[0] > K.SMEM_MAX


def test_k4_cluster_size_follows_n():
    """The smallest cluster that leaves each CTA at most 320 nodes: one
    CTA up to 320 nodes, 8 at the fleet's 2,048, 16 at 13a's 5,120 and (at
    most) at 29,000; an explicit size is taken as given, and only 1, 2, 4,
    8 or 16."""
    cluster = {N: K.k4_launch_config(dict(K4_DIMS, N=N)).cluster
               for N in (1, 320, 321, 2048, 5120, 29000)}
    assert cluster == {1: 1, 320: 1, 321: 2, 2048: 8, 5120: 16, 29000: 16}
    for c in (1, 2, 4, 8, 16):
        cfg = K.k4_launch_config(dict(K4_DIMS, N=3), cluster=c)
        assert cfg.cluster == c and cfg.slice * c >= 3
    with pytest.raises(ValueError):
        K.k4_launch_config(K4_DIMS, cluster=3)
    # one CTA over 29,000 nodes: the per-node values and the row ring
    # leave shared memory for the scratch, the kernel stays the same
    cfg = K.k4_launch_config(dict(K4_DIMS, N=29000), cluster=1)
    assert cfg.slice == 29000 and cfg.smem_bytes <= K.SMEM_MAX
    assert not cfg.place & 0b11
    # the mandatory part (per-term keys, totals and bounds) does not fit
    # for ~15,000 terms
    with pytest.raises(ValueError):
        K.k4_launch_config(dict(K4_DIMS, S=15000))


def test_k4_constants_are_torch_f32_values():
    """The f32 values K4 multiplies and clamps by are the ones torch uses
    for the plain version's Python floats."""
    zw_node, zw_zone, eps = K.k4_constants(CPU)
    one = torch.ones(3)
    assert (one * (1.0 - 2.0 / 3.0))[0].item() == zw_node
    assert (one * (2.0 / 3.0))[0].item() == zw_zone
    assert torch.clamp(one * 0.0, min=1e-9)[0].item() == eps
    assert np.float32(zw_node) == np.float32(1 / 3)
