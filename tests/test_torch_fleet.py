"""The port's fleet (kubernetes_tpu_torch/fleet/) against the JAX package's
(kubernetes_tpu/fleet/): tests/test_fleet.py's cases, each script run on
both packages on the CPU with every tenant's bound (pod, node) list
compared, plus the DRF clamp's parity at real magnitudes and the float32
reduction orders it reproduces.

The JAX side runs as its own tests run it on the CPU; the port runs with
`device="cpu"`. test_fleet.py's mesh cases are in test_torch_fleet_mesh.py;
here one parametrised test holds that the mesh requests are taken.
"""

import importlib
import types as pytypes

import numpy as np
import pytest
import torch

PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")


def _stack_leaves(stack):
    from kubernetes_tpu_torch.fleet.tables import _leaves

    return _leaves(stack.block)


def api(pkg: str):
    """One package's fleet surface under the same names on both sides."""
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    port = pkg == "kubernetes_tpu_torch"
    fleet = m("fleet")
    types = m("api.types")
    sched = m("sched.scheduler")
    return pytypes.SimpleNamespace(
        pkg=pkg, port=port, fleet=fleet, FleetServer=fleet.FleetServer,
        tenant_ledger=fleet.tenant_ledger, Node=types.Node, Pod=types.Pod,
        Resources=types.Resources, Dims=m("state.dims").Dims,
        RecordingBinder=sched.RecordingBinder, Scheduler=sched.Scheduler,
        faultline=m("utils.faultline"), APIServer=m("apiserver").APIServer,
        dev={"device": "cpu"} if port else {},
        sched_kw={"device": "cpu"} if port else {"mesh": 0})


JAX, PORT = api(PACKAGES[0]), api(PACKAGES[1])


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    JAX.faultline.uninstall()
    PORT.faultline.uninstall()


def mknode(A, i, cpu="8"):
    return A.Node(name=f"n{i}",
                  allocatable=A.Resources.make(cpu=cpu, memory="16Gi",
                                               pods=110))


def feed(A, t, tn, n, cpu="100m", prio=None):
    for i in range(n):
        t.on_pod_add(A.Pod(name=f"{tn}-p{i}",
                           requests=A.Resources.make(cpu=cpu, memory="8Mi"),
                           priority=(prio(i) if prio else 0),
                           creation_index=i))


def det_server(A, **kw):
    """A FleetServer on a deterministic clock (1 virtual second per tick),
    as test_fleet.py builds it."""
    clk = {"t": 0.0}
    srv = A.FleetServer(clock=lambda: clk["t"], **A.dev, **kw)
    orig_tick = srv.tick

    def ticking(now=None):
        out = orig_tick(now)
        clk["t"] += 1.0
        return out

    srv.tick = ticking
    return srv


def build_fleet(A, spec, batch_size=16, storage=None, cpu="8",
                pod_cpu="100m", **kw):
    """spec: [(name, n_nodes, n_pods, quota)] → (server, {name: binder})."""
    srv = det_server(A, batch_size=batch_size, storage=storage, **kw)
    binders = {}
    for name, n_nodes, n_pods, quota in spec:
        b = A.RecordingBinder()
        binders[name] = b
        t = srv.add_tenant(name, binder=b, quota=quota)
        for i in range(n_nodes):
            t.on_node_add(mknode(A, i, cpu=cpu))
        feed(A, t, name, n_pods, cpu=pod_cpu)
    return srv, binders


def bound(binders):
    return {n: sorted(b.bound) for n, b in binders.items()}


def both(script):
    """Run `script(A)` on each package; assert the returned bound maps are
    equal and return the port's."""
    want = script(JAX)
    got = script(PORT)
    assert got == want
    return got


# --------------------------------------------------------------------- #
# dims and stacking
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("A", [JAX, PORT], ids=["jax", "port"])
class TestFleetDims:
    def test_union_is_fieldwise_max(self, A):
        a = A.Dims().grown_for(N=32, P=8)
        b = A.Dims().grown_for(N=8, E=64)
        u = a.union(b)
        assert u.N == a.N and u.E == b.E and u.P == a.P
        assert u == u.union(a) == u.union(b)

    def test_union_ors_node_name_flag(self, A):
        from dataclasses import replace

        a = replace(A.Dims(), has_node_name=True)
        assert a.union(A.Dims()).has_node_name
        assert A.Dims().union(a).has_node_name

    def test_fleet_dims_clears_routing_flag(self, A):
        from dataclasses import replace

        tables = importlib.import_module(f"{A.pkg}.fleet.tables")
        d = tables.fleet_dims([replace(A.Dims().grown_for(N=32),
                                       has_node_name=True)])
        assert not d.has_node_name
        assert d.N == 32


class TestStacking:
    def test_stacked_shapes_carry_leading_tenant_axis(self):
        from kubernetes_tpu_torch.fleet.tables import (empty_tenant_block,
                                                       stack_blocks)

        d = PORT.Dims().grown_for(N=16, P=8, E=8)
        blocks = [empty_tenant_block(d, "cpu") for _ in range(3)]
        tables, pending, existing = stack_blocks(blocks)
        assert tables.nodes.alloc.shape[0] == 3
        assert tuple(pending.valid.shape) == (3, d.P)
        assert tuple(existing.valid.shape) == (3, d.E)

    def test_pad_tenant_is_inert(self):
        """An empty-cluster pad tenant admits nothing through any engine."""
        from kubernetes_tpu_torch.fleet.cycle import dispatch_fleet
        from kubernetes_tpu_torch.fleet.tables import (empty_tenant_block,
                                                       stack_blocks)

        d = PORT.Dims().grown_for(N=8, P=8, E=8)
        tables, pending, existing = stack_blocks(
            [empty_tenant_block(d, "cpu") for _ in range(2)])
        for engine in ("waves", "scan", "runs"):
            res = dispatch_fleet(tables, pending, [(0, 0)] * 2, d.D,
                                 existing, engine, torch.ones(2), rc=1)
            assert not bool(res.feasible.any())
            assert int((res.node >= 0).sum()) == 0

    def test_unchanged_tenant_skips_patch_changed_one_patches(self):
        """The JAX package's donated-patch case (test_fleet.py) on the
        port's in-place row patch: no restack without a shape change, the
        changed tenant's row written in place (donated_patches grows, every
        resident leaf on its storage), no donation failure."""
        srv, binders = build_fleet(
            PORT, [("a", 2, 4, 1.0), ("b", 2, 0, 1.0)], batch_size=2)
        srv.tick()
        assert srv.stack.full_restacks >= 1
        patched0 = srv.stack.row_patches
        donated0 = srv.stack.donated_patches
        restacks0 = srv.stack.full_restacks
        ptrs = [a.data_ptr() for a in _stack_leaves(srv.stack)]
        srv.tick()  # a changed (pods bound), b is identical
        assert srv.stack.full_restacks == restacks0
        assert srv.stack.row_patches == patched0 + 1
        assert srv.stack.donated_patches > donated0
        assert srv.stack.donation_failures == 0
        assert [a.data_ptr() for a in _stack_leaves(srv.stack)] == ptrs

    def test_row_patch_equals_a_restack(self):
        """The batched row patch leaves the resident stack equal, leaf for
        leaf, to a fresh stack of the same snapshots."""
        from kubernetes_tpu_torch.fleet.tables import _leaves, stack_blocks

        srv, _ = build_fleet(PORT, [("a", 3, 5, 1.0), ("b", 2, 3, 1.0),
                                    ("c", 2, 0, 1.0)], batch_size=2)
        srv.tick()
        srv.tick()
        st = srv.stack
        assert st.row_patches > 0
        snaps = st._snaps
        fresh = stack_blocks([st._row(s) for s in snaps])
        for a, b in zip(_leaves(st.block), _leaves(fresh)):
            assert torch.equal(a, b)

    def test_invalidated_stack_restacks_and_keeps_the_old_tensors(self):
        """After invalidate() — the server's response to an abandoned
        dispatch, whose worker may still read the stack — a changed tenant
        restacks onto fresh tensors instead of being written in place: the
        old tensors stay as the worker read them."""
        srv, _ = build_fleet(PORT, [("a", 2, 4, 1.0), ("b", 2, 0, 1.0)],
                             batch_size=2)
        srv.tick()
        st = srv.stack
        old = _stack_leaves(st)
        kept = [a.clone() for a in old]
        st.invalidate()
        restacks0, donated0 = st.full_restacks, st.donated_patches
        srv.tick()
        assert st.full_restacks == restacks0 + 1
        assert st.donated_patches == donated0
        assert all(torch.equal(a, b) for a, b in zip(old, kept))
        assert all(a.data_ptr() != b.data_ptr()
                   for a, b in zip(old, _stack_leaves(st)))

    def test_in_place_patch_counts_each_changed_tenant(self):
        """Two changed tenants in one refresh: both rows written in place in
        one index_copy_ per leaf (row_patches and donated_patches grow by
        two, no leaf moves), the third tenant's row untouched, and the
        stack equal to a fresh one."""
        import dataclasses

        from kubernetes_tpu_torch.fleet.tables import _leaves, stack_blocks

        srv, _ = build_fleet(PORT, [("a", 2, 4, 1.0), ("b", 2, 3, 1.0),
                                    ("c", 2, 0, 1.0)], batch_size=2)
        srv.tick()
        st = srv.stack
        snaps, keys = st._snaps, st.keys_host
        ptrs = [a.data_ptr() for a in _stack_leaves(st)]
        third = [a[2].clone() for a in _stack_leaves(st)]
        patched0, donated0 = st.row_patches, st.donated_patches
        changed = list(snaps)
        changed[0] = dataclasses.replace(snaps[0])   # new snapshot objects
        changed[1] = dataclasses.replace(snaps[1])
        st.refresh(changed, keys, st.dims)
        assert st.row_patches == patched0 + 2
        assert st.donated_patches == donated0 + 2
        assert st.donation_failures == 0
        leaves = _stack_leaves(st)
        assert [a.data_ptr() for a in leaves] == ptrs
        assert all(torch.equal(a[2], b) for a, b in zip(leaves, third))
        fresh = stack_blocks([st._row(s) for s in changed])
        for a, b in zip(leaves, _leaves(fresh)):
            assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# the DRF clamp: goldens, reduction orders, parity at real magnitudes
# --------------------------------------------------------------------- #


def tenant_tables(A, existing_cpu_m=0, pending=8, pending_cpu="500m",
                  prio=None):
    """test_fleet.py's hand-computable tenant: 2 nodes × 2 cpu."""
    cycle = importlib.import_module(f"{A.pkg}.sched.cycle")
    cache_mod = importlib.import_module(f"{A.pkg}.state.cache")
    enc_mod = importlib.import_module(f"{A.pkg}.state.encode")
    cache = cache_mod.SchedulerCache()
    enc = enc_mod.Encoder()
    for i in range(2):
        cache.add_node(mknode(A, i, cpu="2"))
    if existing_cpu_m:
        cache.add_pod(A.Pod(
            name="busy", node_name="n0",
            requests=A.Resources.make(cpu=f"{existing_cpu_m}m"),
            creation_index=0))
    pods = [A.Pod(name=f"p{i}", requests=A.Resources.make(cpu=pending_cpu),
                  priority=(prio(i) if prio else 0), creation_index=i + 1)
            for i in range(pending)]
    kw = {"device": "cpu"} if A.port else {}
    snap, _keys = cycle.snapshot_with_keys(cache, enc, pods, None, **kw)
    return snap, pods


def drf_both(quota, **kw):
    """drf_admission_row of each package on the same tenant → numpy
    (mask, share, dom) pairs, asserted bit-equal."""
    import jax.numpy as jnp

    from kubernetes_tpu.fleet.quota import drf_admission_row as jrow
    from kubernetes_tpu_torch.fleet.quota import drf_admission_row as prow

    js, _ = tenant_tables(JAX, **kw)
    ps, pods = tenant_tables(PORT, **kw)
    want = [np.asarray(a) for a in jrow(js.tables, js.pending,
                                        jnp.float32(quota))]
    got = [a.numpy() for a in prow(ps.tables, ps.pending, quota)]
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    return got, pods


class TestDRFQuota:
    def test_share_and_prefix_waterfill(self):
        # used 1000m of 4000m → share 0.25; quota 0.5 leaves 0.25 headroom
        # = exactly 2 pods of 500m
        (mask, share, _), pods = drf_both(0.5, existing_cpu_m=1000,
                                          pending=6)
        assert abs(float(share) - 0.25) < 1e-5
        m = mask[: len(pods)]
        assert m.sum() == 2 and m[:2].all() and not m[2:].any()

    def test_at_quota_tenant_is_inert(self):
        (mask, share, _), _ = drf_both(0.5, existing_cpu_m=2000, pending=4)
        assert float(share) >= 0.5 - 1e-6
        assert not mask.any()

    def test_priority_orders_the_waterfill(self):
        """Headroom funds one pod; the HIGHEST-priority pending pod gets
        it (queue order: priority desc, creation asc)."""
        (mask, _, _), pods = drf_both(
            0.5, existing_cpu_m=1500, pending=4,
            prio=lambda i: 100 if i == 3 else 0)
        m = mask[: len(pods)]
        assert m[3] and m.sum() == 1

    def test_violation_headroom_invariant(self):
        from kubernetes_tpu_torch.fleet.quota import violation_headroom

        share = torch.tensor([0.2, 0.9])
        quota = torch.tensor([0.5, 0.5])
        dom = torch.tensor([[0.1, 0.1], [0.1, 0.1]])
        ok = torch.tensor([[True, True], [False, False]])
        bad = torch.tensor([[True, True], [True, False]])
        assert not bool(violation_headroom(share, dom, ok, quota).any())
        assert bool(violation_headroom(share, dom, bad, quota)[1])
        # the commit loop's host form
        assert bool(violation_headroom(share.numpy(), dom.numpy(),
                                       bad.numpy(), quota.numpy(),
                                       xp=np)[1])


@pytest.mark.parametrize("sizes", [list(range(1, 301)), [4096], [50000]],
                         ids=["1-300", "4096", "50000"])
def test_prefix_sum_matches_jnp_cumsum_bit_for_bit(sizes):
    """fleet/quota.py prefix_sum_f32 against jnp.cumsum (XLA on the CPU),
    bit for bit, at every size."""
    import jax
    import jax.numpy as jnp

    from kubernetes_tpu_torch.fleet.quota import prefix_sum_f32

    f = jax.jit(jnp.cumsum)
    for P in sizes:
        x = np.random.default_rng(P).random(P).astype(np.float32) * 1e-3
        want = np.asarray(f(x))
        got = prefix_sum_f32(torch.from_numpy(x)).numpy()
        assert got.tobytes() == want.tobytes(), P


@pytest.mark.parametrize("seed", range(4))
def test_column_sum_matches_xla_bit_for_bit(seed):
    """fleet/quota.py column_sum_f32 against XLA's reduction of the same
    float32 columns (the JAX package's capacity_usage_planes arithmetic),
    on int32 inputs up to 2^26, stacked [K, N, R]."""
    import jax
    import jax.numpy as jnp

    from kubernetes_tpu_torch.fleet.quota import column_sum_f32

    rng = np.random.default_rng(seed)
    K, N = 3, int(rng.integers(1, 6000))
    x = rng.integers(0, 2 ** 26, size=(K, N, 4)).astype(np.int32)
    live = rng.random((K, N)) < 0.9
    f = jax.jit(jax.vmap(lambda x, live: jnp.where(
        live[:, None], x, 0).astype(jnp.float32).sum(axis=0)))
    want = np.asarray(f(x, live))
    v = torch.where(torch.from_numpy(live)[..., None], torch.from_numpy(x),
                    torch.zeros((), dtype=torch.int32)).float()
    got = column_sum_f32(v).numpy()
    assert got.tobytes() == want.tobytes()


def _drf_inputs(seed):
    """A stack of K=4 tenants at real magnitudes, built directly as encoded
    planes: N up to 5,000 nodes with allocations up to 64 Gi (KiB), used up
    to the allocation, P up to 4,096 pods over up to 64 request vectors,
    random priorities/creation/validity. Returns (numpy planes, quota)."""
    rng = np.random.default_rng(seed)
    K, R = 4, 4
    N = int(rng.integers(1000, 5001))
    P = int(rng.integers(256, 4097))
    SR, SC = 64, 64
    hi = np.array([256_000, 64 * 2 ** 20, 64 * 2 ** 20, 110], np.int64)
    alloc = (rng.random((K, N, R)) * hi).astype(np.int32)
    used = (rng.random((K, N, R)) * alloc).astype(np.int32)
    # tenant 0 nearly idle: its share then adds less than the prefix's own
    # ulp, so the boundary comparison sees the prefix's last bit
    used[0] //= 1000
    valid = rng.random((K, N)) < 0.95
    valid[3, :] = rng.random(N) < 0.5
    vec = (rng.random((K, SR, R)) ** 3 * hi / 64).astype(np.int32)
    rid = rng.integers(-1, SR, size=(K, SC)).astype(np.int32)
    cls = rng.integers(-1, SC, size=(K, P)).astype(np.int32)
    pvalid = rng.random((K, P)) < 0.9
    prio = rng.integers(0, 4, size=(K, P)).astype(np.int32) * 100
    creation = rng.permutation(K * P).reshape(K, P).astype(np.int32)
    # quotas around each tenant's pre-tick share plus a fraction of its
    # batch's demand, so the prefix boundary falls inside the batch
    quota = np.array([0.05, 0.3, 0.6, 1.0], np.float32)[
        rng.permutation(4)]
    return dict(alloc=alloc, used=used, valid=valid, vec=vec, rid=rid,
                cls=cls, pvalid=pvalid, prio=prio, creation=creation), quota


def _jax_drf(d, quota):
    """The JAX package's drf_admission_row, vmapped over the stack, on the
    encoded planes of `_drf_inputs` → numpy (admitted, share, dom, queue
    order)."""
    import jax
    import jax.numpy as jnp

    from kubernetes_tpu.fleet import quota as jq
    from kubernetes_tpu.ops.assign import queue_order
    from kubernetes_tpu.state.arrays import PodArrays

    def row(alloc, used, valid, vec, rid, cls, pvalid, prio, creation, q):
        t = pytypes.SimpleNamespace(
            nodes=pytypes.SimpleNamespace(valid=valid, alloc=alloc,
                                          used=used),
            classes=pytypes.SimpleNamespace(rid=rid),
            reqs=pytypes.SimpleNamespace(vec=vec))
        z = jnp.zeros_like(cls)
        pe = PodArrays(valid=pvalid, name_id=z, ns=z, cls=cls,
                       priority=prio, creation=creation, node_id=z,
                       node_name_req=z)
        return jq.drf_admission_row(t, pe, q) + (queue_order(pe),)

    f = jax.jit(jax.vmap(row))
    return [np.asarray(a) for a in f(
        d["alloc"], d["used"], d["valid"], d["vec"], d["rid"], d["cls"],
        d["pvalid"], d["prio"], d["creation"], quota)]


def _port_drf(d, quota):
    from kubernetes_tpu_torch.fleet.quota import drf_admission_rows
    from kubernetes_tpu_torch.state.arrays import PodArrays

    T = {k: torch.from_numpy(v) for k, v in d.items()}
    tables = pytypes.SimpleNamespace(
        nodes=pytypes.SimpleNamespace(valid=T["valid"], alloc=T["alloc"],
                                      used=T["used"]),
        classes=pytypes.SimpleNamespace(rid=T["rid"]),
        reqs=pytypes.SimpleNamespace(vec=T["vec"]))
    z = torch.zeros_like(T["cls"])
    pending = PodArrays(valid=T["pvalid"], name_id=z, ns=z, cls=T["cls"],
                        priority=T["prio"], creation=T["creation"],
                        node_id=z, node_name_req=z)
    return [a.numpy() for a in drf_admission_rows(
        tables, pending, torch.from_numpy(quota))]


@pytest.mark.parametrize("seed", range(8))
def test_drf_admission_parity_at_real_magnitudes(seed):
    """drf_admission_row of both packages on one random stack at real
    magnitudes. Both float32 reductions reproduce XLA's CPU order, so
    `share` and `dom` are held bit-equal and `admitted` exact — no
    tolerance. Tenant 0's quota is set so that the middle valid pod of its
    queue order sits on the boundary: quota + DRF_EPS rounds to within an
    ulp of share + prefix there (jnp.cumsum's prefix), the comparison a
    different summation order could flip. The printed count is the pods
    within 4 ulps of the boundary."""
    import jax.numpy as jnp

    from kubernetes_tpu_torch.fleet.quota import DRF_EPS

    d, quota = _drf_inputs(seed)
    _, share, dom, order = _jax_drf(d, quota)
    dom_sorted = np.where(np.take_along_axis(d["pvalid"], order, 1),
                          np.take_along_axis(dom, order, 1),
                          np.float32(0))
    cum = np.asarray(jnp.cumsum(dom_sorted, axis=1))
    j = int(d["pvalid"][0].sum()) // 2
    eps = np.float32(DRF_EPS)
    edge = np.float32(share[0] + cum[0, j])
    q = np.float32(edge - eps)
    # the largest quota whose quota + DRF_EPS (float32) does not exceed the
    # boundary pod's share + prefix: that pod is admitted by equality or
    # by less than an ulp
    while np.float32(q + eps) > edge:
        q = np.nextafter(q, np.float32(0))
    while np.float32(np.nextafter(q, np.float32(1)) + eps) <= edge:
        q = np.nextafter(q, np.float32(1))
    quota[0] = q
    want = _jax_drf(d, quota)[:3]
    got = _port_drf(d, quota)
    rhs = (quota + np.float32(DRF_EPS))[:, None]
    near = int((np.abs(share[:, None] + cum - rhs)
                <= 4 * np.spacing(rhs)).sum())
    print(f"seed {seed}: {near} pods within 4 ulps of the quota boundary; "
          f"admitted {int(got[0].sum())} of {int(d['pvalid'].sum())}")
    assert near >= 1
    assert got[1].tobytes() == want[1].tobytes()   # share
    assert got[2].tobytes() == want[2].tobytes()   # dom
    assert np.array_equal(got[0], want[0])         # admitted
    assert 0 < int(got[0].sum()) < int(d["pvalid"].sum())


# --------------------------------------------------------------------- #
# the fleet tick, both packages, bound lists compared
# --------------------------------------------------------------------- #


class TestFleetTick:
    def test_three_tenants_one_dispatch_per_tick(self):
        def script(A):
            srv, binders = build_fleet(
                A, [("a", 4, 6, 1.0), ("b", 4, 3, 1.0), ("c", 4, 9, 1.0)])
            total = srv.run_until_idle(max_ticks=6)
            assert srv.max_dispatches_per_tick == 1
            assert total.cross_tenant_placements == 0
            assert total.drf_violations == 0
            for name, n in (("a", 6), ("b", 3), ("c", 9)):
                assert len(binders[name].bound) == n
                assert total.per_tenant[name].scheduled == n
            return bound(binders)

        both(script)

    def test_quota_clamped_tenant_defers_not_fails(self):
        def script(A):
            # 4 nodes × 8 cpu; quota 0.25 funds 16 pods of 500m; the other
            # 8 stay QUEUED (requeued, never unschedulable, never lost)
            srv = det_server(A, batch_size=32)
            b2 = {}
            for name, quota in (("clamped", 0.25), ("free", 1.0)):
                b = A.RecordingBinder()
                b2[name] = b
                t = srv.add_tenant(name, binder=b, quota=quota)
                for i in range(4):
                    t.on_node_add(mknode(A, i))
                feed(A, t, name, 24 if name == "clamped" else 10,
                     cpu="500m")
            total = srv.run_until_idle(max_ticks=10)
            assert len(b2["clamped"].bound) == 16
            assert len(b2["free"].bound) == 10
            st = total.per_tenant["clamped"]
            assert st.requeued > 0 and st.unschedulable == 0
            assert st.drf_clamped > 0
            assert total.drf_violations == 0
            q = srv.tenant("clamped").sched.queue.lengths()
            assert sum(q) == 24 - 16
            return bound(b2)

        both(script)

    def test_fleet_grows_when_one_tenant_grows(self):
        def script(A):
            srv, binders = build_fleet(
                A, [("a", 2, 2, 1.0), ("b", 2, 2, 1.0)], batch_size=4)
            srv.tick()
            d0 = srv._fleet_dims
            tb = srv.tenant("b")
            for i in range(2, d0.N + 2):   # grow b past the shared bucket
                tb.on_node_add(mknode(A, i))
            feed(A, tb, "b2", 2)
            feed(A, srv.tenant("a"), "a2", 2)
            srv.run_until_idle(max_ticks=6)
            assert srv._fleet_dims.N > d0.N
            assert len(binders["a"].bound) == 4
            assert len(binders["b"].bound) == 4
            return bound(binders)

        both(script)

    def test_mixed_engines_one_dispatch_per_group(self):
        """Per-tenant engines split the tick into engine groups: exactly one
        dispatch per group per tick, placements equal to each tenant's SOLO
        run under its own engine (test_fleet.py TestFleet2DMesh's
        meshless case)."""
        spec = [("a", 5, 7, 1.0), ("b", 3, 5, 1.0), ("c", 6, 9, 1.0)]
        engines = {"a": "waves", "b": "runs", "c": "scan"}

        def script(A):
            srv, bm = build_fleet(A, spec, engines=engines)
            srv.run_until_idle(max_ticks=8)
            srv.run_until_idle(max_ticks=2)   # idle: no extra groups
            assert set(srv.stacks) <= {"waves", "runs", "scan"}
            assert srv.max_engine_groups == 3
            assert srv.max_dispatches_per_tick == 3
            out = bound(bm)
            for name, n_nodes, n_pods, quota in spec:
                solo, sb = build_fleet(A, [(name, n_nodes, n_pods, quota)],
                                       engines={name: engines[name]})
                solo.run_until_idle(max_ticks=8)
                assert out[name] == bound(sb)[name], name
            return out

        both(script)

    @pytest.mark.parametrize("A", [JAX, PORT], ids=["jax", "port"])
    def test_bad_engine_name_rejected(self, A):
        with pytest.raises(ValueError, match="engine"):
            A.FleetServer(engines={"a": "warp"}, **A.dev)


class TestK1Degenerate:
    def test_single_tenant_fleet_matches_plain_scheduler(self):
        def script(A):
            base = A.Dims().grown_for(N=8, P=16, E=16)
            pods = [A.Pod(name=f"p{i}", requests=A.Resources.make(
                cpu="300m", memory="64Mi"), creation_index=i)
                for i in range(12)]
            srv = det_server(A, batch_size=16, base_dims=base)
            fb = A.RecordingBinder()
            t = srv.add_tenant("solo", binder=fb, quota=1.0)
            for i in range(4):
                t.on_node_add(mknode(A, i))
            for p in pods:
                t.on_pod_add(p)
            srv.run_until_idle(max_ticks=4)

            sb = A.RecordingBinder()
            s = A.Scheduler(binder=sb, batch_size=16, base_dims=base,
                            **A.sched_kw)
            for i in range(4):
                s.on_node_add(mknode(A, i))
            for p in pods:
                s.on_pod_add(p)
            s.run_until_idle()
            assert sorted(fb.bound) == sorted(sb.bound)
            return {"solo": sorted(fb.bound)}

        both(script)


class TestBitEquality:
    def test_each_tenant_matches_its_solo_run(self):
        """K-tenant tick vs each tenant alone (same clamp inputs): bound
        (pod, node) sets identical, clamped tenant included — and equal to
        the JAX package's."""
        spec = [("a", 4, 11, 1.0), ("b", 3, 7, 0.25), ("c", 5, 13, 1.0)]

        def run(A, tenants):
            srv, binders = build_fleet(A, tenants, batch_size=8, cpu="2",
                                       pod_cpu="500m")
            srv.run_until_idle(max_ticks=10)
            return bound(binders)

        def script(A):
            together = run(A, spec)
            for entry in spec:
                assert together[entry[0]] == run(A, [entry])[entry[0]]
            return together

        both(script)


# --------------------------------------------------------------------- #
# ledgers, storms, failures, gangs, degraded backend
# --------------------------------------------------------------------- #


class TestTenantLedger:
    def test_namespaced_prefixes_are_disjoint(self):
        a = PORT.APIServer()
        try:
            la = PORT.tenant_ledger(a.storage, "alpha")
            lb = PORT.tenant_ledger(a.storage, "beta")
            ia = la.write_intent(cycle=1, token=0, bindings={"x": "n0"})
            assert ia.key.startswith(
                "/registry/ktpu.io/bindintents/alpha/default-scheduler/")
            assert len(la.unretired()) == 1
            assert len(lb.unretired()) == 0
            la.retire(ia)
            assert len(la.unretired()) == 0
        finally:
            a.close()

    @pytest.mark.chaos
    def test_crash_replay_touches_only_the_crashed_tenant(self):
        """Kill the fleet at post_bind (Bindings committed, intent NOT
        retired): the orphaned intent lives ONLY under the crashed tenant's
        namespace, and a fresh incarnation's recover() replays exactly
        it."""
        def script(A):
            a = A.APIServer()
            try:
                A.faultline.install("proc.crash@post_bind:1")
                srv, _ = build_fleet(
                    A, [("alpha", 2, 3, 1.0), ("beta", 2, 3, 1.0)],
                    batch_size=8, storage=a.storage)
                with pytest.raises(A.faultline.InjectedCrash):
                    srv.tick()
                A.faultline.uninstall()
                la = A.tenant_ledger(a.storage, "alpha")
                lb = A.tenant_ledger(a.storage, "beta")
                assert len(la.unretired()) == 1
                assert len(lb.unretired()) == 0
                srv2, b2 = build_fleet(
                    A, [("alpha", 2, 3, 1.0), ("beta", 2, 3, 1.0)],
                    batch_size=8, storage=a.storage)
                reports = srv2.recover()
                assert reports["alpha"].replayed_intents == 1
                assert reports["beta"].replayed_intents == 0
                assert len(la.unretired()) == 0
                srv2.run_until_idle(max_ticks=6)
                for name in ("alpha", "beta"):
                    keys = [k for k, _ in b2[name].bound]
                    assert len(keys) == 3 and len(set(keys)) == 3
                return bound(b2)
            finally:
                A.faultline.uninstall()
                a.close()

        both(script)


class TestTenantStorm:
    @pytest.mark.chaos
    def test_storm_degrades_only_the_stormed_tenant(self):
        def script(A):
            A.faultline.install("tenant.storm@beta:1+")
            try:
                srv, binders = build_fleet(
                    A, [("alpha", 4, 8, 1.0), ("beta", 4, 8, 1.0),
                        ("gamma", 4, 8, 1.0)])
                total = srv.run_until_idle(max_ticks=6)
                assert len(binders["beta"].bound) == 0
                assert sum(srv.tenant("beta").sched.queue.lengths()) == 8
                assert total.per_tenant["beta"].degraded >= 1
                for name in ("alpha", "gamma"):
                    keys = [k for k, _ in binders[name].bound]
                    assert len(keys) == 8 and len(set(keys)) == 8
                    assert total.per_tenant[name].degraded == 0
                assert total.cross_tenant_placements == 0
                assert A.faultline.active().fired("tenant.storm") >= 1
                return bound(binders)
            finally:
                A.faultline.uninstall()

        both(script)

    @pytest.mark.chaos
    def test_storm_recovery_rebinds_after_uninstall(self):
        def script(A):
            A.faultline.install("tenant.storm@beta:1")  # one-shot
            try:
                srv, binders = build_fleet(
                    A, [("alpha", 4, 4, 1.0), ("beta", 4, 4, 1.0)])
                srv.run_until_idle(max_ticks=8)
                assert len(binders["alpha"].bound) == 4
                assert len(binders["beta"].bound) == 4
                assert srv.tenant("beta").storm_ticks == 1
                return bound(binders)
            finally:
                A.faultline.uninstall()

        both(script)


@pytest.mark.parametrize("kw,env,shape", [
    ({"mesh": 8}, None, (8, 1)),
    ({"mesh": 8, "node_shards": 2}, None, (4, 2)),
    ({"mesh": 8}, "2", (4, 2))], ids=["1d-mesh", "2d-mesh", "node-shards"])
def test_fleet_mesh_is_refused_naming_a13(kw, env, shape, monkeypatch):
    """test_fleet.py's TestFleetMesh and TestFleet2DMesh requests, which the
    port refused until it ported the fleet mesh (ROADMAP A13b): `mesh=8`,
    `mesh=8, node_shards=2` and KTPU_FLEET_NODE_SHARDS=2 are taken over a
    pool of 8 CPU devices, and the same request on a machine without 8 CUDA
    devices raises, with the mesh note, rather than serving meshless."""
    from kubernetes_tpu_torch.parallel.mesh import (MESH_HINT,
                                                    fleet_mesh_shape)

    if env is not None:
        monkeypatch.setenv("KTPU_FLEET_NODE_SHARDS", env)
        assert PORT.FleetServer(device="cpu").mesh is None
    for garbage in ("eight", 1, 0, -3):     # clamps to no mesh
        assert PORT.FleetServer(device="cpu", mesh=garbage).mesh is None
    srv = PORT.FleetServer(device="cpu", mesh_devices=[torch.device("cpu")]
                           * 8, **kw)
    assert fleet_mesh_shape(srv.mesh) == shape
    assert srv.mesh_state.mesh is srv.mesh
    assert srv.node_shards == (2 if shape[1] == 2 else 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as e:
        PORT.FleetServer(device="cpu", **kw)
    assert MESH_HINT in e.value.__notes__


def test_fleet_server_takes_the_card_by_default(monkeypatch):
    """Without device= the fleet runs on the GPU, and without one it
    raises — it never moves to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PORT.FleetServer()
    srv = PORT.FleetServer(device="cpu")
    assert srv.device.type == "cpu"
    assert srv.supervisor.fallback_device is None
    assert not srv.prewarmer.enabled


class TestPostPopFailure:
    def test_mid_tick_failure_requeues_every_popped_batch(self):
        def script(A):
            srv, binders = build_fleet(A, [("a", 2, 5, 1.0),
                                           ("b", 2, 3, 1.0)], batch_size=8)

            def boom(*a, **kw):
                raise RuntimeError("injected post-pop failure")

            orig = srv._dispatch_tick
            srv._dispatch_tick = boom
            with pytest.raises(RuntimeError, match="post-pop"):
                srv.tick()
            for name, n in (("a", 5), ("b", 3)):
                assert sum(srv.tenant(name).sched.queue.lengths()) == n
                assert len(binders[name].bound) == 0
            assert srv.stack.block is None
            srv._dispatch_tick = orig
            srv.run_until_idle(max_ticks=4)
            assert len(binders["a"].bound) == 5
            assert len(binders["b"].bound) == 3
            return bound(binders)

        both(script)


class TestGangTenant:
    def test_gang_growth_restacks_every_tenant(self):
        """A gang-bearing tenant's solo wave grows the fleet bucket
        MID-TICK; every tenant re-snapshots at the converged bucket before
        the restack."""
        def script(A):
            srv, binders = build_fleet(
                A, [("plain", 4, 6, 1.0), ("gang", 8, 0, 1.0)],
                batch_size=64)
            srv.tick()
            t = srv.tenant("gang")
            for i in range(24):
                t.on_pod_add(A.Pod(name=f"gang-g{i}", pod_group="job",
                                   min_member=24,
                                   requests=A.Resources.make(
                                       cpu="100m", memory="8Mi"),
                                   creation_index=i))
            feed(A, srv.tenant("plain"), "plain2", 2)
            total = srv.run_until_idle(max_ticks=8)
            assert len(binders["gang"].bound) == 24
            assert len(binders["plain"].bound) == 8
            assert total.cross_tenant_placements == 0
            for tn in srv.tenants.values():
                assert tn.sched.queue.lengths()[0] == 0
            for name in ("gang", "plain"):
                keys = [k for k, _ in binders[name].bound]
                assert len(keys) == len(set(keys))
            return bound(binders)

        both(script)


class TestDegradedBackend:
    @pytest.mark.chaos
    def test_degraded_tick_never_touches_resident_stack(self, monkeypatch):
        """Backend loss mid-fleet with the CPU fallback configured: the
        degraded tick serves every tenant through the fallback WITHOUT
        patching the resident stacked tensors; re-admission restacks onto
        fresh ones."""
        monkeypatch.setenv("KTPU_PROBE_BACKOFF", "0.05")

        def script(A):
            kw = {"fallback_device": "cpu"} if A.port else {}
            srv, binders = build_fleet(A, [("a", 2, 4, 1.0),
                                           ("b", 2, 4, 1.0)], **kw)
            srv.tick()
            assert srv.stack.block is not None
            pre_restacks = srv.stack.full_restacks
            A.faultline.install("device.error@probe:1+")
            try:
                srv.supervisor._mark_unhealthy("injected backend loss")
                feed(A, srv.tenant("a"), "a2", 3)
                tk = srv.tick()
                assert srv.stack.block is None
                assert srv.stack.full_restacks == pre_restacks
                assert tk.per_tenant["a"].scheduled >= 1
            finally:
                A.faultline.uninstall()
            srv.supervisor._readmit()
            prober = srv.supervisor._prober
            if prober is not None:
                prober.join(timeout=10)
            feed(A, srv.tenant("b"), "b2", 2)
            srv.run_until_idle(max_ticks=4)
            assert srv.stack.full_restacks == pre_restacks + 1
            assert len(binders["a"].bound) == 7
            assert len(binders["b"].bound) == 6
            for name in ("a", "b"):
                keys = [k for k, _ in binders[name].bound]
                assert len(keys) == len(set(keys))
            return bound(binders)

        both(script)

    @pytest.mark.chaos
    def test_no_fallback_abandons_and_requeues(self):
        """Without a configured fallback a failed fleet dispatch is
        abandoned: every popped pod is requeued, nothing moves to another
        device, and the next tick serves them."""
        srv, binders = build_fleet(PORT, [("a", 2, 4, 1.0),
                                          ("b", 2, 4, 1.0)])
        PORT.faultline.install("device.error@cycle:1")
        tk = srv.tick()
        PORT.faultline.uninstall()
        assert tk.per_tenant["a"].aborted == 4
        assert srv.supervisor.stats.abandoned == 1
        assert srv.supervisor.stats.fallback_dispatches == 0
        assert srv.supervisor.wait_recovered(15)
        srv.run_until_idle(max_ticks=4)
        assert {n: len(b.bound) for n, b in binders.items()} == \
            {"a": 4, "b": 4}


# --------------------------------------------------------------------- #
# the fleet cases of test_microwave.py and test_overload.py
# --------------------------------------------------------------------- #


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def _micro_fleet(A):
    clk = FakeClock()
    srv = A.FleetServer(batch_size=16, clock=clk, **A.dev)
    binders = {}
    for name in ("ta", "tb"):
        b = A.RecordingBinder()
        binders[name] = b
        t = srv.add_tenant(name, binder=b, quota=1.0)
        for i in range(2):
            t.on_node_add(A.Node(
                name=f"n{i}", labels={"kubernetes.io/hostname": f"n{i}"},
                allocatable=A.Resources.make(cpu=4, memory="8Gi",
                                             pods=110)))
    return srv, binders, clk


def _mkpod(A, name, **kw):
    return A.Pod(name=name, requests=A.Resources.make(cpu="100m",
                                                      memory="64Mi"), **kw)


class TestFleetMicroPass:
    def test_micro_pass_admits_only_micro_ready_tenants(self, monkeypatch):
        monkeypatch.setenv("KTPU_MICROWAVE", "1")

        def script(A):
            srv, binders, clk = _micro_fleet(A)
            for i in range(2):
                srv.tenants["ta"].on_pod_add(_mkpod(A, f"a{i}",
                                                    creation_index=i))
            out = srv.micro_pass(clk.advance(0.1))
            assert set(out) == {"ta"}
            assert out["ta"].micro == 1 and out["ta"].scheduled == 2
            assert len(binders["ta"].bound) == 2
            assert binders["tb"].bound == []          # isolation
            return bound(binders)

        both(script)

    def test_tick_merges_micro_into_tenant_stats(self, monkeypatch):
        monkeypatch.setenv("KTPU_MICROWAVE", "1")

        def script(A):
            srv, binders, clk = _micro_fleet(A)
            srv.tenants["tb"].on_pod_add(_mkpod(A, "b0", creation_index=0))
            tick = srv.tick(clk.advance(0.1))
            assert tick.per_tenant["tb"].micro == 1
            assert tick.per_tenant["tb"].scheduled == 1
            assert tick.per_tenant["ta"].micro == 0
            assert len(binders["tb"].bound) == 1
            return bound(binders)

        both(script)


class TestFleetTenantIsolation:
    def test_one_tenant_brownout_sheds_only_that_tenant(self):
        def script(A):
            OPEN = importlib.import_module(f"{A.pkg}.sched.overload").OPEN
            clk = FakeClock()
            fs = A.FleetServer(batch_size=8, clock=clk, **A.dev)
            ta = fs.add_tenant("ta", binder=A.RecordingBinder())
            tb = fs.add_tenant("tb", binder=A.RecordingBinder())
            for t in (ta, tb):
                for i in range(3):
                    t.on_node_add(A.Node(
                        name=f"{t.name}-n{i}",
                        allocatable=A.Resources.make(cpu=64, memory="64Gi",
                                                     pods=110)))
            # tenant A's breaker is tripped; tenant B is healthy
            for _ in range(5):
                ta.sched.governor.note_commit(False, 0.01)
            assert ta.sched.governor.breaker.state == OPEN
            for i in range(4):
                ta.on_pod_add(_mkpod(A, f"a{i}", creation_index=i))
                tb.on_pod_add(_mkpod(A, f"b{i}", creation_index=i))
            tick = fs.tick(now=clk.advance(0.05))
            # A paused (nothing popped, nothing lost); B scheduled normally
            assert tick.per_tenant["ta"].commit_paused == 1
            assert tick.per_tenant["ta"].scheduled == 0
            assert ta.sched.queue.lengths()[0] == 4
            assert tick.per_tenant["tb"].scheduled == 4
            return {"ta": sorted(ta.sched.binder.bound),
                    "tb": sorted(tb.sched.binder.bound)}

        both(script)
