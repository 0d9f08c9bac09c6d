"""The port's fleet mesh (kubernetes_tpu_torch/parallel/mesh.py's fleet half,
fleet/tables.py's and fleet/cycle.py's mesh modes, FleetServer(mesh=,
node_shards=)) against the JAX package's, mirroring tests/test_fleet.py's
TestFleetMesh and TestFleet2DMesh and test_prewarm.py's fleet × mesh keys.

The JAX package runs on conftest's 8 virtual XLA devices, the port on
`[cpu] * 8` (`mesh_devices=`), the counterpart; every case runs the same
seeded script on both and holds every tenant's sorted bound (pod, node)
list equal across the two packages and to the port's meshless run. The DRF
case holds the clamp's rows on a node-sharded tenant row exact against
the JAX package's single-device clamp at real magnitudes, and shows that a
shard-wise partial sum of the same column sums would differ.
"""

import dataclasses
import types as pytypes

import jax
import numpy as np
import pytest
import torch

from test_torch_fleet import (JAX, PORT, _drf_inputs, _jax_drf, bound,
                              build_fleet, feed)

pytestmark = [
    pytest.mark.mesh,
    pytest.mark.skipif(len(jax.devices()) < 8,
                       reason="needs 8 (virtual) devices — set XLA_FLAGS="
                              "--xla_force_host_platform_device_count=8"),
]

CPU = torch.device("cpu")
POOL = [CPU] * 8
SPEC = [("a", 5, 7, 1.0), ("b", 3, 5, 1.0), ("c", 6, 9, 1.0)]


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    JAX.faultline.uninstall()
    PORT.faultline.uninstall()


def mesh_kw(A, mesh, node_shards=None, **kw):
    """FleetServer kwargs for a mesh request on either package: the port
    takes its 8 CPU devices as the pool."""
    out = dict(kw, mesh=mesh)
    if node_shards is not None:
        out["node_shards"] = node_shards
    if A.port and mesh is not None:
        out["mesh_devices"] = POOL
    return out


def run_fleet(A, mesh, node_shards=None, engines=None, spec=None):
    kw = mesh_kw(A, mesh, node_shards,
                 **({} if engines is None else {"engines": engines}))
    srv, binders = build_fleet(A, spec or SPEC, **kw)
    srv.run_until_idle(max_ticks=8)
    return srv, binders


def shape_of(A, mesh):
    m = __import__(f"{A.pkg}.parallel.mesh", fromlist=["x"])
    return m.fleet_mesh_shape(mesh)


class TestFleetMesh:
    def test_tenant_axis_sharded_tick_is_bit_equal(self):
        """The 1-D tenant mesh: 3 tenants pad to K 8 (one per device row),
        one dispatch a tick, every tenant's placements equal to the JAX
        package's mesh run and to the port's meshless run."""
        spec = [("a", 4, 7, 1.0), ("b", 4, 5, 1.0), ("c", 4, 9, 1.0)]
        got = {}
        for A in (JAX, PORT):
            srv, b = run_fleet(A, 8, spec=spec)
            assert srv.mesh is not None
            assert shape_of(A, srv.mesh) == (8, 1)
            assert srv.stack.K == 8
            assert srv.max_dispatches_per_tick == 1
            got[A.pkg] = bound(b)
        _, b0 = run_fleet(PORT, None, spec=spec)
        assert got["kubernetes_tpu_torch"] == got["kubernetes_tpu"]
        assert got["kubernetes_tpu_torch"] == bound(b0)


class TestFleet2DMesh:
    def test_make_fleet_mesh_shapes(self):
        from kubernetes_tpu.parallel import mesh as JM
        from kubernetes_tpu_torch.parallel import mesh as TM

        for M, kw in ((JM, {}), (TM, {"devices": POOL})):
            m1 = M.make_fleet_mesh(8, **kw)
            assert m1.axis_names == (M.TENANT_AXIS,)
            assert M.fleet_mesh_shape(m1) == (8, 1)
            m2 = M.make_fleet_mesh(8, node_shards=2, **kw)
            assert m2.axis_names == (M.TENANT_AXIS, M.NODE_AXIS)
            assert M.fleet_mesh_shape(m2) == (4, 2)
            with pytest.raises(ValueError):
                M.make_fleet_mesh(8, node_shards=3, **kw)
        m2 = TM.make_fleet_mesh(8, node_shards=2, devices=POOL)
        assert m2.shape == (4, 2) and len(m2.rows) == 4
        assert all(len(r) == 2 for r in m2.rows)
        with pytest.raises(RuntimeError) as e:
            TM.make_fleet_mesh(16, node_shards=2, devices=POOL)
        assert TM.MESH_HINT in e.value.__notes__

    def test_pad_fleet_node_rows_are_inert(self):
        """Non-divisible N on a stacked [K, N, …] tree: both packages' padded
        node rows carry the inert contract per tenant, and every plane of
        the port's padded tree equals the JAX package's."""
        from kubernetes_tpu.fleet.tables import (
            empty_tenant_block as j_empty, stack_blocks as j_stack)
        from kubernetes_tpu.parallel.mesh import (
            pad_fleet_node_tables as j_pad)
        from kubernetes_tpu_torch.fleet.tables import (
            empty_tenant_block, stack_blocks)
        from kubernetes_tpu_torch.parallel.mesh import pad_fleet_node_tables

        d = PORT.Dims().grown_for(N=8, P=8, E=8)
        jd = JAX.Dims().grown_for(N=8, P=8, E=8)
        jt = j_stack([j_empty(jd) for _ in range(3)])[0]
        jt6 = jax.tree.map(
            lambda a: a[:, :6] if a.ndim >= 2 and a.shape[1] == jd.N else a,
            jt)
        tt = stack_blocks([empty_tenant_block(d, CPU) for _ in range(3)])[0]
        tt6 = tt._replace(nodes=type(tt.nodes)(*(a[:, :6]
                                                 for a in tt.nodes)))
        jp, tp = j_pad(jt6, 4).nodes, pad_fleet_node_tables(tt6, 4).nodes
        n = tp
        assert tuple(n.valid.shape[:2]) == (3, 8)
        assert not bool(n.valid[:, 6:].any())
        assert bool(n.unschedulable[:, 6:].all())
        assert int(n.name_id[:, 6:].max()) == -1
        assert int(n.alloc[:, 6:].abs().sum()) == 0
        assert int(n.used[:, 6:].abs().sum()) == 0
        assert not bool(n.avoid[:, 6:].any())
        for f in n._fields:
            want = np.asarray(getattr(jp, f))
            if want.dtype == np.uint32:
                want = want.view(np.int32)
            assert np.array_equal(getattr(tp, f).numpy(), want), f

    def test_2d_bit_equal_vs_1d_and_single_device(self):
        """3 tenants with ragged node counts on the (4, 2) grid (one inert
        pad tenant), on the 1-D tenant mesh and meshless, on both packages:
        all six runs bind every tenant's pods to the same nodes, each pod
        exactly once on a real node of its own tenant, one dispatch a
        tick; the port's grid took collectives, its 1-D mesh none."""
        from kubernetes_tpu_torch.parallel import axis

        runs = {}
        for A in (JAX, PORT):
            srv2, b2 = run_fleet(A, 8, node_shards=2)
            assert shape_of(A, srv2.mesh) == (4, 2)
            assert srv2.stack.K == 4
            assert srv2.max_dispatches_per_tick == 1
            if A.port:
                assert axis.LAST_RUN["grid"] == [4, 2]
                assert axis.LAST_RUN["all_reduce"] > 0
            srv1, b1 = run_fleet(A, 8)
            assert shape_of(A, srv1.mesh) == (8, 1)
            if A.port:
                assert axis.LAST_RUN["grid"] == [8, 1]
                assert axis.LAST_RUN["exchanges"] == 0
            _, b0 = run_fleet(A, None)
            runs[A.pkg] = (bound(b2), bound(b1), bound(b0))
        want = runs["kubernetes_tpu"][0]
        for got in runs["kubernetes_tpu"] + runs["kubernetes_tpu_torch"]:
            assert got == want
        for name, n_nodes, n_pods, _ in SPEC:
            keys = [k for k, _ in want[name]]
            assert len(keys) == n_pods and len(set(keys)) == n_pods
            assert {nn for _, nn in want[name]} <= \
                {f"n{i}" for i in range(n_nodes)}

    def test_refresh_pads_nondivisible_k_and_n_together(self):
        """Dims whose N the node-shard width does not divide and a live K
        under the tenant width: both packages' refresh stack inert pad
        tenants and inert pad node rows together and keep restacking (the
        patch path would write unpadded rows onto node-padded ones)."""
        from dataclasses import replace

        from kubernetes_tpu.fleet.tables import (
            FleetStack as JStack, empty_tenant_block as j_empty)
        from kubernetes_tpu.parallel.mesh import (
            make_fleet_mesh as j_make)
        from kubernetes_tpu_torch.fleet.tables import (FleetStack,
                                                       empty_tenant_block)
        from kubernetes_tpu_torch.parallel.mesh import (ShardedFleet,
                                                        make_fleet_mesh)

        jstack = JStack(mesh=j_make(8, node_shards=4))
        tstack = FleetStack(CPU, mesh=make_fleet_mesh(8, node_shards=4,
                                                      devices=POOL))
        for stack, Dm, empty, dev in (
                (jstack, JAX.Dims, j_empty, ()),
                (tstack, PORT.Dims, empty_tenant_block, (CPU,))):
            d = replace(Dm(), N=6, P=8, E=8)
            blk = empty(d, *dev)
            snaps = [pytypes.SimpleNamespace(tables=blk[0], pending=blk[1],
                                             existing=blk[2])]
            assert stack.refresh(snaps, [(0, 0)], d) == 2
            if isinstance(stack.block, ShardedFleet):
                # 2 tenant rows of 4 shards, each holding its tenant's 2 of
                # the 8 padded node rows
                valid = [c[0].nodes.valid for c in stack.block.cells]
                assert len(valid) == 8 and stack.block.n_nodes == 8
                assert all(tuple(v.shape) == (1, 2) for v in valid)
            else:
                valid = [stack.block[0].nodes.valid]
                assert tuple(valid[0].shape[:2]) == (2, 8)
            assert not any(bool(np.asarray(v).any()) for v in valid)
            restacks = stack.full_restacks
            stack.refresh(snaps, [(0, 0)], d)
            assert stack.full_restacks == restacks + 1

    def test_mixed_engines_on_2d_mesh_bit_equal(self):
        """waves, runs and scan tenants on the (4, 2) grid: three engine
        groups, one dispatch each a tick, placements equal to the JAX
        package's grid run and to the port's meshless run."""
        engines = {"a": "waves", "b": "runs", "c": "scan"}
        srv_j, bj = run_fleet(JAX, 8, node_shards=2, engines=engines)
        srv_t, bt = run_fleet(PORT, 8, node_shards=2, engines=engines)
        _, b0 = run_fleet(PORT, None, engines=engines)
        assert srv_j.max_engine_groups == srv_t.max_engine_groups == 3
        assert srv_t.max_dispatches_per_tick == 3
        assert bound(bt) == bound(bj) == bound(b0)

    @pytest.mark.chaos
    def test_degrade_reform_under_2d_signature(self, monkeypatch):
        """The degraded-backend drill on the grid, both packages (the port
        with fallback_device='cpu'): a loss drops the whole fleet mesh, the
        degraded tick serves through the fallback without touching the
        resident stack, re-admission reforms the (4, 2) grid and the server
        adopts it; every pod bound exactly once, the same nodes on both."""
        monkeypatch.setenv("KTPU_PROBE_BACKOFF", "0.05")
        out = {}
        for A in (JAX, PORT):
            kw = mesh_kw(A, 8, 2, **({"fallback_device": "cpu"}
                                     if A.port else {}))
            srv, binders = build_fleet(A, [("a", 2, 4, 1.0),
                                           ("b", 2, 4, 1.0)], **kw)
            assert shape_of(A, srv.mesh) == (4, 2)
            srv.tick()
            assert srv.stack.block is not None
            leaves = None
            if A.port:
                leaves = [(a, a.clone()) for c in srv.stack.block.cells
                          for a in c[0].nodes]
            A.faultline.install("device.error@probe:1+")
            try:
                srv.supervisor._mark_unhealthy("injected backend loss")
                assert srv.mesh_state.mesh is None
                feed(A, srv.tenant("a"), "a2", 3)
                tk = srv.tick()
                assert srv.mesh is None
                assert srv.stack.block is None
                assert tk.per_tenant["a"].scheduled >= 1
            finally:
                A.faultline.uninstall()
            if leaves is not None:
                assert all(torch.equal(a, b) for a, b in leaves)
            srv.supervisor._readmit()
            prober = srv.supervisor._prober
            if prober is not None:
                prober.join(timeout=10)
            feed(A, srv.tenant("b"), "b2", 2)
            srv.run_until_idle(max_ticks=4)
            assert srv.mesh is srv.mesh_state.mesh
            assert shape_of(A, srv.mesh) == (4, 2)
            assert len(binders["a"].bound) == 7
            assert len(binders["b"].bound) == 6
            for name in ("a", "b"):
                keys = [k for k, _ in binders[name].bound]
                assert len(keys) == len(set(keys))
            out[A.pkg] = bound(binders)
        assert out["kubernetes_tpu_torch"] == out["kubernetes_tpu"]


class TestShardedStack:
    def _grid_fleet(self):
        srv, _ = build_fleet(PORT, [("a", 5, 6, 1.0), ("b", 3, 4, 1.0),
                                    ("c", 6, 0, 1.0)], batch_size=2,
                             **mesh_kw(PORT, 8, 2))
        srv.tick()
        return srv

    @staticmethod
    def _fresh(st, snaps):
        from kubernetes_tpu_torch.fleet.tables import (empty_tenant_block,
                                                       stack_blocks)
        from kubernetes_tpu_torch.parallel.mesh import shard_fleet

        blocks = [st._row(s) for s in snaps]
        blocks += [empty_tenant_block(st.dims, CPU)] * (st.K - len(blocks))
        return shard_fleet(stack_blocks(blocks), st.mesh)

    def test_grid_patch_writes_each_row_in_place(self):
        """A changed tenant on the grid is written in place into its own
        row's cells only, each shard taking its own node rows: every cell
        then equals a fresh placement of the same snapshots, no cell's
        tensor moved, and the other rows' cells were not written."""
        from kubernetes_tpu_torch.fleet.tables import _leaves

        srv = self._grid_fleet()
        st = srv.stack
        ptrs = [[a.data_ptr() for a in _leaves(c)] for c in st.block.cells]
        others = [[a.clone() for a in _leaves(c)]
                  for c in st.block.cells[2:]]
        changed = list(st._snaps)
        changed[0] = dataclasses.replace(st._snaps[0])
        st.refresh(changed, st.keys_host[:3], st.dims)
        assert st.row_patches and st.donated_patches and not st.copy_patches
        fresh = self._fresh(st, changed)
        for c, f, p in zip(st.block.cells, fresh.cells, ptrs):
            assert [a.data_ptr() for a in _leaves(c)] == p
            assert all(torch.equal(a, b)
                       for a, b in zip(_leaves(c), _leaves(f)))
        for c, kept in zip(st.block.cells[2:], others):
            assert all(torch.equal(a, b) for a, b in zip(_leaves(c), kept))

    def test_patch_while_a_dispatch_holds_the_stack_copies(self):
        """A refresh while a dispatch holds the stack writes new tensors:
        the held cells keep what the dispatch reads, and the new cells
        equal a fresh placement."""
        from kubernetes_tpu_torch.fleet.tables import _leaves

        srv = self._grid_fleet()
        st = srv.stack
        held = st.block
        kept = [[a.clone() for a in _leaves(c)] for c in held.cells]
        changed = [dataclasses.replace(s) for s in st._snaps]
        changed[1] = srv.tenant("b").sched.cache.snapshot(
            srv.tenant("b").sched.encoder, [], st.dims, device=CPU)
        st.mark_dispatch_start()
        try:
            st.refresh(changed, st.keys_host[:3], st.dims)
        finally:
            st.mark_dispatch_done()
        assert st.copy_patches == 3 and st.block is not held
        for c, k in zip(held.cells, kept):
            assert all(torch.equal(a, b) for a, b in zip(_leaves(c), k))
        fresh = self._fresh(st, changed)
        for c, f in zip(st.block.cells, fresh.cells):
            assert all(torch.equal(a, b)
                       for a, b in zip(_leaves(c), _leaves(f)))

    def test_a_failing_position_aborts_the_whole_grid(self):
        """One position that raises fails the dispatch: every row stops
        (no thread waits forever in a collective) and the error is the
        position's own."""
        from kubernetes_tpu_torch.parallel import axis
        from kubernetes_tpu_torch.parallel.mesh import make_fleet_mesh

        mesh = make_fleet_mesh(8, node_shards=2, devices=POOL)

        def fn(r, s):
            ax = axis.current()
            x = torch.ones(1)
            for _ in range(3):
                if (r, s) == (2, 1):
                    raise KeyError("position 2,1")
                x = ax.all_reduce(x, "sum")
            return float(x)

        with pytest.raises(KeyError, match="position 2,1"):
            axis.spmd_grid(mesh.rows, (0, 4), 8, fn)
        ok = axis.spmd_grid(mesh.rows, (0, 4), 8,
                            lambda r, s: float(axis.current().all_reduce(
                                torch.ones(1), "sum")))
        assert ok == [[2.0, 2.0]] * 4
        assert [row["all_reduce"] for row in axis.LAST_RUN["rows"]] == \
            [1] * 4


class TestKeys:
    def test_prewarm_fleet_and_mesh_keys_compose(self):
        """test_prewarm.py's fleet × mesh case on the port: a fleet entry
        warmed on the grid answers only the grid's lookup, the meshless
        fleet entry only its own, and the single-cluster one neither."""
        from dataclasses import replace

        from kubernetes_tpu_torch.parallel.mesh import (make_fleet_mesh,
                                                        mesh_key)
        from kubernetes_tpu_torch.sched.prewarm import BucketPrewarmer

        pw = BucketPrewarmer(threshold=0.8, min_axis=8, device="cpu")
        d = PORT.Dims().grown_for(N=16, E=16)
        base = replace(d, has_node_name=False)
        grid = make_fleet_mesh(8, node_shards=2, devices=POOL)
        pw.warm[(base, "waves", (), False, 0, 8, None)] = 1.0
        pw.warm[(base, "waves", (), False, 0, None, None)] = 1.0
        assert pw.lookup(d, "waves", (), False, fleet=8)
        assert not pw.lookup(d, "waves", (), False, fleet=8, mesh=grid)
        pw.warm[(base, "waves", (), False, 0, 8, mesh_key(grid))] = 1.0
        assert pw.lookup(d, "waves", (), False, fleet=8, mesh=grid)
        assert not pw.lookup(d, "waves", (), False, fleet=16, mesh=grid)
        tenant = make_fleet_mesh(8, devices=POOL)
        assert not pw.lookup(d, "waves", (), False, fleet=8, mesh=tenant)

    def test_grid_key_is_apart_from_tenant_and_node_mesh_keys(self):
        """The (4, 2) grid, the (8, 1) tenant mesh and the 8-shard node
        mesh over the same 8 devices: three keys; two grids built alike
        share one."""
        from kubernetes_tpu_torch.parallel.mesh import (make_fleet_mesh,
                                                        make_mesh, mesh_key)

        keys = {mesh_key(make_fleet_mesh(8, node_shards=2, devices=POOL)),
                mesh_key(make_fleet_mesh(8, devices=POOL)),
                mesh_key(make_mesh(8, devices=POOL))}
        assert len(keys) == 3
        assert mesh_key(make_fleet_mesh(8, node_shards=2, devices=POOL)) \
            == mesh_key(make_fleet_mesh(8, node_shards=2, devices=POOL))

    def test_fleet_mesh_state_reforms_the_grid(self):
        """MeshState(fleet_node_shards=) builds the grid with the node-shard
        width clamped to a power of two no wider than the mesh; a loss
        drops the whole grid, a reform halves it, a full reform restores
        (4, 2)."""
        from kubernetes_tpu_torch.parallel.mesh import (MeshState,
                                                        fleet_mesh_shape)

        ms = MeshState(8, devices=POOL, fleet_node_shards=3)
        assert fleet_mesh_shape(ms.mesh) == (4, 2)
        ms.on_backend_loss()
        assert ms.mesh is None
        assert fleet_mesh_shape(ms.reform()) == (2, 2)
        ms.on_backend_loss()
        assert fleet_mesh_shape(ms.reform(full=True)) == (4, 2)
        wide = MeshState(2, devices=POOL, fleet_node_shards=8)
        assert fleet_mesh_shape(wide.mesh) == (1, 2)


# --------------------------------------------------------------------- #
# the DRF clamp on a node-sharded row, at real magnitudes
# --------------------------------------------------------------------- #


def _boundary_inputs(seed):
    """test_torch_fleet.py's real-magnitude stack (K 4, N ≤ 5,000 nodes of
    ≤ 64 Gi), N cut to a multiple of 4 so 2 and 4 shards split it evenly,
    tenant 0's quota set so the middle valid pod of its queue order sits
    on the boundary of the JAX package's single-device clamp."""
    import jax.numpy as jnp

    from kubernetes_tpu_torch.fleet.quota import DRF_EPS

    d, quota = _drf_inputs(seed)
    N = d["valid"].shape[1] // 4 * 4
    for f in ("alloc", "used", "valid"):
        d[f] = np.ascontiguousarray(d[f][:, :N])
    _, share, dom, order = _jax_drf(d, quota)
    dom_sorted = np.where(np.take_along_axis(d["pvalid"], order, 1),
                          np.take_along_axis(dom, order, 1), np.float32(0))
    cum = np.asarray(jnp.cumsum(dom_sorted, axis=1))
    j = int(d["pvalid"][0].sum()) // 2
    eps = np.float32(DRF_EPS)
    edge = np.float32(share[0] + cum[0, j])
    q = np.float32(edge - eps)
    while np.float32(q + eps) > edge:
        q = np.nextafter(q, np.float32(0))
    while np.float32(np.nextafter(q, np.float32(1)) + eps) <= edge:
        q = np.nextafter(q, np.float32(1))
    quota[0] = q
    return d, quota


def _port_tables(d, lo=0, hi=None):
    from kubernetes_tpu_torch.state.arrays import PodArrays

    T = {k: torch.from_numpy(v) for k, v in d.items()}
    hi = T["valid"].shape[1] if hi is None else hi
    tables = pytypes.SimpleNamespace(
        nodes=pytypes.SimpleNamespace(
            valid=T["valid"][:, lo:hi].contiguous(),
            alloc=T["alloc"][:, lo:hi].contiguous(),
            used=T["used"][:, lo:hi].contiguous()),
        classes=pytypes.SimpleNamespace(rid=T["rid"]),
        reqs=pytypes.SimpleNamespace(vec=T["vec"]))
    z = torch.zeros_like(T["cls"])
    pending = PodArrays(valid=T["pvalid"], name_id=z, ns=z, cls=T["cls"],
                        priority=T["prio"], creation=T["creation"],
                        node_id=z, node_name_req=z)
    return tables, pending


def _grid_clamp(d, quota, kn):
    """fleet/cycle.py row_clamp on one tenant row of kn CPU shards, each
    holding its block of node rows: the rows every shard received."""
    from kubernetes_tpu_torch.fleet.cycle import row_clamp
    from kubernetes_tpu_torch.parallel import axis

    N = d["valid"].shape[1]
    n = N // kn
    parts = [_port_tables(d, s * n, (s + 1) * n) for s in range(kn)]
    q = torch.from_numpy(quota)
    got = axis.spmd([CPU] * kn, tuple(s * n for s in range(kn)), N,
                    lambda s: [a.numpy() for a in row_clamp(*parts[s], q)])
    assert axis.LAST_RUN["gather"] == 3 and axis.LAST_RUN["lead"] == 1
    return got


@pytest.mark.parametrize("seed", range(8))
def test_drf_rows_on_a_node_sharded_row_are_exact(seed):
    """The clamp on a tenant row sharded 2 and 4 ways (N up to 5,000 nodes
    of up to 64 Gi, a pod of tenant 0 on the quota boundary): every
    shard's `share`, `dom` and `admitted` equal the JAX package's
    single-device clamp bit for bit — the row gathers its node planes and
    sums them in the one-device order."""
    d, quota = _boundary_inputs(seed)
    want = _jax_drf(d, quota)[:3]
    assert 0 < int(want[0].sum()) < int(d["pvalid"].sum())
    for kn in (2, 4):
        for got in _grid_clamp(d, quota, kn):
            assert got[1].tobytes() == want[1].tobytes(), (kn, "share")
            assert got[2].tobytes() == want[2].tobytes(), (kn, "dom")
            assert np.array_equal(got[0], want[0]), (kn, "admitted")


def test_shard_wise_partial_sums_differ():
    """What the gather avoids, built here: each shard's column sums over its
    own node rows (in the one-device order), added across the shards in
    shard order as an all-reduce would, and the clamp taken from those
    totals. The KiB sums are far above 2^24, so the grouping moves the f32
    totals: over seeds 0–7 at 2 and 4 shards, some tenant's `share` (and
    with it `dom` or `admitted`) differs from the single-device clamp."""
    from kubernetes_tpu_torch.fleet.quota import (_capacity_usage,
                                                  clamp_from_totals,
                                                  drf_admission_rows)

    moved = {}
    for seed in range(8):
        d, quota = _boundary_inputs(seed)
        whole, pending = _port_tables(d)
        q = torch.from_numpy(quota)
        want = drf_admission_rows(whole, pending, q)
        N = d["valid"].shape[1]
        for kn in (2, 4):
            n = N // kn
            parts = [_capacity_usage(*(getattr(whole.nodes, f)[:, s * n:
                                                              (s + 1) * n]
                                       for f in ("valid", "alloc", "used")))
                     for s in range(kn)]
            pcap, puse = parts[0]
            for c, u in parts[1:]:
                pcap, puse = pcap + c, puse + u
            got = clamp_from_totals(pcap, puse, whole.classes.rid,
                                    whole.reqs.vec, pending, q)
            diff = [f for f, a, b in zip(("admitted", "share", "dom"), got,
                                         want) if not torch.equal(a, b)]
            if diff:
                moved[(seed, kn)] = diff
    print(f"shard-wise partial sums moved the clamp's rows at {moved}")
    assert any("share" in v for v in moved.values())
