"""Node-axis sharding of the port (kubernetes_tpu_torch/parallel/) against
the JAX package's, mirroring tests/test_mesh.py, test_runs.py's mesh case and
test_prewarm.py's TestMeshSignatureIsolation.

The port's mesh is single-controller: one thread per shard, here 8 shards
on the CPU (`[cpu] * 8`, the counterpart of conftest's 8 virtual XLA
devices). Every cycle test runs the same encoded cluster four ways — the
JAX package unsharded and on its 8-device mesh, the port unsharded and on
its 8-shard mesh — and holds all four equal in the placements, `feasible`,
every plane of the final state (`used`, `CNT`, `HOLD`, WSYM, the port and
volume words) and the [P, N] feasibility matrix. `TestLocalMaximaDiffer`
builds a cluster whose shards' local maxima differ from the global ones and
shows that a reduction kept shard-local changes the answer.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.api.types as JT
import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu.models.workloads import flagship_pods, make_nodes
from kubernetes_tpu.ops.assign import assign_batch as j_assign_batch
from kubernetes_tpu.ops.assign import feasible_matrix as j_feasible_matrix
from kubernetes_tpu.ops.assign import initial_state as j_initial_state
from kubernetes_tpu.ops.gang import assign_gang as j_assign_gang
from kubernetes_tpu.ops.lattice import build_cycle as j_build_cycle
from kubernetes_tpu.ops.runs import assign_runs as j_assign_runs
from kubernetes_tpu.ops.runs import plan_runs
from kubernetes_tpu.ops.waves import assign_waves as j_assign_waves
from kubernetes_tpu.parallel.mesh import make_mesh as j_make_mesh
from kubernetes_tpu.parallel.mesh import replicate as j_replicate
from kubernetes_tpu.parallel.mesh import shard_tables as j_shard_tables
from kubernetes_tpu.state.dims import Dims as JDims
from kubernetes_tpu_torch.ops.assign import assign_batch, feasible_matrix
from kubernetes_tpu_torch.ops.assign import initial_state
from kubernetes_tpu_torch.ops.gang import assign_gang
from kubernetes_tpu_torch.ops.lattice import build_cycle
from kubernetes_tpu_torch.ops.runs import assign_runs
from kubernetes_tpu_torch.ops.waves import assign_waves
from kubernetes_tpu_torch.parallel import axis
from kubernetes_tpu_torch.parallel.mesh import (
    MeshState, ShardedTables, gather_state, make_mesh, mesh_key,
    pad_node_tables, replicate, shard_tables)
from kubernetes_tpu_torch.state.arrays import tables_to_torch, to_device
from torch_parity import CPU, encode

pytestmark = [
    pytest.mark.mesh,
    pytest.mark.skipif(len(jax.devices()) < 8,
                       reason="needs 8 (virtual) devices — set XLA_FLAGS="
                              "--xla_force_host_platform_device_count=8"),
]

SHARDS = 8
HOSTNAME = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"


def cpu_mesh(n=SHARDS):
    return make_mesh(n, devices=[CPU] * n)


def as_np(x):
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


# --------------------------------------------------------------------- #
# the four runs of one cycle
# --------------------------------------------------------------------- #

@functools.partial(jax.jit, static_argnums=(0, 6, 7))
def _jax_cycle(engine, tables, pe, ex, uk, ev, D, rc=0):
    cyc = j_build_cycle(tables, ex, uk, ev, D)
    init = j_initial_state(tables, cyc)
    if engine == "waves":
        res = j_assign_waves(tables, cyc, pe, init)
    elif engine == "scan":
        res = j_assign_batch(tables, cyc, pe, init)
    else:
        res = j_assign_runs(tables, cyc, pe, init, rc)
    return res.node, res.feasible, res.state, j_feasible_matrix(tables, cyc,
                                                                pe)


@functools.partial(jax.jit, static_argnums=(6,))
def _jax_gang(tables, pe, ex, gang, uk, ev, D):
    cyc = j_build_cycle(tables, ex, uk, ev, D)
    res, dead = j_assign_gang(tables, cyc, pe, j_initial_state(tables, cyc),
                              gang)
    return res.node, res.feasible, res.state, dead


def _rc(pe) -> int:
    return plan_runs(np.asarray(pe.cls), np.asarray(pe.priority),
                     np.asarray(pe.creation), np.asarray(pe.valid),
                     np.asarray(pe.node_name_req)).rc


def jax_runs(engine, tables, pe, ex, keys, D, gang=None):
    """(unsharded, 8-device mesh) results of the JAX package as numpy."""
    uk, ev = jnp.int32(keys[0]), jnp.int32(keys[1])
    mesh = j_make_mesh(SHARDS)
    out = []
    for sharded in (False, True):
        t = j_shard_tables(tables, mesh) if sharded else jax.device_put(
            tables)
        put = (lambda x: j_replicate(x, mesh)) if sharded \
            else jax.device_put
        if engine == "gang":
            r = _jax_gang(t, put(pe), put(ex), put(gang), uk, ev, D)
        else:
            r = _jax_cycle(engine, t, put(pe), put(ex), uk, ev, D,
                           _rc(pe) if engine == "runs" else 0)
        out.append(jax.tree.map(as_np, r))
    return out


def _port_engine(engine, rc):
    def run(t, cyc, pe, init, g):
        if engine == "waves":
            return assign_waves(t, cyc, pe, init), None
        if engine == "scan":
            return assign_batch(t, cyc, pe, init), None
        if engine == "runs":
            return assign_runs(t, cyc, pe, init, rc), None
        return assign_gang(t, cyc, pe, init, g)
    return run


def port_run(engine, tables, pe, ex, keys, D, gang=None, mesh=None):
    """The port's cycle, on `mesh` when given: (node, feasible, state,
    [P, N] feasibility or the dead groups) as numpy."""
    rc = _rc(pe) if engine == "runs" else 0
    fn = _port_engine(engine, rc)

    def one(t, p, e, g):
        cyc = build_cycle(t, e, keys[0], keys[1], D)
        res, dead = fn(t, cyc, p, initial_state(t, cyc), g)
        extra = dead if engine == "gang" else axis.current().gather(
            feasible_matrix(t, cyc, p), 1)
        return res.node, res.feasible, gather_state(res.state), extra

    if mesh is None:
        out = one(tables, pe, ex, gang)
    else:
        st = shard_tables(tables, mesh)
        out = st.run(one, replicate(pe, mesh), replicate(ex, mesh),
                     replicate(gang, mesh))[0]
    return jax.tree.map(as_np, out)


def assert_all_equal(runs, names):
    ref = runs[0]
    for got, name in zip(runs[1:], names[1:]):
        for i, (a, b) in enumerate(zip(jax.tree.leaves(ref),
                                       jax.tree.leaves(got))):
            np.testing.assert_array_equal(
                b, a, err_msg=f"{name} differs from {names[0]} (leaf {i})")


def four_ways(engine, enc, gang_np=None):
    """The JAX package unsharded and on 8 devices, the port unsharded and on
    8 shards, all at the mesh-padded N (the wave engine's tie-break
    rotation is keyed mod N), held equal."""
    from kubernetes_tpu.parallel.mesh import pad_node_tables as j_pad

    tables, ex, pe = enc["np"]
    tables = j_pad(tables, SHARDS)
    keys, D = enc["keys"], enc["dims"].D
    tt, ext, pet = enc["torch"]
    tt = pad_node_tables(tt, SHARDS)
    gang_t = None if gang_np is None else to_device(gang_np, CPU)
    j_un, j_mesh = jax_runs(engine, tables, pe, ex, keys, D, gang_np)
    p_un = port_run(engine, tt, pet, ext, keys, D, gang_t)
    p_mesh = port_run(engine, tt, pet, ext, keys, D, gang_t, cpu_mesh())
    runs = [j_un, j_mesh, p_un, p_mesh]
    assert_all_equal(runs, ["jax", "jax mesh", "port", "port mesh"])
    return runs


@pytest.fixture(scope="module")
def cluster():
    nodes = make_nodes(64, zones=8, racks_per_zone=4)
    pods = flagship_pods(96, groups=12)
    return encode(nodes, [], pods)


# --------------------------------------------------------------------- #
# test_mesh.py
# --------------------------------------------------------------------- #

def test_mesh_requires_enough_devices():
    with pytest.raises(RuntimeError, match="devices visible"):
        make_mesh(SHARDS + 1, devices=[CPU] * SHARDS)
    n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="devices visible"):
        make_mesh(n_cuda + 1)


@pytest.mark.parametrize("engine", ["waves", "scan"])
def test_sharded_cycle_matches_unsharded(cluster, engine):
    """Both engines on the 8-shard mesh equal their unsharded run and the
    JAX package's unsharded and mesh runs, the final state included."""
    runs = four_ways(engine, cluster)
    assert int(runs[-1][1].sum()) > 0, "sharded cycle scheduled nothing"


def test_sharded_tables_placement(cluster):
    tt, _, _ = cluster["torch"]
    st = shard_tables(tt, cpu_mesh())
    N = int(tt.nodes.valid.shape[0])
    assert len(st.shards) == SHARDS and st.n_nodes == N
    assert st.offsets == tuple(range(0, N, N // SHARDS))
    for i, sh in enumerate(st.shards):
        lo = st.offsets[i]
        # each shard holds its own contiguous block of every node plane
        for a, b in zip(sh.nodes, tt.nodes):
            assert torch.equal(a, b[lo:lo + N // SHARDS])
        # the class tables are replicated whole
        assert torch.equal(sh.classes.rid, tt.classes.rid)
    # the shards own their rows: no shard's plane aliases the input's
    assert st.shards[0].nodes.alloc.data_ptr() != tt.nodes.alloc.data_ptr()
    assert torch.equal(st.gather().nodes.alloc, tt.nodes.alloc)


def test_make_mesh_error_carries_virtual_mesh_note():
    """The raise names the virtual-mesh form in its PEP 678 notes, so a
    wrapped or re-raised error keeps the fix visible."""
    with pytest.raises(RuntimeError) as ei:
        make_mesh(SHARDS + 1, devices=[CPU] * SHARDS)
    assert any("virtual mesh" in n for n in ei.value.__notes__)


class TestNodeAxisPadding:
    """A node count the mesh does not divide: inert rows pad the axis, the
    padded sharded run equals the unsharded one at the same padded N (both
    packages), and no pod lands on a pad row."""

    def _sliced(self, cluster, n_real):
        tables, ex, pe = cluster["np"]
        nodes = type(tables.nodes)(*[np.asarray(a)[:n_real]
                                     for a in tables.nodes])
        tables = tables._replace(nodes=nodes)
        tt, (ext, pet) = tables_to_torch(tables, (ex, pe), CPU)
        return dict(cluster, np=(tables, ex, pe), torch=(tt, ext, pet))

    def test_pad_node_tables_shapes_and_inertness(self, cluster):
        tt = self._sliced(cluster, 60)["torch"][0]
        padded = pad_node_tables(tt, SHARDS)
        n = padded.nodes
        assert n.valid.shape[0] == 64
        assert not n.valid[60:].any() and n.unschedulable[60:].all()
        assert (n.alloc[60:] == 0).all() and (n.name_id[60:] == -1).all()
        # the bitset words pad with 0 (the JAX package's uint32 zero)
        assert (n.port_pair_any[60:] == 0).all()
        assert (n.vol_any[60:] == 0).all()
        assert (n.vol_limit[60:] == -1).all()
        assert pad_node_tables(padded, SHARDS) is padded

    def test_pad_matches_the_jax_package(self, cluster):
        from kubernetes_tpu.parallel.mesh import pad_node_tables as j_pad

        sl = self._sliced(cluster, 57)
        ref = j_pad(sl["np"][0], SHARDS)
        got = pad_node_tables(sl["torch"][0], SHARDS)
        for f in ref.nodes._fields:
            np.testing.assert_array_equal(as_np(getattr(got.nodes, f)),
                                          as_np(getattr(ref.nodes, f)),
                                          err_msg=f)

    @pytest.mark.parametrize("n_real", [60, 57])
    def test_nondivisible_bit_equal_zero_phantoms(self, cluster, n_real):
        sl = self._sliced(cluster, n_real)
        tables, ex, pe = sl["np"]
        from kubernetes_tpu.parallel.mesh import pad_node_tables as j_pad

        padded = j_pad(tables, SHARDS)
        tt_p = pad_node_tables(sl["torch"][0], SHARDS)
        sl_p = dict(sl, np=(padded, ex, pe),
                    torch=(tt_p,) + sl["torch"][1:])
        runs = four_ways("waves", sl_p)
        node, feas, state, mat = runs[-1]
        assert int(feas.sum()) > 0, "padded sharded cycle scheduled nothing"
        # zero phantom admissions, pad capacity untouched
        assert (node < n_real).all()
        assert (state.used[n_real:] == 0).all()
        assert not mat[:, n_real:].any()
        # padding is inert against the unpadded shape's feasibility
        raw = port_run("waves", *sl["torch"][:1], sl["torch"][2],
                       sl["torch"][1], sl["keys"], sl["dims"].D)
        np.testing.assert_array_equal(feas, raw[1])
        np.testing.assert_array_equal(mat[:, :n_real], raw[3])


# --------------------------------------------------------------------- #
# the gang and runs engines on the mesh (test_runs.py:368)
# --------------------------------------------------------------------- #

def test_mesh_sharded_runs_bit_equal():
    """The run-collapsed engine on the 8-shard mesh equals its unsharded
    run, the unsharded scan and both of the JAX package's runs (the
    engine's closed runs take the admission prefix on the lead shard,
    its fallback runs the scan gathered there)."""
    nodes = make_nodes(64, zones=8, racks_per_zone=4)
    enc = encode(nodes, [], flagship_pods(96, groups=8))
    runs = four_ways("runs", enc)
    scan = port_run("scan", *enc["torch"][:1], enc["torch"][2],
                    enc["torch"][1], enc["keys"], enc["dims"].D,
                    mesh=cpu_mesh())
    np.testing.assert_array_equal(runs[-1][0], scan[0])
    assert int(runs[-1][1].sum()) > 0


def test_mesh_gang_rounds_bit_equal():
    """Gang rounds over the sharded wave engine: flagship and gang pods
    plus a group no node can hold, the dead groups equal too."""
    import kubernetes_tpu.parallel.dryrun as jd

    tables, pe, ex, gang, keys, d = jd.encode_mixed(64, 128)
    tables, pe, ex, gang = jax.tree.map(np.asarray, (tables, pe, ex, gang))
    tt, (ext, pet) = tables_to_torch(tables, (ex, pe), CPU)
    enc = dict(np=(tables, ex, pe), torch=(tt, ext, pet),
               keys=(int(keys[0]), int(keys[1])), dims=d)
    runs = four_ways("gang", enc, gang)
    assert int(runs[-1][3].sum()) >= 1  # the monster group is rejected
    assert int(runs[-1][1].sum()) > 0


# --------------------------------------------------------------------- #
# shards whose local maxima differ from the global ones
# --------------------------------------------------------------------- #

def _skewed_cluster():
    """64 nodes, 8 a shard: preferred node affinity to `tier=gold` (only
    the last three shards' nodes), a PreferNoSchedule taint on the first
    two shards', a large image on shard 6's, the `db` pods on shard 7's
    and the `web` pods on shard 0's — so each shard's local max of the
    preferred-affinity sums, the taint counts, the soft inter-pod counts
    and the selector-spread counts differs from the global one."""
    gold = JT.NodeSelectorTerm(requirements=(
        JT.Requirement(key="tier", op=JT.Op.IN, values=("gold",)),))
    silver = JT.NodeSelectorTerm(requirements=(
        JT.Requirement(key="tier", op=JT.Op.IN, values=("silver",)),))
    nodes = [JT.Node(
        name=f"n{i}",
        labels={HOSTNAME: f"n{i}", ZONE: f"z{i % 4}",
                "tier": "gold" if i >= 40 else "silver"},
        allocatable=JT.Resources.make(cpu="16", memory="32Gi", pods=110),
        taints=(JT.Taint(key="soft", value="x",
                         effect=JT.TaintEffect.PREFER_NO_SCHEDULE),)
        if i < 16 else (),
        images_kib={"big": 400 * 1024} if 48 <= i < 56 else {})
        for i in range(64)]
    web = JT.LabelSelector.of(match_labels={"app": "web"})
    existing = [JT.Pod(name=f"db{i}", labels={"app": "db"},
                       requests=JT.Resources.make(cpu="500m"),
                       node_name=f"n{56 + i % 8}", creation_index=i)
                for i in range(16)]
    existing += [JT.Pod(name=f"w{i}", labels={"app": "web"},
                        requests=JT.Resources.make(cpu="500m"),
                        spread_selectors=(web,),
                        node_name=f"n{i % 4}", creation_index=100 + i)
                 for i in range(8)]
    db = JT.PodAffinityTerm(
        selector=JT.LabelSelector.of(match_labels={"app": "db"}),
        topology_key=ZONE)
    pending = [JT.Pod(
        name=f"p{i}", labels={"app": "web"},
        requests=JT.Resources.make(cpu="1", memory="1Gi"),
        affinity=JT.Affinity(
            node_preferred=(JT.PreferredSchedulingTerm(80, gold),
                            JT.PreferredSchedulingTerm(20, silver)),
            pod_preferred=(JT.WeightedPodAffinityTerm(50, db),)),
        spread_selectors=(web,), images=("big",),
        creation_index=200 + i) for i in range(40)]
    return encode(nodes, existing, pending)


class TestLocalMaximaDiffer:
    @pytest.fixture(scope="class")
    def skewed(self):
        return _skewed_cluster()

    @pytest.mark.parametrize("engine", ["waves", "scan"])
    def test_sharded_equals_unsharded(self, skewed, engine):
        four_ways(engine, skewed)

    def test_shard_local_reductions_change_the_answer(self, skewed,
                                                      monkeypatch):
        """The same sharded run with every cross-shard max and sum kept
        local (a broken all_reduce) scores differently: the data above
        would catch a reduction left shard-local."""
        from kubernetes_tpu_torch.sched.cycle import _scores

        tt, ext, pet = skewed["torch"]
        keys, D = skewed["keys"], skewed["dims"].D
        st = shard_tables(tt, cpu_mesh())
        ref = _scores(tt, pet, keys, D, ext)
        np.testing.assert_array_equal(as_np(_scores(st, pet, keys, D, ext)),
                                      as_np(ref))
        monkeypatch.setattr(axis.ShardAxis, "all_reduce",
                            lambda self, x, op: x)
        broken = _scores(st, pet, keys, D, ext)
        assert not torch.equal(broken, ref)

    def test_preemption_bursts_on_the_mesh(self, skewed):
        """A preemption burst (K3's plain version per shard, the node choice
        on the lead shard) equals the unsharded burst and the JAX
        package's."""
        from kubernetes_tpu.ops.preempt import preempt_batch as j_preempt
        from kubernetes_tpu_torch.sched.preemption import _preempt

        tables, ex, pe = skewed["np"]
        tt, ext, _ = skewed["torch"]
        keys, D = skewed["keys"], skewed["dims"].D
        lanes = np.arange(8, dtype=np.int32)
        cls = np.asarray(pe.cls)[lanes].astype(np.int32)
        nnr = np.asarray(pe.node_name_req)[lanes].astype(np.int32)
        prio = np.full(8, 100, np.int32)
        pdb = np.zeros(np.asarray(ex.valid).shape, bool)
        pdb[::3] = True
        cyc = jax.jit(j_build_cycle, static_argnums=(4,))(
            jax.device_put(tables), jax.device_put(ex), jnp.int32(keys[0]),
            jnp.int32(keys[1]), D)
        ref = jax.jit(j_preempt, static_argnums=(6,))(
            jax.device_put(tables), cyc, jax.device_put(ex),
            jnp.asarray(cls), jnp.asarray(nnr), jnp.asarray(prio), D,
            jnp.asarray(pdb))
        args = (torch.from_numpy(cls), torch.from_numpy(nnr),
                torch.from_numpy(prio), D, keys, torch.from_numpy(pdb))
        un = _preempt(tt, ext, *args)
        got = _preempt(shard_tables(tt, cpu_mesh()), ext, *args)
        for f in ref._fields:
            np.testing.assert_array_equal(as_np(getattr(un, f)),
                                          as_np(getattr(ref, f)), err_msg=f)
            np.testing.assert_array_equal(as_np(getattr(got, f)),
                                          as_np(getattr(ref, f)), err_msg=f)
        assert (as_np(got.node) >= 0).any()

    def test_explain_on_the_mesh(self, skewed):
        """The attribution of a sharded wave (ranked on the lead shard over
        the gathered lattice) equals the unsharded one."""
        from kubernetes_tpu_torch.sched.cycle import schedule_batch

        tt, ext, pet = skewed["torch"]
        keys, D = skewed["keys"], skewed["dims"].D
        r0, e0 = schedule_batch(tt, pet, keys, D, ext, explain=True)
        r1, e1 = schedule_batch(shard_tables(tt, cpu_mesh()), pet, keys, D,
                                ext, explain=True)
        assert torch.equal(r0.node, r1.node)
        for f in e0._fields:
            assert torch.equal(getattr(e0, f), getattr(e1, f)), f


# --------------------------------------------------------------------- #
# the serving path: TestMeshResidentCache
# --------------------------------------------------------------------- #

def _mk_sched(mesh, n_nodes=16, batch=8, side="port", **kw):
    from kubernetes_tpu.sched.scheduler import RecordingBinder as JBinder
    from kubernetes_tpu.sched.scheduler import Scheduler as JScheduler
    from kubernetes_tpu_torch.sched.scheduler import RecordingBinder, \
        Scheduler
    from kubernetes_tpu_torch.state.dims import Dims

    if side == "jax":
        types, s = JT, JScheduler(
            binder=JBinder(), mesh=mesh, batch_size=batch,
            base_dims=JDims().grown_for(N=n_nodes, P=batch, E=64))
        s.prewarmer.enabled = False
    else:
        types, s = TT, Scheduler(
            binder=RecordingBinder(), mesh=mesh, batch_size=batch,
            device="cpu", base_dims=Dims().grown_for(N=n_nodes, P=batch,
                                                     E=64), **kw)
    for i in range(n_nodes):
        s.on_node_add(types.Node(name=f"n{i}", allocatable=types.Resources
                                 .make(cpu="64", memory="64Gi", pods=110)))
    return types, s


def _feed(types, s, k, start=0):
    for i in range(start, start + k):
        s.on_pod_add(types.Pod(name=f"p{i}",
                               requests=types.Resources.make(cpu="100m"),
                               creation_index=i))


def _drain(s, limit=40):
    waves = 0
    while s.queue.lengths()[0] > 0 and waves < limit:
        s.schedule_pending()
        waves += 1
        if not s.supervisor.healthy:
            assert s.supervisor.wait_recovered(timeout=30)


class TestMeshResidentCache:
    def test_snapshot_places_tables_sharded_and_rest_replicated(self):
        types, s = _mk_sched(MeshState(SHARDS, devices=[CPU] * SHARDS))
        _feed(types, s, 4)
        snap, _ = s._snapshot_keys(s.queue.peek_active(4))
        assert snap.mesh is s.mesh_state.mesh
        assert isinstance(snap.tables, ShardedTables)
        assert len(snap.tables.shards) == SHARDS
        assert snap.tables.n_nodes % SHARDS == 0
        ref = snap.tables.shards[0]
        for sh in snap.tables.shards[1:]:
            assert torch.equal(sh.classes.rid, ref.classes.rid)
            assert sh.nodes.alloc.shape[0] == ref.nodes.alloc.shape[0]
        # the pods stay on the snapshot's device, whole
        assert snap.pending.cls.shape[0] == snap.dims.P

    def test_steady_state_donates_never_reuploads(self):
        """One cold upload; every later on-path snapshot writes the resident
        shards in place; the prestage snapshot taken while a wave was in
        flight took the copy path."""
        types, s = _mk_sched(MeshState(SHARDS, devices=[CPU] * SHARDS))
        _feed(types, s, 40)
        while s.queue.lengths()[0] > 0:
            s.schedule_pending()
        assert len(s.binder.bound) == 40
        assert s.cache.resident_full_uploads == 1
        assert s.cache.resident_donated_patches >= 3
        assert s.cache.resident_copy_patches >= 1
        assert s.cache._dispatch_inflight == 0

    def test_in_place_patch_keeps_the_resident_storage(self):
        """An on-path patch writes each shard's own rows into the planes it
        already holds (no new storage); a patch while a dispatch holds them
        leaves them untouched."""
        types, s = _mk_sched(MeshState(SHARDS, devices=[CPU] * SHARDS))
        _feed(types, s, 2)
        s.schedule_pending()
        snap0, _ = s._snapshot_keys([])
        ptrs = [sh.nodes.used.data_ptr() for sh in snap0.tables.shards]
        s.on_node_add(TT.Node(name="n3", labels={"x": "y"},
                              allocatable=TT.Resources.make(
                                  cpu="32", memory="64Gi", pods=110)))
        snap1, _ = s._snapshot_keys([])
        assert [sh.nodes.used.data_ptr()
                for sh in snap1.tables.shards] == ptrs
        s.cache.mark_dispatch_start()
        before = snap1.tables.shards[0].nodes.alloc.clone()
        s.on_node_add(TT.Node(name="n0", allocatable=TT.Resources.make(
            cpu="1", memory="1Gi", pods=110)))
        snap2, _ = s._snapshot_keys([])
        s.cache.mark_dispatch_done()
        assert torch.equal(snap1.tables.shards[0].nodes.alloc, before)
        assert not torch.equal(snap2.tables.shards[0].nodes.alloc, before)

    def test_mesh_placements_bit_equal_to_single_device(self):
        """The same cluster and pod stream through the port's mesh-resident
        path, its single-device path and both of the JAX package's bind
        every pod to the same node."""
        def run(side, mesh):
            types, s = _mk_sched(mesh, side=side)
            _feed(types, s, 40)
            while s.queue.lengths()[0] > 0:
                s.schedule_pending()
            return sorted(s.binder.bound)

        ref = run("jax", None)
        assert run("jax", 8) == ref
        assert run("port", None) == ref
        assert run("port", MeshState(SHARDS, devices=[CPU] * SHARDS)) == ref

    @pytest.mark.chaos
    def test_device_loss_degrades_reshards_and_recovers(self, monkeypatch):
        """A device error on the mesh: the wave runs on the CPU fallback
        (the mesh dropped, its shards never read), the prober re-admits,
        the forced-degrade probe reforms a narrower mesh, the resident
        state re-shards onto it, and every pod binds exactly once."""
        from kubernetes_tpu_torch.utils import faultline

        monkeypatch.setenv("KTPU_PROBE_BACKOFF", "0.05")
        faultline.install("device.error@cycle:2,mesh.degrade@probe:1")
        try:
            types, s = _mk_sched(MeshState(SHARDS, devices=[CPU] * SHARDS),
                                 fallback_device="cpu")
            mesh0 = s.mesh_state.mesh
            _feed(types, s, 48)
            _drain(s, 24)
            st = s.supervisor.stats
            assert st.degraded_cycles >= 1, "fault fired but nothing degraded"
            assert st.recoveries >= 1
            assert s.mesh_state.demotions == 1
            mesh1 = s.mesh_state.mesh
            assert mesh1 is not None and mesh1.size < mesh0.size
            snap = s.cache._snapshot
            assert snap.mesh is mesh1
            assert len(snap.tables.shards) == mesh1.size
            bound = [k for k, _ in s.binder.bound]
            assert len(bound) == 48 and len(set(bound)) == 48
            assert sum(s.queue.lengths()) == 0
        finally:
            faultline.uninstall()

    def test_full_width_probe_restores_the_mesh(self, monkeypatch):
        """A second loss after a narrow reform: the full-width probe (one
        all-reduce over every shard of the full mesh) passes, and the mesh
        comes back at full width."""
        from kubernetes_tpu_torch.utils import faultline

        monkeypatch.setenv("KTPU_PROBE_BACKOFF", "0.05")
        faultline.install("device.error@cycle:2,mesh.degrade@probe:1,"
                          "device.error@cycle:5")
        try:
            types, s = _mk_sched(MeshState(SHARDS, devices=[CPU] * SHARDS),
                                 fallback_device="cpu")
            _feed(types, s, 64)
            _drain(s, 30)
            assert s.mesh_state.demotions == 2
            assert s.mesh_state.reforms == 2
            assert s.mesh_state.mesh.size == SHARDS
            bound = [k for k, _ in s.binder.bound]
            assert len(bound) == 64 and len(set(bound)) == 64
        finally:
            faultline.uninstall()

    def test_mesh_state_reform_restores_full_width_when_probe_passes(self):
        ms = MeshState(SHARDS, devices=[CPU] * SHARDS)
        assert ms.n_devices == 8
        ms.on_backend_loss()
        assert ms.mesh is None
        assert ms.reform().size == 4   # half the lost width
        assert ms.reform(full=True).size == 8
        ms.on_backend_loss()
        assert ms.reform().size == 4

    def test_mesh_key_distinguishes_widths_not_objects(self):
        m8a, m8b = cpu_mesh(8), cpu_mesh(8)
        assert m8a is not m8b and mesh_key(m8a) == mesh_key(m8b)
        assert mesh_key(m8a) != mesh_key(cpu_mesh(4))
        assert mesh_key(None) is None
        # the same width over other devices is another key
        other = make_mesh(8, devices=[torch.device("cpu", 1)] * 8)
        assert mesh_key(other) != mesh_key(m8a)


# --------------------------------------------------------------------- #
# test_prewarm.py TestMeshSignatureIsolation
# --------------------------------------------------------------------- #

class TestMeshSignatureIsolation:
    def test_mesh_and_single_device_warm_separate_keys(self):
        from kubernetes_tpu_torch.sched.prewarm import BucketPrewarmer
        from kubernetes_tpu_torch.state.dims import Dims

        mesh = cpu_mesh()
        calls = []
        pw = BucketPrewarmer(
            threshold=0.8, min_axis=8, device="cpu",
            compile_fn=lambda d, e, x, g, rc=0, fleet=None, mesh=None:
            calls.append((d, mesh)))
        d = Dims().grown_for(N=16, E=16)
        pw.observe(d, n_nodes=14, n_existing=1)
        pw.wait(5)
        pw.observe(d, n_nodes=14, n_existing=1, mesh=mesh)
        pw.wait(5)
        assert len(calls) == 2
        assert calls[0][1] is None and calls[1][1] is mesh

    def test_lookup_isolation_across_mesh_signatures(self):
        from kubernetes_tpu_torch.sched.prewarm import BucketPrewarmer
        from kubernetes_tpu_torch.state.dims import Dims

        mesh = cpu_mesh()
        pw = BucketPrewarmer(threshold=0.8, min_axis=8, device="cpu")
        d = Dims().grown_for(N=16, E=16)
        base = dataclasses.replace(d, has_node_name=False)
        pw.warm[(base, "waves", (), False, 0, None, mesh_key(mesh))] = 1.0
        pw.warm[(base, "waves", (), False, 0, None, None)] = 2.0
        assert pw.lookup(d, "waves", (), False, mesh=mesh)
        assert pw.lookup(d, "waves", (), False, mesh=None)
        assert not pw.lookup(d, "waves", (), False, mesh=cpu_mesh(4))
        pw.warm[(base, "runs", (), False, 16, None, None)] = 3.0
        assert pw.lookup(d, "runs", (), False, rc=16)
        assert not pw.lookup(d, "runs", (), False, rc=32)
        pw.warm[pw._preempt_key(d, 8, mesh)] = 4.0
        assert not pw.lookup_preempt(d, 8, mesh=None)
        assert pw.lookup_preempt(d, 8, mesh=mesh)

    def test_a_mesh_warm_runs_the_probe_cycle_sharded(self):
        """The port's warm is a throwaway dispatch: on a mesh it runs the
        probe cycle sharded on that mesh (the counterpart of the JAX
        package's AOT compile of the partitioned program)."""
        from kubernetes_tpu_torch.sched.prewarm import BucketPrewarmer
        from kubernetes_tpu_torch.state.dims import Dims

        mesh = cpu_mesh()
        pw = BucketPrewarmer(threshold=0.8, min_axis=8, device="cpu")
        d = Dims().grown_for(N=16, P=16, E=16)
        assert pw.rewarm(d, mesh=mesh)
        pw.wait(60)
        assert pw.lookup(d, "waves", (), False, mesh=mesh)
        assert not pw.lookup(d, "waves", (), False)
        assert axis.LAST_RUN.get("shards") == SHARDS
