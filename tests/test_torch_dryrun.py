"""The port's multi-device dryrun (kubernetes_tpu_torch/parallel/dryrun.py)
against the JAX package's (kubernetes_tpu/parallel/dryrun.py) on 8 shards
of the CPU.

The spec rung runs at the JAX package's own shape (max(8·n, 16) = 64 nodes ×
64 flagship pods, both engines); the production rung is cut from 4,096 ×
8,192 to 512 nodes × 1,024 pods (flagship and gang pods and the one group
no node can hold, as at full size) so the JAX package's unsharded and mesh
compiles fit the tier-1 budget; the bench rung (5,120 × 50,000) runs on the
card only (chip_smoke.py phase 17a). Each rung's sharded run must equal the
port's unsharded run (run_dryrun raises otherwise) and the JAX package's
unsharded and 8-device mesh runs: the scheduled count, the rejected gang
groups and the node map's sha256.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import kubernetes_tpu.parallel.dryrun as jd
from kubernetes_tpu.ops.assign import assign_batch, initial_state
from kubernetes_tpu.ops.gang import assign_gang
from kubernetes_tpu.ops.lattice import build_cycle
from kubernetes_tpu.ops.waves import assign_waves
from kubernetes_tpu.parallel.mesh import (make_mesh, pad_node_tables,
                                          replicate, shard_tables)
from kubernetes_tpu_torch.parallel import dryrun as td
from kubernetes_tpu_torch.parallel.mesh import make_mesh as t_make_mesh
from torch_parity import CPU

pytestmark = [
    pytest.mark.mesh,
    pytest.mark.skipif(len(jax.devices()) < 8,
                       reason="needs 8 (virtual) devices — set XLA_FLAGS="
                              "--xla_force_host_platform_device_count=8"),
]

N_DEV = 8
# the production rung's cut (full size: 4,096 nodes × 8,192 pods)
PROD = (512, 1024)


@functools.partial(jax.jit, static_argnums=(0, 5))
def _jax_step(engine, tables, pending, existing, keys, D):
    cyc = build_cycle(tables, existing, keys[0], keys[1], D)
    fn = assign_waves if engine == "waves" else assign_batch
    res = fn(tables, cyc, pending, initial_state(tables, cyc))
    return res.node, res.feasible


@functools.partial(jax.jit, static_argnums=(5,))
def _jax_gang_step(tables, pending, existing, gang, keys, D):
    cyc = build_cycle(tables, existing, keys[0], keys[1], D)
    res, dead = assign_gang(tables, cyc, pending,
                            initial_state(tables, cyc), gang)
    return res.node, res.feasible, dead


def _jax_both(step, tables, rest):
    """The JAX package's unsharded and 8-device runs, held equal."""
    mesh = make_mesh(N_DEV)
    ref = jax.tree.map(np.asarray, step(tables, *rest))
    got = jax.tree.map(np.asarray, step(shard_tables(tables, mesh),
                                        *replicate(rest, mesh)))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    return got


def _port(rungs, **kw):
    return {(r["rung"], r["engine"]): r for r in td.run_dryrun(
        devices=[CPU] * N_DEV, device="cpu", rungs=rungs, **kw)["rungs"]}


@pytest.fixture(scope="module")
def spec_rows():
    return _port(("spec",))


@pytest.mark.parametrize("engine", ["waves", "scan"])
def test_spec_rung_matches_jax(spec_rows, engine):
    row = spec_rows[("spec", engine)]
    tables, pe, ex, keys, d = jd.encode_flagship(64, 64)
    tables = pad_node_tables(tables, N_DEV)
    node, feas = _jax_both(
        lambda t, p, e, k: _jax_step(engine, t, p, e, k, d.D), tables,
        (pe, ex, keys))
    assert row["nodes"] == 64 and row["pods"] == 64
    assert row["bit_equal"] and row["scheduled"] == int(feas.sum())
    assert row["sha256"] == td.node_sha256(node)
    # the JAX package's recorded dryrun at 8 devices (MULTICHIP_r07.json)
    assert row["scheduled"] == 43


def test_spec_rung_moves_what_it_reports(spec_rows):
    """The sharded waves run took cross-shard steps on 8 shards: the
    reductions and the lead steps (the score sort, the map back)."""
    c = spec_rows[("spec", "waves")]["collectives"]
    assert c["shards"] == N_DEV
    assert c["all_reduce"] > 0 and c["gather"] > 0 and c["lead"] > 0
    assert c["gather_bytes"] > 0


def test_production_rung_cut_matches_jax():
    """Waves inside the gang rounds at the cut shape: counts, rejected
    groups and the node map equal the JAX package's on its mesh."""
    rows = _port(("production",), production=PROD)
    row = rows[("production", "waves+gang")]
    tables, pe, ex, gang, keys, d = jd.encode_mixed(*PROD)
    tables = pad_node_tables(tables, N_DEV)
    node, feas, dead = _jax_both(
        lambda t, p, e, g, k: _jax_gang_step(t, p, e, g, k, d.D), tables,
        (pe, ex, gang, keys))
    assert row["scheduled"] == int(feas.sum()) > 0
    assert row["rejected_gangs"] == int(dead.sum()) >= 1
    assert row["sha256"] == td.node_sha256(node)


def test_memory_report_splits_the_node_axis():
    tt, _pe, _ex, _keys, _d = td.encode_flagship(64, 8, CPU)
    from kubernetes_tpu_torch.parallel.mesh import shard_tables as t_shard

    rep = td.memory_report(t_shard(tt, t_make_mesh(N_DEV, devices=[CPU]
                                                   * N_DEV)), tt)
    assert rep["n_devices"] == N_DEV and rep["n_nodes"] == 64
    assert rep["node_axis_bytes"] + rep["replicated_bytes"] \
        == rep["table_bytes_single_device"]
    assert rep["table_bytes_per_device_sharded"] == \
        rep["node_axis_bytes"] // N_DEV + rep["replicated_bytes"]


def test_a_divergence_raises():
    """run_dryrun fails loudly when the sharded run differs: a compare of
    two results that differ in one node raises."""
    tt, pe, ex, keys, d = td.encode_flagship(16, 16, CPU)
    ref = td.run_cycle(tt, pe, ex, keys, d.D, td.waves_engine)
    bad_node = ref[0].node.clone()
    bad_node[0] = (bad_node[0] + 1) % 16
    bad = (ref[0]._replace(node=bad_node), None)
    with pytest.raises(AssertionError, match="sharded node differs"):
        td.compare(ref, bad, "spec/waves")


def test_dryrun_refuses_too_few_devices():
    n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="devices visible"):
        td.run_dryrun(n_cuda + 1, rungs=())
