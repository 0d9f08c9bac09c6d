"""The port's copied encoder and its move onto the device: the port's Encoder
(kubernetes_tpu_torch/state/encode.py) must give arrays identical to the JAX
package's on the same object graphs, and tables_to_torch must carry them onto
a torch device bit for bit (uint32 words as their int32 view)."""

import dataclasses
import random

import numpy as np
import pytest
import torch

from kubernetes_tpu.models.workloads import flagship_pods, gang_workload_pods, make_nodes
from kubernetes_tpu.sched.cycle import UNSCHEDULABLE_TAINT_KEY
from kubernetes_tpu.state.encode import Encoder as JaxEncoder
from kubernetes_tpu_torch.state import arrays as tarrays
from kubernetes_tpu_torch.state.encode import Encoder as PortEncoder

import test_golden
import test_scores


def _clusters():
    out = []
    for seed in range(3):
        rng = random.Random(5000 + seed)
        nodes = [test_golden.rand_node(rng, i) for i in range(rng.randint(4, 9))]
        existing = [test_golden.rand_pod(rng, 100 + i,
                                         bound_to=rng.choice(nodes).name)
                    for i in range(rng.randint(0, 6))]
        pending = [test_golden.rand_pod(rng, i)
                   for i in range(rng.randint(4, 14))]
        out.append((f"golden{seed}", nodes, existing, pending))
    rng = random.Random(5100)
    nodes = [test_scores.rand_node(rng, i) for i in range(6)]
    out.append(("scores", nodes,
                [test_scores.rand_pod(rng, 100 + i, bound_to=rng.choice(nodes).name)
                 for i in range(4)],
                [test_scores.rand_pod(rng, i) for i in range(8)]))
    out.append(("flagship", make_nodes(32, zones=4, racks_per_zone=2), [],
                flagship_pods(200, groups=10)))
    return out


CLUSTERS = _clusters()


def _encode(enc_cls, nodes, existing, pending):
    enc = enc_cls()
    enc.vocabs.label_keys.intern(UNSCHEDULABLE_TAINT_KEY)
    enc.vocabs.label_vals.intern("")
    return enc, enc.encode_cluster(nodes, existing, pending, None)


def _assert_arrays_equal(ref, got, name=""):
    if isinstance(ref, tuple) and hasattr(ref, "_fields"):
        assert type(ref).__name__ == type(got).__name__, name
        for f in ref._fields:
            _assert_arrays_equal(getattr(ref, f), getattr(got, f), f"{name}.{f}")
        return
    r, g = np.asarray(ref), np.asarray(got)
    assert r.dtype == g.dtype and r.shape == g.shape, name
    np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.mark.parametrize("case", CLUSTERS, ids=lambda c: c[0])
def test_port_encoder_matches_jax_encoder(case):
    _, nodes, existing, pending = case
    _, (tj, exj, pej, dj) = _encode(JaxEncoder, nodes, existing, pending)
    _, (tp, exp, pep, dp) = _encode(PortEncoder, nodes, existing, pending)
    assert dataclasses.asdict(dj) == dataclasses.asdict(dp)
    _assert_arrays_equal(tj, tp, "tables")
    _assert_arrays_equal(exj, exp, "existing")
    _assert_arrays_equal(pej, pep, "pending")


@pytest.mark.parametrize("case", CLUSTERS[::2], ids=lambda c: c[0])
def test_tables_to_torch_round_trips(case):
    """Either package's numpy tables become the port's tensors: bool and
    int32 unchanged, uint32 words reinterpreted as int32 with the same bits."""
    _, nodes, existing, pending = case
    for enc_cls in (JaxEncoder, PortEncoder):
        _, (tables, ex, pe, _) = _encode(enc_cls, nodes, existing, pending)
        tt, (ext, pet) = tarrays.tables_to_torch(tables, (ex, pe), "cpu")
        assert isinstance(tt, tarrays.ClusterTables)
        assert isinstance(pet, tarrays.PodArrays)

        def walk(ref, got, name):
            if isinstance(ref, tuple):
                assert type(got).__name__ == type(ref).__name__
                for f in ref._fields:
                    walk(getattr(ref, f), getattr(got, f), f"{name}.{f}")
                return
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
            want = {np.dtype(np.bool_): torch.bool,
                    np.dtype(np.int32): torch.int32,
                    np.dtype(np.uint32): torch.int32}[ref.dtype]
            assert got.dtype == want, name
            back = got.numpy()
            if ref.dtype == np.uint32:
                back = back.view(np.uint32)
            np.testing.assert_array_equal(back, ref, err_msg=name)

        walk(tables, tt, "tables")
        walk(ex, ext, "existing")
        walk(pe, pet, "pending")


def test_bit31_words_survive_the_int32_view():
    """A word with bit 31 set reads back through `(w >> s) & 1` on the int32
    view exactly as on the uint32 original."""
    w = np.array([0x80000001, 0xFFFFFFFF, 0x7FFFFFFF, 0], np.uint32)
    t = torch.from_numpy(w.view(np.int32))
    for s in range(32):
        got = ((t >> s) & 1).numpy()
        np.testing.assert_array_equal(got, (w >> np.uint32(s)) & 1)


def test_gang_arrays_match_jax_encoder():
    nodes = make_nodes(8, zones=2, racks_per_zone=2)
    pending = gang_workload_pods(40)
    encj, (_, _, _, dj) = _encode(JaxEncoder, nodes, [], pending)
    encp, (_, _, _, dp) = _encode(PortEncoder, nodes, [], pending)
    gj = encj.build_gang_arrays(pending, dj, {})
    gp = encp.build_gang_arrays(pending, dp, {})
    for f in gj._fields:
        np.testing.assert_array_equal(np.asarray(getattr(gp, f)),
                                      np.asarray(getattr(gj, f)), err_msg=f)
