"""Shared harness for the port's parity tests (tests/test_torch_*.py): encode a
cluster ONCE with the JAX package's Encoder, hand the same numpy arrays to
both packages, and compare their outputs field by field.

Both packages run on the CPU here: JAX under JAX_PLATFORMS=cpu, the port with
device="cpu" (its kernel wrappers take their plain versions on CPU tensors).
uint32 bitset words are compared through their int32 view (the port keeps
word planes as int32, same bits).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kubernetes_tpu.sched.cycle import UNSCHEDULABLE_TAINT_KEY
from kubernetes_tpu.state.encode import Encoder
from kubernetes_tpu_torch.state.arrays import tables_to_torch

CPU = torch.device("cpu")

# one intra-op thread: the suite runs several workers on one machine and
# these tests are small; more torch threads only contend with other tests'
# timing-sensitive threads
torch.set_num_threads(1)

# f32 score rows: both packages evaluate the same expression tree op for op
# (IEEE f32 on one CPU), and the sums involved hold integer-valued terms, so
# they agree to the bit in practice; the stated tolerance leaves room for a
# reduction-order rounding of non-integer sums (ImageLocality).
F32_ATOL = 1e-4


def encode(nodes, existing, pending):
    """(tables, existing, pending) as numpy, the JAX-device copies, the
    port's tensors, the unschedulable-taint key pair and dims."""
    enc = Encoder()
    enc.vocabs.label_keys.intern(UNSCHEDULABLE_TAINT_KEY)
    enc.vocabs.label_vals.intern("")
    tables, ex, pe, d = enc.encode_cluster(nodes, existing, pending, None)
    uk = enc.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY)
    ev = enc.vocabs.label_vals.get("")
    jx = (jax.device_put(tables), jax.device_put(ex), jax.device_put(pe))
    tt, (ext, pet) = tables_to_torch(tables, (ex, pe), CPU)
    return dict(np=(tables, ex, pe), jax=jx, torch=(tt, ext, pet),
                keys=(uk, ev), dims=d, encoder=enc)


def as_np(x) -> np.ndarray:
    """A JAX array or torch tensor as numpy, uint32 viewed as int32."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def assert_same(ref, got, name: str = "", atol: float = F32_ATOL) -> None:
    """Field-by-field equality of two (nested) NamedTuples or arrays: bool
    and int exactly, f32 within `atol` (inf where inf)."""
    if isinstance(ref, tuple) and hasattr(ref, "_fields"):
        for f in ref._fields:
            assert_same(getattr(ref, f), getattr(got, f), f"{name}.{f}", atol)
        return
    if isinstance(ref, (tuple, list)):
        assert len(ref) == len(got), name
        for i, (r, g) in enumerate(zip(ref, got)):
            assert_same(r, g, f"{name}[{i}]", atol)
        return
    if isinstance(ref, (float, int)) and not hasattr(ref, "shape"):
        assert float(ref) == float(got), name
        return
    r, g = as_np(ref), as_np(got)
    assert r.shape == g.shape, f"{name}: shape {r.shape} vs {g.shape}"
    if r.dtype.kind == "f":
        np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=name)
    else:
        assert r.dtype.kind == g.dtype.kind or {r.dtype.kind, g.dtype.kind} \
            <= {"i", "u"}, f"{name}: dtype {r.dtype} vs {g.dtype}"
        np.testing.assert_array_equal(g, r, err_msg=name)


def jax_cycle(enc):
    from kubernetes_tpu.ops.lattice import build_cycle

    tables, ex, _ = enc["jax"]
    uk, ev = enc["keys"]
    return jax.jit(build_cycle, static_argnums=(4,))(
        tables, ex, jnp.int32(uk), jnp.int32(ev), enc["dims"].D)


def torch_cycle(enc):
    from kubernetes_tpu_torch.ops.lattice import build_cycle

    tables, ex, _ = enc["torch"]
    uk, ev = enc["keys"]
    return build_cycle(tables, ex, uk, ev, enc["dims"].D)
