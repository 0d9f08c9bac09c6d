"""The port's kvstore backends and Storage over each
(kubernetes_tpu_torch/storage/native.py NativeKV over csrc/kvstore.cpp and
PyKV, storage/store.py), held against the JAX package's.

tests/test_storage.py's cases, each run on both packages with its
`native|python` fixture on both sides (tests/test_torch_twin.py
`mirror`): revisions, transactions, range order and counts, events and
compaction (CompactedError), wait and its timeout, the Storage's create,
CAS updates, conflicts, deletes, lists and watches, the watch cache. Every
kv and Storage call the case makes returns the same records, revisions,
objects or error on both — the port's C++ store against the JAX package's
C++ store, not only against PyKV. Beyond them: one seeded script through
the four backends (two packages × native/python) gives the same ranges,
counts and event logs. All host code: equality is exact.
"""

import numpy as np
import pytest
from test_torch_twin import mirror, norm

from kubernetes_tpu.storage import native as jnative
from kubernetes_tpu_torch.storage import native as tnative

KV = "storage.native.{}.{}"
# not rev(): some cases poll it until the watch pump catches up, as many
# times as the pump takes
METHODS = ("put", "txn_put", "txn_delete", "get", "range", "count",
           "events_since", "compact", "compacted_rev")

mirror(globals(), "test_storage", record=[
    KV.format(cls, m) for cls in ("NativeKV", "PyKV") for m in METHODS] + [
    "storage.store.Storage.create", "storage.store.Storage.get",
    "storage.store.Storage.list", "storage.store.Storage.delete",
    "storage.store.Storage.guaranteed_update"])


def backends():
    return {"jax/native": jnative.NativeKV(), "jax/python": jnative.PyKV(),
            "port/native": tnative.NativeKV(), "port/python": tnative.PyKV()}


@pytest.mark.parametrize("seed", range(3))
def test_four_backends_agree_on_a_seeded_script(seed):
    rng = np.random.default_rng(seed)
    kvs = backends()
    names = [f"/registry/{r}/{ns}/p-{i}" for r in ("pods", "podsx", "nodes")
             for ns in ("a", "b") for i in range(10)]
    prefixes = ["", "/registry/", "/registry/pods", "/registry/pods/",
                "/registry/pods/a/p-1", "/zzz"]
    ref = kvs["jax/native"]
    for step in range(400):
        key = names[rng.integers(len(names))]
        op = rng.integers(10)
        if op < 6:
            cur = ref.get(key)
            exp = (cur.mod_rev if cur is not None else 0) \
                if rng.integers(4) else -1
            val = f"v{step}".encode()
            got = {k: kv.txn_put(key, exp, val) for k, kv in kvs.items()}
        elif op < 9:
            exp = -1 if rng.integers(3) else int(rng.integers(ref.rev() + 1))
            got = {k: kv.txn_delete(key, exp) for k, kv in kvs.items()}
        else:
            at = int(rng.integers(max(1, ref.rev())))
            got = {k: kv.compact(at) for k, kv in kvs.items()}
        assert len(set(got.values())) == 1, (step, got)
        if step % 20 == 0:
            since = int(rng.integers(ref.rev() + 1))
            for pre in prefixes:
                seen = {}
                for k, kv in kvs.items():
                    try:
                        evs = norm(kv.events_since(since, pre))
                    except (jnative.CompactedError, tnative.CompactedError):
                        evs = "compacted"
                    seen[k] = (norm(kv.range(pre)), kv.count(pre), evs,
                               kv.rev(), kv.compacted_rev())
                assert all(v == seen["jax/native"] for v in seen.values()), \
                    (step, pre)
