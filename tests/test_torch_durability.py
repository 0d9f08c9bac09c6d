"""The port's durable control plane (kubernetes_tpu_torch/storage/wal.py,
storage/native.py DurableKV and NativeKV over csrc/kvstore.cpp, the Storage
and APIServer wiring), held against the JAX package's.

tests/test_durability.py's 28 cases, each run on both packages with its
`native|python` backend fixture on both sides (tests/test_torch_twin.py
`mirror`): framing, persistence and revision continuity, snapshots, the
recovery decision table, the crash sites on each package's own fault
switchboard, the backend parity goldens, the Storage wiring and the
cold-restart drill (the port's Scheduler on the CPU). Every DurableKV and
WAL call returns the same revisions and records on both, and each run's
data dir is byte-identical to the other's. Beyond them: the parity golden
across packages (the same operations through the JAX package's DurableKV
and the port's give byte-identical segments and snapshots) and the
cross-recovery both ways (a data dir written by one package recovers in the
other to the same records, revisions and compaction floor, and the next
write continues the sequence). All host code: equality is exact.
"""

import pytest
from test_durability import _scripted_ops, _wal_bytes
from test_torch_twin import mirror, norm, tree_bytes

from kubernetes_tpu.storage import native as jnative
from kubernetes_tpu.storage import wal as jwal
from kubernetes_tpu_torch.storage import native as tnative
from kubernetes_tpu_torch.storage import wal as twal

mirror(globals(), "test_durability", files=True,
       select=lambda cls, name: cls != "TestColdRestartDrill", record=[
           "storage.native.DurableKV.put", "storage.native.DurableKV.txn_put",
           "storage.native.DurableKV.txn_delete",
           "storage.native.DurableKV.compact",
           "storage.native.DurableKV.snapshot",
           "storage.native.DurableKV.get", "storage.native.DurableKV.range",
           "storage.native.DurableKV.rev",
           "storage.native.DurableKV.compacted_rev",
           "storage.native.DurableKV.events_since",
           "storage.wal.encode_record", "storage.wal.decode_record",
           "storage.wal.frame", "storage.wal.list_segments",
           "storage.wal.list_snapshots", "storage.store.Storage.create",
           "storage.store.Storage.get",
           "storage.store.Storage.guaranteed_update"])
# the cold-restart drill on the port's Scheduler (CPU). Its bind intents
# carry a random name suffix and holder identity (sched/ledger.py), so its
# data dirs are not compared byte for byte and its recorded calls (every
# request to the apiserver, every object the ledger reads and writes) read
# those two scrubbed
mirror(globals(), "test_durability",
       select=lambda cls, name: cls == "TestColdRestartDrill",
       subs=[("s = Scheduler(binder=APIBinder(client),",
              "s = Scheduler(device='cpu', binder=APIBinder(client),")],
       scrub=[(r"(c\d{8}-\d{4}-)[0-9a-f]{8}", r"\1*"),
              (r"^\d+-[0-9a-f]{6}$", "<holder>")],
       record=["apiserver.server.handle_rest", "storage.store.Storage.create",
               "storage.store.Storage.get", "storage.store.Storage.list",
               "storage.store.Storage.guaranteed_update",
               "storage.store.Storage.delete"])

NATIVE = {"jax": jnative, "port": tnative}
BACKENDS = ("native", "python")


def backend(pkg, kind):
    m = NATIVE[pkg]
    return m.NativeKV() if kind == "native" else m.PyKV()


def durable(pkg, kind, path, **kw):
    return NATIVE[pkg].DurableKV(backend(pkg, kind), str(path),
                                 durability="always", **kw)


def state(kv):
    return (kv.rev(), kv.compacted_rev(),
            [norm(r) for r in kv.range("")[0]],
            [norm(e) for e in kv.events_since(kv.compacted_rev())])


@pytest.mark.parametrize("kind", BACKENDS)
def test_parity_golden_across_packages(tmp_path, kind):
    """The scripted operations of test_durability's parity golden through
    the JAX package's DurableKV and the port's: the same trace, the same
    WAL bytes, and after a snapshot the same segment and snapshot files."""
    kv_j = durable("jax", kind, tmp_path / "j")
    kv_t = durable("port", kind, tmp_path / "t")
    trace_j, trace_t = _scripted_ops(kv_j), _scripted_ops(kv_t)
    assert norm(trace_t) == norm(trace_j)
    assert _wal_bytes(str(tmp_path / "t")) == _wal_bytes(str(tmp_path / "j"))
    for kv in (kv_j, kv_t):
        kv.snapshot()
        kv.put("/registry/tail", b"t")
        kv.close()
    assert tree_bytes(tmp_path / "t") == tree_bytes(tmp_path / "j")
    assert len(twal.list_snapshots(str(tmp_path / "t"))) == 1


@pytest.mark.parametrize("kind", BACKENDS)
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("snapshot", [False, True], ids=["wal", "snapshot"])
def test_cross_recovery(tmp_path, kind, writer, reader, snapshot):
    """A data dir written by one package recovers in the other: the same
    records, revisions and compaction floor as a reboot in the writer's own
    package, and the next write continues the sequence."""
    d = tmp_path / "store"
    kv = durable(writer, kind, d, snapshot_every=7 if snapshot else 10**6)
    _scripted_ops(kv)
    for i in range(9):
        kv.put(f"/registry/pods/ns/p{i}", f"v{i}".encode())
    kv.txn_delete("/registry/pods/ns/p3")
    kv.close()
    if snapshot:
        assert twal.list_snapshots(str(d))
    own = durable(writer, kind, d)
    want = state(own)
    own.close()
    other = durable(reader, kind, d)
    assert other.recovered
    assert state(other) == want
    assert other.put("/registry/next", b"x") == want[0] + 1
    other.close()
    again = durable(writer, kind, d)
    assert again.rev() == want[0] + 1
    assert norm(again.get("/registry/next")) == norm(
        jnative.KVRecord("/registry/next", b"x", want[0] + 1, want[0] + 1))
    again.close()


def test_torn_tail_from_one_package_truncates_in_the_other(tmp_path):
    d = tmp_path / "store"
    kv = durable("jax", "python", d)
    for i in range(3):
        kv.put(f"/k{i}", b"v")
    kv.close()
    seg = jwal.list_segments(str(d))[-1][1]
    with open(seg, "r+b") as f:
        f.truncate(f.seek(0, 2) - 3)
    kv = durable("port", "native", d)
    assert kv.torn_tail_truncated and kv.rev() == 2
    assert kv.put("/k2", b"w") == 3
    kv.close()
    kv = durable("jax", "native", d)
    assert kv.rev() == 3 and kv.get("/k2").value == b"w"
    kv.close()


def test_native_store_is_the_ports_own_build():
    """The port's C++ store is built from its own source into build/, not
    the JAX package's committed library."""
    lib = tnative._load_lib()
    assert lib is not None, tnative._build_error
    path = tnative.library_path()
    assert path.endswith(".so") and "/build/kvstore/" in path
    assert tnative.KV_SOURCE.endswith("kubernetes_tpu_torch/csrc/kvstore.cpp")
    assert isinstance(tnative.new_kv(), (tnative.NativeKV, tnative.PyKV))


def test_concurrent_first_builds_make_one_library(tmp_path):
    """Six processes asking for the C++ store at once (tier-1's workers)
    into one empty build directory: one compile, every process the same
    library, no temporary left behind, and the library loads."""
    import subprocess
    import sys

    snippet = (
        "import sys; from kubernetes_tpu_torch.storage import native as n; "
        f"n.BUILD_DIR = {str(tmp_path)!r}; p = n._build_lib(); "
        "print(p or n._build_error)")
    procs = [subprocess.Popen([sys.executable, "-c", snippet],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = {p.communicate(timeout=300)[0].strip() for p in procs}
    assert len(outs) == 1, outs
    path = outs.pop()
    assert path.startswith(str(tmp_path)) and path.endswith(".so")
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == [".lock", path.rsplit("/", 1)[1]], files
    import ctypes

    assert ctypes.CDLL(path).kv_new is not None
