"""The kernel wrappers' Python-side launch choices (ops/kernels.py): K1's
variant and grid for given widths, K2's block and segment shape and where
its counters live for a given D+1 and N. Plain Python, no JAX and no card:
the kernels themselves are held against their plain versions on the card by
chip_smoke.py and tests/test_torch_cuda.py."""

import pytest
import torch

from kubernetes_tpu_torch.ops import kernels as K


# --------------------------------------------------------------------------- #
# K1 contention_scan
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("widths,variant", [
    ((4, 1, 1, 1, 2), "registers"),     # the flagship's
    ((8, 4, 4, 4, 4), "registers"),     # every width at its bound
    ((9, 4, 4, 4, 4), "shared"),        # R one past
    ((8, 5, 4, 4, 4), "shared"),        # PW one past
    ((8, 4, 5, 4, 4), "shared"),        # PT one past
    ((8, 4, 4, 5, 4), "shared"),        # VW one past
    ((8, 4, 4, 4, 5), "shared"),        # DR one past
    ((4, 2, 2, 8, 2), "shared"),        # the port-and-volume cycle's
])
def test_k1_variant_follows_the_register_bounds(widths, variant):
    assert K.k1_launch_config(52, 5120, *widths).variant == variant


@pytest.mark.parametrize("N,warps,blocks", [
    (1, 1, 1), (7, 7, 1), (8, 8, 1), (33, 8, 5), (5000, 8, 625),
    (5120, 8, 640),
])
def test_k1_grid_is_one_warp_per_node(N, warps, blocks):
    cfg = K.k1_launch_config(52, N, 4, 1, 1, 1, 2)
    assert (cfg.warps, cfg.blocks) == (warps, blocks)
    assert cfg.warps * cfg.blocks >= N > cfg.warps * (cfg.blocks - 1)


def test_k1_shared_memory_matches_the_kernel_layout():
    # registers variant: class rows [32, R+2PW+PT+2VW] + drivers [DR, VW]
    # words, 64 flag bytes, the [32, warps] byte tile
    assert K.k1_smem_bytes("registers", 16, 4, 1, 1, 1, 2) == \
        4 * (32 * 9 + 2) + 64 + 32 * 16
    # shared variant adds each warp's node words and per-lane volume words
    per_warp = 2 * 9 + 4 * 4 + 2 * 4 + 6 * 4 + 4 + 32 * 4
    assert K.k1_smem_bytes("shared", 16, 9, 4, 4, 4, 4) == \
        K.k1_smem_bytes("registers", 16, 9, 4, 4, 4, 4) + 4 * 16 * per_warp


def test_k1_wide_widths_take_fewer_warps_then_raise():
    cfg = K.k1_launch_config(8, 1000, 40, 200, 200, 200, 40)
    assert cfg.variant == "shared" and cfg.warps == 1
    assert cfg.smem_bytes <= K.SMEM_MAX
    mid = K.k1_launch_config(8, 1000, 8, 150, 150, 150, 8)
    assert 1 < mid.warps < K.K1_MAX_WARPS and mid.smem_bytes <= K.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        K.k1_launch_config(8, 1000, 8, 400, 400, 400, 8)


# --------------------------------------------------------------------------- #
# K2 domain_rank
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("rows,N,D1,counters,segments,seg", [
    (104, 5120, 5121, "shared", 9, 576),    # the flagship's rows
    (7, 5001, 17, "shared", 16, 320),       # a zone row: 16 segments
    (3, 9000, 13000, "shared", 3, 3008),    # > 48 KB of counters
    (3, 1, 5, "shared", 1, 32),             # N = 1
    (6, 1000, 3, "shared", 16, 64),         # N off the segment count
    (6, 5001, 3000, "shared", 15, 352),     # N off the segment size
    (5, 8000, 70000, "scratch", 16, 512),   # counters past 227 KB
])
def test_k2_block_and_segment_shape(rows, N, D1, counters, segments, seg):
    cfg = K.k2_launch_config(rows, N, D1)
    assert (cfg.counters, cfg.segments, cfg.seg) == (counters, segments, seg)
    assert cfg.seg % 32 == 0 and cfg.segments <= K.K2_MAX_SEGMENTS
    # every walking warp has positions, and the segments cover the row
    assert cfg.segments * cfg.seg >= N > (cfg.segments - 1) * cfg.seg \
        or N <= 1
    stride = -(-D1 // 4) * 4    # counter rows 16-byte aligned
    if counters == "shared":
        # an int32 counter and a tag byte per (segment, domain)
        assert cfg.smem_bytes == 5 * cfg.segments * stride <= K.SMEM_MAX
        assert cfg.blocks == rows and cfg.scratch_elems == 0
    else:
        assert cfg.smem_bytes == 0
        assert cfg.scratch_elems == cfg.blocks * cfg.segments * stride


def test_k2_counters_leave_shared_memory_exactly_past_it():
    last = K.SMEM_MAX // 5 // 4 * 4   # one segment's counters and tags
    assert K.k2_launch_config(2, 5120, last).counters == "shared"
    assert K.k2_launch_config(2, 5120, last).segments == 1
    assert K.k2_launch_config(2, 5120, last + 1).counters == "scratch"


def test_k2_scratch_is_bounded_by_striding_blocks():
    cfg = K.k2_launch_config(200, 1000, 70000)
    assert cfg.counters == "scratch" and cfg.blocks < 200
    assert 4 * cfg.scratch_elems <= K.K2_SCRATCH_BYTES


def test_k2_takes_any_domain_count_that_fits_an_int32_row():
    # no cap from shared memory: only D+1 outside the int32 range raises
    for d1 in (46_489, 58_113, 70_000, 10**6, K.INT32_MAX):
        cfg = K.k2_launch_config(104, 5120, d1)
        assert cfg.counters == "scratch" and cfg.segments >= 1
        assert cfg.blocks >= 1
    huge = K.k2_launch_config(104, 5120, K.INT32_MAX)
    assert (huge.segments, huge.blocks) == (1, 1)
    for bad in (0, K.INT32_MAX + 1):
        with pytest.raises(ValueError, match="num_domains"):
            K.k2_launch_config(1, 8, bad)


def test_k2_plain_version_past_shared_memory():
    gen = torch.Generator().manual_seed(0)
    dom = torch.randint(0, 70_000, (2, 300), generator=gen,
                        dtype=torch.int64).to(torch.int32)
    dom[1, :] = 69_999
    rank = K.domain_rank(dom, 70_000)
    assert rank[1].tolist() == list(range(300))
    for i in range(300):
        assert int(rank[0, i]) == int((dom[0, :i] == dom[0, i]).sum())


# --------------------------------------------------------------------------- #
# K3 reprieve_scan: its order, its arguments and what the wrapper refuses
# --------------------------------------------------------------------------- #

def _k3_args(B=2, N=3, E=5, R=4):
    """K3's arguments in K3_ARGS order: every pod a potential victim on
    node 0, no request, no clash, every node a possible candidate."""
    i32, b8 = torch.int32, torch.bool
    seg_ptr = torch.tensor([0] + [E] * N, dtype=i32)
    return [seg_ptr, torch.arange(E, dtype=i32),
            torch.zeros((E, R), dtype=i32), torch.zeros((E,), dtype=i32),
            torch.zeros((E,), dtype=b8), torch.arange(E, dtype=i32),
            torch.zeros((B, R), dtype=i32), torch.ones((B, E), dtype=b8),
            torch.zeros((B, E), dtype=b8), torch.zeros((B, E), dtype=b8),
            torch.zeros((N, R), dtype=i32), torch.zeros((N, R), dtype=i32),
            torch.ones((N,), dtype=b8), torch.ones((B, N), dtype=b8)]


def test_k3_check_takes_the_wrappers_shapes():
    assert K.k3_check(_k3_args()) == (2, 3, 5, 4)
    assert K.k3_check(_k3_args(B=8, N=5000, E=7, R=8)) == (8, 5000, 7, 8)
    assert K.k3_check(_k3_args(B=33, N=1, E=2000, R=7)) == (33, 1, 2000, 7)
    assert K.k3_check(_k3_args(B=1, N=4, E=0, R=4)) == (1, 4, 0, 4)


def test_k3_refuses_r_past_its_registers():
    """R past the registers variant takes the wide one (every width Dims
    buckets to); K3 refuses only R below the fixed slots and an R whose one
    warp would not fit in shared memory."""
    for R in (9, 16, 20, 64):
        assert K.k3_check(_k3_args(R=R)) == (2, 3, 5, R)
        assert K.k3_launch_config(5000, R).variant == "wide"
    with pytest.raises(ValueError, match="resource slots"):
        K.k3_check(_k3_args(R=3))
    with pytest.raises(ValueError, match="shared memory"):
        K.k3_check(_k3_args(R=400))


@pytest.mark.parametrize("N,R,variant,warps,blocks", [
    (5000, 4, "registers", 4, 1250),    # the storm's first burst
    (5000, 8, "registers", 4, 1250),
    (5000, 9, "wide", 4, 1250),
    (5000, 16, "wide", 4, 1250),        # five scalar resources
    (3, 20, "wide", 3, 1),              # fewer nodes than warps
    (5000, 64, "wide", 4, 1250),
    (5000, 100, "wide", 2, 2500),       # fewer warps fit a block
])
def test_k3_launch_config_variant_and_grid(N, R, variant, warps, blocks):
    cfg = K.k3_launch_config(N, R)
    assert (cfg.variant, cfg.warps, cfg.blocks) == (variant, warps, blocks)
    assert cfg.smem_bytes == (0 if variant == "registers"
                              else warps * K.k3_wide_smem_bytes(R))
    assert cfg.smem_bytes <= K.SMEM_MAX


def test_k3_wide_shared_memory_matches_the_kernel_layout():
    """csrc/reprieve_scan.cu wide_words: the window (pod ids, priorities,
    creations: 3 x 128 words; 4 PDB words; [R, 128] requests) and the
    carries ([R, 32] request vectors and used words, [R] capacity)."""
    assert K.k3_wide_smem_bytes(16) == 4 * (3 * 128 + 4 + 16 * 128
                                            + 2 * 16 * 32 + 16)
    src = (K.CSRC / "reprieve_scan.cu").read_text()
    assert "return 3 * kStage + kChunks + R * kStage + 2 * R * 32 + R;" in src
    widest = max(R for R in range(9, 1000)
                 if K.k3_wide_smem_bytes(R) <= K.SMEM_MAX)
    K.k3_launch_config(1, widest)
    with pytest.raises(ValueError, match=str(K.k3_wide_smem_bytes(
            widest + 1))):
        K.k3_launch_config(1, widest + 1)


def test_k3_refuses_non_contiguous_inputs():
    args = _k3_args()
    args[7] = torch.ones((5, 2), dtype=torch.bool).T      # vict_pot view
    with pytest.raises(ValueError, match="contiguous"):
        K.k3_check(args)


@pytest.mark.parametrize("i,bad", [
    (0, torch.zeros((2, 3), dtype=torch.int32)),          # seg_ptr [B, N], not [N + 1]
    (5, torch.zeros((5,), dtype=torch.int64)),            # creation_e int64
    (9, torch.ones((2, 5), dtype=torch.int32)),           # reblock not bool
    (2, torch.zeros((5, 4), dtype=torch.int64)),          # req_e int64
])
def test_k3_refuses_wrong_dtypes_and_shapes(i, bad):
    args = _k3_args()
    args[i] = bad
    with pytest.raises(ValueError):
        K.k3_check(args)


@pytest.mark.parametrize("i,bad", [
    (1, torch.zeros((4,), dtype=torch.int32)),            # seg_e [E - 1]
    (4, torch.zeros((5,), dtype=torch.uint8)),            # pdb_e uint8
    (11, torch.zeros((4, 4), dtype=torch.int32)),         # alloc [N + 1, R]
    (12, torch.ones((3, 1), dtype=torch.bool)),           # valid [N, 1]
    (13, torch.ones((3, 2), dtype=torch.bool)),           # cand_rest [N, B]
    (6, torch.zeros((2, 5), dtype=torch.int32)),          # req_p [B, R + 1]
])
def test_k3_refuses_the_new_contracts_wrong_planes(i, bad):
    args = _k3_args()
    args[i] = bad
    with pytest.raises(ValueError):
        K.k3_check(args)


def test_k3_refuses_mixed_devices():
    args = _k3_args()
    args[3] = torch.empty((5,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        K.reprieve_scan(*args)
    with pytest.raises(ValueError, match="meta"):
        K.k3_check(args)


def test_k3_plain_version_on_cpu_tensors():
    """On CPU tensors the wrapper is the plain version: here every pod is a
    potential victim on node 0, all requests and capacities zero, so every
    node is a candidate and every pod is kept; the launch count does not
    move."""
    before = K.reprieve_scan.launches
    out = K.reprieve_scan(*_k3_args())
    assert out._fields == ("victim", "cand", "num_v", "sum_p", "max_p",
                           "num_pdb", "est")
    assert out.victim.shape == (2, 5) and not out.victim.any()
    assert out.cand.all()
    assert not out.num_v.any() and not out.sum_p.any()
    assert (out.max_p == -K.INT32_MAX).all() and (out.est == K.INT32_MAX).all()
    assert all(t.dtype == torch.int32 and t.shape == (2, 3) for t in out[2:])
    assert K.reprieve_scan.launches == before


def test_k3_plain_version_with_no_pods():
    """E = 0: no walk, but pass 1 still decides every (lane, node)."""
    args = _k3_args(E=0)
    args[12] = torch.tensor([True, False, True])
    out = K.reprieve_scan(*args)
    assert out.victim.shape == (2, 0)
    assert out.cand.tolist() == [[True, False, True]] * 2


@pytest.mark.parametrize("node,ptr", [
    ([0, 0, 0, 0], [0, 4, 4, 4]),            # one segment, two empty
    ([3, 3, 3, 3], [0, 0, 0, 0]),            # every pod on no node
    ([2, 1, 0, 3], [0, 1, 2, 3]),            # one each, one off-node
])
def test_k3_csr_segments(node, ptr):
    from kubernetes_tpu_torch.ops.preempt import reprieve_order

    prio = [5, -2**31, 5, 0]
    pdb = [False, False, True, False]
    node_t = torch.tensor(node, dtype=torch.int32)
    prio_t = torch.tensor(prio, dtype=torch.int32)
    seg_ptr, seg_e = reprieve_order(node_t, prio_t, torch.tensor(pdb), 3)
    assert seg_ptr.tolist() == ptr
    e = seg_e.tolist()
    # every pod once; grouped by node; each group PDB-blocked first, then
    # by jnp's wrapped -priority (INT32_MIN first), then by index
    assert sorted(e) == [0, 1, 2, 3]
    assert [node[x] for x in e] == sorted(node[x] for x in e)
    neg = lambda p: p if p == -2**31 else -p
    for n in range(4):
        grp = [x for x in e if node[x] == n]
        assert grp == sorted(grp, key=lambda x: (not pdb[x], neg(prio[x]), x))


def test_k3_is_built_with_the_other_kernels():
    assert "reprieve_scan" in K.KERNELS
    assert K.library_path("reprieve_scan").name.startswith("libreprieve_scan-")
    assert K.launch_counts()["reprieve_scan"] == K.reprieve_scan.launches


def test_k3_ablation_edits_match_the_kernel_source():
    """scripts/k3_ablation.py times copies of csrc/reprieve_scan.cu with one
    part taken out by a text edit: every edit must still find its text
    exactly once, or the script would time the wrong kernel."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "k3_ablation.py"
    spec = importlib.util.spec_from_file_location("k3_ablation", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = (K.CSRC / "reprieve_scan.cu").read_text()
    assert set(mod.EDITS) == {"no-walk", "no-flags", "no-gathers", "no-sums",
                              "outputs"}
    for name, edits in mod.EDITS.items():
        for old, new in edits:
            assert src.count(old) == 1, name
            assert new != old


# --------------------------------------------------------------------------- #
# the loader: first use from several threads at once
# --------------------------------------------------------------------------- #

def test_concurrent_first_use_builds_and_loads_once(tmp_path, monkeypatch):
    """The dispatch worker and the prewarm thread may both make a kernel's
    first call: with a stub compiler (a script that counts its runs and
    writes its output slowly) and a stub loader, eight threads asking for
    one library at once run the compiler once, load it once, and all get
    the same library, never a half-written one."""
    import ctypes
    import stat
    import threading

    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "out=''\n"
        "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
        f"echo \"$out\" >> {log}\n"
        "sleep 0.3\n"
        "echo built > \"$out\"\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(K, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(K, "_LIBS", {})
    loads = []

    class FakeLib:
        def __init__(self, path):
            assert open(path).read() == "built\n"  # never half-written
            loads.append(path)
            self.contention_scan_launch = lambda *a: 0
            self.kernel_error_string = lambda e: b""

    monkeypatch.setattr(ctypes, "CDLL", FakeLib)
    barrier = threading.Barrier(8)
    got = []

    def first_use():
        barrier.wait()
        got.append(K._library("contention_scan"))

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 8 and all(g is got[0] for g in got)
    assert len(loads) == 1
    runs = log.read_text().split()
    assert len(runs) == 1 and runs[0].endswith(".tmp")
    assert not list((tmp_path / "build").glob("*.tmp"))
    assert K.library_path("contention_scan").exists()


def test_build_names_its_temporary_by_process_and_thread(tmp_path,
                                                         monkeypatch):
    import os
    import stat
    import threading

    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "out=''\n"
        "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
        f"echo \"$out\" >> {log}\n"
        "echo built > \"$out\"\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(K, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "build")
    done = []
    t = threading.Thread(target=lambda: done.append(
        (threading.get_ident(), K.build(("domain_rank",)))))
    t.start()
    t.join()
    ident = done[0][0]
    assert log.read_text().strip().endswith(f".{os.getpid()}.{ident}.tmp")
    assert K.library_path("domain_rank").read_text() == "built\n"
