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
