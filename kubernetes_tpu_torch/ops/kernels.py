"""The hand-written CUDA kernels of the wave engine, their plain PyTorch
versions, and the build that turns `csrc/*.cu` into shared libraries.

Kernels (sources under kubernetes_tpu_torch/csrc/, notes on what each
replaces and what bounds it at the top of each source):

  * K1 `contention_scan` — the per-node contention pass of assign_waves
    (JAX package ops/waves.py:438-503);
  * K2 `domain_rank` — the rank-in-domain of the domain-quota pass
    (JAX package ops/waves.py:165-174).

Each wrapper takes its plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device — never falling back from one to the
other — and counts its launches in `<wrapper>.launches`. The launch shape
(K1's variant and grid, K2's segments and counter storage) is chosen
in plain Python, `k1_launch_config` / `k2_launch_config`.

Build: `nvcc -gencode arch=compute_90a,code=sm_90a` into one shared library
per source with a plain C interface, loaded with ctypes, at first use. The
libraries go to `build/kernels/` in the checkout, named by a hash of source
and flags so an edited source never loads a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from .fit import _fit
from .volumes import popcount32

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
KERNELS = ("contention_scan", "domain_rank")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "contention_scan_launch": [_P] * 21 + [_I] * 11 + [_P],
    "domain_rank_launch": [_P] * 3 + [_I] * 7 + [_P],
}
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME or nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel library that is not built yet, one nvcc
    per source, all started together. Returns each library's compiler log
    (ptxas register/shared-memory report). Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    logs = {}
    for name in names:
        log = library_path(name).with_suffix(".log")
        logs[name] = log.read_text() if log.exists() else ""
    return logs


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = _ARGTYPES[f"{name}_launch"]
        fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def _check(tensors: Sequence[torch.Tensor], device: torch.device) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def _launch(name: str, *args) -> None:
    lib = _library(name)
    err = getattr(lib, f"{name}_launch")(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.kernel_error_string(err).decode()}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _device_of(t: torch.Tensor) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device


# --------------------------------------------------------------------------- #
# K1 contention_scan
# --------------------------------------------------------------------------- #

Words = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]


def contention_scan_plain(A, req, has_p, pw, ww, tw, has_v, va, vr,
                          alloc, used, vol_any, vol_rw, drv_masks, vol_limit
                          ) -> Tuple[torch.Tensor, Words]:
    """The plain version of K1: a Python loop over classes in rank order
    (torch has no cumulative OR), each step a handful of [N]-row ops.

    A [SC, N] bool admissions in rank order; req [SC, R]; has_p/has_v [SC]
    bool; pw/ww [SC, PW], tw [SC, PT], va/vr [SC, VW] words; alloc/used
    [N, R]; vol_any/vol_rw [N, VW]; drv_masks [DR, VW]; vol_limit [N, DR].
    Returns keep [SC, N] and the words the kept classes commit
    (pair-any [N, PW], pair-wild [N, PW], triple [N, PT], vol-any [N, VW],
    vol-rw [N, VW])."""
    SC, N = A.shape
    base_free = alloc - used
    cum = torch.zeros_like(used)
    c_pa, c_pw = (torch.zeros((N, pw.shape[1]), dtype=torch.int32,
                              device=A.device) for _ in range(2))
    c_pt = torch.zeros((N, tw.shape[1]), dtype=torch.int32, device=A.device)
    c_va, c_vr = (torch.zeros_like(vol_any) for _ in range(2))
    out = [torch.zeros_like(c_pa), torch.zeros_like(c_pw),
           torch.zeros_like(c_pt), torch.zeros_like(c_va),
           torch.zeros_like(c_vr)]
    keep = torch.empty_like(A)
    for c in range(SC):
        a = A[c]
        # resources: earlier admissions claim their requests before the test
        k1 = a & _fit(req[c][None, :], base_free - cum)
        cum = cum + torch.where(a[:, None], req[c][None, :], 0)
        # host ports: earlier classes kept after resources
        conflict = (((ww[c] & c_pa) != 0).any(-1) | ((pw[c] & c_pw) != 0).any(-1)
                    | ((tw[c] & c_pt) != 0).any(-1))
        k2 = k1 & (~has_p[c] | ~conflict)
        kp = (k1 & has_p[c])[:, None]
        c_pa = c_pa | torch.where(kp, pw[c], 0)
        c_pw = c_pw | torch.where(kp, ww[c], 0)
        c_pt = c_pt | torch.where(kp, tw[c], 0)
        # volumes: the node's plus earlier classes kept after ports
        tot_any, tot_rw = vol_any | c_va, vol_rw | c_vr
        vconf = ((va[c] & tot_rw) != 0).any(-1) | ((vr[c] & tot_any) != 0).any(-1)
        vcnt = popcount32((tot_any | va[c])[:, None, :] & drv_masks[None]).sum(-1)
        vlim_ok = ((vol_limit < 0) | (vcnt <= vol_limit)).all(-1)
        k3 = k2 & (~has_v[c] | (~vconf & vlim_ok))
        kv = (k2 & has_v[c])[:, None]
        c_va = c_va | torch.where(kv, va[c], 0)
        c_vr = c_vr | torch.where(kv, vr[c], 0)
        keep[c] = k3
        kp3, kv3 = (k3 & has_p[c])[:, None], (k3 & has_v[c])[:, None]
        for i, (k, w) in enumerate(((kp3, pw[c]), (kp3, ww[c]), (kp3, tw[c]),
                                    (kv3, va[c]), (kv3, vr[c]))):
            out[i] = out[i] | torch.where(k, w, 0)
    return keep, tuple(out)


class K1Launch(NamedTuple):
    variant: str      # "registers" or "shared"
    warps: int        # warps (= nodes) per block
    blocks: int
    smem_bytes: int


K1_MAX_R = 8        # registers variant: resource slots ...
K1_MAX_W = 4        # ... and words of each of PW, PT, VW and DR
K1_MAX_WARPS = 8    # warps (= nodes) per block
SMEM_MAX = 227 * 1024   # shared memory a block can use on an H100


def k1_smem_bytes(variant: str, warps: int, R: int, PW: int, PT: int,
                  VW: int, DR: int) -> int:
    """K1's dynamic shared memory, as csrc/contention_scan.cu lays it out:
    the chunk's class rows and the driver masks, (shared variant) each
    warp's node words and per-lane volume words, the flags and the A/keep
    byte tile."""
    words = 32 * (R + 2 * PW + PT + 2 * VW) + DR * VW
    if variant == "shared":
        words += warps * (2 * R + 4 * PW + 2 * PT + 6 * VW + DR + 32 * VW)
    return 4 * words + 64 + 32 * warps


def k1_launch_config(SC: int, N: int, R: int, PW: int, PT: int, VW: int,
                     DR: int) -> K1Launch:
    """K1's variant and grid: the registers variant where every width is
    within its compile-time bound, else the shared-memory one; one warp per
    node, up to K1_MAX_WARPS nodes per block (fewer if the shared variant's
    words would not fit)."""
    small = R <= K1_MAX_R and max(PW, PT, VW, DR) <= K1_MAX_W
    variant = "registers" if small else "shared"
    warps = max(1, min(K1_MAX_WARPS, N))
    while warps > 1 and k1_smem_bytes(variant, warps, R, PW, PT, VW,
                                      DR) > SMEM_MAX:
        warps -= 1
    smem = k1_smem_bytes(variant, warps, R, PW, PT, VW, DR)
    if smem > SMEM_MAX:
        raise ValueError(f"K1 widths R={R} PW={PW} PT={PT} VW={VW} DR={DR} "
                         f"need {smem} bytes of shared memory for one node")
    return K1Launch(variant, warps, -(-N // warps), smem)


def contention_scan(A, req, has_p, pw, ww, tw, has_v, va, vr,
                    alloc, used, vol_any, vol_rw, drv_masks, vol_limit
                    ) -> Tuple[torch.Tensor, Words]:
    """K1 (see contention_scan_plain for the arguments): the plain version
    on the CPU, the CUDA kernel on a CUDA device."""
    args = (A, req, has_p, pw, ww, tw, has_v, va, vr, alloc, used, vol_any,
            vol_rw, drv_masks, vol_limit)
    device = _device_of(A)
    if device.type == "cpu":
        return contention_scan_plain(*args)
    _check(args, device)
    SC, N = A.shape
    R, PW, PT, VW, DR = (req.shape[1], pw.shape[1], tw.shape[1],
                         va.shape[1], drv_masks.shape[0])
    if A.dtype != torch.bool or has_p.dtype != torch.bool \
            or has_v.dtype != torch.bool:
        raise ValueError("A/has_p/has_v must be bool")
    if any(t.dtype != torch.int32 for t in args if t.dtype != torch.bool):
        raise ValueError("requests, words and limits must be int32")
    if R < 4:
        raise ValueError("resource vectors carry at least the 4 fixed slots")
    cfg = k1_launch_config(SC, N, R, PW, PT, VW, DR)
    keep = torch.empty((SC, N), dtype=torch.bool, device=device)
    # the five word planes as contiguous views of one allocation
    widths = (PW, PW, PT, VW, VW)
    flat = torch.empty((N * sum(widths),), dtype=torch.int32, device=device)
    out = tuple(v.view(N, w) for v, w in
                zip(flat.split([N * w for w in widths]), widths))
    _launch("contention_scan", *(t.data_ptr() for t in args),
            keep.data_ptr(), *(t.data_ptr() for t in out),
            SC, N, R, PW, PT, VW, DR, int(cfg.variant == "shared"),
            cfg.warps, cfg.blocks, cfg.smem_bytes, _stream(device))
    contention_scan.launches += 1
    return keep, out


contention_scan.launches = 0


# --------------------------------------------------------------------------- #
# K2 domain_rank
# --------------------------------------------------------------------------- #

def domain_rank_plain(dom: torch.Tensor, num_domains: int) -> torch.Tensor:
    """The plain version of K2, as the JAX package computes it: stable
    argsort by domain, scatter-min of the group starts, rank = grouped index
    minus its group's start, scattered back. dom [rows, N] int32 in
    [0, num_domains) → rank [rows, N] int32."""
    rows, N = dom.shape
    grp = torch.argsort(dom, dim=1, stable=True)
    dom_g = torch.gather(dom, 1, grp).long()
    gidx = torch.arange(N, dtype=torch.int32, device=dom.device).expand(rows, N)
    start = torch.full((rows, num_domains), N, dtype=torch.int32,
                       device=dom.device)
    start = start.scatter_reduce(1, dom_g, gidx, reduce="amin",
                                 include_self=True)
    rank_g = gidx - torch.gather(start, 1, dom_g)
    return torch.zeros_like(dom).scatter(1, grp, rank_g)


class K2Launch(NamedTuple):
    counters: str     # "shared" or "scratch"
    segments: int     # warps that walk a row: one segment each
    seg: int          # positions per segment, a multiple of 32
    blocks: int       # blocks (of 16 warps) striding over the rows
    smem_bytes: int
    scratch_elems: int


K2_MAX_SEGMENTS = 16           # warps of a K2 block
K2_SCRATCH_BYTES = 256 << 20   # scratch counters beyond shared memory
INT32_MAX = 2**31 - 1


def k2_launch_config(rows: int, N: int, num_domains: int) -> K2Launch:
    """K2's block and segment shape: as many segments per row as their
    counters and tags (an int32 and a byte per (segment, domain), D+1
    rounded up to 4) let shared memory hold, up to 16 and one per 32
    positions; past shared memory the counters go to a scratch of at most
    K2_SCRATCH_BYTES (one row's counters at the least) and the blocks
    stride over the rows."""
    if not 1 <= num_domains <= INT32_MAX:
        raise ValueError(f"num_domains {num_domains} outside [1, 2^31 - 1]")
    stride = -(-num_domains // 4) * 4
    shared = 5 * stride <= SMEM_MAX    # int32 counter + tag byte per domain
    per_seg = (5 if shared else 4) * stride
    budget = SMEM_MAX if shared else K2_SCRATCH_BYTES
    cap = max(1, min(K2_MAX_SEGMENTS, -(-N // 32)))
    segs = max(1, min(cap, budget // per_seg))
    seg = 32 * max(1, -(-N // (32 * segs)))
    segs = max(1, -(-N // seg))
    if shared:
        return K2Launch("shared", segs, seg, max(rows, 1), per_seg * segs, 0)
    blocks = max(1, min(rows, K2_SCRATCH_BYTES // (per_seg * segs)))
    return K2Launch("scratch", segs, seg, blocks, 0, blocks * segs * stride)


def domain_rank(dom: torch.Tensor, num_domains: int) -> torch.Tensor:
    """K2: rank[r, i] = #{j < i : dom[r, j] == dom[r, i]}. The plain version
    on the CPU, the CUDA kernel on a CUDA device."""
    device = _device_of(dom)
    if device.type == "cpu":
        return domain_rank_plain(dom, num_domains)
    _check((dom,), device)
    if dom.dtype != torch.int32 or dom.dim() != 2:
        raise ValueError("dom must be a 2-D int32 tensor")
    rows, N = dom.shape
    cfg = k2_launch_config(rows, N, num_domains)
    rank = torch.empty_like(dom)
    scratch = (torch.empty((cfg.scratch_elems,), dtype=torch.int32,
                           device=device) if cfg.counters == "scratch" else None)
    _launch("domain_rank", dom.data_ptr(), rank.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, rows, N,
            num_domains, cfg.segments, cfg.seg, cfg.blocks, cfg.smem_bytes,
            _stream(device))
    domain_rank.launches += 1
    return rank


domain_rank.launches = 0


def reset_launch_counts() -> None:
    contention_scan.launches = 0
    domain_rank.launches = 0


def launch_counts() -> Dict[str, int]:
    return {"contention_scan": contention_scan.launches,
            "domain_rank": domain_rank.launches}
