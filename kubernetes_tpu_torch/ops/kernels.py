"""The hand-written CUDA kernels of the wave engine, their plain PyTorch
versions, and the build that turns `csrc/*.cu` into shared libraries.

Kernels (sources under kubernetes_tpu_torch/csrc/, notes on what each
replaces and what bounds it at the top of each source):

  * K1 `contention_scan` — the per-node contention pass of assign_waves
    (JAX package ops/waves.py:438-503);
  * K2 `domain_rank` — the rank-in-domain of the domain-quota pass
    (JAX package ops/waves.py:165-174);
  * K3 `reprieve_scan` — the per-node half of the preemption what-if, per
    (lane, node): pass 1, the fit half of the candidate test, the reprieve
    walk and the node-choice summaries (JAX package ops/preempt.py:128-156,
    183-217);
  * K4 `assign_scan` — the sequential-assume scan, every pod of a
    queue-ordered list in one launch on one thread-block cluster, each CTA
    owning a slice of the nodes (JAX package ops/assign.py:64,124); its
    plain version is ops/assign.py assign_scan_plain.

Each wrapper takes its plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device — never falling back from one to the
other — and counts its launches in `<wrapper>.launches`. The launch shape
(K1's variant and grid, K2's segments and counter storage, K4's cluster
and shared-memory placement) is chosen in plain Python,
`k1_launch_config` / `k2_launch_config` / `k3_launch_config` /
`k4_launch_config`.

Build: `nvcc -gencode arch=compute_90a,code=sm_90a` into one shared library
per source with a plain C interface, loaded with ctypes, at first use (K4
adds its own flags, KERNEL_FLAGS). The libraries go to `build/kernels/` in
the checkout, named by a hash of source and flags so an edited source never
loads a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from .fit import _fit
from .lattice import _on
from .scores import ZONE_WEIGHTING
from .volumes import popcount32

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
KERNELS = ("contention_scan", "domain_rank", "reprieve_scan", "assign_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags a source adds to NVCC_FLAGS: K4 repeats the plain version's f32
# operations one rounding each, so no a*b + c may contract into an FMA
KERNEL_FLAGS = {"assign_scan": ("-fmad=false",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "contention_scan_launch": [_P] * 21 + [_I] * 11 + [_P],
    "domain_rank_launch": [_P] * 3 + [_I] * 7 + [_P],
    "reprieve_scan_launch": [_P] * 17 + [_I] * 6 + [_P],
    "assign_scan_launch": [_P, _I, _P],
}
_LIBS: Dict[str, ctypes.CDLL] = {}
# one lock around every build and load: the dispatch supervisor's worker and
# the prewarmer's background warm launch kernels from their own threads, and
# two first uses must neither both run nvcc into one file nor load a
# half-written library
_BUILD_LOCK = threading.RLock()


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


def nvcc_flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + KERNEL_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(nvcc_flags(name)).encode()
                            ).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel library that is not built yet, one nvcc
    per source, all started together. Returns each library's compiler log
    (ptxas register/shared-memory report). Raises on a failed build.
    Thread-safe: one build at a time in a process; each nvcc writes a
    temporary named by process and thread, moved into place atomically."""
    with _BUILD_LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(
                f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [_nvcc(), *nvcc_flags(name), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
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
    if lib is not None:
        return lib
    with _BUILD_LOCK:
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


_COUNT_LOCK = threading.Lock()


def _count(wrapper) -> None:
    """One more launch of `wrapper`'s kernel (kernels launch from the
    serving thread, the dispatch worker and the prewarm thread)."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def _check(tensors: Sequence[torch.Tensor], device: torch.device) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


class KernelLaunchError(RuntimeError):
    """A kernel's launch returned a CUDA error: the context is unusable from
    here on (the dispatch supervisor marks the backend lost)."""


def _launch(name: str, *args) -> None:
    lib = _library(name)
    err = getattr(lib, f"{name}_launch")(*args)
    if err != 0:
        raise KernelLaunchError(f"{name} launch failed: "
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
    _count(contention_scan)
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
    _count(domain_rank)
    return rank


domain_rank.launches = 0


# --------------------------------------------------------------------------- #
# K3 reprieve_scan
# --------------------------------------------------------------------------- #

K3_MAX_R = 8    # widest R K3 carries in registers
K3_WARPS = 4    # warps (= nodes) per block
K3_STAGE = 128  # segment positions a warp stages


class K3Launch(NamedTuple):
    variant: str      # "registers" (R = 4..8) or "wide" (R > 8)
    warps: int        # warps (= nodes) per block
    blocks: int
    smem_bytes: int   # dynamic shared memory (0: the static stage)


def k3_wide_smem_bytes(R: int) -> int:
    """Dynamic shared memory one warp of K3's wide variant uses, as
    csrc/reprieve_scan.cu wide_words lays it out: the staged window (pod
    ids, priorities, creations, one PDB word per 32 positions, [R, stage]
    requests) and the lanes' carries ([R, 32] request vectors and used
    words, the node's [R] capacity)."""
    return 4 * (3 * K3_STAGE + K3_STAGE // 32 + R * K3_STAGE + 2 * R * 32 + R)


def k3_launch_config(N: int, R: int) -> K3Launch:
    """K3's variant and grid: one warp per node; R = 4..8 the registers
    variant (K3_WARPS nodes per block, a kernel per R), wider R the wide
    variant with its carries in shared memory, as many warps per block as
    fit. Raises ValueError below the four fixed slots, or when one warp's
    shared memory would exceed the card's."""
    if R < 4:
        raise ValueError(f"K3 needs the 4 fixed resource slots, got R={R}")
    if R <= K3_MAX_R:
        return K3Launch("registers", K3_WARPS, -(-N // K3_WARPS), 0)
    per_warp = k3_wide_smem_bytes(R)
    if per_warp > SMEM_MAX:
        raise ValueError(f"K3 at R={R} needs {per_warp} bytes of shared "
                         f"memory for one warp, over the {SMEM_MAX} a block "
                         f"can use")
    warps = max(1, min(K3_WARPS, N, SMEM_MAX // per_warp))
    return K3Launch("wide", warps, -(-N // warps), warps * per_warp)


class K3Out(NamedTuple):
    victim: torch.Tensor    # [B, E] bool — evicted by the walk
    cand: torch.Tensor      # [B, N] bool — preemption would work on n
    num_v: torch.Tensor     # [B, N] int32 — the node's victims ...
    sum_p: torch.Tensor     # ... their priority sum (wrapping)
    max_p: torch.Tensor     # ... their highest priority, -INT32_MAX if none
    num_pdb: torch.Tensor   # ... how many are PDB-blocked
    est: torch.Tensor       # ... least creation at max_p, INT32_MAX if none


def _scatter(values: torch.Tensor, idx: torch.Tensor, n: int, fill: int,
             reduce: str) -> torch.Tensor:
    """Scatter [B, E] values into n + 1 slots per lane by idx (slot n the
    discard bucket), starting from `fill`, and drop the last slot."""
    out = torch.full((values.shape[0], n + 1), fill, dtype=values.dtype,
                     device=values.device)
    if reduce == "sum":
        out = out.scatter_add_(1, idx, values)
    else:
        out = out.scatter_reduce_(1, idx, values, reduce=reduce,
                                  include_self=True)
    return out[:, :n]


def reprieve_scan_plain(seg_ptr, seg_e, req_e, prio_e, pdb_e, creation_e,
                        req_p, vict_pot, c_e, reblock, used, alloc, valid,
                        cand_rest) -> K3Out:
    """The plain version of K3: pass 1 and the summaries as scatters over
    the pods' nodes, the walk as a loop over the position k within a
    segment, up to the longest segment, with every (lane, node) walk
    advancing one pod per step.

    The reprieve order, the same in every lane (ops/preempt.py
    reprieve_order): seg_e [E] int32 holds node n's pods at
    seg_ptr[n] : seg_ptr[n + 1] (seg_ptr [N + 1] int32), pods on no node
    past seg_ptr[N]. The pods: req_e [E, R] int32 requests, prio_e and
    creation_e [E] int32, pdb_e [E] bool. The lanes: req_p [B, R] int32,
    vict_pot, c_e (port clash with the lane's preemptor) and reblock [B, E]
    bool. The nodes: used and alloc [N, R] int32, valid [N] bool, and
    cand_rest [B, N] bool, every candidate test but the fit and the port
    clash. Returns K3Out (see csrc/reprieve_scan.cu)."""
    B, E = vict_pot.shape
    N, R = used.shape
    dev = used.device
    i32 = torch.int32
    ptr = seg_ptr.long()
    start, length = ptr[:N], ptr[1:] - ptr[:N]
    node_of = torch.full((E,), N, dtype=torch.long, device=dev)
    on = int(ptr[N]) if N else 0
    node_of[seg_e[:on].long()] = torch.repeat_interleave(
        torch.arange(N, device=dev), length)
    slot = node_of.expand(B, E)

    # pass 1: every potential victim removed
    removed = torch.zeros((B, N + 1, R), dtype=i32, device=dev).scatter_add_(
        1, slot[..., None].expand(B, E, R),
        torch.where(vict_pot[..., None], req_e[None], 0))[:, :N]
    used_wo = used[None] - removed                               # [B, N, R]
    live_clash = (c_e & ~vict_pot & (node_of < N)[None]).to(i32)
    conflict = _scatter(live_clash, slot, N, 0, "amax") > 0      # [B, N]
    cand = (cand_rest & valid[None] & ~conflict
            & _fit(req_p[:, None, :], alloc[None] - used_wo))

    # pass 2: the walk
    victim = torch.zeros((B, E), dtype=torch.bool, device=dev)
    used_c = used_wo
    for k in range(int(length.max()) if N else 0):
        active = k < length                                      # [N]
        e = torch.where(active, seg_e[(start + k).clamp(max=E - 1)].long(),
                        0)                                       # [N]
        is_v = active[None] & cand & vict_pot[:, e]
        new_used = used_c + req_e[e][None]
        fit = _fit(req_p[:, None, :], alloc[None] - new_used)
        new_conf = conflict | c_e[:, e]
        keep = is_v & fit & ~new_conf & ~reblock[:, e]
        used_c = torch.where(keep[..., None], new_used, used_c)
        conflict = torch.where(keep, new_conf, conflict)
        victim[:, e[active]] = (is_v & ~keep)[:, active]

    # the node's victims, summarised for pickOneNodeForPreemption
    idx = torch.where(victim, slot, N)
    prio = prio_e[None].expand(B, E)
    num_v = _scatter(victim.to(i32), idx, N, 0, "sum")
    sum_p = _scatter(torch.where(victim, prio, 0), idx, N, 0, "sum")
    max_p = _scatter(torch.where(victim, prio, -INT32_MAX), idx, N,
                     -INT32_MAX, "amax")
    num_pdb = _scatter((victim & pdb_e[None]).to(i32), idx, N, 0, "sum")
    top = torch.gather(max_p, 1, slot.clamp(max=max(N - 1, 0))) \
        if N else torch.zeros((B, E), dtype=i32, device=dev)
    is_top = victim & (prio == top)
    est = _scatter(torch.where(is_top, creation_e[None].expand(B, E),
                               INT32_MAX), idx, N, INT32_MAX, "amin")
    return K3Out(victim, cand, num_v, sum_p, max_p, num_pdb, est)


K3_ARGS = ("seg_ptr", "seg_e", "req_e", "prio_e", "pdb_e", "creation_e",
           "req_p", "vict_pot", "c_e", "reblock", "used", "alloc", "valid",
           "cand_rest")
K3_BOOL = {"pdb_e", "vict_pot", "c_e", "reblock", "valid", "cand_rest"}


def k3_check(args) -> Tuple[int, int, int, int]:
    """What K3 takes, checked before a launch: one device, contiguous
    tensors, int32 CSR/requests/priorities/creations and bool flags,
    consistent shapes, an R k3_launch_config takes. Returns (B, N, E, R);
    raises ValueError."""
    _check(args, args[0].device)
    named = dict(zip(K3_ARGS, args))
    req_e, req_p, used = named["req_e"], named["req_p"], named["used"]
    if req_e.dim() != 2 or req_p.dim() != 2 or used.dim() != 2:
        raise ValueError("req_e must be [E, R], req_p [B, R] and used [N, R]")
    E, R = req_e.shape
    B, N = req_p.shape[0], used.shape[0]
    want = {"seg_ptr": (N + 1,), "seg_e": (E,), "req_e": (E, R),
            "prio_e": (E,), "pdb_e": (E,), "creation_e": (E,),
            "req_p": (B, R), "vict_pot": (B, E), "c_e": (B, E),
            "reblock": (B, E), "used": (N, R), "alloc": (N, R),
            "valid": (N,), "cand_rest": (B, N)}
    for name, t in named.items():
        dtype = torch.bool if name in K3_BOOL else torch.int32
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
    k3_launch_config(N, R)
    return B, N, E, R


def reprieve_scan(seg_ptr, seg_e, req_e, prio_e, pdb_e, creation_e, req_p,
                  vict_pot, c_e, reblock, used, alloc, valid,
                  cand_rest) -> K3Out:
    """K3 (see reprieve_scan_plain for the arguments): the plain version on
    the CPU, the CUDA kernel on a CUDA device; tensors on mixed devices
    raise."""
    args = (seg_ptr, seg_e, req_e, prio_e, pdb_e, creation_e, req_p,
            vict_pot, c_e, reblock, used, alloc, valid, cand_rest)
    device = _device_of(used)
    for name, t in zip(K3_ARGS, args):
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")
    if device.type == "cpu":
        return reprieve_scan_plain(*args)
    B, N, E, R = k3_check(args)
    cfg = k3_launch_config(N, R)
    victim = torch.zeros((B, E), dtype=torch.bool, device=device)
    cand = torch.empty((B, N), dtype=torch.bool, device=device)
    planes = torch.empty((5, B, N), dtype=torch.int32, device=device)
    _launch("reprieve_scan", *(t.data_ptr() for t in args),
            victim.data_ptr(), cand.data_ptr(), planes.data_ptr(), B, N, E,
            R, cfg.warps, cfg.smem_bytes, _stream(device))
    _count(reprieve_scan)
    return K3Out(victim, cand, *planes.unbind(0))


reprieve_scan.launches = 0


# --------------------------------------------------------------------------- #
# K4 assign_scan
# --------------------------------------------------------------------------- #

# K4's launch arguments, in the order of csrc/assign_scan.cu's struct Args:
# pointers, then ints, then floats
K4_POINTERS = (
    "node_valid", "name_id", "alloc", "domain", "vol_limit", "req_vec",
    "pair_words", "wild_words", "trip_words", "any_words", "rw_words",
    "drv_masks", "topo_key", "zone_keys", "rid", "portset", "volset",
    "aff_terms", "anti_terms", "paff_terms", "paff_w", "panti_terms",
    "panti_w", "tsc_term", "tsc_maxskew", "tsc_hard", "ssel_terms", "smask",
    "node_match", "sscore", "TM", "has_anti", "ELD", "WCOLS", "rows", "cls",
    "pvalid", "nnr", "used", "ppa", "ppw", "ppt", "CNT", "HOLD", "WSYM",
    "vol_any", "vol_rw", "node", "status", "scored", "cblock", "qinfo",
    "gdom", "ghist", "gnode")
K4_INTS = ("N", "R", "K", "PWp", "PWt", "VW", "DR", "S", "SC", "AT", "AN",
           "PAT", "PAN", "TS", "SS", "D", "P", "Q", "cluster", "slice",
           "threads", "cbw", "place", "f_interpod", "f_spread", "f_name",
           "f_fit", "f_ports", "f_volrestrict", "f_vollimits")
K4_FLOATS = ("w_least", "w_balanced", "w_most", "w_interpod", "w_even",
             "w_ssel", "zw_node", "zw_zone", "eps")


class K4Args(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in K4_POINTERS]
                + [(f, ctypes.c_int) for f in K4_INTS]
                + [(f, ctypes.c_float) for f in K4_FLOATS])


# each input K4 reads: its shape by dimension name (D1 = D + 1) — bool
# planes in K4_BOOL, f32 in K4_F32, int32 (uint32 words as their int32
# view) the rest
K4_SHAPES = {
    "node_valid": ("N",), "name_id": ("N",), "alloc": ("N", "R"),
    "domain": ("N", "K"), "vol_limit": ("N", "DR"), "req_vec": ("SR", "R"),
    "pair_words": ("SPP", "PWp"), "wild_words": ("SPP", "PWp"),
    "trip_words": ("SPP", "PWt"), "any_words": ("SV", "VW"),
    "rw_words": ("SV", "VW"), "drv_masks": ("DR", "VW"), "topo_key": ("S",),
    "zone_keys": ("ZK",), "rid": ("SC",), "portset": ("SC",),
    "volset": ("SC",), "aff_terms": ("SC", "AT"), "anti_terms": ("SC", "AN"),
    "paff_terms": ("SC", "PAT"), "paff_w": ("SC", "PAT"),
    "panti_terms": ("SC", "PAN"), "panti_w": ("SC", "PAN"),
    "tsc_term": ("SC", "TS"), "tsc_maxskew": ("SC", "TS"),
    "tsc_hard": ("SC", "TS"), "ssel_terms": ("SC", "SS"),
    "smask": ("SC", "N"), "node_match": ("SC", "N"), "sscore": ("SC", "N"),
    "TM": ("S", "SC"), "has_anti": ("SC", "S"), "ELD": ("SC", "TS", "D1"),
    "WCOLS": ("S", "SC"), "rows": ("Q",), "cls": ("P",), "pvalid": ("P",),
    "nnr": ("P",), "used": ("N", "R"), "ppa": ("N", "PWp"),
    "ppw": ("N", "PWp"), "ppt": ("N", "PWt"), "CNT": ("S", "N"),
    "HOLD": ("S", "N"), "WSYM": ("S", "N"), "vol_any": ("N", "VW"),
    "vol_rw": ("N", "VW")}
K4_BOOL = {"node_valid", "tsc_hard", "smask", "node_match", "TM", "has_anti",
           "ELD", "pvalid"}
K4_F32 = {"sscore", "WCOLS", "WSYM"}
K4_STATE = ("used", "ppa", "ppw", "ppt", "CNT", "HOLD", "WSYM", "vol_any",
            "vol_rw")


def k4_inputs(tables, cyc, pods, rows, init) -> Dict[str, torch.Tensor]:
    """Every tensor K4 reads, by its launch-argument name: the tables, the
    cycle, the pods, the row order `rows` and the state `init`."""
    n, cl = tables.nodes, tables.classes
    st = cyc.static
    return dict(
        node_valid=n.valid, name_id=n.name_id, alloc=n.alloc,
        domain=n.domain, vol_limit=n.vol_limit, req_vec=tables.reqs.vec,
        pair_words=tables.portsets.pair_words,
        wild_words=tables.portsets.wild_words,
        trip_words=tables.portsets.trip_words,
        any_words=tables.volsets.any_words, rw_words=tables.volsets.rw_words,
        drv_masks=tables.drv_masks, topo_key=tables.terms.topo_key,
        zone_keys=tables.zone_keys, rid=cl.rid, portset=cl.portset,
        volset=cl.volset, aff_terms=cl.aff_terms, anti_terms=cl.anti_terms,
        paff_terms=cl.paff_terms, paff_w=cl.paff_w,
        panti_terms=cl.panti_terms, panti_w=cl.panti_w,
        tsc_term=cl.tsc_term, tsc_maxskew=cl.tsc_maxskew,
        tsc_hard=cl.tsc_hard, ssel_terms=cl.ssel_terms, smask=st.mask,
        node_match=st.node_match, sscore=st.score, TM=cyc.TM,
        has_anti=cyc.has_anti, ELD=cyc.ELD, WCOLS=cyc.WCOLS, rows=rows,
        cls=pods.cls, pvalid=pods.valid, nnr=pods.node_name_req,
        **dict(zip(K4_STATE, init)))


def k4_check(ins: Dict[str, torch.Tensor], device: torch.device
             ) -> Dict[str, int]:
    """What K4 takes, checked before either route runs: every tensor on
    `device`, of its dtype, with dimensions that agree (two zone keys, the
    four fixed resource slots at least), and contiguous but for the state
    planes (K4_STATE), which the wrapper copies into contiguous clones
    (build_cycle's count planes are column slices). Returns the
    dimensions by name; raises ValueError."""
    dims: Dict[str, int] = {}
    for name, spec in K4_SHAPES.items():
        t = ins[name]
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")
        if name not in K4_STATE and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        dtype = (torch.bool if name in K4_BOOL else
                 torch.float32 if name in K4_F32 else torch.int32)
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != len(spec):
            raise ValueError(f"{name} must have {len(spec)} dimensions "
                             f"{spec}, got shape {tuple(t.shape)}")
        for d, size in zip(spec, t.shape):
            if dims.setdefault(d, size) != size:
                raise ValueError(f"{name} has {d} = {size}, elsewhere "
                                 f"{dims[d]}")
    if dims["ZK"] != 2:
        raise ValueError("zone_keys must hold the two zone topology keys")
    if dims["R"] < 4:
        raise ValueError("resource vectors carry at least the 4 fixed slots")
    dims["D"] = dims["D1"] - 1
    return dims


# K4's status bits (csrc/assign_scan.cu), each a reason an f32 sum of the
# plain version's Score might round
K4_STATUS = ("a WSYM or WCOLS value is not an integer",
             "a term's |WSYM| sums may reach 2^24",
             "the symmetric credit over a class's terms may reach 2^24",
             "the weighted soft-affinity counts reach 2^24",
             "the even-spread total reaches 2^24",
             "a SelectorSpread zone count reaches 2^24")
# K4's launch shape. The node axis is spread over one thread-block cluster
# of `cluster` CTAs, CTA r owning the nodes [r * slice, (r + 1) * slice);
# the cluster is the smallest that leaves each CTA at most K4_NODES_PER_CTA
# nodes (one a thread), up to K4_MAX_CLUSTER (16 needs the non-portable
# cluster attribute, which the launch sets). 320 from the cluster-size
# sweep on an H100 (PERF.md, §6): the step time falls with the slice
# down to ~256-320 nodes a CTA, below which the wider cluster's barriers
# cost more than the shorter per-node passes save.
K4_CLUSTERS = (1, 2, 4, 8, 16)
K4_MAX_CLUSTER = 16
K4_NODES_PER_CTA = 320
# csrc/assign_scan.cu kMaxThreads, its __launch_bounds__: 512 leaves the
# kernel 128 registers a thread and no spill (at 1,024 it had 64 and
# spilled, and took 20-35% longer a step on an H100; PERF.md, §6)
K4_MAX_THREADS = 512
# the optional shared-memory regions (csrc/assign_scan.cu kNode ... kWords),
# in the order they are offered the room left: the per-node values of a
# step, the ring of the next row's static rows, the slice's node rows, the
# histograms, the slice of CNT, the domain totals, the port and volume
# words (each in global memory only where the shapes leave no room; the
# histograms before CNT measured faster at 13a's shapes, PERF.md §6)
K4_PLACE = ("node", "ring", "rows", "hist", "cnt", "dtot", "words")
K4_RED_BYTES = 704         # sizeof(Red): 3 f32, 2 i64, 2 i32 and 1 u64 x 16
K4_XCH_BYTES = 1112        # sizeof(Xch): 8 u64 and 1 i32 x 16, 2 i32, 2 u64


class K4Launch(NamedTuple):
    cluster: int      # CTAs in the one cluster
    slice: int        # nodes each CTA owns (the last may own fewer)
    threads: int      # threads per CTA
    place: int        # K4_PLACE bits: regions in shared memory
    cbw: int          # int32 words of one class block
    smem_bytes: int   # dynamic shared memory per CTA


def _al16(x: int) -> int:
    return (x + 15) & ~15


def k4_cbw(d: Dict[str, int]) -> int:
    """Words of one class block (csrc/assign_scan.cu cb_layout): flags, nl,
    hard bits, port set, volume set, the matched terms and the WCOLS
    column (S each), the TM and has_anti bits, the term lists, the request
    and the port and volume words."""
    sw = (d["S"] + 31) // 32
    return (5 + 2 * d["S"] + 2 * sw + d["AT"] + d["AN"] + 2 * d["PAT"]
            + 2 * d["PAN"] + 2 * d["TS"] + d["SS"] + d["R"] + 2 * d["PWp"]
            + d["PWt"] + 2 * d["VW"])


def k4_layout(d: Dict[str, int], slice_: int, cbw: int, place: int
              ) -> Tuple[int, Dict[str, int]]:
    """(total bytes, each region's bytes) of one CTA's dynamic shared
    memory (csrc/assign_scan.cu layout; every region rounded up to 16
    bytes): the mandatory part (fold and exchange slots, each CTA's argmax
    candidate's domains, the ring of two class blocks, per-term keys,
    totals and bounds, the driver masks),
    then each K4_PLACE region whose bit is in `place`."""
    L, S, D1, H = slice_, d["S"], d["D"] + 1, 2 * d["D"] + 1
    must = [2 * K4_RED_BYTES, K4_XCH_BYTES, 4 * K4_MAX_CLUSTER * (d["K"] + 1),
            2 * 4 * cbw, 4 * S, 4 * S, 4 * d["K"], 8 * S,
            4 * d["DR"] * d["VW"]]
    parts = {
        "node": [L, 4 * L, 4 * L, 4 * L],
        "ring": [2 * (_al16(L + 8) * 2 + 4 * L)],
        "rows": [L, 4 * L, 4 * L * d["R"], 4 * L * d["R"], 4 * L * d["K"]],
        "hist": [3 * 4 * H], "cnt": [4 * S * L], "dtot": [3 * 4 * S * D1],
        "words": [4 * L * (2 * d["PWp"] + d["PWt"] + 2 * d["VW"]
                           + d["DR"])]}
    sizes = {"must": sum(_al16(b) for b in must)}
    for bit, name in enumerate(K4_PLACE):
        if place >> bit & 1:
            sizes[name] = sum(_al16(b) for b in parts[name])
    return sum(sizes.values()), sizes


def k4_launch_config(d: Dict[str, int], cluster: int = None) -> K4Launch:
    """K4's launch shape from the dimensions alone (k4_check's): the
    cluster size (the smallest power of two that leaves each CTA at most
    K4_NODES_PER_CTA nodes, at most 16; `cluster` overrides it, for the
    card's sweep and tests only), each CTA's slice and threads (one a node,
    a multiple of 32, at most K4_MAX_THREADS), and the dynamic shared memory:
    the mandatory part (k4_layout), then each optional region in K4_PLACE
    order where it still fits in SMEM_MAX (232,448 bytes a CTA on an
    H100). Raises ValueError when the mandatory part does not fit."""
    N = d["N"]
    if cluster is None:
        cluster = 1
        while (cluster < K4_MAX_CLUSTER
               and -(-N // cluster) > K4_NODES_PER_CTA):
            cluster *= 2
    elif cluster not in K4_CLUSTERS:
        raise ValueError(f"K4's cluster size is one of {K4_CLUSTERS}, not "
                         f"{cluster}")
    slice_ = -(-N // cluster)
    threads = min(K4_MAX_THREADS, max(32, -(-slice_ // 32) * 32))
    cbw = k4_cbw(d)
    place = 0
    total, _ = k4_layout(d, slice_, cbw, place)
    if total > SMEM_MAX:
        raise ValueError(f"K4 needs {total} bytes of shared memory a CTA for "
                         f"{slice_} nodes, over the {SMEM_MAX} an H100 has")
    for bit in range(len(K4_PLACE)):
        t, _ = k4_layout(d, slice_, cbw, place | 1 << bit)
        if t <= SMEM_MAX:
            place, total = place | 1 << bit, t
    return K4Launch(cluster, slice_, threads, place, cbw, total)


_K4_F32: Dict[torch.device, Tuple[float, float, float]] = {}


def k4_constants(device: torch.device) -> Tuple[float, float, float]:
    """The f32 values torch multiplies and clamps by on `device` where the
    plain version writes Python floats: 1 - ZONE_WEIGHTING and
    ZONE_WEIGHTING (SelectorSpread's blend, ops/scores.py) and the 1e-9
    of the score normalisations' clamps."""
    got = _K4_F32.get(device)
    if got is None:
        one = torch.ones((), dtype=torch.float32, device=device)
        got = (float(one * (1.0 - ZONE_WEIGHTING)),
               float(one * ZONE_WEIGHTING),
               float(torch.clamp(one * 0.0, min=1e-9)))
        _K4_F32[device] = got
    return got


def assign_scan(tables, cyc, pods, rows: torch.Tensor, init):
    """K4: the sequential-assume scan over the pods `rows` [Q] (int32
    indices into `pods`, in walk order), from the state `init`. Returns
    (node [P] int32 — each walked pod's node, -1 where it placed nowhere
    or was not walked — and the final AssignState). `init` is never
    written: the kernel updates one clone per call in place. The plain
    version (ops/assign.py assign_scan_plain) on the CPU, the CUDA kernel
    on a CUDA device; the inputs are checked on both (k4_check). Raises
    ValueError where an f32 sum of the Score would not be exact (the
    kernel's status word; csrc/assign_scan.cu)."""
    from .assign import assign_scan_plain

    ins = k4_inputs(tables, cyc, pods, rows, init)
    device = _device_of(init.used)
    dims = k4_check(ins, device)
    if device.type == "cpu":
        return assign_scan_plain(tables, cyc, pods, rows, init)
    node, state, status, _ = _k4_launch(ins, dims, cyc.ecfg, type(init),
                                        device)
    _count(assign_scan)
    k4_raise_on_status(status)
    return node, state


def k4_raise_on_status(status: torch.Tensor) -> None:
    """Raise ValueError when K4's status word (a 0-d tensor, read back
    here) has a bit set: an f32 sum of the Score the plain version might
    round, named by K4_STATUS."""
    bits = int(status)
    if bits:
        raise ValueError(
            f"assign_scan: an f32 sum of the Score may round (status "
            f"{bits:#x}: " + ", ".join(
                why for bit, why in enumerate(K4_STATUS) if bits >> bit & 1)
            + "), so the kernel could not match its plain version exactly")


# the clusters the card was found to co-schedule, by (cluster, threads,
# shared bytes): cudaOccupancyMaxActiveClusters at a shape's first launch
_K4_CLUSTERS_OK: Dict[Tuple[int, int, int], int] = {}


def _k4_check_cluster(args: "K4Args", cfg: K4Launch) -> None:
    """At a launch shape's first use: the card can co-schedule the cluster
    (cudaOccupancyMaxActiveClusters > 0), else KernelLaunchError."""
    key = (cfg.cluster, cfg.threads, cfg.smem_bytes)
    if key in _K4_CLUSTERS_OK:
        return
    lib = _library("assign_scan")
    fn = lib.assign_scan_max_clusters
    fn.argtypes, fn.restype = [_P, _I], ctypes.c_int
    n = fn(ctypes.addressof(args), cfg.smem_bytes)
    if n < 0:
        raise KernelLaunchError(
            f"assign_scan: cluster query failed: "
            f"{lib.kernel_error_string(-n).decode()}")
    if n == 0:
        raise KernelLaunchError(
            f"assign_scan: a cluster of {cfg.cluster} CTAs x {cfg.threads} "
            f"threads with {cfg.smem_bytes} bytes of shared memory each "
            f"cannot be co-scheduled on this card")
    _K4_CLUSTERS_OK[key] = n


def _k4_launch(ins, dims, ecfg, state_type, device, *, cluster=None):
    """K4's launch on checked inputs: the state cloned (contiguous), the
    outputs and one scratch allocated (the kernel writes every word it
    reads: the class blocks and walk rows, one copy the cluster builds,
    and each CTA's domain totals and histograms where they are not in
    shared memory), the arguments packed.
    `cluster` overrides k4_launch_config's cluster size (the card's sweep
    and tests only). Returns (node, state, the status word as a 0-d
    tensor, the number of (row, node) pairs the Filter passed as a 0-d
    int64 tensor)."""
    state = state_type(*(ins[k].clone(memory_format=torch.contiguous_format)
                         for k in K4_STATE))
    N, S, D, P, Q = dims["N"], dims["S"], dims["D"], dims["P"], dims["Q"]
    cfg = k4_launch_config(dims, cluster)
    C = cfg.cluster
    place = {name: bool(cfg.place >> bit & 1)
             for bit, name in enumerate(K4_PLACE)}
    # one scratch, carved by word offsets (the 8-byte word first)
    parts = (("scored", 2), ("status", 1),
             ("cblock", dims["SC"] * cfg.cbw), ("qinfo", Q * 3),
             ("gdom", 0 if place["dtot"] else C * 3 * S * (D + 1)),
             ("ghist", 0 if place["hist"] else C * 3 * (2 * D + 1)),
             ("gnode", 0 if place["node"] else C * 4 * cfg.slice))
    scratch = torch.empty((sum(w for _, w in parts),), dtype=torch.int32,
                          device=device)
    node = torch.empty((P,), dtype=torch.int32, device=device)
    ptr, off, at = {}, {}, 0
    for name, words in parts:
        ptr[name] = scratch.data_ptr() + 4 * at
        off[name] = at
        at += words
    ptr.update({k: v.data_ptr() for k, v in ins.items()})
    ptr.update({k: getattr(state, k).data_ptr() for k in K4_STATE})
    ptr["node"] = node.data_ptr()
    zw_node, zw_zone, eps = k4_constants(device)
    args = K4Args(
        *(ptr[f] for f in K4_POINTERS),
        N, dims["R"], dims["K"], dims["PWp"], dims["PWt"], dims["VW"],
        dims["DR"], S, dims["SC"], dims["AT"], dims["AN"], dims["PAT"],
        dims["PAN"], dims["TS"], dims["SS"], D, P, Q,
        C, cfg.slice, cfg.threads, cfg.cbw, cfg.place,
        *(int(_on(getattr(ecfg, f))) for f in (
            "f_interpod", "f_spread", "f_name", "f_fit", "f_ports",
            "f_volrestrict", "f_vollimits")),
        *(float(getattr(ecfg, f)) for f in (
            "w_least", "w_balanced", "w_most", "w_interpod", "w_even",
            "w_ssel")),
        zw_node, zw_zone, eps)
    _k4_check_cluster(args, cfg)
    _launch("assign_scan", ctypes.addressof(args), cfg.smem_bytes,
            _stream(device))
    return (node, state, scratch[off["status"]],
            scratch[0:2].view(torch.int64)[0])


assign_scan.launches = 0


def reset_launch_counts() -> None:
    contention_scan.launches = 0
    domain_rank.launches = 0
    reprieve_scan.launches = 0
    assign_scan.launches = 0


def launch_counts() -> Dict[str, int]:
    return {"contention_scan": contention_scan.launches,
            "domain_rank": domain_rank.launches,
            "reprieve_scan": reprieve_scan.launches,
            "assign_scan": assign_scan.launches}
