#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (kubernetes_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  1. the card's name and power limit; build of every CUDA kernel from
     kubernetes_tpu_torch/csrc/ (nvcc, sm_90a) with its compile time;
  2. each kernel against its plain PyTorch version on the card, exactly, on
     edge shapes (node counts off the block size, more than 256 classes,
     words with bit 31 set, extreme int32 requests, > 48 KB of domain
     counters);
  3. the flagship cycle — 5,000 nodes × 50,000 pods (models/workloads.py
     make_nodes / flagship_pods) — through BatchScheduler(device="cuda"):
     launch counts of the cycle, placements and final state planes against
     the same cycle with device="cpu", the placed count and placement hash
     against the JAX package's, cycle wall time (median of 3 warm runs), and
     each kernel against its plain version on the inputs the cycle gave it;
  4. per-kernel times from CUDA events — device time with the host's
     launch work hidden behind a GPU spin (`ms`), time per call with it
     (`call_ms`) — beside the plain version's time per call and the bound.

Prints a `kernels` JSON line, the nvidia-smi name/power line, and last
`{"ok": true, "device": {...}}`. Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

# The JAX package's BatchScheduler on the same flagship input (5,000 nodes ×
# 50,000 pods, JAX 0.9.0 on the CPU): 34,000 pods placed, 16,000
# unschedulable; sha256 over the assignments, one node name (or "-") per
# pending pod joined by newlines. Reproduce with
# `JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax`.
JAX_SCHEDULED = 34000
JAX_ASSIGNMENTS_SHA256 = \
    "3ef91ba5eb90738691a71cdfd9389032f9306b4bcc42dcde0120c3c4fb6a537f"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12   # float32 outside the tensor cores

K1_SOURCE = "kubernetes_tpu_torch/csrc/contention_scan.cu"
K2_SOURCE = "kubernetes_tpu_torch/csrc/domain_rank.cu"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------------- #

def time_ms(fn, device, reps: int = 20) -> float:
    """Mean time per call of fn() over `reps` calls after one warm-up, from
    CUDA events around the whole run (host clock on a CPU rehearsal). Host
    work between launches shows up as device idle time inside the window,
    so this is the time per CALL."""
    import torch

    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, device, reps: int = 20) -> float:
    """Mean DEVICE time per call of fn(): the stream is held by a GPU spin
    (torch.cuda._sleep) while the host enqueues all `reps` calls, so the
    events around them time back-to-back kernels with no host gaps. The spin
    doubles until the start event is still pending once everything is
    enqueued. On a CPU rehearsal, the host clock per call."""
    import torch

    if device.type != "cuda":
        return time_ms(fn, device, reps)
    fn()
    spin = 50_000_000
    for _ in range(8):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / reps
        spin *= 2
    fail("device_ms: the host never got ahead of the device")


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# --------------------------------------------------------------------------- #
# kernel inputs
# --------------------------------------------------------------------------- #

def k1_inputs(gen, device, SC, N, R, PW, PT, VW, DR, extreme=False):
    """Random K1 inputs. `extreme` draws requests, allocatable and used from
    int32 edge values, so the running sums and free space wrap."""
    import torch

    def ints(*shape, lo=-(2**31), hi=2**31 - 1):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int64).to(torch.int32)

    def words(*shape):  # full 32-bit words, bit 31 set about half the time
        return ints(*shape)

    def flags(*shape, p=0.5):
        return torch.rand(shape, generator=gen) < p

    if extreme:
        edge = torch.tensor([0, 1, -1, 2**31 - 1, -(2**31), 2**30, 7],
                            dtype=torch.int32)
        pick = lambda *s: edge[torch.randint(0, len(edge), s, generator=gen)]
        req, alloc, used = pick(SC, R), pick(N, R), pick(N, R)
    else:
        req = ints(SC, R, lo=0, hi=4000)
        req[:, 3] = 1
        alloc = ints(N, R, lo=0, hi=64000)
        alloc[:, 3] = 110
        used = (alloc.float() * torch.rand((N, R), generator=gen)).to(torch.int32)
    sparse = lambda *s: words(*s) & words(*s) & words(*s)
    t = dict(
        A=flags(SC, N, p=0.4), req=req, has_p=flags(SC), pw=sparse(SC, PW),
        ww=sparse(SC, PW), tw=sparse(SC, PT), has_v=flags(SC),
        va=sparse(SC, VW), vr=sparse(SC, VW), alloc=alloc, used=used,
        vol_any=sparse(N, VW), vol_rw=sparse(N, VW), drv_masks=words(DR, VW),
        vol_limit=ints(N, DR, lo=-1, hi=40))
    return tuple(v.to(device) for v in t.values())


def k2_inputs(gen, device, rows, N, num_domains):
    import torch

    dom = torch.randint(0, num_domains, (rows, N), generator=gen,
                        dtype=torch.int64).to(torch.int32)
    return dom.to(device)


def k1_diff(out_a, out_b) -> int:
    import torch

    (ka, wa), (kb, wb) = out_a, out_b
    d = int((ka.to(torch.int64) - kb.to(torch.int64)).abs().max())
    for x, y in zip(wa, wb):
        d = max(d, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
    return d


def k2_diff(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


def check_kernels(device, cases_k1, cases_k2) -> dict:
    """Phase 2: each kernel against its plain version on the card, exact.
    Returns the max abs error per kernel."""
    from kubernetes_tpu_torch.ops import kernels as K

    err = {"contention_scan": 0, "domain_rank": 0}
    for name, args in cases_k1:
        d = k1_diff(K.contention_scan(*args), K.contention_scan_plain(*args))
        sync(device)
        print(f"  K1 {name}: max_abs_err={d}")
        if d != 0:
            fail(f"contention_scan disagrees with its plain version ({name})")
        err["contention_scan"] = max(err["contention_scan"], d)
    for name, (dom, nd) in cases_k2:
        d = k2_diff(K.domain_rank(dom, nd), K.domain_rank_plain(dom, nd))
        sync(device)
        print(f"  K2 {name}: max_abs_err={d}")
        if d != 0:
            fail(f"domain_rank disagrees with its plain version ({name})")
        err["domain_rank"] = max(err["domain_rank"], d)
    return err


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def edge_cases(device, seed: int = 0):
    import torch

    gen = torch.Generator().manual_seed(seed)
    k1 = [
        ("flagship shape SC=52 N=5120 R=4",
         k1_inputs(gen, device, 52, 5120, 4, 1, 1, 1, 2)),
        ("SC=300 N=5000 R=6 PW=2 PT=3 VW=2 DR=3",
         k1_inputs(gen, device, 300, 5000, 6, 2, 3, 2, 3)),
        ("extreme int32 requests SC=64 N=1031",
         k1_inputs(gen, device, 64, 1031, 5, 1, 1, 1, 2, extreme=True)),
    ]
    k2 = [
        ("flagship shape rows=104 N=5120 D+1=5121",
         (k2_inputs(gen, device, 104, 5120, 5121), 5121)),
        ("rows=7 N=5001 D+1=17", (k2_inputs(gen, device, 7, 5001, 17), 17)),
        ("rows=3 N=9000 D+1=13000 (>48 KB counters)",
         (k2_inputs(gen, device, 3, 9000, 13000), 13000)),
    ]
    return k1, k2


# --------------------------------------------------------------------------- #
# the flagship cycle
# --------------------------------------------------------------------------- #

class Recorder:
    """Keeps a copy of the first call's inputs of a kernel wrapper while the
    main path runs (the shapes and data the cycle really gives it)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = None

        def rec(*args):
            if self.args is None:
                self.args = tuple(a.clone() if hasattr(a, "clone") else a
                                  for a in args)
            return self.fn(*args)

        setattr(module, name, rec)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def assignments_sha256(assignments) -> str:
    return hashlib.sha256(
        "\n".join(a or "-" for a in assignments).encode()).hexdigest()


def run_flagship(device, n_nodes, n_pods, reference_device=None):
    """Phase 3. Returns (result, launches, captured kernel inputs, cycle
    seconds) after checking the cycle against the reference device's run."""
    import torch
    from kubernetes_tpu_torch import BatchScheduler
    from kubernetes_tpu_torch.models.workloads import flagship_pods, make_nodes
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops import waves as W

    nodes = make_nodes(n_nodes)
    pods = flagship_pods(n_pods)
    sched = BatchScheduler(device=device)

    recs = [Recorder(W, "contention_scan"), Recorder(W, "domain_rank")]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = sched.schedule(nodes, [], pods)
    sync(device)
    first_s = time.perf_counter() - t0
    launches = K.launch_counts()
    for r in recs:
        r.restore()
    state = sched.last_result.state
    print(f"  first cycle {first_s:.3f} s; scheduled={res.scheduled} "
          f"failed={res.failed}; launches={launches}")
    if device.type == "cuda":
        for name, n in launches.items():
            if n <= 0:
                fail(f"kernel {name} was not launched by the cycle")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = sched.schedule(nodes, [], pods)
        sync(device)
        times.append(time.perf_counter() - t0)
        if again.assignments != res.assignments:
            fail("warm cycle placements differ from the first cycle's")
    cycle_s = statistics.median(times)
    print(f"  warm cycles {[round(t, 4) for t in times]} s; "
          f"median {cycle_s:.4f} s")

    if reference_device is not None:
        ref = BatchScheduler(device=reference_device)
        t0 = time.perf_counter()
        ref_res = ref.schedule(nodes, [], pods)
        print(f"  {reference_device} reference cycle "
              f"{time.perf_counter() - t0:.3f} s")
        if ref_res.assignments != res.assignments:
            bad = sum(a != b for a, b in zip(ref_res.assignments,
                                             res.assignments))
            fail(f"placements differ from the {reference_device} run "
                 f"({bad} pods)")
        rs = ref.last_result.state
        for f in ("used", "ppa", "ppw", "ppt", "CNT", "HOLD", "vol_any",
                  "vol_rw"):
            if not torch.equal(getattr(state, f).cpu(), getattr(rs, f).cpu()):
                fail(f"final state plane {f} differs from the "
                     f"{reference_device} run")
        # WSYM is f32 holding integer weights here: exact in practice; the
        # stated tolerance covers a summation-order rounding of 1e-4
        if not torch.allclose(state.WSYM.cpu(), rs.WSYM.cpu(), rtol=0,
                              atol=1e-4):
            fail("final WSYM plane differs from the reference beyond 1e-4")
        print(f"  placements and final state planes equal the "
              f"{reference_device} run")
    captured = {r.name: r.args for r in recs}
    return res, launches, captured, cycle_s


def k1_bound(args, out) -> tuple:
    """(bound_ms, bound_by) for K1: each input read once, each output
    written once; operations ≈ per (class, node) a fit test and running sum
    over R slots, the port and volume word tests, per-driver popcounts."""
    A, req, _hp, pw, _ww, tw, _hv, va, _vr, *_ = args
    SC, N = A.shape
    R, PW, PT, VW = req.shape[1], pw.shape[1], tw.shape[1], va.shape[1]
    DR = args[13].shape[0]
    keep, words = out
    b = nbytes(args) + nbytes((keep,) + tuple(words))
    ops = SC * N * (6 * R + 4 * (2 * PW + PT) + 8 * VW + 3 * DR * VW + 10)
    t_b, t_o = b / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def k2_bound(dom) -> tuple:
    """(bound_ms, bound_by) for K2: read the rows once, write the ranks
    once; a handful of operations per element."""
    b = 2 * nbytes((dom,))
    ops = 6 * dom.numel()
    t_b, t_o = b / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def kernel_report(device, captured, launches, errs) -> list:
    """Phase 4: each kernel on the inputs the cycle gave it — exact against
    its plain version, then timed beside the plain version and its bound."""
    from kubernetes_tpu_torch.ops import kernels as K

    a1 = captured["contention_scan"]
    out1 = K.contention_scan(*a1)
    d1 = k1_diff(out1, K.contention_scan_plain(*a1))
    dom, nd = captured["domain_rank"]
    d2 = k2_diff(K.domain_rank(dom, nd), K.domain_rank_plain(dom, nd))
    sync(device)
    print(f"  cycle inputs: K1 {tuple(a1[0].shape)} max_abs_err={d1}; "
          f"K2 {tuple(dom.shape)} D+1={nd} max_abs_err={d2}")
    if d1 != 0 or d2 != 0:
        fail("a kernel disagrees with its plain version on the cycle's inputs")

    b1, by1 = k1_bound(a1, out1)
    b2, by2 = k2_bound(dom)
    rows = [
        dict(name="contention_scan", route="cuda", source=K1_SOURCE,
             replaces="kubernetes_tpu/ops/waves.py:438",
             launches=launches["contention_scan"],
             max_abs_err=max(errs["contention_scan"], d1),
             ms=device_ms(lambda: K.contention_scan(*a1), device),
             call_ms=time_ms(lambda: K.contention_scan(*a1), device),
             plain_ms=time_ms(lambda: K.contention_scan_plain(*a1), device,
                              reps=3),
             bound_ms=b1, bound_by=by1, library_ms=None),
        dict(name="domain_rank", route="cuda", source=K2_SOURCE,
             replaces="kubernetes_tpu/ops/waves.py:165",
             launches=launches["domain_rank"],
             max_abs_err=max(errs["domain_rank"], d2),
             ms=device_ms(lambda: K.domain_rank(dom, nd), device),
             call_ms=time_ms(lambda: K.domain_rank(dom, nd), device),
             plain_ms=time_ms(lambda: K.domain_rank_plain(dom, nd), device),
             bound_ms=b2, bound_by=by2, library_ms=None),
    ]
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms on the device, "
              f"{r['call_ms']:.4f} ms per call (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms by {r['bound_by']}), "
              f"{r['launches']} launches per cycle")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing to measure", file=sys.stderr)
        return 2
    from kubernetes_tpu_torch.ops import kernels as K

    device = torch.device("cuda", 0)
    card = card_line()
    print(f"[1] card: {card}")
    t0 = time.perf_counter()
    logs = K.build()
    build_s = time.perf_counter() - t0
    print(f"    kernel build {build_s:.2f} s (nvcc, {len(logs)} libraries, "
          f"built in parallel)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"    {name}: {line.strip()}")

    print("[2] kernels against their plain versions on the card")
    errs = check_kernels(device, *edge_cases(device))

    print("[3] flagship cycle, 5000 nodes x 50000 pods, BatchScheduler(cuda)")
    res, launches, captured, cycle_s = run_flagship(
        device, 5000, 50000, reference_device="cpu")
    if res.scheduled != JAX_SCHEDULED:
        fail(f"scheduled {res.scheduled} != the JAX package's {JAX_SCHEDULED}")
    if assignments_sha256(res.assignments) != JAX_ASSIGNMENTS_SHA256:
        fail("placements differ from the JAX package's (sha256)")
    print(f"    scheduled {res.scheduled} == JAX package's {JAX_SCHEDULED}; "
          f"placement sha256 equal; cycle {cycle_s * 1e3:.1f} ms (median of 3)")

    print("[4] per-kernel times at the cycle's shapes")
    rows = kernel_report(device, captured, launches, errs)

    print(json.dumps({"kernels": rows, "cycle_ms": cycle_s * 1e3,
                      "build_s": build_s}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
