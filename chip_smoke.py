#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (kubernetes_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  1. the card's name and power limit; build of every CUDA kernel from
     kubernetes_tpu_torch/csrc/ (nvcc, sm_90a) with its compile time;
  2. each kernel against its plain PyTorch version on the card, exactly, on
     edge shapes (edge_cases: class counts around a warp's 32 lanes, node
     counts off the block size, both K1 variants, words with bit 31 set,
     extreme int32 requests; K2 counters in shared memory and in the
     scratch past 227 KB, one-domain rows, N = 1);
  3. the flagship cycle — 5,000 nodes × 50,000 pods (models/workloads.py
     make_nodes / flagship_pods) — through BatchScheduler(device="cuda"):
     launch counts of the cycle, placements and final state planes against
     the same cycle with device="cpu", the placed count and placement hash
     against the JAX package's, cycle wall time (median of 3 warm runs);
     3b. the port-and-volume cycle — 5,000 nodes × 20,000 pods with host
     ports and attachable volumes (port_volume_workload) — the same checks
     but the warm runs, and K1 on the real words of its first wave;
  4. per-kernel times from CUDA events at the flagship cycle's inputs,
     each kernel first checked exactly against its plain version there —
     device time with the host's launch work hidden behind a GPU spin
     (`ms`), time per call with it (`call_ms`) — beside the plain version's
     time per call and the bound; K1's device time at the port-and-volume
     cycle's inputs;
  5. serving on resident state, with the overload governor off
     (KTPU_OVERLOAD=0) and a still clock: 5a the steady state of the
     flagship on the port's SchedulerCache (a cold full snapshot, then two
     cycles that churn one node and one pending pod and must take the
     patch path), 5b the port's Scheduler(device="cuda") draining a
     flagship backlog wave by wave (informer confirmations and a node
     update between waves), then a micro wave of 3 fresh pods. Modes, rows
     patched, per-wave counts, placements and the binder's order equal the
     JAX package's recorded constants; 5b also equals the port's CPU run.
     K1 and K2 launch in both, and equal their plain versions on the first
     serving wave's inputs. Prints the per-cycle and per-wave split.

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

# The same for the port-and-volume workload below
# (port_volume_workload(5000, 20000), JAX 0.9.0 on the CPU): all 20,000
# placed. Reproduce with `JAX_PLATFORMS=cpu python3
# scripts/flagship_reference.py --package jax --workload ports-volumes
# --pods 20000`.
PV_NODES, PV_PODS = 5000, 20000
PV_JAX_SCHEDULED = 20000
PV_JAX_ASSIGNMENTS_SHA256 = \
    "8ee42e8e0cd13d3f38977caa912a44ad5711bf0852800d4accc41133fd5bfb96"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12   # float32 outside the tensor cores

# Phase 5: the steady state at the full flagship, and the wave loop's drain
# at SERVING_PODS pods in waves of SERVING_BATCH on SERVING_NODES nodes.
SERVING_NODES, SERVING_STEADY_PODS = 5000, 50000
SERVING_PODS, SERVING_BATCH = 50000, 4096

# Phase 5's reference results from the JAX package (JAX 0.9.0 on the CPU,
# KTPU_OVERLOAD=0). Reproduce with `JAX_PLATFORMS=cpu python3
# scripts/flagship_reference.py --package jax --path serving`.
# 5a, per cycle: (snapshot mode, rows patched, placed, placement sha256).
JAX_STEADY = [
    ("full", 5000, 34000,
     "3ef91ba5eb90738691a71cdfd9389032f9306b4bcc42dcde0120c3c4fb6a537f"),
    ("patch", 1, 34000,
     "3ef91ba5eb90738691a71cdfd9389032f9306b4bcc42dcde0120c3c4fb6a537f"),
    ("patch", 1, 34000,
     "3ef91ba5eb90738691a71cdfd9389032f9306b4bcc42dcde0120c3c4fb6a537f"),
]
# 5b, per wave: (attempted, scheduled, unschedulable, micro, snapshot
# mode, rows patched); then the binder's ordered (pod, node) list.
JAX_DRAIN = {
    "waves": [
        (4096, 0, 4096, 0, "full", 5000),
        (4096, 0, 4096, 0, "full", 5000),
        (4096, 0, 4096, 0, "full", 5000),
        (4096, 384, 3712, 0, "patch", 1),
        (4096, 4096, 0, 0, "patch", 768),
        (4096, 4096, 0, 0, "full", 5000),
        (4096, 4096, 0, 0, "full", 5000),
        (4096, 4096, 0, 0, "patch", 4338),
        (4096, 4096, 0, 0, "patch", 4338),
        (4096, 4096, 0, 0, "patch", 4988),
        (4096, 4096, 0, 0, "patch", 4338),
        (4096, 4096, 0, 0, "patch", 4338),
        (848, 848, 0, 0, "full", 5000),
        (3, 3, 0, 1, "patch", 899),
    ],
    "bound": 34003,
    "bound_sha256":
        "777cae914b9ee93bc2044c32534c187d86c9551f013c8bd86ba018ea87c6f568",
}

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
    """Phase 2's cases. K1: class counts around the warp's 32 lanes (1, 31,
    32, 33, 300), node counts off the block (1, 33, 5,000), widths at the
    registers variant's bounds (R 8; PW, PT, VW, DR 4) and one past each, so
    both variants run, PT != PW, and extreme int32 requests on both variants.
    K2: counters in shared memory (up to 227 KB) and in the scratch (D+1 =
    70,000, whose counters alone pass 227 KB; rows striding over fewer
    blocks), one domain for a whole row (ranks up to N - 1), N = 1, N off
    the segment size."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    k1 = [
        ("flagship shape SC=52 N=5120 R=4",
         k1_inputs(gen, device, 52, 5120, 4, 1, 1, 1, 2)),
        ("SC=1 N=1 R=4 PW=1 PT=2 VW=1 DR=1",
         k1_inputs(gen, device, 1, 1, 4, 1, 2, 1, 1)),
        ("SC=31 N=33 at the register bounds R=8 PW=PT=VW=DR=4",
         k1_inputs(gen, device, 31, 33, 8, 4, 4, 4, 4)),
        ("SC=32 N=5000 R=8 PW=4 PT=3 VW=4 DR=4",
         k1_inputs(gen, device, 32, 5000, 8, 4, 3, 4, 4)),
        ("SC=33 N=33 shared variant, R=9 one past",
         k1_inputs(gen, device, 33, 33, 9, 4, 4, 4, 4)),
        ("SC=33 N=1 shared variant, PW=5 one past, PT=2",
         k1_inputs(gen, device, 33, 1, 4, 5, 2, 1, 1)),
        ("SC=300 N=5000 R=6 PW=2 PT=3 VW=2 DR=3",
         k1_inputs(gen, device, 300, 5000, 6, 2, 3, 2, 3)),
        ("SC=300 N=5000 shared variant, PT=5 VW=5 DR=5 one past",
         k1_inputs(gen, device, 300, 5000, 5, 2, 5, 5, 5)),
        ("extreme int32 requests SC=64 N=1031",
         k1_inputs(gen, device, 64, 1031, 5, 1, 1, 1, 2, extreme=True)),
        ("extreme int32 requests SC=40 N=33 shared variant, R=9",
         k1_inputs(gen, device, 40, 33, 9, 2, 1, 1, 2, extreme=True)),
    ]
    one = torch.full((4, 5120), 77, dtype=torch.int32, device=device)
    k2 = [
        ("flagship shape rows=104 N=5120 D+1=5121",
         (k2_inputs(gen, device, 104, 5120, 5121), 5121)),
        ("rows=7 N=5001 D+1=17", (k2_inputs(gen, device, 7, 5001, 17), 17)),
        ("rows=3 N=9000 D+1=13000 (>48 KB counters)",
         (k2_inputs(gen, device, 3, 9000, 13000), 13000)),
        ("rows=5 N=8000 D+1=70000 (scratch counters)",
         (k2_inputs(gen, device, 5, 8000, 70000), 70000)),
        ("rows=200 N=1000 D+1=70000 (scratch, blocks stride over rows)",
         (k2_inputs(gen, device, 200, 1000, 70000), 70000)),
        ("rows=4 N=5120 one domain per row (ranks to N-1)", (one, 5121)),
        ("rows=3 N=1 D+1=5", (k2_inputs(gen, device, 3, 1, 5), 5)),
        ("rows=6 N=5001 D+1=3000 (N off the segment size)",
         (k2_inputs(gen, device, 6, 5001, 3000), 3000)),
        ("rows=6 N=1000 D+1=3 (16 segments of 64)",
         (k2_inputs(gen, device, 6, 1000, 3), 3)),
    ]
    return k1, k2


# --------------------------------------------------------------------------- #
# the port-and-volume cycle
# --------------------------------------------------------------------------- #

def port_volume_workload(n_nodes: int, n_pods: int, types=None,
                         workloads=None, groups: int = 48):
    """make_nodes(n_nodes) with per-driver attach limits on four nodes of
    five, and a pending backlog of n_pods in `groups` deployment groups where
    a share carry host ports and attachable volumes:
      * every third group binds four host ports (one on the wildcard IP, three
        on group-specific IPs, TCP and UDP), drawn from 29 port numbers, so
        groups collide on ports: 38 (proto, port) pairs and 48 triples, two
        words each (PWp == PWt, as the JAX package needs);
      * groups g % 4 == 1 mount two read-write "pd" disks, one of eight of the
        group's own and one of twelve shared across groups (classes collide
        on it); groups g % 4 == 3 mount a shared read-only "ebs" volume and
        one of three read-write ones of their own — 147 volumes, 5 words;
      * even groups spread across zones (hard, maxSkew 4).
    `types`/`workloads` are the port's api.types and models.workloads by
    default; scripts/flagship_reference.py passes the JAX package's, to
    build the same input for it."""
    if types is None:
        from kubernetes_tpu_torch.api import types
    if workloads is None:
        from kubernetes_tpu_torch.models import workloads
    nodes = workloads.make_nodes(n_nodes)
    for i, node in enumerate(nodes):
        if i % 5:
            node.volume_limits = {"pd": 2 + i % 4, "ebs": 1 + i % 3}
    tiers = [("100m", "128Mi"), ("250m", "512Mi"), ("500m", "1Gi"),
             ("1", "2Gi")]
    pods = []
    for i in range(n_pods):
        g, j = i % groups, i // groups % 24
        app = f"pv-{g}"
        ports, vols, spread = (), (), ()
        if g % 3 == 0:
            ports = tuple(types.HostPort(
                port=7000 + (5 * g + k) % 29,
                protocol="UDP" if k == 2 else "TCP",
                host_ip="" if k == 0 else f"10.0.{k}.{g}") for k in range(4))
        if g % 4 == 1:
            vols = (types.VolumeRef(f"disk-{g}-{j % 8}", driver="pd"),
                    types.VolumeRef(f"disk-shared-{(g // 4 + j % 8) % 12}",
                                    driver="pd"))
        elif g % 4 == 3:
            vols = (types.VolumeRef(f"data-{g % 6}", driver="ebs",
                                    read_only=True),
                    types.VolumeRef(f"scratch-{g}-{j % 3}", driver="ebs"))
        if g % 2 == 0:
            spread = (types.TopologySpreadConstraint(
                max_skew=4, topology_key=workloads.ZONE,
                when_unsatisfiable=types.UnsatisfiableAction.DO_NOT_SCHEDULE,
                selector=types.LabelSelector.of(match_labels={"app": app})),)
        cpu, mem = tiers[g % len(tiers)]
        pods.append(types.Pod(
            name=f"pv-{g}-{i}", labels={"app": app},
            requests=types.Resources.make(cpu=cpu, memory=mem),
            host_ports=ports, volumes=vols, topology_spread=spread,
            priority=g % 3, creation_index=i))
    return nodes, pods


# --------------------------------------------------------------------------- #
# phase 5: serving on resident state (shared with scripts/flagship_reference.py)
# --------------------------------------------------------------------------- #

class FakeClock:
    """A scheduler clock that stands still unless moved: backoff and the
    assume TTL then depend on the script, not on how fast the host is."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def port_serving_api(device):
    """What phase 5 drives, from the port, on `device`. The reference script
    builds the same namespace from the JAX package, so both packages run the
    one script below."""
    import types as pytypes

    import kubernetes_tpu_torch as ktt
    from kubernetes_tpu_torch.api import types
    from kubernetes_tpu_torch.models import workloads
    from kubernetes_tpu_torch.sched.cycle import (schedule_batch,
                                                  snapshot_with_keys)
    from kubernetes_tpu_torch.state.dims import Dims
    from kubernetes_tpu_torch.state.encode import Encoder

    def dispatch(snap, keys):
        node = schedule_batch(snap.tables, snap.pending, keys, snap.dims.D,
                              snap.existing,
                              has_node_name=snap.dims.has_node_name).node
        sync(device)
        return node

    return pytypes.SimpleNamespace(
        types=types, workloads=workloads, Dims=Dims, Encoder=Encoder,
        SchedulerCache=ktt.SchedulerCache,
        RecordingBinder=ktt.RecordingBinder,
        snapshot=lambda cache, enc, pods, base: snapshot_with_keys(
            cache, enc, pods, base, device=device),
        dispatch=dispatch,
        readback=lambda node: node.cpu().tolist(),
        scheduler=lambda **kw: ktt.Scheduler(device=device, **kw))


def bound_sha256(bound) -> str:
    """sha256 over a binder's ordered (pod key, node) list."""
    return hashlib.sha256("\n".join(
        f"{k} {n}" for k, n in bound).encode()).hexdigest()


def serving_steady(api, n_nodes: int, n_pods: int, cycles: int = 2) -> dict:
    """Phase 5a: the steady state of a serving cycle on the resident cache
    (bench.py's flagship stage): make_nodes(n_nodes) into a SchedulerCache,
    flagship_pods(n_pods) pending with base Dims(N, P, E=1); one cold
    snapshot (full) and cycle, then `cycles` steady cycles that each churn
    one node (update_node) and replace pods[0] with a copy, so the node rows
    and the pending block both patch. Per cycle: snapshot mode, rows
    patched, placed count and placement sha256, and the split — snapshot,
    dispatch (to a synchronize), readback, host mapping — in seconds."""
    import dataclasses

    nodes = api.workloads.make_nodes(n_nodes)
    pods = api.workloads.flagship_pods(n_pods)
    base = api.Dims(N=n_nodes, P=n_pods, E=1)
    cache, enc = api.SchedulerCache(), api.Encoder()
    for n in nodes:
        cache.add_node(n)
    enc.intern_pods(pods)

    def cycle(pending):
        t0 = time.perf_counter()
        snap, keys = api.snapshot(cache, enc, pending, base)
        t1 = time.perf_counter()
        node = api.dispatch(snap, keys)
        t2 = time.perf_counter()
        idx = api.readback(node)
        t3 = time.perf_counter()
        placed = [snap.node_order[i] if i >= 0 else None
                  for i in idx[: len(pending)]]
        t4 = time.perf_counter()
        return dict(mode=cache.last_snapshot_mode,
                    patch_rows=cache.last_patch_rows,
                    scheduled=sum(a is not None for a in placed),
                    sha256=assignments_sha256(placed),
                    snapshot_s=t1 - t0, dispatch_s=t2 - t1,
                    readback_s=t3 - t2, map_s=t4 - t3)

    out = [cycle(pods)]
    for i in range(cycles):
        cache.update_node(nodes[i])
        pods = list(pods)
        pods[0] = dataclasses.replace(pods[0])
        out.append(cycle(pods))
    return {"cycles": out}


def serving_drain(api, n_nodes: int, n_pods: int,
                  batch_size: int = SERVING_BATCH,
                  on_wave=None) -> dict:
    """Phase 5b: the wave loop. A Scheduler(RecordingBinder, batch_size,
    microwave=True) on a still clock over make_nodes(n_nodes), with
    base_dims sized to the drain (N, P = batch_size, E = n_pods) and a
    flagship_pods(n_pods) backlog fed through on_pod_add, drained one wave at
    a time by run_until_idle(max_waves=1). Between waves the wave's bound
    pods are confirmed through on_pod_add with node_name set (the informer
    confirmation) and one node is updated, so the patch path carries node,
    existing-pod and pending rows. Pods a wave cannot place wait in the
    backoff queue (the clock does not move), so the drain ends when the
    active queue is empty. Then 3 fresh single pods arrive: the next
    schedule_pending must be a micro wave. `on_wave(i)` is called after each
    wave's run (chip_smoke.py reads its timings there)."""
    import dataclasses

    T = api.types
    nodes = api.workloads.make_nodes(n_nodes)
    pods = api.workloads.flagship_pods(n_pods)
    by_key = {p.key: p for p in pods}
    binder = api.RecordingBinder()
    s = api.scheduler(binder=binder, batch_size=batch_size, microwave=True,
                      clock=FakeClock(),
                      base_dims=api.Dims(N=n_nodes, P=batch_size, E=n_pods))
    if s.governor is not None:
        # wall-clock wave sizing would make the waves depend on the host
        fail("phase 5 runs with KTPU_OVERLOAD=0 (the overload governor off)")
    for n in nodes:
        s.on_node_add(n)
    for p in pods:
        s.on_pod_add(p)
    waves = []

    def note(st):
        waves.append(dict(attempted=st.attempted, scheduled=st.scheduled,
                          unschedulable=st.unschedulable, micro=st.micro,
                          mode=s.cache.last_snapshot_mode,
                          patch_rows=s.cache.last_patch_rows))
        if on_wave is not None:
            on_wave(len(waves) - 1)

    for w in range(4 * (n_pods // batch_size + 2)):
        first = len(binder.bound)
        note(s.run_until_idle(max_waves=1))
        for key, node in binder.bound[first:]:
            s.on_pod_add(dataclasses.replace(by_key[key], node_name=node))
        s.on_node_update(nodes[w % n_nodes])
        if s.queue.lengths()[0] == 0:
            break
    for i in range(3):
        s.on_pod_add(T.Pod(name=f"fresh-{i}", labels={"app": "fresh"},
                           requests=T.Resources.make(cpu="100m",
                                                     memory="128Mi"),
                           creation_index=n_pods + i))
    note(s.schedule_pending())
    return {"waves": waves, "bound": len(binder.bound),
            "bound_sha256": bound_sha256(binder.bound),
            "counts": list(s.cache.counts()),
            "queue": list(s.queue.lengths())}


# --------------------------------------------------------------------------- #
# running a cycle
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


def run_cycle(device, nodes, pods, warm_runs=3, reference_device=None):
    """One phase-3 cycle through BatchScheduler. The launch counts are set
    to 0 just before the first cycle and read just after it. Returns
    (result, launches, captured kernel inputs, median warm cycle seconds or
    None) after checking the cycle against the reference device's run."""
    import torch
    from kubernetes_tpu_torch import BatchScheduler
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops import waves as W

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
    for _ in range(warm_runs):
        t0 = time.perf_counter()
        again = sched.schedule(nodes, [], pods)
        sync(device)
        times.append(time.perf_counter() - t0)
        if again.assignments != res.assignments:
            fail("warm cycle placements differ from the first cycle's")
    cycle_s = statistics.median(times) if times else None
    if times:
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


def check_real_words(device, args) -> dict:
    """K1 on the port-and-volume cycle's first-wave inputs: the words that
    reach it are real (classes with host ports and volumes, non-zero
    words), and the kernel equals its plain version on them exactly."""
    from kubernetes_tpu_torch.ops import kernels as K

    A, req, has_p, pw, ww, tw, has_v, va, vr, *_ = args
    drv = args[13]
    real = {"classes": int(A.shape[0]),
            "port_classes": int((has_p & ((pw != 0).any(1) | (ww != 0).any(1)
                                          | (tw != 0).any(1))).sum()),
            "volume_classes": int((has_v & ((va != 0).any(1)
                                            | (vr != 0).any(1))).sum())}
    if real["port_classes"] == 0 or real["volume_classes"] == 0:
        fail(f"the port-and-volume cycle sent no real words to K1: {real}")
    out = K.contention_scan(*args)
    d = k1_diff(out, K.contention_scan_plain(*args))
    sync(device)
    cfg = K.k1_launch_config(A.shape[0], A.shape[1], req.shape[1],
                             pw.shape[1], tw.shape[1], va.shape[1],
                             drv.shape[0])
    dropped = int(A.sum()) - int(out[0].sum())
    print(f"  K1 on the cycle's first wave: {real}, widths "
          f"PW={pw.shape[1]} PT={tw.shape[1]} VW={va.shape[1]} "
          f"DR={drv.shape[0]} ({cfg.variant} variant), {dropped} of "
          f"{int(A.sum())} admissions dropped; max_abs_err={d}")
    if d != 0:
        fail("contention_scan disagrees with its plain version on the "
             "port-and-volume cycle's inputs")
    return dict(real, variant=cfg.variant, dropped=dropped, max_abs_err=d)


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


class ServingTimer:
    """Per-wave host timers around the port's Scheduler for phase 5b: the
    snapshot (snapshot_with_keys or its micro twin), the dispatch (the
    cycle, ended by a synchronize, so the readback that follows is only the
    copy of the placements) and the whole wave; commit is the rest of the
    wave (the readback copy, the prestage intern of the next backlog, the
    assume/bind loop, the requeue). Installed by patching the names the
    scheduler module calls; `restore()` puts them back."""

    NAMES = ("snapshot_with_keys", "micro_snapshot_with_keys",
             "schedule_batch")

    def __init__(self, device):
        from kubernetes_tpu_torch.sched import scheduler as S

        self.S, self.saved = S, {n: getattr(S, n) for n in self.NAMES}
        self.cur = {"snapshot_s": 0.0, "dispatch_s": 0.0}
        self.waves = []

        def timed(name, key, synced=False):
            fn = self.saved[name]

            def run(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                if synced:
                    sync(device)
                self.cur[key] += time.perf_counter() - t0
                return out
            return run

        S.snapshot_with_keys = timed("snapshot_with_keys", "snapshot_s")
        S.micro_snapshot_with_keys = timed("micro_snapshot_with_keys",
                                           "snapshot_s")
        S.schedule_batch = timed("schedule_batch", "dispatch_s", True)

    def wrap(self, sched):
        """Time each schedule_pending of one scheduler instance."""
        inner = sched.schedule_pending

        def schedule_pending(*a, **kw):
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            wave_s = time.perf_counter() - t0
            c = self.cur
            self.waves.append(dict(
                snapshot_s=c["snapshot_s"], dispatch_s=c["dispatch_s"],
                commit_s=wave_s - c["snapshot_s"] - c["dispatch_s"],
                wave_s=wave_s))
            self.cur = {"snapshot_s": 0.0, "dispatch_s": 0.0}
            return out

        sched.schedule_pending = schedule_pending
        return sched

    def restore(self):
        for n, fn in self.saved.items():
            setattr(self.S, n, fn)


def serving_phase(device) -> dict:
    """Phase 5 on the card: 5a the steady state at the flagship, 5b the
    wave loop's drain and its micro wave, each against the JAX package's
    recorded constants, 5b also against the port's own CPU run; the launch
    counts of each, set to 0 just before it and read just after; K1 and K2
    held against their plain versions on the first serving wave's inputs."""
    import os

    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops import waves as W

    os.environ["KTPU_OVERLOAD"] = "0"
    api = port_serving_api(device)

    print(f"[5a] steady serving cycles, {SERVING_NODES} nodes x "
          f"{SERVING_STEADY_PODS} pods on the resident cache")
    K.reset_launch_counts()
    steady = serving_steady(api, SERVING_NODES, SERVING_STEADY_PODS)
    launches_a = K.launch_counts()
    for i, c in enumerate(steady["cycles"]):
        print(f"  cycle {i}: {c['mode']} snapshot ({c['patch_rows']} rows) "
              f"{c['snapshot_s']:.4f} s, dispatch {c['dispatch_s']:.4f} s, "
              f"readback {c['readback_s']:.4f} s, host map "
              f"{c['map_s']:.4f} s; scheduled {c['scheduled']}")
    got = [(c["mode"], c["patch_rows"], c["scheduled"], c["sha256"])
           for c in steady["cycles"]]
    if got != [tuple(x) for x in JAX_STEADY]:
        fail(f"steady serving cycles differ from the JAX package's: {got}")
    cold, warm = steady["cycles"][0], steady["cycles"][1:]
    print(f"    modes, rows, placements equal the JAX package's; patch "
          f"snapshot {statistics.median(c['snapshot_s'] for c in warm):.4f} s "
          f"against the cold full snapshot {cold['snapshot_s']:.4f} s; "
          f"launches {launches_a}")
    for name, n in launches_a.items():
        if n <= 0 and device.type == "cuda":
            fail(f"kernel {name} was not launched by the steady cycles")

    print(f"[5b] wave loop: Scheduler(device='cuda', batch_size="
          f"{SERVING_BATCH}, microwave=True), {SERVING_NODES} nodes x "
          f"{SERVING_PODS} pods, drained by run_until_idle")
    timer = ServingTimer(device)
    cuda_api = port_serving_api(device)
    make = cuda_api.scheduler
    cuda_api.scheduler = lambda **kw: timer.wrap(make(**kw))
    recs = [Recorder(W, "contention_scan"), Recorder(W, "domain_rank")]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        drain = serving_drain(cuda_api, SERVING_NODES, SERVING_PODS)
    finally:
        timer.restore()
        for r in recs:
            r.restore()
    drain_s = time.perf_counter() - t0
    launches_b = K.launch_counts()
    for i, (w, t) in enumerate(zip(drain["waves"], timer.waves)):
        print(f"  wave {i:2d}: {'micro' if w['micro'] else 'bulk '} "
              f"{w['mode']:6s} {w['patch_rows']:6d} rows; attempted "
              f"{w['attempted']:5d} scheduled {w['scheduled']:5d} "
              f"unschedulable {w['unschedulable']:5d}; snapshot "
              f"{t['snapshot_s']:.4f} s, dispatch+readback "
              f"{t['dispatch_s']:.4f} s, commit {t['commit_s']:.4f} s")
    sched_s = sum(t["wave_s"] for t in timer.waves)
    pods_s = drain["bound"] / sched_s
    print(f"    {drain['bound']} pods bound in {len(drain['waves'])} waves: "
          f"{sched_s:.3f} s in schedule_pending ({pods_s:.1f} pods/s), "
          f"{drain_s:.3f} s with the informer events; launches {launches_b}")
    for name, n in launches_b.items():
        if n <= 0 and device.type == "cuda":
            fail(f"kernel {name} was not launched by the wave loop")
    if drain["waves"][-1]["micro"] != 1:
        fail("the 3 fresh pods after the drain did not take a micro wave")
    check_drain(drain, "the JAX package's", JAX_DRAIN)

    t0 = time.perf_counter()
    cpu_drain = serving_drain(port_serving_api(torch.device("cpu")),
                              SERVING_NODES, SERVING_PODS)
    print(f"    the port's CPU run of the drain took "
          f"{time.perf_counter() - t0:.1f} s")
    if cpu_drain != drain:
        fail("the drain on the card differs from the port's CPU run")
    print("    binder order, per-wave counts, snapshot modes and the micro "
          "wave equal the JAX package's and the CPU run's")

    a1 = recs[0].args
    d1 = k1_diff(K.contention_scan(*a1), K.contention_scan_plain(*a1))
    dom, nd = recs[1].args
    d2 = k2_diff(K.domain_rank(dom, nd), K.domain_rank_plain(dom, nd))
    sync(device)
    print(f"  first serving wave's inputs: K1 {tuple(a1[0].shape)} "
          f"max_abs_err={d1}; K2 {tuple(dom.shape)} D+1={nd} "
          f"max_abs_err={d2}")
    if d1 or d2:
        fail("a kernel disagrees with its plain version on the first "
             "serving wave's inputs")
    errs = {"contention_scan": d1, "domain_rank": d2}
    return dict(steady=steady, drain=drain, timer=timer.waves,
                drain_s=drain_s, sched_s=sched_s, pods_s=pods_s,
                launches_a=launches_a, launches_b=launches_b, errs=errs,
                inputs={"contention_scan": a1, "domain_rank": (dom, nd)})


def check_drain(drain, who: str, ref: dict) -> None:
    waves = [(w["attempted"], w["scheduled"], w["unschedulable"], w["micro"],
              w["mode"], w["patch_rows"]) for w in drain["waves"]]
    if waves != [tuple(w) for w in ref["waves"]]:
        fail(f"per-wave counts or snapshot modes differ from {who}: {waves}")
    if (drain["bound"], drain["bound_sha256"]) != (ref["bound"],
                                                   ref["bound_sha256"]):
        fail(f"the binder's (pod, node) order differs from {who}")


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
    from kubernetes_tpu_torch.models.workloads import flagship_pods, make_nodes

    res, launches, captured, cycle_s = run_cycle(
        device, make_nodes(5000), flagship_pods(50000), warm_runs=3,
        reference_device="cpu")
    if res.scheduled != JAX_SCHEDULED:
        fail(f"scheduled {res.scheduled} != the JAX package's {JAX_SCHEDULED}")
    if assignments_sha256(res.assignments) != JAX_ASSIGNMENTS_SHA256:
        fail("placements differ from the JAX package's (sha256)")
    print(f"    scheduled {res.scheduled} == JAX package's {JAX_SCHEDULED}; "
          f"placement sha256 equal; cycle {cycle_s * 1e3:.1f} ms (median of 3)")

    print(f"[3b] port-and-volume cycle, {PV_NODES} nodes x {PV_PODS} pods, "
          f"BatchScheduler(cuda)")
    pv_res, pv_launches, pv_captured, _ = run_cycle(
        device, *port_volume_workload(PV_NODES, PV_PODS), warm_runs=0,
        reference_device="cpu")
    if pv_res.scheduled != PV_JAX_SCHEDULED:
        fail(f"port-and-volume cycle scheduled {pv_res.scheduled} != the JAX "
             f"package's {PV_JAX_SCHEDULED}")
    if assignments_sha256(pv_res.assignments) != PV_JAX_ASSIGNMENTS_SHA256:
        fail("port-and-volume placements differ from the JAX package's "
             "(sha256)")
    pv_k1 = check_real_words(device, pv_captured["contention_scan"])
    print(f"    scheduled {pv_res.scheduled} == JAX package's "
          f"{PV_JAX_SCHEDULED}; placement sha256 equal")

    print("[4] per-kernel times at the flagship cycle's shapes")
    rows = kernel_report(device, captured, launches, errs)
    pv_k1["launches"] = pv_launches["contention_scan"]
    pv_k1["ms"] = device_ms(
        lambda: K.contention_scan(*pv_captured["contention_scan"]), device)
    pv_k1["bound_ms"], pv_k1["bound_by"] = k1_bound(
        pv_captured["contention_scan"],
        K.contention_scan(*pv_captured["contention_scan"]))
    print(f"  contention_scan at the port-and-volume cycle's first wave "
          f"({pv_k1['variant']} variant): {pv_k1['ms']:.4f} ms on the device "
          f"(bound {pv_k1['bound_ms']:.6f} ms by {pv_k1['bound_by']}), "
          f"{pv_k1['launches']} launches in that cycle")

    serving = serving_phase(device)
    for r in rows:
        name = r["name"]
        args = serving["inputs"][name]
        fn = K.contention_scan if name == "contention_scan" else K.domain_rank
        r["serving"] = dict(
            launches_steady=serving["launches_a"][name],
            launches_drain=serving["launches_b"][name],
            max_abs_err=serving["errs"][name],
            ms=device_ms(lambda: fn(*args), device),
            shape=list(args[0].shape))
        r["max_abs_err"] = max(r["max_abs_err"], serving["errs"][name])
    steady = serving["steady"]["cycles"]
    print(json.dumps({"kernels": rows, "cycle_ms": cycle_s * 1e3,
                      "build_s": build_s,
                      "contention_scan_ports_volumes": pv_k1,
                      "serving": {
                          "steady_full_snapshot_s": steady[0]["snapshot_s"],
                          "steady_patch_snapshot_s": [
                              c["snapshot_s"] for c in steady[1:]],
                          "steady_cycles": steady,
                          "drain_waves": [dict(w, **t) for w, t in zip(
                              serving["drain"]["waves"], serving["timer"])],
                          "drain_bound": serving["drain"]["bound"],
                          "drain_sched_s": serving["sched_s"],
                          "drain_pods_per_s": serving["pods_s"],
                          "drain_wall_s": serving["drain_s"]}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
