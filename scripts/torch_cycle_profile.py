#!/usr/bin/env python3
"""Where one warm flagship cycle of the PyTorch/CUDA port spends its time.

    python3 scripts/torch_cycle_profile.py [--nodes 5000] [--pods 50000]
                                           [--device cuda]

Runs the steps of kubernetes_tpu_torch's BatchScheduler.schedule on the
flagship workload (models/workloads.py make_nodes × flagship_pods): once
cold, then once warm with host timers around each step — encode (host),
move to the device (tables_to_torch), the device cycle (schedule_batch,
ended by a synchronize), readback of placements — and then the device cycle
once more under torch.profiler: device busy time (the union of kernel and
copy intervals), the idle share of the profiled window, the number of device
operations, and the top kernels by device time. Prints one JSON line.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# run from anywhere: the package lives in the checkout root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals (µs)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=50000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubernetes_tpu_torch.models.workloads import flagship_pods, make_nodes
    from kubernetes_tpu_torch.sched.cycle import (UNSCHEDULABLE_TAINT_KEY,
                                                  schedule_batch)
    from kubernetes_tpu_torch.state.arrays import tables_to_torch
    from kubernetes_tpu_torch.state.encode import Encoder

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_cycle_profile: no CUDA device", file=sys.stderr)
        return 2
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    nodes, pods = make_nodes(args.nodes), flagship_pods(args.pods)
    enc = Encoder()
    enc.vocabs.label_keys.intern(UNSCHEDULABLE_TAINT_KEY)
    enc.vocabs.label_vals.intern("")
    keys = (enc.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY),
            enc.vocabs.label_vals.get(""))

    def cycle():
        t = {}
        t0 = time.perf_counter()
        tables, ex, pe, d = enc.encode_cluster(nodes, [], pods)
        t["encode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tt, (ext, pet) = tables_to_torch(tables, (ex, pe), device)
        sync()
        t["to_device_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = schedule_batch(tt, pet, keys, d.D, ext,
                             has_node_name=d.has_node_name)
        sync()
        t["device_cycle_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        placed = int((res.node.cpu() >= 0).sum())
        t["readback_s"] = time.perf_counter() - t0
        return t, placed, (tt, pet, ext, d)

    cold, _, _ = cycle()
    warm, placed, (tt, pet, ext, d) = cycle()

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        schedule_batch(tt, pet, keys, d.D, ext, has_node_name=d.has_node_name)
        sync()
        window_s = time.perf_counter() - t0
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_us((e.time_range.start, e.time_range.end) for e in dev_events)
    by_name = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + (e.time_range.end - e.time_range.start))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]

    out = {
        "device": (torch.cuda.get_device_name(0) if device.type == "cuda"
                   else "cpu"),
        "nodes": args.nodes, "pods": args.pods, "placed": placed,
        "cold": cold, "warm": warm,
        "profiled_device_cycle_s": window_s,
        "device_ops": len(dev_events),
        "device_busy_ms": busy / 1e3,
        "device_idle_share": (1.0 - busy / 1e6 / window_s
                              if dev_events else None),
        "top_device_ops": [{"name": k[:90], "count": n, "ms": us / 1e3}
                           for k, (n, us) in top],
    }
    for row in out["top_device_ops"]:
        print(f"  {row['ms']:9.3f} ms  {row['count']:5d}x  {row['name']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
