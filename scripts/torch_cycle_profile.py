#!/usr/bin/env python3
"""Where one warm flagship cycle of the PyTorch/CUDA port spends its time.

    python3 scripts/torch_cycle_profile.py [--nodes 5000] [--pods 50000]
                                           [--device cuda] [--mode batch]
    python3 scripts/torch_cycle_profile.py --mode serving
    python3 scripts/torch_cycle_profile.py --mode preempt
    python3 scripts/torch_cycle_profile.py --mode runs
    python3 scripts/torch_cycle_profile.py --mode resilience
    python3 scripts/torch_cycle_profile.py --mode mesh [--shards 4]

`--mode batch` (the default) runs the steps of kubernetes_tpu_torch's
BatchScheduler.schedule on the flagship workload (models/workloads.py
make_nodes × flagship_pods): once cold, then once warm with host timers
around each step — encode (host), move to the device (tables_to_torch), the
device cycle (schedule_batch, ended by a synchronize), readback of
placements — and then the device cycle once more under torch.profiler.

`--mode serving` runs chip_smoke.py's phase-5a steady state instead: the
flagship on the resident SchedulerCache, a cold full snapshot and cycle,
then steady cycles that each churn one node and replace one pending pod —
one warm with host timers (patch snapshot, dispatch to a synchronize,
readback), and one whole steady cycle (snapshot included) under
torch.profiler.

`--mode preempt` runs chip_smoke.py's phase-6 storm instead (the phase-5b
drain of the flagship backlog first, to make its cluster) and profiles the
first three preemption bursts of wave 1, each alone: `preempt_batch` (the
what-if, K3 and the node choice) from a synchronize to a synchronize, with
the count of top-level aten operations it issued on the host.

`--mode runs` runs chip_smoke.py's phase 8a instead: BatchScheduler under
KTPU_ASSIGN=runs on make_nodes × deployment_backlog_pods(P,
deployments=200), once cold, then once warm with a host timer around each
closed-form run (its context, admission epochs and commit; the epochs
counted), and three runs of the warm cycle (runs 100-102) each alone under
torch.profiler, with their host aten-op counts and the host ops that took
the most CPU time (the readbacks' waits among them).

`--mode resilience` drains chip_smoke.py's phase-5b backlog through the
serving Scheduler (KTPU_OVERLOAD=0, a still clock) under five variants of
the resilience layer, in turns ABCDE EDCBA: `default` (the supervised
dispatch on a worker thread and telemetry; the prewarmer off, as the
Scheduler builds it), `prewarm` (the prewarmer on), `inline` (each
supervised dispatch run on the calling thread), `no-telemetry`
(KTPU_TELEMETRY=0) and `bare` (the dispatch inline and telemetry off). Per run: seconds in schedule_pending, pods/s, and the seconds the
garbage collector ran (gc.callbacks); every run must bind 5b's binder order
(at another size, the first run's).

`--mode mesh` runs one warm flagship cycle (make_nodes(N) x
flagship_pods(P), the wave engine) unsharded and then sharded on a mesh of
`--shards` x the device (parallel/mesh.py), each profiled: per run the
cycle's seconds, and for the sharded one the collectives it took and their
bytes, and the lead shard's seconds waiting in them and running lead steps
(parallel/axis.py LAST_RUN); both runs' placements must be equal.

The profiled window gives device busy time (the union of kernel and copy
intervals), the idle share of the window, the number of device operations,
and the top kernels by device time. Prints one JSON line. Imports nothing of
JAX.
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


def device_profile(prof, window_s: float) -> dict:
    """Busy time, idle share, op count and top ops of a profiled window."""
    from torch.autograd import DeviceType

    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_us((e.time_range.start, e.time_range.end) for e in dev_events)
    by_name = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + (e.time_range.end - e.time_range.start))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {
        "device_ops": len(dev_events),
        "device_busy_ms": busy / 1e3,
        "device_idle_share": (1.0 - busy / 1e6 / window_s
                              if dev_events else None),
        "top_device_ops": [{"name": k[:90], "count": n, "ms": us / 1e3}
                           for k, (n, us) in top],
    }


def batch_profile(args, device, sync, profile, acts) -> dict:
    from kubernetes_tpu_torch.models.workloads import flagship_pods, make_nodes
    from kubernetes_tpu_torch.sched.cycle import (UNSCHEDULABLE_TAINT_KEY,
                                                  schedule_batch)
    from kubernetes_tpu_torch.state.arrays import tables_to_torch
    from kubernetes_tpu_torch.state.encode import Encoder

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

    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        schedule_batch(tt, pet, keys, d.D, ext, has_node_name=d.has_node_name)
        sync()
        window_s = time.perf_counter() - t0
    return dict({"placed": placed, "cold": cold, "warm": warm,
                 "profiled_device_cycle_s": window_s},
                **device_profile(prof, window_s))


def serving_profile(args, device, sync, profile, acts) -> dict:
    import dataclasses

    from chip_smoke import port_serving_api

    api = port_serving_api(device)
    nodes = api.workloads.make_nodes(args.nodes)
    pods = api.workloads.flagship_pods(args.pods)
    base = api.Dims(N=args.nodes, P=args.pods, E=1)
    cache, enc = api.SchedulerCache(), api.Encoder()
    for n in nodes:
        cache.add_node(n)
    enc.intern_pods(pods)

    def cycle(churn=None):
        nonlocal pods
        if churn is not None:
            cache.update_node(nodes[churn])
            pods = list(pods)
            pods[0] = dataclasses.replace(pods[0])
        t = {}
        t0 = time.perf_counter()
        snap, keys = api.snapshot(cache, enc, pods, base)
        sync()
        t["snapshot_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        node = api.dispatch(snap, keys)  # ends with a synchronize
        t["dispatch_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        placed = sum(1 for i in api.readback(node) if i >= 0)
        t["readback_s"] = time.perf_counter() - t0
        t.update(mode=cache.last_snapshot_mode,
                 patch_rows=cache.last_patch_rows)
        return t, placed

    cold, _ = cycle()
    warm, placed = cycle(churn=0)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        profiled, _ = cycle(churn=1)
        window_s = time.perf_counter() - t0
    return dict({"placed": placed, "cold": cold, "warm": warm,
                 "profiled": profiled, "profiled_cycle_s": window_s},
                **device_profile(prof, window_s))


def host_ops(prof) -> int:
    """Top-level aten operations the host issued in a profiled window."""
    return sum(1 for e in prof.events() if e.name.startswith("aten::")
               and (e.cpu_parent is None
                    or not e.cpu_parent.name.startswith("aten::")))


def preempt_profile(args, device, sync, profile, acts) -> dict:
    import chip_smoke as cs
    from kubernetes_tpu_torch.sched import preemption as P

    os.environ["KTPU_OVERLOAD"] = "0"
    bound = []
    cs.serving_drain(cs.port_serving_api(device), args.nodes, args.pods,
                     keep_bound=bound)
    inner, wave, bursts = P.preempt_batch, [0], []

    def profiled(*a, **kw):
        if wave[0] != 1 or len(bursts) >= 3:
            return inner(*a, **kw)
        sync()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            res = inner(*a, **kw)
            sync()
            window_s = time.perf_counter() - t0
        bursts.append(dict({"preempt_batch_s": window_s,
                            "host_aten_ops": host_ops(prof)},
                           **device_profile(prof, window_s)))
        return res

    def on_wave(i):
        wave[0] = i + 1

    P.preempt_batch = profiled
    try:
        storm = cs.preempt_storm(cs.port_serving_api(device), args.nodes,
                                 bound, n_pods=args.pods, waves=2,
                                 on_wave=on_wave)
    finally:
        P.preempt_batch = inner
    if not bursts:
        raise SystemExit("torch_cycle_profile: wave 1 ran no preemption burst")
    return dict(bursts[0], storm_waves=storm["waves"], bursts=bursts)


def runs_profile(args, device, sync, profile, acts) -> dict:
    from kubernetes_tpu_torch import BatchScheduler
    from kubernetes_tpu_torch.models.workloads import (deployment_backlog_pods,
                                                       make_nodes)
    from kubernetes_tpu_torch.ops import runs as R

    os.environ["KTPU_ASSIGN"] = "runs"
    nodes = make_nodes(args.nodes)
    pods = deployment_backlog_pods(args.pods, deployments=200)
    sched = BatchScheduler(device=device)
    sched.schedule(nodes, [], pods)
    sync()
    inner, runs, profiled = R._closed_run, [], []

    def timed(*a, **kw):
        i = len(runs)
        e0 = R.assign_runs.stats["epochs"]
        sync()
        t0 = time.perf_counter()
        if 100 <= i < 103:
            with profile(activities=acts) as prof:
                out = inner(*a, **kw)
                sync()
        else:
            out = inner(*a, **kw)
            sync()
        dt = time.perf_counter() - t0
        epochs = R.assign_runs.stats["epochs"] - e0
        runs.append((dt, epochs))
        if 100 <= i < 103:
            top = sorted(prof.key_averages(), key=lambda k: -k.self_cpu_time_total)
            profiled.append(dict(
                {"run": i, "run_s": dt, "epochs": epochs,
                 "host_aten_ops": host_ops(prof),
                 "top_host_ops": [{"name": k.key, "count": k.count,
                                   "self_cpu_ms": k.self_cpu_time_total / 1e3}
                                  for k in top[:8]]},
                **device_profile(prof, dt)))
        return out

    R._closed_run = timed
    try:
        t0 = time.perf_counter()
        sched.schedule(nodes, [], pods)
        sync()
        warm_s = time.perf_counter() - t0
    finally:
        R._closed_run = inner
    run_s = sum(dt for dt, _ in runs)
    epochs = sum(e for _, e in runs)
    return dict(profiled[0], warm_cycle_s=warm_s, closed_runs=len(runs),
                closed_runs_s=run_s, cycle_epochs=epochs,
                s_per_epoch=run_s / max(epochs, 1), profiled_runs=profiled)


def resilience_profile(args, device, sync, profile, acts) -> dict:
    import gc

    import chip_smoke

    os.environ["KTPU_OVERLOAD"] = "0"
    gc_s = [0.0]
    t_gc = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            t_gc[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - t_gc[0]

    gc.callbacks.append(on_gc)

    def inline(sup):
        def submit(kind, key, fn, fallback=None):
            out = fn()
            return type("Done", (), {"result": staticmethod(lambda: out)})()
        sup.submit = submit

    variants = {
        "default": (False, True, False),
        "prewarm": (True, True, False),
        "inline": (False, True, True),
        "no-telemetry": (False, False, False),
        "bare": (False, False, True),
    }
    order = list(variants) + list(reversed(variants))
    runs = {v: [] for v in variants}
    ref = None
    if (args.nodes, args.pods) == (chip_smoke.SERVING_NODES,
                                   chip_smoke.SERVING_PODS):
        ref = (chip_smoke.JAX_DRAIN["bound"],
               chip_smoke.JAX_DRAIN["bound_sha256"])
    for name in order:
        prewarm, telemetry, on_caller = variants[name]
        api = chip_smoke.port_serving_api(device)
        make = api.scheduler
        spent = [0.0]

        def scheduler(**kw):
            if not telemetry:
                os.environ["KTPU_TELEMETRY"] = "0"
            try:
                s = make(**kw)
            finally:
                os.environ.pop("KTPU_TELEMETRY", None)
            s.prewarmer.enabled = prewarm
            if on_caller:
                inline(s.supervisor)
            inner = s.schedule_pending

            def timed(*a, **k):
                t0 = time.perf_counter()
                try:
                    return inner(*a, **k)
                finally:
                    spent[0] += time.perf_counter() - t0
            s.schedule_pending = timed
            return s

        api.scheduler = scheduler
        gc_s[0] = 0.0
        t0 = time.perf_counter()
        drain = chip_smoke.serving_drain(api, args.nodes, args.pods)
        wall = time.perf_counter() - t0
        chip_smoke.settle(api, name, prewarm_ok=prewarm)
        got = (drain["bound"], drain["bound_sha256"])
        if ref is None:
            ref = got
        if got != ref:
            raise SystemExit(f"{name}: the drain differs from the first "
                             f"run's (5b's at chip_smoke.py's size)")
        runs[name].append(dict(sched_s=spent[0],
                               pods_per_s=drain["bound"] / spent[0],
                               wall_s=wall, gc_s=gc_s[0]))
        print(f"  {name:13s} {spent[0]:.3f} s in schedule_pending "
              f"({drain['bound'] / spent[0]:.1f} pods/s), {wall:.3f} s "
              f"with the informer events, gc {gc_s[0]:.3f} s")
    gc.callbacks.remove(on_gc)
    return {"variants": runs, "top_device_ops": []}


def mesh_profile(args, device, sync, profile, acts) -> dict:
    from kubernetes_tpu_torch.models.workloads import flagship_pods, make_nodes
    from kubernetes_tpu_torch.parallel import axis
    from kubernetes_tpu_torch.parallel.mesh import (make_mesh,
                                                    pad_node_tables,
                                                    shard_tables)
    from kubernetes_tpu_torch.sched.cycle import (UNSCHEDULABLE_TAINT_KEY,
                                                  schedule_batch)
    from kubernetes_tpu_torch.state.arrays import tables_to_torch
    from kubernetes_tpu_torch.state.encode import Encoder

    enc = Encoder()
    enc.vocabs.label_keys.intern(UNSCHEDULABLE_TAINT_KEY)
    enc.vocabs.label_vals.intern("")
    keys = (enc.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY),
            enc.vocabs.label_vals.get(""))
    tables, ex, pe, d = enc.encode_cluster(make_nodes(args.nodes), [],
                                           flagship_pods(args.pods))
    tt, (ext, pet) = tables_to_torch(tables, (ex, pe), device)
    tt = pad_node_tables(tt, args.shards)
    st = shard_tables(tt, make_mesh(args.shards,
                                    devices=[device] * args.shards))
    out, nodes = {}, {}
    for name, t in (("unsharded", tt), ("sharded", st)):
        schedule_batch(t, pet, keys, d.D, ext)   # warm
        sync()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            res = schedule_batch(t, pet, keys, d.D, ext)
            sync()
            window_s = time.perf_counter() - t0
        nodes[name] = res.node.cpu()
        out[name] = dict({"cycle_s": window_s},
                         **device_profile(prof, window_s))
        if name == "sharded":
            out[name]["collectives"] = dict(axis.LAST_RUN)
    if not bool((nodes["unsharded"] == nodes["sharded"]).all()):
        raise SystemExit("torch_cycle_profile: the sharded cycle's "
                         "placements differ from the unsharded one's")
    top = out["sharded"].pop("top_device_ops")
    return dict(out, shards=args.shards,
                placed=int((nodes["sharded"] >= 0).sum()),
                top_device_ops=top)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=50000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mode", choices=("batch", "serving", "preempt",
                                       "runs", "resilience", "mesh"),
                    default="batch")
    ap.add_argument("--shards", type=int, default=4,
                    help="--mode mesh: the mesh's shards on the device")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_cycle_profile: no CUDA device", file=sys.stderr)
        return 2
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    run = {"batch": batch_profile, "serving": serving_profile,
           "preempt": preempt_profile, "runs": runs_profile,
           "resilience": resilience_profile,
           "mesh": mesh_profile}[args.mode]
    body = run(args, device, sync, profile, acts)
    out = dict({"mode": args.mode,
                "device": (torch.cuda.get_device_name(0)
                           if device.type == "cuda" else "cpu"),
                "nodes": args.nodes, "pods": args.pods}, **body)
    for row in out["top_device_ops"]:
        print(f"  {row['ms']:9.3f} ms  {row['count']:5d}x  {row['name']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
