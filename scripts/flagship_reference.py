#!/usr/bin/env python3
"""The reference results chip_smoke.py holds the card's runs against: how
many pods a package places, and a hash of where.

    JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax
    python3 scripts/flagship_reference.py --package port [--device cpu]
    JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax \\
        --workload ports-volumes --pods 20000
    JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax \\
        --path serving [--pods 50000]

`--path batch` (the default) runs `BatchScheduler.schedule` of the JAX
package (`kubernetes_tpu`) or of the PyTorch port (`kubernetes_tpu_torch`)
once on make_nodes(N) × flagship_pods(P) (default 5,000 × 50,000), or on
chip_smoke.py's port-and-volume workload (`--workload ports-volumes`, built
from the chosen package's types), and prints one JSON line: placed and
unschedulable counts, seconds, and the sha256 over the assignments (one node
name, or "-", per pending pod, joined by newlines).

`--path serving` runs chip_smoke.py's phase-5 scripts through the chosen
package with the overload governor off (KTPU_OVERLOAD=0, set here): the
steady state on the resident cache (`serving_steady`, flagship 5,000 ×
50,000: per cycle the snapshot mode, rows patched, placed count and
placement sha256) and the wave loop (`serving_drain`, 5,000 nodes × `--pods`
pods in waves of 4,096: per wave the counts and snapshot mode, then the
binder's ordered (pod, node) list as a count and a sha256). It prints one
JSON line without the timings, which differ from host to host.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def jax_serving_api():
    """chip_smoke.port_serving_api's namespace, from the JAX package."""
    import types as pytypes

    import jax

    from kubernetes_tpu.api import types
    from kubernetes_tpu.models import workloads
    from kubernetes_tpu.sched.cycle import _schedule_batch, snapshot_with_keys
    from kubernetes_tpu.sched.scheduler import RecordingBinder, Scheduler
    from kubernetes_tpu.state.cache import SchedulerCache
    from kubernetes_tpu.state.dims import Dims
    from kubernetes_tpu.state.encode import Encoder

    def dispatch(snap, keys):
        res = _schedule_batch(snap.tables, snap.pending, keys, snap.dims.D,
                              snap.existing,
                              has_node_name=snap.dims.has_node_name)
        return jax.block_until_ready(res.node)

    def scheduler(**kw):
        s = Scheduler(**kw)
        s.prewarmer.enabled = False  # compile-ahead only; placements as-is
        return s

    return pytypes.SimpleNamespace(
        types=types, workloads=workloads, Dims=Dims, Encoder=Encoder,
        SchedulerCache=SchedulerCache, RecordingBinder=RecordingBinder,
        snapshot=lambda cache, enc, pods, base: snapshot_with_keys(
            cache, enc, pods, base),
        dispatch=dispatch,
        readback=lambda node: jax.device_get(node).tolist(),
        scheduler=scheduler)


def serving(args) -> dict:
    os.environ["KTPU_OVERLOAD"] = "0"
    import chip_smoke

    if args.package == "jax":
        api = jax_serving_api()
    else:
        import torch

        api = chip_smoke.port_serving_api(torch.device(args.device))
    t0 = time.perf_counter()
    steady = chip_smoke.serving_steady(api, args.nodes,
                                       chip_smoke.SERVING_STEADY_PODS)
    t1 = time.perf_counter()
    drain = chip_smoke.serving_drain(api, args.nodes, args.pods)
    t2 = time.perf_counter()
    timing = ("snapshot_s", "dispatch_s", "readback_s", "map_s")
    return {"package": args.package, "path": "serving", "nodes": args.nodes,
            "steady": [{k: v for k, v in c.items() if k not in timing}
                       for c in steady["cycles"]],
            "drain_pods": args.pods, "drain": drain,
            "steady_seconds": t1 - t0, "drain_seconds": t2 - t1}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--device", default="cpu",
                    help="the port's device (ignored for --package jax)")
    ap.add_argument("--path", choices=("batch", "serving"), default="batch")
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=None,
                    help="pending pods (default 50,000 for the batch path, "
                    "chip_smoke.SERVING_PODS for the serving drain)")
    ap.add_argument("--workload", choices=("flagship", "ports-volumes"),
                    default="flagship")
    args = ap.parse_args()
    if args.path == "serving":
        if args.pods is None:
            import chip_smoke

            args.pods = chip_smoke.SERVING_PODS
        print(json.dumps(serving(args)))
        return 0
    if args.pods is None:
        args.pods = 50000
    if args.package == "jax":
        import kubernetes_tpu as pkg
        from kubernetes_tpu.api import types
        from kubernetes_tpu.models import workloads

        sched = pkg.BatchScheduler()
    else:
        import kubernetes_tpu_torch as pkg
        from kubernetes_tpu_torch.api import types
        from kubernetes_tpu_torch.models import workloads

        sched = pkg.BatchScheduler(device=args.device)
    if args.workload == "flagship":
        nodes = workloads.make_nodes(args.nodes)
        pods = workloads.flagship_pods(args.pods)
    else:
        from chip_smoke import port_volume_workload

        nodes, pods = port_volume_workload(args.nodes, args.pods, types,
                                           workloads)
    t0 = time.perf_counter()
    res = sched.schedule(nodes, [], pods)
    seconds = time.perf_counter() - t0
    digest = hashlib.sha256(
        "\n".join(a or "-" for a in res.assignments).encode()).hexdigest()
    print(json.dumps({"package": args.package, "workload": args.workload,
                      "nodes": args.nodes,
                      "pods": args.pods, "scheduled": res.scheduled,
                      "failed": res.failed, "seconds": seconds,
                      "sha256": digest}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
