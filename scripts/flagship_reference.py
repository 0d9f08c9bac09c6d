#!/usr/bin/env python3
"""The flagship cycle's reference result: how many pods a package places on
the flagship workload, and a hash of where.

    JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax
    python3 scripts/flagship_reference.py --package port [--device cpu]
    JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax \
        --workload ports-volumes --pods 20000

Runs `BatchScheduler.schedule` of the JAX package (`kubernetes_tpu`) or of
the PyTorch port (`kubernetes_tpu_torch`) once on make_nodes(N) ×
flagship_pods(P) (default 5,000 × 50,000), or on chip_smoke.py's
port-and-volume workload (`--workload ports-volumes`, built from the chosen
package's types), and prints one JSON line:
placed and unschedulable counts, seconds, and the sha256 over the
assignments (one node name, or "-", per pending pod, joined by newlines) —
the constants `chip_smoke.py` holds the card's run against.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--device", default="cpu",
                    help="the port's device (ignored for --package jax)")
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=50000)
    ap.add_argument("--workload", choices=("flagship", "ports-volumes"),
                    default="flagship")
    args = ap.parse_args()
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
