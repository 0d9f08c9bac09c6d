"""The fleet grid's host layouts, timed on one card: one tick of the runs
engine's tenants (phase 18a's hardest group) under each way of running a
4 × 2 tenant × node-shard grid's positions.

    python3 scripts/fleet_grid_layouts.py [--tenants 4] [--pods 400]

Tenants t01, t04, … (chip_smoke.fleet_engine gives them the runs engine,
one a tenant row) of make_nodes(chip_smoke.FLEET_NODES) and `--pods` pods
each tick once through FleetServer:

  * single     — no mesh, one device;
  * in-turn    — the grid over 8 × cuda:0 as parallel/axis.py spmd_grid
                 runs it: the rows one after another, each row's two
                 shards at once;
  * at-once    — the same grid with all 8 positions at once, each row
                 still its own collective group (the layout spmd_grid
                 replaced);
  * at-once+si — at-once under sys.setswitchinterval(1e-4).

Prints one JSON line: per layout the tick's seconds and each tenant's
placement sha256 (every layout must bind alike), with the card's name
and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def at_once(rows, offsets, n_global, fn):
    """Every position of the grid in its own thread at once, a collective
    group per row."""
    from kubernetes_tpu_torch.parallel import axis

    kn = len(rows[0])
    groups = [axis._Group(kn) for _ in rows]
    axes = [axis.ShardAxis(groups[r], s, offsets, n_global, row)
            for r, row in enumerate(rows) for s in range(kn)]
    flat = axis._run(axes, groups, lambda i: fn(i // kn, i % kn))
    return [flat[r * kn:(r + 1) * kn] for r in range(len(rows))]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--pods", type=int, default=400)
    args = ap.parse_args()
    os.environ["KTPU_OVERLOAD"] = "0"
    import torch

    if not torch.cuda.is_available():
        print("fleet_grid_layouts: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import axis

    K.build()
    dev = torch.device("cuda", 0)
    C.FLEET_PODS, C.FLEET_MAX_TICKS = args.pods, 1
    names = [f"t{3 * k + 1:02d}" for k in range(args.tenants)]
    in_turn = axis.spmd_grid
    out = {"card": C.card_line(), "tenants": names, "pods": args.pods,
           "nodes": C.FLEET_NODES}
    for layout in ("single", "in-turn", "at-once", "at-once+si"):
        api = C.port_fleet_api(dev)
        kw = {} if layout == "single" else dict(
            mesh=8, node_shards=2, mesh_devices=[dev] * 8)
        axis.spmd_grid = at_once if layout.startswith("at-once") \
            else in_turn
        si = sys.getswitchinterval()
        if layout.endswith("+si"):
            sys.setswitchinterval(1e-4)
        try:
            run = C.fleet_run(api, names=names, fleet_kw=kw)
        finally:
            sys.setswitchinterval(si)
            axis.spmd_grid = in_turn
        out[layout] = dict(
            tick_s=run["ticks"][0].tick_seconds,
            scheduled=run["scheduled"],
            sha256={n: v["sha256"] for n, v in run["tenants"].items()})
    out["bind_alike"] = len({json.dumps(out[k]["sha256"], sort_keys=True)
                             for k in ("single", "in-turn", "at-once",
                                       "at-once+si")}) == 1
    print(json.dumps(out))
    return 0 if out["bind_alike"] else 1


if __name__ == "__main__":
    sys.exit(main())
