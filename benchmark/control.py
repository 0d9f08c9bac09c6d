"""The check's control and planted faults, on the card at a cell's own
size. Per seed: a run of the cell (a short window); then the control — the
reference with its Score left out, which breaks the guarantee that a pod
goes where Score puts it — in the program's place: its placements, wave by
wave over the same pods and deletions, go through the harness's own
comparison with the reference, exactly as the program's do. Beside it the
same for the reference with its Score in bfloat16, the precision below the
program's float32 (a reading: see PERF.md). Then, with `--faults`, a run
of the cell with each fault of faults.py planted in the program.

    python3 benchmark/control.py --workload flagship-backlog \
        --seeds 11,12,13 --seconds 10 --faults unchanged_snapshot

Prints a line per seed: the program's numbers, the control's and each
fault's, each beside its limit, and whether each came out correct. Not one
of the benchmark's runs: it sets the upper readings that the limits lie
below.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_log(run_log: dict, placed) -> dict:
    """The control in the program's place: per wave the same pods, bound
    where the control puts them (in queue order: priority desc, creation
    asc), the rest left unschedulable."""
    waves = []
    for w, res in zip(run_log["waves"], placed):
        bound = [[p, res[p]] for p in w["members"] if res.get(p, -1) >= 0]
        waves.append({"members": w["members"], "bound": bound,
                      "failed": [p for p in w["members"]
                                 if res.get(p, -1) < 0],
                      "deleted": w["deleted"]})
    return {"group": run_log["group"], "fill": run_log["fill"],
            "waves": waves}


def _verdict(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness, traffic
    from benchmark.run import _environment

    cell, config, mix = traffic.load_cell(ROOT, args.workload)
    _environment(config)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from benchmark import faults, reference

    for seed in (int(s) for s in args.seeds.split(",")):
        captured = {}
        orig = harness.compare

        def grab(run_log, cl, ref, lost, _orig=orig):
            captured.update(log=run_log, cluster=cl, ref=ref)
            return _orig(run_log, cl, ref, lost)

        harness.compare = grab
        try:
            r = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                                 False, device="cuda", config=config,
                                 mix=mix)
        finally:
            harness.compare = orig
        line = {
            "workload": args.workload, "seed": seed,
            "waves": len(captured["log"]["waves"]),
            "pods_placed": sum(len(w["bound"])
                               for w in captured["log"]["waves"]),
            "program": {"correct": r["correct"], "checks": r["checks"]}}
        for name, kw in (("control_unscored", {"scored": False}),
                         ("precision_bfloat16", {"fdtype": torch.bfloat16})):
            t = time.perf_counter()
            placed = reference.replay(captured["cluster"], captured["log"],
                                      device="cuda", **kw)
            ctl_s = time.perf_counter() - t
            checks = harness.compare(control_log(captured["log"], placed),
                                     captured["cluster"], captured["ref"], 0)
            line[name] = {"correct": _verdict(checks), "checks": checks,
                          "seconds": ctl_s}
        for name in filter(None, args.faults.split(",")):
            with faults.planted(name):
                rf = harness.run_cell(ROOT, args.workload, seed,
                                      args.seconds, False, device="cuda",
                                      config=config, mix=mix)
            line[name] = {"correct": rf["correct"], "checks": rf["checks"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
