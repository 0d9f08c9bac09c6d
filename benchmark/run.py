"""Run one cell of the benchmark and print its result as the last line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU. The cell
(configuration and traffic mix) is read from BENCHMARK.json by name. With
--trace 0 the metrics are the cell's end-to-end ones, with --trace 1 its
per-layer ones (a profiled stretch of the window). Every run checks the
scheduler's placements against the plain reference (reference.py) and
prints each number it compared beside its limit, as the last lines on
standard error and under "checks" in the result. The run's event log and
per-wave records go to benchmark_out/<workload>-<seed>-<trace>/ in the
checkout.

Exits 2 without a result when there is no CUDA device, and 3 when a module
of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()


def _probe() -> float:
    """Seconds a fixed piece of pure-Python work takes in a fresh process:
    the host's speed at the start, read beside the run's numbers."""
    t = time.perf_counter()
    d = {i: i * 3 for i in range(200_000)}
    sum(v for v in d.values() if v & 1)
    return time.perf_counter() - t


PROBE_START_S = _probe()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
T0_ENV = "BENCHMARK_PROCESS_T0"


def _environment(config: dict) -> None:
    """Run under the configuration's environment: its variables set, no
    other KTPU_* variable. Re-executes the interpreter once if that changes
    anything (PYTHONHASHSEED takes effect only at start); set-up is timed
    from the first start."""
    want = {k: str(v) for k, v in config.get("env", {}).items()}
    extra = [k for k in os.environ if k.startswith("KTPU_") and k not in want]
    if all(os.environ.get(k) == v for k, v in want.items()) and not extra:
        return
    env = {k: v for k, v in os.environ.items() if k not in extra}
    env.update(want)
    env[T0_ENV] = repr(T_PROCESS)
    os.execve(sys.executable, [sys.executable] + sys.argv, env)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_process = float(os.environ.get(T0_ENV, T_PROCESS))

    sys.path.insert(0, str(ROOT))
    from benchmark import traffic

    cell, config, mix = traffic.load_cell(ROOT, args.workload)
    _environment(config)

    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2

    from benchmark import harness

    out_dir = ROOT / "benchmark_out" / \
        f"{args.workload}-{args.seed}-{args.trace}"
    try:
        result = harness.run_cell(ROOT, args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  device="cuda", t_process=t_process,
                                  config=config, mix=mix,
                                  log_dir=out_dir)
    except harness.ForbiddenModules as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    info = result.pop("_info")
    info["host_probe_start_s"] = PROBE_START_S
    print(json.dumps(info), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
