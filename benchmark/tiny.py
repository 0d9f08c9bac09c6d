"""Test-size copies of the cells: the same configuration and mix files,
scaled down so a whole run fits a CPU test (96 nodes in 4 zones, 8
namespaces, waves of 64). Only the tests use them; the benchmark runs the
files as they are."""

from __future__ import annotations

import copy
from pathlib import Path

from . import traffic

ROOT = Path(__file__).resolve().parent.parent


def tiny_cell(workload: str, nodes: int = 96, groups: int = 8):
    cell, config, mix = traffic.load_cell(ROOT, workload)
    config, mix = copy.deepcopy(config), copy.deepcopy(mix)
    config["nodes"].update(count=nodes, zones=["z0", "z1", "z2", "z3"],
                           cpu_milli=600, mem_kib=8 * 1024 * 1024, pods=20)
    config["occupancy"] = 4 * nodes
    config["namespaces"] = groups
    for t in config["templates"]:
        if "spread" in t:
            t["spread"]["max_skew"] = 2
    config["scheduler"]["batch_size"] = 64
    mix["pending"] = 200
    mix["trace_skip_waves"] = 1
    return cell, config, mix


def run_tiny(workload: str, seed: int = 5, seconds: float = 1.5,
             trace: bool = False, **kw) -> dict:
    from . import harness

    cell, config, mix = tiny_cell(workload)
    return harness.run_cell(ROOT, workload, seed, seconds, trace,
                            device="cpu", config=config, mix=mix, **kw)
