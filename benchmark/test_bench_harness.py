"""The harness end to end at test size on the CPU, the check's faults,
the metric arithmetic and BENCHMARK.json's names."""

import json
import re
from pathlib import Path

import pytest

from benchmark import faults, harness, yardstick
from benchmark.tiny import run_tiny

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", ["flagship-backlog", "density-backlog"])
def test_cell_runs_end_to_end_on_the_cpu(workload, tmp_path):
    r = run_tiny(workload, seed=2**31 + 17, log_dir=tmp_path)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"pods_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-2] == "checks"
    assert r["checks"]["mismatched_pods"] == {"value": 0, "limit": 0}
    log = json.loads((tmp_path / "events.json").read_text())
    assert log["waves"] and all(w["members"] for w in log["waves"])


@pytest.mark.parametrize("workload", ["flagship-backlog", "density-backlog"])
def test_traced_run_reports_the_per_layer_metrics(workload):
    r = run_tiny(workload, seed=3, trace=True)
    assert r["correct"]
    for m in ("queue_ms", "snapshot_ms", "dispatch_ms", "commit_ms",
              "idle_share"):
        assert f"{m}.backlog" in r["metrics"], m
    # no CUDA kernel launches on the CPU: its rooflines are left out
    assert not {"pods_per_s", "k1_roofline.backlog",
                "k2_roofline.backlog"} & set(r["metrics"])
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault,workload", [
    ("unchanged_commit", "flagship-backlog"),
    ("unchanged_snapshot", "flagship-backlog"),
    ("unchanged_snapshot", "density-backlog"),
    ("half_batch", "flagship-backlog"),
    ("one_answer", "density-backlog"),
])
def test_a_planted_fault_is_not_correct(fault, workload):
    """Each fault of faults.py, planted in the program, turns a test-size
    run's `correct` false through its placements."""
    with faults.planted(fault):
        r = run_tiny(workload, seed=21)
    assert not r["correct"]
    assert r["checks"]["mismatched_pods"]["value"] > 0


def test_idle_share_is_over_the_union_of_intervals():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert yardstick.union_length(iv) == 4.0
    assert yardstick.gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]
    from benchmark.spans import idle_pct
    ctx = {"traffic": "backlog", "profile": {"window_s": 10.0,
                                             "busy_s": 4.0}}
    assert idle_pct(ctx, "backlog") == pytest.approx(60.0)
    assert idle_pct(ctx, "stream") is None


def test_roofline_takes_the_larger_bound():
    assert yardstick.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert yardstick.bound_s(0, 67e12) == pytest.approx(1.0)
    assert yardstick.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)
    b, ops = yardstick.k2_counts(((4, 100), 8))
    assert (b, ops) == (6400, 2400)
    from benchmark.spans import roofline_pct
    ctx = {"traffic": "backlog",
           "profile": {"k1": {"bound_s": 1e-6, "device_s": 4e-6}}}
    assert roofline_pct(ctx, "backlog", "k1") == pytest.approx(25.0)
    assert roofline_pct(ctx, "backlog", "k2") is None


def test_benchmark_json_names_and_units():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]] + \
        [w["traffic"] for w in b["workloads"]] + \
        [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in b["end_to_end"]
               + b["per_layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    for w in b["workloads"]:
        assert (ROOT / "benchmark" / "mixes" / f"{w['traffic']}.json").exists()
        assert len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_forbidden_modules_are_matched_by_whole_top_level_name():
    assert "kubernetes_tpu" in harness.FORBIDDEN_MODULES
    assert "kubernetes_tpu_torch" not in harness.check_modules()
