"""One run of one cell: set-up, the measured window, the check.

The system under test is kubernetes_tpu_torch's serving scheduler
(`sched.scheduler.Scheduler`). The harness feeds it cluster events
(`on_node_add`, `on_pod_add`, `on_pod_delete`) and calls `schedule_pending`
wave after wave; its binder records every (pod, node) with the time on the
harness's clock. Set-up: the nodes, then the pods the cluster holds bound
(delivered as bound pods, as an informer hands them to a scheduler that
starts on a full cluster), then warm-up waves of the cell's own traffic.
The window then runs the mix for `seconds`, as the mix's driver
(drivers/<kind>.py) feeds it; a backlog mix is a closed loop that tops the
pending pods up to the mix's `pending` before every wave.

After every wave the harness confirms each binding to the scheduler, as an
informer delivers the bound pod (`on_pod_add` of the pod with its node),
and each new binding deletes the oldest bound pod while the cluster holds
more than the configuration's occupancy.

Every wave's pods, bindings, unschedulable pods and the deletions after it
go to the run's log; once the window has closed and the scheduler is freed,
the reference (reference.py) replays the log on its own state and the check
compares, pod by pod, where the scheduler bound each pod with where the
reference places it.
"""

from __future__ import annotations

import collections
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from . import traffic
from .traffic import Cluster, GroupSequence

ROOT = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "kubernetes_tpu")


class RecordingBinder:
    """The scheduler's binder: records (pod id, node index, time) per bind."""

    def __init__(self, node_index: Dict[str, int], clock) -> None:
        self.node_index = node_index
        self.clock = clock
        self.binds: List[tuple] = []

    def bind(self, pod, node_name: str) -> bool:
        self.binds.append((int(pod.name[1:]), self.node_index[node_name],
                           self.clock()))
        return True


class GcClock:
    """Seconds the interpreter's garbage collector ran, and its full
    collections, counted through gc.callbacks."""

    def __init__(self, clock) -> None:
        self.clock = clock
        self.s = 0.0
        self.full = 0
        self._t = None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info) -> None:
        if phase == "start":
            self._t = self.clock()
        elif self._t is not None:
            self.s += self.clock() - self._t
            self.full += info["generation"] == 2
            self._t = None

    def close(self) -> None:
        if self._cb in gc.callbacks:
            gc.callbacks.remove(self._cb)


def host_probe() -> float:
    """Seconds a fixed piece of pure-Python work takes, best of three: the
    host's speed at the time, read beside the run's own numbers."""
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        d = {i: i * 3 for i in range(200_000)}
        sum(v for v in d.values() if v & 1)
        best = min(best, time.perf_counter() - t)
    return best


def host_counters() -> dict:
    """The process's CPU seconds, the host's 1-minute load and its CPU
    jiffies (all, and stolen by the hypervisor) from /proc, where there is
    one: read at the window's ends, they show whether the host held the
    run back."""
    out = {"cpu_s": time.process_time(), "wall_s": time.perf_counter()}
    try:
        with open("/proc/loadavg") as f:
            out["load1"] = float(f.read().split()[0])
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
        out["jiffies"] = sum(v[:8])
        out["steal"] = v[7] if len(v) > 7 else 0
    except (OSError, ValueError, IndexError):
        pass
    return out


def host_share(a: dict, b: dict) -> dict:
    """What the host gave the run between two readings of host_counters."""
    wall = b["wall_s"] - a["wall_s"]
    out = {"cpu_share": (b["cpu_s"] - a["cpu_s"]) / wall if wall > 0 else 0}
    if "jiffies" in a and "jiffies" in b:
        j = b["jiffies"] - a["jiffies"]
        out["steal_share"] = (b["steal"] - a["steal"]) / j if j > 0 else 0
        out["load1"] = [a["load1"], b["load1"]]
    return out


class PodFactory:
    """Plain groups → the scheduler's api.types, one shared spec a group."""

    def __init__(self, cluster: Cluster) -> None:
        from kubernetes_tpu_torch.api.types import (
            Affinity, LabelSelector, PodAffinityTerm, Resources,
            TopologySpreadConstraint, UnsatisfiableAction)

        keys = traffic.TOPOLOGY_KEYS
        self.specs = []
        for g in cluster.groups:
            sel = LabelSelector.of(match_labels={"app": f"app-{g.index}"})
            spread = ()
            if g.spread:
                spread = (TopologySpreadConstraint(
                    max_skew=g.spread[1], topology_key=keys[g.spread[0]],
                    when_unsatisfiable=UnsatisfiableAction.DO_NOT_SCHEDULE,
                    selector=sel),)
            anti = (PodAffinityTerm(selector=sel,
                                    topology_key=keys[g.anti]),) \
                if g.anti else ()
            aff = ()
            if g.affinity:
                partner = LabelSelector.of(
                    match_labels={"app": f"app-{g.affinity[1]}"})
                aff = (PodAffinityTerm(selector=partner,
                                       topology_key=keys[g.affinity[0]]),)
            self.specs.append(dict(
                labels={"app": f"app-{g.index}"} if g.labelled else {},
                requests=Resources.make(cpu=f"{g.cpu_milli}m",
                                        memory=f"{g.mem_kib}Ki"),
                affinity=Affinity(pod_required=aff, anti_required=anti),
                topology_spread=spread, priority=g.priority))
        from kubernetes_tpu_torch.api.types import Pod

        self.Pod = Pod

    def make(self, pid: int, group: int, node_name: str = ""):
        s = self.specs[group]
        return self.Pod(name=f"p{pid}", labels=s["labels"],
                        requests=s["requests"], affinity=s["affinity"],
                        topology_spread=s["topology_spread"],
                        priority=s["priority"], creation_index=pid,
                        node_name=node_name)


def make_nodes(cluster: Cluster):
    """The configuration's node template, labelled with its zone and
    hostname."""
    from kubernetes_tpu_torch.api.types import Node, Resources

    keys = traffic.TOPOLOGY_KEYS
    alloc = Resources.make(cpu=f"{cluster.cpu_milli}m",
                           memory=f"{cluster.mem_kib}Ki",
                           pods=cluster.pods_cap)
    return [Node(name=f"node-{n}", labels={
        keys["zone"]: cluster.zones[cluster.node_zone(n)],
        keys["hostname"]: f"node-{n}"}, allocatable=alloc)
        for n in range(cluster.nodes)]


class Run:
    """The state of one run: the scheduler, the pods it was given, the log."""

    def __init__(self, cluster: Cluster, config: dict, seed: int,
                 device: str, clock=time.perf_counter) -> None:
        from kubernetes_tpu_torch.sched.scheduler import Scheduler

        self.cluster = cluster
        self.clock = clock
        nodes = make_nodes(cluster)
        self.node_names = [n.name for n in nodes]
        self.binder = RecordingBinder(
            {nm: i for i, nm in enumerate(self.node_names)}, clock)
        sc = config["scheduler"]
        self.sched = Scheduler(binder=self.binder, device=device,
                               batch_size=int(sc["batch_size"]),
                               prewarm=bool(sc["prewarm"]),
                               microwave=bool(sc["microwave"]))
        self.factory = PodFactory(cluster)
        self.groups = GroupSequence(len(cluster.groups), seed)
        self.group_of: List[int] = []     # pod id → group
        self.live: Dict[int, object] = {}  # pending or bound pods by id
        self.bound = collections.deque()   # bound pod ids, oldest first
        self.n_bound = 0
        self.node_of: Dict[int, int] = {}  # pod id → node it was bound to
        self.waves: List[dict] = []
        self.fill: List[list] = []
        for node in nodes:
            self.sched.on_node_add(node)
        for pid, (g, n) in enumerate(traffic.fill_placement(cluster)):
            pod = self.factory.make(pid, g, self.node_names[n])
            self.group_of.append(g)
            self.live[pid] = pod
            self.bound.append(pid)
            self.fill.append([pid, n])
            self.sched.on_pod_add(pod)
        self.pending = 0
        self.gc = GcClock(clock)
        self._gc_seen = (0.0, 0)
        # seconds inside the scheduler's event handlers (on_pod_add,
        # on_pod_delete) since the last logged wave
        self.events_s = 0.0

    def add_fresh(self, n: int) -> List[int]:
        """n fresh pods of the mix's groups, added to the scheduler."""
        ids = []
        for g in self.groups.take(n):
            pid = len(self.group_of)
            self.group_of.append(g)
            pod = self.factory.make(pid, g)
            self.live[pid] = pod
            t = self.clock()
            self.sched.on_pod_add(pod)
            self.events_s += self.clock() - t
            ids.append(pid)
        self.pending += n
        return ids

    def wave(self) -> Optional[dict]:
        """One schedule_pending call; logs it if it held pods. Deletes the
        oldest bound pods past the occupancy afterwards."""
        b0 = len(self.binder.binds)
        rec0 = self.sched.telemetry.recorder.records()
        last = rec0[-1] if rec0 else None
        t0 = self.clock()
        stats = self.sched.schedule_pending()
        t1 = self.clock()
        binds = self.binder.binds[b0:]
        members = list(stats.assignments) + list(stats.failed_keys)
        if not members and not binds:
            return None
        recs = self.sched.telemetry.recorder.records()
        record = recs[-1] if recs and recs[-1] is not last else None
        te = self.clock()
        for pid, n, _ in binds:
            self.bound.append(pid)
            self.node_of[pid] = n
            # the informer's confirmation of the binding
            pod = self.live[pid]
            pod.node_name = self.node_names[n]
            self.sched.on_pod_add(pod)
        self.n_bound += len(binds)
        self.pending -= len(binds)
        deleted = []
        while len(self.bound) > self.cluster.occupancy:
            pid = self.bound.popleft()
            self.sched.on_pod_delete(self.live.pop(pid))
            deleted.append(pid)
        t2 = self.clock()
        self.events_s += t2 - te
        events_s, self.events_s = self.events_s, 0.0
        gc_s, gc_full = (self.gc.s - self._gc_seen[0],
                         self.gc.full - self._gc_seen[1])
        self._gc_seen = (self.gc.s, self.gc.full)
        w = {"members": [int(k.split("/p", 1)[1]) for k in members],
             "bound": [[pid, n] for pid, n, _ in binds],
             "failed": [int(k.split("/p", 1)[1])
                        for k in stats.failed_keys],
             "deleted": deleted, "t0": t0, "t1": t1, "t2": t2,
             "events_s": events_s, "gc_s": gc_s, "gc_full": gc_full,
             "attempted": stats.attempted, "aborted": stats.aborted,
             "requeued": stats.requeued, "bind_errors": stats.bind_errors,
             "record": record}
        self.waves.append(w)
        return w

    def log(self) -> dict:
        return {"group": self.group_of, "fill": self.fill,
                "waves": [{k: w[k] for k in ("members", "bound", "failed",
                                             "deleted")}
                          for w in self.waves]}


def _load(folder: str, name: str):
    path = ROOT / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_reader(name: str):
    """The reader of a per-layer or end-to-end metric: metrics/<name>.py."""
    return _load("metrics", name).read


def _load_driver(kind: str):
    """The driver of a kind of traffic mix: drivers/<kind>.py."""
    return _load("drivers", kind).drive


class Profiled:
    """The traced stretch of a `--trace 1` run: torch.profiler over a few
    waves of the window, the K1/K2 launches' shapes recorded around the
    program's calls, and the host's own ranges to name the idle gaps."""

    def __init__(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        import kubernetes_tpu_torch.ops.waves as W

        self.torch = torch
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.active = False
        self.k1: List[tuple] = []
        self.k2: List[tuple] = []
        self.W = W
        self._orig = (W.contention_scan, W.domain_rank)
        k1, k2 = self._orig

        def shapes(ts):
            return [(tuple(t.shape), t.element_size()) for t in ts]

        def contention_scan(*args):
            out = k1(*args)
            if self.active:
                keep, words = out
                self.k1.append((shapes(args), shapes((keep,) + tuple(words))))
            return out

        def domain_rank(dom, num_domains):
            out = k2(dom, num_domains)
            if self.active:
                self.k2.append((tuple(dom.shape), dom.element_size()))
            return out

        W.contention_scan, W.domain_rank = contention_scan, domain_rank
        self.waves: List[dict] = []

    def start(self) -> None:
        self.prof.start()
        self.active = True
        self.range = self.torch.profiler.record_function("bench.stretch")
        self.range.__enter__()

    def stop(self) -> None:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.range.__exit__(None, None, None)
        self.active = False
        self.prof.stop()
        self.W.contention_scan, self.W.domain_rank = self._orig

    def summary(self) -> dict:
        """busy and window seconds, K1/K2 device time against the bound,
        the top device operations and the idle gaps named by the host's
        activity."""
        from torch.autograd import DeviceType

        from . import yardstick as Y

        evs = self.prof.events()
        stretch = [e for e in evs if e.name == "bench.stretch"]
        lo, hi = stretch[0].time_range.start, stretch[0].time_range.end
        dev = [(e.name, e.time_range.start, e.time_range.end) for e in evs
               if e.device_type == DeviceType.CUDA
               and not e.name.startswith("bench.")
               and e.time_range.end > lo and e.time_range.start < hi]
        iv = [(max(s, lo), min(e, hi)) for _, s, e in dev]
        busy = Y.union_length(iv)
        by_name: Dict[str, float] = {}
        for n, s, e in dev:
            by_name[n] = by_name.get(n, 0.0) + (min(e, hi) - max(s, lo))
        # host activity: the harness's ranges and each traced wave's phases
        host = []
        for e in evs:
            if e.name in ("bench.feed", "bench.delete"):
                host.append((e.time_range.start, e.time_range.end,
                             "harness." + e.name.split(".")[1]))
        wave_ranges = sorted((e.time_range.start, e.time_range.end)
                             for e in evs if e.name == "bench.wave")
        for (ws, we), w in zip(wave_ranges, self.waves):
            rec = w.get("record")
            if not rec:
                host.append((ws, we, "wave"))
                continue
            off = ws + (rec["t_start"] - w["t0"]) * 1e6
            cur = off
            for name, dt in rec["phases"]:
                host.append((cur, cur + dt * 1e6, "wave." + name))
                cur += dt * 1e6
            # after the wave: the bindings' confirmations and the deletions
            host.append((cur, we, "harness.events"))
        idle: Dict[str, float] = {}
        for s, e in Y.gaps(iv, lo, hi):
            mid = (s + e) / 2
            name = next((nm for hs, he, nm in host if hs <= mid < he),
                        "harness.other")
            idle[name] = idle.get(name, 0.0) + (e - s)

        def kernel(sub, counts):
            times = [e - s for n, s, e in dev if sub in n]
            if not times or not counts:
                return None
            bound = sum(Y.bound_s(*c) for c in counts) / len(counts)
            return {"bound_s": bound,
                    "device_s": sum(times) / len(times) / 1e6,
                    "events": len(times), "launches": len(counts)}

        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        top = [(n if len(n) <= 120 else n[:117] + "...", t) for n, t in top]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {
            "window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
            "k1": kernel("contention_scan", [Y.k1_counts(a, o)
                                             for a, o in self.k1]),
            "k2": kernel("domain_rank", [Y.k2_counts(d) for d in self.k2]),
            "device_ops": [[n, t / 1e6] for n, t in top],
            "idle_gaps": [[n, t / 1e6] for n, t in gaps],
        }


def window(run: Run, mix: dict, seconds: float, trace: bool, ctx: dict,
           feed) -> None:
    """The measured window: `feed` (which adds what the mix has due) before
    every wave, until `seconds` have passed. With `trace`, the profiled
    stretch of the mix's waves."""
    import torch

    prof = Profiled() if trace else None
    skip = int(mix["trace_skip_waves"])
    n_trace = int(mix["trace_waves"])
    if (ctx.get("gc") or {}).get("freeze_after_setup"):
        # the set-up's objects (nodes, the bound pods, the scheduler's
        # caches) leave the collector's generations for good
        gc.collect()
        gc.freeze()
    ctx["setup_end"] = time.time()
    host0 = host_counters()
    t0 = run.clock()
    ctx["t_window"] = t0
    t_end = t0 + seconds
    first = len(run.waves)
    traced = 0
    while run.clock() < t_end:
        in_trace = prof is not None and skip <= len(run.waves) - first \
            and traced < n_trace
        if in_trace and not prof.active and traced == 0:
            prof.start()
        rf = torch.profiler.record_function if in_trace else None
        if rf:
            with rf("bench.feed"):
                feed()
        else:
            feed()
        if rf:
            with rf("bench.wave"):
                w = run.wave()
        else:
            w = run.wave()
        if w is not None:
            w["traced"] = bool(in_trace)
            if in_trace:
                prof.waves.append(w)
                traced += 1
                if traced == n_trace:
                    prof.stop()
    # the window closes with the wave in flight at t_end: its work and its
    # time both count
    ctx["t_close"] = run.clock()
    ctx["host"] = host_share(host0, host_counters())
    if prof is not None and prof.active:
        prof.stop()
    ctx["t_end"] = t_end
    ctx["window_waves"] = run.waves[first:]
    ctx["profile"] = prof.summary() if prof is not None and prof.waves \
        else None


def check_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark must not load."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def compare(run_log: dict, cluster: Cluster, ref: List[Dict[int, int]],
            lost: int) -> Dict[str, dict]:
    """The numbers the check compares, each with its limit."""
    mismatched = order_errors = double = 0
    seen = set()
    for w, r in zip(run_log["waves"], ref):
        got = {p: -1 for p in w["failed"]}
        for p, n in w["bound"]:
            got[p] = n
            if p in seen:
                double += 1
            seen.add(p)
        for p in w["members"]:
            if got.get(p, -2) != r.get(p, -3):
                mismatched += 1
        expect = sorted((p for p in w["members"] if r.get(p, -1) >= 0),
                        key=lambda p: (-cluster.groups[run_log["group"][p]]
                                       .priority, p))
        seq = [p for p, _ in w["bound"]]
        if seq != expect:
            order_errors += sum(1 for a, b in zip(seq, expect) if a != b) \
                + abs(len(seq) - len(expect))
    return {
        "mismatched_pods": {"value": mismatched, "limit": 0},
        "order_errors": {"value": order_errors, "limit": 0},
        "double_binds": {"value": double, "limit": 0},
        "lost_pods": {"value": lost, "limit": 0},
    }


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_process: float = None,
             config: dict = None, mix: dict = None,
             log_dir: Optional[Path] = None) -> dict:
    """One run. Returns the result object (the last line the command
    prints); writes the run's log and per-wave records under `log_dir`."""
    t_process = time.time() if t_process is None else t_process
    bench = traffic.load_benchmark(root)
    if config is None or mix is None:
        _, config, mix = traffic.load_cell(root, workload)
    import torch

    parts = {"import": time.time() - t_process}
    dev = torch.device(device)
    if dev.type == "cuda":
        from kubernetes_tpu_torch.ops import kernels as K

        t = time.time()
        torch.zeros(1, device=dev)
        parts["cuda_context"] = time.time() - t
        t = time.time()
        K.build()
        parts["kernel_build"] = time.time() - t
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.time()
    cluster = traffic.build_cluster(config)
    run = Run(cluster, config, seed, device)
    parts["nodes_and_fill"] = time.time() - t
    ctx: Dict[str, object] = {"traffic": mix["kind"], "setup_parts": parts,
                              "gc": config.get("gc")}
    _load_driver(mix["kind"])(run, mix, seconds, trace, ctx, seed)
    ctx["setup_s"] = ctx["setup_end"] - t_process
    probe_s = host_probe()
    t_end = ctx["t_end"]
    ctx["binds"] = run.binder.binds
    win = ctx["window_waves"]

    # what is still pending must still be queued
    bound_ids = set(run.node_of)
    lost = sum(1 for pid, pod in run.live.items()
               if pid not in bound_ids and not pod.node_name
               and run.sched.queue.get_pod(pod.key) is None)
    mem_peak = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    metrics = {}
    for m in bench["end_to_end"] + (bench["per_layer"] if trace else []):
        if "workloads" in m and workload not in m["workloads"]:
            continue
        v = _load_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if trace:
        metrics = {k: v for k, v in metrics.items()
                   if k not in {e["name"] for e in bench["end_to_end"]}}
    attempted = sum(w["attempted"] for w in win)
    errors = sum(w["aborted"] + w["bind_errors"] + w["requeued"]
                 for w in run.waves)
    log = run.log()
    if log_dir is not None:
        log_dir.mkdir(parents=True, exist_ok=True)
        with open(log_dir / "events.json", "w") as f:
            json.dump(log, f)
        with open(log_dir / "waves.jsonl", "w") as f:
            for w in run.waves:
                f.write(json.dumps({k: v for k, v in w.items()
                                    if k not in ("members", "bound",
                                                 "failed", "deleted")}
                                   | {"members": len(w["members"]),
                                      "bound": len(w["bound"])}) + "\n")
    summary = {
        "waves": len(run.waves), "window_waves": len(win),
        "bound_in_window": sum(1 for _, _, t in run.binder.binds
                               if ctx["t_window"] <= t < ctx["t_close"]),
        "window_s": ctx["t_close"] - ctx["t_window"],
        "pods_made": len(run.group_of),
        "gc_s": sum(w["gc_s"] for w in win),
        "gc_full": sum(w["gc_full"] for w in win),
        "host_probe_s": probe_s, "host": ctx["host"],
    }
    # free the scheduler before the reference runs
    run.gc.close()
    del run
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    forbidden = check_modules()
    if forbidden:
        raise ForbiddenModules(forbidden)
    from .reference import replay

    t_ref = time.perf_counter()
    ref = replay(cluster, log, device=device)
    ref_s = time.perf_counter() - t_ref
    checks = compare(log, cluster, ref, lost)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    failed = errors + checks["mismatched_pods"]["value"] \
        + checks["lost_pods"]["value"] + checks["double_binds"]["value"]
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind, "count": 1, "memory_peak_bytes": mem_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    prof = ctx.get("profile")
    if trace and prof is not None:
        device_info["busy_s"] = prof["busy_s"]
        device_info["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = checks
    result["_info"] = dict(summary, reference_s=ref_s,
                           setup_parts=ctx.get("setup_parts"))
    return result


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__(f"loaded forbidden modules: {', '.join(names)}")
        self.names = names
