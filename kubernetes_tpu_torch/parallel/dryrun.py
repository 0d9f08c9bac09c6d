"""Multi-device dryrun: shard the node axis of the full cycle across a mesh
and hold the sharded run bit-equal to the unsharded one at the same padded
N, at three rungs (port of the JAX package's parallel/dryrun.py):

  1. spec (max(8·n, 16) nodes × 64 flagship pods): both engines, the wave
     engine and the sequential scan;
  2. production (4,096 nodes × 8,192 flagship and gang pods): the wave
     engine inside the gang engine's rounds, with one group no node can
     hold, so the rejection rounds run too;
  3. bench (5,120 nodes × 50,000 flagship pods): the wave engine at the
     flagship width.

Each rung compares the placements, the feasibility and every plane of the
final state (and the dead groups of rung 2), and reports the scheduled
count, the node map's sha256, both runs' seconds and what the sharded run
moved across shards (parallel/axis.py LAST_RUN). The mesh is any device
list: `[torch.device("cuda", 0)] * 4` is four shards on one card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..api.types import Pod, Resources
from ..models.workloads import flagship_pods, gang_workload_pods, make_nodes
from ..ops.assign import assign_batch, initial_state
from ..ops import kernels
from ..ops.gang import assign_gang
from ..ops.waves import assign_waves
from ..sched.cycle import UNSCHEDULABLE_TAINT_KEY, _cycle
from ..state.arrays import resolve_device, tables_to_torch, to_device
from ..state.dims import Dims
from ..state.encode import Encoder
from . import axis
from .mesh import (ShardedTables, gather_state, make_mesh, memory_report,
                   pad_node_tables, replicate, shard_tables)


def _encoder() -> Encoder:
    enc = Encoder()
    enc.vocabs.label_keys.intern(UNSCHEDULABLE_TAINT_KEY)
    enc.vocabs.label_vals.intern("")
    return enc


def _keys(enc: Encoder):
    return (enc.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY),
            enc.vocabs.label_vals.get(""))


def encode_flagship(n_nodes: int, n_pods: int, device):
    """The flagship workload (zones and racks, inter-pod affinity and
    topology spread) as tensors on `device`: (tables, pending, existing,
    keys, dims)."""
    nodes = make_nodes(n_nodes, zones=min(8, n_nodes), racks_per_zone=4)
    pods = flagship_pods(n_pods, groups=min(12, n_pods))
    enc = _encoder()
    tables, ex, pe, d = enc.encode_cluster(nodes, [], pods,
                                           Dims(N=n_nodes, P=n_pods))
    tt, (ext, pet) = tables_to_torch(tables, (ex, pe), device)
    return tt, pet, ext, _keys(enc), d


def encode_mixed(n_nodes: int, n_pods: int, device):
    """Flagship pods and gang pods in one batch, plus one group of 8 no
    node can hold: (tables, pending, existing, gang, keys, dims)."""
    nodes = make_nodes(n_nodes, zones=min(8, n_nodes), racks_per_zone=4)
    half = n_pods // 2
    pods = flagship_pods(n_pods - half, groups=min(12, n_pods)) + [
        # re-indexed so the gang pods queue after the flagship half
        dataclasses.replace(p, creation_index=p.creation_index + n_pods)
        for p in gang_workload_pods(half - 8)]
    pods += [Pod(name=f"monster-w{m}", pod_group="monster", min_member=8,
                 requests=Resources.make(cpu="512", memory="1Ti"),
                 creation_index=2 * n_pods + m) for m in range(8)]
    enc = _encoder()
    tables, ex, pe, d = enc.encode_cluster(nodes, [], pods,
                                           Dims(N=n_nodes, P=n_pods))
    gang = to_device(enc.build_gang_arrays(pods, d), device)
    tt, (ext, pet) = tables_to_torch(tables, (ex, pe), device)
    return tt, pet, ext, gang, _keys(enc), d


def node_sha256(node) -> str:
    """sha256 of a node map (int32, little-endian)."""
    a = node.cpu().numpy() if isinstance(node, torch.Tensor) \
        else np.asarray(node)
    return hashlib.sha256(a.astype("<i4").tobytes()).hexdigest()


def run_cycle(tables, pending, existing, keys, D: int, engine: Callable,
              gang=None):
    """build_cycle → initial_state → `engine(tables, cyc, pending, init,
    gang)` (→ (AssignResult, extra)); on ShardedTables every shard runs it
    on its rows and the lead's result comes back, its state gathered."""
    def one(t, pe, ex, g):
        cyc = _cycle(t, ex, keys, D)
        res, extra = engine(t, cyc, pe, initial_state(t, cyc), g)
        return res._replace(state=gather_state(res.state)), extra

    if isinstance(tables, ShardedTables):
        mesh = tables.mesh
        return tables.run(one, replicate(pending, mesh),
                          replicate(existing, mesh), replicate(gang, mesh))[0]
    return one(tables, pending, existing, gang)


def waves_engine(t, cyc, pe, init, g):
    return assign_waves(t, cyc, pe, init), None


def scan_engine(t, cyc, pe, init, g):
    return assign_batch(t, cyc, pe, init), None


def gang_engine(t, cyc, pe, init, g):
    return assign_gang(t, cyc, pe, init, g)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compare(ref, got, what: str) -> None:
    """Raise unless the sharded result equals the unsharded one: node,
    feasible, every state plane (and the dead groups)."""
    (rres, rx), (gres, gx) = ref, got
    pairs = [("node", rres.node, gres.node),
             ("feasible", rres.feasible, gres.feasible)]
    pairs += [(f, getattr(rres.state, f), getattr(gres.state, f))
              for f in rres.state._fields]
    if rx is not None:
        pairs.append(("dead", rx, gx))
    for name, a, b in pairs:
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(
                f"dryrun {what}: sharded {name} differs from the unsharded "
                "run")


def run_rung(mesh, rung: str, name: str, tables, pending, existing, keys,
             D: int, engine: Callable, gang=None, device=None) -> Dict:
    """One rung's engine: the unsharded run at the mesh-padded N, then the
    sharded one, compared. Returns the rung's report row."""
    device = device or tables.nodes.valid.device
    n_nodes = int(tables.nodes.valid.shape[0])
    tables = pad_node_tables(tables, mesh.size)
    t0 = time.perf_counter()
    ref = run_cycle(tables, pending, existing, keys, D, engine, gang)
    _sync(device)
    t1 = time.perf_counter()
    st = shard_tables(tables, mesh)
    t2 = time.perf_counter()
    k0 = kernels.launch_counts()
    got = run_cycle(st, pending, existing, keys, D, engine, gang)
    _sync(device)
    t3 = time.perf_counter()
    k1 = kernels.launch_counts()
    compare(ref, got, f"{rung}/{name}")
    res, dead = got
    n_ok = int(res.feasible.sum())
    if n_ok == 0:
        raise AssertionError(f"dryrun {rung}/{name} scheduled nothing")
    row = {"rung": rung, "engine": name, "nodes": n_nodes,
           "padded_nodes": st.n_nodes,
           "pods": int(pending.valid.sum()),
           "scheduled": n_ok, "bit_equal": True,
           "sha256": node_sha256(res.node),
           "unsharded_s": t1 - t0, "shard_upload_s": t2 - t1,
           "sharded_s": t3 - t2, "collectives": dict(axis.LAST_RUN),
           # the sharded run's kernel launches (all 0 on CPU tensors)
           "sharded_launches": {k: k1[k] - k0[k] for k in k1}}
    if dead is not None:
        row["rejected_gangs"] = int(dead.sum())
    return row


def run_dryrun(n_devices: Optional[int] = None,
               devices: Optional[Sequence] = None, device=None,
               log: Optional[Callable[[str], None]] = None,
               bench_pods: int = 50_000,
               production: Sequence[int] = (4096, 8192),
               bench_nodes: int = 5120,
               rungs: Sequence[str] = ("spec", "production", "bench")
               ) -> Dict:
    """The three rungs on a mesh of `n_devices` over `devices` (default
    cuda:0..n-1; parallel/mesh.py make_mesh), the unsharded runs on
    `device` (default the mesh's lead). Raises on any inequality. Returns
    {"n_devices", "rungs": [row, ...], "memory": {...}, "ok": True}."""
    emit = log or (lambda s: None)
    mesh = make_mesh(n_devices, devices=devices)
    device = resolve_device(device if device is not None else mesh.lead)
    n = mesh.size
    rows: List[Dict] = []
    report: Dict = {"n_devices": n, "devices": [str(d) for d in mesh.devices],
                    "rungs": rows, "memory": {}}
    if "spec" in rungs:
        n_nodes = max(8 * n, 16)
        tt, pe, ex, keys, d = encode_flagship(n_nodes, 64, device)
        for name, eng in (("waves", waves_engine), ("scan", scan_engine)):
            rows.append(run_rung(mesh, "spec", name, tt, pe, ex, keys,
                                 d.D, eng, device=device))
            emit(_line(rows[-1], n))
    if "production" in rungs:
        n_nodes, n_pods = production
        tt, pe, ex, gang, keys, d = encode_mixed(n_nodes, n_pods, device)
        rows.append(run_rung(mesh, "production", "waves+gang", tt, pe,
                             ex, keys, d.D, gang_engine, gang=gang,
                             device=device))
        report["memory"]["production"] = memory_report(
            shard_tables(pad_node_tables(tt, n), mesh),
            pad_node_tables(tt, n))
        emit(_line(rows[-1], n))
    if "bench" in rungs:
        tt, pe, ex, keys, d = encode_flagship(bench_nodes, bench_pods,
                                              device)
        rows.append(run_rung(mesh, "bench", "waves", tt, pe, ex, keys,
                             d.D, waves_engine, device=device))
        report["memory"]["bench"] = memory_report(
            shard_tables(pad_node_tables(tt, n), mesh),
            pad_node_tables(tt, n))
        emit(_line(rows[-1], n))
    report["ok"] = True
    return report


def _line(row: Dict, n: int) -> str:
    extra = (f", {row['rejected_gangs']} gang groups rejected"
             if "rejected_gangs" in row else "")
    return (f"dryrun({n}) [{row['rung']}, {row['engine']} @ {row['nodes']} "
            f"nodes × {row['pods']} pods]: scheduled {row['scheduled']}"
            f"{extra}, bit-equal to one device; unsharded "
            f"{row['unsharded_s']:.3f} s, sharded {row['sharded_s']:.3f} s")
