#!/usr/bin/env python3
"""The reference results chip_smoke.py holds the card's runs against: how
many pods a package places, and a hash of where.

    JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax
    python3 scripts/flagship_reference.py --package port [--device cpu]
    JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax \\
        --workload ports-volumes --pods 20000
    JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax \\
        --path serving [--pods 50000]
    JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax \\
        --path preempt
    JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax \\
        --workload gang --pods 100000
    JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax \\
        --explain
    JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax \\
        --workload classes --engine runs [--path serving]
    JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax \\
        --path restart
    JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax \\
        --path framework|extender|cosched
    JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax \\
        --path server [--transport http --pods 2000 [--binary --durable]]
        --path durable
    JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax \\
        --path fleet [--tenants 24 --nodes 2000 --pods 2000]
                     [--mesh 8 --node-shards 2]
        --path scan
        --path kubemark [--nodes 500 --pods 500]
        --path cluster [--nodes 100 --pods 300]
        --path mesh [--devices 4] [--production 4096x8192] [--pods 50000]

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

`--path preempt` runs that drain, then chip_smoke.py's phase-6 storm on its
bound pods (`preempt_storm`: chip_smoke.py's STORM_VIPS priority-1000 pods
through a Scheduler with a Preemptor; per wave the counts, victims evicted
and preemptors nominated, then the evicted keys and the vips' binder order
as counts and sha256).

`--path restart` runs chip_smoke.py's phase-9a drill (`restart_drill`): the
phase-5b backlog drained by a ledger-backed leader that dies at post_intent,
a warm standby over the same store that recovers and drains the rest. It
prints the per-wave counts and snapshot modes of both, the RecoveryReport,
the binder's outcome and the ledger counters — the JAX_RESTART constants —
and, as JAX_WAVE_PHASES, the phase names of the leader's first wave's
flight record.

`--path framework` runs chip_smoke.py's phase-10a drain
(`framework_drain`: phase 5b's backlog through a Scheduler configured by
chip_smoke.FRAMEWORK_CONFIG on labelled nodes); `--path extender` runs the
phase-5b drain, then phase 10b's extender verbs over HTTP and 10c's
Scheduler with an HTTPExtender against that drain's bound pods
(`extender_phase`; the answers as counts and sha256, without the
timings); `--path cosched` runs phase 10d (`cosched_drain`,
gang_workload_pods on the Permit path, `--pods` default
chip_smoke.COSCHED_PODS). Each prints the JAX_FRAMEWORK, JAX_EXTENDER and
JAX_COSCHED constants.

`--path server` runs chip_smoke.py's phase-11a drain (`server_drain`): the
package's SchedulerServer over its own in-process APIServer, 5,000 nodes
and flagship_pods(`--pods`, default chip_smoke.SERVER_PODS) created
through the client before the server starts, drained by one leader-elected
server with a BindIntentLedger, each wave behind chip_smoke.wave_barrier
(every earlier Binding confirmed, every backoff served). It prints the
bound count, the per-wave bound counts and the sha256 of the sorted (pod,
node) map the apiserver holds and of the first wave's placements (the
JAX_SERVER constants); `--transport
http` puts the client on HTTPTransport through an HTTPGateway (phase 11d,
JAX_SERVER_HTTP, `--pods 2000`).

`--binary` puts that client on the binary codec and `--durable` makes the
apiserver durable (batch) over a temporary data dir: with `--transport http
--pods 2000` that is phase 14b (JAX_SERVER_BINARY).

`--path durable` runs chip_smoke.py's phase 14a (`durable_drill`): the
package's APIServer over a temporary data dir (batch), 5,000 nodes and
flagship_pods(`--pods`, default chip_smoke.DURABLE_PODS) created through
Client.local, a Scheduler with an APIBinder and a BindIntentLedger killed
by proc.crash@wal:post_append:2 mid-commit, the apiserver rebooted from
disk and a successor's recover() and drain. It prints the bound count, the
per-wave counts of both schedulers, the RecoveryReport and the sha256 of the
whole (pod, node) map (JAX_DURABLE).

`--path fleet` runs chip_smoke.py's phase 12a (`fleet_run`): the
package's FleetServer with `--tenants` tenants (default
chip_smoke.FLEET_TENANTS) of make_nodes(`--nodes`) and `--pods` pods each
(defaults chip_smoke.FLEET_NODES, FLEET_PODS), engines by tenant, t00
under the tight DRF quota, ticked until idle. It prints per tenant the
bound count and the sha256 of its sorted (pod, node) pairs, the per-tick
scheduled counts, t00's clamped pods and tick 1's DRF rows per engine group
(sha256 of admitted, share, dom) — the JAX_FLEET constant. With `--mesh N`
the fleet serves on a fleet mesh of N devices (the JAX package on N
virtual CPU devices, the port on N × `--device`), `--node-shards K` making
it the (N/K, K) tenant × node-shard grid of phase 18a.

`--path scan` runs chip_smoke.py's phase 13 batches through the package's
BatchScheduler: 13a, make_nodes(5000) x flagship_pods(10000) with every
hundredth pod pinned by spec.nodeName (the nodeName route to the
sequential scan), and 13b, port_volume_workload(5000, 5000) under
KTPU_ASSIGN=scan. It prints each one's scheduled count and the sha256 over
its assignments — the JAX_SCAN constant.

`--path kubemark` runs chip_smoke.py's phase 15 (`kubemark_drive`): the
package's APIServer, a HollowCluster of `--nodes` hollow nodes (default
chip_smoke.KUBEMARK_NODES, labelled with ten zones), a ControllerManager
with the deployment, replicaset, daemonset and nodelifecycle controllers,
a Deployment of `--pods` replicas (default chip_smoke.KUBEMARK_REPLICAS)
spread over the zones and a DaemonSet, created before the package's
SchedulerServer starts and drains them behind chip_smoke.wave_barrier
until every pod runs. It prints the bound count, the per-wave counts and
the sha256 of the bound map (JAX_KUBEMARK) beside the drive's timings.

`--path cluster` runs chip_smoke.py's phase 16 (`cluster_drive`): the
package's Cluster with `--nodes` hollow nodes (default
chip_smoke.CLUSTER_NODES) and the deployment, replicaset, endpoints and
nodelifecycle controllers; kubectl apply of the Deployment web (`--pods`
replicas, default chip_smoke.CLUSTER_REPLICAS, spread with maxSkew 1 over
the hostnames) and its Service as JSON manifests, rollout status; the
proxier's rule for the Service; the metrics server and kubectl top; upgrade
plan and apply to v1.18.0; join 2 nodes and kubectl scale by 3 a node. It
prints the JAX_CLUSTER constant (the per-node counts, the rule's endpoint
count, the top rows, the upgrade phases, the Deployment's status, all
timing-free) beside the drive's timings.

`--workload gang` is BASELINE config 5 on the batch path: gang_workload_pods
(jobs of 8 to 64 all-or-nothing members, 2% of them larger than any node);
besides the placements it prints the dead groups (count and sha256) and the
gang engine's rejection rounds.

`--workload classes` is bench.py's `classes` stage: make_nodes(N) x
deployment_backlog_pods(P, deployments=200), a Deployment scale-out backlog
of 200 class runs; on the batch path it also prints the wave's class runs
and collapse ratio (ops/runs.py plan_runs), on the serving path it drains
that backlog (chip_smoke.py phase 8c) instead of running phase 5.
`--engine` sets KTPU_ASSIGN (waves, the default; runs; scan).

`--path mesh` runs the multi-device dryrun's three rungs (chip_smoke.py
phase 17a) on a mesh of `--devices` shards: the spec rung (both engines,
max(8·n, 16) nodes × 64 flagship pods), the production rung (waves and gang
rounds, `--production` nodes x pods of flagship and gang pods) and the bench
rung (waves, 5,120 nodes × `--pods` flagship pods). The JAX package runs
each on its own virtual CPU mesh (XLA_FLAGS forces the devices) and against
its unsharded run; the port runs parallel/dryrun.py run_dryrun on a mesh of
`--device` repeated. Both print, per rung, the scheduled count, the rejected
gang groups and the sha256 of the node map (chip_smoke.py node_sha256) —
the `JAX_MESH` constant.

`--explain` (batch path) dispatches the cycle as BatchScheduler does but
with explain=True and adds the sha256 of the ExplainResult's integer fields
(chip_smoke.py explain_sha256) to the line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def jax_serving_api():
    """chip_smoke.port_serving_api's namespace, from the JAX package."""
    import types as pytypes

    import jax

    from kubernetes_tpu.api import types
    from kubernetes_tpu.models import workloads
    from kubernetes_tpu.sched.cycle import _schedule_batch, snapshot_with_keys
    from kubernetes_tpu.sched.preemption import Preemptor
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

    from kubernetes_tpu import extender, framework
    from kubernetes_tpu.sched.config import load_config
    from kubernetes_tpu.sched.ledger import BindIntentLedger
    from kubernetes_tpu.storage.native import PyKV
    from kubernetes_tpu.storage.store import Storage
    from kubernetes_tpu.utils import faultline

    return pytypes.SimpleNamespace(
        types=types, workloads=workloads, Dims=Dims, Encoder=Encoder,
        SchedulerCache=SchedulerCache, RecordingBinder=RecordingBinder,
        snapshot=lambda cache, enc, pods, base: snapshot_with_keys(
            cache, enc, pods, base),
        dispatch=dispatch,
        readback=lambda node: jax.device_get(node).tolist(),
        scheduler=scheduler, preemptor=Preemptor,
        ledger=BindIntentLedger, storage=lambda: Storage(kv=PyKV()),
        faultline=faultline, load_config=load_config, framework=framework,
        extender=extender, backend=extender.ExtenderBackend)


def jax_server_api():
    """chip_smoke.port_server_api's namespace, from the JAX package."""
    import types as pytypes

    from kubernetes_tpu.api import types, v1
    from kubernetes_tpu.apiserver import APIServer, HTTPGateway
    from kubernetes_tpu.cli import Cluster, ClusterConfig
    from kubernetes_tpu.cli.kubectl import main as kubectl
    from kubernetes_tpu.client import Client
    from kubernetes_tpu.client.informers import (InformerFactory,
                                                 SharedInformer)
    from kubernetes_tpu.component.metrics_server import MetricsServer
    from kubernetes_tpu.controllers import ControllerManager
    from kubernetes_tpu.kubemark import HollowCluster
    from kubernetes_tpu.machinery import errors
    from kubernetes_tpu.models import workloads
    from kubernetes_tpu.proxy import Proxier
    from kubernetes_tpu.proxy.healthcheck import ProxierHealthServer
    from kubernetes_tpu.sched.ledger import BindIntentLedger
    from kubernetes_tpu.sched.scheduler import Scheduler
    from kubernetes_tpu.sched.server import APIBinder, SchedulerServer
    from kubernetes_tpu.state.dims import Dims, bucket
    from kubernetes_tpu.storage import native, wal
    from kubernetes_tpu.utils import faultline

    made = []

    def server(client, **kw):
        srv = SchedulerServer(client, **kw)
        srv.scheduler.prewarmer.enabled = False  # compile-ahead only
        made.append(srv.scheduler)
        return srv

    def scheduler(**kw):
        s = Scheduler(**kw)
        s.prewarmer.enabled = False  # compile-ahead only
        made.append(s)
        return s

    return pytypes.SimpleNamespace(
        types=types, workloads=workloads, Dims=Dims, bucket=bucket,
        node_to_v1=v1.node_to_v1, pod_to_v1=v1.pod_to_v1,
        node_from_v1=v1.node_from_v1, pod_from_v1=v1.pod_from_v1,
        APIServer=APIServer, HTTPGateway=HTTPGateway, Client=Client,
        server=server, scheduler=scheduler, made=made,
        ledger=BindIntentLedger, APIBinder=APIBinder,
        SharedInformer=SharedInformer, errors=errors, native=native,
        wal=wal, faultline=faultline, ControllerManager=ControllerManager,
        HollowCluster=HollowCluster, Cluster=Cluster,
        cluster_config=ClusterConfig, kubectl=kubectl, Proxier=Proxier,
        ProxierHealthServer=ProxierHealthServer,
        InformerFactory=InformerFactory, MetricsServer=MetricsServer)


def jax_fleet_api():
    """chip_smoke.port_fleet_api's namespace, from the JAX package (the
    fleet part phase 12a uses)."""
    import types as pytypes

    import numpy as np

    from kubernetes_tpu.api import types
    from kubernetes_tpu.fleet import FleetServer
    from kubernetes_tpu.fleet import server as fleet_server
    from kubernetes_tpu.models import workloads
    from kubernetes_tpu.sched.scheduler import RecordingBinder
    from kubernetes_tpu.state.dims import Dims, bucket

    made = []

    def fleet(**kw):
        srv = FleetServer(**kw)
        srv.prewarmer.enabled = False  # compile-ahead only
        made.append(srv)
        return srv

    return pytypes.SimpleNamespace(
        types=types, workloads=workloads, Dims=Dims, bucket=bucket,
        fleet=fleet, fleet_module=fleet_server, made=made,
        RecordingBinder=RecordingBinder, to_np=np.asarray)


def fleet_path(args) -> dict:
    """Phase 12a on the chosen package."""
    os.environ["KTPU_OVERLOAD"] = "0"
    import chip_smoke

    import torch

    if args.package == "jax":
        api = jax_fleet_api()
    else:
        api = chip_smoke.port_fleet_api(torch.device(args.device))
    names = [f"t{k:02d}" for k in range(args.tenants)]
    kw = {}
    if args.mesh:
        kw = dict(mesh=args.mesh, node_shards=args.node_shards)
        if args.package == "port":
            kw["mesh_devices"] = [torch.device(args.device)] * args.mesh
    t0 = time.perf_counter()
    out = chip_smoke.fleet_run(api, names=names, n_nodes=args.nodes,
                               n_pods=args.pods, fleet_kw=kw)
    chip_smoke.check_fleet(out, args.package)
    return {"package": args.package, "path": "fleet",
            "tenants": args.tenants, "nodes": args.nodes,
            "pods": args.pods, "mesh": args.mesh,
            "node_shards": args.node_shards,
            "fleet": chip_smoke.fleet_reference(out),
            "seconds": time.perf_counter() - t0}


def scan_path(args) -> dict:
    """Phase 13 (13a and 13b) on the chosen package."""
    import chip_smoke

    if args.package == "jax":
        import kubernetes_tpu as pkg
        from kubernetes_tpu.api import types
        from kubernetes_tpu.models import workloads

        make = pkg.BatchScheduler
    else:
        import kubernetes_tpu_torch as pkg
        from kubernetes_tpu_torch.api import types
        from kubernetes_tpu_torch.models import workloads

        def make():
            return pkg.BatchScheduler(device=args.device)
    out = {}
    for key in ("nodename", "ports_volumes"):
        nodes, pods, engine = chip_smoke.scan_inputs(types, workloads, key,
                                                     args.nodes)
        os.environ["KTPU_ASSIGN"] = engine or args.engine
        t0 = time.perf_counter()
        res = make().schedule(nodes, [], pods)
        out[key] = {"nodes": len(nodes), "pods": len(pods),
                    "scheduled": res.scheduled,
                    "sha256": chip_smoke.assignments_sha256(res.assignments),
                    "seconds": time.perf_counter() - t0}
    return {"package": args.package, "path": "scan", "scan": out}


def server_path(args) -> dict:
    """Phase 11a (or 11d, `--transport http`) on the chosen package."""
    os.environ["KTPU_OVERLOAD"] = "0"
    import chip_smoke

    if args.package == "jax":
        api = jax_server_api()
    else:
        import torch

        api = chip_smoke.port_server_api(torch.device(args.device))
    t0 = time.perf_counter()
    data_dir = tempfile.mkdtemp(prefix="ktpu-ref-") if args.durable else None
    try:
        out = chip_smoke.server_drain(api, args.nodes, args.pods,
                                      transport=args.transport,
                                      binary=args.binary, data_dir=data_dir)
    finally:
        if data_dir:
            shutil.rmtree(data_dir, ignore_errors=True)
    keep = ("pods", "bound", "bound_sha256", "first_wave_sha256",
            "waves_sha256")
    server = {k: out[k] for k in keep}
    server["waves"] = [w["scheduled"] for w in out["waves"]]
    return {"package": args.package, "path": "server",
            "transport": args.transport, "binary": args.binary,
            "durable": args.durable, "nodes": args.nodes,
            "pods": args.pods, "server": server,
            "waves": out["waves"], "seconds": time.perf_counter() - t0}


def kubemark_path(args) -> dict:
    """Phase 15 (chip_smoke.kubemark_drive) on the chosen package."""
    os.environ["KTPU_OVERLOAD"] = "0"
    import chip_smoke

    if args.package == "jax":
        api = jax_server_api()
    else:
        import torch

        api = chip_smoke.port_server_api(torch.device(args.device))
    t0 = time.perf_counter()
    out = chip_smoke.kubemark_drive(api, args.nodes, args.pods)
    return {"package": args.package, "path": "kubemark",
            "nodes": args.nodes, "replicas": args.pods,
            "kubemark": chip_smoke.kubemark_reference(out),
            "drive": {k: v for k, v in out.items() if k != "bound_sha256"},
            "seconds": time.perf_counter() - t0}


def cluster_path(args) -> dict:
    """Phase 16 (chip_smoke.cluster_drive) on the chosen package."""
    os.environ["KTPU_OVERLOAD"] = "0"
    import chip_smoke

    if args.package == "jax":
        api = jax_server_api()
    else:
        import torch

        api = chip_smoke.port_server_api(torch.device(args.device))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        out = chip_smoke.cluster_drive(api, workdir, args.nodes, args.pods)
    return {"package": args.package, "path": "cluster",
            "nodes": args.nodes, "replicas": args.pods,
            "cluster": chip_smoke.cluster_reference(out),
            "drive": {k: v for k, v in out.items()
                      if not k.startswith("per_node")},
            "seconds": time.perf_counter() - t0}


def durable_path(args) -> dict:
    """Phase 14a (chip_smoke.durable_drill) on the chosen package."""
    os.environ["KTPU_OVERLOAD"] = "0"
    import chip_smoke

    if args.package == "jax":
        api = jax_server_api()
    else:
        import torch

        api = chip_smoke.port_server_api(torch.device(args.device))
    t0 = time.perf_counter()
    data_dir = tempfile.mkdtemp(prefix="ktpu-ref-")
    try:
        out = chip_smoke.durable_drill(api, os.path.join(data_dir, "14a"),
                                       args.nodes, args.pods)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    return {"package": args.package, "path": "durable",
            "nodes": args.nodes, "pods": args.pods,
            "durable": chip_smoke.durable_reference(out),
            "backend": out["backend"], "seconds": time.perf_counter() - t0}


def restart(args) -> dict:
    os.environ["KTPU_OVERLOAD"] = "0"
    import chip_smoke

    if args.package == "jax":
        api = jax_serving_api()
    else:
        import torch

        api = chip_smoke.port_serving_api(torch.device(args.device))
    keep = []
    t0 = time.perf_counter()
    drill = chip_smoke.restart_drill(api, args.nodes, args.pods, keep=keep)
    timing = drill.pop("timing")
    for s in keep:
        s.prewarmer.wait(300)  # no background warm may outlive the script
    leader = keep[0]
    phases = [p for p, _ in leader.telemetry.recorder.records()[0]["phases"]]
    return {"package": args.package, "path": "restart", "nodes": args.nodes,
            "pods": args.pods, "restart": drill, "wave_phases": phases,
            "recover_s": timing["recover_s"],
            "seconds": time.perf_counter() - t0}


def serving(args) -> dict:
    os.environ["KTPU_OVERLOAD"] = "0"
    import chip_smoke

    if args.package == "jax":
        api = jax_serving_api()
    else:
        import torch

        api = chip_smoke.port_serving_api(torch.device(args.device))
    t0 = time.perf_counter()
    steady = {"cycles": []}
    if args.workload == "flagship":
        steady = chip_smoke.serving_steady(api, args.nodes,
                                           chip_smoke.SERVING_STEADY_PODS)
    t1 = time.perf_counter()
    drain = chip_smoke.serving_drain(api, args.nodes, args.pods,
                                     workload=args.workload)
    t2 = time.perf_counter()
    timing = ("snapshot_s", "dispatch_s", "readback_s", "map_s")
    return {"package": args.package, "path": "serving", "nodes": args.nodes,
            "workload": args.workload, "engine": args.engine,
            "steady": [{k: v for k, v in c.items() if k not in timing}
                       for c in steady["cycles"]],
            "drain_pods": args.pods, "drain": drain,
            "steady_seconds": t1 - t0, "drain_seconds": t2 - t1}


def _api(args):
    import chip_smoke

    if args.package == "jax":
        return jax_serving_api()
    import torch

    return chip_smoke.port_serving_api(torch.device(args.device))


def framework_path(args) -> dict:
    """Phase 10a on the chosen package."""
    os.environ["KTPU_OVERLOAD"] = "0"
    import chip_smoke

    api = _api(args)
    t0 = time.perf_counter()
    drain = chip_smoke.framework_drain(api, args.nodes, args.pods)
    return {"package": args.package, "path": "framework",
            "nodes": args.nodes, "pods": args.pods, "drain": drain,
            "seconds": time.perf_counter() - t0}


def extender_path(args) -> dict:
    """Phase 5b's drain, then phases 10b and 10c on its bound pods."""
    os.environ["KTPU_OVERLOAD"] = "0"
    import chip_smoke

    api = _api(args)
    bound = []
    t0 = time.perf_counter()
    chip_smoke.serving_drain(api, args.nodes, args.pods, keep_bound=bound)
    t1 = time.perf_counter()
    ext, _secs = chip_smoke.extender_phase(api, bound, args.nodes, args.pods)
    return {"package": args.package, "path": "extender",
            "nodes": args.nodes, "pods": args.pods, "existing": len(bound),
            "existing_sha256": chip_smoke.bound_sha256(bound),
            "extender": ext, "drain_seconds": t1 - t0,
            "extender_seconds": time.perf_counter() - t1}


def cosched_path(args) -> dict:
    """Phase 10d on the chosen package."""
    os.environ["KTPU_OVERLOAD"] = "0"
    import chip_smoke

    api = _api(args)
    t0 = time.perf_counter()
    out = chip_smoke.cosched_drain(api, args.nodes, args.pods)
    return {"package": args.package, "path": "cosched", "nodes": args.nodes,
            "pods": args.pods, "cosched": out,
            "seconds": time.perf_counter() - t0}


def jax_classes_plan(nodes, pods) -> dict:
    """chip_smoke.classes_plan from the JAX package: the wave's class runs
    and collapse ratio (its ops/runs.py plan_runs on its encoding)."""
    from kubernetes_tpu.ops.runs import plan_runs
    from kubernetes_tpu.sched.cycle import UNSCHEDULABLE_TAINT_KEY
    from kubernetes_tpu.state.encode import Encoder

    enc = Encoder()
    enc.vocabs.label_keys.intern(UNSCHEDULABLE_TAINT_KEY)
    enc.vocabs.label_vals.intern("")
    _t, _ex, pe, _d = enc.encode_cluster(nodes, [], pods)
    plan = plan_runs(pe.cls, pe.priority, pe.creation, pe.valid,
                     pe.node_name_req)
    return {"n_runs": plan.n_runs,
            "collapse_ratio": round(plan.collapse_ratio, 2)}


def jax_explain_sha256(nodes, pods) -> str:
    """The JAX package's BatchScheduler dispatch with explain=True: the
    sha256 of its ExplainResult's integer fields."""
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from kubernetes_tpu.sched.cycle import (UNSCHEDULABLE_TAINT_KEY,
                                            _schedule_batch)
    from kubernetes_tpu.state.encode import Encoder

    enc = Encoder()
    enc.vocabs.label_keys.intern(UNSCHEDULABLE_TAINT_KEY)
    enc.vocabs.label_vals.intern("")
    tables, ex, pe, d = enc.encode_cluster(nodes, [], pods)
    keys = (jnp.int32(enc.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY)),
            jnp.int32(enc.vocabs.label_vals.get("")))
    _res, exp = _schedule_batch(
        jax.device_put(tables), jax.device_put(pe), keys, d.D,
        jax.device_put(ex), has_node_name=d.has_node_name, explain=True)
    exp = jax.device_get(exp)
    return chip_smoke.explain_sha256(
        {f: getattr(exp, f) for f in exp._fields}, len(pods))


def preempt(args) -> dict:
    os.environ["KTPU_OVERLOAD"] = "0"
    import chip_smoke

    if args.package == "jax":
        api = jax_serving_api()
    else:
        import torch

        api = chip_smoke.port_serving_api(torch.device(args.device))
    bound = []
    t0 = time.perf_counter()
    chip_smoke.serving_drain(api, args.nodes, chip_smoke.SERVING_PODS,
                             keep_bound=bound)
    t1 = time.perf_counter()
    storm = chip_smoke.preempt_storm(api, args.nodes, bound)
    t2 = time.perf_counter()
    return {"package": args.package, "path": "preempt", "nodes": args.nodes,
            "existing": len(bound),
            "existing_sha256": chip_smoke.bound_sha256(bound),
            "storm": storm, "drain_seconds": t1 - t0,
            "storm_seconds": t2 - t1}


def count_gang_rounds(package: str) -> list:
    """Counts the gang engine's rounds: the JAX package's host-rounds route
    dispatches `_gang_round_impl` once per round (its device loop is one
    dispatch and is not counted here), the port's assign_gang runs the wave
    engine once per round. Returns a one-element list the count lands in."""
    n = [0]
    if package == "jax":
        from kubernetes_tpu.sched import cycle as mod
        name = "_gang_round_impl"
    else:
        from kubernetes_tpu_torch.ops import gang as mod
        name = "assign_waves"
    fn = getattr(mod, name)

    def counted(*a, **kw):
        n[0] += 1
        return fn(*a, **kw)

    setattr(mod, name, counted)
    return n


def jax_mesh_reference(args) -> dict:
    """The JAX package's mesh dryrun rungs (its parallel/dryrun.py shapes
    and steps), each sharded run held bit-equal to the unsharded one at the
    same padded N; per rung the count and the node map's sha256."""
    import jax
    import numpy as np

    import chip_smoke
    from kubernetes_tpu.ops.assign import assign_batch, initial_state
    from kubernetes_tpu.ops.gang import assign_gang
    from kubernetes_tpu.ops.lattice import build_cycle
    from kubernetes_tpu.ops.waves import assign_waves
    from kubernetes_tpu.parallel.dryrun import encode_flagship, encode_mixed
    from kubernetes_tpu.parallel.mesh import (make_mesh, pad_node_tables,
                                              replicate, shard_tables)

    n = args.devices
    mesh = make_mesh(n)
    out = {}

    def both(fn, tables, rest):
        ref = jax.tree.map(np.asarray, fn(tables, *rest))
        st = shard_tables(tables, mesh)
        got = jax.tree.map(np.asarray, fn(st, *(replicate(r, mesh)
                                               for r in rest)))
        for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
            np.testing.assert_array_equal(a, b)
        return got

    def engine_step(engine, D):
        @jax.jit
        def step(tables, pending, existing, uk, ev):
            cyc = build_cycle(tables, existing, uk, ev, D)
            res = engine(tables, cyc, pending, initial_state(tables, cyc))
            return res.node, res.feasible, res.state.used, res.state.CNT
        return step

    prod_n, prod_p = args.production
    for rung, n_nodes, n_pods in (("spec", max(8 * n, 16), 64),
                                  ("production", prod_n, prod_p),
                                  ("bench", 5120, args.pods)):
        t0 = time.perf_counter()
        if rung == "production":
            tables, pe, ex, gang, keys, d = encode_mixed(n_nodes, n_pods)
            tables = pad_node_tables(tables, n)

            @jax.jit
            def gstep(tables, pending, existing, gang, uk, ev, D=d.D):
                cyc = build_cycle(tables, existing, uk, ev, D)
                res, dead = assign_gang(tables, cyc, pending,
                                        initial_state(tables, cyc), gang)
                return res.node, res.feasible, dead

            node, feas, dead = both(gstep, tables,
                                    (pe, ex, gang, keys[0], keys[1]))
            out["production"] = {
                "engine": "waves+gang", "nodes": n_nodes, "pods": n_pods,
                "scheduled": int(feas.sum()),
                "rejected_gangs": int(dead.sum()),
                "sha256": chip_smoke.node_sha256(node),
                "seconds": time.perf_counter() - t0}
            continue
        tables, pe, ex, keys, d = encode_flagship(n_nodes, n_pods)
        tables = pad_node_tables(tables, n)
        engines = (("waves", assign_waves), ("scan", assign_batch)) \
            if rung == "spec" else (("waves", assign_waves),)
        for name, engine in engines:
            node, feas, _u, _c = both(engine_step(engine, d.D), tables,
                                      (pe, ex, keys[0], keys[1]))
            out[f"{rung}_{name}" if rung == "spec" else rung] = {
                "engine": name, "nodes": n_nodes, "pods": n_pods,
                "scheduled": int(feas.sum()),
                "sha256": chip_smoke.node_sha256(node),
                "seconds": time.perf_counter() - t0}
    return {"package": "jax", "path": "mesh", "devices": n, "mesh": out}


def port_mesh_reference(args) -> dict:
    """The port's dryrun (parallel/dryrun.py) on a mesh of `--device`
    repeated, in the same shape as jax_mesh_reference's."""
    import torch

    import chip_smoke
    from kubernetes_tpu_torch.parallel.dryrun import run_dryrun

    dev = torch.device(args.device)
    rep = run_dryrun(devices=[dev] * args.devices, device=dev,
                     production=tuple(args.production), bench_pods=args.pods)
    return {"package": "port", "path": "mesh", "devices": args.devices,
            "mesh": chip_smoke.mesh_reference(rep)}


def main() -> int:
    import chip_smoke

    chip_smoke.pin_hash_seed()  # phase 10d's release order (cosched_drain)
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--device", default="cpu",
                    help="the port's device (ignored for --package jax)")
    ap.add_argument("--path",
                    choices=("batch", "serving", "preempt", "restart",
                             "framework", "extender", "cosched", "server",
                             "fleet", "scan", "durable", "kubemark",
                             "cluster", "mesh"),
                    default="batch")
    ap.add_argument("--nodes", type=int, default=None,
                    help="default 5,000 (chip_smoke.FLEET_NODES for "
                    "--path fleet)")
    ap.add_argument("--tenants", type=int, default=None,
                    help="--path fleet: default chip_smoke.FLEET_TENANTS")
    ap.add_argument("--pods", type=int, default=None,
                    help="pending pods (default 50,000 for the batch path, "
                    "chip_smoke.SERVING_PODS for the serving drain)")
    ap.add_argument("--workload",
                    choices=("flagship", "ports-volumes", "gang", "classes"),
                    default="flagship")
    ap.add_argument("--engine", choices=("waves", "runs", "scan"),
                    default="waves", help="KTPU_ASSIGN")
    ap.add_argument("--explain", action="store_true",
                    help="batch path: also hash the dispatch's "
                    "ExplainResult")
    ap.add_argument("--transport", choices=("local", "http"),
                    default="local", help="--path server: the client's "
                    "transport")
    ap.add_argument("--binary", action="store_true",
                    help="--path server --transport http: the binary codec")
    ap.add_argument("--durable", action="store_true",
                    help="--path server: a durable apiserver (batch) over a "
                    "temporary data dir")
    ap.add_argument("--devices", type=int, default=4,
                    help="--path mesh: the mesh's shards")
    ap.add_argument("--mesh", type=int, default=0,
                    help="--path fleet: serve on a fleet mesh of this many "
                    "devices (0: none)")
    ap.add_argument("--node-shards", type=int, default=1,
                    help="--path fleet --mesh N: the grid's node-shard "
                    "width")
    ap.add_argument("--production",
                    type=lambda v: tuple(int(x) for x in v.split("x")),
                    default=(4096, 8192),
                    help="--path mesh: the production rung, NODESxPODS")
    args = ap.parse_args()
    os.environ["KTPU_ASSIGN"] = args.engine
    if args.path == "mesh":
        args.pods = args.pods or 50000
        if args.package == "jax":
            # the virtual CPU devices, before anything imports jax
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform"
                f"_device_count={max(args.devices, 8)}").strip()
            print(json.dumps(jax_mesh_reference(args)))
        else:
            print(json.dumps(port_mesh_reference(args)))
        return 0
    if args.path == "fleet":
        if args.mesh and args.package == "jax":
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform"
                f"_device_count={args.mesh}").strip()
        args.tenants = args.tenants or chip_smoke.FLEET_TENANTS
        args.nodes = args.nodes or chip_smoke.FLEET_NODES
        args.pods = args.pods or chip_smoke.FLEET_PODS
        print(json.dumps(fleet_path(args)))
        return 0
    if args.path == "kubemark":
        args.nodes = args.nodes or chip_smoke.KUBEMARK_NODES
        args.pods = args.pods or chip_smoke.KUBEMARK_REPLICAS
        print(json.dumps(kubemark_path(args)))
        return 0
    if args.path == "cluster":
        args.nodes = args.nodes or chip_smoke.CLUSTER_NODES
        args.pods = args.pods or chip_smoke.CLUSTER_REPLICAS
        print(json.dumps(cluster_path(args)))
        return 0
    if args.nodes is None:
        args.nodes = 5000
    if args.path == "scan":
        print(json.dumps(scan_path(args)))
        return 0
    if args.path == "durable":
        if args.pods is None:
            args.pods = chip_smoke.DURABLE_PODS
        print(json.dumps(durable_path(args)))
        return 0
    if args.path == "server":
        if args.pods is None:
            import chip_smoke

            args.pods = chip_smoke.SERVER_PODS
        print(json.dumps(server_path(args)))
        return 0
    if args.path == "preempt":
        print(json.dumps(preempt(args)))
        return 0
    if args.path == "restart":
        if args.pods is None:
            import chip_smoke

            args.pods = chip_smoke.SERVING_PODS
        print(json.dumps(restart(args)))
        return 0
    paths = {"framework": framework_path, "extender": extender_path,
             "cosched": cosched_path}
    if args.path in paths:
        if args.pods is None:
            import chip_smoke

            args.pods = (chip_smoke.COSCHED_PODS if args.path == "cosched"
                         else chip_smoke.SERVING_PODS)
        print(json.dumps(paths[args.path](args)))
        return 0
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
    rounds = None
    if args.workload == "flagship":
        nodes = workloads.make_nodes(args.nodes)
        pods = workloads.flagship_pods(args.pods)
    elif args.workload == "gang":
        nodes = workloads.make_nodes(args.nodes)
        pods = workloads.gang_workload_pods(args.pods)
        rounds = count_gang_rounds(args.package)
    elif args.workload == "classes":
        import chip_smoke

        nodes = workloads.make_nodes(args.nodes)
        pods = workloads.deployment_backlog_pods(
            args.pods, deployments=chip_smoke.CLASSES_DEPLOYMENTS)
    else:
        from chip_smoke import port_volume_workload

        nodes, pods = port_volume_workload(args.nodes, args.pods, types,
                                           workloads)
    t0 = time.perf_counter()
    res = sched.schedule(nodes, [], pods)
    seconds = time.perf_counter() - t0
    digest = hashlib.sha256(
        "\n".join(a or "-" for a in res.assignments).encode()).hexdigest()
    out = {"package": args.package, "workload": args.workload,
           "engine": args.engine, "nodes": args.nodes,
           "pods": args.pods, "scheduled": res.scheduled,
           "failed": res.failed, "seconds": seconds,
           "sha256": digest}
    if rounds is not None:
        from chip_smoke import gang_summary

        out.update(gang_summary(pods, res.assignments), rounds=rounds[0])
    if args.workload == "classes":
        if args.package == "jax":
            out.update(jax_classes_plan(nodes, pods))
        else:
            from chip_smoke import classes_plan

            out.update(classes_plan(nodes, pods))
    if args.explain:
        if args.package == "jax":
            out["explain_sha256"] = jax_explain_sha256(nodes, pods)
        else:
            import torch

            from chip_smoke import explain_sha256, port_explain_cycle

            _placed, exp = port_explain_cycle(torch.device(args.device),
                                              nodes, pods)
            out["explain_sha256"] = explain_sha256(exp, len(pods))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
