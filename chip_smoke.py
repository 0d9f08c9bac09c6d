#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (kubernetes_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  1. the card's name and power limit; build of every CUDA kernel from
     kubernetes_tpu_torch/csrc/ (nvcc, sm_90a) with its compile time;
  2. each kernel against its plain PyTorch version on the card, exactly, on
     edge shapes (edge_cases: class counts around a warp's 32 lanes, node
     counts off the block size, both K1 variants, words with bit 31 set,
     extreme int32 requests; K2 counters in shared memory and in the
     scratch past 227 KB, one-domain rows, N = 1; K3 at R = 4..8 and, in
     its wide variant, R = 9, 16, 20 and 64 — 33 lanes, extreme int32,
     INT32_MIN priorities, a 2,000-pod segment; K4 on encoded workloads
     (k4_edge_cases: identical nodes, a pod that fits nowhere, one pinned
     to a missing node, invalid and padding rows, each Filter flag off,
     R = 4 and 16, host ports at PWt == PWp, volumes at driver limits,
     N = 1, 1,023, 1,025, 5,120 and 29,000 on the hostname key, no terms)
     — every node and all nine state planes, WSYM bitwise, the initial
     state untouched, through the wrapper and at each cluster size 1, 2,
     4, 8, 16 — and K4 refusing an even-spread total past 2^24,
     k4_even_bound_case, through the wrapper and at each cluster size
     above 1);
  3. the flagship cycle — 5,000 nodes × 50,000 pods (models/workloads.py
     make_nodes / flagship_pods) — through BatchScheduler(device="cuda"):
     launch counts of the cycle, placements and final state planes against
     the same cycle with device="cpu", the placed count and placement hash
     against the JAX package's, cycle wall time (median of 3 warm runs);
     3b. the port-and-volume cycle — 5,000 nodes × 20,000 pods with host
     ports and attachable volumes (port_volume_workload) — the same checks
     but the warm runs, and K1 on the real words of its first wave;
     3c. the flagship dispatch with explain=True on the card and on the
     CPU: placements unchanged, the ExplainResult's integer fields equal
     and their sha256 the JAX package's, its f32 fields within
     EXPLAIN_F32_ATOL;
  4. per-kernel times from CUDA events at the flagship cycle's inputs,
     each kernel first checked exactly against its plain version there —
     device time with the host's launch work hidden behind a GPU spin
     (`ms`), time per call with it (`call_ms`) — beside the plain version's
     time per call and the bound; K1's device time at the port-and-volume
     cycle's inputs;
  5. serving on resident state, with the overload governor off
     (KTPU_OVERLOAD=0) and a still clock: 5a the steady state of the
     flagship on the port's SchedulerCache (a cold full snapshot, then two
     cycles that churn one node and one pending pod and must take the
     patch path), 5b the port's Scheduler(device="cuda") draining a
     flagship backlog wave by wave (informer confirmations and a node
     update between waves), then a micro wave of 3 fresh pods. Modes, rows
     patched, per-wave counts, placements and the binder's order equal the
     JAX package's recorded constants; 5b also equals the port's CPU run.
     K1 and K2 launch in both, and equal their plain versions on the first
     serving wave's inputs. Prints the per-cycle and per-wave split;
  6. a preemption storm on 5b's bound pods (preempt_storm): STORM_VIPS pods
     at priority 1000 through Scheduler(device="cuda") with a Preemptor and
     a PodDisruptionBudget, up to STORM_WAVES waves. Per-wave counts,
     evictions, nominations, the evicted keys and the vips' binder order
     equal the JAX package's recorded constants; K3 launches in it and
     equals its plain version, on all seven outputs, on the first burst's
     inputs (and on phase 2's K3 edge cases: empty, 110-pod and 2,000-pod
     segments, all reblocked, R = 7 and 8, 33 lanes, INT32_MIN priorities,
     extreme int32, no pods). Prints each wave's split (snapshot, build_cycle,
     what-if, K3, readback) and K3's time against its bound, and K3's wide
     variant (R = 16) timed beside R = 4 at the first burst's widths;
  7. BASELINE config 5: BatchScheduler(device="cuda") on 5,000 nodes x
     100,000 gang pods (gang_workload_pods): placements, dead groups and
     rejection rounds equal the JAX package's; cold and warm cycle times;
  8. the run-collapsed engine (KTPU_ASSIGN=runs, torch ops, no hand
     kernel) on bench.py's `classes` shapes, 5,000 nodes x 50,000 pods of
     200 deployments: 8a BatchScheduler(device="cuda") — placed count,
     placement sha256, class runs and collapse ratio equal the JAX
     package's, every run through the closed form, epochs per dispatch,
     cold and median warm cycle; 8b the scan and the runs engine on 2,000
     pods, placements bit-equal, the scan through K4 (launched, the plain
     scan not called; K4 equal to it over the first 256 rows); 8c Scheduler(device="cuda") draining the
     backlog in waves of 4,096 — per-wave counts, class runs and the
     binder's order equal the JAX package's, per-wave times;
  9. the serving Scheduler's resilience layer (KTPU_OVERLOAD=0): 9a a
     ledger-backed leader draining 5b's backlog dies at post_intent, a warm
     standby fed the same informer events (read-only under warm_standby)
     recovers and drains the rest — exactly once, its first led wave a
     patch snapshot with K1/K2, equal to the JAX package's drill
     (JAX_RESTART); 9b 5b's drain with a hang and an error and no fallback
     (each abandoned, requeued, re-run on the card), then one error with
     fallback_device="cpu" (a degraded CPU wave equal to 5b's, the prober
     re-admitting the card); 9c a cluster growing from 4,000 to 5,000
     nodes with the prewarmer and without (placements equal; the warm's
     K1/K2, from its thread on its stream, against their plain versions);
     9d a 5b wave's flight record against the JAX package's phase names,
     the device split, watch→bind p50/p99 on a running clock, and one wave
     under KTPU_PROFILE whose `cycle` range holds K1/K2. Every phase but
     9b checks that no dispatch fell back, and every phase but 9c that no
     warm ran (the Scheduler's prewarmer is off unless asked for), so the
     launch counts of phases 5-8 are the main path's own;
 10. the scheduling framework and the extender boundary at 5,000 nodes
     (KTPU_OVERLOAD=0): 10a 5b's drain through Scheduler(framework=
     cfg.build_framework()) configured by FRAMEWORK_CONFIG (a dict
     KubeSchedulerConfiguration: MostAllocated, RequestedToCapacityRatio,
     NodeLabel, NodePreferAvoidPods, hardPodAffinitySymmetricWeight 2) on
     labelled nodes, per wave and binder order against JAX_FRAMEWORK, K1/K2
     in it; 10b an ExtenderServer over ExtenderBackend(device="cuda")
     mirroring those nodes and 5b's bound pods, answering the port's
     HTTPExtender — Filter and Prioritize naming every node,
     ProcessPreemption, Bind — against JAX_EXTENDER, p50/p99 ms per verb;
     10c Scheduler(extenders=[HTTPExtender]) placing fresh pods through
     that server; 10d gang_workload_pods on the Permit path (Coscheduling)
     against JAX_COSCHED. Every subphase checks that no dispatch fell back
     and no warm ran. The script pins PYTHONHASHSEED=0 (pin_hash_seed):
     10d's release order follows the string-hash seed;
 11. the scheduler process over the API at 5,000 nodes (KTPU_OVERLOAD=0):
     every object through the port's client into the port's APIServer.
     11a flagship_pods(5000) created before a leader-elected
     SchedulerServer(device="cuda", ledger=BindIntentLedger) starts and
     drains them over LocalTransport: the waves before the first retried
     pod and the bound count equal JAX_SERVER, every pod bound once (a
     watch pump), no unretired intent, no wave raised (a counting wrapper
     around schedule_pending: the server's loop swallows errors); 11b on
     that server 64 vips (priorityClassName vip, a PDB) preempting through
     API DELETEs, held to invariants (bound or nominated with an event,
     victims gone, no node over its allocatable), K3 launched; 11c two
     servers, the leader killed at post_bind of its second intent wave,
     the standby's takeover binding every pod exactly once, a stale-token
     Binding refused by the fence; 11d 2,000 pods over HTTPTransport
     through an HTTPGateway against JAX_SERVER_HTTP;
 12. the fleet on one card: 12a 24 tenants x make_nodes(2000) x 2,000 pods
     through FleetServer(device="cuda"), engines waves/runs/scan by tenant,
     against JAX_FLEET and each engine's solo run, with K1/K2/K4 launches
     per tick (the scan tenants and the runs tenants' fallback through
     K4, the plain scan never called), the stack patched in place
     (donated_patches > 0, no donation failure), the steady tick's split,
     K4's longest launch per step and at each cluster size, one short
     fallback run's device time and time per call;
     12b tick 1's DRF rows on the card against the CPU; 12c the watch
     plane with a stream killed and revived;
 13. the sequential-assume scan at full width on make_nodes(5000): 13a
     BatchScheduler(device="cuda") on flagship_pods(10000) with every
     hundredth pod pinned by spec.nodeName (the nodeName route), 13b
     port_volume_workload(5000, 5000) under KTPU_ASSIGN=scan; each against
     JAX_SCAN, K4 launched and the plain scan not called on the route, K4
     equal to its plain version over the first 256 rows; K4's device time
     per launch and per step, and per step at each cluster size;
 14. the durable control plane (KTPU_OVERLOAD=0), data dirs under the
     run's temporary directory: 14a an APIServer(data_dir, durability=
     "batch") on the native kvstore (csrc/kvstore.cpp, built at first use;
     the backend gauge must say native) holding make_nodes(5000) and
     flagship_pods(4096), a Scheduler(device="cuda") with an APIBinder and
     a BindIntentLedger, a SharedInformer on the pods; the apiserver killed
     at proc.crash@wal:post_append:2 (the wave's intent durable, its first
     Binding committed and unanswered), its pump and batch flusher stopped
     with no final fsync, rebooted from disk: recovered, the revision
     continuous, the informer resumed with 0 relists, the successor's
     recover() replaying exactly 1 intent, every pod bound exactly once
     and the whole map against JAX_DURABLE; WAL records, bytes, fsyncs and
     fsync seconds, recovery, replay and kill-to-first-bind seconds; 14b
     11d's drain over HTTPTransport(binary=True) against a durable
     apiserver, its map, per-wave counts and per-wave binder order against
     JAX_SERVER_BINARY, its creates/s beside 11d's. K1/K2 launch in both,
     their first launches equal to the plain versions;
 15. (run first, right after phase 1's build) the kubemark rollout, in an
     interpreter of its own (`chip_smoke.py --phase 15` on the same card;
     KTPU_OVERLOAD=0; kubemark_drive): an
     APIServer, a HollowCluster of 500 hollow nodes (a Kubelet with a FakeCRI each,
     ten zones), a ControllerManager with the deployment, replicaset,
     daemonset and nodelifecycle controllers; the Deployment web (500
     replicas of 100m/64Mi, maxSkew 1 over the zones, DoNotSchedule) until
     its ReplicaSet has made every pod, then the DaemonSet agent (50m/32Mi)
     until one pod targets each node; only then SchedulerServer(device=
     "cuda"), each wave behind the wave barrier, until every pod is bound,
     Running and Ready and both workloads report it. Gates: the bound map
     and the waves against JAX_KUBEMARK; the workloads' statuses; each
     daemon pod on its target node, one a node; the spread; no overcommit;
     no unhealthy taint by the node lifecycle controller; no wave and no
     thread raised (a threading.excepthook); K1/K2 launched, their first
     launches equal to the plain versions; the phase within 150 s;
 16. (run second, after phase 15) the cluster and the CLI, in an
     interpreter of its own (`chip_smoke.py --phase 16`; cluster_drive),
     everything through the port's Cluster and kubectl over the gateway
     (Client.http): 16a Cluster(ClusterConfig(hollow_nodes=100,
     device="cuda", controllers=[deployment, replicaset, endpoints,
     nodelifecycle])) up; 16b kubectl apply of two JSON manifests, the
     Deployment web (300 replicas of 100m/64Mi, maxSkew 1 over the
     hostnames, DoNotSchedule) and its ClusterIP Service on port 80, then
     rollout status: every pod Running and Ready, exactly 3 on each node,
     no overcommit; 16c the port's Proxier on the cluster's client, synced
     once: the rule for the Service's (clusterIP, 80) holds exactly the
     300 pods' ip:port, its /healthz 200; 16d a MetricsServer over the
     hollow kubelets: kubectl top nodes and pods give 100 and 300 rows;
     16e upgrade plan and apply to v1.18.0, the restarted SchedulerServer
     on the card; 16f join 2 nodes (token-only) and kubectl scale to 306:
     the restarted scheduler binds the 6, exactly 3 on each joined node.
     Gates: the placements, the rule's size, the top rows, the upgrade
     phases and the Deployment's status against JAX_CLUSTER; no unhealthy
     taint, no thread raised; K1/K2 launched, their first launches equal
     to the plain versions; the phase within 150 s. It prints whether
     PyYAML and cryptography import on the card's machine.
 17. (after 14) node-axis sharding on a mesh of MESH_SHARDS × the card
     (mesh_phase): the dryrun's rungs against JAX_MESH, the serving drain
     on the mesh against mesh=None and its loss → reform drill, a sharded
     preemption burst.
 18. (after 17) the fleet mesh (fleet_mesh_phase): 18a phase 12a's
     workload through FleetServer on the 4 × 2 tenant × node-shard grid
     over 8 × the card, against JAX_FLEET and 12a's one-device run, one
     dispatch per engine group per tick, K1/K2/K4 launched in the grid's
     threads with each first launch equal to its plain version; 18b
     t00–t07 on the 8 × 1 tenant mesh with no collective; 18c the
     degrade → reform drill under the 2-D signature.

Prints a `kernels` JSON line, the nvidia-smi name/power line, and last
`{"ok": true, "device": {...}}`. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import statistics
import subprocess
import sys
import time

# The JAX package's BatchScheduler on the same flagship input (5,000 nodes ×
# 50,000 pods, JAX 0.9.0 on the CPU): 34,000 pods placed, 16,000
# unschedulable; sha256 over the assignments, one node name (or "-") per
# pending pod joined by newlines. Reproduce with
# `JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax`.
JAX_SCHEDULED = 34000
JAX_ASSIGNMENTS_SHA256 = \
    "3ef91ba5eb90738691a71cdfd9389032f9306b4bcc42dcde0120c3c4fb6a537f"

# The same for the port-and-volume workload below
# (port_volume_workload(5000, 20000), JAX 0.9.0 on the CPU): all 20,000
# placed. Reproduce with `JAX_PLATFORMS=cpu python3
# scripts/flagship_reference.py --package jax --workload ports-volumes
# --pods 20000`.
PV_NODES, PV_PODS = 5000, 20000
PV_JAX_SCHEDULED = 20000
PV_JAX_ASSIGNMENTS_SHA256 = \
    "8ee42e8e0cd13d3f38977caa912a44ad5711bf0852800d4accc41133fd5bfb96"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12   # float32 outside the tensor cores

# Phase 5: the steady state at the full flagship, and the wave loop's drain
# at SERVING_PODS pods in waves of SERVING_BATCH on SERVING_NODES nodes.
SERVING_NODES, SERVING_STEADY_PODS = 5000, 50000
SERVING_PODS, SERVING_BATCH = 50000, 4096

# Phase 5's reference results from the JAX package (JAX 0.9.0 on the CPU,
# KTPU_OVERLOAD=0). Reproduce with `JAX_PLATFORMS=cpu python3
# scripts/flagship_reference.py --package jax --path serving`.
# 5a, per cycle: (snapshot mode, rows patched, placed, placement sha256).
JAX_STEADY = [
    ("full", 5000, 34000,
     "3ef91ba5eb90738691a71cdfd9389032f9306b4bcc42dcde0120c3c4fb6a537f"),
    ("patch", 1, 34000,
     "3ef91ba5eb90738691a71cdfd9389032f9306b4bcc42dcde0120c3c4fb6a537f"),
    ("patch", 1, 34000,
     "3ef91ba5eb90738691a71cdfd9389032f9306b4bcc42dcde0120c3c4fb6a537f"),
]
# 5b, per wave: (attempted, scheduled, unschedulable, micro, snapshot
# mode, rows patched); then the binder's ordered (pod, node) list.
JAX_DRAIN = {
    "waves": [
        (4096, 0, 4096, 0, "full", 5000),
        (4096, 0, 4096, 0, "full", 5000),
        (4096, 0, 4096, 0, "full", 5000),
        (4096, 384, 3712, 0, "patch", 1),
        (4096, 4096, 0, 0, "patch", 768),
        (4096, 4096, 0, 0, "full", 5000),
        (4096, 4096, 0, 0, "full", 5000),
        (4096, 4096, 0, 0, "patch", 4338),
        (4096, 4096, 0, 0, "patch", 4338),
        (4096, 4096, 0, 0, "patch", 4988),
        (4096, 4096, 0, 0, "patch", 4338),
        (4096, 4096, 0, 0, "patch", 4338),
        (848, 848, 0, 0, "full", 5000),
        (3, 3, 0, 1, "patch", 899),
    ],
    "bound": 34003,
    "bound_sha256":
        "777cae914b9ee93bc2044c32534c187d86c9551f013c8bd86ba018ea87c6f568",
}

# Phase 6: the preemption storm (preempt_storm) on phase 5b's bound pods.
STORM_VIPS, STORM_WAVES, STORM_TICK, STORM_SPREAD_SKEW = 2304, 16, 61.0, 50

# Phase 6's reference results from the JAX package (JAX 0.9.0 on the CPU,
# KTPU_OVERLOAD=0): per wave (attempted, scheduled, unschedulable, victims
# evicted, preemptors nominated); the evicted keys in order and the vips'
# binder (pod, node) order as counts and sha256; the last burst's PDB
# violations and the preemption attempts. Reproduce with
# `JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax
# --path preempt` (its "storm").
JAX_STORM = {
    "waves": [
        (2304, 2134, 0, 1, 1),
        (170, 1, 0, 1, 1),
        (169, 1, 0, 1, 1),
        (168, 1, 0, 1, 1),
        (167, 1, 0, 1, 1),
        (166, 1, 0, 1, 1),
        (165, 1, 0, 1, 1),
        (164, 1, 0, 1, 1),
        (163, 1, 0, 1, 1),
        (162, 1, 0, 1, 1),
        (161, 1, 0, 1, 1),
        (160, 1, 0, 1, 1),
        (159, 1, 0, 1, 1),
        (158, 1, 0, 1, 1),
        (157, 1, 0, 1, 1),
        (156, 1, 0, 1, 1),
    ],
    "evicted": 16,
    "evicted_sha256":
        "16db5391cccd1756eca763d91be525c6096f15fcbe6677dad2082e877238867e",
    "vips_bound": 2149,
    "vips_bound_sha256":
        "bea87d792d4ebd84653ee1d696744e98043f90caaf3051a5dc4fb8cd55a3da6c",
    "pdb_violations": 0,
    "attempts": 2600,
}

# Phase 7: BASELINE config 5, gang jobs (gang_workload_pods) at 5,000 nodes,
# and the JAX package's result on it (JAX 0.9.0 on the CPU, its host-rounds
# route): placed count and placement sha256, the groups that placed no
# member (count and sha256 of their sorted names) and the rejection rounds.
# Reproduce with `JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py
# --package jax --workload gang --pods 100000`.
GANG_NODES, GANG_PODS = 5000, 100000
JAX_GANG = {
    "scheduled": 46848,
    "sha256":
        "a055229eee4ae5a22103ab5e31d527d7edd121218fd04326a1b4106d5a8b6a8c",
    "dead_groups": 1157,
    "dead_sha256":
        "7b5a5ae764f1c0ae89c6fc5ce90ed1b381634937bc1cabd4fb6a61294efaf80e",
    "rounds": 3,
}

# Phase 3c: the flagship dispatch with explain=True (the waves engine, class
# granularity): sha256 over the ExplainResult's integer fields, each [:P]
# as little-endian int32 in EXPLAIN_INT_FIELDS order (explain_sha256), from
# the JAX package (JAX 0.9.0 on the CPU). Reproduce with `JAX_PLATFORMS=cpu
# python3 scripts/flagship_reference.py --package jax --explain`.
EXPLAIN_INT_FIELDS = ("reasons", "valid_nodes", "feasible_nodes",
                      "rejected_any", "top_nodes", "part_node")
JAX_EXPLAIN_SHA256 = \
    "328870681a33234d5f0e6ab9feb95a9b077591ba0174dcf1da96c42f4f292566"
# its f32 fields (top_scores, score_parts), card against the port's CPU
# run: the same f32 expression tree op for op; the tolerance leaves room
# for a reduction-order rounding (tests/torch_parity.py F32_ATOL)
EXPLAIN_F32_ATOL = 1e-4

# Phase 8: the run-collapsed engine (KTPU_ASSIGN=runs) on bench.py's
# `classes` stage shapes — make_nodes(5000) x deployment_backlog_pods(50000,
# deployments=200) — and the JAX package's results there (JAX 0.9.0 on the
# CPU): 8a BatchScheduler's placed count and placement sha256 and the
# wave's class runs and collapse ratio (plan_runs); reproduce with
# `JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax
# --workload classes --engine runs`. 8c the Scheduler's drain of that
# backlog in waves of SERVING_BATCH, per wave (attempted, scheduled,
# unschedulable, micro, snapshot mode, rows patched, class runs), then the
# binder's order; reproduce with `JAX_PLATFORMS=cpu python3
# scripts/flagship_reference.py --package jax --path serving --workload
# classes --engine runs`. 8b holds the runs engine against the scan on
# CLASSES_SCAN_PODS pods of CLASSES_SCAN_DEPLOYMENTS deployments.
CLASSES_NODES, CLASSES_PODS, CLASSES_DEPLOYMENTS = 5000, 50000, 200
CLASSES_SCAN_PODS, CLASSES_SCAN_DEPLOYMENTS = 2000, 20
# 8a's warm cycles after the cold one (each ~20 s on the card; cut from 3
# for phase 18's time)
CLASSES_WARM_RUNS = 1
JAX_CLASSES = {
    "scheduled": 50000,
    "sha256":
        "13e15552d0640cb740bd45a7a5594f27c8fb0639de597bf618e3069a8a0091f4",
    "n_runs": 200,
    "collapse_ratio": 250.0,
}
JAX_CLASSES_DRAIN = {
    "waves": [
        (4096, 4096, 0, 0, "full", 5000, 17),
        (4096, 4096, 0, 0, "full", 5000, 17),
        (4096, 4096, 0, 0, "full", 5000, 18),
        (4096, 4096, 0, 0, "full", 5000, 17),
        (4096, 4096, 0, 0, "full", 5000, 17),
        (4096, 4096, 0, 0, "full", 5000, 18),
        (4096, 4096, 0, 0, "full", 5000, 17),
        (4096, 4096, 0, 0, "patch", 6659, 18),
        (4096, 4096, 0, 0, "full", 5000, 17),
        (4096, 4096, 0, 0, "full", 5000, 17),
        (4096, 4096, 0, 0, "patch", 6472, 18),
        (4096, 4096, 0, 0, "patch", 6809, 17),
        (848, 848, 0, 0, "patch", 7199, 4),
        (3, 3, 0, 1, "patch", 1697, 1),
    ],
    "bound": 50003,
    "bound_sha256":
        "8b32e1b9810c4e1e6e47720bda5a34834050019a993e40817f46f9bb8f1e08fa",
}

# Phase 9: the serving Scheduler's resilience layer on phase 5b's backlog.
# 9a: the leader dies at post_intent of its RESTART_CRASH_WAVE-th
# intent-writing wave (its first three waves place nothing, so it is its
# sixth wave); 9a's reference from the JAX package (JAX 0.9.0 on the CPU,
# KTPU_OVERLOAD=0, its prewarmer off). Reproduce with `JAX_PLATFORMS=cpu
# python3 scripts/flagship_reference.py --package jax --path restart`.
RESTART_CRASH_WAVE = 3
JAX_RESTART = {
    "leader_waves": [
        [4096, 0, 4096, 0, "full", 5000],
        [4096, 0, 4096, 0, "full", 5000],
        [4096, 0, 4096, 0, "full", 5000],
        [4096, 384, 3712, 0, "patch", 1],
        [4096, 4096, 0, 0, "patch", 768],
    ],
    "crashed_wave": 6,
    "intents_left_at_crash": 1,
    "bound_at_crash": 4480,
    "report": {"replayed_intents": 1, "already_bound": 0, "completed": 4096,
               "released": 0, "dropped": 0, "stale_skipped": 0,
               "forgotten_assumes": 0, "errors": 0},
    "standby_waves": [
        [4096, 4096, 0, 0, "patch", 0],
        [4096, 4096, 0, 0, "patch", 4353],
        [4096, 4096, 0, 0, "patch", 4353],
        [4096, 4096, 0, 0, "patch", 4353],
        [4096, 4096, 0, 0, "full", 5000],
        [4096, 4096, 0, 0, "patch", 4473],
        [4096, 4096, 0, 0, "full", 5000],
        [4096, 4096, 0, 0, "patch", 4338],
        [4096, 4096, 0, 0, "patch", 4338],
        [4096, 4096, 0, 0, "patch", 4338],
        [464, 464, 0, 0, "patch", 4338],
    ],
    "bound": 50000,
    "bind_log_sha256":
        "0d0faec37822cc93beb0c68b82e39777dcfd89741802be867bd1a0305a835a2a",
    "bound_set_sha256":
        "a0f828f95d3d473df4331c58286a23075966aaa6831cd52439b6b09e52603b14",
    "double_bind_attempts": 0,
    "unretired": 0,
    "intents_written": 14,
    "intents_retired": 14,
}
# the phase names of one healthy bulk wave's flight record in the JAX
# package (the same run's leader, its first wave)
JAX_WAVE_PHASES = ["pump", "pop", "snapshot", "prewarm", "dispatch", "readback", "intent-write", "bind-commit", "retire", "requeue"]
# 9b's supervisor knobs: a warm deadline of max(3 s, 8 x the best warm
# time), a cold one of 120 s, a prober backing off from 50 ms
SUPERVISOR_ENV = {"KTPU_DISPATCH_DEADLINE_FLOOR": "3",
                  "KTPU_DISPATCH_DEADLINE_MULT": "8",
                  "KTPU_DISPATCH_COLD_DEADLINE": "120",
                  "KTPU_PROBE_BACKOFF": "0.05",
                  "KTPU_PROBE_BACKOFF_CAP": "1",
                  "KTPU_PROBE_DEADLINE": "10"}
# 9b's faults, by wave of the drain (0-based): a hang and an error with no
# fallback, then one error with fallback_device="cpu" configured
HANG_WAVE, ERROR_WAVE, FALLBACK_WAVE = 8, 9, 11
# 9c: the cluster grows from GROWTH_FROM to GROWTH_TO nodes in steps of
# GROWTH_STEP, one wave of GROWTH_BATCH fresh pods at each step
GROWTH_FROM, GROWTH_TO, GROWTH_STEP, GROWTH_BATCH = 4000, 5000, 100, 256

# Phase 10: the scheduling framework and the extender boundary at the
# flagship's width. 10a's nodes are make_nodes(FRAMEWORK_NODES), every 7th
# labelled disktype=ssd and every 11th annotated preferAvoidPods; its
# configured profile (a dict: the card's machine has no PyYAML):
FRAMEWORK_NODES = 5000
FRAMEWORK_SSD_EVERY, FRAMEWORK_AVOID_EVERY = 7, 11
FRAMEWORK_CONFIG = {
    "kind": "KubeSchedulerConfiguration",
    "hardPodAffinitySymmetricWeight": 2,
    "plugins": {"score": {
        "disabled": ["NodeResourcesLeastAllocated",
                     "NodeResourcesBalancedAllocation"],
        "enabled": [{"name": "NodeResourcesMostAllocated", "weight": 2},
                    {"name": "RequestedToCapacityRatio", "weight": 1},
                    {"name": "NodeLabel", "weight": 3},
                    {"name": "NodePreferAvoidPods", "weight": 5}]}},
    "pluginConfig": [
        {"name": "RequestedToCapacityRatio", "args": {"shape": [
            {"utilization": 0, "score": 0},
            {"utilization": 50, "score": 80},
            {"utilization": 100, "score": 100}]}},
        {"name": "NodeLabel", "args": {"present": ["disktype"]}}],
}
# 10b: Filter and Prioritize calls (one pod each, every node named), the
# ProcessPreemption candidates, Bind calls; 10c: pods through the
# Scheduler's per-pod extender path; 10d: gang pods on the Permit path
EXTENDER_CALLS, EXTENDER_CANDIDATES, EXTENDER_BINDS = 128, 2, 8
EXTENDER_SCHED_PODS = 64
COSCHED_NODES, COSCHED_PODS = 5000, 20000

# Phase 10's references from the JAX package (JAX 0.9.0 on the CPU,
# KTPU_OVERLOAD=0, PYTHONHASHSEED=0). Reproduce with `JAX_PLATFORMS=cpu
# python3 scripts/flagship_reference.py --package jax --path framework`
# (JAX_FRAMEWORK: the drain's per-wave counts and snapshot modes, the
# binder's order), `--path extender` (JAX_EXTENDER: 10b's answers and 10c's
# placements after the phase-5b drain) and `--path cosched` (JAX_COSCHED).
JAX_FRAMEWORK = {
    "waves": [
        (4096, 0, 4096, 0, "full", 5000),
        (4096, 0, 4096, 0, "full", 5000),
        (4096, 0, 4096, 0, "full", 5000),
        (4096, 384, 3712, 0, "patch", 1),
        (4096, 4096, 0, 0, "patch", 417),
        (4096, 4096, 0, 0, "full", 5000),
        (4096, 4096, 0, 0, "full", 5000),
        (4096, 4096, 0, 0, "patch", 5546),
        (4096, 4096, 0, 0, "patch", 4479),
        (4096, 4096, 0, 0, "patch", 4616),
        (4096, 4096, 0, 0, "patch", 4338),
        (4096, 4096, 0, 0, "patch", 4338),
        (848, 848, 0, 0, "full", 5000),
        (3, 3, 0, 1, "patch", 899),
    ],
    "bound": 34003,
    "bound_sha256":
        "4bbd42c2b07ea22886c50666fa2ab65c1d223f1e56c2f1eec373592397a5eec6",
}
# 10b's answers and 10c's placements, on phase 5b's 34003 bound pods
JAX_EXTENDER = {
    "filter": {
        "calls": 128,
        "passing": 597000,
        "failed": 43000,
        "sha256": "86f6a3aac2417370d0dc863176f171dd076c04e619f3992baf9bac38f635a9f5"
    },
    "prioritize": {
        "calls": 128,
        "nonzero": 577191,
        "sha256": "0b605354c741c1cdadc1dd45f95486e5dd0fdc0e31ddadfccd0b42be1ca9958a"
    },
    "preempt": {
        "candidates": 2,
        "victims": 2,
        "surviving": {
            "node-0": 1,
            "node-1": 1
        },
        "sha256": "fb1d3f51b57913b5fc6f1a1f87965e085c704f4e9ee5a1d96591fff2f2c1d5d1"
    },
    "bind": {
        "calls": 8,
        "sha256": "44595b9a3e018dc50bdc4ada275cba36fa1723672a58685fcd6d54dfc2372b60"
    },
    "sched": {
        "pods": 64,
        "attempted": 64,
        "scheduled": 64,
        "unschedulable": 0,
        "bound": 64,
        "sha256": "7af0728a65f7ee0fff6ed679182df9ab9138e58836a01d6fa510ce0bdbb50598",
        "local_binder": 0
    }
}
JAX_COSCHED = {
    "waves": [
        [4096, 134, 80],
        [4096, 134, 96],
        [4096, 134, 144],
        [4096, 134, 96],
        [3616, 119, 80],
    ],
    "bound": 19504,
    "bound_sha256":
        "103d14064465862b6d2e12fdd92915df0dcb74132ef72480ad8a309d4531a00f",
    "bound_set_sha256":
        "7eecfd102beb4e905566ad9b728b22cad72d39d48191ee3d4345611c5532713d",
    "released": 18849,
    "waiting": 0,
}

# the kernels every wave-engine path launches (K3 runs only in preemption)
WAVE_KERNELS = ("contention_scan", "domain_rank")
K1_SOURCE = "kubernetes_tpu_torch/csrc/contention_scan.cu"
K2_SOURCE = "kubernetes_tpu_torch/csrc/domain_rank.cu"
K3_SOURCE = "kubernetes_tpu_torch/csrc/reprieve_scan.cu"


def pin_hash_seed() -> None:
    """Re-run this script under PYTHONHASHSEED=0 unless it already runs so:
    the Coscheduling plugin's release order (phase 10d) follows the string
    hash seed, and the JAX package's order was recorded under 0."""
    import os

    if os.environ.get("PYTHONHASHSEED") != "0":
        sys.stdout.flush()
        os.execve(sys.executable, [sys.executable] + sys.argv,
                  dict(os.environ, PYTHONHASHSEED="0"))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------------- #

def time_ms(fn, device, reps: int = 20) -> float:
    """Mean time per call of fn() over `reps` calls after one warm-up, from
    CUDA events around the whole run (host clock on a CPU rehearsal). Host
    work between launches shows up as device idle time inside the window,
    so this is the time per CALL."""
    import torch

    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, device, reps: int = 20) -> float:
    """Mean DEVICE time per call of fn(): the stream is held by a GPU spin
    (torch.cuda._sleep) while the host enqueues all `reps` calls, so the
    events around them time back-to-back kernels with no host gaps. The spin
    doubles until the start event is still pending once everything is
    enqueued. On a CPU rehearsal, the host clock per call."""
    import torch

    if device.type != "cuda":
        return time_ms(fn, device, reps)
    fn()
    spin = 50_000_000
    for _ in range(8):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / reps
        spin *= 2
    fail("device_ms: the host never got ahead of the device")


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# --------------------------------------------------------------------------- #
# kernel inputs
# --------------------------------------------------------------------------- #

def k1_inputs(gen, device, SC, N, R, PW, PT, VW, DR, extreme=False):
    """Random K1 inputs. `extreme` draws requests, allocatable and used from
    int32 edge values, so the running sums and free space wrap."""
    import torch

    def ints(*shape, lo=-(2**31), hi=2**31 - 1):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int64).to(torch.int32)

    def words(*shape):  # full 32-bit words, bit 31 set about half the time
        return ints(*shape)

    def flags(*shape, p=0.5):
        return torch.rand(shape, generator=gen) < p

    if extreme:
        edge = torch.tensor([0, 1, -1, 2**31 - 1, -(2**31), 2**30, 7],
                            dtype=torch.int32)
        pick = lambda *s: edge[torch.randint(0, len(edge), s, generator=gen)]
        req, alloc, used = pick(SC, R), pick(N, R), pick(N, R)
    else:
        req = ints(SC, R, lo=0, hi=4000)
        req[:, 3] = 1
        alloc = ints(N, R, lo=0, hi=64000)
        alloc[:, 3] = 110
        used = (alloc.float() * torch.rand((N, R), generator=gen)).to(torch.int32)
    sparse = lambda *s: words(*s) & words(*s) & words(*s)
    t = dict(
        A=flags(SC, N, p=0.4), req=req, has_p=flags(SC), pw=sparse(SC, PW),
        ww=sparse(SC, PW), tw=sparse(SC, PT), has_v=flags(SC),
        va=sparse(SC, VW), vr=sparse(SC, VW), alloc=alloc, used=used,
        vol_any=sparse(N, VW), vol_rw=sparse(N, VW), drv_masks=words(DR, VW),
        vol_limit=ints(N, DR, lo=-1, hi=40))
    return tuple(v.to(device) for v in t.values())


def k2_inputs(gen, device, rows, N, num_domains):
    import torch

    dom = torch.randint(0, num_domains, (rows, N), generator=gen,
                        dtype=torch.int64).to(torch.int32)
    return dom.to(device)


def k1_diff(out_a, out_b) -> int:
    import torch

    (ka, wa), (kb, wb) = out_a, out_b
    d = int((ka.to(torch.int64) - kb.to(torch.int64)).abs().max())
    for x, y in zip(wa, wb):
        d = max(d, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
    return d


def k2_diff(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


def check_kernels(device, cases_k1, cases_k2) -> dict:
    """Phase 2: each kernel against its plain version on the card, exact.
    Returns the max abs error per kernel."""
    from kubernetes_tpu_torch.ops import kernels as K

    err = {"contention_scan": 0, "domain_rank": 0}
    for name, args in cases_k1:
        d = k1_diff(K.contention_scan(*args), K.contention_scan_plain(*args))
        sync(device)
        print(f"  K1 {name}: max_abs_err={d}")
        if d != 0:
            fail(f"contention_scan disagrees with its plain version ({name})")
        err["contention_scan"] = max(err["contention_scan"], d)
    for name, (dom, nd) in cases_k2:
        d = k2_diff(K.domain_rank(dom, nd), K.domain_rank_plain(dom, nd))
        sync(device)
        print(f"  K2 {name}: max_abs_err={d}")
        if d != 0:
            fail(f"domain_rank disagrees with its plain version ({name})")
        err["domain_rank"] = max(err["domain_rank"], d)
    return err


# phase 2's K3 case at the storm's first-burst widths with five scalar
# resources (R = 16, the wide variant); PERF.md's kernel table times it
K3_WIDE_CASE = "wide R=16 B=8 N=5120 E=65536 (the storm's first-burst widths)"
K3_NARROW_CASE = "R=4 B=8 N=5120 E=65536 (the storm's first-burst widths)"


def k3_inputs(gen, device, B, N, E, R, p_vict=0.7, p_cand=0.8,
              p_reblock=0.2, p_clash=0.05, extreme=False, node_of=None,
              prios=None):
    """Random K3 inputs in K3_ARGS order, with the reprieve order built as
    the port builds it (ops/preempt.py reprieve_order). `node_of` fixes
    each pod's node (N = on no node); by default 1 pod in 20 is on no node.
    Each node's used counts its pods' requests over a random base, and its
    allocatable leaves room for part of them, so walks both reprieve and
    evict; its pods slot holds at least its pods. `extreme` draws requests,
    allocatable and used from int32 edge values, so the sums wrap;
    `prios` draws each pod's priority from the given values."""
    import torch
    from kubernetes_tpu_torch.ops.preempt import reprieve_order

    def ints(*shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int64).to(torch.int32)

    def flags(*shape, p):
        return torch.rand(shape, generator=gen) < p

    if node_of is None:
        node_of = ints(E, lo=0, hi=N)
        node_of[flags(E, p=0.05)] = N
    on = node_of < N
    if extreme:
        edge = torch.tensor([0, 1, -1, 2**31 - 1, -(2**31), 2**30, 7],
                            dtype=torch.int32)
        pick = lambda *s: edge[torch.randint(0, len(edge), s, generator=gen)]
        req_e, alloc, used = pick(E, R), pick(N, R), pick(N, R)
        low = edge[[0, 1, 2, 4, 6]]   # so that some nodes are candidates
        req_p = low[torch.randint(0, len(low), (B, R), generator=gen)]
        if R > 8:   # most scalar requests zero, or no node is a candidate
            req_p[:, 4:] *= flags(B, R - 4, p=0.2)
    else:
        req_e = ints(E, R, lo=0, hi=1500)
        req_e[:, 3] = 1
        req_p = ints(B, R, lo=0, hi=3000)
        req_p[:, 3] = 1
        if R > 4:   # zero scalar requests, which the fit test ignores
            req_p[:, 4:] *= flags(B, R - 4, p=0.5)
        total = torch.zeros((N + 1, R), dtype=torch.int64).index_add_(
            0, node_of.long(), req_e.long())[:N]
        base = ints(N, R, lo=0, hi=1000).long()
        base[:, 3] = 0
        used = (base + total).to(torch.int32)
        alloc = (base + total * (0.4 + 0.6 * torch.rand((N, R), generator=gen))
                 + ints(N, R, lo=1000, hi=4000)).to(torch.int32)
        alloc[:, 3] = torch.clamp(total[:, 3] + 10, min=110).to(torch.int32)
    prio = (ints(E, lo=0, hi=5) if prios is None else torch.tensor(
        prios, dtype=torch.int32)[torch.randint(0, len(prios), (E,),
                                                generator=gen)])
    pdb = flags(E, p=0.3)
    seg_ptr, seg_e = reprieve_order(node_of, prio, pdb, N)
    args = (seg_ptr, seg_e, req_e, prio, pdb, ints(E, lo=0, hi=10**6), req_p,
            flags(B, E, p=p_vict) & on[None], flags(B, E, p=p_clash),
            flags(B, E, p=p_reblock), used, alloc, flags(N, p=0.95),
            flags(B, N, p=p_cand))
    return tuple(t.to(device).contiguous() for t in args)


def k3_edge_cases(device, seed: int = 0):
    """K3's cases: the storm's widths (8 lanes, 5,000 nodes, 50,000 pods),
    mostly empty segments, 110-pod segments (the flagship's pod cap), a
    2,000-pod segment (longer than any shared-memory stage), every pod
    reblocked, R = 8 with zero scalar requests, R = 7 with 33 lanes (past a
    warp), INT32_MIN and INT32_MAX priorities (the order and max_p traps,
    wrapping priority sums), extreme int32 requests, no pods, one lane of
    one node; then the wide variant (R = 9, 16, 20, 64: five scalar
    resources bucket to 16) at 33 lanes, the storm's first-burst widths,
    extreme int32, a 2,000-pod segment, INT32_MIN priorities and no
    pods."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    full = torch.arange(440, dtype=torch.int32) // 110
    long_seg = torch.cat([torch.zeros(2000, dtype=torch.int32),
                          torch.ones(1900, dtype=torch.int32),
                          torch.full((100,), 2, dtype=torch.int32)])
    edge_prios = (-(2**31), -(2**31) + 1, 0, 1, 5, 2**30, 2**31 - 1)
    return [
        ("storm widths B=8 N=5000 E=50000 R=4",
         k3_inputs(gen, device, 8, 5000, 50000, 4)),
        ("empty segments B=3 N=4096 E=300",
         k3_inputs(gen, device, 3, 4096, 300, 4)),
        ("110-pod segments B=8 N=4 E=440, all potential victims",
         k3_inputs(gen, device, 8, 4, 440, 4, p_vict=1.0, p_cand=1.0,
                   p_reblock=0.0, node_of=full)),
        ("2000-pod segment B=4 N=2 E=4000",
         k3_inputs(gen, device, 4, 2, 4000, 4, p_cand=1.0, p_reblock=0.05,
                   p_clash=0.0, node_of=long_seg)),
        ("all reblocked B=4 N=50 E=2000",
         k3_inputs(gen, device, 4, 50, 2000, 5, p_reblock=1.0)),
        ("R=8 with zero scalar requests B=8 N=333 E=5000",
         k3_inputs(gen, device, 8, 333, 5000, 8)),
        ("33 lanes B=33 N=200 E=3000 R=7",
         k3_inputs(gen, device, 33, 200, 3000, 7)),
        ("INT32_MIN/MAX priorities B=8 N=100 E=2000",
         k3_inputs(gen, device, 8, 100, 2000, 4, prios=edge_prios)),
        ("extreme int32 B=5 N=129 E=3000 R=6",
         k3_inputs(gen, device, 5, 129, 3000, 6, extreme=True)),
        ("no pods B=2 N=10 E=0", k3_inputs(gen, device, 2, 10, 0, 4)),
        ("B=1 N=1 E=1", k3_inputs(gen, device, 1, 1, 1, 4)),
        # the wide variant: R past the registers', as Dims buckets it
        ("wide R=9 B=33 N=200 E=3000",
         k3_inputs(gen, device, 33, 200, 3000, 9)),
        (K3_WIDE_CASE, k3_inputs(gen, device, 8, 5120, 65536, 16)),
        (K3_NARROW_CASE, k3_inputs(gen, device, 8, 5120, 65536, 4)),
        ("wide R=16 extreme int32 B=33 N=129 E=3000",
         k3_inputs(gen, device, 33, 129, 3000, 16, extreme=True)),
        ("wide R=20 2000-pod segment B=4 N=3 E=4000",
         k3_inputs(gen, device, 4, 3, 4000, 20, p_cand=1.0, p_reblock=0.05,
                   p_clash=0.0, node_of=long_seg)),
        ("wide R=64 INT32_MIN/MAX priorities B=33 N=100 E=2000",
         k3_inputs(gen, device, 33, 100, 2000, 64, prios=edge_prios)),
        ("wide R=16 no pods B=2 N=10 E=0",
         k3_inputs(gen, device, 2, 10, 0, 16)),
    ]


def k3_diff(a, b) -> int:
    """Max abs difference over K3's seven outputs (victim, cand and the
    five per-node planes)."""
    import torch

    d = 0
    for name, x, y in zip(a._fields, a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"K3 {name}: {tuple(x.shape)} {x.dtype} != "
                 f"{tuple(y.shape)} {y.dtype}")
        if x.numel():
            d = max(d, int((x.to(torch.int64) - y.to(torch.int64)).abs()
                           .max()))
    return d


def k3_wide_row(device, wide, narrow) -> dict:
    """K3's wide variant (R = 16) at the storm's first-burst widths, timed
    beside the registers variant on inputs of the same B, N and E at R = 4
    (phase 2's K3_WIDE_CASE and K3_NARROW_CASE), each with its bound."""
    from kubernetes_tpu_torch.ops import kernels as K

    out = {}
    for name, args in (("R16", wide), ("R4", narrow)):
        b, by = k3_bound(args, K.reprieve_scan(*args))
        out[name] = dict(
            variant=K.k3_launch_config(args[10].shape[0],
                                       args[10].shape[1]).variant,
            shape=[args[7].shape[0], args[10].shape[0], args[7].shape[1],
                   args[10].shape[1]],
            ms=device_ms(lambda: K.reprieve_scan(*args), device),
            call_ms=time_ms(lambda: K.reprieve_scan(*args), device),
            plain_ms=time_ms(lambda: K.reprieve_scan_plain(*args), device,
                             reps=3),
            bound_ms=b, bound_by=by)
        r = out[name]
        print(f"  reprieve_scan {name} ({r['variant']} variant, B N E R = "
              f"{r['shape']}): {r['ms']:.4f} ms on the device, "
              f"{r['call_ms']:.4f} ms per call (plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.6f} ms by {r['bound_by']})")
    return out


def check_k3(device, cases) -> int:
    """K3 against its plain version on the card, exactly, on all seven
    outputs. Returns the max abs error."""
    from kubernetes_tpu_torch.ops import kernels as K

    err = 0
    for name, args in cases:
        out = K.reprieve_scan(*args)
        d = k3_diff(out, K.reprieve_scan_plain(*args))
        sync(device)
        print(f"  K3 {name}: {int(out.cand.sum())} candidate walks, "
              f"{int(out.victim.sum())} victims, max_abs_err={d}")
        if d != 0:
            fail(f"reprieve_scan disagrees with its plain version ({name})")
        err = max(err, d)
    return err


# --------------------------------------------------------------------------- #
# K4: the sequential-assume scan (phase 2's cases, phase 13)
# --------------------------------------------------------------------------- #

K4_SOURCE = "kubernetes_tpu_torch/csrc/assign_scan.cu"
K4_SWEEP = (1, 2, 4, 8, 16)   # cluster sizes K4 is held and timed at
SCAN_ZONES = ("z-a", "z-b", "z-c")
LEGACY_ZONE = "failure-domain.beta.kubernetes.io/zone"


def scan_workload(T, n_nodes: int, n_pods: int, seed: int = 0,
                  identical: bool = False, scalars: int = 0,
                  terms: bool = True, hostname: bool = False,
                  n_existing: int = None):
    """Phase 2's K4 workloads from the api.types module T (the port's, or
    the JAX package's for the CPU tests): n_nodes nodes over three zones
    (a fifth also with the legacy zone label only; `identical` gives every
    node the same capacity, so scores tie), some with per-driver volume
    limits; n_existing pods bound (default a quarter of n_pods) and n_pods
    pending, random templates over six apps: required affinity and
    anti-affinity, preferred affinity and anti-affinity, hard and soft
    spread (on the hostname key with `hostname`: D ≈ N), SelectorSpread
    selectors, host ports (two pairs and two triples: PWt == PWp), pd
    volumes, `scalars` extended resources (R = 4 + scalars, bucketed),
    three priorities. One pending pod fits nowhere, one is pinned by
    spec.nodeName to a missing node, a few to real ones. `terms=False`
    leaves out every affinity, spread and selector (no term is
    interned)."""
    import random

    rng = random.Random(seed)
    host = "kubernetes.io/hostname"
    zone = "topology.kubernetes.io/zone"
    scal = [f"example.com/r{k}" for k in range(scalars)]
    nodes = []
    for i in range(n_nodes):
        labels = {host: f"n{i}"}
        z = SCAN_ZONES[i % 3]
        if i % 5 == 4:
            labels[LEGACY_ZONE] = z
        elif identical or rng.random() < 0.9:
            labels[zone] = z
        if identical:
            alloc = T.Resources.make(cpu="4", memory="8Gi", pods=20,
                                     scalars={r: 4 for r in scal} or None)
        else:
            alloc = T.Resources.make(
                cpu=rng.choice(["1", "2", "4", "8"]),
                memory=rng.choice(["2Gi", "4Gi", "8Gi"]),
                pods=rng.choice([3, 10, 110]),
                scalars={r: rng.randint(0, 4) for r in scal} or None)
        limits = {"pd": rng.randint(1, 3)} if rng.random() < 0.5 else {}
        nodes.append(T.Node(name=f"n{i}", labels=labels, allocatable=alloc,
                            volume_limits=limits))

    def sel():
        return T.LabelSelector.of(match_labels={"app": f"a{rng.randrange(6)}"})

    def key():
        return host if hostname or rng.random() < 0.4 else zone

    def pod(i, node_name=""):
        aff = T.Affinity()
        spread, ssel = (), ()
        if terms:
            w = lambda: T.WeightedPodAffinityTerm(
                weight=rng.randint(1, 100),
                term=T.PodAffinityTerm(selector=sel(), topology_key=key()))
            aff = T.Affinity(
                pod_required=tuple(
                    T.PodAffinityTerm(selector=sel(), topology_key=key())
                    for _ in range(rng.random() < 0.2)),
                anti_required=tuple(
                    T.PodAffinityTerm(selector=sel(), topology_key=key())
                    for _ in range(rng.random() < 0.25)),
                pod_preferred=tuple(w() for _ in range(rng.random() < 0.3)),
                anti_preferred=tuple(w() for _ in range(rng.random() < 0.3)))
            if rng.random() < 0.4:
                spread = (T.TopologySpreadConstraint(
                    max_skew=rng.randint(1, 2),
                    topology_key=host if hostname else zone,
                    when_unsatisfiable=rng.choice(
                        list(T.UnsatisfiableAction)),
                    selector=sel()),)
            if rng.random() < 0.3:
                ssel = (sel(),)
        ports = ()
        if rng.random() < 0.2:
            ports = (T.HostPort(rng.choice([80, 8080]), "TCP",
                                rng.choice(["", "10.0.0.1"])),)
        vols = ()
        if rng.random() < 0.3:
            vols = tuple(T.VolumeRef(rng.choice(["v1", "v2", "v3", "v4"]),
                                     driver="pd",
                                     read_only=rng.random() < 0.4)
                         for _ in range(rng.randint(1, 2)))
        sc = ({rng.choice(scal): rng.randint(1, 2)}
              if scal and rng.random() < 0.3 else None)
        return T.Pod(
            name=f"p{i}", labels={"app": f"a{rng.randrange(6)}"},
            requests=T.Resources.make(
                cpu=rng.choice(["0", "100m", "500m", "2"]),
                memory=rng.choice(["0", "128Mi", "1Gi"]), scalars=sc),
            affinity=aff, topology_spread=spread, spread_selectors=ssel,
            host_ports=ports, volumes=vols, priority=rng.randrange(3),
            creation_index=i, node_name=node_name)

    n_existing = n_pods // 4 if n_existing is None else n_existing
    existing = [pod(n_pods + i, node_name=f"n{rng.randrange(n_nodes)}")
                for i in range(n_existing)]
    pending = [pod(i) for i in range(n_pods)]
    pending[0] = T.Pod(name="p0-huge", requests=T.Resources.make(cpu="1000"),
                       creation_index=0)
    if n_pods > 1:
        pending[1] = T.Pod(name="p1-ghost", node_name="ghost",
                           requests=T.Resources.make(cpu="100m"),
                           creation_index=1)
    for i in range(2, n_pods, 37):
        pending[i] = dataclasses.replace(pending[i],
                                       node_name=f"n{rng.randrange(n_nodes)}")
    return nodes, existing, pending


# Phase 13: the sequential-assume scan at full width on make_nodes(5000).
# 13a: flagship_pods(SCAN_PODS) with every SCAN_PIN_EVERY-th pending pod
# pinned by spec.nodeName (one pinned pod routes the whole batch to the
# scan); 13b: port_volume_workload(SCAN_NODES, SCAN_PV_PODS) under
# KTPU_ASSIGN=scan. K4 is held to its plain version over the first
# SCAN_CHECK_STEPS steps of each queue (the plain version takes ~8 ms a
# step on the card).
SCAN_NODES, SCAN_PODS, SCAN_PIN_EVERY = 5000, 10000, 100
SCAN_PV_PODS = 5000
SCAN_CHECK_STEPS = 256
# The JAX package's BatchScheduler on both (JAX 0.9.0 on the CPU): the
# scheduled count and the sha256 over the assignments. Reproduce with
# `JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax
# --path scan` (35 s and 19 s on the CPU).
JAX_SCAN = {
    "nodename": {"scheduled": 6792, "sha256":
                 "2a14153c3086899d5692838b478c2cd867dbe4e999491fae9e20533590d91e5c"},
    "ports_volumes": {"scheduled": 5000, "sha256":
                      "76a2099cea74e5522ef7fe47695b8c36c8cadb52142ea0f7242ac3c822088623"},
}


def pinned_flagship(workloads, n_nodes: int, n_pods: int):
    """13a's input: make_nodes(n_nodes) and flagship_pods(n_pods) with every
    SCAN_PIN_EVERY-th pending pod pinned by spec.nodeName to
    node-(7·i mod n_nodes)."""
    nodes = workloads.make_nodes(n_nodes)
    pods = workloads.flagship_pods(n_pods)
    for i in range(0, n_pods, SCAN_PIN_EVERY):
        pods[i] = dataclasses.replace(pods[i],
                                    node_name=f"node-{7 * i % n_nodes}")
    return nodes, pods


def scan_inputs(types, workloads, key: str, n_nodes: int = None):
    """Phase 13's two batches from the given package's api.types and
    models.workloads: (nodes, pods, KTPU_ASSIGN or None) for key
    "nodename" (13a) or "ports_volumes" (13b)."""
    n_nodes = n_nodes or SCAN_NODES
    if key == "nodename":
        return (*pinned_flagship(workloads, n_nodes, SCAN_PODS), None)
    return (*port_volume_workload(n_nodes, SCAN_PV_PODS, types, workloads),
            "scan")


def scan_case(device, nodes, existing, pods, ecfg=None,
              hard_weight: float = 1.0, invalid_every: int = 0,
              trim: bool = False):
    """One K4 input, from the port's encoder on `device`: (tables, cycle,
    pending pods, the queue order, the initial state). `invalid_every`
    marks every such pending pod invalid (as a quota clamp does); `trim`
    cuts the node axis to the real nodes, so N is exactly len(nodes)."""
    import torch
    from kubernetes_tpu_torch.ops.assign import initial_state, queue_order
    from kubernetes_tpu_torch.sched.cycle import (UNSCHEDULABLE_TAINT_KEY,
                                                  _cycle)
    from kubernetes_tpu_torch.state.arrays import tables_to_torch
    from kubernetes_tpu_torch.state.encode import Encoder

    enc = Encoder()
    enc.vocabs.label_keys.intern(UNSCHEDULABLE_TAINT_KEY)
    enc.vocabs.label_vals.intern("")
    tables, ex, pe, d = enc.encode_cluster(nodes, existing, pods)
    keys = (enc.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY),
            enc.vocabs.label_vals.get(""))
    tt, (ext, pet) = tables_to_torch(tables, (ex, pe), device)
    if trim:
        tt = tt._replace(nodes=type(tt.nodes)(
            *(f[:len(nodes)] for f in tt.nodes)))
    cyc = _cycle(tt, ext, keys, d.D, hard_weight, ecfg)
    if invalid_every:
        i = torch.arange(pet.valid.shape[0], device=device)
        pet = pet._replace(valid=pet.valid & (i % invalid_every != 0))
    return (tt, cyc, pet, queue_order(pet).to(torch.int32),
            initial_state(tt, cyc))


def k4_edge_cases(device, seed: int = 0):
    """Phase 2's K4 cases: a mixed workload with invalid rows, identical
    nodes (ties), each of the ten Filter flags off in turn, non-default
    weights with hardPodAffinitySymmetricWeight 2, R = 16 (twelve scalar
    resources), no terms, N = 1, 1,023, 1,025 and 5,120 on the hostname
    key (D ≈ N: the histogram in shared memory), and 29,000 hostname
    domains (the histogram in global memory). Every workload holds a pod
    that fits nowhere, one pinned to a missing node, pods pinned to real
    ones, host ports at PWt == PWp and pd volumes at per-node limits."""
    from kubernetes_tpu_torch.api import types as T
    from kubernetes_tpu_torch.ops.lattice import default_engine_config

    cfg = default_engine_config()
    flags = ("f_unsched", "f_name", "f_ports", "f_node_affinity", "f_fit",
             "f_taints", "f_interpod", "f_spread", "f_volrestrict",
             "f_vollimits")
    cases = [
        ("mixed N=60 R=4, every 7th row invalid",
         scan_case(device, *scan_workload(T, 60, 150, seed),
                   invalid_every=7)),
        ("identical nodes N=33 (ties)",
         scan_case(device, *scan_workload(T, 33, 120, seed + 1,
                                          identical=True))),
    ]
    for k, f in enumerate(flags):
        cases.append((f"{f} off N=48", scan_case(
            device, *scan_workload(T, 48, 100, seed + 10 + k),
            ecfg=cfg._replace(**{f: 0.0}))))
    cases += [
        ("weights least 0.5 most 1 interpod 2 ssel 3, hard weight 2",
         scan_case(device, *scan_workload(T, 48, 120, seed + 2),
                   ecfg=cfg._replace(w_least=0.5, w_most=1.0,
                                     w_interpod=2.0, w_ssel=3.0),
                   hard_weight=2.0)),
        ("R=16 (12 scalar resources) N=64",
         scan_case(device, *scan_workload(T, 64, 150, seed + 3,
                                          scalars=12))),
        ("no terms N=64", scan_case(device, *scan_workload(
            T, 64, 150, seed + 4, terms=False))),
        ("N=1", scan_case(device, *scan_workload(T, 1, 12, seed + 5),
                          trim=True)),
        ("N=1023 hostname key (D = N)", scan_case(
            device, *scan_workload(T, 1023, 100, seed + 6, hostname=True),
            trim=True)),
        ("N=1025 hostname key (D = N)", scan_case(
            device, *scan_workload(T, 1025, 100, seed + 7, hostname=True),
            trim=True)),
        ("N=5120 hostname key (D = N)", scan_case(
            device, *scan_workload(T, 5120, 150, seed + 8, hostname=True),
            trim=True)),
        ("N=29000 hostname key (the histogram in global memory)",
         scan_case(device, *scan_workload(T, 29000, 12, seed + 9,
                                          hostname=True), trim=True)),
    ]
    return cases


def k4_diff(a, b) -> int:
    """Largest difference between two (node, state) results of the scan:
    every node index and all nine state planes, WSYM by its bits."""
    import torch

    (na, sa), (nb, sb) = a, b
    d = 0
    for x, y in [(na, nb)] + list(zip(sa, sb)):
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"K4: {tuple(x.shape)} {x.dtype} != {tuple(y.shape)} "
                 f"{y.dtype}")
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if x.numel():
            d = max(d, int((x.to(torch.int64) - y.to(torch.int64)).abs()
                           .max()))
    return d


def k4_at(args, cluster):
    """K4 on `args` at an explicit cluster size (kernels._k4_launch's
    keyword: the sweep and the card tests only), raising as the wrapper
    does on a status bit; not counted as a launch of the main path."""
    from kubernetes_tpu_torch.ops import kernels as K

    device = args[4].used.device
    ins = K.k4_inputs(*args)
    dims = K.k4_check(ins, device)
    node, state, status, _ = K._k4_launch(ins, dims, args[1].ecfg,
                                          type(args[4]), device,
                                          cluster=cluster)
    K.k4_raise_on_status(status)
    return node, state


def k4_config(args):
    """The K4Launch k4_launch_config picks for `args`."""
    from kubernetes_tpu_torch.ops import kernels as K

    ins = K.k4_inputs(*args)
    return K.k4_launch_config(K.k4_check(ins, args[4].used.device))


def k4_cluster(args) -> int:
    """The cluster size k4_launch_config picks for `args`."""
    return k4_config(args).cluster


def k4_shape(args) -> str:
    """K4's launch shape for `args`, as phases 12a and 13 print it: the
    cluster, each CTA's nodes, threads and dynamic shared bytes, and the
    optional regions placed in shared memory."""
    from kubernetes_tpu_torch.ops import kernels as K

    cfg = k4_config(args)
    placed = [n for b, n in enumerate(K.K4_PLACE) if cfg.place >> b & 1]
    return (f"cluster {cfg.cluster}, {cfg.slice} nodes and {cfg.threads} "
            f"threads a CTA, {cfg.smem_bytes} bytes of shared memory a CTA "
            f"of {K.SMEM_MAX} (placed there: {', '.join(placed) or 'none'})")


def check_k4(device, cases, clusters=K4_SWEEP) -> int:
    """K4 against its plain version on the card, exactly: every node and
    all nine planes (WSYM bitwise); the initial state unchanged by the
    kernel. Each case through the wrapper (the cluster size it picks) and
    at each of `clusters`. Returns the max abs error."""
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops.assign import assign_scan_plain

    err = 0
    for name, args in cases:
        before = [t.clone() for t in args[4]]
        want = assign_scan_plain(*args)
        got = K.assign_scan(*args)
        sync(device)
        if not all(torch.equal(x, y) for x, y in zip(before, args[4])):
            fail(f"assign_scan wrote its initial state ({name})")
        d = k4_diff(got, want)
        diffs = {}
        for c in clusters:
            diffs[c] = k4_diff(k4_at(args, c), want)
            sync(device)
        if not all(torch.equal(x, y) for x, y in zip(before, args[4])):
            fail(f"assign_scan wrote its initial state ({name})")
        pods = args[2]
        placed = int((got[0] >= 0).sum())
        print(f"  K4 {name}: N={args[0].nodes.valid.shape[0]} "
              f"S={args[1].TM.shape[0]} D+1={args[1].ELD.shape[2]} "
              f"R={args[0].nodes.alloc.shape[1]}, {int(pods.valid.sum())} "
              f"valid rows, {placed} placed; cluster {k4_cluster(args)} "
              f"max_abs_err={d}; by cluster size {diffs}")
        if d != 0 or any(diffs.values()):
            fail(f"assign_scan disagrees with its plain version ({name})")
        err = max([err, d] + list(diffs.values()))
    return err


def k4_device_fn(args, cluster=None):
    """K4's launch alone on checked inputs, with no status readback, so
    device_ms's GPU spin can hold the stream while the launches queue;
    at `cluster` CTAs when given."""
    from kubernetes_tpu_torch.ops import kernels as K

    device = args[4].used.device
    ins = K.k4_inputs(*args)
    dims = K.k4_check(ins, device)
    return lambda: K._k4_launch(ins, dims, args[1].ecfg, type(args[4]),
                                device, cluster=cluster)


def k4_sweep(device, args, reps: int = 3) -> dict:
    """K4's device ms on `args` at each cluster size of K4_SWEEP."""
    return {c: device_ms(k4_device_fn(args, c), device, reps=reps)
            for c in K4_SWEEP}


def k4_bound(args) -> tuple:
    """(bound_ms, bound_by) for K4 on `args`, counted from this run's data.
    Bytes: each input read once and each output (node, the nine state
    planes) written once. Operations, for each walked row of class c: on
    the valid nodes c's static Filter row passes, the fit test over R
    slots (under f_fit), the port words where c has a port set (under
    f_ports), the volume words and per-driver popcounts where c has a
    volume set (under f_volrestrict / f_vollimits); on every valid node a
    few for each term slot of c and each term c matches (the spread
    histograms, the domain totals); the Score's ~60 on each (row, node)
    pair the Filter passed (K4's own count, read from one launch on these
    inputs); and per placed row the commit over the S terms."""
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops.lattice import _on

    tables, cyc, pods, rows, init = args
    device = init.used.device
    ins = K.k4_inputs(*args)
    d = K.k4_check(ins, device)
    node, _, _, scored = k4_device_fn(args)()
    sync(device)
    walked = rows.long()[pods.valid[rows.long()]]
    c = pods.cls[walked].long()
    placed = int((node[walked] >= 0).sum())
    cl, ecfg, valid = tables.classes, cyc.ecfg, tables.nodes.valid
    i64 = lambda t: t.to(torch.int64)  # noqa: E731
    static = i64((cyc.static.mask & valid).sum(1))               # [SC]
    slots = sum(i64((getattr(cl, f) >= 0).sum(1)) for f in (
        "aff_terms", "anti_terms", "paff_terms", "panti_terms", "tsc_term",
        "ssel_terms"))
    matched = i64(cyc.TM.sum(0))                                 # [SC]
    per_node = (6 * d["R"] * int(_on(ecfg.f_fit))
                + i64(cl.portset >= 0) * (4 * (2 * d["PWp"] + d["PWt"])
                                         * int(_on(ecfg.f_ports)))
                + i64(cl.volset >= 0) * (
                    4 * d["VW"] * int(_on(ecfg.f_volrestrict))
                    + 3 * d["DR"] * d["VW"] * int(_on(ecfg.f_vollimits))))
    per_row = static * per_node + int(valid.sum()) * 4 * (slots + matched)
    ops = (int(per_row[c].sum()) + 60 * int(scored)
           + placed * d["S"] * 8)
    b = nbytes(ins.values()) + nbytes(init) + 4 * d["P"]
    t_b, t_o = b / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def k4_even_bound_case(device):
    """A K4 input whose even-spread total passes 2^24 while every node's
    own count stays far below it: 64 identical nodes over three zones,
    8 pending pods with a ScheduleAnyway zone spread over their own app,
    and existing pods standing for 20,000 matching pods on every node
    (the spread term's CNT raised to that). Each node's count is its
    zone's, ~430,000; the eligible nodes' total ~27.5 million. The plain
    version sums that total in f32, which rounds past 2^24, so K4 must
    refuse it (K4_STATUS's even-spread bit) — whatever share of the
    nodes one thread owns."""
    from kubernetes_tpu_torch.api import types as T

    zone, host = "topology.kubernetes.io/zone", "kubernetes.io/hostname"
    nodes = [T.Node(name=f"n{i}",
                    labels={host: f"n{i}", zone: SCAN_ZONES[i % 3]},
                    allocatable=T.Resources.make(cpu="4", memory="8Gi",
                                                 pods=110))
             for i in range(64)]
    app = T.LabelSelector.of(match_labels={"app": "even"})
    spread = (T.TopologySpreadConstraint(
        max_skew=1, topology_key=zone,
        when_unsatisfiable=T.UnsatisfiableAction.SCHEDULE_ANYWAY,
        selector=app),)
    pods = [T.Pod(name=f"e{i}", labels={"app": "even"},
                  requests=T.Resources.make(cpu="100m"),
                  topology_spread=spread, creation_index=i)
            for i in range(8)]
    existing = [dataclasses.replace(pods[0], name="e-bound", node_name="n0",
                                    creation_index=8)]
    tables, cyc, pe, rows, init = scan_case(device, nodes, existing, pods)
    cl = tables.classes
    soft = (cl.tsc_term >= 0) & ~cl.tsc_hard
    terms = cl.tsc_term[soft].unique().long()
    CNT = init.CNT.clone()
    CNT[terms] = (tables.nodes.valid.to(CNT.dtype) * 20000)[None]
    return tables, cyc, pe, rows, init._replace(CNT=CNT)


def check_k4_status(device) -> None:
    """K4 refuses an input whose even-spread total passes 2^24 (the plain
    version's f32 sum would round): the wrapper raises, naming the bit —
    through the wrapper, and at every cluster size above 1, where each
    CTA's share of the total stays under 2^24 and only the cluster's total
    passes it."""
    from kubernetes_tpu_torch.ops import kernels as K

    args = k4_even_bound_case(device)
    for c in (None,) + tuple(c for c in K4_SWEEP if c > 1):
        try:
            if c is None:
                K.assign_scan(*args)
            else:
                k4_at(args, c)
        except ValueError as e:
            if "even-spread total" not in str(e):
                fail(f"K4 refused the even-spread case for another reason "
                     f"(cluster {c}): {e}")
            print(f"  K4 even-spread total past 2^24, cluster "
                  f"{c or k4_cluster(args)}: refused ({e})")
            continue
        fail(f"K4 took an even-spread total past 2^24 without raising "
             f"(cluster {c})")


def check_k4_steps(device, args, steps: int, label: str) -> tuple:
    """K4 against its plain version over the first `steps` rows of a
    recorded scan, exactly. Returns (max abs error, the plain version's
    seconds, the sub-scan's args)."""
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops.assign import assign_scan_plain

    tables, cyc, pods, rows, init = args
    sub = (tables, cyc, pods, rows[:steps].contiguous(), init)
    t0 = time.perf_counter()
    want = assign_scan_plain(*sub)
    sync(device)
    plain_s = time.perf_counter() - t0
    d = k4_diff(K.assign_scan(*sub), want)
    sync(device)
    if d != 0:
        fail(f"{label}: assign_scan disagrees with its plain version over "
             f"the first {steps} rows (max_abs_err={d})")
    return d, plain_s, sub


def scan_phase(device, card: str) -> dict:
    """Phase 13 on the card: 13a the nodeName route and 13b KTPU_ASSIGN=scan
    through BatchScheduler(device), each against JAX_SCAN (scheduled count,
    placement sha256); K4 launched on the route and the plain version not
    called there (counts set to 0 just before the cycle, read just after);
    K4 against its plain version over the first SCAN_CHECK_STEPS rows; the
    full launch's device time and the time per step."""
    import os

    from kubernetes_tpu_torch import BatchScheduler
    from kubernetes_tpu_torch.api import types
    from kubernetes_tpu_torch.models import workloads
    from kubernetes_tpu_torch.ops import assign as A
    from kubernetes_tpu_torch.ops import kernels as K

    if JAX_SCAN is None:
        fail("phase 13: JAX_SCAN is not recorded")
    out = {}
    for key, label in (("nodename", "13a"), ("ports_volumes", "13b")):
        nodes, pods, engine = scan_inputs(types, workloads, key)
        saved = os.environ.get("KTPU_ASSIGN")
        if engine:
            os.environ["KTPU_ASSIGN"] = engine
        rec = Recorder(A, "assign_scan")
        try:
            sched = BatchScheduler(device=device)
            K.reset_launch_counts()
            A.assign_scan_plain.calls = 0
            t0 = time.perf_counter()
            res = sched.schedule(nodes, [], pods)
            sync(device)
            wall = time.perf_counter() - t0
            launches = K.launch_counts()
            plain_calls = A.assign_scan_plain.calls
        finally:
            rec.restore()
            if saved is None:
                os.environ.pop("KTPU_ASSIGN", None)
            else:
                os.environ["KTPU_ASSIGN"] = saved
        got = {"scheduled": res.scheduled,
               "sha256": assignments_sha256(res.assignments)}
        ref = JAX_SCAN[key]
        if got != {k: ref[k] for k in got}:
            fail(f"{label}: {got} differs from JAX_SCAN's "
                 f"{ {k: ref[k] for k in got} }")
        if device.type == "cuda" and (launches["assign_scan"] < 1
                                      or plain_calls):
            fail(f"{label}: K4 launched {launches['assign_scan']} times, "
                 f"the plain version called {plain_calls} times")
        args = rec.args
        err, plain_s, sub = check_k4_steps(device, args, SCAN_CHECK_STEPS,
                                           label)
        steps = int(args[2].valid.sum())
        ms = device_ms(k4_device_fn(args), device, reps=3)
        sub_ms = device_ms(k4_device_fn(sub), device, reps=5)
        call_ms = time_ms(lambda: K.assign_scan(*args), device, reps=3)
        b, by = k4_bound(args)
        sweep = k4_sweep(device, args)
        out[key] = dict(
            nodes=len(nodes), pods=len(pods), steps=steps,
            scheduled=res.scheduled, cycle_s=wall, launches=launches,
            plain_calls=plain_calls, max_abs_err=err, ms=ms,
            step_us=ms / max(steps, 1) * 1e3, call_ms=call_ms,
            cluster=k4_cluster(args),
            sweep_ms=sweep,
            sweep_step_us={c: t / max(steps, 1) * 1e3
                           for c, t in sweep.items()},
            check_steps=SCAN_CHECK_STEPS, check_ms=sub_ms,
            plain_ms=plain_s * 1e3,
            plain_step_ms=plain_s * 1e3 / SCAN_CHECK_STEPS,
            bound_ms=b, bound_by=by)
        r = out[key]
        r["check_bound_ms"], r["check_bound_by"] = k4_bound(sub)
        print(f"  {label}: {len(nodes)} nodes x {len(pods)} pods, "
              f"{res.scheduled} scheduled == JAX_SCAN, placement sha256 "
              f"equal; cycle {wall:.3f} s; launches {launches}, plain "
              f"calls {plain_calls}; K4 (cluster {r['cluster']}) "
              f"{ms:.3f} ms on the device for {steps} steps "
              f"({r['step_us']:.2f} us a step; {call_ms:.3f} ms a call; "
              f"bound {b:.6f} ms by {by}); the first {SCAN_CHECK_STEPS} "
              f"rows: K4 {sub_ms:.3f} ms, plain {r['plain_ms']:.1f} ms "
              f"({r['plain_step_ms']:.3f} ms a step), max_abs_err={err} "
              f"({card})")
        print(f"    {label} cluster-size sweep, us a step: "
              + ", ".join(f"{c}: {t:.2f}"
                          for c, t in r["sweep_step_us"].items()))
        print(f"    {label} K4 launch: {k4_shape(args)}")
    return out


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def edge_cases(device, seed: int = 0):
    """Phase 2's cases. K1: class counts around the warp's 32 lanes (1, 31,
    32, 33, 300), node counts off the block (1, 33, 5,000), widths at the
    registers variant's bounds (R 8; PW, PT, VW, DR 4) and one past each, so
    both variants run, PT != PW, and extreme int32 requests on both variants.
    K2: counters in shared memory (up to 227 KB) and in the scratch (D+1 =
    70,000, whose counters alone pass 227 KB; rows striding over fewer
    blocks), one domain for a whole row (ranks up to N - 1), N = 1, N off
    the segment size."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    k1 = [
        ("flagship shape SC=52 N=5120 R=4",
         k1_inputs(gen, device, 52, 5120, 4, 1, 1, 1, 2)),
        ("SC=1 N=1 R=4 PW=1 PT=2 VW=1 DR=1",
         k1_inputs(gen, device, 1, 1, 4, 1, 2, 1, 1)),
        ("SC=31 N=33 at the register bounds R=8 PW=PT=VW=DR=4",
         k1_inputs(gen, device, 31, 33, 8, 4, 4, 4, 4)),
        ("SC=32 N=5000 R=8 PW=4 PT=3 VW=4 DR=4",
         k1_inputs(gen, device, 32, 5000, 8, 4, 3, 4, 4)),
        ("SC=33 N=33 shared variant, R=9 one past",
         k1_inputs(gen, device, 33, 33, 9, 4, 4, 4, 4)),
        ("SC=33 N=1 shared variant, PW=5 one past, PT=2",
         k1_inputs(gen, device, 33, 1, 4, 5, 2, 1, 1)),
        ("SC=300 N=5000 R=6 PW=2 PT=3 VW=2 DR=3",
         k1_inputs(gen, device, 300, 5000, 6, 2, 3, 2, 3)),
        ("SC=300 N=5000 shared variant, PT=5 VW=5 DR=5 one past",
         k1_inputs(gen, device, 300, 5000, 5, 2, 5, 5, 5)),
        ("extreme int32 requests SC=64 N=1031",
         k1_inputs(gen, device, 64, 1031, 5, 1, 1, 1, 2, extreme=True)),
        ("extreme int32 requests SC=40 N=33 shared variant, R=9",
         k1_inputs(gen, device, 40, 33, 9, 2, 1, 1, 2, extreme=True)),
    ]
    one = torch.full((4, 5120), 77, dtype=torch.int32, device=device)
    k2 = [
        ("flagship shape rows=104 N=5120 D+1=5121",
         (k2_inputs(gen, device, 104, 5120, 5121), 5121)),
        ("rows=7 N=5001 D+1=17", (k2_inputs(gen, device, 7, 5001, 17), 17)),
        ("rows=3 N=9000 D+1=13000 (>48 KB counters)",
         (k2_inputs(gen, device, 3, 9000, 13000), 13000)),
        ("rows=5 N=8000 D+1=70000 (scratch counters)",
         (k2_inputs(gen, device, 5, 8000, 70000), 70000)),
        ("rows=200 N=1000 D+1=70000 (scratch, blocks stride over rows)",
         (k2_inputs(gen, device, 200, 1000, 70000), 70000)),
        ("rows=4 N=5120 one domain per row (ranks to N-1)", (one, 5121)),
        ("rows=3 N=1 D+1=5", (k2_inputs(gen, device, 3, 1, 5), 5)),
        ("rows=6 N=5001 D+1=3000 (N off the segment size)",
         (k2_inputs(gen, device, 6, 5001, 3000), 3000)),
        ("rows=6 N=1000 D+1=3 (16 segments of 64)",
         (k2_inputs(gen, device, 6, 1000, 3), 3)),
    ]
    return k1, k2


# --------------------------------------------------------------------------- #
# the port-and-volume cycle
# --------------------------------------------------------------------------- #

def port_volume_workload(n_nodes: int, n_pods: int, types=None,
                         workloads=None, groups: int = 48):
    """make_nodes(n_nodes) with per-driver attach limits on four nodes of
    five, and a pending backlog of n_pods in `groups` deployment groups where
    a share carry host ports and attachable volumes:
      * every third group binds four host ports (one on the wildcard IP, three
        on group-specific IPs, TCP and UDP), drawn from 29 port numbers, so
        groups collide on ports: 38 (proto, port) pairs and 48 triples, two
        words each (PWp == PWt, as the JAX package needs);
      * groups g % 4 == 1 mount two read-write "pd" disks, one of eight of the
        group's own and one of twelve shared across groups (classes collide
        on it); groups g % 4 == 3 mount a shared read-only "ebs" volume and
        one of three read-write ones of their own — 147 volumes, 5 words;
      * even groups spread across zones (hard, maxSkew 4).
    `types`/`workloads` are the port's api.types and models.workloads by
    default; scripts/flagship_reference.py passes the JAX package's, to
    build the same input for it."""
    if types is None:
        from kubernetes_tpu_torch.api import types
    if workloads is None:
        from kubernetes_tpu_torch.models import workloads
    nodes = workloads.make_nodes(n_nodes)
    for i, node in enumerate(nodes):
        if i % 5:
            node.volume_limits = {"pd": 2 + i % 4, "ebs": 1 + i % 3}
    tiers = [("100m", "128Mi"), ("250m", "512Mi"), ("500m", "1Gi"),
             ("1", "2Gi")]
    pods = []
    for i in range(n_pods):
        g, j = i % groups, i // groups % 24
        app = f"pv-{g}"
        ports, vols, spread = (), (), ()
        if g % 3 == 0:
            ports = tuple(types.HostPort(
                port=7000 + (5 * g + k) % 29,
                protocol="UDP" if k == 2 else "TCP",
                host_ip="" if k == 0 else f"10.0.{k}.{g}") for k in range(4))
        if g % 4 == 1:
            vols = (types.VolumeRef(f"disk-{g}-{j % 8}", driver="pd"),
                    types.VolumeRef(f"disk-shared-{(g // 4 + j % 8) % 12}",
                                    driver="pd"))
        elif g % 4 == 3:
            vols = (types.VolumeRef(f"data-{g % 6}", driver="ebs",
                                    read_only=True),
                    types.VolumeRef(f"scratch-{g}-{j % 3}", driver="ebs"))
        if g % 2 == 0:
            spread = (types.TopologySpreadConstraint(
                max_skew=4, topology_key=workloads.ZONE,
                when_unsatisfiable=types.UnsatisfiableAction.DO_NOT_SCHEDULE,
                selector=types.LabelSelector.of(match_labels={"app": app})),)
        cpu, mem = tiers[g % len(tiers)]
        pods.append(types.Pod(
            name=f"pv-{g}-{i}", labels={"app": app},
            requests=types.Resources.make(cpu=cpu, memory=mem),
            host_ports=ports, volumes=vols, topology_spread=spread,
            priority=g % 3, creation_index=i))
    return nodes, pods


# --------------------------------------------------------------------------- #
# phase 5: serving on resident state (shared with scripts/flagship_reference.py)
# --------------------------------------------------------------------------- #

class FakeClock:
    """A scheduler clock that stands still unless moved: backoff and the
    assume TTL then depend on the script, not on how fast the host is."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def port_serving_api(device):
    """What phase 5 drives, from the port, on `device`. The reference script
    builds the same namespace from the JAX package, so both packages run the
    one script below."""
    import types as pytypes

    import kubernetes_tpu_torch as ktt
    from kubernetes_tpu_torch.api import types
    from kubernetes_tpu_torch.models import workloads
    from kubernetes_tpu_torch.sched.cycle import (schedule_batch,
                                                  snapshot_with_keys)
    from kubernetes_tpu_torch.state.dims import Dims
    from kubernetes_tpu_torch.state.encode import Encoder

    from kubernetes_tpu_torch import extender, framework
    from kubernetes_tpu_torch.sched.config import load_config
    from kubernetes_tpu_torch.sched.ledger import BindIntentLedger
    from kubernetes_tpu_torch.storage.store import Storage
    from kubernetes_tpu_torch.utils import faultline

    def dispatch(snap, keys):
        node = schedule_batch(snap.tables, snap.pending, keys, snap.dims.D,
                              snap.existing,
                              has_node_name=snap.dims.has_node_name).node
        sync(device)
        return node

    made = []

    def scheduler(**kw):
        s = ktt.Scheduler(device=device, **kw)
        made.append(s)
        return s

    return pytypes.SimpleNamespace(
        types=types, workloads=workloads, Dims=Dims, Encoder=Encoder,
        SchedulerCache=ktt.SchedulerCache,
        RecordingBinder=ktt.RecordingBinder,
        snapshot=lambda cache, enc, pods, base: snapshot_with_keys(
            cache, enc, pods, base, device=device),
        dispatch=dispatch,
        readback=lambda node: node.cpu().tolist(),
        scheduler=scheduler, made=made, preemptor=ktt.Preemptor,
        ledger=BindIntentLedger, storage=Storage, faultline=faultline,
        load_config=load_config, framework=framework, extender=extender,
        backend=lambda **kw: extender.ExtenderBackend(device=device, **kw))


def settle(api, phase: str, fallback_ok: bool = False,
           prewarm_ok: bool = False) -> None:
    """Joins the background warms of every Scheduler the phase made (no
    thread of the port may outlive the script), and checks that each ran
    every dispatch on its own device: unless the phase configured one, no
    fallback may have served a wave. Unless the phase turned the prewarmer
    on, no warm ran either, so the launch counts read after this are the
    main path's own."""
    for s in api.made:
        s.prewarmer.wait(300)
        if s.prewarmer.warm_log and not prewarm_ok:
            fail(f"phase {phase}: the prewarmer warmed "
                 f"{len(s.prewarmer.warm_log)} signatures")
        if fallback_ok:
            continue
        st = s.supervisor.stats
        if st.fallback_dispatches or st.degraded_cycles:
            fail(f"phase {phase}: a dispatch fell back "
                 f"({st.fallback_dispatches} fallback dispatches)")


def bound_sha256(bound) -> str:
    """sha256 over a binder's ordered (pod key, node) list."""
    return hashlib.sha256("\n".join(
        f"{k} {n}" for k, n in bound).encode()).hexdigest()


def serving_steady(api, n_nodes: int, n_pods: int, cycles: int = 2) -> dict:
    """Phase 5a: the steady state of a serving cycle on the resident cache
    (bench.py's flagship stage): make_nodes(n_nodes) into a SchedulerCache,
    flagship_pods(n_pods) pending with base Dims(N, P, E=1); one cold
    snapshot (full) and cycle, then `cycles` steady cycles that each churn
    one node (update_node) and replace pods[0] with a copy, so the node rows
    and the pending block both patch. Per cycle: snapshot mode, rows
    patched, placed count and placement sha256, and the split — snapshot,
    dispatch (to a synchronize), readback, host mapping — in seconds."""
    import dataclasses

    nodes = api.workloads.make_nodes(n_nodes)
    pods = api.workloads.flagship_pods(n_pods)
    base = api.Dims(N=n_nodes, P=n_pods, E=1)
    cache, enc = api.SchedulerCache(), api.Encoder()
    for n in nodes:
        cache.add_node(n)
    enc.intern_pods(pods)

    def cycle(pending):
        t0 = time.perf_counter()
        snap, keys = api.snapshot(cache, enc, pending, base)
        t1 = time.perf_counter()
        node = api.dispatch(snap, keys)
        t2 = time.perf_counter()
        idx = api.readback(node)
        t3 = time.perf_counter()
        placed = [snap.node_order[i] if i >= 0 else None
                  for i in idx[: len(pending)]]
        t4 = time.perf_counter()
        return dict(mode=cache.last_snapshot_mode,
                    patch_rows=cache.last_patch_rows,
                    scheduled=sum(a is not None for a in placed),
                    sha256=assignments_sha256(placed),
                    snapshot_s=t1 - t0, dispatch_s=t2 - t1,
                    readback_s=t3 - t2, map_s=t4 - t3)

    out = [cycle(pods)]
    for i in range(cycles):
        cache.update_node(nodes[i])
        pods = list(pods)
        pods[0] = dataclasses.replace(pods[0])
        out.append(cycle(pods))
    return {"cycles": out}


def fresh_pods(T, n_pods: int) -> list:
    """The 3 fresh single pods that arrive after phase 5b's drain."""
    return [T.Pod(name=f"fresh-{i}", labels={"app": "fresh"},
                  requests=T.Resources.make(cpu="100m", memory="128Mi"),
                  creation_index=n_pods + i) for i in range(3)]


def serving_drain(api, n_nodes: int, n_pods: int,
                  batch_size: int = SERVING_BATCH,
                  on_wave=None, keep_bound=None,
                  workload: str = "flagship", clock=None,
                  before_wave=None, after_wave=None, keep=None,
                  sched_kw=None, setup=None, node_fn=None) -> dict:
    """Phase 5b: the wave loop. A Scheduler(RecordingBinder, batch_size,
    microwave=True) on a still clock over make_nodes(n_nodes), with
    base_dims sized to the drain (N, P = batch_size, E = n_pods) and a
    flagship_pods(n_pods) backlog fed through on_pod_add, drained one wave at
    a time by run_until_idle(max_waves=1). Between waves the wave's bound
    pods are confirmed through on_pod_add with node_name set (the informer
    confirmation) and one node is updated, so the patch path carries node,
    existing-pod and pending rows. Pods a wave cannot place wait in the
    backoff queue (the clock does not move), so the drain ends when the
    active queue is empty. Then 3 fresh single pods arrive: the next
    schedule_pending must be a micro wave. `on_wave(i)` is called after each
    wave's run (chip_smoke.py reads its timings there). The binder's
    (pod key, node) list is appended to `keep_bound` when one is given.
    `workload="classes"` drains deployment_backlog_pods(n_pods,
    deployments=200) instead (phase 8c); each wave also records the class
    runs the run-collapsed engine reported (0 under the other engines).
    `clock` replaces the still clock; `before_wave(w, s)` and
    `after_wave(w, s)` run around wave w (phase 9b injects faults there);
    a wave whose dispatch was abandoned is retried once the device is
    re-admitted and listed under "aborted" (wave, pods), not in "waves".
    The Scheduler is appended to `keep` when one is given. `sched_kw` adds
    constructor arguments, `setup(s)` runs on the new Scheduler before any
    event, and `node_fn(W, n_nodes)` builds the nodes instead of make_nodes
    (phase 10a: a configured framework on labelled nodes)."""
    import dataclasses

    T = api.types
    nodes = (node_fn or (lambda W, n: W.make_nodes(n)))(api.workloads,
                                                        n_nodes)
    pods = (api.workloads.flagship_pods(n_pods) if workload == "flagship"
            else api.workloads.deployment_backlog_pods(
                n_pods, deployments=CLASSES_DEPLOYMENTS))
    by_key = {p.key: p for p in pods}
    binder = api.RecordingBinder()
    s = api.scheduler(binder=binder, batch_size=batch_size, microwave=True,
                      clock=clock or FakeClock(),
                      base_dims=api.Dims(N=n_nodes, P=batch_size, E=n_pods),
                      **(sched_kw or {}))
    if setup is not None:
        setup(s)
    if keep is not None:
        keep.append(s)
    if s.governor is not None:
        # wall-clock wave sizing would make the waves depend on the host
        fail("phase 5 runs with KTPU_OVERLOAD=0 (the overload governor off)")
    for n in nodes:
        s.on_node_add(n)
    for p in pods:
        s.on_pod_add(p)
    waves = []

    def note(st):
        waves.append(dict(attempted=st.attempted, scheduled=st.scheduled,
                          unschedulable=st.unschedulable, micro=st.micro,
                          mode=s.cache.last_snapshot_mode,
                          patch_rows=s.cache.last_patch_rows,
                          class_runs=st.class_runs))
        if on_wave is not None:
            on_wave(len(waves) - 1)

    w, aborted = 0, []
    while w < 4 * (n_pods // batch_size + 2):
        first = len(binder.bound)
        if before_wave is not None and not (aborted and aborted[-1][0] == w):
            before_wave(w, s)  # once per wave, not again on its retry
        st = s.run_until_idle(max_waves=1)
        if st.aborted:
            # an abandoned dispatch (phase 9b): the batch is back in the
            # queue untouched; retry the same wave once the prober has
            # re-admitted the device, with no informer events between
            aborted.append((w, st.aborted))
            if not s.supervisor.wait_recovered(60):
                fail(f"the device was not re-admitted after wave {w}")
            continue
        note(st)
        if after_wave is not None:
            after_wave(w, s)
        for key, node in binder.bound[first:]:
            s.on_pod_add(dataclasses.replace(by_key[key], node_name=node))
        s.on_node_update(nodes[w % n_nodes])
        w += 1
        if s.queue.lengths()[0] == 0:
            break
    for p in fresh_pods(T, n_pods):
        s.on_pod_add(p)
    note(s.schedule_pending())
    if keep_bound is not None:
        keep_bound.extend(binder.bound)
    out = {"waves": waves, "bound": len(binder.bound),
           "bound_sha256": bound_sha256(binder.bound),
           "counts": list(s.cache.counts()),
           "queue": list(s.queue.lengths())}
    if aborted:
        out["aborted"] = aborted
    return out


# --------------------------------------------------------------------------- #
# phase 9a: crash and takeover (shared with scripts/flagship_reference.py)
# --------------------------------------------------------------------------- #

class DurableBinder:
    """The Binding registry a crash cannot erase: binds survive the
    leader's death, and — like the apiserver's already-assigned guard — a
    second bind of one pod is REFUSED and counted."""

    def __init__(self):
        self.bound = {}            # pod key → node name
        self.double_bind_attempts = 0
        self.bind_log = []         # every accepted (key, node), in order

    def bind(self, pod, node_name):
        if pod.key in self.bound:
            self.double_bind_attempts += 1
            return False
        self.bound[pod.key] = node_name
        self.bind_log.append((pod.key, node_name))
        return True


def _wave_row(st, s) -> tuple:
    return (st.attempted, st.scheduled, st.unschedulable, st.micro,
            s.cache.last_snapshot_mode, s.cache.last_patch_rows)


def restart_drill(api, n_nodes: int, n_pods: int,
                  batch_size: int = SERVING_BATCH, on_wave=None,
                  keep=None) -> dict:
    """Phase 9a: phase 5b's backlog (make_nodes(n_nodes) x
    flagship_pods(n_pods), still clock, microwave=True) drained by a leader
    Scheduler with a BindIntentLedger over one store, while a standby
    incarnation over the same store gets the same informer events (a bound
    pod leaves its pending queue and enters its cache) and beats
    warm_standby() after each leader wave — which must leave its queue
    lengths, its assumes and the binder's log unchanged. The leader dies
    (proc.crash) at post_intent of its RESTART_CRASH_WAVE-th intent-writing
    wave: that wave's intent is durable, none of its Bindings are. The
    standby then runs recover() against informer truth (the binder), beats
    once more (its informer now holds the recovered Bindings, and the
    backlog its first led wave pops is the one after the crashed wave's),
    and drains the rest. Returns the per-wave counts and snapshot modes of
    both, the RecoveryReport, the binder's outcome and the ledger counters;
    `timing` holds the host times (not compared). `on_wave(role, w)` is
    called after each wave."""
    import dataclasses

    nodes = api.workloads.make_nodes(n_nodes)
    pods = api.workloads.flagship_pods(n_pods)
    by_key = {p.key: p for p in pods}
    store = api.storage()
    binder = DurableBinder()
    fl = api.faultline

    def boot():
        s = api.scheduler(binder=binder, batch_size=batch_size,
                          microwave=True, clock=FakeClock(),
                          ledger=api.ledger(store),
                          base_dims=api.Dims(N=n_nodes, P=batch_size,
                                             E=n_pods))
        if s.governor is not None:
            fail("phase 9 runs with KTPU_OVERLOAD=0 (the governor off)")
        for n in nodes:
            s.on_node_add(n)
        for p in pods:
            s.on_pod_add(p)
        if keep is not None:
            keep.append(s)
        return s

    leader, standby = boot(), boot()
    seen = 0       # binder entries the standby's informer has delivered

    def inform_standby(w=None):
        """The standby's informer: each new Binding moves its pod out of
        the pending queue into the cache; then a node update (wave w)."""
        nonlocal seen
        for key, node in binder.bind_log[seen:]:
            standby.on_pod_delete(by_key[key])
            standby.on_pod_add(dataclasses.replace(by_key[key],
                                                   node_name=node))
        seen = len(binder.bind_log)
        if w is not None:
            standby.on_node_update(nodes[w % n_nodes])

    leader_waves, beats = [], []
    fl.install(f"proc.crash@post_intent:{RESTART_CRASH_WAVE}")
    w = 0
    try:
        while w < 4 * (n_pods // batch_size + 2):
            first = len(binder.bind_log)
            st = leader.schedule_pending()
            leader_waves.append(_wave_row(st, leader))
            for key, node in binder.bind_log[first:]:
                leader.on_pod_add(dataclasses.replace(by_key[key],
                                                      node_name=node))
            leader.on_node_update(nodes[w % n_nodes])
            inform_standby(w)
            before = (standby.queue.lengths(), standby.cache.counts(),
                      len(binder.bind_log))
            t0 = time.perf_counter()
            standby.warm_standby()
            beats.append(time.perf_counter() - t0)
            if (standby.queue.lengths(), standby.cache.counts(),
                    len(binder.bind_log)) != before:
                fail("warm_standby changed the standby's queue, its assumes "
                     "or the binder")
            if on_wave is not None:
                on_wave("leader", w)
            w += 1
        fail("the leader never crashed")
    except fl.InjectedCrash:
        crashed_wave = len(leader_waves) + 1
    finally:
        fl.uninstall()
    intents_left = len(api.ledger(store).unretired())
    at_crash = len(binder.bind_log)

    def truth(key):
        pod = by_key.get(key)
        node = binder.bound.get(key, "")
        return dataclasses.replace(pod, node_name=node) if node else pod

    t0 = time.perf_counter()
    report = standby.recover(lookup=truth)
    recover_s = time.perf_counter() - t0
    # the takeover's last standby beat: the recovered Bindings reach its
    # informer, and warm_standby interns and snapshots the backlog its
    # first led wave pops (the crashed wave's pods, which the earlier beats
    # held, are bound now)
    inform_standby()
    t0 = time.perf_counter()
    standby.warm_standby()
    beats.append(time.perf_counter() - t0)
    standby_waves, led_s = [], []
    while w < 8 * (n_pods // batch_size + 2):
        t0 = time.perf_counter()
        st = standby.run_until_idle(max_waves=1)
        led_s.append(time.perf_counter() - t0)
        standby_waves.append(_wave_row(st, standby))
        if on_wave is not None:
            on_wave("standby", w)
        inform_standby(w)
        w += 1
        if standby.queue.lengths()[0] == 0:
            break
    rep = dataclasses.asdict(report)
    rep["errors"] = len(rep["errors"])
    return {
        "leader_waves": leader_waves, "crashed_wave": crashed_wave,
        "intents_left_at_crash": intents_left, "bound_at_crash": at_crash,
        "report": rep, "standby_waves": standby_waves,
        "bound": len(binder.bound),
        "bind_log_sha256": bound_sha256(binder.bind_log),
        "bound_set_sha256": bound_sha256(sorted(binder.bound.items())),
        "double_bind_attempts": binder.double_bind_attempts,
        "unretired": len(api.ledger(store).unretired()),
        "intents_written": leader.ledger.intents_written
        + standby.ledger.intents_written,
        "intents_retired": leader.ledger.intents_retired
        + standby.ledger.intents_retired,
        "timing": {"recover_s": recover_s, "standby_beat_s": beats,
                   "led_wave_s": led_s},
    }


# --------------------------------------------------------------------------- #
# phase 6: a preemption storm, phase 7: gang jobs (shared with
# scripts/flagship_reference.py)
# --------------------------------------------------------------------------- #

def storm_vips(T, W, first_index: int, count: int = None) -> list:
    """`count` (STORM_VIPS) pods at priority 1000, each requesting 31 cpu
    and 8Gi: a node of make_nodes (32 cpu) fits one only while it runs at
    most 1 cpu of requests. Phase 5b's drain leaves fewer such nodes than
    STORM_VIPS, so the first wave fills them and the rest of the vips must
    preempt. Every second carries hostname anti-affinity to app-1
    (restoring an app-1 victim would re-block it); every fourth carries
    app-3's label and a hard zone spread over app-3 (restoring an app-3
    victim would re-block it); the rest are plain."""
    vips = []
    for i in range(STORM_VIPS if count is None else count):
        app = "app-3" if i % 4 == 0 else "vip"
        anti, spread = (), ()
        if i % 2 == 0:
            anti = (T.PodAffinityTerm(
                selector=T.LabelSelector.of(match_labels={"app": "app-1"}),
                topology_key=W.HOSTNAME),)
        if i % 4 == 0:
            spread = (T.TopologySpreadConstraint(
                max_skew=STORM_SPREAD_SKEW, topology_key=W.ZONE,
                when_unsatisfiable=T.UnsatisfiableAction.DO_NOT_SCHEDULE,
                selector=T.LabelSelector.of(match_labels={"app": "app-3"})),)
        vips.append(T.Pod(
            name=f"vip-{i}", labels={"app": app},
            requests=T.Resources.make(cpu="31", memory="8Gi"),
            affinity=T.Affinity(anti_required=anti), topology_spread=spread,
            priority=1000, creation_index=first_index + i))
    return vips


def preempt_storm(api, n_nodes: int, bound, n_pods: int = SERVING_PODS,
                  vips: int = STORM_VIPS, waves: int = STORM_WAVES,
                  batch_size: int = SERVING_BATCH, on_wave=None) -> dict:
    """Phase 6: a Scheduler(preemptor=Preemptor(pdb_source), batch_size)
    on a clock that moves STORM_TICK seconds after every wave (past the
    backoff and the unschedulable flush), base Dims(N=n_nodes, P=batch_size,
    E=n_pods), over make_nodes(n_nodes) holding `bound` — phase 5b's binder
    list of (pod key, node), the flagship and fresh pods added with
    node_name set. One PodDisruptionBudget with no disruptions left covers
    app-0. `vips` vips arrive (storm_vips); waves run until every vip is
    bound or `waves` waves have run, each wave's bindings
    confirmed through on_pod_add. Per wave: attempted, scheduled,
    unschedulable, victims evicted and preemptors nominated; then the
    evicted keys in order and the binder's (vip, node) order, as counts and
    sha256. `on_wave(i)` is called after each wave."""
    import dataclasses

    T, W = api.types, api.workloads
    nodes = W.make_nodes(n_nodes)
    by_key = {p.key: p for p in W.flagship_pods(n_pods) + fresh_pods(T, n_pods)}
    pdbs = [("default", T.LabelSelector.of(match_labels={"app": "app-0"}), 0)]
    pre = api.preemptor(pdb_source=lambda: pdbs)
    binder = api.RecordingBinder()
    clock = FakeClock()
    s = api.scheduler(binder=binder, batch_size=batch_size, clock=clock,
                      preemptor=pre,
                      base_dims=api.Dims(N=n_nodes, P=batch_size, E=n_pods))
    if s.governor is not None:
        fail("phase 6 runs with KTPU_OVERLOAD=0 (the overload governor off)")
    for n in nodes:
        s.on_node_add(n)
    for key, node in bound:
        s.on_pod_add(dataclasses.replace(by_key[key], node_name=node))
    vip_pods = storm_vips(T, W, n_pods + 3, vips)
    vip_by_key = {v.key: v for v in vip_pods}
    for v in vip_pods:
        s.on_pod_add(v)
    out = []
    for w in range(waves):
        first, ev0, ok0 = len(binder.bound), len(pre.evictor.evicted), \
            pre.successes
        st = s.schedule_pending()
        out.append(dict(attempted=st.attempted, scheduled=st.scheduled,
                          unschedulable=st.unschedulable,
                          evicted=len(pre.evictor.evicted) - ev0,
                          nominated=pre.successes - ok0))
        if on_wave is not None:
            on_wave(w)
        for key, node in binder.bound[first:]:
            s.on_pod_add(dataclasses.replace(vip_by_key[key], node_name=node))
        clock.t += STORM_TICK
        if len(binder.bound) == len(vip_pods):
            break
    return {"waves": out, "evicted": len(pre.evictor.evicted),
            "evicted_sha256": hashlib.sha256(
                "\n".join(pre.evictor.evicted).encode()).hexdigest(),
            "vips_bound": len(binder.bound),
            "vips_bound_sha256": bound_sha256(binder.bound),
            "pdb_violations": pre.last_pdb_violations,
            "attempts": pre.attempts}


# --------------------------------------------------------------------------- #
# phase 10: the framework and the extender (shared with
# scripts/flagship_reference.py, which runs them on the JAX package)
# --------------------------------------------------------------------------- #

def framework_nodes(W, n_nodes: int) -> list:
    """make_nodes(n_nodes), every FRAMEWORK_SSD_EVERY-th node labelled
    disktype=ssd and every FRAMEWORK_AVOID_EVERY-th annotated
    preferAvoidPods."""
    import dataclasses

    out = []
    for i, node in enumerate(W.make_nodes(n_nodes)):
        labels = dict(node.labels)
        if i % FRAMEWORK_SSD_EVERY == 0:
            labels["disktype"] = "ssd"
        out.append(dataclasses.replace(
            node, labels=labels,
            prefer_avoid_pods=i % FRAMEWORK_AVOID_EVERY == 0))
    return out


def wire_framework(s, cfg) -> None:
    """What the JAX package's SchedulerServer does with a loaded
    configuration, done here by the caller: the engine's composition, the
    hard affinity weight, NodeLabel's keys interned in the Scheduler's
    encoder."""
    s.engine_config = cfg.engine_config()
    s.hard_pod_affinity_weight = float(cfg.hard_pod_affinity_symmetric_weight)
    keys = s.encoder.vocabs.label_keys
    for pl in s.framework.score_plugins:
        if type(pl).__name__ == "NodeLabel":
            pl._present_ids = tuple(keys.intern(k) for k in pl.present)
            pl._absent_ids = tuple(keys.intern(k) for k in pl.absent)


def framework_drain(api, n_nodes: int = None, n_pods: int = None,
                    keep=None, on_wave=None) -> dict:
    """Phase 10a: 5b's drain (serving_drain: waves of SERVING_BATCH, the
    informer confirmations, the 3-pod micro wave) with FRAMEWORK_CONFIG's
    profile — Scheduler(framework=cfg.build_framework()) wired as
    wire_framework does — on framework_nodes."""
    cfg = api.load_config(FRAMEWORK_CONFIG)
    return serving_drain(api, n_nodes or FRAMEWORK_NODES,
                         n_pods or SERVING_PODS, keep=keep, on_wave=on_wave,
                         sched_kw={"framework": cfg.build_framework()},
                         setup=lambda s: wire_framework(s, cfg),
                         node_fn=framework_nodes)


def next_flagship(W, n_pods: int, skip: int, count: int) -> list:
    """`count` pods of the flagship generator after its first n_pods + skip
    (the same groups, spread and affinity as the backlog's; fresh names)."""
    return W.flagship_pods(n_pods + skip + count)[n_pods + skip:]


def digest(obj) -> str:
    """sha256 of a JSON value with sorted keys."""
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()) \
        .hexdigest()


def extender_phase(api, bound, n_nodes: int = None, n_pods: int = None,
                   mark=None) -> tuple:
    """Phases 10b and 10c. An ExtenderServer over the package's
    ExtenderBackend, which mirrors framework_nodes(n_nodes) and `bound`
    (phase 5b's binder list: the flagship and fresh pods with node_name
    set). 10b: the package's own HTTPExtender (nodeCacheCapable) sends
    EXTENDER_CALLS Filter calls and as many Prioritize calls, each naming
    every node, for the next EXTENDER_CALLS flagship pods; one
    ProcessPreemption of a priority-1000 pod of 31 cpu with the first
    EXTENDER_CANDIDATES nodes as candidates, all their pods as victims; and
    EXTENDER_BINDS Bind calls (the first Filter pods, each to its first
    passing node). 10c: Scheduler(extenders=[HTTPExtender(filter,
    prioritize, bind)]) holding the same nodes and pods schedules the next
    EXTENDER_SCHED_PODS flagship pods in one wave, each through the per-pod
    extender path, bound by the extender's Bind. `mark(name)` is called
    before each subphase. Returns (the answers as counts and sha256, the
    seconds of each call by verb and 10c's wave)."""
    import dataclasses

    T, W, E = api.types, api.workloads, api.extender
    n_nodes, n_pods = n_nodes or FRAMEWORK_NODES, n_pods or SERVING_PODS
    nodes = framework_nodes(W, n_nodes)
    by_key = {p.key: p for p in W.flagship_pods(n_pods)
              + fresh_pods(T, n_pods)}
    placed = [dataclasses.replace(by_key[k], node_name=n) for k, n in bound]
    be = api.backend()
    be.sync_nodes(nodes)
    be.sync_scheduled_pods(placed)
    pods = next_flagship(W, n_pods, 0, EXTENDER_CALLS)
    secs = {"filter": [], "prioritize": [], "preempt": [], "bind": []}

    def timed(verb, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        secs[verb].append(time.perf_counter() - t0)
        return out

    verbs = dict(filter_verb="filter", prioritize_verb="prioritize",
                 bind_verb="bind", node_cache_capable=True,
                 http_timeout=600.0)
    with E.ExtenderServer(be) as srv:
        if mark is not None:
            mark("10b")
        ext = E.HTTPExtender(E.ExtenderConfig(
            url_prefix=srv.url, preempt_verb="preemption", **verbs))
        filt = [list(timed("filter", ext.filter, p, nodes)) for p in pods]
        prio = [timed("prioritize", ext.prioritize, p, nodes)[0]
                for p in pods]
        vip = T.Pod(name="ext-vip", priority=1000,
                    requests=T.Resources.make(cpu="31", memory="8Gi"),
                    creation_index=n_pods + EXTENDER_CALLS)
        cand = {n.name: sorted((p for p in placed if p.node_name == n.name),
                               key=lambda p: p.key)
                for n in nodes[:EXTENDER_CANDIDATES]}
        surv = timed("preempt", ext.process_preemption, vip, cand)
        for pod, (passing, _failed) in zip(pods[:EXTENDER_BINDS], filt):
            timed("bind", ext.bind, pod, passing[0] if passing
                  else nodes[0].name)
        binds = list(be.bound)

        if mark is not None:
            mark("10c")
        s = api.scheduler(binder=api.RecordingBinder(), clock=FakeClock(),
                          extenders=[E.HTTPExtender(E.ExtenderConfig(
                              url_prefix=srv.url, **verbs))],
                          batch_size=EXTENDER_SCHED_PODS,
                          base_dims=api.Dims(N=n_nodes,
                                             P=EXTENDER_SCHED_PODS, E=n_pods))
        for n in nodes:
            s.on_node_add(n)
        for p in placed:
            s.on_pod_add(p)
        for p in next_flagship(W, n_pods, EXTENDER_CALLS,
                               EXTENDER_SCHED_PODS):
            s.on_pod_add(p)
        t0 = time.perf_counter()
        st = s.schedule_pending()
        secs["sched_wave"] = [time.perf_counter() - t0]
        sched_bound = be.bound[len(binds):]
    out = {
        "filter": {"calls": len(filt),
                   "passing": sum(len(p) for p, _ in filt),
                   "failed": sum(len(f) for _, f in filt),
                   "sha256": digest([[p, sorted(f.items())]
                                     for p, f in filt])},
        "prioritize": {"calls": len(prio),
                       "nonzero": sum(1 for d in prio
                                      for v in d.values() if v),
                       "sha256": digest([sorted(d.items()) for d in prio])},
        "preempt": {"candidates": len(cand),
                    "victims": sum(len(v) for v in cand.values()),
                    "surviving": {n: len(v) for n, v in sorted(surv.items())},
                    "sha256": digest(sorted(surv.items()))},
        "bind": {"calls": len(binds), "sha256": digest(binds)},
        "sched": {"pods": EXTENDER_SCHED_PODS, "attempted": st.attempted,
                  "scheduled": st.scheduled,
                  "unschedulable": st.unschedulable,
                  "bound": len(sched_bound),
                  "sha256": digest(sched_bound),
                  "local_binder": len(s.binder.bound)},
    }
    return out, secs


def cosched_drain(api, n_nodes: int = None, n_pods: int = None,
                  batch_size: int = None) -> dict:
    """Phase 10d: gang_workload_pods(n_pods) on make_nodes(n_nodes) through
    a Scheduler whose framework has Coscheduling at reserve, permit and
    unreserve — so the device gang engine is off and the Permit waiting map
    holds each group's members until its quorum is assumed. Waves of
    `batch_size` on a still clock until the active queue is empty. Per
    wave: attempted, scheduled (bound by the wave's own commits),
    unschedulable; then the binder's order as a count and sha256 (and the
    bindings sorted, as a sha256), the pods released from the waiting map,
    and those still waiting. Coscheduling releases a group's waiters in
    the iteration order of a set of pod keys, which follows the
    interpreter's string-hash seed: the order is reproducible only under
    one PYTHONHASHSEED (pin_hash_seed)."""
    import dataclasses

    F, W = api.framework, api.workloads
    n_nodes, n_pods = n_nodes or COSCHED_NODES, n_pods or COSCHED_PODS
    batch_size = batch_size or SERVING_BATCH
    plugins = dataclasses.replace(
        F.default_plugins(),
        reserve=F.PluginSet(enabled=["Coscheduling"]),
        permit=F.PluginSet(enabled=["Coscheduling"]),
        unreserve=F.PluginSet(enabled=["Coscheduling"]))
    fw = F.default_framework(plugins=plugins)
    binder = api.RecordingBinder()
    s = api.scheduler(binder=binder, framework=fw, batch_size=batch_size,
                      clock=FakeClock(),
                      base_dims=api.Dims(N=n_nodes, P=batch_size, E=n_pods))
    if s._device_gangs:
        fail("phase 10d: Coscheduling did not take the groups from the "
             "device gang engine")
    cos = next(p for p in fw.permit_plugins if p.name == "Coscheduling")
    released = [0]

    def release(key, now=None):
        ok = s.complete_waiting(key, now)
        released[0] += int(ok)
        return ok

    cos.on_release = release
    for n in W.make_nodes(n_nodes):
        s.on_node_add(n)
    for p in W.gang_workload_pods(n_pods):
        s.on_pod_add(p)
    waves = []
    for _ in range(4 * (n_pods // batch_size + 2)):
        st = s.run_until_idle(max_waves=1)
        waves.append([st.attempted, st.scheduled, st.unschedulable])
        if s.queue.lengths()[0] == 0:
            break
    return {"waves": waves, "bound": len(binder.bound),
            "bound_sha256": bound_sha256(binder.bound),
            "bound_set_sha256": bound_sha256(sorted(binder.bound)),
            "released": released[0], "waiting": len(fw.waiting_pods())}


def gang_summary(pods, assignments) -> dict:
    """Phase 7's result: placed count, placement sha256, and the gang
    groups that placed no member (the dead groups: every group here needs
    its full size, none has a member bound before the cycle)."""
    placed = {}
    for p, a in zip(pods, assignments):
        placed[p.pod_group] = placed.get(p.pod_group, 0) + (a is not None)
    dead = sorted(g for g, n in placed.items() if n == 0)
    return {"scheduled": sum(a is not None for a in assignments),
            "sha256": assignments_sha256(assignments),
            "dead_groups": len(dead),
            "dead_sha256": hashlib.sha256("\n".join(dead).encode()).hexdigest()}


# --------------------------------------------------------------------------- #
# running a cycle
# --------------------------------------------------------------------------- #

def most_rows(args) -> int:
    """A Recorder key: the first input's leading size (K1's classes, K2's
    rows)."""
    return args[0].shape[0]


def own(x):
    """`x` with every torch tensor in it cloned: tuples, NamedTuples and
    lists rebuilt around the copies, anything else (a JAX array, a number)
    as it is. What a recorder keeps must not move when the main path later
    writes its tensors in place (the fleet's stack, B13a)."""
    if hasattr(x, "clone") and hasattr(x, "data_ptr"):
        return x.clone()
    if isinstance(x, tuple):
        kids = [own(k) for k in x]
        return type(x)(*kids) if hasattr(x, "_fields") else tuple(kids)
    if isinstance(x, list):
        return [own(k) for k in x]
    return x


class Recorder:
    """Keeps a copy of a kernel wrapper's inputs while the main path runs
    (the shapes and data the cycle really gives it): the first call's, or
    with `key` the call's whose key(args) is largest (the first of those).
    Every tensor is copied, inside the tables and cycle K4 takes too."""

    def __init__(self, module, name, key=None):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args, self.best = None, None

        def rec(*args):
            k = None if key is None else key(args)
            if self.args is None or (k is not None and k > self.best):
                self.args = own(args)
                self.best = k
            return self.fn(*args)

        setattr(module, name, rec)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def assignments_sha256(assignments) -> str:
    return hashlib.sha256(
        "\n".join(a or "-" for a in assignments).encode()).hexdigest()


def run_cycle(device, nodes, pods, warm_runs=3, reference_device=None):
    """One phase-3 cycle through BatchScheduler. The launch counts are set
    to 0 just before the first cycle and read just after it. Returns
    (result, launches, captured kernel inputs, median warm cycle seconds or
    None) after checking the cycle against the reference device's run."""
    import torch
    from kubernetes_tpu_torch import BatchScheduler
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops import waves as W

    sched = BatchScheduler(device=device)

    recs = [Recorder(W, "contention_scan"), Recorder(W, "domain_rank")]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = sched.schedule(nodes, [], pods)
    sync(device)
    first_s = time.perf_counter() - t0
    launches = K.launch_counts()
    for r in recs:
        r.restore()
    state = sched.last_result.state
    print(f"  first cycle {first_s:.3f} s; scheduled={res.scheduled} "
          f"failed={res.failed}; launches={launches}")
    if device.type == "cuda":
        for name in WAVE_KERNELS:
            if launches[name] <= 0:
                fail(f"kernel {name} was not launched by the cycle")

    times = []
    for _ in range(warm_runs):
        t0 = time.perf_counter()
        again = sched.schedule(nodes, [], pods)
        sync(device)
        times.append(time.perf_counter() - t0)
        if again.assignments != res.assignments:
            fail("warm cycle placements differ from the first cycle's")
    cycle_s = statistics.median(times) if times else None
    if times:
        print(f"  warm cycles {[round(t, 4) for t in times]} s; "
              f"median {cycle_s:.4f} s")

    if reference_device is not None:
        ref = BatchScheduler(device=reference_device)
        t0 = time.perf_counter()
        ref_res = ref.schedule(nodes, [], pods)
        print(f"  {reference_device} reference cycle "
              f"{time.perf_counter() - t0:.3f} s")
        if ref_res.assignments != res.assignments:
            bad = sum(a != b for a, b in zip(ref_res.assignments,
                                             res.assignments))
            fail(f"placements differ from the {reference_device} run "
                 f"({bad} pods)")
        rs = ref.last_result.state
        for f in ("used", "ppa", "ppw", "ppt", "CNT", "HOLD", "vol_any",
                  "vol_rw"):
            if not torch.equal(getattr(state, f).cpu(), getattr(rs, f).cpu()):
                fail(f"final state plane {f} differs from the "
                     f"{reference_device} run")
        # WSYM is f32 holding integer weights here: exact in practice; the
        # stated tolerance covers a summation-order rounding of 1e-4
        if not torch.allclose(state.WSYM.cpu(), rs.WSYM.cpu(), rtol=0,
                              atol=1e-4):
            fail("final WSYM plane differs from the reference beyond 1e-4")
        print(f"  placements and final state planes equal the "
              f"{reference_device} run")
    captured = {r.name: r.args for r in recs}
    return res, launches, captured, cycle_s


def k1_bound(args, out) -> tuple:
    """(bound_ms, bound_by) for K1: each input read once, each output
    written once; operations ≈ per (class, node) a fit test and running sum
    over R slots, the port and volume word tests, per-driver popcounts."""
    A, req, _hp, pw, _ww, tw, _hv, va, _vr, *_ = args
    SC, N = A.shape
    R, PW, PT, VW = req.shape[1], pw.shape[1], tw.shape[1], va.shape[1]
    DR = args[13].shape[0]
    keep, words = out
    b = nbytes(args) + nbytes((keep,) + tuple(words))
    ops = SC * N * (6 * R + 4 * (2 * PW + PT) + 8 * VW + 3 * DR * VW + 10)
    t_b, t_o = b / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def k2_bound(dom) -> tuple:
    """(bound_ms, bound_by) for K2: read the rows once, write the ranks
    once; a handful of operations per element."""
    b = 2 * nbytes((dom,))
    ops = 6 * dom.numel()
    t_b, t_o = b / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def check_real_words(device, args) -> dict:
    """K1 on the port-and-volume cycle's first-wave inputs: the words that
    reach it are real (classes with host ports and volumes, non-zero
    words), and the kernel equals its plain version on them exactly."""
    from kubernetes_tpu_torch.ops import kernels as K

    A, req, has_p, pw, ww, tw, has_v, va, vr, *_ = args
    drv = args[13]
    real = {"classes": int(A.shape[0]),
            "port_classes": int((has_p & ((pw != 0).any(1) | (ww != 0).any(1)
                                          | (tw != 0).any(1))).sum()),
            "volume_classes": int((has_v & ((va != 0).any(1)
                                            | (vr != 0).any(1))).sum())}
    if real["port_classes"] == 0 or real["volume_classes"] == 0:
        fail(f"the port-and-volume cycle sent no real words to K1: {real}")
    out = K.contention_scan(*args)
    d = k1_diff(out, K.contention_scan_plain(*args))
    sync(device)
    cfg = K.k1_launch_config(A.shape[0], A.shape[1], req.shape[1],
                             pw.shape[1], tw.shape[1], va.shape[1],
                             drv.shape[0])
    dropped = int(A.sum()) - int(out[0].sum())
    print(f"  K1 on the cycle's first wave: {real}, widths "
          f"PW={pw.shape[1]} PT={tw.shape[1]} VW={va.shape[1]} "
          f"DR={drv.shape[0]} ({cfg.variant} variant), {dropped} of "
          f"{int(A.sum())} admissions dropped; max_abs_err={d}")
    if d != 0:
        fail("contention_scan disagrees with its plain version on the "
             "port-and-volume cycle's inputs")
    return dict(real, variant=cfg.variant, dropped=dropped, max_abs_err=d)


def kernel_report(device, captured, launches, errs) -> list:
    """Phase 4: each kernel on the inputs the cycle gave it — exact against
    its plain version, then timed beside the plain version and its bound."""
    from kubernetes_tpu_torch.ops import kernels as K

    a1 = captured["contention_scan"]
    out1 = K.contention_scan(*a1)
    d1 = k1_diff(out1, K.contention_scan_plain(*a1))
    dom, nd = captured["domain_rank"]
    d2 = k2_diff(K.domain_rank(dom, nd), K.domain_rank_plain(dom, nd))
    sync(device)
    print(f"  cycle inputs: K1 {tuple(a1[0].shape)} max_abs_err={d1}; "
          f"K2 {tuple(dom.shape)} D+1={nd} max_abs_err={d2}")
    if d1 != 0 or d2 != 0:
        fail("a kernel disagrees with its plain version on the cycle's inputs")

    b1, by1 = k1_bound(a1, out1)
    b2, by2 = k2_bound(dom)
    rows = [
        dict(name="contention_scan", route="cuda", source=K1_SOURCE,
             replaces="kubernetes_tpu/ops/waves.py:438",
             launches=launches["contention_scan"],
             max_abs_err=max(errs["contention_scan"], d1),
             ms=device_ms(lambda: K.contention_scan(*a1), device),
             call_ms=time_ms(lambda: K.contention_scan(*a1), device),
             plain_ms=time_ms(lambda: K.contention_scan_plain(*a1), device,
                              reps=3),
             bound_ms=b1, bound_by=by1, library_ms=None),
        dict(name="domain_rank", route="cuda", source=K2_SOURCE,
             replaces="kubernetes_tpu/ops/waves.py:165",
             launches=launches["domain_rank"],
             max_abs_err=max(errs["domain_rank"], d2),
             ms=device_ms(lambda: K.domain_rank(dom, nd), device),
             call_ms=time_ms(lambda: K.domain_rank(dom, nd), device),
             plain_ms=time_ms(lambda: K.domain_rank_plain(dom, nd), device),
             bound_ms=b2, bound_by=by2, library_ms=None),
    ]
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms on the device, "
              f"{r['call_ms']:.4f} ms per call (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms by {r['bound_by']}), "
              f"{r['launches']} launches per cycle")
    return rows


class ServingTimer:
    """Per-wave host timers around the port's Scheduler for phase 5b: the
    snapshot (snapshot_with_keys or its micro twin), the dispatch (the
    cycle, ended by a synchronize, so the readback that follows is only the
    copy of the placements) and the whole wave; commit is the rest of the
    wave (the readback copy, the prestage intern of the next backlog, the
    assume/bind loop, the requeue). Installed by patching the names the
    scheduler module calls; `restore()` puts them back."""

    NAMES = ("snapshot_with_keys", "micro_snapshot_with_keys",
             "schedule_batch")

    def __init__(self, device):
        from kubernetes_tpu_torch.sched import scheduler as S

        self.S, self.saved = S, {n: getattr(S, n) for n in self.NAMES}
        self.cur = {"snapshot_s": 0.0, "dispatch_s": 0.0}
        self.waves = []

        def timed(name, key, synced=False):
            fn = self.saved[name]

            def run(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                if synced:
                    sync(device)
                self.cur[key] += time.perf_counter() - t0
                return out
            return run

        S.snapshot_with_keys = timed("snapshot_with_keys", "snapshot_s")
        S.micro_snapshot_with_keys = timed("micro_snapshot_with_keys",
                                           "snapshot_s")
        S.schedule_batch = timed("schedule_batch", "dispatch_s", True)

    def wrap(self, sched):
        """Time each schedule_pending of one scheduler instance."""
        inner = sched.schedule_pending

        def schedule_pending(*a, **kw):
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            wave_s = time.perf_counter() - t0
            c = self.cur
            self.waves.append(dict(
                snapshot_s=c["snapshot_s"], dispatch_s=c["dispatch_s"],
                commit_s=wave_s - c["snapshot_s"] - c["dispatch_s"],
                wave_s=wave_s))
            self.cur = {"snapshot_s": 0.0, "dispatch_s": 0.0}
            return out

        sched.schedule_pending = schedule_pending
        return sched

    def restore(self):
        for n, fn in self.saved.items():
            setattr(self.S, n, fn)


def serving_phase(device) -> dict:
    """Phase 5 on the card: 5a the steady state at the flagship, 5b the
    wave loop's drain and its micro wave, each against the JAX package's
    recorded constants, 5b also against the port's own CPU run; the launch
    counts of each, set to 0 just before it and read just after; K1 and K2
    held against their plain versions on the first serving wave's inputs."""
    import os

    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops import waves as W

    os.environ["KTPU_OVERLOAD"] = "0"
    api = port_serving_api(device)

    print(f"[5a] steady serving cycles, {SERVING_NODES} nodes x "
          f"{SERVING_STEADY_PODS} pods on the resident cache")
    K.reset_launch_counts()
    steady = serving_steady(api, SERVING_NODES, SERVING_STEADY_PODS)
    launches_a = K.launch_counts()
    for i, c in enumerate(steady["cycles"]):
        print(f"  cycle {i}: {c['mode']} snapshot ({c['patch_rows']} rows) "
              f"{c['snapshot_s']:.4f} s, dispatch {c['dispatch_s']:.4f} s, "
              f"readback {c['readback_s']:.4f} s, host map "
              f"{c['map_s']:.4f} s; scheduled {c['scheduled']}")
    got = [(c["mode"], c["patch_rows"], c["scheduled"], c["sha256"])
           for c in steady["cycles"]]
    if got != [tuple(x) for x in JAX_STEADY]:
        fail(f"steady serving cycles differ from the JAX package's: {got}")
    cold, warm = steady["cycles"][0], steady["cycles"][1:]
    print(f"    modes, rows, placements equal the JAX package's; patch "
          f"snapshot {statistics.median(c['snapshot_s'] for c in warm):.4f} s "
          f"against the cold full snapshot {cold['snapshot_s']:.4f} s; "
          f"launches {launches_a}")
    for name, n in launches_a.items():
        if n <= 0 and device.type == "cuda" and name in WAVE_KERNELS:
            fail(f"kernel {name} was not launched by the steady cycles")

    print(f"[5b] wave loop: Scheduler(device='cuda', batch_size="
          f"{SERVING_BATCH}, microwave=True), {SERVING_NODES} nodes x "
          f"{SERVING_PODS} pods, drained by run_until_idle")
    timer = ServingTimer(device)
    cuda_api = port_serving_api(device)
    make = cuda_api.scheduler
    cuda_api.scheduler = lambda **kw: timer.wrap(make(**kw))
    recs = [Recorder(W, "contention_scan"), Recorder(W, "domain_rank")]
    bound = []
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        drain = serving_drain(cuda_api, SERVING_NODES, SERVING_PODS,
                              keep_bound=bound)
    finally:
        timer.restore()
        for r in recs:
            r.restore()
    drain_s = time.perf_counter() - t0
    settle(cuda_api, "5b")
    launches_b = K.launch_counts()
    for i, (w, t) in enumerate(zip(drain["waves"], timer.waves)):
        print(f"  wave {i:2d}: {'micro' if w['micro'] else 'bulk '} "
              f"{w['mode']:6s} {w['patch_rows']:6d} rows; attempted "
              f"{w['attempted']:5d} scheduled {w['scheduled']:5d} "
              f"unschedulable {w['unschedulable']:5d}; snapshot "
              f"{t['snapshot_s']:.4f} s, dispatch+readback "
              f"{t['dispatch_s']:.4f} s, commit {t['commit_s']:.4f} s")
    sched_s = sum(t["wave_s"] for t in timer.waves)
    pods_s = drain["bound"] / sched_s
    print(f"    {drain['bound']} pods bound in {len(drain['waves'])} waves: "
          f"{sched_s:.3f} s in schedule_pending ({pods_s:.1f} pods/s), "
          f"{drain_s:.3f} s with the informer events; launches {launches_b}")
    for name, n in launches_b.items():
        if n <= 0 and device.type == "cuda" and name in WAVE_KERNELS:
            fail(f"kernel {name} was not launched by the wave loop")
    if drain["waves"][-1]["micro"] != 1:
        fail("the 3 fresh pods after the drain did not take a micro wave")
    check_drain(drain, "the JAX package's", JAX_DRAIN)

    t0 = time.perf_counter()
    cpu_api = port_serving_api(torch.device("cpu"))
    cpu_drain = serving_drain(cpu_api, SERVING_NODES, SERVING_PODS)
    settle(cpu_api, "5b (CPU)")
    print(f"    the port's CPU run of the drain took "
          f"{time.perf_counter() - t0:.1f} s")
    if cpu_drain != drain:
        fail("the drain on the card differs from the port's CPU run")
    print("    binder order, per-wave counts, snapshot modes and the micro "
          "wave equal the JAX package's and the CPU run's")

    a1 = recs[0].args
    d1 = k1_diff(K.contention_scan(*a1), K.contention_scan_plain(*a1))
    dom, nd = recs[1].args
    d2 = k2_diff(K.domain_rank(dom, nd), K.domain_rank_plain(dom, nd))
    sync(device)
    print(f"  first serving wave's inputs: K1 {tuple(a1[0].shape)} "
          f"max_abs_err={d1}; K2 {tuple(dom.shape)} D+1={nd} "
          f"max_abs_err={d2}")
    if d1 or d2:
        fail("a kernel disagrees with its plain version on the first "
             "serving wave's inputs")
    errs = {"contention_scan": d1, "domain_rank": d2}
    return dict(steady=steady, drain=drain, timer=timer.waves, bound=bound,
                sched=cuda_api.made[0],
                drain_s=drain_s, sched_s=sched_s, pods_s=pods_s,
                launches_a=launches_a, launches_b=launches_b, errs=errs,
                inputs={"contention_scan": a1, "domain_rank": (dom, nd)})


class PreemptTimer:
    """Timers around the port's preemption pass for phase 6. Per wave: the
    whole schedule_pending and the preemption pass's fresh snapshot, on the
    host clock, with no synchronize added. With `split`, also per burst
    (one dispatch of PREEMPT_BURST lanes): build_cycle, preempt_batch (the
    what-if, K3 and the node choice) and K3 alone, each started and ended
    by a synchronize, and the readback of the result; those synchronizes
    lie inside the timed schedule_pending, so a split run's wave times are
    not the storm's. Installed by patching the names the modules call;
    `restore()` puts them back."""

    KEYS = {"build_cycle": "build_cycle_s", "preempt_batch": "batch_s",
            "_readback": "readback_s", "reprieve_scan": "k3_s"}

    def __init__(self, device, split: bool):
        from kubernetes_tpu_torch.ops import preempt as OP
        from kubernetes_tpu_torch.sched import preemption as P

        self.device = device
        self.saved = [(m, n, getattr(m, n)) for m, n in (
            (P, "build_cycle"), (P, "preempt_batch"), (P, "_readback"),
            (OP, "reprieve_scan"))] if split else []
        self.bursts, self.waves = [], []
        for m, n, fn in self.saved:
            setattr(m, n, self._timed(fn, self.KEYS[n], n != "_readback"))

    def _timed(self, fn, key, synced):
        def run(*a, **kw):
            if key == "build_cycle_s":   # a burst starts with its lattice
                self.bursts.append(dict(wave=len(self.waves), build_cycle_s=0.0,
                                        batch_s=0.0, k3_s=0.0,
                                        readback_s=0.0))
            if synced:
                sync(self.device)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if synced:
                sync(self.device)
            self.bursts[-1][key] += time.perf_counter() - t0
            return out
        return run

    def wrap(self, sched):
        """Time each schedule_pending and preemption snapshot of one
        scheduler instance."""
        inner, snap = sched.schedule_pending, sched._preempt_snapshot

        def preempt_snapshot(*a, **kw):
            t0 = time.perf_counter()
            out = snap(*a, **kw)
            self.waves[-1]["snapshot_s"] += time.perf_counter() - t0
            return out

        def schedule_pending(*a, **kw):
            self.waves.append(dict(snapshot_s=0.0, wave_s=0.0))
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            self.waves[-1]["wave_s"] = time.perf_counter() - t0
            return out

        sched._preempt_snapshot = preempt_snapshot
        sched.schedule_pending = schedule_pending
        return sched

    def restore(self):
        for m, n, fn in reversed(self.saved):
            setattr(m, n, fn)


def k3_bound(args, out) -> tuple:
    """(bound_ms, bound_by) for K3, counted over what this run's data needs
    (csrc/reprieve_scan.cu's header): cand_rest [B, N], valid [N] and req_p
    once; per node some lane may choose (valid and cand_rest) two seg_ptr
    entries and its used and alloc rows; per position of such a node's
    segment its seg_e entry, and vict_pot and c_e per lane that may choose
    the node; the request row of each pod that is a potential victim in
    such a lane; reblock per potential-victim step of a candidate walk;
    priority, creation and PDB byte of each pod evicted in some lane;
    victim [B, E], cand [B, N] and the five int32 [B, N] planes written
    once. Operations: R + 3 per (lane, position) of pass 1 and 3R + 10 per
    potential-victim step of the walk."""
    import torch

    (seg_ptr, seg_e, _req_e, _prio, _pdb, _cre, _req_p, vict_pot, _c_e, _rb,
     used, _alloc, valid, cand_rest) = args
    B, E = vict_pot.shape
    N, R = used.shape
    ptr = seg_ptr.long()
    seglen = ptr[1:] - ptr[:-1]
    on = int(ptr[N])     # positions [0, on) of seg_e are on a node
    node_at = torch.repeat_interleave(
        torch.arange(N, device=seg_e.device), seglen)
    e = seg_e[:on].long()
    live = cand_rest & valid[None]                              # [B, N]
    live_nodes = live.any(0)
    live_pos = live[:, node_at]                                 # [B, on]
    vp = vict_pot[:, e]
    rows = int((vp & live_pos).any(0).sum())
    steps = int((out.cand[:, node_at] & vp).sum())
    lane_pos = int(live_pos.sum())
    evicted = int(out.victim.any(0).sum())
    b = (B * N + N + B * 4 * R + int(live_nodes.sum()) * (8 + 8 * R)
         + int(live_nodes[node_at].sum()) * 4 + lane_pos * 2 + rows * 4 * R
         + steps + evicted * 9 + B * E + B * N + 5 * 4 * B * N)
    ops = lane_pos * (R + 3) + steps * (3 * R + 10)
    t_b, t_o = b / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S
    print(f"  K3's bound counts {int(live_nodes.sum())} nodes some lane may "
          f"choose, {lane_pos} (lane, position) pairs of pass 1, "
          f"{int(out.cand.sum())} candidate walks over {steps} "
          f"potential-victim steps, {rows} request rows, {evicted} evicted "
          f"pods: {b} bytes, {ops} operations")
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def nodes_with_room(bound, n_pods: int = SERVING_PODS) -> tuple:
    """(nodes holding no pod, nodes holding at most 1 cpu of requests)
    among make_nodes(SERVING_NODES) with `bound` (phase 5b's binder list)
    on them."""
    from kubernetes_tpu_torch.api import types as T
    from kubernetes_tpu_torch.models.workloads import flagship_pods

    cpu = {p.key: p.requests.milli_cpu
           for p in flagship_pods(n_pods) + fresh_pods(T, n_pods)}
    used = {}
    for key, node in bound:
        used[node] = used.get(node, 0) + cpu[key]
    return (SERVING_NODES - len(used),
            SERVING_NODES - len(used) + sum(v <= 1000 for v in used.values()))


def run_storm(device, bound, split: bool, recs=()) -> tuple:
    """One preempt_storm through Scheduler(device) under a PreemptTimer;
    the Recorders in `recs` are restored after it. Returns (storm, timer,
    seconds with the informer events, launch counts of the run)."""
    from kubernetes_tpu_torch.ops import kernels as K

    timer = PreemptTimer(device, split)
    api = port_serving_api(device)
    make = api.scheduler
    api.scheduler = lambda **kw: timer.wrap(make(**kw))
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        storm = preempt_storm(api, SERVING_NODES, bound)
    finally:
        timer.restore()
        for r in recs:
            r.restore()
    settle(api, "6")
    return storm, timer, time.perf_counter() - t0, K.launch_counts()


def preempt_phase(device, bound) -> dict:
    """Phase 6 on the card: preempt_storm through Scheduler(device="cuda")
    with a Preemptor, against the JAX package's recorded constants, timed
    per wave with no synchronize added; the launches of K1, K2 and K3 in
    it (counts set to 0 just before, read just after), each held against
    its plain version (K1 and K2 on their launch with the most classes or
    rows, K3 on its first) and K3 timed there.
    Then a second storm with the per-burst split timers (PreemptTimer
    split=True), which must give the same result."""
    import os

    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops import preempt as OP
    from kubernetes_tpu_torch.ops import waves as W

    os.environ["KTPU_OVERLOAD"] = "0"
    idle, fit = nodes_with_room(bound)
    print(f"    after phase 5b, {idle} of {SERVING_NODES} nodes run no pod and "
          f"{fit} run at most 1 cpu of requests (room for one vip)")
    recs = [Recorder(W, "contention_scan", most_rows),
            Recorder(W, "domain_rank", most_rows),
            Recorder(OP, "reprieve_scan")]
    storm, timer, storm_s, launches = run_storm(device, bound, False, recs)
    if device.type == "cuda":
        for name in WAVE_KERNELS + ("reprieve_scan",):
            if launches[name] <= 0:
                fail(f"kernel {name} was not launched by the storm")
    got = dict(storm, waves=[tuple(w.values()) for w in storm["waves"]])
    want = dict(JAX_STORM, waves=[tuple(w) for w in JAX_STORM["waves"]])
    if got != want:
        bad = [k for k in want if got.get(k) != want[k]]
        fail(f"the storm differs from the JAX package's in {bad}: {got}")
    print("    per-wave counts, evictions, nominations, the evicted keys and "
          "the vips' binder order equal the JAX package's")
    wave_s = [t["wave_s"] for t in timer.waves]
    sched_s = sum(wave_s)
    vips_s = storm["vips_bound"] / sched_s
    first = storm["waves"][0]["scheduled"]
    later = storm["vips_bound"] - first
    first_s, later_s = first / wave_s[0], later / sum(wave_s[1:])
    print(f"    {storm['vips_bound']} of {STORM_VIPS} vips bound in "
          f"{len(storm['waves'])} waves, {storm['evicted']} victims evicted; "
          f"{sched_s:.3f} s in schedule_pending ({vips_s:.1f} vips/s), "
          f"{storm_s:.3f} s with the informer events; launches {launches}")
    print(f"    wave 0 binds {first} vips that fit without an eviction in "
          f"{wave_s[0]:.3f} s ({first_s:.1f} vips/s); waves 1-"
          f"{len(wave_s) - 1} bind {later} vips, each nominated by the "
          f"previous wave's preemption pass, in {sum(wave_s[1:]):.3f} s "
          f"({later_s:.2f} vips/s)")

    errs = {}
    for r, diff in zip(recs[:2], (k1_diff, k2_diff)):
        plain = getattr(K, r.name + "_plain")
        errs[r.name] = diff(getattr(K, r.name)(*r.args), plain(*r.args))
    a3 = recs[2].args
    out3 = K.reprieve_scan(*a3)
    errs["reprieve_scan"] = k3_diff(out3, K.reprieve_scan_plain(*a3))
    sync(device)
    (B, E), (N, R) = a3[7].shape, a3[10].shape
    print(f"  the storm's widest K1 and K2 launches and its first K3 launch: "
          f"K1 {tuple(recs[0].args[0].shape)} "
          f"max_abs_err={errs['contention_scan']}; K2 "
          f"{tuple(recs[1].args[0].shape)} D+1={recs[1].args[1]} "
          f"max_abs_err={errs['domain_rank']}; K3 B={B} N={N} E={E} R={R}, "
          f"{int(out3.cand.sum())} candidate walks, "
          f"{int(out3.victim.sum())} victims, "
          f"max_abs_err={errs['reprieve_scan']} over all seven outputs")
    if any(errs.values()):
        fail("a kernel disagrees with its plain version on the storm's "
             "inputs")
    b3, by3 = k3_bound(a3, out3)
    row = dict(name="reprieve_scan", route="cuda", source=K3_SOURCE,
               replaces="kubernetes_tpu/ops/preempt.py:183",
               launches=launches["reprieve_scan"],
               max_abs_err=errs["reprieve_scan"],
               ms=device_ms(lambda: K.reprieve_scan(*a3), device),
               call_ms=time_ms(lambda: K.reprieve_scan(*a3), device),
               plain_ms=time_ms(lambda: K.reprieve_scan_plain(*a3), device,
                                reps=3),
               bound_ms=b3, bound_by=by3, library_ms=None)
    print(f"  reprieve_scan: {row['ms']:.4f} ms on the device, "
          f"{row['call_ms']:.4f} ms per call (plain {row['plain_ms']:.4f} ms,"
          f" bound {row['bound_ms']:.6f} ms by {row['bound_by']}), "
          f"{row['launches']} launches in the storm")

    print("  the same storm again with the per-burst split timers")
    again, split, _, _ = run_storm(device, bound, True)
    if again != storm:
        fail("the storm with the split timers differs from the first run")
    for i, (w, t) in enumerate(zip(storm["waves"], split.waves)):
        bs = [b for b in split.bursts if b["wave"] == i + 1]
        tot = {k: sum(b[k] for b in bs) for k in (
            "build_cycle_s", "batch_s", "k3_s", "readback_s")}
        print(f"  wave {i:2d}: attempted {w['attempted']:4d} scheduled "
              f"{w['scheduled']:4d} unschedulable {w['unschedulable']:3d} "
              f"evicted {w['evicted']:3d} nominated {w['nominated']:2d}; "
              f"wave {wave_s[i]:.3f} s ({t['wave_s']:.3f} s split), "
              f"preemption snapshot {t['snapshot_s']:.4f} s, {len(bs)} "
              f"bursts: build_cycle {tot['build_cycle_s']:.4f} s, what-if "
              f"{tot['batch_s'] - tot['k3_s']:.4f} s, K3 {tot['k3_s']:.4f} s,"
              f" readback {tot['readback_s']:.4f} s")
    for b in split.bursts[:3]:
        print(f"    a burst of wave {b['wave'] - 1}: build_cycle "
              f"{b['build_cycle_s']:.4f} s, what-if "
              f"{b['batch_s'] - b['k3_s']:.4f} s, K3 {b['k3_s']:.4f} s, "
              f"readback {b['readback_s']:.4f} s")
    return dict(storm=storm, waves=timer.waves, split_waves=split.waves,
                bursts=split.bursts, sched_s=sched_s, vips_per_s=vips_s,
                wave0_vips_per_s=first_s, later_vips_per_s=later_s,
                storm_s=storm_s, launches=launches, errs=errs, row=row,
                idle_nodes=idle, room_nodes=fit)


def gang_phase(device) -> dict:
    """Phase 7 on the card: BatchScheduler(device="cuda") on BASELINE config
    5 (make_nodes(GANG_NODES) x gang_workload_pods(GANG_PODS)), a cold and a
    warm run; the placements, dead groups and rejection rounds against the
    JAX package's recorded ones; K1/K2 launches of the cold run (K1 must
    launch; K2 has no domain quota to rank on this workload); K1 held
    against its plain version on the inputs of the cold run's launch with
    the most classes."""
    from kubernetes_tpu_torch import BatchScheduler
    from kubernetes_tpu_torch.models.workloads import (gang_workload_pods,
                                                       make_nodes)
    from kubernetes_tpu_torch.ops import gang as G
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops import waves as W

    nodes, pods = make_nodes(GANG_NODES), gang_workload_pods(GANG_PODS)
    rounds, fn = [0], G.assign_waves

    def counted(*a, **kw):
        rounds[0] += 1
        return fn(*a, **kw)

    sched = BatchScheduler(device=device)
    G.assign_waves = counted
    rec = Recorder(W, "contention_scan", most_rows)
    K.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        res = sched.schedule(nodes, [], pods)
        sync(device)
        cold_s = time.perf_counter() - t0
        launches = K.launch_counts()
        n_rounds = rounds[0]
        rec.restore()
        t0 = time.perf_counter()
        warm = sched.schedule(nodes, [], pods)
        sync(device)
        warm_s = time.perf_counter() - t0
    finally:
        G.assign_waves = fn
        rec.restore()
    if warm.assignments != res.assignments:
        fail("the warm gang cycle's placements differ from the cold one's")
    got = dict(gang_summary(pods, res.assignments), rounds=n_rounds)
    print(f"    scheduled {got['scheduled']} of {GANG_PODS}, "
          f"{got['dead_groups']} dead groups, {n_rounds} rounds; cycle "
          f"{cold_s:.3f} s cold, {warm_s:.3f} s warm; launches {launches}")
    # the jobs carry no spread or anti-affinity terms, so the wave engine
    # has no domain quota to rank (K2): only K1 is on this path
    if device.type == "cuda" and launches["contention_scan"] <= 0:
        fail("kernel contention_scan was not launched by the gang cycle")
    if got != JAX_GANG:
        bad = [k for k in JAX_GANG if got.get(k) != JAX_GANG[k]]
        fail(f"the gang cycle differs from the JAX package's in {bad}: {got}")
    print("    placements (sha256), placed count, dead groups and rounds "
          "equal the JAX package's")
    a1 = rec.args
    t0 = time.perf_counter()
    d1 = k1_diff(K.contention_scan(*a1), K.contention_scan_plain(*a1))
    sync(device)
    print(f"  the gang cycle's K1 launch with the most classes: "
          f"{tuple(a1[0].shape)} "
          f"max_abs_err={d1} (plain version {time.perf_counter() - t0:.1f} s)")
    if d1 != 0:
        fail("contention_scan disagrees with its plain version on the gang "
             "cycle's inputs")
    return dict(got, cold_s=cold_s, warm_s=warm_s, launches=launches,
                errs={"contention_scan": d1})


# --------------------------------------------------------------------------- #
# phase 3c: decision provenance, phase 8: the run-collapsed engine (shared
# with scripts/flagship_reference.py)
# --------------------------------------------------------------------------- #

def explain_sha256(exp: dict, n: int) -> str:
    """sha256 over an ExplainResult's integer fields (numpy arrays by
    name), each [:n] as little-endian int32, in EXPLAIN_INT_FIELDS
    order."""
    import numpy as np

    h = hashlib.sha256()
    for f in EXPLAIN_INT_FIELDS:
        h.update(np.ascontiguousarray(np.asarray(exp[f])[:n],
                                      dtype="<i4").tobytes())
    return h.hexdigest()


def port_explain_cycle(device, nodes, pods):
    """BatchScheduler.schedule's encode and dispatch with explain=True, on
    `device`. Returns (placements by node name, ExplainResult as numpy
    arrays by field)."""
    from kubernetes_tpu_torch.sched.cycle import (UNSCHEDULABLE_TAINT_KEY,
                                                  schedule_batch)
    from kubernetes_tpu_torch.state.arrays import tables_to_torch
    from kubernetes_tpu_torch.state.encode import Encoder

    enc = Encoder()
    enc.vocabs.label_keys.intern(UNSCHEDULABLE_TAINT_KEY)
    enc.vocabs.label_vals.intern("")
    tables, ex, pe, d = enc.encode_cluster(nodes, [], pods)
    keys = (enc.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY),
            enc.vocabs.label_vals.get(""))
    tt, (ext, pet) = tables_to_torch(tables, (ex, pe), device)
    res, exp = schedule_batch(tt, pet, keys, d.D, ext,
                              has_node_name=d.has_node_name, explain=True)
    sync(device)
    idx = res.node.cpu().tolist()[:len(pods)]
    return ([nodes[i].name if i >= 0 else None for i in idx],
            {f: t.cpu().numpy() for f, t in zip(exp._fields, exp)})


def explain_phase(device, nodes, pods) -> dict:
    """Phase 3c: the flagship dispatch with explain=True on the card and on
    the CPU. The placements equal the JAX package's; the integer fields
    equal between the two runs and their sha256 the JAX package's; the f32
    fields within EXPLAIN_F32_ATOL."""
    import numpy as np
    import torch

    card_s = []
    for _ in range(2):    # cold, then warm
        t0 = time.perf_counter()
        placed, exp = port_explain_cycle(device, nodes, pods)
        card_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    placed_c, exp_c = port_explain_cycle(torch.device("cpu"), nodes, pods)
    cpu_s = time.perf_counter() - t0
    if assignments_sha256(placed) != JAX_ASSIGNMENTS_SHA256 \
            or placed_c != placed:
        fail("explain=True changed the flagship placements")
    for f in EXPLAIN_INT_FIELDS:
        if not np.array_equal(exp[f], exp_c[f]):
            fail(f"explain field {f} differs between the card and the CPU")
    f32_err = max(float(np.abs(exp[f] - exp_c[f]).max())
                  for f in ("top_scores", "score_parts"))
    if not f32_err <= EXPLAIN_F32_ATOL:
        fail(f"explain's f32 fields differ from the CPU run by {f32_err} "
             f"(> {EXPLAIN_F32_ATOL})")
    sha = explain_sha256(exp, len(pods))
    if sha != JAX_EXPLAIN_SHA256:
        fail(f"explain's integer fields differ from the JAX package's "
             f"(sha256 {sha})")
    failed = exp["part_node"][:len(pods)] < 0
    print(f"    {sum(a is not None for a in placed)} placed, "
          f"{sum(a is None for a in placed)} unschedulable, "
          f"{int(failed.sum())} with no feasible node; encode and explain "
          f"dispatch {card_s[0]:.3f} s cold and {card_s[1]:.3f} s warm on "
          f"the card, {cpu_s:.3f} s on the CPU; integer "
          f"fields equal (sha256 equal to the JAX package's), f32 fields "
          f"within {f32_err:.3g} (tolerance {EXPLAIN_F32_ATOL})")
    return {"card_cold_s": card_s[0], "card_warm_s": card_s[1],
            "cpu_s": cpu_s, "f32_max_abs_err": f32_err, "sha256": sha}


def classes_plan(nodes, pods) -> dict:
    """The run plan (ops/runs.py plan_runs) of one wave holding `pods`, as
    BatchScheduler encodes it: class runs and collapse ratio."""
    from kubernetes_tpu_torch.ops.runs import plan_runs
    from kubernetes_tpu_torch.sched.cycle import UNSCHEDULABLE_TAINT_KEY
    from kubernetes_tpu_torch.state.encode import Encoder

    enc = Encoder()
    enc.vocabs.label_keys.intern(UNSCHEDULABLE_TAINT_KEY)
    enc.vocabs.label_vals.intern("")
    _t, _ex, pe, _d = enc.encode_cluster(nodes, [], pods)
    plan = plan_runs(pe.cls, pe.priority, pe.creation, pe.valid,
                     pe.node_name_req)
    return {"n_runs": plan.n_runs,
            "collapse_ratio": round(plan.collapse_ratio, 2)}


def runs_phase(device) -> dict:
    """Phase 8, under KTPU_ASSIGN=runs: 8a BatchScheduler(device) on the
    `classes` shapes against JAX_CLASSES, the runs that took the closed
    form and those that fell back, epochs per dispatch, cold and median of
    CLASSES_WARM_RUNS warm cycles; 8b the scan and the runs engine on
    CLASSES_SCAN_PODS pods, placements bit-equal; 8c the
    Scheduler(device) drain of the backlog against JAX_CLASSES_DRAIN,
    per-wave times."""
    import os

    from kubernetes_tpu_torch import BatchScheduler
    from kubernetes_tpu_torch.models.workloads import (deployment_backlog_pods,
                                                       make_nodes)
    from kubernetes_tpu_torch.ops import assign as A
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops import runs as RN

    saved = os.environ.get("KTPU_ASSIGN")
    out = {}
    try:
        os.environ["KTPU_ASSIGN"] = "runs"
        nodes = make_nodes(CLASSES_NODES)
        pods = deployment_backlog_pods(CLASSES_PODS,
                                       deployments=CLASSES_DEPLOYMENTS)
        t_phase = time.perf_counter()
        sched = BatchScheduler(device=device)
        RN.reset_run_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = sched.schedule(nodes, [], pods)
        sync(device)
        cold_s = time.perf_counter() - t0
        stats, launches = dict(RN.assign_runs.stats), K.launch_counts()
        warm = []
        for _ in range(CLASSES_WARM_RUNS):
            t0 = time.perf_counter()
            again = sched.schedule(nodes, [], pods)
            sync(device)
            warm.append(time.perf_counter() - t0)
            if again.assignments != res.assignments:
                fail("a warm runs-engine cycle placed differently")
        got = dict(scheduled=res.scheduled,
                   sha256=assignments_sha256(res.assignments),
                   **classes_plan(nodes, pods))
        epochs = stats["epochs"] / max(stats["dispatches"], 1)
        print(f"  8a: scheduled {got['scheduled']} of {CLASSES_PODS}, "
              f"{got['n_runs']} class runs (collapse ratio "
              f"{got['collapse_ratio']}); {stats['closed']} runs took the "
              f"closed form, {stats['fallback']} fell back; {epochs:.2f} "
              f"epochs per dispatch; cycle {cold_s:.3f} s cold, warm "
              f"{[round(t, 4) for t in warm]} s, median "
              f"{statistics.median(warm):.4f} s; launches {launches}")
        if got != JAX_CLASSES:
            bad = [k for k in JAX_CLASSES if got.get(k) != JAX_CLASSES[k]]
            fail(f"the runs-engine cycle differs from the JAX package's in "
                 f"{bad}: {got}")
        if stats["fallback"] or stats["closed"] != got["n_runs"]:
            fail(f"the closed form did not take every run: {stats}")
        print(f"      placed count, placement sha256, class runs and "
              f"collapse ratio equal the JAX package's "
              f"({time.perf_counter() - t_phase:.1f} s)")
        out["batch"] = dict(got, cold_s=cold_s, warm_s=warm,
                            median_warm_s=statistics.median(warm),
                            closed=stats["closed"],
                            fallback=stats["fallback"],
                            epochs_per_dispatch=epochs, launches=launches)

        t_phase = time.perf_counter()
        small = deployment_backlog_pods(CLASSES_SCAN_PODS,
                                        deployments=CLASSES_SCAN_DEPLOYMENTS)
        cmp, k4 = {}, {}
        for engine in ("scan", "runs"):
            os.environ["KTPU_ASSIGN"] = engine
            sched = BatchScheduler(device=device)
            rec = Recorder(A, "assign_scan")
            K.reset_launch_counts()
            A.assign_scan_plain.calls = 0
            t0 = time.perf_counter()
            try:
                r = sched.schedule(nodes, [], small)
                sync(device)
            finally:
                rec.restore()
            cmp[engine] = (r.assignments, time.perf_counter() - t0)
            k4[engine] = (K.launch_counts()["assign_scan"],
                          A.assign_scan_plain.calls)
            if engine == "scan":
                out["k4_err"] = check_k4_steps(device, rec.args,
                                               SCAN_CHECK_STEPS, "8b")[0]
        if cmp["scan"][0] != cmp["runs"][0]:
            bad = sum(a != b for a, b in zip(cmp["scan"][0], cmp["runs"][0]))
            fail(f"the runs engine's placements differ from the scan's "
                 f"({bad} pods)")
        if device.type == "cuda" and (k4["scan"][0] < 1
                                      or k4["scan"][1] or k4["runs"][1]):
            fail(f"8b: K4 (launches, plain calls) by engine {k4}")
        print(f"  8b: {CLASSES_SCAN_PODS} pods of {CLASSES_SCAN_DEPLOYMENTS} "
              f"deployments: runs equal to the scan, placements bit-equal "
              f"({sum(a is not None for a in cmp['runs'][0])} placed); scan "
              f"{cmp['scan'][1]:.3f} s, runs {cmp['runs'][1]:.3f} s; K4 "
              f"(launches, plain calls) {k4} "
              f"({time.perf_counter() - t_phase:.1f} s)")
        out["scan_vs_runs"] = {"pods": CLASSES_SCAN_PODS,
                               "scan_s": cmp["scan"][1],
                               "runs_s": cmp["runs"][1],
                               "k4_launches": {e: v[0]
                                               for e, v in k4.items()}}

        t_phase = time.perf_counter()
        os.environ["KTPU_ASSIGN"] = "runs"
        os.environ["KTPU_OVERLOAD"] = "0"
        marks = [time.perf_counter()]
        K.reset_launch_counts()
        api = port_serving_api(device)
        drain = serving_drain(api, CLASSES_NODES,
                              CLASSES_PODS, workload="classes",
                              on_wave=lambda i: marks.append(
                                  time.perf_counter()))
        settle(api, "8c")
        wave_s = [b - a for a, b in zip(marks, marks[1:])]
        waves = [(w["attempted"], w["scheduled"], w["unschedulable"],
                  w["micro"], w["mode"], w["patch_rows"], w["class_runs"])
                 for w in drain["waves"]]
        for w, t in zip(waves, wave_s):
            print(f"  8c wave: attempted {w[0]} scheduled {w[1]} "
                  f"unschedulable {w[2]} micro {w[3]} {w[4]} "
                  f"({w[5]} rows) class runs {w[6]}: {t:.3f} s")
        ref = JAX_CLASSES_DRAIN
        if waves != [tuple(w) for w in ref["waves"]]:
            fail(f"8c's per-wave counts, modes or class runs differ from the "
                 f"JAX package's: {waves}")
        if (drain["bound"], drain["bound_sha256"]) != (ref["bound"],
                                                       ref["bound_sha256"]):
            fail("8c's binder order differs from the JAX package's")
        print(f"      {drain['bound']} bound in {len(waves)} waves; per-wave "
              f"counts, class runs and binder order equal the JAX "
              f"package's ({time.perf_counter() - t_phase:.1f} s)")
        out["drain"] = {"waves": waves, "wave_s": wave_s,
                        "bound": drain["bound"],
                        "launches": K.launch_counts()}
    finally:
        if saved is None:
            os.environ.pop("KTPU_ASSIGN", None)
        else:
            os.environ["KTPU_ASSIGN"] = saved
    return out


# --------------------------------------------------------------------------- #
# phase 9: the resilience layer — ledger and takeover, supervisor, prewarmer,
# telemetry
# --------------------------------------------------------------------------- #

class KernelThreads:
    """Counts K1/K2 wrapper calls by the thread that made them (the
    supervisor's dispatch worker, the prewarm thread, any other) and keeps
    the first prewarm-thread call's inputs with the stream it ran on.
    Installed by patching the names ops/waves.py calls."""

    def __init__(self):
        from kubernetes_tpu_torch.ops import waves as W

        self.W, self.saved = W, {n: getattr(W, n) for n in WAVE_KERNELS}
        self.counts = {}
        self.warm_args, self.warm_side_stream = {}, {}

        def spy(name):
            fn = self.saved[name]

            def run(*args):
                import threading

                import torch

                who = threading.current_thread().name
                role = ("dispatch" if who.startswith("ktpu-dispatch")
                        else "prewarm" if who.startswith("ktpu-prewarm")
                        else "other")
                key = (name, role)
                self.counts[key] = self.counts.get(key, 0) + 1
                if role == "prewarm" and name not in self.warm_args:
                    dev = args[0].device
                    self.warm_side_stream[name] = (
                        dev.type == "cuda"
                        and torch.cuda.current_stream(dev)
                        != torch.cuda.default_stream(dev))
                    self.warm_args[name] = tuple(
                        a.clone() if hasattr(a, "clone") else a for a in args)
                return fn(*args)
            return run

        for n in WAVE_KERNELS:
            setattr(W, n, spy(n))

    def count(self, role: str) -> dict:
        return {n: self.counts.get((n, role), 0) for n in WAVE_KERNELS}

    def restore(self):
        for n, fn in self.saved.items():
            setattr(self.W, n, fn)


def _phase_durations(sched, phase: str) -> list:
    return [dt for r in sched.telemetry.recorder.records()
            for p, dt in r["phases"] if p == phase
            and r.get("stats", {}).get("scheduled", 0) > 0]


def restart_phase(device) -> dict:
    """9a on the card against the JAX package's drill (JAX_RESTART)."""
    api = port_serving_api(device)
    keep = []
    spy = KernelThreads()
    marks = {}

    def on_wave(role, w):
        if role == "standby" and "first_led" not in marks:
            marks["first_led"] = (spy.count("dispatch"), w)
        if role == "leader":
            marks["last_leader"] = spy.count("dispatch")

    t0 = time.perf_counter()
    try:
        drill = restart_drill(api, SERVING_NODES, SERVING_PODS,
                              on_wave=on_wave, keep=keep)
    finally:
        spy.restore()
    wall = time.perf_counter() - t0
    timing = drill.pop("timing")
    leader, standby = keep
    got = json.loads(json.dumps(drill))
    if JAX_RESTART is None or got != JAX_RESTART:
        diff = {k: (got[k], (JAX_RESTART or {}).get(k)) for k in got
                if got[k] != (JAX_RESTART or {}).get(k)}
        fail(f"9a differs from the JAX package's drill: {diff}")
    if drill["double_bind_attempts"] or drill["unretired"] \
            or drill["bound"] != standby.cache.counts()[1]:
        fail("9a: not every placed pod was bound exactly once")
    first_mode = drill["standby_waves"][0][4]
    if first_mode == "full":
        fail("9a: the standby's first led wave re-encoded in full")
    before, after = marks["last_leader"], marks["first_led"][0]
    led = {n: after[n] - before[n] for n in WAVE_KERNELS}
    if device.type == "cuda" and not all(led.values()):
        fail(f"9a: K1/K2 did not launch in the first led wave: {led}")
    settle(api, "9a")
    iw = _phase_durations(leader, "intent-write") \
        + _phase_durations(standby, "intent-write")
    rep = drill["report"]
    print(f"  leader: {len(drill['leader_waves'])} waves, died at post_intent "
          f"of wave {drill['crashed_wave']} ({drill['bound_at_crash']} bound, "
          f"{drill['intents_left_at_crash']} intent left); standby beats "
          f"{statistics.median(timing['standby_beat_s']):.4f} s median")
    print(f"  recover(): {timing['recover_s']:.4f} s — replayed "
          f"{rep['replayed_intents']}, completed {rep['completed']}, "
          f"already bound {rep['already_bound']}, released "
          f"{rep['released']}, dropped {rep['dropped']}")
    print(f"  first led wave: {first_mode} snapshot, "
          f"{timing['led_wave_s'][0]:.4f} s, K1/K2 launches {led}; "
          f"{len(drill['standby_waves'])} led waves")
    print(f"  {drill['bound']} bound exactly once (0 double binds, 0 "
          f"unretired); intents written {drill['intents_written']}, retired "
          f"{drill['intents_retired']}; intent write "
          f"{statistics.median(iw) * 1e3:.3f} ms median per wave "
          f"(max {max(iw) * 1e3:.3f}); equal to the JAX package's drill "
          f"({wall:.1f} s)")
    return dict(drill=drill, timing=timing, intent_write_ms=[
        x * 1e3 for x in iw], first_led_launches=led,
        first_led_mode=first_mode, wall_s=wall)


def supervisor_phase(device, ref_bound) -> dict:
    """9b: phase 5b's drain with a hang and an error on the card and no
    fallback configured (each abandoned, requeued and re-run on the card),
    then one error with fallback_device="cpu" configured (a degraded wave
    on the CPU equal to 5b's, the prober re-admitting the card)."""
    import os

    import torch

    api = port_serving_api(device)
    fl = api.faultline
    keep, spy = [], KernelThreads()
    marks = {}

    def before(w, s):
        marks[w] = len(s.binder.bound)
        if w == HANG_WAVE:
            fl.install("device.hang@cycle:1")
        elif w == ERROR_WAVE:
            fl.install("device.error@cycle:1")
        elif w == FALLBACK_WAVE:
            s.supervisor.fallback_device = torch.device("cpu")
            fl.install("device.error@cycle:1")
        else:
            fl.uninstall()
        if w == FALLBACK_WAVE + 1:
            marks["next_before"] = spy.count("dispatch")

    def after(w, s):
        if w == FALLBACK_WAVE:
            marks["degraded"] = list(s.binder.bound[marks[w]:])
            marks["degraded_cycles"] = s.supervisor.stats.degraded_cycles
            if not s.supervisor.wait_recovered(60):
                fail("9b: the prober did not re-admit the card")
        if w == FALLBACK_WAVE + 1:
            marks["next_after"] = spy.count("dispatch")

    saved = {k: os.environ.get(k) for k in SUPERVISOR_ENV}
    os.environ.update(SUPERVISOR_ENV)
    t0 = time.perf_counter()
    try:
        drain = serving_drain(api, SERVING_NODES, SERVING_PODS,
                              before_wave=before, after_wave=after,
                              keep=keep)
    finally:
        fl.uninstall()
        spy.restore()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.perf_counter() - t0
    settle(api, "9b", fallback_ok=True)
    st = keep[0].supervisor.stats
    counts = [w[:4] for w in JAX_DRAIN["waves"]]
    got = [(w["attempted"], w["scheduled"], w["unschedulable"], w["micro"])
           for w in drain["waves"]]
    if got != [tuple(c) for c in counts] or (
            drain["bound"], drain["bound_sha256"]) != (
            JAX_DRAIN["bound"], JAX_DRAIN["bound_sha256"]):
        fail(f"9b's drain differs from 5b's: {got}")
    if drain.get("aborted") != [[HANG_WAVE, SERVING_BATCH],
                                [ERROR_WAVE, SERVING_BATCH]] and \
            drain.get("aborted") != [(HANG_WAVE, SERVING_BATCH),
                                     (ERROR_WAVE, SERVING_BATCH)]:
        fail(f"9b: abandoned waves {drain.get('aborted')}")
    if (st.abandoned, st.watchdog_timeouts, st.fallback_dispatches,
            st.degraded_cycles, marks["degraded_cycles"]) != (2, 1, 1, 1, 1):
        fail(f"9b: supervisor counters {st}")
    lo = marks[FALLBACK_WAVE]
    if marks["degraded"] != [tuple(b) for b in
                             ref_bound[lo: lo + len(marks["degraded"])]]:
        fail("9b: the degraded wave's placements differ from 5b's wave")
    nxt = {n: marks["next_after"][n] - marks["next_before"][n]
           for n in WAVE_KERNELS}
    if device.type == "cuda" and not all(nxt.values()):
        fail(f"9b: the wave after re-admission launched no K1/K2: {nxt}")
    print(f"  hang at wave {HANG_WAVE}: abandoned after "
          f"{st.watchdog_timeouts} watchdog timeout; error at wave "
          f"{ERROR_WAVE}: abandoned; each batch requeued and re-run on the "
          f"card (abandoned {st.abandoned}, fallback_dispatches 0 before "
          f"wave {FALLBACK_WAVE})")
    print(f"  wave {FALLBACK_WAVE} with fallback_device='cpu': degraded onto "
          f"the CPU in {st.degraded_cycle_seconds[0]:.3f} s, "
          f"{len(marks['degraded'])} placements equal to 5b's wave; the "
          f"prober re-admitted the card ({st.recoveries} recoveries, "
          f"{st.probes} probes); the next wave launched {nxt} on the card")
    print(f"  binder order equal to 5b's and the JAX package's "
          f"({drain['bound']} bound, {wall:.1f} s)")
    return dict(stats=dict(abandoned=st.abandoned,
                           watchdog_timeouts=st.watchdog_timeouts,
                           device_errors=st.device_errors,
                           fallback_dispatches=st.fallback_dispatches,
                           degraded_cycles=st.degraded_cycles,
                           degraded_cycle_seconds=st.degraded_cycle_seconds,
                           recoveries=st.recoveries, probes=st.probes,
                           last_recovery_s=st.last_recovery_s),
                next_wave_launches=nxt, wall_s=wall)


def growth_run(device, prewarm: bool) -> dict:
    """9c, one run: GROWTH_FROM nodes growing to GROWTH_TO in steps of
    GROWTH_STEP, a wave of GROWTH_BATCH fresh flagship pods at each step
    (still clock, binds confirmed between waves)."""
    import dataclasses

    import torch

    api = port_serving_api(device)
    T = api.types
    nodes = api.workloads.make_nodes(GROWTH_TO)
    steps = list(range(GROWTH_FROM, GROWTH_TO + 1, GROWTH_STEP))
    pods = api.workloads.flagship_pods(len(steps) * GROWTH_BATCH)
    by_key = {p.key: p for p in pods}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    s = api.scheduler(binder=api.RecordingBinder(), batch_size=GROWTH_BATCH,
                      clock=FakeClock())
    s.prewarmer.enabled = prewarm
    added, rows = 0, []
    for i, n in enumerate(steps):
        for node in nodes[added:n]:
            s.on_node_add(node)
        added = n
        for p in pods[i * GROWTH_BATCH:(i + 1) * GROWTH_BATCH]:
            s.on_pod_add(p)
        first = len(s.binder.bound)
        t0 = time.perf_counter()
        st = s.schedule_pending()
        wave_s = time.perf_counter() - t0
        rows.append(dict(nodes=n, N=s.telemetry.recorder.records()[-1][
            "bucket"]["N"], mode=s.cache.last_snapshot_mode,
            scheduled=st.scheduled, wave_s=wave_s))
        for key, node in s.binder.bound[first:]:
            s.on_pod_add(dataclasses.replace(by_key[key], node_name=node))
    s.prewarmer.wait(120)
    settle(api, "9c", prewarm_ok=prewarm)
    log = [(d.N, d.E, eng) for d, eng in s.prewarmer.warm_log]
    if len(set(log)) != len(log):
        fail(f"9c: the prewarmer warmed one signature twice: {log}")
    return dict(rows=rows, bound=list(s.binder.bound), warm_log=log,
                warm_s=sorted(s.prewarmer.warm.values()))


def growth_phase(device) -> dict:
    """9c: the growth with the prewarmer and without; the warm's K1/K2
    launches (prewarm thread, prewarm stream) against their plain
    versions."""
    from kubernetes_tpu_torch.ops import kernels as K

    spy = KernelThreads()
    try:
        warm = growth_run(device, prewarm=True)
    finally:
        spy.restore()
    cold = growth_run(device, prewarm=False)
    if warm["bound"] != cold["bound"]:
        fail("9c: placements differ with and without the prewarmer")
    if not warm["warm_log"] or not any(n > GROWTH_FROM for n, _e, _g in
                                       warm["warm_log"]):
        fail(f"9c: the prewarmer never warmed a larger bucket: "
             f"{warm['warm_log']}")
    errs = {}
    a1 = spy.warm_args.get("contention_scan")
    a2 = spy.warm_args.get("domain_rank")
    if a1 is None or a2 is None:
        fail("9c: the warm dispatch launched no K1/K2 from the prewarm thread")
    if device.type == "cuda" and not all(spy.warm_side_stream.values()):
        fail("9c: the warm's kernels ran on the default stream")
    errs["contention_scan"] = k1_diff(K.contention_scan(*a1),
                                      K.contention_scan_plain(*a1))
    errs["domain_rank"] = k2_diff(K.domain_rank(*a2),
                                  K.domain_rank_plain(*a2))
    sync(device)
    if any(errs.values()):
        fail(f"9c: a warm launch disagrees with its plain version: {errs}")
    print(f"  warms: {warm['warm_log']} (N, E, engine), "
          f"{[round(x, 4) for x in warm['warm_s']]} s; prewarm-thread "
          f"launches {spy.count('prewarm')} on the prewarm stream, equal to "
          f"their plain versions {errs}")
    out = {"warm_log": warm["warm_log"], "warm_s": warm["warm_s"],
           "prewarm_launches": spy.count("prewarm"), "errs": errs,
           "steps": []}
    prev = None
    for rw, rc in zip(warm["rows"], cold["rows"]):
        crossed = prev is not None and rw["N"] != prev
        prev = rw["N"]
        out["steps"].append(dict(nodes=rw["nodes"], N=rw["N"],
                                 mode=rw["mode"], scheduled=rw["scheduled"],
                                 warm_wave_s=rw["wave_s"],
                                 cold_wave_s=rc["wave_s"], crossed=crossed))
        if crossed:
            print(f"  first wave at N={rw['N']} ({rw['nodes']} nodes, "
                  f"{rw['mode']}): {rw['wave_s']:.4f} s with the prewarmer, "
                  f"{rc['wave_s']:.4f} s without")
    print(f"  placements equal with and without the prewarmer "
          f"({len(warm['bound'])} bound)")
    return out


def telemetry_phase(device, serving_sched) -> dict:
    """9d: one 5b wave's flight record (phase names against the JAX
    package's, the device split), the watch→bind p50/p99 of a drain on a
    running clock, and one wave under KTPU_PROFILE."""
    import os
    import tempfile

    recs = [r for r in serving_sched.telemetry.recorder.records()
            if r.get("stats", {}).get("scheduled") == SERVING_BATCH]
    if not recs:
        fail("9d: no full 5b wave in the flight recorder")
    rec = recs[0]
    names = [p for p, _ in rec["phases"]]
    if JAX_WAVE_PHASES is None or names != JAX_WAVE_PHASES:
        fail(f"9d: phase names {names} differ from the JAX package's")
    split = rec.get("device_split") or {}
    if set(split) != {"launch_s", "execute_s", "readback_s"} or (
            device.type == "cuda" and not split["execute_s"] > 0):
        fail(f"9d: device split {split}")
    print(f"  5b wave {rec['seq']}: phases {names} equal the JAX package's; "
          f"device split launch {split['launch_s']:.6f} s, execute "
          f"{split['execute_s']:.6f} s, readback {split['readback_s']:.6f} s")
    api = port_serving_api(device)
    keep = []
    t0 = time.perf_counter()
    drain = serving_drain(api, SERVING_NODES, SERVING_PODS,
                          clock=time.monotonic, keep=keep)
    q = keep[0].telemetry.latency_quantiles()
    print(f"  a drain on a running clock: {drain['bound']} bound in "
          f"{len(drain['waves'])} waves; watch→bind p50 {q[0.5]:.4f} s, p99 "
          f"{q[0.99]:.4f} s ({time.perf_counter() - t0:.1f} s)")
    settle(api, "9d")
    prof = tempfile.mkdtemp(prefix="ktpu-profile-")
    os.environ["KTPU_PROFILE"] = prof
    try:
        s = api.scheduler(binder=api.RecordingBinder(),
                          batch_size=SERVING_BATCH, clock=FakeClock())
    finally:
        os.environ.pop("KTPU_PROFILE", None)
    for n in api.workloads.make_nodes(SERVING_NODES):
        s.on_node_add(n)
    for p in api.workloads.flagship_pods(SERVING_BATCH):
        s.on_pod_add(p)
    s.schedule_pending()
    path = s.telemetry.stop_profile()
    settle(api, "9d")
    if path is None:
        fail("9d: KTPU_PROFILE wrote no trace")
    events = json.load(open(path))["traceEvents"]
    cycles = [e for e in events if e.get("name") == "cycle"
              and e.get("ph") == "X"]
    if len(cycles) != 1:
        fail(f"9d: {len(cycles)} cycle ranges in the trace")
    c = cycles[0]
    inside = [e for e in events if e.get("cat") == "kernel"
              and c["ts"] <= e["ts"] and e["ts"] + e.get("dur", 0)
              <= c["ts"] + c["dur"]]
    found = {n: sum(n in e["name"] for e in inside) for n in WAVE_KERNELS}
    if device.type == "cuda" and not all(found.values()):
        fail(f"9d: the cycle range holds no K1/K2 kernel events: {found}")
    busy = sum(e.get("dur", 0) for e in inside)
    print(f"  KTPU_PROFILE: {os.path.basename(path)} ({os.path.getsize(path)} "
          f"bytes); the cycle range ({c['dur'] / 1e3:.2f} ms) holds "
          f"{len(inside)} kernels, {found}; kernel time {busy / 1e3:.2f} ms "
          f"({busy / max(c['dur'], 1):.1%} of the range)")
    return dict(phases=names, device_split=split,
                p50_s=q[0.5], p99_s=q[0.99], profile_kernels=found,
                profile_cycle_ms=c["dur"] / 1e3, profile_kernel_ms=busy / 1e3)


def pct_ms(xs, q: float) -> float:
    """The q-quantile of seconds `xs` in ms (nearest rank)."""
    import math

    xs = sorted(xs)
    return xs[max(0, math.ceil(q * len(xs)) - 1)] * 1e3


def framework_phase(device, card: str) -> dict:
    """Phase 10a on the card: framework_drain through the port's Scheduler
    (device="cuda"), per wave timed as 5b, against JAX_FRAMEWORK; K1/K2
    launch counts set to 0 just before and read just after; both kernels
    held against their plain versions on the drain's first wave's inputs."""
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops import waves as W

    api = port_serving_api(device)
    timer = ServingTimer(device)
    make = api.scheduler
    api.scheduler = lambda **kw: timer.wrap(make(**kw))
    recs = [Recorder(W, "contention_scan"), Recorder(W, "domain_rank")]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        drain = framework_drain(api)
    finally:
        timer.restore()
        for r in recs:
            r.restore()
    wall_s = time.perf_counter() - t0
    settle(api, "10a")
    launches = K.launch_counts()
    for i, (w, t) in enumerate(zip(drain["waves"], timer.waves)):
        print(f"  wave {i:2d}: {'micro' if w['micro'] else 'bulk '} "
              f"{w['mode']:6s} {w['patch_rows']:6d} rows; attempted "
              f"{w['attempted']:5d} scheduled {w['scheduled']:5d} "
              f"unschedulable {w['unschedulable']:5d}; snapshot "
              f"{t['snapshot_s']:.4f} s, dispatch+readback "
              f"{t['dispatch_s']:.4f} s, commit {t['commit_s']:.4f} s")
    sched_s = sum(t["wave_s"] for t in timer.waves)
    print(f"    {drain['bound']} pods bound in {len(drain['waves'])} waves: "
          f"{sched_s:.3f} s in schedule_pending "
          f"({drain['bound'] / sched_s:.1f} pods/s), {wall_s:.3f} s with "
          f"the informer events ({card}); launches {launches}")
    for name in WAVE_KERNELS:
        if launches.get(name, 0) <= 0 and device.type == "cuda":
            fail(f"kernel {name} was not launched by phase 10a")
    check_drain(drain, "the JAX package's (JAX_FRAMEWORK)", JAX_FRAMEWORK)
    a1 = recs[0].args
    d1 = k1_diff(K.contention_scan(*a1), K.contention_scan_plain(*a1))
    dom, nd = recs[1].args
    d2 = k2_diff(K.domain_rank(dom, nd), K.domain_rank_plain(dom, nd))
    sync(device)
    if d1 or d2:
        fail("a kernel disagrees with its plain version on phase 10a's "
             "first wave's inputs")
    print(f"    per-wave counts, snapshot modes and binder order equal "
          f"JAX_FRAMEWORK; K1/K2 on the first wave's inputs exact")
    return dict(drain=drain, timer=timer.waves, sched_s=sched_s,
                wall_s=wall_s, launches=launches,
                errs={"contention_scan": d1, "domain_rank": d2})


def extender_chip_phase(device, bound, card: str) -> dict:
    """Phases 10b and 10c on the card: extender_phase through the port's
    ExtenderServer over ExtenderBackend(device="cuda") and the port's
    Scheduler, against JAX_EXTENDER; p50/p99 ms per verb; launch counts
    per subphase."""
    from kubernetes_tpu_torch.ops import kernels as K

    api = port_serving_api(device)
    counts, cur = {}, []

    def mark(name):
        # each subphase's launches: counts set to 0 just before it, read
        # just after (at the next mark, or after the phase)
        if cur:
            counts[cur[-1]] = K.launch_counts()
        cur.append(name)
        K.reset_launch_counts()

    t0 = time.perf_counter()
    out, secs = extender_phase(api, bound, mark=mark)
    counts[cur[-1]] = K.launch_counts()
    wall_s = time.perf_counter() - t0
    settle(api, "10b/10c")
    lat = {v: dict(calls=len(x), p50_ms=pct_ms(x, 0.5),
                   p99_ms=pct_ms(x, 0.99), max_ms=max(x) * 1e3)
           for v, x in secs.items() if v != "sched_wave"}
    for v, d in lat.items():
        print(f"  {v:10s} {d['calls']:4d} calls at {FRAMEWORK_NODES} nodes: "
              f"p50 {d['p50_ms']:.2f} ms, p99 {d['p99_ms']:.2f} ms, "
              f"max {d['max_ms']:.2f} ms ({card})")
    print(f"  10c: {out['sched']['bound']} of {EXTENDER_SCHED_PODS} pods "
          f"bound through the extender in one wave of "
          f"{secs['sched_wave'][0]:.3f} s; phase {wall_s:.1f} s; launches "
          f"10b {counts['10b']}, 10c {counts['10c']}")
    for key, ref in JAX_EXTENDER.items():
        if out[key] != ref:
            fail(f"phase 10b/10c: {key} differs from JAX_EXTENDER: "
                 f"{out[key]}")
    print("    Filter, Prioritize, ProcessPreemption, Bind answers and the "
          "10c placements equal JAX_EXTENDER")
    return dict(answers=out, latency=lat, sched_wave_s=secs["sched_wave"][0],
                wall_s=wall_s, launches=counts)


def cosched_phase(device, card: str) -> dict:
    """Phase 10d on the card: cosched_drain through the port's Scheduler,
    against JAX_COSCHED; K1/K2 launch counts around it (K1 must launch)."""
    from kubernetes_tpu_torch.ops import kernels as K

    api = port_serving_api(device)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = cosched_drain(api)
    wall_s = time.perf_counter() - t0
    settle(api, "10d")
    launches = K.launch_counts()
    print(f"    {out['bound']} bound ({out['released']} released from the "
          f"waiting map, {out['waiting']} still waiting) in "
          f"{len(out['waves'])} waves, {wall_s:.3f} s ({card}); launches "
          f"{launches}")
    # gang_workload_pods carry no spread or anti-affinity: the wave
    # engine's domain-quota pass (K2) has nothing to rank, as in phase 7
    if launches.get("contention_scan", 0) <= 0 and device.type == "cuda":
        fail("kernel contention_scan was not launched by phase 10d")
    if out != JAX_COSCHED:
        fail(f"phase 10d differs from JAX_COSCHED: {out}")
    print("    per-wave counts, binder order, releases equal JAX_COSCHED")
    return dict(result=out, wall_s=wall_s, launches=launches)


# --------------------------------------------------------------------------- #
# phase 11: the scheduler process over the API (shared with
# scripts/flagship_reference.py, which runs it on the JAX package)
# --------------------------------------------------------------------------- #

# SERVER_PODS cut from 10,000 to 5,000 for phase 18's time
SERVER_NODES, SERVER_PODS, SERVER_HTTP_PODS = 5000, 5000, 2000
SERVER_VIPS, SERVER_BATCH = 64, 4096
SERVER_BATCH_WINDOW = 0.15  # the server's debounce before a wave
SERVER_BARRIER_S = 120.0     # the longest a wave may wait at the barrier
# the drain ends when the active queue is empty and the bound count has not
# moved for this long
SERVER_QUIET_S = 2.0
SERVER_TIMEOUT_S = 600.0
SERVER_LEASE = dict(lease_duration=1.5, renew_deadline=1.0, retry_period=0.1)
SERVER_CRASH = "proc.crash@post_bind:2"  # 11c: the leader's 2nd intent wave

# The JAX package's SchedulerServer over its own apiserver on the same
# script (server_drain with its wave barrier: 5,000 nodes, flagship_pods(
# 5000) created before start(), LocalTransport; JAX 0.9.0 on the CPU; the
# port's CPU run, `--package port`, gives the same object).
# Reproduce with `JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py
# --package jax --path server`; `--transport http --pods 2000` gives
# JAX_SERVER_HTTP. The barrier makes each wave start from one state (every
# earlier Binding confirmed, every backoff served), so the whole (pod,
# node) map is gated. The first wave precedes any retry and any
# confirmation, so it is gated in the run without the barrier too.
JAX_SERVER = {
    "bound": 5000, "waves": [2496, 2504],
    "first_wave_sha256":
        "cc076fd3e3bdaf04373d878066e0500d00ad86b803e325c8eb69cd4047f9bf7e",
    "bound_sha256":
        "95b27fdfbdce4c6daadbe768e66a78685a9f40b4211f3290fb1de295f503d183"}
JAX_SERVER_HTTP = {
    "bound": 2000, "waves": [1360, 640],
    "first_wave_sha256":
        "87df4fbcb116f161a829d101f02a0dca4654b039536d23d399e163c809f70790",
    "bound_sha256":
        "3936289b713092fd8c15688037cc70075037616b8ef8354a595c83c285c56689"}


def port_server_api(device):
    """What phase 11 drives, from the port: the apiserver, the client and the
    scheduler process on `device`. scripts/flagship_reference.py builds the
    same namespace from the JAX package."""
    import types as pytypes

    import kubernetes_tpu_torch as ktt
    from kubernetes_tpu_torch.api import types, v1
    from kubernetes_tpu_torch.apiserver import APIServer, HTTPGateway
    from kubernetes_tpu_torch.cli import Cluster, ClusterConfig
    from kubernetes_tpu_torch.cli.kubectl import main as kubectl
    from kubernetes_tpu_torch.client import Client
    from kubernetes_tpu_torch.client.informers import (InformerFactory,
                                                       SharedInformer)
    from kubernetes_tpu_torch.component.metrics_server import MetricsServer
    from kubernetes_tpu_torch.controllers import ControllerManager
    from kubernetes_tpu_torch.kubemark import HollowCluster
    from kubernetes_tpu_torch.machinery import errors
    from kubernetes_tpu_torch.models import workloads
    from kubernetes_tpu_torch.proxy import Proxier
    from kubernetes_tpu_torch.proxy.healthcheck import ProxierHealthServer
    from kubernetes_tpu_torch.sched.ledger import BindIntentLedger
    from kubernetes_tpu_torch.sched.server import APIBinder, SchedulerServer
    from kubernetes_tpu_torch.state.dims import Dims, bucket
    from kubernetes_tpu_torch.storage import native, wal
    from kubernetes_tpu_torch.utils import faultline

    made = []

    def cluster_config(**kw):
        return ClusterConfig(device=device.type, **kw)

    def server(client, **kw):
        srv = SchedulerServer(client, device=device, **kw)
        made.append(srv.scheduler)
        return srv

    def scheduler(**kw):
        s = ktt.Scheduler(device=device, **kw)
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
        cluster_config=cluster_config, kubectl=kubectl, Proxier=Proxier,
        ProxierHealthServer=ProxierHealthServer,
        InformerFactory=InformerFactory, MetricsServer=MetricsServer)


class BindWatch:
    """A watch pump over every pod, apart from the scheduler's own client:
    each pod's first Binding (nodeName set where none was), the time it
    was seen, and any second one — a pod bound twice, or moved to another
    node, is a double bind."""

    def __init__(self, client):
        import threading

        self.bound = {}      # pod key -> node
        self.at = {}         # pod key -> time.monotonic() of the binding
        self.doubles = []
        self.deleted = set()
        self._w = client.pods.watch(namespace="")
        self._t = threading.Thread(target=self._pump, daemon=True,
                                   name="bind-watch")
        self._t.start()

    def _pump(self) -> None:
        while True:
            ev = self._w.next(timeout=0.5)
            if ev is None:
                if self._w.stopped:
                    return
                continue
            if ev.type == "ERROR":
                self.doubles.append(("watch-error", str(ev.object)))
                return
            md = ev.object.get("metadata", {})
            key = f"{md.get('namespace', 'default')}/{md.get('name', '')}"
            if ev.type == "DELETED":
                self.deleted.add(key)
                continue
            node = (ev.object.get("spec") or {}).get("nodeName")
            if not node:
                continue
            prev = self.bound.get(key)
            if prev is None:
                self.bound[key] = node
                self.at[key] = time.monotonic()
            elif prev != node:
                self.doubles.append((key, prev, node))

    def count(self) -> int:
        return len(self.bound)

    def stop(self) -> None:
        self._w.stop()
        self._t.join(timeout=5)


class WaveLog:
    """Wraps a Scheduler's schedule_pending (in this script only): every
    wave's counts, keys and times, and every wave that raised — the
    server's run_one_wave swallows exceptions so that its loop never
    dies, and the phase must not."""

    def __init__(self, sched):
        self.waves, self.errors = [], []
        inner = sched.schedule_pending

        def wrapped(*a, **kw):
            t0 = time.monotonic()
            try:
                st = inner(*a, **kw)
            except Exception as e:  # noqa: BLE001 - counted, re-raised
                self.errors.append(repr(e))
                raise
            if st.attempted:
                self.waves.append(dict(
                    t0=t0, t1=time.monotonic(), attempted=st.attempted,
                    scheduled=st.scheduled, unschedulable=st.unschedulable,
                    bound=sorted(st.assignments.items())))
            return st

        sched.schedule_pending = wrapped


def wave_barrier(srv, log) -> None:
    """Holds each wave of `srv`'s loop (its run_one_wave, which the loop
    calls outside the server's lock) until the informer has delivered the
    Binding confirmation of every pod the earlier waves bound (`log`'s
    waves) and every pod in backoff has served its backoff. Each wave then
    starts from one state whatever the host's speed: the failed pods all
    back in the active queue, the pods bound before it all confirmed.
    Without it, which retried pods a wave holds depends on when the
    confirmations land, since each moves the failed pods back (ROADMAP
    §C). A wait longer than SERVER_BARRIER_S is counted in log.errors.
    Works on both packages' servers."""
    s, inner = srv.scheduler, srv.run_one_wave
    pending, seen = set(), [0]

    def ready() -> bool:
        for w in log.waves[seen[0]:]:
            pending.update(k for k, _ in w["bound"])
        seen[0] = len(log.waves)
        q = s.queue
        with srv._mu:
            pending.difference_update(
                [k for k in pending if not s.cache.is_assumed(k)])
            with q._mu:
                due = max((t for t, _, e in q._backoff
                           if q._backoff_keys.get(e.pod.key) is e),
                          default=None)
            return not pending and (due is None or due <= s.clock())

    def run_one_wave():
        t0 = time.monotonic()
        while not ready():
            if time.monotonic() - t0 > SERVER_BARRIER_S:
                log.errors.append(f"wave barrier held over "
                                  f"{SERVER_BARRIER_S:.0f} s ({len(pending)}"
                                  f" bindings unconfirmed)")
                break
            time.sleep(0.01)
        return inner()

    srv.run_one_wave = run_one_wave


def placement_sha256(pairs) -> str:
    """sha256 over sorted (pod key, node) pairs."""
    return hashlib.sha256("\n".join(
        f"{k} {n}" for k, n in sorted(pairs)).encode()).hexdigest()


def _until(cond, timeout: float, what: str, step: float = 0.05) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            fail(f"phase 11: timed out after {timeout:.0f} s waiting for "
                 f"{what}")
        time.sleep(step)


def _quiet(srv, watch, quiet_s: float, timeout: float) -> None:
    """Until the server's active queue is empty and the bound count has not
    moved for quiet_s seconds."""
    deadline = time.monotonic() + timeout
    last, since = -1, time.monotonic()
    while True:
        if not srv.wait_until_idle(max(1.0, deadline - time.monotonic())):
            s = srv.scheduler
            st = s.supervisor.stats
            fail(f"phase 11: the server's queue never drained: queue "
                 f"{s.queue.lengths()}, bound {watch.count()}, loop alive "
                 f"{[t.is_alive() for t in srv._threads]}, leader "
                 f"{getattr(srv.elector, 'is_leader', None)}, supervisor "
                 f"abandoned {st.abandoned} timeouts {st.watchdog_timeouts} "
                 f"errors {st.device_errors} healthy {s.supervisor.healthy} "
                 f"last failure {st.last_failure!r}")
        n = watch.count()
        if n != last:
            last, since = n, time.monotonic()
        elif time.monotonic() - since >= quiet_s:
            return
        if time.monotonic() > deadline:
            fail(f"phase 11: the bound count kept moving for {timeout:.0f} s")
        time.sleep(0.05)


def pod_obj(api, pod) -> dict:
    """A v1 Pod the apiserver admits: pod_to_v1 with a container image (the
    apiserver's validation requires one)."""
    obj = api.pod_to_v1(pod)
    for c in obj["spec"]["containers"]:
        c.setdefault("image", "pause")
    return obj


def _create(client, api, nodes, pods) -> float:
    t0 = time.perf_counter()
    for n in nodes:
        client.nodes.create(api.node_to_v1(n))
    for p in pods:
        client.pods.create(pod_obj(api, p))
    return time.perf_counter() - t0


def _server_kw(api, storage, identity: str, n_nodes: int, n_pods: int):
    return dict(leader_elect=True,
                ledger=api.ledger(storage, identity=identity),
                base_dims=api.Dims(N=api.bucket(n_nodes), P=SERVER_BATCH,
                                   E=api.bucket(n_pods + 256)),
                batch_window=SERVER_BATCH_WINDOW, cycle_interval=0.02)


def _api_pods(client):
    return client.pods.list("")["items"]


def _outcome(client, watch, waves, errors, led) -> dict:
    """The drain's result as the apiserver holds it (one LIST), held to
    exactly-once: every bound pod seen bound once by the watch pump, no
    double bind, no wave that raised, no unretired intent."""
    items = _api_pods(client)
    pairs = [(f"{p['metadata'].get('namespace', 'default')}/"
              f"{p['metadata']['name']}", p["spec"]["nodeName"])
             for p in items if (p.get("spec") or {}).get("nodeName")]
    if watch.doubles:
        fail(f"phase 11: double binds {watch.doubles[:5]}")
    if dict(pairs) != {k: v for k, v in watch.bound.items()
                       if k not in watch.deleted}:
        fail("phase 11: the LIST and the watch pump disagree on bindings")
    if errors:
        fail(f"phase 11: {len(errors)} waves raised: {errors[:3]}")
    left = led.unretired()
    if left:
        fail(f"phase 11: {len(left)} unretired intents")
    t0 = waves[0]["t0"] if waves else 0.0
    t1 = max(watch.at.values()) if watch.at else t0
    return {"pods": len(items), "bound": len(pairs),
            "bound_sha256": placement_sha256(pairs),
            "first_wave_sha256": placement_sha256(
                waves[0]["bound"] if waves else ()),
            "drain_s": t1 - t0}


def server_drain(api, n_nodes: int = None, n_pods: int = None,
                 transport: str = "local", barrier: bool = True, mark=None,
                 after=None, binary: bool = False,
                 data_dir: str = None) -> dict:
    """11a (and 11d with transport="http"): a fresh APIServer holding
    make_nodes(n_nodes) and flagship_pods(n_pods), created through the
    client before the SchedulerServer starts, so that the informers' first
    LIST puts the whole backlog in the queue before the first wave. One
    leader-elected SchedulerServer with a BindIntentLedger on the
    apiserver's storage drains it (run until the queue is empty and the
    bound count is still for SERVER_QUIET_S), each wave behind
    wave_barrier unless `barrier` is false (the timed run). `mark()` is
    called just before start(); `after(api_server, client, srv, watch,
    out)` runs before the server stops (11b). `binary` puts the HTTP client
    on the binary codec, and `data_dir` makes the apiserver durable over
    that directory with its default policy, batch (14b)."""
    n_nodes = SERVER_NODES if n_nodes is None else n_nodes
    n_pods = SERVER_PODS if n_pods is None else n_pods
    srv_api = api.APIServer(data_dir=data_dir) if data_dir \
        else api.APIServer()
    gw = srv = watch = None
    try:
        admin = api.Client.local(srv_api)
        if transport == "http":
            gw = api.HTTPGateway(srv_api).start()
            client = api.Client.http(gw.url, binary=binary)
        else:
            client = admin
        W = api.workloads
        create_s = _create(client, api, W.make_nodes(n_nodes),
                           W.flagship_pods(n_pods))
        watch = BindWatch(admin)
        srv = api.server(client, **_server_kw(api, srv_api.storage, "11a",
                                              n_nodes, n_pods))
        log = WaveLog(srv.scheduler)
        if barrier:
            wave_barrier(srv, log)
        if mark is not None:
            mark()
        t_start = time.monotonic()
        srv.start()
        if not srv.elector.wait_for_leadership(30):
            fail("phase 11: the server never acquired its lease")
        _quiet(srv, watch, SERVER_QUIET_S, SERVER_TIMEOUT_S)
        out = _outcome(admin, watch, log.waves, log.errors,
                       srv.scheduler.ledger)
        q = srv.scheduler.telemetry.latency_quantiles()
        out.update(create_s=create_s, creates_per_s=(n_nodes + n_pods)
                   / create_s, start_to_first_wave_s=(
                       log.waves[0]["t0"] - t_start if log.waves else None),
                   barrier=barrier,
                   waves=[{k: w[k] for k in ("attempted", "scheduled",
                                             "unschedulable")}
                          for w in log.waves],
                   wave_s=[w["t1"] - w["t0"] for w in log.waves],
                   watch_bind_p50_s=q[0.5], watch_bind_p99_s=q[0.99])
        out["pods_per_s"] = out["bound"] / max(out["drain_s"], 1e-9)
        # the binder's order at wave granularity: each wave's (pod, node)
        # pairs, the waves in order
        out["waves_sha256"] = hashlib.sha256(json.dumps(
            [w["bound"] for w in log.waves]).encode()).hexdigest()
        if after is not None:
            after(srv_api, admin, srv, watch, out)
        return out
    finally:
        if srv is not None:
            srv.stop()
        if watch is not None:
            watch.stop()
        if gw is not None:
            gw.stop()
        srv_api.close()


def vip_objects(api, n_pods: int, count: int, targets) -> tuple:
    """11b's objects: a PriorityClass `vip` (1000), a PodDisruptionBudget
    over app-0 and `count` storm_vips asking for a whole node (32 cpu),
    carrying priorityClassName: vip instead of a priority, vip i pinned by
    a hostname nodeSelector to targets[i]. 11a leaves about half the nodes
    empty (the flagship's zone affinity packs its groups), so unpinned
    vips would take empty nodes; pinned to occupied ones, each must
    preempt."""
    pc = {"apiVersion": "scheduling.k8s.io/v1", "kind": "PriorityClass",
          "metadata": {"name": "vip"}, "value": 1000}
    pdb = {"apiVersion": "policy/v1beta1", "kind": "PodDisruptionBudget",
           "metadata": {"name": "app-0", "namespace": "default"},
           "spec": {"minAvailable": 1,
                    "selector": {"matchLabels": {"app": "app-0"}}}}
    vips = []
    for v in storm_vips(api.types, api.workloads, n_pods, count):
        obj = pod_obj(api, v)
        obj["spec"]["containers"][0]["resources"]["requests"]["cpu"] = "32"
        obj["spec"].pop("priority", None)
        obj["spec"]["priorityClassName"] = "vip"
        obj["spec"]["nodeSelector"] = {
            api.workloads.HOSTNAME: targets[len(vips)]}
        vips.append(obj)
    return pc, pdb, vips


def server_preempt(api, client, srv, watch, count: int = None,
                   timeout: float = 120.0) -> dict:
    """11b on 11a's running server: the vips through the API, each pinned to
    a node 11a occupied; victims leave through the server's APIEvictor. Gates, invariants of any timing: every
    vip bound, or pending with a nominated node and a FailedScheduling
    Event; every victim the cache dropped gone from the apiserver; no node's
    summed requests above its allocatable, per a LIST."""
    count = SERVER_VIPS if count is None else count
    s = srv.scheduler
    evictor = s.preemptor.evictor
    ev0 = len(evictor.evicted)
    # the first `count` occupied nodes by name, per a LIST
    occupied = sorted({(p.get("spec") or {}).get("nodeName")
                       for p in _api_pods(client)} - {None, ""})
    if len(occupied) < count:
        fail(f"11b: only {len(occupied)} occupied nodes for {count} vips")
    pc, pdb, vips = vip_objects(api, SERVER_PODS, count, occupied[:count])
    client.priorityclasses.create(pc)
    client.poddisruptionbudgets.create(pdb)
    keys = [f"default/{v['metadata']['name']}" for v in vips]
    t0 = time.monotonic()
    for v in vips:
        client.pods.create(v)

    def settled():
        return all(k in watch.bound for k in keys)

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not settled():
        time.sleep(0.1)
    srv.wait_until_idle(10)
    t1 = max([watch.at[k] for k in keys if k in watch.at], default=t0)
    bound = [k for k in keys if k in watch.bound]
    events = client.events.list("default")["items"]
    failed_ev = {e["involvedObject"]["name"] for e in events
                 if e.get("reason") == "FailedScheduling"}
    for k in keys:
        if k in watch.bound:
            continue
        name = k.split("/", 1)[1]
        if not s.queue._nominated.get(k) or name not in failed_ev:
            fail(f"11b: vip {k} neither bound nor nominated with a "
                 f"FailedScheduling event")
    evicted = evictor.evicted[ev0:]
    live = {f"default/{p['metadata']['name']}" for p in _api_pods(client)}
    still = [k for k in evicted if k in live]
    if still:
        fail(f"11b: {len(still)} evicted victims still in the apiserver: "
             f"{still[:3]}")
    nodes = {n.name: n for n in
             (api.node_from_v1(o) for o in client.nodes.list()["items"])}
    used = {}
    for o in _api_pods(client):
        p = api.pod_from_v1(o)
        if p.node_name:
            u = used.setdefault(p.node_name, [0, 0, 0])
            u[0] += p.requests.milli_cpu
            u[1] += p.requests.memory_kib
            u[2] += 1
    over = [n for n, u in used.items()
            if u[0] > nodes[n].allocatable.milli_cpu
            or u[1] > nodes[n].allocatable.memory_kib
            or u[2] > nodes[n].allocatable.pods]
    if over:
        fail(f"11b: {len(over)} nodes over their allocatable: {over[:3]}")
    return dict(vips=count, vips_bound=len(bound),
                nominated_pending=count - len(bound),
                evicted=len(evicted), s=t1 - t0,
                vips_per_s=len(bound) / max(t1 - t0, 1e-9))


def server_takeover(api, n_nodes: int = None, n_pods: int = None) -> dict:
    """11c: two SchedulerServers, each with its own client and ledger, over
    one apiserver holding the 11a backlog. The leader is killed by the
    fault switchboard at post_bind of its second intent-writing wave
    (Bindings committed, intent not retired); the standby must take over,
    reconcile and finish: every pod bound exactly once, no unretired
    intent, and a Binding stamped with the dead leader's token refused by
    the apiserver's fence."""
    n_nodes = SERVER_NODES if n_nodes is None else n_nodes
    n_pods = SERVER_PODS if n_pods is None else n_pods
    T = api.types
    srv_api = api.APIServer()
    a = b = watch = None
    try:
        admin = api.Client.local(srv_api)
        W = api.workloads
        _create(admin, api, W.make_nodes(n_nodes), W.flagship_pods(n_pods))
        watch = BindWatch(admin)
        api.faultline.install(SERVER_CRASH)
        kw = lambda ident: dict(_server_kw(api, srv_api.storage, ident,
                                           n_nodes, n_pods),
                                lease_config=dict(identity=ident,
                                                  **SERVER_LEASE),
                                standby_warm_interval=0.2)
        a = api.server(api.Client.local(srv_api), **kw("a"))
        log_a = WaveLog(a.scheduler)
        a.start()
        if not a.elector.wait_for_leadership(30):
            fail("11c: the leader never acquired its lease")
        b = api.server(api.Client.local(srv_api), **kw("b"))
        log_b = WaveLog(b.scheduler)
        b.start()
        _until(lambda: api.faultline.active().fired("proc.crash") > 0,
               SERVER_TIMEOUT_S, "the leader's crash")
        api.faultline.uninstall()
        t_kill = time.monotonic()
        token_a = a.elector.fencing_token
        # the intents the kill left, counted at the kill: the dead loop can
        # retire nothing and a's elector still holds the lease, so the
        # standby cannot have reconciled them yet. After a.crash() it may
        # have: crash() stops the elector first, then joins a's informer
        # and loop threads (seconds under load), past the 1.5 s lease.
        orphaned = len(a.scheduler.ledger.unretired())
        a.crash()
        if orphaned < 1:
            fail("11c: the kill left no unretired intent to replay")
        bound_at_kill = watch.count()
        if not b.elector.wait_for_leadership(60):
            fail("11c: the standby never took over")
        _until(lambda: b.takeovers > 0, 60, "the standby's recovery")
        recovered_s = time.monotonic() - t_kill
        _quiet(b, watch, SERVER_QUIET_S, SERVER_TIMEOUT_S)
        by_b = [watch.at[k] for w in log_b.waves for k, _ in w["bound"]
                if k in watch.at]
        rep = b.last_recovery
        if rep is None or rep.errors:
            fail(f"11c: recovery failed: {b.last_recovery_error!r} "
                 f"{getattr(rep, 'errors', None)}")
        out = _outcome(admin, watch, log_a.waves + log_b.waves,
                       log_a.errors + log_b.errors, b.scheduler.ledger)
        # the fence: a Binding stamped with the dead leader's token
        probe = pod_obj(api, T.Pod(name="stale-probe"))
        admin.pods.create(probe)
        ann = {T.FENCING_TOKEN_ANNOTATION: str(token_a),
               T.FENCING_LEASE_ANNOTATION: T.DEFAULT_FENCING_LEASE}
        try:
            admin.pods.bind("stale-probe", "node-0", "default",
                            annotations=ann)
            fail("11c: the apiserver accepted a stale-token Binding")
        except Exception as e:  # noqa: BLE001 - the refusal is the result
            if getattr(e, "code", None) != 409 or \
                    T.FENCED_BIND_MARKER not in str(e):
                raise
        out.update(recovered_s=recovered_s,
                   takeover_s=(min(by_b) - t_kill) if by_b else None,
                   bound_at_kill=bound_at_kill,
                   orphaned_intents=orphaned,
                   replayed_intents=rep.replayed_intents,
                   already_bound=rep.already_bound, completed=rep.completed,
                   released=rep.released,
                   stale_rejects=a.scheduler.binder.stale_rejects
                   + b.scheduler.binder.stale_rejects,
                   leader_waves=len(log_a.waves),
                   successor_waves=len(log_b.waves))
        return out
    finally:
        api.faultline.uninstall()
        if a is not None:
            a.crash() if a._crashed else a.stop()
        if b is not None:
            b.stop()
        if watch is not None:
            watch.stop()
        srv_api.close()


def check_server(out, ref, who: str) -> None:
    """11a/11d against the JAX package's run of the same script. Behind the
    wave barrier: the per-wave bound counts and the whole (pod, node) map
    the apiserver holds. Without it (the timed run): the first wave's
    placements, which no confirmation or retry can reach, and the final
    count; whether the rest of the map came out equal is only reported."""
    keys = ("bound", "first_wave_sha256")
    if out["barrier"]:
        keys += ("bound_sha256", "waves")
    got = {k: ([w["scheduled"] for w in out[k]] if k == "waves" else out[k])
           for k in keys}
    want = {k: ref[k] for k in keys}
    if got != want:
        fail(f"{who} differs from the JAX package's: {got} != {want}")
    out["whole_map_equal"] = out["bound_sha256"] == ref["bound_sha256"]


def server_kernel_check(recs, counts, device) -> dict:
    """Each subphase's first K1, K2 and K3 launch (the Recorders' copies of
    the inputs the server's loop gave them) against the plain versions on
    the same tensors on the card, after every launch count was read. A
    kernel launched in a subphase must have been recorded there and agree
    exactly. Returns {subphase: {kernel: max abs error}}."""
    from kubernetes_tpu_torch.ops import kernels as K

    diffs = {"contention_scan": k1_diff, "domain_rank": k2_diff,
             "reprieve_scan": k3_diff}
    errs = {}
    for sub, rs in recs.items():
        errs[sub] = {}
        shapes = []
        for r in rs:
            if r.args is None:
                if device.type == "cuda" and counts[sub].get(r.name, 0):
                    fail(f"{sub}: {r.name} launched but not recorded")
                continue
            plain = getattr(K, r.name + "_plain")
            errs[sub][r.name] = diffs[r.name](getattr(K, r.name)(*r.args),
                                              plain(*r.args))
            shapes.append(f"{r.name} {tuple(r.args[0].shape)}"
                          if r.name != "reprieve_scan" else
                          f"reprieve_scan B={r.args[7].shape[0]} "
                          f"N={r.args[10].shape[0]} E={r.args[7].shape[1]}")
        sync(device)
        print(f"    {sub}: the first launch of each kernel against its plain "
              f"version on the same inputs: {'; '.join(shapes)}; max_abs_err "
              f"{errs[sub]}")
        if any(errs[sub].values()):
            fail(f"{sub}: a kernel disagrees with its plain version on the "
                 f"server's inputs: {errs[sub]}")
    return errs


def server_phase(device, card: str) -> dict:
    """Phase 11 on the card: 11a the control loop over LocalTransport behind
    the wave barrier (the whole map gated), 11a-t the same drain without it
    at the server's own pace (the timings; the first wave and the count
    gated), 11b preemption through the API on 11a-t's running server, 11c
    kill and takeover, 11d the wire (HTTPTransport through an HTTPGateway,
    behind the barrier). Launch counts per subphase: set to 0 just before
    it, read just after. Each subphase records its first K1, K2 and K3
    launch, held against the plain versions once all counts are read."""
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops import preempt as OP
    from kubernetes_tpu_torch.ops import waves as W

    api = port_server_api(device)
    counts, cur, recs = {}, [], {}

    def mark(name):
        if cur:
            counts[cur[-1]] = K.launch_counts()
            for r in recs[cur[-1]]:
                r.restore()
        if name is None:
            return
        cur.append(name)
        recs[name] = [Recorder(W, "contention_scan"),
                      Recorder(W, "domain_rank"),
                      Recorder(OP, "reprieve_scan")]
        K.reset_launch_counts()

    res = {}

    def preempt_11b(srv_api, client, srv, watch, out):
        mark("11b")
        res["11b"] = server_preempt(api, client, srv, watch)

    t0 = time.perf_counter()
    try:
        a = server_drain(api, mark=lambda: mark("11a"))
        check_server(a, JAX_SERVER, "11a")
        at = server_drain(api, barrier=False, mark=lambda: mark("11a-t"),
                          after=preempt_11b)
        mark("11c")
        c = server_takeover(api)
        d = server_drain(api, n_pods=SERVER_HTTP_PODS, transport="http",
                         mark=lambda: mark("11d"))
    finally:
        mark(None)
    check_server(at, JAX_SERVER, "11a-t")
    check_server(d, JAX_SERVER_HTTP, "11d")
    b = res["11b"]
    print(f"  11a: {SERVER_NODES} nodes + {SERVER_PODS} pods created in "
          f"{a['create_s']:.3f} s ({a['creates_per_s']:.1f} creates/s); "
          f"{a['bound']} bound in waves of {[w['scheduled'] for w in a['waves']]}"
          f", each behind the wave barrier, {a['drain_s']:.3f} s from the "
          f"first wave to the last bind; launches {counts['11a']} ({card})")
    print(f"    the whole (pod, node) map and the per-wave counts equal "
          f"JAX_SERVER; exactly once, 0 unretired intents, no wave raised")
    print(f"  11a-t: the same drain at the server's own pace (batch_window "
          f"{SERVER_BATCH_WINDOW} s, no barrier): created in "
          f"{at['create_s']:.3f} s ({at['creates_per_s']:.1f} creates/s); "
          f"{at['bound']} bound in waves of "
          f"{[w['scheduled'] for w in at['waves']]}, {at['drain_s']:.3f} s "
          f"from the first wave to the last bind ({at['pods_per_s']:.1f} "
          f"pods/s); start to first wave {at['start_to_first_wave_s']:.3f} "
          f"s; watch→bind p50 {at['watch_bind_p50_s']:.4f} s, p99 "
          f"{at['watch_bind_p99_s']:.4f} s; launches {counts['11a-t']}")
    print(f"    the first wave and the count equal JAX_SERVER (the whole map "
          f"{'equal too' if at['whole_map_equal'] else 'differs'}: without "
          f"the barrier it depends on when the confirmations land); exactly "
          f"once, 0 unretired intents, no wave raised")
    print(f"  11b: {b['vips']} vips (priorityClassName vip): "
          f"{b['vips_bound']} bound, {b['nominated_pending']} nominated and "
          f"pending; {b['evicted']} victims deleted through the API; "
          f"{b['s']:.3f} s ({b['vips_per_s']:.2f} vips/s); launches "
          f"{counts['11b']}")
    if c["bound"] != a["bound"]:
        fail(f"11c: {c['bound']} bound across the takeover, 11a bound "
             f"{a['bound']}")
    first = ("none left to bind" if c["takeover_s"] is None
             else f"{c['takeover_s']:.3f} s")
    print(f"  11c: leader killed at post_bind of its 2nd intent wave "
          f"({c['bound_at_kill']} bound, {c['orphaned_intents']} intent "
          f"left; its loop's InjectedCrash traceback on stderr is the "
          f"kill); standby recovered {c['recovered_s']:.3f} s after the "
          f"kill, first successor bind {first}; replayed "
          f"{c['replayed_intents']} intents (already bound "
          f"{c['already_bound']}, completed {c['completed']}, released "
          f"{c['released']}); {c['bound']} bound exactly once; a stale-"
          f"token Binding refused by the fence; launches {counts['11c']}")
    print(f"  11d: HTTPTransport through an HTTPGateway: {SERVER_NODES} "
          f"nodes + {SERVER_HTTP_PODS} pods created in {d['create_s']:.3f} s "
          f"({d['creates_per_s']:.1f}/s); {d['bound']} bound in waves of "
          f"{[w['scheduled'] for w in d['waves']]} behind the barrier, "
          f"{d['drain_s']:.3f} s; the whole map and the per-wave counts "
          f"equal JAX_SERVER_HTTP; launches {counts['11d']}")
    if device.type == "cuda":
        for sub in ("11a", "11a-t", "11c", "11d"):
            if not all(counts[sub].get(n, 0) for n in WAVE_KERNELS):
                fail(f"{sub}: K1/K2 not launched: {counts[sub]}")
        if not counts["11b"].get("reprieve_scan", 0):
            fail(f"11b: K3 not launched: {counts['11b']}")
    errs = server_kernel_check(recs, counts, device)
    settle(api, "11")
    wall = time.perf_counter() - t0
    return dict(a=a, at=at, b=b, c=c, d=d, launches=counts, errs=errs,
                wall_s=wall)


def check_drain(drain, who: str, ref: dict) -> None:
    waves = [(w["attempted"], w["scheduled"], w["unschedulable"], w["micro"],
              w["mode"], w["patch_rows"]) for w in drain["waves"]]
    if waves != [tuple(w) for w in ref["waves"]]:
        fail(f"per-wave counts or snapshot modes differ from {who}: {waves}")
    if (drain["bound"], drain["bound_sha256"]) != (ref["bound"],
                                                   ref["bound_sha256"]):
        fail(f"the binder's (pod, node) order differs from {who}")


# --------------------------------------------------------------------------- #
# phase 12: the fleet (shared with scripts/flagship_reference.py --path fleet)
# --------------------------------------------------------------------------- #

# 12a: bench.py's fleet stages on one device — FLEET_TENANTS tenants, each
# make_nodes(FLEET_NODES) and FLEET_PODS pods of 20m/16Mi, engines by tenant
# in this rotation, t00 under the tight quota (half its backlog). Every
# FLEET_SPREAD_EVERY-th pod belongs to the tenant's deployment spread evenly
# over zones (maxSkew 1, hard): bench.py's plain pods alone never reach the
# wave engine's domain-quota pass (K2). A spread pod is a self-interacting
# class, which the runs engine takes one pod at a time (711 torch ops a
# step, as the scan): a tenth keeps the runs tenants' cost near the plain
# backlog's
FLEET_TENANTS, FLEET_NODES, FLEET_PODS = 24, 2000, 2000
FLEET_SPREAD_EVERY = 10
FLEET_BATCH = 1000
FLEET_ENGINES = ("waves", "runs", "scan")
FLEET_MAX_TICKS = 24
# 12c: the watch plane through the port's apiserver; the mux.die@stream
# seam fires on the WATCH_DIE_AT-th event fanned after it is installed,
# while WATCH_LATE late pods per tenant are being created
WATCH_TENANTS, WATCH_NODES, WATCH_PODS = 8, 1000, 1000
WATCH_LATE, WATCH_DIE_AT = 16, 40

# The JAX package's run of 12a (JAX 0.9.0 on the CPU): per tenant the bound
# count and the sha256 over its sorted (pod, node) pairs, the per-tick
# scheduled counts, t00's clamped pods over the run, and tick 1's DRF rows
# per engine group (sha256 of admitted, share and dom). Reproduce with
# `JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax
# --path fleet`.
JAX_FLEET = {
    "tenants": {
        "t00": {"bound": 1000, "sha256":
                "07961a3a7c9417d2367d5e9f62a783cf16c9819cb1edba29100ce3c167d89746"},
        "t01": {"bound": 2000, "sha256":
                "f974a70c7d27f8b97f44965692e8a0117f59ee78fe46cfeac363d440990d05f5"},
        "t02": {"bound": 2000, "sha256":
                "ad330356e556346a83f79313ee71de66166c047d847e81368c795605e566a502"},
        "t03": {"bound": 2000, "sha256":
                "ea6ddcd1e1a9d070de9934a75ccac2c85a251daa0af0161b698557aac011bc36"},
        "t04": {"bound": 2000, "sha256":
                "1f4c16c9219d30dd90a5d786fe2436ee608cea9d0b496da119991003f31ff1d9"},
        "t05": {"bound": 2000, "sha256":
                "99f939abd22c95a457692f8b67bc324c58db6c6deb166c9db66e77a8840b158c"},
        "t06": {"bound": 2000, "sha256":
                "aa575829d1c9edda94be566540909e7893db1e9b32534583d0bf45006142577b"},
        "t07": {"bound": 2000, "sha256":
                "7015cbb42927a8690ecc035553896e7c3c4b46f6e032e52d277186913604b31d"},
        "t08": {"bound": 2000, "sha256":
                "cda2fa65e6cd487eaea70a2023462045de20ceedc907c978e3d972ec51568b6e"},
        "t09": {"bound": 2000, "sha256":
                "612853aefbdb243a687b990fe5fc4a89e9f8394ff856dd05b2059ef8d6e4a60d"},
        "t10": {"bound": 2000, "sha256":
                "f9ab03be71d9c3e72c4e3553f0fa79a8e63a9d7d37120ecb940d47ab3ab25295"},
        "t11": {"bound": 2000, "sha256":
                "8a1fa8652421368e63f8e85788a16e5bb6330958d12e8037c8e9e5078946012e"},
        "t12": {"bound": 2000, "sha256":
                "d34c8a23eb1304ca4552d109febbf334dee370bc4fd130a4316f05798da29eb0"},
        "t13": {"bound": 2000, "sha256":
                "130e951ff10f2efa40a8bf5d685b8f2d7824e0e5ec4a0e029da5ac0fadd43a43"},
        "t14": {"bound": 2000, "sha256":
                "ac49fdb2fa9ad33f6c83eb441287d64bbb0c92798b81aa061858957c6649975e"},
        "t15": {"bound": 2000, "sha256":
                "d2ad4b70f73e983c5c2c49e6a778174dfa464ffd5c59ba8995a71a14feea9bb3"},
        "t16": {"bound": 2000, "sha256":
                "08297050c759eeca04b5c5f25f628761287737ba49518b2a3f6dc3b98a650092"},
        "t17": {"bound": 2000, "sha256":
                "699ff7bacfe712a299779c297ce6ba29ebb9450e9b9175b259fb574e8d0ddcf1"},
        "t18": {"bound": 2000, "sha256":
                "4ff130451ce81e561f90cae31623ed01fd9940f3293027a714acc17d69d3e96c"},
        "t19": {"bound": 2000, "sha256":
                "6116e8b068aea780bab10d270e1d1b3dbdd3cc85cc8804216a61b6300a70eb70"},
        "t20": {"bound": 2000, "sha256":
                "64da6bd8b6b41fecdf5749ecd8d4d8655a7d35c0b1112a263478912c061f0143"},
        "t21": {"bound": 2000, "sha256":
                "ea973c97aee4b7ae617a5acd51cba53803121872b8fff6291fa2bccf4f198278"},
        "t22": {"bound": 2000, "sha256":
                "93767f809cd7ad1c2c911f57c31fd5a552fede14d5cd550d6cea1c74dee2c169"},
        "t23": {"bound": 2000, "sha256":
                "e0fea8e0aa6285ee15fe817af793b7a52557006263883077675e6c08a7964d43"},
    },
    "scheduled": [24000, 23000, 0],
    "t00_drf_clamped": 2000,
    "tick1_drf": {
        "runs": {
            "admitted": "14b0a55a36483fe3f743a3584f0a0c753da351c08322dcc8b200ecc562355d8f",
            "share": "66687aadf862bd776c8fc18b8e9f8e20089714856ee233b3902a591d0d5f2925",
            "dom": "ec0b9c11bfb4fc3674a0edad8e4867720db85c9c3052e479ddd80f4b7b1bbe3f",
        },
        "scan": {
            "admitted": "14b0a55a36483fe3f743a3584f0a0c753da351c08322dcc8b200ecc562355d8f",
            "share": "66687aadf862bd776c8fc18b8e9f8e20089714856ee233b3902a591d0d5f2925",
            "dom": "ec0b9c11bfb4fc3674a0edad8e4867720db85c9c3052e479ddd80f4b7b1bbe3f",
        },
        "waves": {
            "admitted": "14b0a55a36483fe3f743a3584f0a0c753da351c08322dcc8b200ecc562355d8f",
            "share": "66687aadf862bd776c8fc18b8e9f8e20089714856ee233b3902a591d0d5f2925",
            "dom": "ec0b9c11bfb4fc3674a0edad8e4867720db85c9c3052e479ddd80f4b7b1bbe3f",
        },
    },
}


def port_fleet_api(device):
    """What phase 12 drives, from the port, on `device`.
    scripts/flagship_reference.py builds the same namespace from the JAX
    package."""
    import types as pytypes

    from kubernetes_tpu_torch.api import types, v1
    from kubernetes_tpu_torch.apiserver import APIServer
    from kubernetes_tpu_torch.client import Client
    from kubernetes_tpu_torch.component.metrics import DEFAULT_REGISTRY
    from kubernetes_tpu_torch.fleet import FleetServer
    from kubernetes_tpu_torch.fleet import server as fleet_server
    from kubernetes_tpu_torch.models import workloads
    from kubernetes_tpu_torch.sched.scheduler import RecordingBinder
    from kubernetes_tpu_torch.state.dims import Dims, bucket
    from kubernetes_tpu_torch.utils import faultline

    made = []

    def fleet(**kw):
        srv = FleetServer(device=device, **kw)
        made.append(srv)
        return srv

    return pytypes.SimpleNamespace(
        types=types, workloads=workloads, Dims=Dims, bucket=bucket,
        node_to_v1=v1.node_to_v1, pod_to_v1=v1.pod_to_v1,
        APIServer=APIServer, Client=Client, registry=DEFAULT_REGISTRY,
        fleet=fleet, fleet_module=fleet_server, made=made,
        RecordingBinder=RecordingBinder, faultline=faultline,
        to_np=lambda a: a.cpu().numpy())


def fleet_tight_quota(n_nodes: int, n_pods: int) -> float:
    """bench.py _fleet_stage's quota for tenant 0: half its backlog's
    dominant demand (the pod slot dominates 20m/16Mi on make_nodes)."""
    per_pod_dom = max(20.0 / (n_nodes * 32000.0),
                      16.0 / (n_nodes * 128.0 * 1024.0),
                      1.0 / (n_nodes * 110.0))
    return max(n_pods * per_pod_dom / 2, 1e-5)


def fleet_engine(name: str) -> str:
    return FLEET_ENGINES[int(name[1:]) % len(FLEET_ENGINES)]


def fleet_pods(api, name: str, n_pods: int) -> list:
    """One tenant's backlog: n_pods pods of 20m/16Mi, every
    FLEET_SPREAD_EVERY-th of them in the tenant's deployment spread over
    zones with maxSkew 1, DoNotSchedule."""
    T = api.types
    app = {"app": f"{name}-spread"}
    spread = (T.TopologySpreadConstraint(
        max_skew=1, topology_key=api.workloads.ZONE,
        when_unsatisfiable=T.UnsatisfiableAction.DO_NOT_SCHEDULE,
        selector=T.LabelSelector.of(match_labels=app)),)
    req = T.Resources.make(cpu="20m", memory="16Mi")
    return [T.Pod(name=f"{name}-p{i}", requests=req, creation_index=i,
                  **(dict(labels=app, topology_spread=spread)
                     if i % FLEET_SPREAD_EVERY == 0 else {}))
            for i in range(n_pods)]


def rows_sha256(api, res) -> dict:
    """sha256 of one dispatch's DRF rows (admitted, share, dom)."""
    return {f: hashlib.sha256(api.to_np(getattr(res, f)).tobytes())
            .hexdigest() for f in ("admitted", "share", "dom")}


def fleet_run(api, names=None, n_nodes: int = None, n_pods: int = None,
              after_tick=None, fleet_kw=None) -> dict:
    """Phase 12a on one package: the tenants `names` (default all
    FLEET_TENANTS), each make_nodes(n_nodes) and fleet_pods(n_pods), through
    one FleetServer (with `fleet_kw` added to its arguments: a fleet mesh)
    ticked until every queue is empty or a tick schedules nothing after the
    second. Tick 1's dispatch of each engine group is captured (its inputs
    and DRF rows). `after_tick(i, tk)` runs after each tick. Returns the
    outcome and its invariants."""
    n_nodes = n_nodes or FLEET_NODES
    n_pods = n_pods or FLEET_PODS
    names = names or [f"t{k:02d}" for k in range(FLEET_TENANTS)]
    base = api.Dims(N=api.bucket(n_nodes), P=api.bucket(FLEET_BATCH),
                    E=api.bucket(n_pods + 256))
    clk = {"t": 0.0}
    srv = api.fleet(batch_size=FLEET_BATCH, base_dims=base,
                    clock=lambda: clk["t"],
                    engines={n: fleet_engine(n) for n in names},
                    **(fleet_kw or {}))
    srv.prewarmer.enabled = False
    nodes = api.workloads.make_nodes(n_nodes)
    binders = {}
    t0 = time.perf_counter()
    for name in names:
        binders[name] = api.RecordingBinder()
        t = srv.add_tenant(name, binder=binders[name],
                           quota=(fleet_tight_quota(n_nodes, n_pods)
                                  if name == "t00" else 1.0))
        for n in nodes:
            t.on_node_add(n)
        for p in fleet_pods(api, name, n_pods):
            t.on_pod_add(p)
    ingest_s = time.perf_counter() - t0

    mod = api.fleet_module
    orig = mod.dispatch_fleet
    captured = {}

    def capture(*a, **kw):
        out = orig(*a, **kw)
        if a[5] not in captured:
            # a copy: the resident stack is patched in place next tick
            captured[a[5]] = (own(a), out)
        return out

    ticks = []
    for i in range(FLEET_MAX_TICKS):
        if i == 0:
            mod.dispatch_fleet = capture
        try:
            tk = srv.tick()
        finally:
            mod.dispatch_fleet = orig
        clk["t"] += 1.0
        ticks.append(tk)
        if after_tick is not None:
            after_tick(i, tk)
        done = all(t.sched.queue.lengths()[0] == 0
                   for t in srv.tenants.values())
        if done or (tk.scheduled == 0 and len(ticks) > 2):
            break

    lost = double = 0
    for name, b in binders.items():
        keys = [k for k, _ in b.bound]
        double += len(keys) - len(set(keys))
        lost += n_pods - len(set(keys)) - sum(
            srv.tenant(name).sched.queue.lengths())
    return dict(
        srv=srv, binders=binders, ticks=ticks, ingest_s=ingest_s,
        captured=captured,
        tenants={n: {"bound": len(b.bound),
                     "sha256": placement_sha256(b.bound)}
                 for n, b in binders.items()},
        scheduled=[tk.scheduled for tk in ticks],
        t00_drf_clamped=sum(tk.per_tenant["t00"].drf_clamped
                            for tk in ticks if "t00" in tk.per_tenant),
        tick1_drf={e: rows_sha256(api, out)
                   for e, (_, out) in sorted(captured.items())},
        drf_violations=srv.total_drf_violations,
        cross_tenant_placements=srv.total_cross_tenant,
        drf_clamped=srv.total_drf_clamped,
        lost_pods=lost, double_bound=double,
        dispatches_per_group=sorted({(tk.dispatches, tk.engine_groups)
                                     for tk in ticks}))


def fleet_reference(out) -> dict:
    """The part of a fleet_run outcome JAX_FLEET holds."""
    return {k: out[k] for k in ("tenants", "scheduled", "t00_drf_clamped",
                                "tick1_drf")}


def watch_plane_run(api, n_tenants: int = None, n_nodes: int = None,
                    n_pods: int = None) -> dict:
    """Phase 12c: n_tenants tenants of n_nodes nodes and n_pods pods, every
    object created through the client into the apiserver with its tenant
    label, served by a FleetServer through ONE watch plane (two upstream
    streams). Once every pod reached its tenant's queue and one tick ran,
    the mux.die@stream seam kills a stream while late pods are created; the
    next tick serves from cache, exports the staleness and revives the
    stream as a resume. Ticks until every pod is bound."""
    n_tenants = n_tenants or WATCH_TENANTS
    n_nodes = n_nodes or WATCH_NODES
    n_pods = n_pods or WATCH_PODS
    T = api.types
    label = "ktpu.io/tenant"
    a = api.APIServer()
    client = api.Client.local(a)
    clk = {"t": 0.0}
    srv = api.fleet(batch_size=FLEET_BATCH,
                    base_dims=api.Dims(N=api.bucket(n_nodes),
                                       P=api.bucket(FLEET_BATCH),
                                       E=api.bucket(n_pods + 256)),
                    clock=lambda: clk["t"])
    names = [f"w{k:02d}" for k in range(n_tenants)]
    binders = {}
    for name in names:
        binders[name] = api.RecordingBinder()
        srv.add_tenant(name, binder=binders[name])
    plane = srv.attach_watch_plane(client)
    t0 = time.perf_counter()

    def pods(name, lo, hi):
        for i in range(lo, hi):
            client.pods.create(pod_obj(api, T.Pod(
                name=f"{name}-p{i}", labels={label: name},
                requests=T.Resources.make(cpu="20m", memory="16Mi"),
                creation_index=i)))

    try:
        for name in names:
            for n in api.workloads.make_nodes(n_nodes):
                obj = api.node_to_v1(n)
                obj["metadata"]["name"] = f"{name}-{n.name}"
                obj["metadata"]["labels"][label] = name
                obj["metadata"]["labels"]["kubernetes.io/hostname"] = \
                    f"{name}-{n.name}"
                client.nodes.create(obj)
            pods(name, 0, n_pods)
        create_s = time.perf_counter() - t0
        _until(lambda: all(
            t.sched.queue.lengths()[0] == n_pods
            and t.sched.cache.node_count == n_nodes
            for t in srv.tenants.values()), 120.0,
            "every tenant's nodes and pods in its cache and queue")
        sync_s = time.perf_counter() - t0
        streams = (a.storage.live_watchers("/registry/core/pods/"),
                   a.storage.live_watchers("/registry/core/nodes/"))
        first = srv.tick()
        clk["t"] += 1.0
        relists = plane.pod_mux.informer.relists
        api.faultline.install(f"mux.die@stream:{WATCH_DIE_AT}")
        try:
            for name in names:
                pods(name, n_pods, n_pods + WATCH_LATE)
            _until(lambda: not plane.pod_mux.alive, 30.0,
                   "the mux.die@stream seam to kill the pod stream")
        finally:
            api.faultline.uninstall()
        time.sleep(1.0)
        dead = srv.tick()          # serves cached state, revives
        clk["t"] += 1.0
        total = n_pods + WATCH_LATE
        _until(lambda: all(
            t.sched.queue.lengths()[0] + len(binders[t.name].bound) >= total
            for t in srv.tenants.values()), 60.0,
            "the late pods after the revive")
        ticks = [first, dead]
        while not all(len(b.bound) >= total for b in binders.values()) \
                and len(ticks) < FLEET_MAX_TICKS:
            ticks.append(srv.tick())
            clk["t"] += 1.0
        text = api.registry.expose_text()
        staleness_exported = all(
            f'tenant_staleness_seconds{{tenant="{n}"}}' in text
            for n in names)
        mux = plane.pod_mux
        out = dict(
            tenants=n_tenants, nodes=n_nodes, pods=n_pods, late=WATCH_LATE,
            create_s=create_s, sync_s=sync_s, streams=streams,
            bound={n: len(b.bound) for n, b in binders.items()},
            double_bound=sum(len(b.bound) - len({k for k, _ in b.bound})
                             for b in binders.values()),
            foreign=sum(1 for n, b in binders.items()
                        for _, node in b.bound
                        if not node.startswith(f"{n}-")),
            cross_tenant_placements=srv.total_cross_tenant,
            dead_tick_staleness_s=dead.staleness_seconds,
            dead_tick_scheduled=dead.scheduled,
            mux_failovers=plane.mux_failovers, deaths=mux.deaths,
            relists_before=relists, relists_after=mux.informer.relists,
            resumes=mux.informer.resumes,
            staleness_exported=staleness_exported,
            ticks=[tk.scheduled for tk in ticks],
            tick_s=[tk.tick_seconds for tk in ticks])
    finally:
        plane.stop()
        a.close()
    return out


def check_watch_plane(w, who: str) -> None:
    total = w["pods"] + w["late"]
    bad = []
    if w["streams"] != (1, 1):
        bad.append(f"upstream streams {w['streams']} (want one each)")
    if any(n != total for n in w["bound"].values()):
        bad.append(f"bound {w['bound']} (want {total} each)")
    if w["double_bound"] or w["foreign"] or w["cross_tenant_placements"]:
        bad.append("a double bind or a cross-tenant placement")
    if not w["staleness_exported"]:
        bad.append("per-tenant staleness not exported")
    if w["deaths"] < 1 or w["mux_failovers"] < 1:
        bad.append("the stream never died or was never revived")
    if w["relists_after"] != w["relists_before"] or w["resumes"] < 1:
        bad.append(f"the revive relisted ({w['relists_before']} → "
                   f"{w['relists_after']}) or never resumed")
    if w["dead_tick_staleness_s"] <= 0.0:
        bad.append("the tick after the death exported no staleness")
    if bad:
        fail(f"{who}: " + "; ".join(bad))


def check_fleet(out, who: str) -> None:
    """12a's invariants on one run."""
    bad = []
    for k in ("drf_violations", "cross_tenant_placements", "lost_pods",
              "double_bound"):
        if out[k]:
            bad.append(f"{k} {out[k]}")
    if out["t00_drf_clamped"] < 1:
        bad.append("the DRF clamp never fired on t00")
    if any(d != g for d, g in out["dispatches_per_group"]):
        bad.append(f"(dispatches, engine groups) per tick "
                   f"{out['dispatches_per_group']}")
    if bad:
        fail(f"{who}: " + "; ".join(bad))


def fleet_phase(device, card: str) -> dict:
    """Phase 12 on the card: 12a the fleet tick at real width against
    JAX_FLEET and each engine's solo run, with the K1/K2/K3 launches per
    tick and the first launch of each kernel against its plain version;
    12b tick 1's DRF rows on the card against the CPU and JAX_FLEET; 12c the
    watch plane."""
    import torch

    from kubernetes_tpu_torch.fleet.quota import drf_admission_rows
    from kubernetes_tpu_torch.ops import assign as A
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops import preempt as OP
    from kubernetes_tpu_torch.ops import runs as RN
    from kubernetes_tpu_torch.ops import waves as W
    from kubernetes_tpu_torch.state.arrays import to_device

    if JAX_FLEET is None:
        fail("phase 12: JAX_FLEET is not recorded")
    api = port_fleet_api(device)
    t0 = time.perf_counter()
    recs = [Recorder(W, "contention_scan"), Recorder(W, "domain_rank"),
            Recorder(OP, "reprieve_scan")]
    # K4's calls from the scan tenants (the longest: a whole batch) and
    # from the runs tenants' fallback
    k4_rec = Recorder(A, "assign_scan", key=lambda a: a[3].shape[0])
    k4_runs = Recorder(RN, "assign_scan")
    per_tick = []

    def after_tick(i, tk):
        c = K.launch_counts()
        per_tick.append(c)

    K.reset_launch_counts()
    A.assign_scan_plain.calls = 0
    RN.reset_run_stats()
    try:
        a = fleet_run(api, after_tick=after_tick)
    finally:
        counts = K.launch_counts()
        plain_calls = A.assign_scan_plain.calls
        fallback_runs = RN.assign_runs.stats["fallback"]
        for r in recs + [k4_rec, k4_runs]:
            r.restore()
    launches = [{k: c.get(k, 0) - (per_tick[i - 1].get(k, 0) if i else 0)
                 for k in ("contention_scan", "domain_rank",
                           "reprieve_scan", "assign_scan")}
                for i, c in enumerate(per_tick)]
    check_fleet(a, "12a")
    stacks = a["srv"].stacks.values()
    donated = sum(st.donated_patches for st in stacks)
    donation_failures = sum(st.donation_failures for st in stacks)
    if donated < 1 or donation_failures:
        fail(f"12a: donated_patches {donated}, donation_failures "
             f"{donation_failures} (want > 0 and 0)")
    ref = JAX_FLEET
    for k in ("tenants", "scheduled", "t00_drf_clamped", "tick1_drf"):
        if a[k] != ref[k]:
            fail(f"12a: {k} differs from JAX_FLEET: {a[k]} != {ref[k]}")
    ticks = a["ticks"]
    steady = ticks[1]
    idle = 1.0 - steady.execute_seconds / steady.tick_seconds
    print(f"  12a: {FLEET_TENANTS} tenants x {FLEET_NODES} nodes x "
          f"{FLEET_PODS} pods ({FLEET_TENANTS * FLEET_NODES} nodes, "
          f"{FLEET_TENANTS * FLEET_PODS} pods) ingested in "
          f"{a['ingest_s']:.3f} s; ticks scheduled {a['scheduled']} in "
          f"{[round(tk.tick_seconds, 3) for tk in ticks]} s; t00 clamped "
          f"{a['t00_drf_clamped']}; 0 violations, 0 cross-tenant, 0 lost, "
          f"0 double; (dispatches, groups) per tick "
          f"{a['dispatches_per_group']} ({card})")
    print(f"    steady tick (tick 2): {steady.tick_seconds:.3f} s, "
          f"{steady.scheduled / steady.tick_seconds:.1f} pods/s; the group "
          f"dispatches' CUDA-event windows {steady.execute_seconds:.3f} s, "
          f"so the device idles at least {idle:.3f} of the tick; launches "
          f"per tick {launches}")
    print("    steady tick's split (the fleet-tick spans, s): "
          + ", ".join(f"{p} {dt:.3f}" for p, dt in tick_split(a["srv"], 1)))
    print("    every tenant's placements (sha256), the per-tick counts, "
          "t00's clamp and tick 1's DRF rows equal JAX_FLEET")
    solo = {}
    for name in [f"t{k:02d}" for k in range(len(FLEET_ENGINES))]:
        s = fleet_run(api, names=[name])
        if sorted(s["binders"][name].bound) != \
                sorted(a["binders"][name].bound):
            fail(f"12a: {name} ({fleet_engine(name)}) differs from its "
                 f"solo run")
        solo[name] = s["tenants"][name]["bound"]
    print(f"    each engine's first tenant equals its solo run: {solo}")
    if device.type == "cuda" and not all(counts.get(n, 0)
                                         for n in WAVE_KERNELS
                                         + ("assign_scan",)):
        fail(f"12a: K1/K2/K4 not launched: {counts}")
    if device.type == "cuda" and plain_calls:
        fail(f"12a: the plain scan was called {plain_calls} times")
    errs = server_kernel_check({"12a": recs}, {"12a": counts}, device)
    # K4's longest launch (a scan tenant's batch) and the runs fallback's
    # first against the plain version, over their first 256 rows
    k4_err = max(check_k4_steps(device, r.args, SCAN_CHECK_STEPS, "12a")[0]
                 for r in (k4_rec, k4_runs) if r.args is not None)
    errs["12a"]["assign_scan"] = k4_err
    k4_first = dict(rows=int(k4_rec.args[3].shape[0]),
                    steps=int(k4_rec.args[2].valid[
                        k4_rec.args[3].long()].sum()),
                    nodes=int(k4_rec.args[0].nodes.valid.shape[0]),
                    cluster=k4_cluster(k4_rec.args),
                    ms=device_ms(k4_device_fn(k4_rec.args), device, reps=3))
    k4_first["step_us"] = k4_first["ms"] / max(k4_first["steps"], 1) * 1e3
    k4_first["sweep_ms"] = k4_sweep(device, k4_rec.args)
    # one short fallback run (a run's rows): the launch's fixed cost
    short = k4_runs.args
    k4_short = dict(rows=int(short[3].shape[0]), cluster=k4_cluster(short),
                    ms=device_ms(k4_device_fn(short), device),
                    call_ms=time_ms(lambda: K.assign_scan(*short), device))
    print(f"    K4 {counts.get('assign_scan', 0)} launches ({fallback_runs} "
          f"of them the runs tenants' fallback runs), plain scan "
          f"{plain_calls} calls; its longest launch ({k4_first['rows']} rows "
          f"at N={k4_first['nodes']}, cluster {k4_first['cluster']}) "
          f"{k4_first['ms']:.3f} ms on the device "
          f"({k4_first['step_us']:.2f} us a step) and equal to the plain "
          f"version over {SCAN_CHECK_STEPS} rows; cluster-size sweep, ms: "
          + ", ".join(f"{c}: {t:.3f}"
                      for c, t in k4_first["sweep_ms"].items())
          + f"; a fallback run of {k4_short['rows']} rows (cluster "
          f"{k4_short['cluster']}): {k4_short['ms']:.4f} ms on the device, "
          f"{k4_short['call_ms']:.4f} ms a call; stack patches in place "
          f"{donated}, donation failures {donation_failures}")
    print(f"    K4 longest launch: {k4_shape(k4_rec.args)}")

    # 12b: tick 1's DRF rows on the card, the CPU and in JAX_FLEET
    b = {}
    for engine, (args, out) in sorted(a["captured"].items()):
        tables, pending, quota = args[0], args[1], args[6]
        card_rows = drf_admission_rows(tables, pending, quota)
        cpu = torch.device("cpu")
        cpu_rows = drf_admission_rows(to_device(tables, cpu),
                                      to_device(pending, cpu),
                                      quota.to(cpu))
        for f, x, y, z in zip(("admitted", "share", "dom"), card_rows,
                              cpu_rows, out[2:]):
            if not (torch.equal(x.cpu(), y) and torch.equal(x, z)):
                fail(f"12b: {engine} {f} on {device} differs from the CPU "
                     f"or from the dispatch")
        b[engine] = dict(K=int(quota.shape[0]),
                         admitted=int(card_rows[0].sum()),
                         clamped=int((pending.valid
                                      & ~card_rows[0]).sum()))
    print(f"  12b: tick 1's DRF rows on {device} bit-equal to the CPU's and "
          f"to JAX_FLEET's hashes: {b}")

    # 12c: the watch plane
    w = watch_plane_run(api)
    check_watch_plane(w, "12c")
    print(f"  12c: {WATCH_TENANTS} tenants x {WATCH_NODES} nodes x "
          f"{WATCH_PODS} pods through the apiserver on {w['streams']} "
          f"upstream streams (pods, nodes); created in {w['create_s']:.3f} "
          f"s, in every tenant's queue at {w['sync_s']:.3f} s; the pod "
          f"stream killed by mux.die@stream mid-create, the next tick "
          f"served cached state ({w['dead_tick_scheduled']} bound, "
          f"staleness {w['dead_tick_staleness_s']:.3f} s) and revived it as "
          f"a resume (relists {w['relists_before']} → {w['relists_after']},"
          f" resumes {w['resumes']}); {sum(w['bound'].values())} bound "
          f"exactly once in ticks {w['ticks']}, none across tenants; "
          f"per-tenant staleness exported")
    settle_fleet(api, "12")
    wall = time.perf_counter() - t0
    return dict(a={k: a[k] for k in ("scheduled", "t00_drf_clamped",
                                     "dispatches_per_group", "ingest_s")},
                tenants=a["tenants"],
                tick_s=[tk.tick_seconds for tk in ticks],
                execute_s=[tk.execute_seconds for tk in ticks],
                steady_pods_per_s=steady.scheduled / steady.tick_seconds,
                steady_idle_share_min=idle, launches_per_tick=launches,
                launches=counts, errs=errs["12a"], drf=b,
                donated_patches=donated, donation_failures=donation_failures,
                k4_first=k4_first, k4_short=k4_short,
                k4_fallback_runs=fallback_runs,
                steady_split=tick_split(a["srv"], 1),
                watch={k: v for k, v in w.items() if k != "bound"},
                solo=solo, wall_s=wall)


def tick_split(srv, i: int) -> list:
    """Tick i's phases as [name, seconds] pairs, from the fleet's flight
    recorder (its `fleet-tick` spans: snapshots, then per engine group the
    stack refresh, prewarm check, dispatch and readback, then the
    commit)."""
    recs = srv.telemetry.recorder.records()
    return [[p, dt] for p, dt in recs[i]["phases"]] if len(recs) > i else []


def settle_fleet(api, phase: str) -> None:
    """No fleet of the phase may have fallen back or warmed a signature:
    the launch counts read are the fleet path's own."""
    for srv in api.made:
        srv.prewarmer.wait(300)
        if srv.prewarmer.warm_log:
            fail(f"phase {phase}: the fleet prewarmer warmed "
                 f"{len(srv.prewarmer.warm_log)} signatures")
        scheds = [srv.supervisor] + [t.sched.supervisor
                                     for t in srv.tenants.values()]
        if any(s.stats.fallback_dispatches or s.stats.degraded_cycles
               for s in scheds):
            fail(f"phase {phase}: a fleet dispatch fell back")


# --------------------------------------------------------------------------- #
# phase 14: the durable control plane (shared with
# scripts/flagship_reference.py, which runs it on the JAX package)
# --------------------------------------------------------------------------- #

DURABLE_NODES, DURABLE_PODS = 5000, SERVER_BATCH
# the kill: the second WAL append after arming, during the first wave that
# binds — the wave's intent is durable and its first Binding committed,
# and the apiserver dies before answering it
DURABLE_CRASH = "proc.crash@wal:post_append:2"
DURABLE_MAX_WAVES = 24

# 14a's reference: the same drill on the JAX package (durability batch, its
# native store; JAX 0.9.0 on the CPU, KTPU_OVERLOAD=0, its prewarmer off):
# the bound count, the per-wave scheduled counts of the killed scheduler
# and of its successor, the successor's RecoveryReport, and the sha256 of
# the whole (pod, node) map the rebooted apiserver holds. Reproduce with
# `JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax
# --path durable` (28 s on the CPU; `--package port` on the CPU gives the
# same).
JAX_DURABLE = {
    "bound": 4096,
    "bound_sha256":
        "05e8929a0bbd62713ada752ce5b03b69b13f939ecec398144e11764afa2f76f7",
    "waves": [], "crashed_wave": 1, "successor_waves": [1311],
    "report": {"replayed_intents": 1, "already_bound": 1, "completed": 2784,
               "released": 0, "dropped": 0, "stale_skipped": 0},
    "bound_at_death": 1}
# 14b's reference: server_drain over HTTPTransport(binary=True) against a
# durable APIServer (batch), 5,000 nodes x 2,000 pods behind the barrier:
# `JAX_PLATFORMS=cpu python3 scripts/flagship_reference.py --package jax
# --path server --transport http --pods 2000 --binary --durable` (54 s on
# the CPU). Its count, per-wave counts, first wave and whole map equal
# JAX_SERVER_HTTP's (the JSON, in-memory run), so those are reused; the
# per-wave binder order (waves_sha256) is this run's.
JAX_SERVER_BINARY = dict(
    JAX_SERVER_HTTP, waves_sha256=(
        "8ac7f43daca038be187899b3cb06684bd9e0eeef9af44ac320b853e726a93610"))


class LoggedBinder:
    """Wraps a binder (in this script only): every accepted Binding in
    order, with the time it returned."""

    def __init__(self, inner, log):
        self.inner, self.log = inner, log

    def bind(self, pod, node_name):
        ok = self.inner.bind(pod, node_name)
        if ok:
            self.log.append((pod.key, node_name, time.monotonic()))
        return ok


def wal_counters(api) -> dict:
    """The WAL's process-wide counters: records appended, fsyncs, and (the
    port only) seconds spent in fsync."""
    w = api.wal
    secs = getattr(w, "WAL_FSYNC_SECONDS", None)
    return {"records": w.WAL_APPENDS.total(), "fsyncs": w.WAL_FSYNCS.total(),
            "fsync_s": secs.total() if secs is not None else 0.0}


def dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(path, n))
               for n in os.listdir(path))


def durable_drill(api, data_dir: str, n_nodes: int = None,
                  n_pods: int = None, mark=None) -> dict:
    """14a, tests/test_durability.py's cold-restart drill at full width: an
    APIServer(data_dir, durability="batch") holding make_nodes(n_nodes) and
    flagship_pods(n_pods), created through Client.local; a SharedInformer
    on the pods; a Scheduler (FakeClock, waves of SERVER_BATCH) with an
    APIBinder and a BindIntentLedger over that storage. Between waves the
    scheduler gets what its informer would deliver: every pod the apiserver
    holds bound that it has not seen bound, then one node update (which
    moves the unschedulable pods back to the active queue). DURABLE_CRASH
    kills the apiserver mid-commit; the process is gone: the informer stops
    (it keeps its resume token), the store's pump stops and its batch
    flusher stops with no final fsync. A new APIServer boots from the data
    dir; the informer resumes against it; a successor Scheduler over the
    rebooted storage runs recover() against the apiserver's pods, then
    run_until_idle(max_waves=1) wave after wave until its queue is empty.
    `mark()` is called just before the first wave."""
    n_nodes = DURABLE_NODES if n_nodes is None else n_nodes
    n_pods = DURABLE_PODS if n_pods is None else n_pods
    W = api.workloads
    nodes = W.make_nodes(n_nodes)
    wal0 = wal_counters(api)
    srv1 = api.APIServer(data_dir=data_dir, durability="batch")
    srv2 = informer = None
    try:
        client = api.Client.local(srv1)
        backend = type(srv1.storage.kv._backend).__name__
        create_s = _create(client, api, nodes, W.flagship_pods(n_pods))
        informer = api.SharedInformer(client.pods, namespace="default")
        informer.start()
        if not informer.wait_for_sync(60):
            fail("14a: the informer never synced")
        relists0 = informer.relists
        log = []
        seen_bound = {}  # a scheduler -> the pods it has seen bound

        def boot(storage):
            s = api.scheduler(
                binder=LoggedBinder(api.APIBinder(client), log),
                ledger=api.ledger(storage), clock=FakeClock(),
                base_dims=api.Dims(N=api.bucket(n_nodes), P=SERVER_BATCH,
                                   E=api.bucket(n_pods + 256)),
                batch_size=SERVER_BATCH)
            seen = seen_bound[id(s)] = set()
            for n in client.nodes.list()["items"]:
                s.on_node_add(api.node_from_v1(n))
            for p in client.pods.list("default")["items"]:
                s.on_pod_add(api.pod_from_v1(p))
                if (p.get("spec") or {}).get("nodeName"):
                    seen.add(p["metadata"]["name"])
            return s

        def inform(s, w):
            seen = seen_bound[id(s)]
            for p in client.pods.list("default")["items"]:
                name = p["metadata"]["name"]
                if (p.get("spec") or {}).get("nodeName") and name not in seen:
                    s.on_pod_add(api.pod_from_v1(p))
                    seen.add(name)
            s.on_node_update(nodes[w % n_nodes])

        def lookup(key):
            ns, name = key.split("/", 1)
            try:
                return api.pod_from_v1(client.pods.get(name, ns))
            except api.errors.StatusError:
                return None

        s1 = boot(srv1.storage)
        if mark is not None:
            mark()
        waves1 = []
        api.faultline.install(DURABLE_CRASH)
        try:
            for w in range(DURABLE_MAX_WAVES):
                st = s1.schedule_pending()
                waves1.append(st.scheduled)
                inform(s1, w)
            fail("14a: the apiserver never died")
        except api.faultline.InjectedCrash:
            t_kill = time.monotonic()
        finally:
            api.faultline.uninstall()
        crashed_wave = len(waves1) + 1
        kv1 = srv1.storage.kv
        rev_at_death = kv1.rev()
        intents_at_death = len(api.ledger(srv1.storage).unretired())
        # the Binding the kill interrupted is committed but was never
        # answered: the apiserver holds it, no binder logged it
        logged = {k for k, _, _ in log}
        unacked = {f"default/{p['metadata']['name']}": p["spec"]["nodeName"]
                   for p in client.pods.list("default")["items"]
                   if (p.get("spec") or {}).get("nodeName")
                   and f"default/{p['metadata']['name']}" not in logged}
        bound_at_death = len(log) + len(unacked)
        if len(unacked) != 1:
            fail(f"14a: {len(unacked)} unanswered Bindings at the kill, "
                 f"want 1")
        if intents_at_death != 1:
            fail(f"14a: {intents_at_death} unretired intents at the kill, "
                 f"want 1")
        # the process is gone: nothing flushes, nothing more is written
        informer.stop()
        srv1.storage._stop.set()
        kv1._wal._stop.set()
        if kv1._wal._flusher is not None:
            kv1._wal._flusher.join(timeout=5)
        wal1 = wal_counters(api)
        wal_bytes = dir_bytes(data_dir)

        # ---- reboot from disk ----------------------------------------- #
        t0 = time.perf_counter()
        srv2 = api.APIServer(data_dir=data_dir, durability="batch")
        boot_s = time.perf_counter() - t0
        kv2 = srv2.storage.kv
        if not kv2.recovered:
            fail("14a: the rebooted store recovered nothing")
        if kv2.rev() != rev_at_death:
            fail(f"14a: rev {kv2.rev()} after the reboot, {rev_at_death} at "
                 f"the kill")
        client.transport.api = srv2
        informer.start()
        if not informer.wait_for_sync(60):
            fail("14a: the informer never resynced")
        if informer.relists != relists0:
            fail("14a: the informer relisted instead of resuming")
        s2 = boot(srv2.storage)
        n_before = len(log)
        t0 = time.perf_counter()
        report = s2.recover(lookup=lookup)
        replay_s = time.perf_counter() - t0
        if report.replayed_intents != 1:
            fail(f"14a: the successor replayed {report.replayed_intents} "
                 f"intents, want 1")
        first_bind_s = (log[n_before][2] - t_kill) if len(log) > n_before \
            else None
        waves2 = []
        for w in range(DURABLE_MAX_WAVES):
            inform(s2, w)
            if sum(s2.queue.lengths()) == 0:
                break
            st = s2.run_until_idle(max_waves=1)
            waves2.append(st.scheduled)
        deadline = time.monotonic() + 10
        while informer.resumes < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        if informer.resumes < 1 or informer.relists != relists0:
            fail(f"14a: informer resumes {informer.resumes}, relists "
                 f"{informer.relists - relists0}")
        items = client.pods.list("default")["items"]
        pairs = [(f"default/{p['metadata']['name']}", p["spec"]["nodeName"])
                 for p in items if (p.get("spec") or {}).get("nodeName")]
        keys = [k for k, _, _ in log] + list(unacked)
        if len(set(keys)) != len(keys):
            fail("14a: a pod was bound twice")
        if dict(pairs) != {**unacked, **{k: n for k, n, _ in log}}:
            fail("14a: the apiserver's bindings and the binders' disagree")
        if s2.ledger.unretired():
            fail(f"14a: {len(s2.ledger.unretired())} unretired intents")
        if len(pairs) != n_pods:
            fail(f"14a: {n_pods - len(pairs)} pods left unbound")
        if kv2.rev() <= rev_at_death:
            fail("14a: the revision did not move on after the reboot")
        rep = {k: getattr(report, k) for k in (
            "replayed_intents", "already_bound", "completed", "released",
            "dropped", "stale_skipped")}
        return {
            "backend": backend, "bound": len(pairs),
            "bound_sha256": placement_sha256(pairs),
            "waves": waves1, "crashed_wave": crashed_wave,
            "successor_waves": waves2, "report": rep,
            "bound_at_death": bound_at_death,
            "create_s": create_s,
            "creates_per_s": (n_nodes + n_pods) / create_s,
            "rev_at_death": rev_at_death,
            "wal_records": wal1["records"] - wal0["records"],
            "wal_bytes": wal_bytes,
            "wal_fsyncs": wal1["fsyncs"] - wal0["fsyncs"],
            "wal_fsync_s": wal1["fsync_s"] - wal0["fsync_s"],
            "recovery_s": kv2.recovery_seconds, "reboot_s": boot_s,
            "kill_to_first_bind_s": first_bind_s, "replay_s": replay_s,
            "informer_resumes": informer.resumes,
            "informer_relists": informer.relists - relists0}
    finally:
        api.faultline.uninstall()
        if informer is not None:
            informer.stop()
        if srv2 is not None:
            srv2.close()


def durable_reference(out) -> dict:
    """What 14a holds the port to: the JAX package's run of the drill."""
    return {k: out[k] for k in ("bound", "bound_sha256", "waves",
                                "crashed_wave", "successor_waves",
                                "report", "bound_at_death")}


def durable_phase(device, card: str) -> dict:
    """Phase 14 on the card: 14a the durable drill (durable_drill), 14b
    11d's drain over the binary codec against a durable apiserver. The
    data dirs live under the run's temporary directory. Launch counts per
    subphase: set to 0 just before it, read just after; each subphase's
    first K1, K2 and K3 launch held against the plain versions (K3 runs in
    14b's what-if, as in 11d)."""
    import os
    import shutil
    import tempfile

    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops import preempt as OP
    from kubernetes_tpu_torch.ops import waves as W

    api = port_server_api(device)
    counts, cur, recs = {}, [], {}

    def mark(name):
        if cur:
            counts[cur[-1]] = K.launch_counts()
            for r in recs[cur[-1]]:
                r.restore()
        if name is None:
            return
        cur.append(name)
        recs[name] = [Recorder(W, "contention_scan"),
                      Recorder(W, "domain_rank"),
                      Recorder(OP, "reprieve_scan")]
        K.reset_launch_counts()

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ktpu-durable-")
    try:
        a = durable_drill(api, os.path.join(root, "14a"),
                          mark=lambda: mark("14a"))
        b = server_drain(api, n_pods=SERVER_HTTP_PODS, transport="http",
                         binary=True, data_dir=os.path.join(root, "14b"),
                         mark=lambda: mark("14b"))
    finally:
        mark(None)
        shutil.rmtree(root, ignore_errors=True)
    # the backend this process selected at its first store, and 14a's
    native = api.native
    if native.BACKEND_INFO.value(backend="native", reason="preferred") != 1 \
            or a["backend"] != "NativeKV":
        fail(f"14a: the native kvstore does not serve this process: 14a ran "
             f"on {a['backend']} ({native._build_error})")
    got = durable_reference(a)
    if got != JAX_DURABLE:
        fail(f"14a differs from JAX_DURABLE: {got}")
    check_server(b, JAX_SERVER_BINARY, "14b")
    if b["waves_sha256"] != JAX_SERVER_BINARY["waves_sha256"]:
        fail("14b: the per-wave binder order differs from the JAX package's")
    if device.type == "cuda":
        for sub in ("14a", "14b"):
            if not all(counts[sub].get(n, 0) for n in WAVE_KERNELS):
                fail(f"{sub}: K1/K2 not launched: {counts[sub]}")
    errs = server_kernel_check(recs, counts, device)
    settle(api, "14")
    first = ("none" if a["kill_to_first_bind_s"] is None
             else f"{a['kill_to_first_bind_s']:.3f} s")
    print(f"  14a: {DURABLE_NODES} nodes + {DURABLE_PODS} pods created "
          f"through the durable apiserver (batch, native store) in "
          f"{a['create_s']:.3f} s ({a['creates_per_s']:.1f} creates/s); "
          f"killed at {DURABLE_CRASH} in wave {a['crashed_wave']} (rev "
          f"{a['rev_at_death']}, {a['bound_at_death']} bound, 1 intent "
          f"left); WAL {a['wal_records']:.0f} records, {a['wal_bytes']} "
          f"bytes, {a['wal_fsyncs']:.0f} fsyncs in {a['wal_fsync_s']:.4f} s")
    print(f"    reboot {a['reboot_s']:.3f} s (DurableKV recovery "
          f"{a['recovery_s']:.3f} s), rev continuous; informer resumed "
          f"({a['informer_resumes']} resumes, 0 relists); replayed 1 intent "
          f"in {a['replay_s']:.3f} s ({a['report']}); kill to the first "
          f"successor bind {first}; successor waves {a['successor_waves']}; "
          f"{a['bound']} bound exactly once, the whole map equal to "
          f"JAX_DURABLE; launches {counts['14a']} ({card})")
    print(f"  14b: HTTPTransport(binary=True) through an HTTPGateway to a "
          f"durable apiserver: {SERVER_NODES} nodes + {SERVER_HTTP_PODS} "
          f"pods created in {b['create_s']:.3f} s ({b['creates_per_s']:.1f}"
          f"/s); {b['bound']} bound in waves of "
          f"{[w['scheduled'] for w in b['waves']]} behind the barrier, "
          f"{b['drain_s']:.3f} s; the whole map, the per-wave counts and "
          f"order equal JAX_SERVER_BINARY; launches {counts['14b']}")
    return dict(a=a, b=b, launches=counts, errs=errs,
                wal_fsync_s=a["wal_fsync_s"],
                wall_s=time.perf_counter() - t0)


# --------------------------------------------------------------------------- #
# phase 15: the kubemark rollout (shared with scripts/flagship_reference.py
# --path kubemark, which runs it on the JAX package)
# --------------------------------------------------------------------------- #

# 500 hollow nodes, not kubemark's 5,000: every hollow node is a Kubelet with
# a field-selected pod informer and two threads, so every pod write fans out
# to one watcher per node, and all of them share one interpreter lock with
# the scheduler. 500 replicas, not 2,000, halved twice for the phase's
# 150 s: at 2,000 a slow host's wave took 265 s for its Bindings and the
# starved heartbeats let the node lifecycle controller taint 128 nodes; at
# 1,000 three runs alone took 78.5, 87.8 and 140.7 s, the last with its
# wave waiting 91.5 s for the interpreter lock beside the hollow nodes
KUBEMARK_NODES, KUBEMARK_REPLICAS, KUBEMARK_ZONES = 500, 500, 10
KUBEMARK_CONTROLLERS = ["deployment", "replicaset", "daemonset",
                        "nodelifecycle"]
KUBEMARK_TIMEOUT_S = 300.0  # the longest any one stage may wait
KUBEMARK_BUDGET_S = 150.0   # the phase's whole time on the card
ZONE_KEY = "topology.kubernetes.io/zone"
UNHEALTHY_TAINTS = ("node.kubernetes.io/unreachable",
                    "node.kubernetes.io/not-ready")

# The JAX package's run of kubemark_drive (500 hollow nodes, Deployment web
# of 500 replicas spread over 10 zones, DaemonSet agent; its
# SchedulerServer at its defaults behind the wave barrier; JAX 0.9.0 on the
# CPU). Reproduce with `JAX_PLATFORMS=cpu python3
# scripts/flagship_reference.py --package jax --path kubemark`. The map keys
# a Deployment pod by its name (its ReplicaSet's one worker creates the
# replicas in order, so the apiserver's name sequence gives each the same
# name) and a daemon pod by the node its metadata.name term targets (the
# DaemonSet controller keeps no expectations, so a resync on a stale lister
# may make a duplicate and delete it again, spending a name). Two runs of
# the reference on 2026-10-18 gave these same values (two others on a
# loaded CPU failed their taint gate: the hollow nodes' heartbeats starved).
JAX_KUBEMARK = {
    "bound": 1000, "waves": [1000],
    "bound_sha256":
        "37ef54957a8da4891b2806ceff88bc1346871ec84bd80328d66d151aeb754049"}


def kubemark_labels(i: int) -> dict:
    return {"kubernetes.io/hostname": f"hollow-node-{i}",
            ZONE_KEY: f"zone-{i % KUBEMARK_ZONES}"}


def web_deployment(replicas: int) -> dict:
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": "web", "namespace": "default"},
            "spec": {"replicas": replicas,
                     "selector": {"matchLabels": {"app": "web"}},
                     "template": {
                         "metadata": {"labels": {"app": "web"}},
                         "spec": {
                             "containers": [{
                                 "name": "web", "image": "nginx",
                                 "resources": {"requests": {
                                     "cpu": "100m", "memory": "64Mi"}}}],
                             "topologySpreadConstraints": [{
                                 "maxSkew": 1, "topologyKey": ZONE_KEY,
                                 "whenUnsatisfiable": "DoNotSchedule",
                                 "labelSelector": {
                                     "matchLabels": {"app": "web"}}}]}}}}


def agent_daemonset() -> dict:
    return {"apiVersion": "apps/v1", "kind": "DaemonSet",
            "metadata": {"name": "agent", "namespace": "default"},
            "spec": {"selector": {"matchLabels": {"app": "agent"}},
                     "template": {
                         "metadata": {"labels": {"app": "agent"}},
                         "spec": {"containers": [{
                             "name": "agent", "image": "agent",
                             "resources": {"requests": {
                                 "cpu": "50m", "memory": "32Mi"}}}]}}}}


def daemon_target(pod: dict) -> str:
    """The node a daemon pod's required metadata.name term names."""
    terms = (((pod["spec"].get("affinity") or {}).get("nodeAffinity") or {})
             .get("requiredDuringSchedulingIgnoredDuringExecution") or {}
             ).get("nodeSelectorTerms") or []
    for t in terms:
        for f in t.get("matchFields") or []:
            if f.get("key") == "metadata.name" and f.get("values"):
                return f["values"][0]
    return ""


def kubemark_key(pod: dict) -> str:
    """A pod's key in the bound map: a daemon pod by its target node, any
    other pod by its name (see JAX_KUBEMARK)."""
    md = pod["metadata"]
    if (md.get("labels") or {}).get("app") == "agent":
        return f"daemon@{daemon_target(pod)}"
    return f"{md.get('namespace', 'default')}/{md['name']}"


class ThreadErrors:
    """A threading.excepthook that records every exception a thread dies
    of (a controller, kubelet, informer or scheduler thread), then calls
    the hook it replaced."""

    def __init__(self):
        import threading

        self.errors, self._prev = [], threading.excepthook

        def hook(args):
            self.errors.append(f"{getattr(args.thread, 'name', '?')}: "
                               f"{args.exc_type.__name__}: {args.exc_value}")
            self._prev(args)

        threading.excepthook = hook

    def restore(self) -> None:
        import threading

        threading.excepthook = self._prev


class TaintWatch:
    """A watch pump over the nodes: every taint the node lifecycle
    controller puts on a node (unreachable, not-ready), with the time it
    was seen."""

    def __init__(self, client):
        import threading

        self.tainted = {}  # node -> (taint key, monotonic time)
        self._w = client.nodes.watch()
        self._t = threading.Thread(target=self._pump, daemon=True,
                                   name="taint-watch")
        self._t.start()

    def _pump(self) -> None:
        while True:
            ev = self._w.next(timeout=0.5)
            if ev is None:
                if self._w.stopped:
                    return
                continue
            if ev.type == "ERROR":
                self.tainted["<watch>"] = (str(ev.object), time.monotonic())
                return
            for t in (ev.object.get("spec") or {}).get("taints") or []:
                if t.get("key") in UNHEALTHY_TAINTS:
                    self.tainted.setdefault(ev.object["metadata"]["name"],
                                            (t["key"], time.monotonic()))

    def stop(self) -> None:
        self._w.stop()
        self._t.join(timeout=5)


def _kubemark_wait(cond, what: str, timeout: float = KUBEMARK_TIMEOUT_S,
                   step: float = 0.25) -> float:
    t0 = time.perf_counter()
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            fail(f"phase 15: timed out after {timeout:.0f} s waiting for "
                 f"{what}")
        time.sleep(step)
    return time.perf_counter() - t0


def kubemark_drive(api, n_nodes: int = None, replicas: int = None,
                   mark=None) -> dict:
    """Phase 15's drive on one package: an APIServer and a Client.local; a
    HollowCluster of `n_nodes` (hostname and zone-{i % 10} labels, the
    reference's default 8 CPU, 16Gi and 110 pods, heartbeat 5 s,
    housekeeping 1 s); a ControllerManager with KUBEMARK_CONTROLLERS; the
    Deployment web (`replicas` of 100m/64Mi, spread with maxSkew 1 over the
    zones, DoNotSchedule) until its ReplicaSet has created every pod, then
    the DaemonSet agent (50m/32Mi) until it has one pod per node and no
    duplicate; only then `mark()` and a SchedulerServer at its defaults,
    each wave behind wave_barrier, until every pod is bound, Running and
    Ready and both workloads report it. Every thread exception, every
    wave that raised and every unhealthy taint is recorded, and every
    gate of the phase that needs no reference is checked here."""
    import threading

    n_nodes = KUBEMARK_NODES if n_nodes is None else n_nodes
    replicas = KUBEMARK_REPLICAS if replicas is None else replicas
    total = replicas + n_nodes
    errs = ThreadErrors()
    srv_api = api.APIServer()
    hollow = cm = srv = watch = taints = None
    out = {"nodes": n_nodes, "replicas": replicas}
    t_phase = time.perf_counter()
    try:
        client = api.Client.local(srv_api)
        t0 = time.perf_counter()
        hollow = api.HollowCluster(client, n_nodes,
                                   labels_fn=kubemark_labels,
                                   heartbeat_interval=5.0,
                                   housekeeping_interval=1.0).start()
        out["hollow_start_s"] = time.perf_counter() - t0
        out["threads"] = threading.active_count()
        taints = TaintWatch(client)
        cm = api.ControllerManager(client,
                                   controllers=KUBEMARK_CONTROLLERS).start()

        def pods(sel: str) -> list:
            return client.pods.list("default", label_selector=sel)["items"]

        t0 = time.perf_counter()
        client.deployments.create(web_deployment(replicas))
        _kubemark_wait(lambda: len(pods("app=web")) >= replicas,
                       f"the ReplicaSet's {replicas} pods")
        out["web_create_s"] = time.perf_counter() - t0

        def daemons_settled() -> bool:
            ds = pods("app=agent")
            return len(ds) == n_nodes and len(
                {daemon_target(p) for p in ds}) == n_nodes
        t1 = time.perf_counter()
        client.daemonsets.create(agent_daemonset())
        _kubemark_wait(daemons_settled, f"the DaemonSet's {n_nodes} pods")
        time.sleep(1.0)  # a duplicate made on a stale lister is deleted
        _kubemark_wait(daemons_settled, "the DaemonSet to drop duplicates")
        out["agent_create_s"] = time.perf_counter() - t1
        out["create_s"] = time.perf_counter() - t0
        out["creates_per_s"] = total / out["create_s"]
        if len(pods("app=web")) != replicas:
            fail(f"phase 15: the ReplicaSet made {len(pods('app=web'))} "
                 f"pods, not {replicas}")

        watch = BindWatch(client)
        srv = api.server(client)
        log = WaveLog(srv.scheduler)
        wave_barrier(srv, log)
        if mark is not None:
            mark()
        srv.start()
        _kubemark_wait(lambda: watch.count() >= total,
                       f"{total} pods bound", step=0.05)
        srv.wait_until_idle(30)
        t_bound = max(watch.at.values())
        out["sched_s"] = t_bound - log.waves[0]["t0"]
        out["waves"] = [w["scheduled"] for w in log.waves]
        out["wave_s"] = [w["t1"] - w["t0"] for w in log.waves]
        # each wave's flight record: readback is the device cycle waited
        # for, bind-commit the Bindings through the client
        out["wave_split_s"] = [
            {p: dt for p, dt in r["phases"]}
            for r in srv.scheduler.telemetry.recorder.records()
            if r.get("stats", {}).get("attempted")]

        def all_running() -> bool:
            items = client.pods.list("default")["items"]
            return len(items) == total and all(
                (p.get("status") or {}).get("phase") == "Running" and any(
                    c.get("type") == "Ready" and c.get("status") == "True"
                    for c in (p.get("status") or {}).get("conditions") or [])
                for p in items)
        _kubemark_wait(all_running, "every pod Running and Ready")
        out["bind_to_running_s"] = time.monotonic() - t_bound

        def statuses() -> tuple:
            d = client.deployments.get("web", "default").get("status") or {}
            a = client.daemonsets.get("agent", "default").get("status") or {}
            return (d.get("readyReplicas"), d.get("availableReplicas"),
                    a.get("numberReady"), a.get("desiredNumberScheduled"))
        want = (replicas, replicas, n_nodes, n_nodes)
        _kubemark_wait(lambda: statuses() == want,
                       f"the workloads' statuses {want}")
        out["statuses"] = statuses()
        out["phase_s"] = time.perf_counter() - t_phase

        items = client.pods.list("default")["items"]
        nodes = {n["metadata"]["name"]: n
                 for n in client.nodes.list("")["items"]}
        out["bound"] = sum(1 for p in items if p["spec"].get("nodeName"))
        out["bound_sha256"] = placement_sha256(
            (kubemark_key(p), p["spec"]["nodeName"]) for p in items)
        # DaemonSet placement: each on its target, one per node
        daemons = [p for p in items
                   if p["metadata"]["labels"].get("app") == "agent"]
        off = [p["metadata"]["name"] for p in daemons
               if p["spec"]["nodeName"] != daemon_target(p)]
        per_node = {}
        for p in daemons:
            per_node[p["spec"]["nodeName"]] = \
                per_node.get(p["spec"]["nodeName"], 0) + 1
        if off or sorted(per_node) != sorted(nodes) or \
                set(per_node.values()) != {1}:
            fail(f"phase 15: DaemonSet placement: {len(off)} daemon pods "
                 f"off their target node, {len(per_node)} nodes hold one, "
                 f"counts {sorted(set(per_node.values()))}")
        # topology spread of the Deployment
        zones = {}
        for p in items:
            if p["metadata"]["labels"].get("app") == "web":
                z = nodes[p["spec"]["nodeName"]]["metadata"]["labels"][
                    ZONE_KEY]
                zones[z] = zones.get(z, 0) + 1
        out["zone_counts"] = dict(sorted(zones.items()))
        if len(zones) != min(n_nodes, KUBEMARK_ZONES) or \
                max(zones.values()) - min(zones.values()) > 1:
            fail(f"phase 15: the Deployment's zone counts differ by more "
                 f"than maxSkew 1: {out['zone_counts']}")
        over, held = overcommitted(api, items, nodes)
        if over:
            fail(f"phase 15: {len(over)} nodes overcommitted: {over[:3]}")
        out["max_node_pods"] = max(held.values())
        if watch.doubles:
            fail(f"phase 15: double binds {watch.doubles[:5]}")
        if log.errors:
            fail(f"phase 15: {len(log.errors)} waves raised: "
                 f"{log.errors[:3]}")
        if taints.tainted:
            renew = {}
            for name in list(taints.tainted)[:5]:
                try:
                    renew[name] = client.leases.get(
                        name, "kube-node-lease")["spec"].get("renewTime")
                except Exception as e:  # noqa: BLE001 - reported
                    renew[name] = repr(e)
            fail(f"phase 15: the node lifecycle controller tainted "
                 f"{len(taints.tainted)} hollow nodes: "
                 f"{dict(list(taints.tainted.items())[:5])}; their last "
                 f"lease renewals {renew}")
        out["sync_errors"] = {n: len(c.sync_errors)
                              for n, c in cm.controllers.items()}
        return out
    finally:
        for x in (srv, cm, hollow, watch, taints):
            if x is not None:
                x.stop()
        srv_api.close()
        errs.restore()
        if errs.errors:
            fail(f"phase 15: {len(errs.errors)} threads raised: "
                 f"{errs.errors[:3]}")


def kubemark_reference(out) -> dict:
    """What phase 15 holds the port to: the JAX package's run."""
    return {k: out[k] for k in ("bound", "bound_sha256", "waves")}


PHASE_CHILD_TIMEOUT_S = {"15": 480.0, "16": 420.0}
PHASE_RESULT = "phase-result: "


def phase_child(phase: str) -> int:
    """`chip_smoke.py --phase 15|16`: that phase alone in this interpreter
    (the kernels built from the checkout, loaded from build/ where the
    parent built them), its result on one line after PHASE_RESULT.

    The interpreter ends with os._exit once its output is flushed, not by
    finalising: threads of the drive that stop() did not join (kubelets,
    informers) may still run then, and a finalising interpreter under them
    aborted ("terminate called without an active exception") or crashed
    after the phase's result was out, which the parent reads as a failed
    phase."""
    import os
    import traceback

    import torch

    if not torch.cuda.is_available():
        print(f"chip_smoke --phase {phase}: no CUDA device", file=sys.stderr)
        return 2
    from kubernetes_tpu_torch.ops import kernels as K

    os.environ["KTPU_OVERLOAD"] = "0"
    run = {"15": kubemark_phase, "16": cluster_phase,
           "17": mesh_phase, "18": fleet_mesh_phase}[phase]
    code = 1
    try:
        K.build()
        out = run(torch.device("cuda", 0), card_line())
        print(PHASE_RESULT + json.dumps(out, default=str))
        code = 0
    except SystemExit as e:
        print(e, file=sys.stderr)
    except BaseException:  # noqa: BLE001 - printed, then a failed exit
        traceback.print_exc()
    # ROADMAP C7: what still runs when the interpreter would finalise
    print(f"phase {phase} threads alive before os._exit: "
          + json.dumps(live_threads()))
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def live_threads() -> dict:
    """The threads alive now but the caller's: non-daemon and daemon
    names (a kubelet's threads collapsed to one count per name pattern)."""
    import re
    import threading

    me = threading.current_thread()
    alive = [t for t in threading.enumerate() if t is not me]
    daemon = {}
    for t in alive:
        if t.daemon:
            key = re.sub(r"\d+", "N", t.name)
            daemon[key] = daemon.get(key, 0) + 1
    return {"non_daemon": sorted(t.name for t in alive if not t.daemon),
            "daemon": daemon}


def phase_subprocess(phase: str) -> dict:
    """Phase 15 or 16 in an interpreter of its own (`--phase N`), on the
    same card, before phases 2-14. Their hundreds of threads share one
    interpreter lock with everything in their process, and the cores with
    every process: in this interpreter after phases 1-14 phase 15's drive
    could not create its pods in 300 s on the card's host, and in a child
    after them its starved heartbeats let nodes be tainted on a slow host.
    The child's lines are printed here; its result comes back as JSON."""
    import os

    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--phase", phase], capture_output=True, text=True,
                       timeout=PHASE_CHILD_TIMEOUT_S[phase])
    result = None
    for line in r.stdout.splitlines():
        if line.startswith(PHASE_RESULT):
            result = json.loads(line[len(PHASE_RESULT):])
        else:
            print(line)
    if r.returncode != 0 or result is None:
        sys.stderr.write(r.stderr[-4000:])
        fail(f"phase {phase}'s interpreter exited {r.returncode}: "
             f"{r.stderr.strip().splitlines()[-1:] or 'no result'}")
    return result


def kubemark_phase(device, card: str) -> dict:
    """Phase 15 on the card: kubemark_drive with the port's SchedulerServer
    on `device`, its map and waves against JAX_KUBEMARK, K1 and K2 launched
    in its waves and their first launches held against the plain versions.
    Launch counts set to 0 just before the server starts, read just after
    the drive."""
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops import preempt as OP
    from kubernetes_tpu_torch.ops import waves as W

    api = port_server_api(device)
    recs = {}

    def mark():
        recs["15"] = [Recorder(W, "contention_scan"),
                      Recorder(W, "domain_rank"),
                      Recorder(OP, "reprieve_scan")]
        K.reset_launch_counts()

    try:
        out = kubemark_drive(api, mark=mark)
    finally:
        counts = {"15": K.launch_counts()}
        for r in recs.get("15", []):
            r.restore()
    got = kubemark_reference(out)
    if got != JAX_KUBEMARK:
        fail(f"phase 15 differs from JAX_KUBEMARK: {got} != {JAX_KUBEMARK}")
    if device.type == "cuda" and not all(
            counts["15"].get(n, 0) for n in WAVE_KERNELS):
        fail(f"phase 15: K1/K2 not launched: {counts['15']}")
    errs = server_kernel_check(recs, counts, device)
    settle(api, "15")
    if out["phase_s"] > KUBEMARK_BUDGET_S:
        fail(f"phase 15 took {out['phase_s']:.1f} s, over its "
             f"{KUBEMARK_BUDGET_S:.0f} s")
    print(f"  15: {out['nodes']} hollow nodes started in "
          f"{out['hollow_start_s']:.3f} s ({out['threads']} threads); the "
          f"controllers created {out['replicas']} + {out['nodes']} pods in "
          f"{out['create_s']:.3f} s ({out['creates_per_s']:.1f} pods/s; web "
          f"{out['web_create_s']:.3f} s, agent {out['agent_create_s']:.3f} "
          f"s) ({card})")
    split = "; ".join(f"readback {w.get('readback', 0):.3f} s, "
                      f"bind-commit {w.get('bind-commit', 0):.3f} s"
                      for w in out["wave_split_s"])
    print(f"    {out['bound']} bound in waves of {out['waves']} behind the "
          f"wave barrier ({split}), first wave to last bind "
          f"{out['sched_s']:.3f} s; "
          f"last bind to all Running and Ready {out['bind_to_running_s']:.3f}"
          f" s; phase {out['phase_s']:.3f} s; launches {counts['15']} "
          f"({card})")
    print(f"    the map and the waves equal JAX_KUBEMARK; web ready/"
          f"available and agent ready/desired {out['statuses']}; zones "
          f"{list(out['zone_counts'].values())}; each daemon pod on its "
          f"node; no overcommit (at most {out['max_node_pods']} pods a "
          f"node); no taint, no thread raised; controller sync errors "
          f"{out['sync_errors']}")
    return dict(out=out, launches=counts, errs=errs)


# --------------------------------------------------------------------------- #
# phase 16: a cluster stood up by Cluster and driven by kubectl
# --------------------------------------------------------------------------- #

CLUSTER_NODES, CLUSTER_REPLICAS, CLUSTER_JOIN = 100, 300, 2
CLUSTER_CONTROLLERS = ["deployment", "replicaset", "endpoints",
                       "nodelifecycle"]
CLUSTER_TIMEOUT_S = 120.0  # the longest any one stage may wait
CLUSTER_BUDGET_S = 150.0   # the phase's whole time on the card
CLUSTER_UPGRADE_TO = "v1.18.0"
HOSTNAME_KEY = "kubernetes.io/hostname"

# The JAX package's run of cluster_drive (Cluster with 100 hollow nodes and
# CLUSTER_CONTROLLERS, kubectl apply of web and its Service, the proxier,
# the metrics server and kubectl top, upgrade plan/apply to v1.18.0, join 2
# and kubectl scale to 306; JAX 0.9.0 on the CPU): everything in it is
# timing-free. Reproduce with `JAX_PLATFORMS=cpu python3
# scripts/flagship_reference.py --package jax --path cluster`. Three runs
# on 2026-10-18 gave these values; a fourth lost a hollow kubelet's
# heartbeat thread to a connection reset (ROADMAP §C, C6).
JAX_CLUSTER = {
    "per_node_16b": {
        "nodes_by_count": {"3": 100},
        "sha256":
            "d485885aabe58c4c813eac22fc25dfe49cd818a339367dd005a540e38c1e1961"},
    "per_node_16f": {
        "nodes_by_count": {"3": 102},
        "sha256":
            "fabf20aaab9c0b74230fdde007ef4d34bfc064dd1868694d8f9ba910cac33db6"},
    "joined": {"joined-node-b0-0": 3, "joined-node-b0-1": 3},
    "endpoints": 300, "top_rows": {"nodes": 100, "pods": 300},
    "upgrade_phases": ["preflight", "config", "control-plane/scheduler",
                       "control-plane/controller-manager", "upload-config",
                       "health"],
    "apply": ["deployment/web created", "service/web created"],
    "status_16b": {"availableReplicas": 300, "observedGeneration": 1,
                   "readyReplicas": 300, "replicas": 300,
                   "updatedReplicas": 300, "conditions": []},
    "status_16f": {"availableReplicas": 306, "observedGeneration": 1,
                   "readyReplicas": 306, "replicas": 306,
                   "updatedReplicas": 306, "conditions": []}}


def cluster_manifests(replicas: int) -> dict:
    """Phase 16's two JSON manifests: the Deployment web (100m/64Mi, spread
    with maxSkew 1 over the nodes' hostnames, DoNotSchedule) and its
    ClusterIP Service on port 80."""
    deploy = {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": "web", "namespace": "default"},
        "spec": {"replicas": replicas,
                 "selector": {"matchLabels": {"app": "web"}},
                 "template": {
                     "metadata": {"labels": {"app": "web"}},
                     "spec": {
                         "containers": [{
                             "name": "web", "image": "nginx",
                             "ports": [{"containerPort": 80}],
                             "resources": {"requests": {
                                 "cpu": "100m", "memory": "64Mi"}}}],
                         "topologySpreadConstraints": [{
                             "maxSkew": 1, "topologyKey": HOSTNAME_KEY,
                             "whenUnsatisfiable": "DoNotSchedule",
                             "labelSelector": {
                                 "matchLabels": {"app": "web"}}}]}}}}
    service = {
        "apiVersion": "v1", "kind": "Service",
        "metadata": {"name": "web", "namespace": "default"},
        "spec": {"type": "ClusterIP", "selector": {"app": "web"},
                 "ports": [{"name": "http", "port": 80}]}}
    return {"deploy.json": deploy, "service.json": service}


def overcommitted(api, items, nodes) -> list:
    """The nodes whose bound pods request more CPU, memory or pods than the
    node allocates (the package's own quantity parsers), and per node the
    pods it holds."""
    milli, kib = api.types.parse_cpu_milli, api.types.parse_mem_kib
    used = {}
    for p in items:
        u = used.setdefault(p["spec"]["nodeName"], [0, 0, 0])
        for c in p["spec"].get("containers") or []:
            r = (c.get("resources") or {}).get("requests") or {}
            u[0] += milli(r.get("cpu", 0))
            u[1] += kib(r.get("memory", 0))
        u[2] += 1
    over = []
    for name, (cpu, mem, n) in used.items():
        alloc = nodes[name]["status"]["allocatable"]
        if cpu > milli(alloc["cpu"]) or mem > kib(alloc["memory"]) \
                or n > int(alloc["pods"]):
            over.append((name, cpu, mem, n))
    return over, {name: u[2] for name, u in used.items()}


def deployment_status(client) -> dict:
    """The Deployment web's status less what follows the clock: its
    conditions as (type, status, reason)."""
    st = dict(client.deployments.get("web", "default").get("status") or {})
    st["conditions"] = sorted([c.get("type"), c.get("status"), c.get("reason")]
                              for c in st.get("conditions") or [])
    return st


def _cluster_wait(cond, what: str, timeout: float = CLUSTER_TIMEOUT_S,
                  step: float = 0.1) -> float:
    t0 = time.perf_counter()
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            fail(f"phase 16: timed out after {timeout:.0f} s waiting for "
                 f"{what}")
        time.sleep(step)
    return time.perf_counter() - t0


def cluster_drive(api, workdir: str, n_nodes: int = None,
                  replicas: int = None, mark=None) -> dict:
    """Phase 16's drive on one package, through its Cluster and kubectl
    over the gateway (Client.http): 16a Cluster(hollow_nodes=n_nodes,
    controllers=CLUSTER_CONTROLLERS) up; 16b kubectl apply of the two JSON
    manifests (written under `workdir`) and rollout status, until every
    pod runs, exactly replicas/n_nodes on each node; 16c a Proxier on the
    cluster's client, synced once, its rule for the Service against the
    pods' ip:port, and its /healthz; 16d a MetricsServer over the hollow
    kubelets and kubectl top nodes and pods; 16e upgrade plan and apply to
    CLUSTER_UPGRADE_TO; 16f join CLUSTER_JOIN nodes (token-only: no CSR
    controller) and kubectl scale by 3 a joined node, placed by the
    restarted scheduler. `mark()` runs just before the cluster comes up.
    Every thread exception and every unhealthy taint fails the phase, as
    does any gate that needs no reference."""
    import io
    import os
    import threading
    import urllib.request

    n_nodes = CLUSTER_NODES if n_nodes is None else n_nodes
    replicas = CLUSTER_REPLICAS if replicas is None else replicas
    per_node = replicas // n_nodes
    scaled = replicas + per_node * CLUSTER_JOIN
    errs = ThreadErrors()
    cluster = taints = factory = hz = ms = None
    out = {"nodes": n_nodes, "replicas": replicas, "join": CLUSTER_JOIN}
    t_phase = time.perf_counter()
    try:
        if mark is not None:
            mark()
        t0 = time.perf_counter()
        cluster = api.Cluster(api.cluster_config(
            hollow_nodes=n_nodes, controllers=list(CLUSTER_CONTROLLERS))).up()
        out["up_s"] = time.perf_counter() - t0
        out["threads"] = threading.active_count()
        api.made.append(cluster.scheduler.scheduler)
        client = cluster.client
        taints = TaintWatch(client)

        def kubectl(*argv) -> str:
            o, e = io.StringIO(), io.StringIO()
            rc = api.kubectl(["-s", cluster.url, *argv], out=o, err=e)
            if rc != 0:
                fail(f"phase 16: kubectl {' '.join(argv)} exited {rc}: "
                     f"{e.getvalue().strip()}")
            return o.getvalue()

        def ready_nodes() -> set:
            return {n["metadata"]["name"]
                    for n in client.nodes.list("")["items"]
                    if any(c.get("type") == "Ready" and c.get("status") ==
                           "True" for c in (n.get("status") or {}).get(
                               "conditions") or [])}

        out["nodes_ready_s"] = _cluster_wait(
            lambda: len(ready_nodes()) >= n_nodes, f"{n_nodes} nodes Ready")

        def web_pods() -> list:
            return client.pods.list("default",
                                    label_selector="app=web")["items"]

        def all_running(want: int) -> bool:
            items = web_pods()
            return len(items) == want and all(
                (p.get("status") or {}).get("phase") == "Running" and any(
                    c.get("type") == "Ready" and c.get("status") == "True"
                    for c in (p.get("status") or {}).get("conditions") or [])
                for p in items)

        def placement(want: int, nodes_want: int, what: str) -> dict:
            items = web_pods()
            nodes = {n["metadata"]["name"]: n
                     for n in client.nodes.list("")["items"]}
            over, held = overcommitted(api, items, nodes)
            if over:
                fail(f"phase 16: {len(over)} nodes overcommitted {what}: "
                     f"{over[:3]}")
            if len(items) != want or len(nodes) != nodes_want or \
                    sorted(held) != sorted(nodes) or \
                    set(held.values()) != {per_node}:
                fail(f"phase 16: {what}, {len(items)} pods on "
                     f"{len(held)} of {len(nodes)} nodes, per node "
                     f"{sorted(set(held.values()))}, not exactly "
                     f"{per_node} on each (nodes tainted unhealthy: "
                     f"{dict(list(taints.tainted.items())[:5])}; threads "
                     f"raised: {errs.errors[:3]})")
            return dict(sorted(held.items()))

        # 16b: kubectl apply of the JSON manifests, then rollout status
        paths = []
        for name, obj in cluster_manifests(replicas).items():
            path = os.path.join(workdir, name)
            with open(path, "w") as f:
                json.dump(obj, f)
            paths.append(path)
        t0 = time.perf_counter()
        out["apply"] = [kubectl("apply", "-f", path).strip()
                        for path in paths]
        kubectl("rollout", "status", "deployment/web", "--timeout",
                f"{CLUSTER_TIMEOUT_S:g}")
        out["rollout_s"] = time.perf_counter() - t0
        _cluster_wait(lambda: all_running(replicas),
                      f"{replicas} pods Running and Ready")
        out["running_s"] = time.perf_counter() - t0
        out["per_node_16b"] = placement(replicas, n_nodes, "after 16b")
        out["status_16b"] = deployment_status(client)

        # 16c: the proxier's rule for the Service, synced once
        t0 = time.perf_counter()

        def endpoints_ready() -> int:
            try:
                ep = client.endpoints.get("web", "default")
            except api.errors.StatusError:
                return 0
            return sum(len(ss.get("addresses") or [])
                       for ss in ep.get("subsets") or [])
        _cluster_wait(lambda: endpoints_ready() == replicas,
                      f"the Endpoints of web to list {replicas} addresses")
        factory = api.InformerFactory(client)
        hz = api.ProxierHealthServer().start()
        proxier = api.Proxier(client, factory, healthz=hz)
        factory.start()
        factory.wait_for_sync()
        out["synced_services"] = proxier.sync()
        vip = client.services.get("web", "default")["spec"]["clusterIP"]
        key = proxier.table.by_vip.get((vip, 80))
        rule = sorted(proxier.table.by_port[key].endpoints) if key else []
        want = sorted(f"{p['status']['podIP']}:80" for p in web_pods())
        if rule != want:
            fail(f"phase 16: the rule for {vip}:80 holds {len(rule)} "
                 f"endpoints, not the {len(want)} pods' ip:port")
        out["endpoints"] = len(rule)
        out["distinct_pod_ips"] = len(set(rule))
        with urllib.request.urlopen(
                f"http://127.0.0.1:{hz.port}/healthz", timeout=10) as r:
            out["healthz"] = r.status
        if out["healthz"] != 200:
            fail(f"phase 16: the proxier's /healthz answered {r.status}")
        out["proxy_s"] = time.perf_counter() - t0

        # 16d: the metrics server over the hollow kubelets, kubectl top
        t0 = time.perf_counter()
        ms = api.MetricsServer(client, kubelets=cluster.hollow.kubelets)
        ms.install()
        ms.scrape_once()
        out["top_rows"] = {
            kind: len(kubectl("top", kind).splitlines()) - 1
            for kind in ("nodes", "pods")}
        if out["top_rows"] != {"nodes": n_nodes, "pods": replicas}:
            fail(f"phase 16: kubectl top rows {out['top_rows']}")
        out["top_s"] = time.perf_counter() - t0

        # 16e: upgrade plan and apply; the scheduler restarts
        t0 = time.perf_counter()
        plan = cluster.upgrade_plan(CLUSTER_UPGRADE_TO)
        if not plan["canUpgrade"]:
            fail(f"phase 16: upgrade plan refused: {plan['reason']}")
        first = cluster.scheduler
        out["upgrade_phases"] = cluster.upgrade_apply(
            CLUSTER_UPGRADE_TO)["phases"]
        if cluster.scheduler is first:
            fail("phase 16: upgrade_apply kept the old scheduler")
        api.made.append(cluster.scheduler.scheduler)
        out["restarted_device"] = str(getattr(
            cluster.scheduler.scheduler, "device", "jax"))
        out["version"] = cluster.current_version()
        out["upgrade_s"] = time.perf_counter() - t0

        # 16f: join, then kubectl scale; the restarted scheduler places
        t0 = time.perf_counter()
        joined = cluster.join(CLUSTER_JOIN)
        names = [k.node_name for k in joined.kubelets]
        _cluster_wait(lambda: set(names) <= ready_nodes(),
                      f"the joined nodes {names} Ready")
        kubectl("scale", "deployment/web", "--replicas", str(scaled))
        kubectl("rollout", "status", "deployment/web", "--timeout",
                f"{CLUSTER_TIMEOUT_S:g}")
        _cluster_wait(lambda: all_running(scaled),
                      f"{scaled} pods Running and Ready")
        out["scale_s"] = time.perf_counter() - t0
        out["per_node_16f"] = placement(scaled, n_nodes + CLUSTER_JOIN,
                                        "after 16f")
        out["joined"] = {n: out["per_node_16f"][n] for n in names}
        out["restarted_scheduled"] = sum(
            (r.get("stats") or {}).get("scheduled", 0) for r in
            cluster.scheduler.scheduler.telemetry.recorder.records())
        if out["restarted_scheduled"] != scaled - replicas:
            fail(f"phase 16: the restarted scheduler bound "
                 f"{out['restarted_scheduled']} pods, not "
                 f"{scaled - replicas}")
        out["status_16f"] = deployment_status(client)
        out["phase_s"] = time.perf_counter() - t_phase
        if taints.tainted:
            fail(f"phase 16: the node lifecycle controller tainted "
                 f"{len(taints.tainted)} hollow nodes: "
                 f"{dict(list(taints.tainted.items())[:5])}")
        out["sync_errors"] = {n: len(c.sync_errors)
                              for n, c in cluster.manager.controllers.items()}
        return out
    finally:
        for x in (ms, hz, taints):
            if x is not None:
                x.stop()
        if factory is not None:
            factory.stop()
        if cluster is not None:
            cluster.down()
        errs.restore()
        if errs.errors:
            fail(f"phase 16: {len(errs.errors)} threads raised: "
                 f"{errs.errors[:3]}")


def cluster_reference(out) -> dict:
    """What phase 16 holds the port to: the JAX package's run, all of it
    timing-free."""
    def counts(held):
        hist = {}
        for n in held.values():
            hist[str(n)] = hist.get(str(n), 0) + 1
        return {"nodes_by_count": dict(sorted(hist.items())),
                "sha256": placement_sha256(
                    (k, str(v)) for k, v in held.items())}
    return json.loads(json.dumps({
        "per_node_16b": counts(out["per_node_16b"]),
        "per_node_16f": counts(out["per_node_16f"]),
        "joined": out["joined"], "endpoints": out["endpoints"],
        "top_rows": out["top_rows"], "upgrade_phases": out["upgrade_phases"],
        "apply": out["apply"], "status_16b": out["status_16b"],
        "status_16f": out["status_16f"]}))


def cluster_phase(device, card: str) -> dict:
    """Phase 16 on the card: cluster_drive with the port's Cluster on
    `device` (its scheduler, and the one upgrade_apply restarts), held
    against JAX_CLUSTER; K1 and K2 launched in its waves, their first
    launches held against the plain versions. Launch counts set to 0 just
    before the cluster comes up, read just after the drive."""
    import tempfile

    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops import preempt as OP
    from kubernetes_tpu_torch.ops import waves as W

    have = {}
    for mod in ("yaml", "cryptography"):
        try:
            __import__(mod)
            have[mod] = "yes"
        except ImportError:
            have[mod] = "no"
    print(f"  16: import yaml: {have['yaml']}; import cryptography: "
          f"{have['cryptography']} (joins are token-only: no CSR "
          f"controller runs)")
    api = port_server_api(device)
    recs = {}

    def mark():
        recs["16"] = [Recorder(W, "contention_scan"),
                      Recorder(W, "domain_rank"),
                      Recorder(OP, "reprieve_scan")]
        K.reset_launch_counts()

    try:
        with tempfile.TemporaryDirectory() as workdir:
            out = cluster_drive(api, workdir, mark=mark)
    finally:
        counts = {"16": K.launch_counts()}
        for r in recs.get("16", []):
            r.restore()
    got = cluster_reference(out)
    if got != JAX_CLUSTER:
        fail(f"phase 16 differs from JAX_CLUSTER: {got} != {JAX_CLUSTER}")
    if out["restarted_device"] != str(device.type):
        fail(f"phase 16: the restarted scheduler runs on "
             f"{out['restarted_device']}, not {device.type}")
    if device.type == "cuda" and not all(
            counts["16"].get(n, 0) for n in WAVE_KERNELS):
        fail(f"phase 16: K1/K2 not launched: {counts['16']}")
    errs = server_kernel_check(recs, counts, device)
    settle(api, "16")
    if out["phase_s"] > CLUSTER_BUDGET_S:
        fail(f"phase 16 took {out['phase_s']:.1f} s, over its "
             f"{CLUSTER_BUDGET_S:.0f} s")
    print(f"  16a: Cluster up in {out['up_s']:.3f} s ({out['threads']} "
          f"threads), {out['nodes']} hollow nodes Ready "
          f"{out['nodes_ready_s']:.3f} s later ({card})")
    print(f"  16b: kubectl apply {out['apply']}; rollout status "
          f"{out['rollout_s']:.3f} s, all {out['replicas']} Running and "
          f"Ready {out['running_s']:.3f} s after the apply; "
          f"{out['replicas'] // out['nodes']} on every node; no overcommit")
    print(f"  16c: the rule for web's VIP:80 holds the {out['endpoints']} "
          f"pods' ip:port ({out['distinct_pod_ips']} distinct: each hollow "
          f"node's FakeCRI numbers its own sandboxes); /healthz "
          f"{out['healthz']}; {out['proxy_s']:.3f} s")
    print(f"  16d: kubectl top rows {out['top_rows']} in "
          f"{out['top_s']:.3f} s")
    print(f"  16e: upgrade to {out['version']}: {out['upgrade_phases']}; "
          f"the restarted scheduler on {out['restarted_device']}; "
          f"{out['upgrade_s']:.3f} s")
    print(f"  16f: joined {out['joined']} (pods each), scaled to "
          f"{sum(out['per_node_16f'].values())}, the restarted scheduler "
          f"bound {out['restarted_scheduled']}; {out['scale_s']:.3f} s; "
          f"phase {out['phase_s']:.3f} s; launches {counts['16']}; no taint, "
          f"no thread raised; controller sync errors {out['sync_errors']} "
          f"({card})")
    print("    the placements, the rule, the top rows, the upgrade phases "
          "and the Deployment's status equal JAX_CLUSTER")
    return dict(out=out, launches=counts, errs=errs)


# ---------------------------------------------------------------------- #
# phase 17: node-axis sharding of the single cluster (parallel/mesh.py)
# ---------------------------------------------------------------------- #

def node_sha256(node) -> str:
    """sha256 of a node map (int32, little-endian): a torch tensor or an
    array of either package."""
    import numpy as np

    a = node.cpu().numpy() if hasattr(node, "cpu") else np.asarray(node)
    return hashlib.sha256(a.astype("<i4").tobytes()).hexdigest()


def mesh_reference(report: dict) -> dict:
    """The port's dryrun report (parallel/dryrun.py run_dryrun) in the
    shape of JAX_MESH: per rung the engine, sizes, scheduled count,
    rejected gang groups and node-map sha256."""
    out = {}
    for row in report["rungs"]:
        key = (f"spec_{row['engine']}" if row["rung"] == "spec"
               else row["rung"])
        out[key] = {k: row[k] for k in ("engine", "nodes", "pods",
                                        "scheduled", "rejected_gangs",
                                        "sha256") if k in row}
    return out


# the mesh of phase 17: 4 shards on the one card (a virtual mesh)
MESH_SHARDS = 4
# 17a's production and bench rungs (the JAX package's dryrun shapes)
MESH_PRODUCTION = (4096, 8192)
MESH_BENCH_PODS = 50000
# 17b: the serving drain on the mesh (5b's cluster, waves of 4,096): 6 full
# waves and a micro wave (cut from 8 for phase 18's time); the drill's
# faults by dispatch of the "cycle" kind (a loss at the 2nd, the first
# reform forced narrow, a loss at the 5th, whose reform the full-width
# probe lets back to 4 for the 6th)
MESH_PODS, MESH_BATCH = 24576, SERVING_BATCH
MESH_FAULTS = ("device.error@cycle:2,mesh.degrade@probe:1,"
               "device.error@cycle:5")
# 17c: one preemption burst of PREEMPT_BURST whole-node vips on 17b's
# resident mesh
MESH_VIP_CPU = "32"  # a whole node: every candidate needs victims
MESH_KERNELS = ("contention_scan", "domain_rank", "reprieve_scan",
                "assign_scan")
# the JAX package's mesh runs at these shapes, on a 4-device virtual CPU
# mesh, each bit-equal to its unsharded run: JAX_PLATFORMS=cpu python3
# scripts/flagship_reference.py --package jax --path mesh
JAX_MESH = {
    "spec_waves": {"nodes": 32, "pods": 64, "scheduled": 43,
                   "sha256": "8659ab61214486dce0c25ad01e616f8e"
                             "92929df7c386b8833dd91d16bd1a5ac0"},
    "spec_scan": {"nodes": 32, "pods": 64, "scheduled": 43,
                  "sha256": "48ed7643ddcc582d92b12050c63d30e0"
                            "9cc7b4ad7860527fc3f649a9a4c5f881"},
    "production": {"nodes": 4096, "pods": 8192, "scheduled": 6739,
                   "rejected_gangs": 3,
                   "sha256": "ef84ce82d55f71d94aa924e785598907"
                             "a9c8757e08bcf7d4628f3846688471a3"},
    "bench": {"nodes": 5120, "pods": 50000, "scheduled": 33334,
              "sha256": "22514eb6c485fc81c4ebb4edcd0b2618"
                        "e14356f0b0a2b9c7522c57995ebea909"},
}


class MeshKernelSpy:
    """Keeps, for each kernel, the inputs and output of its FIRST launch
    inside a sharded run (a shard's launch, or the lead shard's in a lead
    step: parallel/axis.py `in_mesh`), and counts those launches. Installed
    by patching the names the engines call (ops/waves.py K1/K2,
    ops/preempt.py K3, ops/assign.py K4); the wrappers' own counters stay
    the phase's launch counts."""

    def __init__(self):
        from kubernetes_tpu_torch.ops import assign as A
        from kubernetes_tpu_torch.ops import preempt as Pr
        from kubernetes_tpu_torch.ops import runs as RN
        from kubernetes_tpu_torch.ops import waves as W
        from kubernetes_tpu_torch.parallel import axis

        # K4 under both names the engines call it by: ops/assign.py's
        # (the scan) and ops/runs.py's (the runs engine's fallback runs)
        self.sites = [(W, "contention_scan"), (W, "domain_rank"),
                      (Pr, "reprieve_scan"), (A, "assign_scan"),
                      (RN, "assign_scan")]
        self.saved = [(m, n, getattr(m, n)) for m, n in self.sites]
        self.first, self.mesh_launches = {}, {n: 0 for n in MESH_KERNELS}

        def spy(name, fn):
            def run(*args):
                out = fn(*args)
                if axis.current().in_mesh:
                    self.mesh_launches[name] += 1
                    if name not in self.first:
                        self.first[name] = (own(args), own(out))
                return out
            return run

        for m, n, fn in self.saved:
            setattr(m, n, spy(n, fn))

    def restore(self):
        for m, n, fn in self.saved:
            setattr(m, n, fn)

    def check(self, device, phase: str = "phase 17") -> dict:
        """Each first mesh launch against its plain version on the same
        inputs, exactly; returns the max abs error by kernel (None where
        the kernel did not launch on the mesh)."""
        from kubernetes_tpu_torch.ops import kernels as K
        from kubernetes_tpu_torch.ops.assign import assign_scan_plain

        plain = {"contention_scan": (K.contention_scan_plain, k1_diff),
                 "domain_rank": (K.domain_rank_plain, k2_diff),
                 "reprieve_scan": (K.reprieve_scan_plain, k3_diff),
                 "assign_scan": (assign_scan_plain, k4_diff)}
        errs = {}
        for name in MESH_KERNELS:
            if name not in self.first:
                errs[name] = None
                continue
            args, out = self.first[name]
            fn, diff = plain[name]
            errs[name] = diff(out, fn(*args))
            sync(device)
            if errs[name] != 0:
                fail(f"{phase}: {name}'s first mesh launch disagrees with "
                     f"its plain version (max_abs_err={errs[name]})")
        return errs


def mesh_drill_hooks(widths):
    """17b's drill: after every wave, wait for the prober's re-admission
    (the reform happens there) and note the mesh width."""
    def after(w, s):
        if not s.supervisor.healthy and not s.supervisor.wait_recovered(60):
            fail("17b: the prober did not re-admit the card")
        widths.append(s.mesh_state.n_devices)
    return after


def mesh_events(api, base_dims=None):
    """17b's Scheduler setup: every wave's dispatch is followed, while the
    device runs it, by an informer update of one node with unchanged
    content (the deltas a live cluster streams in mid-wave) — so the mesh
    prestage has rows to patch while the dispatch holds the resident
    planes; and, given, `base_dims` as the capacity floor."""
    nodes = api.workloads.make_nodes(SERVING_NODES)

    def setup(s):
        if base_dims is not None:
            s.base_dims = base_dims
        submit, n = s.supervisor.submit, [0]

        def during(kind, key, fn, fallback=None):
            h = submit(kind, key, fn, fallback)
            if kind == "cycle":
                s.on_node_update(nodes[(7 * n[0]) % len(nodes)])
                n[0] += 1
            return h
        s.supervisor.submit = during
    return setup


def mesh_serving(device, card: str) -> dict:
    """17b: phase 5b's drain (make_nodes(5000), waves of 4,096,
    MESH_PODS flagship pods, informer confirmations and a node update
    between waves and one during each, a 3-pod micro wave) three times on
    the card: with mesh=None; on a MeshState over MESH_SHARDS × the card
    (every wave sharded, the node planes resident per shard) with the
    capacities the first run ended at as its floor, so the one full upload
    is the cold one; and on the mesh again under MESH_FAULTS with
    fallback_device='cpu' (a loss → the wave on the CPU → a reform at half
    width; a second loss → a reform at full width). All three bind the
    same pods to the same nodes."""
    import os

    import torch

    from kubernetes_tpu_torch.parallel.mesh import MeshState

    api = port_serving_api(device)
    pool = [device] * MESH_SHARDS
    out = {}
    keep = []
    t0 = time.perf_counter()
    ref = serving_drain(api, SERVING_NODES, MESH_PODS, MESH_BATCH, keep=keep,
                        setup=mesh_events(api))
    out["single_s"] = time.perf_counter() - t0
    single = keep[0]
    top = single.cache._snapshot.dims
    keep = []
    t0 = time.perf_counter()
    got = serving_drain(api, SERVING_NODES, MESH_PODS, MESH_BATCH, keep=keep,
                        setup=mesh_events(api, top),
                        sched_kw={"mesh": MeshState(MESH_SHARDS,
                                                    devices=pool)})
    out["mesh_s"] = time.perf_counter() - t0
    s = keep[0]
    if (got["bound"], got["bound_sha256"]) != (ref["bound"],
                                               ref["bound_sha256"]):
        fail("17b: the mesh drain's placements differ from mesh=None's")
    if [w["scheduled"] for w in got["waves"]] != \
            [w["scheduled"] for w in ref["waves"]]:
        fail("17b: the mesh drain's waves differ from mesh=None's")
    c = s.cache
    out["resident"] = dict(full_uploads=c.resident_full_uploads,
                           in_place_patches=c.resident_donated_patches,
                           copy_patches=c.resident_copy_patches)
    if c.resident_full_uploads != 1 or c.resident_donated_patches < 3 \
            or c.resident_copy_patches < 1 or c._dispatch_inflight:
        fail(f"17b: resident counters {out['resident']}")
    print(f"  mesh=None {out['single_s']:.1f} s, mesh of {MESH_SHARDS} "
          f"{out['mesh_s']:.1f} s: {got['bound']} bound, placements and "
          f"per-wave counts equal; resident {out['resident']}")
    out["waves"] = [dict(w) for w in got["waves"]]
    # per wave, the snapshot (the resident patches) and the dispatch to its
    # readback, with mesh=None and on the mesh
    out["split"] = {k: {"snapshot_s": _phase_durations(x, "snapshot"),
                        "dispatch_s": _phase_durations(x, "dispatch"),
                        "readback_s": _phase_durations(x, "readback")}
                    for k, x in (("single", single), ("mesh", s))}

    # the drill, under 9b's supervisor knobs
    fl = api.faultline
    saved = {k: os.environ.get(k) for k in SUPERVISOR_ENV}
    os.environ.update(SUPERVISOR_ENV)
    widths, keep = [], []
    ms = MeshState(MESH_SHARDS, devices=pool)
    fl.install(MESH_FAULTS)
    t0 = time.perf_counter()
    try:
        drill = serving_drain(
            api, SERVING_NODES, MESH_PODS, MESH_BATCH, keep=keep,
            setup=mesh_events(api, top), after_wave=mesh_drill_hooks(widths),
            sched_kw={"mesh": ms, "fallback_device": torch.device("cpu")})
    finally:
        fl.uninstall()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["drill_s"] = time.perf_counter() - t0
    st = keep[0].supervisor.stats
    out["drill"] = dict(widths=widths, demotions=ms.demotions,
                        reforms=ms.reforms,
                        degraded_cycles=st.degraded_cycles,
                        degraded_cycle_seconds=st.degraded_cycle_seconds,
                        recoveries=st.recoveries,
                        full_uploads=keep[0].cache.resident_full_uploads)
    if (drill["bound"], drill["bound_sha256"]) != (ref["bound"],
                                                   ref["bound_sha256"]):
        fail("17b: the drill's placements differ from mesh=None's")
    if ms.demotions != 2 or ms.reforms != 2 or 2 not in widths \
            or widths[-1] != MESH_SHARDS or st.degraded_cycles < 2:
        fail(f"17b: the drill's mesh ladder {out['drill']}")
    print(f"  drill ({MESH_FAULTS}): widths by wave {widths}, "
          f"{st.degraded_cycles} waves on the CPU "
          f"({', '.join(f'{x:.2f}' for x in st.degraded_cycle_seconds)} s), "
          f"every pod bound once, placements equal to mesh=None's "
          f"({out['drill_s']:.1f} s)")
    settle(api, "17b", fallback_ok=True)
    return dict(out, sched=s)


def mesh_preempt(device, s) -> dict:
    """17c: one preemption burst (PREEMPT_BURST vips of MESH_VIP_CPU cpu,
    priority 1000) on 17b's scheduler: its snapshot resident on the mesh,
    the burst sharded (K3 on each shard's nodes, the node choice on the
    lead) against the same burst on the gathered tables."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.api import types as T
    from kubernetes_tpu_torch.sched.cycle import UNSCHEDULABLE_TAINT_KEY
    from kubernetes_tpu_torch.sched.preemption import PREEMPT_BURST, _preempt

    # a priority-0 filler bound on every node, so no node is empty and
    # every candidate needs victims
    for i, name in enumerate(s.cache._node_names):
        if name:
            s.on_pod_add(T.Pod(name=f"mesh-filler{i}", node_name=name,
                               requests=T.Resources.make(cpu="100m"),
                               creation_index=9_000_000 + i))
    vips = [T.Pod(name=f"mesh-vip{i}", priority=1000,
                  requests=T.Resources.make(cpu=MESH_VIP_CPU, memory="1Gi"),
                  creation_index=10_000_000 + i)
            for i in range(PREEMPT_BURST)]
    snap = s._preempt_snapshot(vips)
    if snap.mesh is None:
        fail("17c: the scheduler's snapshot is not on the mesh")
    keys = (s.encoder.vocabs.label_keys.get(UNSCHEDULABLE_TAINT_KEY),
            s.encoder.vocabs.label_vals.get(""))
    lane = torch.arange(PREEMPT_BURST, device=device)
    args = (snap.pending.cls[lane].contiguous(),
            snap.pending.node_name_req[lane].contiguous(),
            torch.full((PREEMPT_BURST,), 1000, dtype=torch.int32,
                       device=device), snap.dims.D, keys,
            torch.zeros(snap.existing.valid.shape, dtype=torch.bool,
                        device=device))
    t0 = time.perf_counter()
    got = _preempt(snap.tables, snap.existing, *args)
    sync(device)
    mesh_s = time.perf_counter() - t0
    ref = _preempt(snap.tables.gather(), snap.existing, *args)
    sync(device)
    for f in ref._fields:
        if not torch.equal(getattr(ref, f), getattr(got, f)):
            fail(f"17c: the sharded burst's {f} differs from the gathered")
    nodes = got.node.cpu().numpy()
    print(f"  burst of {PREEMPT_BURST}: nodes {nodes.tolist()}, "
          f"{int(got.victims.sum())} victims, equal to the burst on the "
          f"gathered tables ({mesh_s * 1e3:.1f} ms sharded)")
    if not (nodes >= 0).any() or not bool(got.victims.any()):
        fail("17c: no vip found a node with victims")
    return dict(nodes=nodes.tolist(), victims=int(got.victims.sum()),
                sharded_ms=mesh_s * 1e3)


def mesh_phase(device, card: str) -> dict:
    """Phase 17 on the card: 17a the dryrun's three rungs on a mesh of
    MESH_SHARDS × the card, each bit-equal to the unsharded run and equal
    to JAX_MESH; 17b the serving Scheduler on the mesh (mesh_serving); 17c a
    preemption burst on it (mesh_preempt). K1–K4's launches are counted
    over the phase, each kernel's first mesh launch held against its plain
    version."""
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel.dryrun import run_dryrun

    spy = MeshKernelSpy()
    launches = {}
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        rep = run_dryrun(devices=[device] * MESH_SHARDS, device=device,
                         production=MESH_PRODUCTION,
                         bench_pods=MESH_BENCH_PODS,
                         log=lambda line: print("  " + line))
        a_s = time.perf_counter() - t0
        launches["17a"] = K.launch_counts()
        for row in rep["rungs"]:
            key = (f"spec_{row['engine']}" if row["rung"] == "spec"
                   else row["rung"])
            want = JAX_MESH[key]
            for f in ("nodes", "pods", "scheduled", "rejected_gangs",
                      "sha256"):
                if f in want and row.get(f) != want[f]:
                    fail(f"17a: {key}'s {f} {row.get(f)} differs from "
                         f"JAX_MESH's {want[f]}")
            c = row["collectives"]
            print(f"    {key}: equal to JAX_MESH; sharded launches "
                  f"{row['sharded_launches']}; collectives "
                  f"{c['all_reduce']} all-reduce ({c['all_reduce_bytes']} B), "
                  f"{c['gather']} gathers ({c['gather_bytes']} B), "
                  f"{c['lead']} lead steps ({c['lead_bytes']} B out); the "
                  f"lead shard waited {c['wait_s']:.3f} s in them and ran "
                  f"lead steps {c['lead_s']:.3f} s")
        print(f"    17a {a_s:.1f} s ({card})")
        K.reset_launch_counts()
        t0 = time.perf_counter()
        print(f"[17b] Scheduler(mesh=MeshState({MESH_SHARDS}, devices="
              f"[{device}] * {MESH_SHARDS})) on make_nodes({SERVING_NODES}), "
              f"{MESH_PODS} flagship pods in waves of {MESH_BATCH}, "
              f"against mesh=None; then the loss → reform drill")
        serving = mesh_serving(device, card)
        launches["17b"] = K.launch_counts()
        K.reset_launch_counts()
        print(f"[17c] a preemption burst on 17b's mesh-resident snapshot")
        pre = mesh_preempt(device, serving.pop("sched"))
        launches["17c"] = K.launch_counts()
        b_s = time.perf_counter() - t0
    finally:
        spy.restore()
    errs = spy.check(device)
    for name in MESH_KERNELS:
        if spy.mesh_launches[name] == 0:
            fail(f"phase 17: {name} never launched on the mesh")
    total = {n: sum(v[n] for v in launches.values()) for n in MESH_KERNELS}
    print(f"    launches 17a {launches['17a']}, 17b {launches['17b']}, 17c "
          f"{launches['17c']}; on the mesh {spy.mesh_launches}; first mesh "
          f"launches equal to the plain versions {errs}; 17b+c {b_s:.1f} s")
    return dict(rungs=rep["rungs"], memory=rep["memory"], dryrun_s=a_s,
                serving=serving, preempt=pre, launches=launches,
                total=total, mesh_launches=spy.mesh_launches, errs=errs)


# --------------------------------------------------------------------------- #
# phase 18: the fleet mesh
# --------------------------------------------------------------------------- #

# 18a: phase 12a's workload on bench.py's fleet-flagship layout, the (4, 2)
# tenant × node-shard grid over 8 × the card; 18b: the 1-D tenant mesh over
# the same 8 × the card on t00–t07 (one tenant a device row)
FLEET_MESH_DEVICES, FLEET_MESH_NODE_SHARDS = 8, 2
FLEET_1D_TENANTS = 8
FLEET_MESH_KERNELS = ("contention_scan", "domain_rank", "assign_scan")


def fleet_mesh_run(api, pool, node_shards: int, names=None,
                   after_tick=None, grid_runs=None) -> tuple:
    """fleet_run on a fleet mesh of len(pool) devices, `node_shards` wide
    rows, with every grid run's collective tally (parallel/axis.py
    LAST_RUN after each spmd_grid) appended in order to `grid_runs`.
    Returns (the outcome, grid_runs)."""
    from kubernetes_tpu_torch.parallel import axis

    grid_runs = [] if grid_runs is None else grid_runs
    orig = axis.spmd_grid

    def counted(*a, **kw):
        try:
            return orig(*a, **kw)
        finally:
            grid_runs.append(dict(axis.LAST_RUN,
                                  rows=[dict(r) for r in
                                        axis.LAST_RUN.get("rows", [])]))

    axis.spmd_grid = counted
    try:
        out = fleet_run(api, names=names, after_tick=after_tick,
                        fleet_kw=dict(mesh=len(pool), node_shards=node_shards,
                                      mesh_devices=pool))
    finally:
        axis.spmd_grid = orig
    return out, grid_runs


def row_tally(runs) -> list:
    """Per tenant row, the collectives of `runs` (grid runs' LAST_RUN
    copies) summed: [all-reduces, gathers, lead steps, bytes moved]."""
    if not runs:
        return []
    out = []
    for r in range(len(runs[0]["rows"])):
        rows = [x["rows"][r] for x in runs]
        out.append([sum(x[k] for x in rows)
                    for k in ("all_reduce", "gather", "lead")]
                   + [sum(x[k] for x in rows
                          for k in ("all_reduce_bytes", "gather_bytes",
                                    "lead_bytes"))])
    return out


def fleet_mesh_drill(device, pool) -> dict:
    """18c: test_fleet.py's degrade → reform drill under the 2-D signature
    on the card: tenants a and b (2 nodes, 4 pods each) on the (4, 2) grid
    over `pool` with fallback_device='cpu'; one tick; a backend loss (the
    re-admission probe pinned to fail) drops the whole grid and the
    degraded tick serves through the CPU without touching the resident
    stack; re-admission reforms the grid 2-D and the server adopts it;
    every pod is bound exactly once."""
    import os

    import torch

    from kubernetes_tpu_torch.fleet.tables import _leaves
    from kubernetes_tpu_torch.parallel.mesh import fleet_mesh_shape

    api = port_fleet_api(device)
    T = api.types
    clk = {"t": 0.0}
    saved = os.environ.get("KTPU_PROBE_BACKOFF")
    os.environ["KTPU_PROBE_BACKOFF"] = "0.05"
    srv = api.fleet(batch_size=16, clock=lambda: clk["t"], mesh=len(pool),
                    node_shards=FLEET_MESH_NODE_SHARDS, mesh_devices=pool,
                    fallback_device="cpu")

    def feed(name, prefix, n):
        for i in range(n):
            srv.tenant(name).on_pod_add(T.Pod(
                name=f"{prefix}-p{i}", creation_index=i,
                requests=T.Resources.make(cpu="100m", memory="8Mi")))

    def tick():
        tk = srv.tick()
        clk["t"] += 1.0
        return tk

    binders = {}
    try:
        for name in ("a", "b"):
            binders[name] = api.RecordingBinder()
            srv.add_tenant(name, binder=binders[name])
            for i in range(2):
                srv.tenant(name).on_node_add(T.Node(
                    name=f"n{i}", allocatable=T.Resources.make(
                        cpu="8", memory="16Gi", pods=110)))
            feed(name, name, 4)
        shape0 = fleet_mesh_shape(srv.mesh)
        tick()
        held = [(x, x.clone()) for c in srv.stack.block.cells
                for x in _leaves(c)]
        api.faultline.install("device.error@probe:1+")
        try:
            srv.supervisor._mark_unhealthy("injected backend loss")
            dropped = srv.mesh_state.mesh is None
            feed("a", "a2", 3)
            tk = tick()
            degraded = dict(mesh=srv.mesh, block=srv.stack.block,
                            scheduled=tk.per_tenant["a"].scheduled)
        finally:
            api.faultline.uninstall()
        untouched = all(torch.equal(x, y) for x, y in held)
        srv.supervisor._readmit()
        if srv.supervisor._prober is not None:
            srv.supervisor._prober.join(timeout=10)
        feed("b", "b2", 2)
        for _ in range(4):
            tick()
            if all(t.sched.queue.lengths()[0] == 0
                   for t in srv.tenants.values()):
                break
    finally:
        if saved is None:
            os.environ.pop("KTPU_PROBE_BACKOFF", None)
        else:
            os.environ["KTPU_PROBE_BACKOFF"] = saved
    counts = {n: len(b.bound) for n, b in binders.items()}
    double = sum(len(b.bound) - len({k for k, _ in b.bound})
                 for b in binders.values())
    out = dict(shape=list(shape0), dropped=dropped, untouched=untouched,
               degraded_scheduled=degraded["scheduled"],
               reformed=list(fleet_mesh_shape(srv.mesh)) if srv.mesh
               else None, adopted=srv.mesh is srv.mesh_state.mesh,
               reforms=srv.mesh_state.reforms,
               degraded_cycles=srv.supervisor.stats.degraded_cycles,
               bound=counts, double_bound=double)
    if (shape0 != (4, 2) or not dropped or degraded["mesh"] is not None
            or degraded["block"] is not None or degraded["scheduled"] < 1
            or not untouched or out["reformed"] != [4, 2]
            or not out["adopted"] or counts != {"a": 7, "b": 6} or double):
        fail(f"18c: the drill {out}")
    return out


def fleet_mesh_phase(device, card: str, ref_tenants=None) -> dict:
    """Phase 18 on the card: 18a phase 12a's 24 tenants on the (4, 2) grid
    over FLEET_MESH_DEVICES × the card against JAX_FLEET (and against 12a's
    one-device run, `ref_tenants`, when this interpreter ran it), one
    dispatch per engine group per tick, K1, K2 and K4 launched in the grid's
    threads with each first launch held against its plain version, the
    per-row collectives per tick; 18b the 1-D tenant mesh on t00–t07, no
    collective, each tenant against JAX_FLEET; 18c the degrade → reform
    drill (fleet_mesh_drill)."""
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel.mesh import (fleet_mesh_shape,
                                                    padded_tenant_count)

    if JAX_FLEET is None:
        fail("phase 18: JAX_FLEET is not recorded")
    api = port_fleet_api(device)
    pool = [device] * FLEET_MESH_DEVICES
    t0 = time.perf_counter()
    spy = MeshKernelSpy()
    marks, runs = [], []
    K.reset_launch_counts()
    try:
        a, runs = fleet_mesh_run(
            api, pool, FLEET_MESH_NODE_SHARDS, grid_runs=runs,
            after_tick=lambda i, tk: marks.append(
                (K.launch_counts(), len(runs))))
    finally:
        counts = K.launch_counts()
        spy.restore()
    a_s = time.perf_counter() - t0
    errs = spy.check(device, "18a")
    check_fleet(a, "18a")
    for k in ("tenants", "scheduled", "t00_drf_clamped", "tick1_drf"):
        if a[k] != JAX_FLEET[k]:
            fail(f"18a: {k} differs from JAX_FLEET: {a[k]} != "
                 f"{JAX_FLEET[k]}")
    if ref_tenants is not None and a["tenants"] != ref_tenants:
        fail("18a: the grid's tenants differ from 12a's one-device run")
    srv = a["srv"]
    ks = {e: st.K for e, st in srv.stacks.items()}
    kt, kn = fleet_mesh_shape(srv.mesh)
    if (kt, kn) != (4, 2):
        fail(f"18a: the mesh is {kt} x {kn}, not 4 x 2")
    # each group's live tenants padded to a multiple of the tenant rows
    # (8 of 8 at 24 tenants)
    want_k = {e: padded_tenant_count(
        sum(fleet_engine(n) == e for n in a["tenants"]), kt)
        for e in FLEET_ENGINES}
    if srv.max_engine_groups != 3 or srv.max_dispatches_per_tick != 3 \
            or ks != want_k:
        fail(f"18a: groups {srv.max_engine_groups}, dispatches a tick "
             f"{srv.max_dispatches_per_tick}, stack K by group {ks}")
    for name in FLEET_MESH_KERNELS:
        if not spy.mesh_launches[name]:
            fail(f"18a: {name} never launched in the grid's threads")
    stacks = srv.stacks.values()
    patches = dict(full_restacks=sum(st.full_restacks for st in stacks),
                   in_place=sum(st.donated_patches for st in stacks),
                   copy=sum(st.copy_patches for st in stacks))
    ticks = a["ticks"]
    bounds = [0] + [m[1] for m in marks]
    per_tick_rows = [row_tally(runs[bounds[i]:bounds[i + 1]])
                     for i in range(len(ticks))]
    launches = [{k: c[k] - (marks[i - 1][0][k] if i else 0)
                 for k in FLEET_MESH_KERNELS}
                for i, (c, _) in enumerate(marks)]
    print(f"  18a: {FLEET_TENANTS} tenants x {FLEET_NODES} nodes x "
          f"{FLEET_PODS} pods on the {kt} x {kn} grid over "
          f"{FLEET_MESH_DEVICES} x {device}: ticks scheduled "
          f"{a['scheduled']} in {[round(t.tick_seconds, 3) for t in ticks]}"
          f" s (the group dispatches' CUDA-event windows "
          f"{[round(t.execute_seconds, 3) for t in ticks]} s); every "
          f"tenant's hash, the counts, t00's {a['t00_drf_clamped']} clamped "
          f"and tick 1's DRF rows equal JAX_FLEET"
          + (" and 12a's one-device run" if ref_tenants else "")
          + f"; (dispatches, groups) per tick {a['dispatches_per_group']}, "
          f"stack K by group {ks}; 0 violations, 0 cross-tenant, 0 lost, "
          f"0 double ({card})")
    print(f"    per tick, per tenant row [all-reduces, gathers, lead steps, "
          f"bytes]: {per_tick_rows}")
    print(f"    launches per tick {launches}; in the grid's threads "
          f"{spy.mesh_launches}; first grid launches equal to the plain "
          f"versions {errs}; stack {patches}")
    print("    steady tick's split (the fleet-tick spans, s): "
          + ", ".join(f"{p} {dt:.3f}" for p, dt in tick_split(srv, 1)))

    t1 = time.perf_counter()
    names = [f"t{k:02d}" for k in range(min(FLEET_1D_TENANTS,
                                            FLEET_TENANTS))]
    b, b_runs = fleet_mesh_run(api, pool, 1, names=names)
    b_s = time.perf_counter() - t1
    check_fleet(b, "18b")
    want = {n: JAX_FLEET["tenants"][n] for n in names}
    if b["tenants"] != want:
        fail(f"18b: the tenant mesh's tenants differ from JAX_FLEET's: "
             f"{sorted(n for n in names if b['tenants'][n] != want[n])}")
    took = sum(x["exchanges"] + x["all_reduce"] + x["gather"] + x["lead"]
               for x in b_runs)
    if took or fleet_mesh_shape(b["srv"].mesh) != (FLEET_MESH_DEVICES, 1):
        fail(f"18b: {took} collectives on the 1-D tenant mesh")
    print(f"  18b: t00–t{len(names) - 1:02d} on the "
          f"{FLEET_MESH_DEVICES} x 1 tenant mesh: ticks scheduled "
          f"{b['scheduled']} in "
          f"{[round(t.tick_seconds, 3) for t in b['ticks']]} s, every "
          f"tenant's hash equal to JAX_FLEET's, 0 collectives in "
          f"{len(b_runs)} grid runs ({b_s:.1f} s)")
    settle_fleet(api, "18")

    t2 = time.perf_counter()
    c = fleet_mesh_drill(device, pool)
    c_s = time.perf_counter() - t2
    print(f"  18c: loss → narrow → full under the 2-D signature: {c} "
          f"({c_s:.1f} s)")
    return dict(a=dict(scheduled=a["scheduled"],
                       dispatches_per_group=a["dispatches_per_group"],
                       tick_s=[t.tick_seconds for t in ticks],
                       execute_s=[t.execute_seconds for t in ticks],
                       rows_per_tick=per_tick_rows, stack_k=ks,
                       patches=patches, split=tick_split(srv, 1),
                       wall_s=a_s),
                b=dict(scheduled=b["scheduled"],
                       tick_s=[t.tick_seconds for t in b["ticks"]],
                       wall_s=b_s),
                c=dict(c, wall_s=c_s), launches=counts,
                launches_per_tick=launches, grid_launches=spy.mesh_launches,
                errs=errs, wall_s=time.perf_counter() - t0)


T_START = time.perf_counter()
LINES_PATH = "build/chip_smoke_lines.jsonl"


class LineLog:
    """Standard output that also writes each complete line, as one JSON
    object {"t": seconds since the script started, "line": ...}, to
    LINES_PATH — a remote run's captured output may keep only its tail. A line
    opening with "[<phase>]" starts that phase; `summary()` gives each
    phase's seconds."""

    def __init__(self, out, path: str):
        import os

        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.out, self.file = out, open(path, "w")
        self.buf, self.starts = "", []

    def write(self, s: str) -> int:
        import re

        self.out.write(s)
        self.buf += s
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            t = time.perf_counter() - T_START
            m = re.match(r"\[(\w+)\]", line)
            if m:
                self.starts.append((m.group(1), t))
            self.file.write(json.dumps({"t": round(t, 3), "line": line})
                            + "\n")
            self.file.flush()
        return len(s)

    def flush(self) -> None:
        self.out.flush()
        self.file.flush()

    def summary(self) -> str:
        now = time.perf_counter() - T_START
        ends = [t for _, t in self.starts[1:]] + [now]
        parts = [f"[{p}] {e - t:.1f} s" for (p, t), e in
                 zip(self.starts, ends)]
        return (f"phase summary ({LINES_PATH}): " + ", ".join(parts)
                + f"; total {now:.1f} s")


def main() -> int:
    import os

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing to measure", file=sys.stderr)
        return 2
    from kubernetes_tpu_torch.ops import kernels as K

    line_log = LineLog(sys.stdout, LINES_PATH)
    sys.stdout = line_log

    device = torch.device("cuda", 0)
    card = card_line()
    print(f"[1] card: {card}")
    t0 = time.perf_counter()
    logs = K.build()
    build_s = time.perf_counter() - t0
    print(f"    kernel build {build_s:.2f} s (nvcc, {len(logs)} libraries, "
          f"built in parallel)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"    {name}: {line.strip()}")

    t15 = time.perf_counter()
    print(f"[15] the kubemark rollout: {KUBEMARK_NODES} hollow nodes "
          f"(HollowCluster), ControllerManager({KUBEMARK_CONTROLLERS}), "
          f"Deployment web of {KUBEMARK_REPLICAS} replicas spread over "
          f"{KUBEMARK_ZONES} zones and DaemonSet agent, placed by "
          f"SchedulerServer(device='cuda') behind the wave barrier")
    km = phase_subprocess("15")
    print(f"    phase 15 {time.perf_counter() - t15:.1f} s (its own "
          f"interpreter); the script so "
          f"far {time.perf_counter() - T_START:.1f} s ({card})")
    t16 = time.perf_counter()
    print(f"[16] the cluster and the CLI: Cluster(ClusterConfig("
          f"hollow_nodes={CLUSTER_NODES}, device='cuda', controllers="
          f"{CLUSTER_CONTROLLERS})), kubectl apply of the Deployment web "
          f"({CLUSTER_REPLICAS} replicas spread with maxSkew 1 over the "
          f"hostnames) and its Service as JSON manifests, the proxier, the "
          f"metrics server and kubectl top, upgrade to "
          f"{CLUSTER_UPGRADE_TO}, join {CLUSTER_JOIN} and kubectl scale")
    cl = phase_subprocess("16")
    print(f"    phase 16 {time.perf_counter() - t16:.1f} s (its own "
          f"interpreter); the script so "
          f"far {time.perf_counter() - T_START:.1f} s ({card})")
    print("[2] kernels against their plain versions on the card")
    errs = check_kernels(device, *edge_cases(device))
    k3_cases = dict(k3_edge_cases(device))
    errs["reprieve_scan"] = check_k3(device, list(k3_cases.items()))
    t0 = time.perf_counter()
    errs["assign_scan"] = check_k4(device, k4_edge_cases(device))
    check_k4_status(device)
    print(f"    K4's cases {time.perf_counter() - t0:.1f} s")

    print("[3] flagship cycle, 5000 nodes x 50000 pods, BatchScheduler(cuda)")
    from kubernetes_tpu_torch.models.workloads import flagship_pods, make_nodes

    res, launches, captured, cycle_s = run_cycle(
        device, make_nodes(5000), flagship_pods(50000), warm_runs=3,
        reference_device="cpu")
    if res.scheduled != JAX_SCHEDULED:
        fail(f"scheduled {res.scheduled} != the JAX package's {JAX_SCHEDULED}")
    if assignments_sha256(res.assignments) != JAX_ASSIGNMENTS_SHA256:
        fail("placements differ from the JAX package's (sha256)")
    print(f"    scheduled {res.scheduled} == JAX package's {JAX_SCHEDULED}; "
          f"placement sha256 equal; cycle {cycle_s * 1e3:.1f} ms (median of 3)")

    print("[3c] the flagship dispatch with explain=True, card and CPU")
    t0 = time.perf_counter()
    explain = explain_phase(device, make_nodes(5000), flagship_pods(50000))
    print(f"    phase 3c {time.perf_counter() - t0:.1f} s")

    print(f"[3b] port-and-volume cycle, {PV_NODES} nodes x {PV_PODS} pods, "
          f"BatchScheduler(cuda)")
    pv_res, pv_launches, pv_captured, _ = run_cycle(
        device, *port_volume_workload(PV_NODES, PV_PODS), warm_runs=0,
        reference_device="cpu")
    if pv_res.scheduled != PV_JAX_SCHEDULED:
        fail(f"port-and-volume cycle scheduled {pv_res.scheduled} != the JAX "
             f"package's {PV_JAX_SCHEDULED}")
    if assignments_sha256(pv_res.assignments) != PV_JAX_ASSIGNMENTS_SHA256:
        fail("port-and-volume placements differ from the JAX package's "
             "(sha256)")
    pv_k1 = check_real_words(device, pv_captured["contention_scan"])
    print(f"    scheduled {pv_res.scheduled} == JAX package's "
          f"{PV_JAX_SCHEDULED}; placement sha256 equal")

    print("[4] per-kernel times at the flagship cycle's shapes")
    rows = kernel_report(device, captured, launches, errs)
    pv_k1["launches"] = pv_launches["contention_scan"]
    pv_k1["ms"] = device_ms(
        lambda: K.contention_scan(*pv_captured["contention_scan"]), device)
    pv_k1["bound_ms"], pv_k1["bound_by"] = k1_bound(
        pv_captured["contention_scan"],
        K.contention_scan(*pv_captured["contention_scan"]))
    print(f"  contention_scan at the port-and-volume cycle's first wave "
          f"({pv_k1['variant']} variant): {pv_k1['ms']:.4f} ms on the device "
          f"(bound {pv_k1['bound_ms']:.6f} ms by {pv_k1['bound_by']}), "
          f"{pv_k1['launches']} launches in that cycle")

    serving = serving_phase(device)
    for r in rows:
        name = r["name"]
        args = serving["inputs"][name]
        fn = K.contention_scan if name == "contention_scan" else K.domain_rank
        r["serving"] = dict(
            launches_steady=serving["launches_a"][name],
            launches_drain=serving["launches_b"][name],
            max_abs_err=serving["errs"][name],
            ms=device_ms(lambda: fn(*args), device),
            shape=list(args[0].shape))
        r["max_abs_err"] = max(r["max_abs_err"], serving["errs"][name])
    print(f"[6] preemption storm: Scheduler(device='cuda', batch_size="
          f"{SERVING_BATCH}, preemptor=Preemptor(pdb_source)), "
          f"{SERVING_NODES} nodes holding phase 5b's {len(serving['bound'])} "
          f"pods, {STORM_VIPS} vips at priority 1000")
    storm = preempt_phase(device, serving["bound"])
    k3 = storm["row"]
    k3["max_abs_err"] = max(k3["max_abs_err"], errs["reprieve_scan"])
    k3["wide"] = k3_wide_row(device, k3_cases[K3_WIDE_CASE],
                             k3_cases[K3_NARROW_CASE])
    rows.append(k3)

    print(f"[7] gang jobs (BASELINE config 5): {GANG_NODES} nodes x "
          f"{GANG_PODS} pods, BatchScheduler(cuda)")
    gang = gang_phase(device)
    for r in rows[:2]:
        name = r["name"]
        r["preempt"] = dict(launches=storm["launches"][name],
                            max_abs_err=storm["errs"][name])
        r["gang"] = dict(launches=gang["launches"][name],
                         max_abs_err=gang["errs"].get(name))
        r["max_abs_err"] = max(r["max_abs_err"], storm["errs"][name],
                               gang["errs"].get(name, 0))

    print(f"[8] run-collapsed engine (KTPU_ASSIGN=runs): {CLASSES_NODES} "
          f"nodes x {CLASSES_PODS} pods of {CLASSES_DEPLOYMENTS} deployments")
    t0 = time.perf_counter()
    runs = runs_phase(device)
    print(f"    phase 8 {time.perf_counter() - t0:.1f} s")

    os.environ["KTPU_OVERLOAD"] = "0"
    t9 = time.perf_counter()
    print(f"[9a] crash and takeover: a ledger-backed leader and a warm "
          f"standby, {SERVING_NODES} nodes x {SERVING_PODS} pods")
    restart = restart_phase(device)
    print(f"[9b] the dispatch supervisor on 5b's drain: a hang and an error "
          f"with no fallback, then one error with fallback_device='cpu'")
    sup = supervisor_phase(device, serving["bound"])
    print(f"[9c] growth from {GROWTH_FROM} to {GROWTH_TO} nodes, waves of "
          f"{GROWTH_BATCH}, with the prewarmer and without")
    growth = growth_phase(device)
    print("[9d] telemetry: a 5b wave's flight record, watch→bind latency, "
          "KTPU_PROFILE")
    tel = telemetry_phase(device, serving["sched"])
    print(f"    phase 9 {time.perf_counter() - t9:.1f} s")
    for r in rows[:2]:
        name = r["name"]
        r["resilience"] = dict(
            first_led_launches=restart["first_led_launches"][name],
            next_wave_after_readmission=sup["next_wave_launches"][name],
            prewarm_launches=growth["prewarm_launches"][name],
            prewarm_max_abs_err=growth["errs"][name])
        r["max_abs_err"] = max(r["max_abs_err"], growth["errs"][name])

    t10 = time.perf_counter()
    print(f"[10a] a configured profile: Scheduler(device='cuda', framework="
          f"cfg.build_framework(), batch_size={SERVING_BATCH}), "
          f"{FRAMEWORK_NODES} nodes (disktype=ssd every "
          f"{FRAMEWORK_SSD_EVERY}th, preferAvoidPods every "
          f"{FRAMEWORK_AVOID_EVERY}th) x {SERVING_PODS} pods")
    fwk = framework_phase(device, card)
    print(f"[10b] extender verbs over HTTP: ExtenderServer(ExtenderBackend("
          f"device='cuda')) mirroring {FRAMEWORK_NODES} nodes and phase 5b's "
          f"{len(serving['bound'])} pods; [10c] Scheduler(extenders=["
          f"HTTPExtender]) on {EXTENDER_SCHED_PODS} pods")
    ext = extender_chip_phase(device, serving["bound"], card)
    print(f"[10d] Coscheduling on the Permit path: {COSCHED_NODES} nodes x "
          f"{COSCHED_PODS} gang pods")
    cos = cosched_phase(device, card)
    print(f"    phase 10 {time.perf_counter() - t10:.1f} s")

    t11 = time.perf_counter()
    print(f"[11] the scheduler process over the API: SchedulerServer("
          f"device='cuda') through the port's client into its APIServer, "
          f"{SERVER_NODES} nodes x {SERVER_PODS} pods, 11a behind the wave "
          f"barrier, 11a-t at the server's own pace; 11b {SERVER_VIPS} "
          f"vips; 11c kill and takeover; 11d HTTP, {SERVER_HTTP_PODS} pods")
    srvp = server_phase(device, card)
    print(f"    phase 11 {time.perf_counter() - t11:.1f} s")
    for r in rows:
        name = r["name"]
        r["server"] = {sub: dict(launches=c.get(name, 0),
                                 max_abs_err=srvp["errs"][sub].get(name))
                       for sub, c in srvp["launches"].items()}
        r["max_abs_err"] = max([r["max_abs_err"]] + [
            e[name] for e in srvp["errs"].values() if name in e])
    t12 = time.perf_counter()
    print(f"[12] the fleet on one card: FleetServer(device='cuda'), 12a "
          f"{FLEET_TENANTS} tenants x {FLEET_NODES} nodes x {FLEET_PODS} "
          f"pods, engines {FLEET_ENGINES} by tenant, t00 under a tight DRF "
          f"quota; 12b tick 1's DRF rows; 12c the watch plane, "
          f"{WATCH_TENANTS} tenants x {WATCH_NODES} nodes x {WATCH_PODS} "
          f"pods through the apiserver")
    fleet = fleet_phase(device, card)
    print(f"    phase 12 {time.perf_counter() - t12:.1f} s")
    t13 = time.perf_counter()
    print(f"[13] the sequential-assume scan at full width: BatchScheduler("
          f"device='cuda') on make_nodes({SCAN_NODES}), 13a flagship_pods("
          f"{SCAN_PODS}) with every {SCAN_PIN_EVERY}th pod pinned by "
          f"spec.nodeName, 13b port_volume_workload({SCAN_NODES}, "
          f"{SCAN_PV_PODS}) under KTPU_ASSIGN=scan")
    scan = scan_phase(device, card)
    scan_wall = time.perf_counter() - t13
    print(f"    phase 13 {scan_wall:.1f} s")
    a13 = scan["nodename"]
    rows.append(dict(
        name="assign_scan", route="cuda", source=K4_SOURCE,
        replaces="kubernetes_tpu/ops/assign.py:124", cluster=a13["cluster"],
        launches=a13["launches"]["assign_scan"],
        max_abs_err=max(errs["assign_scan"], a13["max_abs_err"],
                        scan["ports_volumes"]["max_abs_err"],
                        runs["k4_err"]),
        # ms, plain_ms and bound_ms on one piece of work: 13a's first
        # SCAN_CHECK_STEPS rows (the plain version at ~8 ms a step makes a
        # whole 13a scan too long to time)
        ms=a13["check_ms"], plain_ms=a13["plain_ms"],
        bound_ms=a13["check_bound_ms"], bound_by=a13["check_bound_by"],
        library_ms=None,
        steps_timed=SCAN_CHECK_STEPS,
        full_launch={k: dict(steps=v["steps"], ms=v["ms"],
                             step_us=v["step_us"], call_ms=v["call_ms"],
                             bound_ms=v["bound_ms"], bound_by=v["bound_by"],
                             plain_step_ms=v["plain_step_ms"],
                             cluster=v["cluster"],
                             sweep_step_us=v["sweep_step_us"])
                     for k, v in scan.items()},
        launches_by_phase={"8b": runs["scan_vs_runs"]["k4_launches"],
                           "12a": fleet["launches"].get("assign_scan", 0),
                           "12a_runs_fallback": fleet["k4_fallback_runs"],
                           "13a": a13["launches"]["assign_scan"],
                           "13b": scan["ports_volumes"]["launches"][
                               "assign_scan"]}))
    t14 = time.perf_counter()
    print(f"[14] the durable control plane: 14a an APIServer(data_dir, "
          f"durability='batch') on the native store killed mid-commit at "
          f"{DURABLE_CRASH} and rebooted from disk, {DURABLE_NODES} nodes x "
          f"{DURABLE_PODS} pods, Scheduler(device='cuda') with a "
          f"BindIntentLedger; 14b phase 11d over HTTPTransport(binary=True) "
          f"against a durable apiserver, {SERVER_HTTP_PODS} pods")
    dur = durable_phase(device, card)
    print(f"    14b creates/s {dur['b']['creates_per_s']:.1f} (binary, "
          f"durable) against 11d's {srvp['d']['creates_per_s']:.1f} (JSON, "
          f"in memory) in this run; 11a's {srvp['a']['creates_per_s']:.1f} "
          f"(local, in memory, native store)")
    print(f"    phase 14 {time.perf_counter() - t14:.1f} s")
    t17 = time.perf_counter()
    print(f"[17a] node-axis sharding: the dryrun's three rungs on a mesh of "
          f"{MESH_SHARDS} x cuda:0 (parallel/dryrun.py run_dryrun): spec "
          f"(waves and scan, {max(8 * MESH_SHARDS, 16)} x 64), production "
          f"(waves in the gang rounds, {MESH_PRODUCTION[0]} x "
          f"{MESH_PRODUCTION[1]}), bench (waves, 5120 x {MESH_BENCH_PODS}), "
          f"each against the unsharded run and JAX_MESH")
    mesh = mesh_phase(device, card)
    print(f"    phase 17 {time.perf_counter() - t17:.1f} s")
    t18 = time.perf_counter()
    print(f"[18] the fleet mesh: 18a phase 12a's {FLEET_TENANTS} tenants x "
          f"{FLEET_NODES} nodes x {FLEET_PODS} pods through FleetServer("
          f"mesh={FLEET_MESH_DEVICES}, node_shards={FLEET_MESH_NODE_SHARDS}, "
          f"mesh_devices=[cuda:0] * {FLEET_MESH_DEVICES}) (the 4 x 2 tenant "
          f"x node-shard grid), 18b t00–t{FLEET_1D_TENANTS - 1:02d} on the "
          f"{FLEET_MESH_DEVICES} x 1 tenant mesh, 18c the degrade → reform "
          f"drill")
    fmesh = fleet_mesh_phase(device, card, ref_tenants=fleet["tenants"])
    print(f"    phase 18 {time.perf_counter() - t18:.1f} s")
    for r in rows:
        name = r["name"]
        r["fleet_mesh"] = dict(
            launches=fmesh["launches"].get(name, 0),
            launches_per_tick=[t.get(name, 0)
                               for t in fmesh["launches_per_tick"]],
            launches_in_grid=fmesh["grid_launches"].get(name, 0),
            max_abs_err=fmesh["errs"].get(name))
        if fmesh["errs"].get(name) is not None:
            r["max_abs_err"] = max(r["max_abs_err"], fmesh["errs"][name])
    for r in rows:
        name = r["name"]
        r["mesh"] = dict(launches=mesh["total"][name],
                         launches_by_subphase={k: v[name] for k, v in
                                               mesh["launches"].items()},
                         launches_on_mesh=mesh["mesh_launches"][name],
                         max_abs_err=mesh["errs"][name])
        if mesh["errs"][name] is not None:
            r["max_abs_err"] = max(r["max_abs_err"], mesh["errs"][name])
    for r in rows:
        name = r["name"]
        r["durable"] = {sub: dict(launches=c.get(name, 0),
                                  max_abs_err=dur["errs"][sub].get(name))
                        for sub, c in dur["launches"].items()}
        r["max_abs_err"] = max([r["max_abs_err"]] + [
            e[name] for e in dur["errs"].values() if name in e])
    for r in rows:
        name = r["name"]
        for key, ph, res in (("kubemark", "15", km), ("cluster", "16", cl)):
            r[key] = dict(launches=res["launches"][ph].get(name, 0),
                          max_abs_err=res["errs"][ph].get(name))
            if name in res["errs"][ph]:
                r["max_abs_err"] = max(r["max_abs_err"],
                                       res["errs"][ph][name])
    for r in rows:
        name = r["name"]
        r["fleet"] = dict(launches=fleet["launches"].get(name, 0),
                          launches_per_tick=[t.get(name, 0) for t in
                                             fleet["launches_per_tick"]],
                          max_abs_err=fleet["errs"].get(name))
        if name in fleet["errs"]:
            r["max_abs_err"] = max(r["max_abs_err"], fleet["errs"][name])
    for r in rows[:2]:
        name = r["name"]
        r["framework"] = dict(
            launches_10a=fwk["launches"][name],
            launches_10b=ext["launches"]["10b"][name],
            launches_10c=ext["launches"]["10c"][name],
            launches_10d=cos["launches"][name],
            max_abs_err=fwk["errs"][name])
        r["max_abs_err"] = max(r["max_abs_err"], fwk["errs"][name])

    steady = serving["steady"]["cycles"]
    print(json.dumps({"kernels": rows, "cycle_ms": cycle_s * 1e3,
                      "build_s": build_s,
                      "contention_scan_ports_volumes": pv_k1,
                      "serving": {
                          "steady_full_snapshot_s": steady[0]["snapshot_s"],
                          "steady_patch_snapshot_s": [
                              c["snapshot_s"] for c in steady[1:]],
                          "steady_cycles": steady,
                          "drain_waves": [dict(w, **t) for w, t in zip(
                              serving["drain"]["waves"], serving["timer"])],
                          "drain_bound": serving["drain"]["bound"],
                          "drain_sched_s": serving["sched_s"],
                          "drain_pods_per_s": serving["pods_s"],
                          "drain_wall_s": serving["drain_s"]},
                      "preempt": {
                          "waves": [dict(w, **t) for w, t in zip(
                              storm["storm"]["waves"], storm["waves"])],
                          "bursts": len(storm["bursts"]),
                          "idle_nodes": storm["idle_nodes"],
                          "room_nodes": storm["room_nodes"],
                          "vips_bound": storm["storm"]["vips_bound"],
                          "evicted": storm["storm"]["evicted"],
                          "split_waves": storm["split_waves"],
                          "sched_s": storm["sched_s"],
                          "vips_per_s": storm["vips_per_s"],
                          "wave0_vips_per_s": storm["wave0_vips_per_s"],
                          "later_vips_per_s": storm["later_vips_per_s"],
                          "wall_s": storm["storm_s"]},
                      "gang": gang, "explain": explain, "runs": runs,
                      "resilience": {
                          "restart": {k: restart[k] for k in (
                              "timing", "intent_write_ms", "first_led_mode",
                              "wall_s")},
                          "supervisor": sup, "growth": growth,
                          "telemetry": tel},
                      "framework": {
                          "drain_waves": [dict(w, **t) for w, t in zip(
                              fwk["drain"]["waves"], fwk["timer"])],
                          "drain_bound": fwk["drain"]["bound"],
                          "drain_sched_s": fwk["sched_s"],
                          "drain_wall_s": fwk["wall_s"],
                          "extender_latency": ext["latency"],
                          "extender_sched_wave_s": ext["sched_wave_s"],
                          "extender_wall_s": ext["wall_s"],
                          "cosched": cos["result"],
                          "cosched_wall_s": cos["wall_s"]},
                      "server": {
                          sub: {k: v for k, v in srvp[sub].items()
                                if k not in ("bound_sha256",
                                             "first_wave_sha256")}
                          for sub in ("a", "at", "b", "c", "d")},
                      "server_wall_s": srvp["wall_s"],
                      "fleet": {k: v for k, v in fleet.items()
                                if k not in ("errs", "launches",
                                             "tenants")},
                      "scan": scan, "scan_wall_s": scan_wall,
                      "durable": {
                          "a": {k: v for k, v in dur["a"].items()
                                if k != "bound_sha256"},
                          "b": {k: v for k, v in dur["b"].items()
                                if k not in ("bound_sha256",
                                             "first_wave_sha256",
                                             "waves_sha256")},
                          "wall_s": dur["wall_s"]},
                      "kubemark": km["out"],
                      "cluster": {k: v for k, v in cl["out"].items()
                                  if not k.startswith("per_node")},
                      "mesh": {
                          "rungs": [{k: v for k, v in row.items()
                                     if k != "sha256"}
                                    for row in mesh["rungs"]],
                          "memory": mesh["memory"],
                          "dryrun_s": mesh["dryrun_s"],
                          "serving": {k: v for k, v in
                                      mesh["serving"].items()
                                      if k != "waves"},
                          "preempt": mesh["preempt"]},
                      "fleet_mesh": {k: v for k, v in fmesh.items()
                                     if k not in ("errs", "launches")},
                      "wall_s": time.perf_counter() - T_START}))
    print(card)
    print(line_log.summary())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    pin_hash_seed()
    if sys.argv[1:2] == ["--phase"] and sys.argv[2:] in (["15"], ["16"],
                                                          ["17"], ["18"]):
        sys.exit(phase_child(sys.argv[2]))
    sys.exit(main())
