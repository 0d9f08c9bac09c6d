"""The cells' inputs as plain data, made from a seed: the nodes, the
namespaces (each stamping one pod template), the pods that fill the cluster
bound, and the order of the fresh pods a mix adds.

One general generator reads a configuration file (the deployment) and a mix
file (the traffic); nothing here knows a cell by name. Both the harness,
which converts the data to the scheduler's types, and the reference, which
works the classes out again, read the same `Cluster`.

The node and pod templates are scheduler_perf's, as a configuration file
states them; its namespaces are cluster-loader2 density's. The seed orders
the fresh pods' namespaces and never changes the amount of work (the same
namespaces and templates).
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

ROOT = Path(__file__).resolve().parent

TOPOLOGY_KEYS = {
    "zone": "topology.kubernetes.io/zone",
    "hostname": "kubernetes.io/hostname",
}


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


@dataclass(frozen=True)
class Group:
    """One namespace's pods: one template's requests and terms. A pod of a
    template with a term carries the label app=app-<index>, and each term
    selects it (a template's selector matches its own pods, and a
    namespace scopes it: the label stands for the namespace); a template
    without a term carries no label, as pod-default."""

    index: int
    cpu_milli: int
    mem_kib: int
    priority: int
    spread: Optional[Tuple[str, int]]    # hard spread: key, maxSkew
    anti: Optional[str]                  # anti-affinity to its own group: key
    affinity: Optional[Tuple[str, int]]  # affinity: key, selected group

    @property
    def labelled(self) -> bool:
        return bool(self.spread or self.anti or self.affinity)


@dataclass(frozen=True)
class Cluster:
    nodes: int
    zones: Tuple[str, ...]
    cpu_milli: int
    mem_kib: int
    pods_cap: int
    groups: Tuple[Group, ...]
    occupancy: int

    def node_zone(self, n: int) -> int:
        return n % len(self.zones)

    def domains(self, key: str) -> List[int]:
        """Each node's domain of a topology key (compact ids)."""
        if key == "zone":
            return [self.node_zone(n) for n in range(self.nodes)]
        if key == "hostname":
            return list(range(self.nodes))
        raise ValueError(f"unknown topology key {key!r}")


def _rng(seed: int, salt: str) -> random.Random:
    # a str seed is hashed with sha512: the same stream in every process,
    # whatever PYTHONHASHSEED says
    return random.Random(f"{int(seed)}:{salt}")


def build_cluster(config: dict) -> Cluster:
    """The deployment of a configuration file: namespace g stamps template
    g mod T."""
    nd = config["nodes"]
    templates = config["templates"]
    groups = []
    for g in range(int(config["namespaces"])):
        t = templates[g % len(templates)]
        spread = (t["spread"]["key"], int(t["spread"]["max_skew"])) \
            if t.get("spread") else None
        anti = t["anti"]["key"] if t.get("anti") else None
        aff = (t["affinity"]["key"], g) if t.get("affinity") else None
        groups.append(Group(index=g, cpu_milli=int(t["cpu_milli"]),
                            mem_kib=int(t["mem_kib"]),
                            priority=int(t.get("priority", 0)), spread=spread,
                            anti=anti, affinity=aff))
    return Cluster(nodes=int(nd["count"]), zones=tuple(nd["zones"]),
                   cpu_milli=int(nd["cpu_milli"]), mem_kib=int(nd["mem_kib"]),
                   pods_cap=int(nd["pods"]), groups=tuple(groups),
                   occupancy=int(config["occupancy"]))


def fill_placement(cluster: Cluster) -> List[Tuple[int, int]]:
    """The pods the cluster holds bound when the scheduler starts, in
    creation order (the oldest first), as (group, node) per pod id. Pod i
    is group i mod G's k-th pod (k = i div G). A group with a zone
    affinity sits in one zone (its rank among such groups mod Z); every
    other group's k-th pod goes to zone k mod Z, so a spread group is
    even over the zones. Within a zone the pods go round the zone's nodes,
    skipping a node that holds ⌈occupancy / N⌉ + 1 pods already, or a pod
    of the pod's own anti-affine group."""
    G, N, Z = len(cluster.groups), cluster.nodes, len(cluster.zones)
    zone_nodes = [[n for n in range(N) if cluster.node_zone(n) == z]
                  for z in range(Z)]
    cap = -(-cluster.occupancy // N) + 1
    count = [0] * N
    held = [set() for _ in range(G)]
    cursor = [0] * Z
    aff_rank = {}
    for g in cluster.groups:
        if g.affinity:
            aff_rank[g.index] = len(aff_rank)
    out = []
    for i in range(cluster.occupancy):
        g, k = i % G, i // G
        grp = cluster.groups[g]
        z = aff_rank[g] % Z if grp.affinity else k % Z
        nodes = zone_nodes[z]
        for step in range(len(nodes)):
            n = nodes[(cursor[z] + step) % len(nodes)]
            if count[n] < cap and not (grp.anti and n in held[g]):
                break
        else:
            raise ValueError("the fill does not fit the zone's nodes")
        cursor[z] = (cursor[z] + step + 1) % len(nodes)
        count[n] += 1
        if grp.anti:
            held[g].add(n)
        out.append((g, n))
    return out


class GroupSequence:
    """The groups of fresh pods in order: blocks of every group once, each
    block in an order drawn from the seed, so any prefix is balanced to
    within one block."""

    def __init__(self, n_groups: int, seed: int, salt: str = "fresh") -> None:
        self.n_groups = n_groups
        self.rng = _rng(seed, salt)
        self.block: List[int] = []

    def take(self, n: int) -> List[int]:
        out = []
        while len(out) < n:
            if not self.block:
                self.block = list(range(self.n_groups))
                self.rng.shuffle(self.block)
            take = min(n - len(out), len(self.block))
            out.extend(self.block[:take])
            del self.block[:take]
        return out


def load_cell(root: Path, workload: str) -> Tuple[dict, dict, dict]:
    """(cell entry, configuration, mix) of a workload named in
    BENCHMARK.json; the mix is mixes/<traffic>.json beside this file."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = load_json(Path(root) / cfgs[cell["config"]]["file"])
    mix = load_json(ROOT / "mixes" / f"{cell['traffic']}.json")
    return cell, config, mix

