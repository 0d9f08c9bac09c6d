"""Parity of the port's SchedulerCache (kubernetes_tpu_torch/state/cache.py)
with the JAX package's (kubernetes_tpu/state/cache.py).

One event script drives both caches, each in its own package's types (the
packages have separate Pod/Node classes, and the pending signature is keyed
by object identity, so every pod and node is built once per package from
one spec). After every snapshot both must agree on how it was produced
(`last_snapshot_mode`, `last_patch_rows`), on `node_order`, `dims`,
`existing_keys` and the generation, and on every field of `tables`,
`existing` and `pending` — exactly for the integer and bool planes. The
scripts mirror tests/test_incremental.py. The port runs with device="cpu".

Also here: an earlier port Snapshot keeps its tensors through later
mutations (every staging → device move copies, every patch is out of
place), and the micro-wave graft.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

import kubernetes_tpu.api.types as JT
import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu.sched.cycle import _schedule_batch
from kubernetes_tpu.sched.cycle import \
    micro_snapshot_with_keys as j_micro_snapshot
from kubernetes_tpu.sched.cycle import snapshot_with_keys as j_snapshot
from kubernetes_tpu.state.cache import SchedulerCache as JCache
from kubernetes_tpu.state.encode import Encoder as JEncoder
from kubernetes_tpu_torch.sched.cycle import \
    micro_snapshot_with_keys as t_micro_snapshot
from kubernetes_tpu_torch.sched.cycle import schedule_batch
from kubernetes_tpu_torch.sched.cycle import snapshot_with_keys as t_snapshot
from kubernetes_tpu_torch.state.cache import SchedulerCache as TCache
from kubernetes_tpu_torch.state.encode import Encoder as TEncoder
from torch_parity import CPU, as_np, assert_same

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"
RACK = "example.com/rack"


def mknode(T, name, zone="z0", cpu="4", mem="16Gi", labels=None):
    lab = {ZONE: zone, HOSTNAME: name}
    lab.update(labels or {})
    return T.Node(name=name, labels=lab,
                  allocatable=T.Resources.make(cpu=cpu, memory=mem, pods=110))


def mkpod(T, name, app="a", cpu="500m", mem="1Gi", node=None, anti=False,
          spread=False, spread_key=ZONE, creation=0):
    sel = T.LabelSelector.of(match_labels={"app": app})
    affinity = T.Affinity(anti_required=(
        T.PodAffinityTerm(selector=sel, topology_key=HOSTNAME),)) if anti \
        else T.Affinity()
    tsc = (T.TopologySpreadConstraint(
        max_skew=1, topology_key=spread_key,
        when_unsatisfiable=T.UnsatisfiableAction.DO_NOT_SCHEDULE,
        selector=sel),) if spread else ()
    return T.Pod(name=name, labels={"app": app},
                 requests=T.Resources.make(cpu=cpu, memory=mem),
                 affinity=affinity, topology_spread=tsc,
                 node_name=node or "", creation_index=creation)


class Twin:
    """One JAX cache and one port cache, driven by the same events."""

    def __init__(self):
        self.cache = {"jax": JCache(), "port": TCache()}
        self.enc = {"jax": JEncoder(), "port": TEncoder()}
        self.types = {"jax": JT, "port": TT}

    def node(self, op, **spec):
        for side, c in self.cache.items():
            getattr(c, op)(mknode(self.types[side], **spec))

    def pod(self, op, **spec):
        for side, c in self.cache.items():
            getattr(c, op)(mkpod(self.types[side], **spec))

    def assume(self, node_name, **spec):
        for side, c in self.cache.items():
            c.assume_pod(mkpod(self.types[side], **spec), node_name)

    def call(self, op, *args):
        for c in self.cache.values():
            getattr(c, op)(*args)

    def pending(self, specs):
        """Each package's pending list, built once so the identity-keyed
        pending signature repeats across snapshots."""
        return {side: [mkpod(T, **s) for s in specs]
                for side, T in self.types.items()}

    def snapshot(self, pending):
        js, jk = j_snapshot(self.cache["jax"], self.enc["jax"],
                            pending["jax"], None)
        ts, tk = t_snapshot(self.cache["port"], self.enc["port"],
                            pending["port"], None, device=CPU)
        self.check(js, ts)
        assert (int(jk[0]), int(jk[1])) == tk
        return js, ts

    def micro_snapshot(self, pending, micro_p=128):
        js, jk = j_micro_snapshot(self.cache["jax"], self.enc["jax"],
                                  pending["jax"], None, micro_p)
        ts, tk = t_micro_snapshot(self.cache["port"], self.enc["port"],
                                  pending["port"], None, micro_p, device=CPU)
        self.check(js, ts)
        assert (int(jk[0]), int(jk[1])) == tk
        return js, ts

    def check(self, js, ts):
        cj, cp = self.cache["jax"], self.cache["port"]
        assert cp.last_snapshot_mode == cj.last_snapshot_mode
        assert cp.last_patch_rows == cj.last_patch_rows
        assert ts.node_order == js.node_order
        assert dataclasses.asdict(ts.dims) == dataclasses.asdict(js.dims)
        assert ts.existing_keys == js.existing_keys
        assert [k for k, _ in ts.pending_keys] == \
            [k for k, _ in js.pending_keys]
        assert ts.generation == js.generation
        assert ts.device == CPU
        assert_same(js.tables, ts.tables, "tables")
        assert_same(js.existing, ts.existing, "existing")
        assert_same(js.pending, ts.pending, "pending")

    def mode(self):
        return self.cache["port"].last_snapshot_mode

    def schedule(self, js, ts, n):
        """Placements of both snapshots through each package's cycle."""
        import jax
        import jax.numpy as jnp

        vocabs = self.enc["port"].vocabs
        keys = (vocabs.label_keys.get("node.kubernetes.io/unschedulable"),
                vocabs.label_vals.get(""))
        rj = _schedule_batch(js.tables, js.pending,
                             (jnp.int32(keys[0]), jnp.int32(keys[1])),
                             js.dims.D, js.existing,
                             has_node_name=js.dims.has_node_name)
        rt = schedule_batch(ts.tables, ts.pending, keys, ts.dims.D,
                            ts.existing, has_node_name=ts.dims.has_node_name)
        nj = np.asarray(jax.device_get(rj.node))[:n]
        nt = rt.node.cpu().numpy()[:n]
        np.testing.assert_array_equal(nt, nj)
        return [ts.node_order[i] if i >= 0 else None for i in nt]


def build_twin(n_nodes=12, n_bound=8):
    tw = Twin()
    for i in range(n_nodes):
        tw.node("add_node", name=f"n{i}", zone=f"z{i % 3}")
    for i in range(n_bound):
        tw.pod("add_pod", name=f"b{i}", app=f"g{i % 2}",
               node=f"n{i % n_nodes}", anti=(i % 2 == 0), creation=i)
    return tw


def test_second_snapshot_is_cached():
    tw = build_twin()
    pending = tw.pending([dict(name="p0", app="g0", creation=100)])
    tw.snapshot(pending)
    assert tw.mode() == "full"
    js, ts = tw.snapshot(pending)
    assert tw.mode() == "cached"
    assert ts is tw.cache["port"]._snapshot


def test_node_churn_takes_patch_path_with_o_changed_rows():
    tw = build_twin(n_nodes=12, n_bound=8)
    pending = tw.pending([dict(name="p0", app="g0", creation=100)])
    _, t1 = tw.snapshot(pending)
    assert tw.mode() == "full"
    tw.node("update_node", name="n3", zone="z1", cpu="8")
    _, t2 = tw.snapshot(pending)
    assert tw.mode() == "patch"
    assert tw.cache["port"].last_patch_rows == 1
    # untouched tables are reused, not re-uploaded
    assert t2.tables.reqs.vec is t1.tables.reqs.vec
    assert t2.tables.classes.rid is t1.tables.classes.rid
    assert t2.existing.cls is t1.existing.cls
    assert t2.pending.cls is t1.pending.cls
    # the patched plane is a new tensor; the old one is as it was
    assert t2.tables.nodes.alloc is not t1.tables.nodes.alloc


def test_patch_churn_node_update_assume_remove_add():
    """test_incremental's mixed churn and node-removal cases: every
    snapshot equal, and the placements of the patched snapshot equal."""
    tw = build_twin(n_nodes=12, n_bound=8)
    specs = [dict(name=f"p{i}", app=f"g{i % 2}", anti=(i % 3 == 0),
                  spread=(i % 2 == 0), creation=100 + i) for i in range(6)]
    pending = tw.pending(specs)
    tw.snapshot(pending)
    tw.node("update_node", name="n1", zone="z2", cpu="2")
    tw.assume("n2", name="x0", app="g1", creation=50)
    tw.call("remove_pod", "default/b3")
    tw.node("add_node", name="n12", zone="z0")
    js, ts = tw.snapshot(pending)
    assert tw.mode() == "patch"
    tw.call("remove_node", "n2")
    js, ts = tw.snapshot(pending)
    assert tw.mode() == "patch"
    got = tw.schedule(js, ts, len(specs))
    assert any(g is not None for g in got) and "n2" not in got


def test_new_topology_key_stays_on_patch_path():
    tw = Twin()
    for i in range(4):
        tw.node("add_node", name=f"n{i}",
                labels={RACK: "rA" if i < 2 else "rB"})
    tw.pod("add_pod", name="g1a", app="g1", cpu="100m", node="n0", anti=True,
           creation=0)
    tw.pod("add_pod", name="g1b", app="g1", cpu="100m", node="n1", creation=1)
    tw.pod("add_pod", name="biga", app="big", cpu="3", node="n2", creation=2)
    tw.pod("add_pod", name="bigb", app="big", cpu="3", node="n3", creation=3)
    tw.snapshot(tw.pending([dict(name="w0", app="g0", creation=90)]))
    pending = tw.pending([dict(name="p-rack", app="g1", cpu="100m",
                               spread=True, spread_key=RACK, creation=100)])
    js, ts = tw.snapshot(pending)
    assert tw.mode() == "patch"
    assert tw.cache["port"].last_patch_rows == 0
    assert tw.schedule(js, ts, 1)[0] in ("n2", "n3")


def test_capacity_growth_falls_back_to_full():
    tw = build_twin(n_nodes=12, n_bound=4)
    pending = tw.pending([dict(name="p0", app="g0", creation=100)])
    tw.snapshot(pending)
    for i in range(30):  # past the bucketed node capacity (16)
        tw.node("add_node", name=f"grow{i}")
    tw.snapshot(pending)
    assert tw.mode() == "full"


def test_domain_compaction_under_hostname_churn():
    """Hostname-keyed anti-affinity makes every node name a domain; node
    replacement churn must not ratchet D up: each full re-encode compacts
    the domain maps, in both packages alike."""
    tw = build_twin(n_nodes=8, n_bound=4)
    pending = tw.pending([dict(name="p0", app="g0", anti=True,
                               creation=100)])
    tw.snapshot(pending)
    modes = []
    for gen in range(6):
        for n in list(tw.cache["port"].nodes()):
            if n.name.startswith(("n", f"gen{gen - 1}-")):
                tw.call("remove_node", n.name)
        for i in range(8):
            tw.node("add_node", name=f"gen{gen}-{i}", zone=f"z{i % 3}")
        tw.snapshot(pending)
        modes.append(tw.mode())
    assert "full" in modes
    assert tw.cache["port"]._snapshot.dims.D <= 16


def test_pod_bound_before_its_node_exists():
    tw = build_twin(n_nodes=4, n_bound=2)
    pending = tw.pending([dict(name="p0", app="late", anti=True,
                               creation=100)])
    tw.snapshot(pending)
    tw.pod("add_pod", name="orphan", app="late", node="nlate", anti=True,
           creation=10)
    tw.snapshot(pending)
    tw.node("add_node", name="nlate", zone="z1")
    js, ts = tw.snapshot(pending)
    assert tw.mode() == "patch"
    assert tw.schedule(js, ts, 1)[0] != "nlate"


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_randomized_churn_replay(seed):
    """After ANY sequence of cache mutations, both caches produce the same
    snapshot, step by step, and the same placements at the end."""
    rng = random.Random(seed)
    tw = build_twin(n_nodes=10, n_bound=6)
    specs = [dict(name=f"p{i}", app=f"g{i % 3}", anti=(i % 2 == 0),
                  spread=(i % 3 == 0), creation=100 + i) for i in range(5)]
    pending = tw.pending(specs)
    tw.snapshot(pending)
    next_id = 100
    modes = []
    for _step in range(12):
        op = rng.choice(["node_up", "assume", "forget_or_remove", "node_add"])
        port = tw.cache["port"]
        if op == "node_up":
            name = rng.choice([n.name for n in port.nodes()])
            tw.node("update_node", name=name, zone=f"z{rng.randrange(4)}",
                    cpu=rng.choice(["2", "4", "8"]))
        elif op == "assume":
            k, next_id = next_id, next_id + 1
            tw.assume(rng.choice([n.name for n in port.nodes()]),
                      name=f"c{k}", app=f"g{k % 3}", creation=k)
        elif op == "forget_or_remove":
            pods = port.scheduled_pods()
            if pods:
                victim = rng.choice(pods)
                tw.call("forget_pod" if port.is_assumed(victim.key)
                        else "remove_pod", victim.key)
        else:
            k, next_id = next_id, next_id + 1
            tw.node("add_node", name=f"a{k}", zone=f"z{k % 4}")
        js, ts = tw.snapshot(pending)
        modes.append(tw.mode())
    assert "patch" in modes
    tw.schedule(js, ts, len(specs))


def test_earlier_snapshot_is_unchanged_by_later_mutations():
    """A port Snapshot holds its own tensors: the staging mirrors the cache
    rewrites in place, and the patches that follow, never reach it (on the
    CPU a move that aliased the staging would show here)."""
    tw = build_twin(n_nodes=12, n_bound=8)
    cache, enc = tw.cache["port"], tw.enc["port"]
    pending = [mkpod(TT, f"p{i}", app=f"g{i % 2}", creation=100 + i)
               for i in range(4)]
    s1, _ = t_snapshot(cache, enc, pending, None, device=CPU)
    frozen = [(f, t.clone()) for f, t in _leaves(s1)]

    cache.update_node(mknode(TT, "n1", zone="z2", cpu="2"))
    cache.assume_pod(mkpod(TT, "x0", app="g1", creation=50), "n2")
    cache.remove_pod("default/b3")
    cache.remove_pod("default/b5")
    cache.add_node(mknode(TT, "n12", zone="z0"))
    cache.add_pod(mkpod(TT, "late", app="g0", node="n4", creation=60))
    pending2 = list(pending)
    pending2[0] = mkpod(TT, "p0", app="g0", cpu="1", creation=100)
    s2, _ = t_snapshot(cache, enc, pending2, None, device=CPU)
    assert cache.last_snapshot_mode == "patch"
    cache.update_node(mknode(TT, "n5", zone="z1",
                             labels={RACK: "rC"}))
    s3, _ = t_snapshot(cache, enc, [mkpod(TT, "q", app="g1", spread=True,
                                          spread_key=RACK, creation=7)],
                       None, device=CPU)
    assert cache.last_snapshot_mode == "patch"

    for (name, before), (_, now) in zip(frozen, _leaves(s1)):
        assert torch.equal(before, now), name
    changed = [n for (n, a), (_, b) in zip(_leaves(s1), _leaves(s2))
               if not torch.equal(a, b)]
    assert {"tables.nodes.used", "existing.name_id", "pending.cls"} \
        <= set(changed)
    assert not torch.equal(s2.tables.nodes.topo, s3.tables.nodes.topo)


def _leaves(snap):
    out = []

    def walk(x, name):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            for f in x._fields:
                walk(getattr(x, f), f"{name}.{f}")
        else:
            out.append((name, x))

    for part in ("tables", "existing", "pending"):
        walk(getattr(snap, part), part)
    return out


def test_micro_graft_equals_and_leaves_the_bulk_snapshot():
    """The micro path: intern the deltas, patch the resident state with an
    EMPTY pending batch, graft a [micro_p] pending block. Both packages
    produce the same graft; it shares the base tables and is not cached."""
    tw = build_twin(n_nodes=12, n_bound=8)
    pending = tw.pending([dict(name="p0", app="g0", creation=100)])
    tw.snapshot(pending)
    tw.node("update_node", name="n3", zone="z1", cpu="8")
    deltas = tw.pending([dict(name=f"m{i}", app="fresh", cpu="250m",
                              spread=(i == 1), creation=200 + i)
                         for i in range(3)])
    js, ts = tw.micro_snapshot(deltas)
    port = tw.cache["port"]
    assert port.last_snapshot_mode == "patch"
    assert ts.dims.P == 128 and not ts.dims.has_node_name
    assert ts.tables is port._snapshot.tables
    assert ts is not port._snapshot and port._snapshot.pending_keys == ()
    got = tw.schedule(js, ts, 3)
    assert all(g is not None for g in got)
    # a second graft of the same deltas reuses the cached base
    tw.micro_snapshot(deltas)
    assert tw.mode() == "cached"


def test_stage_to_device_copies_never_alias():
    from kubernetes_tpu_torch.state.arrays import to_device

    a = np.arange(6, dtype=np.uint32).reshape(2, 3)
    t = to_device(a, CPU)
    a[0, 0] = 99
    assert t.dtype == torch.int32 and int(t[0, 0]) == 0
    with pytest.raises(TypeError):
        to_device(np.zeros(3, np.int64), CPU)
    assert as_np(t).shape == (2, 3)
