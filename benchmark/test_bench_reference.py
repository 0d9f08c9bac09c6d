"""The plain reference against tiny clusters worked out by hand, and its
control (the Score left out) against the reference."""

import pytest

from benchmark import reference
from benchmark.control import control_log
from benchmark.tiny import run_tiny
from benchmark.traffic import Cluster, Group


def cluster(nodes, zones, groups, occupancy=0):
    return Cluster(nodes=nodes, zones=tuple(f"z{i}" for i in range(zones)),
                   cpu_milli=4000, mem_kib=8 * 1024 * 1024, pods_cap=20,
                   groups=tuple(groups), occupancy=occupancy)


def group(i, cpu=250, spread=None, anti=None, affinity=None, priority=0):
    return Group(index=i, cpu_milli=cpu, mem_kib=512 * 1024,
                 priority=priority, spread=spread, anti=anti,
                 affinity=affinity)


def log(groups_of, fill, waves):
    return {"group": groups_of, "fill": fill,
            "waves": [{"members": m, "deleted": d} for m, d in waves]}


def test_anti_affinity_then_a_deletion_frees_a_node():
    # two nodes; three pods of a group anti-affine by hostname: two land,
    # one per node, the third finds no node until one of them is deleted
    cl = cluster(2, 2, [group(0, anti="hostname")])
    out = reference.replay(cl, log([0, 0, 0], [], [([0, 1, 2], [0]),
                                                   ([2], [])]))
    assert out[0] == {0: 0, 1: 1, 2: -1}
    assert out[1] == {2: 0}


def test_zone_affinity_follows_the_first_pod():
    # nodes 0, 2 in zone 0; 1, 3 in zone 1. The group requires its own pods
    # in its zone. On an empty cluster the first pod escapes (to node 0,
    # equal scores: the lowest node) and the second follows it to zone 0, to
    # node 2, the emptier node there. With a pod already on node 1 both go
    # to zone 1: node 3, then node 1
    cl = cluster(4, 2, [group(0, affinity=("zone", 0))])
    out = reference.replay(cl, log([0, 0], [], [([0, 1], [])]))
    assert out[0] == {0: 0, 1: 2}
    out = reference.replay(cl, log([0, 0, 0], [[0, 1]], [([1, 2], [])]))
    assert out[0] == {1: 3, 2: 1}


def test_hard_zone_spread():
    # maxSkew 1 over two one-node zones; two pods of the group already on
    # node 0 (zone 0). The next pod must go to zone 1; of the next two, the
    # first fills zone 1's quota and the second, with the zones even, takes
    # node 0 (equal scores: the lowest node)
    cl = cluster(2, 2, [group(0, spread=("zone", 1))])
    out = reference.replay(cl, log([0] * 5, [[0, 0], [1, 0]],
                                   [([2], []), ([3, 4], [])]))
    assert out[0] == {2: 1}
    assert out[1] == {3: 1, 4: 0}


def test_deleted_resources_are_released():
    # one node of 4 CPU; four 1-CPU pods fill it; a fifth waits, and fits
    # once one is deleted
    cl = cluster(1, 1, [group(0, cpu=1000)])
    out = reference.replay(cl, log([0] * 5, [[i, 0] for i in range(4)],
                                   [([4], [1]), ([4], [])]))
    assert out[0] == {4: -1}
    assert out[1] == {4: 0}


def test_priority_orders_a_contended_slot():
    # the last slot goes to the higher priority pod, created later
    cl = cluster(1, 1, [group(0, cpu=1000), group(1, cpu=1000, priority=5)])
    out = reference.replay(cl, log([0, 0, 0, 0, 1], [[i, 0] for i in range(3)],
                                   [([3, 4], [])]))
    assert out[0] == {3: -1, 4: 0}


@pytest.mark.parametrize("workload", ["flagship-backlog", "density-backlog"])
def test_control_without_the_score_is_not_correct(workload):
    """The control: the reference with its Score left out, in the program's
    place on a test-size run, comes out not correct through the harness's
    own comparison; the reference on the same log agrees with the
    program."""
    captured = {}
    from benchmark import harness

    orig = harness.compare

    def grab(run_log, cl, ref, lost):
        captured.update(log=run_log, cluster=cl, ref=ref)
        return orig(run_log, cl, ref, lost)

    harness.compare = grab
    try:
        r = run_tiny(workload, seed=11)
    finally:
        harness.compare = orig
    assert r["correct"]
    ctl = reference.replay(captured["cluster"], captured["log"],
                           scored=False)
    checks = orig(control_log(captured["log"], ctl), captured["cluster"],
                  captured["ref"], 0)
    assert checks["mismatched_pods"]["value"] > 0
    assert any(c["value"] > c["limit"] for c in checks.values())
