"""The seeded generator: a seed repeats, seeds differ, the work does not."""

import collections

import pytest

from benchmark import traffic
from benchmark.tiny import tiny_cell

SEEDS = (1, 2, 2**31 + 5)


def _cluster(workload="flagship-backlog"):
    _, config, _ = tiny_cell(workload)
    return traffic.build_cluster(config)


def test_fresh_pods_repeat_per_seed_and_differ_across_seeds():
    cl = _cluster()
    a = traffic.GroupSequence(len(cl.groups), SEEDS[2]).take(200)
    assert a == traffic.GroupSequence(len(cl.groups), SEEDS[2]).take(200)
    b = traffic.GroupSequence(len(cl.groups), SEEDS[0]).take(200)
    assert a != b
    # the same namespaces, in another order
    assert sorted(a) == sorted(b)


def test_flagship_templates():
    cl = _cluster()
    assert len(cl.zones) == 4 and cl.cpu_milli == 600
    for g in cl.groups:
        assert (g.cpu_milli, g.mem_kib, g.priority) == (100, 512000, 0)
        t = g.index % 4
        assert g.spread == (("zone", 2) if t == 1 else None)
        assert g.affinity == (("zone", g.index) if t == 2 else None)
        assert g.anti == ("hostname" if t == 3 else None)
        assert g.labelled == (t != 0)
    dens = _cluster("density-backlog")
    assert not any(g.labelled for g in dens.groups)


def test_group_sequence_repeats_and_is_balanced():
    s1 = traffic.GroupSequence(8, 9).take(100)
    assert s1 == traffic.GroupSequence(8, 9).take(100)
    assert s1 != traffic.GroupSequence(8, 10).take(100)
    counts = collections.Counter(traffic.GroupSequence(8, 10).take(96))
    assert set(counts.values()) == {12}


@pytest.mark.parametrize("workload", ["flagship-backlog", "density-backlog"])
def test_fill_respects_the_constraints(workload):
    cl = _cluster(workload)
    place = traffic.fill_placement(cl)
    assert len(place) == cl.occupancy
    per_group = collections.defaultdict(list)
    for g, n in place:
        per_group[g].append(n)
    for g, ns in per_group.items():
        grp = cl.groups[g]
        zones = collections.Counter(cl.node_zone(n) for n in ns)
        if grp.anti:
            assert len(set(ns)) == len(ns)          # distinct nodes
        if grp.affinity:
            assert len(zones) == 1
        if grp.spread:
            assert len(zones) == len(cl.zones)
            assert max(zones.values()) - min(zones.values()) <= \
                grp.spread[1]
    per_node = collections.Counter(n for _, n in place)
    assert max(per_node.values()) <= cl.occupancy // cl.nodes + 1


def test_the_configurations_fill_at_full_size():
    for name in ("flagship-5k", "density-5k"):
        config = traffic.load_json(traffic.ROOT / "configs" / f"{name}.json")
        cl = traffic.build_cluster(config)
        place = traffic.fill_placement(cl)
        per_node = collections.Counter(n for _, n in place)
        assert len(per_node) == cl.nodes == 5000
        assert 29 <= min(per_node.values()) <= max(per_node.values()) <= 31
