"""Pod-at-a-time semantics (a copy of the three functions of the JAX
package's api/semantics.py that the port's host side needs: the preemption
pass's `Preemptor._pdb_blocked` matches PodDisruptionBudget selectors
against the labels of the existing pods, and intent replay's
`Scheduler.node_fits` checks a node's resources).

labels.Requirement.Matches — apimachinery labels/selector.go:192-215;
PodFitsResources — predicates.go:789-845.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .types import LabelSelector, Node, Op, Pod, Requirement, Resources


def requirement_matches(req: Requirement, labels: Dict[str, str]) -> bool:
    has = req.key in labels
    if req.op == Op.IN:
        return has and labels[req.key] in req.values
    if req.op == Op.NOT_IN:
        # selector.go:199-203 — absent key satisfies NotIn
        return (not has) or labels[req.key] not in req.values
    if req.op == Op.EXISTS:
        return has
    if req.op == Op.DOES_NOT_EXIST:
        return not has
    if req.op in (Op.GT, Op.LT):
        # selector.go:208-233 — key must exist, both sides parse as int64
        if not has:
            return False
        try:
            lhs = int(labels[req.key])
            rhs = int(req.values[0])
        except (ValueError, IndexError):
            return False
        return lhs > rhs if req.op == Op.GT else lhs < rhs
    raise AssertionError(req.op)


def selector_matches(sel: LabelSelector, labels: Dict[str, str]) -> bool:
    """Empty selector matches everything (labels.Everything). The
    preemption driver drops nil and empty PDB selectors before it gets here:
    for a PDB they match nothing (sched/preemption.py)."""
    return all(requirement_matches(r, labels) for r in sel.requirements)


def pod_fits_resources(
    pod: Pod, node: Node, used: Resources, used_pods: int
) -> Tuple[bool, List[str]]:
    """PodFitsResources (predicates.go:789-845): pods count, CPU, memory,
    ephemeral storage, then every scalar resource."""
    alloc = node.allocatable
    fails: List[str] = []
    if used_pods + 1 > alloc.pods:
        fails.append("pods")
    req = pod.requests
    if req.milli_cpu == 0 and req.memory_kib == 0 and req.ephemeral_kib == 0 and not req.scalars:
        return (not fails, fails)
    if req.milli_cpu > alloc.milli_cpu - used.milli_cpu:
        fails.append("cpu")
    if req.memory_kib > alloc.memory_kib - used.memory_kib:
        fails.append("memory")
    if req.ephemeral_kib > alloc.ephemeral_kib - used.ephemeral_kib:
        fails.append("ephemeral-storage")
    used_scalars = dict(used.scalars)
    alloc_scalars = dict(alloc.scalars)
    for name, amount in req.scalars:
        if amount > alloc_scalars.get(name, 0) - used_scalars.get(name, 0):
            fails.append(name)
    return (not fails, fails)
