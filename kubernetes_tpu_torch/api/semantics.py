"""Label-selector matching, pod at a time (a copy of the two functions of the
JAX package's api/semantics.py that the preemption driver needs:
`Preemptor._pdb_blocked` matches PodDisruptionBudget selectors against the
labels of the existing pods on the host).

labels.Requirement.Matches — apimachinery labels/selector.go:192-215.
"""

from __future__ import annotations

from typing import Dict

from .types import LabelSelector, Op, Requirement


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
