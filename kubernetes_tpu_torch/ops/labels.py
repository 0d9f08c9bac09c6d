"""Vectorized label/selector matching (port of the JAX package's ops/labels.py).

The tensor re-statement of apimachinery's labels.Requirement.Matches
(staging/src/k8s.io/apimachinery/pkg/labels/selector.go:192-215) and
v1helper.MatchNodeSelectorTerms. A label *set* is two parallel id arrays
(keys, vals) padded with -1; a requirement is (key, op, values[V], int_rhs).
Everything is broadcasting over small trailing axes (L, Q, V).
"""

from __future__ import annotations

import torch

from ..api.types import Op
from ..state.arrays import Array, LabelSetTable, NodeArrays, NodeTermTable, TermTable
from ..state.vocab import INT_SENTINEL


def _lookup(label_keys: Array, label_vals: Array, key: Array) -> tuple[Array, Array]:
    """label_keys/vals: [..., L]; key: [...] → (has: [...], val: [...]).
    Keys are unique within a set; -1 pads never match (-1 keys vs key>=0)."""
    eq = (label_keys == key[..., None]) & (key[..., None] >= 0)
    has = eq.any(-1)
    val = torch.where(eq, label_vals, -1).amax(-1)
    return has, val


def _lookup_int(label_keys: Array, label_ints: Array, key: Array) -> Array:
    eq = (label_keys == key[..., None]) & (key[..., None] >= 0)
    return torch.where(eq, label_ints, INT_SENTINEL).amax(-1)


def match_requirements(
    req_keys: Array,   # [..., Q]
    req_ops: Array,    # [..., Q]
    req_vals: Array,   # [..., Q, V]
    req_ints,          # [..., Q] or None
    label_keys: Array, # [..., L]
    label_vals: Array, # [..., L]
    label_ints,        # [..., L] or None
) -> Array:
    """AND over Q requirements (padded key == -1 ⇒ vacuously true) → [...] bool.
    Semantics per labels/selector.go:192-215:
      IN:             has && val ∈ values
      NOT_IN:         !has || val ∉ values          (absent key satisfies NotIn)
      EXISTS:         has
      DOES_NOT_EXIST: !has
      GT/LT:          has && int(val) <op> rhs      (non-numeric never matches)
    """
    lk = label_keys[..., None, :]  # [..., 1(Q), L]
    lv = label_vals[..., None, :]
    has, val = _lookup(lk, lv, req_keys)  # [..., Q]
    in_vals = ((val[..., None] == req_vals) & (req_vals >= 0)).any(-1)

    if label_ints is not None and req_ints is not None:
        ival = _lookup_int(lk, label_ints[..., None, :], req_keys)
        # both sides must parse as ints (selector.go:208-233)
        numeric = has & (ival != INT_SENTINEL) & (req_ints != INT_SENTINEL)
        res_gt = numeric & (ival > req_ints)
        res_lt = numeric & (ival < req_ints)
    else:
        res_gt = torch.zeros_like(has)
        res_lt = torch.zeros_like(has)

    # jnp.select: the FIRST true condition wins, so nest from the last one
    per_req = res_lt
    for cond, res in reversed((
        (req_keys < 0, torch.ones_like(has)),
        (req_ops == int(Op.IN), has & in_vals),
        (req_ops == int(Op.NOT_IN), ~has | ~in_vals),
        (req_ops == int(Op.EXISTS), has),
        (req_ops == int(Op.DOES_NOT_EXIST), ~has),
        (req_ops == int(Op.GT), res_gt),
    )):
        per_req = torch.where(cond, res, per_req)
    return per_req.all(-1)


def node_term_matrix(nterms: NodeTermTable, nodes: NodeArrays) -> Array:
    """[SN, N] bool: does node-selector term s match node n (matchExpressions
    with Gt/Lt AND matchFields on metadata.name; invalid terms match
    nothing)."""
    expr_ok = match_requirements(
        nterms.keys[:, None, :],            # [SN, 1, Q]
        nterms.ops[:, None, :],
        nterms.vals[:, None, :, :],
        nterms.ints[:, None, :],
        nodes.label_keys[None, :, :],       # [1, N, L]
        nodes.label_vals[None, :, :],
        nodes.label_ints[None, :, :],
    )  # [SN, N]
    field_hit = (
        (nterms.fields[:, None, :] == nodes.name_id[None, :, None])
        & (nterms.fields[:, None, :] >= 0)
    ).any(-1)  # [SN, N]
    field_ok = (nterms.nfields[:, None] == 0) | field_hit
    return nterms.valid[:, None] & expr_ok & field_ok & nodes.valid[None, :]


def term_labelset_matrix(terms: TermTable, labelsets: LabelSetTable) -> Array:
    """[S, SL] bool: does pod-selector term s match label set l (an empty
    selector matches everything)."""
    return match_requirements(
        terms.req_keys[:, None, :],     # [S, 1, Q]
        terms.req_ops[:, None, :],
        terms.req_vals[:, None, :, :],
        None,
        labelsets.keys[None, :, :],     # [1, SL, L]
        labelsets.vals[None, :, :],
        None,
    ) & terms.valid[:, None]


def ns_bit(ns_words: Array, ns_id: Array) -> Array:
    """ns_words: [..., NW] bitset words (u32 bits held as i32); ns_id: [...]
    → [...] bool membership. `(w >> s) & 1` reads bit s of the int32 view
    exactly: the arithmetic shift only fills bits above it."""
    word = torch.take_along_dim(
        ns_words, (torch.clamp(ns_id, min=0) >> 5)[..., None].long(), dim=-1
    )[..., 0]
    bit = (word >> (ns_id & 31)) & 1
    return (bit == 1) & (ns_id >= 0)
