"""Device tensor schemas: the flat tensors the scheduler's hot path runs on.

The same NamedTuples as the JAX package's state/arrays.py, field for field,
with `Array = torch.Tensor` (see that module for the class-interning design and
the citations into the reference). The encoder (state/encode.py) fills them
with numpy arrays; `tables_to_torch` moves them onto a torch device.

Dtypes on the device: ids and counts are int32, flags are bool, and the
uint32 bitset words of the encoder are REINTERPRETED as int32 (same bits):
torch has no `>>` on uint32 on the CPU, and every word operation the engine
needs (`&`, `|`, `!= 0`, `(w >> s) & 1`, popcount) reads the same bits from
an int32 view — an arithmetic shift only changes the bits above the one
extracted.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

Array = torch.Tensor


class NodeArrays(NamedTuple):
    valid: Array          # [N] bool
    name_id: Array        # [N] i32 node-name vocab id
    alloc: Array          # [N, R] i32 allocatable (milliCPU, KiB, KiB, pods, scalars…)
    used: Array           # [N, R] i32 requested by existing+assumed pods
    label_keys: Array     # [N, L] i32, -1 pad
    label_vals: Array     # [N, L] i32
    label_ints: Array     # [N, L] i32 parsed int value (INT_SENTINEL if not numeric)
    unschedulable: Array  # [N] bool
    taint_keys: Array     # [N, TT] i32, -1 pad
    taint_vals: Array     # [N, TT] i32
    taint_effects: Array  # [N, TT] i32 (TaintEffect), -1 pad
    topo: Array           # [N, K] i32 label-value id per topo key, -1 absent
    domain: Array         # [N, K] i32 compact per-key domain index, -1 absent
    port_pair_any: Array  # [N, PWp] i32 words — (proto,port) used by any pod (any IP)
    port_pair_wild: Array # [N, PWp] i32 words — (proto,port) used with wildcard IP
    port_triple: Array    # [N, PWt] i32 words — (proto,port,ip) exact triples in use
    img_words: Array      # [N, IW] i32 words — image-presence bitset (ImageLocality)
    vol_any: Array        # [N, VW] i32 words — volumes attached by pods on the node
    vol_rw: Array         # [N, VW] i32 words — volumes attached read-write
    vol_limit: Array      # [N, DR] i32 — per-driver attach limits, -1 unlimited
    avoid: Array          # [N] bool — preferAvoidPods annotation present
                          # (NodePreferAvoidPods score, node_prefer_avoid_pods.go)


class ReqTable(NamedTuple):
    """Distinct request vectors."""

    vec: Array  # [SR, R] i32


class LabelSetTable(NamedTuple):
    """Distinct pod label sets (the 'matched-by-selectors' side)."""

    keys: Array  # [SL, PL] i32, -1 pad
    vals: Array  # [SL, PL] i32


class NodeTermTable(NamedTuple):
    """Distinct node-selector terms (node-affinity terms and spec.nodeSelector
    lowered to an AND-of-IN term)."""

    valid: Array    # [SN] bool
    keys: Array     # [SN, Q] i32, -1 pad
    ops: Array      # [SN, Q] i32 (Op)
    vals: Array     # [SN, Q, V] i32, -1 pad
    ints: Array     # [SN, Q] i32 rhs for Gt/Lt
    fields: Array   # [SN, F] i32 metadata.name ids, -1 pad
    nfields: Array  # [SN] i32 count of matchFields values


class TolSetTable(NamedTuple):
    """Distinct toleration sets."""

    valid: Array    # [STL, TL] bool
    keys: Array     # [STL, TL] i32, -1 = empty key (match all)
    ops: Array      # [STL, TL] i32 (TolerationOp)
    vals: Array     # [STL, TL] i32, -1 = empty value
    effects: Array  # [STL, TL] i32, -1 = all effects


class PortSetTable(NamedTuple):
    """Distinct host-port sets, plus precomputed bitset word-masks for O(words)
    conflict checks and scan-time node updates."""

    pair: Array        # [SPP, PP] i32 pair id, -1 pad
    triple: Array      # [SPP, PP] i32 triple id, -1 pad
    wild: Array        # [SPP, PP] bool
    pair_words: Array  # [SPP, PWp] i32 words — union of pair bits
    wild_words: Array  # [SPP, PWp] i32 words — union of wildcard pair bits
    trip_words: Array  # [SPP, PWt] i32 words — union of triple bits


class VolSetTable(NamedTuple):
    """Distinct attachable-volume sets (NoDiskConflict + max-volume-count;
    predicates.go:156-221, csi_volume_predicate.go:89). Bitsets are over the
    volume vocab; per-driver occupancy is DERIVED from bitsets by popcount
    against `ClusterTables.drv_masks`, so the engines carry only two [N, VW]
    words per node."""

    any_words: Array  # [SV, VW] i32 words — all volumes in the set
    rw_words: Array   # [SV, VW] i32 words — volumes mounted read-write


class TermTable(NamedTuple):
    """Interned pod-affinity / anti-affinity / topology-spread terms:
    (label selector, concrete namespace set, topology key)."""

    valid: Array      # [S] bool
    req_keys: Array   # [S, Q] i32, -1 pad
    req_ops: Array    # [S, Q] i32 (Op; label-selector subset)
    req_vals: Array   # [S, Q, V] i32, -1 pad
    ns_words: Array   # [S, NW] i32 words namespace bitset
    topo_key: Array   # [S] i32 topo-key index, -1 if unused


class PodClassTable(NamedTuple):
    """The pod-spec template: one row per distinct scheduling spec."""

    valid: Array        # [SC] bool
    ns: Array           # [SC] i32 namespace id (part of the class key)
    rid: Array          # [SC] i32 → ReqTable
    labelset: Array     # [SC] i32 → LabelSetTable
    nsel_term: Array    # [SC] i32 → NodeTermTable (spec.nodeSelector), -1 none
    aff_active: Array   # [SC] bool — node-affinity required present
    nterm_ids: Array    # [SC, T] i32 → NodeTermTable, -1 pad (OR of terms)
    pterm_ids: Array    # [SC, PT] i32 → NodeTermTable, -1 pad (preferred)
    pterm_w: Array      # [SC, PT] i32 weights 1-100
    tolset: Array       # [SC] i32 → TolSetTable
    portset: Array      # [SC] i32 → PortSetTable, -1 = no ports
    aff_terms: Array    # [SC, AT] i32 → TermTable, -1 pad
    anti_terms: Array   # [SC, AN] i32 → TermTable
    paff_terms: Array   # [SC, PAT] i32 → TermTable
    paff_w: Array       # [SC, PAT] i32
    panti_terms: Array  # [SC, PAN] i32 → TermTable
    panti_w: Array      # [SC, PAN] i32
    tsc_term: Array     # [SC, TS] i32 → TermTable, -1 pad
    tsc_key: Array      # [SC, TS] i32 topo-key index
    tsc_maxskew: Array  # [SC, TS] i32
    tsc_hard: Array     # [SC, TS] bool (DoNotSchedule)
    volset: Array       # [SC] i32 → VolSetTable, -1 = no attachable volumes
    ssel_terms: Array   # [SC, SS] i32 → TermTable (SelectorSpread owners), -1 pad
    img_ids: Array      # [SC, CI] i32 → image vocab (ImageLocality), -1 pad
    lim_rid: Array      # [SC] i32 → ReqTable (container limits), -1 none


class PodArrays(NamedTuple):
    """Per-pod identity; everything spec-like lives in the class."""

    valid: Array         # [P] bool
    name_id: Array       # [P] i32
    ns: Array            # [P] i32
    cls: Array           # [P] i32 → PodClassTable
    priority: Array      # [P] i32
    creation: Array      # [P] i32 creation ordering index
    node_id: Array       # [P] i32 bound/assumed node index, -1 unbound
    node_name_req: Array # [P] i32 spec.nodeName as name id, -1 none


class ImageTable(NamedTuple):
    """Interned container images: size in KiB per image id (ImageLocality;
    nodeinfo ImageStateSummary.Size analog — NumNodes is derived on device
    from NodeArrays.img_words so it stays patch-friendly)."""

    size_kib: Array  # [IMG] i32


class ClusterTables(NamedTuple):
    """Everything static-per-cycle bundled for the jitted lattice fns."""

    nodes: NodeArrays
    reqs: ReqTable
    labelsets: LabelSetTable
    nterms: NodeTermTable
    tolsets: TolSetTable
    portsets: PortSetTable
    terms: TermTable
    classes: PodClassTable
    images: ImageTable
    zone_keys: Array  # [2] i32 topo-key ids (modern, legacy zone label), -1 absent
    volsets: VolSetTable
    drv_masks: Array  # [DR, VW] i32 words — which volume-vocab bits belong to driver d


_TUPLES = {cls.__name__: cls for cls in (
    NodeArrays, ReqTable, LabelSetTable, NodeTermTable, TolSetTable,
    PortSetTable, VolSetTable, TermTable, PodClassTable, PodArrays,
    ImageTable, ClusterTables)}


def _to_torch(x, device: torch.device, copy: bool = False):
    """Recursively rebuild an encoder NamedTuple (either package's classes,
    matched by name) as the port's NamedTuple of tensors on `device`. With
    `copy`, every tensor owns its memory even where `.to(device)` would
    alias the numpy array (a CPU device)."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        cls = _TUPLES[type(x).__name__]
        return cls(*(_to_torch(getattr(x, f), device, copy)
                     for f in cls._fields))
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype not in (np.int32, np.bool_):
        raise TypeError(f"unexpected encoder dtype {a.dtype}")
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=copy)


def tables_to_torch(
    tables, pods: Sequence, device,
) -> Tuple[ClusterTables, Tuple[PodArrays, ...]]:
    """Move the encoder's numpy `ClusterTables` and each `PodArrays` in `pods`
    onto `device` as the port's tensors: the one seam between host encoding
    and device work. Accepts the output of either package's Encoder."""
    device = torch.device(device)
    return (_to_torch(tables, device),
            tuple(_to_torch(p, device) for p in pods))


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. Raises when the card is asked for and absent — nothing
    moves to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def to_device(x, device: torch.device):
    """One encoder NamedTuple (ClusterTables, one of its tables, PodArrays) or
    one numpy plane as the port's tensors on `device`, always as a COPY:
    the serving cache keeps writing its host staging arrays in place after
    the move, and a snapshot taken before must not see those writes (on a
    CPU device a plain `.to(device)` would share their memory). Same dtype
    rules as `tables_to_torch`: uint32 words become their int32 view, and
    only int32 and bool are accepted."""
    return _to_torch(x, device, copy=True)
