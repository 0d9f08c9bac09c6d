"""Attachable-volume predicates as bitset ops: NoDiskConflict + the
max-volume-count family (port of the JAX package's ops/volumes.py).

  * NoDiskConflict (predicates.go:156-221): two mounts of the same volume on
    one node conflict unless both are read-only;
  * MaxPDVolumeCount / CSIMaxVolumeLimit (predicates.go:223-…,
    csi_volume_predicate.go:89-160): distinct attachable volumes per driver on
    a node stay within the node's per-driver limit (-1 = unlimited).

Per-node state is two bitsets over the volume vocab (vol_any, vol_rw);
per-driver occupancy is a popcount against static driver masks.
"""

from __future__ import annotations

from ..state.arrays import Array, ClusterTables


def popcount32(x: Array) -> Array:
    """Per-element popcount of int32 words (torch has no popcount). SWAR on
    the int32 view: every mask clears the sign bits an arithmetic shift
    fills, so the count equals the uint32 popcount of the same bits."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def volume_components_row(
    tables: ClusterTables,
    vol_any: Array,   # [N, VW] live attached bitset
    vol_rw: Array,    # [N, VW] live read-write bitset
    cls: Array,       # [B] class ids
) -> tuple[Array, Array]:
    """([B, N] conflict_free, [B, N] limit_ok) per class against the live
    node volume state; separable so VolumeRestrictions and NodeVolumeLimits
    toggle independently."""
    nodes = tables.nodes
    vs = tables.classes.volset[cls]
    safe = vs.clamp(min=0).long()
    mine_any = tables.volsets.any_words[safe][:, None, :]   # [B, 1, VW]
    mine_rw = tables.volsets.rw_words[safe][:, None, :]
    absent = (vs < 0)[:, None]

    conflict = (((mine_any & vol_rw[None]) != 0).any(-1)
                | ((mine_rw & vol_any[None]) != 0).any(-1))

    after = vol_any[None] | mine_any                          # [B, N, VW]
    cnt = popcount32(
        after[:, :, None, :] & tables.drv_masks[None, None]
    ).sum(-1)                                                 # [B, N, DR]
    lim = nodes.vol_limit[None]                                # [1, N, DR]
    limit_ok = ((lim < 0) | (cnt <= lim)).all(-1)
    return absent | ~conflict, absent | limit_ok


def volume_ok_row(tables: ClusterTables, vol_any: Array, vol_rw: Array,
                  cls: Array) -> Array:
    """[B, N] bool: both volume predicates (the diagnosis surface)."""
    conflict_free, limit_ok = volume_components_row(tables, vol_any, vol_rw,
                                                    cls)
    return conflict_free & limit_ok
