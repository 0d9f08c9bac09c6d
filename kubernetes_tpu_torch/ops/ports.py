"""Host-port conflict checking as bitset tensor ops (port of the JAX package's
ops/ports.py).

PodFitsHostPorts (predicates.go:1104-1120): a wanted (proto, ip, port)
conflicts with an existing one iff same proto+port and (either side is the
0.0.0.0 wildcard or the IPs are equal). Nodes carry three bitsets — pair_any,
pair_wild, triple — and each port-set class the matching word masks.
"""

from __future__ import annotations

from ..state.arrays import Array


def port_conflict_row(
    wild_words: Array, pair_words: Array, trip_words: Array,
    ppa: Array, ppw: Array, ppt: Array,
) -> Array:
    """[B, N] bool conflict for port-set words [B, W] against live node
    bitsets [N, W]."""
    hits = (wild_words[:, None, :] & ppa[None]) | (pair_words[:, None, :] & ppw[None])
    return (hits != 0).any(-1) | ((trip_words[:, None, :] & ppt[None]) != 0).any(-1)
