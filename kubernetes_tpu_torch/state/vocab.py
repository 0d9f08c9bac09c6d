"""String interning: every label key/value, namespace, taint key, topology key,
resource name, node/pod name, and port triple becomes a stable small int before
it reaches the device.

The reference keeps string maps on every hot path (labels.Set is map[string]
string, predicates compare strings per (pod,node) pair). On TPU the string world
must be resolved once, host-side, into dense integer ids; all device kernels
operate on int32. Ids are append-only and never recycled within a process, so
device-resident arrays stay valid across incremental updates (the analog of the
reference cache's generation monotonicity, internal/cache/cache.go:89-102).
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, List, Optional, Tuple


class Vocab:
    """Append-only bidirectional string↔int map. id 0..n-1; -1 is the universal
    'absent' sentinel in device arrays."""

    __slots__ = ("_fwd", "_rev")

    def __init__(self) -> None:
        self._fwd: Dict[Hashable, int] = {}
        self._rev: List[Hashable] = []

    def intern(self, s: Hashable) -> int:
        i = self._fwd.get(s)
        if i is None:
            i = len(self._rev)
            self._fwd[s] = i
            self._rev.append(s)
        return i

    def get(self, s: Hashable) -> int:
        """-1 if unknown (device sentinel)."""
        return self._fwd.get(s, -1)

    def lookup(self, i: int) -> Hashable:
        return self._rev[i]

    def __len__(self) -> int:
        return len(self._rev)

    def __contains__(self, s: Hashable) -> bool:
        return s in self._fwd


INT_SENTINEL = -(2**31)  # label value that does not parse as int (Gt/Lt)


def parse_label_int(v: str) -> int:
    """Best-effort int64-ish parse used by Gt/Lt requirements
    (labels/selector.go:208-233 parses via strconv.ParseInt)."""
    try:
        x = int(v)
    except (ValueError, TypeError):
        return INT_SENTINEL
    # clamp into int32 range for device arrays; practical label ints
    # (ports, generation counters) fit comfortably
    return max(min(x, 2**31 - 1), -(2**31) + 1)


class VocabSet:
    """The full set of interning tables for one cluster state."""

    def __init__(self) -> None:
        self.label_keys = Vocab()
        self.label_vals = Vocab()
        self.namespaces = Vocab()
        self.node_names = Vocab()  # node names ONLY (matchFields/spec.nodeName match space)
        self.pod_names = Vocab()   # pod identity; kept separate so churning pods
                                   # never grow the node-name match space
        self.resources = Vocab()  # scalar/extended resource names only
        self.topo_keys = Vocab()  # topology keys referenced by any term/constraint
        self.port_pairs = Vocab()  # (protocol, port)
        self.port_triples = Vocab()  # (protocol, port, ip) with ip != wildcard
        self.images = Vocab()  # container image names (ImageLocality)
        self.volumes = Vocab()  # (driver, volume id) attachable volumes
        self.vol_drivers = Vocab()  # volume driver/plugin names
