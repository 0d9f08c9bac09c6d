"""Cache debugger: comparer + dumper, plus device-mirror drift detection.

Analog of kube-scheduler's `pkg/scheduler/internal/cache/debugger/`
(debugger.go:55-68: SIGUSR2 → CompareNodes/ComparePods + Dump). The batched
design adds a third check the reference doesn't need: `verify_staging`
re-encodes every node/pod row from scratch and diffs it against the
incrementally-patched host staging arrays — the guard against silent drift
in the device mirror that per-pod caches are less exposed to (the
cache-corruption Fatalf analog, cache.go:445,473)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..state.cache import SchedulerCache
from ..state.encode import Encoder


class CacheComparer:
    """debugger/comparer.go: cache contents vs the apiserver's view."""

    def __init__(self, cache: SchedulerCache, client=None):
        self.cache = cache
        self.client = client

    def compare_nodes(self, items: "Optional[List]" = None
                      ) -> Tuple[List[str], List[str]]:
        """(missing_from_cache, stale_in_cache) node names. `items` lets a
        caller that already listed the nodes (the periodic sweep, which
        also needs them for healing) skip a second full LIST."""
        if self.client is None and items is None:
            return [], []
        from ..machinery import meta

        if items is None:
            items = self.client.nodes.list()["items"]
        api_names = {meta.name(n) for n in items}
        cache_names = {n.name for n in self.cache.nodes()}
        return sorted(api_names - cache_names), sorted(cache_names - api_names)

    def compare_pods(self, items: "Optional[List]" = None
                     ) -> Tuple[List[str], List[str]]:
        """(missing_from_cache, stale_in_cache) pod keys; assumed pods are
        legitimately cache-only and excluded from staleness (comparer.go
        ComparePods ignores assumed). `items` as in compare_nodes."""
        if self.client is None and items is None:
            return [], []
        from ..machinery import meta

        if items is None:
            items = self.client.pods.list(None)["items"]
        api_keys = {f"{meta.namespace(p)}/{meta.name(p)}"
                    for p in items
                    if p.get("spec", {}).get("nodeName")}
        cache_keys = {p.key for p in self.cache.scheduled_pods()}
        assumed = {p.key for p in self.cache.scheduled_pods()
                   if self.cache.is_assumed(p.key)}
        return (sorted(api_keys - cache_keys),
                sorted(cache_keys - api_keys - assumed))

    def dump(self) -> str:
        """debugger/dumper.go: human-readable cache dump."""
        lines = [f"generation={self.cache.generation}"]
        by_node: Dict[str, List[str]] = {}
        for p in self.cache.scheduled_pods():
            mark = "*" if self.cache.is_assumed(p.key) else ""
            by_node.setdefault(p.node_name, []).append(p.key + mark)
        for n in self.cache.nodes():
            pods = ", ".join(sorted(by_node.get(n.name, []))) or "-"
            lines.append(f"node {n.name}: {pods}")
        orphans = by_node.keys() - {n.name for n in self.cache.nodes()}
        for nn in sorted(orphans):
            lines.append(f"node {nn} (GONE): {', '.join(by_node[nn])}")
        return "\n".join(lines)

    def verify_staging(self) -> List[str]:
        """Re-encode every live node row with a scratch staging buffer and
        diff against the incrementally-patched arrays. Any mismatch means the
        dirty-tracking patch path diverged from a from-scratch encode — the
        failure the reference guards with Fatalf on cache corruption."""
        cache = self.cache
        with cache._mu:
            enc: Encoder = cache._encoder
            staging = cache._staging_nodes
            if enc is None or staging is None or cache._snapshot is None:
                return []
            d = cache._snapshot.dims
            fresh = enc.empty_node_arrays(d)
            drift: List[str] = []
            for name, slot in cache._node_slot.items():
                node = cache._nodes.get(name)
                if node is None:
                    continue
                if name in cache._dirty_nodes:
                    # mutated since the last snapshot: staging is
                    # LEGITIMATELY behind until the next patch re-encodes
                    # this row — pending work, not drift
                    continue
                enc.encode_node_row(
                    fresh, slot, node,
                    list(cache._by_node.get(name, {}).values()), d)
                for fld in staging._fields:
                    a = getattr(staging, fld)[slot]
                    b = getattr(fresh, fld)[slot]
                    if not np.array_equal(a, b):
                        drift.append(f"node {name} field {fld}")
            return drift


class ConsistencySweeper:
    """Periodic cache-consistency sweep (the kube `cacheComparer` run on a
    timer instead of SIGUSR2): diff the scheduler's resident view — cache
    contents AND the incrementally-patched staging arrays behind the device
    `ClusterTables` — against informer/apiserver truth; log divergence,
    bump the consistency metrics, and SELF-HEAL: missing/stale objects are
    reconciled from truth and the snapshot is invalidated so the next wave
    re-encodes from scratch instead of trusting drifted patches.

    Assumed pods are exempt from staleness (they are legitimately
    cache-only until the Binding confirmation lands), exactly as the
    reference's ComparePods. Call `maybe_sweep(now)` from the serving loop;
    `sweep()` runs one pass unconditionally (the restart drill does)."""

    def __init__(self, scheduler, client=None, interval: float = 60.0,
                 log=print):
        self.scheduler = scheduler
        self.comparer = CacheComparer(scheduler.cache, client)
        self.interval = interval
        self.log = log
        self._last = 0.0
        # totals for tests/bench (the metrics registry keeps the gauges)
        self.sweeps = 0
        self.divergences = 0
        self.heals = 0

    def maybe_sweep(self, now: float) -> Optional[Dict[str, int]]:
        if now - self._last < self.interval:
            return None
        self._last = now
        return self.sweep()

    def sweep(self) -> Dict[str, int]:
        from .metrics import (CACHE_CONSISTENCY_DIVERGENCES,
                              CACHE_CONSISTENCY_HEALS,
                              CACHE_CONSISTENCY_SWEEPS)

        self.sweeps += 1
        CACHE_CONSISTENCY_SWEEPS.inc()
        # ONE list per resource per sweep: the same snapshot feeds both the
        # compare and (on divergence) the heal, so they can never disagree
        # and the apiserver sees half the LIST load
        # None (no client) must stay None: an EMPTY list would read as
        # "the apiserver has no objects" and flag the whole cache stale
        client = self.comparer.client
        node_items = client.nodes.list()["items"] if client else None
        pod_items = client.pods.list(None)["items"] if client else None
        miss_n, stale_n = self.comparer.compare_nodes(node_items)
        miss_p, stale_p = self.comparer.compare_pods(pod_items)
        drift = self.comparer.verify_staging()
        found = {"nodes_missing": len(miss_n), "nodes_stale": len(stale_n),
                 "pods_missing": len(miss_p), "pods_stale": len(stale_p),
                 "staging_drift": len(drift)}
        total = sum(found.values())
        if not total:
            return found
        self.divergences += total
        for kind, n in found.items():
            if n:
                CACHE_CONSISTENCY_DIVERGENCES.inc(n, kind=kind)
        self.log(f"cache consistency sweep: divergence {found} — healing "
                 f"with a full re-encode")
        self._heal(miss_n, stale_n, miss_p, stale_p, node_items, pod_items)
        self.heals += 1
        CACHE_CONSISTENCY_HEALS.inc()
        return found

    def _heal(self, miss_n, stale_n, miss_p, stale_p,
              node_items, pod_items) -> None:
        """Reconcile cache contents from the SAME listed truth the compare
        diagnosed from, then invalidate the snapshot: the next wave
        rebuilds staging + device tables from scratch (the one fix that
        covers every drift class at once)."""
        from ..api.v1 import node_from_v1, pod_from_v1
        from ..machinery import meta
        from ..state.cache import CacheError

        cache = self.scheduler.cache
        if self.comparer.client is not None:
            by_name = {meta.name(n): n for n in node_items}
            for name in miss_n:
                obj = by_name.get(name)
                if obj is not None:
                    cache.add_node(node_from_v1(obj))
            for name in stale_n:
                try:
                    cache.remove_node(name)
                except CacheError:
                    pass
            pods_by_key = {
                f"{meta.namespace(p)}/{meta.name(p)}": p
                for p in pod_items
                if p.get("spec", {}).get("nodeName")}
            for key in miss_p:
                obj = pods_by_key.get(key)
                if obj is not None:
                    try:
                        cache.add_pod(pod_from_v1(obj))
                    except CacheError:
                        pass
            for key in stale_p:
                try:
                    cache.remove_pod(key)
                except CacheError:
                    pass
        cache.invalidate_snapshot()


def install_sigusr2(comparer: CacheComparer, log=print) -> bool:
    """debugger.go:55-68: dump + compare on SIGUSR2 (main thread only)."""
    import signal
    import threading

    if threading.current_thread() is not threading.main_thread():
        return False

    def handler(signum, frame):
        miss_n, stale_n = comparer.compare_nodes()
        miss_p, stale_p = comparer.compare_pods()
        drift = comparer.verify_staging()
        log("=== scheduler cache dump (SIGUSR2) ===")
        log(comparer.dump())
        if miss_n or stale_n:
            log(f"node diff: missing={miss_n} stale={stale_n}")
        if miss_p or stale_p:
            log(f"pod diff: missing={miss_p} stale={stale_p}")
        if drift:
            log(f"DEVICE-MIRROR DRIFT: {drift}")

    try:
        signal.signal(signal.SIGUSR2, handler)
        return True
    except (ValueError, OSError):
        return False
