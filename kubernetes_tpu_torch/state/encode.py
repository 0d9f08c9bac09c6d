"""Host → device encoding: Pod/Node object graphs become flat class-interned arrays.

The analog of the reference's snapshot construction (internal/cache/cache.go:204-255
UpdateNodeInfoSnapshot + nodeinfo/snapshot/snapshot.go), except the snapshot is a
set of rectangular int32 tensors ready for one pjit'd lattice evaluation, strings
are interned (state/vocab.py), and pod specs are deduplicated into equivalence
classes (state/arrays.py docstring).

The Encoder is long-lived: vocab/registry ids are append-only across cycles so
device arrays can be patched incrementally (state/cache.py) instead of re-encoded.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api.types import (
    NUM_FIXED_RES,
    RES_PODS,
    HostPort,
    LabelSelector,
    Node,
    NodeSelector,
    NodeSelectorTerm,
    Op,
    Pod,
    PodAffinityTerm,
    Requirement,
    Resources,
)
from .arrays import (
    ClusterTables,
    GangArrays,
    LabelSetTable,
    NodeArrays,
    NodeTermTable,
    PodArrays,
    PodClassTable,
    PortSetTable,
    ReqTable,
    TermTable,
    TolSetTable,
)
from .dims import Dims
from .vocab import Vocab, VocabSet, parse_label_int

I32 = np.int32
U32 = np.uint32



# GetZoneKey's label precedence (pkg/util/node): the modern topology label,
# falling back to the pre-1.17 failure-domain beta label
ZONE_TOPO_KEYS = ("topology.kubernetes.io/zone",
                  "failure-domain.beta.kubernetes.io/zone")


class ProjectionUnconvergedError(RuntimeError):
    """The selector→label projection re-walk failed to reach a fixpoint:
    every pass referenced yet another pod-label key. Encoding would produce
    stale class ids (silently wrong placements), so the snapshot build
    raises instead. In practice this means a pathological workload keeps
    introducing selectors over never-before-seen keys faster than the walk
    converges — surface it to the operator rather than mis-schedule."""


def _set_bit(words: np.ndarray, idx: int) -> None:
    words[idx >> 5] |= U32(1) << U32(idx & 31)


def _evict_half(memo: Dict, cap: int) -> None:
    """Bound an id-keyed memo: drop the OLDEST half (dict preserves insertion
    order) instead of clearing wholesale, so a long-running process never
    pays a full cold re-walk spike and dead objects don't pile up forever."""
    if len(memo) > cap:
        for k in list(memo.keys())[: cap // 2]:
            del memo[k]


def nsel_as_term(node_selector: Dict[str, str]) -> NodeSelectorTerm:
    """spec.nodeSelector lowered to an AND-of-IN node term
    (predicates.go:879-886 uses labels.SelectorFromSet — equality match)."""
    return NodeSelectorTerm(
        requirements=tuple(
            Requirement(k, Op.IN, (v,)) for k, v in sorted(node_selector.items())
        )
    )


class Encoder:
    """Stateful interner: object graphs → integer ids → numpy tables."""

    def __init__(self) -> None:
        self.vocabs = VocabSet()
        self.req_reg = Vocab()       # resource-vector tuples
        self.labelset_reg = Vocab()  # sorted ((key_id, val_id), …)
        self.nterm_reg = Vocab()     # ((key_id, op, val_ids, int_rhs), …), field_ids
        self.tolset_reg = Vocab()    # toleration tuples
        self.portset_reg = Vocab()   # host-port tuples
        self.term_reg = Vocab()      # (sel req tuple, ns_id tuple, topo_key_id)
        self.class_reg = Vocab()     # the full pod-spec tuple
        self._class_spec: List[tuple] = []  # parallel to class_reg ids
        # Label projection (the TPU-first class-collapse move): a pod's
        # labels enter its CLASS identity only through the keys some
        # selector in the system actually matches pod labels by (term_id's
        # requirement keys — pod affinity/anti-affinity, topology spread,
        # SelectorSpread owner selectors). Unreferenced labels cannot
        # change any engine decision, so folding them out merges e.g.
        # thousands of `app: job-N`-labeled gang jobs with identical
        # requests into ONE scheduling class — the wave fixpoint then
        # scales with *distinguishable* specs, not raw label diversity
        # (BASELINE config 5 goes from ~P/30 classes to ~#tiers).
        # When a never-before-seen key becomes referenced, every projected
        # class is potentially split: `classes_stale` tells the cache to
        # clear row memos and re-walk (SchedulerCache.snapshot).
        self.referenced_label_keys: set = set()   # label-key vocab ids
        self.referenced_label_strs: set = set()   # the same keys, as strings
        self.classes_stale = False
        # value-based class memo: spec fingerprint (namespace id + the raw
        # field values class_id would walk) → class id. This is the batch-
        # ingest fast path: template-stamped pods (Deployments, gang jobs)
        # produce value-equal specs in FRESH objects per informer event, so
        # identity memos miss but this hits — the full class_id walk then
        # runs once per distinct template, not once per pod. Invalidated
        # with the row memos when the label projection widens
        # (projection_rewalk): fingerprints embed the projected label set.
        self._class_memo: Dict[tuple, int] = {}
        # incremental-encode state (the cache.go:204-255 analog's host half):
        # per-object memos so steady-state cycles do O(changed) interning work.
        self._pod_rows: Dict[int, tuple] = {}   # id(pod) → (pod, row tuple)
        self._node_seen: Dict[int, Node] = {}   # id(node) → node (interned)
        # append-only compact domain index per topo key (node label value →
        # dense domain id); persistent so device rows stay patchable
        self.domain_maps: List[Dict[int, int]] = []
        # monotonic capacity trackers (capacities never shrink, so running
        # maxima replace O(N) rescans of the node set on every dims() call)
        self._max_node_labels = 1
        self._max_node_taints = 1
        self._node_domains_done: Dict[int, tuple] = {}
        self.image_sizes: List[int] = []  # KiB, parallel to vocabs.images
        self.volset_reg = Vocab()   # sorted ((vol_id, driver_id, ro), …)
        self.vol_driver: List[int] = []  # driver id per volume vocab id
        # gang pod groups (BASELINE config 5; ops/gang.py): group key → id +
        # effective minMember per id. UNLIKE every other vocab these are
        # compactable (compact_groups): gang jobs churn per-job, and dead
        # ids would otherwise grow GR — and with it GangArrays and the full-
        # re-encode cadence — forever. Nothing device-resident stores group
        # ids between snapshots, which is what makes compaction safe.
        self.pod_groups = Vocab()
        self.group_min: Dict[int, int] = {}
        # authoritative minMember per group KEY (PodGroup objects); survives
        # compaction, overrides pod-carried hints
        self.group_spec: Dict[str, int] = {}

    # ---------------- gang groups ---------------- #

    def group_id(self, p: Pod) -> int:
        """Intern a pod's gang group; -1 for ungrouped pods. Folds the
        pod-carried minMember hint into the group's effective minimum."""
        key = p.group_key
        if not key:
            return -1
        g = self.pod_groups.intern(key)
        spec = self.group_spec.get(key)
        if spec is not None:
            self.group_min[g] = spec
        elif p.min_member > self.group_min.get(g, 0):
            self.group_min[g] = p.min_member
        return g

    def set_group_min(self, group_key: str, min_member: int) -> None:
        """Authoritative minMember from a PodGroup object (overrides
        pod-carried hints)."""
        self.group_spec[group_key] = int(min_member)
        g = self.pod_groups.get(group_key)
        if g >= 0:
            self.group_min[g] = int(min_member)

    def compact_groups(self, live_pods) -> None:
        """Drop dead group ids, re-interning only groups that still have
        live pods — the gang analog of rebuild_domain_maps, called at full
        re-encode time (the free moment: every array rebuilds anyway)."""
        self.pod_groups = Vocab()
        self.group_min = {}
        for p in live_pods:
            self.group_id(p)

    # ---------------- sub-object interning ---------------- #

    def req_id(self, r: Resources) -> int:
        scalars = tuple(
            (self.vocabs.resources.intern(name), amt) for name, amt in r.scalars
        )
        return self.req_reg.intern(
            (r.milli_cpu, r.memory_kib, r.ephemeral_kib, scalars)
        )

    def labelset_id(self, labels: Dict[str, str]) -> int:
        key = tuple(
            sorted(
                (self.vocabs.label_keys.intern(k), self.vocabs.label_vals.intern(v))
                for k, v in labels.items()
            )
        )
        return self.labelset_reg.intern(key)

    def nterm_id(self, term: NodeSelectorTerm) -> int:
        reqs = []
        for r in term.requirements:
            kid = self.vocabs.label_keys.intern(r.key)
            vids = tuple(self.vocabs.label_vals.intern(v) for v in r.values)
            rhs = parse_label_int(r.values[0]) if (r.op in (Op.GT, Op.LT) and r.values) else 0
            reqs.append((kid, int(r.op), vids, rhs))
        fields = tuple(self.vocabs.node_names.intern(f) for f in term.field_name_in)
        return self.nterm_reg.intern((tuple(reqs), fields))

    def tolset_id(self, tols) -> int:
        key = []
        for t in tols:
            kid = self.vocabs.label_keys.intern(t.key) if t.key else -1
            # value is always interned — "" is a real value that must compare
            # equal to an empty taint value (toleration.go:49-50)
            vid = self.vocabs.label_vals.intern(t.value)
            eff = -1 if t.effect is None else int(t.effect)
            key.append((kid, int(t.op), vid, eff))
        return self.tolset_reg.intern(tuple(key))

    def portset_id(self, ports: Sequence[HostPort]) -> int:
        key = []
        for hp in ports:
            if hp.port == 0:
                continue
            pair = self.vocabs.port_pairs.intern((hp.protocol, hp.port))
            wild = hp.host_ip in ("", "0.0.0.0")
            trip = -1 if wild else self.vocabs.port_triples.intern(
                (hp.protocol, hp.port, hp.host_ip)
            )
            key.append((pair, trip, wild))
        return self.portset_reg.intern(tuple(sorted(key)))

    def term_id(self, selector: LabelSelector, namespaces: Sequence[str], topo_key: str) -> int:
        reqs = []
        for r in selector.requirements:
            kid = self.vocabs.label_keys.intern(r.key)
            if kid not in self.referenced_label_keys:
                # a new pod-label key is now selector-visible: projected
                # class identities must be recomputed (see __init__ note)
                self.referenced_label_keys.add(kid)
                self.referenced_label_strs.add(r.key)
                self.classes_stale = True
            vids = tuple(sorted(self.vocabs.label_vals.intern(v) for v in r.values))
            reqs.append((kid, int(r.op), vids))
        ns_ids = tuple(sorted(self.vocabs.namespaces.intern(n) for n in namespaces))
        tk = self.vocabs.topo_keys.intern(topo_key)
        self.vocabs.label_keys.intern(topo_key)  # topo keys are label keys
        return self.term_reg.intern((tuple(reqs), ns_ids, tk))

    def pod_term_id(self, term: PodAffinityTerm, owner: Pod) -> int:
        ns = term.namespaces if term.namespaces else (owner.namespace,)
        return self.term_id(term.selector, ns, term.topology_key)

    # ---------------- class interning ---------------- #

    def image_id(self, name: str, size_kib: int = 0) -> int:
        """Intern a container image; first size seen wins (ImageStateSummary
        keeps one size per image, nodeinfo/node_info.go image states)."""
        before = len(self.vocabs.images)
        i = self.vocabs.images.intern(name)
        if i == before:
            self.image_sizes.append(size_kib)
        elif size_kib and not self.image_sizes[i]:
            self.image_sizes[i] = size_kib
        return i

    def volume_id(self, vol) -> int:
        """Intern one VolumeRef's (driver, id) identity; the driver of a
        volume is part of its identity (a PD name and an EBS id never
        collide)."""
        did = self.vocabs.vol_drivers.intern(vol.driver)
        before = len(self.vocabs.volumes)
        vid = self.vocabs.volumes.intern((vol.driver, vol.vol_id))
        if vid == before:
            self.vol_driver.append(did)
        return vid

    def volset_id(self, vols) -> int:
        key = tuple(sorted(
            (self.volume_id(v), self.vocabs.vol_drivers.intern(v.driver),
             bool(v.read_only))
            for v in vols))
        return self.volset_reg.intern(key)

    def projection_rewalk(self) -> None:
        """A new label key became selector-referenced: drop the row memos so
        the owner re-walks every pod under the widened projection."""
        self.classes_stale = False
        self._pod_rows.clear()
        self._class_memo.clear()

    def _projected_labels(self, labels: Dict[str, str]) -> Dict[str, str]:
        if not labels:
            return labels
        ref = self.referenced_label_keys
        get = self.vocabs.label_keys.get
        return {k: v for k, v in labels.items() if get(k) in ref}

    def class_fingerprint(self, p: Pod, ns_id: int) -> tuple:
        """Value-based spec fingerprint: equal fingerprints ⇒ class_id would
        intern the same spec tuple. Built from raw field VALUES (everything
        class_id walks), with two costs avoided on the template-stamped hot
        path: labels collapse to the projected subset (unreferenced keys
        cannot enter class identity, see __init__), and an all-empty
        Affinity collapses to None so the per-pod fresh Affinity object
        never pays a Python dataclass hash/eq."""
        ref = self.referenced_label_strs
        labels = p.labels
        lk = tuple(sorted(
            (k, v) for k, v in labels.items() if k in ref)) \
            if (ref and labels) else ()
        aff = p.affinity
        if (aff.node_required is None and not aff.node_preferred
                and not aff.pod_required and not aff.anti_required
                and not aff.pod_preferred and not aff.anti_preferred):
            aff = None
        r = p.requests
        nsel = p.node_selector
        lim = p.limits
        return (ns_id, r.milli_cpu, r.memory_kib, r.ephemeral_kib, r.scalars,
                lk, tuple(sorted(nsel.items())) if nsel else None, aff,
                p.tolerations, p.host_ports, p.topology_spread,
                p.spread_selectors, p.images,
                lim if (lim.milli_cpu or lim.memory_kib) else None,
                p.volumes)

    def class_id_memo(self, p: Pod, ns_id: int) -> int:
        """class_id through the value-based fingerprint memo: the full spec
        walk runs once per distinct template, not once per pod."""
        key = self.class_fingerprint(p, ns_id)
        cid = self._class_memo.get(key)
        if cid is None:
            cid = self.class_id(p)
            _evict_half(self._class_memo, 1 << 16)
            self._class_memo[key] = cid
        return cid

    def class_id(self, p: Pod) -> int:
        ns_id = self.vocabs.namespaces.intern(p.namespace)
        rid = self.req_id(p.requests)
        ls = self.labelset_id(self._projected_labels(p.labels))
        nsel = self.nterm_id(nsel_as_term(p.node_selector)) if p.node_selector else -1
        aff_active = p.affinity.node_required is not None
        nterms = tuple(
            self.nterm_id(t) for t in (p.affinity.node_required.terms if aff_active else ())
            if (t.requirements or t.field_name_in)
        )
        pterms = tuple(
            (self.nterm_id(w.term), w.weight)
            for w in p.affinity.node_preferred
            if (w.term.requirements or w.term.field_name_in)
        )
        tol = self.tolset_id(p.tolerations)
        ports = self.portset_id(p.host_ports)
        aff = tuple(self.pod_term_id(t, p) for t in p.affinity.pod_required)
        anti = tuple(self.pod_term_id(t, p) for t in p.affinity.anti_required)
        paff = tuple((self.pod_term_id(w.term, p), w.weight) for w in p.affinity.pod_preferred)
        panti = tuple((self.pod_term_id(w.term, p), w.weight) for w in p.affinity.anti_preferred)
        tsc = tuple(
            (
                self.term_id(c.selector, (p.namespace,), c.topology_key),
                self.vocabs.topo_keys.intern(c.topology_key),
                c.max_skew,
                int(c.when_unsatisfiable) == 0,
            )
            for c in p.topology_spread
        )
        # SelectorSpread owner selectors: countMatchingPods requires a pod to
        # match EVERY owner selector (selector_spreading.go:198-218), so the
        # conjunction is interned as ONE term with an empty topology key
        # (counting is per-node via CNT; zone weighting uses the well-known
        # zone keys, not the term's key)
        ssel = ()
        if p.spread_selectors:
            all_reqs = tuple(r for s in p.spread_selectors
                             for r in s.requirements)
            ssel = (self.term_id(LabelSelector(all_reqs), (p.namespace,), ""),)
            for zk in ZONE_TOPO_KEYS:  # zone-weighted reduce needs zone domains
                self.vocabs.topo_keys.intern(zk)
                self.vocabs.label_keys.intern(zk)
        imgs = tuple(self.image_id(nm) for nm in p.images)
        lim = (self.req_id(p.limits)
               if (p.limits.milli_cpu or p.limits.memory_kib) else -1)
        vols = self.volset_id(p.volumes) if p.volumes else -1
        spec = (ns_id, rid, ls, nsel, aff_active, nterms, pterms, tol, ports,
                aff, anti, paff, panti, tsc, ssel, imgs, lim, vols)
        before = len(self.class_reg)
        cid = self.class_reg.intern(spec)
        if cid == before:
            self._class_spec.append(spec)
        return cid

    def intern_node(self, n: Node) -> None:
        seen = self._node_seen.get(id(n))
        if seen is n:
            return
        self.vocabs.node_names.intern(n.name)
        for k, v in n.labels.items():
            self.vocabs.label_keys.intern(k)
            self.vocabs.label_vals.intern(v)
        for t in n.taints:
            self.vocabs.label_keys.intern(t.key)
            self.vocabs.label_vals.intern(t.value)
        for name, _ in n.allocatable.scalars:
            self.vocabs.resources.intern(name)
        for img, size in n.images_kib.items():
            self.image_id(img, size)
        self._max_node_labels = max(self._max_node_labels, len(n.labels))
        self._max_node_taints = max(self._max_node_taints, len(n.taints))
        _evict_half(self._node_seen, 1 << 18)
        self._node_seen[id(n)] = n

    def pod_row(self, p: Pod) -> tuple:
        """Interned identity row for one pod:
        (name_id, ns_id, class_id, priority, creation, node_name_vocab_id).
        Memoized by object identity (the keepalive reference makes id() safe),
        so a pod is walked ONCE when it first appears — the analog of the
        reference encoding a pod into NodeInfo once per informer event, not
        once per cycle (cache.go:394). Gang group ids are deliberately NOT a
        column: they are compactable (compact_groups) and a memoized copy
        would go stale; build_gang_arrays re-derives them per snapshot."""
        ent = self._pod_rows.get(id(p))
        if ent is not None and ent[0] is p:
            return ent[1]
        if p.pod_group:
            # groups must be interned at INGEST time so dims() sees the true
            # group count before capacities freeze: computing GR only inside
            # build_gang_arrays left the first cycle at the default GR
            # bucket, and gang ids beyond it clip-collided (wrong all-or-
            # nothing accounting for every group past the capacity)
            self.group_id(p)
        ns_id = self.vocabs.namespaces.intern(p.namespace)
        row = (
            self.vocabs.pod_names.intern(p.name),
            ns_id,
            self.class_id_memo(p, ns_id),
            p.priority,
            p.creation_index,
            self.vocabs.node_names.intern(p.node_name) if p.node_name else -1,
        )
        _evict_half(self._pod_rows, 1 << 19)
        self._pod_rows[id(p)] = (p, row)
        return row

    def intern_pods(self, pods) -> None:
        """Batch ingest: the vectorized (columnar) analog of calling pod_row
        per pod. One tight loop with hoisted lookups interns the whole event
        batch — per-pod cost collapses to a fingerprint probe + a name
        intern; the full object-graph walk (class_id) runs once per distinct
        template. Fills the same per-object row memo pod_row reads, so
        build_pod_arrays / encode_node_row afterwards are pure memo lookups.

        Callers with selector-bearing workloads must keep the classes_stale
        re-walk loop (encode_cluster, SchedulerCache.snapshot): a selector
        referencing a new pod-label key mid-batch widens the projection and
        invalidates earlier rows, exactly as in the per-pod path."""
        pod_rows = self._pod_rows
        names_fwd = self.vocabs.pod_names._fwd
        names_rev = self.vocabs.pod_names._rev
        ns_intern = self.vocabs.namespaces.intern
        nn_intern = self.vocabs.node_names.intern
        class_memo = self._class_memo
        class_id = self.class_id
        ref = self.referenced_label_strs
        group_memo: Dict[object, Tuple[int, bool]] = {}
        group_min = self.group_min
        group_spec = self.group_spec
        ns_cache: Dict[str, int] = {}
        for p in pods:
            ent = pod_rows.get(id(p))
            if ent is not None and ent[0] is p:
                continue
            ns = p.namespace
            nsid = ns_cache.get(ns)
            if nsid is None:
                nsid = ns_cache[ns] = ns_intern(ns)
            gk = p.pod_group
            if gk:
                # relative group names are namespaced (Pod.group_key)
                mk = gk if "/" in gk else (ns, gk)
                gent = group_memo.get(mk)
                if gent is None:
                    key = gk if "/" in gk else ns + "/" + gk
                    g = self.pod_groups.intern(key)
                    spec = group_spec.get(key)
                    if spec is not None:
                        group_min[g] = spec
                    gent = group_memo[mk] = (g, spec is not None)
                g, pinned = gent
                if not pinned:
                    mm = p.min_member
                    if mm > group_min.get(g, 0):
                        group_min[g] = mm
            # ---- class_fingerprint, inlined: this loop is the ingest hot
            # path and the method-call + re-hoisting overhead is measurable
            # at 100k pods/batch. KEEP IN SYNC with class_fingerprint.
            labels = p.labels
            lk = tuple(sorted(
                (k, v) for k, v in labels.items() if k in ref)) \
                if (ref and labels) else ()
            aff = p.affinity
            if (aff.node_required is None and not aff.node_preferred
                    and not aff.pod_required and not aff.anti_required
                    and not aff.pod_preferred and not aff.anti_preferred):
                aff = None
            r = p.requests
            nsel = p.node_selector
            lim = p.limits
            fp = (nsid, r.milli_cpu, r.memory_kib, r.ephemeral_kib,
                  r.scalars, lk,
                  tuple(sorted(nsel.items())) if nsel else None, aff,
                  p.tolerations, p.host_ports, p.topology_spread,
                  p.spread_selectors, p.images,
                  lim if (lim.milli_cpu or lim.memory_kib) else None,
                  p.volumes)
            cid = class_memo.get(fp)
            if cid is None:
                cid = class_id(p)
                class_memo[fp] = cid
            name = p.name
            nid = names_fwd.get(name)
            if nid is None:
                nid = names_fwd[name] = len(names_rev)
                names_rev.append(name)
            nn = p.node_name
            row = (nid, nsid, cid, p.priority, p.creation_index,
                   nn_intern(nn) if nn else -1)
            pod_rows[id(p)] = (p, row)
        _evict_half(pod_rows, 1 << 19)
        _evict_half(class_memo, 1 << 16)

    def rebuild_domain_maps(self, nodes: Sequence[Node]) -> None:
        """Compact the per-topology-key domain maps to the LIVE node set.
        Append-only ids are what make device rows patchable BETWEEN full
        encodes, but without compaction node churn (hostname-keyed spread
        makes every node name a domain) grows D forever; a full re-encode
        rebuilds every row anyway, so it is the free moment to shrink.
        NOTE: an Encoder is owned by one SchedulerCache — compaction
        invalidates any other consumer's staged domain ids."""
        self.domain_maps = [dict() for _ in range(len(self.vocabs.topo_keys))]
        self._node_domains_done.clear()
        for n in nodes:
            self.register_node_domains(n)

    def register_node_domains(self, n: Node) -> None:
        """Assign compact per-topology-key domain ids for this node's labels.
        Append-only: ids are stable across encodes so device rows patch
        in place. Memoized per (node object, topo-key count) so steady-state
        cycles skip already-registered nodes in O(1)."""
        v = self.vocabs
        nk = len(v.topo_keys)
        done = self._node_domains_done.get(id(n))
        if done is not None and done[0] is n and done[1] == nk:
            return
        while len(self.domain_maps) < nk:
            self.domain_maps.append({})
        for ki in range(nk):
            key = v.topo_keys.lookup(ki)
            if key in n.labels:
                vid = v.label_vals.intern(n.labels[key])
                dm = self.domain_maps[ki]
                if vid not in dm:
                    dm[vid] = len(dm)
        _evict_half(self._node_domains_done, 1 << 18)
        self._node_domains_done[id(n)] = (n, nk)

    # ---------------- capacity computation ---------------- #

    def dims(
        self,
        n_nodes: int,
        n_existing: int,
        n_pending: int,
        nodes: Sequence[Node],
        base: Optional[Dims] = None,
    ) -> Dims:
        d = base or Dims()
        v = self.vocabs

        def mx(it, default=1):
            vals = list(it)
            return max(vals) if vals else default

        nterm_specs = [self.nterm_reg.lookup(i) for i in range(len(self.nterm_reg))]
        term_specs = [self.term_reg.lookup(i) for i in range(len(self.term_reg))]
        tol_specs = [self.tolset_reg.lookup(i) for i in range(len(self.tolset_reg))]
        port_specs = [self.portset_reg.lookup(i) for i in range(len(self.portset_reg))]

        max_q = mx([len(s[0]) for s in nterm_specs] + [len(s[0]) for s in term_specs])
        max_v = mx(
            [len(r[2]) for s in nterm_specs for r in s[0]]
            + [len(r[2]) for s in term_specs for r in s[0]]
        )
        # domain capacity from the persistent per-key maps (register_node_domains)
        # — O(K), not an O(N·K) rescan of every node's labels per cycle
        for n in nodes:
            self.register_node_domains(n)
        max_domains = mx([len(dm) for dm in self.domain_maps])

        return d.grown_for(
            N=n_nodes, P=max(n_pending, 1), E=max(n_existing, 1),
            R=NUM_FIXED_RES + len(v.resources),
            L=self._max_node_labels,
            PL=mx([len(s) for i in range(len(self.labelset_reg))
                   for s in [self.labelset_reg.lookup(i)]]),
            T=mx([len(s[5]) for s in self._class_spec]),
            PT=mx([len(s[6]) for s in self._class_spec]),
            Q=max_q, V=max_v,
            F=mx([len(s[1]) for s in nterm_specs]),
            TL=mx([len(s) for s in tol_specs]),
            TT=self._max_node_taints,
            PP=mx([len(s) for s in port_specs]),
            AT=mx([len(s[9]) for s in self._class_spec]),
            AN=mx([len(s[10]) for s in self._class_spec]),
            PAT=mx([len(s[11]) for s in self._class_spec]),
            PAN=mx([len(s[12]) for s in self._class_spec]),
            TS=mx([len(s[13]) for s in self._class_spec]),
            SS=mx([len(s[14]) for s in self._class_spec]),
            CI=mx([len(s[15]) for s in self._class_spec]),
            IMG=max(len(self.vocabs.images), 1),
            IW=(len(self.vocabs.images) + 31) // 32 or 1,
            VS=mx([len(self.volset_reg.lookup(i))
                   for i in range(len(self.volset_reg))]),
            SV=max(len(self.volset_reg), 1),
            VW=(len(self.vocabs.volumes) + 31) // 32 or 1,
            DR=max(len(self.vocabs.vol_drivers), 1),
            S=max(len(self.term_reg), 1),
            SR=max(len(self.req_reg), 1),
            SL=max(len(self.labelset_reg), 1),
            SN=max(len(self.nterm_reg), 1),
            STL=max(len(self.tolset_reg), 1),
            SPP=max(len(self.portset_reg), 1),
            SC=max(len(self.class_reg), 1),
            K=max(len(v.topo_keys), 1),
            D=max_domains,
            GR=max(len(self.pod_groups), 1),
            NW=(len(v.namespaces) + 31) // 32 or 1,
            PWp=(len(v.port_pairs) + 31) // 32 or 1,
            PWt=(len(v.port_triples) + 31) // 32 or 1,
        )

    # ---------------- table materialization ---------------- #

    def build_req_table(self, d: Dims) -> ReqTable:
        vec = np.zeros((d.SR, d.R), I32)
        for i in range(len(self.req_reg)):
            cpu, mem, eph, scalars = self.req_reg.lookup(i)
            vec[i, 0], vec[i, 1], vec[i, 2] = cpu, mem, eph
            vec[i, RES_PODS] = 1
            for sid, amt in scalars:
                vec[i, NUM_FIXED_RES + sid] = amt
        return ReqTable(vec=vec)

    def build_labelset_table(self, d: Dims) -> LabelSetTable:
        keys = np.full((d.SL, d.PL), -1, I32)
        vals = np.full((d.SL, d.PL), -1, I32)
        for i in range(len(self.labelset_reg)):
            for li, (k, v) in enumerate(self.labelset_reg.lookup(i)):
                keys[i, li], vals[i, li] = k, v
        return LabelSetTable(keys=keys, vals=vals)

    def build_nterm_table(self, d: Dims) -> NodeTermTable:
        SN, Q, V, F = d.SN, d.Q, d.V, d.F
        valid = np.zeros((SN,), bool)
        keys = np.full((SN, Q), -1, I32)
        ops = np.zeros((SN, Q), I32)
        vals = np.full((SN, Q, V), -1, I32)
        ints = np.zeros((SN, Q), I32)
        fields = np.full((SN, F), -1, I32)
        nfields = np.zeros((SN,), I32)
        for i in range(len(self.nterm_reg)):
            reqs, flds = self.nterm_reg.lookup(i)
            valid[i] = True
            for qi, (kid, op, vids, rhs) in enumerate(reqs):
                keys[i, qi], ops[i, qi], ints[i, qi] = kid, op, rhs
                for vi, vid in enumerate(vids):
                    vals[i, qi, vi] = vid
            for fi, f in enumerate(flds):
                fields[i, fi] = f
            nfields[i] = len(flds)
        return NodeTermTable(valid=valid, keys=keys, ops=ops, vals=vals,
                             ints=ints, fields=fields, nfields=nfields)

    def build_tolset_table(self, d: Dims) -> TolSetTable:
        STL, TL = d.STL, d.TL
        valid = np.zeros((STL, TL), bool)
        keys = np.full((STL, TL), -1, I32)
        ops = np.zeros((STL, TL), I32)
        vals = np.full((STL, TL), -1, I32)
        effects = np.full((STL, TL), -1, I32)
        for i in range(len(self.tolset_reg)):
            for ti, (kid, op, vid, eff) in enumerate(self.tolset_reg.lookup(i)):
                valid[i, ti] = True
                keys[i, ti], ops[i, ti], vals[i, ti], effects[i, ti] = kid, op, vid, eff
        return TolSetTable(valid=valid, keys=keys, ops=ops, vals=vals, effects=effects)

    def build_portset_table(self, d: Dims) -> PortSetTable:
        SPP, PP = d.SPP, d.PP
        pair = np.full((SPP, PP), -1, I32)
        triple = np.full((SPP, PP), -1, I32)
        wild = np.zeros((SPP, PP), bool)
        pw = np.zeros((SPP, d.PWp), U32)
        ww = np.zeros((SPP, d.PWp), U32)
        tw = np.zeros((SPP, d.PWt), U32)
        for i in range(len(self.portset_reg)):
            for pi, (pr, tr, wl) in enumerate(self.portset_reg.lookup(i)):
                pair[i, pi], triple[i, pi], wild[i, pi] = pr, tr, wl
                _set_bit(pw[i], pr)
                if wl:
                    _set_bit(ww[i], pr)
                elif tr >= 0:
                    _set_bit(tw[i], tr)
        return PortSetTable(pair=pair, triple=triple, wild=wild,
                            pair_words=pw, wild_words=ww, trip_words=tw)

    def build_term_table(self, d: Dims) -> TermTable:
        S, Q, V, NW = d.S, d.Q, d.V, d.NW
        valid = np.zeros((S,), bool)
        req_keys = np.full((S, Q), -1, I32)
        req_ops = np.zeros((S, Q), I32)
        req_vals = np.full((S, Q, V), -1, I32)
        ns_words = np.zeros((S, NW), U32)
        topo_key = np.full((S,), -1, I32)
        for i in range(len(self.term_reg)):
            reqs, ns_ids, tk = self.term_reg.lookup(i)
            valid[i] = True
            topo_key[i] = tk
            for qi, (kid, op, vids) in enumerate(reqs):
                req_keys[i, qi], req_ops[i, qi] = kid, op
                for vi, vid in enumerate(vids):
                    req_vals[i, qi, vi] = vid
            for ns in ns_ids:
                _set_bit(ns_words[i], ns)
        return TermTable(valid=valid, req_keys=req_keys, req_ops=req_ops,
                         req_vals=req_vals, ns_words=ns_words, topo_key=topo_key)

    def build_class_table(self, d: Dims) -> PodClassTable:
        SC = d.SC

        def z(shape, fill=0, dtype=I32):
            return np.full(shape, fill, dtype)

        t = dict(
            valid=z((SC,), False, bool), ns=z((SC,), -1), rid=z((SC,)),
            labelset=z((SC,)), nsel_term=z((SC,), -1),
            aff_active=z((SC,), False, bool),
            nterm_ids=z((SC, d.T), -1), pterm_ids=z((SC, d.PT), -1),
            pterm_w=z((SC, d.PT)), tolset=z((SC,)), portset=z((SC,), -1),
            aff_terms=z((SC, d.AT), -1), anti_terms=z((SC, d.AN), -1),
            paff_terms=z((SC, d.PAT), -1), paff_w=z((SC, d.PAT)),
            panti_terms=z((SC, d.PAN), -1), panti_w=z((SC, d.PAN)),
            tsc_term=z((SC, d.TS), -1), tsc_key=z((SC, d.TS), -1),
            tsc_maxskew=z((SC, d.TS)), tsc_hard=z((SC, d.TS), False, bool),
            volset=z((SC,), -1),
            ssel_terms=z((SC, d.SS), -1), img_ids=z((SC, d.CI), -1),
            lim_rid=z((SC,), -1),
        )
        for i, spec in enumerate(self._class_spec):
            (ns_id, rid, ls, nsel, aff_active, nterms, pterms, tol, ports,
             aff, anti, paff, panti, tsc, ssel, imgs, lim, vols) = spec
            t["valid"][i] = True
            t["ns"][i], t["rid"][i], t["labelset"][i] = ns_id, rid, ls
            t["nsel_term"][i] = nsel
            t["aff_active"][i] = aff_active
            for ti, x in enumerate(nterms):
                t["nterm_ids"][i, ti] = x
            for ti, (x, w) in enumerate(pterms):
                t["pterm_ids"][i, ti], t["pterm_w"][i, ti] = x, w
            t["tolset"][i], t["portset"][i] = tol, ports
            for ti, x in enumerate(aff):
                t["aff_terms"][i, ti] = x
            for ti, x in enumerate(anti):
                t["anti_terms"][i, ti] = x
            for ti, (x, w) in enumerate(paff):
                t["paff_terms"][i, ti], t["paff_w"][i, ti] = x, w
            for ti, (x, w) in enumerate(panti):
                t["panti_terms"][i, ti], t["panti_w"][i, ti] = x, w
            for ti, (x, k, skew, hard) in enumerate(tsc):
                t["tsc_term"][i, ti], t["tsc_key"][i, ti] = x, k
                t["tsc_maxskew"][i, ti], t["tsc_hard"][i, ti] = skew, hard
            for ti, x in enumerate(ssel):
                t["ssel_terms"][i, ti] = x
            for ti, x in enumerate(imgs):
                t["img_ids"][i, ti] = x
            t["lim_rid"][i] = lim
            t["volset"][i] = vols
        return PodClassTable(**t)

    def build_volset_table(self, d: Dims) -> "VolSetTable":
        from .arrays import VolSetTable

        any_w = np.zeros((d.SV, d.VW), U32)
        rw_w = np.zeros((d.SV, d.VW), U32)
        for i in range(len(self.volset_reg)):
            for vid, _did, ro in self.volset_reg.lookup(i):
                _set_bit(any_w[i], vid)
                if not ro:
                    _set_bit(rw_w[i], vid)
        return VolSetTable(any_words=any_w, rw_words=rw_w)

    def build_drv_masks(self, d: Dims) -> np.ndarray:
        """[DR, VW] u32: which volume-vocab bits belong to each driver —
        lets per-driver attach counts be popcounts over the node's live
        volume bitset instead of separate carried counters."""
        masks = np.zeros((d.DR, d.VW), U32)
        for vid, did in enumerate(self.vol_driver):
            _set_bit(masks[did], vid)
        return masks

    def build_image_table(self, d: Dims) -> "ImageTable":
        from .arrays import ImageTable

        size = np.zeros((d.IMG,), I32)
        for i, s in enumerate(self.image_sizes):
            size[i] = s
        return ImageTable(size_kib=size)

    def build_zone_keys(self) -> np.ndarray:
        """[2] i32: topo-key ids of the modern / legacy zone labels
        (GetZoneKey precedence), -1 when not interned."""
        return np.array([self.vocabs.topo_keys.get(k) for k in ZONE_TOPO_KEYS],
                        I32)

    def encode_node_row(
        self, arrays: NodeArrays, i: int, n: Node, pods_on_node: Sequence[Pod],
        d: Dims,
    ) -> None:
        """Write ONE node's full row (labels/taints/topo/alloc + the usage
        aggregate of its pods) into host staging `arrays` at slot `i`. The
        per-node unit of both the cold full encode and the incremental patch
        (cache.go:204-255 copies NodeInfos one at a time for the same reason).
        Pod usage comes from the interned class registry (pod_row), so the pod
        object graph is walked at most once per object, not once per cycle."""
        v = self.vocabs
        arrays.valid[i] = True
        arrays.name_id[i] = v.node_names.intern(n.name)
        av = arrays.alloc[i]
        av[:] = 0
        av[0], av[1], av[2] = (n.allocatable.milli_cpu,
                               n.allocatable.memory_kib,
                               n.allocatable.ephemeral_kib)
        av[RES_PODS] = n.allocatable.pods
        for name, amt in n.allocatable.scalars:
            av[NUM_FIXED_RES + v.resources.intern(name)] = amt
        arrays.unschedulable[i] = n.unschedulable
        arrays.label_keys[i] = -1
        arrays.label_vals[i] = -1
        arrays.label_ints[i] = 0
        for li, (k, val) in enumerate(n.labels.items()):
            arrays.label_keys[i, li] = v.label_keys.intern(k)
            arrays.label_vals[i, li] = v.label_vals.intern(val)
            arrays.label_ints[i, li] = parse_label_int(val)
        arrays.taint_keys[i] = -1
        arrays.taint_vals[i] = -1
        arrays.taint_effects[i] = -1
        for ti, t in enumerate(n.taints):
            arrays.taint_keys[i, ti] = v.label_keys.intern(t.key)
            arrays.taint_vals[i, ti] = v.label_vals.intern(t.value)
            arrays.taint_effects[i, ti] = int(t.effect)
        arrays.img_words[i] = 0
        for img, size in n.images_kib.items():
            _set_bit(arrays.img_words[i], self.image_id(img, size))
        self.register_node_domains(n)
        arrays.topo[i] = -1
        arrays.domain[i] = -1
        for ki in range(len(v.topo_keys)):
            key = v.topo_keys.lookup(ki)
            if key in n.labels:
                vid = v.label_vals.intern(n.labels[key])
                arrays.topo[i, ki] = vid
                arrays.domain[i, ki] = self.domain_maps[ki][vid]

        arrays.vol_limit[i] = -1
        for drv, lim in n.volume_limits.items():
            arrays.vol_limit[i, self.vocabs.vol_drivers.intern(drv)] = lim
        arrays.avoid[i] = n.prefer_avoid_pods
        used = arrays.used[i]
        used[:] = 0
        arrays.port_pair_any[i] = 0
        arrays.port_pair_wild[i] = 0
        arrays.port_triple[i] = 0
        arrays.vol_any[i] = 0
        arrays.vol_rw[i] = 0
        for p in pods_on_node:
            spec = self._class_spec[self.pod_row(p)[2]]
            cpu, mem, eph, scalars = self.req_reg.lookup(spec[1])
            used[0] += cpu
            used[1] += mem
            used[2] += eph
            used[RES_PODS] += 1
            for sid, amt in scalars:
                used[NUM_FIXED_RES + sid] += amt
            ports_id = spec[8]
            if ports_id >= 0:
                for pair, trip, wild in self.portset_reg.lookup(ports_id):
                    _set_bit(arrays.port_pair_any[i], pair)
                    if wild:
                        _set_bit(arrays.port_pair_wild[i], pair)
                    elif trip >= 0:
                        _set_bit(arrays.port_triple[i], trip)
            vols_id = spec[17]
            if vols_id >= 0:
                for vid, _did, ro in self.volset_reg.lookup(vols_id):
                    _set_bit(arrays.vol_any[i], vid)
                    if not ro:
                        _set_bit(arrays.vol_rw[i], vid)

    @staticmethod
    def empty_node_arrays(d: Dims) -> NodeArrays:
        """Host (numpy) staging NodeArrays, all slots invalid."""
        N, R, L, TT, K = d.N, d.R, d.L, d.TT, d.K
        return NodeArrays(
            valid=np.zeros((N,), bool),
            name_id=np.full((N,), -1, I32),
            alloc=np.zeros((N, R), I32),
            used=np.zeros((N, R), I32),
            label_keys=np.full((N, L), -1, I32),
            label_vals=np.full((N, L), -1, I32),
            label_ints=np.zeros((N, L), I32),
            unschedulable=np.zeros((N,), bool),
            taint_keys=np.full((N, TT), -1, I32),
            taint_vals=np.full((N, TT), -1, I32),
            taint_effects=np.full((N, TT), -1, I32),
            topo=np.full((N, K), -1, I32),
            domain=np.full((N, K), -1, I32),
            port_pair_any=np.zeros((N, d.PWp), U32),
            port_pair_wild=np.zeros((N, d.PWp), U32),
            port_triple=np.zeros((N, d.PWt), U32),
            img_words=np.zeros((N, d.IW), U32),
            vol_any=np.zeros((N, d.VW), U32),
            vol_rw=np.zeros((N, d.VW), U32),
            vol_limit=np.full((N, d.DR), -1, I32),
            avoid=np.zeros((N,), bool),
        )

    def build_node_arrays(
        self, nodes: Sequence[Node], existing: Sequence[Pod], d: Dims
    ) -> NodeArrays:
        arrays = self.empty_node_arrays(d)
        by_node: Dict[str, List[Pod]] = {}
        for p in existing:
            if p.node_name:
                by_node.setdefault(p.node_name, []).append(p)
        for i, n in enumerate(nodes):
            self.encode_node_row(arrays, i, n, by_node.get(n.name, ()), d)
        return arrays

    def build_pod_arrays(
        self,
        pods: Sequence[Pod],
        d: Dims,
        node_index: Optional[Dict[str, int]] = None,
        capacity: Optional[int] = None,
    ) -> PodArrays:
        P = capacity if capacity is not None else max(len(pods), 1)
        node_index = node_index or {}
        k = len(pods)
        valid = np.zeros((P,), bool)
        node_id = np.full((P,), -1, I32)
        rows = np.zeros((P, 6), I32)
        rows[:, 0] = rows[:, 1] = rows[:, 5] = -1  # absent ids, like before
        if k:
            # one vectorized assembly from memoized rows — 50k pods cost one
            # flat fromiter, not 50k spec walks (pod_row pays the walk
            # exactly once per pod object, at informer-arrival time in
            # steady state). fromiter over the flattened generator skips the
            # list-of-tuples + sequence-protocol copy np.array would do —
            # this assembly is the largest host-side term of the steady
            # cycle at 50k pending.
            rows[:k] = np.fromiter(
                (v for p in pods for v in self.pod_row(p)),
                dtype=I32, count=6 * k).reshape(k, 6)
            valid[:k] = True
            node_id[:k] = np.fromiter(
                (node_index.get(p.node_name, -1) if p.node_name else -1
                 for p in pods), dtype=I32, count=k)
        return PodArrays(
            valid=valid, name_id=rows[:, 0], ns=rows[:, 1], cls=rows[:, 2],
            priority=rows[:, 3], creation=rows[:, 4],
            node_id=node_id, node_name_req=rows[:, 5],
        )

    def build_gang_arrays(self, pending: Sequence[Pod], d: Dims,
                          bound_counts: Optional[Dict[int, int]] = None):
        """GangArrays for one cycle (ops/gang.py): per-pending-pod group ids
        plus per-group needed counts, netting out members already bound
        (`bound_counts`: group id → bound/assumed member count). Returns None
        when no pending pod is gang-grouped — the dispatch layer then traces
        the plain (gang-free) engine."""
        # cheap attr scan first: gang-free batches (the common flagship
        # cycle) pay one falsy check per pod, not a group_id walk
        if not any(p.pod_group for p in pending):
            return None
        gids = [self.group_id(p) for p in pending]
        GR, P = d.GR, d.P
        group = np.full((P,), -1, I32)
        group[: len(gids)] = np.array(gids, I32) if gids else 0
        needed = np.zeros((GR,), I32)
        valid = np.zeros((GR,), bool)
        bound_counts = bound_counts or {}
        # only groups with members IN THIS BATCH participate: an absent
        # group's needed>0 would read as permanently underfilled and spin
        # the engine's rejection loop for pods that are not even here
        present = {g for g in gids if g >= 0}
        for g in present:
            if g < GR:
                valid[g] = True
                needed[g] = max(
                    self.group_min.get(g, 0) - bound_counts.get(g, 0), 0)
        # rejection order: lowest max-member-priority first, then youngest
        # (latest min creation) — the coscheduling queue-sort inverted
        pri = np.full((GR,), -(2**31) + 1, I32)
        cre = np.full((GR,), 2**31 - 1, I32)
        for p, g in zip(pending, gids):
            if 0 <= g < GR:
                pri[g] = max(pri[g], p.priority)
                cre[g] = min(cre[g], p.creation_index)
        order = np.lexsort((-cre, pri))  # ascending priority, youngest first
        rank = np.zeros((GR,), I32)
        rank[order] = np.arange(GR - 1, -1, -1, dtype=I32)
        return GangArrays(group=group, needed=needed, valid=valid, rank=rank)

    # ---------------- one-shot full encode ---------------- #

    def encode_cluster(
        self,
        nodes: Sequence[Node],
        existing: Sequence[Pod],
        pending: Sequence[Pod],
        base: Optional[Dims] = None,
    ) -> Tuple[ClusterTables, PodArrays, PodArrays, Dims]:
        """Cold-path full encode. Interns everything, sizes capacities, builds
        all tables. Returns (tables, existing_pods, pending_pods, dims)."""
        for n in nodes:
            self.intern_node(n)
        all_pods = list(existing) + list(pending)
        converged = False
        for _walk_pass in range(8):  # referenced keys grow monotonically
            self.intern_pods(all_pods)
            if not self.classes_stale:
                converged = True
                break
            # a selector referenced a new pod-label key mid-walk: class
            # projections changed — re-walk under the widened projection
            # (the cache path does the same in SchedulerCache.snapshot).
            # NOTE: projection_rewalk clears classes_stale, so convergence
            # must be tracked HERE — the flag cannot be re-checked after
            # the loop.
            self.projection_rewalk()
        if not converged:
            # every pass widened the projection: building tables now would
            # bake stale class ids into device rows (wrong placements).
            # Fail loud instead of mis-scheduling silently.
            raise ProjectionUnconvergedError(
                "label projection did not converge after 8 re-walk passes; "
                f"{len(self.referenced_label_keys)} referenced keys")
        d = self.dims(len(nodes), len(existing), len(pending), nodes, base)
        node_index = {n.name: i for i, n in enumerate(nodes)}
        tables = ClusterTables(
            nodes=self.build_node_arrays(nodes, existing, d),
            reqs=self.build_req_table(d),
            labelsets=self.build_labelset_table(d),
            nterms=self.build_nterm_table(d),
            tolsets=self.build_tolset_table(d),
            portsets=self.build_portset_table(d),
            terms=self.build_term_table(d),
            classes=self.build_class_table(d),
            images=self.build_image_table(d),
            zone_keys=self.build_zone_keys(),
            volsets=self.build_volset_table(d),
            drv_masks=self.build_drv_masks(d),
        )
        ex = self.build_pod_arrays(existing, d, node_index, capacity=d.E)
        pe = self.build_pod_arrays(pending, d, node_index, capacity=d.P)
        from dataclasses import replace

        d = replace(d, has_node_name=bool((pe.node_name_req >= 0).any()))
        return tables, ex, pe, d
