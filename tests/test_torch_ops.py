"""Port parity, op by op: every leaf op, build_cycle, the shared Filter/Score
rows, and the plain versions of the two CUDA kernels of kubernetes_tpu_torch
against the JAX package, on the same encoded input.

Bool and int outputs must be equal; f32 rows agree within F32_ATOL
(tests/torch_parity.py states why). Also covers the torch-vs-jnp traps the
port has to get right: stable sorts, lexsort by chained stable sorts, int32
negation of INT32_MIN, the unsigned priority bias, scatter-min, popcount.
"""

import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from kubernetes_tpu.ops import assign as jassign
from kubernetes_tpu.ops import waves as jwaves
from kubernetes_tpu.ops.fit import fit_row, resource_scores_row
from kubernetes_tpu.ops.interpod import affinity_rows, soft_affinity_row
from kubernetes_tpu.ops.labels import node_term_matrix, term_labelset_matrix
from kubernetes_tpu.ops.ports import port_conflict_row
from kubernetes_tpu.ops.scores import (even_spread_soft_row,
                                       image_locality_static,
                                       selector_spread_row)
from kubernetes_tpu.ops.taints import taint_matrices
from kubernetes_tpu.ops.topospread import spread_row
from kubernetes_tpu.ops.volumes import volume_components_row
from kubernetes_tpu.models.workloads import flagship_pods, make_nodes
from kubernetes_tpu_torch.ops import assign as tassign
from kubernetes_tpu_torch.ops import fit as tfit
from kubernetes_tpu_torch.ops import interpod as tinterpod
from kubernetes_tpu_torch.ops import kernels as tkernels
from kubernetes_tpu_torch.ops import labels as tlabels
from kubernetes_tpu_torch.ops import ports as tports
from kubernetes_tpu_torch.ops import scores as tscores
from kubernetes_tpu_torch.ops import taints as ttaints
from kubernetes_tpu_torch.ops import topospread as ttopo
from kubernetes_tpu_torch.ops import volumes as tvolumes
from kubernetes_tpu_torch.ops import waves as twaves

import test_golden
import test_scores
from torch_parity import assert_same, encode, jax_cycle, torch_cycle

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def golden_cluster(seed):
    rng = random.Random(7000 + seed)
    nodes = [test_golden.rand_node(rng, i) for i in range(rng.randint(5, 8))]
    existing = [test_golden.rand_pod(rng, 100 + i,
                                     bound_to=rng.choice(nodes).name)
                for i in range(rng.randint(2, 6))]
    pending = [test_golden.rand_pod(rng, i) for i in range(rng.randint(6, 12))]
    return nodes, existing, pending


def scores_cluster(seed):
    rng = random.Random(8000 + seed)
    nodes = [test_scores.rand_node(rng, i) for i in range(6)]
    existing = [test_scores.rand_pod(rng, 100 + i,
                                     bound_to=rng.choice(nodes).name)
                for i in range(5)]
    pending = [test_scores.rand_pod(rng, i) for i in range(8)]
    return nodes, existing, pending


def flagship_cluster(_seed):
    return make_nodes(16, zones=4, racks_per_zone=2), [], flagship_pods(
        96, groups=6)


CLUSTERS = [("golden", golden_cluster, s) for s in range(3)] + \
    [("scores", scores_cluster, s) for s in range(2)] + \
    [("flagship", flagship_cluster, 0)]


@pytest.fixture(params=CLUSTERS, ids=lambda c: f"{c[0]}{c[2]}")
def cluster(request):
    _, make, seed = request.param
    return encode(*make(seed))


def test_static_tables_match(cluster):
    """node_term_matrix, term_labelset_matrix (ns_bit inside
    term_class_matrix), taint_matrices and image_locality_static."""
    tj, _, _ = cluster["jax"]
    tt, _, _ = cluster["torch"]
    uk, ev = cluster["keys"]
    ref = jax.jit(lambda t, k, v: (
        node_term_matrix(t.nterms, t.nodes),
        term_labelset_matrix(t.terms, t.labelsets),
        taint_matrices(t.tolsets, t.nodes, k, v),
        image_locality_static(t)))(tj, jnp.int32(uk), jnp.int32(ev))
    got = (tlabels.node_term_matrix(tt.nterms, tt.nodes),
           tlabels.term_labelset_matrix(tt.terms, tt.labelsets),
           ttaints.taint_matrices(tt.tolsets, tt.nodes, uk, ev),
           tscores.image_locality_static(tt))
    for name, r, g in zip(("MT", "TLS", "taints", "img"), ref, got):
        assert_same(r, g, name)


def test_build_cycle_field_by_field(cluster):
    assert_same(jax_cycle(cluster), torch_cycle(cluster), "cyc")


def _perturbed_states(cluster, cj, ct, seed=0):
    """The initial assume-state and one with random extra counts, usage and
    words (the same numpy draws handed to both packages)."""
    init_j = jassign.initial_state(cluster["jax"][0], cj)
    rng = np.random.default_rng(seed)
    fields = {}
    for f in init_j._fields:
        a = np.asarray(getattr(init_j, f))
        if f in ("CNT", "HOLD"):
            a = a + rng.integers(0, 3, a.shape).astype(a.dtype)
        elif f == "used":
            a = a + rng.integers(0, 2000, a.shape).astype(a.dtype)
        elif f == "WSYM":
            a = a + rng.integers(-3, 4, a.shape).astype(a.dtype)
        else:  # bitset words: OR in a few random bits
            a = a | (rng.integers(0, 2**32, a.shape, dtype=np.uint64)
                     & rng.integers(0, 2**32, a.shape, dtype=np.uint64)
                     & rng.integers(0, 2**32, a.shape, dtype=np.uint64)
                     ).astype(np.uint32)
        fields[f] = a
    pert_j = jassign.AssignState(**{f: jnp.asarray(v) for f, v in fields.items()})
    pert_t = tassign.AssignState(**{
        f: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v)
        for f, v in fields.items()})
    return [(init_j, tassign.initial_state(cluster["torch"][0], ct)),
            (pert_j, pert_t)]


@jax.jit
def _jax_rows(tables, cyc, state):
    nodes, classes, terms = tables.nodes, tables.classes, tables.terms
    D = cyc.ELD.shape[2] - 1

    def row(c):
        req = tables.reqs.vec[classes.rid[c]]
        ps = jnp.maximum(classes.portset[c], 0)
        return dict(
            affinity=affinity_rows(c, classes, terms, cyc.TM, state.CNT,
                                   state.HOLD, nodes, D),
            spread=spread_row(c, classes, terms, cyc.TM, state.CNT, cyc.ELD,
                              cyc.static.node_match[c], nodes, D),
            soft=soft_affinity_row(c, classes, terms, state.CNT, nodes, D,
                                   TM=cyc.TM, WSYM=state.WSYM),
            even=even_spread_soft_row(c, classes, terms, state.CNT, nodes,
                                      cyc.static.node_match[c], D),
            ssel=selector_spread_row(c, classes, state.CNT, nodes,
                                     tables.zone_keys, D),
            volumes=volume_components_row(tables, state.vol_any,
                                          state.vol_rw, c),
            fit=fit_row(req, state.used, nodes.alloc, nodes.valid),
            resource=resource_scores_row(req, state.used, nodes.alloc),
            ports=port_conflict_row(
                tables.portsets.wild_words[ps], tables.portsets.pair_words[ps],
                tables.portsets.trip_words[ps], state.ppa, state.ppw,
                state.ppt),
            mask=jassign.pod_mask_row(tables, cyc, state, c, jnp.int32(-1),
                                      classes.valid[c]),
            score=jassign.score_row(tables, cyc, state, c),
        )

    return jax.vmap(row)(jnp.arange(classes.valid.shape[0]))


def _torch_rows(tables, cyc, state):
    nodes, classes, terms = tables.nodes, tables.classes, tables.terms
    D = cyc.ELD.shape[2] - 1
    c = torch.arange(classes.valid.shape[0])
    req = tables.reqs.vec[classes.rid.long()]
    ps = classes.portset.clamp(min=0).long()
    nm = cyc.static.node_match
    return dict(
        affinity=tinterpod.affinity_rows(c, classes, terms, cyc.TM, state.CNT,
                                         state.HOLD, nodes, D),
        spread=ttopo.spread_row(c, classes, terms, cyc.TM, state.CNT, cyc.ELD,
                                nm, nodes, D),
        soft=tinterpod.soft_affinity_row(c, classes, terms, state.CNT, nodes,
                                         D, TM=cyc.TM, WSYM=state.WSYM),
        even=tscores.even_spread_soft_row(c, classes, terms, state.CNT, nodes,
                                          nm, D),
        ssel=tscores.selector_spread_row(c, classes, state.CNT, nodes,
                                         tables.zone_keys, D),
        volumes=tvolumes.volume_components_row(tables, state.vol_any,
                                               state.vol_rw, c),
        fit=tfit.fit_row(req, state.used, nodes.alloc, nodes.valid),
        resource=tfit.resource_scores_row(req, state.used, nodes.alloc),
        ports=tports.port_conflict_row(
            tables.portsets.wild_words[ps], tables.portsets.pair_words[ps],
            tables.portsets.trip_words[ps], state.ppa, state.ppw, state.ppt),
        mask=tassign.pod_mask_row(tables, cyc, state, c,
                                  torch.full(c.shape, -1, dtype=torch.int32),
                                  classes.valid),
        score=tassign.score_row(tables, cyc, state, c),
    )


def test_leaf_rows_match(cluster):
    """Every per-class row of the Filter/Score surface, on the initial and a
    perturbed assume-state."""
    cj, ct = jax_cycle(cluster), torch_cycle(cluster)
    for i, (sj, st) in enumerate(_perturbed_states(cluster, cj, ct)):
        rj = _jax_rows(cluster["jax"][0], cj, sj)
        rt = _torch_rows(cluster["torch"][0], ct, st)
        for k in rj:
            assert_same(rj[k], rt[k], f"state{i}.{k}")


def test_feasible_and_score_matrix(cluster):
    tj, _, pj = cluster["jax"]
    tt, _, pt = cluster["torch"]
    cj, ct = jax_cycle(cluster), torch_cycle(cluster)
    ref = jax.jit(lambda t, c, p: (jassign.feasible_matrix(t, c, p),
                                   jassign.score_matrix(t, c, p)))(tj, cj, pj)
    assert_same(ref[0], tassign.feasible_matrix(tt, ct, pt), "feasible")
    assert_same(ref[1], tassign.score_matrix(tt, ct, pt), "score")


def test_popcount32_matches_lax():
    rng = np.random.default_rng(3)
    w = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    w[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    ref = np.asarray(lax.population_count(jnp.asarray(w)))
    got = tvolumes.popcount32(torch.from_numpy(w.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int32))


# --------------------------------------------------------------------------- #
# K1 contention_scan: the plain version against the JAX block scan
# --------------------------------------------------------------------------- #

def _jax_block_fn(nodes, state, tables):
    """The JAX package's contention `block` body (ops/waves.py:438-503),
    rebuilt from assign_waves' code object with its closure — the reference
    itself, not a transcription. `shift`/`or_red` are its two helper lambdas
    (ops/waves.py:433-436), restated verbatim."""
    def find(code):
        for c in code.co_consts:
            if isinstance(c, types.CodeType):
                if c.co_name == "block":
                    return c
                found = find(c)
                if found is not None:
                    return found
        return None

    code = find(jwaves.assign_waves.__code__)
    shift = lambda M: jnp.concatenate(
        [jnp.zeros_like(M[:1]), M[:-1]], axis=0)
    or_red = lambda k, W: lax.associative_scan(
        jnp.bitwise_or, jnp.where(k, W[:, None, :], 0), axis=0)[-1]
    env = dict(nodes=nodes, or_red=or_red, shift=shift, state=state,
               tables=tables)
    cells = tuple(types.CellType(env[v]) for v in code.co_freevars)
    return types.FunctionType(code, vars(jwaves), "block", None, cells)


def _jax_contention(args, B):
    """Drive the block body as assign_waves does (ops/waves.py:423-523):
    class blocks of B padded with inert rows, lax.scan, OR across blocks."""
    (A, req, hp, pw, ww, tw, hv, va, vr, alloc, used, vol_any, vol_rw, drv,
     vlim) = args
    SC, N = A.shape
    nodes = types.SimpleNamespace(alloc=alloc, vol_limit=vlim)
    state = types.SimpleNamespace(used=used, vol_any=vol_any, vol_rw=vol_rw)
    tables = types.SimpleNamespace(drv_masks=drv)
    block = _jax_block_fn(nodes, state, tables)
    nb = -(-SC // B)
    pad = nb * B - SC

    def blocks_of(x):
        if pad:
            x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
        return x.reshape((nb, B) + x.shape[1:])

    carry0 = (jnp.zeros((N, req.shape[1]), jnp.int32),
              jnp.zeros((N, pw.shape[1]), jnp.uint32),
              jnp.zeros((N, pw.shape[1]), jnp.uint32),
              jnp.zeros((N, pw.shape[1]), jnp.uint32),
              jnp.zeros((N, va.shape[1]), jnp.uint32),
              jnp.zeros((N, va.shape[1]), jnp.uint32))
    _, (keep_b, committed_b) = lax.scan(block, carry0, tuple(
        blocks_of(x) for x in (A, req, hp, pw, ww, tw, hv, va, vr)))
    keep = keep_b.reshape(nb * B, N)[:SC]
    ored = tuple(lax.associative_scan(jnp.bitwise_or, cb, axis=0)[-1]
                 for cb in committed_b)
    return keep, ored


def _k1_case(seed, SC, N, R, W, VW, DR, extreme):
    rng = np.random.default_rng(seed)
    u32 = lambda *s: rng.integers(0, 2**32, s, dtype=np.uint64).astype(np.uint32)
    sparse = lambda *s: u32(*s) & u32(*s) & u32(*s)
    if extreme:
        edge = np.array([0, 1, -1, I32_MAX, I32_MIN, 2**30, 7], np.int32)
        pick = lambda *s: edge[rng.integers(0, len(edge), s)]
        req, alloc, used = pick(SC, R), pick(N, R), pick(N, R)
    else:
        req = rng.integers(0, 3000, (SC, R)).astype(np.int32)
        req[:, 3] = 1
        req[:, 4:] *= rng.random((SC, R - 4)) < 0.5   # unrequested scalars
        req[rng.random(SC) < 0.2] = 0                  # all-zero requests
        alloc = rng.integers(2000, 8000, (N, R)).astype(np.int32)
        alloc[:, 3] = rng.integers(0, 4, N)
        used = (alloc * rng.random((N, R))).astype(np.int32)
    return (rng.random((SC, N)) < 0.5, req, rng.random(SC) < 0.6,
            sparse(SC, W), sparse(SC, W), sparse(SC, W), rng.random(SC) < 0.6,
            sparse(SC, VW), sparse(SC, VW), alloc, used, sparse(N, VW),
            sparse(N, VW), u32(DR, VW),
            rng.integers(-1, 12, (N, DR)).astype(np.int32))


@pytest.mark.parametrize("seed,SC,N,R,W,VW,DR,extreme,B", [
    (0, 10, 33, 4, 1, 1, 2, False, 4),     # several blocks + a padded tail
    (1, 7, 20, 6, 2, 2, 3, False, 7),      # scalar slots, 2-word bitsets
    (2, 12, 17, 5, 1, 2, 2, True, 5),      # int32 edge requests: sums wrap
])
def test_contention_scan_plain_matches_jax_block(seed, SC, N, R, W, VW, DR,
                                                 extreme, B):
    case = _k1_case(seed, SC, N, R, W, VW, DR, extreme)
    ref_keep, ref_words = _jax_contention(
        tuple(jnp.asarray(a) for a in case), B)
    keep, words = tkernels.contention_scan(*(
        torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
        for a in case))
    assert_same(ref_keep, keep, "keep")
    for i, (r, g) in enumerate(zip(ref_words, words)):
        assert_same(r, g, f"committed[{i}]")
    assert bool(keep.any()) and bool((~keep & torch.from_numpy(case[0])).any())


# --------------------------------------------------------------------------- #
# K2 domain_rank: the plain version, through the quota pass, against JAX
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seed", range(2))
def test_domain_quota_pass_matches_jax(cluster, seed):
    """_domain_quota_pass (K2's plain version inside) against the JAX
    package's, on random per-class score orders and admission rows."""
    tj, _, _ = cluster["jax"]
    tt, _, _ = cluster["torch"]
    cj, ct = jax_cycle(cluster), torch_cycle(cluster)
    (sj, st), (pj, pt) = _perturbed_states(cluster, cj, ct, seed)
    SC, N = np.asarray(cj.static.mask).shape
    rng = np.random.default_rng(seed)
    order = np.argsort(rng.random((SC, N)), axis=1).astype(np.int32)
    allowed = rng.random((SC, N)) < 0.8
    slots = twaves.quota_slots(tt)
    for state_j, state_t in ((sj, st), (pj, pt)):
        ref = jax.jit(jwaves._domain_quota_pass)(
            tj, cj, state_j, cj.static.mask, jnp.asarray(order),
            jnp.asarray(allowed))
        got = twaves._domain_quota_pass(
            tt, ct, state_t, torch.from_numpy(order).long(),
            torch.from_numpy(allowed), slots)
        assert_same(ref, got, "allowed")


def test_domain_rank_plain_counts_earlier_equals():
    rng = np.random.default_rng(5)
    dom = rng.integers(0, 9, (6, 300)).astype(np.int32)
    got = tkernels.domain_rank(torch.from_numpy(dom), 9).numpy()
    for r in range(dom.shape[0]):
        seen = {}
        for i, d in enumerate(dom[r]):
            assert got[r, i] == seen.get(d, 0)
            seen[d] = seen.get(d, 0) + 1


# --------------------------------------------------------------------------- #
# torch-vs-jnp traps
# --------------------------------------------------------------------------- #

def _tied_ints(rng, n):
    return rng.choice(np.array([I32_MIN, I32_MIN + 1, -1, 0, 1, I32_MAX],
                               np.int32), n)


def test_lexsort_chained_stable_sorts_match_jnp():
    rng = np.random.default_rng(11)
    keys = (_tied_ints(rng, 200), _tied_ints(rng, 200),
            rng.integers(0, 3, 200).astype(np.int32))
    ref = np.asarray(jnp.lexsort(tuple(jnp.asarray(k) for k in keys)))
    got = tassign.lexsort(tuple(torch.from_numpy(k) for k in keys)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_queue_order_wraps_int32_min_like_jax():
    """-priority wraps for INT32_MIN in both packages (tests/test_waves.py
    extreme-priority case): the same pop order."""
    rng = np.random.default_rng(12)
    P = 64
    pods = dict(valid=rng.random(P) < 0.9, name_id=np.arange(P, dtype=np.int32),
                ns=np.zeros(P, np.int32), cls=np.zeros(P, np.int32),
                priority=_tied_ints(rng, P),
                creation=rng.integers(0, 8, P).astype(np.int32),
                node_id=np.full(P, -1, np.int32),
                node_name_req=np.full(P, -1, np.int32))
    from kubernetes_tpu.state.arrays import PodArrays as JPods
    from kubernetes_tpu_torch.state.arrays import PodArrays as TPods

    ref = np.asarray(jassign.queue_order(JPods(**{
        k: jnp.asarray(v) for k, v in pods.items()})))
    got = tassign.queue_order(TPods(**{
        k: torch.from_numpy(v) for k, v in pods.items()})).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tassign.neg_i32(torch.tensor([I32_MIN, I32_MAX, 0, -5],
                                     dtype=torch.int32)).numpy(),
        -np.array([I32_MIN, I32_MAX, 0, -5], np.int32))


def test_queue_rank_key_unsigned_bias_matches_jax():
    """The class rank of a wave (ops/waves.py:367-368): the uint32 bias
    expression reproduced bit for bit, INT32_MIN priorities included."""
    rng = np.random.default_rng(13)
    SC = 64
    ok = rng.random(SC) < 0.7
    pri = _tied_ints(rng, SC)
    cre = rng.integers(0, 5, SC).astype(np.int32)
    pri_desc = ~(jnp.asarray(pri).astype(jnp.uint32) ^ jnp.uint32(0x80000000))
    ref = np.asarray(jnp.lexsort((jnp.asarray(cre), pri_desc,
                                  ~jnp.asarray(ok))))
    got = twaves.queue_rank_key(torch.from_numpy(ok), torch.from_numpy(pri),
                                torch.from_numpy(cre)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_score_order_stable_ties_match_jax():
    """Rotated stable descending sort of score rows (ops/waves.py:387-392)
    on rows full of ties, -inf, and signed zeros."""
    rng = np.random.default_rng(14)
    SC, N = 9, 40
    score = rng.choice(np.array([-np.inf, -0.0, 0.0, 1.5, 100.0], np.float32),
                       (SC, N))
    crank = rng.permutation(SC).astype(np.int32)
    s, c = jnp.asarray(score), jnp.asarray(crank)
    rot = (jnp.arange(N, dtype=jnp.int32)[None, :] + ((c * 97) % N)[:, None]) % N
    order_rot = jnp.argsort(-jnp.take_along_axis(s, rot, axis=1), axis=1)
    ref = np.asarray(jnp.take_along_axis(rot, order_rot, axis=1))
    got = twaves.score_order(torch.from_numpy(score),
                             torch.from_numpy(crank)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_scatter_min_group_starts_match_at_min():
    """scatter_reduce(amin, include_self=True) is `.at[].min` over a filled
    base (ops/waves.py:172)."""
    rng = np.random.default_rng(15)
    idx = rng.integers(0, 7, 50).astype(np.int32)
    val = rng.integers(-20, 20, 50).astype(np.int32)
    ref = np.asarray(jnp.full((8,), 50, jnp.int32).at[idx].min(val))
    got = torch.full((8,), 50, dtype=torch.int32).scatter_reduce(
        0, torch.from_numpy(idx).long(), torch.from_numpy(val), reduce="amin",
        include_self=True).numpy()
    np.testing.assert_array_equal(got, ref)
