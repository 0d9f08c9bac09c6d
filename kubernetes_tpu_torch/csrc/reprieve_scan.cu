// K3 reprieve_scan: the per-node half of the preemption what-if for B
// preemptor lanes at once — selectVictimsOnNode (generic_scheduler.go:
// 1125-1170, both passes) plus each node's inputs to
// pickOneNodeForPreemption (:903).
//
// Replaces, in the JAX package's ops/preempt.py preempt_for_pod (vmapped
// over the lanes): pass 1 (lines 128-151: used_wo, conflict_wo and the fit;
// their half of `cand` at :156), the reprieve lax.scan (lines 183-200) and
// the five per-node summaries of the node choice (lines 205-217).
//
// The function, for every (lane b, node n):
//   pass 1  used_wo  = used[n] - sum of req_e[e] over the node's pods with
//                      vict_pot[b, e] (int32 arithmetic that wraps);
//           conflict = any pod e of the node with c_e[b, e] & ~vict_pot[b, e];
//           cand     = cand_rest[b, n] & valid[n] & ~conflict
//                      & _fit(req_p[b], alloc[n] - used_wo);
//   pass 2  if cand: walk the node's pods in reprieve order; per potential
//           victim e:
//             fit  = _fit(req_p[b], alloc[n] - (used + req_e[e]))
//             keep = fit & ~(conflict | c_e[b, e]) & ~reblock[b, e]
//             if keep: used += req_e[e]; conflict |= c_e[b, e]
//             else:    victim[b, e] = 1
//   summaries over the node's victims: num_v (count), sum_p (priority sum,
//           wrapping), max_p (highest priority, from -INT32_MAX: a victim
//           at INT32_MIN never raises it), num_pdb (PDB-blocked count), est
//           (least creation among the victims whose priority equals the
//           final max_p; I32_MAX if none).
// The fit test is the port's _fit exactly (ops/fit.py): cpu, memory and
// ephemeral storage checked even at a zero request, a zero scalar request
// ignored, the pods slot on its own rule, the zero-request escape, int32
// arithmetic that wraps (done in uint32 here, where wrapping is defined).
//
// The reprieve order is the same in every lane: the JAX order
// lexsort((e, -prio, ~pdb_blocked, ~vict_pot[b])) restricted to the pods
// the walk acts on (its potential victims) is (PDB-blocked first, jnp's
// wrapped -priority ascending, e). The caller builds it once per burst as
// a CSR over [E] (ops/preempt.py reprieve_order): node n's pods are
// seg_e[seg_ptr[n] : seg_ptr[n + 1]]; pods on no node lie past seg_ptr[N].
//
// Design. One warp per node, kWarps nodes per block, one kernel per R
// (4..8) so that every per-slot loop unrolls to exactly R; the B lanes in
// groups of 32, lane g + t on thread t (lanes past 32 loop). The warp
// takes its node's segment kStage positions at a time, one position per
// thread: the thread loads the pod id (seg_e, coalesced), then in one
// round of independent loads the pod's request row, priority, creation
// and PDB byte, and the flags (vict_pot, c_e, reblock) of its position for
// kLaneBatch lanes at once, and stages the pod's data in shared memory
// (the PDB bits as one ballot word per 32 positions). A ballot per lane
// and flag turns the flags into one word per 32 positions, kept in the
// registers of that lane's thread. Pass 1 is a warp reduction per lane and
// slot (__reduce_add_sync over the lane's potential victims; the live
// clashes from the ballots). Pass 2: the thread of each candidate lane
// walks its potential victims in the staged window (the set bits of its
// vict_pot words, in segment order), reading the staged rows from shared
// memory, so the walk's steps carry no global load; the carries (R used
// words, the conflict bit) and the five summaries stay in registers and
// are written once. A node no lane of the group may choose (not valid, or
// cand_rest false in every lane) reads no segment. A segment longer than
// kStage is streamed: pass 1 over every window, then pass 2 stages each
// window again.
//
// Bound on an H100: bytes. Per node that some lane may choose: its seg_ptr
// entries, used and alloc rows; per position of its segment: seg_e, and
// vict_pot and c_e per lane that may choose it; the request row of a pod
// that is a potential victim in such a lane; reblock per potential victim
// a candidate lane walks; priority, creation and the PDB byte of each pod
// evicted in some lane; cand_rest [B, N], valid [N] and req_p read once;
// victim [B, E], cand [B, N] and the five [B, N] planes written once.
// Operations: about R + 3 per (lane, position) in pass 1 and 3R + 10 per
// potential-victim step of the walk — far below the bytes' time. The walk
// is sequential over a segment (at most a node's pods cap, 110 on the
// flagship's nodes), so the kernel is latency-bound, not bandwidth-bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;             // nodes per block, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kStage = 128;           // segment positions a warp stages
constexpr int kChunks = kStage / 32;  // ballot words per flag and window
constexpr int kLaneBatch = 8;         // lanes' flags a thread loads at once
constexpr int kMaxR = 8;              // resource slots carried in registers
constexpr int kPods = 3;              // api/types.py RES_PODS
constexpr int kFixed = 4;             // api/types.py NUM_FIXED_RES
constexpr int32_t kI32Max = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int32_t* seg_ptr;     // [N + 1]
  const int32_t* seg_e;       // [E]
  const int32_t* req_e;       // [E, R]
  const int32_t* prio_e;      // [E]
  const uint8_t* pdb_e;       // [E]
  const int32_t* creation_e;  // [E]
  const int32_t* req_p;       // [B, R]
  const uint8_t* vict_pot;    // [B, E]
  const uint8_t* c_e;         // [B, E]
  const uint8_t* reblock;     // [B, E]
  const int32_t* used;        // [N, R]
  const int32_t* alloc;       // [N, R]
  const uint8_t* valid;       // [N]
  const uint8_t* cand_rest;   // [B, N]
  uint8_t* victim;            // [B, E], zeroed by the caller
  uint8_t* cand;              // [B, N]
  int32_t* planes;            // [5, B, N]: num_v, sum_p, max_p, num_pdb, est
  int B, N, E;
};

// One warp's window of its node's segment.
template <int R>
struct Stage {
  int32_t e[kStage];
  int32_t req[R][kStage];
  int32_t prio[kStage];
  int32_t cre[kStage];
  uint32_t pdb[kChunks];
};

// ops/fit.py _fit for one request vector against cap - used.
template <int R>
__device__ __forceinline__ bool fits(const int32_t (&vec)[R],
                                     const int32_t (&cap)[R],
                                     const uint32_t (&used)[R],
                                     bool zero_all) {
  bool pods_ok = true, res_ok = true;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int32_t free_r = (int32_t)((uint32_t)cap[r] - used[r]);
    if (r == kPods) {
      pods_ok = vec[r] <= free_r;
    } else if (!(r >= kFixed && vec[r] == 0) && vec[r] > free_r) {
      res_ok = false;
    }
  }
  return pods_ok && (zero_all || res_ok);
}

// One window of the node's segment, positions [w0, w0 + wl) from lo, for
// lanes g .. g + nl - 1. With `stage`, each thread first loads its
// position's pod id, and then its request row, priority, creation and PDB
// byte into the warp's stage, in the same round of loads as its flags;
// else the stage already holds the window. Thread j ends with lane g + j's
// vict_pot, c_e and reblock bits, one word per 32 positions. With kSum
// (pass 1), thread j also adds lane g + j's potential victims' requests to
// rem (a warp reduction per lane and slot) and ORs its live clashes into
// clash; lanes outside `lanes` (a bit per thread) skip the reduction.
template <int R, bool kSum>
__device__ __forceinline__ void window(
    Stage<R>& s, const Args& a, int lo, int w0, int wl, bool stage, int g,
    int nl, int t, uint32_t lanes, uint32_t (&vpw)[kChunks],
    uint32_t (&cew)[kChunks], uint32_t (&rbw)[kChunks], uint32_t (&rem)[R],
    bool& clash) {
  if (stage) __syncwarp();  // every thread is done reading the old window
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    vpw[c] = cew[c] = rbw[c] = 0;
    if (c * 32 >= wl) continue;
    const int i = c * 32 + t;
    const bool in = i < wl;
    int e = 0;
    uint32_t q[R];
    bool pdb = false;
    if (in) e = stage ? a.seg_e[lo + w0 + i] : s.e[i];
    if (in && stage) {
#pragma unroll
      for (int r = 0; r < R; ++r) q[r] = (uint32_t)a.req_e[(size_t)e * R + r];
      s.prio[i] = a.prio_e[e];
      s.cre[i] = a.creation_e[e];
      pdb = a.pdb_e[e] != 0;
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        q[r] = (kSum && in) ? (uint32_t)s.req[r][i] : 0u;
    }
    for (int j0 = 0; j0 < nl; j0 += kLaneBatch) {
      uint32_t f[kLaneBatch];
#pragma unroll
      for (int u = 0; u < kLaneBatch; ++u) {
        const int j = j0 + u;
        f[u] = 0;
        if (in && j < nl) {
          const size_t row = (size_t)(g + j) * a.E + e;
          f[u] = (a.vict_pot[row] != 0) | ((a.c_e[row] != 0) << 1) |
                 ((a.reblock[row] != 0) << 2);
        }
      }
#pragma unroll
      for (int u = 0; u < kLaneBatch; ++u) {
        const int j = j0 + u;
        if (j >= nl) break;
        const bool vp = f[u] & 1u;
        const uint32_t vm = __ballot_sync(kFull, vp);
        const uint32_t cm = __ballot_sync(kFull, f[u] & 2u);
        const uint32_t rm = __ballot_sync(kFull, f[u] & 4u);
        if (t == j) {
          vpw[c] = vm;
          cew[c] = cm;
          rbw[c] = rm;
        }
        if (kSum && ((lanes >> j) & 1u)) {
          if (t == j && (cm & ~vm) != 0) clash = true;
          if (vm != 0) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const uint32_t sum = __reduce_add_sync(kFull, vp ? q[r] : 0u);
              if (t == j) rem[r] += sum;
            }
          }
        }
      }
    }
    if (stage) {
      if (in) {
        s.e[i] = e;
#pragma unroll
        for (int r = 0; r < R; ++r) s.req[r][i] = (int32_t)q[r];
      }
      const uint32_t word = __ballot_sync(kFull, pdb);
      if (t == 0) s.pdb[c] = word;
    }
  }
  if (stage) __syncwarp();
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    reprieve_scan_kernel(const Args a) {
  __shared__ Stage<R> stages[kWarps];
  const int t = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= a.N) return;  // the whole warp leaves together
  Stage<R>& s = stages[threadIdx.x >> 5];
  const int lo = a.seg_ptr[n], len = a.seg_ptr[n + 1] - lo;
  const bool node_ok = a.valid[n] != 0;
  int32_t cap[R], base[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    cap[r] = a.alloc[(size_t)n * R + r];
    base[r] = a.used[(size_t)n * R + r];
  }
  const int nwin = (len + kStage - 1) / kStage;
  const size_t plane = (size_t)a.B * a.N;
  int staged = -1;  // the window start whose pods s holds

  for (int g = 0; g < a.B; g += 32) {
    const int b = g + t, nl = min(32, a.B - g);
    const size_t bn = (size_t)b * a.N + n;
    const bool live = b < a.B && node_ok && a.cand_rest[bn] != 0;
    int32_t vec[R];
    bool zero_all = true;  // the zero-request escape
#pragma unroll
    for (int r = 0; r < R; ++r) {
      vec[r] = b < a.B ? a.req_p[(size_t)b * R + r] : 0;
      if (r != kPods && vec[r] > 0) zero_all = false;
    }
    const uint32_t lanes = __ballot_sync(kFull, live);
    bool cand = false;
    int32_t num_v = 0, max_p = -kI32Max, num_pdb = 0, est = kI32Max;
    uint32_t sum_p = 0;
    if (lanes != 0) {
      uint32_t used[R], rem[R];
#pragma unroll
      for (int r = 0; r < R; ++r) rem[r] = 0;
      uint32_t vpw[kChunks], cew[kChunks], rbw[kChunks];
      bool conflict = false;

      // pass 1: every potential victim removed
      for (int w0 = 0; w0 < len; w0 += kStage) {
        window<R, true>(s, a, lo, w0, min(kStage, len - w0), staged != w0,
                        g, nl, t, lanes, vpw, cew, rbw, rem, conflict);
        staged = w0;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) used[r] = (uint32_t)base[r] - rem[r];
      cand = live && !conflict && fits<R>(vec, cap, used, zero_all);

      // pass 2: the reprieve walk of each candidate lane
      if (__any_sync(kFull, cand)) {
        for (int w0 = 0; w0 < len; w0 += kStage) {
          const int wl = min(kStage, len - w0);
          if (nwin > 1) {  // one window: pass 1's stage and flags hold
            window<R, false>(s, a, lo, w0, wl, true, g, nl, t, 0u, vpw, cew,
                             rbw, rem, conflict);
            staged = w0;
          }
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            if (c * 32 >= wl) break;
            // this lane's potential victims in the chunk, in walk order;
            // the step is branch-free, so kept and evicted lanes of the
            // warp stay together
            uint32_t vm = cand ? vpw[c] : 0u;
            while (vm != 0) {
              const int i = __ffs(vm) - 1;
              vm &= vm - 1;
              const int k = c * 32 + i;
              const int32_t p = s.prio[k], cre = s.cre[k];
              uint32_t nu[R];
#pragma unroll
              for (int r = 0; r < R; ++r)
                nu[r] = used[r] + (uint32_t)s.req[r][k];
              const bool nc = conflict || ((cew[c] >> i) & 1u);
              const bool keep = !nc && !((rbw[c] >> i) & 1u) &&
                                fits<R>(vec, cap, nu, zero_all);
#pragma unroll
              for (int r = 0; r < R; ++r) used[r] = keep ? nu[r] : used[r];
              conflict = keep ? nc : conflict;
              if (!keep) a.victim[(size_t)b * a.E + s.e[k]] = 1;
              const bool top = !keep && p >= max_p;
              num_v += !keep;
              sum_p += keep ? 0u : (uint32_t)p;
              num_pdb += (int32_t)(!keep & ((s.pdb[c] >> i) & 1u));
              est = top ? (p > max_p ? cre : min(est, cre)) : est;
              max_p = top ? p : max_p;
            }
          }
        }
      }
    }
    if (b < a.B) {
      a.cand[bn] = cand;
      a.planes[bn] = num_v;
      a.planes[plane + bn] = (int32_t)sum_p;
      a.planes[2 * plane + bn] = max_p;
      a.planes[3 * plane + bn] = num_pdb;
      a.planes[4 * plane + bn] = est;
    }
  }
}

}  // namespace

// One warp per node, kWarps nodes per block, a kernel per R. `victim`
// [B, E] must be zeroed by the caller; cand [B, N] and the five int32
// planes [5, B, N] are written in full. Returns a cudaError_t (0 on
// success).
extern "C" int reprieve_scan_launch(
    const void* seg_ptr, const void* seg_e, const void* req_e,
    const void* prio_e, const void* pdb_e, const void* creation_e,
    const void* req_p, const void* vict_pot, const void* c_e,
    const void* reblock, const void* used, const void* alloc,
    const void* valid, const void* cand_rest, void* victim, void* cand,
    void* planes, int B, int N, int E, int R, void* stream) {
  if (B < 0 || N < 0 || E < 0 || R < kFixed || R > kMaxR)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  const Args a{(const int32_t*)seg_ptr,  (const int32_t*)seg_e,
               (const int32_t*)req_e,    (const int32_t*)prio_e,
               (const uint8_t*)pdb_e,    (const int32_t*)creation_e,
               (const int32_t*)req_p,    (const uint8_t*)vict_pot,
               (const uint8_t*)c_e,      (const uint8_t*)reblock,
               (const int32_t*)used,     (const int32_t*)alloc,
               (const uint8_t*)valid,    (const uint8_t*)cand_rest,
               (uint8_t*)victim,         (uint8_t*)cand,
               (int32_t*)planes,         B, N, E};
  const unsigned blocks = (unsigned)((N + kWarps - 1) / kWarps);
  cudaStream_t st = (cudaStream_t)stream;
  switch (R) {
    case 4: reprieve_scan_kernel<4><<<blocks, kThreads, 0, st>>>(a); break;
    case 5: reprieve_scan_kernel<5><<<blocks, kThreads, 0, st>>>(a); break;
    case 6: reprieve_scan_kernel<6><<<blocks, kThreads, 0, st>>>(a); break;
    case 7: reprieve_scan_kernel<7><<<blocks, kThreads, 0, st>>>(a); break;
    default: reprieve_scan_kernel<8><<<blocks, kThreads, 0, st>>>(a); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
