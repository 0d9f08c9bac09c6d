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
// Design. One warp per node, the B lanes in groups of 32, lane g + t on
// thread t (lanes past 32 loop). Two variants of one template:
//   * R = 4..8 (template argument R): kWarps nodes per block, every
//     per-slot loop unrolled to exactly R, each lane's carries (its request
//     vector, the node's capacity, the used words) in registers and the
//     window in static shared memory;
//   * R > 8 (template argument kWide, R a runtime argument, so every width
//     Dims can produce runs): the window and each lane's carries ([R][32]
//     words, one column per thread) in dynamic shared memory, sized at
//     launch from R, with as many warps per block as fit (ops/kernels.py
//     k3_launch_config).
// The warp takes its node's segment kStage positions at a time, one
// position per thread: the thread loads the pod id (seg_e, coalesced),
// then in one round of independent loads the pod's request row, priority,
// creation and PDB byte, and the flags (vict_pot, c_e, reblock) of its
// position for kLaneBatch lanes at once, and stages the pod's data in
// shared memory (the PDB bits as one ballot word per 32 positions). A
// ballot per lane and flag turns the flags into one word per 32 positions,
// kept in the registers of that lane's thread. Pass 1 is a warp reduction
// per lane and slot (__reduce_add_sync over the lane's potential victims,
// subtracted from the lane's used words; the live clashes from the
// ballots). Pass 2: the thread of each candidate lane walks its potential
// victims in the staged window (the set bits of its vict_pot words, in
// segment order), reading the staged rows from shared memory, so the
// walk's steps carry no global load; the carries (R used words, the
// conflict bit) and the five summaries are written once. A node no lane
// of the group may choose (not valid, or cand_rest false in every lane)
// reads no segment. A segment longer than kStage is streamed: pass 1 over
// every window, then pass 2 stages each window again.
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

constexpr int kWarps = 4;             // nodes per block (fewer may fit: wide)
constexpr int kThreads = kWarps * 32;
constexpr int kStage = 128;           // segment positions a warp stages
constexpr int kChunks = kStage / 32;  // ballot words per flag and window
constexpr int kLaneBatch = 8;         // lanes' flags a thread loads at once
constexpr int kMaxR = 8;              // widest R carried in registers
constexpr int kWide = 0;              // the template R of the wide variant
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
  int B, N, E, R;
};

// One warp's window of its node's segment, in static shared memory.
template <int R>
struct Stage {
  int32_t e[kStage];
  int32_t req[R][kStage];
  int32_t prio[kStage];
  int32_t cre[kStage];
  uint32_t pdb[kChunks];
  __device__ __forceinline__ int32_t& rq(int r, int i) { return req[r][i]; }
};

// The wide variant's window: views into the warp's dynamic shared memory.
template <>
struct Stage<kWide> {
  int32_t* e;
  int32_t* req;  // [R][kStage]
  int32_t* prio;
  int32_t* cre;
  uint32_t* pdb;
  __device__ __forceinline__ int32_t& rq(int r, int i) {
    return req[r * kStage + i];
  }
};

// One lane's carries: its preemptor's request vector, the node's capacity
// and the lane's used words, in registers.
template <int R>
struct Carry {
  int32_t vec[R];
  int32_t cap[R];
  uint32_t used[R];
  __device__ __forceinline__ int32_t& v(int r) { return vec[r]; }
  __device__ __forceinline__ int32_t& c(int r) { return cap[r]; }
  __device__ __forceinline__ uint32_t& u(int r) { return used[r]; }
};

// The wide variant's carries: lane t's column of [R][32] words in the
// warp's dynamic shared memory (the capacity, [R], shared by the warp).
template <>
struct Carry<kWide> {
  int32_t* vec;
  int32_t* cap;
  uint32_t* used;
  int t;
  __device__ __forceinline__ int32_t& v(int r) { return vec[r * 32 + t]; }
  __device__ __forceinline__ int32_t& c(int r) { return cap[r]; }
  __device__ __forceinline__ uint32_t& u(int r) { return used[r * 32 + t]; }
};

// 32-bit words of dynamic shared memory one warp of the wide variant uses:
// the window (e, prio, cre, the PDB words, [R][kStage] requests) and the
// lanes' carries ([R][32] vec and used, [R] capacity). ops/kernels.py
// k3_wide_smem_bytes counts the same.
__host__ __device__ constexpr int wide_words(int R) {
  return 3 * kStage + kChunks + R * kStage + 2 * R * 32 + R;
}

// ops/fit.py _fit for the lane's request vector against the node's
// capacity less its used words plus (k >= 0) the staged pod k's requests.
template <int R>
__device__ __forceinline__ bool fits(Carry<R>& ln, Stage<R>& s, int nr_rt,
                                     int k, bool zero_all) {
  const int nr = R == kWide ? nr_rt : R;
  bool pods_ok = true, res_ok = true;
#pragma unroll
  for (int r = 0; r < nr; ++r) {
    const uint32_t add = k >= 0 ? (uint32_t)s.rq(r, k) : 0u;
    const int32_t free_r = (int32_t)((uint32_t)ln.c(r) - (ln.u(r) + add));
    const int32_t vec_r = ln.v(r);
    if (r == kPods) {
      pods_ok = vec_r <= free_r;
    } else if (!(r >= kFixed && vec_r == 0) && vec_r > free_r) {
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
// (pass 1), thread j also subtracts lane g + j's potential victims'
// requests from its used words (a warp reduction per lane and slot) and
// ORs its live clashes into clash; lanes outside `lanes` (a bit per
// thread) skip the reduction.
template <int R, bool kSum>
__device__ __forceinline__ void window(
    Stage<R>& s, Carry<R>& ln, const Args& a, int lo, int w0, int wl,
    bool stage, int g, int nl, int t, uint32_t lanes,
    uint32_t (&vpw)[kChunks], uint32_t (&cew)[kChunks],
    uint32_t (&rbw)[kChunks], bool& clash) {
  const int nr = R == kWide ? a.R : R;
  if (stage) __syncwarp();  // every thread is done reading the old window
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    vpw[c] = cew[c] = rbw[c] = 0;
    if (c * 32 >= wl) continue;
    const int i = c * 32 + t;
    const bool in = i < wl;
    int e = 0;
    uint32_t q[R == kWide ? 1 : R];  // registers: the position's requests
    bool pdb = false;
    if (in) e = stage ? a.seg_e[lo + w0 + i] : s.e[i];
    if (in && stage) {
      if constexpr (R == kWide) {
        for (int r = 0; r < nr; ++r)
          s.rq(r, i) = a.req_e[(size_t)e * nr + r];
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) q[r] = (uint32_t)a.req_e[(size_t)e * R + r];
      }
      s.prio[i] = a.prio_e[e];
      s.cre[i] = a.creation_e[e];
      pdb = a.pdb_e[e] != 0;
    } else if constexpr (R != kWide) {
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
            for (int r = 0; r < nr; ++r) {
              uint32_t x;
              if constexpr (R == kWide) x = (uint32_t)s.rq(r, i);
              else x = q[r];
              const uint32_t sum = __reduce_add_sync(kFull, vp ? x : 0u);
              if (t == j) ln.u(r) -= sum;
            }
          }
        }
      }
    }
    if (stage) {
      if (in) {
        s.e[i] = e;
        if constexpr (R != kWide) {
#pragma unroll
          for (int r = 0; r < R; ++r) s.req[r][i] = (int32_t)q[r];
        }
      }
      const uint32_t word = __ballot_sync(kFull, pdb);
      if (t == 0) s.pdb[c] = word;
    }
  }
  if (stage) __syncwarp();
}

// Node n's warp: every lane group's pass 1, walks and summaries.
template <int R>
__device__ __forceinline__ void node(Stage<R>& s, Carry<R>& ln,
                                     const Args& a, int n, int t) {
  const int nr = R == kWide ? a.R : R;
  const int lo = a.seg_ptr[n], len = a.seg_ptr[n + 1] - lo;
  const bool node_ok = a.valid[n] != 0;
  if constexpr (R == kWide) {
    for (int r = t; r < nr; r += 32) ln.cap[r] = a.alloc[(size_t)n * nr + r];
    __syncwarp();
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) ln.cap[r] = a.alloc[(size_t)n * R + r];
  }
  const int nwin = (len + kStage - 1) / kStage;
  const size_t plane = (size_t)a.B * a.N;
  int staged = -1;  // the window start whose pods s holds

  for (int g = 0; g < a.B; g += 32) {
    const int b = g + t, nl = min(32, a.B - g);
    const size_t bn = (size_t)b * a.N + n;
    const bool live = b < a.B && node_ok && a.cand_rest[bn] != 0;
    bool zero_all = true;  // the zero-request escape
#pragma unroll
    for (int r = 0; r < nr; ++r) {
      ln.v(r) = b < a.B ? a.req_p[(size_t)b * nr + r] : 0;
      if (r != kPods && ln.v(r) > 0) zero_all = false;
    }
    const uint32_t lanes = __ballot_sync(kFull, live);
    bool cand = false;
    int32_t num_v = 0, max_p = -kI32Max, num_pdb = 0, est = kI32Max;
    uint32_t sum_p = 0;
    if (lanes != 0) {
#pragma unroll
      for (int r = 0; r < nr; ++r)
        ln.u(r) = (uint32_t)a.used[(size_t)n * nr + r];
      uint32_t vpw[kChunks], cew[kChunks], rbw[kChunks];
      bool conflict = false;

      // pass 1: every potential victim removed
      for (int w0 = 0; w0 < len; w0 += kStage) {
        window<R, true>(s, ln, a, lo, w0, min(kStage, len - w0), staged != w0,
                        g, nl, t, lanes, vpw, cew, rbw, conflict);
        staged = w0;
      }
      cand = live && !conflict && fits<R>(ln, s, nr, -1, zero_all);

      // pass 2: the reprieve walk of each candidate lane
      if (__any_sync(kFull, cand)) {
        for (int w0 = 0; w0 < len; w0 += kStage) {
          const int wl = min(kStage, len - w0);
          if (nwin > 1) {  // one window: pass 1's stage and flags hold
            window<R, false>(s, ln, a, lo, w0, wl, true, g, nl, t, 0u, vpw,
                             cew, rbw, conflict);
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
              const bool nc = conflict || ((cew[c] >> i) & 1u);
              const bool keep = !nc && !((rbw[c] >> i) & 1u) &&
                                fits<R>(ln, s, nr, k, zero_all);
#pragma unroll
              for (int r = 0; r < nr; ++r)
                ln.u(r) += keep ? (uint32_t)s.rq(r, k) : 0u;
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

template <int R>
__global__ void __launch_bounds__(kThreads)
    reprieve_scan_kernel(const Args a) {
  __shared__ Stage<R> stages[kWarps];
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= a.N) return;  // the whole warp leaves together
  Carry<R> ln;
  node<R>(stages[threadIdx.x >> 5], ln, a, n, threadIdx.x & 31);
}

// R > kMaxR: blockDim.x / 32 warps, each with wide_words(R) words of the
// dynamic shared memory.
__global__ void __launch_bounds__(kThreads)
    reprieve_scan_wide_kernel(const Args a) {
  extern __shared__ int32_t smem[];
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + w;
  if (n >= a.N) return;
  int32_t* base = smem + (size_t)w * wide_words(a.R);
  int32_t* req = base + 3 * kStage + kChunks;
  Stage<kWide> s{base, req, base + kStage, base + 2 * kStage,
                 (uint32_t*)(base + 3 * kStage)};
  int32_t* vec = req + a.R * kStage;
  Carry<kWide> ln{vec, vec + 2 * a.R * 32, (uint32_t*)(vec + a.R * 32), t};
  node<kWide>(s, ln, a, n, t);
}

}  // namespace

// One warp per node. R = 4..8: kWarps nodes per block, a kernel per R;
// R > 8: `warps` nodes per block and `smem_bytes` of dynamic shared memory
// (at least warps * wide_words(R) words; ops/kernels.py k3_launch_config).
// `victim` [B, E] must be zeroed by the caller; cand [B, N] and the five
// int32 planes [5, B, N] are written in full. Returns a cudaError_t (0 on
// success).
extern "C" int reprieve_scan_launch(
    const void* seg_ptr, const void* seg_e, const void* req_e,
    const void* prio_e, const void* pdb_e, const void* creation_e,
    const void* req_p, const void* vict_pot, const void* c_e,
    const void* reblock, const void* used, const void* alloc,
    const void* valid, const void* cand_rest, void* victim, void* cand,
    void* planes, int B, int N, int E, int R, int warps, int smem_bytes,
    void* stream) {
  if (B < 0 || N < 0 || E < 0 || R < kFixed)
    return (int)cudaErrorInvalidValue;
  if (R > kMaxR && (warps < 1 || warps > kWarps ||
                    (long long)smem_bytes <
                        4LL * warps * (long long)wide_words(R)))
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
               (int32_t*)planes,         B, N, E, R};
  cudaStream_t st = (cudaStream_t)stream;
  if (R > kMaxR) {
    const cudaError_t err = cudaFuncSetAttribute(
        reprieve_scan_wide_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((N + warps - 1) / warps);
    reprieve_scan_wide_kernel<<<blocks, warps * 32, smem_bytes, st>>>(a);
    return (int)cudaGetLastError();
  }
  const unsigned blocks = (unsigned)((N + kWarps - 1) / kWarps);
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
