// K1 contention_scan: the wave engine's per-node contention pass.
//
// Replaces the `block` body of the JAX package's ops/waves.py assign_waves
// (lines 438-503, run by lax.scan at :515): per node, walk the classes that
// tried to admit a pod this wave in queue-rank order and keep a class's
// admission only if it still fits after every earlier class on that node.
// Each of the three stages is an associative scan over the class axis once
// the previous stage is known:
//   1. resources: exclusive running SUM of requests over the ADMITTED set A
//      (before the fit test), then fit._fit's test per (class, node);
//   2. host ports: exclusive running OR of the pair/wild/triple words over
//      the classes kept after stage 1, then the conflict test;
//   3. volumes: exclusive running OR of the any/rw words over the classes
//      kept after stage 2, then the conflict test and the per-driver
//      popcount against the node's limit (< 0: no limit);
// and the words the kept classes commit are an OR over the final keep set.
//
// Design: one warp per node, lanes over classes. Classes go in chunks of 32
// (lane = class in the chunk); each stage is a warp scan with
// __shfl_up_sync (5 steps) per word, skipped by a vote where no lane adds
// anything, the committed words are warp OR reductions (__reduce_or_sync),
// and the running state carried from one chunk to the next is
// warp-uniform, so it lives in registers in the `registers` variant — one
// word per lane, read by shuffle, so each array costs a thread one register
// (widths up to kMaxR resource slots and kMaxW words each, loops unrolled)
// — and in the warp's slice of shared memory in the `shared` variant (any
// width, words looped). Every node-word read sits outside any divergent
// branch or short-circuit, since it may be a shuffle. A block of W warps
// (8 from the wrapper) handles W neighbouring nodes: per chunk it loads the
// chunk's class rows into shared memory once, and passes A in and keep out
// through a [32 classes, W nodes] byte tile so global accesses run along
// nodes. Nothing is kept in device memory between classes.
//
// Bound on an H100: bytes. Each input is read once and each output written
// once (A and keep are [SC, N] bytes; alloc/used [N, R], the node words and
// limits [N, *] int32); the arithmetic is a few integer ops per
// (class, node, word). Arithmetic on requests wraps modulo 2^32, as int32
// does in XLA.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kResPods = 3;       // api/types.py RES_PODS
constexpr int kNumFixedRes = 4;   // api/types.py NUM_FIXED_RES
constexpr int kMaxR = 8;          // registers variant: resource slots
constexpr int kMaxW = 4;          // registers variant: PW, PT, VW and DR
constexpr int kMaxWarps = 16;     // warps (nodes) per block; at most 42
                                  // registers a thread, so 48 warps share
                                  // an SM and the flagship's 5,120 warps
                                  // are all resident at once
constexpr unsigned kFull = 0xffffffffu;

// Loop over i < n; unrolled to the compile-time bound M when M > 0.
#define EACH(i, n, M)                                        \
  _Pragma("unroll") for (int i = 0; i < ((M) ? (M) : (n)); ++i) \
    if (!(M) || i < (n))

// Warp-uniform words of one node: when the width has the compile-time bound
// M (<= 32), one register per lane — lane i holds word i and a read is a
// shuffle from it, so the node's whole state costs each thread one register
// per array; else the warp's slice of shared memory (lane 0 writes, between
// two __syncwarp so every lane has read the old value and sees the new one).
template <int M>
struct NodeWords {
  static_assert(M <= 32, "one word per lane");
  uint32_t v;
  __device__ __forceinline__ void bind(uint32_t*&, int) {}
  __device__ __forceinline__ uint32_t operator[](int i) const {
    return __shfl_sync(kFull, v, i);
  }
  __device__ __forceinline__ void put(int i, uint32_t x) {
    if ((int)(threadIdx.x & 31) == i) v = x;
  }
};
template <>
struct NodeWords<0> {
  uint32_t* p;
  __device__ __forceinline__ void bind(uint32_t*& cursor, int n) {
    p = cursor;
    cursor += n;
  }
  __device__ __forceinline__ uint32_t operator[](int i) const { return p[i]; }
  __device__ __forceinline__ void put(int i, uint32_t x) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) p[i] = x;
    __syncwarp();
  }
};

// Per-lane words: registers, or a [n, 32] slice of shared memory.
template <int M>
struct LaneWords {
  uint32_t v[M];
  __device__ __forceinline__ void bind(uint32_t*&, int) {}
  __device__ __forceinline__ uint32_t operator[](int i) const { return v[i]; }
  __device__ __forceinline__ void put(int i, uint32_t x) { v[i] = x; }
};
template <>
struct LaneWords<0> {
  uint32_t* p;
  __device__ __forceinline__ void bind(uint32_t*& cursor, int n) {
    p = cursor + (threadIdx.x & 31);
    cursor += 32 * n;
  }
  __device__ __forceinline__ uint32_t operator[](int i) const { return p[32 * i]; }
  __device__ __forceinline__ void put(int i, uint32_t x) { p[32 * i] = x; }
};

// Exclusive scans over the warp's lanes; `total` gets the inclusive value
// of lane 31. A scan in which no lane adds anything is all zeros: one vote
// skips it (classes without host ports or volumes carry zero words).
__device__ __forceinline__ uint32_t excl_sum(uint32_t x, int lane,
                                             uint32_t& total) {
  if (!__any_sync(kFull, x != 0u)) {
    total = 0u;
    return 0u;
  }
  uint32_t s = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, s, o);
    if (lane >= o) s += y;
  }
  total = __shfl_sync(kFull, s, 31);
  return s - x;
}

__device__ __forceinline__ uint32_t excl_or(uint32_t x, int lane,
                                            uint32_t& total) {
  if (!__any_sync(kFull, x != 0u)) {
    total = 0u;
    return 0u;
  }
  uint32_t s = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, s, o);
    if (lane >= o) s |= y;
  }
  total = __shfl_sync(kFull, s, 31);
  const uint32_t e = __shfl_up_sync(kFull, s, 1);
  return lane == 0 ? 0u : e;
}

__device__ __forceinline__ uint32_t warp_or(uint32_t x) {
  return __reduce_or_sync(kFull, x);
}

// Shared memory of a block of `warps` warps, in 32-bit words: the chunk's
// class rows [32, R | PW | PW | PT | VW | VW], the driver masks [DR, VW],
// then (shared variant only) each warp's node words and per-lane volume
// words, then 64 flag bytes and the [32, warps] A/keep byte tile.
__host__ __device__ inline size_t block_words(int R, int PW, int PT, int VW,
                                              int DR) {
  return (size_t)32 * (R + 2 * PW + PT + 2 * VW) + (size_t)DR * VW;
}
__host__ __device__ inline size_t warp_words(int R, int PW, int PT, int VW,
                                             int DR) {
  // base, carry [R]; carries and outputs pa/pw/pt/va/vr; vol_any/rw [VW];
  // limits [DR]; per-lane volume words after the class [VW, 32]
  return (size_t)2 * R + 4 * PW + 2 * PT + 6 * VW + DR + 32 * VW;
}
inline size_t smem_bytes(bool shared_variant, int warps, int R, int PW, int PT,
                         int VW, int DR) {
  size_t words = block_words(R, PW, PT, VW, DR);
  if (shared_variant) words += (size_t)warps * warp_words(R, PW, PT, VW, DR);
  return 4 * words + 64 + (size_t)32 * warps;
}

template <int MR, int MW>
__global__ void __launch_bounds__(32 * kMaxWarps, 3) contention_scan_kernel(
    const uint8_t* __restrict__ A, const int32_t* __restrict__ req,
    const uint8_t* __restrict__ has_p, const int32_t* __restrict__ pw,
    const int32_t* __restrict__ ww, const int32_t* __restrict__ tw,
    const uint8_t* __restrict__ has_v, const int32_t* __restrict__ va,
    const int32_t* __restrict__ vr, const int32_t* __restrict__ alloc,
    const int32_t* __restrict__ used, const int32_t* __restrict__ vol_any,
    const int32_t* __restrict__ vol_rw, const int32_t* __restrict__ drv,
    const int32_t* __restrict__ vlim, uint8_t* __restrict__ keep,
    int32_t* __restrict__ out_pa, int32_t* __restrict__ out_pw,
    int32_t* __restrict__ out_pt, int32_t* __restrict__ out_va,
    int32_t* __restrict__ out_vr, int SC, int N, int R, int PW, int PT,
    int VW, int DR) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, tid = threadIdx.x;
  const int n0 = blockIdx.x * warps, n = n0 + warp;
  const bool live = n < N;

  uint32_t* s_req = smem;                       // [32, R]
  uint32_t* s_pw = s_req + 32 * R;              // [32, PW]
  uint32_t* s_ww = s_pw + 32 * PW;              // [32, PW]
  uint32_t* s_tw = s_ww + 32 * PW;              // [32, PT]
  uint32_t* s_va = s_tw + 32 * PT;              // [32, VW]
  uint32_t* s_vr = s_va + 32 * VW;              // [32, VW]
  uint32_t* s_drv = s_vr + 32 * VW;             // [DR, VW]
  uint32_t* tail = s_drv + DR * VW;             // [warps, warp_words]
  uint32_t* cursor = tail;
  if (MR == 0) {
    cursor += (size_t)warp * warp_words(R, PW, PT, VW, DR);
    tail += (size_t)warps * warp_words(R, PW, PT, VW, DR);
  }
  NodeWords<MR> base, cres;
  NodeWords<MW> cpa, cpw, cpt, cva, cvr, opa, opw, opt, ova, ovr, vany, vrw,
      lim;
  LaneWords<MW> after;
  base.bind(cursor, R);
  cres.bind(cursor, R);
  cpa.bind(cursor, PW);
  cpw.bind(cursor, PW);
  cpt.bind(cursor, PT);
  cva.bind(cursor, VW);
  cvr.bind(cursor, VW);
  opa.bind(cursor, PW);
  opw.bind(cursor, PW);
  opt.bind(cursor, PT);
  ova.bind(cursor, VW);
  ovr.bind(cursor, VW);
  vany.bind(cursor, VW);
  vrw.bind(cursor, VW);
  lim.bind(cursor, DR);
  after.bind(cursor, VW);
  uint8_t* s_hp = reinterpret_cast<uint8_t*>(tail);        // [32]
  uint8_t* s_hv = s_hp + 32;                                // [32]
  uint8_t* tile = s_hv + 32;                                // [32, warps]

  // the node's own rows, once per warp
  EACH(r, R, MR) {
    base.put(r, live ? (uint32_t)alloc[(size_t)n * R + r] -
                           (uint32_t)used[(size_t)n * R + r]
                     : 0u);
    cres.put(r, 0u);
  }
  EACH(w, PW, MW) {
    cpa.put(w, 0u);
    cpw.put(w, 0u);
    opa.put(w, 0u);
    opw.put(w, 0u);
  }
  EACH(w, PT, MW) {
    cpt.put(w, 0u);
    opt.put(w, 0u);
  }
  EACH(w, VW, MW) {
    cva.put(w, 0u);
    cvr.put(w, 0u);
    ova.put(w, 0u);
    ovr.put(w, 0u);
    vany.put(w, live ? (uint32_t)vol_any[(size_t)n * VW + w] : 0u);
    vrw.put(w, live ? (uint32_t)vol_rw[(size_t)n * VW + w] : 0u);
  }
  EACH(d, DR, MW) lim.put(d, live ? (uint32_t)vlim[(size_t)n * DR + d] : 0u);
  for (int i = tid; i < DR * VW; i += blockDim.x) s_drv[i] = (uint32_t)drv[i];

  for (int c0 = 0; c0 < SC; c0 += 32) {
    const int nc = min(32, SC - c0);
    __syncthreads();  // the previous chunk's rows and tile are done with
    for (int i = tid; i < nc * R; i += blockDim.x)
      s_req[i] = (uint32_t)req[(size_t)c0 * R + i];
    for (int i = tid; i < nc * PW; i += blockDim.x) {
      s_pw[i] = (uint32_t)pw[(size_t)c0 * PW + i];
      s_ww[i] = (uint32_t)ww[(size_t)c0 * PW + i];
    }
    for (int i = tid; i < nc * PT; i += blockDim.x)
      s_tw[i] = (uint32_t)tw[(size_t)c0 * PT + i];
    for (int i = tid; i < nc * VW; i += blockDim.x) {
      s_va[i] = (uint32_t)va[(size_t)c0 * VW + i];
      s_vr[i] = (uint32_t)vr[(size_t)c0 * VW + i];
    }
    if (tid < 32) {
      s_hp[tid] = tid < nc ? has_p[c0 + tid] : 0;
      s_hv[tid] = tid < nc ? has_v[c0 + tid] : 0;
    }
    for (int i = tid; i < 32 * warps; i += blockDim.x) {
      const int c = i / warps, m = i - c * warps;
      tile[i] = (c < nc && n0 + m < N) ? A[(size_t)(c0 + c) * N + n0 + m] : 0;
    }
    __syncthreads();

    // lanes >= nc carry a = 0 and no flags, so they add nothing to a scan
    const bool a = tile[lane * warps + warp] != 0;
    const bool hp = s_hp[lane] != 0, hv = s_hv[lane] != 0;

    // ---- 1. resources: fit against free minus earlier admissions ----
    const uint32_t* rq = s_req + lane * R;
    bool pods_ok = true, res_ok = true;
    int32_t zmax = 0;  // the pods slot counts as 0 in the all-zero test
    EACH(r, R, MR) {
      const uint32_t v = rq[r];
      uint32_t tot;
      const uint32_t carry = cres[r];
      const uint32_t claimed = carry + excl_sum(a ? v : 0u, lane, tot);
      const int32_t free_r = (int32_t)(base[r] - claimed);
      const int32_t vs = (int32_t)v;
      if (r == kResPods) {
        pods_ok = vs <= free_r;
      } else {
        zmax = vs > zmax ? vs : zmax;
        res_ok = res_ok && ((r >= kNumFixedRes && vs == 0) || vs <= free_r);
      }
      cres.put(r, carry + tot);
    }
    const bool keep1 = a && pods_ok && (zmax == 0 || res_ok);

    // ---- 2. host ports against earlier classes kept after resources ----
    const bool addp = keep1 && hp;
    bool conflict = false;
    EACH(w, PW, MW) {
      const uint32_t p = s_pw[lane * PW + w], wd = s_ww[lane * PW + w];
      uint32_t tpa, tpw;
      const uint32_t ca = cpa[w], cw = cpw[w];
      const uint32_t epa = ca | excl_or(addp ? p : 0u, lane, tpa);
      const uint32_t epw = cw | excl_or(addp ? wd : 0u, lane, tpw);
      conflict = conflict || (wd & epa) != 0u || (p & epw) != 0u;
      cpa.put(w, ca | tpa);
      cpw.put(w, cw | tpw);
    }
    EACH(w, PT, MW) {
      const uint32_t t = s_tw[lane * PT + w];
      uint32_t tpt;
      const uint32_t ct = cpt[w];
      const uint32_t ept = ct | excl_or(addp ? t : 0u, lane, tpt);
      conflict = conflict || (t & ept) != 0u;
      cpt.put(w, ct | tpt);
    }
    const bool keep2 = keep1 && (!hp || !conflict);

    // ---- 3. volumes against the node plus earlier classes kept after
    //      ports ----
    const bool addv = keep2 && hv;
    bool vconf = false;
    EACH(w, VW, MW) {
      const uint32_t a_w = s_va[lane * VW + w], r_w = s_vr[lane * VW + w];
      uint32_t tva, tvr;
      const uint32_t ca = cva[w], cr = cvr[w], na = vany[w], nr = vrw[w];
      const uint32_t eva = ca | excl_or(addv ? a_w : 0u, lane, tva);
      const uint32_t evr = cr | excl_or(addv ? r_w : 0u, lane, tvr);
      vconf = vconf || (a_w & (nr | evr)) != 0u ||
              (r_w & (na | eva)) != 0u;
      after.put(w, na | eva | a_w);
      cva.put(w, ca | tva);
      cvr.put(w, cr | tvr);
    }
    bool vlim_ok = true;
    EACH(d, DR, MW) {
      int cnt = 0;
      EACH(w, VW, MW) cnt += __popc(after[w] & s_drv[d * VW + w]);
      const int32_t l = (int32_t)lim[d];
      vlim_ok = vlim_ok && (l < 0 || cnt <= l);
    }
    const bool keep3 = keep2 && (!hv || (!vconf && vlim_ok));

    // ---- 4. the words the kept classes commit ----
    const bool cp = keep3 && hp, cv = keep3 && hv;
    EACH(w, PW, MW) {
      const uint32_t xa = warp_or(cp ? s_pw[lane * PW + w] : 0u);
      const uint32_t xw = warp_or(cp ? s_ww[lane * PW + w] : 0u);
      const uint32_t oa = opa[w], ow = opw[w];
      opa.put(w, oa | xa);
      opw.put(w, ow | xw);
    }
    EACH(w, PT, MW) {
      const uint32_t xt = warp_or(cp ? s_tw[lane * PT + w] : 0u);
      const uint32_t ot = opt[w];
      opt.put(w, ot | xt);
    }
    EACH(w, VW, MW) {
      const uint32_t xa = warp_or(cv ? s_va[lane * VW + w] : 0u);
      const uint32_t xr = warp_or(cv ? s_vr[lane * VW + w] : 0u);
      const uint32_t oa = ova[w], orw = ovr[w];
      ova.put(w, oa | xa);
      ovr.put(w, orw | xr);
    }

    // each thread rewrites only the tile byte it read
    tile[lane * warps + warp] = keep3 ? 1 : 0;
    __syncthreads();
    for (int i = tid; i < nc * warps; i += blockDim.x) {
      const int c = i / warps, m = i - c * warps;
      if (n0 + m < N) keep[(size_t)(c0 + c) * N + n0 + m] = tile[i];
    }
  }

  // every lane reads (a read may be a shuffle), lane 0 writes
  const bool writer = live && lane == 0;
  EACH(w, PW, MW) {
    const uint32_t xa = opa[w], xw = opw[w];
    if (writer) {
      out_pa[(size_t)n * PW + w] = (int32_t)xa;
      out_pw[(size_t)n * PW + w] = (int32_t)xw;
    }
  }
  EACH(w, PT, MW) {
    const uint32_t xt = opt[w];
    if (writer) out_pt[(size_t)n * PT + w] = (int32_t)xt;
  }
  EACH(w, VW, MW) {
    const uint32_t xa = ova[w], xr = ovr[w];
    if (writer) {
      out_va[(size_t)n * VW + w] = (int32_t)xa;
      out_vr[(size_t)n * VW + w] = (int32_t)xr;
    }
  }
}

template <int MR, int MW>
cudaError_t launch(int blocks, int warps, size_t smem, cudaStream_t stream,
                   const void* const* p, int SC, int N, int R, int PW, int PT,
                   int VW, int DR) {
  auto kernel = contention_scan_kernel<MR, MW>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, 32 * warps, smem, stream>>>(
      (const uint8_t*)p[0], (const int32_t*)p[1], (const uint8_t*)p[2],
      (const int32_t*)p[3], (const int32_t*)p[4], (const int32_t*)p[5],
      (const uint8_t*)p[6], (const int32_t*)p[7], (const int32_t*)p[8],
      (const int32_t*)p[9], (const int32_t*)p[10], (const int32_t*)p[11],
      (const int32_t*)p[12], (const int32_t*)p[13], (const int32_t*)p[14],
      (uint8_t*)p[15], (int32_t*)p[16], (int32_t*)p[17], (int32_t*)p[18],
      (int32_t*)p[19], (int32_t*)p[20], SC, N, R, PW, PT, VW, DR);
  return cudaGetLastError();
}

}  // namespace

// `shared_variant` 0 runs the registers variant (R <= 8, PW/PT/VW/DR <= 4),
// 1 the shared-memory variant; `blocks` blocks of `warps` nodes; `smem` the
// dynamic shared memory the caller sized for them (checked against the
// layout).
extern "C" int contention_scan_launch(
    const void* A, const void* req, const void* has_p, const void* pw,
    const void* ww, const void* tw, const void* has_v, const void* va,
    const void* vr, const void* alloc, const void* used, const void* vol_any,
    const void* vol_rw, const void* drv, const void* vlim, void* keep,
    void* out_pa, void* out_pw, void* out_pt, void* out_va, void* out_vr,
    int SC, int N, int R, int PW, int PT, int VW, int DR, int shared_variant,
    int warps, int blocks, int smem, void* stream) {
  const void* p[21] = {A,    req,   has_p,   pw,     ww,   tw,     has_v,
                       va,   vr,    alloc,   used,   vol_any, vol_rw, drv,
                       vlim, keep,  out_pa,  out_pw, out_pt,  out_va, out_vr};
  if (warps < 1 || warps > kMaxWarps || R < kNumFixedRes ||
      (long long)blocks * warps < N ||
      (!shared_variant &&
       (R > kMaxR || PW > kMaxW || PT > kMaxW || VW > kMaxW || DR > kMaxW)) ||
      (size_t)smem < smem_bytes(shared_variant != 0, warps, R, PW, PT, VW, DR))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      shared_variant
          ? launch<0, 0>(blocks, warps, smem, s, p, SC, N, R, PW, PT, VW, DR)
          : launch<kMaxR, kMaxW>(blocks, warps, smem, s, p, SC, N, R, PW, PT,
                                 VW, DR);
  return (int)err;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
