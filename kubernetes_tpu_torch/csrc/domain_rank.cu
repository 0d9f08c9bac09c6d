// K2 domain_rank: each node's rank within its topology domain, taking nodes
// in a class's score order.
//
// Replaces the rank-in-domain of the JAX package's ops/waves.py
// _domain_quota_pass (slot_quota, lines 165-174: a stable argsort by domain
// plus a scatter-min of the group starts). For row r and position i of
// dom[r, :] (domains already in score order, the discard bucket included),
//     rank[r, i] = #{ j < i : dom[r, j] == dom[r, i] }.
//
// Design: a block of 16 warps per row, the row cut into W <= 16 contiguous
// segments of `seg` positions (a multiple of 32), one counter per
// (segment, domain). Three passes, no sort:
//   1. each warp counts its segment's domains (shared-memory atomics: a
//      count does not depend on order);
//   2. for each domain (all 512 threads, 4 domains each) the counters
//      become the exclusive prefix over segments;
//   3. each warp walks its segment again, 32 positions a step: a lane's
//      rank is its domain's counter plus the lower lanes holding the same
//      domain, and the group's highest lane stores its rank + 1 as the
//      counter. The lanes of a domain are found by an election through a tag
//      byte per (segment, domain) and 6 ballots (shared counters), or by
//      one ballot per bit of the domain (scratch counters).
// Each walk loads kBatch positions per lane at once before it steps through
// them. The dependent walk is seg / 32 warp steps instead of N / 32. The
// counters and tags (5 bytes per (segment, domain)) live in shared memory
// where they fit (227 KB); past that, the counters go to a scratch the
// caller allocates ([blocks, W, D+1 rounded up to 4] int32) and the kernel
// zeroes, with the blocks striding over rows. Any D+1 that fits an int32
// row is answered. With thousands of domains, zeroing and the prefix (2 to
// 3 passes over the counters) cost about as much as the walk: that, not
// the walk alone, sets W.
//
// Bound on an H100: bytes — the row is read once and the ranks written once
// (8 bytes per (row, node)). Domains outside [0, num_domains) are written as
// rank -1 (never produced by the engine: the caller maps absent domains to
// the discard bucket).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;   // every block: 16 warps
constexpr int kMaxSegs = 16;    // segments (walking warps) per row
constexpr int kBatch = 16;      // positions per lane loaded before a walk

// A warp's next 32 * kBatch positions of the row, all loads issued before
// the walk uses any, so the walk waits for memory once per batch.
__device__ __forceinline__ void load_batch(const int32_t* __restrict__ row,
                                           int base, int hi, int lane,
                                           int (&d)[kBatch]) {
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const int i = base + 32 * k + lane;
    d[k] = i < hi ? row[i] : -1;
  }
}

// The lanes holding the same key as this lane: one ballot per bit of the
// key (keys < 2^nbits). __match_any_sync computes the same mask, but with
// many distinct keys it is slow on an H100 and the SM's warps queue for it;
// ballots cost less, and fewer bits cost less still.
__device__ __forceinline__ unsigned same_key_lanes(unsigned key, int nbits) {
  unsigned peers = kFull;
#pragma unroll 8
  for (int b = 0; b < nbits; ++b) {
    const bool bit = (key >> b) & 1u;
    const unsigned ones = __ballot_sync(kFull, bit);
    peers &= bit ? ones : ~ones;
  }
  return peers;
}

// The same for shared-memory counters, with 5-bit keys: every valid lane
// writes its lane number into its domain's tag byte, the lanes of one domain
// all read back the same winner, and 5 ballots on that lane number (plus one
// for validity) group them, whatever the number of domains.
__device__ __forceinline__ unsigned same_domain_lanes(uint8_t* tag, int d,
                                                      bool ok, int lane) {
  if (ok) tag[d] = (uint8_t)lane;
  __syncwarp();
  const unsigned winner = ok ? tag[d] : (unsigned)lane;
  __syncwarp();  // read before the next step's writes
  return same_key_lanes(winner, 5) & __ballot_sync(kFull, ok);
}

template <bool kScratch>
__global__ void __launch_bounds__(kThreads) domain_rank_kernel(
    const int32_t* __restrict__ dom, int32_t* __restrict__ rank,
    int32_t* __restrict__ scratch, int rows, int N, int num_domains,
    int stride, int segs, int seg, int nbits) {
  extern __shared__ int4 s_count4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tid = threadIdx.x;
  const size_t S = (size_t)stride;
  int32_t* count = kScratch ? scratch + (size_t)blockIdx.x * segs * S
                            : reinterpret_cast<int32_t*>(s_count4);
  int32_t* mine = count + (size_t)warp * S;
  // shared counters are followed by a tag byte per (segment, domain)
  uint8_t* tag = reinterpret_cast<uint8_t*>(count + (size_t)segs * S) +
                 (size_t)warp * S;
  const bool walker = warp < segs;
  const int lo = min(N, warp * seg), hi = walker ? min(N, lo + seg) : lo;
  const unsigned lower = (1u << lane) - 1u;
  // invalid positions (and lanes past the segment) share the key
  // num_domains, which no valid domain has
  const unsigned none = (unsigned)num_domains;

  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const int32_t* row = dom + (size_t)r * N;
    int32_t* out = rank + (size_t)r * N;
    // counters [segs, stride], stride a multiple of 4: zeroed 16 bytes a store
    int4* count4 = reinterpret_cast<int4*>(count);
    const size_t quads = (size_t)segs * S / 4;
    for (size_t i = tid; i < quads; i += kThreads)
      count4[i] = make_int4(0, 0, 0, 0);
    __syncthreads();

    // 1. per-segment counts: order does not matter, so atomics
    for (int base = lo; base < hi; base += 32 * kBatch) {
      int d[kBatch];
      load_batch(row, base, hi, lane, d);
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (d[k] >= 0 && d[k] < num_domains) atomicAdd(&mine[d[k]], 1);
    }
    __syncthreads();

    // 2. exclusive prefix over segments, 4 domains per thread; every count
    //    of a group of 8 segments loaded before any is rewritten
    const size_t S4 = S / 4;
    for (size_t q = tid; q < S4; q += kThreads) {
      int4 run = make_int4(0, 0, 0, 0);
      int4* p = count4 + q;
      for (int w0 = 0; w0 < segs; w0 += 8, p += 8 * S4) {
        int4 c[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (w0 + k < segs) c[k] = p[k * S4];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (w0 + k < segs) {
            p[k * S4] = run;
            run.x += c[k].x;
            run.y += c[k].y;
            run.z += c[k].z;
            run.w += c[k].w;
          }
      }
    }
    __syncthreads();

    // 3. ranks: earlier segments + earlier in this segment + lower lanes;
    //    the group's highest lane stores its own rank + 1 as the counter
    for (int base = lo; base < hi; base += 32 * kBatch) {
      int d[kBatch];
      load_batch(row, base, hi, lane, d);
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (base + 32 * k >= hi) break;  // warp-uniform
        const int i = base + 32 * k + lane;
        const bool ok = d[k] >= 0 && d[k] < num_domains;
        const unsigned peers =
            kScratch ? same_key_lanes(ok ? (unsigned)d[k] : none, nbits)
                     : same_domain_lanes(tag, d[k], ok, lane);
        const int rk = ok ? mine[d[k]] + __popc(peers & lower) : -1;
        __syncwarp();
        if (i < hi) out[i] = rk;
        if (ok && lane == 31 - __clz(peers)) mine[d[k]] = rk + 1;
        __syncwarp();
      }
    }
    __syncthreads();  // the counters are zeroed again for the next row
  }
}

}  // namespace

// Blocks of 512 threads; the first `segs` warps walk `seg` positions each,
// all of them zero the counters and take the prefix. `blocks` blocks stride
// over the rows. Counters [segs, stride] int32 with stride = num_domains
// rounded up to 4: `scratch` null, `smem` bytes of shared memory holding
// them and [segs, stride] tag bytes; else [blocks, segs, stride] in the
// scratch.
extern "C" int domain_rank_launch(const void* dom, void* rank, void* scratch,
                                  int rows, int N, int num_domains, int segs,
                                  int seg, int blocks, int smem, void* stream) {
  const long long stride = ((long long)num_domains + 3) / 4 * 4;
  if (segs < 1 || segs > kMaxSegs || seg < 32 || seg % 32 != 0 ||
      num_domains < 1 || blocks < 1 || (long long)segs * seg < N ||
      (!scratch && (long long)smem < 5LL * segs * stride))
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || N == 0) return (int)cudaSuccess;
  int nbits = 1;  // bits of the largest key, num_domains itself
  while (nbits < 32 && (num_domains >> nbits) != 0) ++nbits;
  const cudaStream_t s = (cudaStream_t)stream;
  if (scratch) {
    domain_rank_kernel<true><<<blocks, kThreads, 0, s>>>(
        (const int32_t*)dom, (int32_t*)rank, (int32_t*)scratch, rows, N,
        num_domains, (int)stride, segs, seg, nbits);
  } else {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          domain_rank_kernel<false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
    domain_rank_kernel<false><<<blocks, kThreads, smem, s>>>(
        (const int32_t*)dom, (int32_t*)rank, nullptr, rows, N, num_domains,
        (int)stride, segs, seg, nbits);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
