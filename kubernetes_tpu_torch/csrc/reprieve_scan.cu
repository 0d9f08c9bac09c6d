// K3 reprieve_scan: the reprieve pass of preemption (selectVictimsOnNode's
// second pass, generic_scheduler.go:1125-1170), for B preemptor lanes at once.
//
// Replaces the lax.scan of the JAX package's ops/preempt.py
// preempt_for_pod (lines 183-200). That scan walks ALL E existing pods in the
// lane's reprieve order (potential victims first, PDB-blocked ones before
// the rest, each group in priority-descending order), and each step reads
// and writes only the carry row of its own pod's node: `used[n]` (R int32
// slots) and `conflict[n]` (one bit). So the scan is N x B independent
// sequential walks, one per (lane, node), each over that node's pods in
// the lane's order. The caller hands them over as a CSR per lane: segment n
// of lane b is seg_e[b, seg_ptr[n] : seg_ptr[n + 1]], the node's pods in
// reprieve order (built in torch: a stable sort of the order by node, then
// bincount and cumsum). A node holds the same pods in every lane, so the
// segment starts seg_ptr [N + 1] are one row for all lanes. Pods on no node
// belong to no segment; the JAX scan visits them as no-ops.
//
// Per step, for pod e of segment (b, n):
//     is_v = vict_pot[b, e] & cand[b, n]
//     fit  = _fit(req_p[b], alloc[n] - (used + req_e[e]))   (ops/fit.py)
//     keep = is_v & fit & ~(conflict | c_e[b, e]) & ~reblock[b, e]
//     if keep: used += req_e[e]; conflict |= c_e[b, e]
//     victim[b, e] = is_v & ~keep
// The fit test is the port's _fit exactly: cpu, memory and ephemeral
// storage checked even at a zero request, a zero scalar request ignored,
// the pods slot on its own rule, the zero-request escape, int32 arithmetic
// that wraps (done in uint32 here, where wrapping is defined).
//
// Design (a first, simple one): one thread per (lane, node), the carries in
// registers (R <= 8 used words and the conflict bit); a thread whose node is
// no candidate of its lane returns at once (its victims stay 0: the wrapper
// zeroes `victim`). The gathers of a pod's request row and flags are
// scattered reads; neighbouring threads walk neighbouring nodes.
//
// Bound on an H100: bytes, counted over what the walks read. cand [B, N]
// bytes for every thread; per candidate (lane, node) its used_wo row (4R
// bytes), its conflict_wo byte, its node's alloc row (4R) and two seg_ptr
// entries; per step seg_e (4 bytes) and vict_pot (1); per potential victim
// c_e and reblock (2) and, once over all lanes, its req_e row (4R); req_p
// [B, R]; victim [B, E] written once. Pods on no node and the segments of
// non-candidate nodes are never read. Operations: about 3R + 10 per
// potential-victim step and 2 per other step. The sequential depth
// is the longest segment, at most a node's pod count (its pods cap, 110 on
// the flagship's nodes): the walk is latency-bound, not bandwidth-bound.
// Later work: a warp per node with the B lanes across it, the segment and
// the request rows staged in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxR = 8;       // resource slots carried in registers
constexpr int kPods = 3;       // api/types.py RES_PODS
constexpr int kFixed = 4;      // api/types.py NUM_FIXED_RES

__global__ void __launch_bounds__(kThreads) reprieve_scan_kernel(
    const int32_t* __restrict__ req_e, const int32_t* __restrict__ req_p,
    const int32_t* __restrict__ alloc, const int32_t* __restrict__ used_wo,
    const uint8_t* __restrict__ conflict_wo, const uint8_t* __restrict__ cand,
    const uint8_t* __restrict__ vict_pot, const uint8_t* __restrict__ c_e,
    const uint8_t* __restrict__ reblock, const int32_t* __restrict__ seg_ptr,
    const int32_t* __restrict__ seg_e, uint8_t* __restrict__ victim, int B,
    int N, int E, int R) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)B * N) return;
  if (!cand[t]) return;  // cand is [B, N]: row-major index b * N + n == t
  const int b = (int)(t / N), n = (int)(t % N);
  const int lo = seg_ptr[n], hi = seg_ptr[n + 1];
  if (lo >= hi) return;

  uint32_t used[kMaxR];
  int32_t vec[kMaxR], cap[kMaxR];
  // the zero-request escape: every slot but the pods slot requests <= 0
  bool zero_all = true;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    if (r < R) {
      used[r] = (uint32_t)used_wo[(size_t)t * R + r];
      vec[r] = req_p[(size_t)b * R + r];
      cap[r] = alloc[(size_t)n * R + r];
      if (r != kPods && vec[r] > 0) zero_all = false;
    }
  }
  bool conflict = conflict_wo[t] != 0;
  const size_t row = (size_t)b * E;
  const uint8_t* vp = vict_pot + row;
  const uint8_t* ce = c_e + row;
  const uint8_t* rb = reblock + row;
  const int32_t* seg = seg_e + row;
  uint8_t* out = victim + row;

  for (int k = lo; k < hi; ++k) {
    const int e = seg[k];
    if (!vp[e]) continue;  // not a victim: no carry change, victim stays 0
    const int32_t* q = req_e + (size_t)e * R;
    uint32_t nu[kMaxR];
    bool pods_ok = true, res_ok = true;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r < R) {
        nu[r] = used[r] + (uint32_t)q[r];
        const int32_t free_r = (int32_t)((uint32_t)cap[r] - nu[r]);
        if (r == kPods) {
          pods_ok = vec[r] <= free_r;
        } else if (!(r >= kFixed && vec[r] == 0) && vec[r] > free_r) {
          res_ok = false;
        }
      }
    }
    const bool fit = pods_ok && (zero_all || res_ok);
    const bool nc = conflict || ce[e] != 0;
    if (fit && !nc && !rb[e]) {
#pragma unroll
      for (int r = 0; r < kMaxR; ++r)
        if (r < R) used[r] = nu[r];
      conflict = nc;
    } else {
      out[e] = 1;
    }
  }
}

}  // namespace

// One thread per (lane, node), blocks of kThreads. `victim` [B, E] must be
// zeroed by the caller. Returns a cudaError_t (0 on success).
extern "C" int reprieve_scan_launch(
    const void* req_e, const void* req_p, const void* alloc,
    const void* used_wo, const void* conflict_wo, const void* cand,
    const void* vict_pot, const void* c_e, const void* reblock,
    const void* seg_ptr, const void* seg_e, void* victim, int B, int N, int E,
    int R, void* stream) {
  if (B < 0 || N < 0 || E < 0 || R < kFixed || R > kMaxR)
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)B * N;
  if (threads == 0 || E == 0) return (int)cudaSuccess;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  reprieve_scan_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)req_e, (const int32_t*)req_p, (const int32_t*)alloc,
      (const int32_t*)used_wo, (const uint8_t*)conflict_wo,
      (const uint8_t*)cand, (const uint8_t*)vict_pot, (const uint8_t*)c_e,
      (const uint8_t*)reblock, (const int32_t*)seg_ptr,
      (const int32_t*)seg_e, (uint8_t*)victim, B, N, E, R);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
