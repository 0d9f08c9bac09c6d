// K1 contention_scan: the wave engine's per-node contention pass.
//
// Replaces the `block` body of the JAX package's ops/waves.py assign_waves
// (lines 438-503, run by lax.scan at :515): per node, walk the classes that
// tried to admit a pod this wave in queue-rank order and keep a class's
// admission only if it still fits after every earlier class on that node:
//   * resources: exclusive running sum of requests over the ADMITTED set A
//     (before the fit test), re-checked with fit._fit's rules;
//   * host ports: exclusive running OR of the pair/wild/triple words over the
//     classes kept after resources;
//   * volumes: exclusive running OR of the any/rw words over the classes kept
//     after ports, conflict test plus per-driver popcount against the limit.
// Outputs the final keep plane and the OR of the words the kept classes
// commit. The JAX package evaluates this with associative scans over
// [B, N, W] temporaries; here it is one thread per node and a loop over
// classes, with the running state in a scratch plane in device memory laid
// out [word, node] so a warp touches 32 neighbouring words.
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

__global__ void contention_scan_kernel(
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
    int32_t* __restrict__ out_vr, uint32_t* __restrict__ scratch,
    int SC, int N, int R, int PW, int PT, int VW, int DR) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  // running state, one plane per word: [R | PW | PW | PT | VW | VW] x N
  uint32_t* cum = scratch;
  uint32_t* c_pa = cum + (size_t)R * N;
  uint32_t* c_pw = c_pa + (size_t)PW * N;
  uint32_t* c_pt = c_pw + (size_t)PW * N;
  uint32_t* c_va = c_pt + (size_t)PT * N;
  uint32_t* c_vr = c_va + (size_t)VW * N;
  const int planes = R + 2 * PW + PT + 2 * VW;
  for (int w = 0; w < planes; ++w) scratch[(size_t)w * N + n] = 0u;
  for (int w = 0; w < PW; ++w) {
    out_pa[(size_t)n * PW + w] = 0;
    out_pw[(size_t)n * PW + w] = 0;
  }
  for (int w = 0; w < PT; ++w) out_pt[(size_t)n * PT + w] = 0;
  for (int w = 0; w < VW; ++w) {
    out_va[(size_t)n * VW + w] = 0;
    out_vr[(size_t)n * VW + w] = 0;
  }

  for (int c = 0; c < SC; ++c) {
    const bool a = A[(size_t)c * N + n] != 0;
    const int32_t* rq = req + (size_t)c * R;

    // ---- resources: PodFitsResources against free minus earlier claims ----
    bool pods_ok = true, res_ok = true;
    int32_t zmax = 0;  // the pods slot counts as 0 in the all-zero test
    for (int r = 0; r < R; ++r) {
      const int32_t v = rq[r];
      const int32_t free_r = (int32_t)((uint32_t)alloc[(size_t)n * R + r] -
                                       (uint32_t)used[(size_t)n * R + r] -
                                       cum[(size_t)r * N + n]);
      if (r == kResPods) {
        pods_ok = v <= free_r;
      } else {
        zmax = v > zmax ? v : zmax;
        res_ok = res_ok && ((r >= kNumFixedRes && v == 0) || v <= free_r);
      }
    }
    const bool keep1 = a && pods_ok && (zmax == 0 || res_ok);
    if (a)
      for (int r = 0; r < R; ++r) cum[(size_t)r * N + n] += (uint32_t)rq[r];

    // ---- host ports against earlier classes kept after resources ----
    const bool hp = has_p[c] != 0;
    bool conflict = false;
    for (int w = 0; w < PW; ++w) {
      const uint32_t p = (uint32_t)pw[(size_t)c * PW + w];
      const uint32_t wd = (uint32_t)ww[(size_t)c * PW + w];
      conflict = conflict || (wd & c_pa[(size_t)w * N + n]) != 0u ||
                 (p & c_pw[(size_t)w * N + n]) != 0u;
    }
    for (int w = 0; w < PT; ++w)
      conflict = conflict ||
                 ((uint32_t)tw[(size_t)c * PT + w] & c_pt[(size_t)w * N + n]) != 0u;
    const bool keep2 = keep1 && (!hp || !conflict);
    if (keep1 && hp) {
      for (int w = 0; w < PW; ++w) {
        c_pa[(size_t)w * N + n] |= (uint32_t)pw[(size_t)c * PW + w];
        c_pw[(size_t)w * N + n] |= (uint32_t)ww[(size_t)c * PW + w];
      }
      for (int w = 0; w < PT; ++w)
        c_pt[(size_t)w * N + n] |= (uint32_t)tw[(size_t)c * PT + w];
    }

    // ---- volumes against the node plus earlier classes kept after ports ----
    const bool hv = has_v[c] != 0;
    bool vconf = false;
    for (int w = 0; w < VW; ++w) {
      const uint32_t tot_any = (uint32_t)vol_any[(size_t)n * VW + w] | c_va[(size_t)w * N + n];
      const uint32_t tot_rw = (uint32_t)vol_rw[(size_t)n * VW + w] | c_vr[(size_t)w * N + n];
      vconf = vconf || ((uint32_t)va[(size_t)c * VW + w] & tot_rw) != 0u ||
              ((uint32_t)vr[(size_t)c * VW + w] & tot_any) != 0u;
    }
    bool vlim_ok = true;
    for (int d = 0; d < DR; ++d) {
      int cnt = 0;
      for (int w = 0; w < VW; ++w) {
        const uint32_t after = (uint32_t)vol_any[(size_t)n * VW + w] |
                               c_va[(size_t)w * N + n] |
                               (uint32_t)va[(size_t)c * VW + w];
        cnt += __popc(after & (uint32_t)drv[(size_t)d * VW + w]);
      }
      const int32_t lim = vlim[(size_t)n * DR + d];
      vlim_ok = vlim_ok && (lim < 0 || cnt <= lim);
    }
    const bool keep3 = keep2 && (!hv || (!vconf && vlim_ok));
    if (keep2 && hv) {
      for (int w = 0; w < VW; ++w) {
        c_va[(size_t)w * N + n] |= (uint32_t)va[(size_t)c * VW + w];
        c_vr[(size_t)w * N + n] |= (uint32_t)vr[(size_t)c * VW + w];
      }
    }

    // ---- final keep and the words it commits ----
    keep[(size_t)c * N + n] = keep3 ? 1 : 0;
    if (keep3 && hp) {
      for (int w = 0; w < PW; ++w) {
        out_pa[(size_t)n * PW + w] |= pw[(size_t)c * PW + w];
        out_pw[(size_t)n * PW + w] |= ww[(size_t)c * PW + w];
      }
      for (int w = 0; w < PT; ++w) out_pt[(size_t)n * PT + w] |= tw[(size_t)c * PT + w];
    }
    if (keep3 && hv) {
      for (int w = 0; w < VW; ++w) {
        out_va[(size_t)n * VW + w] |= va[(size_t)c * VW + w];
        out_vr[(size_t)n * VW + w] |= vr[(size_t)c * VW + w];
      }
    }
  }
}

}  // namespace

extern "C" int contention_scan_launch(
    const void* A, const void* req, const void* has_p, const void* pw,
    const void* ww, const void* tw, const void* has_v, const void* va,
    const void* vr, const void* alloc, const void* used, const void* vol_any,
    const void* vol_rw, const void* drv, const void* vlim, void* keep,
    void* out_pa, void* out_pw, void* out_pt, void* out_va, void* out_vr,
    void* scratch, int SC, int N, int R, int PW, int PT, int VW, int DR,
    void* stream) {
  // 64-thread blocks: one thread per node, spread over as many SMs as the
  // node count allows (5,120 nodes → 80 blocks)
  const int threads = 64;
  const int blocks = (N + threads - 1) / threads;
  if (blocks > 0) {
    contention_scan_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)A, (const int32_t*)req, (const uint8_t*)has_p,
        (const int32_t*)pw, (const int32_t*)ww, (const int32_t*)tw,
        (const uint8_t*)has_v, (const int32_t*)va, (const int32_t*)vr,
        (const int32_t*)alloc, (const int32_t*)used, (const int32_t*)vol_any,
        (const int32_t*)vol_rw, (const int32_t*)drv, (const int32_t*)vlim,
        (uint8_t*)keep, (int32_t*)out_pa, (int32_t*)out_pw, (int32_t*)out_pt,
        (int32_t*)out_va, (int32_t*)out_vr, (uint32_t*)scratch, SC, N, R, PW,
        PT, VW, DR);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
