// K2 domain_rank: each node's rank within its topology domain, taking nodes
// in a class's score order.
//
// Replaces the rank-in-domain of the JAX package's ops/waves.py
// _domain_quota_pass (slot_quota, lines 165-174: a stable argsort by domain
// plus a scatter-min of the group starts). For row r and position i of
// dom[r, :] (domains already in score order, the discard bucket included),
//     rank[r, i] = #{ j < i : dom[r, j] == dom[r, i] }.
// One warp per row walks the row in score order, 32 positions at a time:
// __match_any_sync finds the lanes that share a domain, the rank is the
// domain's counter in shared memory plus the lower lanes of the same group,
// and the group's lowest lane advances the counter. No sort.
//
// Bound on an H100: bytes — the row is read once and the ranks written once
// (8 bytes per (row, node)); the walk is N/32 dependent steps per row.
// Domains outside [0, num_domains) are written as rank -1 (never produced by
// the engine: the caller maps absent domains to the discard bucket).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void domain_rank_kernel(const int32_t* __restrict__ dom,
                                   int32_t* __restrict__ rank, int N,
                                   int num_domains) {
  extern __shared__ int32_t count[];
  const int lane = threadIdx.x;
  for (int d = lane; d < num_domains; d += 32) count[d] = 0;
  __syncwarp();
  const int32_t* row = dom + (size_t)blockIdx.x * N;
  int32_t* out = rank + (size_t)blockIdx.x * N;
  const unsigned lower = (1u << lane) - 1u;
  for (int base = 0; base < N; base += 32) {
    const int i = base + lane;
    int d = i < N ? row[i] : -1;
    const bool ok = d >= 0 && d < num_domains;
    if (!ok) d = -1;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int r = ok ? count[d] + __popc(peers & lower) : -1;
    __syncwarp();
    if (i < N) out[i] = r;
    if (ok && lane == __ffs(peers) - 1) count[d] += __popc(peers);
    __syncwarp();
  }
}

}  // namespace

extern "C" int domain_rank_launch(const void* dom, void* rank, int rows, int N,
                                  int num_domains, void* stream) {
  const size_t smem = (size_t)num_domains * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        domain_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (rows > 0) {
    domain_rank_kernel<<<rows, 32, smem, (cudaStream_t)stream>>>(
        (const int32_t*)dom, (int32_t*)rank, N, num_domains);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
