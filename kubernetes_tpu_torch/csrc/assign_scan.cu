// K4 assign_scan: the sequential-assume scan in one launch — every pod of
// a queue-ordered row list through Filter → Score → selectHost → assume
// against the state every earlier pod left (scheduleOne, scheduler.go:
// 596-763, one pod at a time).
//
// Replaces, in the JAX package's ops/assign.py: assign_batch (line 124), one
// lax.scan of assign_step (line 64) over the pods in queue order. The port
// ran it as a host loop of ~711 torch ops and two readbacks per pod
// (ops/assign.py assign_scan_plain, the plain version it is held to).
//
// The function, for each row idx = rows[q], q = 0, 1, ..., in turn (a row
// whose pod is not valid places nowhere and changes nothing):
//   mask[n]  = the Filter of ops/assign.py pod_mask_row — the static lattice
//              row, inter-pod affinity (required terms with the first-pod
//              escape, own anti-affinity, existing pods' anti-affinity by
//              symmetry), hard topology spread over the class's eligible
//              domains, spec.nodeName, _fit (the pods slot, the scalar
//              rule), host ports on pair and triple words, volume conflicts
//              and per-driver limits — each part under its EngineConfig flag;
//   score[n] = score_combine_row: static + least·w + balanced·w + most·w +
//              soft inter-pod (with the WSYM symmetric weights)·w + even
//              spread (ScheduleAnyway)·w + SelectorSpread·w, left to right;
//   node     = the first n of the largest mask ? score : -inf (torch.argmax)
//              when any mask[n], else -1; node[idx] = node;
//   assume   = used[n] += req; the port and volume words OR'd in;
//              CNT[:, n] += TM[:, c]; HOLD[:, n] += has_anti[c];
//              WSYM[:, n] += WCOLS[:, c] (an f32 add, as the plain version).
//
// Exactness. Every f32 value is computed by the plain version's own
// sequence of f32 operations, each rounded once: __fadd_rn/__fmul_rn/
// __fdiv_rn throughout, and the source is built with -fmad=false
// (ops/kernels.py KERNEL_FLAGS), so no a*b + c contracts into an FMA.
// The constants the plain version multiplies by as Python floats reach the
// kernel as the f32 values torch multiplies by (zw_node, zw_zone, eps).
// The plain version's f32 sums — domain sums of WSYM, the symmetric credit
// over terms, the weighted soft-affinity counts over term slots, the even
// spread total over nodes, the zone counts — hold integer-valued terms, and
// are exact in any order while the magnitudes stay below 2^24. The kernel
// sums them exactly (integers, or integer-valued f32 under that bound) and
// sets a bit of *status where the bound or the integrality does not hold;
// the wrapper raises then, rather than return a result the plain version
// might round otherwise.
//
// Design. One block of kThreads threads walks the whole scan; thread t owns
// nodes t, t + kThreads, ... in every pass, so a node's per-step values
// (node_b, node_i, node_f, node_s: global scratch) are written and read by
// the same thread. The state planes are the wrapper's clone, in place.
// Per-term domain totals of CNT, HOLD and WSYM ([S, D+1]) and the per-term
// totals of CNT over keyed nodes are built once per launch and updated at
// each commit, so the required/anti/symmetric affinity terms and the soft
// affinity score read one total per (term, node) instead of summing a
// domain: O(S + N·|terms of the class|) a step. A topology-spread slot's
// sums count only the class's eligible nodes, so each is a per-step
// histogram of [D+1] integer bins (integer atomics: exact in any order);
// one histogram buffer serves every slot in turn, then the [2D+1] zone
// counts of SelectorSpread — in dynamic shared memory where it fits,
// else in global scratch. A step is: setup (the class's terms), the
// spread slots, pass A (the mask and the score's context values per
// node), one block reduction (the min/max/total normalisers), pass B (the
// score and the running argmax), one block reduction (the argmax), the
// commit. wgmma, TMA and clusters play no part.
//
// Bound on an H100: the walk is sequential — a step cannot start before
// the previous commit — so the kernel is latency-bound: 12 to 15 block
// barriers a step plus the per-node passes spread over the block. The
// bytes of the table's convention (each input read once, each output
// written once) are a few MB a launch, microseconds over 3.35 TB/s; the
// operations, up to a few hundred per (pod, node) the Filter or Score
// visits, under a tenth of a millisecond over 67 TOP/s for 10,000 pods
// on 5,120 nodes. The block
// reductions fold scalars field by field (warp shuffles, then per-field
// shared arrays): a struct folded through shuffles and a shared array of
// structs gave wrong normalisers on the card.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPods = 3;    // api/types.py RES_PODS
constexpr int kFixed = 4;   // api/types.py NUM_FIXED_RES
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaxScore = 100.0f;        // MAX_NODE_SCORE
constexpr long long kExact = 1LL << 24;    // integer-valued f32 sums exact below
// *status bits: why an f32 sum of the plain version might round
constexpr int kNonInteger = 1;   // a WSYM or WCOLS value not an integer
constexpr int kTermBound = 2;    // a term's |WSYM| sums may reach 2^24
constexpr int kClassBound = 4;   // the symmetric credit over a class's terms
constexpr int kSlotBound = 8;    // the weighted soft-affinity slot sums
constexpr int kEvenBound = 16;   // the even-spread total
constexpr int kZoneBound = 32;   // a SelectorSpread zone count

// node_b bits
constexpr uint8_t kMask = 1;      // the Filter passes
constexpr uint8_t kSpreadOk = 2;  // every hard spread slot passes
constexpr uint8_t kEvenKey = 4;   // the node has every soft slot's key
constexpr uint8_t kElig = 8;      // EvenPodsSpread-eligible

// The launch arguments; ops/kernels.py K4_FIELDS lists the same fields in
// the same order (a ctypes.Structure).
struct Args {
  // nodes
  const uint8_t* node_valid;   // [N]
  const int32_t* name_id;      // [N]
  const int32_t* alloc;        // [N, R]
  const int32_t* domain;       // [N, K]
  const int32_t* vol_limit;    // [N, DR]
  // tables
  const int32_t* req_vec;      // [SR, R]
  const int32_t* pair_words;   // [SPP, PWp]
  const int32_t* wild_words;   // [SPP, PWp]
  const int32_t* trip_words;   // [SPP, PWt]
  const int32_t* any_words;    // [SV, VW]
  const int32_t* rw_words;     // [SV, VW]
  const int32_t* drv_masks;    // [DR, VW]
  const int32_t* topo_key;     // [S]
  const int32_t* zone_keys;    // [2]
  // classes
  const int32_t* rid;          // [SC]
  const int32_t* portset;      // [SC]
  const int32_t* volset;       // [SC]
  const int32_t* aff_terms;    // [SC, AT]
  const int32_t* anti_terms;   // [SC, AN]
  const int32_t* paff_terms;   // [SC, PAT]
  const int32_t* paff_w;       // [SC, PAT]
  const int32_t* panti_terms;  // [SC, PAN]
  const int32_t* panti_w;      // [SC, PAN]
  const int32_t* tsc_term;     // [SC, TS]
  const int32_t* tsc_maxskew;  // [SC, TS]
  const uint8_t* tsc_hard;     // [SC, TS]
  const int32_t* ssel_terms;   // [SC, SS]
  // the cycle
  const uint8_t* smask;        // [SC, N] static Filter
  const uint8_t* node_match;   // [SC, N] spread eligibility
  const float* sscore;         // [SC, N] static Score
  const uint8_t* TM;           // [S, SC]
  const uint8_t* has_anti;     // [SC, S]
  const uint8_t* ELD;          // [SC, TS, D+1]
  const float* WCOLS;          // [S, SC]
  // the pods
  const int32_t* rows;         // [Q] pod indices in walk order
  const int32_t* cls;          // [P]
  const uint8_t* pvalid;       // [P]
  const int32_t* nnr;          // [P] spec.nodeName id, -1 none
  // the state, updated in place
  int32_t* used;               // [N, R]
  int32_t* ppa;                // [N, PWp]
  int32_t* ppw;                // [N, PWp]
  int32_t* ppt;                // [N, PWt]
  int32_t* CNT;                // [S, N]
  int32_t* HOLD;               // [S, N]
  float* WSYM;                 // [S, N]
  int32_t* vol_any;            // [N, VW]
  int32_t* vol_rw;             // [N, VW]
  // outputs: node [P] (filled with -1 by the caller), status [1] and
  // scored [1] — the (row, node) pairs the Filter passed — (zeroed)
  int32_t* node;
  int32_t* status;
  unsigned long long* scored;
  // scratch, zeroed by the caller
  double* wbound;              // [S] bound on |WSYM| sums of the term
  int32_t* dCNT;               // [S, D+1] domain totals
  int32_t* dHOLD;              // [S, D+1]
  float* dWSYM;                // [S, D+1]
  int32_t* tCNT;               // [S] total over keyed nodes
  int32_t* lc;                 // [S] the step's class terms (TM[s, c])
  int32_t* hist;               // [2D+1] when not in shared memory
  float* node_f;               // [N] raw soft inter-pod affinity
  int32_t* node_i;             // [N] raw even-spread count
  int32_t* node_s;             // [N] SelectorSpread count
  uint8_t* node_b;             // [N] kMask | kSpreadOk | kEvenKey | kElig
  int N, R, K, PWp, PWt, VW, DR, S, SC, AT, AN, PAT, PAN, TS, SS, D, P, Q;
  int hist_shared;             // the histogram in dynamic shared memory
  int f_interpod, f_spread, f_name, f_fit, f_ports, f_volrestrict,
      f_vollimits;
  float w_least, w_balanced, w_most, w_interpod, w_even, w_ssel;
  float zw_node, zw_zone;      // torch's f32 of 1 - ZONE_WEIGHTING, ZONE_WEIGHTING
  float eps;                   // torch's f32 of the 1e-9 clamp
};

__device__ __forceinline__ int32_t wadd(int32_t x, int32_t y) {
  return (int32_t)((uint32_t)x + (uint32_t)y);
}

__device__ __forceinline__ int32_t wsub(int32_t x, int32_t y) {
  return (int32_t)((uint32_t)x - (uint32_t)y);
}

// ops/interpod.py domain_of_term: node n's compact domain under term s's
// topology key, -1 without the key or on a padded node.
__device__ __forceinline__ int dom_of(const Args& a, int s, int n) {
  const int k = a.topo_key[s];
  if (k < 0 || !a.node_valid[n]) return -1;
  return a.domain[(size_t)n * a.K + k];
}

// SelectorSpread's zone bucket (ops/scores.py zdom_of): the modern zone
// label's domain, else D + the legacy one's, else -1.
__device__ __forceinline__ int zone_of(const Args& a, int n) {
  if (!a.node_valid[n]) return -1;
  const int k0 = a.zone_keys[0], k1 = a.zone_keys[1];
  const int z0 = k0 >= 0 ? a.domain[(size_t)n * a.K + k0] : -1;
  if (z0 >= 0) return z0;
  const int z1 = k1 >= 0 ? a.domain[(size_t)n * a.K + k1] : -1;
  return z1 >= 0 ? a.D + z1 : -1;
}

// ops/fit.py _fit on int32 words that wrap.
__device__ bool fits(const int32_t* req, const int32_t* alloc,
                     const int32_t* used, int R) {
  bool res_ok = true;
  int32_t top = 0;  // amax over the request with the pods slot as 0
  for (int r = 0; r < R; ++r) {
    if (r == kPods) continue;
    const int32_t v = req[r];
    top = max(top, v);
    if (!((r >= kFixed && v == 0) || v <= wsub(alloc[r], used[r])))
      res_ok = false;
  }
  const bool pods_ok = req[kPods] <= wsub(alloc[kPods], used[kPods]);
  return pods_ok && (top == 0 || res_ok);
}

// ops/fit.py least(t, cap) / most(t, cap) / _frac(t, cap), op for op.
__device__ __forceinline__ float least1(int32_t t, int32_t cap) {
  if (!(cap > 0 && t <= cap)) return 0.0f;
  const float capf = (float)cap;
  return __fdiv_rn(__fmul_rn(__fsub_rn(capf, (float)t), kMaxScore),
                   fmaxf(capf, 1.0f));
}

__device__ __forceinline__ float most1(int32_t t, int32_t cap) {
  if (!(cap > 0 && t <= cap)) return 0.0f;
  return __fdiv_rn(__fmul_rn((float)t, kMaxScore), fmaxf((float)cap, 1.0f));
}

__device__ __forceinline__ float frac1(int32_t t, int32_t cap) {
  return cap > 0 ? __fdiv_rn((float)t, fmaxf((float)cap, 1.0f)) : 0.0f;
}

// Block reductions, field by field: each warp folds its lanes with
// shuffles and its lane 0 puts the warp's value into a kWarps-entry shared
// array; after a barrier every thread folds the kWarps entries itself.
struct MinF {
  __device__ float operator()(float x, float y) const { return fminf(x, y); }
};
struct MaxF {
  __device__ float operator()(float x, float y) const { return fmaxf(x, y); }
};
struct MinI {
  __device__ int operator()(int x, int y) const { return min(x, y); }
};
struct OrI {
  __device__ int operator()(int x, int y) const { return x | y; }
};
struct SumL {
  __device__ long long operator()(long long x, long long y) const {
    return x + y;
  }
};

template <typename T, typename Op>
__device__ __forceinline__ void warp_put(T v, Op op, T* buf) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
}

template <typename T, typename Op>
__device__ __forceinline__ T gather(const T* buf, Op op) {
  T r = buf[0];
  for (int w = 1; w < kWarps; ++w) r = op(r, buf[w]);
  return r;
}

// The running argmax as torch.argmax keeps it: the larger value (NaN above
// every number), the first index among equals.
__device__ __forceinline__ void take_best(float& v, int& i, float ov,
                                          int oi) {
  const bool ovn = isnan(ov), vn = isnan(v);
  if ((ovn && !vn) || ov > v || ((ov == v || (ovn && vn)) && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
    assign_scan_kernel(const Args a) {
  extern __shared__ int32_t smem_hist[];
  int32_t* hist = a.hist_shared ? smem_hist : a.hist;
  // the reductions' per-warp values
  __shared__ float red_f[4][kWarps];
  __shared__ int red_i[3][kWarps];
  __shared__ long long red_l[2][kWarps];
  __shared__ int sh_nl, sh_status, sh_escape, sh_has_aff, sh_has_sel,
      sh_any_soft;
  __shared__ double sh_wsum;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, S = a.S, SC = a.SC, D1 = a.D + 1, R = a.R;
  unsigned long long scored = 0;  // this thread's nodes the Filter passed
  if (tid == 0) sh_status = 0;
  __syncthreads();

  // ---- once per launch: the per-term domain totals and the WSYM bound.
  // A warp per term: lanes over the nodes, then over the classes.
  for (int s = warp; s < S; s += kWarps) {
    uint32_t tot = 0;
    double wabs = 0.0;
    int bad = 0;
    for (int n = lane; n < N; n += 32) {
      const int d = dom_of(a, s, n);
      if (d < 0) continue;
      const size_t sn = (size_t)s * N + n, sd = (size_t)s * D1 + d;
      const int32_t cnt = a.CNT[sn];
      const float w = a.WSYM[sn];
      if (!(w == truncf(w))) bad = 1;  // NaN and inf fail too
      atomicAdd(&a.dCNT[sd], cnt);
      atomicAdd(&a.dHOLD[sd], a.HOLD[sn]);
      atomicAdd(&a.dWSYM[sd], w);
      tot += (uint32_t)cnt;
      wabs += fabs((double)w);
    }
    float wmax = 0.0f;
    for (int c = lane; c < SC; c += 32) {
      const float w = a.WCOLS[(size_t)s * SC + c];
      if (!(w == truncf(w))) bad = 1;
      wmax = fmaxf(wmax, fabsf(w));
    }
    for (int o = 16; o > 0; o >>= 1) {
      tot += __shfl_xor_sync(kFull, tot, o);
      wabs += __shfl_xor_sync(kFull, wabs, o);
      wmax = fmaxf(wmax, __shfl_xor_sync(kFull, wmax, o));
      bad |= __shfl_xor_sync(kFull, bad, o);
    }
    if (lane == 0) {
      // every |WSYM| sum over nodes of term s, through every commit: at
      // most the existing weights plus one column entry per row
      const double bound = wabs + (double)a.Q * (double)wmax;
      a.tCNT[s] = (int32_t)tot;
      a.wbound[s] = bound;
      if (bad) atomicOr(&sh_status, kNonInteger);
      if (bound >= (double)kExact) atomicOr(&sh_status, kTermBound);
    }
  }
  __syncthreads();

  for (int q = 0; q < a.Q; ++q) {
    const int idx = a.rows[q];
    if (!a.pvalid[idx]) continue;  // the same row for every thread
    const int c = a.cls[idx];
    const int nnr = a.nnr[idx];
    const int rid = a.rid[c], ps = a.portset[c], vs = a.volset[c];
    const int32_t* req = a.req_vec + (size_t)rid * R;

    // ---- setup: the class's scalars and its terms
    if (tid == 0) {
      sh_nl = 0;
      sh_wsum = 0.0;
      int has_aff = 0, self_all = 1;
      uint32_t total = 0;
      for (int j = 0; j < a.AT; ++j) {
        const int s = a.aff_terms[(size_t)c * a.AT + j];
        if (s < 0) continue;
        has_aff = 1;
        total += (uint32_t)a.tCNT[s];
        if (!a.TM[(size_t)s * SC + c]) self_all = 0;
      }
      sh_has_aff = has_aff;
      sh_escape = has_aff && total == 0 && self_all;
      int has_sel = 0;
      for (int j = 0; j < a.SS; ++j)
        if (a.ssel_terms[(size_t)c * a.SS + j] >= 0) has_sel = 1;
      sh_has_sel = has_sel;
      int any_soft = 0;
      for (int j = 0; j < a.TS; ++j)
        if (a.tsc_term[(size_t)c * a.TS + j] >= 0 &&
            !a.tsc_hard[(size_t)c * a.TS + j])
          any_soft = 1;
      sh_any_soft = any_soft;
    }
    __syncthreads();
    for (int s = tid; s < S; s += kThreads) {
      if (a.TM[(size_t)s * SC + c]) {
        a.lc[atomicAdd(&sh_nl, 1)] = s;
        atomicAdd(&sh_wsum, a.wbound[s]);
      }
    }
    for (int n = tid; n < N; n += kThreads) {
      a.node_b[n] = kSpreadOk | kEvenKey;
      a.node_i[n] = 0;
    }
    __syncthreads();
    const int nl = sh_nl;
    // the symmetric credit sums over the class's terms
    if (tid == 0 && sh_wsum >= (double)kExact)
      atomicOr(&sh_status, kClassBound);

    // ---- topology-spread slots: domain sums over the eligible nodes
    for (int t = 0; t < a.TS; ++t) {
      const size_t ct = (size_t)c * a.TS + t;
      const int s = a.tsc_term[ct];
      if (s < 0) continue;
      const bool hard = a.tsc_hard[ct];
      if (hard && !a.f_spread) continue;  // the filter is off
      for (int d = tid; d < D1; d += kThreads) hist[d] = 0;
      __syncthreads();
      for (int n = tid; n < N; n += kThreads) {
        if (!a.node_match[(size_t)c * N + n]) continue;
        const int d = dom_of(a, s, n);
        if (d >= 0) atomicAdd(&hist[d], a.CNT[(size_t)s * N + n]);
      }
      __syncthreads();
      int mn = INT32_MAX, any = 0;
      if (hard) {
        const uint8_t* eld = a.ELD + ct * D1;
        for (int d = tid; d < a.D; d += kThreads) {
          if (eld[d]) {
            any = 1;
            mn = min(mn, hist[d]);
          }
        }
        warp_put(mn, MinI(), red_i[0]);
        any = __syncthreads_or(any);
        mn = gather(red_i[0], MinI());
        __syncthreads();
      }
      const int32_t self = a.TM[(size_t)s * SC + c] ? 1 : 0;
      const int32_t maxskew = a.tsc_maxskew[ct];
      for (int n = tid; n < N; n += kThreads) {
        const int d = dom_of(a, s, n);
        if (hard) {
          if (any &&
              !(d >= 0 && wsub(wadd(hist[d], self), mn) <= maxskew))
            a.node_b[n] &= ~kSpreadOk;
        } else if (d >= 0) {
          a.node_i[n] = wadd(a.node_i[n], hist[d]);
        } else {
          a.node_b[n] &= ~kEvenKey;
        }
      }
      __syncthreads();  // before the next slot clears the histogram
    }
    const bool has_sel = sh_has_sel, any_soft = sh_any_soft;
    if (has_sel) {
      for (int d = tid; d < 2 * a.D + 1; d += kThreads) hist[d] = 0;
      __syncthreads();
    }

    // ---- pass A: the Filter, and the score's context values per node
    // the score context's normalisers: soft inter-pod raw min/max over
    // valid nodes, the even-spread total, minimum and absolute sum over
    // eligible nodes, SelectorSpread's per-node and per-zone maxima
    float lo = INFINITY, hi = -INFINITY, maxn = -INFINITY, maxz = 0.0f;
    long long etot = 0, eabs = 0;
    int emn = INT32_MAX, flags = 0, bad = 0;  // flags: 1 eligible, 2 zoned
    for (int n = tid; n < N; n += kThreads) {
      const bool nv = a.node_valid[n];
      const size_t cn = (size_t)c * N + n;
      bool m = a.smask[cn];
      uint8_t b = a.node_b[n];
      if (m && a.f_name && nnr >= 0 && a.name_id[n] != nnr) m = false;
      if (m && a.f_fit &&
          !(nv && fits(req, a.alloc + (size_t)n * R, a.used + (size_t)n * R,
                       R)))
        m = false;
      if (m && a.f_ports && ps >= 0) {
        bool conflict = false;
        for (int w = 0; w < a.PWp; ++w) {
          const size_t pw = (size_t)ps * a.PWp + w, nw = (size_t)n * a.PWp + w;
          if ((a.wild_words[pw] & a.ppa[nw]) | (a.pair_words[pw] & a.ppw[nw]))
            conflict = true;
        }
        for (int w = 0; w < a.PWt; ++w)
          if (a.trip_words[(size_t)ps * a.PWt + w] &
              a.ppt[(size_t)n * a.PWt + w])
            conflict = true;
        if (conflict) m = false;
      }
      if (m && vs >= 0 && (a.f_volrestrict || a.f_vollimits)) {
        const int32_t* mine_any = a.any_words + (size_t)vs * a.VW;
        const int32_t* mine_rw = a.rw_words + (size_t)vs * a.VW;
        const int32_t* va = a.vol_any + (size_t)n * a.VW;
        const int32_t* vr = a.vol_rw + (size_t)n * a.VW;
        if (a.f_volrestrict) {
          for (int w = 0; w < a.VW; ++w)
            if ((mine_any[w] & vr[w]) | (mine_rw[w] & va[w])) m = false;
        }
        if (a.f_vollimits) {
          for (int d = 0; d < a.DR; ++d) {
            int cnt = 0;
            for (int w = 0; w < a.VW; ++w)
              cnt += __popc((unsigned)((va[w] | mine_any[w]) &
                                       a.drv_masks[(size_t)d * a.VW + w]));
            const int32_t lim = a.vol_limit[(size_t)n * a.DR + d];
            if (!(lim < 0 || cnt <= lim)) m = false;
          }
        }
      }
      if (m && a.f_spread && !(b & kSpreadOk)) m = false;
      if (m && a.f_interpod) {
        if (sh_has_aff && !sh_escape) {
          for (int j = 0; j < a.AT && m; ++j) {
            const int s = a.aff_terms[(size_t)c * a.AT + j];
            if (s < 0) continue;
            const int d = dom_of(a, s, n);
            if (d < 0 || a.dCNT[(size_t)s * D1 + d] <= 0) m = false;
          }
        }
        for (int j = 0; j < a.AN && m; ++j) {
          const int s = a.anti_terms[(size_t)c * a.AN + j];
          if (s < 0) continue;
          const int d = dom_of(a, s, n);
          if (d >= 0 && a.dCNT[(size_t)s * D1 + d] > 0) m = false;
        }
        for (int j = 0; j < nl && m; ++j) {
          const int s = a.lc[j];
          const int d = dom_of(a, s, n);
          if (d >= 0 && a.dHOLD[(size_t)s * D1 + d] > 0) m = false;
        }
      }
      if (m) b |= kMask;

      // soft inter-pod affinity, raw: the weighted counts as integers (the
      // plain version's f32 products and slot sums are exact while the
      // absolute sums stay below 2^24), then the symmetric credit over the
      // class's terms
      long long sa = 0, sn = 0, aa = 0, an = 0;
      for (int j = 0; j < a.PAT; ++j) {
        const int s = a.paff_terms[(size_t)c * a.PAT + j];
        const int d = s >= 0 ? dom_of(a, s, n) : -1;
        if (d < 0) continue;
        const long long p = (long long)a.paff_w[(size_t)c * a.PAT + j] *
                            a.dCNT[(size_t)s * D1 + d];
        sa += p;
        aa += llabs(p);
      }
      for (int j = 0; j < a.PAN; ++j) {
        const int s = a.panti_terms[(size_t)c * a.PAN + j];
        const int d = s >= 0 ? dom_of(a, s, n) : -1;
        if (d < 0) continue;
        const long long p = (long long)a.panti_w[(size_t)c * a.PAN + j] *
                            a.dCNT[(size_t)s * D1 + d];
        sn += p;
        an += llabs(p);
      }
      if (aa >= kExact || an >= kExact) bad |= kSlotBound;
      float sym = 0.0f;
      for (int j = 0; j < nl; ++j) {
        const int s = a.lc[j];
        const int d = dom_of(a, s, n);
        if (d >= 0) sym = __fadd_rn(sym, a.dWSYM[(size_t)s * D1 + d]);
      }
      const float raw =
          __fadd_rn(__fadd_rn((float)sa, -(float)sn), sym);
      a.node_f[n] = raw;
      if (nv) {
        lo = fminf(lo, raw);
        hi = fmaxf(hi, raw);
      }

      // even spread: the eligible nodes' total and minimum
      if (a.node_match[cn] && nv && (b & kEvenKey)) {
        b |= kElig;
        const int32_t r = a.node_i[n];
        etot += r;
        eabs += llabs((long long)r);
        emn = min(emn, r);
        flags |= 1;
      }

      // SelectorSpread: the node's count and its zone's
      if (has_sel) {
        int32_t cnt = 0;
        for (int j = 0; j < a.SS; ++j) {
          const int s = a.ssel_terms[(size_t)c * a.SS + j];
          if (s >= 0) cnt = wadd(cnt, a.CNT[(size_t)s * N + n]);
        }
        a.node_s[n] = cnt;
        maxn = fmaxf(maxn, nv ? (float)cnt : 0.0f);
        const int z = zone_of(a, n);
        if (z >= 0) {
          atomicAdd(&hist[z], cnt);
          flags |= 2;
        }
      }
      a.node_b[n] = b;
    }
    if (has_sel) {
      __syncthreads();  // every zone count is in
      for (int d = tid; d < 2 * a.D; d += kThreads) {
        // integer-valued f32 zone sums: exact below 2^24
        if (hist[d] >= kExact || hist[d] < 0) bad |= kZoneBound;
        maxz = fmaxf(maxz, (float)hist[d]);
      }
    }
    warp_put(lo, MinF(), red_f[0]);
    warp_put(hi, MaxF(), red_f[1]);
    warp_put(maxn, MaxF(), red_f[2]);
    warp_put(maxz, MaxF(), red_f[3]);
    warp_put(etot, SumL(), red_l[0]);
    warp_put(eabs, SumL(), red_l[1]);
    warp_put(emn, MinI(), red_i[0]);
    warp_put(flags, OrI(), red_i[1]);
    warp_put(bad, OrI(), red_i[2]);
    __syncthreads();
    lo = gather(red_f[0], MinF());
    hi = gather(red_f[1], MaxF());
    maxn = gather(red_f[2], MaxF());
    maxz = gather(red_f[3], MaxF());
    etot = gather(red_l[0], SumL());
    eabs = gather(red_l[1], SumL());
    emn = gather(red_i[0], MinI());
    flags = gather(red_i[1], OrI());
    bad = gather(red_i[2], OrI());
    __syncthreads();
    // the plain version sums the eligible nodes' counts in f32: exact in
    // any order while their absolute sum over the block stays below 2^24
    if (any_soft && eabs >= kExact) bad |= kEvenBound;
    if (tid == 0 && bad) atomicOr(&sh_status, bad);

    // ---- pass B: the Score row over the Filter's nodes, and the argmax
    const float etotf = (float)etot;
    const float emnf = (flags & 1) ? (float)emn : INFINITY;
    const float edenom = __fsub_rn(etotf, isinf(emnf) ? 0.0f : emnf);
    const bool ip_norm = hi > lo;
    const float ip_span = fmaxf(__fsub_rn(hi, lo), a.eps);
    const bool have_zones = flags & 2;
    float best_v = -INFINITY;
    int best_i = INT32_MAX, any_mask = 0;
    for (int n = tid; n < N; n += kThreads) {
      const uint8_t b = a.node_b[n];
      float v = -INFINITY;
      if (b & kMask) {
        any_mask = 1;
        ++scored;
        const int32_t* al = a.alloc + (size_t)n * R;
        const int32_t* us = a.used + (size_t)n * R;
        const int32_t t0 = wadd(us[0], req[0]), t1 = wadd(us[1], req[1]);
        const float least =
            __fdiv_rn(__fadd_rn(least1(t0, al[0]), least1(t1, al[1])), 2.0f);
        const float most =
            __fdiv_rn(__fadd_rn(most1(t0, al[0]), most1(t1, al[1])), 2.0f);
        const float cf = frac1(t0, al[0]), mf = frac1(t1, al[1]);
        const float balanced =
            (cf >= 1.0f || mf >= 1.0f)
                ? 0.0f
                : __fsub_rn(kMaxScore,
                            __fmul_rn(fabsf(__fsub_rn(cf, mf)), kMaxScore));
        const float ip =
            ip_norm ? __fdiv_rn(__fmul_rn(kMaxScore,
                                          __fsub_rn(a.node_f[n], lo)),
                                ip_span)
                    : 0.0f;
        float even = 0.0f;
        if (any_soft && (b & kElig)) {
          const float rawf = (float)a.node_i[n];
          even = edenom > 0.0f
                     ? __fdiv_rn(__fmul_rn(kMaxScore, __fsub_rn(etotf, rawf)),
                                 fmaxf(edenom, a.eps))
                     : kMaxScore;
        }
        float ssel = 0.0f;
        if (has_sel && a.node_valid[n]) {
          const float cnt = (float)a.node_s[n];
          const float ns =
              maxn > 0.0f
                  ? __fdiv_rn(__fmul_rn(kMaxScore, __fsub_rn(maxn, cnt)),
                              maxn)
                  : kMaxScore;
          const int z = zone_of(a, n);
          if (have_zones && z >= 0) {
            const float zc = (float)hist[z];
            const float zs =
                maxz > 0.0f
                    ? __fdiv_rn(__fmul_rn(kMaxScore, __fsub_rn(maxz, zc)),
                                maxz)
                    : kMaxScore;
            ssel = __fadd_rn(__fmul_rn(ns, a.zw_node), __fmul_rn(a.zw_zone, zs));
          } else {
            ssel = ns;
          }
        }
        v = a.sscore[(size_t)c * N + n];
        v = __fadd_rn(v, __fmul_rn(least, a.w_least));
        v = __fadd_rn(v, __fmul_rn(balanced, a.w_balanced));
        v = __fadd_rn(v, __fmul_rn(most, a.w_most));
        v = __fadd_rn(v, __fmul_rn(ip, a.w_interpod));
        v = __fadd_rn(v, __fmul_rn(even, a.w_even));
        v = __fadd_rn(v, __fmul_rn(ssel, a.w_ssel));
      }
      take_best(best_v, best_i, v, n);
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best_v, o);
      const int oi = __shfl_xor_sync(kFull, best_i, o);
      take_best(best_v, best_i, ov, oi);
    }
    if (lane == 0) {
      red_f[0][warp] = best_v;
      red_i[0][warp] = best_i;
    }
    any_mask = __syncthreads_or(any_mask);
    for (int w = 0; w < kWarps; ++w)
      take_best(best_v, best_i, red_f[0][w], red_i[0][w]);
    __syncthreads();

    // ---- assume: commit the pod to the state
    const int n = any_mask ? best_i : -1;
    if (tid == 0) a.node[idx] = n;
    if (n >= 0) {
      for (int r = tid; r < R; r += kThreads)
        a.used[(size_t)n * R + r] = wadd(a.used[(size_t)n * R + r], req[r]);
      if (ps >= 0) {
        for (int w = tid; w < a.PWp; w += kThreads) {
          a.ppa[(size_t)n * a.PWp + w] |= a.pair_words[(size_t)ps * a.PWp + w];
          a.ppw[(size_t)n * a.PWp + w] |= a.wild_words[(size_t)ps * a.PWp + w];
        }
        for (int w = tid; w < a.PWt; w += kThreads)
          a.ppt[(size_t)n * a.PWt + w] |= a.trip_words[(size_t)ps * a.PWt + w];
      }
      if (vs >= 0) {
        for (int w = tid; w < a.VW; w += kThreads) {
          a.vol_any[(size_t)n * a.VW + w] |= a.any_words[(size_t)vs * a.VW + w];
          a.vol_rw[(size_t)n * a.VW + w] |= a.rw_words[(size_t)vs * a.VW + w];
        }
      }
      for (int s = tid; s < S; s += kThreads) {
        const int32_t tm = a.TM[(size_t)s * SC + c] ? 1 : 0;
        const int32_t ha = a.has_anti[(size_t)c * S + s] ? 1 : 0;
        const float wc = a.WCOLS[(size_t)s * SC + c];
        const size_t sn = (size_t)s * N + n;
        a.CNT[sn] = wadd(a.CNT[sn], tm);
        a.HOLD[sn] = wadd(a.HOLD[sn], ha);
        a.WSYM[sn] = __fadd_rn(a.WSYM[sn], wc);
        const int d = dom_of(a, s, n);
        if (d >= 0) {
          const size_t sd = (size_t)s * D1 + d;
          a.dCNT[sd] = wadd(a.dCNT[sd], tm);
          a.dHOLD[sd] = wadd(a.dHOLD[sd], ha);
          a.dWSYM[sd] = __fadd_rn(a.dWSYM[sd], wc);
          a.tCNT[s] = wadd(a.tCNT[s], tm);
        }
      }
    }
    __syncthreads();
  }
  for (int o = 16; o > 0; o >>= 1) scored += __shfl_xor_sync(kFull, scored, o);
  if (lane == 0 && scored) atomicAdd(a.scored, scored);
  __syncthreads();
  if (tid == 0) a.status[0] = sh_status;
}

}  // namespace

// One block walks the whole scan. `smem_bytes` of dynamic shared memory
// hold the [2D+1] histogram when a->hist_shared (ops/kernels.py
// k4_launch_config), else 0. The caller fills node with -1, zeroes status,
// scored and the scratch, and passes the state planes to update in place.
// Returns a cudaError_t (0 on success).
extern "C" int assign_scan_launch(const void* args, int smem_bytes,
                                  void* stream) {
  const Args& a = *(const Args*)args;
  if (a.N < 0 || a.S < 0 || a.SC < 0 || a.D < 0 || a.P < 0 || a.Q < 0 ||
      a.R < kFixed || a.K < 0)
    return (int)cudaErrorInvalidValue;
  if (a.hist_shared && (long long)smem_bytes < 4LL * (2LL * a.D + 1))
    return (int)cudaErrorInvalidValue;
  if (!a.hist_shared && smem_bytes != 0) return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        assign_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  assign_scan_kernel<<<1, kThreads, smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
