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
// sets a bit of *status where the bound or the integrality does not hold,
// each bound taken over every node of the launch; the wrapper raises then,
// rather than return a result the plain version might round otherwise.
//
// Design: the node axis over a thread-block cluster. The launch is one
// cluster of `cluster` CTAs (1, 2, 4, 8 or 16; ops/kernels.py
// k4_launch_config picks it from N). CTA r owns the nodes [r·slice,
// (r+1)·slice) and every CTA walks the same rows in lock step; a thread
// owns the same nodes in every pass, so a node's per-step values (the
// Filter bit, the even-spread count, the raw soft affinity, the
// SelectorSpread count) live in the CTA's shared memory. Once per launch
// each CTA copies its slice of the read-mostly node rows (valid, name,
// alloc, used, domains; the CNT plane and the port and volume words) into
// shared memory and builds the per-term domain totals of CNT, HOLD and
// WSYM ([S, D+1]) over all nodes (its own copy: in shared memory where it
// fits, else in its global scratch); the cluster builds one block per
// class of every scalar and list a step needs (its matched terms, the TM
// and has_anti bits, the WCOLS column, the term lists, the request, the
// port and volume words, the symmetric-credit bound) and the walk's rows,
// once, split over the CTAs into one global copy that every CTA reads after
// the prologue's cluster barrier. Which regions are in shared memory
// follows from the shapes alone (ops/kernels.py k4_launch_config offers
// the room in a fixed order; a region left out is read in place, or kept
// in the CTA's global scratch, by the same code); at the cluster size the
// wrapper picks for 5,120 nodes, the per-node values, the static rows and
// the node rows fit with room to spare. Every CTA applies every commit to
// its copy of the domain totals in the same order, so the f32 adds stay
// bitwise equal across CTAs.
//
// A step: wait for the row's class block and its slice of the static
// Filter, eligibility and Score rows (copied with cp.async during the
// previous step) and start the next row's copy; per spread slot, a partial
// histogram of the slice's eligible counts, pushed by integer DSMEM atomics
// into every CTA's histogram (one cluster barrier; exact in any order);
// pass A (the Filter and the score's context per node; SelectorSpread's
// zone counts pushed the same way); the seven normalisers folded per CTA
// and exchanged through DSMEM (one cluster barrier); pass B (the Score and
// a 64-bit argmax key: the value's bits ordered with NaN above every number
// as torch.argmax, then the complemented index) folded once across the
// cluster (one cluster barrier), each CTA's candidate carrying its
// domains; the commit, as atomics nobody waits for. Every fold is min, max, or,
// an integer sum or the key's max, so the result does not depend on the
// cluster size. Block folds go field by field through warp shuffles and
// per-field shared arrays: a struct folded through shuffles gave wrong
// normalisers on the card.
//
// Bound on an H100: the walk is sequential — a step cannot start before
// the previous commit — so the kernel is latency-bound: two cluster
// barriers a step plus one per spread slot, a few block barriers, and the
// per-node passes over a slice of N / cluster nodes. The bytes of the
// table's convention (each input read once, each output written once) are
// a few MB a launch, microseconds over 3.35 TB/s; the operations, up to a
// few hundred per (pod, node) the Filter or Score visits, under a tenth of
// a millisecond over 67 TOP/s for 10,000 pods on 5,120 nodes.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

// threads a CTA at most, the kernel's __launch_bounds__: 128 registers a
// thread and no spill (1,024 left 64, spilled, and ran 20-35% slower)
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kPods = 3;    // api/types.py RES_PODS
constexpr int kFixed = 4;   // api/types.py NUM_FIXED_RES
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaxScore = 100.0f;        // MAX_NODE_SCORE
constexpr long long kExact = 1LL << 24;    // integer-valued f32 sums exact below
// dynamic shared memory a CTA can have on an H100 (ops/kernels.py SMEM_MAX)
constexpr int kSmemMax = 227 * 1024;
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

// a class block's flags
constexpr int kHasAff = 1, kSelfAll = 2, kHasSel = 4, kAnySoft = 8,
              kWideSym = 16;

// which optional regions are in shared memory (Args::place; ops/kernels.py
// K4_PLACE lists the same bits in the same order)
constexpr int kNode = 1;   // the per-node values of a step
constexpr int kRing = 2;   // the ring of two static rows (mask, match, score)
constexpr int kRows = 4;   // node_valid, name_id, alloc, used, domain
constexpr int kHist = 8;   // the histograms
constexpr int kCnt = 16;   // the slice of CNT
constexpr int kDtot = 32;  // the domain totals
constexpr int kWords = 64; // the port and volume words, the driver limits

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
  // outputs, written by the kernel whole: node [P] (-1 where a row placed
  // nowhere or was not walked), status [1], scored [1] (the (row, node)
  // pairs the Filter passed)
  int32_t* node;
  int32_t* status;
  unsigned long long* scored;
  // scratch, each word written before it is read: one copy of the class
  // blocks and walk rows (built by the CTAs in turn), one region per CTA
  // of the rest
  int32_t* cblock;             // [SC, cbw] the class blocks
  int32_t* qinfo;              // [Q, 3] idx, class (-1 invalid), nnr
  int32_t* gdom;               // [cluster, 3, S, D+1] without kDtot
  int32_t* ghist;              // [cluster, 3, 2D+1] without kHist
  int32_t* gnode;              // [cluster, 4, slice] without kNode
  int N, R, K, PWp, PWt, VW, DR, S, SC, AT, AN, PAT, PAN, TS, SS, D, P, Q;
  int cluster, slice, threads, cbw, place;
  int f_interpod, f_spread, f_name, f_fit, f_ports, f_volrestrict,
      f_vollimits;
  float w_least, w_balanced, w_most, w_interpod, w_even, w_ssel;
  float zw_node, zw_zone;      // torch's f32 of 1 - ZONE_WEIGHTING, ZONE_WEIGHTING
  float eps;                   // torch's f32 of the 1e-9 clamp
};

// A class block: int offsets of its parts (ops/kernels.py k4_cbw).
struct CbLayout {
  int flags, nl, hard, ps, vs, lc, wcol, tm, ha, aff, anti, paff, paffw,
      panti, pantiw, tst, tsk, ssel, req, pair, wild, trip, vany, vrw, total;
};

__host__ __device__ inline CbLayout cb_layout(const Args& a) {
  CbLayout o;
  const int sw = (a.S + 31) / 32;
  int at = 0;
  o.flags = at++;
  o.nl = at++;
  o.hard = at++;
  o.ps = at++;
  o.vs = at++;
  o.lc = at; at += a.S;
  o.wcol = at; at += a.S;
  o.tm = at; at += sw;
  o.ha = at; at += sw;
  o.aff = at; at += a.AT;
  o.anti = at; at += a.AN;
  o.paff = at; at += a.PAT;
  o.paffw = at; at += a.PAT;
  o.panti = at; at += a.PAN;
  o.pantiw = at; at += a.PAN;
  o.tst = at; at += a.TS;
  o.tsk = at; at += a.TS;
  o.ssel = at; at += a.SS;
  o.req = at; at += a.R;
  o.pair = at; at += a.PWp;
  o.wild = at; at += a.PWp;
  o.trip = at; at += a.PWt;
  o.vany = at; at += a.VW;
  o.vrw = at; at += a.VW;
  o.total = at;
  return o;
}

// Block folds: per-field arrays of per-warp values (two sets, used in
// turn, so a fold needs one barrier). Exchange slots: every CTA's folded
// normalisers and argmax key, written into every CTA by DSMEM.
struct Red {
  float f[3][kMaxWarps];
  long long l[2][kMaxWarps];
  int i[2][kMaxWarps];
  unsigned long long k[kMaxWarps];
};
struct Xch {
  unsigned long long norm[7][kMaxCluster];
  unsigned long long key[kMaxCluster];
  int any[kMaxCluster];
  int status[2];               // [0] this CTA's, [1] the cluster's (rank 0)
  unsigned long long scored[2];
};

// Dynamic shared memory, byte offsets (ops/kernels.py k4_layout); an
// optional region not in Args::place is -1 and lives in global memory.
struct Layout {
  long long red, xch, xdom, cb, rbuf, rb, nb, ni, nf, ns, tk, tcnt, dk, wb,
      drv;
  long long valid, name, alloc, used, dom, hist, cnt, dtot, words, total;
};

__host__ __device__ inline long long al16(long long x) {
  return (x + 15) & ~15LL;
}

__host__ __device__ inline Layout layout(const Args& a) {
  Layout o;
  const long long L = a.slice, S = a.S, H = 2LL * a.D + 1,
                  D1 = (long long)a.D + 1;
  long long at = 0;
  auto take = [&](long long bytes) {
    const long long p = at;
    at = al16(at + bytes);
    return p;
  };
  o.rb = al16(L + 8) * 2 + 4 * L;  // one row buffer: mask, match, score
  o.red = take(2 * (long long)sizeof(Red));
  o.xch = take(sizeof(Xch));
  o.xdom = take(4LL * kMaxCluster * (a.K + 1));
  o.cb = take(2LL * 4 * a.cbw);
  o.tk = take(4 * S);
  o.tcnt = take(4 * S);
  o.dk = take(4LL * a.K);
  o.wb = take(8 * S);
  o.drv = take(4LL * a.DR * a.VW);
  o.nb = o.ni = o.nf = o.ns = o.rbuf = -1;
  if (a.place & kNode) {
    o.nb = take(L);
    o.ni = take(4 * L);
    o.nf = take(4 * L);
    o.ns = take(4 * L);
  }
  if (a.place & kRing) o.rbuf = take(2 * o.rb);
  o.valid = o.name = o.alloc = o.used = o.dom = -1;
  if (a.place & kRows) {
    o.valid = take(L);
    o.name = take(4 * L);
    o.alloc = take(4 * L * a.R);
    o.used = take(4 * L * a.R);
    o.dom = take(4 * L * a.K);
  }
  o.hist = (a.place & kHist) ? take(3 * 4 * H) : -1;
  o.cnt = (a.place & kCnt) ? take(4 * S * L) : -1;
  o.dtot = (a.place & kDtot) ? take(3 * 4 * S * D1) : -1;
  o.words = (a.place & kWords)
                ? take(4 * L * (2LL * a.PWp + a.PWt + 2LL * a.VW + a.DR))
                : -1;
  o.total = at;
  return o;
}

__device__ __forceinline__ int32_t wadd(int32_t x, int32_t y) {
  return (int32_t)((uint32_t)x + (uint32_t)y);
}

__device__ __forceinline__ int32_t wsub(int32_t x, int32_t y) {
  return (int32_t)((uint32_t)x - (uint32_t)y);
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
struct MaxU {
  __device__ unsigned long long operator()(unsigned long long x,
                                           unsigned long long y) const {
    return x > y ? x : y;
  }
};

template <typename T, typename Op>
__device__ __forceinline__ T warp_fold(T v, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <typename T, typename Op>
__device__ __forceinline__ T gather(const T* buf, int n, Op op) {
  T r = buf[0];
  for (int w = 1; w < n; ++w) r = op(r, buf[w]);
  return r;
}

__device__ __forceinline__ unsigned long long fbits(float v) {
  return (unsigned long long)__float_as_uint(v);
}
__device__ __forceinline__ float bitsf(unsigned long long u) {
  return __uint_as_float((unsigned)u);
}

// The argmax key: torch.argmax's order — the larger value, NaN above every
// number (every NaN equal), -0.0 equal to +0.0, then the first index — as
// one unsigned 64-bit number whose maximum is the winner.
__device__ __forceinline__ unsigned long long argmax_key(float v, int n) {
  unsigned u;
  if (isnan(v)) {
    u = 0xffffffffu;
  } else {
    if (v == 0.0f) v = 0.0f;
    u = __float_as_uint(v);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return ((unsigned long long)u << 32) | (0xffffffffu - (unsigned)n);
}

__global__ void __launch_bounds__(kMaxThreads)
    assign_scan_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char k4_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout o = layout(a);
  const CbLayout cbo = cb_layout(a);
  const int T = blockDim.x, nw = T >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.cluster, rank = (int)cluster.block_rank();
  const int N = a.N, S = a.S, SC = a.SC, K = a.K, R = a.R, D = a.D;
  const int D1 = D + 1, H = 2 * D + 1, L = a.slice;
  const int lo = rank * L;
  const int cnt = max(0, min(N - lo, L));  // nodes in this CTA's slice
  unsigned char* sm = k4_smem;

  Red* red = (Red*)(sm + o.red);
  Xch* xch = (Xch*)(sm + o.xch);
  // each CTA's argmax candidate: valid, then its domain under each key
  int32_t* xdom = (int32_t*)(sm + o.xdom);
  int32_t* cbring = (int32_t*)(sm + o.cb);
  // the per-node values of a step: in shared memory unless the shapes
  // leave no room (one CTA over tens of thousands of nodes)
  const bool node_sm = a.place & kNode;
  int32_t* gn = a.gnode + (size_t)rank * 4 * L;
  uint8_t* nb = node_sm ? sm + o.nb : (uint8_t*)(gn + 3 * (size_t)L);
  int32_t* ni = node_sm ? (int32_t*)(sm + o.ni) : gn;
  float* nf = node_sm ? (float*)(sm + o.nf) : (float*)(gn + L);
  int32_t* ns = node_sm ? (int32_t*)(sm + o.ns) : gn + 2 * (size_t)L;
  const bool ring_sm = a.place & kRing;
  int32_t* tk = (int32_t*)(sm + o.tk);
  int32_t* tcnt = (int32_t*)(sm + o.tcnt);
  int32_t* dk = (int32_t*)(sm + o.dk);
  double* wb = (double*)(sm + o.wb);
  int32_t* drv = (int32_t*)(sm + o.drv);

  // the slice's node rows: shared copies, or the global rows themselves
  const bool rows_sm = a.place & kRows;
  uint8_t* vrow = rows_sm ? sm + o.valid : nullptr;
  int32_t* namerow = rows_sm ? (int32_t*)(sm + o.name) : nullptr;
  int32_t* allocrow = rows_sm ? (int32_t*)(sm + o.alloc) : nullptr;
  int32_t* usedrow = rows_sm ? (int32_t*)(sm + o.used) : a.used + (size_t)lo * R;
  int32_t* domrow = rows_sm ? (int32_t*)(sm + o.dom) : nullptr;
  const uint8_t* nvalid = rows_sm ? vrow : a.node_valid + lo;
  const int32_t* nname = rows_sm ? namerow : a.name_id + lo;
  const int32_t* nalloc = rows_sm ? allocrow : a.alloc + (size_t)lo * R;
  const int32_t* ndom = rows_sm ? domrow : a.domain + (size_t)lo * K;
  // CNT over the slice: [S][slice] in shared memory, else the plane
  const bool cnt_sm = a.place & kCnt;
  int32_t* cntp = cnt_sm ? (int32_t*)(sm + o.cnt) : a.CNT + lo;
  const size_t cs = cnt_sm ? (size_t)L : (size_t)N;
  // port and volume words, the driver limits
  const bool words_sm = a.place & kWords;
  int32_t* wbase = words_sm ? (int32_t*)(sm + o.words) : nullptr;
  int32_t* ppa = words_sm ? wbase : a.ppa + (size_t)lo * a.PWp;
  int32_t* ppw = words_sm ? ppa + (size_t)L * a.PWp : a.ppw + (size_t)lo * a.PWp;
  int32_t* ppt = words_sm ? ppw + (size_t)L * a.PWp : a.ppt + (size_t)lo * a.PWt;
  int32_t* vany = words_sm ? ppt + (size_t)L * a.PWt : a.vol_any + (size_t)lo * a.VW;
  int32_t* vrw = words_sm ? vany + (size_t)L * a.VW : a.vol_rw + (size_t)lo * a.VW;
  int32_t* vlim_sm = words_sm ? vrw + (size_t)L * a.VW : nullptr;
  const int32_t* vlim = words_sm ? vlim_sm : a.vol_limit + (size_t)lo * a.DR;
  // this CTA's copy of the domain totals
  const bool dtot_sm = a.place & kDtot;
  int32_t* dtot = dtot_sm ? (int32_t*)(sm + o.dtot)
                          : a.gdom + (size_t)rank * 3 * S * D1;
  int32_t* dC = dtot;
  int32_t* dHd = dtot + (size_t)S * D1;
  float* dW = (float*)(dtot + 2 * (size_t)S * D1);
  // the histograms: two buffers the cluster sums into, used in turn, and
  // this CTA's partial
  const bool hist_sm = a.place & kHist;
  int32_t* hbase = hist_sm ? (int32_t*)(sm + o.hist)
                           : a.ghist + (size_t)rank * 3 * H;
  int32_t* part = hbase + 2 * (size_t)H;
  int32_t* cbk = a.cblock;
  int32_t* qi = a.qinfo;

  // rank r's histogram buffer p
  auto remote_hist = [&](int p, int r) -> int32_t* {
    if (hist_sm) return cluster.map_shared_rank(hbase + (size_t)p * H, r);
    return a.ghist + (size_t)r * 3 * H + (size_t)p * H;
  };
  auto hist_at = [&](const int32_t* h, int d) -> int32_t {
    return hist_sm ? h[d] : __ldcg(h + d);
  };
  // node i of the slice: its compact domain under term s's key
  auto dom_l = [&](int s, int i) -> int {
    const int k = tk[s];
    if (k < 0 || !nvalid[i]) return -1;
    return ndom[(size_t)i * K + k];
  };
  // SelectorSpread's zone bucket (ops/scores.py zdom_of): the modern zone
  // label's domain, else D + the legacy one's, else -1.
  const int zk0 = a.zone_keys[0], zk1 = a.zone_keys[1];
  auto zone_l = [&](int i) -> int {
    if (!nvalid[i]) return -1;
    const int z0 = zk0 >= 0 ? ndom[(size_t)i * K + zk0] : -1;
    if (z0 >= 0) return z0;
    const int z1 = zk1 >= 0 ? ndom[(size_t)i * K + zk1] : -1;
    return z1 >= 0 ? D + z1 : -1;
  };

  // ---- once per launch: this CTA's shared state
  for (int w = tid; w < (int)(sizeof(Xch) / 4); w += T) ((int*)xch)[w] = 0;
  for (int s = tid; s < S; s += T) {
    tk[s] = a.topo_key[s];
    tcnt[s] = 0;
  }
  for (int k = tid; k < K; k += T) dk[k] = 0;
  for (int w = tid; w < a.DR * a.VW; w += T) drv[w] = a.drv_masks[w];
  for (size_t w = tid; w < 3 * (size_t)H; w += T) hbase[w] = 0;
  for (size_t w = tid; w < 3 * (size_t)S * D1; w += T) dtot[w] = 0;
  if (rows_sm) {
    for (int i = tid; i < cnt; i += T) {
      vrow[i] = a.node_valid[lo + i];
      namerow[i] = a.name_id[lo + i];
    }
    for (size_t w = tid; w < (size_t)cnt * R; w += T) {
      allocrow[w] = a.alloc[(size_t)lo * R + w];
      usedrow[w] = a.used[(size_t)lo * R + w];
    }
    for (size_t w = tid; w < (size_t)cnt * K; w += T)
      domrow[w] = a.domain[(size_t)lo * K + w];
  }
  if (cnt_sm)
    for (size_t w = tid; w < (size_t)S * cnt; w += T) {
      const size_t s = w / cnt, i = w % cnt;
      cntp[s * L + i] = a.CNT[s * N + lo + i];
    }
  if (words_sm) {
    for (size_t w = tid; w < (size_t)cnt * a.PWp; w += T) {
      ppa[w] = a.ppa[(size_t)lo * a.PWp + w];
      ppw[w] = a.ppw[(size_t)lo * a.PWp + w];
    }
    for (size_t w = tid; w < (size_t)cnt * a.PWt; w += T)
      ppt[w] = a.ppt[(size_t)lo * a.PWt + w];
    for (size_t w = tid; w < (size_t)cnt * a.VW; w += T) {
      vany[w] = a.vol_any[(size_t)lo * a.VW + w];
      vrw[w] = a.vol_rw[(size_t)lo * a.VW + w];
    }
    for (size_t w = tid; w < (size_t)cnt * a.DR; w += T)
      vlim_sm[w] = a.vol_limit[(size_t)lo * a.DR + w];
  }
  // the walk's rows: (idx, class or -1 where the pod is not valid, nnr),
  // split over the cluster
  for (int q = rank * T + tid; q < a.Q; q += C * T) {
    const int idx = a.rows[q];
    qi[3 * q] = idx;
    qi[3 * q + 1] = a.pvalid[idx] ? a.cls[idx] : -1;
    qi[3 * q + 2] = a.nnr[idx];
  }
  if (rank == 0)
    for (int p = tid; p < a.P; p += T) a.node[p] = -1;
  __syncthreads();

  // the per-term domain totals over every node, each term's WSYM bound,
  // and each key's domain count (a warp per term: lanes over the nodes)
  int mybits = 0;  // this thread's *status bits
  for (int s = warp; s < S; s += nw) {
    const int k = tk[s];
    uint32_t tot = 0;
    double wabs = 0.0;
    int bad = 0;
    if (k >= 0) {
#pragma unroll 4
      for (int n = lane; n < N; n += 32) {
        if (!a.node_valid[n]) continue;
        const int d = a.domain[(size_t)n * K + k];
        if (d < 0) continue;
        const size_t sn = (size_t)s * N + n, sd = (size_t)s * D1 + d;
        const int32_t c = a.CNT[sn], h = a.HOLD[sn];
        const float w = a.WSYM[sn];
        if (!(w == truncf(w))) bad = 1;  // NaN and inf fail too
        if (c) atomicAdd(&dC[sd], c);
        if (h) atomicAdd(&dHd[sd], h);
        if (w != 0.0f) atomicAdd(&dW[sd], w);
        tot += (uint32_t)c;
        wabs += fabs((double)w);
      }
    }
    float wmax = 0.0f;
    for (int c = lane; c < SC; c += 32) {
      const float w = a.WCOLS[(size_t)s * SC + c];
      if (!(w == truncf(w))) bad = 1;
      wmax = fmaxf(wmax, fabsf(w));
    }
    tot = warp_fold(tot, [](uint32_t x, uint32_t y) { return x + y; });
    wabs = warp_fold(wabs, [](double x, double y) { return x + y; });
    wmax = warp_fold(wmax, MaxF());
    bad = warp_fold(bad, OrI());
    if (lane == 0) {
      // every |WSYM| sum over nodes of term s, through every commit: at
      // most the existing weights plus one column entry per row
      const double bound = wabs + (double)a.Q * (double)wmax;
      tcnt[s] = (int32_t)tot;
      wb[s] = bound;
      if (bad) mybits |= kNonInteger;
      if (bound >= (double)kExact) mybits |= kTermBound;
    }
  }
  for (int base = 0; base < N; base += T) {
    const int n = base + tid;
    const bool nv = n < N && a.node_valid[n];
    for (int k = 0; k < K; ++k) {
      const int d = nv ? a.domain[(size_t)n * K + k] : -1;
      const int m = __reduce_max_sync(kFull, d + 1);
      if (lane == 0 && m > 0) atomicMax(&dk[k], m);
    }
  }
  __syncthreads();

  // one block per class (a warp per class: lanes over the terms; the
  // classes split over the cluster)
  for (int c = rank * nw + warp; c < SC; c += C * nw) {
    int32_t* b = cbk + (size_t)c * a.cbw;
    int nl = 0;
    double wsum = 0.0;
    for (int base = 0; base < S; base += 32) {
      const int s = base + lane;
      const bool in = s < S;
      const bool tm = in && a.TM[(size_t)s * SC + c];
      const bool ha = in && a.has_anti[(size_t)c * S + s];
      const unsigned tmm = __ballot_sync(kFull, tm);
      const unsigned ham = __ballot_sync(kFull, ha);
      if (tm) b[cbo.lc + nl + __popc(tmm & ((1u << lane) - 1))] = s;
      if (in) {
        b[cbo.wcol + s] = __float_as_int(a.WCOLS[(size_t)s * SC + c]);
        if (tm) wsum += wb[s];
      }
      if (lane == 0) {
        b[cbo.tm + base / 32] = (int)tmm;
        b[cbo.ha + base / 32] = (int)ham;
      }
      nl += __popc(tmm);
    }
    // the symmetric credit's bound over the class's terms, summed in lane
    // order (a bound, exact to the last bit or not: the test is >= 2^24)
    wsum = warp_fold(wsum, [](double x, double y) { return x + y; });
    for (int j = lane; j < a.AT; j += 32)
      b[cbo.aff + j] = a.aff_terms[(size_t)c * a.AT + j];
    for (int j = lane; j < a.AN; j += 32)
      b[cbo.anti + j] = a.anti_terms[(size_t)c * a.AN + j];
    for (int j = lane; j < a.PAT; j += 32) {
      b[cbo.paff + j] = a.paff_terms[(size_t)c * a.PAT + j];
      b[cbo.paffw + j] = a.paff_w[(size_t)c * a.PAT + j];
    }
    for (int j = lane; j < a.PAN; j += 32) {
      b[cbo.panti + j] = a.panti_terms[(size_t)c * a.PAN + j];
      b[cbo.pantiw + j] = a.panti_w[(size_t)c * a.PAN + j];
    }
    for (int j = lane; j < a.TS; j += 32) {
      b[cbo.tst + j] = a.tsc_term[(size_t)c * a.TS + j];
      b[cbo.tsk + j] = a.tsc_maxskew[(size_t)c * a.TS + j];
    }
    for (int j = lane; j < a.SS; j += 32)
      b[cbo.ssel + j] = a.ssel_terms[(size_t)c * a.SS + j];
    const int rid = a.rid[c], ps = a.portset[c], vs = a.volset[c];
    for (int j = lane; j < R; j += 32)
      b[cbo.req + j] = a.req_vec[(size_t)rid * R + j];
    for (int j = lane; j < a.PWp; j += 32) {
      b[cbo.pair + j] = ps >= 0 ? a.pair_words[(size_t)ps * a.PWp + j] : 0;
      b[cbo.wild + j] = ps >= 0 ? a.wild_words[(size_t)ps * a.PWp + j] : 0;
    }
    for (int j = lane; j < a.PWt; j += 32)
      b[cbo.trip + j] = ps >= 0 ? a.trip_words[(size_t)ps * a.PWt + j] : 0;
    for (int j = lane; j < a.VW; j += 32) {
      b[cbo.vany + j] = vs >= 0 ? a.any_words[(size_t)vs * a.VW + j] : 0;
      b[cbo.vrw + j] = vs >= 0 ? a.rw_words[(size_t)vs * a.VW + j] : 0;
    }
    if (lane == 0) {
      int has_aff = 0, self_all = 1, has_sel = 0, any_soft = 0, hard = 0;
      for (int j = 0; j < a.AT; ++j) {
        const int s = a.aff_terms[(size_t)c * a.AT + j];
        if (s < 0) continue;
        has_aff = 1;
        if (!a.TM[(size_t)s * SC + c]) self_all = 0;
      }
      for (int j = 0; j < a.SS; ++j)
        if (a.ssel_terms[(size_t)c * a.SS + j] >= 0) has_sel = 1;
      for (int j = 0; j < a.TS; ++j) {
        const bool h = a.tsc_hard[(size_t)c * a.TS + j];
        if (h) hard |= 1 << j;
        if (a.tsc_term[(size_t)c * a.TS + j] >= 0 && !h) any_soft = 1;
      }
      b[cbo.flags] = (has_aff ? kHasAff : 0) | (self_all ? kSelfAll : 0) |
                     (has_sel ? kHasSel : 0) | (any_soft ? kAnySoft : 0) |
                     (wsum >= (double)kExact ? kWideSym : 0);
      b[cbo.nl] = nl;
      b[cbo.hard] = hard;
      b[cbo.ps] = ps;
      b[cbo.vs] = vs;
    }
  }
  __syncthreads();
  // every CTA's histograms are zero before any push; the class blocks and
  // walk rows are whole
  cluster.sync();

  // the copy of a row's class block and its slice of the static rows
  // into ring slot `buf` (cp.async, 4 bytes a copy; the byte rows as the
  // aligned words that cover them)
  const long long RB = al16((long long)L + 8);
  auto row_mask = [&](int buf) { return sm + o.rbuf + buf * o.rb; };
  auto row_match = [&](int buf) { return sm + o.rbuf + buf * o.rb + RB; };
  auto row_score = [&](int buf) {
    return (float*)(sm + o.rbuf + buf * o.rb + 2 * RB);
  };
  auto prefetch = [&](int c, int buf) {
    const int32_t* src = cbk + (size_t)c * a.cbw;
    int32_t* dst = cbring + (size_t)buf * a.cbw;
    for (int w = tid; w < a.cbw; w += T)
      __pipeline_memcpy_async(dst + w, src + w, 4);
    if (ring_sm && cnt > 0) {
      const uint8_t* rows2[2] = {a.smask, a.node_match};
      unsigned char* dsts[2] = {row_mask(buf), row_match(buf)};
      for (int r = 0; r < 2; ++r) {
        const uintptr_t at = (uintptr_t)(rows2[r] + (size_t)c * N + lo);
        const uintptr_t a0 = at & ~(uintptr_t)3;
        const int words = (int)((at - a0 + cnt + 3) >> 2);
        for (int w = tid; w < words; w += T)
          __pipeline_memcpy_async(dsts[r] + 4 * w,
                                  (const void*)(a0 + 4 * (uintptr_t)w), 4);
      }
      const float* sc = a.sscore + (size_t)c * N + lo;
      float* sd = row_score(buf);
      for (int i = tid; i < cnt; i += T)
        __pipeline_memcpy_async(sd + i, sc + i, 4);
    }
    __pipeline_commit();
  };
  auto byte_shift = [&](const uint8_t* base, int c) {
    return (int)((uintptr_t)(base + (size_t)c * N + lo) & 3);
  };

  unsigned long long scored = 0;  // this thread's nodes the Filter passed
  int rset = 0;                   // the Red set the next fold uses
  int huse = 0;                   // histogram uses so far (buffer huse & 1)
  int z1lo = 0, z1hi = 0, z2lo = 0, z2hi = 0;  // the last use's bins
  int pending = -1;               // the row whose copy is in flight
  auto load_q = [&](int q, int& idx, int& c, int& nnr) {
    idx = -1;
    c = -1;
    nnr = -1;
    if (q < a.Q) {
      idx = qi[3 * q];
      c = qi[3 * q + 1];
      nnr = qi[3 * q + 2];
    }
  };
  // start a histogram use: clear the other buffer's last bins, return
  // this use's buffer
  auto hist_begin = [&](int lo1, int hi1, int lo2, int hi2) {
    int32_t* other = hbase + (size_t)((huse + 1) & 1) * H;
    for (int d = z1lo + tid; d < z1hi; d += T) other[d] = 0;
    for (int d = z2lo + tid; d < z2hi; d += T) other[d] = 0;
    z1lo = lo1;
    z1hi = hi1;
    z2lo = lo2;
    z2hi = hi2;
    return huse & 1;
  };
  // push the partial's bins [lo1, hi1) and [lo2, hi2) into every CTA's
  // buffer p, clearing the partial
  auto hist_push = [&](int p, int lo1, int hi1, int lo2, int hi2) {
    for (int r = 0; r < 2; ++r) {
      const int b0 = r ? lo2 : lo1, b1 = r ? hi2 : hi1;
      for (int d = b0 + tid; d < b1; d += T) {
        const int32_t v = part[d];
        if (!v) continue;
        for (int k = 0; k < C; ++k) atomicAdd(remote_hist(p, k) + d, v);
        part[d] = 0;
      }
    }
    ++huse;
  };

  int q0i, q0c, q0n, q1i, q1c, q1n;
  load_q(0, q0i, q0c, q0n);
  load_q(1, q1i, q1c, q1n);
  if (q0c >= 0) {
    prefetch(q0c, 0);
    pending = 0;
  }
  for (int q = 0; q < a.Q; ++q) {
    int q2i, q2c, q2n;
    load_q(q + 2, q2i, q2c, q2n);
    const int idx = q0i, c = q0c, nnr = q0n;
    const int next_c = q1c;
    q0i = q1i; q0c = q1c; q0n = q1n;
    q1i = q2i; q1c = q2c; q1n = q2n;
    if (c < 0) continue;  // the same row for every thread of the cluster
    const int buf = q & 1;
    if (pending != q) prefetch(c, buf);
    __pipeline_wait_prior(0);
    __syncthreads();  // the row's copy has landed; the last commit is in
    if (next_c >= 0) {
      prefetch(next_c, buf ^ 1);
      pending = q + 1;
    }
    const int32_t* cb = cbring + (size_t)buf * a.cbw;
    const int flags = cb[cbo.flags], nl = cb[cbo.nl], hard = cb[cbo.hard];
    const int ps = cb[cbo.ps], vs = cb[cbo.vs];
    const int32_t* req = cb + cbo.req;
    const int32_t* lc = cb + cbo.lc;
    const size_t crow = (size_t)c * N + lo;
    const uint8_t* rmask =
        ring_sm ? row_mask(buf) + byte_shift(a.smask, c) : a.smask + crow;
    const uint8_t* rmatch = ring_sm
                                ? row_match(buf) + byte_shift(a.node_match, c)
                                : a.node_match + crow;
    const float* rscore = ring_sm ? row_score(buf) : a.sscore + crow;
    const bool has_aff = flags & kHasAff, has_sel = flags & kHasSel,
               any_soft = flags & kAnySoft;
    if (flags & kWideSym) mybits |= kClassBound;
    // the first-pod escape: every required term is the class's own and
    // none has a match yet
    bool escape = false;
    if (has_aff && (flags & kSelfAll)) {
      uint32_t total = 0;
      for (int j = 0; j < a.AT; ++j) {
        const int s = cb[cbo.aff + j];
        if (s >= 0) total += (uint32_t)tcnt[s];
      }
      escape = total == 0;
    }
    for (int i = tid; i < cnt; i += T) {
      nb[i] = kSpreadOk | kEvenKey;
      ni[i] = 0;
    }

    // ---- topology-spread slots: domain sums over the eligible nodes
    for (int t = 0; t < a.TS; ++t) {
      const int s = cb[cbo.tst + t];
      if (s < 0) continue;
      const bool hslot = (hard >> t) & 1;
      if (hslot && !a.f_spread) continue;  // the filter is off
      const int k = tk[s];
      const int nbins = k >= 0 ? min(dk[k], D) : 0;
      for (int i = tid; i < cnt; i += T) {
        if (!rmatch[i]) continue;
        const int d = dom_l(s, i);
        if (d < 0) continue;
        const int32_t v = cntp[(size_t)s * cs + i];
        if (v) atomicAdd(&part[d], v);
      }
      // the first eligible-domain byte of this thread, read before the
      // barrier so its latency hides behind it
      const uint8_t* eld = a.ELD + ((size_t)c * a.TS + t) * D1;
      const bool eld0 = hslot && tid < nbins && eld[tid];
      __syncthreads();  // the partial is whole
      const int p = hist_begin(0, nbins, 0, 0);
      hist_push(p, 0, nbins, 0, 0);
      cluster.sync();   // every CTA's partial is in
      const int32_t* hist = hbase + (size_t)p * H;
      int mn = INT32_MAX, any = 0;
      if (hslot) {
        for (int d = tid; d < nbins; d += T) {
          if (d == tid ? eld0 : eld[d]) {
            any = 1;
            mn = min(mn, hist_at(hist, d));
          }
        }
        Red& rd = red[rset];
        rset ^= 1;
        mn = warp_fold(mn, MinI());
        any = __any_sync(kFull, any);
        if (lane == 0) {
          rd.i[0][warp] = mn;
          rd.i[1][warp] = any;
        }
        __syncthreads();
        mn = warp_fold(lane < nw ? rd.i[0][lane] : INT32_MAX, MinI());
        any = warp_fold(lane < nw ? rd.i[1][lane] : 0, OrI());
      }
      const int32_t self = (cb[cbo.tm + (s >> 5)] >> (s & 31)) & 1;
      const int32_t maxskew = cb[cbo.tsk + t];
      for (int i = tid; i < cnt; i += T) {
        const int d = dom_l(s, i);
        if (hslot) {
          if (any && !(d >= 0 &&
                       wsub(wadd(hist_at(hist, d), self), mn) <= maxskew))
            nb[i] &= ~kSpreadOk;
        } else if (d >= 0) {
          ni[i] = wadd(ni[i], hist_at(hist, d));
        } else {
          nb[i] &= ~kEvenKey;
        }
      }
    }

    // ---- pass A: the Filter, and the score's context values per node
    // the score context's normalisers: soft inter-pod raw min/max over
    // valid nodes, the even-spread total, minimum and absolute sum over
    // eligible nodes, SelectorSpread's per-node maximum (the zone maximum
    // comes from the summed zone counts)
    float lo_f = INFINITY, hi_f = -INFINITY, maxn = -INFINITY;
    long long etot = 0, eabs = 0;
    int emn = INT32_MAX, flg = 0;  // flg: 1 eligible, 2 zoned
    for (int i = tid; i < cnt; i += T) {
      const bool nv = nvalid[i];
      bool m = rmask[i];
      uint8_t b = nb[i];
      if (m && a.f_name && nnr >= 0 && nname[i] != nnr) m = false;
      if (m && a.f_fit &&
          !(nv && fits(req, nalloc + (size_t)i * R, usedrow + (size_t)i * R,
                       R)))
        m = false;
      if (m && a.f_ports && ps >= 0) {
        bool conflict = false;
        for (int w = 0; w < a.PWp; ++w) {
          const size_t nw2 = (size_t)i * a.PWp + w;
          if ((cb[cbo.wild + w] & ppa[nw2]) | (cb[cbo.pair + w] & ppw[nw2]))
            conflict = true;
        }
        for (int w = 0; w < a.PWt; ++w)
          if (cb[cbo.trip + w] & ppt[(size_t)i * a.PWt + w]) conflict = true;
        if (conflict) m = false;
      }
      if (m && vs >= 0 && (a.f_volrestrict || a.f_vollimits)) {
        const int32_t* mine_any = cb + cbo.vany;
        const int32_t* mine_rw = cb + cbo.vrw;
        const int32_t* va = vany + (size_t)i * a.VW;
        const int32_t* vr = vrw + (size_t)i * a.VW;
        if (a.f_volrestrict) {
          for (int w = 0; w < a.VW; ++w)
            if ((mine_any[w] & vr[w]) | (mine_rw[w] & va[w])) m = false;
        }
        if (a.f_vollimits) {
          for (int d = 0; d < a.DR; ++d) {
            int cntv = 0;
            for (int w = 0; w < a.VW; ++w)
              cntv += __popc((unsigned)((va[w] | mine_any[w]) &
                                        drv[(size_t)d * a.VW + w]));
            const int32_t lim = vlim[(size_t)i * a.DR + d];
            if (!(lim < 0 || cntv <= lim)) m = false;
          }
        }
      }
      if (m && a.f_spread && !(b & kSpreadOk)) m = false;
      if (m && a.f_interpod) {
        // every term looked up (no early exit), so the loads overlap
        bool ok = true;
        if (has_aff && !escape) {
#pragma unroll 2
          for (int j = 0; j < a.AT; ++j) {
            const int s = cb[cbo.aff + j];
            if (s < 0) continue;
            const int d = dom_l(s, i);
            ok &= d >= 0 && dC[(size_t)s * D1 + d] > 0;
          }
        }
#pragma unroll 2
        for (int j = 0; j < a.AN; ++j) {
          const int s = cb[cbo.anti + j];
          if (s < 0) continue;
          const int d = dom_l(s, i);
          ok &= !(d >= 0 && dC[(size_t)s * D1 + d] > 0);
        }
#pragma unroll 4
        for (int j = 0; j < nl; ++j) {
          const int s = lc[j];
          const int d = dom_l(s, i);
          ok &= !(d >= 0 && dHd[(size_t)s * D1 + d] > 0);
        }
        m = ok;
      }
      if (m) b |= kMask;

      // soft inter-pod affinity, raw: the weighted counts as integers (the
      // plain version's f32 products and slot sums are exact while the
      // absolute sums stay below 2^24), then the symmetric credit over the
      // class's terms
      long long sa = 0, sn = 0, aa = 0, an = 0;
      for (int j = 0; j < a.PAT; ++j) {
        const int s = cb[cbo.paff + j];
        const int d = s >= 0 ? dom_l(s, i) : -1;
        if (d < 0) continue;
        const long long p = (long long)cb[cbo.paffw + j] * dC[(size_t)s * D1 + d];
        sa += p;
        aa += llabs(p);
      }
      for (int j = 0; j < a.PAN; ++j) {
        const int s = cb[cbo.panti + j];
        const int d = s >= 0 ? dom_l(s, i) : -1;
        if (d < 0) continue;
        const long long p =
            (long long)cb[cbo.pantiw + j] * dC[(size_t)s * D1 + d];
        sn += p;
        an += llabs(p);
      }
      if (aa >= kExact || an >= kExact) mybits |= kSlotBound;
      float sym = 0.0f;
      for (int j = 0; j < nl; ++j) {
        const int s = lc[j];
        const int d = dom_l(s, i);
        if (d >= 0) sym = __fadd_rn(sym, dW[(size_t)s * D1 + d]);
      }
      const float raw = __fadd_rn(__fadd_rn((float)sa, -(float)sn), sym);
      nf[i] = raw;
      if (nv) {
        lo_f = fminf(lo_f, raw);
        hi_f = fmaxf(hi_f, raw);
      }

      // even spread: the eligible nodes' total and minimum
      if (rmatch[i] && nv && (b & kEvenKey)) {
        b |= kElig;
        const int32_t r = ni[i];
        etot += r;
        eabs += llabs((long long)r);
        emn = min(emn, r);
        flg |= 1;
      }

      // SelectorSpread: the node's count and its zone's partial
      if (has_sel) {
        int32_t sc = 0;
        for (int j = 0; j < a.SS; ++j) {
          const int s = cb[cbo.ssel + j];
          if (s >= 0) sc = wadd(sc, cntp[(size_t)s * cs + i]);
        }
        ns[i] = sc;
        maxn = fmaxf(maxn, nv ? (float)sc : 0.0f);
        const int z = zone_l(i);
        if (z >= 0) {
          if (sc) atomicAdd(&part[z], sc);
          flg |= 2;
        }
      }
      nb[i] = b;
    }
    // the normalisers, folded per CTA then across the cluster
    {
      Red& rd = red[rset];
      rset ^= 1;
      const float f0 = warp_fold(lo_f, MinF()), f1 = warp_fold(hi_f, MaxF()),
                  f2 = warp_fold(maxn, MaxF());
      const long long l0 = warp_fold(etot, SumL()), l1 = warp_fold(eabs, SumL());
      const int i0 = warp_fold(emn, MinI()), i1 = warp_fold(flg, OrI());
      if (lane == 0) {
        rd.f[0][warp] = f0;
        rd.f[1][warp] = f1;
        rd.f[2][warp] = f2;
        rd.l[0][warp] = l0;
        rd.l[1][warp] = l1;
        rd.i[0][warp] = i0;
        rd.i[1][warp] = i1;
      }
      __syncthreads();  // the warps' values and the zone partial are in
      if (warp == 0) {
        // lane w folds warp w's values, then the warp folds the lanes
        const bool in = lane < nw;
        const float g0 = warp_fold(in ? rd.f[0][lane] : INFINITY, MinF());
        const float g1 = warp_fold(in ? rd.f[1][lane] : -INFINITY, MaxF());
        const float g2 = warp_fold(in ? rd.f[2][lane] : -INFINITY, MaxF());
        const long long h0 = warp_fold(in ? rd.l[0][lane] : 0LL, SumL());
        const long long h1 = warp_fold(in ? rd.l[1][lane] : 0LL, SumL());
        const int k0 = warp_fold(in ? rd.i[0][lane] : INT32_MAX, MinI());
        const int k1 = warp_fold(in ? rd.i[1][lane] : 0, OrI());
        if (lane < C) {
          Xch* dst = cluster.map_shared_rank(xch, lane);
          dst->norm[0][rank] = fbits(g0);
          dst->norm[1][rank] = fbits(g1);
          dst->norm[2][rank] = fbits(g2);
          dst->norm[3][rank] = (unsigned long long)h0;
          dst->norm[4][rank] = (unsigned long long)h1;
          dst->norm[5][rank] = (unsigned long long)(unsigned)k0;
          dst->norm[6][rank] = (unsigned long long)(unsigned)k1;
        }
      }
    }
    int zp = 0, zhi1 = 0, zlo2 = 0, zhi2 = 0;
    if (has_sel) {
      zhi1 = zk0 >= 0 ? min(dk[zk0], D) : 0;
      zlo2 = D;
      zhi2 = D + (zk1 >= 0 ? min(dk[zk1], D) : 0);
      zp = hist_begin(0, zhi1, zlo2, zhi2);
      hist_push(zp, 0, zhi1, zlo2, zhi2);
    }
    cluster.sync();  // every CTA's normalisers and zone partial are in
    {
      const bool in = lane < C;
      lo_f = warp_fold(in ? bitsf(xch->norm[0][lane]) : INFINITY, MinF());
      hi_f = warp_fold(in ? bitsf(xch->norm[1][lane]) : -INFINITY, MaxF());
      maxn = warp_fold(in ? bitsf(xch->norm[2][lane]) : -INFINITY, MaxF());
      etot = warp_fold(in ? (long long)xch->norm[3][lane] : 0LL, SumL());
      eabs = warp_fold(in ? (long long)xch->norm[4][lane] : 0LL, SumL());
      emn = warp_fold(in ? (int)(unsigned)xch->norm[5][lane] : INT32_MAX,
                      MinI());
      flg = warp_fold(in ? (int)(unsigned)xch->norm[6][lane] : 0, OrI());
    }
    // SelectorSpread's zone maximum over the cluster's zone counts
    // (integer-valued f32 zone sums: exact below 2^24)
    float maxz = 0.0f;
    const int32_t* zhist = hbase + (size_t)zp * H;
    if (has_sel) {
      int zbad = 0;
      for (int r = 0; r < 2; ++r) {
        const int b0 = r ? zlo2 : 0, b1 = r ? zhi2 : zhi1;
        for (int d = b0 + tid; d < b1; d += T) {
          const int32_t v = hist_at(zhist, d);
          if (v >= kExact || v < 0) zbad = 1;
          maxz = fmaxf(maxz, (float)v);
        }
      }
      Red& rd = red[rset];
      rset ^= 1;
      const float m = warp_fold(maxz, MaxF());
      const int zb = warp_fold(zbad, OrI());
      if (lane == 0) {
        rd.f[0][warp] = m;
        rd.i[0][warp] = zb;
      }
      __syncthreads();
      maxz = warp_fold(lane < nw ? rd.f[0][lane] : 0.0f, MaxF());
      if (warp_fold(lane < nw ? rd.i[0][lane] : 0, OrI()))
        mybits |= kZoneBound;
    }
    // the plain version sums the eligible nodes' counts in f32: exact in
    // any order while their absolute sum over every node stays below 2^24
    if (any_soft && eabs >= kExact) mybits |= kEvenBound;

    // ---- pass B: the Score row over the Filter's nodes, and the argmax
    const float etotf = (float)etot;
    const float emnf = (flg & 1) ? (float)emn : INFINITY;
    const float edenom = __fsub_rn(etotf, isinf(emnf) ? 0.0f : emnf);
    const bool ip_norm = hi_f > lo_f;
    const float ip_span = fmaxf(__fsub_rn(hi_f, lo_f), a.eps);
    const bool have_zones = flg & 2;
    unsigned long long best = 0;
    int any_mask = 0;
    for (int i = tid; i < cnt; i += T) {
      const uint8_t b = nb[i];
      float v = -INFINITY;
      if (b & kMask) {
        any_mask = 1;
        ++scored;
        const int32_t* al = nalloc + (size_t)i * R;
        const int32_t* us = usedrow + (size_t)i * R;
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
            ip_norm ? __fdiv_rn(__fmul_rn(kMaxScore, __fsub_rn(nf[i], lo_f)),
                                ip_span)
                    : 0.0f;
        float even = 0.0f;
        if (any_soft && (b & kElig)) {
          const float rawf = (float)ni[i];
          even = edenom > 0.0f
                     ? __fdiv_rn(__fmul_rn(kMaxScore, __fsub_rn(etotf, rawf)),
                                 fmaxf(edenom, a.eps))
                     : kMaxScore;
        }
        float ssel = 0.0f;
        if (has_sel && nvalid[i]) {
          const float cntf = (float)ns[i];
          const float nsv =
              maxn > 0.0f
                  ? __fdiv_rn(__fmul_rn(kMaxScore, __fsub_rn(maxn, cntf)),
                              maxn)
                  : kMaxScore;
          const int z = zone_l(i);
          if (have_zones && z >= 0) {
            const float zc = (float)hist_at(zhist, z);
            const float zs =
                maxz > 0.0f
                    ? __fdiv_rn(__fmul_rn(kMaxScore, __fsub_rn(maxz, zc)),
                                maxz)
                    : kMaxScore;
            ssel = __fadd_rn(__fmul_rn(nsv, a.zw_node), __fmul_rn(a.zw_zone, zs));
          } else {
            ssel = nsv;
          }
        }
        v = rscore[i];
        v = __fadd_rn(v, __fmul_rn(least, a.w_least));
        v = __fadd_rn(v, __fmul_rn(balanced, a.w_balanced));
        v = __fadd_rn(v, __fmul_rn(most, a.w_most));
        v = __fadd_rn(v, __fmul_rn(ip, a.w_interpod));
        v = __fadd_rn(v, __fmul_rn(even, a.w_even));
        v = __fadd_rn(v, __fmul_rn(ssel, a.w_ssel));
      }
      const unsigned long long key = argmax_key(v, lo + i);
      if (key > best) best = key;
    }
    {
      Red& rd = red[rset];
      rset ^= 1;
      const unsigned long long wk = warp_fold(best, MaxU());
      const int wa = __any_sync(kFull, any_mask);
      if (lane == 0) {
        rd.k[warp] = wk;
        rd.i[0][warp] = wa;
      }
      __syncthreads();
      if (warp == 0) {
        const bool in = lane < nw;
        const unsigned long long ck = warp_fold(in ? rd.k[lane] : 0ULL, MaxU());
        const int ca = warp_fold(in ? rd.i[0][lane] : 0, OrI());
        if (lane < C) {
          // the candidate's domains travel with its key, so the commit
          // reads none from global memory
          const int ci = (int)(0xffffffffu - (unsigned)(ck & 0xffffffffu)) - lo;
          const bool cv = ck != 0 && ci >= 0 && ci < cnt && nvalid[ci];
          Xch* dst = cluster.map_shared_rank(xch, lane);
          int32_t* dd = cluster.map_shared_rank(xdom, lane) + rank * (K + 1);
          dst->key[rank] = ck;
          dst->any[rank] = ca;
          dd[0] = cv;
          for (int k = 0; k < K; ++k)
            dd[1 + k] = cv ? ndom[(size_t)ci * K + k] : -1;
        }
      }
    }
    cluster.sync();  // every CTA's argmax is in
    best = warp_fold(lane < C ? xch->key[lane] : 0ULL, MaxU());
    any_mask = warp_fold(lane < C ? xch->any[lane] : 0, OrI());

    // ---- assume: commit the pod to the state (every CTA its copy of the
    // domain totals, the owning CTA the node's rows)
    const int n = any_mask ? (int)(0xffffffffu - (unsigned)(best & 0xffffffffu))
                           : -1;
    if (rank == 0 && tid == 0) a.node[idx] = n;
    // Every update is an atomic whose result nobody waits for (integer adds
    // wrap as wadd; an f32 atomic add rounds to nearest once, as
    // __fadd_rn, and the domain totals never hold -0.0, so a zero column
    // entry is skipped there), and the next step reads after a barrier.
    if (n >= 0) {
      const int i = n - lo;
      const bool mine = i >= 0 && i < cnt;
      const int32_t* wd = xdom + (n / L) * (K + 1);
      if (mine) {
        for (int r = tid; r < R; r += T)
          atomicAdd(&usedrow[(size_t)i * R + r], req[r]);
        if (ps >= 0) {
          for (int w = tid; w < a.PWp; w += T) {
            atomicOr(&ppa[(size_t)i * a.PWp + w], cb[cbo.pair + w]);
            atomicOr(&ppw[(size_t)i * a.PWp + w], cb[cbo.wild + w]);
          }
          for (int w = tid; w < a.PWt; w += T)
            atomicOr(&ppt[(size_t)i * a.PWt + w], cb[cbo.trip + w]);
        }
        if (vs >= 0) {
          for (int w = tid; w < a.VW; w += T) {
            atomicOr(&vany[(size_t)i * a.VW + w], cb[cbo.vany + w]);
            atomicOr(&vrw[(size_t)i * a.VW + w], cb[cbo.vrw + w]);
          }
        }
      }
      for (int s = tid; s < S; s += T) {
        const int32_t tm = (cb[cbo.tm + (s >> 5)] >> (s & 31)) & 1;
        const int32_t ha = (cb[cbo.ha + (s >> 5)] >> (s & 31)) & 1;
        const float wc = __int_as_float(cb[cbo.wcol + s]);
        if (mine) {
          const size_t sn = (size_t)s * N + n;
          if (tm) atomicAdd(&cntp[(size_t)s * cs + i], tm);
          if (ha) atomicAdd(&a.HOLD[sn], ha);
          atomicAdd(&a.WSYM[sn], wc);  // even 0: -0.0 + 0.0 is +0.0
        }
        const int k = tk[s];
        const int d = k >= 0 && wd[0] ? wd[1 + k] : -1;
        if (d >= 0) {
          const size_t sd = (size_t)s * D1 + d;
          if (tm) atomicAdd(&dC[sd], tm);
          if (ha) atomicAdd(&dHd[sd], ha);
          if (wc != 0.0f) atomicAdd(&dW[sd], wc);
          tcnt[s] = wadd(tcnt[s], tm);
        }
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // ---- the slice's state back to the planes, the status and the count
  if (rows_sm)
    for (size_t w = tid; w < (size_t)cnt * R; w += T)
      a.used[(size_t)lo * R + w] = usedrow[w];
  if (cnt_sm)
    for (size_t w = tid; w < (size_t)S * cnt; w += T) {
      const size_t s = w / cnt, i = w % cnt;
      a.CNT[s * N + lo + i] = cntp[s * L + i];
    }
  if (words_sm) {
    for (size_t w = tid; w < (size_t)cnt * a.PWp; w += T) {
      a.ppa[(size_t)lo * a.PWp + w] = ppa[w];
      a.ppw[(size_t)lo * a.PWp + w] = ppw[w];
    }
    for (size_t w = tid; w < (size_t)cnt * a.PWt; w += T)
      a.ppt[(size_t)lo * a.PWt + w] = ppt[w];
    for (size_t w = tid; w < (size_t)cnt * a.VW; w += T) {
      a.vol_any[(size_t)lo * a.VW + w] = vany[w];
      a.vol_rw[(size_t)lo * a.VW + w] = vrw[w];
    }
  }
  mybits = warp_fold(mybits, OrI());
  scored = warp_fold(scored, [](unsigned long long x, unsigned long long y) {
    return x + y;
  });
  if (lane == 0) {
    if (mybits) atomicOr(&xch->status[0], mybits);
    if (scored) atomicAdd(&xch->scored[0], scored);
  }
  __syncthreads();
  if (tid == 0) {
    Xch* root = cluster.map_shared_rank(xch, 0);
    if (xch->status[0]) atomicOr(&root->status[1], xch->status[0]);
    if (xch->scored[0]) atomicAdd(&root->scored[1], xch->scored[0]);
  }
  cluster.sync();  // no CTA leaves while another may reach its memory
  if (rank == 0 && tid == 0) {
    a.status[0] = xch->status[1];
    a.scored[0] = xch->scored[1];
  }
}

cudaLaunchConfig_t launch_config(const Args& a, int smem_bytes, void* stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, 1, 1);
  cfg.blockDim = dim3(a.threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The launch's shapes against the kernel's own layout; the function
// attributes every launch needs, set to the same constants by every caller
// (a per-function value shared by the threads that launch K4, so no launch
// may lower it under another's feet).
cudaError_t prepare(const Args& a, int smem_bytes) {
  if (a.N < 0 || a.S < 0 || a.SC < 0 || a.D < 0 || a.P < 0 || a.Q < 0 ||
      a.R < kFixed || a.K < 0 || a.TS > 31)
    return cudaErrorInvalidValue;
  const int c = a.cluster;
  if (!(c == 1 || c == 2 || c == 4 || c == 8 || c == 16))
    return cudaErrorInvalidValue;
  if (a.slice < 0 || (long long)a.slice * c < a.N || a.threads < 32 ||
      a.threads > kMaxThreads || a.threads % 32)
    return cudaErrorInvalidValue;
  if (a.cbw != cb_layout(a).total) return cudaErrorInvalidValue;
  if (layout(a).total != (long long)smem_bytes || smem_bytes > kSmemMax)
    return cudaErrorInvalidValue;
  static std::atomic<bool> set{false};
  if (set.load(std::memory_order_acquire)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      assign_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemMax);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(assign_scan_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err != cudaSuccess) return err;
  set.store(true, std::memory_order_release);
  return cudaSuccess;
}

}  // namespace

// One cluster of args->cluster CTAs of args->threads threads walks the
// whole scan, each CTA with `smem_bytes` of dynamic shared memory (the
// layout ops/kernels.py k4_layout computes; checked here against the
// kernel's own). The caller clones the state planes to update in place and
// passes per-CTA scratch; the kernel writes node, status and scored whole.
// Returns a cudaError_t (0 on success).
extern "C" int assign_scan_launch(const void* args, int smem_bytes,
                                  void* stream) {
  const Args& a = *(const Args*)args;
  cudaError_t err = prepare(a, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(a, smem_bytes, stream, attr);
  err = cudaLaunchKernelEx(&cfg, assign_scan_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many such clusters the card can hold at once
// (cudaOccupancyMaxActiveClusters): 0 means the launch cannot be
// co-scheduled. Negative: minus the cudaError_t of a failed query.
extern "C" int assign_scan_max_clusters(const void* args, int smem_bytes) {
  const Args& a = *(const Args*)args;
  cudaError_t err = prepare(a, smem_bytes);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(a, smem_bytes, nullptr, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, assign_scan_kernel, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return n;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
