// Symphony's switch data plane (paper Alg. 1) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/switch_pipeline/kernel.py:42
// (_pipeline_kernel, pallas_call at kernel.py:129), entered through
// switch_pipeline().  The plain torch version is ../ref.py::pipeline_plain;
// the wrapper is ../kernel.py.
//
// A switch processes one packet a cycle through stateful ALUs, and the
// reference walks the batch in that order, carrying the Per-Job State Block
// (step_min, psn_rec, alpha, Cnt_total, Cnt_op).  Each field's update per
// packet is a map from a family closed under composition, so the walk is a
// parallel scan:
//
//   step_min  LAST ? step + 1 : min(s, step): a constant or s -> min(s, v)
//   psn_rec   given the step_min before the packet: a constant (window end,
//             LAST, step < step_min), r -> max(r, psn) (step == step_min)
//             or the identity
//   Cnt_total, Cnt_op
//             counts since the last window end (the op count adds
//             step > step_min).  A float32 count stops at 2^24 (2^24 + 1
//             rounds back to it), so the walk's value is float(min(n,
//             2^24)): integer counts saturated at 2^24, reset or added
//   alpha     at a window end a -> min(max(a + d, 1), alpha_max) with d in
//             {-1, 0, +1} from that window's counts; clamps with an offset
//             compose into a clamp with an offset
//
// Every composition is exact in float32: min and max are, counts are
// integers, and a composed alpha map min(max(a + D, lo), hi) meets only
// values of the form 1 + k and alpha_max - k, which are exact while
// alpha_max < 2^23; a sum that leaves [lo, hi] rounds to the same side of
// the bound it is clamped to.  So the scan equals the walk bit for bit.
//
// The design: one launch, not one a scan: a tile's packets stay in the
// block's registers from the first scan to the outputs, so each input byte
// is read once.  A block takes the next tile of SP_TILE packets
// (a global counter, so tiles start in order), stages it through shared
// memory, and each thread composes the maps of its SP_ITEMS consecutive
// packets.  Three scans follow in order, each a block scan (warp shuffles,
// then the warps' totals) and a decoupled look-back over the tiles before
// it: (a) step_min, which gives the state before every packet and so
// is_op, lt and eq; (b) psn_rec with the two counts; (c) alpha, whose maps
// need (b)'s counts at each window end.  In a look-back, one warp
// publishes the tile's aggregate map with a flag, then reads the
// predecessors' flags 32 at a time, nearest first, composing aggregates
// until it meets an inclusive state, and publishes its own.  No
// atomics touch float values; flags and values are ordered by
// __threadfence(), and values are read from L2 (__ldcg).  Last, each
// thread walks its packets once more from its entering state for the
// outputs: the state after each packet and the mark, decided against the
// state before it in the reference kernel's float order, ((k * alpha) *
// psn) / max(psn_rec, 1); exact=0 is the ASIC path: log2-domain compare
// through a 16-entry mantissa LUT, floor(log2f(x)) for the exponent and
// x / exp2f(e) for the mantissa.  Built with --fmad=false.
//
// What bounds it.  Each packet reads 20 bytes and writes 16: at 1,000,000
// packets, 36 MB, about 11 us at 3.35 TB/s.  The scan's work is a few
// dozen operations a packet, and the look-backs add a chain of flag reads
// through L2 across the ~500 tiles.  So the bound is bytes, and the kernel
// moves each byte once.

#include <cuda_runtime.h>
#include <math.h>

#define SP_THREADS 256
#define SP_ITEMS 8
#define SP_TILE (SP_THREADS * SP_ITEMS)
#define SP_WARPS (SP_THREADS / 32)
#define SP_SAT (1 << 24)   // where a float32 count stops growing

// log2(1 + i/16) rounded to float32, i = 0..15: the mantissa LUT, bit for
// bit ref.py's LOG2_LUT (a test holds the two equal).
__constant__ float LOG2_LUT[16] = {
    0x0.0p+0f, 0x1.663f70p-4f, 0x1.5c01a4p-3f, 0x1.fbc16cp-3f,
    0x1.49a784p-2f, 0x1.91bba8p-2f, 0x1.d6753ep-2f, 0x1.0c1050p-1f,
    0x1.2b8034p-1f, 0x1.49a784p-1f, 0x1.66a008p-1f, 0x1.82809ep-1f,
    0x1.9d5da0p-1f, 0x1.b74948p-1f, 0x1.d053f6p-1f, 0x1.e88c6cp-1f};

__device__ __forceinline__ float lut_log2(float x) {
  const float e = floorf(log2f(fmaxf(x, 1e-30f)));
  const float m = x / exp2f(e);
  const int idx = min(max((int)((m - 1.0f) * 16.0f), 0), 15);
  return e + LOG2_LUT[idx];
}

// ---- the map families; compose(f, g) is f, then g

// step_min: s -> c ? v : min(s, v)
struct MinMap {
  int c;
  float v;
  static __device__ __forceinline__ MinMap id() { return {0, INFINITY}; }
};
__device__ __forceinline__ MinMap compose(const MinMap& f, const MinMap& g) {
  return {f.c | g.c, g.c ? g.v : fminf(f.v, g.v)};
}
__device__ __forceinline__ float apply(const MinMap& m, float s) {
  return m.c ? m.v : fminf(s, m.v);
}

// psn_rec: r -> rc ? rv : max(r, rv); the counts: (n, no) -> reset ? (cn,
// cno) : (sat(n + cn), sat(no + cno))
struct PsnCnt {
  int rc;
  float rv;
  int reset, cn, cno;
  static __device__ __forceinline__ PsnCnt id() {
    return {0, -INFINITY, 0, 0, 0};
  }
};
struct PsnCntState {
  float r;
  int n, no;
};
__device__ __forceinline__ int sat(int n) { return min(n, SP_SAT); }
__device__ __forceinline__ PsnCnt compose(const PsnCnt& f, const PsnCnt& g) {
  return {f.rc | g.rc, g.rc ? g.rv : fmaxf(f.rv, g.rv), f.reset | g.reset,
          g.reset ? g.cn : sat(f.cn + g.cn),
          g.reset ? g.cno : sat(f.cno + g.cno)};
}
__device__ __forceinline__ PsnCntState apply(const PsnCnt& m,
                                             const PsnCntState& x) {
  return {m.rc ? m.rv : fmaxf(x.r, m.rv), m.reset ? m.cn : sat(x.n + m.cn),
          m.reset ? m.cno : sat(x.no + m.cno)};
}

// alpha: a -> min(max(a + d, lo), hi)
struct ClampMap {
  int d;
  float lo, hi;
  static __device__ __forceinline__ ClampMap id() {
    return {0, -INFINITY, INFINITY};
  }
};
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ ClampMap compose(const ClampMap& f,
                                            const ClampMap& g) {
  const float gd = (float)g.d;
  return {f.d + g.d, clampf(f.lo + gd, g.lo, g.hi),
          clampf(f.hi + gd, g.lo, g.hi)};
}
__device__ __forceinline__ float apply(const ClampMap& m, float a) {
  return clampf(a + (float)m.d, m.lo, m.hi);
}

// ---- warp shuffles and L2 reads of the maps and states
__device__ __forceinline__ MinMap shfl_up(const MinMap& m, int o) {
  return {__shfl_up_sync(0xffffffffu, m.c, o),
          __shfl_up_sync(0xffffffffu, m.v, o)};
}
__device__ __forceinline__ PsnCnt shfl_up(const PsnCnt& m, int o) {
  return {__shfl_up_sync(0xffffffffu, m.rc, o),
          __shfl_up_sync(0xffffffffu, m.rv, o),
          __shfl_up_sync(0xffffffffu, m.reset, o),
          __shfl_up_sync(0xffffffffu, m.cn, o),
          __shfl_up_sync(0xffffffffu, m.cno, o)};
}
__device__ __forceinline__ ClampMap shfl_up(const ClampMap& m, int o) {
  return {__shfl_up_sync(0xffffffffu, m.d, o),
          __shfl_up_sync(0xffffffffu, m.lo, o),
          __shfl_up_sync(0xffffffffu, m.hi, o)};
}

__device__ __forceinline__ MinMap shfl_down(const MinMap& m, int o) {
  return {__shfl_down_sync(0xffffffffu, m.c, o),
          __shfl_down_sync(0xffffffffu, m.v, o)};
}
__device__ __forceinline__ PsnCnt shfl_down(const PsnCnt& m, int o) {
  return {__shfl_down_sync(0xffffffffu, m.rc, o),
          __shfl_down_sync(0xffffffffu, m.rv, o),
          __shfl_down_sync(0xffffffffu, m.reset, o),
          __shfl_down_sync(0xffffffffu, m.cn, o),
          __shfl_down_sync(0xffffffffu, m.cno, o)};
}
__device__ __forceinline__ ClampMap shfl_down(const ClampMap& m, int o) {
  return {__shfl_down_sync(0xffffffffu, m.d, o),
          __shfl_down_sync(0xffffffffu, m.lo, o),
          __shfl_down_sync(0xffffffffu, m.hi, o)};
}

__device__ __forceinline__ float ld_l2(const float* p) { return __ldcg(p); }
__device__ __forceinline__ MinMap ld_l2(const MinMap* p) {
  return {__ldcg(&p->c), __ldcg(&p->v)};
}
__device__ __forceinline__ PsnCnt ld_l2(const PsnCnt* p) {
  return {__ldcg(&p->rc), __ldcg(&p->rv), __ldcg(&p->reset), __ldcg(&p->cn),
          __ldcg(&p->cno)};
}
__device__ __forceinline__ PsnCntState ld_l2(const PsnCntState* p) {
  return {__ldcg(&p->r), __ldcg(&p->n), __ldcg(&p->no)};
}
__device__ __forceinline__ ClampMap ld_l2(const ClampMap* p) {
  return {__ldcg(&p->d), __ldcg(&p->lo), __ldcg(&p->hi)};
}

// The exclusive prefix of each thread's map over the block's threads in
// order, and the block's total.  wtot: SP_WARPS maps of shared scratch,
// one set per call site.  Synchronises the block once.
template <class M>
__device__ __forceinline__ M block_exclusive(const M& v, M* wtot, M& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  M incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const M y = shfl_up(incl, o);
    if (lane >= o) incl = compose(y, incl);
  }
  M ex = shfl_up(incl, 1);
  if (lane == 0) ex = M::id();
  if (lane == 31) wtot[warp] = incl;
  __syncthreads();
  M pre = M::id();
  total = M::id();
#pragma unroll
  for (int w = 0; w < SP_WARPS; ++w) {
    if (w == warp) pre = total;
    total = compose(total, wtot[w]);
  }
  return compose(pre, ex);
}

// One tile's slot of a look-back: its aggregate map and its inclusive
// state (the state after its last packet).
template <class M, class S>
struct Slot {
  M agg;
  S inc;
};

#define SP_AGG 1
#define SP_INC 2

// The state entering tile `tile`, from the tiles before it; run by one
// warp, whose lane 0 returns it.  Publishes the tile's aggregate `agg`,
// then its inclusive state.  The warp reads the flags of 32 predecessors
// at once (lane k: the k-th nearest), waits until each is set, and takes
// the nearest inclusive state among them, composing the aggregates of the
// tiles after it in order (a shuffle tree: lane k composes the farther
// lanes' maps before its own); with no inclusive state in the window, it
// composes all 32 and moves 32 tiles back.
template <class M, class S>
__device__ __noinline__ S lookback(int tile, const M& agg, S init,
                                   int* flags, Slot<M, S>* slots) {
  const int lane = threadIdx.x & 31;
  volatile int* vf = flags;
  if (tile == 0) {
    if (lane == 0) {
      slots[0].inc = apply(agg, init);
      __threadfence();
      vf[0] = SP_INC;
    }
    return init;
  }
  if (lane == 0) {
    slots[tile].agg = agg;
    __threadfence();
    vf[tile] = SP_AGG;
  }
  M acc = M::id();   // the tiles after the window and before this one
  S in;
  const int first = tile - 1;
  for (int base = first;; base -= 32) {
    const int j = base - lane;
    int f = SP_INC;   // past tile 0: never the nearest inclusive
    if (j >= 0)
      while ((f = vf[j]) == 0) {
      }
    __threadfence();
    const unsigned inc = __ballot_sync(0xffffffffu, f == SP_INC);
    const int stop = inc ? __ffs(inc) - 1 : 32;
    M m = lane < stop ? ld_l2(&slots[j].agg) : M::id();
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const M far = shfl_down(m, o);
      if (lane + o < 32) m = compose(far, m);
    }
    acc = compose(m, acc);   // lane 0's m: the tiles nearer than stop
    if (inc) {
      in = apply(acc, ld_l2(&slots[base - stop].inc));
      break;
    }
  }
  if (lane == 0) {
    slots[tile].inc = apply(agg, in);
    __threadfence();
    vf[tile] = SP_INC;
  }
  return in;
}

struct SpArgs {
  const int* steps; const float* psns; const int* lasts; const int* wins;
  const float* us;
  int* marks_o; int* smin_o; float* prec_o; float* alpha_o;
  int* counter;                               // tiles taken so far
  int* flags;                                 // [3, T] look-back flags
  Slot<MinMap, float>* slot_a;                // [T]
  Slot<PsnCnt, PsnCntState>* slot_b;          // [T]
  Slot<ClampMap, float>* slot_c;              // [T]
  int P, T;
  float k, tau, n_warmup, n_sample, alpha_max;
  int exact;
};

__global__ void __launch_bounds__(SP_THREADS)
switch_pipeline_kernel(SpArgs a) {
  // the tile's inputs, then its outputs
  __shared__ __align__(16) float buf[5][SP_TILE];
  __shared__ MinMap wtot_a[SP_WARPS];
  __shared__ PsnCnt wtot_b[SP_WARPS];
  __shared__ ClampMap wtot_c[SP_WARPS];
  __shared__ int tile_s;
  __shared__ float s_in_s, a_in_s;
  __shared__ PsnCntState b_in_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) tile_s = atomicAdd(a.counter, 1);
  __syncthreads();
  const int tile = tile_s;
  const int t0 = tile * SP_TILE, n = min(SP_TILE, a.P - t0);
  int* step_b = reinterpret_cast<int*>(buf[0]);
  int* last_b = reinterpret_cast<int*>(buf[2]);
  int* win_b = reinterpret_cast<int*>(buf[3]);
  for (int j = tid; j < SP_TILE; j += SP_THREADS) {
    const bool in = j < n;   // packets past the end change nothing read
    step_b[j] = in ? a.steps[t0 + j] : 0;
    buf[1][j] = in ? a.psns[t0 + j] : 0.0f;
    last_b[j] = in ? a.lasts[t0 + j] : 0;
    win_b[j] = in ? a.wins[t0 + j] : 0;
    buf[4][j] = in ? a.us[t0 + j] : 1.0f;
  }
  __syncthreads();
  const int j0 = tid * SP_ITEMS;
  float step[SP_ITEMS], psn[SP_ITEMS], u[SP_ITEMS];
  bool last[SP_ITEMS], win[SP_ITEMS];
#pragma unroll
  for (int q = 0; q < SP_ITEMS; q += 4) {
    const int4 s4 = *reinterpret_cast<const int4*>(step_b + j0 + q);
    const float4 p4 = *reinterpret_cast<const float4*>(buf[1] + j0 + q);
    const int4 l4 = *reinterpret_cast<const int4*>(last_b + j0 + q);
    const int4 w4 = *reinterpret_cast<const int4*>(win_b + j0 + q);
    const float4 u4 = *reinterpret_cast<const float4*>(buf[4] + j0 + q);
    step[q] = (float)s4.x; step[q + 1] = (float)s4.y;
    step[q + 2] = (float)s4.z; step[q + 3] = (float)s4.w;
    psn[q] = p4.x; psn[q + 1] = p4.y; psn[q + 2] = p4.z; psn[q + 3] = p4.w;
    last[q] = l4.x > 0; last[q + 1] = l4.y > 0;
    last[q + 2] = l4.z > 0; last[q + 3] = l4.w > 0;
    win[q] = w4.x > 0; win[q + 1] = w4.y > 0;
    win[q + 2] = w4.z > 0; win[q + 3] = w4.w > 0;
    u[q] = u4.x; u[q + 1] = u4.y; u[q + 2] = u4.z; u[q + 3] = u4.w;
  }

  // ---- (a) step_min: the state before every packet
  MinMap ma = MinMap::id();
#pragma unroll
  for (int q = 0; q < SP_ITEMS; ++q)
    ma = compose(ma, last[q] ? MinMap{1, step[q] + 1.0f} : MinMap{0, step[q]});
  MinMap tot_a;
  const MinMap ex_a = block_exclusive(ma, wtot_a, tot_a);
  if (warp == 0) {
    const float v = lookback(tile, tot_a, 0.0f, a.flags, a.slot_a);
    if (lane == 0) s_in_s = v;
  }
  __syncthreads();
  float smin[SP_ITEMS + 1];   // smin[q]: before packet q; smin[q + 1]: after
  smin[0] = apply(ex_a, s_in_s);
  unsigned op = 0, lt = 0, eq = 0;
#pragma unroll
  for (int q = 0; q < SP_ITEMS; ++q) {
    const float s = smin[q];
    op |= (step[q] > s ? 1u : 0u) << q;
    lt |= (step[q] < s ? 1u : 0u) << q;
    eq |= (step[q] == s ? 1u : 0u) << q;
    smin[q + 1] = last[q] ? step[q] + 1.0f : fminf(s, step[q]);
  }

  // ---- (b) psn_rec and the counts
  PsnCnt mb = PsnCnt::id();
#pragma unroll
  for (int q = 0; q < SP_ITEMS; ++q) {
    PsnCnt e;
    if (win[q] || last[q]) {
      e.rc = 1; e.rv = 0.0f;
    } else if ((lt >> q) & 1u) {
      e.rc = 1; e.rv = psn[q];
    } else {
      e.rc = 0; e.rv = ((eq >> q) & 1u) ? psn[q] : -INFINITY;
    }
    e.reset = win[q];
    e.cn = win[q] ? 0 : 1;
    e.cno = win[q] ? 0 : (int)((op >> q) & 1u);
    mb = compose(mb, e);
  }
  PsnCnt tot_b;
  const PsnCnt ex_b = block_exclusive(mb, wtot_b, tot_b);
  if (warp == 0) {
    const PsnCntState v = lookback(tile, tot_b, PsnCntState{0.0f, 0, 0},
                                   a.flags + a.T, a.slot_b);
    if (lane == 0) b_in_s = v;
  }
  __syncthreads();
  PsnCntState sb = apply(ex_b, b_in_s);
  float prec[SP_ITEMS + 1];   // psn_rec before / after each packet
  int d[SP_ITEMS];            // alpha's step at a window end
  prec[0] = sb.r;
#pragma unroll
  for (int q = 0; q < SP_ITEMS; ++q) {
    const int n1 = sat(sb.n + 1), no1 = sat(sb.no + (int)((op >> q) & 1u));
    const float cnt = (float)n1, cnt_op = (float)no1;
    const bool have = cnt > a.n_sample;
    const bool exceed = cnt_op >= a.tau * cnt;
    d[q] = have ? (exceed ? 1 : -1) : 0;
    float r = prec[q];
    if (last[q]) r = 0.0f;
    else if ((lt >> q) & 1u) r = psn[q];
    else if ((eq >> q) & 1u) r = fmaxf(r, psn[q]);
    if (win[q]) {
      r = 0.0f;
      sb.n = 0;
      sb.no = 0;
    } else {
      sb.n = n1;
      sb.no = no1;
    }
    prec[q + 1] = r;
  }

  // ---- (c) alpha
  ClampMap mc = ClampMap::id();
#pragma unroll
  for (int q = 0; q < SP_ITEMS; ++q)
    if (win[q]) mc = compose(mc, ClampMap{d[q], 1.0f, a.alpha_max});
  ClampMap tot_c;
  const ClampMap ex_c = block_exclusive(mc, wtot_c, tot_c);
  if (warp == 0) {
    const float v = lookback(tile, tot_c, 1.0f, a.flags + 2 * a.T, a.slot_c);
    if (lane == 0) a_in_s = v;
  }
  __syncthreads();
  float alpha[SP_ITEMS + 1];
  alpha[0] = apply(ex_c, a_in_s);
#pragma unroll
  for (int q = 0; q < SP_ITEMS; ++q)
    alpha[q + 1] = win[q] ? clampf(alpha[q] + (float)d[q], 1.0f, a.alpha_max)
                          : alpha[q];

  // ---- the marks against the state before each packet, and the outputs
  int mark[SP_ITEMS];
#pragma unroll
  for (int q = 0; q < SP_ITEMS; ++q) {
    const bool outpacing = ((op >> q) & 1u) && (prec[q] > a.n_warmup);
    bool m;
    if (a.exact) {
      const float p =
          fminf(1.0f, a.k * alpha[q] * psn[q] / fmaxf(prec[q], 1.0f));
      m = outpacing && (u[q] < p);
    } else {
      const float lp = lut_log2(a.k) + lut_log2(alpha[q]) +
                       lut_log2(fmaxf(psn[q], 1.0f)) -
                       lut_log2(fmaxf(prec[q], 1.0f));
      m = outpacing && (lut_log2(fmaxf(u[q], 1e-9f)) < lp);
    }
    mark[q] = m ? 1 : 0;
  }
  // every thread has read its inputs (the look-backs' barriers came after)
#pragma unroll
  for (int q = 0; q < SP_ITEMS; q += 4) {
    *reinterpret_cast<int4*>(reinterpret_cast<int*>(buf[0]) + j0 + q) =
        make_int4(mark[q], mark[q + 1], mark[q + 2], mark[q + 3]);
    *reinterpret_cast<int4*>(reinterpret_cast<int*>(buf[1]) + j0 + q) =
        make_int4((int)smin[q + 1], (int)smin[q + 2], (int)smin[q + 3],
                  (int)smin[q + 4]);
    *reinterpret_cast<float4*>(buf[2] + j0 + q) =
        make_float4(prec[q + 1], prec[q + 2], prec[q + 3], prec[q + 4]);
    *reinterpret_cast<float4*>(buf[3] + j0 + q) =
        make_float4(alpha[q + 1], alpha[q + 2], alpha[q + 3], alpha[q + 4]);
  }
  __syncthreads();
  for (int j = tid; j < n; j += SP_THREADS) {
    a.marks_o[t0 + j] = reinterpret_cast<int*>(buf[0])[j];
    a.smin_o[t0 + j] = reinterpret_cast<int*>(buf[1])[j];
    a.prec_o[t0 + j] = buf[2][j];
    a.alpha_o[t0 + j] = buf[3][j];
  }
}

// Tiles of a batch of P packets.
__host__ __device__ inline int sp_tiles(int P) {
  return (P + SP_TILE - 1) / SP_TILE;
}

// Bytes of the workspace a call needs: the tile counter and the flags
// (zeroed by the launch), then the three look-backs' slots.
__host__ __device__ inline size_t sp_ws_head(int P) {
  return ((size_t)1 + 3 * (size_t)sp_tiles(P)) * 4;
}

extern "C" size_t switch_pipeline_ws_bytes(int P) {
  const size_t T = (size_t)sp_tiles(P);
  return (sp_ws_head(P) + 15) / 16 * 16 +
         T * (sizeof(Slot<MinMap, float>) +
              sizeof(Slot<PsnCnt, PsnCntState>) +
              sizeof(Slot<ClampMap, float>));
}

// The interface: 2 since the scan (the first port's walk took no
// workspace).
extern "C" int switch_pipeline_abi() { return 2; }

extern "C" int switch_pipeline_launch(
    const int* steps, const float* psns, const int* lasts, const int* wins,
    const float* us, int* marks_o, int* smin_o, float* prec_o,
    float* alpha_o, void* ws, int P, float k, float tau, float n_warmup,
    float n_sample, float alpha_max, int exact, void* stream) {
  if (P <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  SpArgs a;
  a.steps = steps; a.psns = psns; a.lasts = lasts; a.wins = wins; a.us = us;
  a.marks_o = marks_o; a.smin_o = smin_o; a.prec_o = prec_o;
  a.alpha_o = alpha_o;
  a.P = P;
  a.T = sp_tiles(P);
  const size_t T = (size_t)a.T;
  unsigned char* w = static_cast<unsigned char*>(ws);
  a.counter = reinterpret_cast<int*>(w);
  a.flags = a.counter + 1;
  unsigned char* slots = w + (sp_ws_head(P) + 15) / 16 * 16;
  a.slot_a = reinterpret_cast<Slot<MinMap, float>*>(slots);
  slots += T * sizeof(Slot<MinMap, float>);
  a.slot_b = reinterpret_cast<Slot<PsnCnt, PsnCntState>*>(slots);
  slots += T * sizeof(Slot<PsnCnt, PsnCntState>);
  a.slot_c = reinterpret_cast<Slot<ClampMap, float>*>(slots);
  a.k = k; a.tau = tau; a.n_warmup = n_warmup; a.n_sample = n_sample;
  a.alpha_max = alpha_max; a.exact = exact;
  cudaError_t err = cudaMemsetAsync(ws, 0, sp_ws_head(P), s);
  if (err != cudaSuccess) return (int)err;
  switch_pipeline_kernel<<<a.T, SP_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
