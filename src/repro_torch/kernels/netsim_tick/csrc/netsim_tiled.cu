// The netsim tick tiled over the instance axis, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/netsim_tick/kernel.py:374
// (_tiled_tick_kernel, pallas_call at kernel.py:760): segsum="onehot" with
// blk, the form for fabrics whose per-lane instance axis outgrows one SM
// (the 512-host fat_tree_multipod grid: FW = 32,768 instances x 6 hops a
// lane).  The plain torch version is ../ref.py::tiled_tick_ref; the wrapper
// is ../tiled.py.
//
// The grid is (NB blocks of blk instances) x (B lanes).  The tick is a chain
// of reductions (job min-wire -> link scales -> eff -> Symphony step-min ->
// psn window), so, like the reference's (4 sweeps, NB) grid, it runs as
// sweeps over the blocks, one kernel launch each, in stream order (the
// launch boundary is the grid-wide barrier):
//
//   sweep 0  instance view and route choice; per-block job min-wire and
//            proportional link-load partials
//   sweep 1  strict-priority class; hi/lo link-load partials
//   sweep 2  link scales (every block folds the link partials), eff,
//            packets, completions; per-block Symphony cnt/cntop partials
//            and step-min candidates
//   sweep 3  step-min (every block folds the candidates); per-block psn
//            window partials
//   flush    one block per lane: queues, RED, the Symphony rows
//
// Separate launches, not one cooperative launch with grid.sync(): a
// cooperative launch needs every block of the grid resident at once, which
// holds at the main path's 16 x 8 = 128 blocks on 132 SMs but not for small
// blk or many lanes, and it would have to fail there rather than fall back.
// Five launches a tick cost a few microseconds of launch latency each.
//
// Exactness.  No float atomics.  A block's partial of a row (a link or a
// Symphony (domain, job) row) adds its entries in ascending (instance, hop)
// order from zero, walked by the one thread that owns the row; a row's total
// adds the partials in ascending block order.  Integer min/max (job
// min-wire, step-min candidates) use shared-memory atomics (exact in any
// order), and the psn window is a max.  Build with --fmad=false.  So the
// kernel equals tiled_tick_ref; against the staged tick (one ordered sum
// over all entries) the float sums reassociate, which is segsum="onehot"'s
// allclose contract.
//
// What bounds it.  One tick reads each lane's instance state and the
// chosen rows of its packed route tables once and writes iroute and eff:
// a few MB at 512 hosts x 8 lanes, microseconds at 3.35 TB/s.  The row
// walks cost far more: each block walks its blk x H entries once per pass
// of 2,048 rows (4 rows a thread), four walks a tick, each a serial loop
// of dependent shared and L1 reads.  So the kernel is latency-bound, not
// bound by bytes or operations; a per-block counting sort by row is the
// next step and is not taken here.

#include <stddef.h>

#include "netsim_hot.cuh"

#define TT_RPT 4    // rows a thread owns in one pass of a row walk
#define TT_LOG 9    // log2(NT_THREADS)
static_assert(NT_THREADS == (1 << TT_LOG), "row ownership needs 2^TT_LOG");

struct TiledArgs {
  // per-lane inputs, lane axis first
  const int* step; const float* sent; const float* rate;   // [B, FW]
  const int* done_upto;                                     // [B, F]
  const float* q_prev;                                      // [B, L1]
  const int* s_stepmin; const float* s_psnwin; const float* s_alpha;
  const float* s_cnt; const float* s_cntop;                 // [B, DJ]
  const float* cap; const float* bg_base; const float* bg_amp;  // [B, L1]
  // per-instance index arrays, shared by every lane: [FW]
  const int* inst_job; const int* inst_flow; const int* sps;
  const int* phase; const int* nph; const int* off;
  // packed per-instance tables, lane axis first
  const float* chunk;       // [B, FW, SEG]
  const int* routes; const int* route_dom;  // [B, FW, H]
  const int* cand; const int* cand_dom;     // [B, FW, P, H]
  const int* n_paths;       // [B, FW]
  const int* iscal;         // [B, 5] tick, seed, bg_period, sym_win, pq_on
  const float* fscal;       // [B, 7] bg_duty, red_kmin, red_kmax,
                            //        red_pmax, tau, n_sample, alpha_max
  // outputs
  int* iroute_o; float* eff_o;                              // [B, FW(, H)]
  float* offered_o; float* q_o; float* p_red_o;             // [B, L1]
  int* smin_o; float* spsn_o; float* salpha_o; float* scnt_o;
  float* scntop_o;                                          // [B, DJ]
  // workspaces
  int* ws_dom;              // [B, FW, H] Symphony domain of each hop
  int* ws_wire;             // [B, FW] wire step
  unsigned char* ws_flags;  // [B, FW] F_* bits
  float* ws_f;              // [B, FW] chunk size, then packets this tick
  float* p_link;            // [B, NB, 3, L1] off_p, off_hi, off_lo
  int* p_job;               // [B, NB, J] job min-wire
  float* p_symf;            // [B, NB, 3, DJ] cnt, cntop, psn window
  int* p_symi;              // [B, NB, 2, DJ] candidates, min active
  int B, F, W, H, P, L1, J, SEG, DJ, blk, NB, per_step_ecmp, policy_pq;
  float dt, mtu;
};
#define N_TILED_PTRS 45
static_assert(offsetof(TiledArgs, B) == N_TILED_PTRS * sizeof(void*),
              "TiledArgs must start with its N_TILED_PTRS pointers");

// The block's lane b, its block nb and its instances [i0, i1).
struct TileIdx {
  int b, nb, i0, i1;
  size_t bFW;
};

__device__ inline TileIdx tile_idx(const TiledArgs& a) {
  TileIdx t;
  t.b = blockIdx.y;
  t.nb = blockIdx.x;
  const int FW = a.F * a.W;
  t.i0 = t.nb * a.blk;
  t.i1 = min(t.i0 + a.blk, FW);
  t.bFW = (size_t)t.b * FW;
  return t;
}

// In a row walk, thread t owns rows base + t + k * NT_THREADS, k < TT_RPT:
// the slot k of `row`, or -1 when another thread owns it.
__device__ __forceinline__ int owned(int row, int base) {
  const unsigned d = (unsigned)(row - base);
  if (d >= (unsigned)(NT_THREADS * TT_RPT) ||
      (int)(d & (NT_THREADS - 1)) != (int)threadIdx.x)
    return -1;
  return (int)(d >> TT_LOG);
}

__device__ __forceinline__ void add_at(float (&acc)[TT_RPT], int k, float v) {
#pragma unroll
  for (int s = 0; s < TT_RPT; ++s)
    if (s == k) acc[s] += v;
}

__device__ __forceinline__ void max_at(float (&acc)[TT_RPT], int k, float v) {
#pragma unroll
  for (int s = 0; s < TT_RPT; ++s)
    if (s == k) acc[s] = fmaxf(acc[s], v);
}

__device__ __forceinline__ void zero(float (&acc)[TT_RPT]) {
#pragma unroll
  for (int s = 0; s < TT_RPT; ++s) acc[s] = 0.0f;
}

// Write a pass's owned rows to out[base + ...] (rows below R only).
__device__ __forceinline__ void store(const float (&acc)[TT_RPT], float* out,
                                      int base, int R) {
#pragma unroll
  for (int s = 0; s < TT_RPT; ++s) {
    const int r = base + threadIdx.x + s * NT_THREADS;
    if (r < R) out[r] = acc[s];
  }
}

__device__ __forceinline__ bool lane_gate(const TiledArgs& a, int b) {
  return a.policy_pq || a.iscal[b * 5 + 4] != 0;
}

// Link r of lane b: the proportional, hi and lo loads (partials folded in
// ascending block order; the first two with the background added).
__device__ inline void fold_links(const TiledArgs& a, int b, int r,
                                  float& off_p, float& off_hi,
                                  float& off_lo) {
  const int* iscal = a.iscal + b * 5;
  const float* fscal = a.fscal + b * 7;
  const int tick = iscal[0], bg_period = iscal[2];
  const bool bg_on =
      (float)floormod(tick, bg_period) < fscal[0] * (float)bg_period;
  const size_t bL = (size_t)b * a.L1;
  float sp = 0.0f, sh = 0.0f, sl = 0.0f;
  for (int nb = 0; nb < a.NB; ++nb) {
    const float* p = a.p_link + ((size_t)b * a.NB + nb) * 3 * a.L1;
    sp += p[r];
    sh += p[a.L1 + r];
    sl += p[2 * a.L1 + r];
  }
  const float bg = a.bg_base[bL + r] + (bg_on ? a.bg_amp[bL + r] : 0.0f);
  off_p = sp + bg;
  off_hi = sh + bg;
  off_lo = sl;
}

// Row r of lane b: the Symphony step-min after this tick's candidates.
__device__ inline int fold_stepmin(const TiledArgs& a, int b, int r) {
  int cand = a.s_stepmin[(size_t)b * a.DJ + r];
  int ma = NT_BIG;
  for (int nb = 0; nb < a.NB; ++nb) {
    const int* p = a.p_symi + ((size_t)b * a.NB + nb) * 2 * a.DJ;
    cand = max(cand, p[r]);
    ma = min(ma, p[a.DJ + r]);
  }
  return ma < NT_BIG ? min(cand, ma) : cand;
}

// ---- sweep 0: instance view, route choice, job min-wire and proportional
//      link-load partials
__global__ void __launch_bounds__(NT_THREADS) tiled_sweep0(TiledArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* jobmin_s = reinterpret_cast<int*>(smem);
  const TileIdx t = tile_idx(a);
  const int tid = threadIdx.x, H = a.H, J = a.J, L1 = a.L1;
  const size_t bFW = t.bFW;
  const int seed = a.iscal[t.b * 5 + 1];
  for (int j = tid; j < J; j += NT_THREADS) jobmin_s[j] = NT_BIG;
  __syncthreads();
  for (int i = t.i0 + tid; i < t.i1; i += NT_THREADS) {
    const size_t k = bFW + i;
    const int istep = a.step[k];
    const float isent = a.sent[k];
    const int job = a.inst_job[i], flow = a.inst_flow[i];
    const int sps = a.sps[i];
    const int iseg = floordiv(istep, sps) * a.nph[i] + a.phase[i];
    const int segc = min(max(iseg, 0), a.SEG - 1);
    const float ichunk = a.chunk[k * a.SEG + segc];
    const int iwire = iseg * NT_WIRE_SEG + floormod(istep, sps) + a.off[i];
    const bool occupied = istep >= 0;
    const bool retired =
        occupied && istep < a.done_upto[(size_t)t.b * a.F + flow];
    const bool complete = occupied && isent >= ichunk;
    const bool active = occupied && !complete && !retired;
    const int *row, *drow;
    if (a.per_step_ecmp) {
      uint32_t h = (uint32_t)flow * 2654435761u +
                   (uint32_t)max(istep, 0) * 40503u +
                   ((uint32_t)seed + 1u) * 2246822519u;
      h = (h ^ (h >> 13)) * 2654435761u;
      h = h ^ (h >> 16);
      const uint32_t np = (uint32_t)a.n_paths[k];
      const size_t c = (k * a.P + (int)(h % np)) * H;
      row = a.cand + c;
      drow = a.cand_dom + c;
    } else {
      row = a.routes + k * H;
      drow = a.route_dom + k * H;
    }
    for (int hh = 0; hh < H; ++hh) {
      a.iroute_o[k * H + hh] = row[hh];
      a.ws_dom[k * H + hh] = drow[hh];
    }
    if (active) atomicMin(&jobmin_s[job], iwire);
    a.ws_wire[k] = iwire;
    a.ws_f[k] = ichunk;
    a.ws_flags[k] = active ? F_ACTIVE : 0;
  }
  __syncthreads();
  const size_t pb = (size_t)t.b * a.NB + t.nb;
  for (int j = tid; j < J; j += NT_THREADS) a.p_job[pb * J + j] = jobmin_s[j];
  float* out = a.p_link + pb * 3 * L1;
  for (int base = 0; base < L1; base += NT_THREADS * TT_RPT) {
    float acc[TT_RPT];
    zero(acc);
    for (int i = t.i0; i < t.i1; ++i) {
      const size_t k = bFW + i;
      if (!(a.ws_flags[k] & F_ACTIVE)) continue;
      const float v = a.rate[k];
      const int* rt = a.iroute_o + k * H;
      for (int hh = 0; hh < H; ++hh) {
        const int s = owned(rt[hh], base);
        if (s >= 0) add_at(acc, s, v);
      }
    }
    store(acc, out, base, L1);
  }
}

// ---- sweep 1: strict-priority class, hi/lo link-load partials
__global__ void __launch_bounds__(NT_THREADS) tiled_sweep1(TiledArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* jobmin_s = reinterpret_cast<int*>(smem);
  const TileIdx t = tile_idx(a);
  const int tid = threadIdx.x, H = a.H, J = a.J, L1 = a.L1;
  const size_t bFW = t.bFW;
  for (int j = tid; j < J; j += NT_THREADS) {
    int m = NT_BIG;
    for (int nb = 0; nb < a.NB; ++nb)
      m = min(m, a.p_job[((size_t)t.b * a.NB + nb) * J + j]);
    jobmin_s[j] = m;
  }
  __syncthreads();
  for (int i = t.i0 + tid; i < t.i1; i += NT_THREADS) {
    const size_t k = bFW + i;
    if ((a.ws_flags[k] & F_ACTIVE) && a.ws_wire[k] <= jobmin_s[a.inst_job[i]])
      a.ws_flags[k] |= F_HI;
  }
  __syncthreads();
  float* out = a.p_link + ((size_t)t.b * a.NB + t.nb) * 3 * L1;
  for (int base = 0; base < L1; base += NT_THREADS * TT_RPT) {
    float hi[TT_RPT], lo[TT_RPT];
    zero(hi);
    zero(lo);
    for (int i = t.i0; i < t.i1; ++i) {
      const size_t k = bFW + i;
      const unsigned char f = a.ws_flags[k];
      if (!(f & F_ACTIVE)) continue;
      const float v = a.rate[k];
      const int* rt = a.iroute_o + k * H;
      for (int hh = 0; hh < H; ++hh) {
        const int s = owned(rt[hh], base);
        if (s < 0) continue;
        if (f & F_HI) add_at(hi, s, v); else add_at(lo, s, v);
      }
    }
    store(hi, out + L1, base, L1);
    store(lo, out + 2 * L1, base, L1);
  }
}

// ---- sweep 2: link scales, eff, packets and completions; Symphony
//      cnt/cntop partials and step-min candidates
__global__ void __launch_bounds__(NT_THREADS) tiled_sweep2(TiledArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L1 = a.L1, DJ = a.DJ, J = a.J, H = a.H;
  float* sl_s = reinterpret_cast<float*>(smem);
  float* shi_s = sl_s + L1;
  float* slo_s = shi_s + L1;
  int* smin_s = reinterpret_cast<int*>(slo_s + L1);
  int* cand_s = smin_s + DJ;
  int* minact_s = cand_s + DJ;
  const TileIdx t = tile_idx(a);
  const int tid = threadIdx.x;
  const size_t bFW = t.bFW, bL = (size_t)t.b * L1;
  for (int r = tid; r < L1; r += NT_THREADS) {
    float off_p, off_hi, off_lo;
    fold_links(a, t.b, r, off_p, off_hi, off_lo);
    const float c = a.cap[bL + r];
    sl_s[r] = fminf(1.0f, c / fmaxf(off_p, 1.0f));
    const float s_hi = fminf(1.0f, c / fmaxf(off_hi, 1.0f));
    shi_s[r] = s_hi;
    slo_s[r] = fmaxf(c - off_hi * s_hi, 0.0f) / fmaxf(off_lo, 1.0f);
  }
  for (int r = tid; r < DJ; r += NT_THREADS) {
    smin_s[r] = a.s_stepmin[(size_t)t.b * DJ + r];
    cand_s[r] = 0;
    minact_s[r] = NT_BIG;
  }
  __syncthreads();
  const bool gate = lane_gate(a, t.b);
  const float dt = a.dt, mtu = a.mtu;
  for (int i = t.i0 + tid; i < t.i1; i += NT_THREADS) {
    const size_t k = bFW + i;
    unsigned char f = a.ws_flags[k];
    const bool active = f & F_ACTIVE;
    const bool is_hi = f & F_HI;
    const float w_rate = active ? a.rate[k] : 0.0f;
    const int* rt = a.iroute_o + k * H;
    float mp = 0.0f, mq = 0.0f;
    for (int hh = 0; hh < H; ++hh) {
      const int l = rt[hh];
      const float vp = sl_s[l];
      const float vq = is_hi ? shi_s[l] : fminf(1.0f, slo_s[l]);
      mp = hh == 0 ? vp : fminf(mp, vp);
      mq = hh == 0 ? vq : fminf(mq, vq);
    }
    const float eff = gate ? w_rate * mq : w_rate * mp;
    a.eff_o[k] = eff;
    const float pkts = eff * dt / mtu;
    const bool done = active && (a.sent[k] + eff * dt >= a.ws_f[k]);
    const bool send = active && (eff > 1.0f);
    f |= (done ? F_DONE : 0) | (send ? F_SEND : 0);
    a.ws_flags[k] = f;
    a.ws_f[k] = pkts;
    if (!active) continue;
    const int iwire = a.ws_wire[k];
    const int job = a.inst_job[i];
    for (int hh = 0; hh < H; ++hh) {
      const int dj = a.ws_dom[k * H + hh] * J + job;
      if (done) atomicMax(&cand_s[dj], iwire + 1);
      else atomicMin(&minact_s[dj], iwire);
    }
  }
  __syncthreads();
  const size_t pb = (size_t)t.b * a.NB + t.nb;
  int* pi = a.p_symi + pb * 2 * DJ;
  for (int r = tid; r < DJ; r += NT_THREADS) {
    pi[r] = cand_s[r];
    pi[DJ + r] = minact_s[r];
  }
  float* out = a.p_symf + pb * 3 * DJ;
  for (int base = 0; base < DJ; base += NT_THREADS * TT_RPT) {
    float cnt[TT_RPT], cntop[TT_RPT];
    zero(cnt);
    zero(cntop);
    for (int i = t.i0; i < t.i1; ++i) {
      const size_t k = bFW + i;
      if (!(a.ws_flags[k] & F_ACTIVE)) continue;
      const float v = a.ws_f[k];
      const int iwire = a.ws_wire[k];
      const int job = a.inst_job[i];
      for (int hh = 0; hh < H; ++hh) {
        const int dj = a.ws_dom[k * H + hh] * J + job;
        const int s = owned(dj, base);
        if (s < 0) continue;
        add_at(cnt, s, v);
        if (iwire > smin_s[dj]) add_at(cntop, s, v);
      }
    }
    store(cnt, out, base, DJ);
    store(cntop, out + DJ, base, DJ);
  }
}

// ---- sweep 3: step-min, psn-window partials
__global__ void __launch_bounds__(NT_THREADS) tiled_sweep3(TiledArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int DJ = a.DJ, J = a.J, H = a.H;
  int* stepmin_s = reinterpret_cast<int*>(smem);
  const TileIdx t = tile_idx(a);
  const int tid = threadIdx.x;
  const size_t bFW = t.bFW;
  for (int r = tid; r < DJ; r += NT_THREADS)
    stepmin_s[r] = fold_stepmin(a, t.b, r);
  __syncthreads();
  float* out = a.p_symf + (((size_t)t.b * a.NB + t.nb) * 3 + 2) * DJ;
  for (int base = 0; base < DJ; base += NT_THREADS * TT_RPT) {
    float psn[TT_RPT];
    zero(psn);
    for (int i = t.i0; i < t.i1; ++i) {
      const size_t k = bFW + i;
      const unsigned char f = a.ws_flags[k];
      if (!(f & F_SEND) || (f & F_DONE)) continue;
      const int iwire = a.ws_wire[k];
      const float v = a.sent[k] / a.mtu + a.ws_f[k];
      const int job = a.inst_job[i];
      for (int hh = 0; hh < H; ++hh) {
        const int dj = a.ws_dom[k * H + hh] * J + job;
        const int s = owned(dj, base);
        if (s >= 0 && iwire == stepmin_s[dj]) max_at(psn, s, v);
      }
    }
    store(psn, out, base, DJ);
  }
}

// ---- flush, one block per lane: queues + RED and the Symphony rows
__global__ void __launch_bounds__(NT_THREADS) tiled_flush(TiledArgs a) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int L1 = a.L1, DJ = a.DJ;
  const size_t bL = (size_t)b * L1, bDJ = (size_t)b * DJ;
  const int* iscal = a.iscal + b * 5;
  const float* fscal = a.fscal + b * 7;
  const bool gate = lane_gate(a, b);
  const float kmin = fscal[1], kmax = fscal[2], pmax = fscal[3];
  for (int r = tid; r < L1; r += NT_THREADS) {
    float off_p, off_hi, off_lo;
    fold_links(a, b, r, off_p, off_hi, off_lo);
    const float c = a.cap[bL + r];
    const float offered = gate ? off_hi + off_lo : off_p;
    float q = fmaxf(a.q_prev[bL + r] + (offered - c) * a.dt, 0.0f);
    if (r == L1 - 1) q = 0.0f;
    a.offered_o[bL + r] = offered;
    a.q_o[bL + r] = q;
    a.p_red_o[bL + r] =
        fminf(fmaxf((q - kmin) / (kmax - kmin), 0.0f), 1.0f) * pmax;
  }
  const int tick = iscal[0], sym_win = iscal[3];
  const float tau = fscal[4], n_sample = fscal[5], alpha_max = fscal[6];
  const bool sym_epoch = floormod(tick, sym_win) == sym_win - 1;
  for (int r = tid; r < DJ; r += NT_THREADS) {
    float cnt = 0.0f, cntop = 0.0f, psn = a.s_psnwin[bDJ + r];
    for (int nb = 0; nb < a.NB; ++nb) {
      const float* p = a.p_symf + ((size_t)b * a.NB + nb) * 3 * DJ;
      cnt += p[r];
      cntop += p[DJ + r];
      psn = fmaxf(psn, p[2 * DJ + r]);
    }
    cnt = a.s_cnt[bDJ + r] + cnt;
    cntop = a.s_cntop[bDJ + r] + cntop;
    const bool have = cnt > n_sample;
    const bool exceed = cntop >= tau * cnt;
    const float step = (exceed ? 1.0f : -1.0f) * (have ? 1.0f : 0.0f);
    const float alpha_in = a.s_alpha[bDJ + r];
    const float alpha_new = fminf(fmaxf(alpha_in + step, 1.0f), alpha_max);
    a.smin_o[bDJ + r] = fold_stepmin(a, b, r);
    a.spsn_o[bDJ + r] = sym_epoch ? 0.0f : psn;
    a.salpha_o[bDJ + r] = sym_epoch ? alpha_new : alpha_in;
    a.scnt_o[bDJ + r] = sym_epoch ? 0.0f : cnt;
    a.scntop_o[bDJ + r] = sym_epoch ? 0.0f : cntop;
  }
}

// Dynamic shared bytes of the sweeps: sweep 2's link scales and Symphony
// rows are the most.
__host__ __device__ inline size_t tiled_smem2(int L1, int J, int DJ) {
  return ((size_t)3 * L1 + (size_t)3 * DJ) * 4;
}

extern "C" size_t netsim_tiled_smem_bytes(int L1, int J, int DJ) {
  const size_t s2 = tiled_smem2(L1, J, DJ);
  const size_t s0 = (size_t)J * 4, s3 = (size_t)DJ * 4;
  return s2 > s0 ? (s2 > s3 ? s2 : s3) : (s0 > s3 ? s0 : s3);
}

// ptrs: the TiledArgs pointers in declaration order (N_TILED_PTRS of them);
// dims: B, F, W, H, P, L1, J, SEG, DJ, blk, NB, per_step_ecmp, policy_pq;
// fdims: dt, mtu.  Launches the four sweeps and the flush on the stream.
extern "C" int netsim_tiled_launch(void** ptrs, const int* dims,
                                   const float* fdims, void* stream) {
  TiledArgs a;
  void** slot = reinterpret_cast<void**>(&a);
  for (int k = 0; k < N_TILED_PTRS; ++k) slot[k] = ptrs[k];
  a.B = dims[0]; a.F = dims[1]; a.W = dims[2]; a.H = dims[3]; a.P = dims[4];
  a.L1 = dims[5]; a.J = dims[6]; a.SEG = dims[7]; a.DJ = dims[8];
  a.blk = dims[9]; a.NB = dims[10]; a.per_step_ecmp = dims[11];
  a.policy_pq = dims[12];
  a.dt = fdims[0]; a.mtu = fdims[1];
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t s0 = (size_t)a.J * 4, s2 = tiled_smem2(a.L1, a.J, a.DJ);
  const size_t s3 = (size_t)a.DJ * 4;
  cudaError_t err = cudaFuncSetAttribute(
      tiled_sweep2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.NB, a.B);
  tiled_sweep0<<<grid, NT_THREADS, s0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tiled_sweep1<<<grid, NT_THREADS, s0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tiled_sweep2<<<grid, NT_THREADS, s2, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tiled_sweep3<<<grid, NT_THREADS, s3, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tiled_flush<<<a.B, NT_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
