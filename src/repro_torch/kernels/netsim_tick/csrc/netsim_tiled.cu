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
//   sweep 0  instance view and route choice; per-block job min-wire; the
//            block's active entries sorted by link row and by Symphony row
//   sweep 1  strict-priority class; proportional, hi and lo link-load
//            partials
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
// Entry lists by row, per block.  Sweep 0 compacts the block's active
// instances in ascending index order (warp ballots over per-warp runs),
// counts each link row's and each Symphony row's active entries (shared
// integer atomics: counting is order-free), turns the counts into offsets
// (a block-wide exclusive scan, netsim_hot.cuh's block_offsets) and places
// the entries in two lists sorted by row with the stable counting sort of
// netsim_hot.cuh (place_entries: warp 0 the link rows, warp 1 the Symphony
// rows dj = dom * J + job, at the same time).  The lists (instance indices
// within the block, uint16) and their offsets stay in a per-(lane, block)
// workspace, so that the sort runs once a tick and the later sweeps only
// read it: sweep 1 folds every link row's segment (proportional, hi and
// lo loads), sweep 2 every Symphony row's (cnt, cntop and the step-min
// candidates), sweep 3 every Symphony row's again (the psn window).  A row
// of at most NT_LONG entries is folded by one thread, a longer one by a
// warp (long_rows).
//
// Exactness.  No float atomics.  A block's partial of a row adds the
// row's segment in order from zero: the placement is stable, so that is
// ascending (instance, hop) order, the order of tiled_tick_ref's ordered
// sums (inactive entries, which the reference adds as +0.0, are left out:
// x + 0.0 == x on these non-negative sums).  A row's total adds the
// partials in ascending block order.  The step-min candidates are integer
// max/min and the psn window a max of non-negative floats, order-free.
// Build with --fmad=false.  So the kernel equals tiled_tick_ref bit for
// bit; against the staged tick (one ordered sum over all entries) the
// float sums reassociate, which is segsum="onehot"'s allclose contract.
//
// What bounds it.  One tick reads each lane's instance state and the
// chosen rows of its packed route tables once and writes iroute and eff:
// a few MB at 512 hosts x 8 lanes, microseconds at 3.35 TB/s.  The sort
// and the folds touch only the active entries (about one instance a flow
// is active mid-run), and every block folds the link partials of all
// blocks in sweeps 2 and the flush (NB x 3 x L+1 floats, from L2).  What
// is left is five launches a tick, each a few microseconds of latency
// with a pass over the block's instances, and the serial folds of the
// longest rows (the null link's).

#include <stddef.h>

#include "netsim_hot.cuh"

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
                            //   (written for active instances only)
  int* ws_wire;             // [B, FW] wire step
  unsigned char* ws_flags;  // [B, FW] F_* bits
  float* ws_f;              // [B, FW] chunk size, then packets this tick
  float* p_link;            // [B, NB, 3, L1] off_p, off_hi, off_lo
  int* p_job;               // [B, NB, J] job min-wire
  float* p_symf;            // [B, NB, 3, DJ] cnt, cntop, psn window
  int* p_symi;              // [B, NB, 2, DJ] candidates, min active
  unsigned short* ws_act;   // [B, NB, blk] active instances, ascending
  unsigned short* ws_llist; // [B, NB, blk * H] entries sorted by link row
  unsigned short* ws_slist; // [B, NB, blk * H] ... by Symphony row
  int* ws_loff;             // [B, NB, L1 + 1] link row offsets
  int* ws_soff;             // [B, NB, DJ + 1] Symphony row offsets
  int B, F, W, H, P, L1, J, SEG, DJ, blk, NB, per_step_ecmp, policy_pq;
  float dt, mtu;
};
#define N_TILED_PTRS 50
static_assert(offsetof(TiledArgs, B) == N_TILED_PTRS * sizeof(void*),
              "TiledArgs must start with its N_TILED_PTRS pointers");

// The block's lane b, its block nb and its instances [i0, i1); pb indexes
// the (lane, block) partials and lists.
struct TileIdx {
  int b, nb, i0, i1;
  size_t bFW, pb;
};

__device__ inline TileIdx tile_idx(const TiledArgs& a) {
  TileIdx t;
  t.b = blockIdx.y;
  t.nb = blockIdx.x;
  const int FW = a.F * a.W;
  t.i0 = t.nb * a.blk;
  t.i1 = min(t.i0 + a.blk, FW);
  t.bFW = (size_t)t.b * FW;
  t.pb = (size_t)t.b * a.NB + t.nb;
  return t;
}

// A (lane, block)'s sorted lists and their offsets.
struct BlockLists {
  const unsigned short* act;
  const unsigned short* llist;
  const unsigned short* slist;
  const int* loff;
  const int* soff;
};

__device__ inline BlockLists block_lists(const TiledArgs& a,
                                         const TileIdx& t) {
  const size_t E = (size_t)a.blk * a.H;
  return {a.ws_act + t.pb * a.blk, a.ws_llist + t.pb * E,
          a.ws_slist + t.pb * E, a.ws_loff + t.pb * (a.L1 + 1),
          a.ws_soff + t.pb * (a.DJ + 1)};
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

// Sweep 0's shared rows: the job min-wire, the link and Symphony row
// counts (then placement cursors) and offsets, two ints per warp.
__host__ __device__ inline size_t tiled_smem0(int L1, int J, int DJ) {
  return ((size_t)J + 2 * (size_t)L1 + 1 + 2 * (size_t)DJ + 1 +
          2 * NT_WARPS) * 4;
}

// Sweep 2's shared rows: the three link scales.
__host__ __device__ inline size_t tiled_smem2(int L1) {
  return (size_t)3 * L1 * 4;
}

// ---- sweep 0: instance view, route choice, job min-wire partial; the
//      active entries sorted by link row and by Symphony row
__global__ void __launch_bounds__(NT_THREADS) tiled_sweep0(TiledArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, J = a.J, L1 = a.L1, DJ = a.DJ;
  int* jobmin_s = reinterpret_cast<int*>(smem);
  int* lcur_s = jobmin_s + J;
  int* loff_s = lcur_s + L1;
  int* scur_s = loff_s + L1 + 1;
  int* soff_s = scur_s + DJ;
  int* wcnt_s = soff_s + DJ + 1;
  int* wsum_s = wcnt_s + NT_WARPS;
  const TileIdx t = tile_idx(a);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const size_t bFW = t.bFW;
  const int seed = a.iscal[t.b * 5 + 1];
  for (int j = tid; j < J; j += NT_THREADS) jobmin_s[j] = NT_BIG;
  for (int r = tid; r < L1; r += NT_THREADS) lcur_s[r] = 0;
  for (int r = tid; r < DJ; r += NT_THREADS) scur_s[r] = 0;
  __syncthreads();
  // each warp takes a run of consecutive instances, so that the active
  // ones compact in ascending order
  const int n = t.i1 - t.i0;
  const int wper = (n + 32 * NT_WARPS - 1) / (32 * NT_WARPS) * 32;
  const int w0 = min(warp * wper, n), w1 = min(w0 + wper, n);
  int wact = 0;
  for (int c = w0; c < w1; c += 32) {
    const int li = c + lane;
    bool active = false;
    if (li < w1) {
      const int i = t.i0 + li;
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
      active = occupied && !complete && !retired;
      const int *row, *drow;
      if (a.per_step_ecmp) {
        uint32_t h = (uint32_t)flow * 2654435761u +
                     (uint32_t)max(istep, 0) * 40503u +
                     ((uint32_t)seed + 1u) * 2246822519u;
        h = (h ^ (h >> 13)) * 2654435761u;
        h = h ^ (h >> 16);
        const uint32_t np = (uint32_t)a.n_paths[k];
        const size_t c2 = (k * a.P + (int)(h % np)) * H;
        row = a.cand + c2;
        drow = a.cand_dom + c2;
      } else {
        row = a.routes + k * H;
        drow = a.route_dom + k * H;
      }
      for (int hh = 0; hh < H; ++hh) {
        const int l = row[hh];
        a.iroute_o[k * H + hh] = l;
        if (active) {
          const int d = drow[hh];
          a.ws_dom[k * H + hh] = d;
          atomicAdd(&lcur_s[l], 1);
          atomicAdd(&scur_s[d * J + job], 1);
        }
      }
      if (active) atomicMin(&jobmin_s[job], iwire);
      a.ws_wire[k] = iwire;
      a.ws_f[k] = ichunk;
      a.ws_flags[k] = active ? F_ACTIVE : 0;
    }
    wact += __popc(__ballot_sync(0xffffffffu, active));
  }
  if (lane == 0) wcnt_s[warp] = wact;
  __syncthreads();
  // the active list, in ascending order (each lane re-reads the flags it
  // wrote)
  int n_act = 0, at = 0;
  for (int w = 0; w < NT_WARPS; ++w) {
    if (w == warp) at = n_act;
    n_act += wcnt_s[w];
  }
  const size_t E = (size_t)a.blk * H;
  unsigned short* act = a.ws_act + t.pb * a.blk;
  for (int c = w0; c < w1; c += 32) {
    const int li = c + lane;
    const bool active = li < w1 && (a.ws_flags[bFW + t.i0 + li] & F_ACTIVE);
    const unsigned bal = __ballot_sync(0xffffffffu, active);
    if (active) act[at + __popc(bal & lt)] = (unsigned short)li;
    at += __popc(bal);
  }
  block_offsets(lcur_s, loff_s, L1, wsum_s);
  block_offsets(scur_s, soff_s, DJ, wsum_s);
  // warp 0 sorts the link entries, warp 1 the Symphony entries
  const size_t e0 = (bFW + t.i0) * H;
  const int* jobs = a.inst_job + t.i0;
  if (warp == 0)
    place_entries(act, n_act, H, lcur_s, a.ws_llist + t.pb * E,
                  [&](int i, int hh) { return a.iroute_o[e0 + i * H + hh]; });
  else if (warp == 1)
    place_entries(act, n_act, H, scur_s, a.ws_slist + t.pb * E,
                  [&](int i, int hh) {
                    return a.ws_dom[e0 + i * H + hh] * J + jobs[i];
                  });
  for (int r = tid; r <= L1; r += NT_THREADS)
    a.ws_loff[t.pb * (L1 + 1) + r] = loff_s[r];
  for (int r = tid; r <= DJ; r += NT_THREADS)
    a.ws_soff[t.pb * (DJ + 1) + r] = soff_s[r];
  for (int j = tid; j < J; j += NT_THREADS) a.p_job[t.pb * J + j] = jobmin_s[j];
}

// ---- sweep 1: strict-priority class; proportional, hi and lo link-load
//      partials over each link row's segment
__global__ void __launch_bounds__(NT_THREADS) tiled_sweep1(TiledArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* jobmin_s = reinterpret_cast<int*>(smem);
  const TileIdx t = tile_idx(a);
  const int tid = threadIdx.x, lane = tid & 31, H = a.H, J = a.J;
  const int L1 = a.L1;
  const BlockLists bl = block_lists(a, t);
  for (int j = tid; j < J; j += NT_THREADS) {
    int m = NT_BIG;
    for (int nb = 0; nb < a.NB; ++nb)
      m = min(m, a.p_job[((size_t)t.b * a.NB + nb) * J + j]);
    jobmin_s[j] = m;
  }
  __syncthreads();
  const size_t base = t.bFW + t.i0;
  const int n_act = bl.loff[L1] / H;
  for (int q = tid; q < n_act; q += NT_THREADS) {
    const int li = bl.act[q];
    if (a.ws_wire[base + li] <= jobmin_s[a.inst_job[t.i0 + li]])
      a.ws_flags[base + li] |= F_HI;
  }
  __syncthreads();
  const float* rate = a.rate + base;
  const unsigned char* flags = a.ws_flags + base;
  float* out = a.p_link + t.pb * 3 * L1;
  for (int r = tid; r < L1; r += NT_THREADS) {
    const int p0 = bl.loff[r], p1 = bl.loff[r + 1];
    if (p1 - p0 > NT_LONG) continue;
    float sp = 0.0f, shi = 0.0f, slo = 0.0f;
    for (int p = p0; p < p1; ++p) {
      const int i = bl.llist[p];
      const float v = rate[i];
      sp += v;
      if (flags[i] & F_HI) shi += v; else slo += v;
    }
    out[r] = sp;
    out[L1 + r] = shi;
    out[2 * L1 + r] = slo;
  }
  long_rows(bl.loff, L1, [&](int r) {
    const int p0 = bl.loff[r], p1 = bl.loff[r + 1];
    float sp = 0.0f, shi = 0.0f, slo = 0.0f;
    for (int p = p0; p < p1; p += 32 * NT_GATHER) {
      int i[NT_GATHER];
      float v[NT_GATHER];
#pragma unroll
      for (int g = 0; g < NT_GATHER; ++g) {
        const int q = p + 32 * g + lane;
        i[g] = q < p1 ? bl.llist[q] : -1;
        v[g] = i[g] >= 0 ? rate[i[g]] : 0.0f;
      }
#pragma unroll
      for (int g = 0; g < NT_GATHER; ++g) {
        const int m = min(32, p1 - p - 32 * g);
        const unsigned his = __ballot_sync(
            0xffffffffu, i[g] >= 0 && (flags[i[g]] & F_HI));
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float x = __shfl_sync(0xffffffffu, v[g], j);
          if (j < m) {
            sp += x;
            if ((his >> j) & 1u) shi += x; else slo += x;
          }
        }
      }
    }
    if (lane == 0) {
      out[r] = sp;
      out[L1 + r] = shi;
      out[2 * L1 + r] = slo;
    }
  });
}

// ---- sweep 2: link scales, eff, packets and completions; Symphony
//      cnt/cntop partials and step-min candidates over each Symphony row's
//      segment
__global__ void __launch_bounds__(NT_THREADS) tiled_sweep2(TiledArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L1 = a.L1, DJ = a.DJ, H = a.H;
  float* sl_s = reinterpret_cast<float*>(smem);
  float* shi_s = sl_s + L1;
  float* slo_s = shi_s + L1;
  const TileIdx t = tile_idx(a);
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t bL = (size_t)t.b * L1, base = t.bFW + t.i0;
  const BlockLists bl = block_lists(a, t);
  for (int r = tid; r < L1; r += NT_THREADS) {
    float off_p, off_hi, off_lo;
    fold_links(a, t.b, r, off_p, off_hi, off_lo);
    const float c = a.cap[bL + r];
    sl_s[r] = fminf(1.0f, c / fmaxf(off_p, 1.0f));
    const float s_hi = fminf(1.0f, c / fmaxf(off_hi, 1.0f));
    shi_s[r] = s_hi;
    slo_s[r] = fmaxf(c - off_hi * s_hi, 0.0f) / fmaxf(off_lo, 1.0f);
  }
  // an inactive instance's rate counts as 0: it delivers eff = 0 * (a
  // share <= 1) = 0 and sends 0 packets
  for (int li = tid; li < t.i1 - t.i0; li += NT_THREADS) {
    if (a.ws_flags[base + li] & F_ACTIVE) continue;
    a.eff_o[base + li] = 0.0f;
    a.ws_f[base + li] = 0.0f;
  }
  __syncthreads();
  const bool gate = lane_gate(a, t.b);
  const float dt = a.dt, mtu = a.mtu;
  const int n_act = bl.loff[L1] / H;
  for (int q = tid; q < n_act; q += NT_THREADS) {
    const size_t k = base + bl.act[q];
    unsigned char f = a.ws_flags[k];
    const bool is_hi = f & F_HI;
    const float w_rate = a.rate[k];
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
    const bool done = a.sent[k] + eff * dt >= a.ws_f[k];
    const bool send = eff > 1.0f;
    a.ws_flags[k] = f | (done ? F_DONE : 0) | (send ? F_SEND : 0);
    a.ws_f[k] = pkts;
  }
  __syncthreads();
  const float* pkts = a.ws_f + base;
  const int* wire = a.ws_wire + base;
  const unsigned char* flags = a.ws_flags + base;
  const int* smin_in = a.s_stepmin + (size_t)t.b * DJ;
  float* pf = a.p_symf + t.pb * 3 * DJ;
  int* pi = a.p_symi + t.pb * 2 * DJ;
  for (int r = tid; r < DJ; r += NT_THREADS) {
    const int p0 = bl.soff[r], p1 = bl.soff[r + 1];
    if (p1 - p0 > NT_LONG) continue;
    const int s0 = smin_in[r];
    float cnt = 0.0f, cntop = 0.0f;
    int cand = 0, minact = NT_BIG;
    for (int p = p0; p < p1; ++p) {
      const int i = bl.slist[p];
      const float v = pkts[i];
      const int w = wire[i];
      cnt += v;
      if (w > s0) cntop += v;
      if (flags[i] & F_DONE) cand = max(cand, w + 1);
      else minact = min(minact, w);
    }
    pf[r] = cnt;
    pf[DJ + r] = cntop;
    pi[r] = cand;
    pi[DJ + r] = minact;
  }
  long_rows(bl.soff, DJ, [&](int r) {
    const int p0 = bl.soff[r], p1 = bl.soff[r + 1];
    const int s0 = smin_in[r];
    float cnt = 0.0f, cntop = 0.0f;
    int cand = 0, minact = NT_BIG;
    for (int p = p0; p < p1; p += 32 * NT_GATHER) {
      float v[NT_GATHER];
      int w[NT_GATHER];
#pragma unroll
      for (int g = 0; g < NT_GATHER; ++g) {
        const int q = p + 32 * g + lane;
        const int i = q < p1 ? bl.slist[q] : -1;
        v[g] = i >= 0 ? pkts[i] : 0.0f;
        w[g] = i >= 0 ? wire[i] : 0;
        if (i >= 0) {
          if (flags[i] & F_DONE) cand = max(cand, w[g] + 1);
          else minact = min(minact, w[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < NT_GATHER; ++g) {
        const int m = min(32, p1 - p - 32 * g);
        const unsigned ops =
            __ballot_sync(0xffffffffu, 32 * g + lane < p1 - p && w[g] > s0);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float x = __shfl_sync(0xffffffffu, v[g], j);
          if (j < m) {
            cnt += x;
            if ((ops >> j) & 1u) cntop += x;
          }
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      cand = max(cand, __shfl_xor_sync(0xffffffffu, cand, o));
      minact = min(minact, __shfl_xor_sync(0xffffffffu, minact, o));
    }
    if (lane == 0) {
      pf[r] = cnt;
      pf[DJ + r] = cntop;
      pi[r] = cand;
      pi[DJ + r] = minact;
    }
  });
}

// ---- sweep 3: step-min; psn-window partials over each Symphony row's
//      segment (a max: order-free)
__global__ void __launch_bounds__(NT_THREADS) tiled_sweep3(TiledArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int DJ = a.DJ;
  int* stepmin_s = reinterpret_cast<int*>(smem);
  const TileIdx t = tile_idx(a);
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t base = t.bFW + t.i0;
  const BlockLists bl = block_lists(a, t);
  for (int r = tid; r < DJ; r += NT_THREADS)
    stepmin_s[r] = fold_stepmin(a, t.b, r);
  __syncthreads();
  const float mtu = a.mtu;
  const float* sent = a.sent + base;
  const float* pkts = a.ws_f + base;
  const int* wire = a.ws_wire + base;
  const unsigned char* flags = a.ws_flags + base;
  // the psn candidate of the entry of block instance i in row r
  auto cand = [&](int i, int r) {
    const unsigned char f = flags[i];
    return ((f & F_SEND) && !(f & F_DONE) && wire[i] == stepmin_s[r])
               ? sent[i] / mtu + pkts[i]
               : 0.0f;
  };
  float* out = a.p_symf + (t.pb * 3 + 2) * DJ;
  for (int r = tid; r < DJ; r += NT_THREADS) {
    const int p0 = bl.soff[r], p1 = bl.soff[r + 1];
    if (p1 - p0 > NT_LONG) continue;
    float psn = 0.0f;
    for (int p = p0; p < p1; ++p) psn = fmaxf(psn, cand(bl.slist[p], r));
    out[r] = psn;
  }
  long_rows(bl.soff, DJ, [&](int r) {
    const int p0 = bl.soff[r], p1 = bl.soff[r + 1];
    float psn = 0.0f;
    for (int p = p0 + lane; p < p1; p += 32)
      psn = fmaxf(psn, cand(bl.slist[p], r));
    for (int o = 16; o > 0; o >>= 1)
      psn = fmaxf(psn, __shfl_xor_sync(0xffffffffu, psn, o));
    if (lane == 0) out[r] = psn;
  });
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

extern "C" size_t netsim_tiled_smem_bytes(int L1, int J, int DJ) {
  const size_t s0 = tiled_smem0(L1, J, DJ), s2 = tiled_smem2(L1);
  return s0 > s2 ? s0 : s2;
}

// The interface: 2 since the per-block row sort (five list and offset
// workspaces after the first port's 45 pointers).
extern "C" int netsim_tiled_abi() { return 2; }

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
  const size_t s0 = tiled_smem0(a.L1, a.J, a.DJ), s1 = (size_t)a.J * 4;
  const size_t s2 = tiled_smem2(a.L1), s3 = (size_t)a.DJ * 4;
  cudaError_t err = cudaFuncSetAttribute(
      tiled_sweep0, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s0);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      tiled_sweep2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.NB, a.B);
  tiled_sweep0<<<grid, NT_THREADS, s0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tiled_sweep1<<<grid, NT_THREADS, s1, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tiled_sweep2<<<grid, NT_THREADS, s2, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tiled_sweep3<<<grid, NT_THREADS, s3, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tiled_flush<<<a.B, NT_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
