// The hot stages of one netsim engine tick for one simulation lane, as
// __device__ code shared by the single-tick kernel (netsim_tick.cu) and the
// multi-tick window kernel (netsim_window.cu).
//
// hot_tick() is the counterpart of the reference's kernel.hot_tick in
// segsum="scatter" mode: the instance view, per-step ECMP route hash,
// proportional and strict-priority bandwidth shares (selected per lane by
// pq_on), queue integration + RED, and the Symphony per-(domain, job) state
// update.  Every thread of the block calls it; it synchronises the block
// between its phases and not after the last one.
//
// Entry lists by row.  The float sums (offered load per link, Symphony
// cnt/cntop) run over the tick's active (instance, hop) entries, A x H of
// them where A is the number of active instances (one per flow mid-run,
// against F x W instances).  The block compacts the active instances into a
// list in ascending index order (warp ballots, per-warp counts), counts each
// row's entries (shared integer atomics: counting is order-free), turns the
// counts into row offsets (a block-wide exclusive scan), and one warp places
// the entries into a list sorted by row (place_entries: a stable counting
// sort).  Each row then adds only its own segment of that list: one thread
// per row, or one warp per row where the segment is longer than NT_LONG.
// The link rows and the Symphony rows are two such sorts; the Symphony sort
// reuses the link sort's list, since the two phases never overlap.
//
// Exactness.  The float sums must add in ascending flat (instance, hop)
// order, the order of XLA's CPU scatter and of torch's CPU index_add_.  The
// placement is stable, so each row's segment holds its entries in that
// order, and every row's sum is a sequential fold of its segment: the same
// additions in the same order as a walk over every instance.  Inactive
// instances are left out; the reference adds where(active, v, 0.0) there,
// and x + 0.0 == x on these non-negative sums.  There are no float atomics.
// Integer min/max (job min-wire, step-min candidates) and the float max of
// non-negative psn values are order-free and use shared-memory atomics or
// warp reductions.  Build with --fmad=false so that a*b+c rounds twice, as
// the eager op sequence does.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NT_BIG (1 << 30)
#define NT_I32MAX 2147483647
#define NT_WIRE_SEG 4096
#define NT_THREADS 512
#define NT_WARPS (NT_THREADS / 32)
// a row whose segment is longer than this is added by a whole warp, which
// gathers NT_GATHER entries a lane at once
#define NT_LONG 32
#define NT_GATHER 4

// flag bits per instance
#define F_ACTIVE 1
#define F_HI 2
#define F_DONE 4
#define F_SEND 8

// Shapes and static options of a run.
struct HotDims {
  int F, W, H, P, L1, J, SEG, DJ;
  float dt, mtu;
  int per_step_ecmp, policy_pq;
};

// Per-instance index arrays shared by every lane ([FW] each) and the
// per-job chunk schedule ([J, SEG]).
struct HotShared {
  const int* inst_job; const int* inst_flow; const int* sps;
  const int* phase; const int* nph; const int* off;
  const float* chunk_sched;
};

// One lane's operands, every pointer already offset to the lane.  Outputs
// that a caller does not need are null.  q_prev and q_out may alias: each
// link row is read and then written by the same thread.
struct HotLane {
  const int* step; const float* sent; const float* rate;   // [FW]
  const int* done_upto;                                     // [F]
  const float* q_prev;                                      // [L1]
  const int* s_stepmin; const float* s_psnwin; const float* s_alpha;
  const float* s_cnt; const float* s_cntop;                 // [DJ] in
  const int* routes;      // [F, H]
  const int* path_table;  // [F, P, H]
  const int* n_paths;     // [F]
  const float* cap; const int* link_dom; const float* bg_base;
  const float* bg_amp;                                      // [L1]
  int* iroute_o;          // [FW, H] or null
  float* eff_o;           // [FW]
  float* offered_o;       // [L1] or null
  float* q_o;             // [L1]
  float* p_red_o;         // [L1]
  int* smin_o; float* spsn_o; float* salpha_o; float* scnt_o;
  float* scntop_o;                                          // [DJ] out
  int* ws_wire;           // [FW] wire step of each instance
  float* ws_f;            // [FW] its chunk size, then its packets this tick
  int tick, seed, bg_period, sym_win, pq_on;
  float bg_duty, red_kmin, red_kmax, red_pmax, tau, n_sample, alpha_max;
};

// Scratch of hot_tick.  The rows always live in shared memory: the link,
// job and Symphony rows, and the sorts' row counts (which become placement
// cursors), row offsets and per-warp counts.  The per-(instance, hop) link
// ids, the entry list (an instance index per entry, sorted by row) and the
// per-instance flags live there too when they fit; a lane whose ids do not
// fit (256 hosts and up at window 64) keeps them in its global workspace
// instead.  The active-instance list always lives in the lane's global
// workspace (L2-resident), first: hot_ws_bytes() per lane.  Every walk and
// sort reads the same values in the same order wherever they live, so the
// split changes no result.
struct HotSmem {
  float* cap_s; float* bg_s; float* sl_s; float* shi_s; float* slo_s;
  int* dom_s; int* jobmin_s; int* cand_s; int* minact_s;
  int* lcur_s;               // [L1]   link row counts, then cursors
  int* loff_s;               // [L1+1] link row offsets into list_s
  int* scur_s;               // [DJ]   Symphony row counts, then cursors
  int* soff_s;               // [DJ+1] Symphony row offsets into list_s
  int* wcnt_s;               // [NT_WARPS] active instances per warp range
  int* wsum_s;               // [NT_WARPS] scan scratch
  unsigned short* route_s;   // [FW*H] link id of each (instance, hop)
  unsigned short* list_s;    // [FW*H] entries' instances, sorted by row
  unsigned char* flags_s;    // [FW] F_* bits
  unsigned short* act;       // [FW] active instances, ascending (global)
};

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// Bytes of the rows: five link rows, the link domains, the job row, two
// Symphony rows, then the sorts' link counts and offsets, Symphony counts
// and offsets, and two ints per warp.
__host__ __device__ inline size_t hot_rows_bytes(int L1, int J, int DJ) {
  return ((size_t)8 * L1 + J + (size_t)4 * DJ + 2 + 2 * NT_WARPS) * 4;
}

// Bytes of one lane's link ids and entry list (uint16 each, padded to an
// even count) and flags.
__host__ __device__ inline size_t hot_ids_raw(int FW, int H) {
  const size_t E = (size_t)FW * H;
  return ((E + 1) & ~(size_t)1) * 4 + (size_t)FW;
}

// Bytes of one lane's active-instance list (uint16, padded to 16 bytes).
__host__ __device__ inline size_t hot_act_bytes(int FW) {
  return round16(((size_t)FW + 1) / 2 * 4);
}

// A lane's stride in the global workspace: the active list, then the ids
// when they do not live in shared memory.
__host__ __device__ inline size_t hot_ws_bytes(int FW, int H,
                                               int ids_in_smem) {
  return hot_act_bytes(FW) + (ids_in_smem ? 0 : round16(hot_ids_raw(FW, H)));
}

// Shared bytes of hot_tick's scratch, rounded up to 16 so that more scratch
// can follow: the rows, and the ids right after them when ids_in_smem.
__host__ __device__ inline size_t hot_smem_bytes(int FW, int H, int L1,
                                                 int J, int DJ,
                                                 int ids_in_smem) {
  return round16(hot_rows_bytes(L1, J, DJ) +
                 (ids_in_smem ? hot_ids_raw(FW, H) : 0));
}

// Carve the scratch from the block's shared memory and ws, this lane's
// global workspace of hot_ws_bytes().  With IDS_SMEM the ids follow the
// rows in shared memory; otherwise they follow the active list in ws.  The
// choice is a template parameter so that each kernel instantiation knows
// the ids' address space at compile time.  The ids start right after the
// last row, derived from its int pointer: starting them at a 16-byte
// boundary instead measured 21-25 % slower for the single-tick kernel on
// the H100 (PERF.md).
template <bool IDS_SMEM>
__device__ __forceinline__ HotSmem hot_smem_carve(unsigned char* base,
                                                  const HotDims& d,
                                                  unsigned char* ws) {
  HotSmem m;
  const int L1 = d.L1, DJ = d.DJ, FW = d.F * d.W, E = FW * d.H;
  m.cap_s = reinterpret_cast<float*>(base);
  m.bg_s = m.cap_s + L1;
  m.sl_s = m.bg_s + L1;
  m.shi_s = m.sl_s + L1;
  m.slo_s = m.shi_s + L1;
  m.dom_s = reinterpret_cast<int*>(m.slo_s + L1);
  m.jobmin_s = m.dom_s + L1;
  m.cand_s = m.jobmin_s + d.J;
  m.minact_s = m.cand_s + DJ;
  m.lcur_s = m.minact_s + DJ;
  m.loff_s = m.lcur_s + L1;
  m.scur_s = m.loff_s + L1 + 1;
  m.soff_s = m.scur_s + DJ;
  m.wcnt_s = m.soff_s + DJ + 1;
  m.wsum_s = m.wcnt_s + NT_WARPS;
  m.act = reinterpret_cast<unsigned short*>(ws);
  unsigned char* ids =
      IDS_SMEM ? reinterpret_cast<unsigned char*>(m.wsum_s + NT_WARPS)
               : ws + hot_act_bytes(FW);
  m.route_s = reinterpret_cast<unsigned short*>(ids);
  m.list_s = m.route_s + ((E + 1) & ~1);
  m.flags_s = reinterpret_cast<unsigned char*>(m.list_s + ((E + 1) & ~1));
  return m;
}

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

__device__ __forceinline__ int floormod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// Exclusive prefix sums of cnt[0..n) into off[0..n] (off[n] = the total),
// with cnt overwritten by the same offsets (the placement cursors).  Every
// thread calls it; each sums a run of consecutive rows, a warp scan and the
// per-warp totals in wsum give its run's offset.  Ends synchronised.
__device__ __forceinline__ void block_offsets(int* cnt, int* off, int n,
                                              int* wsum) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int per = (n + nt - 1) / nt;
  const int r0 = min(tid * per, n), r1 = min(r0 + per, n);
  int s = 0;
  for (int r = r0; r < r1; ++r) s += cnt[r];
  int incl = s;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wsum[tid >> 5] = incl;
  __syncthreads();
  int at = incl - s;
  for (int w = 0; w < (tid >> 5); ++w) at += wsum[w];
  for (int r = r0; r < r1; ++r) {
    const int c = cnt[r];
    off[r] = at;
    cnt[r] = at;
    at += c;
  }
  if (tid == nt - 1) off[n] = at;
  __syncthreads();
}

// Stable counting-sort placement, run by one warp: the n_act * H active
// entries, visited in ascending flat (instance, hop) order in batches of
// 32, each written to list[cur[key] + its rank among the batch's entries
// of the same key]; the lowest lane of each key then advances cur[key] by
// the batch's count.  key(i, hh) is the row of hop hh of instance i.  The
// next batch's ids are fetched before the current batch is placed.
template <class Key>
__device__ __forceinline__ void place_entries(const unsigned short* act,
                                              int n_act, int H, int* cur,
                                              unsigned short* list, Key key) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int n = n_act * H;
  // entry e0 + lane is hop hh of the q-th active instance; e0 steps by 32
  int q = lane / H, hh = lane - q * H;
  const int dq = 32 / H, dh = 32 - dq * H;
  int i = 0, k = -1;
  auto fetch = [&]() {
    k = -1;
    if (q < n_act) {
      i = act[q];
      k = key(i, hh);
    }
    q += dq;
    hh += dh;
    if (hh >= H) {
      hh -= H;
      ++q;
    }
  };
  fetch();
  for (int e0 = 0; e0 < n; e0 += 32) {
    const int ci = i, ck = k;
    fetch();
    const unsigned peers = __match_any_sync(0xffffffffu, ck);
    const int rank = __popc(peers & lt);
    if (ck >= 0) list[cur[ck] + rank] = (unsigned short)ci;
    __syncwarp();
    if (ck >= 0 && rank == 0) cur[ck] += __popc(peers);
    __syncwarp();
  }
}

// Calls body(r) for every row r < R whose segment of off is longer than
// NT_LONG, each by one warp (rows dealt round-robin over the warps).  A
// body gathers 32 x NT_GATHER entries at a time, NT_GATHER a lane, and
// every lane then adds them in list order from the shuffles, unrolled so
// that the shuffles issue back to back and only the adds wait on each
// other.
template <class Body>
__device__ __forceinline__ void long_rows(const int* off, int R, Body body) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int k0 = 0; warp + k0 * nw < R; k0 += 32) {
    const int r = warp + (k0 + lane) * nw;
    unsigned todo = __ballot_sync(
        0xffffffffu, r < R && off[r + 1] - off[r] > NT_LONG);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      body(warp + (k0 + j) * nw);
    }
  }
}

// Link row r from its sums: shares, queue, RED (phase 3's epilogue).
__device__ __forceinline__ void link_row(const HotLane& a, const HotSmem& m,
                                         int r, int L1, bool gate, float dt,
                                         float sp, float shi, float slo) {
  const float c = m.cap_s[r], bg = m.bg_s[r];
  const float off_p = sp + bg;
  const float s_l = fminf(1.0f, c / fmaxf(off_p, 1.0f));
  const float off_hi = shi + bg;
  const float s_hi = fminf(1.0f, c / fmaxf(off_hi, 1.0f));
  const float rem = fmaxf(c - off_hi * s_hi, 0.0f);
  const float off_lo = slo;
  const float s_lo = rem / fmaxf(off_lo, 1.0f);
  const float offered = gate ? off_hi + off_lo : off_p;
  float q = fmaxf(a.q_prev[r] + (offered - c) * dt, 0.0f);
  if (r == L1 - 1) q = 0.0f;
  const float p_red =
      fminf(fmaxf((q - a.red_kmin) / (a.red_kmax - a.red_kmin), 0.0f),
            1.0f) * a.red_pmax;
  if (a.offered_o) a.offered_o[r] = offered;
  a.q_o[r] = q;
  a.p_red_o[r] = p_red;
  m.sl_s[r] = s_l;
  m.shi_s[r] = s_hi;
  m.slo_s[r] = s_lo;
}

// One Symphony row's running state (phase 5).
struct SymRow {
  int smin_in, stepmin;
  float cnt, cntop, psn;
};

__device__ __forceinline__ SymRow sym_begin(const HotLane& a,
                                            const HotSmem& m, int r) {
  SymRow s;
  s.smin_in = a.s_stepmin[r];
  const int cand = max(s.smin_in, m.cand_s[r]);
  const int ma = m.minact_s[r];
  s.stepmin = ma < NT_BIG ? min(cand, ma) : cand;
  s.cnt = a.s_cnt[r];
  s.cntop = a.s_cntop[r];
  s.psn = a.s_psnwin[r];
  return s;
}

// The psn candidate of an entry of an instance with flags f, isent bytes
// sent and iwire (-inf when it has none).
__device__ __forceinline__ float sym_psn(unsigned char f, float isent,
                                         int iwire, float pkts, int stepmin,
                                         float mtu) {
  return ((f & F_SEND) && !(f & F_DONE) && iwire == stepmin)
             ? isent / mtu + pkts
             : -INFINITY;
}

__device__ __forceinline__ void sym_end(const HotLane& a, int r,
                                        const SymRow& s, bool sym_epoch) {
  const bool have = s.cnt > a.n_sample;
  const bool exceed = s.cntop >= a.tau * s.cnt;
  const float step = (exceed ? 1.0f : -1.0f) * (have ? 1.0f : 0.0f);
  const float alpha_in = a.s_alpha[r];
  const float alpha_new = fminf(fmaxf(alpha_in + step, 1.0f), a.alpha_max);
  a.smin_o[r] = s.stepmin;
  a.spsn_o[r] = sym_epoch ? 0.0f : s.psn;
  a.salpha_o[r] = sym_epoch ? alpha_new : alpha_in;
  a.scnt_o[r] = sym_epoch ? 0.0f : s.cnt;
  a.scntop_o[r] = sym_epoch ? 0.0f : s.cntop;
}

// What phase 1 reads of instance i, every load issued and nothing stored,
// so that a lane's loads for several instances are in flight together.
struct InstView {
  int job, iwire;
  float ichunk;
  bool active;
  const int* row;   // its route: H link ids
};

__device__ __forceinline__ InstView inst_view(const HotLane& a,
                                              const HotDims& d,
                                              const HotShared& s, int i) {
  InstView v;
  const int istep = a.step[i];
  const int flow = s.inst_flow[i];
  // an unoccupied slot (most of them mid-run) is inactive; its wire step
  // and chunk size are never read
  v.job = 0;
  v.iwire = 0;
  v.ichunk = 0.0f;
  v.active = false;
  if (istep >= 0) {
    const float isent = a.sent[i];
    const int sps = s.sps[i];
    v.job = s.inst_job[i];
    const int iseg = floordiv(istep, sps) * s.nph[i] + s.phase[i];
    const int segc = min(max(iseg, 0), d.SEG - 1);
    v.ichunk = s.chunk_sched[v.job * d.SEG + segc];
    v.iwire = iseg * NT_WIRE_SEG + floormod(istep, sps) + s.off[i];
    const bool retired = istep < a.done_upto[flow];
    const bool complete = isent >= v.ichunk;
    v.active = !complete && !retired;
  }
  if (d.per_step_ecmp) {
    uint32_t h = (uint32_t)flow * 2654435761u +
                 (uint32_t)max(istep, 0) * 40503u +
                 ((uint32_t)a.seed + 1u) * 2246822519u;
    h = (h ^ (h >> 13)) * 2654435761u;
    h = h ^ (h >> 16);
    const uint32_t np = (uint32_t)a.n_paths[flow];
    const int choice = (int)(h % np);
    v.row = a.path_table + ((size_t)flow * d.P + choice) * d.H;
  } else {
    v.row = a.routes + (size_t)flow * d.H;
  }
  return v;
}

// instances a lane views together in phase 1, and route ids loaded at once
#define NT_VIEWS 2
#define NT_HOPS 8

__device__ __forceinline__ void hot_tick(const HotLane& a, const HotDims& d,
                                         const HotShared& s,
                                         const HotSmem& m) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int F = d.F, H = d.H, L1 = d.L1, J = d.J, DJ = d.DJ;
  const int FW = F * d.W;
  const int tick = a.tick;
  const bool gate = d.policy_pq || (a.pq_on != 0);
  const float dt = d.dt, mtu = d.mtu;
  // phases 1-2 give each warp a run of consecutive instances, so that the
  // active ones compact in ascending order
  const int wper = (FW + 32 * NT_WARPS - 1) / (32 * NT_WARPS) * 32;
  const int w0 = min(warp * wper, FW), w1 = min(w0 + wper, FW);

  // ---- phase 0: link rows, background load, reduction identities, row
  //      counts
  const bool bg_on =
      (float)floormod(tick, a.bg_period) < a.bg_duty * (float)a.bg_period;
  for (int r = tid; r < L1; r += nt) {
    m.cap_s[r] = a.cap[r];
    m.dom_s[r] = a.link_dom[r];
    m.bg_s[r] = a.bg_base[r] + (bg_on ? a.bg_amp[r] : 0.0f);
    m.lcur_s[r] = 0;
  }
  for (int j = tid; j < J; j += nt) m.jobmin_s[j] = NT_BIG;
  for (int r = tid; r < DJ; r += nt) {
    m.cand_s[r] = 0;
    m.minact_s[r] = NT_BIG;
    m.scur_s[r] = 0;
  }
  __syncthreads();

  // ---- phase 1: instance view, route selection, job min-wire; the
  //      active instances of each warp's run and the entries of each link
  //      and Symphony row counted
  //      (NT_VIEWS instances a lane at a time, each one's loads before any
  //      store)
  int wact = 0;
  for (int b = w0; b < w1; b += 32 * NT_VIEWS) {
    InstView v[NT_VIEWS];
#pragma unroll
    for (int u = 0; u < NT_VIEWS; ++u) {
      const int i = b + 32 * u + lane;
      v[u].active = false;
      if (i < w1) v[u] = inst_view(a, d, s, i);
    }
    for (int h0 = 0; h0 < H; h0 += NT_HOPS) {
      int l[NT_VIEWS][NT_HOPS];
#pragma unroll
      for (int u = 0; u < NT_VIEWS; ++u)
#pragma unroll
        for (int k = 0; k < NT_HOPS; ++k)
          if (b + 32 * u + lane < w1 && h0 + k < H) l[u][k] = v[u].row[h0 + k];
#pragma unroll
      for (int u = 0; u < NT_VIEWS; ++u) {
        const int i = b + 32 * u + lane;
#pragma unroll
        for (int k = 0; k < NT_HOPS; ++k) {
          if (i >= w1 || h0 + k >= H) continue;
          const int e = i * H + h0 + k;
          m.route_s[e] = (unsigned short)l[u][k];
          if (v[u].active) {
            atomicAdd(&m.lcur_s[l[u][k]], 1);
            atomicAdd(&m.scur_s[m.dom_s[l[u][k]] * J + v[u].job], 1);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < NT_VIEWS; ++u) {
      const int i = b + 32 * u + lane;
      if (i < w1) {
        if (v[u].active) atomicMin(&m.jobmin_s[v[u].job], v[u].iwire);
        a.ws_wire[i] = v[u].iwire;
        a.ws_f[i] = v[u].ichunk;
        m.flags_s[i] = v[u].active ? F_ACTIVE : 0;
      }
      wact += __popc(__ballot_sync(0xffffffffu, v[u].active));
    }
    if (a.iroute_o) {   // the warp's routes, copied out in coalesced rows
      __syncwarp();
      const int e1 = min(b + 32 * NT_VIEWS, w1) * H;
      for (int e = b * H + lane; e < e1; e += 32) a.iroute_o[e] = m.route_s[e];
    }
  }
  if (lane == 0) m.wcnt_s[warp] = wact;
  __syncthreads();

  // ---- phase 2: strict-priority class (the job's oldest active step);
  //      the active list, in ascending order; row counts -> offsets.  The
  //      list goes to the entry list's unused tail when the A x H entries
  //      leave room for it, else to the global workspace.
  int n_act = 0, at = 0;
  for (int w = 0; w < NT_WARPS; ++w) {
    if (w == warp) at = n_act;
    n_act += m.wcnt_s[w];
  }
  const int E2 = (FW * H + 1) & ~1;
  unsigned short* act =
      n_act * (H + 1) <= E2 ? m.list_s + (E2 - n_act) : m.act;
  for (int b = w0; b < w1; b += 32) {
    const int i = b + lane;
    bool active = false;
    if (i < w1) {
      const unsigned char f = m.flags_s[i];
      active = f & F_ACTIVE;
      if (active && a.ws_wire[i] <= m.jobmin_s[s.inst_job[i]])
        m.flags_s[i] = f | F_HI;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, active);
    if (active) act[at + __popc(bal & lt)] = (unsigned short)i;
    at += __popc(bal);
  }
  block_offsets(m.lcur_s, m.loff_s, L1, m.wsum_s);
  block_offsets(m.scur_s, m.soff_s, DJ, m.wsum_s);

  // ---- phase 3: the active entries sorted by link row; each row's
  //      offered load added over its segment in order; link scales,
  //      queues and RED
  //      The Symphony entries are sorted at the same time, by warp 1, into
  //      the buffer after the link entries when both lists and the active
  //      list fit, else in phase 5.
  const bool both = n_act * (2 * H + 1) <= E2;
  unsigned short* slist = both ? m.list_s + n_act * H : m.list_s;
  auto sym_key = [&](int i, int hh) {
    return m.dom_s[m.route_s[i * H + hh]] * J + s.inst_job[i];
  };
  if (warp == 0)
    place_entries(act, n_act, H, m.lcur_s, m.list_s,
                  [&](int i, int hh) { return (int)m.route_s[i * H + hh]; });
  else if (warp == 1 && both)
    place_entries(act, n_act, H, m.scur_s, slist, sym_key);
  __syncthreads();
  for (int r = tid; r < L1; r += nt) {
    const int p0 = m.loff_s[r], p1 = m.loff_s[r + 1];
    if (p1 - p0 > NT_LONG) continue;
    float sp = 0.0f, shi = 0.0f, slo = 0.0f;
#pragma unroll 4
    for (int p = p0; p < p1; ++p) {
      const int i = m.list_s[p];
      const float v = a.rate[i];
      sp += v;
      if (m.flags_s[i] & F_HI) shi += v; else slo += v;
    }
    link_row(a, m, r, L1, gate, dt, sp, shi, slo);
  }
  long_rows(m.loff_s, L1, [&](int r) {
    const int p0 = m.loff_s[r], p1 = m.loff_s[r + 1];
    float sp = 0.0f, shi = 0.0f, slo = 0.0f;
    for (int p = p0; p < p1; p += 32 * NT_GATHER) {
      int i[NT_GATHER];
      float v[NT_GATHER];
#pragma unroll
      for (int g = 0; g < NT_GATHER; ++g) {
        const int q = p + 32 * g + lane;
        i[g] = q < p1 ? m.list_s[q] : -1;
        v[g] = i[g] >= 0 ? a.rate[i[g]] : 0.0f;
      }
#pragma unroll
      for (int g = 0; g < NT_GATHER; ++g) {
        const int n = min(32, p1 - p - 32 * g);
        const unsigned his = __ballot_sync(
            0xffffffffu, i[g] >= 0 && (m.flags_s[i[g]] & F_HI));
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float x = __shfl_sync(0xffffffffu, v[g], j);
          if (j < n) {
            sp += x;
            if ((his >> j) & 1u) shi += x; else slo += x;
          }
        }
      }
    }
    if (lane == 0) link_row(a, m, r, L1, gate, dt, sp, shi, slo);
  });
  __syncthreads();

  // ---- phase 4: delivered rate, completions, Symphony step-min
  //      candidates.  An inactive instance's rate counts as 0, so it
  //      delivers eff = 0 * (a share <= 1) = 0 and sends 0 packets.
  for (int i = tid; i < FW; i += nt) {
    if (m.flags_s[i] & F_ACTIVE) continue;
    a.eff_o[i] = 0.0f;
    a.ws_f[i] = 0.0f;
  }
  for (int k = tid; k < n_act; k += nt) {
    const int i = act[k];
    unsigned char f = m.flags_s[i];
    const bool is_hi = f & F_HI;
    const float w_rate = a.rate[i];
    const float ichunk = a.ws_f[i];
    const float isent = a.sent[i];
    const int iwire = a.ws_wire[i];
    const int job = s.inst_job[i];
    float mp = 0.0f, mq = 0.0f;
    for (int hh = 0; hh < H; ++hh) {
      const int l = m.route_s[i * H + hh];
      const float vp = m.sl_s[l];
      const float vq = is_hi ? m.shi_s[l] : fminf(1.0f, m.slo_s[l]);
      mp = hh == 0 ? vp : fminf(mp, vp);
      mq = hh == 0 ? vq : fminf(mq, vq);
    }
    const float eff = gate ? w_rate * mq : w_rate * mp;
    const float pkts = eff * dt / mtu;
    const bool done = isent + eff * dt >= ichunk;
    const bool send = eff > 1.0f;
    a.eff_o[i] = eff;
    a.ws_f[i] = pkts;
    m.flags_s[i] = f | (done ? F_DONE : 0) | (send ? F_SEND : 0);
    for (int hh = 0; hh < H; ++hh) {
      const int dj = m.dom_s[m.route_s[i * H + hh]] * J + job;
      if (done) atomicMax(&m.cand_s[dj], iwire + 1);
      else atomicMin(&m.minact_s[dj], iwire);
    }
  }
  __syncthreads();

  // ---- phase 5: the active entries sorted by Symphony row, unless phase
  //      3 did (the link list's buffer reused); each row's counters added
  //      over its segment in order
  if (!both) {
    if (warp == 0) place_entries(act, n_act, H, m.scur_s, slist, sym_key);
    __syncthreads();
  }
  const bool sym_epoch = floormod(tick, a.sym_win) == a.sym_win - 1;
  for (int r = tid; r < DJ; r += nt) {
    const int p0 = m.soff_s[r], p1 = m.soff_s[r + 1];
    if (p1 - p0 > NT_LONG) continue;
    SymRow y = sym_begin(a, m, r);
#pragma unroll 4
    for (int p = p0; p < p1; ++p) {
      const int i = slist[p];
      const float pkts = a.ws_f[i];
      const int iwire = a.ws_wire[i];
      y.cnt += pkts;
      if (iwire > y.smin_in) y.cntop += pkts;
      y.psn = fmaxf(y.psn, sym_psn(m.flags_s[i], a.sent[i], iwire, pkts,
                                   y.stepmin, mtu));
    }
    sym_end(a, r, y, sym_epoch);
  }
  long_rows(m.soff_s, DJ, [&](int r) {
    const int p0 = m.soff_s[r], p1 = m.soff_s[r + 1];
    SymRow y = sym_begin(a, m, r);
    float psn = -INFINITY;
    for (int p = p0; p < p1; p += 32 * NT_GATHER) {
      int i[NT_GATHER], iwire[NT_GATHER];
      float pkts[NT_GATHER], isent[NT_GATHER];
#pragma unroll
      for (int g = 0; g < NT_GATHER; ++g) {
        const int q = p + 32 * g + lane;
        i[g] = q < p1 ? slist[q] : -1;
        pkts[g] = i[g] >= 0 ? a.ws_f[i[g]] : 0.0f;
        iwire[g] = i[g] >= 0 ? a.ws_wire[i[g]] : 0;
        isent[g] = i[g] >= 0 ? a.sent[i[g]] : 0.0f;
      }
#pragma unroll
      for (int g = 0; g < NT_GATHER; ++g) {
        const int n = min(32, p1 - p - 32 * g);
        const unsigned ops =
            __ballot_sync(0xffffffffu, i[g] >= 0 && iwire[g] > y.smin_in);
        if (i[g] >= 0)
          psn = fmaxf(psn, sym_psn(m.flags_s[i[g]], isent[g], iwire[g],
                                   pkts[g], y.stepmin, mtu));
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float x = __shfl_sync(0xffffffffu, pkts[g], j);
          if (j < n) {
            y.cnt += x;
            if ((ops >> j) & 1u) y.cntop += x;
          }
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1)
      psn = fmaxf(psn, __shfl_xor_sync(0xffffffffu, psn, o));
    y.psn = fmaxf(y.psn, psn);
    if (lane == 0) sym_end(a, r, y, sym_epoch);
  });
}
