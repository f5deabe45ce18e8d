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
// Exactness.  The float sums (offered load per link, Symphony cnt/cntop)
// must add in ascending flat (instance, hop) order, the order of XLA's CPU
// scatter and of torch's CPU index_add_.  So there are no float atomics:
// one thread per target row walks the active instances in order and adds
// its row's entries one by one.  Integer min/max (job min-wire, step-min
// candidates) and the float max of non-negative psn values are order-free
// and use shared-memory atomics.  Build with --fmad=false so that a*b+c
// rounds twice, as the eager op sequence does.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NT_BIG (1 << 30)
#define NT_I32MAX 2147483647
#define NT_WIRE_SEG 4096
#define NT_THREADS 512

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

// Scratch of hot_tick.  The link, job and Symphony rows always live in
// shared memory.  The per-(instance, hop) link ids and the per-instance
// flags live there too when they fit; a lane whose ids do not fit (256
// hosts and up at window 64) keeps them in a global-memory workspace of
// hot_ids_bytes() per lane instead.  The walks read them in the same order
// either way, so where they live changes no result.
struct HotSmem {
  float* cap_s; float* bg_s; float* sl_s; float* shi_s; float* slo_s;
  int* dom_s; int* jobmin_s; int* cand_s; int* minact_s;
  unsigned short* route_s;   // [FW*H] link id of each (instance, hop)
  unsigned char* flags_s;    // [FW] F_* bits
};

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// Bytes of the rows: five link rows, the link domains, the job row and two
// Symphony rows.
__host__ __device__ inline size_t hot_rows_bytes(int L1, int J, int DJ) {
  return ((size_t)6 * L1 + J + (size_t)2 * DJ) * 4;
}

// Bytes of one lane's link ids (uint16, padded to an even count) and flags.
__host__ __device__ inline size_t hot_ids_raw(int FW, int H) {
  const size_t E = (size_t)FW * H;
  return ((E + 1) & ~(size_t)1) * 2 + (size_t)FW;
}

// A lane's stride in the global ids workspace.
__host__ __device__ inline size_t hot_ids_bytes(int FW, int H) {
  return round16(hot_ids_raw(FW, H));
}

// Shared bytes of hot_tick's scratch, rounded up to 16 so that more scratch
// can follow: the rows, and the ids right after them when ids_in_smem.
__host__ __device__ inline size_t hot_smem_bytes(int FW, int H, int L1,
                                                 int J, int DJ,
                                                 int ids_in_smem) {
  return round16(hot_rows_bytes(L1, J, DJ) +
                 (ids_in_smem ? hot_ids_raw(FW, H) : 0));
}

// Carve the scratch from the block's shared memory.  With IDS_SMEM the ids
// follow the rows there; otherwise they live in ids_ws, this lane's global
// workspace of hot_ids_bytes().  The choice is a template parameter so that
// each kernel instantiation knows the ids' address space at compile time.
// The ids start right after the last row, derived from its int pointer:
// starting them at a 16-byte boundary instead measured 21-25 % slower for
// the single-tick kernel on the H100 (PERF.md).
template <bool IDS_SMEM>
__device__ __forceinline__ HotSmem hot_smem_carve(unsigned char* base,
                                                  const HotDims& d,
                                                  unsigned char* ids_ws) {
  HotSmem m;
  const int L1 = d.L1, E = d.F * d.W * d.H;
  m.cap_s = reinterpret_cast<float*>(base);
  m.bg_s = m.cap_s + L1;
  m.sl_s = m.bg_s + L1;
  m.shi_s = m.sl_s + L1;
  m.slo_s = m.shi_s + L1;
  m.dom_s = reinterpret_cast<int*>(m.slo_s + L1);
  m.jobmin_s = m.dom_s + L1;
  m.cand_s = m.jobmin_s + d.J;
  m.minact_s = m.cand_s + d.DJ;
  unsigned char* ids =
      IDS_SMEM ? reinterpret_cast<unsigned char*>(m.minact_s + d.DJ)
               : ids_ws;
  m.route_s = reinterpret_cast<unsigned short*>(ids);
  m.flags_s = reinterpret_cast<unsigned char*>(m.route_s + ((E + 1) & ~1));
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

__device__ void hot_tick(const HotLane& a, const HotDims& d,
                         const HotShared& s, const HotSmem& m) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int F = d.F, H = d.H, L1 = d.L1, J = d.J, DJ = d.DJ;
  const int FW = F * d.W;
  const int tick = a.tick;
  const bool gate = d.policy_pq || (a.pq_on != 0);
  const float dt = d.dt, mtu = d.mtu;

  // ---- phase 0: link rows, background load, reduction identities
  const bool bg_on =
      (float)floormod(tick, a.bg_period) < a.bg_duty * (float)a.bg_period;
  for (int r = tid; r < L1; r += nt) {
    m.cap_s[r] = a.cap[r];
    m.dom_s[r] = a.link_dom[r];
    m.bg_s[r] = a.bg_base[r] + (bg_on ? a.bg_amp[r] : 0.0f);
  }
  for (int j = tid; j < J; j += nt) m.jobmin_s[j] = NT_BIG;
  for (int r = tid; r < DJ; r += nt) {
    m.cand_s[r] = 0;
    m.minact_s[r] = NT_BIG;
  }
  __syncthreads();

  // ---- phase 1: instance view, route selection, job min-wire
  for (int i = tid; i < FW; i += nt) {
    const int istep = a.step[i];
    const float isent = a.sent[i];
    const int job = s.inst_job[i], flow = s.inst_flow[i];
    const int sps = s.sps[i];
    const int iseg = floordiv(istep, sps) * s.nph[i] + s.phase[i];
    const int segc = min(max(iseg, 0), d.SEG - 1);
    const float ichunk = s.chunk_sched[job * d.SEG + segc];
    const int iwire = iseg * NT_WIRE_SEG + floormod(istep, sps) + s.off[i];
    const bool occupied = istep >= 0;
    const bool retired = occupied && istep < a.done_upto[flow];
    const bool complete = occupied && isent >= ichunk;
    const bool active = occupied && !complete && !retired;
    const int* row;
    if (d.per_step_ecmp) {
      uint32_t h = (uint32_t)flow * 2654435761u +
                   (uint32_t)max(istep, 0) * 40503u +
                   ((uint32_t)a.seed + 1u) * 2246822519u;
      h = (h ^ (h >> 13)) * 2654435761u;
      h = h ^ (h >> 16);
      const uint32_t np = (uint32_t)a.n_paths[flow];
      const int choice = (int)(h % np);
      row = a.path_table + ((size_t)flow * d.P + choice) * H;
    } else {
      row = a.routes + (size_t)flow * H;
    }
    for (int hh = 0; hh < H; ++hh) {
      const int l = row[hh];
      if (a.iroute_o) a.iroute_o[(size_t)i * H + hh] = l;
      m.route_s[i * H + hh] = (unsigned short)l;
    }
    if (active) atomicMin(&m.jobmin_s[job], iwire);
    a.ws_wire[i] = iwire;
    a.ws_f[i] = ichunk;
    m.flags_s[i] = active ? F_ACTIVE : 0;
  }
  __syncthreads();

  // ---- phase 2: strict-priority class (the job's oldest active step)
  for (int i = tid; i < FW; i += nt) {
    if ((m.flags_s[i] & F_ACTIVE) && a.ws_wire[i] <= m.jobmin_s[s.inst_job[i]])
      m.flags_s[i] |= F_HI;
  }
  __syncthreads();

  // ---- phase 3: offered load per link, in ascending (instance, hop) order;
  //      link scales, queues and RED
  for (int r = tid; r < L1; r += nt) {
    float sp = 0.0f, shi = 0.0f, slo = 0.0f;
    for (int i = 0; i < FW; ++i) {
      const unsigned char f = m.flags_s[i];
      if (!(f & F_ACTIVE)) continue;
      for (int hh = 0; hh < H; ++hh) {
        if (m.route_s[i * H + hh] != r) continue;
        const float v = a.rate[i];
        sp += v;
        if (f & F_HI) shi += v; else slo += v;
      }
    }
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
  __syncthreads();

  // ---- phase 4: delivered rate, completions, Symphony step-min candidates
  for (int i = tid; i < FW; i += nt) {
    unsigned char f = m.flags_s[i];
    const bool active = f & F_ACTIVE;
    const bool is_hi = f & F_HI;
    const float w_rate = active ? a.rate[i] : 0.0f;
    float mp = 0.0f, mq = 0.0f;
    for (int hh = 0; hh < H; ++hh) {
      const int l = m.route_s[i * H + hh];
      const float vp = m.sl_s[l];
      const float vq = is_hi ? m.shi_s[l] : fminf(1.0f, m.slo_s[l]);
      mp = hh == 0 ? vp : fminf(mp, vp);
      mq = hh == 0 ? vq : fminf(mq, vq);
    }
    const float eff = gate ? w_rate * mq : w_rate * mp;
    a.eff_o[i] = eff;
    const float ichunk = a.ws_f[i];
    const float pkts = eff * dt / mtu;
    const bool done = active && (a.sent[i] + eff * dt >= ichunk);
    const bool send = active && (eff > 1.0f);
    f |= (done ? F_DONE : 0) | (send ? F_SEND : 0);
    m.flags_s[i] = f;
    a.ws_f[i] = pkts;
    if (!active) continue;
    const int iwire = a.ws_wire[i];
    const int job = s.inst_job[i];
    for (int hh = 0; hh < H; ++hh) {
      const int dj = m.dom_s[m.route_s[i * H + hh]] * J + job;
      if (done) atomicMax(&m.cand_s[dj], iwire + 1);
      else atomicMin(&m.minact_s[dj], iwire);
    }
  }
  __syncthreads();

  // ---- phase 5: Symphony rows, each walked in ascending (instance, hop)
  //      order by one thread
  const bool sym_epoch = floormod(tick, a.sym_win) == a.sym_win - 1;
  for (int r = tid; r < DJ; r += nt) {
    const int smin_in = a.s_stepmin[r];
    const int cand = max(smin_in, m.cand_s[r]);
    const int ma = m.minact_s[r];
    const int stepmin = ma < NT_BIG ? min(cand, ma) : cand;
    float cnt = a.s_cnt[r];
    float cntop = a.s_cntop[r];
    float psn = a.s_psnwin[r];
    for (int i = 0; i < FW; ++i) {
      const unsigned char f = m.flags_s[i];
      if (!(f & F_ACTIVE)) continue;
      const int job = s.inst_job[i];
      for (int hh = 0; hh < H; ++hh) {
        if (m.dom_s[m.route_s[i * H + hh]] * J + job != r) continue;
        const float pkts = a.ws_f[i];
        const int iwire = a.ws_wire[i];
        cnt += pkts;
        if (iwire > smin_in) cntop += pkts;
        if ((f & F_SEND) && !(f & F_DONE) && iwire == stepmin)
          psn = fmaxf(psn, a.sent[i] / mtu + pkts);
      }
    }
    const bool have = cnt > a.n_sample;
    const bool exceed = cntop >= a.tau * cnt;
    const float step = (exceed ? 1.0f : -1.0f) * (have ? 1.0f : 0.0f);
    const float alpha_in = a.s_alpha[r];
    const float alpha_new = fminf(fmaxf(alpha_in + step, 1.0f), a.alpha_max);
    a.smin_o[r] = stepmin;
    a.spsn_o[r] = sym_epoch ? 0.0f : psn;
    a.salpha_o[r] = sym_epoch ? alpha_new : alpha_in;
    a.scnt_o[r] = sym_epoch ? 0.0f : cnt;
    a.scntop_o[r] = sym_epoch ? 0.0f : cntop;
  }
}
