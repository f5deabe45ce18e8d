// Multi-tick netsim window for Hopper (sm_90a): n whole engine ticks per
// launch, one thread block per simulation lane.
//
// Replaces the TPU kernel src/repro/kernels/netsim_tick/window.py:64
// (_window_kernel, pallas_call at window.py:180), entered through
// ops.engine_window_fused, in segsum="scatter" mode with the proportional
// and pq share policies (and the per-lane pq_on gate).  The plain torch
// version is ../ref.py::window_ref (n staged eager ticks); the wrapper is
// ../window.py.
//
// Each loop iteration replays the eager tick in stages.py order:
// stage_starts, the hot stages (hot_tick() of netsim_hot.cuh, the same code
// the single-tick kernel runs), stage_marking with Symphony's marking
// probability, stage_progress, stage_rate_control (DCQCN, with the
// threefry2x32 coin flips of jax.random in legacy mode drawn in the
// kernel), stage_segments (with dependency-triggered release), and
// stage_metrics on the window's last tick only.  Lanes never interact, so
// no grid-wide synchronisation is needed: __syncthreads() separates the
// stages.
//
// What bounds it.  A window reads each state, table and knob operand once
// and writes each state and sample output once (a few MB at 128 hosts x 8
// lanes: well under a millisecond at 3.35 TB/s).  Like the single-tick
// kernel, a tick is a chain of dependent reductions inside one block, so
// the kernel is latency-bound, not bound by bytes or operations.  What it
// removes is the host: one launch per window instead of one fused kernel
// and ~300 torch kernels per tick.
//
// What the design does about it.  Link rows, Symphony rows (two copies: the
// marking stage reads the tick's old rows while the hot stages write the
// new ones), job rows, the per-(instance, hop) uint16 link ids and the
// entry list live in shared memory; a lane whose ids do not fit there (256
// hosts and up at window 64) keeps the ids, list and flags in a per-lane
// global workspace.  The hot stages add each link and Symphony row over
// its own segment of a stably row-sorted list of the tick's active entries
// (netsim_hot.cuh), so their cost follows the active instances, not the
// F x W instance slots.  The per-instance state ([F, W] arrays, 229 KB a
// lane at 128 hosts x window 64) does not fit beside them, so it stays in
// global memory: the block copies its lane's input state to the output
// buffers once and then updates the outputs in place across the loop
// (L2-resident).
//
// Exactness.  Float sums keep the single-tick kernel's ascending (instance,
// hop) order within each row (stable entry lists) with no float atomics;
// log1pf/expf (never __expf) and --fmad=false keep torch's roundings.  The
// host-side shortcuts of the eager tick (the Symphony marking skipped
// before any lane's sym_from, the DCQCN draw skipped when no lane's epoch
// fires) become per-lane tests here; both only skip values that would be
// discarded.  The per-job throughput sample is a block reduction whose
// order differs from torch's sum(dim=2), so it agrees to rounding, not
// bitwise.

#include <stddef.h>

#include "netsim_hot.cuh"

// Per-lane knob rows: iscal [B, WIN_NI] and fscal [B, WIN_NF].  The first
// 5 ints and 7 floats are the single-tick kernel's (minus the tick).
#define WIN_NI 8   // seed, bg_period, sym_win, pq_on, cc_epoch, cc_fr,
                   // sym_on, sym_start
#define WIN_NF 13  // bg_duty, red_kmin, red_kmax, red_pmax, tau, n_sample,
                   // alpha_max, cc_g, cc_rai, cc_rhai, cc_min_rate, k,
                   // n_warmup

struct WinArgs {
  // engine state in, lane axis first (stages.EngineState order)
  const int* next_step_i; const int* done_upto_i; const int* finish_i;
  const int* step_of_i; const float* sent_i; const float* rate_i;
  const float* target_i; const float* alpha_cc_i; const int* stage_i;
  const float* lam_i; const float* q_i;
  const int* s_stepmin_i; const float* s_psnwin_i; const float* s_alpha_i;
  const float* s_cnt_i; const float* s_cntop_i;
  const int* seg_idx_i; const int* seg_ready_i; const int* job_finish_i;
  const long long* key_i;
  // engine state out
  int* next_step; int* done_upto; int* finish;
  int* step_of; float* sent; float* rate; float* target; float* alpha_cc;
  int* stage; float* lam; float* q;
  int* s_stepmin; float* s_psnwin; float* s_alpha; float* s_cnt;
  float* s_cntop;
  int* seg_idx; int* seg_ready; int* job_finish;
  long long* key;
  // workload, shared by every lane: [F] per flow slot, [J] per job
  const int* pred; const int* job; const int* phase; const int* sps;
  const int* pass_steps; const int* total_steps; const int* n_phases;
  const int* n_segs; const float* chunk_sched; const int* gap_ticks;
  const int* fstart_ticks; const int* trig_job; const int* trig_seg;
  const int* trig_delay;
  // per-instance index arrays, shared by every lane: [FW]
  const int* inst_job; const int* inst_flow; const int* sps_i;
  const int* phase_i; const int* nph_i; const int* off_i;
  // per-lane static arrays and knobs
  const int* routes; const int* path_table; const int* n_paths;
  const float* cap; const int* link_dom; const float* bg_base;
  const float* bg_amp; const int* iscal; const float* fscal;
  // sample of the window's last tick
  int* min_wire_o; int* max_wire_o; int* done_min_o; float* tput_o;
  float* qmax_o; float* amax_o;
  // workspaces [B, FW]
  int* ws_wire; float* ws_f; float* ws_eff;
  // [B, hot_ws_bytes]: each lane's active list, then its link ids, entry
  // list and flags when they do not fit in shared memory beside the rows
  unsigned char* ids_ws;
  int base_tick, n;
  HotDims d;
};

// Bytes of the window's own rows: two sets of Symphony rows, the RED
// profile, a flag per flow, six job rows and a float per warp.
__host__ __device__ inline size_t win_rows_bytes(int F, int L1, int J,
                                                 int DJ) {
  return (size_t)10 * DJ * 4 + (size_t)L1 * 4 + (size_t)F * 4 +
         (size_t)6 * J * 4 + 32 * 4;
}

// Bytes of shared memory one lane needs: hot_tick's scratch, then the
// window's own rows.
__host__ __device__ inline size_t win_smem_bytes(int F, int FW, int H,
                                                 int L1, int J, int DJ,
                                                 int ids_in_smem) {
  return hot_smem_bytes(FW, H, L1, J, DJ, ids_in_smem) +
         win_rows_bytes(F, L1, J, DJ);
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// The 20-round threefry2x32 block function, as jax.random computes it.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// Sum of v over the block (valid on thread 0); red holds one float a warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// IDS_SMEM: the lane's link ids, entry list and flags live in shared memory
// (else in a.ids_ws, after its active list).  One block an SM (one lane,
// most of the SM's shared memory) lets ptxas use 128 registers a thread;
// without the 1 it kept to 64, and the window kernel spilled.
template <bool IDS_SMEM>
__global__ void __launch_bounds__(NT_THREADS, 1)
netsim_window_kernel(WinArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const HotDims d = a.d;
  const int F = d.F, W = d.W, H = d.H, L1 = d.L1, J = d.J, DJ = d.DJ;
  const int SEG = d.SEG;
  const int FW = F * W;
  const int D = DJ / J - 1;   // Symphony domains; D is "none"

  // ---- shared memory
  unsigned char* ws = a.ids_ws + (size_t)b * hot_ws_bytes(FW, H, IDS_SMEM);
  const HotSmem m = hot_smem_carve<IDS_SMEM>(smem, d, ws);
  int* sym_i = reinterpret_cast<int*>(
      smem + hot_smem_bytes(FW, H, L1, J, DJ, IDS_SMEM));
  int* smin_a = sym_i;
  float* psn_a = reinterpret_cast<float*>(smin_a + DJ);
  float* alpha_a = psn_a + DJ;
  float* cnt_a = alpha_a + DJ;
  float* cntop_a = cnt_a + DJ;
  int* smin_b = reinterpret_cast<int*>(cntop_a + DJ);
  float* psn_b = reinterpret_cast<float*>(smin_b + DJ);
  float* alpha_b = psn_b + DJ;
  float* cnt_b = alpha_b + DJ;
  float* cntop_b = cnt_b + DJ;
  float* p_red_s = cntop_b + DJ;
  int* can_s = reinterpret_cast<int*>(p_red_s + L1);
  int* jobdone_s = can_s + F;
  int* segnew_s = jobdone_s + J;
  int* ready_s = segnew_s + J;
  int* minw_s = ready_s + J;
  int* maxw_s = minw_s + J;
  int* dmin_s = maxw_s + J;
  float* red_s = reinterpret_cast<float*>(dmin_s + J);

  // ---- this lane's state: copy in -> out once, then update in place
  const size_t bF = (size_t)b * F, bFW = (size_t)b * FW;
  const size_t bL = (size_t)b * L1, bJ = (size_t)b * J, bDJ = (size_t)b * DJ;
  int* step = a.step_of + bFW;
  float* sent = a.sent + bFW;
  float* rate = a.rate + bFW;
  float* target = a.target + bFW;
  float* alpha_cc = a.alpha_cc + bFW;
  int* stage = a.stage + bFW;
  float* lam = a.lam + bFW;
  int* next_step = a.next_step + bF;
  int* done_upto = a.done_upto + bF;
  int* finish = a.finish + bF;
  float* q = a.q + bL;
  int* seg_idx = a.seg_idx + bJ;
  int* seg_ready = a.seg_ready + bJ;
  int* job_finish = a.job_finish + bJ;
  for (int i = tid; i < FW; i += nt) {
    step[i] = a.step_of_i[bFW + i];
    sent[i] = a.sent_i[bFW + i];
    rate[i] = a.rate_i[bFW + i];
    target[i] = a.target_i[bFW + i];
    alpha_cc[i] = a.alpha_cc_i[bFW + i];
    stage[i] = a.stage_i[bFW + i];
    lam[i] = a.lam_i[bFW + i];
  }
  for (int f = tid; f < F; f += nt) {
    next_step[f] = a.next_step_i[bF + f];
    done_upto[f] = a.done_upto_i[bF + f];
    finish[f] = a.finish_i[bF + f];
  }
  for (int r = tid; r < L1; r += nt) q[r] = a.q_i[bL + r];
  for (int j = tid; j < J; j += nt) {
    seg_idx[j] = a.seg_idx_i[bJ + j];
    seg_ready[j] = a.seg_ready_i[bJ + j];
    job_finish[j] = a.job_finish_i[bJ + j];
  }
  for (int r = tid; r < DJ; r += nt) {
    smin_a[r] = a.s_stepmin_i[bDJ + r];
    psn_a[r] = a.s_psnwin_i[bDJ + r];
    alpha_a[r] = a.s_alpha_i[bDJ + r];
    cnt_a[r] = a.s_cnt_i[bDJ + r];
    cntop_a[r] = a.s_cntop_i[bDJ + r];
  }
  uint32_t key0 = (uint32_t)a.key_i[b * 2], key1 = (uint32_t)a.key_i[b * 2 + 1];

  // ---- knobs and statics of this lane
  const int* iscal = a.iscal + b * WIN_NI;
  const float* fscal = a.fscal + b * WIN_NF;
  const int cc_epoch = iscal[4], cc_fr = iscal[5], sym_on = iscal[6];
  const int sym_start = iscal[7];
  const float cc_g = fscal[7], cc_rai = fscal[8], cc_rhai = fscal[9];
  const float cc_min_rate = fscal[10], sym_k = fscal[11];
  const float n_warmup = fscal[12];
  const int* routes = a.routes + bF * H;
  const float* cap = a.cap + bL;

  HotShared hs;
  hs.inst_job = a.inst_job; hs.inst_flow = a.inst_flow; hs.sps = a.sps_i;
  hs.phase = a.phase_i; hs.nph = a.nph_i; hs.off = a.off_i;
  hs.chunk_sched = a.chunk_sched;

  HotLane h;
  h.step = step; h.sent = sent; h.rate = rate; h.done_upto = done_upto;
  h.q_prev = q;
  h.routes = routes;
  h.path_table = a.path_table + bF * (d.P > 0 ? d.P : 0) * H;
  h.n_paths = a.n_paths + bF;
  h.cap = cap; h.link_dom = a.link_dom + bL;
  h.bg_base = a.bg_base + bL; h.bg_amp = a.bg_amp + bL;
  h.iroute_o = nullptr;
  h.eff_o = a.ws_eff + bFW;
  h.offered_o = nullptr;
  h.q_o = q;
  h.p_red_o = p_red_s;
  h.ws_wire = a.ws_wire + bFW;
  h.ws_f = a.ws_f + bFW;
  h.seed = iscal[0]; h.bg_period = iscal[1]; h.sym_win = iscal[2];
  h.pq_on = iscal[3];
  h.bg_duty = fscal[0]; h.red_kmin = fscal[1]; h.red_kmax = fscal[2];
  h.red_pmax = fscal[3]; h.tau = fscal[4]; h.n_sample = fscal[5];
  h.alpha_max = fscal[6];
  const int* ws_wire = h.ws_wire;
  const float* ws_f = h.ws_f;
  const float* ws_eff = h.eff_o;
  const float dt = d.dt, mtu = d.mtu;
  __syncthreads();

  bool cur_a = true;   // which Symphony row set holds the current state
  for (int t = 0; t < a.n; ++t) {
    const int tick = a.base_tick + t;
    const bool last = t == a.n - 1;
    int* smin_c = cur_a ? smin_a : smin_b;
    float* psn_c = cur_a ? psn_a : psn_b;
    float* alpha_c = cur_a ? alpha_a : alpha_b;
    float* cnt_c = cur_a ? cnt_a : cnt_b;
    float* cntop_c = cur_a ? cntop_a : cntop_b;
    int* smin_n = cur_a ? smin_b : smin_a;
    float* psn_n = cur_a ? psn_b : psn_a;
    float* alpha_n = cur_a ? alpha_b : alpha_a;
    float* cnt_n = cur_a ? cnt_b : cnt_a;
    float* cntop_n = cur_a ? cntop_b : cntop_a;

    // ---- stage_starts, 1: which flows start their next step (reads only)
    for (int j = tid; j < J; j += nt) {
      jobdone_s[j] = 1;
      minw_s[j] = NT_BIG;
      maxw_s[j] = -1;
      dmin_s[j] = NT_BIG;
    }
    for (int f = tid; f < F; f += nt) {
      const int jb = a.job[f], pr = a.pred[f];
      const int sps = a.sps[f], ph = a.phase[f], nph = a.n_phases[jb];
      const int s_next = next_step[f];
      const int seg_of_next = floordiv(s_next, sps) * nph + ph;
      const bool seg_ok = seg_of_next == seg_idx[jb] && tick >= seg_ready[jb];
      const bool boundary = floormod(s_next, a.pass_steps[f]) == 0;
      const int w_prev = floormod(s_next - 1, W);
      const int ps_prev = step[(size_t)pr * W + w_prev];
      const float sent_prev = sent[(size_t)pr * W + w_prev];
      const int seg_prev = floordiv(s_next - 1, sps) * nph + ph;
      const float prev_chunk =
          a.chunk_sched[jb * SEG + min(max(seg_prev, 0), SEG - 1)];
      const int done_pred = done_upto[pr];
      const bool pred_prev_done =
          done_pred >= s_next || ps_prev > s_next - 1 ||
          (ps_prev == s_next - 1 && sent_prev >= prev_chunk);
      const bool pass_done = done_upto[f] >= s_next && done_pred >= s_next;
      bool ring_ok = boundary ? (s_next == 0 || pass_done) : pred_prev_done;
      ring_ok = ring_ok && tick >= a.fstart_ticks[f];
      const int slot = step[(size_t)f * W + floormod(s_next, W)];
      const bool slot_free = slot < 0 || slot < done_upto[f];
      can_s[f] = s_next < a.total_steps[f] && seg_ok && ring_ok && slot_free;
    }
    __syncthreads();
    // ---- stage_starts, 2: initialise the started slots
    for (int f = tid; f < F; f += nt) {
      if (!can_s[f]) continue;
      const int s_next = next_step[f];
      const size_t k = (size_t)f * W + floormod(s_next, W);
      const float lr = cap[routes[(size_t)f * H]];
      step[k] = s_next;
      sent[k] = 0.0f;
      rate[k] = lr;
      target[k] = lr;
      alpha_cc[k] = 1.0f;
      stage[k] = 0;
      lam[k] = 0.0f;
      next_step[f] = s_next + 1;
    }
    __syncthreads();

    // ---- the hot stages: instance view, shares, queues + RED, Symphony
    h.tick = tick;
    h.s_stepmin = smin_c; h.s_psnwin = psn_c; h.s_alpha = alpha_c;
    h.s_cnt = cnt_c; h.s_cntop = cntop_c;
    h.smin_o = smin_n; h.spsn_o = psn_n; h.salpha_o = alpha_n;
    h.scnt_o = cnt_n; h.scntop_o = cntop_n;
    hot_tick(h, d, hs, m);
    __syncthreads();

    // ---- stage_marking, byte progress and stage_rate_control, one
    //      instance at a time; the coin flips come in threefry pairs
    //      (instances p and p + half share one block-function call)
    const bool sym_gate = sym_on != 0 && tick >= sym_start;
    const bool cc_fire = floormod(tick, cc_epoch) == cc_epoch - 1;
    uint32_t sub0 = 0, sub1 = 0;
    if (cc_fire) {   // split(key): new key from counters (0,2), (1,3)
      uint32_t a0 = 0, a1 = 2, b0 = 1, b1 = 3;
      threefry2x32(key0, key1, a0, a1);
      threefry2x32(key0, key1, b0, b1);
      key0 = a0; key1 = b0;
      sub0 = a1; sub1 = b1;
    }
    const int half = (FW + 1) / 2;
    for (int p = tid; p < half; p += nt) {
      uint32_t y[2] = {0u, 0u};
      if (cc_fire) {
        y[0] = (uint32_t)p;
        y[1] = ((FW & 1) && p == half - 1) ? 0u : (uint32_t)(half + p);
        threefry2x32(sub0, sub1, y[0], y[1]);
      }
      for (int e = 0; e < 2; ++e) {
        const int i = p + e * half;
        if (i >= FW) break;
        const bool active = m.flags_s[i] & F_ACTIVE;
        const int iwire = ws_wire[i];
        const float isent = sent[i];
        const float ipsn = isent / mtu;
        const float pkts = ws_f[i];
        const float eff = ws_eff[i];
        const int job = a.inst_job[i];
        float log_nomark = 0.0f;
        for (int hh = 0; hh < H; ++hh) {
          const int l = m.route_s[i * H + hh];
          const int dom = m.dom_s[l];
          const int dj = dom * J + job;
          float p_sym = 0.0f;
          const float pw = psn_c[dj];
          if (iwire > smin_c[dj] && pw > n_warmup) {
            const float delta = alpha_c[dj] * (ipsn / fmaxf(pw, 1.0f));
            p_sym = fminf(sym_k * delta, 1.0f);
          }
          if (dom >= D || !sym_gate) p_sym = 0.0f;
          const float no_mark = (1.0f - p_red_s[l]) * (1.0f - p_sym);
          const float p_hop = 1.0f - no_mark;
          const float term = log1pf(-fminf(p_hop, 0.999999f));
          log_nomark = hh == 0 ? term : log_nomark + term;
        }
        const float p_inst = 1.0f - expf(log_nomark);
        const float lam_m = lam[i] + (active ? p_inst * pkts : 0.0f);
        sent[i] = isent + eff * dt;
        if (!cc_fire) {
          lam[i] = lam_m;
          continue;
        }
        const uint32_t bits = y[e];
        const float u = fmaxf(
            __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f, 0.0f);
        const bool cut = (u < 1.0f - expf(-lam_m)) && step[i] >= 0;
        const float r0 = rate[i], t0 = target[i], a0 = alpha_cc[i];
        const int s0 = stage[i];
        const float lr = cap[routes[(size_t)a.inst_flow[i] * H]];
        const float r_c = fmaxf(r0 * (1.0f - a0 / 2.0f), cc_min_rate);
        const float t_c = s0 > 0 ? r0 : t0;
        const float a_c = (1.0f - cc_g) * a0 + cc_g;
        const float a_n = (1.0f - cc_g) * a0;
        const int stage_n = s0 + 1;
        const float tgt_inc =
            stage_n > cc_fr ? (stage_n > 2 * cc_fr ? cc_rhai : cc_rai) : 0.0f;
        const float t_n = fminf(t0 + tgt_inc, lr);
        const float r_n = fminf((r0 + t_n) / 2.0f, lr);
        rate[i] = cut ? r_c : r_n;
        target[i] = cut ? t_c : t_n;
        alpha_cc[i] = cut ? a_c : a_n;
        stage[i] = cut ? 0 : stage_n;
        lam[i] = 0.0f;
      }
    }
    __syncthreads();

    // ---- stage_progress: in-order retirement per flow, finish ticks; and
    //      each flow's share of its job's segment barrier
    for (int f = tid; f < F; f += nt) {
      const int jb = a.job[f];
      const int sps = a.sps[f], ph = a.phase[f], nph = a.n_phases[jb];
      int du = done_upto[f];
      for (int rep = 0; rep < 2; ++rep) {
        const size_t k = (size_t)f * W + floormod(du, W);
        const int seg = floordiv(du, sps) * nph + ph;
        const float ch = a.chunk_sched[jb * SEG + min(max(seg, 0), SEG - 1)];
        if (step[k] == du && sent[k] >= ch) du += 1;
      }
      done_upto[f] = du;
      if (du >= a.total_steps[f] && finish[f] == NT_I32MAX) finish[f] = tick;
      const int sj = seg_idx[jb];
      const bool participating = ph == floormod(sj, nph);
      const int c_end = (floordiv(sj, nph) + 1) * sps;
      if (participating && du < c_end) atomicMin(&jobdone_s[jb], 0);
    }
    __syncthreads();

    // ---- stage_segments: advance each job's barrier, then release the
    //      jobs whose trigger job has advanced far enough
    for (int j = tid; j < J; j += nt) {
      const int sj = seg_idx[j], rdy = seg_ready[j];
      const bool adv = jobdone_s[j] > 0 && sj < a.n_segs[j] && tick >= rdy;
      const int sn = sj + (adv ? 1 : 0);
      const bool phase0 = floormod(sn, a.n_phases[j]) == 0;
      segnew_s[j] = sn;
      ready_s[j] = adv ? tick + (phase0 ? a.gap_ticks[j] : 0) : rdy;
      if (sn >= a.n_segs[j] && job_finish[j] == NT_I32MAX) job_finish[j] = tick;
    }
    __syncthreads();
    for (int j = tid; j < J; j += nt) {
      const int tj = a.trig_job[j];
      const int src = min(max(tj, 0), J - 1);
      const bool fired = tj >= 0 && seg_ready[j] == NT_I32MAX &&
                         segnew_s[src] >= a.trig_seg[j];
      seg_ready[j] = fired ? tick + a.trig_delay[j] + a.gap_ticks[j]
                           : ready_s[j];
      seg_idx[j] = segnew_s[j];
    }
    __syncthreads();

    // ---- stage_metrics on the window's last tick
    if (last) {
      for (int i = tid; i < FW; i += nt) {
        if (!(m.flags_s[i] & F_ACTIVE)) continue;
        const int jb = a.inst_job[i];
        atomicMin(&minw_s[jb], ws_wire[i]);
        atomicMax(&maxw_s[jb], ws_wire[i]);
      }
      for (int f = tid; f < F; f += nt) atomicMin(&dmin_s[a.job[f]],
                                                  done_upto[f]);
      for (int j = 0; j < J; ++j) {
        float v = 0.0f;
        for (int i = tid; i < FW; i += nt)
          if (a.inst_job[i] == j) v += ws_eff[i];
        const float tot = block_sum(v, red_s);
        if (tid == 0) a.tput_o[bJ + j] = tot;
      }
      __syncthreads();
      for (int j = tid; j < J; j += nt) {
        a.min_wire_o[bJ + j] = minw_s[j];
        a.max_wire_o[bJ + j] = maxw_s[j];
        a.done_min_o[bJ + j] = dmin_s[j];
      }
      if (tid == 0) {
        float qm = q[0];
        for (int r = 1; r < L1 - 1; ++r) qm = fmaxf(qm, q[r]);
        float am = alpha_n[0];
        for (int r = 1; r < DJ; ++r) am = fmaxf(am, alpha_n[r]);
        a.qmax_o[b] = qm;
        a.amax_o[b] = am;
      }
    }
    cur_a = !cur_a;
  }

  // ---- write back the Symphony rows and the PRNG key
  const int* smin_c = cur_a ? smin_a : smin_b;
  const float* psn_c = cur_a ? psn_a : psn_b;
  const float* alpha_c = cur_a ? alpha_a : alpha_b;
  const float* cnt_c = cur_a ? cnt_a : cnt_b;
  const float* cntop_c = cur_a ? cntop_a : cntop_b;
  for (int r = tid; r < DJ; r += nt) {
    a.s_stepmin[bDJ + r] = smin_c[r];
    a.s_psnwin[bDJ + r] = psn_c[r];
    a.s_alpha[bDJ + r] = alpha_c[r];
    a.s_cnt[bDJ + r] = cnt_c[r];
    a.s_cntop[bDJ + r] = cntop_c[r];
  }
  if (tid == 0) {
    a.key[b * 2] = (long long)key0;
    a.key[b * 2 + 1] = (long long)key1;
  }
}

// Elementwise expf / log1pf of the kernel library, so that a caller can
// hold the kernel's transcendentals against torch's on the card.
__global__ void netsim_math_kernel(const float* x, float* exp_o,
                                   float* log1p_o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    exp_o[i] = expf(x[i]);
    log1p_o[i] = log1pf(x[i]);
  }
}

extern "C" size_t netsim_window_smem_bytes(int F, int FW, int H, int L1,
                                           int J, int DJ, int ids_in_smem) {
  return win_smem_bytes(F, FW, H, L1, J, DJ, ids_in_smem);
}

// ptrs: the WinArgs pointers in declaration order (N_WIN_PTRS of them);
// dims: B, F, W, H, P, L1, J, SEG, DJ, per_step_ecmp, policy_pq,
// base_tick, n, ids_in_smem; fdims: dt, mtu.
#define N_WIN_PTRS 79
static_assert(offsetof(WinArgs, base_tick) == N_WIN_PTRS * sizeof(void*),
              "WinArgs must start with its N_WIN_PTRS pointers");
extern "C" int netsim_window_launch(void** ptrs, const int* dims,
                                    const float* fdims, void* stream) {
  WinArgs a;
  void** slot = reinterpret_cast<void**>(&a);
  for (int k = 0; k < N_WIN_PTRS; ++k) slot[k] = ptrs[k];
  const int B = dims[0];
  a.d.F = dims[1]; a.d.W = dims[2]; a.d.H = dims[3]; a.d.P = dims[4];
  a.d.L1 = dims[5]; a.d.J = dims[6]; a.d.SEG = dims[7]; a.d.DJ = dims[8];
  a.d.per_step_ecmp = dims[9]; a.d.policy_pq = dims[10];
  a.base_tick = dims[11]; a.n = dims[12];
  const int ids_in_smem = dims[13];
  a.d.dt = fdims[0]; a.d.mtu = fdims[1];
  // instance and link ids are uint16
  if (a.d.F * a.d.W > 65536 || a.d.L1 > 65536)
    return (int)cudaErrorInvalidValue;
  const size_t smem = win_smem_bytes(a.d.F, a.d.F * a.d.W, a.d.H, a.d.L1,
                                     a.d.J, a.d.DJ, ids_in_smem);
  void (*kernel)(WinArgs) = ids_in_smem ? netsim_window_kernel<true>
                                        : netsim_window_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, NT_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int netsim_math_launch(const float* x, float* exp_o,
                                  float* log1p_o, int n, void* stream) {
  netsim_math_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      x, exp_o, log1p_o, n);
  return (int)cudaGetLastError();
}
