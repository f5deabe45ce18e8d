// Fused netsim engine tick for Hopper (sm_90a), one thread block per lane.
//
// Replaces the TPU kernel src/repro/kernels/netsim_tick/kernel.py:339
// (_tick_kernel, body hot_tick at kernel.py:189) in segsum="scatter" mode:
// the instance view, per-step ECMP route hash, proportional and
// strict-priority bandwidth shares (selected per lane by pq_on), queue
// integration + RED, and the Symphony per-(domain, job) state update.  The
// plain torch version is ../ref.py::hot_tick; the wrapper is ../kernel.py.
//
// What bounds it.  At the Table-1 shape (F=32, W=64, FW=2048, H=4, L+1=97)
// one tick moves about 115 KB: the FW-sized step/sent/rate inputs and six
// index arrays in, iroute [FW,4] and eff out.  At 3.35 TB/s that is about
// 35 ns, far below a kernel launch.  The work is a chain of dependent
// reductions (job min-wire -> link scales -> eff -> Symphony step-min ->
// psn window), so the kernel is launch- and latency-bound, not bound by
// bytes or operations.  Launch cost is what the multi-tick window kernel of
// the next slice of the port amortizes.
//
// What the design does about it.  It keeps everything a tick reduces over on
// chip: the [L+1] link rows, [DJ] Symphony rows and [J] job rows, the
// per-(instance, hop) link ids (uint16) and per-instance flag bits all live
// in shared memory, so one launch runs the whole dependent chain with
// __syncthreads() between phases and touches device memory only for the
// tick's true inputs and outputs.  Lanes (seeds, knob points) are blocks.
//
// Exactness.  The float sums (offered load per link, Symphony cnt/cntop)
// must add in ascending flat (instance, hop) order, the order of XLA's CPU
// scatter and of torch's CPU index_add_.  So there are no float atomics:
// one thread per target row walks the active instances in order and adds
// its row's entries one by one.  Integer min/max (job min-wire, step-min
// candidates) and the float max of non-negative psn values are order-free
// and use shared-memory atomics.  Build with --fmad=false so that a*b+c
// rounds twice, as the eager op sequence does.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT_BIG (1 << 30)
#define NT_WIRE_SEG 4096
#define NT_THREADS 512

struct TickArgs {
  const int* step; const float* sent; const float* rate;
  const int* done_upto; const float* q_prev;
  const int* s_stepmin; const float* s_psnwin; const float* s_alpha;
  const float* s_cnt; const float* s_cntop;
  const int* routes; const int* path_table; const int* n_paths;
  const float* cap; const int* link_dom; const float* bg_base;
  const float* bg_amp;
  const int* inst_job; const int* inst_flow; const int* sps;
  const int* phase; const int* nph; const int* off;
  const float* chunk_sched; const int* iscal; const float* fscal;
  int* iroute_o; float* eff_o; float* offered_o; float* q_o; float* p_red_o;
  int* smin_o; float* spsn_o; float* salpha_o; float* scnt_o;
  float* scntop_o;
  int* ws_wire; float* ws_f;
  int F, W, H, P, L1, J, SEG, DJ;
  float dt, mtu;
  int per_step_ecmp, policy_pq;
};

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

// flag bits per instance
#define F_ACTIVE 1
#define F_HI 2
#define F_DONE 4
#define F_SEND 8

__global__ void __launch_bounds__(NT_THREADS)
netsim_tick_kernel(TickArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int F = a.F, H = a.H, L1 = a.L1, J = a.J, DJ = a.DJ;
  const int FW = F * a.W;
  const int E = FW * H;

  float* cap_s = reinterpret_cast<float*>(smem);
  float* bg_s = cap_s + L1;
  float* sl_s = bg_s + L1;
  float* shi_s = sl_s + L1;
  float* slo_s = shi_s + L1;
  int* dom_s = reinterpret_cast<int*>(slo_s + L1);
  int* jobmin_s = dom_s + L1;
  int* cand_s = jobmin_s + J;
  int* minact_s = cand_s + DJ;
  unsigned short* route_s = reinterpret_cast<unsigned short*>(minact_s + DJ);
  unsigned char* flags_s =
      reinterpret_cast<unsigned char*>(route_s + ((E + 1) & ~1));

  const size_t bFW = (size_t)b * FW;
  const int* iscal = a.iscal + b * 5;
  const float* fscal = a.fscal + b * 7;
  const int tick = iscal[0], seed = iscal[1], bg_period = iscal[2];
  const int sym_win = iscal[3], pq_on = iscal[4];
  const float bg_duty = fscal[0], red_kmin = fscal[1], red_kmax = fscal[2];
  const float red_pmax = fscal[3], tau = fscal[4], n_sample = fscal[5];
  const float alpha_max = fscal[6];
  const bool gate = a.policy_pq || (pq_on != 0);
  const float dt = a.dt, mtu = a.mtu;

  // ---- phase 0: link rows, background load, reduction identities
  const bool bg_on =
      (float)floormod(tick, bg_period) < bg_duty * (float)bg_period;
  for (int r = tid; r < L1; r += nt) {
    cap_s[r] = a.cap[b * L1 + r];
    dom_s[r] = a.link_dom[b * L1 + r];
    bg_s[r] = a.bg_base[b * L1 + r] + (bg_on ? a.bg_amp[b * L1 + r] : 0.0f);
  }
  for (int j = tid; j < J; j += nt) jobmin_s[j] = NT_BIG;
  for (int r = tid; r < DJ; r += nt) {
    cand_s[r] = 0;
    minact_s[r] = NT_BIG;
  }
  __syncthreads();

  // ---- phase 1: instance view, route selection, job min-wire
  for (int i = tid; i < FW; i += nt) {
    const int istep = a.step[bFW + i];
    const float isent = a.sent[bFW + i];
    const int job = a.inst_job[i], flow = a.inst_flow[i];
    const int sps = a.sps[i];
    const int iseg = floordiv(istep, sps) * a.nph[i] + a.phase[i];
    const int segc = min(max(iseg, 0), a.SEG - 1);
    const float ichunk = a.chunk_sched[job * a.SEG + segc];
    const int iwire = iseg * NT_WIRE_SEG + floormod(istep, sps) + a.off[i];
    const bool occupied = istep >= 0;
    const bool retired = occupied && istep < a.done_upto[b * F + flow];
    const bool complete = occupied && isent >= ichunk;
    const bool active = occupied && !complete && !retired;
    const int* row;
    if (a.per_step_ecmp) {
      uint32_t h = (uint32_t)flow * 2654435761u +
                   (uint32_t)max(istep, 0) * 40503u +
                   ((uint32_t)seed + 1u) * 2246822519u;
      h = (h ^ (h >> 13)) * 2654435761u;
      h = h ^ (h >> 16);
      const uint32_t np = (uint32_t)a.n_paths[b * F + flow];
      const int choice = (int)(h % np);
      row = a.path_table + (((size_t)b * F + flow) * a.P + choice) * H;
    } else {
      row = a.routes + ((size_t)b * F + flow) * H;
    }
    for (int hh = 0; hh < H; ++hh) {
      const int l = row[hh];
      a.iroute_o[(bFW + i) * H + hh] = l;
      route_s[i * H + hh] = (unsigned short)l;
    }
    if (active) atomicMin(&jobmin_s[job], iwire);
    a.ws_wire[bFW + i] = iwire;
    a.ws_f[bFW + i] = ichunk;
    flags_s[i] = active ? F_ACTIVE : 0;
  }
  __syncthreads();

  // ---- phase 2: strict-priority class (the job's oldest active step)
  for (int i = tid; i < FW; i += nt) {
    if ((flags_s[i] & F_ACTIVE) &&
        a.ws_wire[bFW + i] <= jobmin_s[a.inst_job[i]])
      flags_s[i] |= F_HI;
  }
  __syncthreads();

  // ---- phase 3: offered load per link, in ascending (instance, hop) order;
  //      link scales, queues and RED
  for (int r = tid; r < L1; r += nt) {
    float sp = 0.0f, shi = 0.0f, slo = 0.0f;
    for (int i = 0; i < FW; ++i) {
      const unsigned char f = flags_s[i];
      if (!(f & F_ACTIVE)) continue;
      for (int hh = 0; hh < H; ++hh) {
        if (route_s[i * H + hh] != r) continue;
        const float v = a.rate[bFW + i];
        sp += v;
        if (f & F_HI) shi += v; else slo += v;
      }
    }
    const float c = cap_s[r], bg = bg_s[r];
    const float off_p = sp + bg;
    const float s_l = fminf(1.0f, c / fmaxf(off_p, 1.0f));
    const float off_hi = shi + bg;
    const float s_hi = fminf(1.0f, c / fmaxf(off_hi, 1.0f));
    const float rem = fmaxf(c - off_hi * s_hi, 0.0f);
    const float off_lo = slo;
    const float s_lo = rem / fmaxf(off_lo, 1.0f);
    const float offered = gate ? off_hi + off_lo : off_p;
    float q = fmaxf(a.q_prev[b * L1 + r] + (offered - c) * dt, 0.0f);
    if (r == L1 - 1) q = 0.0f;
    const float p_red =
        fminf(fmaxf((q - red_kmin) / (red_kmax - red_kmin), 0.0f), 1.0f) *
        red_pmax;
    a.offered_o[b * L1 + r] = offered;
    a.q_o[b * L1 + r] = q;
    a.p_red_o[b * L1 + r] = p_red;
    sl_s[r] = s_l;
    shi_s[r] = s_hi;
    slo_s[r] = s_lo;
  }
  __syncthreads();

  // ---- phase 4: delivered rate, completions, Symphony step-min candidates
  for (int i = tid; i < FW; i += nt) {
    unsigned char f = flags_s[i];
    const bool active = f & F_ACTIVE;
    const bool is_hi = f & F_HI;
    const float w_rate = active ? a.rate[bFW + i] : 0.0f;
    float mp = 0.0f, mq = 0.0f;
    for (int hh = 0; hh < H; ++hh) {
      const int l = route_s[i * H + hh];
      const float vp = sl_s[l];
      const float vq = is_hi ? shi_s[l] : fminf(1.0f, slo_s[l]);
      mp = hh == 0 ? vp : fminf(mp, vp);
      mq = hh == 0 ? vq : fminf(mq, vq);
    }
    const float eff = gate ? w_rate * mq : w_rate * mp;
    a.eff_o[bFW + i] = eff;
    const float ichunk = a.ws_f[bFW + i];
    const float pkts = eff * dt / mtu;
    const bool done = active && (a.sent[bFW + i] + eff * dt >= ichunk);
    const bool send = active && (eff > 1.0f);
    f |= (done ? F_DONE : 0) | (send ? F_SEND : 0);
    flags_s[i] = f;
    a.ws_f[bFW + i] = pkts;
    if (!active) continue;
    const int iwire = a.ws_wire[bFW + i];
    const int job = a.inst_job[i];
    for (int hh = 0; hh < H; ++hh) {
      const int dj = dom_s[route_s[i * H + hh]] * J + job;
      if (done) atomicMax(&cand_s[dj], iwire + 1);
      else atomicMin(&minact_s[dj], iwire);
    }
  }
  __syncthreads();

  // ---- phase 5: Symphony rows, each walked in ascending (instance, hop)
  //      order by one thread
  const bool sym_epoch = floormod(tick, sym_win) == sym_win - 1;
  for (int r = tid; r < DJ; r += nt) {
    const int smin_in = a.s_stepmin[b * DJ + r];
    const int cand = max(smin_in, cand_s[r]);
    const int ma = minact_s[r];
    const int stepmin = ma < NT_BIG ? min(cand, ma) : cand;
    float cnt = a.s_cnt[b * DJ + r];
    float cntop = a.s_cntop[b * DJ + r];
    float psn = a.s_psnwin[b * DJ + r];
    for (int i = 0; i < FW; ++i) {
      const unsigned char f = flags_s[i];
      if (!(f & F_ACTIVE)) continue;
      const int job = a.inst_job[i];
      for (int hh = 0; hh < H; ++hh) {
        if (dom_s[route_s[i * H + hh]] * J + job != r) continue;
        const float pkts = a.ws_f[bFW + i];
        const int iwire = a.ws_wire[bFW + i];
        cnt += pkts;
        if (iwire > smin_in) cntop += pkts;
        if ((f & F_SEND) && !(f & F_DONE) && iwire == stepmin)
          psn = fmaxf(psn, a.sent[bFW + i] / mtu + pkts);
      }
    }
    const bool have = cnt > n_sample;
    const bool exceed = cntop >= tau * cnt;
    const float step = (exceed ? 1.0f : -1.0f) * (have ? 1.0f : 0.0f);
    const float alpha_in = a.s_alpha[b * DJ + r];
    const float alpha_new = fminf(fmaxf(alpha_in + step, 1.0f), alpha_max);
    a.smin_o[b * DJ + r] = stepmin;
    a.spsn_o[b * DJ + r] = sym_epoch ? 0.0f : psn;
    a.salpha_o[b * DJ + r] = sym_epoch ? alpha_new : alpha_in;
    a.scnt_o[b * DJ + r] = sym_epoch ? 0.0f : cnt;
    a.scntop_o[b * DJ + r] = sym_epoch ? 0.0f : cntop;
  }
}

extern "C" size_t netsim_tick_smem_bytes(int FW, int H, int L1, int J,
                                         int DJ) {
  const size_t E = (size_t)FW * H;
  return (size_t)5 * L1 * 4 + (size_t)L1 * 4 + (size_t)J * 4 +
         (size_t)2 * DJ * 4 + ((E + 1) & ~(size_t)1) * 2 + (size_t)FW;
}

extern "C" int netsim_tick_launch(
    const int* step, const float* sent, const float* rate,
    const int* done_upto, const float* q_prev,
    const int* s_stepmin, const float* s_psnwin, const float* s_alpha,
    const float* s_cnt, const float* s_cntop,
    const int* routes, const int* path_table, const int* n_paths,
    const float* cap, const int* link_dom, const float* bg_base,
    const float* bg_amp,
    const int* inst_job, const int* inst_flow, const int* sps,
    const int* phase, const int* nph, const int* off,
    const float* chunk_sched, const int* iscal, const float* fscal,
    int* iroute_o, float* eff_o, float* offered_o, float* q_o,
    float* p_red_o, int* smin_o, float* spsn_o, float* salpha_o,
    float* scnt_o, float* scntop_o, int* ws_wire, float* ws_f,
    int B, int F, int W, int H, int P, int L1, int J, int SEG, int DJ,
    float dt, float mtu, int per_step_ecmp, int policy_pq, void* stream) {
  TickArgs a;
  a.step = step; a.sent = sent; a.rate = rate; a.done_upto = done_upto;
  a.q_prev = q_prev; a.s_stepmin = s_stepmin; a.s_psnwin = s_psnwin;
  a.s_alpha = s_alpha; a.s_cnt = s_cnt; a.s_cntop = s_cntop;
  a.routes = routes; a.path_table = path_table; a.n_paths = n_paths;
  a.cap = cap; a.link_dom = link_dom; a.bg_base = bg_base; a.bg_amp = bg_amp;
  a.inst_job = inst_job; a.inst_flow = inst_flow; a.sps = sps;
  a.phase = phase; a.nph = nph; a.off = off; a.chunk_sched = chunk_sched;
  a.iscal = iscal; a.fscal = fscal;
  a.iroute_o = iroute_o; a.eff_o = eff_o; a.offered_o = offered_o;
  a.q_o = q_o; a.p_red_o = p_red_o; a.smin_o = smin_o; a.spsn_o = spsn_o;
  a.salpha_o = salpha_o; a.scnt_o = scnt_o; a.scntop_o = scntop_o;
  a.ws_wire = ws_wire; a.ws_f = ws_f;
  a.F = F; a.W = W; a.H = H; a.P = P; a.L1 = L1; a.J = J; a.SEG = SEG;
  a.DJ = DJ; a.dt = dt; a.mtu = mtu; a.per_step_ecmp = per_step_ecmp;
  a.policy_pq = policy_pq;
  const size_t smem = netsim_tick_smem_bytes(F * W, H, L1, J, DJ);
  cudaError_t err = cudaFuncSetAttribute(
      netsim_tick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  netsim_tick_kernel<<<B, NT_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
