// Fused netsim engine tick for Hopper (sm_90a), one thread block per lane.
//
// Replaces the TPU kernel src/repro/kernels/netsim_tick/kernel.py:339
// (_tick_kernel, body hot_tick at kernel.py:189) in segsum="scatter" mode.
// The tick's hot stages are hot_tick() in netsim_hot.cuh, which the
// multi-tick window kernel (netsim_window.cu) runs too.  The plain torch
// version is ../ref.py::hot_tick; the wrapper is ../kernel.py.
//
// What bounds it.  At the Table-1 shape (F=32, W=64, FW=2048, H=4, L+1=97)
// one tick moves about 115 KB: the FW-sized step/sent/rate inputs and six
// index arrays in, iroute [FW,4] and eff out.  At 3.35 TB/s that is about
// 35 ns, far below a kernel launch.  The work is a chain of dependent
// reductions (job min-wire -> link scales -> eff -> Symphony step-min ->
// psn window), so the kernel is launch- and latency-bound, not bound by
// bytes or operations.  The window kernel (netsim_window.cu) amortizes the
// launch over many ticks; this kernel stays the tick_window=1 path.
//
// What the design does about it.  It keeps everything a tick reduces over on
// chip: the [L+1] link rows, [DJ] Symphony rows and [J] job rows, the
// per-(instance, hop) link ids (uint16), the entry list sorted by row and
// the per-instance flag bits all live in shared memory, so one launch runs
// the whole dependent chain with __syncthreads() between phases.  The
// float sums touch only the tick's active entries: the active instances
// (one per flow mid-run, against W per flow) are compacted in order, their
// entries stably counting-sorted by row, and each row adds its own segment
// (netsim_hot.cuh), so a row costs its own entries, not a walk over all
// F x W instances.  Lanes (seeds, knob points) are blocks.  Where a lane's
// ids do not fit (256 hosts and up at window 64) they and the entry list go
// to the per-lane global workspace the wrapper allocates, read through
// L1/L2, after the active list, which lives there at every size.

#include "netsim_hot.cuh"

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
  unsigned char* ids_ws;  // [B, hot_ws_bytes]: active list (+ ids)
  HotDims d;
};

// IDS_SMEM: the lane's link ids, entry list and flags live in shared memory
// (else in a.ids_ws, after its active list).  One block an SM (one lane,
// most of the SM's shared memory) lets ptxas use 128 registers a thread;
// without the 1 it kept to 64, and the window kernel spilled.
template <bool IDS_SMEM>
__global__ void __launch_bounds__(NT_THREADS, 1)
netsim_tick_kernel(TickArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const HotDims d = a.d;
  const int F = d.F, H = d.H, L1 = d.L1, DJ = d.DJ;
  const size_t FW = (size_t)F * d.W;
  const size_t bFW = (size_t)b * FW;
  const int* iscal = a.iscal + b * 5;
  const float* fscal = a.fscal + b * 7;

  HotLane h;
  h.step = a.step + bFW; h.sent = a.sent + bFW; h.rate = a.rate + bFW;
  h.done_upto = a.done_upto + (size_t)b * F;
  h.q_prev = a.q_prev + (size_t)b * L1;
  h.s_stepmin = a.s_stepmin + (size_t)b * DJ;
  h.s_psnwin = a.s_psnwin + (size_t)b * DJ;
  h.s_alpha = a.s_alpha + (size_t)b * DJ;
  h.s_cnt = a.s_cnt + (size_t)b * DJ;
  h.s_cntop = a.s_cntop + (size_t)b * DJ;
  h.routes = a.routes + (size_t)b * F * H;
  h.path_table = a.path_table + (size_t)b * F * (d.P > 0 ? d.P : 0) * H;
  h.n_paths = a.n_paths + (size_t)b * F;
  h.cap = a.cap + (size_t)b * L1;
  h.link_dom = a.link_dom + (size_t)b * L1;
  h.bg_base = a.bg_base + (size_t)b * L1;
  h.bg_amp = a.bg_amp + (size_t)b * L1;
  h.iroute_o = a.iroute_o + bFW * H;
  h.eff_o = a.eff_o + bFW;
  h.offered_o = a.offered_o + (size_t)b * L1;
  h.q_o = a.q_o + (size_t)b * L1;
  h.p_red_o = a.p_red_o + (size_t)b * L1;
  h.smin_o = a.smin_o + (size_t)b * DJ;
  h.spsn_o = a.spsn_o + (size_t)b * DJ;
  h.salpha_o = a.salpha_o + (size_t)b * DJ;
  h.scnt_o = a.scnt_o + (size_t)b * DJ;
  h.scntop_o = a.scntop_o + (size_t)b * DJ;
  h.ws_wire = a.ws_wire + bFW;
  h.ws_f = a.ws_f + bFW;
  h.tick = iscal[0]; h.seed = iscal[1]; h.bg_period = iscal[2];
  h.sym_win = iscal[3]; h.pq_on = iscal[4];
  h.bg_duty = fscal[0]; h.red_kmin = fscal[1]; h.red_kmax = fscal[2];
  h.red_pmax = fscal[3]; h.tau = fscal[4]; h.n_sample = fscal[5];
  h.alpha_max = fscal[6];

  HotShared s;
  s.inst_job = a.inst_job; s.inst_flow = a.inst_flow; s.sps = a.sps;
  s.phase = a.phase; s.nph = a.nph; s.off = a.off;
  s.chunk_sched = a.chunk_sched;

  unsigned char* ws =
      a.ids_ws + (size_t)b * hot_ws_bytes((int)FW, H, IDS_SMEM);
  hot_tick(h, d, s, hot_smem_carve<IDS_SMEM>(smem, d, ws));
}

// Shared bytes one block needs; the global workspace takes hot_ws_bytes()
// per lane (the ids too when ids_in_smem is 0).
extern "C" size_t netsim_tick_smem_bytes(int FW, int H, int L1, int J,
                                         int DJ, int ids_in_smem) {
  return hot_smem_bytes(FW, H, L1, J, DJ, ids_in_smem);
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
    unsigned char* ids_ws,
    int B, int F, int W, int H, int P, int L1, int J, int SEG, int DJ,
    float dt, float mtu, int per_step_ecmp, int policy_pq, int ids_in_smem,
    void* stream) {
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
  a.ids_ws = ids_ws;
  a.d.F = F; a.d.W = W; a.d.H = H; a.d.P = P; a.d.L1 = L1; a.d.J = J;
  a.d.SEG = SEG; a.d.DJ = DJ; a.d.dt = dt; a.d.mtu = mtu;
  a.d.per_step_ecmp = per_step_ecmp; a.d.policy_pq = policy_pq;
  // instance and link ids are uint16
  if (F * W > 65536 || L1 > 65536) return (int)cudaErrorInvalidValue;
  const size_t smem =
      netsim_tick_smem_bytes(F * W, H, L1, J, DJ, ids_in_smem);
  void (*kernel)(TickArgs) = ids_in_smem ? netsim_tick_kernel<true>
                                         : netsim_tick_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, NT_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
