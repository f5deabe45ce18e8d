// Symphony's switch data plane (paper Alg. 1) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/switch_pipeline/kernel.py:42
// (_pipeline_kernel, pallas_call at kernel.py:129), entered through
// switch_pipeline().  The plain torch version is ../ref.py::pipeline_plain;
// the wrapper is ../kernel.py.
//
// A switch processes one packet a cycle through stateful ALUs: the Per-Job
// State Block (step_min, psn_rec, alpha, Cnt_total, Cnt_op) after packet i
// depends on every packet before it.  So one thread walks the batch in
// order, carrying the block in registers, exactly as the reference's
// fori_loop does over its SMEM scratch.  The marking probability keeps the
// reference kernel's float order, ((k * alpha) * psn) / max(psn_rec, 1);
// exact=0 is the ASIC path: log2-domain compare through a 16-entry mantissa
// LUT, floor(log2f(x)) for the exponent and x / exp2f(e) for the mantissa.
// Built with --fmad=false; no expression here contracts into an FMA anyway.
//
// What bounds it.  Each packet reads 20 bytes and writes 16: at 1,000,000
// packets, 36 MB, about 11 us at 3.35 TB/s.  The walk is a chain of
// dependent float compares and selects a packet long, on one thread: the
// kernel is latency-bound by that chain, not by bytes or operations.
// What the design does about it: the block's 256 threads stage tiles of
// the inputs into shared memory and write the outputs back coalesced, so
// the walking thread reads and writes shared memory only.

#define SP_THREADS 256
#define SP_TILE 1024

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

__global__ void __launch_bounds__(SP_THREADS)
switch_pipeline_kernel(const int* steps, const float* psns, const int* lasts,
                       const int* wins, const float* us,
                       int* marks_o, int* smin_o, float* prec_o,
                       float* alpha_o, int P, float k, float tau,
                       float n_warmup, float n_sample, float alpha_max,
                       int exact) {
  __shared__ int step_s[SP_TILE], last_s[SP_TILE], win_s[SP_TILE];
  __shared__ float psn_s[SP_TILE], u_s[SP_TILE];
  __shared__ int mark_s[SP_TILE], smin_s[SP_TILE];
  __shared__ float prec_s[SP_TILE], alpha_s[SP_TILE];
  const int tid = threadIdx.x;
  // the state block, carried by thread 0 across tiles
  float step_min = 0.0f, psn_rec = 0.0f, alpha = 1.0f, cnt = 0.0f;
  float cnt_op = 0.0f;
  for (int t0 = 0; t0 < P; t0 += SP_TILE) {
    const int n = min(SP_TILE, P - t0);
    for (int j = tid; j < n; j += SP_THREADS) {
      step_s[j] = steps[t0 + j];
      psn_s[j] = psns[t0 + j];
      last_s[j] = lasts[t0 + j];
      win_s[j] = wins[t0 + j];
      u_s[j] = us[t0 + j];
    }
    __syncthreads();
    if (tid == 0) {
      for (int j = 0; j < n; ++j) {
        const float step = (float)step_s[j];
        const float psn = psn_s[j];
        const float u = u_s[j];
        // UpdateTrafficStats against the state before this packet
        const bool is_op = step > step_min;
        cnt = cnt + 1.0f;
        cnt_op = cnt_op + (is_op ? 1.0f : 0.0f);
        // marking decision against the found state (Alg. 1 l.11-17)
        const bool outpacing = is_op && (psn_rec > n_warmup);
        bool mark;
        if (exact) {
          const float p = fminf(1.0f, k * alpha * psn / fmaxf(psn_rec, 1.0f));
          mark = outpacing && (u < p);
        } else {
          const float lp = lut_log2(k) + lut_log2(alpha) +
                           lut_log2(fmaxf(psn, 1.0f)) -
                           lut_log2(fmaxf(psn_rec, 1.0f));
          mark = outpacing && (lut_log2(fmaxf(u, 1e-9f)) < lp);
        }
        // progress tracking (Alg. 1 l.3-10)
        const bool lt = step < step_min, eq = step == step_min;
        if (last_s[j] > 0) {
          step_min = step + 1.0f;
          psn_rec = 0.0f;
        } else if (lt) {
          step_min = step;
          psn_rec = psn;
        } else if (eq) {
          psn_rec = fmaxf(psn_rec, psn);
        }
        // T_win boundary: Eq. 5 integer test + windowed psn reset
        if (win_s[j] > 0) {
          const bool have = cnt > n_sample;
          const bool exceed = cnt_op >= tau * cnt;
          const float d = (exceed ? 1.0f : -1.0f) * (have ? 1.0f : 0.0f);
          alpha = fminf(fmaxf(alpha + d, 1.0f), alpha_max);
          cnt = 0.0f;
          cnt_op = 0.0f;
          psn_rec = 0.0f;
        }
        mark_s[j] = mark ? 1 : 0;
        smin_s[j] = (int)step_min;
        prec_s[j] = psn_rec;
        alpha_s[j] = alpha;
      }
    }
    __syncthreads();
    for (int j = tid; j < n; j += SP_THREADS) {
      marks_o[t0 + j] = mark_s[j];
      smin_o[t0 + j] = smin_s[j];
      prec_o[t0 + j] = prec_s[j];
      alpha_o[t0 + j] = alpha_s[j];
    }
    __syncthreads();
  }
}

extern "C" int switch_pipeline_launch(
    const int* steps, const float* psns, const int* lasts, const int* wins,
    const float* us, int* marks_o, int* smin_o, float* prec_o,
    float* alpha_o, int P, float k, float tau, float n_warmup,
    float n_sample, float alpha_max, int exact, void* stream) {
  switch_pipeline_kernel<<<1, SP_THREADS, 0, (cudaStream_t)stream>>>(
      steps, psns, lasts, wins, us, marks_o, smin_o, prec_o, alpha_o, P, k,
      tau, n_warmup, n_sample, alpha_max, exact);
  return (int)cudaGetLastError();
}
