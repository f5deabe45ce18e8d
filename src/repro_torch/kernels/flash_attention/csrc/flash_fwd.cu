// Flash attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the reference's Pallas `_fwd_kernel`
// (src/repro/kernels/flash_attention/kernel.py:44): causal softmax attention
// with an optional sliding window (kpos > qpos - window) and GQA (query head
// h reads KV head h / (Hq / Hkv)), returning o in q's dtype and
// lse = m + log(max(l, 1e-30)) in float32, with scale 1/sqrt(D).
//
// What bounds it: at the prefill shapes it is bound by operations
// (4 * D flops per visible (query, key) pair against ~2 * D * 2 bytes per
// key row read once), so the design keeps every tile on chip: one block per
// (64-row query tile, head, batch row) walks the key tiles that the causal
// mask and the window leave visible (tiles wholly outside the window are
// skipped, which the reference does not do), with K and V tiles in shared
// memory and the online softmax and the output accumulator in float32
// registers.
//
// Two instantiations:
//   * bf16: four warps, each owning 16 query rows; Q K^T and P V on the
//     tensor cores with mma.sync m16n8k16 (bf16 in, float32 accumulate),
//     P rounded to bf16 between the two products.
//   * float32: 256 threads, four per query row, CUDA-core FMAs; every sum
//     is float32 throughout (the checks hold it to 2e-5).
// Head dims are padded in shared memory to 64 or 128 (D = 120 -> 128); any
// D that is a multiple of 8 up to 128 is taken.  Inputs are read through
// strides, so [B, S, H, D] activations need no copy to [B*H, S, D].
//
// A row whose first visited tile is fully masked takes p = exp(0) there,
// and the next tile's correction exp(-1e30 - m) wipes it, as in the
// reference (kernel.py:65-72); every row sees at least its own key.
// Not yet done (a later PR): WGMMA, TMA, warp specialisation, pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;             // [B, Hq, S]
  int B, Hq, Hkv, S, D;
  long long qb, qh, qs;   // element strides of batch, head and sequence
  long long kb, kh, ks;
  long long vb, vh, vs;
  long long ob, oh, os;
  int window, causal;
  float scale;
};

// The key tiles [j0, j1] that rows [q0, q0 + BQ) can see.
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int& j0,
                                          int& j1) {
  const int kmax = a.causal ? min(a.S - 1, q0 + BQ - 1) : a.S - 1;
  const int kmin = a.window ? max(0, q0 - a.window + 1) : 0;
  j0 = kmin / BK;
  j1 = kmax / BK;
}

// ------------------------------------------------------------------ bf16
//
// With the fragment layouts of flash_common.cuh, the C fragments of two
// adjacent 8-key blocks of S are the A fragment of P for one 16-key step of
// P V.

constexpr int NT_BF16 = 128;

template <int DP>
constexpr int smem_bf16() {
  return 3 * BQ * (DP + 8) * 2;
}

template <int DP>
__global__ void __launch_bounds__(NT_BF16)
flash_fwd_bf16(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = DP + 8;     // padded rows: fewer bank conflicts
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BQ * LD;
  __nv_bfloat16* sV = sK + BK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;
  const __nv_bfloat16* Q =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.qb + h * a.qh;
  const __nv_bfloat16* K =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.kb + hk * a.kh;
  const __nv_bfloat16* V =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.vb + hk * a.vh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;

  load_tile<__nv_bfloat16, DP, NT_BF16>(sQ, LD, Q + q0 * a.qs, a.qs, a.D, BQ);
  __syncthreads();
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const __nv_bfloat16* row0 = sQ + (r0 + g) * LD + kk * 16 + 2 * t;
    const __nv_bfloat16* row1 = row0 + 8 * LD;
    qf[kk][0] = ld32(row0);
    qf[kk][1] = ld32(row1);
    qf[kk][2] = ld32(row0 + 8);
    qf[kk][3] = ld32(row1 + 8);
  }

  float o[DP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const int qp0 = q0 + r0 + g, qp1 = qp0 + 8;

  int j0, j1;
  key_tiles(a, q0, j0, j1);
  for (int j = j0; j <= j1; ++j) {
    const int k0 = j * BK;
    __syncthreads();             // the previous tile's readers are done
    load_tile<__nv_bfloat16, DP, NT_BF16>(sK, LD, K + k0 * a.ks, a.ks, a.D,
                                          BK);
    load_tile<__nv_bfloat16, DP, NT_BF16>(sV, LD, V + k0 * a.vs, a.vs, a.D,
                                          BK);
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      const __nv_bfloat16* krow = sK + (nb * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        mma16816(s[nb], qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + nb * 8 + 2 * t + (e & 1);
        const int qp = e < 2 ? qp0 : qp1;
        const float x = visible(qp, kp, a.window, a.causal)
                            ? s[nb][e] * a.scale : NEG_INF;
        s[nb][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float c0 = __expf(m0 - mx0), c1 = __expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      o[nd][0] *= c0; o[nd][1] *= c0;
      o[nd][2] *= c1; o[nd][3] *= c1;
    }
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
      s[nb][0] = __expf(s[nb][0] - m0);
      s[nb][1] = __expf(s[nb][1] - m0);
      s[nb][2] = __expf(s[nb][2] - m1);
      s[nb][3] = __expf(s[nb][3] - m1);
      l0 += s[nb][0] + s[nb][1];
      l1 += s[nb][2] + s[nb][3];
    }

#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint32_t pf[4] = {pack2(s[2 * ks][0], s[2 * ks][1]),
                              pack2(s[2 * ks][2], s[2 * ks][3]),
                              pack2(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                              pack2(s[2 * ks + 1][2], s[2 * ks + 1][3])};
      const __nv_bfloat16* vrow = sV + (ks * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) {
        if (nd * 8 < a.D) {
          const __nv_bfloat16* vp = vrow + nd * 8;
          mma16816(o[nd], pf, pack2(vp[0], vp[LD]),
                   pack2(vp[8 * LD], vp[9 * LD]));
        }
      }
    }
  }

  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(a.o) + b * a.ob + h * a.oh;
  __nv_bfloat16* o0 = O + qp0 * a.os + 2 * t;
  __nv_bfloat16* o1 = O + qp1 * a.os + 2 * t;
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    if (nd * 8 < a.D) {
      *reinterpret_cast<__nv_bfloat162*>(o0 + nd * 8) =
          __floats2bfloat162_rn(o[nd][0] / l0, o[nd][1] / l0);
      *reinterpret_cast<__nv_bfloat162*>(o1 + nd * 8) =
          __floats2bfloat162_rn(o[nd][2] / l1, o[nd][3] / l1);
    }
  }
  if (t == 0) {
    float* L = a.lse + (static_cast<long long>(b) * a.Hq + h) * a.S;
    L[qp0] = m0 + logf(l0);
    L[qp1] = m1 + logf(l1);
  }
}

// --------------------------------------------------------------- float32
//
// Thread (row r = tid / 4, lane in row c = tid % 4) scores keys c + 4 jj of
// each tile and accumulates output columns c + 4 i; the probabilities pass
// through shared memory from the four threads of a row to all of them.

constexpr int NT_F32 = 256;

template <int DP>
constexpr int smem_f32() {
  return (3 * BQ * (DP + 4) + BQ * (BK + 4)) * 4;
}

template <int DP>
__global__ void __launch_bounds__(NT_F32)
flash_fwd_f32(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = DP + 4;
  constexpr int LDP = BK + 4;
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;
  const float* Q = static_cast<const float*>(a.q) + b * a.qb + h * a.qh;
  const float* K = static_cast<const float*>(a.k) + b * a.kb + hk * a.kh;
  const float* V = static_cast<const float*>(a.v) + b * a.vb + hk * a.vh;
  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;
  const int qp = q0 + r;
  const int nd = a.D / 4;        // output columns of this thread

  load_tile<float, DP, NT_F32>(sQ, LD, Q + q0 * a.qs, a.qs, a.D, BQ);

  float o[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) o[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  int j0, j1;
  key_tiles(a, q0, j0, j1);
  for (int j = j0; j <= j1; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    load_tile<float, DP, NT_F32>(sK, LD, K + k0 * a.ks, a.ks, a.D, BK);
    load_tile<float, DP, NT_F32>(sV, LD, V + k0 * a.vs, a.vs, a.D, BK);
    __syncthreads();

    float s[BK / 4];
#pragma unroll
    for (int jj = 0; jj < BK / 4; ++jj) s[jj] = 0.f;
    for (int d = 0; d < a.D; ++d) {
      const float qv = sQ[r * LD + d];
#pragma unroll
      for (int jj = 0; jj < BK / 4; ++jj)
        s[jj] += qv * sK[(c + 4 * jj) * LD + d];
    }
    float mx = m;
#pragma unroll
    for (int jj = 0; jj < BK / 4; ++jj) {
      const int kp = k0 + c + 4 * jj;
      s[jj] = visible(qp, kp, a.window, a.causal) ? s[jj] * a.scale : NEG_INF;
      mx = fmaxf(mx, s[jj]);
    }
    mx = quad_max(mx);
    const float corr = expf(m - mx);
    m = mx;
    float ps = 0.f;
#pragma unroll
    for (int jj = 0; jj < BK / 4; ++jj) {
      const float p = expf(s[jj] - m);
      ps += p;
      sP[r * LDP + c + 4 * jj] = p;
    }
    l = l * corr + ps;
    __syncwarp();                // a row's four threads share one warp
#pragma unroll
    for (int i = 0; i < DP / 4; ++i) o[i] *= corr;
    for (int kk = 0; kk < BK; ++kk) {
      const float p = sP[r * LDP + kk];
      const float* vrow = sV + kk * LD + c;
#pragma unroll
      for (int i = 0; i < DP / 4; ++i)
        if (i < nd) o[i] += p * vrow[4 * i];
    }
    __syncwarp();                // sP is rewritten by the next tile
  }

  l = fmaxf(quad_sum(l), 1e-30f);
  float* O = static_cast<float*>(a.o) + b * a.ob + h * a.oh + qp * a.os + c;
#pragma unroll
  for (int i = 0; i < DP / 4; ++i)
    if (i < nd) O[4 * i] = o[i] / l;
  if (c == 0)
    a.lse[(static_cast<long long>(b) * a.Hq + h) * a.S + qp] = m + logf(l);
}

template <typename KernelT>
cudaError_t launch(KernelT kernel, int threads, int smem, const Args& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.S / BQ, a.Hq, a.B);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dims: B, Hq, Hkv, S, D, then the (batch, head, sequence) element strides
// of q, k, v and o, then window and causal (19 values).  dtype: 0 = bf16,
// 1 = float32.  Returns a CUDA error code (0 on success); the launch does
// not synchronize.
int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                     float* lse, const long long* dims, float scale,
                     int dtype, void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse;
  a.B = static_cast<int>(dims[0]);
  a.Hq = static_cast<int>(dims[1]);
  a.Hkv = static_cast<int>(dims[2]);
  a.S = static_cast<int>(dims[3]);
  a.D = static_cast<int>(dims[4]);
  a.qb = dims[5];  a.qh = dims[6];  a.qs = dims[7];
  a.kb = dims[8];  a.kh = dims[9];  a.ks = dims[10];
  a.vb = dims[11]; a.vh = dims[12]; a.vs = dims[13];
  a.ob = dims[14]; a.oh = dims[15]; a.os = dims[16];
  a.window = static_cast<int>(dims[17]);
  a.causal = static_cast<int>(dims[18]);
  a.scale = scale;
  if (a.D % 8 || a.D > 128 || a.S % BQ || a.Hkv <= 0 || a.Hq % a.Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool small = a.D <= 64;
  cudaError_t err;
  if (dtype == 0)
    err = small ? launch(flash_fwd_bf16<64>, NT_BF16, smem_bf16<64>(), a, st)
                : launch(flash_fwd_bf16<128>, NT_BF16, smem_bf16<128>(), a,
                         st);
  else if (dtype == 1)
    err = small ? launch(flash_fwd_f32<64>, NT_F32, smem_f32<64>(), a, st)
                : launch(flash_fwd_f32<128>, NT_F32, smem_f32<128>(), a, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
