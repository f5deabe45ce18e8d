// Mamba-2 SSD chunked scan for Hopper (sm_90a), written by hand.
//
// Replaces the reference's Pallas `_ssd_kernel`
// (src/repro/kernels/ssd/kernel.py:24).  For each (batch row b, head h),
// over chunks of Q steps in order, with a float32 state [N, P] carried from
// chunk to chunk:
//   cum    = cumsum(a)                                  [Q]
//   L      = tril(exp(cum_i - cum_j))                   [Q, Q]
//   y      = ((C B^T) * L) x + exp(cum) * (C state)     [Q, P]
//   state  = state * exp(cum[-1]) + (B * exp(cum[-1] - cum))^T x
// B and C ([B, S, N], bf16 or float32) are shared by the H heads of a row;
// x and a are float32; y and the final state are float32.  Every sum is
// float32 with explicit fmaf (the library is built with --fmad=false, so
// nothing else is contracted), in a fixed order: two launches give the same
// bits.
//
// What bounds it: operations.  Per (row, head, chunk) it does
// 2 Q^2 N (C B^T) + 2 Q^2 P ((G*L) x) + 2 Q N P (C state) + 2 Q N P (the
// state update) flops, ~10.5 MFLOP at Q = N = 128, P = 64, against
// ~Q (P + 2 N) * 4 bytes read: ~170 flops a byte, far above the card's
// float32 ridge (67 TFLOP/s over 3.35 TB/s = 20).  The design keeps the
// whole chunk on chip: one block of 256 threads per (row, head) walks the
// chunks (the reference's sequential grid axis becomes a loop); x, B and C
// of the chunk sit in shared memory as float32 (bf16 B/C are widened once
// on load), so does the state entering the chunk; each thread also keeps
// its 8 x 4 piece of the state in registers for the update.  The [Q, Q]
// score tile never exists whole: each warp computes 4 rows of it at a time
// (a stripe of 32 rows for the block), masks and decays them, and
// multiplies them straight into its 4 rows of y.  Shared memory: 211.5 KiB
// of the 227 KiB a block may use, so one block per SM; B*H blocks (192 at
// batch 8, 24 heads) fill the card's 132 SMs in two waves.
//
// Smaller shapes (N < 128, P < 64, Q < 128) are zero-padded on chip: padded
// rows and columns contribute exact zeros and are not written.
//
// Underflow: L is exp of differences (never a ratio of exps), and
// exp(cum) in the off-chunk term may underflow to 0, as in the reference.
//
// Not yet done (a later PR): C B^T once per row instead of once per head,
// the intra-chunk work in parallel over chunks apart from the state pass,
// tensor cores, loads of the next chunk overlapped with compute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QM = 128;           // chunk rows on chip
constexpr int NM = 128;           // state size on chip
constexpr int PM = 64;            // head dim on chip
constexpr int NT = 256;           // threads a block
constexpr int NW = NT / 32;       // warps
constexpr int RW = 4;             // score rows a warp holds at a time
constexpr int STRIPE = NW * RW;   // score rows the block holds at a time
constexpr int LDB = NM + 4;       // B rows padded: conflict-free column reads

// shared memory, in floats
constexpr int OFF_X = 0;                        // x      [QM][PM]
constexpr int OFF_B = OFF_X + QM * PM;          // B      [QM][LDB]
constexpr int OFF_C = OFF_B + QM * LDB;         // C      [QM][NM]
constexpr int OFF_S = OFF_C + QM * NM;          // state  [NM][PM]
constexpr int OFF_G = OFF_S + NM * PM;          // scores [NW][RW][QM]
constexpr int OFF_CUM = OFF_G + NW * RW * QM;   // cum, exp(cum), decay to end
constexpr int OFF_TOT = OFF_CUM + 3 * QM;       // per-warp sums of the scan
constexpr int SMEM_FLOATS = OFF_TOT + 8;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

struct Args {
  const float* x;         // [B, H, S, P] through strides
  const float* a;         // [B, H, S] through strides
  const void* bm;         // [B, S, N] through strides, unit last stride
  const void* cm;
  float* y;               // like x
  float* fs;              // [B, H, N, P] contiguous
  int B, H, S, P, N, Q;
  long long xb, xh, xs;
  long long ab, ah, as;
  long long bb, bs;
  long long cb, cs;
  long long yb, yh, ys;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// acc[0..1] += m * v
__device__ __forceinline__ void fma2(float (&acc)[2], float m, float2 v) {
  acc[0] = fmaf(m, v.x, acc[0]);
  acc[1] = fmaf(m, v.y, acc[1]);
}

template <typename T>
__global__ void __launch_bounds__(NT, 1) ssd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* sx = smem + OFF_X;
  float* sB = smem + OFF_B;
  float* sC = smem + OFF_C;
  float* sS = smem + OFF_S;
  float* cum = smem + OFF_CUM;
  float* ecum = cum + QM;
  float* dte = ecum + QM;
  float* tot = smem + OFF_TOT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int Q = a.Q, P = a.P, N = a.N;
  const float* X = a.x + b * a.xb + h * a.xh;
  const float* A = a.a + b * a.ab + h * a.ah;
  const T* Bg = static_cast<const T*>(a.bm) + b * a.bb;
  const T* Cg = static_cast<const T*>(a.cm) + b * a.cb;
  float* Y = a.y + b * a.yb + h * a.yh;
  float* sG = smem + OFF_G + warp * RW * QM;     // this warp's score rows

  // the piece of the state this thread updates: rows n0..n0+7, cols p0..+3
  const int n0 = 8 * (tid >> 4), p0 = 4 * (tid & 15);
  float st[8][4];
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) st[k][j] = 0.f;
  for (int i = tid; i < NM * PM; i += NT) sS[i] = 0.f;

  const int nc = a.S / Q;
  for (int c = 0; c < nc; ++c) {
    const long long s0 = static_cast<long long>(c) * Q;
    __syncthreads();             // the previous chunk is done with sx, sB
    // ---- the chunk's x, B, C (zero-padded) and the scan of a
#pragma unroll 8
    for (int i = tid; i < QM * PM; i += NT) {
      const int q = i / PM, p = i % PM;
      sx[i] = (q < Q && p < P) ? X[(s0 + q) * a.xs + p] : 0.f;
    }
#pragma unroll 8
    for (int i = tid; i < QM * NM; i += NT) {
      const int q = i / NM, n = i % NM;
      const bool in = q < Q && n < N;
      sB[q * LDB + n] = in ? widen(Bg[(s0 + q) * a.bs + n]) : 0.f;
      sC[i] = in ? widen(Cg[(s0 + q) * a.cs + n]) : 0.f;
    }
    if (warp < QM / 32) {        // inclusive scan of each 32 steps
      const int q = warp * 32 + lane;
      float v = q < Q ? A[(s0 + q) * a.as] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      cum[q] = v;
      if (lane == 31) tot[warp] = v;
    }
    __syncthreads();
    if (tid < QM) {              // add the sums of the earlier warps
      float off = 0.f;
      for (int w = 0; w < (tid >> 5); ++w) off += tot[w];
      cum[tid] += off;
    }
    __syncthreads();
    const float last = cum[Q - 1];
    if (tid < QM) {
      ecum[tid] = expf(cum[tid]);
      dte[tid] = expf(last - cum[tid]);
    }
    __syncthreads();

    // ---- y, one stripe of score rows at a time; warp w holds rows
    // r0 + 4w .. r0 + 4w + 3 of each stripe
    for (int r0 = 0; r0 < QM; r0 += STRIPE) {
      const int q0 = r0 + warp * RW;
      // scores G = C B^T: rows q0.., columns lane + 32 jj
      float g[RW][4];
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) g[i][jj] = 0.f;
#pragma unroll 4
      for (int k = 0; k < NM; k += 4) {
        float4 cv[RW], bv[4];
#pragma unroll
        for (int i = 0; i < RW; ++i) cv[i] = ld4(sC + (q0 + i) * NM + k);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          bv[jj] = ld4(sB + (lane + 32 * jj) * LDB + k);
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            g[i][jj] = fmaf(cv[i].x, bv[jj].x, g[i][jj]);
            g[i][jj] = fmaf(cv[i].y, bv[jj].y, g[i][jj]);
            g[i][jj] = fmaf(cv[i].z, bv[jj].z, g[i][jj]);
            g[i][jj] = fmaf(cv[i].w, bv[jj].w, g[i][jj]);
          }
      }
      // masked and decayed: M = G * L
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int q = q0 + i, j = lane + 32 * jj;
          sG[i * QM + j] = j <= q ? g[i][jj] * expf(cum[q] - cum[j]) : 0.f;
        }
      __syncwarp();
      // y rows q0.., columns 2 lane, 2 lane + 1: M x, and C state
      float yd[RW][2], yo[RW][2];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        yd[i][0] = yd[i][1] = 0.f;
        yo[i][0] = yo[i][1] = 0.f;
      }
#pragma unroll 2
      for (int j = 0; j < QM; j += 4) {
        float2 xv[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          xv[jj] = ld2(sx + (j + jj) * PM + 2 * lane);
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const float4 m = ld4(sG + i * QM + j);
          fma2(yd[i], m.x, xv[0]);
          fma2(yd[i], m.y, xv[1]);
          fma2(yd[i], m.z, xv[2]);
          fma2(yd[i], m.w, xv[3]);
        }
      }
#pragma unroll 2
      for (int n = 0; n < NM; n += 4) {
        float2 sv[4];
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
          sv[nn] = ld2(sS + (n + nn) * PM + 2 * lane);
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const float4 cv = ld4(sC + (q0 + i) * NM + n);
          fma2(yo[i], cv.x, sv[0]);
          fma2(yo[i], cv.y, sv[1]);
          fma2(yo[i], cv.z, sv[2]);
          fma2(yo[i], cv.w, sv[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int q = q0 + i;
        if (q >= Q) continue;
        float* yrow = Y + (s0 + q) * a.ys;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = 2 * lane + e;
          if (p < P) yrow[p] = yd[i][e] + ecum[q] * yo[i][e];
        }
      }
      __syncwarp();              // sG is rewritten by the next stripe
    }
    __syncthreads();             // every read of the entering state is done

    // ---- state = state * exp(cum[-1]) + (B * decay_to_end)^T x
    const float chunk_decay = expf(last);
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[k][j] *= chunk_decay;
#pragma unroll 4
    for (int q = 0; q < QM; ++q) {
      const float d = dte[q];
      const float4 b0 = ld4(sB + q * LDB + n0);
      const float4 b1 = ld4(sB + q * LDB + n0 + 4);
      const float4 xv = ld4(sx + q * PM + p0);
      const float bd[8] = {b0.x * d, b0.y * d, b0.z * d, b0.w * d,
                           b1.x * d, b1.y * d, b1.z * d, b1.w * d};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        st[k][0] = fmaf(bd[k], xv.x, st[k][0]);
        st[k][1] = fmaf(bd[k], xv.y, st[k][1]);
        st[k][2] = fmaf(bd[k], xv.z, st[k][2]);
        st[k][3] = fmaf(bd[k], xv.w, st[k][3]);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      *reinterpret_cast<float4*>(sS + (n0 + k) * PM + p0) =
          make_float4(st[k][0], st[k][1], st[k][2], st[k][3]);
  }

  // ---- the final state, [N, P] of this (row, head)
  float* F = a.fs + static_cast<long long>(bh) * N * P;
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + k < N && p0 + j < P) F[(n0 + k) * P + p0 + j] = st[k][j];
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<a.B * a.H, NT, SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dims: B, H, S, P, N, Q, then the (batch, head, sequence) element strides
// of x and of a, the (batch, sequence) strides of B and of C, the (batch,
// head, sequence) strides of y (19 values).  bc_dtype: 0 = float32,
// 1 = bf16.  Returns a CUDA error code (0 on success); the launch does not
// synchronize.
int ssd_launch(const float* x, const float* a, const void* bm,
               const void* cm, float* y, float* fs, const long long* dims,
               int bc_dtype, void* stream) {
  Args g;
  g.x = x; g.a = a; g.bm = bm; g.cm = cm; g.y = y; g.fs = fs;
  g.B = static_cast<int>(dims[0]);
  g.H = static_cast<int>(dims[1]);
  g.S = static_cast<int>(dims[2]);
  g.P = static_cast<int>(dims[3]);
  g.N = static_cast<int>(dims[4]);
  g.Q = static_cast<int>(dims[5]);
  g.xb = dims[6];  g.xh = dims[7];  g.xs = dims[8];
  g.ab = dims[9];  g.ah = dims[10]; g.as = dims[11];
  g.bb = dims[12]; g.bs = dims[13];
  g.cb = dims[14]; g.cs = dims[15];
  g.yb = dims[16]; g.yh = dims[17]; g.ys = dims[18];
  if (g.B <= 0 || g.H <= 0 || g.S <= 0 || g.P <= 0 || g.P > PM ||
      g.N <= 0 || g.N > NM || g.Q <= 0 || g.Q > QM || g.S % g.Q)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bc_dtype == 0)
    err = launch<float>(g, st);
  else if (bc_dtype == 1)
    err = launch<__nv_bfloat16>(g, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
