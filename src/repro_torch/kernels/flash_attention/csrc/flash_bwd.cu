// Flash attention backward for Hopper (sm_90a), written by hand.
//
// Replaces the reference's Pallas `_dq_kernel` and `_dkv_kernel`
// (src/repro/kernels/flash_attention/kernel.py:124 and :159): the gradients
// of causal softmax attention with an optional sliding window and GQA, from
// the forward's saved float32 lse and delta = rowsum(dO * O) (a float32
// pre-pass in the wrapper, as the reference computes it outside its kernels):
//
//   p  = exp(s * scale - lse)   on visible (query, key) pairs, else 0
//   ds = p * (dp - delta) * scale,  s = q k^T,  dp = dO v^T
//   dq = ds k,  dk = ds^T q,  dv = p^T dO
//
// Two kernels and no float atomics, so each result is the same bits on
// every run:
//   * dq:  one block per (64-row query tile, query head, batch row), walking
//          the key tiles the mask leaves visible;
//   * dkv: one block per (64-key tile, KV head, batch row), walking the
//          group's query heads in order and, for each, the query tiles that
//          see the key tile.  The GQA group sum happens here, in registers
//          (the reference writes per-query-head dk/dv and sums afterwards).
// Tiles wholly outside the causal window are skipped in both loops (p and
// ds are 0 there); the reference skips only the causal triangle.
//
// What bounds it: operations (6 * D flops per visible pair for dq, 8 * D for
// dkv, against ~2 * D * 2 bytes per row read once), so every tile stays on
// chip and the sums stay in float32 registers.
//
// Two instantiations:
//   * bf16: four warps, each owning 16 rows of the block's tile; every
//     product on the tensor cores with mma.sync m16n8k16 (bf16 in, float32
//     accumulate).  dkv computes the transposed scores k q^T and v dO^T
//     directly, so p^T and ds^T come out as C fragments with keys as rows
//     and feed p^T dO and ds^T q as A fragments: no transpose through
//     shared memory.  p and ds are rounded to bf16 before the second
//     product, as FlashAttention-2 does.
//   * float32: 256 threads, four per row, CUDA-core products with the same
//     tiles and masks; p and ds pass through shared memory between them.
// Head dims are zero-padded in shared memory to 64 or 128 (D = 120 -> 128);
// inputs and outputs are read and written through strides, so [B, S, H, D]
// activations and gradients need no copy.
// Not yet done (a later PR): WGMMA, TMA, pipelined tile loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // keys per tile
constexpr int HALF = 32;  // bf16: columns of the score tile per pass

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* g;          // dO
  const float* lse;       // [B, Hq, S]
  const float* delta;     // [B, Hq, S]
  void* dq;
  void* dk;
  void* dv;
  int B, Hq, Hkv, S, D;
  long long qb, qh, qs;   // element strides of batch, head and sequence
  long long kb, kh, ks;
  long long vb, vh, vs;
  long long gb, gh, gs;
  long long dqb, dqh, dqs;
  long long dkb, dkh, dks;
  long long dvb, dvh, dvs;
  int window, causal;
  float scale;
};

// The key tiles [j0, j1] that query rows [q0, q0 + BQ) can see.
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int& j0,
                                          int& j1) {
  const int kmax = a.causal ? min(a.S - 1, q0 + BQ - 1) : a.S - 1;
  const int kmin = a.window ? max(0, q0 - a.window + 1) : 0;
  j0 = kmin / BK;
  j1 = kmax / BK;
}

// The query tiles [i0, i1] that see keys [k0, k0 + BK).
__device__ __forceinline__ void query_tiles(const Args& a, int k0, int& i0,
                                            int& i1) {
  const int qmin = a.causal ? k0 : 0;
  const int qmax = a.window ? min(a.S - 1, k0 + BK - 1 + a.window - 1)
                            : a.S - 1;
  i0 = qmin / BQ;
  i1 = qmax / BQ;
}

__device__ __forceinline__ const float* row_of(const float* x, const Args& a,
                                               int b, int h) {
  return x + (static_cast<long long>(b) * a.Hq + h) * a.S;
}

// ------------------------------------------------------------------ bf16

typedef __nv_bfloat16 bf16;
constexpr int NT_BF16 = 128;

template <int DP>
constexpr int smem_dq_bf16() {
  return 4 * BQ * (DP + 8) * 2;
}

template <int DP>
constexpr int smem_dkv_bf16() {
  return 4 * BQ * (DP + 8) * 2 + 2 * BQ * 4;
}

template <int DP>
__global__ void __launch_bounds__(NT_BF16)
flash_dq_bf16(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = DP + 8;     // padded rows: fewer bank conflicts
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sG = sQ + BQ * LD;
  bf16* sK = sG + BQ * LD;
  bf16* sV = sK + BK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.qb + h * a.qh;
  const bf16* G = static_cast<const bf16*>(a.g) + b * a.gb + h * a.gh;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.kb + hk * a.kh;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.vb + hk * a.vh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;

  load_tile<bf16, DP, NT_BF16>(sQ, LD, Q + q0 * a.qs, a.qs, a.D, BQ);
  load_tile<bf16, DP, NT_BF16>(sG, LD, G + q0 * a.gs, a.gs, a.D, BQ);
  const int qp0 = q0 + r0 + g, qp1 = qp0 + 8;
  const float* L = row_of(a.lse, a, b, h);
  const float* Dl = row_of(a.delta, a, b, h);
  const float lse0 = L[qp0], lse1 = L[qp1];
  const float del0 = Dl[qp0], del1 = Dl[qp1];

  float acc[DP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  int j0, j1;
  key_tiles(a, q0, j0, j1);
  for (int j = j0; j <= j1; ++j) {
    const int k0 = j * BK;
    __syncthreads();             // the previous tile's readers are done
    load_tile<bf16, DP, NT_BF16>(sK, LD, K + k0 * a.ks, a.ks, a.D, BK);
    load_tile<bf16, DP, NT_BF16>(sV, LD, V + k0 * a.vs, a.vs, a.D, BK);
    __syncthreads();

#pragma unroll
    for (int kb = 0; kb < BK; kb += HALF) {
      // s = q k^T and dp = dO v^T over keys [kb, kb + HALF) of the tile
      float s[HALF / 8][4], dp[HALF / 8][4];
#pragma unroll
      for (int nb = 0; nb < HALF / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t qa[4], ga[4];
        load_a(qa, sQ + (r0 + g) * LD + kk * 16 + 2 * t, LD);
        load_a(ga, sG + (r0 + g) * LD + kk * 16 + 2 * t, LD);
#pragma unroll
        for (int nb = 0; nb < HALF / 8; ++nb) {
          const int row = (kb + nb * 8 + g) * LD + kk * 16 + 2 * t;
          mma16816(s[nb], qa, ld32(sK + row), ld32(sK + row + 8));
          mma16816(dp[nb], ga, ld32(sV + row), ld32(sV + row + 8));
        }
      }
      // ds, kept in s
#pragma unroll
      for (int nb = 0; nb < HALF / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + kb + nb * 8 + 2 * t + (e & 1);
          const bool top = e < 2;
          const float p = visible(top ? qp0 : qp1, kp, a.window, a.causal)
                              ? __expf(s[nb][e] * a.scale -
                                       (top ? lse0 : lse1))
                              : 0.f;
          s[nb][e] = p * (dp[nb][e] - (top ? del0 : del1)) * a.scale;
        }
      }
      // dq += ds k
#pragma unroll
      for (int ks = 0; ks < HALF / 16; ++ks) {
        uint32_t df[4];
        pack_c_as_a(df, s[2 * ks], s[2 * ks + 1]);
        const bf16* kcol = sK + (kb + ks * 16 + 2 * t) * LD + g;
#pragma unroll
        for (int nd = 0; nd < DP / 8; ++nd) {
          if (nd * 8 < a.D) {
            uint32_t b0, b1;
            load_b_kn(b0, b1, kcol + nd * 8, LD);
            mma16816(acc[nd], df, b0, b1);
          }
        }
      }
    }
  }

  bf16* DQ = static_cast<bf16*>(a.dq) + b * a.dqb + h * a.dqh;
  bf16* o0 = DQ + qp0 * a.dqs + 2 * t;
  bf16* o1 = DQ + qp1 * a.dqs + 2 * t;
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    if (nd * 8 < a.D) {
      *reinterpret_cast<__nv_bfloat162*>(o0 + nd * 8) =
          __floats2bfloat162_rn(acc[nd][0], acc[nd][1]);
      *reinterpret_cast<__nv_bfloat162*>(o1 + nd * 8) =
          __floats2bfloat162_rn(acc[nd][2], acc[nd][3]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(NT_BF16)
flash_dkv_bf16(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = DP + 8;
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * LD;
  bf16* sQ = sV + BK * LD;
  bf16* sG = sQ + BQ * LD;
  float* sL = reinterpret_cast<float*>(sG + BQ * LD);
  float* sD = sL + BQ;

  const int kt = blockIdx.x;     // the first key tiles see the most queries
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int k0 = kt * BK;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.kb + hk * a.kh;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.vb + hk * a.vh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;

  load_tile<bf16, DP, NT_BF16>(sK, LD, K + k0 * a.ks, a.ks, a.D, BK);
  load_tile<bf16, DP, NT_BF16>(sV, LD, V + k0 * a.vs, a.vs, a.D, BK);
  const int kp0 = k0 + r0 + g, kp1 = kp0 + 8;

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;

  int i0, i1;
  query_tiles(a, k0, i0, i1);
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const bf16* Q = static_cast<const bf16*>(a.q) + b * a.qb + h * a.qh;
    const bf16* G = static_cast<const bf16*>(a.g) + b * a.gb + h * a.gh;
    const float* L = row_of(a.lse, a, b, h);
    const float* Dl = row_of(a.delta, a, b, h);
    for (int i = i0; i <= i1; ++i) {
      const int q0 = i * BQ;
      __syncthreads();
      load_tile<bf16, DP, NT_BF16>(sQ, LD, Q + q0 * a.qs, a.qs, a.D, BQ);
      load_tile<bf16, DP, NT_BF16>(sG, LD, G + q0 * a.gs, a.gs, a.D, BQ);
      for (int c = threadIdx.x; c < BQ; c += NT_BF16) {
        sL[c] = L[q0 + c];
        sD[c] = Dl[q0 + c];
      }
      __syncthreads();

#pragma unroll
      for (int qb = 0; qb < BQ; qb += HALF) {
        // s^T = k q^T and dp^T = v dO^T: keys are rows, queries columns
        float s[HALF / 8][4], dp[HALF / 8][4];
#pragma unroll
        for (int nb = 0; nb < HALF / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          uint32_t ka[4], va[4];
          load_a(ka, sK + (r0 + g) * LD + kk * 16 + 2 * t, LD);
          load_a(va, sV + (r0 + g) * LD + kk * 16 + 2 * t, LD);
#pragma unroll
          for (int nb = 0; nb < HALF / 8; ++nb) {
            const int row = (qb + nb * 8 + g) * LD + kk * 16 + 2 * t;
            mma16816(s[nb], ka, ld32(sQ + row), ld32(sQ + row + 8));
            mma16816(dp[nb], va, ld32(sG + row), ld32(sG + row + 8));
          }
        }
        // p^T kept in s, ds^T in dp
#pragma unroll
        for (int nb = 0; nb < HALF / 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = qb + nb * 8 + 2 * t + (e & 1);
            const int kp = e < 2 ? kp0 : kp1;
            const float p = visible(q0 + qi, kp, a.window, a.causal)
                                ? __expf(s[nb][e] * a.scale - sL[qi])
                                : 0.f;
            s[nb][e] = p;
            dp[nb][e] = p * (dp[nb][e] - sD[qi]) * a.scale;
          }
        }
        // dv += p^T dO, dk += ds^T q
#pragma unroll
        for (int ks = 0; ks < HALF / 16; ++ks) {
          uint32_t pf[4], df[4];
          pack_c_as_a(pf, s[2 * ks], s[2 * ks + 1]);
          pack_c_as_a(df, dp[2 * ks], dp[2 * ks + 1]);
          const int col = (qb + ks * 16 + 2 * t) * LD + g;
#pragma unroll
          for (int nd = 0; nd < DP / 8; ++nd) {
            if (nd * 8 < a.D) {
              uint32_t b0, b1;
              load_b_kn(b0, b1, sG + col + nd * 8, LD);
              mma16816(dv[nd], pf, b0, b1);
              load_b_kn(b0, b1, sQ + col + nd * 8, LD);
              mma16816(dk[nd], df, b0, b1);
            }
          }
        }
      }
    }
  }

  bf16* DK = static_cast<bf16*>(a.dk) + b * a.dkb + hk * a.dkh;
  bf16* DV = static_cast<bf16*>(a.dv) + b * a.dvb + hk * a.dvh;
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    if (nd * 8 < a.D) {
      const int c = nd * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(DK + kp0 * a.dks + c) =
          __floats2bfloat162_rn(dk[nd][0], dk[nd][1]);
      *reinterpret_cast<__nv_bfloat162*>(DK + kp1 * a.dks + c) =
          __floats2bfloat162_rn(dk[nd][2], dk[nd][3]);
      *reinterpret_cast<__nv_bfloat162*>(DV + kp0 * a.dvs + c) =
          __floats2bfloat162_rn(dv[nd][0], dv[nd][1]);
      *reinterpret_cast<__nv_bfloat162*>(DV + kp1 * a.dvs + c) =
          __floats2bfloat162_rn(dv[nd][2], dv[nd][3]);
    }
  }
}

// --------------------------------------------------------------- float32
//
// Thread (row r = tid / 4, lane in row c = tid % 4) computes the scores of
// columns c + 4 jj of the tile and accumulates output columns c + 4 i; the
// scores' products pass through shared memory from the four threads of a
// row to all of them (one warp holds eight whole rows).

constexpr int NT_F32 = 256;

template <int DP>
constexpr int smem_dq_f32() {
  return (4 * BQ * (DP + 4) + BQ * (BK + 4)) * 4;
}

template <int DP>
constexpr int smem_dkv_f32() {
  return (4 * BQ * (DP + 4) + 2 * BQ * (BQ + 4) + 2 * BQ) * 4;
}

template <int DP>
__global__ void __launch_bounds__(NT_F32)
flash_dq_f32(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = DP + 4;
  constexpr int LDS = BK + 4;
  float* sQ = reinterpret_cast<float*>(smem);
  float* sG = sQ + BQ * LD;
  float* sK = sG + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;
  const float* Q = static_cast<const float*>(a.q) + b * a.qb + h * a.qh;
  const float* G = static_cast<const float*>(a.g) + b * a.gb + h * a.gh;
  const float* K = static_cast<const float*>(a.k) + b * a.kb + hk * a.kh;
  const float* V = static_cast<const float*>(a.v) + b * a.vb + hk * a.vh;
  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;
  const int qp = q0 + r;
  const int nd = a.D / 4;

  load_tile<float, DP, NT_F32>(sQ, LD, Q + q0 * a.qs, a.qs, a.D, BQ);
  load_tile<float, DP, NT_F32>(sG, LD, G + q0 * a.gs, a.gs, a.D, BQ);
  const float lse = row_of(a.lse, a, b, h)[qp];
  const float del = row_of(a.delta, a, b, h)[qp];

  float acc[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) acc[i] = 0.f;

  int j0, j1;
  key_tiles(a, q0, j0, j1);
  for (int j = j0; j <= j1; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    load_tile<float, DP, NT_F32>(sK, LD, K + k0 * a.ks, a.ks, a.D, BK);
    load_tile<float, DP, NT_F32>(sV, LD, V + k0 * a.vs, a.vs, a.D, BK);
    __syncthreads();

    float s[BK / 4], dp[BK / 4];
#pragma unroll
    for (int jj = 0; jj < BK / 4; ++jj) s[jj] = dp[jj] = 0.f;
    for (int d = 0; d < a.D; ++d) {
      const float qv = sQ[r * LD + d], gv = sG[r * LD + d];
#pragma unroll
      for (int jj = 0; jj < BK / 4; ++jj) {
        s[jj] += qv * sK[(c + 4 * jj) * LD + d];
        dp[jj] += gv * sV[(c + 4 * jj) * LD + d];
      }
    }
#pragma unroll
    for (int jj = 0; jj < BK / 4; ++jj) {
      const int kp = k0 + c + 4 * jj;
      const float p = visible(qp, kp, a.window, a.causal)
                          ? expf(s[jj] * a.scale - lse) : 0.f;
      sS[r * LDS + c + 4 * jj] = p * (dp[jj] - del) * a.scale;
    }
    __syncwarp();                // a row's four threads share one warp
    for (int kk = 0; kk < BK; ++kk) {
      const float ds = sS[r * LDS + kk];
      const float* krow = sK + kk * LD + c;
#pragma unroll
      for (int i = 0; i < DP / 4; ++i)
        if (i < nd) acc[i] += ds * krow[4 * i];
    }
    __syncwarp();                // sS is rewritten by the next tile
  }

  float* DQ = static_cast<float*>(a.dq) + b * a.dqb + h * a.dqh +
              qp * a.dqs + c;
#pragma unroll
  for (int i = 0; i < DP / 4; ++i)
    if (i < nd) DQ[4 * i] = acc[i];
}

template <int DP>
__global__ void __launch_bounds__(NT_F32)
flash_dkv_f32(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = DP + 4;
  constexpr int LDS = BQ + 4;
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sG = sQ + BQ * LD;
  float* sP = sG + BQ * LD;
  float* sS = sP + BK * LDS;
  float* sL = sS + BK * LDS;
  float* sD = sL + BQ;

  const int kt = blockIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int k0 = kt * BK;
  const float* K = static_cast<const float*>(a.k) + b * a.kb + hk * a.kh;
  const float* V = static_cast<const float*>(a.v) + b * a.vb + hk * a.vh;
  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;
  const int kp = k0 + r;
  const int nd = a.D / 4;

  load_tile<float, DP, NT_F32>(sK, LD, K + k0 * a.ks, a.ks, a.D, BK);
  load_tile<float, DP, NT_F32>(sV, LD, V + k0 * a.vs, a.vs, a.D, BK);

  float dk[DP / 4], dv[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) dk[i] = dv[i] = 0.f;

  int i0, i1;
  query_tiles(a, k0, i0, i1);
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const float* Q = static_cast<const float*>(a.q) + b * a.qb + h * a.qh;
    const float* G = static_cast<const float*>(a.g) + b * a.gb + h * a.gh;
    const float* L = row_of(a.lse, a, b, h);
    const float* Dl = row_of(a.delta, a, b, h);
    for (int i = i0; i <= i1; ++i) {
      const int q0 = i * BQ;
      __syncthreads();
      load_tile<float, DP, NT_F32>(sQ, LD, Q + q0 * a.qs, a.qs, a.D, BQ);
      load_tile<float, DP, NT_F32>(sG, LD, G + q0 * a.gs, a.gs, a.D, BQ);
      for (int x = threadIdx.x; x < BQ; x += NT_F32) {
        sL[x] = L[q0 + x];
        sD[x] = Dl[q0 + x];
      }
      __syncthreads();

      float s[BQ / 4], dp[BQ / 4];
#pragma unroll
      for (int jj = 0; jj < BQ / 4; ++jj) s[jj] = dp[jj] = 0.f;
      for (int d = 0; d < a.D; ++d) {
        const float kv = sK[r * LD + d], vv = sV[r * LD + d];
#pragma unroll
        for (int jj = 0; jj < BQ / 4; ++jj) {
          s[jj] += kv * sQ[(c + 4 * jj) * LD + d];
          dp[jj] += vv * sG[(c + 4 * jj) * LD + d];
        }
      }
#pragma unroll
      for (int jj = 0; jj < BQ / 4; ++jj) {
        const int qi = c + 4 * jj;
        const float p = visible(q0 + qi, kp, a.window, a.causal)
                            ? expf(s[jj] * a.scale - sL[qi]) : 0.f;
        sP[r * LDS + qi] = p;
        sS[r * LDS + qi] = p * (dp[jj] - sD[qi]) * a.scale;
      }
      __syncwarp();
      for (int qi = 0; qi < BQ; ++qi) {
        const float p = sP[r * LDS + qi], ds = sS[r * LDS + qi];
        const float* grow = sG + qi * LD + c;
        const float* qrow = sQ + qi * LD + c;
#pragma unroll
        for (int i = 0; i < DP / 4; ++i) {
          if (i < nd) {
            dv[i] += p * grow[4 * i];
            dk[i] += ds * qrow[4 * i];
          }
        }
      }
      __syncwarp();
    }
  }

  float* DK = static_cast<float*>(a.dk) + b * a.dkb + hk * a.dkh +
              kp * a.dks + c;
  float* DV = static_cast<float*>(a.dv) + b * a.dvb + hk * a.dvh +
              kp * a.dvs + c;
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) {
    if (i < nd) {
      DK[4 * i] = dk[i];
      DV[4 * i] = dv[i];
    }
  }
}

template <typename KernelT>
cudaError_t launch(KernelT kernel, int threads, int smem, dim3 grid,
                   const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// dims: B, Hq, Hkv, S, D, then the (batch, head, sequence) element strides
// of q, k, v, dO, dq, dk and dv, then window and causal (28 values).
bool parse(Args& a, const long long* dims) {
  a.B = static_cast<int>(dims[0]);
  a.Hq = static_cast<int>(dims[1]);
  a.Hkv = static_cast<int>(dims[2]);
  a.S = static_cast<int>(dims[3]);
  a.D = static_cast<int>(dims[4]);
  long long* strides[21] = {&a.qb,  &a.qh,  &a.qs,  &a.kb,  &a.kh,  &a.ks,
                            &a.vb,  &a.vh,  &a.vs,  &a.gb,  &a.gh,  &a.gs,
                            &a.dqb, &a.dqh, &a.dqs, &a.dkb, &a.dkh, &a.dks,
                            &a.dvb, &a.dvh, &a.dvs};
  for (int i = 0; i < 21; ++i) *strides[i] = dims[5 + i];
  a.window = static_cast<int>(dims[26]);
  a.causal = static_cast<int>(dims[27]);
  return !(a.D % 8 || a.D > 128 || a.S % BQ || a.Hkv <= 0 || a.Hq % a.Hkv);
}

}  // namespace

extern "C" {

// dq of every query row.  q, k, v, dO and dq in one dtype (0 = bf16,
// 1 = float32); lse and delta float32 [B, Hq, S].  Returns a CUDA error code
// (0 on success); the launch does not synchronize.
int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dq, const long long* dims,
                        float scale, int dtype, void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.g = dout; a.lse = lse; a.delta = delta;
  a.dq = dq; a.dk = nullptr; a.dv = nullptr;
  a.scale = scale;
  if (!parse(a, dims)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(a.S / BQ, a.Hq, a.B);
  const bool small = a.D <= 64;
  cudaError_t err;
  if (dtype == 0)
    err = small ? launch(flash_dq_bf16<64>, NT_BF16, smem_dq_bf16<64>(),
                         grid, a, st)
                : launch(flash_dq_bf16<128>, NT_BF16, smem_dq_bf16<128>(),
                         grid, a, st);
  else if (dtype == 1)
    err = small ? launch(flash_dq_f32<64>, NT_F32, smem_dq_f32<64>(), grid,
                         a, st)
                : launch(flash_dq_f32<128>, NT_F32, smem_dq_f32<128>(), grid,
                         a, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// dk and dv of every KV row, each summed over its GQA group of query heads.
int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv,
                         const long long* dims, float scale, int dtype,
                         void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.g = dout; a.lse = lse; a.delta = delta;
  a.dq = nullptr; a.dk = dk; a.dv = dv;
  a.scale = scale;
  if (!parse(a, dims)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(a.S / BK, a.Hkv, a.B);
  const bool small = a.D <= 64;
  cudaError_t err;
  if (dtype == 0)
    err = small ? launch(flash_dkv_bf16<64>, NT_BF16, smem_dkv_bf16<64>(),
                         grid, a, st)
                : launch(flash_dkv_bf16<128>, NT_BF16, smem_dkv_bf16<128>(),
                         grid, a, st);
  else if (dtype == 1)
    err = small ? launch(flash_dkv_f32<64>, NT_F32, smem_dkv_f32<64>(),
                         grid, a, st)
                : launch(flash_dkv_f32<128>, NT_F32, smem_dkv_f32<128>(),
                         grid, a, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
