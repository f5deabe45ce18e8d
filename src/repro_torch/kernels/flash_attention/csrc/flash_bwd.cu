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
//   * dq:  one block per (query tile, query head, batch row), walking the
//          key tiles the mask leaves visible in ascending order;
//   * dkv: one block per (key tile, KV head, batch row), walking the
//          group's query heads in order and, for each, the query tiles that
//          see the key tile in ascending order.  The GQA group sum happens
//          here, in registers (the reference writes per-query-head dk/dv
//          and sums afterwards).
// The split recomputes s and dp in both kernels (14 D flops a visible pair
// against 10 D for a fused pass); a fused dq would need float atomics or an
// ordered reduction across blocks.  Tiles wholly outside the causal window
// are skipped in both loops (p and ds are 0 there); the reference skips
// only the causal triangle.
//
// What bounds it: operations (6 D flops per visible pair for dq, 8 D for
// dkv, against ~2 D * 2 bytes per row read once), so the tensor cores must
// be kept fed and every intermediate stays on chip.
//
// bf16 (the training path): blocks of three warpgroups (hopper.cuh).
//   * One producer warpgroup, whose first thread issues every copy with
//     TMA: the block's resident tile once (q and dO in dq, k and v in dkv),
//     then a ring of STAGES stages (k and v tiles in dq; q and dO tiles
//     plus their lse and delta rows in dkv) synchronised by mbarriers, so
//     the next tiles are in flight while the tensor cores work.  Tensor
//     maps over the 4-D strided tensors read [B, S, H, D] views in place;
//     TMA's out-of-bounds fill supplies the zero columns D..DP-1 (D = 120
//     -> 128), and the 128-byte swizzle keeps wgmma's reads free of bank
//     conflicts.  setmaxnreg leaves the producer 24 registers.
//   * Two consumer warpgroups (240 registers each), each owning 64 rows of
//     the resident tile.  Every product is a wgmma (bf16 in, float32
//     accumulate): s = q k^T and dp = dO v^T (dkv: s^T = k q^T and dp^T =
//     v dO^T, keys as rows) with both operands in shared memory, K-major;
//     then dq += ds k (dkv: dv += p^T dO, dk += ds^T q) with A from
//     registers, the accumulator rounded to bf16 as FlashAttention-2 does,
//     and B in shared memory, MN-major: no transpose passes through shared
//     memory.  The element mask runs only on tiles that straddle the
//     diagonal or the window's edge (a separate, branch-free instantiation
//     of the score step: two compares against the row's bounds and a
//     select); log2(e) is folded into the scale and lse, so each p is one
//     multiply-add and one exp2; the scale of ds is applied once to dq and
//     dk at the end.
//   * dq: 128 query rows a block, 64 keys a stage; dkv: 128 keys a block,
//     64 query rows a stage.  A consumer waits for its score products,
//     then works through the stage in two halves of 32 columns: the second
//     products of the first half are issued before the exponentials of the
//     second, which run beside them on the tensor cores; it waits for all
//     of them before it releases the stage.  The other consumer fills the
//     remaining gaps.  dk and dv (2 x 64 float32 a thread) with the scores
//     take ~230 registers, hence setmaxnreg.
// What still holds it back: the score products read both operands from
// shared memory (at N = 64 that is about as many bytes a cycle as shared
// memory delivers); each consumer idles the tensor cores between its
// score products and its exponentials; dk/dv recomputes the scores that
// dq computes; tiles on the diagonal are computed whole.
// float32 (the tests' dtype, off the training path): 256 threads, four per
// row, CUDA-core products with 64-row tiles and the same masks; p and ds
// pass through shared memory between them.
// Head dims are zero-padded on chip to 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

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

// The key tiles [j0, j1] (of TK keys) that query rows [q0, q0 + TQ) see.
template <int TQ, int TK>
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int& j0,
                                          int& j1) {
  const int kmax = a.causal ? min(a.S - 1, q0 + TQ - 1) : a.S - 1;
  const int kmin = a.window ? max(0, q0 - a.window + 1) : 0;
  j0 = kmin / TK;
  j1 = kmax / TK;
}

// The query tiles [i0, i1] (of TQ rows) that see keys [k0, k0 + TK).
template <int TQ, int TK>
__device__ __forceinline__ void query_tiles(const Args& a, int k0, int& i0,
                                            int& i1) {
  const int qmin = a.causal ? k0 : 0;
  const int qmax = a.window ? min(a.S - 1, k0 + TK - 1 + a.window - 1)
                            : a.S - 1;
  i0 = qmin / TQ;
  i1 = qmax / TQ;
}

__device__ __forceinline__ const float* row_of(const float* x, const Args& a,
                                               int b, int h) {
  return x + (static_cast<long long>(b) * a.Hq + h) * a.S;
}

// ------------------------------------------------------------------ bf16

typedef __nv_bfloat16 bf16;
constexpr int NT_BF16 = 384;   // consumer warpgroups 0 and 1, producer 2
constexpr int DQ_ROWS = 128;   // query rows a dq block (64 a consumer)
constexpr int DQ_KEYS = 64;    // keys a dq stage
constexpr int DKV_KEYS = 128;  // keys a dk/dv block (64 a consumer)
constexpr int DKV_ROWS = 64;   // query rows a dk/dv stage
constexpr int STAGES = 3;
constexpr int REGS_CONSUMER = 240;   // setmaxnreg: 2 x 128 x 240 + 128 x 24
constexpr int REGS_PRODUCER = 24;    // fits the SM's 65,536 registers

// Byte offsets, from a 1024-byte boundary, of a block's shared memory: two
// resident operands of R rows, STAGES ring stages of two operands of T rows
// each, STATS bytes a stage of per-row floats, then the mbarriers (the
// resident tile's, STAGES "full", STAGES "empty").
template <int DP, int R, int T, int STATS>
struct Layout {
  static constexpr int RES = R * DP * 2;     // one resident operand
  static constexpr int TILE = T * DP * 2;    // one ring operand
  static constexpr int RING = 2 * RES;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int STAT = RING + STAGES * STAGE;
  static constexpr int BARS = STAT + STAGES * STATS;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

template <int DP>
using DqLayout = Layout<DP, DQ_ROWS, DQ_KEYS, 0>;
template <int DP>
using DkvLayout = Layout<DP, DKV_KEYS, DKV_ROWS, 2 * DKV_ROWS * 4>;

// bar[0]: the resident tile (one arrival plus its bytes); bar[1 + s]:
// stage s loaded (likewise); bar[1 + STAGES + s]: stage s released by every
// consumer thread.
__device__ __forceinline__ void init_ring(uint64_t* bar) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(bar + 1 + s, 1);
      hopper::mbar_init(bar + 1 + STAGES + s, 256);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
}

// dq: ds without its scale, in place of s, over half `half` (32 keys) of
// the stage: p = exp2(s * scale * log2(e) - lse * log2(e)), zero outside
// each row's keys [lim[2 i], lim[2 i + 1]] when MASK; ds = p (dp - delta).
// The accumulator's rows are this thread's qp0 (i = 0) and qp1 (i = 1),
// its columns kc + 8 j + c.
template <bool MASK>
__device__ __forceinline__ void dq_scores(float (&sc)[32],
                                          const float (&dp)[32], int half,
                                          float sl2, const float (&nl)[2],
                                          const float (&del)[2], int kc,
                                          const int (&lim)[4]) {
#pragma unroll
  for (int j = 4 * half; j < 4 * half + 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * j + e, i = e >> 1;
      float p = hopper::ex2(__fmaf_rn(sc[x], sl2, nl[i]));
      if (MASK) {
        const int kp = kc + 8 * j + (e & 1);
        p = kp < lim[2 * i] || kp > lim[2 * i + 1] ? 0.f : p;
      }
      sc[x] = p * (dp[x] - del[i]);
    }
  }
}

// dk/dv: p^T in place of s^T and ds^T (without its scale) in place of
// dp^T over half `half` (32 queries) of the stage, whose lse and delta
// rows are stat[0, 64) and stat[64, 128); zero outside each key row's
// queries [lim[2 i], lim[2 i + 1]] when MASK.  The accumulator's rows are
// this thread's two keys, its columns queries q0 + 8 j + 2 t + c.
template <bool MASK>
__device__ __forceinline__ void dkv_scores(float (&st)[32], float (&dpt)[32],
                                           int half, float sl2,
                                           const float* stat, int q0, int t,
                                           const int (&lim)[4]) {
#pragma unroll
  for (int j = 4 * half; j < 4 * half + 4; ++j) {
    const int qi = 8 * j + 2 * t;
    const float2 l2 = *reinterpret_cast<const float2*>(stat + qi);
    const float2 d2 = *reinterpret_cast<const float2*>(stat + DKV_ROWS + qi);
    const float nl[2] = {-(l2.x * LOG2E), -(l2.y * LOG2E)};
    const float dl[2] = {d2.x, d2.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * j + e, i = e >> 1, c = e & 1;
      float p = hopper::ex2(__fmaf_rn(st[x], sl2, nl[c]));
      if (MASK) {
        const int qp = q0 + qi + c;
        p = qp < lim[2 * i] || qp > lim[2 * i + 1] ? 0.f : p;
      }
      st[x] = p;
      dpt[x] = p * (dpt[x] - dl[c]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(NT_BF16, 1)
flash_dq_bf16(const Args a, const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tg) {
  using L = DqLayout<DP>;
  constexpr int NB = DP / 64;                  // boxes of 64 columns a row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = bar + 1;
  uint64_t* empty = full + STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * DQ_ROWS;
  int j0, j1;
  key_tiles<DQ_ROWS, DQ_KEYS>(a, q0, j0, j1);
  const int n = j1 - j0 + 1;
  init_ring(bar);

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // ---- producer: q and dO once, then k and v tile by tile
    hopper::reg_dealloc<REGS_PRODUCER>();
    if (threadIdx.x == 256) {
      hopper::mbar_expect_tx(bar, 2 * L::RES);
      for (int c = 0; c < NB; ++c) {
        hopper::tma_load(smem + c * DQ_ROWS * 128, &tq, bar, 64 * c, q0, h,
                         b);
        hopper::tma_load(smem + L::RES + c * DQ_ROWS * 128, &tg, bar, 64 * c,
                         q0, h, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        hopper::mbar_wait(empty + s, ((i / STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(full + s, L::STAGE);
        unsigned char* st = smem + L::RING + s * L::STAGE;
        const int k0 = (j0 + i) * DQ_KEYS;
        for (int c = 0; c < NB; ++c) {
          hopper::tma_load(st + c * DQ_KEYS * 128, &tk, full + s, 64 * c, k0,
                           hk, b);
          hopper::tma_load(st + L::TILE + c * DQ_KEYS * 128, &tv, full + s,
                           64 * c, k0, hk, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    hopper::reg_alloc<REGS_CONSUMER>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int ra = q0 + 64 * wg;
    const int qp0 = ra + 16 * warp + g, qp1 = qp0 + 8;
    const float* Lr = row_of(a.lse, a, b, h);
    const float* Dr = row_of(a.delta, a, b, h);
    const float sl2 = a.scale * LOG2E;
    const float nl[2] = {-(Lr[qp0] * LOG2E), -(Lr[qp1] * LOG2E)};
    const float del[2] = {Dr[qp0], Dr[qp1]};
    // the keys each of this thread's two query rows sees: [lo, hi]
    const int lim[4] = {a.window ? qp0 - a.window + 1 : -(1 << 30),
                        a.causal ? qp0 : (1 << 30),
                        a.window ? qp1 - a.window + 1 : -(1 << 30),
                        a.causal ? qp1 : (1 << 30)};
    const uint32_t sq0 = hopper::smem_u32(smem) + 64 * 128 * wg;

    float acc[DP / 2];
#pragma unroll
    for (int x = 0; x < DP / 2; ++x) acc[x] = 0.f;

    hopper::mbar_wait(bar, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      const int k0 = (j0 + i) * DQ_KEYS;
      const int kind = tile_kind(a.window, a.causal, ra, ra + 63, k0,
                                  k0 + DQ_KEYS - 1);
      hopper::mbar_wait(full + s, (i / STAGES) & 1);
      if (kind != NONE) {
        const uint32_t sk = hopper::smem_u32(smem + L::RING + s * L::STAGE);
        const uint32_t sv = sk + L::TILE;
        const uint32_t sq = hopper::opaque(sq0), sg = sq + L::RES;
        // s = q k^T and dp = dO v^T over the tile's 64 keys
        float sc[32], dp[32];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t oa = (kk >> 2) * DQ_ROWS * 128 + (kk & 3) * 32;
          const uint32_t ob = (kk >> 2) * DQ_KEYS * 128 + (kk & 3) * 32;
          hopper::wgmma_ss_m64n64k16(sc, hopper::sw128_desc(sq + oa, 16, 1024),
                                     hopper::sw128_desc(sk + ob, 16, 1024),
                                     kk);
          hopper::wgmma_ss_m64n64k16(dp, hopper::sw128_desc(sg + oa, 16, 1024),
                                     hopper::sw128_desc(sv + ob, 16, 1024),
                                     kk);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        hopper::fence_regs(dp);
        // ds without its scale (applied to dq at the end), in two halves of
        // 32 keys; a half's dq += ds k is issued before the next half's
        // exponentials, which overlap it
        const bool all = kind == ALL;
        uint32_t da[DQ_KEYS / 16][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (all)
            dq_scores<false>(sc, dp, half, sl2, nl, del, k0 + 2 * t, lim);
          else
            dq_scores<true>(sc, dp, half, sl2, nl, del, k0 + 2 * t, lim);
#pragma unroll
          for (int k = 2 * half; k < 2 * half + 2; ++k)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              da[k][e] = hopper::pack_bf16(sc[8 * k + 2 * e],
                                           sc[8 * k + 2 * e + 1]);
          hopper::wgmma_fence();
#pragma unroll
          for (int k = 2 * half; k < 2 * half + 2; ++k)
            hopper::wgmma_rs<DP>(
                acc, da[k],
                hopper::sw128_desc(sk + k * 2048, DQ_KEYS * 128, 1024), 1);
          hopper::wgmma_commit();
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        hopper::fence_regs(da);
      }
      hopper::mbar_arrive(empty + s);
    }

    bf16* DQ = static_cast<bf16*>(a.dq) + b * a.dqb + h * a.dqh;
    bf16* o0 = DQ + qp0 * a.dqs + 2 * t;
    bf16* o1 = DQ + qp1 * a.dqs + 2 * t;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j < a.D) {
        *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j] * a.scale,
                                  acc[4 * j + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2] * a.scale,
                                  acc[4 * j + 3] * a.scale);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(NT_BF16, 1)
flash_dkv_bf16(const Args a, const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tg) {
  using L = DkvLayout<DP>;
  constexpr int NB = DP / 64;
  constexpr int STATS = 2 * DKV_ROWS * 4;      // lse, then delta
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = bar + 1;
  uint64_t* empty = full + STAGES;

  const int kt = blockIdx.x;     // the first key tiles see the most queries
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int k0 = kt * DKV_KEYS;
  int i0, i1;
  query_tiles<DKV_ROWS, DKV_KEYS>(a, k0, i0, i1);
  init_ring(bar);

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // ---- producer: k and v once, then q, dO, lse and delta tile by tile
    hopper::reg_dealloc<REGS_PRODUCER>();
    if (threadIdx.x == 256) {
      hopper::mbar_expect_tx(bar, 2 * L::RES);
      for (int c = 0; c < NB; ++c) {
        hopper::tma_load(smem + c * DKV_KEYS * 128, &tk, bar, 64 * c, k0, hk,
                         b);
        hopper::tma_load(smem + L::RES + c * DKV_KEYS * 128, &tv, bar,
                         64 * c, k0, hk, b);
      }
      int i = 0;
      for (int hh = 0; hh < group; ++hh) {
        const int h = hk * group + hh;
        const float* Lr = row_of(a.lse, a, b, h);
        const float* Dr = row_of(a.delta, a, b, h);
        for (int it = i0; it <= i1; ++it, ++i) {
          const int s = i % STAGES;
          const int q0 = it * DKV_ROWS;
          hopper::mbar_wait(empty + s, ((i / STAGES) & 1) ^ 1);
          hopper::mbar_expect_tx(full + s, L::STAGE + STATS);
          unsigned char* st = smem + L::RING + s * L::STAGE;
          for (int c = 0; c < NB; ++c) {
            hopper::tma_load(st + c * DKV_ROWS * 128, &tq, full + s, 64 * c,
                             q0, h, b);
            hopper::tma_load(st + L::TILE + c * DKV_ROWS * 128, &tg, full + s,
                             64 * c, q0, h, b);
          }
          unsigned char* stat = smem + L::STAT + s * STATS;
          hopper::bulk_load(stat, Lr + q0, DKV_ROWS * 4, full + s);
          hopper::bulk_load(stat + DKV_ROWS * 4, Dr + q0, DKV_ROWS * 4,
                            full + s);
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each
    hopper::reg_alloc<REGS_CONSUMER>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int ka = k0 + 64 * wg;
    const int kp0 = ka + 16 * warp + g, kp1 = kp0 + 8;
    const float sl2 = a.scale * LOG2E;
    // the queries each of this thread's two keys sees: [lo, hi]
    const int lim[4] = {a.causal ? kp0 : -(1 << 30),
                        a.window ? kp0 + a.window - 1 : (1 << 30),
                        a.causal ? kp1 : -(1 << 30),
                        a.window ? kp1 + a.window - 1 : (1 << 30)};
    const uint32_t sk0 = hopper::smem_u32(smem) + 64 * 128 * wg;

    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int x = 0; x < DP / 2; ++x) dk[x] = dv[x] = 0.f;

    hopper::mbar_wait(bar, 0);
    int i = 0;
    for (int hh = 0; hh < group; ++hh) {
      for (int it = i0; it <= i1; ++it, ++i) {
        const int s = i % STAGES;
        const int q0 = it * DKV_ROWS;
        const int kind = tile_kind(a.window, a.causal, q0, q0 + DKV_ROWS - 1,
                                    ka, ka + 63);
        hopper::mbar_wait(full + s, (i / STAGES) & 1);
        if (kind != NONE) {
          const uint32_t sq = hopper::smem_u32(smem + L::RING + s * L::STAGE);
          const uint32_t sg = sq + L::TILE;
          const uint32_t sk = hopper::opaque(sk0), sv = sk + L::RES;
          const float* stat =
              reinterpret_cast<const float*>(smem + L::STAT + s * STATS);
          const bool all = kind == ALL;
          // s^T = k q^T and dp^T = v dO^T: keys are rows, queries columns
          float st[32], dpt[32];
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            const uint32_t oa = (kk >> 2) * DKV_KEYS * 128 + (kk & 3) * 32;
            const uint32_t ob = (kk >> 2) * DKV_ROWS * 128 + (kk & 3) * 32;
            hopper::wgmma_ss_m64n64k16(
                st, hopper::sw128_desc(sk + oa, 16, 1024),
                hopper::sw128_desc(sq + ob, 16, 1024), kk);
            hopper::wgmma_ss_m64n64k16(
                dpt, hopper::sw128_desc(sv + oa, 16, 1024),
                hopper::sw128_desc(sg + ob, 16, 1024), kk);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(st);
          hopper::fence_regs(dpt);
          // In two halves of 32 queries: p^T and ds^T (without its scale)
          // of a half, rounded to bf16 A operands, then dv += p^T dO and
          // dk += ds^T q over that half, issued without waiting, so that
          // the second half's exponentials overlap the first half's
          // products.
          uint32_t pa[4][4], da[4][4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (all)
              dkv_scores<false>(st, dpt, half, sl2, stat, q0, t, lim);
            else
              dkv_scores<true>(st, dpt, half, sl2, stat, q0, t, lim);
#pragma unroll
            for (int k = 2 * half; k < 2 * half + 2; ++k)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                pa[k][e] = hopper::pack_bf16(st[8 * k + 2 * e],
                                             st[8 * k + 2 * e + 1]);
                da[k][e] = hopper::pack_bf16(dpt[8 * k + 2 * e],
                                             dpt[8 * k + 2 * e + 1]);
              }
            hopper::wgmma_fence();
#pragma unroll
            for (int k = 2 * half; k < 2 * half + 2; ++k)
              hopper::wgmma_rs<DP>(
                  dv, pa[k],
                  hopper::sw128_desc(sg + k * 2048, DKV_ROWS * 128, 1024),
                  1);
#pragma unroll
            for (int k = 2 * half; k < 2 * half + 2; ++k)
              hopper::wgmma_rs<DP>(
                  dk, da[k],
                  hopper::sw128_desc(sq + k * 2048, DKV_ROWS * 128, 1024),
                  1);
            hopper::wgmma_commit();
          }
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dv);
          hopper::fence_regs(dk);
          hopper::fence_regs(pa);
          hopper::fence_regs(da);
        }
        hopper::mbar_arrive(empty + s);
      }
    }

    bf16* DK = static_cast<bf16*>(a.dk) + b * a.dkb + hk * a.dkh;
    bf16* DV = static_cast<bf16*>(a.dv) + b * a.dvb + hk * a.dvh;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j < a.D) {
        const int c = 8 * j + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(DK + kp0 * a.dks + c) =
            __floats2bfloat162_rn(dk[4 * j] * a.scale,
                                  dk[4 * j + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(DK + kp1 * a.dks + c) =
            __floats2bfloat162_rn(dk[4 * j + 2] * a.scale,
                                  dk[4 * j + 3] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(DV + kp0 * a.dvs + c) =
            __floats2bfloat162_rn(dv[4 * j], dv[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(DV + kp1 * a.dvs + c) =
            __floats2bfloat162_rn(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  }
}

// --------------------------------------------------------------- float32
//
// Thread (row r = tid / 4, lane in row c = tid % 4) computes the scores of
// columns c + 4 jj of the tile and accumulates output columns c + 4 i; the
// scores' products pass through shared memory from the four threads of a
// row to all of them (one warp holds eight whole rows).

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // keys per tile

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
  key_tiles<BQ, BK>(a, q0, j0, j1);
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
  query_tiles<BQ, BK>(a, k0, i0, i1);
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

// A kernel of this library: its function, threads, dynamic shared memory
// and whether it reads tensor maps (the bf16 kernels do).
struct Kernel {
  const void* fn;
  int threads, smem;
  bool maps;
};

// which 0 = dq, 1 = dk/dv; dtype 0 = bf16, 1 = float32.
bool pick(int which, int dtype, int D, Kernel& kn) {
  const bool small = D <= 64;
  if (dtype == 0) {
    kn.threads = NT_BF16;
    kn.maps = true;
    if (which == 0) {
      kn.fn = small ? reinterpret_cast<const void*>(flash_dq_bf16<64>)
                    : reinterpret_cast<const void*>(flash_dq_bf16<128>);
      kn.smem = small ? DqLayout<64>::BYTES : DqLayout<128>::BYTES;
    } else {
      kn.fn = small ? reinterpret_cast<const void*>(flash_dkv_bf16<64>)
                    : reinterpret_cast<const void*>(flash_dkv_bf16<128>);
      kn.smem = small ? DkvLayout<64>::BYTES : DkvLayout<128>::BYTES;
    }
    return true;
  }
  if (dtype == 1) {
    kn.threads = NT_F32;
    kn.maps = false;
    if (which == 0) {
      kn.fn = small ? reinterpret_cast<const void*>(flash_dq_f32<64>)
                    : reinterpret_cast<const void*>(flash_dq_f32<128>);
      kn.smem = small ? smem_dq_f32<64>() : smem_dq_f32<128>();
    } else {
      kn.fn = small ? reinterpret_cast<const void*>(flash_dkv_f32<64>)
                    : reinterpret_cast<const void*>(flash_dkv_f32<128>);
      kn.smem = small ? smem_dkv_f32<64>() : smem_dkv_f32<128>();
    }
    return true;
  }
  return false;
}

// Launch kernel `which` over `grid`.  The bf16 kernels get tensor maps of
// q and dO in boxes of rows_q rows and of k and v in boxes of rows_k.
cudaError_t launch(int which, int dtype, dim3 grid, int rows_q, int rows_k,
                   Args a, cudaStream_t stream) {
  Kernel kn;
  if (!pick(which, dtype, a.D, kn)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kn.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kn.smem);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[4];   // q, k, v, dO
  void* args[5] = {&a, &maps[0], &maps[1], &maps[2], &maps[3]};
  if (kn.maps) {
    const void* base[4] = {a.q, a.k, a.v, a.g};
    const long long* st[4] = {&a.qb, &a.kb, &a.vb, &a.gb};  // b, h, s
    const int heads[4] = {a.Hq, a.Hkv, a.Hkv, a.Hq};
    const int rows[4] = {rows_q, rows_k, rows_k, rows_q};
    for (int m = 0; m < 4; ++m) {
      err = hopper::map_bf16(&maps[m], base[m], a.D, a.S, heads[m], a.B,
                             st[m][2], st[m][1], st[m][0], rows[m]);
      if (err != cudaSuccess) return err;
    }
  }
  err = cudaLaunchKernel(kn.fn, grid, dim3(kn.threads), args,
                         static_cast<size_t>(kn.smem), stream);
  if (err != cudaSuccess) return err;
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
  return !(a.D % 8 || a.D > 128 || a.S % DQ_ROWS || a.S % DKV_KEYS ||
           a.Hkv <= 0 || a.Hq % a.Hkv);
}

}  // namespace

extern "C" {

// dq of every query row.  q, k, v, dO and dq in one dtype (0 = bf16,
// 1 = float32); lse and delta float32 [B, Hq, S] (16-byte aligned for
// bf16).  Returns a CUDA error code (0 on success); the launch does not
// synchronize.
int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dq, const long long* dims,
                        float scale, int dtype, void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.g = dout; a.lse = lse; a.delta = delta;
  a.dq = dq; a.dk = nullptr; a.dv = nullptr;
  a.scale = scale;
  if (!parse(a, dims)) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = dtype == 0 ? DQ_ROWS : BQ;
  const dim3 grid(a.S / rows, a.Hq, a.B);
  return static_cast<int>(launch(0, dtype, grid, DQ_ROWS, DQ_KEYS, a,
                                 static_cast<cudaStream_t>(stream)));
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
  const int keys = dtype == 0 ? DKV_KEYS : BK;
  const dim3 grid(a.S / keys, a.Hkv, a.B);
  return static_cast<int>(launch(1, dtype, grid, DKV_ROWS, DKV_KEYS, a,
                                 static_cast<cudaStream_t>(stream)));
}

// What the compiler made of kernel `which` (0 = dq, 1 = dk/dv) in `dtype`
// for head dim D: out = {registers a thread, local (spill) bytes a thread,
// dynamic shared memory a block, threads a block}.  Returns a CUDA error
// code.
int flash_bwd_kernel_info(int which, int dtype, int D, int* out) {
  Kernel kn;
  if (!pick(which, dtype, D, kn)) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kn.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = kn.smem;
  out[3] = kn.threads;
  return 0;
}

}  // extern "C"
