// Flash attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the reference's Pallas `_fwd_kernel`
// (src/repro/kernels/flash_attention/kernel.py:44): causal softmax attention
// with an optional sliding window (kpos > qpos - window) and GQA (query head
// h reads KV head h / (Hq / Hkv)), returning o in q's dtype and
// lse = m + log(max(l, 1e-30)) in float32 (natural log: the backward reads
// it), with scale 1/sqrt(D).
//
// What bounds it: operations (4 D flops per visible (query, key) pair
// against ~2 D * 2 bytes per key row read once), so the tensor cores must
// be kept fed and every intermediate stays on chip.  One block per (128-row
// query tile, head, batch row) walks the key tiles that the causal mask and
// the window leave visible (tiles wholly outside the window are skipped,
// which the reference does not do) with the online softmax in registers.
//
// bf16 (the serving and training paths): blocks of three warpgroups
// (hopper.cuh), as in flash_bwd.cu.
//   * One producer warpgroup (setmaxnreg 24), whose first thread issues
//     every copy with TMA: the block's q tile once, then the k and v tiles
//     of 128 keys into a ring of STAGES stages, k and v each with their own
//     "loaded" and "released" mbarriers, so a k tile is refilled as soon as
//     its scores are computed.  Tensor maps over the 4-D strided tensors
//     read [B, S, H, D] views in place; TMA's out-of-bounds fill supplies
//     the zero columns D..DP-1 (D = 120 -> 128).
//   * Two consumer warpgroups (setmaxnreg 240), each owning 64 query rows.
//     s = q k^T is a wgmma m64n128 with both operands in shared memory,
//     K-major; o += p v a wgmma with p from registers (rounded to bf16
//     pairwise: the accumulator of s is the A operand, p never passes
//     through shared memory) and v in shared memory, MN-major.
//   * The two consumers take turns on the tensor cores (FlashAttention-3's
//     ping-pong): a consumer's turn issues s of its next tile, then o += p
//     v of its previous tile, and hands the turn over (named barriers 1 and
//     2); it waits for s alone, runs that tile's softmax while its o += p v
//     and the other consumer's products run, then waits for the rest.
//   * Softmax in base 2: log2(e) is folded into the scale, so each p is one
//     explicit fused multiply-add (the library is built with --fmad=false)
//     and one ex2; lse goes back to the natural log at the end.  The element
//     mask runs only on tiles that straddle the diagonal or the window's
//     edge for the consumer's rows (a separate, branch-free instantiation of
//     the softmax step); there masked scores take the finite NEG_INF in the
//     row maximum and p = 0.  A row with no visible key in such a tile keeps
//     l = 0 and a maximum near NEG_INF, which the next tile's correction
//     ex2(m_old - m_new) = 0 wipes; every row sees its own key.
//   * Blocks are launched longest rows first (the query tile is the slowest
//     grid dimension), so the causal shape's short blocks fill the tail.
// float32 (the tests' dtype, off the main paths): 256 threads, four per
// query row, 64-row tiles, CUDA-core FMAs; every sum is float32 throughout
// (the checks hold it to 2e-5).
// Head dims are padded on chip to 64 or 128 (D = 120 -> 128); any D that is
// a multiple of 8 up to 128 is taken.  Inputs are read through strides, so
// [B, S, H, D] activations need no copy to [B*H, S, D].

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

// The key tiles [j0, j1] (of TK keys) that query rows [q0, q0 + TQ) see.
template <int TQ, int TK>
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int& j0,
                                          int& j1) {
  const int kmax = a.causal ? min(a.S - 1, q0 + TQ - 1) : a.S - 1;
  const int kmin = a.window ? max(0, q0 - a.window + 1) : 0;
  j0 = kmin / TK;
  j1 = kmax / TK;
}

__device__ __forceinline__ float* lse_row(const Args& a, int b, int h) {
  return a.lse + (static_cast<long long>(b) * a.Hq + h) * a.S;
}

// ------------------------------------------------------------------ bf16

typedef __nv_bfloat16 bf16;
constexpr int NT_BF16 = 384;   // consumer warpgroups 0 and 1, producer 2
constexpr int FWD_ROWS = 128;  // query rows a block (64 a consumer)
constexpr int FWD_KEYS = 128;  // keys a stage
constexpr int STAGES = 3;
constexpr int REGS_CONSUMER = 240;   // setmaxnreg: 2 x 128 x 240 + 128 x 24
constexpr int REGS_PRODUCER = 24;    // fits the SM's 65,536 registers
constexpr float LN2 = 0.6931471805599453f;

// Byte offsets, from a 1024-byte boundary, of a block's shared memory: the
// q tile, STAGES stages of a k and a v tile, then the mbarriers (q's, then
// STAGES each of "k loaded", "v loaded", "k released", "v released").  At
// DP 128: 32 KB + 3 x 64 KB, 230,504 bytes with the alignment slack, of
// the 232,448 a block may have.
template <int DP>
struct Layout {
  static constexpr int Q = FWD_ROWS * DP * 2;
  static constexpr int TILE = FWD_KEYS * DP * 2;    // k or v
  static constexpr int STAGE = 2 * TILE;
  static constexpr int BARS = Q + STAGES * STAGE;
  static constexpr int BYTES = BARS + 8 * (1 + 4 * STAGES) + 1024;
};

// Row i's 32 values of the accumulator (x = 4 j + 2 i + c) folded with
// op, as a tree: 5 steps of latency instead of 31.
template <typename Op>
__device__ __forceinline__ float fold_row(const float (&v)[64], int i,
                                          Op op) {
  float r[16];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    r[j] = op(v[4 * j + 2 * i], v[4 * j + 2 * i + 1]);
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = op(r[j], r[j + 8]);
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = op(r[j], r[j + 4]);
  return op(op(r[0], r[2]), op(r[1], r[3]));
}

// One tile's online softmax for this thread's two rows (i = 0: qp0, 1:
// qp1) in base 2: the raw scores sc become p = 2^(sc * sl2 - m) in place,
// m moves to the new row maximum (scaled), l (this thread's share of the
// row sum) is rescaled and grows, and c returns the factor 2^(m_old -
// m_new) that rescales the output rows.  When MASK, keys outside each row's
// [lim[2 i], lim[2 i + 1]] count as NEG_INF in the maximum and give p = 0.
// The accumulator's columns are kc + 8 j + c (x = 4 j + 2 i + c).
template <bool MASK>
__device__ __forceinline__ void softmax_step(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&c)[2],
                                             float sl2, int kc,
                                             const int (&lim)[4]) {
  const auto fmax2 = [](float x, float y) { return fmaxf(x, y); };
  const auto add2 = [](float x, float y) { return x + y; };
  if (MASK) {
#pragma unroll
    for (int x = 0; x < 64; ++x) {
      const int i = (x >> 1) & 1;
      const int kp = kc + 8 * (x >> 2) + (x & 1);
      sc[x] = kp < lim[2 * i] || kp > lim[2 * i + 1] ? NEG_INF : sc[x];
    }
  }
  float nm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mn = fmaxf(m[i], quad_max(fold_row(sc, i, fmax2)) * sl2);
    c[i] = hopper::ex2(m[i] - mn);
    m[i] = mn;
    nm[i] = -mn;
  }
#pragma unroll
  for (int x = 0; x < 64; ++x) {
    const int i = (x >> 1) & 1;
    const float p = hopper::ex2(__fmaf_rn(sc[x], sl2, nm[i]));
    sc[x] = MASK && sc[x] == NEG_INF ? 0.f : p;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * c[i] + fold_row(sc, i, add2);
}

// The softmax of the stage of keys [k0, k0 + 128) for rows [ra, ra + 64)
// once their scores have landed in sc (p in place); c returns the factor
// that rescales the output rows.
__device__ __forceinline__ void softmax_tile(const Args& a, int ra, int k0,
                                             int t, float sl2,
                                             const int (&lim)[4],
                                             float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&c)[2]) {
  if (tile_kind(a.window, a.causal, ra, ra + 63, k0, k0 + FWD_KEYS - 1) ==
      ALL)
    softmax_step<false>(sc, m, l, c, sl2, k0 + 2 * t, lim);
  else
    softmax_step<true>(sc, m, l, c, sl2, k0 + 2 * t, lim);
}

// The output rows rescaled by c, and p (in sc) into pa as 8 A steps of 16
// keys.
template <int DP>
__device__ __forceinline__ void rescale_and_pack(float (&o)[DP / 2],
                                                 uint32_t (&pa)[8][4],
                                                 const float (&sc)[64],
                                                 const float (&c)[2]) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    o[4 * j] *= c[0];
    o[4 * j + 1] *= c[0];
    o[4 * j + 2] *= c[1];
    o[4 * j + 3] *= c[1];
  }
#pragma unroll
  for (int k = 0; k < FWD_KEYS / 16; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[k][e] = hopper::pack_bf16(sc[8 * k + 2 * e], sc[8 * k + 2 * e + 1]);
}

// s = q k^T over one stage: 64 rows of q by 128 keys, DP deep, from the
// descriptors of the q rows' and the k tile's first 16 columns (a step is
// a byte offset, added to the descriptor's address field in 16-byte
// units: no carry, shared addresses are below 2^18).
template <int DP>
__device__ __forceinline__ void issue_scores(float (&sc)[64], uint64_t dq,
                                             uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t oa = (kk >> 2) * FWD_ROWS * 128 + (kk & 3) * 32;
    const uint32_t ob = (kk >> 2) * FWD_KEYS * 128 + (kk & 3) * 32;
    hopper::wgmma_ss_m64n128k16(sc, dq + (oa >> 4), dk + (ob >> 4), kk);
  }
}

// o += p v over one stage: p as 8 A steps of 16 keys, v MN-major from the
// descriptor of its first 16 rows.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&pa)[8][4],
                                         uint64_t dv) {
#pragma unroll
  for (int k = 0; k < FWD_KEYS / 16; ++k)
    hopper::wgmma_rs<DP>(o, pa[k], dv + ((k * 2048) >> 4), 1);
}

template <int DP>
__global__ void __launch_bounds__(NT_BF16, 1)
flash_fwd_bf16(const Args a, const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv) {
  using L = Layout<DP>;
  constexpr int NB = DP / 64;                  // boxes of 64 columns a row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full_k = bar + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;   // longest rows first
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * FWD_ROWS;
  int j0, j1;
  key_tiles<FWD_ROWS, FWD_KEYS>(a, q0, j0, j1);
  const int n = j1 - j0 + 1;
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full_k + s, 1);
      hopper::mbar_init(full_v + s, 1);
      hopper::mbar_init(empty_k + s, 256);
      hopper::mbar_init(empty_v + s, 256);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // ---- producer: q once, then k and v tile by tile
    hopper::reg_dealloc<REGS_PRODUCER>();
    if (threadIdx.x == 256) {
      hopper::mbar_expect_tx(bar, L::Q);
      for (int c = 0; c < NB; ++c)
        hopper::tma_load(smem + c * FWD_ROWS * 128, &tq, bar, 64 * c, q0, h,
                         b);
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        const int k0 = (j0 + i) * FWD_KEYS;
        // k, then v, each once the tile it replaces has been released
        for (int kv = 0; kv < 2; ++kv) {
          uint64_t* f = (kv ? full_v : full_k) + s;
          hopper::mbar_wait((kv ? empty_v : empty_k) + s,
                            ((i / STAGES) & 1) ^ 1);
          hopper::mbar_expect_tx(f, L::TILE);
          unsigned char* dst = smem + L::Q + s * L::STAGE + kv * L::TILE;
          for (int c = 0; c < NB; ++c)
            hopper::tma_load(dst + c * FWD_KEYS * 128, kv ? &tv : &tk, f,
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
    const float sl2 = a.scale * LOG2E;
    // the keys each of this thread's two query rows sees: [lo, hi]
    const int lim[4] = {a.window ? qp0 - a.window + 1 : -(1 << 30),
                        a.causal ? qp0 : (1 << 30),
                        a.window ? qp1 - a.window + 1 : -(1 << 30),
                        a.causal ? qp1 : (1 << 30)};
    // descriptors of this consumer's q rows, of stage 0's k and v tiles;
    // stage s is STAGE bytes further
    const uint64_t dq = hopper::sw128_desc(
        hopper::smem_u32(smem) + 64 * 128 * wg, 16, 1024);
    const uint32_t ring = hopper::smem_u32(smem + L::Q);
    const uint64_t dk0 = hopper::sw128_desc(ring, 16, 1024);
    const uint64_t dv0 =
        hopper::sw128_desc(ring + L::TILE, FWD_KEYS * 128, 1024);
    constexpr uint32_t STEP = L::STAGE >> 4;
    // named barrier 1 + w: consumer w's turn on the tensor cores
    const int mine = 1 + wg, other = 2 - wg;

    float o[DP / 2], sc[64];
    uint32_t pa[FWD_KEYS / 16][4];
#pragma unroll
    for (int x = 0; x < DP / 2; ++x) o[x] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    // Turn i issues o += p v of tile i - 1 and s of tile i; consumer 0
    // takes the first turn.  Each consumer syncs n + 1 times on its barrier
    // and the other arrives there n + 1 times.
    if (wg == 1) hopper::bar_arrive(other, 256);
    hopper::mbar_wait(bar, 0);
    hopper::mbar_wait(full_k, 0);
    hopper::bar_sync(mine, 256);
    hopper::wgmma_fence();
    issue_scores<DP>(sc, dq, dk0);
    hopper::wgmma_commit();
    hopper::bar_arrive(other, 256);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::mbar_arrive(empty_k);
    float c[2];
    softmax_tile(a, ra, j0 * FWD_KEYS, t, sl2, lim, sc, m, l, c);
    rescale_and_pack<DP>(o, pa, sc, c);
    for (int i = 1; i < n; ++i) {
      const int s = i % STAGES, sp = (i - 1) % STAGES;
      const int k0 = (j0 + i) * FWD_KEYS;
      hopper::mbar_wait(full_k + s, (i / STAGES) & 1);
      hopper::mbar_wait(full_v + sp, ((i - 1) / STAGES) & 1);
      hopper::bar_sync(mine, 256);
      hopper::wgmma_fence();
      issue_scores<DP>(sc, dq, dk0 + s * STEP);
      hopper::wgmma_commit();
      // o += p v of the previous tile runs on the tensor cores while this
      // tile's exponentials run
      issue_pv<DP>(o, pa, dv0 + sp * STEP);
      hopper::wgmma_commit();
      hopper::bar_arrive(other, 256);
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);
      hopper::mbar_arrive(empty_k + s);       // k of tile i is read
      softmax_tile(a, ra, k0, t, sl2, lim, sc, m, l, c);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::fence_regs(pa);
      hopper::mbar_arrive(empty_v + sp);      // v of tile i - 1 is read
      rescale_and_pack<DP>(o, pa, sc, c);
    }
    hopper::mbar_wait(full_v + (n - 1) % STAGES, ((n - 1) / STAGES) & 1);
    hopper::bar_sync(mine, 256);
    hopper::wgmma_fence();
    issue_pv<DP>(o, pa, dv0 + ((n - 1) % STAGES) * STEP);
    hopper::wgmma_commit();
    if (wg == 0) hopper::bar_arrive(other, 256);   // consumer 1's last turn
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::fence_regs(pa);

    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = fmaxf(quad_sum(l[i]), 1e-30f);
      inv[i] = 1.f / l[i];
    }
    bf16* O = static_cast<bf16*>(a.o) + b * a.ob + h * a.oh;
    bf16* o0 = O + qp0 * a.os + 2 * t;
    bf16* o1 = O + qp1 * a.os + 2 * t;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j < a.D) {
        *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
            __floats2bfloat162_rn(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
        *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv[1],
                                  o[4 * j + 3] * inv[1]);
      }
    }
    if (t == 0) {
      float* Lr = lse_row(a, b, h);
      Lr[qp0] = m[0] * LN2 + logf(l[0]);
      Lr[qp1] = m[1] * LN2 + logf(l[1]);
    }
  }
}

// --------------------------------------------------------------- float32
//
// Thread (row r = tid / 4, lane in row c = tid % 4) scores keys c + 4 jj of
// each tile and accumulates output columns c + 4 i; the probabilities pass
// through shared memory from the four threads of a row to all of them.

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // keys per tile
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
  key_tiles<BQ, BK>(a, q0, j0, j1);
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
  if (c == 0) lse_row(a, b, h)[qp] = m + logf(l);
}

// A kernel of this library: its function, threads, dynamic shared memory
// and whether it reads tensor maps (the bf16 ones do).
struct Kernel {
  const void* fn;
  int threads, smem;
  bool maps;
};

// dtype 0 = bf16, 1 = float32.
bool pick(int dtype, int D, Kernel& kn) {
  const bool small = D <= 64;
  if (dtype == 0) {
    kn.fn = small ? reinterpret_cast<const void*>(flash_fwd_bf16<64>)
                  : reinterpret_cast<const void*>(flash_fwd_bf16<128>);
    kn.threads = NT_BF16;
    kn.smem = small ? Layout<64>::BYTES : Layout<128>::BYTES;
    kn.maps = true;
    return true;
  }
  if (dtype == 1) {
    kn.fn = small ? reinterpret_cast<const void*>(flash_fwd_f32<64>)
                  : reinterpret_cast<const void*>(flash_fwd_f32<128>);
    kn.threads = NT_F32;
    kn.smem = small ? smem_f32<64>() : smem_f32<128>();
    kn.maps = false;
    return true;
  }
  return false;
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
  Kernel kn;
  if (a.D % 8 || a.D > 128 || a.S % FWD_ROWS || a.Hkv <= 0 ||
      a.Hq % a.Hkv || !pick(dtype, a.D, kn))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kn.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kn.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[3];   // q, k, v
  void* args[4] = {&a, &maps[0], &maps[1], &maps[2]};
  dim3 grid(a.S / BQ, a.Hq, a.B);
  if (kn.maps) {
    const void* base[3] = {a.q, a.k, a.v};
    const long long* st[3] = {&a.qb, &a.kb, &a.vb};   // b, h, s
    const int heads[3] = {a.Hq, a.Hkv, a.Hkv};
    const int rows[3] = {FWD_ROWS, FWD_KEYS, FWD_KEYS};
    for (int m = 0; m < 3; ++m) {
      err = hopper::map_bf16(&maps[m], base[m], a.D, a.S, heads[m], a.B,
                             st[m][2], st[m][1], st[m][0], rows[m]);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    grid = dim3(a.Hq, a.B, a.S / FWD_ROWS);
  }
  err = cudaLaunchKernel(kn.fn, grid, dim3(kn.threads), args,
                         static_cast<size_t>(kn.smem),
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// What the compiler made of the kernel for `dtype` and head dim D: out =
// {registers a thread, local (spill) bytes a thread, dynamic shared memory
// a block, threads a block}.  Returns a CUDA error code.
int flash_fwd_kernel_info(int dtype, int D, int* out) {
  Kernel kn;
  if (!pick(dtype, D, kn)) return static_cast<int>(cudaErrorInvalidValue);
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
