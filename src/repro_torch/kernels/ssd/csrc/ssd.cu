// Mamba-2 SSD chunked scan for Hopper (sm_90a), written by hand.
//
// Replaces the reference's Pallas `_ssd_kernel`
// (src/repro/kernels/ssd/kernel.py:24).  For each batch row b and head h,
// over chunks of Q steps, with a float32 state [N, P] carried in order:
//   cum    = cumsum(a)                                  [Q]
//   L      = tril(exp(cum_i - cum_j))                   [Q, Q]
//   y      = ((C B^T) * L) x + exp(cum) * (C state)     [Q, P]
//   state  = state * exp(cum[-1]) + (B * exp(cum[-1] - cum))^T x
// B and C ([B, S, N], bf16 or float32) are shared by the H heads of a row;
// x and a are float32; y and the final state are float32.
//
// What bounds it: operations.  The function needs, per (row, chunk), C B^T
// over the causal triangle (Q^2 N flops), and per (row, head, chunk)
// (G * L) x over the triangle (Q^2 P), C state (2 Q N P) and the chunk's
// state (2 Q N P): ~170 flops a byte of x, B and C read, 3.9 ms of float32
// work on the CUDA cores at mamba2's prefill shape against 1.0 ms to move
// x, a, B, C, y and the final state once.  On the tensor cores TF32 keeps
// 11 bits of mantissa, so each float32 operand is split as hi = tf32(v),
// lo = tf32(v - hi) and each product taken as lo*hi + hi*lo + hi*hi (with
// one TF32 pass y is off by ~0.1 and fails the reference's tolerance, 5e-4
// absolute and relative; split, it stays within 5e-4 absolute); bf16 B and
// C are exact in TF32, so C B^T takes one pass and C state and B^T x two.
// Counted that way the products take 1.2 ms at 495 TFLOP/s.  The design
// below moves ~11 GB (x read twice, the chunk states written, read and
// written by the state pass, read again), 3.4 ms at 3.35 TB/s: the state
// workspace is the price of running chunks in parallel.
//
// The design is Mamba-2's own chunked decomposition, in four launches on
// one stream (one wrapper call):
//   1. ssd_prep, a block per (row, chunk): the in-chunk prefix sums of a
//      for every head (one warp a head, sums in a fixed order), and from
//      them log2(e) * cum, exp(cum), exp(cum[-1] - cum) and the chunk's
//      decay exp(cum[-1]) into a small workspace.
//   2. ssd_chunk_state, a block per (row, chunk), chunks in parallel: B of
//      the chunk stays in shared memory while the heads' x tiles stream in
//      (cp.async, two in flight); each head's chunk state
//      S_c = B^T (exp(cum[-1] - cum) * x) goes to the state workspace
//      [B, H, nc, N, P].
//   3. ssd_state_pass, in order over chunks and in parallel over (row,
//      head, state element): state_c = state_{c-1} * decay_{c-1} +
//      S_{c-1}, written over S_c in place (the state entering chunk c); the
//      last is the final state.  Memory-bound.
//   4. ssd_chunk_out, a block per (row, chunk): G = C B^T once for all H
//      heads, over the causal triangle only (16 x 8 tiles above the
//      diagonal are skipped; mma.sync m16n8k8), kept in shared memory in
//      16-row bands; then for each head its entering state and its x
//      stream in (two in flight where B/C are bf16):
//      y = exp(cum) * (C state) + (G * L) x, L = 2^(log2 cum_i - log2 cum_j)
//      computed on the fly from the kept G, masked on the diagonal.
// The per-head products run on wgmma m64n64k8 TF32, one warpgroup per 64
// rows: A (C, B^T or G * L) from registers, built in groups of 4 k-steps
// while the previous group's products run; B (the state, x or
// exp(cum[-1] - cum) * x) from shared memory, where each landed float32
// tile is turned into hi and lo TF32 planes, transposed to K-major with
// the 128-byte swizzle (TF32 wgmma reads both operands K-major only).
// Every sum runs in a fixed order, no atomics: two launches give the same
// bits.  Fragment reads of padded shared-memory tiles hit 32 distinct
// banks.
//
// Smaller shapes (N < 128, P < 64, Q < 128) are zero-padded on chip: padded
// rows and columns contribute exact zeros and are not written.  Tiles come
// in by 16-byte cp.async: the rows of x, B and C start on 16-byte
// boundaries and P is a multiple of 4 (the wrapper refuses other inputs).
//
// Underflow: L is exp of differences (never a ratio of exps), and
// exp(cum) in the off-chunk term may underflow to 0, as in the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QM = 128;           // chunk rows on chip
constexpr int NM = 128;           // state size on chip
constexpr int PM = 64;            // head dim on chip
constexpr int NT = 256;           // threads a block (8 warps, 2 warpgroups)
constexpr int HG = 32;            // heads a prep block holds at a time
constexpr int LDX = PM + 8;       // a landed x or state tile's rows (floats)
constexpr int LDB_T = NM + 8;     // B read transposed (chunk-state kernel)
constexpr int AUX = 3;            // log2(e) cum, exp(cum), exp(cum[-1] - cum)
constexpr int PASS_BATCH = 14;    // chunks a state-pass thread loads at
                                  // once (16 needs 128+ registers: spills)
constexpr int STATE_STAGES = 2;   // staging slots, chunk-state kernel
constexpr int SLOT = QM * LDX + QM;   // floats: a landed tile and its aux row
constexpr int G_FLOATS = 128 * 8 * 8 + 192 * 8;  // the triangle's bands
// a wgmma B operand: PM rows of QM TF32 values, K-major, 128-byte swizzle
// (boxes of 32 columns, 8 KB each); hi and lo planes one after the other
constexpr int PLANE = PM * QM * 4;
constexpr int KSTEPS = QM / 8;    // k-steps of 8 (wgmma m64n64k8)
constexpr int KGROUP = 4;         // k-steps whose A fragments are built at once
constexpr float LOG2E = 1.4426950408889634f;

static_assert(NM == QM, "state and x tiles share the staging slot");

// Band r of G (rows 16 r .. 16 r + 15, columns 0 .. 16 r + 15) starts at
// float g_off(r) with rows g_ld(r) floats apart (= 4 or 20 mod 32 banks).
__host__ __device__ constexpr int g_ld(int r) { return 16 * r + 20; }
__host__ __device__ constexpr int g_off(int r) { return 128 * r * r + 192 * r; }
static_assert(g_off(8) == G_FLOATS, "G bands");

// Rows of C and B read as "row g, column t" fragments: 132 floats (4 banks
// a row) or 136 bf16 (68 words, 4 banks a row).
template <typename T>
__host__ __device__ constexpr int ld_rg() {
  return sizeof(T) == 2 ? 136 : 132;
}

// staging slots of the output kernel: 2 where B and C are bf16, 1 where
// they are float32 (its C takes twice the room)
template <typename T>
__host__ __device__ constexpr int out_stages() {
  return sizeof(T) == 2 ? 2 : 1;
}

// Dynamic shared memory, in bytes (1024 more than the layout: the planes
// start on a 1024-byte boundary, the swizzle's period).
//   chunk state: B [QM][LDB_T] of T | hi, lo planes | staging slots
//   output:      C [QM][ld_rg] of T | G bands | hi, lo planes | staging
//                slots | the item's aux row
template <typename T>
__host__ __device__ constexpr int state_smem() {
  return QM * LDB_T * static_cast<int>(sizeof(T)) + 2 * PLANE +
         STATE_STAGES * SLOT * 4 + 1024;
}
template <typename T>
__host__ __device__ constexpr int out_smem() {
  return QM * ld_rg<T>() * static_cast<int>(sizeof(T)) + G_FLOATS * 4 +
         2 * PLANE + out_stages<T>() * SLOT * 4 + QM * 4 + 1024;
}
static_assert(out_smem<float>() <= 232448 &&
                  out_smem<__nv_bfloat16>() <= 232448 &&
                  state_smem<float>() <= 232448,
              "shared memory of a block");
static_assert((QM * ld_rg<float>() * 4) % 1024 == 0 &&
              (QM * ld_rg<__nv_bfloat16>() * 2) % 1024 == 0 &&
              (G_FLOATS * 4) % 1024 == 0 && (QM * LDB_T * 2) % 1024 == 0,
              "planes on 1024-byte boundaries");
static_assert(QM * ld_rg<float>() * 4 <= 2 * PLANE + SLOT * 4,
              "B fits the planes and a staging slot");

struct Args {
  const float* x;         // [B, H, S, P] through strides
  const float* a;         // [B, H, S] through strides
  const void* bm;         // [B, S, N] through strides, unit last stride
  const void* cm;
  float* y;               // like x
  float* fs;              // [B, H, N, P] contiguous
  float* ws;              // [B, H, nc, N, P]: chunk states, then entering
  float* aux;             // [B, H, nc, AUX, QM]
  float* dec;             // [B, H, nc]: exp(cum[-1]) of each chunk
  int B, H, S, P, N, Q, nc;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (dynamic shared memory is only
// 16-byte aligned by declaration).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// 16 bytes global -> shared; bytes past `bytes` (0..16) are zero-filled.
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS x COLS tile of T from global (rows ldg elements apart, unit column
// stride, every row 16-byte aligned) into shared (rows LDS elements apart)
// by 16-byte cp.async; rows >= nrows and columns >= ncols read as zeros.
// Completes at the caller's cp_wait.
template <typename T, int ROWS, int COLS, int LDS>
__device__ __forceinline__ void load_tile(T* s, const T* g, long long ldg,
                                          int nrows, int ncols) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CPR = COLS / E;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c0 = (i % CPR) * E;
    const bool in = r < nrows && c0 < ncols;
    const int bytes = in ? min(E, ncols - c0) * static_cast<int>(sizeof(T))
                         : 0;
    cp16(s + r * LDS + c0, in ? g + r * ldg + c0 : g, bytes);
  }
}

// QM floats of the aux workspace (16-byte aligned) into shared memory.
__device__ __forceinline__ void load_aux(float* s, const float* g) {
  if (threadIdx.x < QM / 4) cp16(s + 4 * threadIdx.x, g + 4 * threadIdx.x, 16);
}

// ------------------------------------------------- tensor-core products
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v as TF32 hi + lo; for EXACT (a bf16 value) hi = v and lo is not used.
template <bool EXACT>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(v);
    lo = 0u;
  } else {
    hi = tf32(v);
    lo = tf32(v - __uint_as_float(hi));
  }
}

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// d += a b, m16n8k8, TF32 operands, float32 accumulators.  Fragments
// (g = lane / 4, t = lane % 4): a = rows (g, g+8, g, g+8) x columns (t, t,
// t+4, t+4); b = rows (t, t+4) x column g; d = rows (g, g, g+8, g+8) x
// columns (2t, 2t+1, 2t, 2t+1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b with each inexact operand split: lo*hi, hi*lo, then hi*hi.
template <bool AEXACT, bool BEXACT>
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t (&bh)[2],
                                          const uint32_t (&bl)[2]) {
  if (!AEXACT) mma(d, al, bh[0], bh[1]);
  if (!BEXACT) mma(d, ah, bl[0], bl[1]);
  mma(d, ah, bh[0], bh[1]);
}

// A fragment of rows r0.., columns k0.. of a row-major tile.
template <bool EXACT, typename T>
__device__ __forceinline__ void frag_a(const T* s, int ld, int r0, int k0,
                                       uint32_t (&h)[4], uint32_t (&l)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const T* p = s + (r0 + g) * ld + k0 + t;
  split<EXACT>(widen(p[0]), h[0], l[0]);
  split<EXACT>(widen(p[8 * ld]), h[1], l[1]);
  split<EXACT>(widen(p[4]), h[2], l[2]);
  split<EXACT>(widen(p[8 * ld + 4]), h[3], l[3]);
}

// A fragment of rows m0.., columns k0.. of the transpose of a row-major
// tile s (A[m][k] = s[k][m]).
template <bool EXACT, typename T>
__device__ __forceinline__ void frag_a_t(const T* s, int ld, int m0, int k0,
                                         uint32_t (&h)[4], uint32_t (&l)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const T* p = s + (k0 + t) * ld + m0 + g;
  split<EXACT>(widen(p[0]), h[0], l[0]);
  split<EXACT>(widen(p[8]), h[1], l[1]);
  split<EXACT>(widen(p[4 * ld]), h[2], l[2]);
  split<EXACT>(widen(p[4 * ld + 8]), h[3], l[3]);
}

// B fragment (k0.., column c0) of the transpose of a row-major
// [column][k] tile.
template <bool EXACT, typename T>
__device__ __forceinline__ void frag_b_t(const T* s, int ld, int k0, int c0,
                                         uint32_t (&h)[2], uint32_t (&l)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const T* p = s + (c0 + g) * ld + k0 + t;
  split<EXACT>(widen(p[0]), h[0], l[0]);
  split<EXACT>(widen(p[4]), h[1], l[1]);
}

// ------------------------------------------------------------ wgmma
// A descriptor of a 128-byte-swizzled K-major tile at shared address addr
// (8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// The descriptor of k-step ks (8 columns) of a plane at shared address p.
__device__ __forceinline__ uint64_t plane_desc(uint32_t p, int ks) {
  return sw128_desc(p + (ks >> 2) * 8192 + (ks & 3) * 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the registers across
// this point (an accumulator after a wait, an A operand until its product
// has completed).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// d += A B for a 64 x 64 tile, K = 8, TF32: A in registers (per warp the
// m16n8k8 A fragment of its 16 rows), B K-major in shared memory.  The
// accumulator: d[4 j + 2 i + c] = element (16 w + g + 8 i, 8 j + 2 t + c).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Issues one group of KGROUP k-steps from k-step ks0: d += A B with A's
// fragments ah/al (lo unused if AEXACT) and B's hi and lo planes at shared
// addresses bh, bl; passes lo*hi, hi*lo, hi*hi per k-step.
template <bool AEXACT>
__device__ __forceinline__ void wgmma_group(float (&d)[32],
                                            uint32_t (&ah)[KGROUP][4],
                                            uint32_t (&al)[KGROUP][4],
                                            uint32_t bh, uint32_t bl,
                                            int ks0) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KGROUP; ++s) {
    if (!AEXACT) wgmma_tf32(d, al[s], plane_desc(bh, ks0 + s));
    wgmma_tf32(d, ah[s], plane_desc(bl, ks0 + s));
    wgmma_tf32(d, ah[s], plane_desc(bh, ks0 + s));
  }
  wgmma_commit();
}

// d += A B over `groups` groups of KGROUP k-steps (an even number), A's
// fragments built by gen(ah, al, ks0) into two buffers in turn: a group's
// fragments are built while the previous group's products run.  Waits for
// every product before it returns.
template <bool AEXACT, typename Gen>
__device__ __forceinline__ void wgmma_product(float (&d)[32], int groups,
                                              uint32_t bh, uint32_t bl,
                                              Gen gen) {
  uint32_t ah0[KGROUP][4], al0[KGROUP][4], ah1[KGROUP][4], al1[KGROUP][4];
#pragma unroll 1
  for (int grp = 0; grp < groups; grp += 2) {
    gen(ah0, al0, grp * KGROUP);
    wgmma_group<AEXACT>(d, ah0, al0, bh, bl, grp * KGROUP);
    if (grp > 0) {               // group grp - 1 is done with buffer 1
      wgmma_wait<1>();
      fence_regs(ah1);
      fence_regs(al1);
    }
    gen(ah1, al1, (grp + 1) * KGROUP);
    wgmma_group<AEXACT>(d, ah1, al1, bh, bl, (grp + 1) * KGROUP);
    wgmma_wait<1>();             // group grp is done with buffer 0
    fence_regs(ah0);
    fence_regs(al0);
  }
  wgmma_wait<0>();
  fence_regs(d);
  fence_regs(ah1);
  fence_regs(al1);
}

// A landed [QM][LDX] tile (rows: the contraction k, columns p), each row k
// scaled by f[k] if f, into the hi and lo TF32 planes of a wgmma B operand
// at `planes`: plane row p holds columns k, 16-byte chunk c of a 128-byte
// row at chunk c ^ (p % 8).  Every thread: 8 chunks of 4 k.  The caller
// syncs the block before the planes are read.
__device__ __forceinline__ void to_planes(const float* tile, const float* f,
                                          unsigned char* planes) {
  const int p = threadIdx.x & (PM - 1), kq = threadIdx.x / PM;
#pragma unroll 4
  for (int it = 0; it < QM / 4 / (NT / PM); ++it) {
    const int q = kq + (NT / PM) * it;   // k = 4 q .. 4 q + 3
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = tile[(4 * q + e) * LDX + p] * (f ? f[4 * q + e] : 1.f);
      split<false>(v, h[e], l[e]);
    }
    const int off = (q >> 3) * 8192 + p * 128 + (((q & 7) ^ (p & 7)) << 4);
    *reinterpret_cast<uint4*>(planes + off) =
        make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(planes + PLANE + off) =
        make_uint4(l[0], l[1], l[2], l[3]);
  }
  // wgmma reads shared memory through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------ 1. prep
// a block per (chunk, row): every head's cum, from a read as [Q, H] tiles
__global__ void __launch_bounds__(NT) ssd_prep(const Args a) {
  __shared__ float sa[HG][QM + 1];
  const int c = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long s0 = static_cast<long long>(c) * a.Q;
  for (int h0 = 0; h0 < a.H; h0 += HG) {
    __syncthreads();             // the previous group's scans are done
    for (int i = tid; i < QM * HG; i += NT) {
      const int q = i / HG, hh = i % HG, h = h0 + hh;
      sa[hh][q] = (q < a.Q && h < a.H)
                      ? a.a[b * a.ab + h * a.ah + (s0 + q) * a.as] : 0.f;
    }
    __syncthreads();
    for (int hh = warp; hh < HG && h0 + hh < a.H; hh += NT / 32) {
      // lane l: steps 4 l .. 4 l + 3, summed in order, then the lanes'
      // totals scanned (steps 1, 2, 4, 8, 16)
      float v[4];
      v[0] = sa[hh][4 * lane];
#pragma unroll
      for (int j = 1; j < 4; ++j) v[j] = v[j - 1] + sa[hh][4 * lane + j];
      float inc = v[3];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += u;
      }
      float before = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) before = 0.f;
      float cum[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) cum[j] = before + v[j];
      const float last = __shfl_sync(0xffffffffu, cum[3], 31);
      const long long bh = static_cast<long long>(b) * a.H + h0 + hh;
      float* out = a.aux + ((bh * a.nc + c) * AUX) * QM + 4 * lane;
      reinterpret_cast<float4*>(out)[0] = make_float4(
          cum[0] * LOG2E, cum[1] * LOG2E, cum[2] * LOG2E, cum[3] * LOG2E);
      reinterpret_cast<float4*>(out + QM)[0] = make_float4(
          expf(cum[0]), expf(cum[1]), expf(cum[2]), expf(cum[3]));
      reinterpret_cast<float4*>(out + 2 * QM)[0] = make_float4(
          expf(last - cum[0]), expf(last - cum[1]), expf(last - cum[2]),
          expf(last - cum[3]));
      if (lane == 0) a.dec[bh * a.nc + c] = expf(last);
    }
  }
}

// ----------------------------------------------------- 2. chunk states
// a block per (chunk, row); warpgroup wg: state rows 64 wg .. 64 wg + 63,
// its warp w the 16 of them from 64 wg + 16 w; every head's
// S_c = B^T (d * x) with d = exp(cum[-1] - cum)
template <typename T>
__global__ void __launch_bounds__(NT, 1) ssd_chunk_state(const Args a) {
  constexpr bool EXACT = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  T* sB = reinterpret_cast<T*>(smem);
  unsigned char* planes = smem + QM * LDB_T * sizeof(T);
  float* stage = reinterpret_cast<float*>(planes + 2 * PLANE);
  const uint32_t ph = smem_u32(planes), pl = ph + PLANE;
  const int c = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * warp;      // = 64 wg + 16 (warp % 4)
  const long long s0 = static_cast<long long>(c) * a.Q;
  load_tile<T, QM, NM, LDB_T>(
      sB, static_cast<const T*>(a.bm) + b * a.bb + s0 * a.bs, a.bs, a.Q, a.N);
  auto issue = [&](int h) {
    if (h < a.H) {
      float* slot = stage + (h % STATE_STAGES) * SLOT;
      const long long bh = static_cast<long long>(b) * a.H + h;
      load_tile<float, QM, PM, LDX>(slot, a.x + b * a.xb + h * a.xh +
                                              s0 * a.xs,
                                    a.xs, a.Q, a.P);
      load_aux(slot + QM * LDX, a.aux + ((bh * a.nc + c) * AUX + 2) * QM);
    }
    cp_commit();
  };
#pragma unroll
  for (int h = 0; h < STATE_STAGES; ++h) issue(h);
  const long long NP = static_cast<long long>(a.N) * a.P;
  for (int h = 0; h < a.H; ++h) {
    cp_wait<STATE_STAGES - 1>();
    __syncthreads();             // head h landed; h - 1's products are done
    const float* slot = stage + (h % STATE_STAGES) * SLOT;
    to_planes(slot, slot + QM * LDX, planes);
    __syncthreads();             // the planes are whole; the slot is free
    issue(h + STATE_STAGES);
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    wgmma_product<EXACT>(
        acc, KSTEPS / KGROUP, ph, pl,
        [&](uint32_t (&ah)[KGROUP][4], uint32_t (&al)[KGROUP][4], int ks0) {
#pragma unroll
          for (int s = 0; s < KGROUP; ++s)
            frag_a_t<EXACT>(sB, LDB_T, m0, 8 * (ks0 + s), ah[s], al[s]);
        });
    // S_c of head h: rows n, columns p of [N, P]
    float* out = a.ws + ((static_cast<long long>(b) * a.H + h) * a.nc + c) * NP;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = m0 + g + 8 * i, p = 8 * j + 2 * t;
        if (n >= a.N || p >= a.P) continue;
        *reinterpret_cast<float2*>(out + n * a.P + p) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
  }
}

// ------------------------------------------------------ 3. state pass
// thread: 4 consecutive elements of one (row, head)'s [N, P] state (P is a
// multiple of 4), walked over the chunks in order, PASS_BATCH chunks'
// loads at a time; state * decay + update as two roundings, as the plain
// version takes it
__global__ void __launch_bounds__(NT) ssd_state_pass(const Args a) {
  const long long E = static_cast<long long>(a.N) * a.P / 4;
  const long long e = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (e >= E) return;
  const long long bh = blockIdx.y;
  const int nc = a.nc;
  float4* w = reinterpret_cast<float4*>(a.ws) + bh * nc * E + e;
  const float* dec = a.dec + bh * nc;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += PASS_BATCH) {
    float4 v[PASS_BATCH];
#pragma unroll
    for (int j = 0; j < PASS_BATCH; ++j)
      if (c0 + j < nc) v[j] = w[(c0 + j) * E];
#pragma unroll
    for (int j = 0; j < PASS_BATCH; ++j)
      if (c0 + j < nc) {
        w[(c0 + j) * E] = s;          // the state entering chunk c0 + j
        const float d = dec[c0 + j];
        s = make_float4(s.x * d + v[j].x, s.y * d + v[j].y,
                        s.z * d + v[j].z, s.w * d + v[j].w);
      }
  }
  reinterpret_cast<float4*>(a.fs)[bh * E + e] = s;
}

// ----------------------------------------------------------- 4. output
// a block per (chunk, row).  G = C B^T: warp w computes its tiles in the
// 16-row bands w % 4 and 7 - w % 4 (mma.sync).  Then per head, warpgroup
// wg: y rows 64 wg .. 64 wg + 63, its warp w the 16 from 16 w (wgmma).
template <typename T>
__global__ void __launch_bounds__(NT, 1) ssd_chunk_out(const Args a) {
  constexpr bool EXACT = sizeof(T) == 2;
  constexpr int LDC = ld_rg<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  T* sC = reinterpret_cast<T*>(smem);
  float* sG = reinterpret_cast<float*>(smem + QM * LDC * sizeof(T));
  unsigned char* planes = reinterpret_cast<unsigned char*>(sG + G_FLOATS);
  float* stage = reinterpret_cast<float*>(planes + 2 * PLANE);
  constexpr int NS = out_stages<T>();
  float* aux = stage + NS * SLOT;            // the item's aux row
  T* sB = reinterpret_cast<T*>(planes);      // until G is computed
  const uint32_t ph = smem_u32(planes), pl = ph + PLANE;
  const int c = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long s0 = static_cast<long long>(c) * a.Q;
  load_tile<T, QM, NM, LDC>(
      sC, static_cast<const T*>(a.cm) + b * a.cb + s0 * a.cs, a.cs, a.Q, a.N);
  load_tile<T, QM, NM, LDC>(
      sB, static_cast<const T*>(a.bm) + b * a.bb + s0 * a.bs, a.bs, a.Q, a.N);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // ---- G = C B^T: band r holds its tiles 0 .. 2 r + 1 of 8 columns; warp
  // w computes those of parity w / 4 in bands w % 4 and 7 - w % 4
  {
    const int pr = warp & 3, half = warp >> 2;
#pragma unroll 1
    for (int side = 0; side < 2; ++side) {
      const int r = side ? 7 - pr : pr;
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2
      for (int k0 = 0; k0 < NM; k0 += 8) {
        uint32_t ah[4], al[4];
        frag_a<EXACT>(sC, LDC, 16 * r, k0, ah, al);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j <= r) {
            uint32_t bh[2], bl[2];
            frag_b_t<EXACT>(sB, LDC, k0, 8 * (2 * j + half), bh, bl);
            mma_split<EXACT, EXACT>(acc[j], ah, al, bh, bl);
          }
      }
      float* band = sG + g_off(r);
      const int ld = g_ld(r);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j <= r) {
          const int col = 8 * (2 * j + half) + 2 * t;
          *reinterpret_cast<float2*>(band + g * ld + col) =
              make_float2(acc[j][0], acc[j][1]);
          *reinterpret_cast<float2*>(band + (g + 8) * ld + col) =
              make_float2(acc[j][2], acc[j][3]);
        }
    }
  }
  __syncthreads();               // G is whole; B's space becomes the planes

  // ---- the heads: item 2h = head h's entering state and exp(cum), item
  // 2h + 1 = its x and log2(e) cum
  const int items = 2 * a.H;
  const long long NP = static_cast<long long>(a.N) * a.P;
  auto issue = [&](int item) {
    if (item < items) {
      float* slot = stage + (item % NS) * SLOT;
      const int h = item >> 1;
      const long long bhc = (static_cast<long long>(b) * a.H + h) * a.nc + c;
      if (item & 1) {
        load_tile<float, QM, PM, LDX>(slot, a.x + b * a.xb + h * a.xh +
                                                s0 * a.xs,
                                      a.xs, a.Q, a.P);
        load_aux(slot + QM * LDX, a.aux + (bhc * AUX + 0) * QM);
      } else {
        if (c > 0)               // the state entering chunk 0 is zero
          load_tile<float, NM, PM, LDX>(slot, a.ws + bhc * NP, a.P, a.N,
                                        a.P);
        load_aux(slot + QM * LDX, a.aux + (bhc * AUX + 1) * QM);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int i = 0; i < NS; ++i) issue(i);

  const int r0 = 16 * warp;      // this warp's 16 rows: 64 wg + 16 (w % 4)
  const int band = warp;         // their band of G
  const float* grow = sG + g_off(band) + g * g_ld(band) + t;
  const int gld = g_ld(band);
  float acc[32];
#pragma unroll 1
  for (int item = 0; item < items; ++item) {
    cp_wait<NS - 1>();
    __syncthreads();             // item landed; item - 1's products are done
    const bool odd = item & 1;
    const float* slot = stage + (item % NS) * SLOT;
    if (odd || c > 0) to_planes(slot, nullptr, planes);
    if (threadIdx.x < QM) aux[threadIdx.x] = slot[QM * LDX + threadIdx.x];
    __syncthreads();             // planes and aux row whole; the slot is free
    issue(item + NS);
    if (!odd) {
      // -- exp(cum) (C state): the contraction runs over the state's rows
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      if (c > 0)
        wgmma_product<EXACT>(
            acc, KSTEPS / KGROUP, ph, pl,
            [&](uint32_t (&ah)[KGROUP][4], uint32_t (&al)[KGROUP][4],
                int ks0) {
#pragma unroll
              for (int s = 0; s < KGROUP; ++s)
                frag_a<EXACT>(sC, LDC, r0, 8 * (ks0 + s), ah[s], al[s]);
            });
      const float e0 = aux[r0 + g], e1 = aux[r0 + g + 8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[4 * j] *= e0;
        acc[4 * j + 1] *= e0;
        acc[4 * j + 2] *= e1;
        acc[4 * j + 3] *= e1;
      }
      continue;
    }
    // -- (G * L) x over the triangle, L = 2^(c2_i - c2_j) for j <= i; a
    // warpgroup's k-steps end at its last row (8 or 16), a warp's band at
    // column 16 band + 15 (zeros past it)
    const int h = item >> 1;
    const int i0 = r0 + g, i1 = i0 + 8;
    const float ci0 = aux[i0], ci1 = aux[i1];
    const int ksteps = (warp >> 2) ? KSTEPS : KSTEPS / 2;
    wgmma_product<false>(
        acc, ksteps / KGROUP, ph, pl,
        [&](uint32_t (&ah)[KGROUP][4], uint32_t (&al)[KGROUP][4], int ks0) {
#pragma unroll
          for (int s = 0; s < KGROUP; ++s) {
            const int j0 = 8 * (ks0 + s) + t, j1 = j0 + 4;
            float m[4] = {0.f, 0.f, 0.f, 0.f};
            if (j0 <= i1) {      // inside the band (j0 <= 16 band + 15)
              const float cj0 = aux[j0], cj1 = aux[min(j1, QM - 1)];
              const float* gr = grow + 8 * (ks0 + s);
              m[0] = j0 <= i0 ? gr[0] * ex2(ci0 - cj0) : 0.f;
              m[1] = gr[8 * gld] * ex2(ci1 - cj0);
              m[2] = j1 <= i0 ? gr[4] * ex2(ci0 - cj1) : 0.f;
              m[3] = j1 <= i1 ? gr[8 * gld + 4] * ex2(ci1 - cj1) : 0.f;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split<false>(m[e], ah[s][e], al[s][e]);
          }
        });
    // -- y rows of this head
    float* Y = a.y + b * a.yb + h * a.yh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = r0 + g + 8 * i;
      if (q >= a.Q) continue;
      float* row = Y + (s0 + q) * a.ys;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * j + 2 * t;
        if (p < a.P)
          *reinterpret_cast<float2*>(row + p) =
              make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 chunks(a.nc, a.B);
  ssd_prep<<<chunks, NT, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_chunk_state<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             state_smem<T>());
  if (err != cudaSuccess) return err;
  ssd_chunk_state<T><<<chunks, NT, state_smem<T>(), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long vecs = static_cast<long long>(a.N) * a.P / 4;
  const dim3 grid(static_cast<unsigned>((vecs + NT - 1) / NT), a.B * a.H);
  ssd_state_pass<<<grid, NT, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_chunk_out<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             out_smem<T>());
  if (err != cudaSuccess) return err;
  ssd_chunk_out<T><<<chunks, NT, out_smem<T>(), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The interface of ssd_launch below: 2.  (The first port's single-kernel
// ssd_launch, with no workspace, exported no tag: 1.)
int ssd_abi() { return 2; }

// Dynamic shared memory, in bytes, of a block of kernel k, by its place in
// a call's launches (0 ssd_prep, 1 ssd_chunk_state, 2 ssd_state_pass, 3
// ssd_chunk_out), for B/C of bc_dtype (0 float32, 1 bf16); -1 for any
// other k or bc_dtype.
int ssd_smem_bytes(int k, int bc_dtype) {
  if (bc_dtype != 0 && bc_dtype != 1) return -1;
  const bool bf = bc_dtype == 1;
  switch (k) {
    case 0:
    case 2:
      return 0;
    case 1:
      return bf ? state_smem<__nv_bfloat16>() : state_smem<float>();
    case 3:
      return bf ? out_smem<__nv_bfloat16>() : out_smem<float>();
    default:
      return -1;
  }
}

// dims: B, H, S, P, N, Q, then the (batch, head, sequence) element strides
// of x and of a, the (batch, sequence) strides of B and of C, the (batch,
// head, sequence) strides of y (19 values).  ws: [B, H, S / Q, N, P]
// float32, aux: [B, H, S / Q, 3, 128] float32, dec: [B, H, S / Q] float32,
// all written before they are read.  bc_dtype: 0 = float32, 1 = bf16.
// The rows of x, B, C and y start on 16-byte boundaries and P is a multiple
// of 4 (the wrapper checks).  Returns a CUDA error code (0 on success); the
// launches do not synchronize.
int ssd_launch(const float* x, const float* a, const void* bm,
               const void* cm, float* y, float* fs, float* ws, float* aux,
               float* dec, const long long* dims, int bc_dtype,
               void* stream) {
  Args g;
  g.x = x; g.a = a; g.bm = bm; g.cm = cm; g.y = y; g.fs = fs;
  g.ws = ws; g.aux = aux; g.dec = dec;
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
      g.P % 4 || g.N <= 0 || g.N > NM || g.Q <= 0 || g.Q > QM || g.S % g.Q ||
      static_cast<long long>(g.B) * g.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  g.nc = g.S / g.Q;
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
