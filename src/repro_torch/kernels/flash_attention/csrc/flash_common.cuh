// Helpers of the flash attention kernels: the causal/window mask and
// 16-byte tile loads into shared memory with the head dim zero-padded
// (flash_fwd.cu, and flash_bwd.cu's float32 kernels), bf16 fragment loads
// and packing, mma.sync m16n8k16, and sums over the four threads of a
// fragment row (flash_fwd.cu).
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//              a3 = (g+8, 2t+8..)
//   B (16x8):  b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C (16x8):  c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// so the C fragments of two adjacent 8-column blocks are the A fragment of
// one 16-deep step of the next product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ bool visible(int qp, int kp, int window,
                                        int causal) {
  return (!causal || kp <= qp) && (!window || kp > qp - window);
}

// Copy `rows` rows of D elements (a multiple of 16 bytes) into shared
// memory rows of `ld` elements, zero-filling columns D..DP-1.
template <typename T, int DP, int NTHREADS>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long stride, int D, int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = DP / VEC;
  for (int c = threadIdx.x; c < rows * CHUNKS; c += NTHREADS) {
    const int r = c / CHUNKS, cc = c % CHUNKS;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (cc * VEC < D)
      val = *reinterpret_cast<const uint4*>(src + r * stride + cc * VEC);
    *reinterpret_cast<uint4*>(dst + r * ld + cc * VEC) = val;
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  __nv_bfloat162 h;
  h.x = lo;
  h.y = hi;
  return *reinterpret_cast<uint32_t*>(&h);
}

// d += a * b for one 16x8x16 tile (A row-major, B column-major).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
