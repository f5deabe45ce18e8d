// Helpers of the flash attention kernels: the causal/window mask of one
// (query, key) pair and of a tile (flash_fwd.cu, flash_bwd.cu), 16-byte
// tile loads into shared memory with the head dim zero-padded and sums
// over the four threads of a fragment row (their float32 kernels).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ bool visible(int qp, int kp, int window,
                                        int causal) {
  return (!causal || kp <= qp) && (!window || kp > qp - window);
}

enum { NONE = 0, SOME = 1, ALL = 2 };

// Whether query rows [qa, qb] see none, some or all of keys [ka, kb].
__device__ __forceinline__ int tile_kind(int window, int causal, int qa,
                                         int qb, int ka, int kb) {
  if ((causal && ka > qb) || (window && kb <= qa - window)) return NONE;
  if ((!causal || kb <= qa) && (!window || ka > qb - window)) return ALL;
  return SOME;
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
