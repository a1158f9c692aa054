// Tile helpers shared by the flash-attention forward (K1,
// flash_attention.cu) and backward (K4, flash_attention_bwd.cu): 64-row
// tiles of (rows, dh) fp32 or bf16 tensors staged in shared memory as fp32,
// dh padded to DHP (64 or 128) with zeros, 256 threads a block arranged as
// a 16 x 16 grid (tx = threadIdx.x % 16, ty = threadIdx.x / 16) that each
// own a 4 x 4 patch of a 64 x 64 product tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace flash {

constexpr int BQ = 64;           // query rows per tile
constexpr int BK = 64;           // key/value rows per tile
constexpr int THREADS = 256;     // a 16 x 16 grid of threads
constexpr int PSTRIDE = BK + 4;  // row stride of a probability tile
constexpr float MASKED = -1e9f;  // the JAX package's mask value

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned int*>(&lo);
  raw.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float lane(float4 x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// Rows [0, ROWS) of a (rows, dh) tile starting at `src`, written transposed
// into dst[d * ROWS + r]; rows at or beyond `valid` and columns beyond dh
// are zero.
template <typename T, int ROWS, int DHP>
__device__ __forceinline__ void load_transposed(float* dst, const T* src,
                                                int valid, int dh) {
  const int dh4 = dh / 4;
  for (int e = threadIdx.x; e < ROWS * (DHP / 4); e += THREADS) {
    const int r = e % ROWS, c = e / ROWS;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid && c < dh4) x = load4(src + (size_t)r * dh + 4 * c);
    dst[(4 * c + 0) * ROWS + r] = x.x;
    dst[(4 * c + 1) * ROWS + r] = x.y;
    dst[(4 * c + 2) * ROWS + r] = x.z;
    dst[(4 * c + 3) * ROWS + r] = x.w;
  }
}

// The same tile kept row-major, dst[r * DHP + d], with the same zeros.
template <typename T, int ROWS, int DHP>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int valid,
                                          int dh) {
  for (int e = threadIdx.x; e < ROWS * (DHP / 4); e += THREADS) {
    const int c = e % (DHP / 4), r = e / (DHP / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid && c < dh / 4) x = load4(src + (size_t)r * dh + 4 * c);
    *reinterpret_cast<float4*>(dst + r * DHP + 4 * c) = x;
  }
}

// acc[i][4g + c] += sum_j P[4ty + i][j] * V[j][64g + 4tx + c] over the 64
// columns j of a probability tile `p` (row stride PSTRIDE) and a row-major
// (BK, DHP) tile `v`: the P·V step of the forward, and the dS·K, P^T·dO
// and dS^T·Q steps of the backward.
template <int DHP>
__device__ __forceinline__ void accumulate_pv(float (&acc)[4][4 * (DHP / 64)],
                                              const float* p, const float* v) {
  constexpr int G = DHP / 64;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 2
  for (int j = 0; j < BK; j += 4) {
    float4 p4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p4[i] = *reinterpret_cast<const float4*>(p + (4 * ty + i) * PSTRIDE + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 w = *reinterpret_cast<const float4*>(v + (j + jj) * DHP + g * 64 + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = lane(p4[i], jj);
          acc[i][4 * g + 0] = fmaf(pv, w.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(pv, w.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pv, w.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pv, w.w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// s[i][j] = sum_d a[d][4ty + i] * b[d][4tx + j] over d < dh, for two
// transposed tiles a ([DHP][AROWS]) and b ([DHP][BROWS]).
template <int AROWS, int BROWS>
__device__ __forceinline__ void dot_tile(float (&s)[4][4], const float* a,
                                         const float* b, int dh) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < dh; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(a + d * AROWS + 4 * ty);
    const float4 y = *reinterpret_cast<const float4*>(b + d * BROWS + 4 * tx);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(xv[i], yv[j], s[i][j]);
  }
}

}  // namespace flash
