// 16-byte vector access to rows in device memory and the one-wave launch
// size, shared by the LayerNorm (layer_norm.cu: K5) and the bias+GELU
// example (fused_bias_gelu.cu: K8), both elementwise passes over rows that
// device memory bandwidth or the launch itself bounds.
//
// - Pack<T, N>: N values of T read or written as one access of up to 16
//   bytes (two where 8 fp32 parameters sit beside 8 bf16 values).
// - load_stream / store_stream: x read once and y written once go through
//   the cache as evict-first (streaming) accesses when they are 16 bytes.
// - one_wave: at most as many blocks as the card holds at once, from the
//   kernel's occupancy (its registers) at the block size, asked once a
//   kernel and block size, and the SM count once a device.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vector_access {

constexpr int MAX_THREADS = 256;  // both kernels' __launch_bounds__
constexpr int MAX_DEVICES = 64;

template <typename T, int N>
struct alignas(N * sizeof(T) >= 16 ? 16 : N * sizeof(T)) Pack {
  T v[N];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename P>
__device__ __forceinline__ P load_stream(const P* p) {
  if constexpr (sizeof(P) == 16) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    P r;
    __builtin_memcpy(&r, &u, 16);
    return r;
  } else {
    return *p;
  }
}

template <typename P>
__device__ __forceinline__ void store_stream(P* p, const P& v) {
  if constexpr (sizeof(P) == 16) {
    uint4 u;
    __builtin_memcpy(&u, &v, 16);
    __stcs(reinterpret_cast<uint4*>(p), u);
  } else {
    *p = v;
  }
}

// `resident` is the kernel's own cache (a static of its launch function),
// by block size; a wave is shared out over `chunks` blocks of the grid's y
template <typename Kernel>
int one_wave(Kernel kernel, int (&resident)[MAX_THREADS + 1], int threads, int blocks,
             int chunks = 1) {
  static int sms[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES) return blocks;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  int& per_sm = resident[threads];
  if (per_sm == 0) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const int wave = per_sm * sms[dev] / chunks;
  return wave < 1 ? 1 : wave < blocks ? wave : blocks;
}

inline bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<size_t>(p) % 16 == 0;
}

}  // namespace vector_access
