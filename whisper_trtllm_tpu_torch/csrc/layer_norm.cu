// LayerNorm over the last axis for Hopper (sm_90a): fp32 statistics
// whatever the storage, output in the input's dtype.
//
// Replaces whisper_trtllm_tpu/ops/pallas/layer_norm.py::layer_norm_fused
// (_kernel), which computes the JAX package's ops/functional.py::layer_norm:
// mean = sum(x) / d, var = sum((x - mean)^2) / d (two passes, not
// E[x^2] - mean^2), y = (x - mean) * rsqrt(var + eps) * scale (+ bias).
// x and y are fp32 or bf16; scale and bias are fp32 or bf16 (one dtype);
// bias may be absent.
//
// What bounds it: ~8 flops per element against 4-8 bytes moved. At the
// encoder's 6000 x 384 rows (batch 4) that is device memory bandwidth
// (3.35 TB/s on an H100 SXM: 0.0055 ms in fp32, 0.0028 in bf16); at the
// decode step's 4 rows it is latency: one launch and one round trip to
// device memory.
//
// Design (the plan comes from ops/kernels/layer_norm.py::norm_plan):
// - x, y, scale and bias move as 16-byte vectors of VEC values (4 fp32 or
//   8 bf16) where d and every pointer allow it; otherwise VEC is 1, the
//   scalar path of the same kernel.
// - A group of `lpr` lanes (a power of two) shares a row, lane l of the
//   group holding vectors l, l + lpr, ... (VPT of them) in registers, so
//   neighbouring lanes read neighbouring 16 bytes; 32 / lpr rows a warp.
//   Both sums are xor shuffles inside the group: no shared memory, no
//   barrier. The variance is the second pass over the registers.
// - Each thread loads its scale and bias vectors once, before its rows.
// - One wave of blocks (the plan's blocks, cut to what the card holds at
//   once by the kernel's occupancy); each warp walks its rows a grid's
//   stride apart with the next row's loads issued before the current row
//   reduces. x and y go through the cache as streaming accesses. A call
//   whose rows fit in one block launches just the warps they need.
// - At the decode shape every load (scale, bias, x) is issued before the
//   first shuffle: one dependent round trip, then the store. Where the
//   plan fills every lane's vectors (d = lpr * VPT * VEC, as at d 384) a
//   second instantiation drops the per-vector bounds checks: at 4 rows
//   the kernel's time is its instruction chain as much as its memory, so
//   rows that fit in one block take 32 lanes a row, with 8-byte vectors
//   where those fill the lanes exactly and 16-byte ones do not (bf16 at
//   d 384: 12 values a lane, not 24). 1 / d is taken while the loads are
//   in flight, so mean = sum * (1 / d), within an ulp of sum / d.
// - No programmatic dependent launch: loading scale and bias before the
//   kernel ahead ends would race a kernel that writes them, and in the
//   decode loop, whose host leaves the card idle between launches, it
//   gained nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vector_access.cuh"

namespace {

using namespace vector_access;

constexpr int MAX_D = 2048;

template <int VEC>
__device__ __forceinline__ Pack<float, VEC> pack_out(const float (&o)[VEC], float) {
  Pack<float, VEC> r;
#pragma unroll
  for (int e = 0; e < VEC; ++e) r.v[e] = o[e];
  return r;
}

template <int VEC>
__device__ __forceinline__ Pack<__nv_bfloat16, VEC> pack_out(const float (&o)[VEC],
                                                             __nv_bfloat16) {
  Pack<__nv_bfloat16, VEC> r;
  if constexpr (VEC % 2 == 0) {
#pragma unroll
    for (int e = 0; e < VEC; e += 2) {  // one conversion a pair
      const __nv_bfloat162 two = __floats2bfloat162_rn(o[e], o[e + 1]);
      r.v[e] = two.x;
      r.v[e + 1] = two.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) r.v[e] = __float2bfloat16(o[e]);
  }
  return r;
}

// vector v of a lane lies in the row: always when the plan fills every
// lane's VPT vectors (FULL)
template <bool FULL>
__device__ __forceinline__ bool in_row(int j, int nv) { return FULL || j < nv; }

// the xor tree over a row's group of lpr lanes, unrolled: every lane ends
// with the same sum, added in the same order
__device__ __forceinline__ float group_sum(float x, int lpr) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    if (off < lpr) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the VPT vectors of one row that a lane holds, zeros where the row or
// the vector lies past the end
template <typename T, int VEC, int VPT, bool FULL>
__device__ __forceinline__ void load_row(Pack<T, VEC> (&out)[VPT], const T* __restrict__ p,
                                         int row, int rows, int d, int gl, int lpr) {
  const int nv = d / VEC;
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int j = gl + lpr * v;
    out[v] = (row < rows && in_row<FULL>(j, nv))
                 ? load_stream(reinterpret_cast<const Pack<T, VEC>*>(
                       p + (size_t)row * d + (size_t)j * VEC))
                 : Pack<T, VEC>{};
  }
}

template <typename XT, typename PT, int VEC, int VPT, bool FULL>
__global__ void __launch_bounds__(MAX_THREADS)
layer_norm_kernel(const XT* __restrict__ x, const PT* __restrict__ scale,
                  const PT* __restrict__ bias, XT* __restrict__ y, int rows,
                  int d, int lpr, float eps) {
  using XP = Pack<XT, VEC>;
  using PP = Pack<PT, VEC>;
  const int nv = d / VEC;
  const int lane = threadIdx.x % 32;
  const int gl = lane % lpr;  // the lane's place in its row's group
  const int rpw = 32 / lpr;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int stride = gridDim.x * (blockDim.x / 32) * rpw;  // rows a grid's pass
  int base = warp * rpw;                                  // the warp's first row
  int row = base + lane / lpr;

  PP sp[VPT], bp[VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int j = gl + lpr * v;
    sp[v] = in_row<FULL>(j, nv) ? *reinterpret_cast<const PP*>(scale + (size_t)j * VEC) : PP{};
    bp[v] = (bias != nullptr && in_row<FULL>(j, nv))
                ? *reinterpret_cast<const PP*>(bias + (size_t)j * VEC)
                : PP{};
  }
  XP cur[VPT];
  load_row<XT, VEC, VPT, FULL>(cur, x, row, rows, d, gl, lpr);
  const float inv_d = 1.f / d;  // while the loads are in flight

  for (; base < rows; base += stride, row += stride) {  // uniform over the warp
    XP nxt[VPT];
    if (base + stride < rows)  // uniform: a one-pass launch skips it
      load_row<XT, VEC, VPT, FULL>(nxt, x, row + stride, rows, d, gl, lpr);

    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < VPT; ++v)
#pragma unroll
      for (int e = 0; e < VEC; ++e) sum += to_float(cur[v].v[e]);
    const float mean = group_sum(sum, lpr) * inv_d;
    float sq = 0.f;
#pragma unroll
    for (int v = 0; v < VPT; ++v)
      if (in_row<FULL>(gl + lpr * v, nv)) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float dv = to_float(cur[v].v[e]) - mean;
          sq += dv * dv;
        }
      }
    const float rstd = rsqrtf(group_sum(sq, lpr) * inv_d + eps);
    if (row < rows) {
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        const int j = gl + lpr * v;
        if (in_row<FULL>(j, nv)) {
          float o[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            o[e] = (to_float(cur[v].v[e]) - mean) * rstd * to_float(sp[v].v[e]);
            if (bias != nullptr) o[e] += to_float(bp[v].v[e]);
          }
          store_stream(reinterpret_cast<XP*>(y + (size_t)row * d + (size_t)j * VEC),
                       pack_out<VEC>(o, XT{}));
        }
      }
    }
#pragma unroll
    for (int v = 0; v < VPT; ++v) cur[v] = nxt[v];
  }
}

template <typename XT, typename PT, int VEC, int VPT, bool FULL>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* y, int rows,
                   int d, int lpr, float eps, int blocks, int threads, cudaStream_t st) {
  static int resident[MAX_THREADS + 1];
  const auto kernel = layer_norm_kernel<XT, PT, VEC, VPT, FULL>;
  kernel<<<one_wave(kernel, resident, threads, blocks), threads, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const PT*>(scale),
      static_cast<const PT*>(bias), static_cast<XT*>(y), rows, d, lpr, eps);
  return cudaGetLastError();
}

// the instantiated vectors a lane: norm_plan's VECTOR_VPTS, HALF_VPTS and
// SCALAR_VPTS
template <typename XT, typename PT, int VEC, bool FULL, int... VPTS>
cudaError_t dispatch(int vpt, const void* x, const void* scale, const void* bias, void* y,
                     int rows, int d, int lpr, float eps, int blocks, int threads,
                     cudaStream_t st) {
  cudaError_t err = cudaErrorInvalidValue;
  ((vpt == VPTS && (err = launch<XT, PT, VEC, VPTS, FULL>(x, scale, bias, y, rows, d, lpr,
                                                           eps, blocks, threads, st),
                    true)) ||
   ...);
  return err;
}

template <typename XT, typename PT>
cudaError_t dispatch_vec(int vec, int vpt, bool full, const void* x, const void* scale,
                         const void* bias, void* y, int rows, int d, int lpr, float eps,
                         int blocks, int threads, cudaStream_t st) {
  constexpr int WIDE = 16 / sizeof(XT);
  if (vec == 1)
    return dispatch<XT, PT, 1, false, 1, 2, 3, 4, 8, 16, 32, 64>(
        vpt, x, scale, bias, y, rows, d, lpr, eps, blocks, threads, st);
  if (vec == WIDE / 2)  // 8-byte vectors: rows that fit one block, 32 lanes
    return full ? dispatch<XT, PT, WIDE / 2, true, 1, 2, 3, 4>(
                      vpt, x, scale, bias, y, rows, d, lpr, eps, blocks, threads, st)
                : cudaErrorInvalidValue;
  if (full)
    return dispatch<XT, PT, WIDE, true, 1, 2, 3, 4, 6, 8, 12, 16>(
        vpt, x, scale, bias, y, rows, d, lpr, eps, blocks, threads, st);
  return dispatch<XT, PT, WIDE, false, 1, 2, 3, 4, 6, 8, 12, 16>(
      vpt, x, scale, bias, y, rows, d, lpr, eps, blocks, threads, st);
}

}  // namespace

extern "C" {

// x, y (rows, d) contiguous in x_dtype (0 float32, 1 bfloat16); scale and
// bias (d,) in p_dtype (same codes); bias may be null. d <= 2048. The plan
// (ops/kernels/layer_norm.py::norm_plan): vec values a vector (1, or 16
// bytes of x's dtype, or 8 where that fills 32 lanes a row exactly; both
// need d % vec == 0 and every pointer on 16 bytes), lpr lanes a row (a
// power of two up to 32), vpt vectors a lane (lpr * vpt * vec >= d),
// blocks of threads (a multiple of 32 up to 256), of which at most one
// wave is launched. Returns a cudaError_t.
int layer_norm(const void* x, const void* scale, const void* bias, void* y,
               int rows, int d, float eps, int x_dtype, int p_dtype, int vec,
               int lpr, int vpt, int blocks, int threads, void* stream) {
  if (rows <= 0 || d <= 0 || d > MAX_D || x_dtype < 0 || x_dtype > 1 ||
      p_dtype < 0 || p_dtype > 1 || blocks <= 0 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 || lpr < 1 || lpr > 32 ||
      (lpr & (lpr - 1)) != 0 || (long long)lpr * vpt * vec < d)
    return cudaErrorInvalidValue;
  const int wide = x_dtype == 0 ? 4 : 8;
  if (vec != 1 && ((vec != wide && vec != wide / 2) || d % vec != 0 || !aligned16(x) ||
                   !aligned16(scale) || !aligned16(bias) || !aligned16(y)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool full = lpr * vpt * vec == d;  // no lane holds a vector past the row
  if (x_dtype == 0 && p_dtype == 0)
    return dispatch_vec<float, float>(vec, vpt, full, x, scale, bias, y, rows, d, lpr, eps,
                                      blocks, threads, st);
  if (x_dtype == 0)
    return dispatch_vec<float, __nv_bfloat16>(vec, vpt, full, x, scale, bias, y, rows, d, lpr,
                                              eps, blocks, threads, st);
  if (p_dtype == 0)
    return dispatch_vec<__nv_bfloat16, float>(vec, vpt, full, x, scale, bias, y, rows, d, lpr,
                                              eps, blocks, threads, st);
  return dispatch_vec<__nv_bfloat16, __nv_bfloat16>(vec, vpt, full, x, scale, bias, y, rows, d,
                                                    lpr, eps, blocks, threads, st);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
