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
// What bounds it: ~8 flops per element against 4-8 bytes moved: device
// memory bandwidth (3.35 TB/s on an H100 SXM) for the encoder's 6000 x 384
// rows at batch 4, and the launch itself for the decode step's 4 rows.
//
// Design: one warp per row, 8 rows per block of 256 threads. Lane l holds
// elements l, l + 32, ... of its row in registers (12 at d = 384), so the
// row is read once from device memory, with neighbouring lanes on
// neighbouring addresses; both sums are warp shuffles, so no shared memory
// and no block barrier is needed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// VPL: values per lane, d <= 32 * VPL
template <typename XT, typename PT, int VPL>
__global__ void __launch_bounds__(THREADS)
layer_norm_kernel(const XT* __restrict__ x, const PT* __restrict__ scale,
                  const PT* __restrict__ bias, XT* __restrict__ y, int rows,
                  int d, float eps) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp leaves together
  const XT* xr = x + (size_t)row * d;
  XT* yr = y + (size_t)row * d;

  float v[VPL];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < d ? to_float(xr[c]) : 0.f;
    sum += v[i];
  }
  const float mean = warp_sum(sum) / d;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    const float dv = v[i] - mean;
    sq += c < d ? dv * dv : 0.f;
  }
  const float rstd = rsqrtf(warp_sum(sq) / d + eps);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < d) {
      float out = (v[i] - mean) * rstd * to_float(scale[c]);
      if (bias != nullptr) out += to_float(bias[c]);
      store1(yr + c, out);
    }
  }
}

template <typename XT, typename PT>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* y,
                   int rows, int d, float eps, cudaStream_t st) {
  const dim3 grid((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  const XT* xp = static_cast<const XT*>(x);
  const PT* sp = static_cast<const PT*>(scale);
  const PT* bp = static_cast<const PT*>(bias);
  XT* yp = static_cast<XT*>(y);
  if (d <= 32 * 4)
    layer_norm_kernel<XT, PT, 4><<<grid, THREADS, 0, st>>>(xp, sp, bp, yp, rows, d, eps);
  else if (d <= 32 * 8)
    layer_norm_kernel<XT, PT, 8><<<grid, THREADS, 0, st>>>(xp, sp, bp, yp, rows, d, eps);
  else if (d <= 32 * 16)
    layer_norm_kernel<XT, PT, 16><<<grid, THREADS, 0, st>>>(xp, sp, bp, yp, rows, d, eps);
  else if (d <= 32 * 32)
    layer_norm_kernel<XT, PT, 32><<<grid, THREADS, 0, st>>>(xp, sp, bp, yp, rows, d, eps);
  else
    layer_norm_kernel<XT, PT, 64><<<grid, THREADS, 0, st>>>(xp, sp, bp, yp, rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y (rows, d) contiguous in x_dtype (0 float32, 1 bfloat16); scale and
// bias (d,) in p_dtype (same codes); bias may be null. d <= 2048. Returns a
// cudaError_t.
int layer_norm(const void* x, const void* scale, const void* bias, void* y,
               int rows, int d, float eps, int x_dtype, int p_dtype,
               void* stream) {
  if (rows <= 0 || d <= 0 || d > 32 * 64 || x_dtype < 0 || x_dtype > 1 ||
      p_dtype < 0 || p_dtype > 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && p_dtype == 0)
    return launch<float, float>(x, scale, bias, y, rows, d, eps, st);
  if (x_dtype == 0)
    return launch<float, __nv_bfloat16>(x, scale, bias, y, rows, d, eps, st);
  if (p_dtype == 0)
    return launch<__nv_bfloat16, float>(x, scale, bias, y, rows, d, eps, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, bias, y, rows, d, eps, st);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
