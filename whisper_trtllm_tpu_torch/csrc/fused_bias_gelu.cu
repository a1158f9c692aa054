// gelu(x + bias) in one pass, for Hopper (sm_90a): the worked example of a
// custom kernel (whisper_trtllm_tpu_torch/examples/custom_kernel).
//
// Replaces examples/custom_kernel/custom_gelu_kernel.py::fused_bias_gelu
// (_kernel): x (rows, D) plus bias (D,) broadcast over the rows, the exact
// GELU 0.5 y (1 + erf(y / sqrt 2)) in fp32, the output in x's dtype; x and
// bias are fp32 or bf16, one dtype. The TPU kernel evaluates erf with the
// Abramowitz-Stegun polynomial because Mosaic has no erf; here it is
// CUDA's erff, as PyTorch's own exact GELU computes it. Any row count is
// taken: the TPU kernel's 256-row tiles belong to its grid.
//
// What bounds it: ~20 flops per element against 8 bytes (fp32) or 4
// (bf16) moved: device memory bandwidth (3.35 TB/s on an H100 SXM); at the
// example's (512, 384) fp32 that is 1.57 MB, 0.47 us, and the launch itself
// takes longer.
//
// Design: one thread an element, a grid-stride loop over the flattened
// (rows, D) array, neighbouring threads on neighbouring addresses; the bias
// column is the element's index modulo D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // 16 blocks on each of the 132 SMs

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_bias_gelu_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                       T* __restrict__ y, long long n, int d) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const float v = to_float(x[i]) + to_float(bias[i % d]);
    store1(y + i, 0.5f * v * (1.0f + erff(v * 0.70710678118654752f)));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* bias, void* y, long long n,
                   int d, cudaStream_t st) {
  const long long want = (n + THREADS - 1) / THREADS;
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  fused_bias_gelu_kernel<T><<<blocks, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias),
      static_cast<T*>(y), n, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y (rows, d) and bias (d,), contiguous, of dtype (0 float32, 1
// bfloat16). Returns a cudaError_t.
int fused_bias_gelu(const void* x, const void* bias, void* y, int rows, int d,
                    int dtype, void* stream) {
  if (rows <= 0 || d <= 0 || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = (long long)rows * d;
  if (dtype == 0) return launch<float>(x, bias, y, n, d, st);
  return launch<__nv_bfloat16>(x, bias, y, n, d, st);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
