// gelu(x + bias) in one pass, for Hopper (sm_90a): the worked example of a
// custom kernel (whisper_trtllm_tpu_torch/examples/custom_kernel).
//
// Replaces examples/custom_kernel/custom_gelu_kernel.py::fused_bias_gelu
// (_kernel): x (rows, D) plus bias (D,) broadcast over the rows, the exact
// GELU 0.5 y (1 + erf(y / sqrt 2)) in fp32, the output in x's dtype; x and
// bias are fp32 or bf16, one dtype. The TPU kernel evaluates erf with the
// Abramowitz-Stegun polynomial because Mosaic has no erf; here it is
// CUDA's erff, as PyTorch's own exact GELU computes it. Any row count and
// any D are taken: the TPU kernel's 256-row tiles belong to its grid.
//
// What bounds it: ~20 flops per element against 8 bytes (fp32) or 4
// (bf16) moved: device memory bandwidth (3.35 TB/s on an H100 SXM). At
// the example's (512, 384) fp32 that is 1.57 MB, 0.47 us, less than one
// launch; at the encoder MLP's fc1 output at batch 4, (6000, 1536), it is
// 73.7 MB in fp32, 0.022 ms.
//
// Design (the plan comes from examples/custom_kernel/custom_gelu_kernel.py::
// gelu_plan): a block is `tx` column threads by `ty` rows. Thread x of a
// row takes the 16-byte vectors (4 fp32 or 8 bf16 values) x, x + tx, ...
// (CPT of them) of its block's column chunk (blockIdx.y), loads their bias
// once into registers and walks the rows a grid's stride apart, the next
// row's loads issued before this row computes; no index is taken modulo
// D. x and y go through the cache as streaming accesses. One wave of
// blocks: the plan's row blocks cut to what the card holds at once by the
// kernel's occupancy. A D that does not divide into vectors, or a pointer
// off a 16-byte boundary, takes VEC = 1, the scalar path of the same
// kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "vector_access.cuh"

namespace {

using namespace vector_access;

constexpr int MAX_CHUNKS = 65535;  // gridDim.y

// the CPT vectors of one row that a thread takes, where the row and the
// vector lie inside x
template <typename T, int VEC, int CPT>
__device__ __forceinline__ void load_row(Pack<T, VEC> (&out)[CPT], const T* __restrict__ x,
                                         int row, int rows, int d, int j0, int tx) {
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = j0 + tx * c;
    if (row < rows && j < d / VEC)
      out[c] = load_stream(reinterpret_cast<const Pack<T, VEC>*>(x + (size_t)row * d +
                                                                  (size_t)j * VEC));
  }
}

template <typename T, int VEC, int CPT>
__global__ void __launch_bounds__(MAX_THREADS)
fused_bias_gelu_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                       T* __restrict__ y, int rows, int d, int tx) {
  using P = Pack<T, VEC>;
  const int nv = d / VEC;
  const int ty = blockDim.x / tx;
  const int j0 = blockIdx.y * tx * CPT + threadIdx.x % tx;  // first vector
  const int stride = gridDim.x * ty;
  int row = blockIdx.x * ty + threadIdx.x / tx;
  P bb[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = j0 + tx * c;
    bb[c] = j < nv ? *reinterpret_cast<const P*>(bias + (size_t)j * VEC) : P{};
  }
  P cur[CPT];
  load_row<T, VEC, CPT>(cur, x, row, rows, d, j0, tx);
  for (; row < rows; row += stride) {
    P nxt[CPT];  // the next row's loads in flight while this one computes
    load_row<T, VEC, CPT>(nxt, x, row + stride, rows, d, j0, tx);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = j0 + tx * c;
      if (j < nv) {
        P o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float v = to_float(cur[c].v[e]) + to_float(bb[c].v[e]);
          o.v[e] = from_float<T>(0.5f * v * (1.0f + erff(v * 0.70710678118654752f)));
        }
        store_stream(reinterpret_cast<P*>(y + (size_t)row * d + (size_t)j * VEC), o);
      }
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c) cur[c] = nxt[c];
  }
}

template <typename T, int VEC, int CPT>
cudaError_t launch(const void* x, const void* bias, void* y, int rows, int d, int tx, int ty,
                   int chunks, int blocks, cudaStream_t st) {
  static int resident[MAX_THREADS + 1];
  const auto kernel = fused_bias_gelu_kernel<T, VEC, CPT>;
  kernel<<<dim3(one_wave(kernel, resident, tx * ty, blocks, chunks), chunks), tx * ty, 0,
           st>>>(static_cast<const T*>(x), static_cast<const T*>(bias), static_cast<T*>(y),
                 rows, d, tx);
  return cudaGetLastError();
}

// the instantiated vectors a thread: gelu_plan's MAX_CPT
template <typename T, int VEC>
cudaError_t dispatch(int cpt, const void* x, const void* bias, void* y, int rows, int d,
                     int tx, int ty, int chunks, int blocks, cudaStream_t st) {
  switch (cpt) {
    case 1: return launch<T, VEC, 1>(x, bias, y, rows, d, tx, ty, chunks, blocks, st);
    case 2: return launch<T, VEC, 2>(x, bias, y, rows, d, tx, ty, chunks, blocks, st);
    case 3: return launch<T, VEC, 3>(x, bias, y, rows, d, tx, ty, chunks, blocks, st);
    case 4: return launch<T, VEC, 4>(x, bias, y, rows, d, tx, ty, chunks, blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x, y (rows, d) and bias (d,), contiguous, of dtype (0 float32, 1
// bfloat16). The plan (custom_gelu_kernel.py::gelu_plan): vec values a
// vector (1, or 16 bytes of the dtype, which needs d % vec == 0 and every
// pointer on 16 bytes), cpt vectors a thread (1 to 4), blocks of tx
// column threads by ty rows (tx * ty <= 256), chunks column chunks
// (chunks * tx * cpt * vec >= d), blocks row blocks, of which at most one
// wave is launched. Returns a cudaError_t.
int fused_bias_gelu(const void* x, const void* bias, void* y, int rows, int d,
                    int dtype, int vec, int cpt, int tx, int ty, int chunks,
                    int blocks, void* stream) {
  if (rows <= 0 || d <= 0 || dtype < 0 || dtype > 1 || tx <= 0 || ty <= 0 ||
      tx * ty > MAX_THREADS || chunks <= 0 || chunks > MAX_CHUNKS || blocks <= 0 ||
      (long long)chunks * tx * cpt * vec < d)
    return cudaErrorInvalidValue;
  const int wide = dtype == 0 ? 4 : 8;
  if (vec != 1 && (vec != wide || d % vec != 0 || !aligned16(x) || !aligned16(bias) ||
                   !aligned16(y)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec == 1 ? dispatch<float, 1>(cpt, x, bias, y, rows, d, tx, ty, chunks, blocks, st)
                    : dispatch<float, 4>(cpt, x, bias, y, rows, d, tx, ty, chunks, blocks, st);
  return vec == 1
             ? dispatch<__nv_bfloat16, 1>(cpt, x, bias, y, rows, d, tx, ty, chunks, blocks, st)
             : dispatch<__nv_bfloat16, 8>(cpt, x, bias, y, rows, d, tx, ty, chunks, blocks, st);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
