// One-token cross attention against a head-contiguous cache, for Hopper
// (sm_90a): fp32 scores, an exact fp32 softmax and fp32 P.V whatever the
// storage.
//
// Replaces whisper_trtllm_tpu/ops/pallas/cross_attention.py::
// cross_decode_mha (_kernel): q (B, H*dh) pre-scaled; the cache K, V
// (B, T, H*dh), head h in columns [h*dh, (h+1)*dh) of every row; rows at or
// past valid_len masked with -1e9; each head's P.V cast to the storage
// dtype, the output (B, H*dh). q and the cache are fp32, or all bf16.
// valid_len is a host integer (static in the JAX package); valid_len <= 0
// masks every row, so every score is -1e9 and the softmax is uniform over
// all T rows: the mean of V, as in the JAX package.
//
// What bounds it: each (batch, head) reads valid_len * dh values of K and
// of V and does 4 flops per pair of them, far below the ~20 flops per byte
// at which an H100's fp32 units would be the limit: device memory
// bandwidth (3.35 TB/s on an H100 SXM). At the hardware check's shape
// (B 4, H 6, T 1504 of which 1500 valid, dh 64, fp32) that is 18.4 MB,
// 5.5 us.
//
// Design: at that shape B*H is only 24, so one block per (batch, head)
// would leave 108 of the 132 SMs idle (the decode-attention kernel's
// measured loss on the same cross case). T is split into chunks of CHUNK
// rows instead, one block of 128 threads each: 24 heads x 24 chunks = 576
// blocks.
// - Scores: a warp per row; lane l reads the row's head slice at l, l + 32,
//   ... (dh contiguous values: neighbouring lanes on neighbouring
//   addresses) and the warp sums its dot with shuffles. The chunk's scores
//   stay in shared memory.
// - The chunk's max m, its exponentials e = exp(s - m), their sum l and
//   acc = sum e v over its rows, in fp32; P.V by groups of dh threads, one
//   column a thread, each group over every G-th row, the groups summed in
//   order. The partials (m, l, acc[dh]) go to an fp32 workspace.
// - A second small kernel combines a head's chunks in chunk order: with
//   M = max m, out = sum acc exp(m - M) / sum l exp(m - M). Every sum has a
//   fixed order, so results repeat bit for bit (no atomics).
// Only valid rows are read: with 1 <= valid_len <= T the masked rows'
// weights are exactly 0 in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 64;  // rows a block; the wrapper sizes the workspace by it
constexpr int MAX_DH = 128;
constexpr float MASKED = -1e9f;  // the JAX package's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The block's max (MAX) or sum of x, in every thread; the warps' results
// combine in warp order. `red` holds WARPS floats.
template <bool MAX>
__device__ float block_reduce(float x, float* red) {
  x = MAX ? warp_max(x) : warp_sum(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < WARPS; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is written again by the next call
  return r;
}

// Grid (chunks, H, B). Writes ws[b, h, chunk] = (m, l, acc[dh]).
template <typename T>
__global__ void __launch_bounds__(THREADS)
cross_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ ws, int t,
                     int rows, int heads, int dh, int all_masked) {
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hd = heads * dh;
  const int row0 = chunk * CHUNK;
  const int n = min(CHUNK, rows - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __shared__ float s[CHUNK];
  __shared__ float pv[THREADS];
  __shared__ float red[WARPS];

  const T* qh = q + (size_t)b * hd + (size_t)h * dh;
  float qv[MAX_DH / 32];
#pragma unroll
  for (int i = 0; i < MAX_DH / 32; ++i) {
    const int c = lane + 32 * i;
    qv[i] = c < dh ? to_float(qh[c]) : 0.f;
  }
  // row row0 of batch b, head h's first column
  const size_t base = ((size_t)b * t + row0) * hd + (size_t)h * dh;
  for (int r = warp; r < n; r += WARPS) {
    float dot = MASKED;
    if (!all_masked) {
      const T* kr = k + base + (size_t)r * hd;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_DH / 32; ++i) {
        const int c = lane + 32 * i;
        if (c < dh) part += qv[i] * to_float(kr[c]);
      }
      dot = warp_sum(part);
    }
    if (lane == 0) s[r] = dot;
  }
  __syncthreads();

  float x = -INFINITY;
  for (int r = threadIdx.x; r < n; r += THREADS) x = fmaxf(x, s[r]);
  const float m = block_reduce<true>(x, red);
  float e_sum = 0.f;
  for (int r = threadIdx.x; r < n; r += THREADS) {
    const float e = expf(s[r] - m);
    s[r] = e;
    e_sum += e;
  }
  // its first barrier also publishes every exponential in s
  const float l = block_reduce<false>(e_sum, red);

  // P.V: G groups of dh threads, thread (g, j) sums column j over rows
  // g, g + G, ...
  const int groups = max(1, THREADS / dh);
  const int g = threadIdx.x / dh, j = threadIdx.x % dh;
  if (g < groups) {
    float acc = 0.f;
    const T* vc = v + base + j;
    for (int r = g; r < n; r += groups) acc += s[r] * to_float(vc[(size_t)r * hd]);
    pv[threadIdx.x] = acc;
  }
  // dh > THREADS is refused, so with one group every column has a thread
  __syncthreads();
  float* out = ws + (((size_t)b * heads + h) * gridDim.x + chunk) * (dh + 2);
  for (int c = threadIdx.x; c < dh; c += THREADS) {
    float acc = 0.f;
    for (int gg = 0; gg < groups; ++gg) acc += pv[gg * dh + c];
    out[2 + c] = acc;
  }
  if (threadIdx.x == 0) {
    out[0] = m;
    out[1] = l;
  }
}

// Grid (H, B): the chunks of one head, combined in chunk order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
cross_combine_kernel(const float* __restrict__ ws, T* __restrict__ out,
                     int heads, int dh, int n_chunks) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int stride = dh + 2;
  const float* p = ws + ((size_t)b * heads + h) * n_chunks * stride;
  float mx = -INFINITY;
  for (int c = 0; c < n_chunks; ++c) mx = fmaxf(mx, p[c * stride]);
  for (int j = threadIdx.x; j < dh; j += THREADS) {
    float l = 0.f, acc = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const float w = expf(p[c * stride] - mx);
      l += p[c * stride + 1] * w;
      acc += p[c * stride + 2 + j] * w;
    }
    store1(out + ((size_t)b * heads + h) * dh + j, acc / l);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* ws, int b, int t, int rows, int heads, int dh,
                   int all_masked, cudaStream_t st) {
  const int n_chunks = (rows + CHUNK - 1) / CHUNK;
  cross_partial_kernel<T><<<dim3(n_chunks, heads, b), THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ws, t, rows, heads, dh, all_masked);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cross_combine_kernel<T><<<dim3(heads, b), THREADS, 0, st>>>(
      ws, static_cast<T*>(out), heads, dh, n_chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out (B, H*dh); k, v (B, T, H*dh); all contiguous, of dtype (0 float32,
// 1 bfloat16). ws: ws_floats fp32 of scratch, at least
// B * H * ceil(rows / 64) * (dh + 2) with rows = min(valid_len, T), or T
// when valid_len <= 0. dh <= 128. Returns a cudaError_t.
int cross_decode_mha(const void* q, const void* k, const void* v, void* out,
                     void* ws, long long ws_floats, int b, int t, int heads,
                     int dh, int valid_len, int dtype, void* stream) {
  if (b <= 0 || t <= 0 || heads <= 0 || dh <= 0 || dh > MAX_DH || dtype < 0 ||
      dtype > 1 || b > 65535 || heads > 65535)
    return cudaErrorInvalidValue;
  const int all_masked = valid_len <= 0;
  const int rows = all_masked ? t : min(valid_len, t);
  const long long need =
      (long long)b * heads * ((rows + CHUNK - 1) / CHUNK) * (dh + 2);
  if (ws_floats < need) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dtype == 0)
    return launch<float>(q, k, v, out, w, b, t, rows, heads, dh, all_masked, st);
  return launch<__nv_bfloat16>(q, k, v, out, w, b, t, rows, heads, dh,
                               all_masked, st);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
