// Single-token masked attention against a static KV cache, for Hopper
// (sm_90a): fp32 or bf16 cache, fp32 scores, softmax and accumulation.
//
// Replaces whisper_trtllm_tpu/ops/pallas/decode_attention.py::decode_mha
// (_kernel): q (B, H, 1, dh) pre-scaled, cache (B, H, T, dh), and the number
// of valid cache rows `valid_len` as an int32 scalar read from device memory
// inside the kernel, so the host never waits for it and a captured CUDA
// graph can replay the launch with a new value. Rows >= valid_len are
// masked with -1e9 before an fp32 softmax, then P V. It serves the decode
// step's self attention (T = max_len, valid_len = pos + 1) and cross
// attention (T = 1504, valid_len = 1500).
//
// What bounds it: each (batch, head) reads valid_len * dh * 2 cache values
// and does 4 flops per pair read, far below the ~20 flops per byte at which
// an H100's fp32 units would be the limit: device memory bandwidth bounds
// it (3.35 TB/s on an H100 SXM), and at small batch the few blocks in
// flight bound it first.
//
// Design: one block of 256 threads per (batch, head). Each row of the
// cache is read by a group of lanes with one 16-byte load each (16 lanes
// for fp32 at dh = 64), neighbouring lanes on neighbouring addresses, and
// the group reduces its dot with shuffles. Only rows below valid_len are
// read: the masked rows' weights are exactly 0 in fp32, so skipping them
// gives the same softmax. The scores (T floats: 6 KB at T = 1504) stay in
// shared memory for the block-wide max, the exponentials and the sum; then
// the same lane groups accumulate P V and a shared-memory pass sums the
// groups. Splitting T across blocks to fill all 132 SMs at small batch is
// left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float MASKED = -1e9f;  // the JAX package's mask value

template <typename T>
struct Vec16;  // one 16-byte load of T, widened to floats

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Block-wide reduction (max when IS_MAX, else sum); every thread gets it.
template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = IS_MAX ? fmaxf(x, y) : x + y;
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) x = IS_MAX ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// LPR: lanes per cache row, a power of two >= dh / Vec16<T>::N.
template <typename T, int LPR>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ valid_len,
                   T* __restrict__ o, int T_len, int dh) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int RPW = 32 / LPR;       // cache rows per warp per pass
  constexpr int SLOTS = WARPS * RPW;  // cache rows per block per pass
  extern __shared__ float scores[];   // [T_len]
  __shared__ float part[SLOTS][LPR * VEC];
  __shared__ float red[WARPS];

  const int bh = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sub = lane % LPR;              // which 16-byte chunk of a row
  const int row_in_pass = warp * RPW + lane / LPR;
  const int d0 = sub * VEC;
  const bool active = d0 < dh;
  const T* kp = k + (size_t)bh * T_len * dh + d0;
  const T* vp = v + (size_t)bh * T_len * dh + d0;

  // valid_len <= 0 masks every row: the plain softmax over T values of -1e9
  // is then uniform over the whole cache, and so is this one
  const int vl = *valid_len;
  const bool all_masked = vl <= 0;
  const int n = all_masked ? T_len : min(vl, T_len);

  float qv[VEC];
  if (active) {
    Vec16<T>::load(q + (size_t)bh * dh + d0, qv);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) qv[i] = 0.f;
  }

  // scores; every lane of a warp runs the same trip count for the shuffles
  for (int base = 0; base < n; base += SLOTS) {
    const int t = base + row_in_pass;
    float dot = 0.f;
    if (active && t < n) {
      float kv[VEC];
      Vec16<T>::load(kp + (size_t)t * dh, kv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) dot = fmaf(qv[i], kv[i], dot);
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (sub == 0 && t < n) scores[t] = all_masked ? MASKED : dot;
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int t = threadIdx.x; t < n; t += THREADS) mx = fmaxf(mx, scores[t]);
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
  for (int t = threadIdx.x; t < n; t += THREADS) {
    const float p = expf(scores[t] - mx);
    scores[t] = p;
    sum += p;
  }
  sum = block_reduce<false>(sum, red);  // its barriers also publish scores

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  if (active) {
    for (int t = row_in_pass; t < n; t += SLOTS) {
      const float p = scores[t];
      float vv[VEC];
      Vec16<T>::load(vp + (size_t)t * dh, vv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, vv[i], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) part[row_in_pass][d0 + i] = acc[i];
  __syncthreads();

  const float inv = 1.f / sum;
  for (int d = threadIdx.x; d < dh; d += THREADS) {
    float x = 0.f;
    for (int r = 0; r < SLOTS; ++r) x += part[r][d];
    store1(o + (size_t)bh * dh + d, x * inv);
  }
}

template <typename T, int LPR>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid_len, void* o, int BH, int T_len, int dh,
                   cudaStream_t stream) {
  const size_t smem = (size_t)T_len * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_kernel<T, LPR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_attn_kernel<T, LPR><<<BH, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(valid_len), static_cast<T*>(o), T_len, dh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* valid_len, void* o, int BH, int T_len,
                     int dh, cudaStream_t st) {
  const int chunks = dh / Vec16<T>::N;
  if (chunks <= 1) return launch<T, 1>(q, k, v, valid_len, o, BH, T_len, dh, st);
  if (chunks <= 2) return launch<T, 2>(q, k, v, valid_len, o, BH, T_len, dh, st);
  if (chunks <= 4) return launch<T, 4>(q, k, v, valid_len, o, BH, T_len, dh, st);
  if (chunks <= 8) return launch<T, 8>(q, k, v, valid_len, o, BH, T_len, dh, st);
  if (chunks <= 16) return launch<T, 16>(q, k, v, valid_len, o, BH, T_len, dh, st);
  return launch<T, 32>(q, k, v, valid_len, o, BH, T_len, dh, st);
}

}  // namespace

extern "C" {

// q (B, H, 1, dh), k/v (B, H, T, dh), o (B, H, 1, dh), contiguous, one
// dtype (is_bf16: 0 float32, 1 bfloat16); valid_len points to one int32 on
// the device. Returns a cudaError_t.
int decode_attn(const void* q, const void* k, const void* v,
                const void* valid_len, void* o, int B, int H, int T_len,
                int dh, int is_bf16, void* stream) {
  // the scores of one (batch, head) must fit the shared memory left beside
  // the static buffers
  if (B <= 0 || H <= 0 || T_len <= 0 || T_len > 53248 || dh <= 0 ||
      dh > 128 || dh % 8 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, valid_len, o, B * H, T_len, dh, st);
  return dispatch<float>(q, k, v, valid_len, o, B * H, T_len, dh, st);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
