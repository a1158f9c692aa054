// Single-token masked attention against a static KV cache, for Hopper
// (sm_90a): fp32 scores, softmax and accumulation whatever the storage.
//
// Replaces whisper_trtllm_tpu/ops/pallas/decode_attention.py::decode_mha
// (_kernel), and the branches that whisper_trtllm_tpu/ops/attention.py::
// mha_decode_step computes around it: q (B, H, 1, dh) pre-scaled in fp32 or
// bf16; the cache in q's dtype, or int8 / fp8 e4m3 with one fp32 scale per
// (batch, head, row) for K and for V; the cache dh-minor (B, H, T, dh) or
// T-minor (B, H, dh, T); and the number of valid cache rows `valid_len` read
// from device memory inside the kernel (one int32, or one per batch lane
// with stride 1), so the host never waits for it and a captured CUDA graph
// can replay the launch with new values. Rows >= valid_len are masked with
// -1e9 before the fp32 softmax; valid_len <= 0 gives the uniform softmax
// over all T rows, as the plain formula does. It serves the decode step's
// self attention (T = max_len, valid_len = pos + 1) and cross attention
// (T = 1504, valid_len = 1500).
//
// Quantized caches: the scales commute out of both products,
// q . (k s)^T = (q . k^T) s^T and p . (v s) = (p s^T) . v, so k_scale
// multiplies each score and v_scale each softmax weight; only the 1-byte
// values and the scales cross device memory and no dequantized cache is
// ever written.
//
// What bounds it: each (batch, head) reads valid_len * dh * 2 cache values
// (+ 2 scales a row when quantized) and does 4 flops per value pair, far
// below the ~20 flops per byte at which an H100's fp32 units would be the
// limit: device memory bandwidth bounds it (3.35 TB/s on an H100 SXM), and
// at small batch the few blocks in flight bound it first.
//
// Design: one block of 256 threads per (batch, head).
// - dh-minor: each row of the cache is read by a group of lanes with one 16-
//   byte (fp32, bf16) or 8-byte (int8, fp8: a dh = 64 row is then 8 lanes)
//   load each, neighbouring lanes on neighbouring addresses, and the group
//   reduces its dot with shuffles. P V uses the same lane groups, then a
//   shared-memory pass sums the groups.
// - T-minor: one thread per run of 4 cache rows t for the scores (one 4-,
//   8- or 16-byte load per d row), so neighbouring threads read neighbouring
//   runs of each d row; P V is a warp per d row, lanes walking contiguous
//   runs of t, reduced with shuffles.
// Only rows below valid_len are read: the masked rows' weights are exactly
// 0 in fp32, so skipping them gives the same softmax. The scores (T floats:
// 6 KB at T = 1504) stay in shared memory for the block-wide max, the
// exponentials and the sum. Splitting T across blocks to fill all 132 SMs
// at small batch is left for later.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_DH = 128;
constexpr int MAX_T = 53248;     // scores in the shared memory left over
constexpr float MASKED = -1e9f;  // the JAX package's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// One vector load of a cache row piece, widened to N floats.
template <typename T>
struct Piece;

template <>
struct Piece<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};

template <>
struct Piece<__nv_bfloat16> {
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

// 1-byte types: 8 values (8 bytes) a lane
template <typename T>
struct Piece8 {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const T* p, float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = to_float(e[i]);
  }
};
template <> struct Piece<int8_t> : Piece8<int8_t> {};
template <> struct Piece<__nv_fp8_e4m3> : Piece8<__nv_fp8_e4m3> {};

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

// Softmax over scores[0, n) in place, leaving the unnormalised weights
// exp(s - max), times v_scale when quantized; returns 1 / sum of the
// unscaled weights. Its reductions' barriers publish the weights.
template <bool QUANT>
__device__ __forceinline__ float softmax_weights(float* scores, int n,
                                                 const float* vs, float* red) {
  float mx = -INFINITY;
  for (int t = threadIdx.x; t < n; t += THREADS) mx = fmaxf(mx, scores[t]);
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
  for (int t = threadIdx.x; t < n; t += THREADS) {
    const float p = expf(scores[t] - mx);
    scores[t] = QUANT ? p * vs[t] : p;
    sum += p;
  }
  return 1.f / block_reduce<false>(sum, red);
}

// dh-minor cache (B, H, T, dh). LPR: lanes per cache row, a power of two
// >= dh / Piece<CT>::N; a compile-time constant, so the row loops unroll
// and keep several loads in flight.
template <typename QT, typename CT, int LPR>
__global__ void __launch_bounds__(THREADS)
decode_dh_minor(const QT* __restrict__ q, const CT* __restrict__ k,
                const CT* __restrict__ v, const float* __restrict__ k_scale,
                const float* __restrict__ v_scale,
                const int* __restrict__ valid_len, int vl_stride,
                QT* __restrict__ o, int H, int T_len, int dh) {
  constexpr int VEC = Piece<CT>::N;
  constexpr bool QUANT = sizeof(CT) == 1;  // int8 / fp8 values
  constexpr int RPW = 32 / LPR;            // cache rows per warp per pass
  constexpr int SLOTS = WARPS * RPW;       // cache rows per block per pass
  constexpr int WIDTH = LPR * VEC;
  extern __shared__ float scores[];        // [T_len]
  __shared__ float part[SLOTS][WIDTH];
  __shared__ float red[WARPS];

  const int bh = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sub = lane % LPR;              // which piece of a row
  const int row_in_pass = warp * RPW + lane / LPR;
  const int d0 = sub * VEC;
  const bool active = d0 < dh;
  const CT* kp = k + (size_t)bh * T_len * dh + d0;
  const CT* vp = v + (size_t)bh * T_len * dh + d0;
  const float* ks = QUANT ? k_scale + (size_t)bh * T_len : nullptr;
  const float* vs = QUANT ? v_scale + (size_t)bh * T_len : nullptr;

  // valid_len <= 0 masks every row: the plain softmax over T values of -1e9
  // is then uniform over the whole cache, and so is this one
  const int vl = valid_len[(bh / H) * vl_stride];
  const bool all_masked = vl <= 0;
  const int n = all_masked ? T_len : min(vl, T_len);

  float qv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    qv[i] = active ? to_float(q[(size_t)bh * dh + d0 + i]) : 0.f;

  // scores; every lane of a warp runs the same trip count for the shuffles
  for (int base = 0; base < n; base += SLOTS) {
    const int t = base + row_in_pass;
    float dot = 0.f;
    if (active && t < n) {
      float kv[VEC];
      Piece<CT>::load(kp + (size_t)t * dh, kv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) dot = fmaf(qv[i], kv[i], dot);
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (sub == 0 && t < n)
      scores[t] = all_masked ? MASKED : (QUANT ? dot * ks[t] : dot);
  }
  __syncthreads();
  const float inv = softmax_weights<QUANT>(scores, n, vs, red);

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  if (active) {
    for (int t = row_in_pass; t < n; t += SLOTS) {
      const float p = scores[t];
      float vv[VEC];
      Piece<CT>::load(vp + (size_t)t * dh, vv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, vv[i], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) part[row_in_pass][d0 + i] = acc[i];
  __syncthreads();

  for (int d = threadIdx.x; d < dh; d += THREADS) {
    float x = 0.f;
    for (int r = 0; r < SLOTS; ++r) x += part[r][d];
    store1(o + (size_t)bh * dh + d, x * inv);
  }
}

// VT consecutive elements of a T-minor row, widened to floats: one 4-,
// 8- or 16-byte load when VT = 4 (the caller keeps it aligned).
template <typename T, int VT>
__device__ __forceinline__ void load_run(const T* p, float* out) {
  struct alignas(VT * sizeof(T)) Run { T x[VT]; };
  const Run r = *reinterpret_cast<const Run*>(p);
#pragma unroll
  for (int i = 0; i < VT; ++i) out[i] = to_float(r.x[i]);
}

// T-minor cache (B, H, dh, T). VT: cache rows t per thread and per load, 4
// when T % 4 == 0 (every run then lies inside its aligned row), else 1.
template <typename QT, typename CT, int VT>
__global__ void __launch_bounds__(THREADS)
decode_t_minor(const QT* __restrict__ q, const CT* __restrict__ k,
               const CT* __restrict__ v, const float* __restrict__ k_scale,
               const float* __restrict__ v_scale,
               const int* __restrict__ valid_len, int vl_stride,
               QT* __restrict__ o, int H, int T_len, int dh) {
  constexpr bool QUANT = sizeof(CT) == 1;  // int8 / fp8 values
  extern __shared__ float scores[];  // [T_len]
  __shared__ float qs[MAX_DH];
  __shared__ float red[WARPS];

  const int bh = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const CT* kp = k + (size_t)bh * dh * T_len;
  const CT* vp = v + (size_t)bh * dh * T_len;
  const float* ks = QUANT ? k_scale + (size_t)bh * T_len : nullptr;
  const float* vs = QUANT ? v_scale + (size_t)bh * T_len : nullptr;
  const int vl = valid_len[(bh / H) * vl_stride];
  const bool all_masked = vl <= 0;
  const int n = all_masked ? T_len : min(vl, T_len);

  for (int d = threadIdx.x; d < dh; d += THREADS) qs[d] = to_float(q[(size_t)bh * dh + d]);
  __syncthreads();

  // a run of VT rows per thread: neighbouring threads read neighbouring runs
  // of each d row; a run may pass n, never T_len
  for (int t0 = threadIdx.x * VT; t0 < n; t0 += THREADS * VT) {
    float dot[VT];
#pragma unroll
    for (int i = 0; i < VT; ++i) dot[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < dh; ++d) {
      float kv[VT];
      load_run<CT, VT>(kp + (size_t)d * T_len + t0, kv);
#pragma unroll
      for (int i = 0; i < VT; ++i) dot[i] = fmaf(qs[d], kv[i], dot[i]);
    }
#pragma unroll
    for (int i = 0; i < VT; ++i) {
      const int t = t0 + i;
      if (t < n) scores[t] = all_masked ? MASKED : (QUANT ? dot[i] * ks[t] : dot[i]);
    }
  }
  __syncthreads();
  const float inv = softmax_weights<QUANT>(scores, n, vs, red);

  for (int d = warp; d < dh; d += WARPS) {
    const CT* row = vp + (size_t)d * T_len;
    float acc = 0.f;
    for (int t0 = lane * VT; t0 < n; t0 += 32 * VT) {
      float vv[VT];
      load_run<CT, VT>(row + t0, vv);
#pragma unroll
      for (int i = 0; i < VT; ++i)
        if (t0 + i < n) acc = fmaf(scores[t0 + i], vv[i], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) store1(o + (size_t)bh * dh + d, acc * inv);
  }
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *valid_len;
  int vl_stride;
  void* o;
  int BH, H, T_len, dh;
  cudaStream_t stream;
};

template <typename QT, typename CT, int LPR>
cudaError_t launch_dh_minor(const Args& a, size_t smem) {
  auto kernel = decode_dh_minor<QT, CT, LPR>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.BH, THREADS, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const CT*>(a.k),
      static_cast<const CT*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.valid_len),
      a.vl_stride, static_cast<QT*>(a.o), a.H, a.T_len, a.dh);
  return cudaGetLastError();
}

template <typename QT, typename CT>
cudaError_t launch(const Args& a, bool t_major) {
  const size_t smem = (size_t)a.T_len * sizeof(float);
  if (t_major) {
    auto kernel = a.T_len % 4 == 0 ? decode_t_minor<QT, CT, 4> : decode_t_minor<QT, CT, 1>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<a.BH, THREADS, smem, a.stream>>>(
        static_cast<const QT*>(a.q), static_cast<const CT*>(a.k),
        static_cast<const CT*>(a.v), static_cast<const float*>(a.ks),
        static_cast<const float*>(a.vs), static_cast<const int*>(a.valid_len),
        a.vl_stride, static_cast<QT*>(a.o), a.H, a.T_len, a.dh);
    return cudaGetLastError();
  }
  // dh % 8 == 0 and dh <= 128: 1..32 pieces of N = 4 or 8 values
  const int pieces = a.dh / Piece<CT>::N;
  if (pieces <= 1) return launch_dh_minor<QT, CT, 1>(a, smem);
  if (pieces <= 2) return launch_dh_minor<QT, CT, 2>(a, smem);
  if (pieces <= 4) return launch_dh_minor<QT, CT, 4>(a, smem);
  if (pieces <= 8) return launch_dh_minor<QT, CT, 8>(a, smem);
  if (pieces <= 16) return launch_dh_minor<QT, CT, 16>(a, smem);
  return launch_dh_minor<QT, CT, 32>(a, smem);
}

// cache dtype codes: 0 float32, 1 bfloat16, 2 int8, 3 fp8 e4m3
template <typename QT>
cudaError_t by_cache(int cache_dtype, int same, const Args& a, bool t_major) {
  if (cache_dtype == same) return launch<QT, QT>(a, t_major);
  if (cache_dtype == 2) return launch<QT, int8_t>(a, t_major);
  if (cache_dtype == 3) return launch<QT, __nv_fp8_e4m3>(a, t_major);
  return cudaErrorInvalidValue;  // a float cache of another dtype than q's
}

}  // namespace

extern "C" {

// q (B, H, 1, dh) and o (B, H, 1, dh) in q_dtype (0 float32, 1 bfloat16);
// k/v (B, H, T, dh), or (B, H, dh, T) when t_major, in cache_dtype (0
// float32, 1 bfloat16: equal to q_dtype; 2 int8, 3 fp8 e4m3: then k_scale
// and v_scale point to fp32 (B, H, T, 1)); all contiguous. valid_len points
// to int32 on the device: lane b reads valid_len[b * vl_stride]. Returns a
// cudaError_t.
int decode_attn(const void* q, const void* k, const void* v,
                const void* k_scale, const void* v_scale,
                const void* valid_len, int vl_stride, void* o, int B, int H,
                int T_len, int dh, int q_dtype, int cache_dtype, int t_major,
                void* stream) {
  const bool quant = cache_dtype == 2 || cache_dtype == 3;
  if (B <= 0 || H <= 0 || T_len <= 0 || T_len > MAX_T || dh <= 0 ||
      dh > MAX_DH || dh % 8 != 0 || (vl_stride != 0 && vl_stride != 1) ||
      (quant && (k_scale == nullptr || v_scale == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, k_scale, v_scale, valid_len, vl_stride, o, B * H, H,
               T_len, dh, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0) return by_cache<float>(cache_dtype, 0, a, t_major != 0);
  if (q_dtype == 1) return by_cache<__nv_bfloat16>(cache_dtype, 1, a, t_major != 0);
  return cudaErrorInvalidValue;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
