// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of the forward
// in flash_attention.cu (K1), fp32 or bf16 in and out, fp32 arithmetic.
//
// Replaces whisper_trtllm_tpu/ops/pallas/flash_attention.py::_bwd_impl
// (_bwd_kernel, the backward of the custom VJP _flash): q (B, H, S, dh)
// pre-scaled, k/v (B, Hkv, T, dh) with Hkv | H, dO (B, H, S, dh). Scores are
// masked at the true T with -1e9 and, with `causal` (S == T), above the
// diagonal, as _mask_scores does; then
//   P = softmax(S), dP = dO V^T, delta = rowsum(P * dP),
//   dS = P * (dP - delta), dq = dS K, dk = dS^T Q, dv = P^T dO,
// with dk and dv summed in fp32 over the q rows and over the q-heads of a
// GQA group, then cast to k's dtype; dq in q's dtype.
//
// What bounds it: the function is 10*S*T*dh flops a head (the scores
// recomputed, then four products) against ~9*S*dh values of I/O, so fp32
// arithmetic bounds it (67 TFLOP/s on an H100 SXM without tensor cores), as
// for K1. The products are fp32 FMAs, for K1's reason (TF32 keeps ~3
// digits).
//
// Design: the TPU kernel is one program per (batch, head, q-block) that
// holds the whole K/V in VMEM and accumulates dk/dv in output blocks that
// stay resident while the sequential grid walks the q-blocks and the
// group's heads. Blocks on Hopper run in parallel and share no such
// accumulator, so the work is split in two kernels with no atomics, and
// the result repeats bit for bit:
// - dq: one block per (q tile of 64 rows, head, batch). It streams K/V in
//   64-row tiles (under causal only those at or left of the diagonal) and
//   recomputes P = exp(S - lse) from K1's log-sum-exp, twice: a first pass
//   sums delta = rowsum(P * dP) for its rows and stores it for the second
//   kernel, a second accumulates dq += dS K in registers. delta is taken
//   as _bwd_kernel takes it, not as rowsum(dO * O): O rounded to bf16
//   moves it by ~2^-9 |O| an element, which moved bf16 dq by up to 0.04 on
//   causal rows with few columns.
// - dk/dv: one block per (kv tile of 64 rows, kv-head, batch). It keeps
//   its K/V tile, loops over the group's q-heads and their q tiles (under
//   causal only those at or below the diagonal), recomputes P^T and dP^T
//   for the tile pair and accumulates dv += P^T dO and dk += dS^T Q in
//   registers, in a fixed order.
// Each pass recomputes the scores (18*S*T*dh flops in all, against the
// function's 10). Tiles and the 4 x 4 thread patches are K1's
// (flash_tiles.cuh); q rows past S and kv rows past T are zero in shared
// memory and their P is set to 0, so they add nothing anywhere.

#include "flash_tiles.cuh"

namespace {

using namespace flash;

// P = exp(S - lse) (0 where _mask_scores masks) into p and dP into dp for
// this thread's 4 x 4 patch of the (q tile at q0, K/V tile at k0) pair,
// from the transposed tiles in shared memory
__device__ __forceinline__ void p_dp_tile(float (&p)[4][4], float (&dp)[4][4],
                                          const float* qt, const float* dot,
                                          const float* kt, const float* vt,
                                          const float* lse_s, int q0, int k0,
                                          int S, int T_len, int dh,
                                          int causal) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  dot_tile<BQ, BK>(p, qt, kt, dh);   // S = Q K^T
  dot_tile<BQ, BK>(dp, dot, vt, dh);  // dP = dO V^T
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + 4 * tx + j;
      const bool live = row < S && col < T_len && !(causal && col > row);
      p[i][j] = live ? expf(p[i][j] - lse_s[4 * ty + i]) : 0.f;
    }
  }
}

template <typename T, int DHP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, int H, int Hkv, int S, int T_len,
                    int dh, int causal) {
  constexpr int G = DHP / 64;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DHP][BQ]
  float* dot = qt + DHP * BQ;                   // [DHP][BQ]
  float* kt = dot + DHP * BQ;                   // [DHP][BK]
  float* vt = kt + DHP * BK;                    // [DHP][BK]
  float* ks = vt + DHP * BK;                    // [BK][DHP]
  float* dss = ks + BK * DHP;                   // [BQ][PSTRIDE]
  float* lse_s = dss + BQ * PSTRIDE;            // [BQ]
  float* delta_s = lse_s + BQ;                  // [BQ]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t bh = (size_t)b * H + h;
  const T* qh = q + (bh * S + q0) * dh;
  const T* doh = dout + (bh * S + q0) * dh;
  const T* kh = k + ((size_t)b * Hkv + hk) * T_len * dh;
  const T* vh = v + ((size_t)b * Hkv + hk) * T_len * dh;

  load_transposed<T, BQ, DHP>(qt, qh, S - q0, dh);
  load_transposed<T, BQ, DHP>(dot, doh, S - q0, dh);
  if (threadIdx.x < BQ) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < S ? lse[bh * S + row] : 0.f;
  }

  const int kv_end = causal ? min(T_len, q0 + BQ) : T_len;
  float s[4][4], dp[4][4];

  // pass 1: delta = rowsum(P * dP); a row's columns are spread over the 16
  // lanes sharing its ty, summed in a fixed order
  float dsum[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    load_transposed<T, BK, DHP>(kt, kh + (size_t)k0 * dh, T_len - k0, dh);
    load_transposed<T, BK, DHP>(vt, vh + (size_t)k0 * dh, T_len - k0, dh);
    __syncthreads();
    p_dp_tile(s, dp, qt, dot, kt, vt, lse_s, q0, k0, S, T_len, dh, causal);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dsum[i] = fmaf(s[i][j], dp[i][j], dsum[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], off);
    const int r = 4 * ty + i;
    if (tx == 0) {
      delta_s[r] = dsum[i];
      if (q0 + r < S) delta[bh * S + q0 + r] = dsum[i];
    }
  }

  // pass 2: dq += dS K, dS = P * (dP - delta)
  float acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile (and pass 1's) is no longer read
    load_transposed<T, BK, DHP>(kt, kh + (size_t)k0 * dh, T_len - k0, dh);
    load_transposed<T, BK, DHP>(vt, vh + (size_t)k0 * dh, T_len - k0, dh);
    load_rows<T, BK, DHP>(ks, kh + (size_t)k0 * dh, T_len - k0, dh);
    __syncthreads();
    p_dp_tile(s, dp, qt, dot, kt, vt, lse_s, q0, k0, S, T_len, dh, causal);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) ds[j] = s[i][j] * (dp[i][j] - delta_s[r]);
      *reinterpret_cast<float4*>(dss + r * PSTRIDE + 4 * tx) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    accumulate_pv<DHP>(acc, dss, ks);  // dq += dS K
  }

  T* dqh = dq + bh * S * dh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int col = g * 64 + 4 * tx;
      if (col < dh)
        store4(dqh + (size_t)row * dh + col,
               make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                           acc[i][4 * g + 3]));
    }
  }
}

template <typename T, int DHP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int Hkv, int S, int T_len,
                      int dh, int causal) {
  constexpr int G = DHP / 64;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);  // [DHP][BK]
  float* vt = kt + DHP * BK;                    // [DHP][BK]
  float* qt = vt + DHP * BK;                    // [DHP][BQ]
  float* dot = qt + DHP * BQ;                   // [DHP][BQ]
  float* qs = dot + DHP * BQ;                   // [BQ][DHP]
  float* dos = qs + BQ * DHP;                   // [BQ][DHP]
  float* ps = dos + BQ * DHP;                   // [BK][PSTRIDE]: P^T
  float* dss = ps + BK * PSTRIDE;               // [BK][PSTRIDE]: dS^T
  float* lse_s = dss + BK * PSTRIDE;            // [BQ]
  float* delta_s = lse_s + BQ;                  // [BQ]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int c0 = blockIdx.x * BK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const size_t bhk = (size_t)b * Hkv + hk;
  load_transposed<T, BK, DHP>(kt, k + (bhk * T_len + c0) * dh, T_len - c0, dh);
  load_transposed<T, BK, DHP>(vt, v + (bhk * T_len + c0) * dh, T_len - c0, dh);

  float dk_acc[4][4 * G], dv_acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: q rows below c0 see none of this tile's columns
  const int q_begin = causal ? (c0 / BQ) * BQ : 0;
  for (int gi = 0; gi < group; ++gi) {
    const size_t bh = (size_t)b * H + hk * group + gi;
    for (int q0 = q_begin; q0 < S; q0 += BQ) {
      __syncthreads();  // the previous q tile is no longer read
      const T* qh = q + (bh * S + q0) * dh;
      const T* doh = dout + (bh * S + q0) * dh;
      load_transposed<T, BQ, DHP>(qt, qh, S - q0, dh);
      load_transposed<T, BQ, DHP>(dot, doh, S - q0, dh);
      load_rows<T, BQ, DHP>(qs, qh, S - q0, dh);
      load_rows<T, BQ, DHP>(dos, doh, S - q0, dh);
      if (threadIdx.x < BQ) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < S ? lse[bh * S + row] : 0.f;
        delta_s[threadIdx.x] = row < S ? delta[bh * S + row] : 0.f;
      }
      __syncthreads();

      // transposed tiles: element [i][j] is kv row 4ty+i, q row 4tx+j
      float s[4][4], dp[4][4];
      dot_tile<BK, BQ>(s, kt, qt, dh);   // S^T = K Q^T
      dot_tile<BK, BQ>(dp, vt, dot, dh);  // dP^T = V dO^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 4 * ty + i, col = c0 + c;
        float p4[4], ds4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 4 * tx + j, row = q0 + r;
          const bool live = row < S && col < T_len && !(causal && col > row);
          p4[j] = live ? expf(s[i][j] - lse_s[r]) : 0.f;
          ds4[j] = p4[j] * (dp[i][j] - delta_s[r]);
        }
        *reinterpret_cast<float4*>(ps + c * PSTRIDE + 4 * tx) =
            make_float4(p4[0], p4[1], p4[2], p4[3]);
        *reinterpret_cast<float4*>(dss + c * PSTRIDE + 4 * tx) =
            make_float4(ds4[0], ds4[1], ds4[2], ds4[3]);
      }
      __syncthreads();
      accumulate_pv<DHP>(dv_acc, ps, dos);  // dv += P^T dO
      accumulate_pv<DHP>(dk_acc, dss, qs);  // dk += dS^T Q
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = c0 + 4 * ty + i;
    if (row >= T_len) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int col = g * 64 + 4 * tx;
      if (col >= dh) continue;
      const size_t at = (bhk * T_len + row) * dh + col;
      store4(dk + at, make_float4(dk_acc[i][4 * g], dk_acc[i][4 * g + 1],
                                  dk_acc[i][4 * g + 2], dk_acc[i][4 * g + 3]));
      store4(dv + at, make_float4(dv_acc[i][4 * g], dv_acc[i][4 * g + 1],
                                  dv_acc[i][4 * g + 2], dv_acc[i][4 * g + 3]));
    }
  }
}

template <typename T, int DHP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, void* delta, void* dq,
                   void* dk, void* dv, int B, int H, int Hkv, int S, int T_len,
                   int dh, int causal, cudaStream_t stream) {
  const size_t smem_dq = (size_t)(2 * DHP * BQ + 2 * DHP * BK + BK * DHP +
                                  BQ * PSTRIDE + 2 * BQ) * sizeof(float);
  const size_t smem_kv = (size_t)(2 * DHP * BK + 2 * DHP * BQ + 2 * BQ * DHP +
                                  2 * BK * PSTRIDE + 2 * BQ) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return err;
  // dq first: it writes the delta the dk/dv kernel reads
  flash_bwd_dq_kernel<T, DHP><<<dim3((S + BQ - 1) / BQ, H, B), THREADS, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), H, Hkv, S, T_len, dh,
      causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, DHP><<<dim3((T_len + BK - 1) / BK, Hkv, B), THREADS, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      H, Hkv, S, T_len, dh, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, dout, dq (B, H, S, dh); k, v, dk, dv (B, Hkv, T, dh); all contiguous
// and of one dtype (is_bf16: 0 float32, 1 bfloat16). lse is K1's fp32
// (B, H, S) log-sum-exp of the same call; delta an fp32 (B, H, S) scratch.
// Two launches on `stream`, dq's then dk/dv's. Returns a cudaError_t.
int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, void* delta, void* dq,
              void* dk, void* dv, int B, int H, int Hkv, int S, int T_len,
              int dh, int causal, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      dh <= 0 || dh > 128 || dh % 8 != 0 || (causal && S != T_len))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (dh <= 64)
      return launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, S, T_len, dh, causal, st);
    return launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, S, T_len, dh, causal, st);
  }
  if (dh <= 64)
    return launch<float, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, S, T_len, dh, causal, st);
  return launch<float, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, S, T_len, dh, causal, st);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
