// Flash-attention forward for Hopper (sm_90a): fp32 or bf16 in and out,
// fp32 scores, softmax and accumulation.
//
// Replaces whisper_trtllm_tpu/ops/pallas/flash_attention.py::flash_mha,
// forward half (_fwd_impl, _kernel, _mask_scores): q (B, H, S, dh) arrives
// pre-scaled, k/v are (B, Hkv, T, dh) with Hkv | H, and q-head h reads
// kv-head h / (H / Hkv) without the repeat ever existing. Columns >= T are
// masked with -1e9, and with `causal` (S == T) so are columns > row, as
// _mask_scores does.
//
// What bounds it: at the Whisper encoder's shapes (S = T = 1500, dh = 64)
// the work is 4*S*T*dh flops per (batch, head) against 4*S*dh*4 bytes of
// q/k/v/o, about 190 flops per byte, so fp32 arithmetic bounds it (67
// TFLOP/s without tensor cores on an H100 SXM), not memory. TF32 tensor
// cores would keep ~3 decimal digits, outside the fp32 tolerance the port
// holds the kernel to, so the products are fp32 FMAs.
//
// Design: the TPU kernel keeps one head's whole K/V in VMEM and takes one
// exact softmax; one head's K alone is 385 KB at T = 1504 in fp32, more than
// the 227 KB of shared memory a block may use. So one block per (q tile of
// 64 rows, head, batch) streams K/V through shared memory in 64-row tiles
// and keeps an online softmax (running max and sum per row) in registers.
// 256 threads each own a 4 x 4 patch of the 64 x 64 score tile and a
// 4 x (dhp / 16) patch of the output; q and k sit transposed in shared
// memory so each step of the dot reads two float4s for 16 FMAs. dh is
// padded to 64 or 128 inside the block (the zero columns add nothing).
// wgmma, TMA and warp specialisation are left for later.

#include "flash_tiles.cuh"

namespace {

using namespace flash;

template <typename T, int DHP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int S, int T_len,
                 int dh, int causal) {
  constexpr int G = DHP / 64;  // float4 output groups per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DHP][BQ]
  float* kt = qt + DHP * BQ;                    // [DHP][BK]
  float* vs = kt + DHP * BK;                    // [BK][DHP]
  float* ps = vs + BK * DHP;                    // [BQ][PSTRIDE]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const T* qh = q + ((size_t)(b * H + h) * S + q0) * dh;
  const T* kh = k + (size_t)(b * Hkv + hk) * T_len * dh;
  const T* vh = v + (size_t)(b * Hkv + hk) * T_len * dh;
  T* oh = o + (size_t)(b * H + h) * S * dh;

  load_transposed<T, BQ, DHP>(qt, qh, S - q0, dh);

  float m[4], l[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  // causal: tiles wholly right of this block's last row add nothing
  const int kv_end = causal ? min(T_len, q0 + BQ) : T_len;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    load_transposed<T, BK, DHP>(kt, kh + (size_t)k0 * dh, T_len - k0, dh);
    load_rows<T, BK, DHP>(vs, vh + (size_t)k0 * dh, T_len - k0, dh);
    __syncthreads();

    float s[4][4];
    dot_tile<BQ, BK>(s, qt, kt, dh);

    // mask, then the online-softmax update of each of this thread's rows;
    // a row's 64 scores are spread over the 16 lanes sharing its ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        if (col >= T_len || (causal && col > row)) s[i][j] = MASKED;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(ps + (4 * ty + i) * PSTRIDE + 4 * tx) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    accumulate_pv<DHP>(acc, ps, vs);  // acc += P V over the tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    // the row's log-sum-exp, which the backward (K4) recomputes P from
    if (lse != nullptr && tx == 0)
      lse[(size_t)(b * H + h) * S + row] = m[i] + logf(l[i]);
    const float inv = 1.f / l[i];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int col = g * 64 + 4 * tx;
      if (col < dh)
        store4(oh + (size_t)row * dh + col,
               make_float4(acc[i][4 * g] * inv, acc[i][4 * g + 1] * inv,
                           acc[i][4 * g + 2] * inv, acc[i][4 * g + 3] * inv));
    }
  }
}

template <typename T, int DHP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Hkv, int S, int T_len, int dh,
                   int causal, cudaStream_t stream) {
  const size_t smem = (size_t)(DHP * BQ + DHP * BK + BK * DHP + BQ * PSTRIDE) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DHP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), H, Hkv, S, T_len, dh, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, S, dh), k/v (B, Hkv, T, dh), o (B, H, S, dh), all contiguous and
// of one dtype (is_bf16: 0 float32, 1 bfloat16); lse, when not null, an
// fp32 (B, H, S) that receives each row's log-sum-exp of its masked scores
// (the inference path passes null). Returns a cudaError_t.
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              int B, int H, int Hkv, int S, int T_len, int dh, int causal,
              int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      dh <= 0 || dh > 128 || dh % 8 != 0 || (causal && S != T_len))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (dh <= 64) return launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, H, Hkv, S, T_len, dh, causal, st);
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, H, Hkv, S, T_len, dh, causal, st);
  }
  if (dh <= 64) return launch<float, 64>(q, k, v, o, lse, B, H, Hkv, S, T_len, dh, causal, st);
  return launch<float, 128>(q, k, v, o, lse, B, H, Hkv, S, T_len, dh, causal, st);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
