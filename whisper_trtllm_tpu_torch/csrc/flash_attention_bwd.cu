// Flash-attention backward for Hopper (sm_90a) on the tensor cores: dq,
// dk, dv of the forward in flash_attention.cu (K1), fp32 or bf16 in and
// out, fp32 accumulation.
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
// recomputed, then four products) against ~9*S*dh values of I/O, so the
// tensor cores bound it: 989 TFLOP/s in bf16, 495/3 = 165 TFLOP/s for
// fp32 as 3xTF32 (flash_tiles.cuh); at the encoder's shape (B 4, H 6,
// S = T = 1500, dh 64) 0.0349 and 0.2095 ms. This kernel does 18*S*T*dh
// (below), in bf16 three of its products twice (hi + lo). The instruction rate
// around the products holds it well above that, as in K1; the dq kernel
// takes a little over half the time. Times on the card: PERF.md §6.
//
// Where it rounds, against the JAX kernel: _bwd_kernel widens q, k, v and
// dO to fp32 and keeps P and dS in fp32 for all its products. Here the
// seven products of a tile pair (S and dP, S^T and dP^T, dq += dS K,
// dv += P^T dO, dk += dS^T Q) run on mma.sync with fp32 accumulation:
// - bf16: the inputs are bf16 already, so S, dP, S^T and dP^T are exact
//   products summed in fp32, as in JAX. P and dS enter the dv, dq and dk
//   products split into bf16 hi + lo (~16 bits), two mma each. Rounded
//   once to bf16 they broke the 2e-2 of max(|plain|, 1) the port holds
//   bf16 K4 to: dq = dS K sums terms that cancel (a row of dS sums to 0),
//   so their rounding errors do not shrink with dq; emulated on causal
//   rows, dq missed the JAX kernel by 2.3e-2 (tests/
//   test_torch_flash_rounding.py emulates both routes against _bwd_impl).
// - fp32: every operand, P and dS included, is split as 3xTF32.
// delta is taken as _bwd_kernel takes it, rowsum(P * dP) in fp32, not as
// rowsum(dO * O): O rounded to bf16 moves it by ~2^-9 |O| an element,
// which moved bf16 dq by up to 0.04 on causal rows with few columns.
//
// Design: the TPU kernel is one program per (batch, head, q-block) that
// holds the whole K/V in VMEM and accumulates dk/dv in output blocks that
// stay resident while the sequential grid walks the q-blocks and the
// group's heads. Blocks on Hopper run in parallel and share no such
// accumulator, so the work is split in two kernels with no atomics, and
// the result repeats bit for bit:
// - dq: one block per (q tile of 64 rows, head, batch), four warps of 16
//   rows. It streams K/V in 64-row tiles (under causal only those at or
//   left of the diagonal), double-buffered by cp.async, and recomputes
//   P = exp(S - lse) from K1's log-sum-exp twice: a first pass sums delta
//   for its rows (in a fixed order) and stores it for the second kernel, a
//   second accumulates dq += dS K, dS straight from the accumulators as
//   the A operand and K through ldmatrix.trans.
// - dk/dv: one block per (kv tile of 64 rows, kv-head, batch), four warps
//   of 16 kv rows. It keeps its K/V tile, loops over the group's q-heads
//   and their q tiles (under causal only those at or below the diagonal)
//   in a fixed order, double-buffered, and takes each q tile in two
//   halves of 32 columns (the accumulators of a whole tile spilled): it
//   computes S^T = K Q^T and dP^T = V dO^T, and accumulates
//   dv += P^T dO and dk += dS^T Q in registers, P^T and dS^T again
//   straight from the accumulators.
// Each pass recomputes the scores (18*S*T*dh flops in all, against the
// function's 10). q rows past S and kv rows past T are zero in shared
// memory and their P is set to 0, so they add nothing anywhere. mma.sync
// rather than wgmma: see flash_tiles.cuh.

#include "flash_tiles.cuh"

namespace {

using namespace flash;

// hold a tile's A fragments in registers when they take at most 16
template <typename M, int DHP>
__host__ __device__ constexpr bool hold_a() {
  return (DHP / M::K) * sizeof(typename M::A) <= 64;
}

constexpr int HALF = 32;  // the dk/dv kernel takes a q tile in two halves

template <typename T, int DHP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, int H, int Hkv, int S, int T_len,
                    int dh, int causal) {
  using M = Mma<T>;
  constexpr int LD = DHP + M::PAD;
  constexpr int KC = DHP / M::K;
  constexpr int NS = BK / 8;
  constexpr int NO = DHP / 8;
  constexpr bool HOLD = hold_a<M, DHP>();
  extern __shared__ uint4 smem[];
  T* qs = reinterpret_cast<T*>(smem);  // [BQ][LD]
  T* dos = qs + BQ * LD;               // [BQ][LD]
  T* ks = dos + BQ * LD;               // [2][BK][LD]
  T* vs = ks + 2 * BK * LD;            // [2][BK][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t bh = (size_t)b * H + h;
  const T* kh = k + ((size_t)b * Hkv + hk) * T_len * dh;
  const T* vh = v + ((size_t)b * Hkv + hk) * T_len * dh;

  const int kv_end = causal ? min(T_len, q0 + BQ) : T_len;
  const int tiles = (kv_end + BK - 1) / BK;
  load_tile<T, BQ, DHP, LD>(qs, q + (bh * S + q0) * dh, q, S - q0, dh);
  load_tile<T, BQ, DHP, LD>(dos, dout + (bh * S + q0) * dh, dout, S - q0,
                            dh);
  cp_async_commit();
  load_tile<T, BK, DHP, LD>(ks, kh, k, T_len, dh);
  load_tile<T, BK, DHP, LD>(vs, vh, v, T_len, dh);
  cp_async_commit();

  const int r0 = 16 * warp;
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  // rows past S read lse 0: their P is never used (dq and delta are not
  // written for them)
  float lse_b[2], delta_r[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i)
    lse_b[i] = (rows[i] < S ? lse[bh * S + rows[i]] : 0.f) * LOG2E;

  typename M::A qa[HOLD ? KC : 1], da[HOLD ? KC : 1];
  if constexpr (HOLD) {  // Q's and dO's group is in
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      M::load_a(qa[kc], qs, LD, r0, kc * M::K);
      M::load_a(da[kc], dos, LD, r0, kc * M::K);
    }
  }
  auto q_of = [&](typename M::A& a, int kc) {
    if constexpr (HOLD) a = qa[kc];
    else M::load_a(a, qs, LD, r0, kc * M::K);
  };
  auto do_of = [&](typename M::A& a, int kc) {
    if constexpr (HOLD) a = da[kc];
    else M::load_a(a, dos, LD, r0, kc * M::K);
  };
  float acc[NO][4];
  zero(acc);

  // steps [0, tiles) are pass 1 (delta), [tiles, 2 tiles) pass 2 (dq)
  for (int n = 0; n < 2 * tiles; ++n) {
    const int tile = n % tiles, k0 = tile * BK, buf = n & 1;
    if (n + 1 < 2 * tiles) {
      const int next = (n + 1) % tiles;
      const size_t off = (size_t)next * BK * dh;
      load_tile<T, BK, DHP, LD>(ks + (buf ^ 1) * BK * LD, kh + off, k,
                                T_len - next * BK, dh);
      load_tile<T, BK, DHP, LD>(vs + (buf ^ 1) * BK * LD, vh + off, v,
                                T_len - next * BK, dh);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (n == tiles) {
      // pass 1 is done: a row's sum is spread over the 4 lanes sharing g
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        delta_r[i] = dsum[i] + __shfl_xor_sync(0xffffffffu, dsum[i], 1);
        delta_r[i] += __shfl_xor_sync(0xffffffffu, delta_r[i], 2);
        if (t == 0 && rows[i] < S) delta[bh * S + rows[i]] = delta_r[i];
      }
    }

    const T* kt = ks + buf * BK * LD;
    float s[NS][4], dp[NS][4];
    zero(s);
    zero(dp);
    gemm<M, DHP, NS, true>(s, q_of, kt, LD);                    // S = Q K^T
    gemm<M, DHP, NS, true>(dp, do_of, vs + buf * BK * LD, LD);  // dP = dO V^T
    // P = exp(S - lse), 0 where masked (only a tile that crosses T or,
    // under causal, the warp's diagonal, needs the test)
    const bool edge = k0 + BK > T_len || (causal && k0 + BK - 1 > q0 + r0);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1), i = e / 2;
        float p = ex2(fmaf(s[j][e], LOG2E, -lse_b[i]));
        if (edge && (col >= T_len || (causal && col > rows[i]))) p = 0.f;
        if (n < tiles) {
          dsum[i] = fmaf(p, dp[j][e], dsum[i]);
        } else {
          s[j][e] = p * (dp[j][e] - delta_r[i]);  // dS
        }
      }
    if (n >= tiles)  // dq += dS K
      gemm<M, BK, NO, false, typename M::A2>(
          acc, [&](typename M::A2& a, int kc) { M::acc_to_a2(a, s, kc); },
          kt, LD);
    __syncthreads();  // this buffer is refilled two steps on
  }
  store_strip<T, NO>(dq + (bh * S + q0) * dh, acc, r0, S - q0, dh, 1.f, 1.f);
}

template <typename T, int DHP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int Hkv, int S, int T_len,
                      int dh, int causal) {
  using M = Mma<T>;
  constexpr int LD = DHP + M::PAD;
  constexpr int KC = DHP / M::K;
  constexpr int NS = HALF / 8;  // S^T tiles of 8 q columns
  constexpr int NO = DHP / 8;
  constexpr bool HOLD = hold_a<M, DHP>();
  extern __shared__ uint4 smem[];
  T* ks = reinterpret_cast<T*>(smem);  // [BK][LD]
  T* vs = ks + BK * LD;                // [BK][LD]
  T* qs = vs + BK * LD;                // [2][BQ][LD]
  T* dos = qs + 2 * BQ * LD;           // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                             // [2][BQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int c0 = blockIdx.x * BK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const size_t bhk = (size_t)b * Hkv + hk;
  // causal: q rows below c0 see none of this tile's columns
  const int q_begin = causal ? (c0 / BQ) * BQ : 0;
  const int per_head = (S - q_begin + BQ - 1) / BQ;
  const int steps = group * per_head;

  // q tile `n` of the walk (head gi = n / per_head) into buffer `buf`;
  // rows past S are zero with lse and delta 0, so their P^T is 1 and
  // dS^T 0, against zero dO and Q rows: they add nothing
  auto load_q = [&](int n, int buf) {
    const size_t bh = (size_t)b * H + hk * group + n / per_head;
    const int q0 = q_begin + (n % per_head) * BQ;
    load_tile<T, BQ, DHP, LD>(qs + buf * BQ * LD, q + (bh * S + q0) * dh, q,
                              S - q0, dh);
    load_tile<T, BQ, DHP, LD>(dos + buf * BQ * LD, dout + (bh * S + q0) * dh,
                              dout, S - q0, dh);
    load_vec(lse_s + buf * BQ, lse + bh * S + q0, lse, BQ, S - q0);
    load_vec(delta_s + buf * BQ, delta + bh * S + q0, delta, BQ, S - q0);
  };
  load_tile<T, BK, DHP, LD>(ks, k + (bhk * T_len + c0) * dh, k, T_len - c0,
                            dh);
  load_tile<T, BK, DHP, LD>(vs, v + (bhk * T_len + c0) * dh, v, T_len - c0,
                            dh);
  cp_async_commit();
  load_q(0, 0);
  cp_async_commit();

  const int r0 = 16 * warp;  // the warp's kv rows in the tile
  const int cols[2] = {c0 + r0 + g, c0 + r0 + g + 8};
  typename M::A ka[HOLD ? KC : 1], va[HOLD ? KC : 1];
  if constexpr (HOLD) {  // K's and V's group is in
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      M::load_a(ka[kc], ks, LD, r0, kc * M::K);
      M::load_a(va[kc], vs, LD, r0, kc * M::K);
    }
  }
  auto k_of = [&](typename M::A& a, int kc) {
    if constexpr (HOLD) a = ka[kc];
    else M::load_a(a, ks, LD, r0, kc * M::K);
  };
  auto v_of = [&](typename M::A& a, int kc) {
    if constexpr (HOLD) a = va[kc];
    else M::load_a(a, vs, LD, r0, kc * M::K);
  };
  float dk_acc[NO][4], dv_acc[NO][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int n = 0; n < steps; ++n) {
    const int buf = n & 1;
    const int q0 = q_begin + (n % per_head) * BQ;
    if (n + 1 < steps) {
      load_q(n + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // the q tile in two halves of 32 columns, to hold fewer accumulators
#pragma unroll 1
    for (int hs = 0; hs < BQ / HALF; ++hs) {
      const T* qt = qs + (buf * BQ + hs * HALF) * LD;
      const T* dot = dos + (buf * BQ + hs * HALF) * LD;
      const float* lse_t = lse_s + buf * BQ + hs * HALF;
      const float* delta_t = delta_s + buf * BQ + hs * HALF;
      const int qh0 = q0 + hs * HALF;
      // transposed tiles: rows are kv rows, columns q rows
      float s[NS][4], dp[NS][4];
      zero(s);
      zero(dp);
      gemm<M, DHP, NS, true>(s, k_of, qt, LD);    // S^T = K Q^T
      gemm<M, DHP, NS, true>(dp, v_of, dot, LD);  // dP^T = V dO^T
      const bool edge = causal && c0 + r0 + 15 > qh0;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * j + 2 * t + (e & 1);
          float p = ex2(fmaf(s[j][e], LOG2E, -lse_t[r] * LOG2E));
          if (edge && cols[e / 2] > qh0 + r) p = 0.f;
          s[j][e] = p;                             // P^T
          dp[j][e] = p * (dp[j][e] - delta_t[r]);  // dS^T
        }
      gemm<M, HALF, NO, false, typename M::A2>(  // dv += P^T dO
          dv_acc, [&](typename M::A2& a, int kc) { M::acc_to_a2(a, s, kc); },
          dot, LD);
      gemm<M, HALF, NO, false, typename M::A2>(  // dk += dS^T Q
          dk_acc, [&](typename M::A2& a, int kc) { M::acc_to_a2(a, dp, kc); },
          qt, LD);
    }
    __syncthreads();  // this buffer is refilled two steps on
  }
  store_strip<T, NO>(dk + (bhk * T_len + c0) * dh, dk_acc, r0, T_len - c0,
                     dh, 1.f, 1.f);
  store_strip<T, NO>(dv + (bhk * T_len + c0) * dh, dv_acc, r0, T_len - c0,
                     dh, 1.f, 1.f);
}

template <typename T, int DHP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, void* delta, void* dq,
                   void* dk, void* dv, int B, int H, int Hkv, int S, int T_len,
                   int dh, int causal, cudaStream_t stream) {
  constexpr int LD = DHP + Mma<T>::PAD;
  const size_t smem_dq = (size_t)(2 * BQ + 4 * BK) * LD * sizeof(T);
  const size_t smem_kv =
      (size_t)(2 * BK + 4 * BQ) * LD * sizeof(T) + 4 * BQ * sizeof(float);
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

// q, dout, dq (B, H, S, dh); k, v, dk, dv (B, Hkv, T, dh); all contiguous,
// 16-byte aligned and of one dtype (is_bf16: 0 float32, 1 bfloat16). lse
// is K1's fp32 (B, H, S) log-sum-exp of the same call; delta an fp32
// (B, H, S) scratch. Two launches on `stream`, dq's then dk/dv's. Returns
// a cudaError_t.
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
