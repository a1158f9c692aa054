// Flash-attention forward for Hopper (sm_90a) on the tensor cores: fp32 or
// bf16 in and out, fp32 scores, softmax and accumulation.
//
// Replaces whisper_trtllm_tpu/ops/pallas/flash_attention.py::flash_mha,
// forward half (_fwd_impl, _kernel, _mask_scores): q (B, H, S, dh) arrives
// pre-scaled, k/v are (B, Hkv, T, dh) with Hkv | H, and q-head h reads
// kv-head h / (H / Hkv) without the repeat ever existing. Columns >= T are
// masked with -1e9, and with `causal` (S == T) so are columns > row, as
// _mask_scores does.
//
// What bounds it: at the Whisper encoder's shapes (S = T = 1500, dh = 64)
// the work is 4*S*T*dh flops per (batch, head) against 4*S*dh values of
// q/k/v/o, ~190 flops a byte in fp32 and ~375 in bf16, so the tensor
// cores bound it, not memory: 989 TFLOP/s in bf16 (B 4, H 6: 0.0140 ms),
// and 495/3 = 165 TFLOP/s for fp32 taken as 3xTF32 (0.0838 ms). What holds
// it well above that is the instruction rate around the products: the online
// softmax's ~5 instructions a score, the cp.async address arithmetic, the
// synchronous wait on every product, and in fp32 the hi/lo split of every
// operand fragment (four warps each split the whole K/V tile). Times on
// the card: PERF.md §6.
//
// Where it rounds, against the JAX kernel: both products take bf16 (or
// fp32) inputs with fp32 accumulation, as _kernel's dot_generals with
// preferred_element_type=f32. _kernel takes one exact softmax over the
// whole row and rounds the normalised P to v's dtype before P.V; this
// kernel keeps an online softmax over 64-column tiles and rounds the
// unnormalised P = exp(s - running max) to bf16 before P.V, dividing by
// the fp32 row sum (taken from P before it is rounded) at the end. exp is
// MUFU.EX2 of s*log2(e) - m*log2(e) (~2^-22 relative). In fp32, every
// operand, P included, enters as 3xTF32 (~22 bits) with fresh partials
// (flash_tiles.cuh).
//
// Design: the TPU kernel keeps one head's whole K/V in VMEM; one head's K
// alone is 385 KB at T = 1504 in fp32, more than a block's 227 KB of
// shared memory. So one block per (q tile of 64 rows, head, batch), four
// warps of 16 q rows each, streams K/V through shared memory in 64-row
// tiles, double-buffered by cp.async, and keeps an online softmax on the
// accumulator fragments (a row lives in 4 lanes: two shuffles; the mask
// only on a tile that crosses T or the causal diagonal). P goes from the
// accumulators straight into the A operand of P.V. dh is padded to 64 or
// 128 with zeros in shared memory. Two instructions carry the products:
// - bf16 at dh <= 64 (Whisper's): wgmma m64n64k16, the block's four warps
//   one warpgroup, A (Q, P) from registers and B (K, V) from tiles of
//   128-byte rows in the 128-byte swizzle, loaded by cp.async. It ran the
//   encoder shape faster than the mma.sync kernel (PERF.md §6), which
//   this case no longer takes. The loads are cp.async, not TMA
//   into an mbarrier ring, and every product is waited for at once: what
//   a warp-specialised pipeline would overlap is left for later.
// - fp32, and bf16 at dh 72..128: mma.sync (m16n8k8 tf32 as 3xTF32, or
//   m16n8k16 bf16), with the warp's Q fragments held in registers in bf16
//   (in fp32 the hi/lo pair would take 64-128 registers, so they are
//   re-read from shared memory), V through ldmatrix.trans.
// Two 16-row strips a warp (half the shared-memory reads a product) ran
// slower: the registers they need leave fewer blocks an SM.

#include "flash_tiles.cuh"

namespace {

using namespace flash;

template <typename T, int DHP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int S, int T_len,
                 int dh, int causal) {
  using M = Mma<T>;
  constexpr int LD = DHP + M::PAD;
  constexpr int KC = DHP / M::K;  // contraction chunks over dh
  constexpr int NS = BK / 8;      // score tiles of 8 columns
  constexpr int NO = DHP / 8;     // output tiles of 8 columns
  // hold Q's fragments when they take at most 32 registers
  constexpr bool HOLD = KC * sizeof(typename M::A) <= 128;
  extern __shared__ uint4 smem[];
  T* qs = reinterpret_cast<T*>(smem);  // [BQ][LD]
  T* ks = qs + BQ * LD;                // [2][BK][LD]
  T* vs = ks + 2 * BK * LD;            // [2][BK][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const T* qh = q + ((size_t)(b * H + h) * S + q0) * dh;
  const T* kh = k + (size_t)(b * Hkv + hk) * T_len * dh;
  const T* vh = v + (size_t)(b * Hkv + hk) * T_len * dh;

  // causal: tiles wholly right of this block's last row add nothing
  const int kv_end = causal ? min(T_len, q0 + BQ) : T_len;
  const int tiles = (kv_end + BK - 1) / BK;
  load_tile<T, BQ, DHP, LD>(qs, qh, q, S - q0, dh);
  cp_async_commit();
  load_tile<T, BK, DHP, LD>(ks, kh, k, T_len, dh);
  load_tile<T, BK, DHP, LD>(vs, vh, v, T_len, dh);
  cp_async_commit();

  const int r0 = 16 * warp;            // the warp's rows in the tile
  const int row_lo = q0 + r0 + g;      // this lane's two rows
  const int row_hi = row_lo + 8;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NO][4];
  zero(acc);
  typename M::A qa[HOLD ? KC : 1];
  if constexpr (HOLD) {  // Q's group is in while the first K/V tile loads
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) M::load_a(qa[kc], qs, LD, r0, kc * M::K);
  }
  auto q_of = [&](typename M::A& a, int kc) {
    if constexpr (HOLD) a = qa[kc];
    else M::load_a(a, qs, LD, r0, kc * M::K);
  };

  for (int n = 0; n < tiles; ++n) {
    const int k0 = n * BK, buf = n & 1;
    if (n + 1 < tiles) {
      const size_t off = (size_t)(k0 + BK) * dh;
      load_tile<T, BK, DHP, LD>(ks + (buf ^ 1) * BK * LD, kh + off, k,
                                T_len - k0 - BK, dh);
      load_tile<T, BK, DHP, LD>(vs + (buf ^ 1) * BK * LD, vh + off, v,
                                T_len - k0 - BK, dh);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[NS][4];
    zero(s);
    gemm<M, DHP, NS, true>(s, q_of, ks + buf * BK * LD, LD);  // S = Q K^T

    // mask (only a tile that crosses T or, under causal, the warp's
    // diagonal), then the online-softmax update of the lane's two rows; a
    // row's 64 scores are spread over the 4 lanes sharing g
    if (k0 + BK > T_len || (causal && k0 + BK - 1 > q0 + r0)) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? row_lo : row_hi;
          if (col >= T_len || (causal && col > row)) s[j][e] = MASKED;
        }
    }
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mt[e / 2] = fmaxf(mt[e / 2], s[j][e]);
    float alpha[2], mb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m[i], mt[i]);
      alpha[i] = ex2((m[i] - m_new) * LOG2E);
      m[i] = m_new;
      mb[i] = m_new * LOG2E;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], LOG2E, -mb[e / 2]));
        l[e / 2] += s[j][e];  // this lane's part of the row sum
      }
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e / 2];

    // acc += P V, P straight from the score accumulators
    gemm<M, BK, NO, false>(
        acc, [&](typename M::A& a, int kc) { M::acc_to_a(a, s, kc); },
        vs + buf * BK * LD, LD);
    __syncthreads();  // this buffer is refilled two tiles on
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];
    // the row's log-sum-exp, which the backward (K4) recomputes P from
    const int row = i ? row_hi : row_lo;
    if (lse != nullptr && t == 0 && row < S)
      lse[(size_t)(b * H + h) * S + row] = m[i] + logf(l[i]);
  }
  store_strip<T, NO>(o + ((size_t)(b * H + h) * S + q0) * dh, acc, r0,
                     S - q0, dh, inv[0], inv[1]);
}

// ---- bf16 at dh <= 64: both products on wgmma ----------------------------
// One warpgroup (the block's four warps) runs m64n64k16 products: A (Q,
// then P) from registers in mma.sync's fragment layout, B (K, then V) from
// shared memory tiles of 128-byte rows in the 128-byte swizzle, K read
// K-contiguous and V N-contiguous (transposed). The accumulators come back
// in mma.sync's fragment layout too, so the softmax is the same code.

#define ACC32(x)                                                            \
  "+f"(x[0][0]), "+f"(x[0][1]), "+f"(x[0][2]), "+f"(x[0][3]),               \
  "+f"(x[1][0]), "+f"(x[1][1]), "+f"(x[1][2]), "+f"(x[1][3]),               \
  "+f"(x[2][0]), "+f"(x[2][1]), "+f"(x[2][2]), "+f"(x[2][3]),               \
  "+f"(x[3][0]), "+f"(x[3][1]), "+f"(x[3][2]), "+f"(x[3][3]),               \
  "+f"(x[4][0]), "+f"(x[4][1]), "+f"(x[4][2]), "+f"(x[4][3]),               \
  "+f"(x[5][0]), "+f"(x[5][1]), "+f"(x[5][2]), "+f"(x[5][3]),               \
  "+f"(x[6][0]), "+f"(x[6][1]), "+f"(x[6][2]), "+f"(x[6][3]),               \
  "+f"(x[7][0]), "+f"(x[7][1]), "+f"(x[7][2]), "+f"(x[7][3])

using BfA = Mma<__nv_bfloat16>::A;

// d (64 x 64) += a (64 x 16: this warp's 16 rows) . B, B by descriptor;
// TRANS_B 1: B stored N-contiguous (V), 0: K-contiguous (K)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const BfA& a,
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : ACC32(d)
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "l"(desc),
        "n"(TRANS_B), "r"(1));
}

// Pins registers in program order against wgmma.fence and the wait: the
// compiler may otherwise sink a write past the fence, or hoist a read
// above the wait, while the tensor cores use them asynchronously
__device__ __forceinline__ void pin(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(BfA (&a)[N]) {
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[c].r[i])::"memory");
}

// commit the products queued since fence(), then wait for all of them
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// descriptor of a 1024-byte-aligned tile of 128-byte rows in the 128-byte
// swizzle: start >> 4, leading offset 1 (one atom wide: unused), 1024
// bytes between 8-row groups, layout 1
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// rows [0, BK) of a (rows, dh <= 64) bf16 tensor into a BK x 128-byte tile,
// 16-byte chunk c of row r at chunk c ^ (r % 8) (the swizzle), zero past
// `valid` rows and dh columns
__device__ __forceinline__ void load_tile_sw128(char* dst,
                                                const __nv_bfloat16* src,
                                                const __nv_bfloat16* base,
                                                int valid, int dh) {
  for (int i = threadIdx.x; i < BK * 8; i += THREADS) {
    const int r = i / 8, c = i % 8;
    const bool ok = r < valid && 8 * c < dh;
    cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4),
               ok ? src + (size_t)r * dh + 8 * c : base, ok ? 16 : 0);
  }
}

constexpr int SW_TILE = BK * 128;  // bytes of a swizzled K or V tile
constexpr int LDQ = 64 + Mma<__nv_bfloat16>::PAD;
constexpr size_t WGMMA_SMEM = 1024 + 4 * SW_TILE + BQ * LDQ * 2;

__global__ void __launch_bounds__(THREADS)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int H, int Hkv, int S, int T_len, int dh, int causal) {
  using T = __nv_bfloat16;
  using M = Mma<T>;
  constexpr int KC = 64 / M::K;
  extern __shared__ uint4 smem[];
  // the swizzle repeats every 1024 bytes: tiles start on that boundary
  char* base = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  char* ks = base;                                // [2][SW_TILE]
  char* vs = base + 2 * SW_TILE;                  // [2][SW_TILE]
  T* qs = reinterpret_cast<T*>(base + 4 * SW_TILE);  // [BQ][LDQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const T* qh = q + ((size_t)(b * H + h) * S + q0) * dh;
  const T* kh = k + (size_t)(b * Hkv + hk) * T_len * dh;
  const T* vh = v + (size_t)(b * Hkv + hk) * T_len * dh;

  const int kv_end = causal ? min(T_len, q0 + BQ) : T_len;
  const int tiles = (kv_end + BK - 1) / BK;
  load_tile<T, BQ, 64, LDQ>(qs, qh, q, S - q0, dh);
  load_tile_sw128(ks, kh, k, T_len, dh);
  load_tile_sw128(vs, vh, v, T_len, dh);
  cp_async_commit();

  const int r0 = 16 * warp;
  const int row_lo = q0 + r0 + g, row_hi = row_lo + 8;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[8][4];
  zero(acc);

  for (int n = 0; n < tiles; ++n) {
    const int k0 = n * BK, buf = n & 1;
    if (n + 1 < tiles) {
      const size_t off = (size_t)(k0 + BK) * dh;
      load_tile_sw128(ks + (buf ^ 1) * SW_TILE, kh + off, k, T_len - k0 - BK,
                      dh);
      load_tile_sw128(vs + (buf ^ 1) * SW_TILE, vh + off, v, T_len - k0 - BK,
                      dh);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // the copies' writes, made visible to the tensor cores' async reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // Q's fragments are read again every tile: held across the loop, the
    // registers came back changed after the first tile's products
    BfA qa[KC];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) M::load_a(qa[kc], qs, LDQ, r0, kc * M::K);
    float s[8][4];
    zero(s);
    pin(s);
    pin(qa);
    wgmma_fence();
    const uint64_t kd = sw128_desc(ks + buf * SW_TILE);
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)  // 16 columns of dh: 32 bytes a step
      wgmma_rs<0>(s, qa[kc], kd + 2 * kc);
    wgmma_wait();
    pin(s);
    pin(qa);

    if (k0 + BK > T_len || (causal && k0 + BK - 1 > q0 + r0)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? row_lo : row_hi;
          if (col >= T_len || (causal && col > row)) s[j][e] = MASKED;
        }
    }
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mt[e / 2] = fmaxf(mt[e / 2], s[j][e]);
    float alpha[2], mb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m[i], mt[i]);
      alpha[i] = ex2((m[i] - m_new) * LOG2E);
      m[i] = m_new;
      mb[i] = m_new * LOG2E;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], LOG2E, -mb[e / 2]));
        l[e / 2] += s[j][e];
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e / 2];

    // acc += P V: P rounded to bf16 straight from the score accumulators
    BfA pa[BK / 16];
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) M::acc_to_a(pa[c], s, c);
    pin(acc);
    pin(pa);
    wgmma_fence();
    const uint64_t vd = sw128_desc(vs + buf * SW_TILE);
#pragma unroll
    for (int c = 0; c < BK / 16; ++c)  // 16 rows of V: 2048 bytes a step
      wgmma_rs<1>(acc, pa[c], vd + 128 * c);
    wgmma_wait();
    pin(acc);
    pin(pa);
    __syncthreads();  // this buffer is refilled two tiles on
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];
    const int row = i ? row_hi : row_lo;
    if (lse != nullptr && t == 0 && row < S)
      lse[(size_t)(b * H + h) * S + row] = m[i] + logf(l[i]);
  }
  store_strip<T, 8>(o + ((size_t)(b * H + h) * S + q0) * dh, acc, r0, S - q0,
                    dh, inv[0], inv[1]);
}

cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int H, int Hkv, int S, int T_len,
                         int dh, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)WGMMA_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_wgmma_kernel<<<grid, THREADS, WGMMA_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, Hkv, S, T_len, dh, causal);
  return cudaGetLastError();
}

template <typename T, int DHP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Hkv, int S, int T_len, int dh,
                   int causal, cudaStream_t stream) {
  constexpr int LD = DHP + Mma<T>::PAD;
  const size_t smem = (size_t)(BQ + 4 * BK) * LD * sizeof(T);
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

// q (B, H, S, dh), k/v (B, Hkv, T, dh), o (B, H, S, dh), all contiguous,
// 16-byte aligned and of one dtype (is_bf16: 0 float32, 1 bfloat16); lse,
// when not null, an fp32 (B, H, S) that receives each row's log-sum-exp of
// its masked scores (the inference path passes null). Returns a
// cudaError_t.
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              int B, int H, int Hkv, int S, int T_len, int dh, int causal,
              int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      dh <= 0 || dh > 128 || dh % 8 != 0 || (causal && S != T_len))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (dh <= 64) return launch_wgmma(q, k, v, o, lse, B, H, Hkv, S, T_len, dh, causal, st);
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, H, Hkv, S, T_len, dh, causal, st);
  }
  if (dh <= 64) return launch<float, 64>(q, k, v, o, lse, B, H, Hkv, S, T_len, dh, causal, st);
  return launch<float, 128>(q, k, v, o, lse, B, H, Hkv, S, T_len, dh, causal, st);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
