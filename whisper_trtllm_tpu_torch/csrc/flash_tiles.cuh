// Tensor-core tile helpers shared by the flash-attention forward (K1,
// flash_attention.cu) and backward (K4, flash_attention_bwd.cu).
//
// Every product runs on `mma.sync` with fp32 accumulators, one warp a
// 16-row strip of the output:
// - bf16: `mma.sync.aligned.m16n8k16` bf16 x bf16 -> fp32. Operands come
//   from shared memory through `ldmatrix` (`.trans` where the contraction
//   runs down a tile's rows), or from registers.
// - fp32: 3xTF32 on `mma.sync.aligned.m16n8k8` tf32. Each operand x is
//   split into hi = tf32(x) (round to nearest, as `cvt.rna`) and
//   lo = tf32(x - hi), about 22 mantissa bits together, and each product
//   is lo*hi + hi*lo + hi*hi, small terms first, into a fresh fp32 partial
//   every four chunks (Mma<float>::FRESH). The dropped lo*lo term is
//   ~2^-22 of a product. One TF32 product keeps ~11 bits and would break
//   the 1e-5 fp32 tolerance the port holds K1 and K4 to; three reach it
//   at up to 495/3 = 165 TFLOP/s on an H100 SXM, against 67 TFLOP/s on
//   the fp32 FMA units. The products of four 8-column tiles go out
//   term by term, so four independent chains hide the mma latency.
//
// mma.sync rather than wgmma for K4, for fp32 and for K1 at dh > 64: the
// warp-level instruction takes 3xTF32's split operands, the transposed
// and register operands of the backward's seven products and any padded
// dh without swizzled 64-row warpgroup tiles; K1's bf16 case at dh <= 64
// runs on wgmma (flash_attention.cu).
//
// Tiles sit in shared memory row-major in their own dtype, dh padded with
// zeros to DHP (64 or 128) and each row padded by 16 bytes, so the eight
// row addresses of an `ldmatrix` (bf16) or a fragment's 32 scalar loads
// (fp32, row stride = 4 mod 32 words) fall in distinct banks. They arrive
// by `cp.async`, 16 bytes a copy, rows past the tensor's end and columns
// past dh zero-filled by the copy itself, so a tile can be loaded while
// the previous one is multiplied.
//
// An accumulator tile (16 rows x 8 columns, fp32) holds, in lane
// (g = lane / 4, t = lane % 4), rows g and g + 8 at columns 2t and 2t + 1.
// `acc_to_a` turns accumulators straight into the A operand of the next
// product (P into P.V, dS into dS.K) without shared memory (`acc_to_a2`
// as bf16 hi + lo, two products, for the backward): in bf16 two
// accumulator tiles are one k16 A fragment as they stand; in tf32 a k8 A
// fragment wants columns t and t + 4 where the lane holds 2t and 2t + 1,
// so the contraction index is permuted (logical t -> 2t, t + 4 -> 2t + 1)
// and `load_b_kn` reads the B rows in the same permuted order: the sum
// over k is the same.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int BQ = 64;           // query rows of a block's own tile
constexpr int BK = 64;           // key/value rows of a streamed tile
constexpr int THREADS = 128;     // four warps, one a 16-row strip
constexpr float MASKED = -1e9f;  // the JAX package's mask value
constexpr float LOG2E = 1.4426950408889634f;

// 2^x, MUFU.EX2 (~2^-22 relative); exp(s - m) is ex2(s*log2e - m*log2e)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [0, ROWS) of a (rows, dh) tensor at `src` into the row-major tile
// `dst` (row stride LD elements), zero where row >= valid or col >= dh;
// `base` is any readable address of the tensor, given to the zero-filling
// copies. dh % 8 == 0 keeps every copy whole and 16-byte aligned.
template <typename T, int ROWS, int DHP, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          const T* base, int valid, int dh) {
  constexpr int E = 16 / sizeof(T);  // elements a copy
  constexpr int PER_ROW = DHP / E;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * E;
    const bool ok = r < valid && c < dh;
    cp_async16(dst + r * LD + c, ok ? src + (size_t)r * dh + c : base,
               ok ? 16 : 0);
  }
}

// n fp32 values from `src` into `dst`, zero from index `valid` on
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         const float* base, int n, int valid) {
  for (int i = threadIdx.x; i < n; i += THREADS)
    cp_async4(dst + i, i < valid ? src + i : base, i < valid ? 4 : 0);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// two fp32 values as bf16 hi + lo pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// x rounded to tf32 as cvt.rna.tf32.f32 rounds a finite x (to nearest,
// ties away from zero), in two integer operations: the instruction itself
// compiles to four on sm_90a (it also guards NaN and infinity)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

template <typename T>
struct Mma;

// bf16 operands, m16n8k16
template <>
struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int K = 16;   // contraction depth of one mma
  static constexpr int PAD = 8;  // row padding of a tile, elements
  static constexpr int FRESH = 0;  // see Mma<float>
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };

  // A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a tile
  static __device__ __forceinline__ void load_a(A& a, const T* tile, int ld,
                                                int r0, int c0) {
    const int lane = threadIdx.x % 32, m = lane / 8;
    const T* p = tile + (r0 + lane % 8 + 8 * (m & 1)) * ld + c0 + 8 * (m >> 1);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
        : "r"(smem_addr(p)));
  }

  // B fragments of two n-tiles, B[k][n] = tile[n0 + n][k0 + k] for
  // n < 16, k < 16: the tile's rows are B's columns (Q K^T, dO V^T)
  static __device__ __forceinline__ void load_b_nt(B (&b)[2], const T* tile,
                                                   int ld, int n0, int k0) {
    const int lane = threadIdx.x % 32, m = lane / 8;
    const T* p = tile + (n0 + lane % 8 + 8 * (m >> 1)) * ld + k0 + 8 * (m & 1);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(b[0].r[0]), "=r"(b[0].r[1]), "=r"(b[1].r[0]), "=r"(b[1].r[1])
        : "r"(smem_addr(p)));
  }

  // B fragments of two n-tiles, B[k][n] = tile[k0 + k][n0 + n]: the
  // contraction runs down the tile's rows (P V, dS K, P^T dO, dS^T Q)
  static __device__ __forceinline__ void load_b_kn(B (&b)[2], const T* tile,
                                                   int ld, int k0, int n0) {
    const int lane = threadIdx.x % 32, m = lane / 8;
    const T* p = tile + (k0 + lane % 8 + 8 * (m & 1)) * ld + n0 + 8 * (m >> 1);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(b[0].r[0]), "=r"(b[0].r[1]), "=r"(b[1].r[0]), "=r"(b[1].r[1])
        : "r"(smem_addr(p)));
  }

  // accumulator tiles 2c and 2c + 1 as the A fragment of contraction
  // chunk c, rounded to bf16
  static __device__ __forceinline__ void acc_to_a(A& a, const float (*acc)[4],
                                                  int c) {
    a.r[0] = pack_bf16(acc[2 * c][0], acc[2 * c][1]);
    a.r[1] = pack_bf16(acc[2 * c][2], acc[2 * c][3]);
    a.r[2] = pack_bf16(acc[2 * c + 1][0], acc[2 * c + 1][1]);
    a.r[3] = pack_bf16(acc[2 * c + 1][2], acc[2 * c + 1][3]);
  }

  // the same as bf16 hi + lo (~16 bits), for the backward's P and dS
  struct A2 { A hi, lo; };
  static __device__ __forceinline__ void acc_to_a2(A2& a,
                                                   const float (*acc)[4],
                                                   int c) {
    split_bf16(acc[2 * c][0], acc[2 * c][1], a.hi.r[0], a.lo.r[0]);
    split_bf16(acc[2 * c][2], acc[2 * c][3], a.hi.r[1], a.lo.r[1]);
    split_bf16(acc[2 * c + 1][0], acc[2 * c + 1][1], a.hi.r[2], a.lo.r[2]);
    split_bf16(acc[2 * c + 1][2], acc[2 * c + 1][3], a.hi.r[3], a.lo.r[3]);
  }

  static __device__ __forceinline__ void mma(float (&c)[4], const A2& a,
                                             const B& b) {
    mma(c, a.lo, b);
    mma(c, a.hi, b);
  }

  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
          "r"(b.r[1]));
  }
};

// fp32 operands as 3xTF32, m16n8k8
template <>
struct Mma<float> {
  using T = float;
  static constexpr int K = 8;
  static constexpr int PAD = 4;
  // The tensor cores truncate the fp32 sum they accumulate into, a bias
  // of up to an ulp of the accumulator a step; carried through the 24
  // steps of a 64-deep 3xTF32 contraction it broke the fp32 limit (K4's
  // dq by 1.4e-5 of its largest value, NVIDIA H100 80GB HBM3, 700.00 W).
  // So the products of every FRESH chunks (12 steps) go into a fresh
  // partial, added to the accumulator in fp32, round to nearest.
  static constexpr int FRESH = 4;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };

  static __device__ __forceinline__ void load_a(A& a, const T* tile, int ld,
                                                int r0, int c0) {
    const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
    const T* p = tile + (r0 + g) * ld + c0 + t;
    split_tf32(p[0], a.hi[0], a.lo[0]);
    split_tf32(p[8 * ld], a.hi[1], a.lo[1]);
    split_tf32(p[4], a.hi[2], a.lo[2]);
    split_tf32(p[8 * ld + 4], a.hi[3], a.lo[3]);
  }

  static __device__ __forceinline__ void load_b_nt(B (&b)[2], const T* tile,
                                                   int ld, int n0, int k0) {
    const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const T* p = tile + (n0 + 8 * i + g) * ld + k0 + t;
      split_tf32(p[0], b[i].hi[0], b[i].lo[0]);
      split_tf32(p[4], b[i].hi[1], b[i].lo[1]);
    }
  }

  // rows in the permuted order of acc_to_a: k 2t and 2t + 1
  static __device__ __forceinline__ void load_b_kn(B (&b)[2], const T* tile,
                                                   int ld, int k0, int n0) {
    const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const T* p = tile + (k0 + 2 * t) * ld + n0 + 8 * i + g;
      split_tf32(p[0], b[i].hi[0], b[i].lo[0]);
      split_tf32(p[ld], b[i].hi[1], b[i].lo[1]);
    }
  }

  // accumulator tile c as the A fragment of contraction chunk c
  static __device__ __forceinline__ void acc_to_a(A& a, const float (*acc)[4],
                                                  int c) {
    split_tf32(acc[c][0], a.hi[0], a.lo[0]);
    split_tf32(acc[c][2], a.hi[1], a.lo[1]);
    split_tf32(acc[c][1], a.hi[2], a.lo[2]);
    split_tf32(acc[c][3], a.hi[3], a.lo[3]);
  }

  // already ~22 bits: the backward's P and dS take the same split
  using A2 = A;
  static __device__ __forceinline__ void acc_to_a2(A2& a,
                                                   const float (*acc)[4],
                                                   int c) {
    acc_to_a(a, acc, c);
  }

  static __device__ __forceinline__ void mma1(float (&c)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }

  // d = a . b from zero
  static __device__ __forceinline__ void mma1_fresh(float (&d)[4],
                                                    const uint32_t (&a)[4],
                                                    const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(0.f));
  }

  // d[i] (+)= a . b[i] for four 8-column tiles, term by term across the
  // tiles (small terms first), so four chains of products run side by side
  template <bool FROM_ZERO>
  static __device__ __forceinline__ void mma4(float (&d)[4][4], const A& a,
                                              const B (&b)[2][2]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (FROM_ZERO) mma1_fresh(d[i], a.lo, b[i / 2][i % 2].hi);
      else mma1(d[i], a.lo, b[i / 2][i % 2].hi);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) mma1(d[i], a.hi, b[i / 2][i % 2].lo);
#pragma unroll
    for (int i = 0; i < 4; ++i) mma1(d[i], a.hi, b[i / 2][i % 2].hi);
  }
};

// c[j] += A . B_j over a contraction of KD, A (16 x KD) given chunk by
// chunk by a_of(AT&, chunk) as M::A (or M::A2, hi + lo), B_j the j-th
// 8-column tile of B from `tile`: B[k][n] = tile[n][k] when NT_B
// (load_b_nt), tile[k][n] otherwise. With M::FRESH, each run of FRESH
// chunks sums into a fresh partial first, four tiles a round.
template <typename M, int KD, int NJ, bool NT_B, typename AT = typename M::A,
          typename AOf>
__device__ __forceinline__ void gemm(float (&c)[NJ][4], AOf a_of,
                                     const typename M::T* tile, int ld) {
  constexpr int F = M::FRESH > 0 ? M::FRESH : 1;
  static_assert((KD / M::K) % F == 0, "FRESH must divide the chunks");
  static_assert(M::FRESH == 0 || NJ % 4 == 0, "FRESH takes four tiles a round");
#pragma unroll
  for (int k0 = 0; k0 < KD / M::K; k0 += F) {
    AT a[F];
#pragma unroll
    for (int f = 0; f < F; ++f) a_of(a[f], k0 + f);
    if constexpr (M::FRESH > 0) {
#pragma unroll
      for (int j0 = 0; j0 < NJ; j0 += 4) {
        float d[4][4];
#pragma unroll
        for (int f = 0; f < F; ++f) {
          typename M::B b[2][2];
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            if constexpr (NT_B)
              M::load_b_nt(b[p], tile, ld, 8 * j0 + 16 * p, (k0 + f) * M::K);
            else
              M::load_b_kn(b[p], tile, ld, (k0 + f) * M::K, 8 * j0 + 16 * p);
          }
          if (f == 0) M::template mma4<true>(d, a[f], b);
          else M::template mma4<false>(d, a[f], b);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[j0 + i][e] += d[i][e];
      }
    } else {
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        typename M::B b[2];
        if constexpr (NT_B)
          M::load_b_nt(b, tile, ld, 16 * jp, k0 * M::K);
        else
          M::load_b_kn(b, tile, ld, k0 * M::K, 16 * jp);
        M::mma(c[2 * jp], a[0], b[0]);
        M::mma(c[2 * jp + 1], a[0], b[1]);
      }
    }
  }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&c)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Rows [r0, r0 + 16) of an accumulator strip c (NJ tiles of 8 columns)
// into a (rows, dh) tensor `dst`, times `scale` per row half (rows r0 + g
// and r0 + g + 8), rows at or past `rows` and columns past dh skipped.
template <typename T, int NJ>
__device__ __forceinline__ void store_strip(T* dst, const float (&c)[NJ][4],
                                            int r0, int rows, int dh,
                                            float scale_lo, float scale_hi) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= dh) continue;
    if (r0 + g < rows)
      store2(dst + (size_t)(r0 + g) * dh + col, c[j][0] * scale_lo,
             c[j][1] * scale_lo);
    if (r0 + g + 8 < rows)
      store2(dst + (size_t)(r0 + g + 8) * dh + col, c[j][2] * scale_hi,
             c[j][3] * scale_hi);
  }
}

}  // namespace flash
