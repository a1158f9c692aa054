// The split-T ("flash-decoding") engine of one query row per head against a
// cache of T rows, for Hopper (sm_90a). Shared by K2 (decode_attention.cu:
// the (B, H, T, dh) and (B, H, dh, T) caches, float or int8 / fp8 with
// scales) and K7 (cross_attention.cu: the head-contiguous (B, T, H*dh)
// cache). fp32 scores, softmax and accumulation whatever the storage.
//
// What bounds it: one query row per head does 4 flops per pair of cache
// values, ~0.5-2 flops a byte, far below the ~20 a byte where the H100's
// fp32 units would be the limit: device memory bandwidth (3.35 TB/s on an
// H100 SXM), and below a few MB per call the latency of the loads and the
// number of blocks that keep them in flight. One block per (batch, head),
// as K2 had, ran 24 blocks at B 4, H 6 and left 108 of the 132 SMs idle.
//
// Design:
// - Split: the rows of one (batch, head) are cut into `splits` chunks of
//   `chunk` rows, one block each, the blocks of a head one thread block
//   cluster; the host picks the plan from the shape and the SM count
//   alone, never from valid_len, so a captured CUDA graph stays right
//   when valid_len is rewritten on the device. A block attends rows
//   [rank * chunk, min((rank + 1) * chunk, n)); one whose chunk starts at
//   or past n leaves an empty partial (m = -inf, l = 0).
// - Copy: a block walks its chunk in tiles of `tile` rows through a ring
//   of `stages` tiles in shared memory, K (with the rows' scales) and V of
//   a tile each on its own mbarrier. A contiguous run of rows (dh-minor
//   K2) is one bulk copy each (cp.async.bulk, issued by one thread before
//   the block's first barrier); strided runs (T-minor d rows, K7's rows
//   H*dh apart) are 16-byte cp.async by every thread, which arrive on the
//   mbarrier as they land: one bulk copy a K7 row measured slower than
//   the kernel this replaced, the copy engine taking small copies one at
//   a time. Where 16 bytes do not align (dh-minor int8 at dh % 16 != 0,
//   T-minor at T * size % 16 != 0, odd K7 head widths) the threads copy
//   element by element. A lone block of at most 64 contiguous rows (the
//   decode step's self cache, which L2 still holds) stages nothing: 256
//   threads load every row they take at once and reduce from registers.
// - Compute: dh-minor, a group of lanes per row (a slot) with 8- or
//   16-byte reads and a shuffle sum for the dot, and its own online
//   softmax over the rows it takes (running max m, sum l, acc of its
//   columns), so a tile needs no block-wide reduction; the slots merge in
//   order at the end. T-minor, threads split runs of 4 t and 8 groups of d
//   rows, the groups' partial dots summed in order, a block softmax a
//   tile, and P.V by (segment of t, d row) threads summed in order.
//   Scores are kept in base 2, so each exponential is one exp2f.
// - Bias: an optional fp32 additive bias a row (ALiBi), added to the score
//   after the K scale and before the mask and the softmax, as
//   (bias - bias at the head's last valid row) * log2(e): the softmax does
//   not see a constant a head, and the difference keeps the sum from being
//   rounded at ALiBi's magnitudes (~600, where one fp32 step is 6e-5), as
//   the plain version (ops/kernels/decode_attention.py) takes it. The
//   dh-minor paths take it through a template flag (BIAS; K2 builds its
//   kernels with one in a library of their own, decode_attention_bias.cu),
//   so the kernels without one are the code they were; T-minor's through a
//   branch uniform across the launch. An all-zero bias adds 0 to every score, so the
//   output is the one without, bit for bit.
// - Combine in the same launch: each block of a cluster writes its
//   (m, l, acc[dh]) into rank 0's shared memory over DSMEM, and rank 0
//   sums them in rank order and writes the output once, cast to the
//   storage dtype. No workspace, no atomics, no counters: the result
//   repeats bit for bit.
// - Heads of 136..256 (GPT-J's 256): attend_rows_wide, a warp a row, each
//   lane two 4-value vectors (fp32) or one of 8 (the other types); in
//   T-minor one P.V segment, each thread dh / 128 d rows. The partials and
//   rank 0's gather are sized by the kernel's widest head (DHM), 128 or
//   256, so the narrow instantiations keep their shared memory.
// Rows >= valid_len are masked with -1e9, and only rows below it are read
// (their weights are exactly 0 in fp32); valid_len <= 0 masks every row,
// which gives the uniform softmax over all T rows, as the plain formula.
// Quantized caches: k_scale multiplies each score and v_scale each softmax
// weight (q.(k s)^T = (q.k^T) s^T, p.(v s) = (p s^T).v); no dequantized
// cache is ever written.
//
// What the numbers showed (chip_smoke.py --parent, NVIDIA H100 80GB
// HBM3, 700 W, beside the one-block kernel in the same run): the B 4,
// H 6, T 1504 cross case from 0.046-0.064 ms to 0.010-0.014 ms, 2.5-7x its
// bound, about SDPA's time in bf16; every case ahead at B 32 and at the
// self cache's T 33. See PERF.md.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

#include "async_copy.cuh"

namespace decode_split {

namespace cg = cooperative_groups;
using namespace async_copy;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_DH = 128;      // the head widths most instantiations take
constexpr int MAX_DH_WIDE = 256; // ... and the wide ones (GPT-J's 256)
constexpr int MAX_SPLITS = 16;   // a cluster of 16 needs the non-portable size
constexpr int ROW_ALIGN = 16;    // chunk and tile rows are multiples of it
constexpr int T_GROUPS = 8;      // T-minor: groups of d rows in the scores
constexpr int MAX_STAGES = 4;    // tiles in flight a block
constexpr int DIRECT_ROWS = 64;  // the most rows a block reads in place
constexpr int DIRECT_RPS = 8;    // ... and a slot of lanes keeps in registers
                                 // (half as many rows of a wide head)
constexpr int DIRECT_THREADS = 256;  // a block that reads in place: more slots
constexpr int MAX_SMEM = 200 * 1024;
constexpr float MASKED = -1e9f;  // the JAX package's mask value
// Scores are kept in base 2 (q is scaled by log2(e) as it is loaded), so
// every exponential is one exp2f: e^(s - m) = 2^(s log2 e - m log2 e).
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__device__ __forceinline__ T zero() { return T(0.f); }
template <>
__device__ __forceinline__ int8_t zero<int8_t>() { return 0; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// One aligned read of N consecutive values of a row in shared memory,
// widened to floats: 16 bytes for fp32 and bf16, 8 for 1-byte types.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
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

template <typename T>
struct Vec8 {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const T* p, float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = to_float(e[i]);
  }
};
template <> struct Vec<int8_t> : Vec8<int8_t> {};
template <> struct Vec<__nv_fp8_e4m3> : Vec8<__nv_fp8_e4m3> {};

// 4 consecutive t of a T-minor row in shared memory (aligned to 4 values)
template <typename T>
__device__ __forceinline__ void load4(const T* p, float* out) {
  struct alignas(4 * sizeof(T)) Run { T x[4]; };
  const Run r = *reinterpret_cast<const Run*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = to_float(r.x[i]);
}

// ---- reductions ----------------------------------------------------------

// Block-wide max (IS_MAX) or sum, in every thread; warps combine in order.
template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = IS_MAX ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red may still be read by the previous reduction
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) x = IS_MAX ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// ---- one (batch, head) as the engine sees it -------------------------------

// How a tile reaches shared memory: one bulk copy each of K and V (a
// contiguous run of rows), 16-byte cp.async by every thread (strided runs),
// or element by element (what 16 bytes do not align). DIRECT stages
// nothing: a block of one small tile of contiguous rows (the self cache,
// which the decode step has just written and L2 still holds) reads it
// where it lies, without barriers or copies.
enum Copy : int { ELEMENT = 0, BULK = 1, ASYNC = 2, DIRECT = 3 };

template <typename QT, typename CT>
struct Head {
  const QT* q;          // dh values
  const CT* k;          // the head's row 0 (dh-minor) or d row 0 (T-minor)
  const CT* v;
  long long stride;     // elements between rows (dh-minor), d rows (T-minor)
  const float* ks;      // per-row scales from row 0, or null
  const float* vs;
  const float* bias;    // the additive bias of row 0 (rows contiguous), or null
  float bias_ref;       // the bias at the last valid row (0 when all masked)
  QT* out;              // dh values
  int n;                // rows attended: [0, n)
  bool all_masked;      // valid_len <= 0: every score is MASKED, n = T
  Copy copy;
};

// What each block leaves for the cluster's combine, for heads up to DHM.
template <int DHM = MAX_DH>
struct PartialT {
  float m, l;
  float acc[DHM];
};
using Partial = PartialT<>;

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// rows a slot of lanes of a block that reads in place keeps in registers
__host__ __device__ constexpr int direct_rps(int dhm) {
  return dhm > MAX_DH ? DIRECT_RPS / 2 : DIRECT_RPS;
}

// Shared memory: `stages` stages of a tile (K, V: dh-minor, tile rows of
// dhp values; T-minor, dh rows of tile t; the rows' two scales), then the
// tile's scores and T-minor's partial dots. The host sizes the launch
// with the same function.
template <typename CT>
__host__ __device__ inline int stage_bytes(int tile, int dhp) {
  return 2 * round16(tile * dhp * (int)sizeof(CT)) + 2 * tile * (int)sizeof(float);
}

template <typename CT>
__host__ __device__ inline int tile_smem(int tile, int dhp, int stages, bool t_minor) {
  if (!t_minor) return stages * stage_bytes<CT>(tile, dhp);
  const int pv = dhp > THREADS ? dhp : THREADS;  // P.V's partial sums
  const int part = T_GROUPS * tile > pv ? T_GROUPS * tile : pv;
  return stages * stage_bytes<CT>(tile, dhp) + (tile + part) * (int)sizeof(float);
}

template <typename CT>
struct Stage {
  CT* k;
  CT* v;
  float* ks;
  float* vs;
};

template <typename CT>
__device__ __forceinline__ Stage<CT> stage(unsigned char* dyn, int tile, int dhp, int i) {
  const int kv = round16(tile * dhp * (int)sizeof(CT));
  unsigned char* base = dyn + i * stage_bytes<CT>(tile, dhp);
  Stage<CT> s;
  s.k = reinterpret_cast<CT*>(base);
  s.v = reinterpret_cast<CT*>(base + kv);
  s.ks = reinterpret_cast<float*>(base + 2 * kv);
  s.vs = s.ks + tile;
  return s;
}

// The tile's softmax step over the raw dots s[0, rows) (base 2): scales
// them by k_scale (or sets MASKED), updates the block's running max m and
// sum l (the same in every thread) and leaves the weights 2^(s - m), times
// v_scale when quantized, in s. Returns alpha, the factor the accumulator
// is rescaled by.
template <bool QUANT, typename CT>
__device__ __forceinline__ float tile_softmax(float* s, const Stage<CT>& st, int rows,
                                              bool all_masked, const float* bias,
                                              float bias_ref, float& m, float& l,
                                              float* red) {
  float mt = -INFINITY;
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    float x = QUANT ? s[r] * st.ks[r] : s[r];
    if (bias != nullptr) x += (bias[r] - bias_ref) * LOG2E;
    x = all_masked ? MASKED : x;
    s[r] = x;
    mt = fmaxf(mt, x);
  }
  mt = block_reduce<true>(mt, red);
  const float m_new = fmaxf(m, mt);
  const float alpha = exp2f(m - m_new);  // 0 on the first tile (m = -inf)
  float sum = 0.f;
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    const float p = exp2f(s[r] - m_new);
    s[r] = QUANT ? p * st.vs[r] : p;
    sum += p;
  }
  // its barriers also publish every weight in s
  sum = block_reduce<false>(sum, red);
  l = l * alpha + sum;
  m = m_new;
  return alpha;
}

// Starts tile `it` of the chunk into stage `it % stages`: every thread
// calls it. K and the rows' scales complete on bar[2 * stage], V on
// bar[2 * stage + 1].
template <bool T_MINOR, typename QT, typename CT>
__device__ __forceinline__ void issue(const Head<QT, CT>& h, unsigned char* dyn, uint64_t* bar,
                                      int dh, int dhp, int tile, int stages, int c0, int c1,
                                      int it) {
  constexpr int E = 16 / sizeof(CT);  // values in 16 bytes
  const int r0 = c0 + it * tile, rows = min(tile, c1 - r0);
  const int si = it % stages;
  const Stage<CT> st = stage<CT>(dyn, tile, dhp, si);
  const bool quant = h.ks != nullptr;
  uint64_t* kb = bar + 2 * si;
  uint64_t* vb = kb + 1;
  if (h.copy == BULK) {  // dh-minor, contiguous rows; scales with T % 4 == 0
    if (threadIdx.x == 0) {
      const uint32_t bytes = rows * dh * sizeof(CT);
      const uint32_t sbytes = quant ? (rows + 3) / 4 * 16 : 0;  // inside T
      mbar_expect(kb, bytes + 2 * sbytes);
      mbar_expect(vb, bytes);
      bulk_copy(st.k, h.k + (long long)r0 * dh, bytes, kb);
      if (quant) {
        bulk_copy(st.ks, h.ks + r0, sbytes, kb);
        bulk_copy(st.vs, h.vs + r0, sbytes, kb);
      }
      bulk_copy(st.v, h.v + (long long)r0 * dh, bytes, vb);
    }
    return;
  }
  if (h.copy == ASYNC) {
    if (T_MINOR) {  // d rows of rows t, rounded up to 16 bytes inside T
      const int runs = (rows + E - 1) / E;
      for (int i = threadIdx.x; i < dh * runs; i += THREADS) {
        const int d = i / runs, t = (i - d * runs) * E;
        copy16(st.k + d * tile + t, h.k + d * h.stride + r0 + t);
      }
    } else {  // rows of dh values, `stride` apart
      const int pieces = dh / E;
      for (int i = threadIdx.x; i < rows * pieces; i += THREADS) {
        const int r = i / pieces, c = (i - r * pieces) * E;
        copy16(st.k + r * dh + c, h.k + (r0 + r) * h.stride + c);
      }
    }
    if (quant) {
      for (int r = threadIdx.x; r < rows; r += THREADS) {
        copy4(st.ks + r, h.ks + r0 + r);
        copy4(st.vs + r, h.vs + r0 + r);
      }
    }
    mbar_arrive_async(kb);
    if (T_MINOR) {
      const int runs = (rows + E - 1) / E;
      for (int i = threadIdx.x; i < dh * runs; i += THREADS) {
        const int d = i / runs, t = (i - d * runs) * E;
        copy16(st.v + d * tile + t, h.v + d * h.stride + r0 + t);
      }
    } else {
      const int pieces = dh / E;
      for (int i = threadIdx.x; i < rows * pieces; i += THREADS) {
        const int r = i / pieces, c = (i - r * pieces) * E;
        copy16(st.v + r * dh + c, h.v + (r0 + r) * h.stride + c);
      }
    }
    mbar_arrive_async(vb);
    return;
  }
  if (T_MINOR) {
    for (int i = threadIdx.x; i < dh * rows; i += THREADS) {
      const int d = i / rows, t = i - d * rows;
      st.k[d * tile + t] = h.k[d * h.stride + r0 + t];
      st.v[d * tile + t] = h.v[d * h.stride + r0 + t];
    }
  } else {  // rows padded with zeros to dhp values
    for (int i = threadIdx.x; i < rows * dhp; i += THREADS) {
      const int r = i / dhp, d = i - r * dhp;
      const long long g = (r0 + r) * h.stride + d;
      st.k[i] = d < dh ? h.k[g] : zero<CT>();
      st.v[i] = d < dh ? h.v[g] : zero<CT>();
    }
  }
  if (quant) {
    for (int r = threadIdx.x; r < rows; r += THREADS) {
      st.ks[r] = h.ks[r0 + r];
      st.vs[r] = h.vs[r0 + r];
    }
  }
  mbar_arrive(kb);
  mbar_arrive(vb);
}

// Sets up the stages' barriers and starts the first tiles; returns the
// number of tiles of the chunk [c0, c1).
template <bool T_MINOR, typename QT, typename CT>
__device__ __forceinline__ int prologue(const Head<QT, CT>& h, unsigned char* dyn,
                                        uint64_t* bar, int dh, int dhp, int tile, int stages,
                                        int c0, int c1) {
  const int tiles = c0 < c1 ? (c1 - c0 + tile - 1) / tile : 0;
  const int first = min(tiles, stages);
  if (h.copy == DIRECT) return tiles;
  if (threadIdx.x == 0) {
    const uint32_t count = h.copy == BULK ? 1 : THREADS;
    for (int i = 0; i < 2 * stages; ++i) mbar_init(bar + i, count);
    mbar_init_fence();
    // one thread issues bulk copies: they start before the block's barrier
    if (h.copy == BULK)
      for (int it = 0; it < first; ++it)
        issue<T_MINOR>(h, dyn, bar, dh, dhp, tile, stages, c0, c1, it);
  }
  __syncthreads();  // the barriers are initialised
  for (int it = 0; it < first; ++it) {
    if (h.copy != BULK || threadIdx.x != 0)
      issue<T_MINOR>(h, dyn, bar, dh, dhp, tile, stages, c0, c1, it);
  }
  return tiles;
}

// After tile `it`'s last read (and a block barrier): the next tile into
// its stage.
template <bool T_MINOR, typename QT, typename CT>
__device__ __forceinline__ void refill(const Head<QT, CT>& h, unsigned char* dyn, uint64_t* bar,
                                       int dh, int dhp, int tile, int stages, int c0, int c1,
                                       int it, int tiles) {
  if (it + stages >= tiles) return;
  if (h.copy != ELEMENT) fence_proxy_async();
  issue<T_MINOR>(h, dyn, bar, dh, dhp, tile, stages, c0, c1, it + stages);
}

// ---- dh-minor: rows of dh values, `stride` apart ---------------------------

// LPR: lanes per row, a power of two >= ceil(dh / Vec<CT>::N). Each group
// of LPR lanes (a slot) takes rows slot, slot + SLOTS, ... of every tile
// and keeps its own online softmax over them (running max m, sum l, and
// acc of its VEC columns): no block-wide reduction a tile. The slots merge
// in slot order at the end. Returns true when it wrote the output (one
// split), else leaves the block's (m, l, acc) in `out` for combine(). NT:
// the block's threads; a block of other than THREADS reads in place only.
template <typename QT, typename CT, int LPR, int NT = THREADS, bool BIAS = false>
__device__ bool attend_rows(const Head<QT, CT>& h, int dh, int chunk, int tile, int stages,
                            int rank, Partial& out) {
  constexpr int VEC = Vec<CT>::N;
  constexpr bool QUANT = sizeof(CT) == 1;
  constexpr int RPW = 32 / LPR;       // rows a warp takes at once
  constexpr int SLOTS = NT / 32 * RPW;  // rows the block takes at once
  constexpr bool STAGED = NT == THREADS;
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ uint64_t bar[2 * MAX_STAGES];
  __shared__ float part[SLOTS][LPR * VEC];
  __shared__ float slot_m[SLOTS], slot_l[SLOTS];

  const int dhp = (dh + VEC - 1) / VEC * VEC;  // the row in shared memory
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sub = lane % LPR, slot = warp * RPW + lane / LPR;
  const int d0 = sub * VEC;
  const bool active = d0 < dhp;
  const int c0 = rank * chunk, c1 = min(c0 + chunk, h.n);
  const int tiles = STAGED ? prologue<false>(h, dyn, bar, dh, dhp, tile, stages, c0, c1) : 0;

  float qv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) qv[i] = d0 + i < dh ? to_float(h.q[d0 + i]) * LOG2E : 0.f;
  float m = -INFINITY, l = 0.f, acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  // one row into the slot's online softmax: k and v its values, r its
  // index for the scales, bv its bias (read before the row's dot)
  auto take = [&](const float* kv, const float* vv, const float* ks, const float* vs,
                  float bv, int r, bool valid) {
    float dot = 0.f;
    if (active && valid) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) dot = fmaf(qv[i], kv[i], dot);
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (!valid) return;
    float s = QUANT ? dot * ks[r] : dot;
    if constexpr (BIAS) s += (bv - h.bias_ref) * LOG2E;
    s = h.all_masked ? MASKED : s;
    const float m_new = fmaxf(m, s);
    const float alpha = exp2f(m - m_new);  // 0 on the slot's first row
    const float p = exp2f(s - m_new);
    const float w = QUANT ? p * vs[r] : p;
    l = fmaf(l, alpha, p);
    m = m_new;
    if (active) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(w, vv[i], acc[i] * alpha);
    }
  };

  if (h.copy == DIRECT) {
    // one tile of at most DIRECT_ROWS contiguous rows (dhp == dh): every
    // row the slot takes is loaded before the first is reduced
    constexpr int MAXR = (DIRECT_ROWS + SLOTS - 1) / SLOTS < DIRECT_RPS
                             ? (DIRECT_ROWS + SLOTS - 1) / SLOTS
                             : DIRECT_RPS;
    const int rows = c1 - c0;
    const CT* kp = h.k + (long long)c0 * dh + d0;
    const CT* vp = h.v + (long long)c0 * dh + d0;
    const float* bs = BIAS ? h.bias + c0 : nullptr;
    float kv[MAXR][VEC], vv[MAXR][VEC], bv[MAXR];
#pragma unroll
    for (int j = 0; j < MAXR; ++j) {
      const int r = j * SLOTS + slot;
      if (active && r < rows) {
        Vec<CT>::load(kp + r * dh, kv[j]);
        Vec<CT>::load(vp + r * dh, vv[j]);
      }
      bv[j] = BIAS && r < rows ? bs[r] : 0.f;
    }
    const float* ks = QUANT ? h.ks + c0 : nullptr;
    const float* vs = QUANT ? h.vs + c0 : nullptr;
#pragma unroll
    for (int j = 0; j < MAXR; ++j) {
      if (j * SLOTS >= rows) break;  // the same in every thread
      const int r = j * SLOTS + slot;
      take(kv[j], vv[j], ks, vs, bv[j], r, r < rows);
    }
  }
  for (int it = 0; STAGED && it < tiles && h.copy != DIRECT; ++it) {
    const int rows = min(tile, c1 - c0 - it * tile);
    const int si = it % stages;
    const uint32_t phase = (it / stages) & 1;
    const Stage<CT> st = stage<CT>(dyn, tile, dhp, si);
    const float* bs = BIAS ? h.bias + c0 + it * tile : nullptr;
    mbar_wait(bar + 2 * si, phase);
    mbar_wait(bar + 2 * si + 1, phase);
    // every lane of a warp runs the same trip count for the shuffles
    for (int base = 0; base < rows; base += SLOTS) {
      const int r = base + slot;
      const float bv = BIAS && r < rows ? bs[r] : 0.f;
      float kv[VEC], vv[VEC];
      if (active && r < rows) {
        Vec<CT>::load(st.k + r * dhp + d0, kv);
        Vec<CT>::load(st.v + r * dhp + d0, vv);
      }
      take(kv, vv, st.ks, st.vs, bv, r, r < rows);
    }
    __syncthreads();  // the stage is free
    refill<false>(h, dyn, bar, dh, dhp, tile, stages, c0, c1, it, tiles);
  }

  // merge the slots in slot order: M = max m_s, each slot weighed by
  // w_s = 2^(m_s - M) (0 for a slot that took no row). A lone block (one
  // split) writes the output itself; a cluster's blocks leave their
  // partial for combine().
  if (active) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) part[slot][d0 + i] = acc[i];
  }
  if (sub == 0) {
    slot_m[slot] = m;
    slot_l[slot] = l;
  }
  __syncthreads();
  float big = -INFINITY;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) big = fmaxf(big, slot_m[s]);
  const bool alone = cg::this_cluster().num_blocks() == 1;
  for (int d = threadIdx.x; d < dh; d += NT) {
    float x = 0.f, sum = 0.f;
    if (big != -INFINITY) {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const float w = exp2f(slot_m[s] - big);
        x = fmaf(part[s][d], w, x);
        sum = fmaf(slot_l[s], w, sum);
      }
    }
    if (alone) {
      store1(h.out + d, x / sum);
    } else {
      out.acc[d] = x;
      if (d == 0) {
        out.m = big;
        out.l = sum;
      }
    }
  }
  return alone;
}

// attend_rows for heads of 136..256 (DHM = MAX_DH_WIDE): a slot is a
// whole warp (LPR 32), each lane holding VPL vectors of its rows, vectors
// sub, sub + LPR, ... of the row so that neighbouring lanes read
// neighbouring bytes (VPL 2: fp32, 64 vectors of 4; VPL 1: 32 vectors of
// 8 values of the other types). A function of its own: folding the
// vectors a lane into attend_rows cost its quantized cross cases 2-4% on
// an H100 (chip_smoke.py --parent), and the narrow heads keep its code.
template <typename QT, typename CT, int LPR, int NT = THREADS, int VPL = 1, int DHM,
          bool BIAS = false>
__device__ bool attend_rows_wide(const Head<QT, CT>& h, int dh, int chunk, int tile,
                                 int stages, int rank, PartialT<DHM>& out) {
  constexpr int VEC = Vec<CT>::N;
  constexpr bool QUANT = sizeof(CT) == 1;
  constexpr int RPW = 32 / LPR;       // rows a warp takes at once
  constexpr int SLOTS = NT / 32 * RPW;  // rows the block takes at once
  constexpr bool STAGED = NT == THREADS;
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ uint64_t bar[2 * MAX_STAGES];
  __shared__ float part[SLOTS][LPR * VEC * VPL];
  __shared__ float slot_m[SLOTS], slot_l[SLOTS];

  const int dhp = (dh + VEC - 1) / VEC * VEC;  // the row in shared memory
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sub = lane % LPR, slot = warp * RPW + lane / LPR;
  int d0[VPL];
  bool active[VPL];
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    d0[u] = (u * LPR + sub) * VEC;
    active[u] = d0[u] < dhp;
  }
  const int c0 = rank * chunk, c1 = min(c0 + chunk, h.n);
  const int tiles = STAGED ? prologue<false>(h, dyn, bar, dh, dhp, tile, stages, c0, c1) : 0;

  float qv[VPL][VEC];
#pragma unroll
  for (int u = 0; u < VPL; ++u)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      qv[u][i] = d0[u] + i < dh ? to_float(h.q[d0[u] + i]) * LOG2E : 0.f;
  float m = -INFINITY, l = 0.f, acc[VPL][VEC];
#pragma unroll
  for (int u = 0; u < VPL; ++u)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[u][i] = 0.f;

  // one row into the slot's online softmax: k and v its values, r its
  // index for the scales, bv its bias (read before the row's dot)
  auto take = [&](const float (&kv)[VPL][VEC], const float (&vv)[VPL][VEC], const float* ks,
                  const float* vs, float bv, int r, bool valid) {
    float dot = 0.f;
    if (valid) {
#pragma unroll
      for (int u = 0; u < VPL; ++u)
        if (active[u]) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) dot = fmaf(qv[u][i], kv[u][i], dot);
        }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (!valid) return;
    float s = QUANT ? dot * ks[r] : dot;
    if constexpr (BIAS) s += (bv - h.bias_ref) * LOG2E;
    s = h.all_masked ? MASKED : s;
    const float m_new = fmaxf(m, s);
    const float alpha = exp2f(m - m_new);  // 0 on the slot's first row
    const float p = exp2f(s - m_new);
    const float w = QUANT ? p * vs[r] : p;
    l = fmaf(l, alpha, p);
    m = m_new;
#pragma unroll
    for (int u = 0; u < VPL; ++u)
      if (active[u]) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[u][i] = fmaf(w, vv[u][i], acc[u][i] * alpha);
      }
  };

  if (h.copy == DIRECT) {
    // one tile of at most DIRECT_ROWS contiguous rows (dhp == dh): every
    // row the slot takes is loaded before the first is reduced
    constexpr int MAXR = (DIRECT_ROWS + SLOTS - 1) / SLOTS < direct_rps(DHM)
                             ? (DIRECT_ROWS + SLOTS - 1) / SLOTS
                             : direct_rps(DHM);
    const int rows = c1 - c0;
    const CT* kp = h.k + (long long)c0 * dh;
    const CT* vp = h.v + (long long)c0 * dh;
    const float* bs = BIAS ? h.bias + c0 : nullptr;
    float kv[MAXR][VPL][VEC], vv[MAXR][VPL][VEC], bv[MAXR];
#pragma unroll
    for (int j = 0; j < MAXR; ++j) {
      const int r = j * SLOTS + slot;
#pragma unroll
      for (int u = 0; u < VPL; ++u)
        if (active[u] && r < rows) {
          Vec<CT>::load(kp + r * dh + d0[u], kv[j][u]);
          Vec<CT>::load(vp + r * dh + d0[u], vv[j][u]);
        }
      bv[j] = BIAS && r < rows ? bs[r] : 0.f;
    }
    const float* ks = QUANT ? h.ks + c0 : nullptr;
    const float* vs = QUANT ? h.vs + c0 : nullptr;
#pragma unroll
    for (int j = 0; j < MAXR; ++j) {
      if (j * SLOTS >= rows) break;  // the same in every thread
      const int r = j * SLOTS + slot;
      take(kv[j], vv[j], ks, vs, bv[j], r, r < rows);
    }
  }
  for (int it = 0; STAGED && it < tiles && h.copy != DIRECT; ++it) {
    const int rows = min(tile, c1 - c0 - it * tile);
    const int si = it % stages;
    const uint32_t phase = (it / stages) & 1;
    const Stage<CT> st = stage<CT>(dyn, tile, dhp, si);
    const float* bs = BIAS ? h.bias + c0 + it * tile : nullptr;
    mbar_wait(bar + 2 * si, phase);
    mbar_wait(bar + 2 * si + 1, phase);
    // every lane of a warp runs the same trip count for the shuffles
    for (int base = 0; base < rows; base += SLOTS) {
      const int r = base + slot;
      const float bv = BIAS && r < rows ? bs[r] : 0.f;
      float kv[VPL][VEC], vv[VPL][VEC];
#pragma unroll
      for (int u = 0; u < VPL; ++u)
        if (active[u] && r < rows) {
          Vec<CT>::load(st.k + r * dhp + d0[u], kv[u]);
          Vec<CT>::load(st.v + r * dhp + d0[u], vv[u]);
        }
      take(kv, vv, st.ks, st.vs, bv, r, r < rows);
    }
    __syncthreads();  // the stage is free
    refill<false>(h, dyn, bar, dh, dhp, tile, stages, c0, c1, it, tiles);
  }

  // merge the slots in slot order: M = max m_s, each slot weighed by
  // w_s = 2^(m_s - M) (0 for a slot that took no row). A lone block (one
  // split) writes the output itself; a cluster's blocks leave their
  // partial for combine().
#pragma unroll
  for (int u = 0; u < VPL; ++u)
    if (active[u]) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) part[slot][d0[u] + i] = acc[u][i];
    }
  if (sub == 0) {
    slot_m[slot] = m;
    slot_l[slot] = l;
  }
  __syncthreads();
  float big = -INFINITY;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) big = fmaxf(big, slot_m[s]);
  const bool alone = cg::this_cluster().num_blocks() == 1;
  for (int d = threadIdx.x; d < dh; d += NT) {
    float x = 0.f, sum = 0.f;
    if (big != -INFINITY) {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const float w = exp2f(slot_m[s] - big);
        x = fmaf(part[s][d], w, x);
        sum = fmaf(slot_l[s], w, sum);
      }
    }
    if (alone) {
      store1(h.out + d, x / sum);
    } else {
      out.acc[d] = x;
      if (d == 0) {
        out.m = big;
        out.l = sum;
      }
    }
  }
  return alone;
}

// ---- T-minor: dh rows of T values, `stride` (= T) apart ---------------------

template <typename QT, typename CT, int DHM>
__device__ void attend_t_minor(const Head<QT, CT>& h, int dh, int chunk, int tile, int stages,
                               int rank, PartialT<DHM>& out) {
  constexpr bool QUANT = sizeof(CT) == 1;
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ uint64_t bar[2 * MAX_STAGES];
  __shared__ float red[WARPS];
  __shared__ float qs[DHM];

  float* s = reinterpret_cast<float*>(dyn + stages * stage_bytes<CT>(tile, dh));
  float* part = s + tile;  // [T_GROUPS][tile] dots, then [segments][dh] P.V
  const int c0 = rank * chunk, c1 = min(c0 + chunk, h.n);
  const int dg = dh / T_GROUPS;  // dh % 8 == 0
  const int tiles = prologue<true>(h, dyn, bar, dh, dh, tile, stages, c0, c1);

  for (int d = threadIdx.x; d < dh; d += THREADS) {
    qs[d] = to_float(h.q[d]) * LOG2E;
    out.acc[d] = 0.f;  // one owner a d row: thread d % THREADS
  }
  __syncthreads();

  float m = -INFINITY, l = 0.f;
  for (int it = 0; it < tiles; ++it) {
    const int rows = min(tile, c1 - c0 - it * tile);
    const int si = it % stages;
    const uint32_t phase = (it / stages) & 1;
    const Stage<CT> st = stage<CT>(dyn, tile, dh, si);
    mbar_wait(bar + 2 * si, phase);
    // partial dots: item = (run of 4 t, group of dg d rows); a run may pass
    // `rows` inside the tile, and those values go unused
    const int runs = (rows + 3) / 4;
    for (int i = threadIdx.x; i < runs * T_GROUPS; i += THREADS) {
      const int t0 = (i % runs) * 4, g = i / runs;
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = g * dg; d < (g + 1) * dg; ++d) {
        float kv[4];
        load4(st.k + d * tile + t0, kv);
#pragma unroll
        for (int j = 0; j < 4; ++j) dot[j] = fmaf(qs[d], kv[j], dot[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) part[g * tile + t0 + j] = dot[j];
    }
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += THREADS) {
      float dot = part[r];
#pragma unroll
      for (int g = 1; g < T_GROUPS; ++g) dot += part[g * tile + r];
      s[r] = dot;
    }
    const float* bs = h.bias != nullptr ? h.bias + c0 + it * tile : nullptr;
    const float alpha =
        tile_softmax<QUANT>(s, st, rows, h.all_masked, bs, h.bias_ref, m, l, red);

    mbar_wait(bar + 2 * si + 1, phase);
    // P.V: thread (segment g, d row) sums its segment of the rows, 4 t at
    // a time; the segments add up in order. A head wider than the block
    // (DHM > THREADS) takes one segment, each thread dh / THREADS d rows.
    {
      auto segment = [&](int g, int d, int seg) {
        float a = 0.f;
        const int t1 = min(rows, (g + 1) * seg);
        for (int t0 = g * seg; t0 < t1; t0 += 4) {
          float vv[4];
          load4(st.v + d * tile + t0, vv);
          const float4 p = *reinterpret_cast<const float4*>(s + t0);
          const float pw[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (t0 + j < rows) a = fmaf(pw[j], vv[j], a);
        }
        part[g * dh + d] = a;
      };
      int segs = 1;
      if constexpr (DHM <= THREADS) {
        segs = THREADS / dh;
        const int g = threadIdx.x / dh;
        if (g < segs)  // t a segment: whole runs
          segment(g, threadIdx.x - g * dh, (runs + segs - 1) / segs * 4);
      } else {
        for (int d = threadIdx.x; d < dh; d += THREADS) segment(0, d, runs * 4);
      }
      __syncthreads();
      for (int dd = threadIdx.x; dd < dh; dd += THREADS) {
        float a = 0.f;
        for (int gg = 0; gg < segs; ++gg) a += part[gg * dh + dd];
        out.acc[dd] = out.acc[dd] * alpha + a;
      }
    }
    __syncthreads();
    refill<true>(h, dyn, bar, dh, dh, tile, stages, c0, c1, it, tiles);
  }
  if (threadIdx.x == 0) {
    out.m = m;
    out.l = l;
  }
}

// ---- the cluster's combine ---------------------------------------------

// Every thread calls it first in a kernel of clusters of more than one
// block: its arrival on the cluster barrier that combine() waits on before
// writing into rank 0's shared memory, which must have started.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Every block of the cluster calls it with its partial: each writes its
// (m, l, acc) into rank 0's shared memory, and rank 0 writes
// out[d] = sum_r acc_r[d] e^(m_r - M) / sum_r l_r e^(m_r - M), M = max m_r,
// every sum in rank order. The other ranks leave at once: no block reads
// their shared memory.
template <typename QT, int DHM>
__device__ void combine(PartialT<DHM>& mine, int dh, QT* out) {
  __shared__ float gather[MAX_SPLITS][DHM + 2];  // rank 0's: (m, l, acc)
  __shared__ float w[MAX_SPLITS];
  __shared__ float l_sum;
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  __syncthreads();  // the partial is written
  if (splits == 1) {
    for (int d = threadIdx.x; d < dh; d += THREADS) store1(out + d, mine.acc[d] / mine.l);
    return;
  }
  const int rank = static_cast<int>(cluster.block_rank());
  cluster_wait();  // every block of the cluster has started
  float* row = cluster.map_shared_rank(&gather[rank][0], 0);
  for (int d = threadIdx.x; d < dh; d += THREADS) row[2 + d] = mine.acc[d];
  if (threadIdx.x == 0) {
    row[0] = mine.m;
    row[1] = mine.l;
  }
  cluster.sync();  // every partial has landed in rank 0
  if (rank != 0) return;
  if (threadIdx.x == 0) {
    float big = -INFINITY;
    for (int r = 0; r < splits; ++r) big = fmaxf(big, gather[r][0]);
    float sum = 0.f;
    for (int r = 0; r < splits; ++r) {
      w[r] = exp2f(gather[r][0] - big);  // 0 for an empty partial
      sum += gather[r][1] * w[r];
    }
    l_sum = sum;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < dh; d += THREADS) {
    float a = 0.f;
    for (int r = 0; r < splits; ++r) a += gather[r][2 + d] * w[r];
    store1(out + d, a / l_sum);
  }
}

// ---- launching -------------------------------------------------------------

// Grid splits * bh blocks in clusters of `splits`: block x is chunk
// x % splits of (batch, head) x / splits. Sets the kernel's shared-memory
// and cluster-size attributes once per device.
template <int NT = THREADS, typename... KernelArgs, typename... Args>
cudaError_t launch(void (*kernel)(KernelArgs...), unsigned* ready, int splits, int bh,
                   int smem, cudaStream_t stream, Args&&... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(*ready >> dev & 1u)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    *ready |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(splits * bh));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // one block a head: no cluster
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The plan the host passes: splits in 1..MAX_SPLITS, chunk and tile
// multiples of ROW_ALIGN, the chunks covering t_split rows with none empty
// of rows, and the tile's shared memory within the limit.
inline bool plan_ok(int t_split, int splits, int chunk, int tile, int stages, int smem) {
  return splits >= 1 && splits <= MAX_SPLITS && chunk > 0 && chunk % ROW_ALIGN == 0 &&
         tile > 0 && tile % ROW_ALIGN == 0 && stages >= 1 && stages <= MAX_STAGES &&
         (long long)(splits - 1) * chunk < t_split && (long long)splits * chunk >= t_split &&
         smem <= MAX_SMEM;
}

}  // namespace decode_split
