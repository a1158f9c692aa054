// One decoder layer's decode step after the cache append, in one
// cooperative launch, for Hopper (sm_90a).
//
// Replaces whisper_trtllm_tpu/ops/pallas/fused_decoder_step.py::
// fused_decoder_layer_step (_kernel): q projection -> masked self attention
// over the cache rows t <= pos -> out projection + residual -> LN2 ->
// cross-q projection -> cross attention over the rows t < enc_len -> out
// projection + residual -> LN3 -> fc1 -> exact GELU (erff) -> fc2 +
// residual. x, the residual stream, LayerNorm statistics and softmaxes are
// fp32; every projection casts its fp32 input to the weight dtype (fp32 or
// bf16) and sums fp32 products; masked scores are -1e9; the output is in
// x's dtype.
//
// What bounds it: at batch 4 every projection is a matrix-vector product,
// about 2 flops per weight byte, far below the card's ridge, so the bytes
// bound it: a layer's six weight matrices (7.08 MB fp32 at tiny.en) and the
// cross K/V (18.48 MB fp32 at T = 1504) are read once per step, ~26 MB or
// ~7.75 us at 3.35 TB/s. The TPU kernel is one sequential program with the
// weights resident in VMEM; one block streaming them here would read at a
// single SM's rate. So the work is spread over every SM and the phases are
// separated by grid-wide barriers (cooperative launch, one or two resident
// blocks per SM, grid sized from the occupancy query). One instantiation
// per storage dtype: head dim 64 (every Whisper size) and up to MAX_B
// batch rows.
//   1. q partials: projections are cut into items of 64 output columns
//      (2 per lane) x 32 input rows, one warp each, the 32 weight rows
//      loaded at once; each item writes fp32 partial sums, which the
//      consumer adds in a fixed order (no atomics: results repeat exactly).
//   2. self attention, one warp per (b, h), online softmax over 32-row
//      chunks; q = (sum of partials + bias) * dh^-0.5.
//   3. out-projection partials.  4. one block per batch row: x_mid = x +
//      bias + partials, LN2.  5. cross-q partials.
//   6. cross attention split over T (flash-decoding): one warp per
//      (b, h, chunk of 32 rows) writes (max, sum, acc[dh]);
//      a ragged last chunk is masked.  7. combine the chunks per (b, h).
//   8. cross out-projection partials.  9. x2 = x_mid + bias + partials,
//      LN3.  10. fc1 partials.  11. fc2 partials, its input GELU(fc1
//      partials + bias) formed as it is loaded.  12. y = x2 + bias +
//      partials, stored in x's dtype.
// pos and enc_len are read from device memory: no host sync.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KCHUNK = 32;   // input rows of a projection item
constexpr int NGROUP = 64;   // output columns of a projection item
constexpr int ITERS = 8;     // row groups an attention chunk loads at once
constexpr int DH = 64;     // head dim (every Whisper size)
constexpr int LPR = DH / 8;  // lanes that share a cache row, 8 elements each
constexpr int MAX_B = 16;
constexpr int MAX_D = 2048;
constexpr float MASK = -1e9f;
constexpr float NEG_BIG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* x;
  const void* h1;
  const int* pos;
  const int* enc_len;
  // q, out, LN2, cross q, cross out, LN3, fc1, fc2: weight (or LN scale)
  // and bias (may be null)
  const void* w[8];
  const void* bias[8];
  const void* sk;
  const void* sv;
  const void* ck;
  const void* cv;
  void* out;
  float* ws;
  unsigned long long* timeline;  // null, or 13 slots (see the C interface)
  int b, h, ts, tc, d, ffn;
  float scale;
};

constexpr int CT = ITERS * 32 / LPR;  // cache rows of an attention chunk

__host__ __device__ inline int cross_chunks(int tc) { return (tc + CT - 1) / CT; }

// fp32 workspace, in floats
struct Layout {
  size_t part_q, a, part_o, xmid, h2, part_cq, cpart, ca, part_co, x2, h3,
      part_f1, part_f2, total;
};

__host__ __device__ inline Layout layout(int b, int h, int tc, int d, int ffn) {
  Layout L;
  const size_t pd = d / KCHUNK, pf = ffn / KCHUNK, bd = (size_t)b * d;
  size_t o = 0;
  L.part_q = o;  o += pd * bd;
  L.a = o;       o += bd;
  L.part_o = o;  o += pd * bd;
  L.xmid = o;    o += bd;
  L.h2 = o;      o += bd;
  L.part_cq = o; o += pd * bd;
  L.cpart = o;   o += (size_t)b * h * cross_chunks(tc) * (DH + 2);
  L.ca = o;      o += bd;
  L.part_co = o; o += pd * bd;
  L.x2 = o;      o += bd;
  L.h3 = o;      o += bd;
  L.part_f1 = o; o += pd * (size_t)b * ffn;
  L.part_f2 = o; o += pf * bd;
  L.total = o;
  return L;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// the cast of a dot's fp32 input to the weight dtype, kept as fp32
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

template <typename T>
__device__ __forceinline__ float param(const void* p, int i) {
  return p == nullptr ? 0.f : to_f(static_cast<const T*>(p)[i]);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// ---- projections ----------------------------------------------------------
// What a projection reads as its input element (b, k), in fp32: a (B, K)
// tensor in the storage dtype (LN1(x)), an fp32 workspace row, or GELU of
// the sum of the fc1 partials plus bias, formed as it is read.
enum InKind { IN_STORE = 0, IN_F32 = 1, IN_GELU = 2 };

struct ProjIn {
  int kind;
  const void* p;     // IN_STORE, IN_F32: the (B, K) input; IN_GELU: partials
  const void* bias;  // IN_GELU: fc1's bias
  int ld;            // row stride of the input (of the partials for IN_GELU)
  int P;             // IN_GELU: number of partials
};

template <typename T>
__device__ __forceinline__ float proj_in(const ProjIn& in, int B, int b, int k) {
  if (in.kind == IN_STORE) return to_f(static_cast<const T*>(in.p)[(size_t)b * in.ld + k]);
  if (in.kind == IN_F32) return static_cast<const float*>(in.p)[(size_t)b * in.ld + k];
  const float* part = static_cast<const float*>(in.p);
  float s = 0.f;
#pragma unroll 8
  for (int c = 0; c < in.P; ++c) s += part[((size_t)c * B + b) * in.ld + k];
  s += param<T>(in.bias, k);
  return 0.5f * s * (1.f + erff(s * 0.70710678118654752f));
}

// partial (B, N) products of in (B, K) and W (K, N), one warp per item of
// 64 columns x 32 rows: part[(kc * B + b) * N + n] for row chunk kc. Not
// inlined: one copy serves the kernel's six projections, which keeps
// ptxas's time down.
template <typename T>
__device__ __noinline__ void project(const ProjIn in, const T* __restrict__ W,
                                     int K, int N, int B,
                                     float* __restrict__ part, int gw, int nw,
                                     int lane) {
  const int groups = N / NGROUP;
  const int items = groups * (K / KCHUNK);
  for (int it = gw; it < items; it += nw) {
    const int n0 = (it % groups) * NGROUP + 2 * lane;
    const int kc = it / groups;
    const int k0 = kc * KCHUNK;
    float2 w[KCHUNK];
#pragma unroll
    for (int r = 0; r < KCHUNK; ++r) w[r] = load2(W + (size_t)(k0 + r) * N + n0);
    // one batch row at a time (B is uniform over the warp), its 32 input
    // elements spread over the lanes
#pragma unroll
    for (int bb = 0; bb < MAX_B; ++bb) {
      if (bb >= B) break;
      const float xin = round_to<T>(proj_in<T>(in, B, bb, k0 + lane));
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int r = 0; r < KCHUNK; ++r) {
        const float xv = __shfl_sync(FULL, xin, r);
        acc.x = fmaf(xv, w[r].x, acc.x);
        acc.y = fmaf(xv, w[r].y, acc.y);
      }
      *reinterpret_cast<float2*>(part + ((size_t)kc * B + bb) * N + n0) = acc;
    }
  }
}

// ---- attention ------------------------------------------------------------
// A warp reads rows in groups of 32 / LPR; LPR lanes share a row, 8
// elements each.

// the lane's 8 query elements of head hh: (sum of partials + bias) * scale
template <typename T>
__device__ void load_q(float (&q)[8], const float* part, const void* bias,
                       int P, int B, int d, int b, int hh, float scale,
                       int lane) {
  const int e = hh * DH + (lane % (DH / 8)) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float s = 0.f;
#pragma unroll 4
    for (int c = 0; c < P; ++c) s += part[((size_t)c * B + b) * d + e + j];
    q[j] = (s + param<T>(bias, e + j)) * scale;
  }
}

// rows [t0, t0 + chunk) of K, V (T, DH) that lie below `limit`, merged
// into the online softmax state: m (warp-uniform), l and acc (per row
// group, the lane's 8 elements). A row at or past `valid` scores MASK.
template <typename T>
__device__ void attend_chunk(const float (&q)[8], const T* __restrict__ K,
                             const T* __restrict__ V, int t0, int limit,
                             int valid, float& m, float& l, float (&acc)[8],
                             int lane) {
  constexpr int RPI = 32 / LPR;
  const int g = lane / LPR, e0 = (lane % LPR) * 8;
  float s[ITERS];
  float kv[ITERS][8];
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int t = t0 + i * RPI + g;
    if (t < limit) {
      load8(K + (size_t)t * DH + e0, kv[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[i][j] = 0.f;
    }
  }
  float mc = -INFINITY;
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) p = fmaf(q[j], kv[i][j], p);
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1) p += __shfl_xor_sync(FULL, p, off);
    const int t = t0 + i * RPI + g;
    s[i] = t >= limit ? -INFINITY : (t < valid ? p : MASK);
    mc = fmaxf(mc, s[i]);
  }
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) mc = fmaxf(mc, __shfl_xor_sync(FULL, mc, off));
  const float m_new = fmaxf(m, mc);
  const float corr = expf(m - m_new);
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int t = t0 + i * RPI + g;
    if (t < limit) {
      load8(V + (size_t)t * DH + e0, kv[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[i][j] = 0.f;
    }
  }
  float ls = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] *= corr;
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const float p = expf(s[i] - m_new);  // 0 for rows past `limit`
    ls += p;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = fmaf(p, kv[i][j], acc[j]);
  }
  l = l * corr + ls;
  m = m_new;
}

// sum l and acc over the warp's row groups (every lane ends with the total)
__device__ __forceinline__ void reduce_groups(float& l, float (&acc)[8]) {
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
    l += __shfl_xor_sync(FULL, l, off);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += __shfl_xor_sync(FULL, acc[j], off);
  }
}

// ---- residual + LayerNorm, one block per batch row -------------------------
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  __syncthreads();
  return s;
}

// xres = base + bias + sum of partials (fp32, kept for the next residual);
// hout = LN(xres) * ln_s + ln_b. base is x (storage dtype) or fp32.
template <typename T>
__device__ void residual_ln(int B, int d, const T* base_t, const float* base_f,
                            const void* bias, const float* part, int P,
                            const void* ln_s, const void* ln_b, float* xres,
                            float* hout, float* row, float* red) {
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    float sum = 0.f;
    for (int k = threadIdx.x; k < d; k += THREADS) {
      float v = base_t != nullptr ? to_f(base_t[(size_t)b * d + k]) : base_f[(size_t)b * d + k];
      v += param<T>(bias, k);
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < P; ++c) s += part[((size_t)c * B + b) * d + k];
      v += s;
      row[k] = v;
      xres[(size_t)b * d + k] = v;
      sum += v;
    }
    const float mean = block_sum(sum, red) / d;
    float sq = 0.f;
    for (int k = threadIdx.x; k < d; k += THREADS) {
      const float dv = row[k] - mean;
      sq += dv * dv;
    }
    const float rstd = rsqrtf(block_sum(sq, red) / d + 1e-5f);
    for (int k = threadIdx.x; k < d; k += THREADS)
      hout[(size_t)b * d + k] = (row[k] - mean) * rstd * param<T>(ln_s, k) + param<T>(ln_b, k);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) fused_step_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float row[MAX_D];
  __shared__ float red[WARPS];
  // the grid-wide barrier between phases; with a timeline, block 0 stamps
  // the start and the end of every phase (the end of the last one is its
  // own)
  const bool stamp = a.timeline != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  int phase = 0;
  if (stamp) a.timeline[0] = global_ns();
  auto sync = [&]() {
    grid.sync();
    ++phase;
    if (stamp) a.timeline[phase] = global_ns();
  };
  const int lane = threadIdx.x % 32;
  const int gw = (threadIdx.x / 32) * gridDim.x + blockIdx.x;
  const int nw = WARPS * gridDim.x;
  const int B = a.b, H = a.h, d = a.d, ffn = a.ffn;
  const int pd = d / KCHUNK, pf = ffn / KCHUNK;
  const Layout L = layout(B, H, a.tc, d, ffn);
  float* ws = a.ws;
  const T* sk = static_cast<const T*>(a.sk);
  const T* sv = static_cast<const T*>(a.sv);
  const T* ck = static_cast<const T*>(a.ck);
  const T* cv = static_cast<const T*>(a.cv);
  const int e0 = (lane % LPR) * 8;

  // 1. q projection of LN1(x)
  project<T>(ProjIn{IN_STORE, a.h1, nullptr, d, 0}, static_cast<const T*>(a.w[0]), d, d,
             B, ws + L.part_q, gw, nw, lane);
  sync();

  // 2. self attention over the rows t <= pos
  {
    const int valid = min(max(*a.pos + 1, 0), a.ts);
    const int limit = valid > 0 ? valid : a.ts;  // none valid: all at MASK
    for (int it = gw; it < B * H; it += nw) {
      const int b = it / H, hh = it % H;
      float q[8], acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float m = NEG_BIG, l = 0.f;
      load_q<T>(q, ws + L.part_q, a.bias[0], pd, B, d, b, hh, a.scale, lane);
      const size_t off = (size_t)it * a.ts * DH;
      for (int t0 = 0; t0 < limit; t0 += CT)
        attend_chunk<T>(q, sk + off, sv + off, t0, limit, valid, m, l, acc, lane);
      reduce_groups(l, acc);
      if (lane < LPR)
#pragma unroll
        for (int j = 0; j < 8; ++j) ws[L.a + (size_t)b * d + hh * DH + e0 + j] = acc[j] / l;
    }
  }
  sync();

  // 3. self-attention out projection
  project<T>(ProjIn{IN_F32, ws + L.a, nullptr, d, 0}, static_cast<const T*>(a.w[1]), d, d, B,
             ws + L.part_o, gw, nw, lane);
  sync();

  // 4. x_mid = x + bias + partials; LN2
  residual_ln<T>(B, d, static_cast<const T*>(a.x), nullptr, a.bias[1], ws + L.part_o, pd,
                 a.w[2], a.bias[2], ws + L.xmid, ws + L.h2, row, red);
  sync();

  // 5. cross-attention q projection
  project<T>(ProjIn{IN_F32, ws + L.h2, nullptr, d, 0}, static_cast<const T*>(a.w[3]), d, d, B,
             ws + L.part_cq, gw, nw, lane);
  sync();

  // 6. cross attention, one warp per (b, h, chunk of rows)
  const int nc = cross_chunks(a.tc);
  {
    const int valid = min(max(*a.enc_len, 0), a.tc);
    const int limit = valid > 0 ? valid : a.tc;
    for (int it = gw; it < B * H * nc; it += nw) {
      const int c = it % nc, bh = it / nc;
      const int b = bh / H, hh = bh % H;
      float q[8], acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float m = NEG_BIG, l = 0.f;
      if (c * CT < limit) {
        load_q<T>(q, ws + L.part_cq, a.bias[3], pd, B, d, b, hh, a.scale, lane);
        const size_t off = (size_t)bh * a.tc * DH;
        attend_chunk<T>(q, ck + off, cv + off, c * CT, limit, valid, m, l, acc, lane);
        reduce_groups(l, acc);
      }
      float* dst = ws + L.cpart + (size_t)it * (DH + 2);
      if (lane == 0) {
        dst[0] = m;
        dst[1] = l;
      }
      if (lane < LPR)
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[2 + e0 + j] = acc[j];
    }
  }
  sync();

  // 7. combine the chunks of each (b, h): the lanes split the chunks for
  // the max and the sum, then each lane adds its elements over all chunks
  for (int it = gw; it < B * H; it += nw) {
    const float* src = ws + L.cpart + (size_t)it * nc * (DH + 2);
    float mx = NEG_BIG;
    for (int c = lane; c < nc; c += 32) mx = fmaxf(mx, src[(size_t)c * (DH + 2)]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    float l = 0.f;
    for (int c = lane; c < nc; c += 32)
      l += src[(size_t)c * (DH + 2) + 1] * expf(src[(size_t)c * (DH + 2)] - mx);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(FULL, l, off);
    const int b = it / H, hh = it % H;
    for (int e = lane; e < DH; e += 32) {
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < nc; ++c)
        acc += src[(size_t)c * (DH + 2) + 2 + e] * expf(src[(size_t)c * (DH + 2)] - mx);
      ws[L.ca + (size_t)b * d + hh * DH + e] = acc / l;
    }
  }
  sync();

  // 8. cross-attention out projection
  project<T>(ProjIn{IN_F32, ws + L.ca, nullptr, d, 0}, static_cast<const T*>(a.w[4]), d, d, B,
             ws + L.part_co, gw, nw, lane);
  sync();

  // 9. x2 = x_mid + bias + partials; LN3
  residual_ln<T>(B, d, nullptr, ws + L.xmid, a.bias[4], ws + L.part_co, pd, a.w[5],
                 a.bias[5], ws + L.x2, ws + L.h3, row, red);
  sync();

  // 10. fc1
  project<T>(ProjIn{IN_F32, ws + L.h3, nullptr, d, 0}, static_cast<const T*>(a.w[6]), d, ffn, B,
             ws + L.part_f1, gw, nw, lane);
  sync();

  // 11. fc2 of GELU(fc1)
  project<T>(ProjIn{IN_GELU, ws + L.part_f1, a.bias[6], ffn, pd},
             static_cast<const T*>(a.w[7]), ffn, d, B, ws + L.part_f2, gw, nw, lane);
  sync();

  // 12. y = x2 + bias + partials, in x's dtype
  T* out = static_cast<T*>(a.out);
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < B * d; i += gridDim.x * THREADS) {
    const int b = i / d, n = i % d;
    float s = 0.f;
#pragma unroll 8
    for (int c = 0; c < pf; ++c) s += ws[L.part_f2 + ((size_t)c * B + b) * d + n];
    out[i] = from_f<T>(ws[L.x2 + i] + param<T>(a.bias[7], n) + s);
  }
  if (stamp) a.timeline[phase + 1] = global_ns();
}

template <typename T>
cudaError_t launch(Args& a, cudaStream_t st) {
  void (*kern)(Args) = fused_step_kernel<T>;
  // resident blocks per SM, cached per device: every block of a
  // cooperative launch must be resident at once
  static int occupancy[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (occupancy[dev] == 0) {
    int coop = 0, occ = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, THREADS, 0);
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
    occupancy[dev] = occ < 2 ? occ : 2;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                    dim3(sms * occupancy[dev]), dim3(THREADS), args, 0, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// x, h1, out (B, d); pos, enc_len int32 on the device; for each of q, out,
// LN2, cross q, cross out, LN3, fc1, fc2 the weight ((in, out), or the LN
// scale (d,)) then its bias (or null); self cache (B, H, Ts, dh) x2, cross
// cache (B, H, Tc, dh) x2; every float tensor in `dtype` (0 float32,
// 1 bfloat16), contiguous; `ws` fp32 of at least `ws_floats`, which must
// cover the workspace layout() lays out; `timeline` null, or 13 device uint64
// slots that receive the global timer (ns) at the start of the kernel and
// at the end of each of its 12 phases, as block 0 sees them. 1 <= B <= 16,
// dh = 64, d = H * dh, d and ffn multiples of 64, d <= 2048.
// Returns a cudaError_t.
int fused_decoder_step(
    const void* x, const void* h1, const void* pos, const void* enc_len,
    const void* wq, const void* bq, const void* wo, const void* bo,
    const void* ln2s, const void* ln2b, const void* wcq, const void* bcq,
    const void* wco, const void* bco, const void* ln3s, const void* ln3b,
    const void* wf1, const void* bf1, const void* wf2, const void* bf2,
    const void* sk, const void* sv, const void* ck, const void* cv, void* out,
    void* ws, void* timeline, int b, int h, int ts, int dh, int tc, int d,
    int ffn, int dtype,
    int ws_floats, void* stream) {
  if (b < 1 || b > MAX_B || h < 1 || ts < 1 || tc < 1 || d != h * dh ||
      d % NGROUP || ffn % NGROUP || ffn < NGROUP || d > MAX_D ||
      dh != DH || dtype < 0 || dtype > 1 ||
      ws_floats < 0 || (size_t)ws_floats < layout(b, h, tc, d, ffn).total)
    return cudaErrorInvalidValue;
  Args a;
  a.x = x; a.h1 = h1;
  a.pos = static_cast<const int*>(pos);
  a.enc_len = static_cast<const int*>(enc_len);
  const void* w[8] = {wq, wo, ln2s, wcq, wco, ln3s, wf1, wf2};
  const void* bias[8] = {bq, bo, ln2b, bcq, bco, ln3b, bf1, bf2};
  for (int i = 0; i < 8; ++i) {
    a.w[i] = w[i];
    a.bias[i] = bias[i];
  }
  a.sk = sk; a.sv = sv; a.ck = ck; a.cv = cv;
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.timeline = static_cast<unsigned long long*>(timeline);
  a.b = b; a.h = h; a.ts = ts; a.tc = tc; a.d = d; a.ffn = ffn;
  a.scale = static_cast<float>(pow(static_cast<double>(dh), -0.5));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(a, st) : launch<__nv_bfloat16>(a, st);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
