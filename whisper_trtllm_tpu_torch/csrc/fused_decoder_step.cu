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
// ~7.75 us at 3.35 TB/s, ~195 KB for each of the 132 SMs. The TPU kernel is
// one sequential program with the weights resident in VMEM; here the work
// is spread over every SM, and what costs time is the chain of dependent
// phases: each waits for the blocks that produce what it reads.
//
// Design. Six phases, five waits (the previous kernel ran twelve phases
// between eleven grid.sync()s, and read each phase's weights only after
// the barrier before it):
//   0. q + self attention, one block a head: the head's q for every batch
//      row with the full d-deep sum (no split-K partials), then the head's
//      attention over the rows t <= pos for every b -> a (B, d).
//   1. out projection, one block per group of CG columns, full d-deep:
//      x_mid = x + bias + a Wo.
//   2. cross attention, one block per (head, split of the cross rows): the
//      block recomputes LN2 of the B rows from x_mid, the head's cross q
//      with the full sum, attends its split of the rows t < enc_len for
//      every b and writes (max, sum, acc[dh]); the last block of a head to
//      finish (a ticket in global memory) combines the head's splits in
//      split order -> ca (B, d). A split past enc_len weighs exp(-1e30) = 0.
//   3. cross out projection, column groups: x2 = x_mid + bias + ca Wco.
//   4. MLP, one block per group of G ffn columns: LN3 of the B rows
//      recomputed from x2, fc1 of the group over the full d, GELU once in
//      registers, times fc2's G rows -> one (B, d) partial a group; fc1's
//      output never reaches global memory.
//   5. store: y = x2 + bias + the partials summed in a fixed order.
// Every sum is taken in a fixed order (no atomics on data): results repeat
// bit for bit. The split and the groups (splits, chunk, CG, G) come from
// the shape and the SM count alone, never from pos or enc_len, so a
// captured CUDA graph stays right when both are rewritten on the device.
//
// Loads ahead of the waits. Weights and caches depend on no phase, so a
// producer warp walks the block's whole schedule of tiles, every phase's
// slices in order, through a ring of STAGES shared-memory stages: each
// tile is one or two copy-engine (TMA) instructions on the stage's "full"
// mbarrier, issued as soon as the consumers release the stage ("empty"),
// so the next phases' slices are in flight while the block waits. Cache
// rows and fc2 rows are contiguous runs (cp.async.bulk); a weight's column
// slice is a box of a 2-D tensor map (cp.async.bulk.tensor), the maps made
// on the host and kept per weight. Only rows below pos + 1 and enc_len are
// read. Issuing from the eight consumer warps instead stalled them ~1 us a
// tile (NVIDIA H100 80GB HBM3, 700 W; the kernel took 0.073 ms that way).
//
// Compute. A projection's input (B rows of d) is staged once a phase,
// k-major and padded with zero rows to BP = 4, 8 or 16, and each thread
// takes 4 adjacent columns of its row group for all BP rows: one vector
// read of weights and BP / 4 of inputs feed 4 BP FMAs, with no branch. The
// attention of an item whose rows are one tile a batch row runs a warp a
// batch row with no block barrier: scores 8 lanes a row, the tile's
// softmax, P.V two columns a lane.
//
// Flag waits in place of grid.sync(). A phase waits for the blocks that
// produce what it reads: done[p] counts the blocks that finished producing
// phase p (each raises it once, red.release.gpu after a fence; phase 2's
// producers are the H combining blocks), and one thread spins on it with
// ld.acquire.gpu. The counters and tickets live in a per-device buffer
// that the wrapper zeroes once; the last block out (an exit counter)
// resets them, so the next launch and a CUDA graph's replays find them at
// zero with no memset. The cooperative launch keeps every block resident,
// so a spin never waits on a block that has not started. Launches on one
// device must not overlap (one stream, as the decode loop runs them).
//
// Workspace reads of what other blocks wrote in this launch go through L2
// (ld.global.cg), never the non-coherent L1.
//
// What the timeline showed (block 0, tiny.en, B 4, pos 32; NVIDIA H100
// 80GB HBM3, 700 W): 0.061 ms in fp32 and 0.062 in bf16, so the bytes
// are not what is left. Each phase is a few dependent global round trips
// (its input rows, its outputs, the fence, the wait): ~0.4 us each in the
// store phase, when no tile is in flight, but 3-5 us in the first three,
// while the blocks' tiles stream (LN2's staging 5.0 us, the cross split's
// attention 5.6, the combine 4.5 of the cross phase's 23 us). Capping the
// tiles in flight a block at 1 or 2, or holding the cross phase's tiles
// back until earlier phases end, did not move it. See PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

#include "async_copy.cuh"

namespace {

using namespace async_copy;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int DH = 64;     // head dim (every Whisper size)
constexpr int LPR = 8;     // lanes that share a cache row, 8 elements each
constexpr int MAX_B = 16;
constexpr int MAX_D = 2048;
constexpr int MAX_H = MAX_D / DH;
constexpr int MAX_SPLITS = 128;
constexpr int STAGES = 5;
constexpr int STAGE_BYTES = 35 * 1024;
constexpr int IN_FLOATS = 4096;                          // staged inputs
constexpr int MAX_KV_ROWS = STAGE_BYTES / (2 * DH * 2);  // bf16 K and V
constexpr int N_PHASES = 6;
constexpr float MASK = -1e9f;
constexpr float NEG_BIG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
// the per-device counters, uint32: done[p] at p, the exit count, a ticket
// per head
constexpr int SYNC_EXIT = N_PHASES;
constexpr int SYNC_TICKET = 8;
constexpr int SYNC_WORDS = SYNC_TICKET + MAX_H;
// a spin that outlasts this (ns) is a broken schedule: trap, do not hang
constexpr unsigned long long SPIN_LIMIT_NS = 2000000000ull;

constexpr int RED_FLOATS = MAX_B * THREADS;              // reductions
constexpr int LN_FLOATS = 2048;  // LN2's and LN3's scale and bias, where 4 d fits
constexpr size_t SMEM_BYTES =
    (size_t)STAGES * STAGE_BYTES +
    4 * (IN_FLOATS + RED_FLOATS + LN_FLOATS + MAX_B * DH + MAX_KV_ROWS + 4 * DH + 2 * MAX_B) +
    16 * STAGES + 16;

// the weights whose column slices a tile takes (2-D tensor copies)
enum MapId { MAP_Q = 0, MAP_O = 1, MAP_CQ = 2, MAP_CO = 3, MAP_F1 = 4, N_MAPS = 5 };

struct Args {
  CUtensorMap maps[N_MAPS];
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
  unsigned long long* timeline;  // null, or N_PHASES + 1 slots
  unsigned* sync;                // SYNC_WORDS, zero between launches
  int b, h, ts, tc, d, ffn;
  int splits, chunk, cg, g;
  float scale;
};

// fp32 workspace, in floats
struct Layout {
  size_t a, xm, cpart, ca, x2, f2, total;
};

__host__ __device__ inline Layout layout(int b, int h, int d, int ffn, int splits, int g) {
  Layout L;
  const size_t bd = (size_t)b * d;
  L.a = 0;
  L.xm = L.a + bd;
  L.cpart = L.xm + bd;
  L.ca = L.cpart + (size_t)b * h * splits * (DH + 2);
  L.x2 = L.ca + bd;
  L.f2 = L.x2 + bd;
  L.total = L.f2 + (size_t)(ffn / g) * bd;
  return L;
}

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}


__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(p) : "memory");
}

__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(p) : "memory");
  return old;
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// ---- the block's schedule --------------------------------------------------

struct Plan {
  int B, H, d, ffn, ts, tc, S, chunk, CG, G, sz, NB, blk;
  int BP;  // B padded to 4, 8 or 16: the projections' batch rows
  int valid_s, limit_s, valid_c, limit_c;
  // tile geometry: rows of a column-slice tile of dh, CG and G columns,
  // K/V rows of a cache tile, fc2 rows of a tile; tiles of each slice
  int r_dh, r_cg, r_g, r_kv, r_w2, n_dh, n_cg, n_g, n_w2, n_self;
};

__host__ __device__ inline int batch_pad(int b) { return b <= 4 ? 4 : (b <= 8 ? 8 : 16); }

// rows of a column slice of C columns a tile holds: its inputs are staged
// beside it (BP x rows floats), and a tensor copy's box has at most 256
__host__ __device__ inline int slice_rows(int C, int sz, int bp) {
  const int r = STAGE_BYTES / (C * sz) < IN_FLOATS / bp ? STAGE_BYTES / (C * sz) : IN_FLOATS / bp;
  return r < 256 ? r : 256;
}

__device__ void plan_geometry(Plan& p) {
  p.BP = batch_pad(p.B);
  p.r_dh = slice_rows(DH, p.sz, p.BP);
  p.r_cg = slice_rows(p.CG, p.sz, p.BP);
  p.r_g = slice_rows(p.G, p.sz, p.BP);
  p.r_kv = STAGE_BYTES / (2 * DH * p.sz);
  p.r_w2 = min(p.G, STAGE_BYTES / (p.d * p.sz));
  p.n_dh = ceil_div(p.d, p.r_dh);
  p.n_cg = ceil_div(p.d, p.r_cg);
  p.n_g = ceil_div(p.d, p.r_g);
  p.n_w2 = ceil_div(p.G, p.r_w2);
  p.n_self = ceil_div(p.limit_s, p.r_kv);
}

// cross rows [s * chunk, + cross_rows) that split s attends
__device__ __forceinline__ int cross_rows(const Plan& p, int s) {
  return max(min(s * p.chunk + p.chunk, p.limit_c) - s * p.chunk, 0);
}

__device__ __forceinline__ int n_items(const Plan& p, int ph) {
  switch (ph) {
    case 0: return p.H;
    case 1: case 3: return p.d / p.CG;
    case 2: return p.H * p.S;
    case 4: return p.ffn / p.G;
    default: return p.B * (p.d / 32);
  }
}

// blocks that signal phase ph's completion (the combining blocks for 2)
__device__ __forceinline__ unsigned producers(const Plan& p, int ph) {
  return ph == 2 ? p.H : min(n_items(p, ph), p.NB);
}

__device__ __forceinline__ int n_tiles(const Plan& p, int ph, int item) {
  switch (ph) {
    case 0:
      return p.n_dh + p.B * p.n_self;
    case 1: case 3:
      return p.n_cg;
    case 2: {
      const int rows = cross_rows(p, item % p.S);
      return rows > 0 ? p.n_dh + p.B * ceil_div(rows, p.r_kv) : 0;
    }
    case 4:
      return p.n_g + p.n_w2;
    default:
      return 0;
  }
}

// what one stage receives: up to two contiguous runs (bulk copies, laid
// out one after the other) or one box of a weight's column slice (a 2-D
// tensor copy: box_rows x C values, rows past the weight zero-filled)
struct Tile {
  const char* bulk[2];
  uint32_t bytes[2];
  const CUtensorMap* map;
  int c0, r0;
  uint32_t box_bytes;
};

template <typename T>
__device__ Tile make_tile(const Args& a, const Plan& p, int ph, int item, int sub) {
  Tile t;
  t.bytes[0] = t.bytes[1] = t.box_bytes = 0;
  t.bulk[0] = t.bulk[1] = nullptr;
  t.map = nullptr;
  t.c0 = t.r0 = 0;
  const int sz = sizeof(T);
  // tile `j` of the column slice [col0, col0 + C) of a weight
  auto cols = [&](int map, int col0, int C, int R, int j) {
    t.map = &a.maps[map];
    t.c0 = col0;
    t.r0 = j * R;
    t.box_bytes = (uint32_t)R * C * sz;
  };
  // tile `j` of the K and V rows [r0, r0 + rows) of (b, h) in a (B, H, T, dh) cache
  auto kv = [&](const void* K, const void* V, int T_len, int b, int h, int r0, int rows, int j) {
    const int R = p.r_kv, t0 = r0 + j * R, n = min(R, r0 + rows - t0);
    const size_t off = ((((size_t)b * p.H + h) * T_len) + t0) * DH * sz;
    t.bulk[0] = static_cast<const char*>(K) + off;
    t.bulk[1] = static_cast<const char*>(V) + off;
    t.bytes[0] = t.bytes[1] = (uint32_t)n * DH * sz;
  };
  switch (ph) {
    case 0:
      if (sub < p.n_dh) {
        cols(MAP_Q, item * DH, DH, p.r_dh, sub);
      } else {
        const int j = sub - p.n_dh;
        kv(a.sk, a.sv, p.ts, j / p.n_self, item, 0, p.limit_s, j % p.n_self);
      }
      break;
    case 1:
      cols(MAP_O, item * p.CG, p.CG, p.r_cg, sub);
      break;
    case 2: {
      const int h = item / p.S, s = item % p.S;
      if (sub < p.n_dh) {
        cols(MAP_CQ, h * DH, DH, p.r_dh, sub);
      } else {
        const int rows = cross_rows(p, s), j = sub - p.n_dh, per = ceil_div(rows, p.r_kv);
        kv(a.ck, a.cv, p.tc, j / per, h, s * p.chunk, rows, j % per);
      }
      break;
    }
    case 3:
      cols(MAP_CO, item * p.CG, p.CG, p.r_cg, sub);
      break;
    case 4:
      if (sub < p.n_g) {
        cols(MAP_F1, item * p.G, p.G, p.r_g, sub);
      } else {
        const int R = p.r_w2, j = sub - p.n_g, r0 = item * p.G + j * R;
        t.bulk[0] = static_cast<const char*>(a.w[7]) + (size_t)r0 * p.d * sz;
        t.bytes[0] = (uint32_t)min(R, p.G - j * R) * p.d * sz;
      }
      break;
    default:
      break;
  }
  return t;
}

// Thread 0: the tile into stage `dst`, completing on `bar` (one arrival,
// and the bytes the copy engine brings).
__device__ __forceinline__ void issue(const Tile& t, char* dst, uint64_t* bar) {
  fence_proxy_async();  // the stage's last reads before the copy engine writes
  mbar_expect(bar, t.bytes[0] + t.bytes[1] + t.box_bytes);
  if (t.bytes[0]) bulk_copy(dst, t.bulk[0], t.bytes[0], bar);
  if (t.bytes[1]) bulk_copy(dst + t.bytes[0], t.bulk[1], t.bytes[1], bar);
  if (t.map != nullptr) bulk_copy_2d(dst, t.map, t.c0, t.r0, bar);
}

// The ring of STAGES stages. A producer warp walks the block's schedule of
// tiles and issues each into the next stage once its last reader has
// released it (empty[s]); the consumer warps take the tiles in the same
// order as they land (full[s]). Neither waits for the other's bookkeeping.
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
}

template <typename T>
__device__ void produce(const Args& a, const Plan& p, char* base, uint64_t* full,
                        uint64_t* empty) {
  int i = 0;
  for (int ph = 0; ph < N_PHASES; ++ph)
    for (int item = p.blk; item < n_items(p, ph); item += p.NB)
      for (int sub = 0, n = n_tiles(p, ph, item); sub < n; ++sub, ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + s, ((i / STAGES) - 1) & 1);
        issue(make_tile<T>(a, p, ph, item, sub), base + (size_t)s * STAGE_BYTES, full + s);
      }
}

template <typename T>
struct Ring {
  char* base;
  uint64_t* full;
  uint64_t* empty;
  int head;  // tiles consumed

  // the tile i places past the next one to consume, once it has landed
  __device__ const T* acquire_ahead(int i) {
    const int t = head + i, s = t % STAGES;
    mbar_wait(full + s, (t / STAGES) & 1);
    return reinterpret_cast<const T*>(base + (size_t)s * STAGE_BYTES);
  }

  __device__ const T* acquire() { return acquire_ahead(0); }

  // after the last read of the n tiles acquired last: their stages are free
  __device__ void release_n(int n) {
    csync();
    if (threadIdx.x == 0)
      for (int k = 0; k < n; ++k) mbar_arrive(empty + (head + k) % STAGES);
    head += n;
  }

  __device__ void release() { release_n(1); }
};

// ---- waits -----------------------------------------------------------------

__device__ void wait_done(unsigned* sync, int ph, unsigned target) {
  if (threadIdx.x == 0) {
    const unsigned long long t0 = global_ns();
    unsigned spins = 0;
    while (ld_acquire(sync + ph) < target) {
      if ((++spins & 1023u) == 0 && global_ns() - t0 > SPIN_LIMIT_NS) __trap();
    }
  }
  csync();
}

// this block's part of phase ph is written
__device__ void arrive_done(unsigned* sync, int ph) {
  __threadfence();
  csync();
  if (threadIdx.x == 0) red_release(sync + ph);
}

__device__ __forceinline__ void stamp(const Args& a, int i) {
  if (a.timeline != nullptr && blockIdx.x == 0 && threadIdx.x == 0) a.timeline[i] = global_ns();
}


// ---- projections -----------------------------------------------------------

// dst(i) = f(i) for i < n, eight values a thread in flight at once (the
// loads are issued before any store)
template <typename F, typename D>
__device__ __forceinline__ void fill(int n, F f, D dst) {
  for (int i0 = 0; i0 < n; i0 += 8 * THREADS) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * THREADS + threadIdx.x;
      v[u] = i < n ? f(i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * THREADS + threadIdx.x;
      if (i < n) *dst(i) = v[u];
    }
  }
}

// A phase's projection input, B rows of d values in the weight dtype
// (kept as fp32), is the same for every item of the block: where BP * d
// fits (`whole`), it is staged once into in_s, k-major (in_s[k * BP + b],
// so one vector read gives a row's BP values; rows past B zero);
// otherwise each tile stages its rows the same way.
template <typename F>
__device__ void stage_whole(const Plan& p, float* in_s, F f) {
  fill(p.BP * p.d, [&](int i) { return i % p.BP < p.B ? f(i % p.BP, i / p.BP) : 0.f; },
       [&](int i) { return in_s + i; });
  csync();
}

// The same for LayerNorm(x) of the fp32 rows x (B, d) in the workspace:
// the rows and the scale and bias (into red) in one round of loads, the
// statistics (two passes, a warp a row) from shared memory, then the
// normalised rows in place, cast to the weight dtype.
template <typename T>
__device__ void stage_ln(const Plan& p, float* in_s, float* red, const float* x,
                         const void* scale, const void* bias, const float* loaded,
                         float* mean, float* rstd) {
  const int np = p.BP * p.d, BP = p.BP;
  const int n_par = loaded != nullptr ? 0 : 2 * p.d;  // scale and bias, unless loaded
  fill(np + n_par,
       [&](int i) {
         return i < np ? (i % BP < p.B ? __ldcg(x + (size_t)(i % BP) * p.d + i / BP) : 0.f)
                       : (i < np + p.d ? param<T>(scale, i - np) : param<T>(bias, i - np - p.d));
       },
       [&](int i) { return i < np ? in_s + i : red + (i - np); });
  if (loaded != nullptr) red = const_cast<float*>(loaded);
  csync();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int b = warp; b < p.B; b += WARPS) {
    float sum = 0.f;
    for (int k = lane; k < p.d; k += 32) sum += in_s[k * BP + b];
    const float mu = warp_sum(sum) / p.d;
    float q = 0.f;
    for (int k = lane; k < p.d; k += 32) {
      const float v = in_s[k * BP + b] - mu;
      q += v * v;
    }
    const float r = rsqrtf(warp_sum(q) / p.d + 1e-5f);
    if (lane == 0) {
      mean[b] = mu;
      rstd[b] = r;
    }
  }
  csync();
  for (int i = threadIdx.x; i < np; i += THREADS) {
    const int b = i % BP, k = i / BP;
    if (b < p.B) in_s[i] = round_to<T>((in_s[i] - mean[b]) * rstd[b] * red[k] + red[p.d + k]);
  }
  csync();
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// out[b * C + c] = sum_k in(b, k) W[k, c] for b < B over the d rows of a
// column slice of C columns, tile by tile from the ring. A thread takes 4
// adjacent columns of the rows r = group (mod its row groups), for NB
// batch rows at once (B padded with zero rows to NB): per row one vector
// read of the weights and NB / 4 of the k-major inputs feed 4 * NB FMAs,
// with no branch. The lanes of a warp and then the warps are summed in a
// fixed order (through red, 8 x 4 x C floats a round of 4 batch rows).
// With `whole` the input is in in_s already; otherwise in(b, k) is staged
// for each tile while its copy lands.
template <typename T, int NB, typename InF>
__device__ void project_nb(Ring<T>& ring, const Plan& p, int C, int R, float* in_s, bool whole,
                           InF in_of, float* red, float* out) {
  const int LR = C / 4;  // lanes a row
  const int c4 = (threadIdx.x % LR) * 4, rg = threadIdx.x / LR, RG = THREADS / LR;
  const int B = p.B, K = p.d;
  float acc[NB][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[b][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += R) {
    const int rows = min(R, K - k0);
    const float* in = in_s + (size_t)k0 * NB;
    if (!whole) {
      fill(NB * rows,
           [&](int i) { return i % NB < B ? in_of(i % NB, k0 + i / NB) : 0.f; },
           [&](int i) { return in_s + i; });
      in = in_s;
    }
    const T* w = ring.acquire();
    csync();  // the staged inputs
#pragma unroll 2
    for (int r = rg; r < rows; r += RG) {
      float wv[4], iv[NB];
      load4(w + r * C + c4, wv);
#pragma unroll
      for (int b = 0; b < NB; b += 4) {
        float v4[4];
        load4(in + r * NB + b, v4);
#pragma unroll
        for (int j = 0; j < 4; ++j) iv[b + j] = v4[j];
      }
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[b][j] = fmaf(iv[b], wv[j], acc[b][j]);
    }
    ring.release();
  }
  for (int off = LR; off < 32; off <<= 1)
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[b][j] += __shfl_xor_sync(FULL, acc[b][j], off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int b0 = 0; b0 < NB; b0 += 4) {
    if (lane < LR)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
#pragma unroll
        for (int j = 0; j < 4; ++j) red[(warp * 4 + bb) * C + c4 + j] = acc[b0 + bb][j];
    csync();
    for (int i = threadIdx.x; i < 4 * C; i += THREADS) {
      const int bb = i / C, cc = i % C;
      if (b0 + bb < B) {
        float v = 0.f;
        for (int w8 = 0; w8 < WARPS; ++w8) v += red[(w8 * 4 + bb) * C + cc];
        out[(b0 + bb) * C + cc] = v;
      }
    }
    csync();  // red is free; after the last round, out is whole
  }
}

template <typename T, typename InF>
__device__ void project(Ring<T>& ring, const Plan& p, int C, float* in_s, bool whole, InF in_of,
                        float* red, float* out) {
  const int R = C == DH ? p.r_dh : (C == p.CG ? p.r_cg : p.r_g);
  if (p.BP == 4) project_nb<T, 4>(ring, p, C, R, in_s, whole, in_of, red, out);
  else if (p.BP == 8) project_nb<T, 8>(ring, p, C, R, in_s, whole, in_of, red, out);
  else project_nb<T, 16>(ring, p, C, R, in_s, whole, in_of, red, out);
}

// LayerNorm statistics of the B fp32 rows of `x` (B, d) in the workspace,
// into mean[b], rstd[b]; one warp a row, two passes
__device__ void ln_stats(const Plan& p, const float* x, float* mean, float* rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int b = warp; b < p.B; b += WARPS) {
    const float* row = x + (size_t)b * p.d;
    float s = 0.f;
    for (int k = lane; k < p.d; k += 32) s += __ldcg(row + k);
    const float mu = warp_sum(s) / p.d;
    float q = 0.f;
    for (int k = lane; k < p.d; k += 32) {
      const float v = __ldcg(row + k) - mu;
      q += v * v;
    }
    const float r = rsqrtf(warp_sum(q) / p.d + 1e-5f);
    if (lane == 0) {
      mean[b] = mu;
      rstd[b] = r;
    }
  }
  csync();
}

// ---- attention -------------------------------------------------------------

// Online softmax of one query row (q_s, dh fp32, scaled) against a tile of
// `rows` K and V rows (rows t0.. of the cache) in shared memory; rows at
// or past `valid` score MASK. Every thread keeps the same m and l; thread
// (e = tid % dh, group = tid / dh) keeps acc over the rows of its group.
// sc holds the tile's scores.
template <typename T>
__device__ void attend_tile(const float* q_s, const T* K, const T* V, int rows, int t0,
                            int valid, float* sc, float& m, float& l, float& acc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e0 = (lane % LPR) * 8;
  float q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) q[j] = q_s[e0 + j];
  for (int r0 = warp * (32 / LPR); r0 < rows; r0 += THREADS / LPR) {
    const int r = r0 + lane / LPR;
    float kv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < rows) load8(K + (size_t)r * DH + e0, kv);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s = fmaf(q[j], kv[j], s);
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (lane % LPR == 0 && r < rows) sc[r] = t0 + r < valid ? s : MASK;
  }
  csync();
  float mx = -INFINITY;
  for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, sc[r]);
  const float m_new = fmaxf(m, warp_max(mx));
  const float corr = expf(m - m_new);
  float ls = 0.f;
  for (int r = lane; r < rows; r += 32) ls += expf(sc[r] - m_new);
  l = l * corr + warp_sum(ls);
  const int e = threadIdx.x % DH;
  acc *= corr;
  for (int r = threadIdx.x / DH; r < rows; r += THREADS / DH)
    acc = fmaf(expf(sc[r] - m_new), to_f(V[(size_t)r * DH + e]), acc);
  m = m_new;
}

// one (b, head): the tiles of rows [r0, r0 + rows) from the ring; returns
// acc summed over the thread groups to threads tid < dh (red: 4 x dh)
template <typename T>
__device__ float attend_rows(Ring<T>& ring, const Plan& p, const float* q_s, int r0, int rows,
                             int valid, float* sc, float* red, float& m, float& l) {
  const int R = p.r_kv;
  float acc = 0.f;
  m = NEG_BIG;
  l = 0.f;
  for (int t0 = r0; t0 < r0 + rows; t0 += R) {
    const int n = min(R, r0 + rows - t0);
    const T* K = ring.acquire();
    attend_tile<T>(q_s, K, K + (size_t)n * DH, n, t0, valid, sc, m, l, acc);
    ring.release();
  }
  red[threadIdx.x] = acc;
  csync();
  float v = 0.f;
  if (threadIdx.x < DH)
    for (int g = 0; g < THREADS / DH; ++g) v += red[g * DH + threadIdx.x];
  csync();
  return v;
}

// The attention of one item: B query rows (q_s, B x dh fp32, scaled)
// against rows [r0, r0 + rows) of each b's K and V (the ring's next tiles,
// b by b); rows at or past `valid` score MASK. res[b * (dh + 2) + ...]
// receives (max, sum, acc[dh]). Where each b's rows are one tile and the
// B tiles fit the ring at once, warp w takes b = w, w + WARPS, ...: its
// scores (8 lanes a row) into sc, the tile's softmax from them, and P.V
// (two columns a lane), with no block barrier; otherwise the block takes
// the b's one after another, tile by tile, with an online softmax.
template <typename T>
__device__ void attend_item(Ring<T>& ring, const Plan& p, const float* q_s, int r0, int rows,
                            int valid, float* sc, float* red, float* res) {
  const int B = p.B;
  if (B <= STAGES && rows <= p.r_kv) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int slot = lane / LPR, e0 = (lane % LPR) * 8;
    for (int b = warp; b < B; b += WARPS) {
      const T* K = ring.acquire_ahead(b);
      const T* V = K + (size_t)rows * DH;
      float* s = sc + b * p.r_kv;
      float q[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) q[j] = q_s[b * DH + e0 + j];
      for (int rr = 0; rr < rows; rr += 32 / LPR) {
        const int r = rr + slot;
        float kv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (r < rows) load8(K + (size_t)r * DH + e0, kv);
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) dot = fmaf(q[j], kv[j], dot);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(FULL, dot, off);
        if (lane % LPR == 0 && r < rows) s[r] = r0 + r < valid ? dot : MASK;
      }
      __syncwarp();
      float mx = -INFINITY;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, s[r]);
      mx = warp_max(mx);
      float l = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float e = expf(s[r] - mx);
        s[r] = e;
        l += e;
      }
      l = warp_sum(l);
      __syncwarp();
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const float pr = s[r];
        a0 = fmaf(pr, to_f(V[(size_t)r * DH + lane]), a0);
        a1 = fmaf(pr, to_f(V[(size_t)r * DH + lane + 32]), a1);
      }
      float* o = res + b * (DH + 2);
      if (lane == 0) {
        o[0] = mx;
        o[1] = l;
      }
      o[2 + lane] = a0;
      o[2 + lane + 32] = a1;
    }
    ring.release_n(B);  // and res is whole
    return;
  }
  for (int b = 0; b < B; ++b) {
    float m, l;
    const float v = attend_rows<T>(ring, p, q_s + b * DH, r0, rows, valid, sc, red, m, l);
    float* o = res + b * (DH + 2);
    if (threadIdx.x == 0) {
      o[0] = m;
      o[1] = l;
    }
    if (threadIdx.x < DH) o[2 + threadIdx.x] = v;
  }
  csync();
}

// ---- the kernel ------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS + 32, 1) fused_step_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* in_s = reinterpret_cast<float*>(smem + (size_t)STAGES * STAGE_BYTES);
  float* big_s = in_s + IN_FLOATS;  // reductions; LN parameters; scores and
                                    // attention results; combine weights
  float* ln_s = big_s + RED_FLOATS;  // LN2 scale, bias, LN3 scale, bias
  float* q_s = ln_s + LN_FLOATS;     // B x dh queries; B x G GELU outputs
  float* sc_s = q_s + MAX_B * DH;
  float* red_s = sc_s + MAX_KV_ROWS;
  float* mean_s = red_s + 4 * DH;
  float* rstd_s = mean_s + MAX_B;
  uint64_t* bar = reinterpret_cast<uint64_t*>(rstd_s + MAX_B);
  int* flag_s = reinterpret_cast<int*>(bar + 2 * STAGES);
  float* res_s = big_s + MAX_B * MAX_KV_ROWS;  // B x (dh + 2) attention results

  stamp(a, 0);
  Plan p;
  p.B = a.b; p.H = a.h; p.d = a.d; p.ffn = a.ffn; p.ts = a.ts; p.tc = a.tc;
  p.S = a.splits; p.chunk = a.chunk; p.CG = a.cg; p.G = a.g;
  p.sz = sizeof(T); p.NB = gridDim.x; p.blk = blockIdx.x;
  p.valid_s = min(max(*a.pos + 1, 0), a.ts);
  p.limit_s = p.valid_s > 0 ? p.valid_s : a.ts;  // none valid: all at MASK
  p.valid_c = min(max(*a.enc_len, 0), a.tc);
  p.limit_c = p.valid_c > 0 ? p.valid_c : a.tc;
  plan_geometry(p);

  Ring<T> ring;
  ring.base = reinterpret_cast<char*>(smem);
  ring.full = bar;
  ring.empty = bar + STAGES;
  ring.head = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * STAGES; ++s) mbar_init(bar + s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= THREADS) {  // the producer warp
    if (threadIdx.x == THREADS) produce<T>(a, p, ring.base, ring.full, ring.empty);
    return;
  }

  const Layout L = layout(p.B, p.H, p.d, p.ffn, p.S, p.G);
  float* ws = a.ws;
  const int B = p.B, d = p.d, tid = threadIdx.x;
  const T* x = static_cast<const T*>(a.x);
  const T* h1 = static_cast<const T*>(a.h1);
  const bool whole = p.BP * d <= IN_FLOATS;
  auto h1_of = [&](int b, int k) { return to_f(h1[(size_t)b * d + k]); };

  // the first phase's input (a head block's) and LN2's and LN3's
  // parameters, in one round of loads
  const bool ln_loaded = 4 * d <= LN_FLOATS;
  {
    const int n_in = whole && p.blk < n_items(p, 0) ? p.BP * d : 0;
    const int n_ln = ln_loaded ? 4 * d : 0;
    const void* ln[4] = {a.w[2], a.bias[2], a.w[5], a.bias[5]};
    fill(n_in + n_ln,
         [&](int i) {
           if (i < n_in) return i % p.BP < B ? h1_of(i % p.BP, i / p.BP) : 0.f;
           i -= n_in;
           return param<T>(ln[i / d], i % d);
         },
         [&](int i) { return i < n_in ? in_s + i : ln_s + (i - n_in); });
    csync();
  }

  // 0. q + self attention, a block a head
  for (int hh = p.blk; hh < p.H; hh += p.NB) {
    // epilogue operands are loaded before the projection, to land meanwhile
    // (thread i's columns are i % C for every i it takes)
    const float bq = param<T>(a.bias[0], hh * DH + tid % DH);
    project<T>(ring, p, DH, in_s, whole, h1_of, big_s, q_s);
    for (int i = tid; i < B * DH; i += THREADS) q_s[i] = (q_s[i] + bq) * a.scale;
    csync();
    attend_item<T>(ring, p, q_s, 0, p.limit_s, p.valid_s, big_s, red_s, res_s);
    for (int i = tid; i < B * DH; i += THREADS) {
      const float* o = res_s + (i / DH) * (DH + 2);
      ws[L.a + (size_t)(i / DH) * d + hh * DH + i % DH] = o[2 + i % DH] / o[1];
    }
    csync();  // res_s before the next item
  }
  if (p.blk < n_items(p, 0)) arrive_done(a.sync, 0);

  // 1. out projection: x_mid = x + bias + a Wo
  wait_done(a.sync, 0, producers(p, 0));
  stamp(a, 1);
  if (p.blk < n_items(p, 1)) {
    auto a_of = [&](int b, int k) { return round_to<T>(__ldcg(ws + L.a + (size_t)b * d + k)); };
    if (whole) stage_whole(p, in_s, a_of);
    for (int it = p.blk; it < n_items(p, 1); it += p.NB) {
      const int n0 = it * p.CG;
      const float bo = param<T>(a.bias[1], n0 + tid % p.CG);
      const float x0 = tid < B * p.CG ? to_f(x[(size_t)(tid / p.CG) * d + n0 + tid % p.CG]) : 0.f;
      project<T>(ring, p, p.CG, in_s, whole, a_of, big_s, q_s);
      for (int i = tid; i < B * p.CG; i += THREADS) {
        const int b = i / p.CG, n = n0 + i % p.CG;
        ws[L.xm + (size_t)b * d + n] = (i == tid ? x0 : to_f(x[(size_t)b * d + n])) + bo + q_s[i];
      }
      csync();  // q_s before the next item
    }
    arrive_done(a.sync, 1);
  }

  // 2. LN2, cross q, cross attention split over the rows, combine
  wait_done(a.sync, 1, producers(p, 1));
  stamp(a, 2);
  if (p.blk < n_items(p, 2)) {
    if (whole)
      stage_ln<T>(p, in_s, big_s, ws + L.xm, a.w[2], a.bias[2], ln_loaded ? ln_s : nullptr,
                  mean_s, rstd_s);
    else
      ln_stats(p, ws + L.xm, mean_s, rstd_s);
    auto h2_of = [&](int b, int k) {
      const float v = (__ldcg(ws + L.xm + (size_t)b * d + k) - mean_s[b]) * rstd_s[b];
      return round_to<T>(v * param<T>(a.w[2], k) + param<T>(a.bias[2], k));
    };
    const size_t bstride = (size_t)p.H * p.S * (DH + 2);
    for (int it = p.blk; it < n_items(p, 2); it += p.NB) {
      const int hh = it / p.S, s = it % p.S, rows = cross_rows(p, s);
      // (b, hh, s)'s partial at part + b * bstride
      float* part = ws + L.cpart + ((size_t)hh * p.S + s) * (DH + 2);
      if (rows > 0) {
        const float bq = param<T>(a.bias[3], hh * DH + tid % DH);
        project<T>(ring, p, DH, in_s, whole, h2_of, big_s, q_s);
        for (int i = tid; i < B * DH; i += THREADS) q_s[i] = (q_s[i] + bq) * a.scale;
        csync();
        attend_item<T>(ring, p, q_s, s * p.chunk, rows, p.valid_c, big_s, red_s, res_s);
        for (int i = tid; i < B * (DH + 2); i += THREADS)
          part[(i / (DH + 2)) * bstride + i % (DH + 2)] = res_s[i];
      } else {
        // a split past enc_len: an empty partial, which weighs 0
        for (int i = tid; i < B * (DH + 2); i += THREADS) {
          const int b = i / (DH + 2), j = i % (DH + 2);
          part[b * bstride + j] = j == 0 ? NEG_BIG : 0.f;
        }
      }
      // the last split of the head to finish combines them all
      __threadfence();
      csync();
      if (tid == 0) {
        const bool last = atom_add_acq_rel(a.sync + SYNC_TICKET + hh) == (unsigned)p.S - 1;
        if (last) a.sync[SYNC_TICKET + hh] = 0;
        flag_s[0] = last;
      }
      csync();
      if (flag_s[0]) {
        const float* src = ws + L.cpart + (size_t)hh * p.S * (DH + 2);
        float* mw = big_s;            // B x S maxima, then weights
        float* lw = big_s + B * p.S;  // B x S sums
        for (int i = tid; i < B * p.S; i += THREADS) {
          const int b = i / p.S, j = i % p.S;
          const float* pp = src + b * bstride + (size_t)j * (DH + 2);
          mw[i] = __ldcg(pp);
          lw[i] = __ldcg(pp + 1);
        }
        csync();
        if (tid < B) {
          float mx = NEG_BIG;
          for (int j = 0; j < p.S; ++j) mx = fmaxf(mx, mw[tid * p.S + j]);
          red_s[tid] = mx;
        }
        csync();
        for (int i = tid; i < B * p.S; i += THREADS) mw[i] = expf(mw[i] - red_s[i / p.S]);
        csync();
        if (tid < B) {
          float sum = 0.f;
          for (int j = 0; j < p.S; ++j) sum += lw[tid * p.S + j] * mw[tid * p.S + j];
          red_s[MAX_B + tid] = sum;
        }
        csync();
        for (int i = tid; i < B * DH; i += THREADS) {
          const int b = i / DH, e = i % DH;
          const float* pp = src + b * bstride + 2 + e;
          float o = 0.f;
#pragma unroll 16
          for (int j = 0; j < p.S; ++j) o = fmaf(mw[b * p.S + j], __ldcg(pp + (size_t)j * (DH + 2)), o);
          ws[L.ca + (size_t)b * d + hh * DH + e] = o / red_s[MAX_B + b];
        }
        arrive_done(a.sync, 2);
      }
      csync();  // big_s, red_s and flag_s before the next item
    }
  }

  // 3. cross out projection: x2 = x_mid + bias + ca Wco
  wait_done(a.sync, 2, producers(p, 2));
  stamp(a, 3);
  if (p.blk < n_items(p, 3)) {
    auto ca_of = [&](int b, int k) { return round_to<T>(__ldcg(ws + L.ca + (size_t)b * d + k)); };
    if (whole) stage_whole(p, in_s, ca_of);
    for (int it = p.blk; it < n_items(p, 3); it += p.NB) {
      const int n0 = it * p.CG;
      const float bco = param<T>(a.bias[4], n0 + tid % p.CG);
      const float xm0 =
          tid < B * p.CG ? __ldcg(ws + L.xm + (size_t)(tid / p.CG) * d + n0 + tid % p.CG) : 0.f;
      project<T>(ring, p, p.CG, in_s, whole, ca_of, big_s, q_s);
      for (int i = tid; i < B * p.CG; i += THREADS) {
        const int b = i / p.CG, n = n0 + i % p.CG;
        ws[L.x2 + (size_t)b * d + n] =
            (i == tid ? xm0 : __ldcg(ws + L.xm + (size_t)b * d + n)) + bco + q_s[i];
      }
      csync();  // q_s before the next item
    }
    arrive_done(a.sync, 3);
  }

  // 4. LN3, fc1 of a group of G columns, GELU, times fc2's G rows
  wait_done(a.sync, 3, producers(p, 3));
  stamp(a, 4);
  if (p.blk < n_items(p, 4)) {
    if (whole)
      stage_ln<T>(p, in_s, big_s, ws + L.x2, a.w[5], a.bias[5],
                  ln_loaded ? ln_s + 2 * d : nullptr, mean_s, rstd_s);
    else
      ln_stats(p, ws + L.x2, mean_s, rstd_s);
    auto h3_of = [&](int b, int k) {
      const float v = (__ldcg(ws + L.x2 + (size_t)b * d + k) - mean_s[b]) * rstd_s[b];
      return round_to<T>(v * param<T>(a.w[5], k) + param<T>(a.bias[5], k));
    };
    const int G = p.G;
    for (int it = p.blk; it < n_items(p, 4); it += p.NB) {
      const float b1 = param<T>(a.bias[6], it * G + tid % G);
      project<T>(ring, p, G, in_s, whole, h3_of, big_s, q_s);
      for (int i = tid; i < B * G; i += THREADS) {
        const float f = q_s[i] + b1;
        q_s[i] = round_to<T>(0.5f * f * (1.f + erff(f * 0.70710678118654752f)));
      }
      csync();
      float* f2 = ws + L.f2 + (size_t)it * B * d;
      for (int j0 = 0; j0 < G; j0 += p.r_w2) {
        const int n_rows = min(p.r_w2, G - j0);
        const T* w2 = ring.acquire();
        for (int n = tid; n < d; n += THREADS) {
          for (int b = 0; b < B; ++b) {
            float s = j0 == 0 ? 0.f : __ldcg(f2 + (size_t)b * d + n);
#pragma unroll 4
            for (int r = 0; r < n_rows; ++r)
              s = fmaf(q_s[b * G + j0 + r], to_f(w2[(size_t)r * d + n]), s);
            __stcg(f2 + (size_t)b * d + n, s);
          }
        }
        ring.release();
      }
    }
    arrive_done(a.sync, 4);
  }

  // 5. y = x2 + bias + the fc2 partials, in x's dtype; a block per
  // (b, 32 columns), the warps splitting the partials
  wait_done(a.sync, 4, producers(p, 4));
  stamp(a, 5);
  if (p.blk < n_items(p, 5)) {
    const int warp = tid / 32, lane = tid % 32, NG = p.ffn / p.G;
    T* out = static_cast<T*>(a.out);
    for (int it = p.blk; it < n_items(p, 5); it += p.NB) {
      const int b = it / (d / 32), n = (it % (d / 32)) * 32 + lane;
      const float base = warp == 0 ? __ldcg(ws + L.x2 + (size_t)b * d + n) + param<T>(a.bias[7], n)
                                   : 0.f;
      float s = 0.f;
#pragma unroll 4
      for (int g = warp; g < NG; g += WARPS) s += __ldcg(ws + L.f2 + ((size_t)g * B + b) * d + n);
      red_s[warp * 32 + lane] = s;
      csync();
      if (warp == 0) {
        float tot = 0.f;
        for (int w = 0; w < WARPS; ++w) tot += red_s[w * 32 + lane];
        out[(size_t)b * d + n] = from_f<T>(base + tot);
      }
      csync();
    }
  }
  stamp(a, N_PHASES);

  // the last block out leaves the counters at zero for the next launch
  csync();
  if (tid == 0 && atom_add_acq_rel(a.sync + SYNC_EXIT) == (unsigned)p.NB - 1) {
    volatile unsigned* s = a.sync;
    for (int i = 0; i <= SYNC_EXIT; ++i) s[i] = 0;
  }
}

template <typename T>
cudaError_t launch(Args& a, cudaStream_t st) {
  void (*kern)(const Args) = fused_step_kernel<T>;
  // per device: the shared-memory attribute set, every block of a
  // cooperative launch resident (one a SM), the SM count
  static int sms_of[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    int coop = 0, occ = 0, sms = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, THREADS + 32, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms_of[dev] = sms;
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(sms_of[dev]),
                                    dim3(THREADS + 32), args, SMEM_BYTES, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool power_of_two_in(int v, int lo, int hi) { return v >= lo && v <= hi && (v & (v - 1)) == 0; }

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a (rows, cols) weight in boxes of box_r rows x box_c
// columns. A map encodes only the address, the shape and the box, so maps
// are kept by all of them: the next step's launch of the same layer finds
// its maps made.
bool weight_map(CUtensorMap* out, const void* w, int rows, int cols, int box_c, int box_r,
                int dtype) {
  struct Entry {
    const void* w;
    int rows, cols, box_c, box_r, dtype;
    CUtensorMap map;
  };
  constexpr int CACHED = 256;
  static Entry cache[CACHED];
  static int n = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n; ++i) {
    const Entry& e = cache[i];
    if (e.w == w && e.rows == rows && e.cols == cols && e.box_c == box_c &&
        e.box_r == box_r && e.dtype == dtype) {
      *out = e.map;
      return true;
    }
  }
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const int sz = dtype == 0 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sz};
  const cuuint32_t box[2] = {(cuuint32_t)box_c, (cuuint32_t)box_r};
  const cuuint32_t steps[2] = {1, 1};
  if (enc(out, dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
          2, const_cast<void*>(w), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  Entry& e = cache[n < CACHED ? n++ : next++ % CACHED];
  e = Entry{w, rows, cols, box_c, box_r, dtype, *out};
  return true;
}

}  // namespace

extern "C" {

// x, h1, out (B, d); pos, enc_len int32 on the device; for each of q, out,
// LN2, cross q, cross out, LN3, fc1, fc2 the weight ((in, out), or the LN
// scale (d,)) then its bias (or null); self cache (B, H, Ts, dh) x2, cross
// cache (B, H, Tc, dh) x2; every float tensor in `dtype` (0 float32,
// 1 bfloat16), contiguous, 16-byte aligned; `ws` fp32 of at least
// `ws_floats`, which must cover the workspace layout() lays out;
// `timeline` null, or 7 device uint64 slots that receive the global timer
// (ns) at the start of the kernel, after each of the 5 waits and at the
// end, as block 0 sees them; `sync` the device's 40 uint32 counters, zero
// before the first launch (each launch leaves them at zero). The plan:
// `splits` blocks a head for the cross rows, `chunk` rows each
// (splits * chunk >= Tc, splits <= 128), column groups of `cg` (out
// projections) and `g` (fc1 columns, fc2 rows), powers of two in [8, 64]
// dividing d and ffn. 1 <= B <= 16, dh = 64, d = H * dh, d and ffn
// multiples of 64, d <= 2048. Returns a cudaError_t.
int fused_decoder_step(
    const void* x, const void* h1, const void* pos, const void* enc_len,
    const void* wq, const void* bq, const void* wo, const void* bo,
    const void* ln2s, const void* ln2b, const void* wcq, const void* bcq,
    const void* wco, const void* bco, const void* ln3s, const void* ln3b,
    const void* wf1, const void* bf1, const void* wf2, const void* bf2,
    const void* sk, const void* sv, const void* ck, const void* cv, void* out,
    void* ws, void* timeline, void* sync, int b, int h, int ts, int dh, int tc, int d,
    int ffn, int dtype, int splits, int chunk, int cg, int g, int ws_floats, void* stream) {
  if (b < 1 || b > MAX_B || h < 1 || ts < 1 || tc < 1 || d != h * dh || d % 64 ||
      ffn % 64 || ffn < 64 || d > MAX_D || dh != DH || dtype < 0 || dtype > 1 ||
      sync == nullptr || splits < 1 || splits > MAX_SPLITS || chunk < 1 ||
      (long long)splits * chunk < tc || !power_of_two_in(cg, 8, 64) ||
      !power_of_two_in(g, 8, 64) || d % cg || ffn % g || ws_floats < 0 ||
      (size_t)ws_floats < layout(b, h, d, ffn, splits, g).total)
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
  a.sync = static_cast<unsigned*>(sync);
  a.b = b; a.h = h; a.ts = ts; a.tc = tc; a.d = d; a.ffn = ffn;
  a.splits = splits; a.chunk = chunk; a.cg = cg; a.g = g;
  a.scale = static_cast<float>(pow(static_cast<double>(dh), -0.5));
  // the column slices' tensor maps: boxes of slice_rows() rows
  const int sz = dtype == 0 ? 4 : 2;
  const struct {
    int id;
    const void* w;
    int cols, box_c;
  } slices[N_MAPS] = {{MAP_Q, wq, d, DH}, {MAP_O, wo, d, cg}, {MAP_CQ, wcq, d, DH},
                      {MAP_CO, wco, d, cg}, {MAP_F1, wf1, ffn, g}};
  for (const auto& sl : slices)
    if (!weight_map(&a.maps[sl.id], sl.w, d, sl.cols, sl.box_c, slice_rows(sl.box_c, sz, batch_pad(b)),
                    dtype))
      return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(a, st) : launch<__nv_bfloat16>(a, st);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
