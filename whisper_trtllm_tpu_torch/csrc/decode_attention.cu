// K2: single-token masked attention against a static KV cache, for Hopper
// (sm_90a), one launch a call on the split-T engine of decode_split.cuh.
//
// Replaces whisper_trtllm_tpu/ops/pallas/decode_attention.py::decode_mha
// (_kernel), and the branches that whisper_trtllm_tpu/ops/attention.py::
// mha_decode_step computes around it: q (B, H, 1, dh) pre-scaled in fp32 or
// bf16; the cache in q's dtype, or int8 / fp8 e4m3 with one fp32 scale per
// (batch, head, row) for K and for V, folded into the scores and the
// weights; the cache dh-minor (B, H, T, dh) or T-minor (B, H, dh, T); and
// the number of valid cache rows `valid_len` read from device memory inside
// the kernel (one int32, or one per batch lane with stride 1), so the host
// never waits for it and a captured CUDA graph can replay the launch with
// new values. It serves the decode step's self attention (T = max_len,
// valid_len = pos + 1) and cross attention (T = 1504, valid_len = 1500).
// An optional fp32 additive bias (B, H, 1, T), broadcast dimensions at
// stride 0 and T contiguous, is added to each score after the K scale and
// before the mask and the softmax, where the JAX package adds ALiBi's bias
// (whisper_trtllm_tpu/ops/attention.py::mha_decode_step), taken relative
// to its value at the head's last valid row (decode_split.cuh); the Bloom
// step's. The dh-minor kernels with a bias are instantiations of their
// own (BIAS), built apart as decode_attention_bias.cu, which includes this
// file with DECODE_ATTENTION_BIAS defined: built here as well, they doubled
// this file's nvcc time (75 to 152 s on the H100 host), and the kernels
// without a bias must stay the code they were (a uniform branch in them
// cost the quantized cross shapes 4-8%, chip_smoke.py --parent).
//
// What bounds it: each (batch, head) reads valid_len * dh * 2 cache values
// (+ 2 fp32 scales a row when quantized), 4 flops a value pair: device
// memory bandwidth. At the cross case of B 4, H 6, dh 64 that is 18.4 MB in
// fp32 (5.5 us at 3.35 TB/s), 9.2 MB in bf16 and 4.9 MB as int8 with
// scales (1.5 us); so small a read is bound by the loads in flight, which
// is why the rows are split across blocks (decode_split.cuh).
//
// Grid: splits * B * H blocks of 128 threads in clusters of `splits`;
// block x takes chunk x % splits of (batch, head) x / splits. The host
// passes splits, chunk, tile and stages (ops/kernels/decode_attention.py::
// split_plan: from T, B * H, dh, the cache's element size and the SM
// count, never from valid_len). One split of one tile of at most 64 rows
// (the self cache) runs decode_direct instead: 256 threads a head, the
// rows read in place. Before the split, one block of 256 threads per
// (batch, head) took the B 4 cross case in 0.0644 ms (fp32), 0.0460
// (bf16) and 0.0484 (int8 T-minor, bf16 q); split, 0.0137, 0.0113 and
// 0.0106 (chip_smoke.py --parent, H100 80GB HBM3, 700 W, both in one
// run).

#include "decode_split.cuh"

namespace {

using namespace decode_split;

#ifdef DECODE_ATTENTION_BIAS
constexpr bool BIAS = true;  // decode_attention_bias.cu: every call has a bias
#else
constexpr bool BIAS = false;
#endif

struct Params {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int* valid_len;
  int vl_stride;
  const float* bias;  // or null
  int bias_b, bias_h;  // its strides between batch lanes and heads
  void* o;
  int H, T, dh, chunk, tile, stages;
  Copy copy;
};

template <typename QT, typename CT>
__device__ __forceinline__ Head<QT, CT> head(const Params& p, int bh, bool t_minor) {
  Head<QT, CT> h;
  const int vl = p.valid_len[(bh / p.H) * p.vl_stride];
  h.all_masked = vl <= 0;
  h.n = h.all_masked ? p.T : min(vl, p.T);
  const long long base = (long long)bh * p.T * p.dh;
  h.q = static_cast<const QT*>(p.q) + (long long)bh * p.dh;
  h.out = static_cast<QT*>(p.o) + (long long)bh * p.dh;
  h.k = static_cast<const CT*>(p.k) + base;
  h.v = static_cast<const CT*>(p.v) + base;
  h.stride = t_minor ? p.T : p.dh;
  h.ks = p.ks ? p.ks + (long long)bh * p.T : nullptr;
  h.vs = p.vs ? p.vs + (long long)bh * p.T : nullptr;
  h.bias = p.bias ? p.bias + (long long)(bh / p.H) * p.bias_b + (long long)(bh % p.H) * p.bias_h
                  : nullptr;
  h.bias_ref = h.bias != nullptr && !h.all_masked ? h.bias[h.n - 1] : 0.f;
  h.copy = p.copy;
  return h;
}

// VPL vectors a lane (2: fp32 heads wider than 128), heads up to DHM
template <typename QT, typename CT, int LPR, int VPL, int DHM>
__global__ void __launch_bounds__(THREADS) decode_dh_minor(const Params p) {
  __shared__ PartialT<DHM> part;
  const int splits = static_cast<int>(cg::this_cluster().num_blocks());
  if (splits > 1) cluster_arrive();
  const int bh = blockIdx.x / splits, rank = blockIdx.x % splits;
  const Head<QT, CT> h = head<QT, CT>(p, bh, false);
  bool alone;
  if constexpr (DHM > MAX_DH)
    alone = attend_rows_wide<QT, CT, LPR, THREADS, VPL, DHM, BIAS>(h, p.dh, p.chunk, p.tile,
                                                                  p.stages, rank, part);
  else
    alone = attend_rows<QT, CT, LPR, THREADS, BIAS>(h, p.dh, p.chunk, p.tile, p.stages, rank,
                                                    part);
  if (!alone) combine(part, p.dh, h.out);
}

// One block a head of at most DIRECT_ROWS rows, read in place (the self
// cache): more threads, so more rows at once.
template <typename QT, typename CT, int LPR, int VPL, int DHM>
__global__ void __launch_bounds__(DIRECT_THREADS) decode_direct(const Params p) {
  __shared__ PartialT<DHM> part;
  const Head<QT, CT> h = head<QT, CT>(p, blockIdx.x, false);
  if constexpr (DHM > MAX_DH)
    attend_rows_wide<QT, CT, LPR, DIRECT_THREADS, VPL, DHM, BIAS>(h, p.dh, p.chunk, p.tile, 1,
                                                                 0, part);
  else
    attend_rows<QT, CT, LPR, DIRECT_THREADS, BIAS>(h, p.dh, p.chunk, p.tile, 1, 0, part);
}

template <typename QT, typename CT, int DHM>
__global__ void __launch_bounds__(THREADS) decode_t_minor(const Params p) {
  __shared__ PartialT<DHM> part;
  const int splits = static_cast<int>(cg::this_cluster().num_blocks());
  if (splits > 1) cluster_arrive();
  const int bh = blockIdx.x / splits, rank = blockIdx.x % splits;
  const Head<QT, CT> h = head<QT, CT>(p, bh, true);
  attend_t_minor<QT, CT>(h, p.dh, p.chunk, p.tile, p.stages, rank, part);
  combine(part, p.dh, h.out);
}

bool aligned16(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0;
}

// How a dh-minor tile reaches shared memory, worked out here from the plan
// and the pointers: one split of one tile of rows that the slots keep in
// registers is read in place (DIRECT); otherwise a tile's rows, one
// contiguous run of whole 16-byte pieces, are one bulk copy each of K and
// V (BULK), their scales one more each where T % 4 == 0 and the scales
// align, else by cp.async (ASYNC); rows that 16 bytes do not align are
// copied element by element (ELEMENT).
template <typename QT, typename CT, int LPR, int VPL = 1, int DHM = MAX_DH>
cudaError_t launch_dh_minor(Params p, int splits, int bh, cudaStream_t st) {
  constexpr int VEC = Vec<CT>::N;
  const int dhp = (p.dh + VEC - 1) / VEC * VEC;
  if (!aligned16(p.k, p.v) || (p.dh * (int)sizeof(CT)) % 16 != 0)
    p.copy = ELEMENT;
  else if (splits == 1 && p.tile >= p.chunk &&
           p.chunk <= min(DIRECT_ROWS, direct_rps(DHM) * (DIRECT_THREADS / 32) * (32 / LPR)))
    p.copy = DIRECT;
  else if (p.ks != nullptr && (p.T % 4 != 0 || !aligned16(p.ks, p.vs)))
    p.copy = ASYNC;
  else
    p.copy = BULK;
  const int smem = p.copy == DIRECT ? 0 : tile_smem<CT>(p.tile, dhp, p.stages, false);
  if (!plan_ok(p.T, splits, p.chunk, p.tile, p.stages, smem)) return cudaErrorInvalidValue;
  static unsigned ready = 0, direct_ready = 0;
  if (p.copy == DIRECT)
    return launch<DIRECT_THREADS>(decode_direct<QT, CT, LPR, VPL, DHM>, &direct_ready, 1, bh, 0,
                                  st, p);
  return launch(decode_dh_minor<QT, CT, LPR, VPL, DHM>, &ready, splits, bh, smem, st, p);
}

template <typename QT, typename CT, int DHM>
cudaError_t launch_t_minor(Params p, int splits, int bh, cudaStream_t st) {
  static unsigned ready = 0;
  // a tile's d rows are dh runs of t, T apart: 16-byte cp.async pieces
  // where the runs align
  p.copy = aligned16(p.k, p.v) && (p.T * (int)sizeof(CT)) % 16 == 0 ? ASYNC : ELEMENT;
  const int smem = tile_smem<CT>(p.tile, p.dh, p.stages, true);
  if (!plan_ok(p.T, splits, p.chunk, p.tile, p.stages, smem)) return cudaErrorInvalidValue;
  return launch(decode_t_minor<QT, CT, DHM>, &ready, splits, bh, smem, st, p);
}

template <typename QT, typename CT>
cudaError_t launch_cache(Params p, int splits, int bh, bool t_minor, cudaStream_t st) {
  if (t_minor)
    return p.dh > MAX_DH ? launch_t_minor<QT, CT, MAX_DH_WIDE>(p, splits, bh, st)
                         : launch_t_minor<QT, CT, MAX_DH>(p, splits, bh, st);
  // heads of 136..256: 32 lanes a row, each 2 vectors of 4 fp32 values or
  // one of 8 values of the other types
  if (p.dh > MAX_DH)
    return launch_dh_minor<QT, CT, 32, Vec<CT>::N == 4 ? 2 : 1, MAX_DH_WIDE>(p, splits, bh, st);
  // dh % 8 == 0 and dh <= 128: 2..32 pieces of 4 fp32 values, 1..16 of 8
  // values of the other types; only the reachable widths are built
  const int pieces = p.dh / Vec<CT>::N;
  if constexpr (Vec<CT>::N == 4) {
    if (pieces <= 2) return launch_dh_minor<QT, CT, 2>(p, splits, bh, st);
    if (pieces <= 4) return launch_dh_minor<QT, CT, 4>(p, splits, bh, st);
    if (pieces <= 8) return launch_dh_minor<QT, CT, 8>(p, splits, bh, st);
    if (pieces <= 16) return launch_dh_minor<QT, CT, 16>(p, splits, bh, st);
    return launch_dh_minor<QT, CT, 32>(p, splits, bh, st);
  } else {
    if (pieces <= 1) return launch_dh_minor<QT, CT, 1>(p, splits, bh, st);
    if (pieces <= 2) return launch_dh_minor<QT, CT, 2>(p, splits, bh, st);
    if (pieces <= 4) return launch_dh_minor<QT, CT, 4>(p, splits, bh, st);
    if (pieces <= 8) return launch_dh_minor<QT, CT, 8>(p, splits, bh, st);
    return launch_dh_minor<QT, CT, 16>(p, splits, bh, st);
  }
}

// cache dtype codes: 0 float32, 1 bfloat16, 2 int8, 3 fp8 e4m3
template <typename QT>
cudaError_t by_cache(int cache_dtype, int same, const Params& p, int splits, int bh,
                     bool t_minor, cudaStream_t st) {
  if (cache_dtype == same) return launch_cache<QT, QT>(p, splits, bh, t_minor, st);
  if (cache_dtype == 2) return launch_cache<QT, int8_t>(p, splits, bh, t_minor, st);
  if (cache_dtype == 3) return launch_cache<QT, __nv_fp8_e4m3>(p, splits, bh, t_minor, st);
  return cudaErrorInvalidValue;  // a float cache of another dtype than q's
}

}  // namespace

extern "C" {

// q (B, H, 1, dh) and o (B, H, 1, dh) in q_dtype (0 float32, 1 bfloat16);
// k/v (B, H, T, dh), or (B, H, dh, T) when t_major, in cache_dtype (0
// float32, 1 bfloat16: equal to q_dtype; 2 int8, 3 fp8 e4m3: then k_scale
// and v_scale point to fp32 (B, H, T, 1)); dh a multiple of 8 up to 256;
// all contiguous. valid_len points
// to int32 on the device: lane b reads valid_len[b * vl_stride]. bias, when
// not null, points to fp32: head h of lane b adds bias[b * bias_b + h *
// bias_h + t] to row t's score (strides 0 where it broadcasts); this
// library refuses a call with one, decode_attention_bias.cu's one without. splits
// (1..16) chunks of `chunk` rows cover T, none empty; the blocks walk them
// in tiles of `tile` rows (chunk and tile multiples of 16), `stages`
// (1..4) tiles in flight. Returns a cudaError_t.
int decode_attn(const void* q, const void* k, const void* v, const void* k_scale,
                const void* v_scale, const void* valid_len, int vl_stride, const void* bias,
                int bias_b, int bias_h, void* o,
                int B, int H, int T_len, int dh, int q_dtype, int cache_dtype,
                int t_major, int splits, int chunk, int tile, int stages, void* stream) {
  const bool quant = cache_dtype == 2 || cache_dtype == 3;
  if (B <= 0 || H <= 0 || T_len <= 0 || dh <= 0 || dh > MAX_DH_WIDE || dh % 8 != 0 ||
      (vl_stride != 0 && vl_stride != 1) || (bias != nullptr) != BIAS || bias_b < 0 ||
      bias_h < 0 ||
      (quant && (k_scale == nullptr || v_scale == nullptr)) ||
      (long long)B * H * splits > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // the launchers set how tiles reach shared memory
  const Params p{q, k, v, static_cast<const float*>(quant ? k_scale : nullptr),
                 static_cast<const float*>(quant ? v_scale : nullptr),
                 static_cast<const int*>(valid_len), vl_stride,
                 static_cast<const float*>(bias), bias_b, bias_h, o, H, T_len, dh, chunk,
                 tile, stages, ELEMENT};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return by_cache<float>(cache_dtype, 0, p, splits, B * H, t_major != 0, st);
  if (q_dtype == 1)
    return by_cache<__nv_bfloat16>(cache_dtype, 1, p, splits, B * H, t_major != 0, st);
  return cudaErrorInvalidValue;
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
