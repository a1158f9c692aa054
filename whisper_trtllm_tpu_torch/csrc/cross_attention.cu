// K7: one-token cross attention against a head-contiguous cache, for Hopper
// (sm_90a), one launch a call on the split-T engine of decode_split.cuh:
// fp32 scores, an exact fp32 softmax and fp32 P.V whatever the storage.
//
// Replaces whisper_trtllm_tpu/ops/pallas/cross_attention.py::
// cross_decode_mha (_kernel): q (B, H*dh) pre-scaled; the cache K, V
// (B, T, H*dh), head h in columns [h*dh, (h+1)*dh) of every row; rows at or
// past valid_len masked with -1e9; each head's P.V cast to the storage
// dtype, the output (B, H*dh). q and the cache are fp32, or all bf16.
// valid_len is a host integer (static in the JAX package); valid_len <= 0
// masks every row, so every score is -1e9 and the softmax is uniform over
// all T rows: the mean of V, as in the JAX package.
//
// What bounds it: each (batch, head) reads valid_len * dh values of K and
// of V, 4 flops a pair: device memory bandwidth (3.35 TB/s on an H100
// SXM). At the hardware check's shape (B 4, H 6, T 1504 of which 1500
// valid, dh 64) that is 18.4 MB in fp32, 5.5 us, and 9.2 MB in bf16.
//
// It is the engine's dh-minor case with rows H*dh apart and head h's
// columns from h*dh: 16-byte cp.async pieces, or element by element where
// dh * size is not a multiple of 16. Its valid_len is known on the host,
// so the host splits only the rows it reads (ops/kernels/
// cross_attention.py). Before this design, 576 blocks of 64 rows wrote
// fp32 partials that a second kernel combined: 0.0225 ms in fp32 and
// 0.0219 in bf16 at that shape; one launch now takes 0.0150 and 0.0118
// (chip_smoke.py --parent, H100 80GB HBM3, 700 W, both in one run).

#include "decode_split.cuh"

namespace {

using namespace decode_split;

struct Params {
  const void *q, *k, *v;
  void* out;
  int t, rows, heads, dh, chunk, tile, stages;
  bool all_masked;
  Copy copy;
};

template <typename T, int LPR>
__global__ void __launch_bounds__(THREADS) cross_kernel(const Params p) {
  __shared__ Partial part;
  const int splits = static_cast<int>(cg::this_cluster().num_blocks());
  if (splits > 1) cluster_arrive();
  const int bh = blockIdx.x / splits, rank = blockIdx.x % splits;
  const int b = bh / p.heads, hh = bh % p.heads;
  const long long hd = (long long)p.heads * p.dh;
  Head<T, T> h;
  h.q = static_cast<const T*>(p.q) + (long long)bh * p.dh;
  h.out = static_cast<T*>(p.out) + (long long)bh * p.dh;
  h.k = static_cast<const T*>(p.k) + (long long)b * p.t * hd + (long long)hh * p.dh;
  h.v = static_cast<const T*>(p.v) + (long long)b * p.t * hd + (long long)hh * p.dh;
  h.stride = hd;
  h.ks = h.vs = nullptr;
  h.n = p.rows;
  h.all_masked = p.all_masked;
  h.copy = p.copy;
  if (!attend_rows<T, T, LPR>(h, p.dh, p.chunk, p.tile, p.stages, rank, part))
    combine(part, p.dh, h.out);
}

template <typename T, int LPR>
cudaError_t launch_lpr(const Params& p, int splits, int bh, cudaStream_t st) {
  static unsigned ready = 0;
  constexpr int VEC = Vec<T>::N;
  const int dhp = (p.dh + VEC - 1) / VEC * VEC;
  const int smem = tile_smem<T>(p.tile, dhp, p.stages, false);
  if (!plan_ok(p.rows, splits, p.chunk, p.tile, p.stages, smem)) return cudaErrorInvalidValue;
  return launch(cross_kernel<T, LPR>, &ready, splits, bh, smem, st, p);
}

template <typename T>
cudaError_t launch_dtype(Params p, int splits, int bh, cudaStream_t st) {
  // rows H*dh apart: 16-byte cp.async pieces where dh * size allows
  if ((p.dh * (int)sizeof(T)) % 16 != 0) p.copy = ELEMENT;
  // dh <= 128: 1..32 pieces of 4 fp32 values, 1..16 of 8 bf16 values;
  // only the reachable widths are built
  const int pieces = (p.dh + Vec<T>::N - 1) / Vec<T>::N;
  if (pieces <= 1) return launch_lpr<T, 1>(p, splits, bh, st);
  if (pieces <= 2) return launch_lpr<T, 2>(p, splits, bh, st);
  if (pieces <= 4) return launch_lpr<T, 4>(p, splits, bh, st);
  if (pieces <= 8) return launch_lpr<T, 8>(p, splits, bh, st);
  if constexpr (Vec<T>::N == 4) {
    if (pieces <= 16) return launch_lpr<T, 16>(p, splits, bh, st);
    return launch_lpr<T, 32>(p, splits, bh, st);
  } else {
    return launch_lpr<T, 16>(p, splits, bh, st);
  }
}

}  // namespace

extern "C" {

// q, out (B, H*dh); k, v (B, T, H*dh); all contiguous, of dtype (0 float32,
// 1 bfloat16); dh <= 128. The kernel reads rows = min(valid_len, T) rows, or
// all T when valid_len <= 0 (then every score is masked): splits (1..16)
// chunks of `chunk` rows cover them, none empty, walked in tiles of `tile`
// rows (chunk and tile multiples of 16), `stages` (1..4) tiles in flight.
// Returns a cudaError_t.
int cross_decode_mha(const void* q, const void* k, const void* v, void* out, int b,
                     int t, int heads, int dh, int valid_len, int dtype, int splits,
                     int chunk, int tile, int stages, void* stream) {
  if (b <= 0 || t <= 0 || heads <= 0 || dh <= 0 || dh > MAX_DH || dtype < 0 || dtype > 1 ||
      (long long)b * heads * splits > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const bool all_masked = valid_len <= 0;
  const int rows = all_masked ? t : min(valid_len, t);
  const bool aligned = (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const Params p{q,     k,    v,      out,        t,      rows, heads,
                 dh,    chunk, tile, stages, all_masked, aligned ? ASYNC : ELEMENT};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dtype<float>(p, splits, b * heads, st);
  return launch_dtype<__nv_bfloat16>(p, splits, b * heads, st);
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
