// Fused STFT + power + mel + log10 for Hopper (sm_90a): both products on
// the tensor cores as 3xTF32, power in fp32.
//
// Replaces whisper_trtllm_tpu/ops/pallas/stft.py::stft_log_mel (_kernel):
// frame f of utterance b is the n_taps samples x[b, f*hop : f*hop + n_taps]
// of the center-padded signal; its windowed DFT against a basis
// (n_taps, 2*n_bins) (window folded in, real columns then imaginary), the
// power re^2 + im^2 of each bin, the projection onto the mel filterbank
// (n_bins, n_mels) and log10 with a 1e-10 floor give out[b, f, :].
// The Pallas kernel summed three hop-shifted (FB, hop) x (hop, 2*n_bins)
// products only because Mosaic cannot slice unaligned lanes; here a block
// reads its frames straight from the signal. The Whisper frontend passes the
// 400 non-zero rows of its (480, 402) basis, so no zero taps are summed.
//
// Numerics: the JAX kernel runs both products at Precision.HIGHEST,
// because log10 amplifies the relative error of a small power value. Here
// each is a product on mma.sync m16n8k8 as 3xTF32 (flash_tiles.cuh): each
// operand x = hi + lo, hi = tf32(x), lo = tf32(x - hi), about 22 mantissa
// bits, and a product is lo*hi + hi*lo + hi*hi (lo*lo, ~2^-22 of it,
// dropped). The tensor cores truncate the fp32 sum they add into, so each
// 8-step's three products go into a fresh partial that is added to the
// accumulator in fp32, round to nearest: no truncated sum runs longer than
// three products. Splitting by truncation instead (three operations, not
// five) was no faster and broke the limit on the card (2.7e-4 at 128 mels;
// NVIDIA H100 80GB HBM3, 700 W). The mel sums have no cancellation (power
// and the weights are non-negative).
//
// What bounds it: at Whisper's shapes (B 4, 3001 frames, 400 taps, 201
// bins, 80 mels) the DFT is 3.86 GFLOP and the mel product 0.39, 25.7 us
// together at 3xTF32's 495/3 TFLOP/s; 12 MB move (3.6 us at 3.35 TB/s):
// the operations bound it. The previous kernel ran the DFT as fp32 FMAs at
// 0.32 shared-memory reads an FMA, 1.42 waves, with 4-byte copies.
//
// Design: one block of 12 warps per (utterance, 96 frames): 128 blocks at
// B 4, one wave on 132 SMs. Warp (mp, nq) of 3 x 4 owns frames 32 mp .. +32
// (two 16-row tiles) and bins 56 nq .. +56 (seven 8-bin tiles, real and
// imaginary), so each B fragment serves two row tiles and power forms in
// the lane that holds both halves. 224 bins are covered (201 used). The
// taps stream in chunks of 32 through three stages: the frames as a padded
// (96, 32) tile (row stride 40 words: the fragment reads fall in distinct
// banks, where a stride of hop = 160 would be an 8-way conflict), by 16-byte
// cp.async; the basis rows as one bulk copy (TMA) on an mbarrier, the next
// chunks in flight while one is multiplied. The contraction index runs in
// the permuted order of flash_tiles' load_b_kn (k 2t, 2t + 1 in lane t):
// the A fragments read the same pair, and the sum over k is unchanged.
// After the last chunk, power goes to shared memory while the filterbank
// (128 mels at a time) is copied in beside it, and the mel product runs as
// the DFT does, a warp 16 frames by half the mels (mel_mma). mel_mma is
// not inlined: inlined, its registers came out of the DFT's 168 and both
// spilled (the kernel took 0.1044 ms, 0.0994 apart; NVIDIA H100 80GB HBM3,
// 700 W).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "flash_tiles.cuh"

namespace {

using flash::split_tf32;
using M3 = flash::Mma<float>;

constexpr int THREADS = 384;
constexpr int BM = 96;               // frames a block
constexpr int NB_TILES = 7;          // 8-bin tiles a warp
constexpr int NQ = 4;                // bin quarters
constexpr int NB_MAX = 8 * NB_TILES * NQ;  // 224 bins
constexpr int KC = 32;               // taps a chunk
constexpr int STAGES = 3;
constexpr int LDA = KC + 8;          // frames tile row stride (words)
constexpr int LDP = NB_MAX + 4;      // power row stride (4 x odd words)
constexpr int MC = 128;              // mels a pass
constexpr int LDF = MC + 4;          // filterbank row stride (4 mod 32 words)
constexpr int A_FLOATS = BM * LDA;

__host__ __device__ inline size_t stage_floats(int n_bins) {
  return A_FLOATS + (size_t)KC * 2 * n_bins;
}

__host__ __device__ inline size_t smem_floats(int n_bins) {
  const size_t main = STAGES * stage_floats(n_bins);
  const size_t mel = (size_t)BM * LDP + (size_t)(n_bins + 7) / 8 * 8 * LDF;
  // + slack: the padded bins of the last bin tile read past a stage's rows
  return (main > mel ? main : mel) + 2 * NB_MAX;
}

// log10 of the mel product for the block's frames and mels [m0, m0 + mc),
// on the tensor cores as 3xTF32 too: power (BM, nb8) in P is the A operand
// (its k index permuted as the DFT's), the filterbank rows (nb8, MC) in FB,
// LDF floats apart, the B operand. Warp w takes the 16 frames 16 (w % 6) on
// and half of the mel tiles; the sums are of non-negative terms, so 3xTF32
// holds them to ~2^-21.
// PER mel tiles a warp, so the tiles' product chains interleave.
template <int PER>
__device__ __noinline__ void mel_mma(const float* P, const float* FB, float* out, int out0,
                                        int frames, int n_mels, int m0, int mc, int nb8) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * (warp % 6), tiles = (mc + 7) / 8;
  const int base = (warp / 6) * PER;
  float acc[PER][4];
#pragma unroll
  for (int j = 0; j < PER; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int kk = 0; kk < nb8; kk += 8) {
    M3::A a;
    const float* p = P + (r0 + g) * LDP + kk + 2 * t;
    const float2 lo_row = *reinterpret_cast<const float2*>(p);
    const float2 hi_row = *reinterpret_cast<const float2*>(p + 8 * LDP);
    split_tf32(lo_row.x, a.hi[0], a.lo[0]);
    split_tf32(hi_row.x, a.hi[1], a.lo[1]);
    split_tf32(lo_row.y, a.hi[2], a.lo[2]);
    split_tf32(hi_row.y, a.hi[3], a.lo[3]);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      // a tile past the last reads the next columns of FB's rows (finite,
      // or zero past n_bins) and is not stored
      const float* q = FB + (kk + 2 * t) * LDF + min(8 * (base + j), MC - 8) + g;
      M3::B bf;
      split_tf32(q[0], bf.hi[0], bf.lo[0]);
      split_tf32(q[LDF], bf.hi[1], bf.lo[1]);
      float d[4];
      M3::mma1_fresh(d, a.lo, bf.hi);
      M3::mma1(d, a.hi, bf.lo);
      M3::mma1(d, a.hi, bf.hi);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += d[e];
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (base + j >= tiles) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e / 2), m = 8 * (base + j) + 2 * t + e % 2;
      if (r < frames && m < mc)
        out[((size_t)out0 + r) * n_mels + m0 + m] = log10f(fmaxf(acc[j][e], 1e-10f));
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
stft_log_mel_kernel(const float* __restrict__ x, const float* __restrict__ basis,
                    const float* __restrict__ mel, float* __restrict__ out,
                    int n_samples, int n_frames, int hop, int n_taps,
                    int n_bins, int n_mels) {
  extern __shared__ __align__(128) float smem[];
  const int n_smem = (int)smem_floats(n_bins);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + n_smem);
  const int sf = (int)stage_floats(n_bins);
  const int row = 2 * n_bins;  // basis row, floats

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int mp = warp % 3, nq = warp / 3;
  const float* xb = x + (size_t)b * n_samples;
  const int n_chunks = (n_taps + KC - 1) / KC;
  const bool vec = hop % 4 == 0 && n_taps % 4 == 0 && n_samples % 4 == 0;

  // the basis regions start zeroed: rows past n_taps of a partial last
  // step are then zeros (or finite rows of an earlier chunk), whose
  // products with the zero-filled frame columns vanish
  if (tid == 0)
    for (int s = 0; s < STAGES; ++s) async_copy::mbar_init(bar + s, 1);
  for (int s = 0; s < STAGES; ++s)
    for (int i = tid; i < KC * row; i += THREADS) smem[s * sf + A_FLOATS + i] = 0.f;
  for (int i = STAGES * sf + tid; i < n_smem; i += THREADS) smem[i] = 0.f;
  __syncthreads();
  if (tid == 0) {
    async_copy::mbar_init_fence();
    async_copy::fence_proxy_async();
  }

  // chunk c (taps [c * KC, + KC)) into stage c % STAGES: frames by every
  // thread (one cp.async group), the basis rows by one bulk copy
  auto load = [&](int c) {
    float* A = smem + (c % STAGES) * sf;
    float* Bt = A + A_FLOATS;
    const int k0 = c * KC, kc = min(KC, n_taps - k0);
    if (tid == 0) {
      const uint32_t bytes = (uint32_t)kc * row * 4;
      const uint32_t bulk = bytes & ~15u;
      async_copy::fence_proxy_async();
      async_copy::mbar_expect(bar + c % STAGES, bulk);
      if (bulk) async_copy::bulk_copy(Bt, basis + (size_t)k0 * row, bulk, bar + c % STAGES);
      for (uint32_t i = bulk / 4; i < bytes / 4; ++i) Bt[i] = basis[(size_t)k0 * row + i];
    }
    if (vec) {
      for (int i = tid; i < BM * (KC / 4); i += THREADS) {
        const int r = i / (KC / 4), k = (i % (KC / 4)) * 4;
        const bool ok = f0 + r < n_frames && k < kc;
        flash::cp_async16(A + r * LDA + k, ok ? xb + (size_t)(f0 + r) * hop + k0 + k : xb,
                          ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < BM * KC; i += THREADS) {
        const int r = i / KC, k = i % KC;
        const bool ok = f0 + r < n_frames && k < kc;
        flash::cp_async4(A + r * LDA + k, ok ? xb + (size_t)(f0 + r) * hop + k0 + k : xb,
                         ok ? 4 : 0);
      }
    }
    flash::cp_async_commit();
  };
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < n_chunks) load(c);
    else flash::cp_async_commit();
  }

  // acc[i][j][0: re, 1: im][4]: row tile i (16 frames), bin tile j
  float acc[2][NB_TILES][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NB_TILES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][0][e] = acc[i][j][1][e] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    // the stage of chunk c - 1 is free (every thread passed the barrier
    // that ended its products): chunk c + STAGES - 1 goes into it
    if (c + STAGES - 1 < n_chunks) load(c + STAGES - 1);
    else flash::cp_async_commit();
    flash::cp_async_wait<STAGES - 1>();
    async_copy::mbar_wait(bar + c % STAGES, (c / STAGES) & 1);
    __syncthreads();
    const float* A = smem + (c % STAGES) * sf;
    const float* Bt = A + A_FLOATS;
    const int steps = (min(KC, n_taps - c * KC) + 7) / 8;
    for (int ks = 0; ks < steps; ++ks) {
      const int kk = ks * 8;
      M3::A a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* p = A + (32 * mp + 16 * i + g) * LDA + kk + 2 * t;
        const float2 lo_row = *reinterpret_cast<const float2*>(p);
        const float2 hi_row = *reinterpret_cast<const float2*>(p + 8 * LDA);
        split_tf32(lo_row.x, a[i].hi[0], a[i].lo[0]);
        split_tf32(hi_row.x, a[i].hi[1], a[i].lo[1]);
        split_tf32(lo_row.y, a[i].hi[2], a[i].lo[2]);
        split_tf32(hi_row.y, a[i].hi[3], a[i].lo[3]);
      }
#pragma unroll
      for (int j = 0; j < NB_TILES; ++j) {
        const int n = 8 * (NB_TILES * nq + j) + g;
        M3::B bf[2];  // re, im
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float* p = Bt + (kk + 2 * t) * row + q * n_bins + n;
          split_tf32(p[0], bf[q].hi[0], bf[q].lo[0]);
          split_tf32(p[row], bf[q].hi[1], bf[q].lo[1]);
        }
        // a fresh partial for this step's three products, four chains
        float d[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) M3::mma1_fresh(d[u], a[u / 2].lo, bf[u % 2].hi);
#pragma unroll
        for (int u = 0; u < 4; ++u) M3::mma1(d[u], a[u / 2].hi, bf[u % 2].lo);
#pragma unroll
        for (int u = 0; u < 4; ++u) M3::mma1(d[u], a[u / 2].hi, bf[u % 2].hi);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u / 2][j][u % 2][e] += d[u][e];
      }
    }
    __syncthreads();  // chunk c's stage may be refilled
  }
  flash::cp_async_wait<0>();

  // power, then the mel product over the frames' bins; the filterbank's
  // first MC columns are copied in while power is written
  float* P = smem;
  float* FB = smem + BM * LDP;
  const int nb8 = (n_bins + 7) / 8 * 8;
  // the filterbank's columns [m0, m0 + mc) into FB (row j: LDF floats),
  // rows from n_bins to nb8 zero
  auto load_fb = [&](int m0, int mc) {
    if (mc % 4 == 0 && n_mels % 4 == 0 && m0 % 4 == 0 &&
        reinterpret_cast<uintptr_t>(mel) % 16 == 0) {
      for (int i = tid; i < nb8 * (mc / 4); i += THREADS) {
        const int j = i / (mc / 4), m = (i % (mc / 4)) * 4;
        flash::cp_async16(FB + j * LDF + m, mel + (size_t)min(j, n_bins - 1) * n_mels + m0 + m,
                          j < n_bins ? 16 : 0);
      }
    } else {
      for (int i = tid; i < nb8 * mc; i += THREADS) {
        const int j = i / mc, m = i % mc;
        flash::cp_async4(FB + j * LDF + m, mel + (size_t)min(j, n_bins - 1) * n_mels + m0 + m,
                         j < n_bins ? 4 : 0);
      }
    }
    flash::cp_async_commit();
  };
  load_fb(0, min(MC, n_mels));
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NB_TILES; ++j) {
      const int r = 32 * mp + 16 * i + g, col = 8 * (NB_TILES * nq + j) + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float re = acc[i][j][0][e], im = acc[i][j][1][e];
        P[(r + 8 * (e / 2)) * LDP + col + e % 2] = re * re + im * im;
      }
    }
  for (int m0 = 0; m0 < n_mels; m0 += MC) {
    const int mc = min(MC, n_mels - m0);
    if (m0 > 0) {
      __syncthreads();  // the last pass's reads of FB are done
      load_fb(m0, mc);
    }
    flash::cp_async_wait<0>();
    __syncthreads();  // P and this pass's FB visible
    const int out0 = b * n_frames + f0, frames = n_frames - f0;
    switch (((mc + 7) / 8 + 1) / 2) {  // mel tiles a warp
      case 1: mel_mma<1>(P, FB, out, out0, frames, n_mels, m0, mc, nb8); break;
      case 2: mel_mma<2>(P, FB, out, out0, frames, n_mels, m0, mc, nb8); break;
      case 3: mel_mma<3>(P, FB, out, out0, frames, n_mels, m0, mc, nb8); break;
      case 4: mel_mma<4>(P, FB, out, out0, frames, n_mels, m0, mc, nb8); break;
      case 5: mel_mma<5>(P, FB, out, out0, frames, n_mels, m0, mc, nb8); break;
      case 6: mel_mma<6>(P, FB, out, out0, frames, n_mels, m0, mc, nb8); break;
      case 7: mel_mma<7>(P, FB, out, out0, frames, n_mels, m0, mc, nb8); break;
      default: mel_mma<8>(P, FB, out, out0, frames, n_mels, m0, mc, nb8); break;
    }
  }
}

}  // namespace

extern "C" {

// x (B, n_samples) fp32, basis (n_taps, 2 * n_bins) fp32, mel (n_bins,
// n_mels) fp32, out (B, n_frames, n_mels) fp32, all contiguous, x and
// basis 16-byte aligned; frame f reads x[b, f*hop : f*hop + n_taps] (the
// caller keeps f*hop + n_taps <= n_samples). Returns a cudaError_t.
int stft_log_mel(const void* x, const void* basis, const void* mel, void* out,
                 int B, int n_samples, int n_frames, int hop, int n_taps,
                 int n_bins, int n_mels, void* stream) {
  if (B <= 0 || n_frames <= 0 || hop <= 0 || n_taps <= 0 || n_bins <= 0 ||
      n_bins > NB_MAX || n_mels <= 0 || B > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(basis) % 16)
    return cudaErrorInvalidValue;
  const size_t smem = smem_floats(n_bins) * sizeof(float) + STAGES * sizeof(uint64_t);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stft_log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_frames + BM - 1) / BM, B);
  stft_log_mel_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(basis),
      static_cast<const float*>(mel), static_cast<float*>(out), n_samples,
      n_frames, hop, n_taps, n_bins, n_mels);
  return cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
