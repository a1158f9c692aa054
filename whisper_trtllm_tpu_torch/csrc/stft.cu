// Fused STFT + power + mel + log10 for Hopper (sm_90a), all in full fp32.
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
// Numerics: fp32 FMAs on the CUDA cores, never TF32 or the tensor cores:
// log10 amplifies the relative error of a small power value (the JAX
// package uses Precision.HIGHEST for the same reason).
//
// What bounds it: at Whisper's shapes (3001 frames, 400 taps, 201 bins,
// 80 mels) each frame needs 2*400*402 + 2*201*80 = 0.35 Mflop and moves
// 1.6 KB (the frame's own hop of samples in, its mel row out): ~220 flops
// per byte, so the fp32 units bound it (67 Tflop/s on an H100 SXM).
//
// Design: one block of 256 threads per (utterance, 32 frames). The block's
// signal slab, (FB - 1) * hop + n_taps samples (21 KB), sits in shared
// memory, and the basis streams through two shared-memory buffers 16 rows
// at a time (cp.async: the next chunk is in flight while this one is used),
// each row laid out as 224 real then 224 imaginary columns (bins 201..223
// zero). Thread (fg, bg) of 8 x 32 owns 4 frames and bins bg + 32 j,
// j < 7, real and imaginary: per tap it reads 4 samples (one address per
// warp: a broadcast) and 14 basis values (32 consecutive words per warp: no
// bank conflicts) for 56 FMAs. Power is formed in registers and written to
// shared memory over the consumed slab; then each thread projects 8 frames
// onto one mel bin, reading the filterbank through L1, and stores log10.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int FB = 32;              // frames per block
constexpr int BG = 32;              // bin groups: one per lane
constexpr int FG = THREADS / BG;    // frame groups: one per warp
constexpr int RF = FB / FG;         // frames per thread in the DFT
constexpr int RB = 7;               // bins per thread: bg + BG * j
constexpr int NB_MAX = BG * RB;     // 224 bins at most
constexpr int KC = 16;              // basis rows per staged chunk
constexpr int CHUNK = KC * 2 * NB_MAX;
constexpr int RM = 8;               // frames per thread in the mel product

size_t smem_floats(int hop, int n_taps, int n_bins) {
  const size_t dft = (size_t)(FB - 1) * hop + n_taps + 2 * (size_t)CHUNK;
  const size_t mel = (size_t)FB * n_bins;
  return dft > mel ? dft : mel;
}

__global__ void __launch_bounds__(THREADS, 2)
stft_log_mel_kernel(const float* __restrict__ x, const float* __restrict__ basis,
                    const float* __restrict__ mel, float* __restrict__ out,
                    int n_samples, int n_frames, int hop, int n_taps,
                    int n_bins, int n_mels) {
  extern __shared__ float smem[];
  const int slab_len = (FB - 1) * hop + n_taps;
  float* slab = smem;                    // [slab_len]
  float* chunks = smem + slab_len;       // [2][KC][2][NB_MAX]
  float* power = smem;                   // [FB][n_bins], after the DFT

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FB;
  const int tid = threadIdx.x;
  const int bg = tid % BG, fg = tid / BG;
  const float* xb = x + (size_t)b * n_samples;
  const size_t s0 = (size_t)f0 * hop;

  const int row = 2 * n_bins;
  const int n_chunks = (n_taps + KC - 1) / KC;
  // basis rows [ci * KC, ci * KC + KC) into buffer ci % 2, asynchronously
  auto stage = [&](int ci) {
    float* buf = chunks + (ci % 2) * CHUNK;
    const int k0 = ci * KC, kc = min(KC, n_taps - k0);
    for (int kk = 0; kk < kc; ++kk) {
      const float* src = basis + (size_t)(k0 + kk) * row;
      for (int c = tid; c < row; c += THREADS) {
        const int im_part = c >= n_bins;
        __pipeline_memcpy_async(buf + (kk * 2 + im_part) * NB_MAX + c - im_part * n_bins,
                                src + c, sizeof(float));
      }
    }
    __pipeline_commit();
  };
  stage(0);

  for (int i = tid; i < slab_len; i += THREADS)
    slab[i] = s0 + i < (size_t)n_samples ? xb[s0 + i] : 0.f;
  // bins >= n_bins stay zero: the copies never write them
  for (int i = tid; i < 2 * CHUNK; i += THREADS)
    if (i % NB_MAX >= n_bins) chunks[i] = 0.f;

  float re[RF][RB], im[RF][RB];
#pragma unroll
  for (int r = 0; r < RF; ++r)
#pragma unroll
    for (int j = 0; j < RB; ++j) re[r][j] = im[r][j] = 0.f;

  for (int ci = 0; ci < n_chunks; ++ci) {
    if (ci + 1 < n_chunks) {
      stage(ci + 1);  // its buffer was released by the barrier ending ci - 1
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // chunk ci (and the slab, the zeros) visible to all
    const float* chunk = chunks + (ci % 2) * CHUNK;
    const int k0 = ci * KC, kc = min(KC, n_taps - k0);
    for (int kk = 0; kk < kc; ++kk) {
      float xs[RF];
#pragma unroll
      for (int r = 0; r < RF; ++r) xs[r] = slab[(fg * RF + r) * hop + k0 + kk];
      const float* b_re = chunk + kk * 2 * NB_MAX + bg;
      const float* b_im = b_re + NB_MAX;
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const float br = b_re[BG * j], bi = b_im[BG * j];
#pragma unroll
        for (int r = 0; r < RF; ++r) {
          re[r][j] = fmaf(xs[r], br, re[r][j]);
          im[r][j] = fmaf(xs[r], bi, im[r][j]);
        }
      }
    }
    __syncthreads();  // every thread is done with chunk ci (and at the end,
                      // with the slab)
  }

#pragma unroll
  for (int r = 0; r < RF; ++r)
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int bin = bg + BG * j;
      if (bin < n_bins)
        power[(fg * RF + r) * n_bins + bin] = re[r][j] * re[r][j] + im[r][j] * im[r][j];
    }
  __syncthreads();

  const int items = (FB / RM) * n_mels;
  for (int w = tid; w < items; w += THREADS) {
    const int m = w % n_mels, g = w / n_mels;
    const float* pw = power + g * RM * n_bins;
    float acc[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) acc[r] = 0.f;
    for (int j = 0; j < n_bins; ++j) {
      const float fb = __ldg(mel + (size_t)j * n_mels + m);
#pragma unroll
      for (int r = 0; r < RM; ++r) acc[r] = fmaf(pw[r * n_bins + j], fb, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int f = f0 + g * RM + r;
      if (f < n_frames)
        out[((size_t)b * n_frames + f) * n_mels + m] = log10f(fmaxf(acc[r], 1e-10f));
    }
  }
}

}  // namespace

extern "C" {

// x (B, n_samples) fp32, basis (n_taps, 2 * n_bins) fp32, mel (n_bins,
// n_mels) fp32, out (B, n_frames, n_mels) fp32, all contiguous; frame f
// reads x[b, f*hop : f*hop + n_taps] (samples past n_samples read as 0).
// Returns a cudaError_t.
int stft_log_mel(const void* x, const void* basis, const void* mel, void* out,
                 int B, int n_samples, int n_frames, int hop, int n_taps,
                 int n_bins, int n_mels, void* stream) {
  if (B <= 0 || n_frames <= 0 || hop <= 0 || n_taps <= 0 || n_bins <= 0 ||
      n_bins > NB_MAX || n_mels <= 0 || B > 65535)
    return cudaErrorInvalidValue;
  const size_t smem = smem_floats(hop, n_taps, n_bins) * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stft_log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_frames + FB - 1) / FB, B);
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
