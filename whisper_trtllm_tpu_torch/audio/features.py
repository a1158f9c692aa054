"""Log-mel spectrogram frontend (counterpart of
``whisper_trtllm_tpu/audio/features.py``).

The audio is center-padded and cut into hop-sized (160) blocks; analysis
frame f is the 400 samples from block f on. The windowed DFT (the window
folded into a (400, 402) real-then-imaginary basis), power, mel projection
and log10 run in kernel K3 (``ops/kernels/stft.py``) on the card and in its
plain version, two fp32 matmuls, on the CPU; the kernel takes both
products as 3xTF32, about fp32's precision. Neither rounds to TF32 or
bf16: log10 amplifies any rounding in the power spectrum.

Semantics: hann(400, periodic) window, hop 160, reflect center-pad 200,
power spectrum, slaney mel (80 or 128 bins), log10 with a 1e-10 floor, drop
the last frame, clamp to each utterance's max - 8, then (x + 4) / 4.
"""

from __future__ import annotations

import wave

import numpy as np
import torch
import torch.nn.functional as F

from whisper_trtllm_tpu_torch.audio import mel as _mel
from whisper_trtllm_tpu_torch.ops.kernels.stft import stft_log_mel
from whisper_trtllm_tpu_torch.utils.device import resolve_device, to_tensor

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE      # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH          # 3000
N_FREQ_BINS = N_FFT // 2 + 1                # 201


def read_wav(path: str) -> np.ndarray:
    """A 16-bit PCM mono WAV file → float32 samples in [-1, 1)."""
    with wave.open(path, "rb") as f:
        if f.getsampwidth() != 2 or f.getnchannels() != 1:
            raise ValueError(f"{path}: expected 16-bit mono PCM")
        pcm = np.frombuffer(f.readframes(f.getnframes()), np.int16)
    return pcm.astype(np.float32) / 32768.0


def pad_or_trim(audio: np.ndarray, length: int = N_SAMPLES) -> np.ndarray:
    """Pad with zeros / trim to exactly ``length`` samples along the last
    axis."""
    audio = np.asarray(audio)
    if audio.shape[-1] > length:
        audio = audio[..., :length]
    elif audio.shape[-1] < length:
        pad = [(0, 0)] * (audio.ndim - 1) + [(0, length - audio.shape[-1])]
        audio = np.pad(audio, pad)
    return audio


class LogMelSpectrogram:
    """Holds the window/DFT/mel constants on ``device`` (the CUDA card by
    default); ``__call__`` maps audio ``(B, N_SAMPLES)`` to
    ``(B, N_FRAMES, num_mel_bins)``, time-major, as the encoder's conv stem
    takes it, computed in fp32 and cast to ``dtype`` at the end."""

    def __init__(self, num_mel_bins: int = 80, dtype=torch.float32,
                 device=None):
        window = _mel.hann_window(N_FFT, periodic=True)          # (400,)
        cos_m, sin_m = _mel.dft_matrices(N_FFT)                  # (400, 201)
        # the window folded into the bases, the 400-tap analysis zero-padded
        # to 3 hop blocks (480), real and imaginary fused into one basis
        basis = np.zeros((3 * HOP_LENGTH, 2 * N_FREQ_BINS), np.float32)
        basis[:N_FFT, :N_FREQ_BINS] = window[:, None] * cos_m
        basis[:N_FFT, N_FREQ_BINS:] = window[:, None] * sin_m
        self.device = resolve_device(device)
        self.dft_basis = torch.from_numpy(basis).to(self.device)  # (480, 402)
        self.mel_fb = torch.from_numpy(
            _mel.mel_filter_bank(N_FREQ_BINS, num_mel_bins)).to(self.device)
        self.num_mel_bins = num_mel_bins
        self.dtype = dtype

    def __call__(self, audio) -> torch.Tensor:
        audio = to_tensor(audio, self.device, torch.float32)
        if audio.dim() == 1:
            audio = audio[None]
        b = audio.shape[0]
        # center=True reflect padding of n_fft//2 on both sides
        padded = F.pad(audio[:, None], (N_FFT // 2, N_FFT // 2),
                       mode="reflect")[:, 0]
        # frame f covers samples [160f, 160f+400) within three consecutive
        # hop blocks. Tail-pad so block f+2 exists for the last frame.
        n_frames_full = N_FRAMES + 1                              # 3001
        total = (n_frames_full + 2) * HOP_LENGTH
        padded = F.pad(padded, (0, total - padded.shape[1]))
        blocks = padded.reshape(b, n_frames_full + 2, HOP_LENGTH)
        # the basis' rows past N_FFT are zero taps
        log_spec = stft_log_mel(blocks, self.dft_basis[:N_FFT],
                                self.mel_fb)                      # (B, 3001, M)
        log_spec = log_spec[:, :-1, :]                            # (B, 3000, M)
        gmax = log_spec.reshape(b, -1).amax(dim=-1)               # per utterance
        log_spec = torch.maximum(log_spec, gmax[:, None, None] - 8.0)
        log_spec = (log_spec + 4.0) / 4.0
        return log_spec.to(self.dtype)


def log_mel_spectrogram(audio, num_mel_bins: int = 80,
                        device=None) -> torch.Tensor:
    """One-shot API: audio ``(B, 480000)`` or ``(480000,)`` (numpy or
    tensor) → ``(B, 3000, M)`` on ``device`` (the CUDA card by default)."""
    return LogMelSpectrogram(num_mel_bins, device=device)(audio)
