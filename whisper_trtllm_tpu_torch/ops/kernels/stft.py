"""K3: fused STFT + power + mel + log10 — the wrapper of ``csrc/stft.cu``
and its plain PyTorch version. The kernel takes the DFT and the mel
product on the tensor cores as 3xTF32 (about 22 bits an operand, a fresh
fp32 partial every 8 taps or bins) and power in fp32.

Counterpart of ``whisper_trtllm_tpu/ops/pallas/stft.py::stft_log_mel``.
The wrapper takes the plain version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from whisper_trtllm_tpu_torch.ops.kernels import _build, _launches

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "stft_log_mel": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}
MAX_BINS = 224  # the kernel's bins: 4 warps × 7 tiles of 8


def stft_log_mel_reference(audio_blocks: torch.Tensor, basis: torch.Tensor,
                           mel_fb: torch.Tensor) -> torch.Tensor:
    """Plain version: frame f is the ``n_taps = basis.shape[0]`` samples
    from hop block f on; its windowed DFT (two fp32 matmuls, never TF32),
    power, mel projection and log10 with a 1e-10 floor."""
    b, n_blocks, hop = audio_blocks.shape
    n_taps, n_bins = basis.shape[0], basis.shape[1] // 2
    frames = audio_blocks.reshape(b, n_blocks * hop).unfold(1, n_taps, hop)
    spec = torch.matmul(frames[:, :n_blocks - 2], basis)
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    power = re * re + im * im
    return torch.log10(torch.clamp(torch.matmul(power, mel_fb), min=1e-10))


def _check(x, basis, mel_fb):
    if not (x.device == basis.device == mel_fb.device):
        raise ValueError("stft_log_mel: the signal, the basis and the "
                         "filterbank must lie on one device")
    if x.dim() != 3 or basis.dim() != 2 or mel_fb.dim() != 2:
        raise ValueError(
            f"stft_log_mel: audio_blocks (B, n_blocks, hop), basis (n_taps, "
            f"2*n_bins), mel_fb (n_bins, M); got {tuple(x.shape)}, "
            f"{tuple(basis.shape)}, {tuple(mel_fb.shape)}")
    b, n_blocks, hop = x.shape
    n_taps, cols = basis.shape
    if (cols % 2 or mel_fb.shape[0] != cols // 2 or n_taps > 3 * hop
            or n_blocks < 3):
        raise ValueError(
            f"stft_log_mel: basis {tuple(basis.shape)} and mel_fb "
            f"{tuple(mel_fb.shape)} do not fit hop {hop} (n_taps <= 3 * hop, "
            f"at least 3 hop blocks)")
    if cols // 2 > MAX_BINS:
        raise ValueError(f"stft_log_mel: at most {MAX_BINS} frequency bins, "
                         f"got {cols // 2}")
    if any(t.dtype != torch.float32 for t in (x, basis, mel_fb)):
        raise TypeError("stft_log_mel: float32 inputs only (the DFT must "
                        "stay full fp32)")
    if not (x.is_contiguous() and basis.is_contiguous()
            and mel_fb.is_contiguous()):
        raise ValueError("stft_log_mel: inputs must be contiguous")
    if x.data_ptr() % 16 or basis.data_ptr() % 16:
        raise ValueError("stft_log_mel: the signal and the basis are copied "
                         "in 16-byte pieces and must be aligned so")


def stft_log_mel(audio_blocks: torch.Tensor, basis: torch.Tensor,
                 mel_fb: torch.Tensor) -> torch.Tensor:
    """audio_blocks (B, n_blocks, hop) fp32, the center-padded signal in
    hop rows; basis (n_taps <= 3*hop, 2*n_bins), the windowed DFT, real
    columns then imaginary; mel_fb (n_bins, M). Returns (B, n_blocks - 2,
    M) log10-mel, frame f reading n_taps samples from block f. Has no
    backward: on the card it refuses inputs that require grad. Counts its
    kernel launches in ``stft_log_mel.launches``."""
    if audio_blocks.device.type == "cpu":
        return stft_log_mel_reference(audio_blocks, basis, mel_fb)
    _check(audio_blocks, basis, mel_fb)
    if audio_blocks.device.type != "cuda":
        raise ValueError(
            f"stft_log_mel: unsupported device {audio_blocks.device}")
    _build.refuse_grad("stft_log_mel", audio_blocks, basis, mel_fb)
    lib = _build.load("stft", _SIGNATURES)
    b, n_blocks, hop = audio_blocks.shape
    n_taps, n_bins, m = basis.shape[0], basis.shape[1] // 2, mel_fb.shape[1]
    out = torch.empty((b, n_blocks - 2, m), dtype=torch.float32,
                      device=audio_blocks.device)
    with torch.cuda.device(audio_blocks.device):
        err = lib.stft_log_mel(
            audio_blocks.data_ptr(), basis.data_ptr(), mel_fb.data_ptr(),
            out.data_ptr(), b, n_blocks * hop, n_blocks - 2, hop, n_taps,
            n_bins, m, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, "stft_log_mel")
    _launches.count(stft_log_mel)
    return out


stft_log_mel.launches = 0
