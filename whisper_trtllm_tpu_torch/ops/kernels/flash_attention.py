"""K1: fused attention forward — the wrapper of ``csrc/flash_attention.cu``
and its plain PyTorch version.

Counterpart of ``whisper_trtllm_tpu/ops/pallas/flash_attention.py::flash_mha``
(forward). The wrapper takes the plain version only for CPU tensors; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from whisper_trtllm_tpu_torch.ops.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "flash_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MASK_VALUE = -1e9


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
    fp32_softmax: bool = True,
) -> torch.Tensor:
    """Plain full-sequence attention (``ops/attention.py::mha``'s formula).
    q (B, H, S, dh) pre-scaled; k, v (B, Hkv, T, dh) with Hkv | H; fp32
    scores; ``mask`` is additive; causal masks col > row + (T - S)."""
    h, s = q.shape[1], q.shape[2]
    hkv = k.shape[1]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if causal:
        t = k.shape[2]
        keep = torch.ones(s, t, dtype=torch.bool, device=q.device).tril(t - s)
        scores = scores.masked_fill(~keep, MASK_VALUE)
    if mask is not None:
        scores = scores + mask.float()
    if fp32_softmax:
        weights = torch.softmax(scores, dim=-1).to(q.dtype)
    else:
        weights = torch.softmax(scores.to(q.dtype), dim=-1)
    return torch.matmul(weights, v)


def _check(q, k, v, causal):
    if not (q.device == k.device == v.device):
        raise ValueError("flash_fwd: q, k, v must lie on one device")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_fwd: q (B,H,S,dh), k/v (B,Hkv,T,dh); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[1]:
        raise ValueError(
            f"flash_fwd: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if causal and s != k.shape[2]:
        raise ValueError("flash_fwd: causal needs S == T")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"flash_fwd: float32 or bfloat16 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if dh % 8 or dh > 128:
        raise ValueError(f"flash_fwd: head_dim must be a multiple of 8 up "
                         f"to 128, got {dh}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd: q, k, v must be contiguous")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False) -> torch.Tensor:
    """Fused attention; q (B, H, S, dh) pre-scaled, k/v (B, Hkv, T, dh).
    Returns (B, H, S, dh) in q's dtype. Counts its kernel launches in
    ``flash_fwd.launches``."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal)
    _check(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    lib = _build.load("flash_attention", _SIGNATURES)
    b, h, s, dh = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, k.shape[1], s, k.shape[2], dh, int(causal),
            _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, "flash_fwd")
    flash_fwd.launches += 1
    return out


flash_fwd.launches = 0
