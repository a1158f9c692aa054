"""K2: single-token masked attention against a static KV cache — the
wrapper of ``csrc/decode_attention.cu`` and its plain PyTorch version.

Counterpart of ``whisper_trtllm_tpu/ops/pallas/decode_attention.py::
decode_mha``. The wrapper takes the plain version only for CPU tensors;
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from whisper_trtllm_tpu_torch.ops.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "decode_attn": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MASK_VALUE = -1e9


def decode_attention_reference(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    valid_len,
    fp32_softmax: bool = True,
) -> torch.Tensor:
    """Plain single-token attention (``mha_decode_step``'s float dh-minor
    formula): q (B, H, 1, dh) pre-scaled, cache (B, H, T, dh), rows at or
    after the scalar ``valid_len`` masked with -1e9."""
    scores = torch.matmul(q.float(), cache_k.float().transpose(-1, -2))
    t = cache_k.shape[2]
    pos = torch.arange(t, device=q.device)
    vl = torch.as_tensor(valid_len, device=q.device)
    scores = scores.masked_fill(pos >= vl, MASK_VALUE)
    if fp32_softmax:
        weights = torch.softmax(scores, dim=-1).to(q.dtype)
    else:
        weights = torch.softmax(scores.to(q.dtype), dim=-1)
    return torch.matmul(weights, cache_v)


def _check(q, k, v, valid_len):
    if not (q.device == k.device == v.device):
        raise ValueError("decode_attn: q and the cache must lie on one device")
    if (q.dim() != 4 or q.shape[2] != 1 or k.dim() != 4 or k.shape != v.shape
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]):
        raise ValueError(
            f"decode_attn: q (B,H,1,dh), cache (B,H,T,dh); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"decode_attn: float32 or bfloat16 q/cache of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    dh = q.shape[3]
    if dh % 8 or dh > 128:
        raise ValueError(f"decode_attn: head_dim must be a multiple of 8 up "
                         f"to 128, got {dh}")
    if k.shape[2] > 53248:
        raise ValueError(f"decode_attn: cache length {k.shape[2]} exceeds "
                         f"the shared-memory score buffer (53248)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attn: q and the cache must be contiguous")
    if (not isinstance(valid_len, torch.Tensor) or valid_len.numel() != 1
            or valid_len.dtype != torch.int32 or valid_len.device != q.device):
        raise TypeError("decode_attn: valid_len must be one int32 on q's "
                        "device")


def decode_attn(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                valid_len: torch.Tensor) -> torch.Tensor:
    """q (B, H, 1, dh) pre-scaled; cache (B, H, T, dh); ``valid_len`` one
    int32 on the device, read by the kernel (no host sync). Returns
    (B, H, 1, dh) in q's dtype. Counts its kernel launches in
    ``decode_attn.launches``."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, cache_k, cache_v, valid_len)
    _check(q, cache_k, cache_v, valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn: unsupported device {q.device}")
    lib = _build.load("decode_attention", _SIGNATURES)
    b, h, t, dh = cache_k.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.decode_attn(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            valid_len.data_ptr(), out.data_ptr(), b, h, t, dh,
            _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, "decode_attn")
    decode_attn.launches += 1
    return out


decode_attn.launches = 0
