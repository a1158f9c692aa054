"""K7: one decode token's cross attention against a head-contiguous cache
— the wrapper of ``csrc/cross_attention.cu`` and its plain PyTorch version.

Counterpart of ``whisper_trtllm_tpu/ops/pallas/cross_attention.py::
cross_decode_mha``, a library kernel: no model path calls it, and its
caller is the hardware check (``cli/gpu_check.py``'s ``cross_attn_kernel``).
The wrapper takes the plain version only for CPU tensors; for a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from whisper_trtllm_tpu_torch.ops.kernels import _build, _launches
from whisper_trtllm_tpu_torch.ops.kernels.decode_attention import (
    sm_count,
    split_plan,
    tile_row_bytes,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cross_decode_mha": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MASK_VALUE = -1e9
MAX_DH = 128


def cross_plan(q: torch.Tensor, heads: int, head_dim: int, t: int,
               valid_len: int):
    """The split plan of a ``cross_decode_mha`` call on the card: the rows
    it reads (``valid_len`` is known here, so only those are split; all T
    when it masks every row) over ``decode_attention.split_plan``."""
    rows = t if valid_len <= 0 else min(valid_len, t)
    return split_plan(rows, q.shape[0] * heads,
                      tile_row_bytes(head_dim, q.element_size(), False),
                      sm_count(q.device.index or 0))


def cross_decode_mha_reference(q: torch.Tensor, cache_k: torch.Tensor,
                               cache_v: torch.Tensor, heads: int,
                               head_dim: int, valid_len: int) -> torch.Tensor:
    """Plain version, ``_kernel``'s formula: per head, fp32 scores of K's
    h-th column block against q_h, rows at or past ``valid_len`` set to
    -1e9, an fp32 softmax over T, P·V in fp32 cast to V's dtype; returns
    (B, H·dh) in q's dtype."""
    b, t = cache_k.shape[0], cache_k.shape[1]
    qh = q.float().reshape(b, heads, 1, head_dim)
    k = cache_k.float().reshape(b, t, heads, head_dim).transpose(1, 2)
    v = cache_v.float().reshape(b, t, heads, head_dim).transpose(1, 2)
    scores = torch.matmul(qh, k.transpose(-1, -2))            # (B, H, 1, T)
    scores = scores.masked_fill(
        torch.arange(t, device=q.device) >= valid_len, MASK_VALUE)
    out = torch.matmul(torch.softmax(scores, dim=-1), v).to(cache_v.dtype)
    return out.reshape(b, heads * head_dim).to(q.dtype)


def _check(q, k, v, heads, head_dim):
    if not (q.device == k.device == v.device):
        raise ValueError("cross_decode_mha: q and the cache must lie on one "
                         "device")
    hd = heads * head_dim
    if (q.dim() != 2 or k.dim() != 3 or k.shape != v.shape
            or q.shape != (k.shape[0], hd) or k.shape[2] != hd):
        raise ValueError(
            f"cross_decode_mha: q (B, H*dh) and cache (B, T, H*dh) with "
            f"H*dh = {hd}; got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"cross_decode_mha: float32 or bfloat16 q and cache "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 0 < head_dim <= MAX_DH:
        raise ValueError(f"cross_decode_mha: head_dim must be 1..{MAX_DH}, "
                         f"got {head_dim}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("cross_decode_mha: q and the cache must be "
                         "contiguous")


def cross_decode_mha(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, heads: int, head_dim: int,
                     valid_len: int) -> torch.Tensor:
    """q (B, H·dh) pre-scaled; cache_k/v (B, T, H·dh), head-contiguous;
    ``valid_len`` a Python int (rows at or past it are masked; <= 0 masks
    all, which gives the mean of V). Returns (B, H·dh) in q's dtype. Has no
    backward: on the card it refuses inputs that require grad. Counts its
    kernel launches in ``cross_decode_mha.launches``."""
    valid_len = int(valid_len)
    if q.device.type == "cpu":
        return cross_decode_mha_reference(q, cache_k, cache_v, heads,
                                          head_dim, valid_len)
    _check(q, cache_k, cache_v, heads, head_dim)
    if q.device.type != "cuda":
        raise ValueError(f"cross_decode_mha: unsupported device {q.device}")
    _build.refuse_grad("cross_decode_mha", q, cache_k, cache_v)
    lib = _build.load("cross_attention", _SIGNATURES)
    b, t = cache_k.shape[0], cache_k.shape[1]
    splits, chunk, tile, stages = cross_plan(q, heads, head_dim, t,
                                             valid_len)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.cross_decode_mha(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            out.data_ptr(), b, t, heads, head_dim, min(max(valid_len, 0), t),
            _DTYPES[q.dtype], splits, chunk, tile, stages,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, "cross_decode_mha")
    _launches.count(cross_decode_mha)
    return out


cross_decode_mha.launches = 0
