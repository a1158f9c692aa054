"""Attention ops over (B, H, S, dh) tensors (counterpart of
``whisper_trtllm_tpu/ops/attention.py``).

On a CUDA tensor every attention here runs a hand-written kernel
(``ops/kernels``) or raises: a case the kernels do not take yet is a later
slice, and never falls through to the plain formula on the card. On a CPU
tensor the plain formulas serve every case.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from whisper_trtllm_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_reference,
    decode_attn,
)
from whisper_trtllm_tpu_torch.ops.kernels.flash_attention import (
    attention_reference,
    flash_fwd,
)


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    fp32_softmax: bool = True,
) -> torch.Tensor:
    """Full-sequence attention. q: (B, H, S, dh) pre-scaled by dh**-0.5;
    k, v: (B, Hkv, T, dh) with Hkv | H; ``mask`` additive, broadcastable
    to (B, H, S, T).

    The bidirectional unmasked case (the encoder's) goes to kernel K1
    under the JAX package's conditions; on the card K1 also needs
    dh <= 128."""
    h, s, dh = q.shape[1], q.shape[2], q.shape[3]
    if (mask is None and h % k.shape[1] == 0 and s > 1 and dh % 8 == 0
            and not causal):
        return flash_fwd(q.contiguous(), k.contiguous(), v.contiguous())
    if q.is_cuda:
        raise NotImplementedError(
            "mha on CUDA runs only the flash kernel's case (no mask, S > 1, "
            "dh % 8 == 0, bidirectional); masked, causal and single-row "
            "attention on the card are later slices")
    return attention_reference(q, k, v, causal=causal, mask=mask,
                               fp32_softmax=fp32_softmax)


def init_kv_cache(batch: int, heads: int, max_len: int, head_dim: int,
                  dtype=torch.float32, device="cpu"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Preallocated static KV cache (B, H, max_len, dh) ×2."""
    shape = (batch, heads, max_len, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def update_kv_cache(
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write the step's K/V (B, H, 1, dh) at row ``pos`` of the caches.

    Unlike the JAX version, which returns updated arrays, this writes IN
    PLACE into the preallocated caches (and into the stacked (L, ...)
    tensor they may be views of) and returns them. ``pos`` is a scalar,
    an int or a 0-d tensor (lockstep batch); per-lane positions are a
    later slice."""
    idx = torch.as_tensor(pos, device=cache_k.device)
    if idx.dim() != 0:
        raise NotImplementedError("per-lane cache positions are not ported yet")
    idx = idx.long().reshape(1)
    cache_k.index_copy_(2, idx, k_new.to(cache_k.dtype))
    cache_v.index_copy_(2, idx, v_new.to(cache_v.dtype))
    return cache_k, cache_v


def mha_decode_step(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    valid_len,
    fp32_softmax: bool = True,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    t_major: bool = False,
) -> torch.Tensor:
    """Single-token attention against a static cache: q (B, H, 1, dh);
    cache (B, H, Tmax, dh); ``valid_len`` a scalar count of valid rows
    (pos + 1 for self attention, the encoder length for cross attention).

    The float dh-minor path with fp32 softmax goes to kernel K2. int8/fp8
    caches (``k_scale``/``v_scale``), the T-minor layout, per-lane
    ``valid_len`` and ``bias`` are later slices and raise."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("quantized KV caches are not ported yet")
    if t_major:
        raise NotImplementedError("the T-minor cache layout is not ported yet")
    if bias is not None:
        raise NotImplementedError("attention bias is not ported yet")
    valid_len = torch.as_tensor(valid_len, dtype=torch.int32, device=q.device)
    if valid_len.dim() != 0:
        raise NotImplementedError("per-lane valid_len is not ported yet")
    if fp32_softmax:
        return decode_attn(q, cache_k, cache_v, valid_len)
    if q.is_cuda:
        raise NotImplementedError(
            "decode attention on CUDA takes its softmax in fp32 only")
    return decode_attention_reference(q, cache_k, cache_v, valid_len,
                                      fp32_softmax=False)
