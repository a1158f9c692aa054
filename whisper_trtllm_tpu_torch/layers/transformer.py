"""Transformer building blocks (counterpart of
``whisper_trtllm_tpu/layers/transformer.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from whisper_trtllm_tpu_torch.ops.functional import ACT2FN, dense


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, d) → (B, H, S, dh), a strided view."""
    b, s, d = x.shape
    return x.reshape(b, s, heads, d // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, dh) → (B, S, d)."""
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def attention_qkv(
    params: dict,
    x: torch.Tensor,
    kv_states: Optional[torch.Tensor],
    heads: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (scaled by dh**-0.5, the Whisper convention) from ``x``, k/v from
    ``kv_states`` (self-attention when None); each (B, H, S, dh). A tree
    from ``models/whisper/model.py::fuse_qkv_params`` carries one ``qkv``
    projection: one matmul instead of three in the self-attention case."""
    d = x.shape[-1]
    scale = (d // heads) ** -0.5
    if "qkv" in params and kv_states is None:
        q, k, v = dense(params["qkv"], x).split(d, dim=-1)
        return (split_heads(q * scale, heads), split_heads(k, heads),
                split_heads(v, heads))
    kv = x if kv_states is None else kv_states
    q = split_heads(dense(params["q"], x) * scale, heads)
    k = split_heads(dense(params["k"], kv), heads)
    v = split_heads(dense(params["v"], kv), heads)
    return q, k, v


def mlp_block(params: dict, x: torch.Tensor,
              activation: str = "gelu") -> torch.Tensor:
    """fc1 → activation → fc2."""
    return dense(params["fc2"], ACT2FN[activation](dense(params["fc1"], x)))
