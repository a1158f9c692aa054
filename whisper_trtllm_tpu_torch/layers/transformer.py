"""Transformer building blocks (counterpart of
``whisper_trtllm_tpu/layers/transformer.py``).

On a tree cut over the model axis (``parallel/partition.py``) a rank holds
its heads of q/k/v and its columns of fc1, so it runs the attention at its
local head count, with the head dim from the config; ``row_dense`` then
all-reduces the row-parallel projections' partial sums over the model
axis's ``group`` and adds their bias once, after the sum.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from whisper_trtllm_tpu_torch.ops.functional import ACT2FN, dense
from whisper_trtllm_tpu_torch.parallel.collectives import reduce_from_model


def split_heads(x: torch.Tensor, heads: int,
                head_dim: Optional[int] = None) -> torch.Tensor:
    """(B, S, heads·dh) → (B, H, S, dh), a strided view; ``head_dim``
    defaults to the width over ``heads`` (a rank with no heads gives it)."""
    b, s, d = x.shape
    dh = head_dim or d // heads
    return x.reshape(b, s, heads, dh).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, dh) → (B, S, d)."""
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def attention_qkv(
    params: dict,
    x: torch.Tensor,
    kv_states: Optional[torch.Tensor],
    heads: int,
    head_dim: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (scaled by dh**-0.5, the Whisper convention) from ``x``, k/v from
    ``kv_states`` (self-attention when None); each (B, H, S, dh), ``heads``
    the projections' head count (this rank's on a cut tree) and
    ``head_dim`` dh (default: the input width over ``heads``). A tree from
    ``models/whisper/model.py::fuse_qkv_params`` carries one ``qkv``
    projection: one matmul instead of three in the self-attention case."""
    dh = head_dim or x.shape[-1] // heads
    scale = dh ** -0.5
    if "qkv" in params and kv_states is None:
        q, k, v = dense(params["qkv"], x).split(heads * dh, dim=-1)
        return (split_heads(q * scale, heads, dh), split_heads(k, heads, dh),
                split_heads(v, heads, dh))
    kv = x if kv_states is None else kv_states
    q = split_heads(dense(params["q"], x) * scale, heads, dh)
    k = split_heads(dense(params["k"], kv), heads, dh)
    v = split_heads(dense(params["v"], kv), heads, dh)
    return q, k, v


def row_dense(params: dict, x: torch.Tensor, group=None) -> torch.Tensor:
    """A row-parallel projection: ``dense`` without its bias on this rank's
    input columns, the partial sums all-reduced over the model axis
    (``group``; None: one rank, plain ``dense``), then the bias, once."""
    if group is None:
        return dense(params, x)
    y = reduce_from_model(
        dense({k: v for k, v in params.items() if k != "bias"}, x), group)
    if params.get("bias") is not None:
        y = y + params["bias"].to(y.dtype)
    return y


def mlp_block(params: dict, x: torch.Tensor, activation: str = "gelu",
              group=None) -> torch.Tensor:
    """fc1 → activation → fc2 (row-parallel over ``group``)."""
    return row_dense(params["fc2"],
                     ACT2FN[activation](dense(params["fc1"], x)), group)
