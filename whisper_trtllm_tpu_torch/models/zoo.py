"""What the causal-LM zoo's models (``models/{gpt,opt,llama,gptj,
gptneox,bloom,chatglm6b}``) share: the stacked layer trees, the head split
and merge, the tied fp32 vocab head, and the device and dtype of a
generate call."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from whisper_trtllm_tpu_torch.utils.device import resolve_device, to_tensor


def stack(trees: list) -> dict:
    """Identically shaped dict trees of numpy arrays stacked along a new
    leading (layer) axis."""
    if isinstance(trees[0], dict):
        return {k: stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees, axis=0)


def layer(tree, i: int):
    """Layer ``i`` of a stacked (L, ...) tree, as views."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def split_heads(t: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """(B, S, heads · head_dim) → (B, heads, S, head_dim)."""
    b, s, _ = t.shape
    return t.reshape(b, s, heads, head_dim).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, H, S, dh) → (B, S, H · dh)."""
    b, h, s, dh = t.shape
    return t.transpose(1, 2).reshape(b, s, h * dh)


def tied_logits(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (..., d) against the (V, d) table in x's dtype, summed in fp32:
    fp32 logits (..., V), as the JAX einsum with an fp32 accumulator."""
    return torch.matmul(x.float(), table.to(x.dtype).float().t())


def write_prefix(cache: torch.Tensor, new: torch.Tensor) -> None:
    """One layer's cache (B, H, T, dh) takes ``new`` (B, H, S, dh) at rows
    [0, S), in place."""
    cache[:, :, :new.shape[2]].copy_(new)


def position_rows(table: torch.Tensor, pos: torch.Tensor,
                  offset: int = 0) -> torch.Tensor:
    """Rows ``pos + offset`` of a position table as a (B or 1, 1, d) term:
    ``pos`` 0-d (one row for the batch) or (B,) (one a lane); read on the
    device."""
    idx = pos.long() + offset
    if idx.dim() == 1:
        return table.index_select(0, idx)[:, None]
    return table.index_select(0, idx.reshape(1))[None]


def params_device(params: dict) -> torch.device:
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.device


def prepare(params: dict, prompt, device=None
            ) -> Tuple[torch.Tensor, torch.dtype]:
    """(the prompt as int32 on ``device``, the compute dtype) for a
    generate call on ``device`` (the CUDA card by default), where the
    parameters must already lie; the compute dtype is the parameters'
    float dtype (a tree holds one: ``params_from_numpy`` casts them all)."""
    dev = resolve_device(device)
    have = params_device(params)
    if have.type != dev.type:
        raise ValueError(f"params lie on {have}, not on {dev}")
    todo = [params]
    dtype = torch.float32
    while todo:
        t = todo.pop()
        if isinstance(t, dict):
            todo.extend(t.values())
        elif t.is_floating_point() and t.element_size() > 1:
            dtype = t.dtype
            break
    return to_tensor(prompt, have, torch.int32), dtype
