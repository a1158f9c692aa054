"""The functional op core over parameter dicts (counterpart of
``whisper_trtllm_tpu/ops/functional.py``).

Parameter convention, shared with the JAX package: dicts with ``kernel`` of
shape ``(in, out)`` and optional ``bias`` of shape ``(out,)``; weight-only
int8 trees carry ``kernel_q`` (int8) + per-output-channel ``scale`` instead.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from whisper_trtllm_tpu_torch.ops.kernels import _build
from whisper_trtllm_tpu_torch.ops.kernels.layer_norm import (
    LayerNorm,
    layer_norm as layer_norm_kernel,
)

_UNPORTED_KERNELS = ("kernel_sq", "kernel_q4", "kernel_f8")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf-based) GELU, Whisper's activation."""
    return F.gelu(x, approximate="none")


ACT2FN = {"gelu": gelu}


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ kernel + bias`` with ``kernel`` ``(in, out)``.

    Weight-only int8 (``kernel_q`` + ``scale``): the int8 kernel is cast to
    the activation dtype for the product and the per-channel scale applied
    to the result, as the JAX package does. SmoothQuant, int4 and fp8
    trees are later slices of the port."""
    for key in _UNPORTED_KERNELS:
        if key in params:
            raise NotImplementedError(
                f"dense: {key!r} weights are not ported yet")
    if "kernel_q" in params:
        y = torch.matmul(x, params["kernel_q"].to(x.dtype))
        y = y * params["scale"].to(y.dtype)
    else:
        y = torch.matmul(x, params["kernel"])
    if params.get("bias") is not None:
        y = y + params["bias"].to(y.dtype)
    return y


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics whatever the compute dtype; kernel K5
    on the card, through the differentiable ``LayerNorm`` where autograd
    records."""
    x, scale, bias = x.contiguous(), params["scale"], params.get("bias")
    if _build.needs_grad(x, scale, bias):
        return LayerNorm.apply(x, scale, bias, eps)
    return layer_norm_kernel(x, scale, bias, eps)


def embedding(table, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """Token embedding gather. ``table`` may be the int8 dict
    ``{"table_q", "scale"}``: the gathered rows dequantize on the fly."""
    ids = ids.long()
    if isinstance(table, dict):
        rows = table["table_q"][ids]
        scale = table["scale"][ids][..., None]
        out = rows.to(scale.dtype) * scale
    else:
        out = table[ids]
    return out.to(dtype) if dtype is not None else out


def sinusoid_position_embedding(length: int, channels: int) -> np.ndarray:
    """Whisper encoder sinusoids: first half sin, second half cos, with
    log-timescale increment ln(10000)/(channels//2 - 1)."""
    if channels % 2:
        raise ValueError(f"channels must be even, got {channels}")
    log_timescale_increment = math.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)],
                          axis=1).astype(np.float32)


def conv1d(params: dict, x: torch.Tensor, stride: int = 1,
           padding: int = 1) -> torch.Tensor:
    """1-D convolution over time-major input ``(B, T, C_in)`` with kernel
    ``(K, C_in, C_out)``; returns ``(B, T', C_out)``."""
    w = params["kernel"].permute(2, 1, 0)                 # (C_out, C_in, K)
    y = F.conv1d(x.transpose(1, 2), w, stride=stride, padding=padding)
    y = y.transpose(1, 2)
    if params.get("bias") is not None:
        y = y + params["bias"].to(y.dtype)
    return y
