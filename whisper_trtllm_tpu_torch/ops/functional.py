"""The functional op core over parameter dicts (counterpart of
``whisper_trtllm_tpu/ops/functional.py``).

Parameter convention, shared with the JAX package: dicts with ``kernel`` of
shape ``(in, out)`` and optional ``bias`` of shape ``(out,)``; quantized
trees carry instead ``kernel_sq`` (SmoothQuant int8, with per-channel
``scale`` and per-input-channel ``smooth``), ``kernel_q`` (weight-only
int8), ``kernel_q4`` (weight-only int4, two nibbles a byte) with
per-channel ``scale``, or ``kernel_f8`` (float8_e4m3fn) with a per-tensor
``scale`` (``whisper_trtllm_tpu_torch/quantization``).
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
from whisper_trtllm_tpu_torch.quantization.quantize import (
    divide,
    fp8_qdq_activation,
    unpack_int4_kernel,
)

# torch._int_mm on CUDA (torch 2.11.0+cu128, H100) refuses a first dim of
# 16 or less and an inner or outer dim that is not a positive multiple of
# 8, and cuBLASLt refused an inner dim of 64 (CUBLAS_STATUS_NOT_SUPPORTED);
# at tiny.en's inner dims (384 and 1536) it was exact at 17 to 6000 rows,
# for either operand row- or column-major, and inside a CUDA graph capture
_INT_MM_MIN_ROWS = 17


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf-based) GELU, Whisper's activation."""
    return F.gelu(x, approximate="none")


ACT2FN = {"gelu": gelu}


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 × (K, N) int8 → (..., N) int32, exact (a sum of K ≤
    1536 products of ±127 stays far inside int32; an fp32 product would
    round above 2^24). ``torch._int_mm`` on both devices; on the card a
    call of fewer than ``_INT_MM_MIN_ROWS`` rows is padded with zero rows,
    whose results are sliced off."""
    lead, k = a.shape[:-1], a.shape[-1]
    a2 = a.reshape(-1, k)
    m = a2.shape[0]
    if a2.is_cuda and m < _INT_MM_MIN_ROWS:
        a2 = torch.cat([a2, a2.new_zeros(_INT_MM_MIN_ROWS - m, k)])
    y = torch._int_mm(a2.contiguous(), b.contiguous())
    return y[:m].reshape(*lead, b.shape[-1])


def smooth_quant_activation(x: torch.Tensor, smooth: torch.Tensor):
    """SmoothQuant's activation side: ``x · smooth`` in ``x``'s dtype, then
    per-token int8 with a dynamic scale ``max(amax, 1e-8) / 127`` in fp32.
    Returns (int8 values, (..., 1) fp32 scales)."""
    xs = x * smooth.to(x.dtype)
    amax = xs.abs().amax(dim=-1, keepdim=True)
    act_scale = divide(torch.clamp(amax.to(torch.float32), min=1e-8), 127.0)
    xq = torch.clamp(torch.round(xs.to(torch.float32) / act_scale),
                     -127, 127).to(torch.int8)
    return xq, act_scale


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ kernel + bias`` with ``kernel`` ``(in, out)``; the quantized
    forms in the JAX package's order and with its casts:

    - SmoothQuant (``kernel_sq``): the activation smoothed and quantized
      per token (``smooth_quant_activation``), an exact int8 × int8 product
      into int32 (``int8_matmul``), then times the activation scales and
      the per-channel ``scale`` in fp32, cast to ``x``'s dtype;
    - weight-only int8 (``kernel_q``) and int4 (``kernel_q4``, unpacked):
      the kernel cast to ``x``'s dtype for the product, the per-channel
      ``scale`` applied to the result;
    - fp8 (``kernel_f8``): the activation through fp8 QDQ with its
      per-tensor scale (``fp8_qdq_activation``), the kernel cast to ``x``'s
      dtype, the product, then the per-tensor ``scale``."""
    if "kernel_sq" in params:
        xq, act_scale = smooth_quant_activation(x, params["smooth"])
        yi = int8_matmul(xq, params["kernel_sq"])
        y = (yi.to(torch.float32) * act_scale
             * params["scale"].to(torch.float32)).to(x.dtype)
    elif "kernel_q" in params:
        y = torch.matmul(x, params["kernel_q"].to(x.dtype))
        y = y * params["scale"].to(y.dtype)
    elif "kernel_q4" in params:
        y = torch.matmul(x, unpack_int4_kernel(params["kernel_q4"], x.dtype))
        y = y * params["scale"].to(y.dtype)
    elif "kernel_f8" in params:
        y = torch.matmul(fp8_qdq_activation(x),
                         params["kernel_f8"].to(x.dtype))
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
