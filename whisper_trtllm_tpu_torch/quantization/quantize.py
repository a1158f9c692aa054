"""Weight quantization at load time (counterpart of
``whisper_trtllm_tpu/quantization/quantize.py``): int8 weight-only
(``kernel_q``), int4 weight-only (``kernel_q4``, two nibbles a byte), fp8
storage with activation QDQ (``kernel_f8``), and the int8 vocab table.

The load-time math stays in numpy, as in the JAX package, so the int8 and
int4 values and the fp32 scales come out bit-equal to its own. numpy has
no float8 type here (no ``ml_dtypes``), so the fp8 kernels are CPU
``torch.float8_e4m3fn`` tensors cast by torch from the same fp32 values:
inside ±448, the only range the amax / 448 scaling makes, torch's cast and
``ml_dtypes``'s round alike (to nearest, ties to even). Leaves may be numpy
arrays or tensors on any device; the rewritten projections are host
arrays or tensors and the session places them
(``utils/checkpoint.py::params_from_numpy``). ``ops/functional.py::dense``
dispatches on the kernel's key, so a quantized tree runs unchanged.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from whisper_trtllm_tpu_torch.utils.device import to_numpy


def quantize_kernel(kernel) -> Tuple[np.ndarray, np.ndarray]:
    """(in, out) float → (int8 kernel, (out,) fp32 per-output-channel
    scales): symmetric, amax / 127, round half to even, clip to ±127."""
    kernel = np.asarray(to_numpy(kernel), np.float32)
    amax = np.maximum(np.abs(kernel).max(axis=0), 1e-8)
    scale = (amax / 127.0).astype(np.float32)
    q = np.clip(np.round(kernel / scale[None, :]), -127, 127).astype(np.int8)
    return q, scale


def dequantize_kernel(kernel_q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """int8 kernel (..., in, out) × per-channel scales (..., out) →
    ``dtype``; a stacked (L, in, out) kernel takes (L, out) scales."""
    return kernel_q.to(dtype) * scale.to(dtype).unsqueeze(-2)


def _rewrite(params: dict, keys: Iterable[str], quantize, even_out=False
             ) -> dict:
    """Rewrite every dense projection subtree (2-D or stacked 3-D
    ``kernel``; with ``even_out`` only an even output dim) whose dict key is
    in ``keys`` through ``quantize``."""
    keys = frozenset(keys)

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for name, sub in tree.items():
            if (name in keys and isinstance(sub, dict) and "kernel" in sub
                    and sub["kernel"].ndim in (2, 3)
                    and not (even_out and sub["kernel"].shape[-1] % 2)):
                out[name] = quantize(sub)
            else:
                out[name] = walk(sub)
        return out

    return walk(params)


def _per_layer(p: dict, quantize, key: str) -> dict:
    """{'kernel', 'bias'?} → {key, 'scale', 'bias'?}: a 2-D kernel through
    ``quantize``, a stacked (L, in, out) one layer by layer; other ranks
    are left as they are."""
    kernel = to_numpy(p["kernel"])
    if kernel.ndim == 2:
        q, s = quantize(kernel)
    elif kernel.ndim == 3:
        qs, ss = zip(*(quantize(k) for k in kernel))
        stack = torch.stack if isinstance(qs[0], torch.Tensor) else np.stack
        q, s = stack(qs), np.stack(ss)
    else:
        return dict(p)
    out = {key: q, "scale": s}
    if "bias" in p:
        out["bias"] = to_numpy(p["bias"])
    return out


def quantize_dense_params(p: dict) -> dict:
    """{'kernel', 'bias'?} → {'kernel_q', 'scale', 'bias'?}; a stacked
    (L, in, out) kernel is quantized layer by layer; other ranks are left
    as they are."""
    return _per_layer(p, quantize_kernel, "kernel_q")


_DENSE_KEYS = frozenset({
    "q", "k", "v", "out", "qkv", "fc1", "fc2",    # whisper layers
    "attn_qkv", "attn_out", "fc_in", "fc_out",    # gpt/bert layers
    "o", "gate", "up", "down",                    # llama layers
    "pooler",
})


def weight_only_quantize(params: dict,
                         keys: Iterable[str] = _DENSE_KEYS) -> dict:
    """Rewrite a model tree, quantizing every dense projection subtree
    (2-D or stacked 3-D ``kernel``) whose dict key is in ``keys``."""
    return _rewrite(params, keys, quantize_dense_params)


def quantize_kernel_int4(kernel) -> Tuple[np.ndarray, np.ndarray]:
    """(in, out) float → (packed int4 kernel (in, out // 2) int8, (out,)
    fp32 scales): symmetric per channel, amax / 7, round half to even,
    clip to [-8, 7]; output column 2j in the low nibble of byte j, 2j + 1
    in the high one."""
    kernel = np.asarray(to_numpy(kernel), np.float32)
    if kernel.shape[1] % 2:
        raise ValueError("output dim must be even to pack int4")
    amax = np.maximum(np.abs(kernel).max(axis=0), 1e-8)
    scale = (amax / 7.0).astype(np.float32)
    q = np.clip(np.round(kernel / scale[None, :]), -8, 7).astype(np.int8)
    low = q[:, 0::2] & 0x0F
    high = (q[:, 1::2] & 0x0F) << 4
    return (low | high).astype(np.int8), scale


def unpack_int4_kernel(packed: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    """(..., in, out // 2) int8 → (..., in, out) in ``dtype``, the unscaled
    nibble values: the low nibble sign-extended by a shift left by 4 and an
    arithmetic shift right by 4, the high one by the arithmetic shift."""
    p = packed.to(torch.int8)
    low = (p << 4) >> 4
    high = p >> 4
    inter = torch.stack([low, high], dim=-1)           # (..., out // 2, 2)
    return inter.reshape(*p.shape[:-1], -1).to(dtype)


def quantize_dense_params_int4(p: dict) -> dict:
    """{'kernel', 'bias'?} → {'kernel_q4', 'scale', 'bias'?}."""
    return _per_layer(p, quantize_kernel_int4, "kernel_q4")


def weight_only_quantize_int4(params: dict,
                              keys: Iterable[str] = _DENSE_KEYS) -> dict:
    """The int4 form of ``weight_only_quantize``; a projection with an odd
    output dim stays float."""
    return _rewrite(params, keys, quantize_dense_params_int4, even_out=True)


FP8_MAX = 448.0      # float8_e4m3fn's largest finite value


def divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, on every device. On CUDA torch turns a
    division by a Python number into a product with its reciprocal, and
    1/448 or 1/127 is inexact, so that product can land one bit off the
    CPU's quotient (and the JAX package's); a divisor on the device keeps
    the true division, with no host copy inside a graph capture."""
    return x / torch.full_like(x, d)


def quantize_kernel_fp8(kernel) -> Tuple[torch.Tensor, np.float32]:
    """(in, out) float → (float8_e4m3fn kernel, a 0-d fp32 per-tensor
    scale, amax / 448, so that the cast never saturates)."""
    kernel = np.asarray(to_numpy(kernel), np.float32)
    amax = max(float(np.abs(kernel).max()), 1e-8)
    scale = np.float32(amax / FP8_MAX)
    q = torch.from_numpy(kernel / scale).to(torch.float8_e4m3fn)
    return q, scale


def fp8_qdq_activation(x: torch.Tensor) -> torch.Tensor:
    """Dynamic per-tensor QDQ of an activation through float8_e4m3fn: the
    scale is the abs-max of the whole tensor over 448, in fp32; the result
    is in ``x``'s dtype. No host read: the amax stays on the device."""
    xf = x.to(torch.float32)
    amax = torch.clamp(xf.abs().amax(), min=1e-8)
    scale = divide(amax, FP8_MAX)
    q = (xf / scale).to(torch.float8_e4m3fn)
    return (q.to(torch.float32) * scale).to(x.dtype)


def quantize_dense_params_fp8(p: dict) -> dict:
    """{'kernel', 'bias'?} → {'kernel_f8', 'scale', 'bias'?}; a stacked
    kernel's scales stack to (L,)."""
    out = _per_layer(p, quantize_kernel_fp8, "kernel_f8")
    if "kernel_f8" in out:
        out["scale"] = np.asarray(out["scale"], np.float32)
    return out


def fp8_quantize(params: dict, keys: Iterable[str] = _DENSE_KEYS) -> dict:
    """The fp8 QDQ tree rewrite (``QuantMode.FP8_QDQ``)."""
    return _rewrite(params, keys, quantize_dense_params_fp8)


def quantize_embedding(table) -> dict:
    """(V, d) float → {"table_q" int8, "scale" (V,) fp32}, symmetric per
    row: the vocab head applies the scales after its dot."""
    table = np.asarray(to_numpy(table), np.float32)
    amax = np.maximum(np.abs(table).max(axis=1), 1e-8)
    scale = (amax / 127.0).astype(np.float32)
    q = np.clip(np.round(table / scale[:, None]), -127, 127).astype(np.int8)
    return {"table_q": q, "scale": scale}


def quantize_vocab_embedding(params: dict) -> dict:
    """Whisper-tree rewrite: decoder.embed_tokens → the int8 dict."""
    dec = dict(params["decoder"])
    dec["embed_tokens"] = quantize_embedding(dec["embed_tokens"])
    return {**params, "decoder": dec}


def dequantize_params(params: dict, dtype=torch.float32) -> dict:
    """The inverse rewrite on a tree of tensors: every ``kernel_q`` +
    ``scale`` projection → ``kernel = kernel_q · scale`` and an int8 vocab
    table → ``table_q · scale[:, None]``, in ``dtype``. Quantizing the
    fp32 result again gives back the int8 values and scales bit for bit
    (the largest entry of each channel is ±127 · scale), which is how the
    committed int8 artifact yields a float-weight tree with no download."""
    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        if "kernel_q" in tree:
            out = {"kernel": dequantize_kernel(tree["kernel_q"], tree["scale"],
                                               dtype)}
            if "bias" in tree:
                out["bias"] = tree["bias"]
            return out
        if "table_q" in tree:
            return (tree["table_q"].to(dtype)
                    * tree["scale"].to(dtype)[:, None])
        return {k: walk(v) for k, v in tree.items()}

    return walk(params)
