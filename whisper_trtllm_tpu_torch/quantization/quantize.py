"""Weight-only int8 quantization at load time (counterpart of
``whisper_trtllm_tpu/quantization/quantize.py``: ``quantize_kernel``,
``dequantize_kernel``, ``quantize_dense_params``, ``weight_only_quantize``,
``quantize_embedding``, ``quantize_vocab_embedding``).

The load-time math stays in numpy, as in the JAX package, so the int8
values and the fp32 scales come out bit-equal to its own. Leaves may be
numpy arrays or tensors on any device; the rewritten projections are numpy
and the session places them (``utils/checkpoint.py::params_from_numpy``).
``ops/functional.py::dense`` dispatches on ``kernel_q``, so a quantized
tree runs unchanged. int4, fp8 and SmoothQuant are later slices.
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


def quantize_dense_params(p: dict) -> dict:
    """{'kernel', 'bias'?} → {'kernel_q', 'scale', 'bias'?}; a stacked
    (L, in, out) kernel is quantized layer by layer; other ranks are left
    as they are."""
    kernel = to_numpy(p["kernel"])
    if kernel.ndim == 2:
        q, s = quantize_kernel(kernel)
    elif kernel.ndim == 3:
        qs, ss = zip(*(quantize_kernel(k) for k in kernel))
        q, s = np.stack(qs), np.stack(ss)
    else:
        return dict(p)
    out = {"kernel_q": q, "scale": s}
    if "bias" in p:
        out["bias"] = to_numpy(p["bias"])
    return out


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
    keys = frozenset(keys)

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for name, sub in tree.items():
            if (name in keys and isinstance(sub, dict) and "kernel" in sub
                    and sub["kernel"].ndim in (2, 3)):
                out[name] = quantize_dense_params(sub)
            else:
                out[name] = walk(sub)
        return out

    return walk(params)


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
