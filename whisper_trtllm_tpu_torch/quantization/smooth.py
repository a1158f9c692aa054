"""SmoothQuant for the Whisper model (counterpart of the Whisper half of
``whisper_trtllm_tpu/quantization/smooth.py``: ``whisper_act_stats``,
``_smooth_factors``, ``_sq_dense``, ``smooth_quantize_whisper``).

Per input channel j of a projection W, ``s_j = amax_act_j ** alpha /
amax_w_j ** (1 - alpha)``; the rewritten projection keeps ``diag(s) W``
as int8 with per-output-channel scales (``kernel_sq``, ``scale``) and
``1 / s`` as ``smooth``, which ``ops/functional.py::dense`` multiplies the
activation by before quantizing it per token to int8. The product is
int8 × int8 into int32.

The calibration pass (``whisper_act_stats``) runs the port's own encoder
and teacher-forced decoder once and records the abs-max of every dense
input, per layer: on the card its attention goes through
``ops/attention.py::mha``'s dispatch (the flash kernel where the JAX
package takes flash). The factors and the int8 tree are computed in numpy
on the host, as in the JAX package, so a tree made from the same stats is
bit-equal to its own. The model modules are imported inside the pass:
``ops/functional.py`` imports this package for its quantized branches.
"""

from __future__ import annotations

import numpy as np
import torch

from whisper_trtllm_tpu_torch.config import WhisperConfig
from whisper_trtllm_tpu_torch.quantization.quantize import quantize_kernel
from whisper_trtllm_tpu_torch.utils.device import to_numpy, to_tensor


def _amax(x: torch.Tensor) -> torch.Tensor:
    """(B, S, d) → (d,) abs-max over batch and positions."""
    return x.abs().amax(dim=(0, 1))


def _encoder_stats(params: dict, cfg: WhisperConfig, mel: torch.Tensor):
    """``models.whisper.encode``'s math, recording each dense's input
    amax a layer."""
    from whisper_trtllm_tpu_torch.layers.transformer import (
        attention_qkv,
        merge_heads,
    )
    from whisper_trtllm_tpu_torch.models.whisper.model import layer
    from whisper_trtllm_tpu_torch.ops.attention import mha
    from whisper_trtllm_tpu_torch.ops.functional import (
        conv1d,
        dense,
        gelu,
        layer_norm,
    )

    enc = params["encoder"]
    x = gelu(conv1d(enc["conv1"], mel, stride=1, padding=1))
    x = gelu(conv1d(enc["conv2"], x, stride=2, padding=1))
    x = x + enc["embed_positions"].to(x.dtype)[None]
    heads = cfg.encoder_attention_heads
    stats = []
    for i in range(cfg.encoder_layers):
        lp = layer(enc["layers"], i)
        h = layer_norm(lp["self_attn_layer_norm"], x)
        q, k, v = attention_qkv(lp["self_attn"], h, None, heads)
        a = merge_heads(mha(q, k, v, causal=False))
        x = x + dense(lp["self_attn"]["out"], a)
        h2 = layer_norm(lp["final_layer_norm"], x)
        mid = gelu(dense(lp["fc1"], h2))
        x = x + dense(lp["fc2"], mid)
        stats.append({"attn_in": _amax(h), "attn_out_in": _amax(a),
                      "fc1_in": _amax(h2), "fc2_in": _amax(mid)})
    return layer_norm(enc["layer_norm"], x), stats


def _decoder_stats(params: dict, cfg: WhisperConfig, tokens: torch.Tensor,
                   enc_states: torch.Tensor):
    from whisper_trtllm_tpu_torch.layers.transformer import (
        attention_qkv,
        merge_heads,
    )
    from whisper_trtllm_tpu_torch.models.whisper.model import layer
    from whisper_trtllm_tpu_torch.ops.attention import mha
    from whisper_trtllm_tpu_torch.ops.functional import (
        dense,
        embedding,
        gelu,
        layer_norm,
    )

    dec = params["decoder"]
    s = tokens.shape[1]
    x = embedding(dec["embed_tokens"], tokens, dtype=enc_states.dtype)
    x = x + dec["embed_positions"][:s].to(x.dtype)[None]
    heads = cfg.decoder_attention_heads
    stats = []
    for i in range(cfg.decoder_layers):
        lp = layer(dec["layers"], i)
        h = layer_norm(lp["self_attn_layer_norm"], x)
        q, k, v = attention_qkv(lp["self_attn"], h, None, heads)
        a = merge_heads(mha(q, k, v, causal=True))
        x = x + dense(lp["self_attn"]["out"], a)
        hc = layer_norm(lp["encoder_attn_layer_norm"], x)
        q, k, v = attention_qkv(lp["encoder_attn"], hc, enc_states, heads)
        ac = merge_heads(mha(q, k, v, causal=False))
        x = x + dense(lp["encoder_attn"]["out"], ac)
        h2 = layer_norm(lp["final_layer_norm"], x)
        mid = gelu(dense(lp["fc1"], h2))
        x = x + dense(lp["fc2"], mid)
        stats.append({"attn_in": _amax(h), "attn_out_in": _amax(a),
                      "cross_in": _amax(hc), "cross_kv_in": _amax(enc_states),
                      "cross_out_in": _amax(ac),
                      "fc1_in": _amax(h2), "fc2_in": _amax(mid)})
    return stats


def _stacked(stats: list) -> dict:
    """A list of per-layer dicts of (d,) tensors → {name: (L, d) numpy}."""
    return {k: np.stack([to_numpy(s[k]) for s in stats]) for k in stats[0]}


@torch.inference_mode()
def whisper_act_stats(params: dict, cfg: WhisperConfig, mel,
                      tokens) -> dict:
    """Calibration pass: per-layer (L, d_in) abs-max (numpy) of every dense
    input, for a calibration batch of mels (B, 3000, M) and teacher-forcing
    token prefixes (B, S), run on the weights' device."""
    conv1 = params["encoder"]["conv1"]["kernel"]
    mel = to_tensor(mel, conv1.device, conv1.dtype)
    tokens = to_tensor(tokens, conv1.device)
    enc_states, enc_stats = _encoder_stats(params, cfg, mel)
    dec_stats = _decoder_stats(params, cfg, tokens, enc_states)
    return {"encoder": _stacked(enc_stats), "decoder": _stacked(dec_stats)}


def _smooth_factors(w: np.ndarray, act_amax: np.ndarray,
                    alpha: float) -> np.ndarray:
    """w (d_in, d_out), act_amax (d_in,) → s (d_in,)."""
    w_amax = np.maximum(np.abs(w).max(axis=-1), 1e-8)
    s = (np.power(np.maximum(act_amax, 1e-8), alpha)
         / np.power(w_amax, 1.0 - alpha))
    return np.clip(s, 1e-4, 1e4).astype(np.float32)


def _sq_dense(p: dict, act_amax_l: np.ndarray, alpha: float) -> dict:
    """Per-layer-stacked dense {kernel (L, din, dout)} + (L, din) stats →
    {kernel_sq int8, scale (L, dout), smooth (L, din), bias?}."""
    kernel = np.asarray(to_numpy(p["kernel"]), np.float32)
    qs, scales, smooths = [], [], []
    for li in range(kernel.shape[0]):
        s = _smooth_factors(kernel[li], act_amax_l[li], alpha)
        q, sc = quantize_kernel(kernel[li] * s[:, None])
        qs.append(q)
        scales.append(sc)
        smooths.append(1.0 / s)
    out = {"kernel_sq": np.stack(qs), "scale": np.stack(scales),
           "smooth": np.stack(smooths).astype(np.float32)}
    if "bias" in p:
        out["bias"] = to_numpy(p["bias"])
    return out


def smooth_quantize_whisper(params: dict, stats: dict,
                            alpha: float = 0.5) -> dict:
    """Rewrite the Whisper tree with SmoothQuant projections
    (``QuantMode.SMOOTH_QUANT``). The conv stem, embeddings, LayerNorms and
    the tied vocab head stay floating point; the rewritten projections are
    numpy, and a session places them."""
    enc_layers = dict(params["encoder"]["layers"])
    est = stats["encoder"]
    enc_attn = dict(enc_layers["self_attn"])
    for k in ("q", "k", "v"):
        enc_attn[k] = _sq_dense(enc_attn[k], est["attn_in"], alpha)
    enc_attn["out"] = _sq_dense(enc_attn["out"], est["attn_out_in"], alpha)
    enc_layers["self_attn"] = enc_attn
    enc_layers["fc1"] = _sq_dense(enc_layers["fc1"], est["fc1_in"], alpha)
    enc_layers["fc2"] = _sq_dense(enc_layers["fc2"], est["fc2_in"], alpha)

    dec_layers = dict(params["decoder"]["layers"])
    dst = stats["decoder"]
    dec_self = dict(dec_layers["self_attn"])
    for k in ("q", "k", "v"):
        dec_self[k] = _sq_dense(dec_self[k], dst["attn_in"], alpha)
    dec_self["out"] = _sq_dense(dec_self["out"], dst["attn_out_in"], alpha)
    dec_layers["self_attn"] = dec_self
    dec_cross = dict(dec_layers["encoder_attn"])
    dec_cross["q"] = _sq_dense(dec_cross["q"], dst["cross_in"], alpha)
    for k in ("k", "v"):
        dec_cross[k] = _sq_dense(dec_cross[k], dst["cross_kv_in"], alpha)
    dec_cross["out"] = _sq_dense(dec_cross["out"], dst["cross_out_in"], alpha)
    dec_layers["encoder_attn"] = dec_cross
    dec_layers["fc1"] = _sq_dense(dec_layers["fc1"], dst["fc1_in"], alpha)
    dec_layers["fc2"] = _sq_dense(dec_layers["fc2"], dst["fc2_in"], alpha)

    return {"encoder": {**params["encoder"], "layers": enc_layers},
            "decoder": {**params["decoder"], "layers": dec_layers}}
