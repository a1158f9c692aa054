"""HF Whisper checkpoint ↔ the parameter tree (counterpart of
``whisper_trtllm_tpu/models/whisper/convert.py``).

Torch ``Linear`` weights (out, in) become (in, out) kernels; ``Conv1d``
weights (out, in, k) become (k, in, out); per-layer tensors are stacked
along a leading L axis, with numpy. ``proj_out`` is tied to
``embed_tokens``, so only the table is kept. ``transformers`` is imported
only by ``load_pretrained``, so the module imports where it is absent.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from whisper_trtllm_tpu_torch.config import WhisperConfig
from whisper_trtllm_tpu_torch.models.whisper.model import _stack, layer
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy
from whisper_trtllm_tpu_torch.utils.device import resolve_device, to_numpy


def _dense(sd: Dict[str, Any], prefix: str) -> dict:
    p = {"kernel": np.ascontiguousarray(to_numpy(sd[prefix + ".weight"]).T)}
    if prefix + ".bias" in sd:
        p["bias"] = to_numpy(sd[prefix + ".bias"])
    return p


def _ln(sd: Dict[str, Any], prefix: str) -> dict:
    return {"scale": to_numpy(sd[prefix + ".weight"]),
            "bias": to_numpy(sd[prefix + ".bias"])}


def _attn(sd: Dict[str, Any], prefix: str) -> dict:
    return {
        "q": _dense(sd, prefix + ".q_proj"),
        "k": _dense(sd, prefix + ".k_proj"),   # no bias in Whisper
        "v": _dense(sd, prefix + ".v_proj"),
        "out": _dense(sd, prefix + ".out_proj"),
    }


def _conv1d(sd: Dict[str, Any], prefix: str) -> dict:
    w = to_numpy(sd[prefix + ".weight"])  # (out, in, k)
    return {"kernel": np.ascontiguousarray(w.transpose(2, 1, 0)),
            "bias": to_numpy(sd[prefix + ".bias"])}


def convert_state_dict(sd: Dict[str, Any], cfg: WhisperConfig) -> dict:
    """A raw HF state dict (torch tensors or numpy) → the parameter tree in
    numpy."""
    enc_layers = []
    for i in range(cfg.encoder_layers):
        p = f"model.encoder.layers.{i}"
        enc_layers.append({
            "self_attn": _attn(sd, p + ".self_attn"),
            "self_attn_layer_norm": _ln(sd, p + ".self_attn_layer_norm"),
            "fc1": _dense(sd, p + ".fc1"),
            "fc2": _dense(sd, p + ".fc2"),
            "final_layer_norm": _ln(sd, p + ".final_layer_norm"),
        })
    dec_layers = []
    for i in range(cfg.decoder_layers):
        p = f"model.decoder.layers.{i}"
        dec_layers.append({
            "self_attn": _attn(sd, p + ".self_attn"),
            "self_attn_layer_norm": _ln(sd, p + ".self_attn_layer_norm"),
            "encoder_attn": _attn(sd, p + ".encoder_attn"),
            "encoder_attn_layer_norm": _ln(sd, p + ".encoder_attn_layer_norm"),
            "fc1": _dense(sd, p + ".fc1"),
            "fc2": _dense(sd, p + ".fc2"),
            "final_layer_norm": _ln(sd, p + ".final_layer_norm"),
        })
    return {
        "encoder": {
            "conv1": _conv1d(sd, "model.encoder.conv1"),
            "conv2": _conv1d(sd, "model.encoder.conv2"),
            "embed_positions": to_numpy(
                sd["model.encoder.embed_positions.weight"]),
            "layers": _stack(enc_layers),
            "layer_norm": _ln(sd, "model.encoder.layer_norm"),
        },
        "decoder": {
            "embed_tokens": to_numpy(sd["model.decoder.embed_tokens.weight"]),
            "embed_positions": to_numpy(
                sd["model.decoder.embed_positions.weight"]),
            "layers": _stack(dec_layers),
            "layer_norm": _ln(sd, "model.decoder.layer_norm"),
        },
    }


def convert_hf_model(hf_model, device=None) -> Tuple[dict, WhisperConfig]:
    """A live transformers ``WhisperForConditionalGeneration`` → (the
    parameter tree as tensors on ``device``, the CUDA card by default,
    config)."""
    dev = resolve_device(device)
    cfg = WhisperConfig.from_hf(
        hf_model.config, getattr(hf_model, "generation_config", None))
    return params_from_numpy(convert_state_dict(hf_model.state_dict(), cfg),
                             dev), cfg


def load_pretrained(path: str, device=None) -> Tuple[dict, WhisperConfig]:
    """An HF checkpoint in the local directory ``path`` → (tensor tree on
    ``device``, config). Nothing is fetched from the network."""
    dev = resolve_device(device)
    from transformers import WhisperForConditionalGeneration

    hf = WhisperForConditionalGeneration.from_pretrained(
        path, local_files_only=True)
    return convert_hf_model(hf, dev)


def export_state_dict(params: dict, cfg: WhisperConfig) -> Dict[str, np.ndarray]:
    """Inverse of ``convert_state_dict``: the parameter tree (tensors or
    numpy) → the HF state-dict layout in fp32 numpy, so a fine-tuned tree
    can be written back into an HF model. ``proj_out`` stays tied to
    ``embed_tokens``."""
    def norm(x):
        return np.ascontiguousarray(np.asarray(to_numpy(x), np.float32))

    sd: Dict[str, np.ndarray] = {}

    def put_dense(prefix, p):
        sd[prefix + ".weight"] = norm(p["kernel"]).T.copy()
        if "bias" in p:
            sd[prefix + ".bias"] = norm(p["bias"])

    def put_ln(prefix, p):
        sd[prefix + ".weight"] = norm(p["scale"])
        sd[prefix + ".bias"] = norm(p["bias"])

    def put_attn(prefix, p):
        for name in ("q", "k", "v"):
            put_dense(f"{prefix}.{name}_proj", p[name])
        put_dense(prefix + ".out_proj", p["out"])

    def put_conv1d(prefix, p):
        sd[prefix + ".weight"] = norm(p["kernel"]).transpose(2, 1, 0).copy()
        sd[prefix + ".bias"] = norm(p["bias"])

    enc, dec = params["encoder"], params["decoder"]
    put_conv1d("model.encoder.conv1", enc["conv1"])
    put_conv1d("model.encoder.conv2", enc["conv2"])
    sd["model.encoder.embed_positions.weight"] = norm(enc["embed_positions"])
    put_ln("model.encoder.layer_norm", enc["layer_norm"])
    for i in range(cfg.encoder_layers):
        lp = layer(enc["layers"], i)
        p = f"model.encoder.layers.{i}"
        put_attn(p + ".self_attn", lp["self_attn"])
        put_ln(p + ".self_attn_layer_norm", lp["self_attn_layer_norm"])
        put_dense(p + ".fc1", lp["fc1"])
        put_dense(p + ".fc2", lp["fc2"])
        put_ln(p + ".final_layer_norm", lp["final_layer_norm"])
    sd["model.decoder.embed_tokens.weight"] = norm(dec["embed_tokens"])
    sd["model.decoder.embed_positions.weight"] = norm(dec["embed_positions"])
    put_ln("model.decoder.layer_norm", dec["layer_norm"])
    for i in range(cfg.decoder_layers):
        lp = layer(dec["layers"], i)
        p = f"model.decoder.layers.{i}"
        put_attn(p + ".self_attn", lp["self_attn"])
        put_ln(p + ".self_attn_layer_norm", lp["self_attn_layer_norm"])
        put_attn(p + ".encoder_attn", lp["encoder_attn"])
        put_ln(p + ".encoder_attn_layer_norm", lp["encoder_attn_layer_norm"])
        put_dense(p + ".fc1", lp["fc1"])
        put_dense(p + ".fc2", lp["fc2"])
        put_ln(p + ".final_layer_norm", lp["final_layer_norm"])
    return sd
