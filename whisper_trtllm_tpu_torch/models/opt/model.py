"""OPT-family decoder-only model (counterpart of
``whisper_trtllm_tpu/models/opt/model.py``): learned positions with OPT's
offset of 2, a ReLU MLP, pre-LN blocks with a final LN, a tied vocab head.
The same layers and generation paths as ``models/gpt``: on the card K1 in
a prefill from 768 positions, K5 for every LayerNorm (2L + 1 a pass), K2 a
layer a step. Converts from HF ``OPTForCausalLM``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from whisper_trtllm_tpu_torch.layers.init import (
    init_dense,
    init_embedding,
    init_layer_norm,
)
from whisper_trtllm_tpu_torch.models.zoo import (
    layer,
    merge_heads,
    position_rows,
    prepare,
    split_heads,
    stack,
    tied_logits,
    write_prefix,
)
from whisper_trtllm_tpu_torch.ops.attention import (
    mha,
    mha_decode_step,
    update_kv_cache,
)
from whisper_trtllm_tpu_torch.ops.functional import (
    ACT2FN,
    dense,
    embedding,
    gather_last_token_logits,
    layer_norm,
)
from whisper_trtllm_tpu_torch.runtime import causal_lm
from whisper_trtllm_tpu_torch.runtime.beam_lm import make_generate_beam
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy
from whisper_trtllm_tpu_torch.utils.device import resolve_device, to_tensor

_POS_OFFSET = 2  # OPT reserves the first two positional rows


@dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    max_positions: int = 2048
    d_model: int = 768
    n_layer: int = 12
    n_head: int = 12
    ffn_dim: int = 3072
    activation: str = "relu"
    eos_token_id: int = 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @classmethod
    def testing(cls, **overrides) -> "OPTConfig":
        kw = dict(vocab_size=89, max_positions=32, d_model=32, n_layer=2,
                  n_head=4, ffn_dim=64, eos_token_id=2)
        kw.update(overrides)
        return cls(**kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def _init_layer(rng, cfg: OPTConfig) -> dict:
    d = cfg.d_model
    return {
        "attn_ln": init_layer_norm(d),
        "q": init_dense(rng, d, d),
        "k": init_dense(rng, d, d),
        "v": init_dense(rng, d, d),
        "attn_out": init_dense(rng, d, d),
        "ffn_ln": init_layer_norm(d),
        "fc_in": init_dense(rng, d, cfg.ffn_dim),
        "fc_out": init_dense(rng, cfg.ffn_dim, d),
    }


def init_params(cfg: OPTConfig, seed: int = 0, device=None) -> dict:
    """Random weights in the JAX package's draw order (bit-equal to its
    ``init_params``), fp32 tensors on ``device`` (the card by default)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    layers = [_init_layer(rng, cfg) for _ in range(cfg.n_layer)]
    return params_from_numpy({
        "embed_tokens": init_embedding(rng, cfg.vocab_size, cfg.d_model),
        "embed_positions": init_embedding(
            rng, cfg.max_positions + _POS_OFFSET, cfg.d_model),
        "layers": stack(layers),
        "final_ln": init_layer_norm(cfg.d_model),
    }, dev)


def _heads(cfg: OPTConfig, t: torch.Tensor) -> torch.Tensor:
    return split_heads(t, cfg.n_head, cfg.head_dim)


def _layer(lp, x, cfg: OPTConfig, attend):
    """One pre-LN block; ``attend(q, k, v)`` is the attention (the full
    causal one, or the cache append and the step's)."""
    h = layer_norm(lp["attn_ln"], x)
    q = _heads(cfg, dense(lp["q"], h)) * cfg.head_dim ** -0.5
    a = attend(q, _heads(cfg, dense(lp["k"], h)), _heads(cfg, dense(lp["v"], h)))
    x = x + dense(lp["attn_out"], merge_heads(a))
    h = layer_norm(lp["ffn_ln"], x)
    return x + dense(lp["fc_out"],
                     ACT2FN[cfg.activation](dense(lp["fc_in"], h)))


@torch.inference_mode()
def forward(params: dict, cfg: OPTConfig, tokens) -> torch.Tensor:
    """Teacher-forced: tokens (B, S) → logits (B, S, V) fp32."""
    tokens = to_tensor(tokens, params["embed_tokens"].device, torch.int64)
    x, _, _ = _prefill_hidden(params, cfg, tokens, None, None)
    return tied_logits(params["embed_tokens"], x)


def convert_hf_opt(hf_model, device=None) -> Tuple[dict, OPTConfig]:
    """transformers ``OPTForCausalLM`` → (tensor tree on ``device``, the
    card by default, config)."""
    dev = resolve_device(device)
    hc = hf_model.config
    cfg = OPTConfig(
        vocab_size=hc.vocab_size, max_positions=hc.max_position_embeddings,
        d_model=hc.hidden_size, n_layer=hc.num_hidden_layers,
        n_head=hc.num_attention_heads, ffn_dim=hc.ffn_dim,
        activation=hc.activation_function,
        eos_token_id=hc.eos_token_id if hc.eos_token_id is not None else 2,
    )
    sd = {k: v.detach().cpu().float().numpy()
          for k, v in hf_model.state_dict().items()}

    def ln(p):
        return {"scale": sd[p + ".weight"], "bias": sd[p + ".bias"]}

    def lin(p):
        return {"kernel": np.ascontiguousarray(sd[p + ".weight"].T),
                "bias": sd[p + ".bias"]}

    layers = []
    for i in range(cfg.n_layer):
        p = f"model.decoder.layers.{i}"
        layers.append({
            "attn_ln": ln(p + ".self_attn_layer_norm"),
            "q": lin(p + ".self_attn.q_proj"),
            "k": lin(p + ".self_attn.k_proj"),
            "v": lin(p + ".self_attn.v_proj"),
            "attn_out": lin(p + ".self_attn.out_proj"),
            "ffn_ln": ln(p + ".final_layer_norm"),
            "fc_in": lin(p + ".fc1"),
            "fc_out": lin(p + ".fc2"),
        })
    return params_from_numpy({
        "embed_tokens": sd["model.decoder.embed_tokens.weight"],
        "embed_positions": sd["model.decoder.embed_positions.weight"],
        "layers": stack(layers),
        "final_ln": ln("model.decoder.final_layer_norm"),
    }, dev), cfg


def _prefill_hidden(params, cfg: OPTConfig, tokens, cache_k, cache_v):
    """Context phase: the final hidden states (B, S, d); the K/V written
    into rows [0, S) of the caches when they are given."""
    s = tokens.shape[1]
    x = embedding(params["embed_tokens"], tokens)
    x = x + params["embed_positions"][_POS_OFFSET:_POS_OFFSET + s][None]
    for i in range(cfg.n_layer):
        def attend(q, k, v):
            if cache_k is not None:
                write_prefix(cache_k[i], k)
                write_prefix(cache_v[i], v)
            return mha(q, k, v, causal=True)

        x = _layer(layer(params["layers"], i), x, cfg, attend)
    return layer_norm(params["final_ln"], x), cache_k, cache_v


def _vocab_logits(params, x):
    return tied_logits(params["embed_tokens"], x)


def _prefill(params, cfg: OPTConfig, tokens, cache_k, cache_v):
    """Context phase (``runtime/causal_lm.py``'s contract)."""
    x, cache_k, cache_v = _prefill_hidden(params, cfg, tokens, cache_k,
                                          cache_v)
    return _vocab_logits(params, x[:, -1]), cache_k, cache_v


def _prefill_ragged(params, cfg: OPTConfig, tokens, lens, cache_k, cache_v):
    """Ragged context phase: logits at each row's own last valid position."""
    x, cache_k, cache_v = _prefill_hidden(params, cfg, tokens, cache_k,
                                          cache_v)
    return (_vocab_logits(params, gather_last_token_logits(x, lens)),
            cache_k, cache_v)


def _step(params, cfg: OPTConfig, tok, pos, cache_k, cache_v):
    """Generation phase: one token, the caches appended at ``pos`` (0-d
    for a lockstep batch, (B,) for a ragged one)."""
    x = embedding(params["embed_tokens"], tok[:, None])
    x = x + position_rows(params["embed_positions"], pos, _POS_OFFSET)
    for i in range(cfg.n_layer):
        def attend(q, k, v):
            ck, cv = update_kv_cache(cache_k[i], cache_v[i], k, v, pos)
            return mha_decode_step(q, ck, cv, pos + 1)

        x = _layer(layer(params["layers"], i), x, cfg, attend)
    x = layer_norm(params["final_ln"], x)
    return _vocab_logits(params, x[:, 0]), cache_k, cache_v


def _cache_shape(cfg: OPTConfig, b: int, max_len: int) -> tuple:
    return (cfg.n_layer, b, cfg.n_head, max_len, cfg.head_dim)


def generate_ragged(params: dict, cfg: OPTConfig, prompt, prompt_lens,
                    max_new_tokens: int, temperature: float = 1.0,
                    top_k: int = 0, top_p: float = 0.0,
                    repetition_penalty: float = 1.0, seed: int = 0,
                    do_sample: bool = False, device=None,
                    sampling_cfg=None) -> torch.Tensor:
    """Variable-length batched generation (see
    ``models/gpt/model.py::generate_ragged``)."""
    prompt, dtype = prepare(params, prompt, device)
    sc = sampling_cfg or causal_lm.make_sampling_cfg(
        temperature, top_k, top_p, repetition_penalty, seed, do_sample)
    lens = to_tensor(prompt_lens, prompt.device, torch.int32)
    b, p = prompt.shape
    return causal_lm.generate_tokens_ragged(
        lambda pr, t, ln, ck, cv: _prefill_ragged(pr, cfg, t, ln, ck, cv),
        lambda pr, tok, pos, ck, cv: _step(pr, cfg, tok, pos, ck, cv),
        params, prompt, lens,
        cache_shape=_cache_shape(cfg, b, p + max_new_tokens),
        max_new_tokens=max_new_tokens, eos_token_id=cfg.eos_token_id,
        sampling_cfg=sc, cache_dtype=dtype, key=("opt", cfg))


def generate(params: dict, cfg: OPTConfig, prompt, max_new_tokens: int,
             temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
             repetition_penalty: float = 1.0, seed: int = 0,
             do_sample: bool = False, device=None,
             sampling_cfg=None) -> torch.Tensor:
    """KV-cached generation through the shared causal-LM loop (see
    ``models/gpt/model.py::generate``)."""
    prompt, dtype = prepare(params, prompt, device)
    b, prompt_len = prompt.shape
    max_len = min(cfg.max_positions, prompt_len + max_new_tokens)
    sc = sampling_cfg or causal_lm.make_sampling_cfg(
        temperature, top_k, top_p, repetition_penalty, seed, do_sample)
    return causal_lm.generate_tokens(
        lambda pr, t, ck, cv: _prefill(pr, cfg, t, ck, cv),
        lambda pr, tok, pos, ck, cv: _step(pr, cfg, tok, pos, ck, cv),
        params, prompt, cache_shape=_cache_shape(cfg, b, max_len),
        prompt_len=prompt_len, max_len=max_len,
        eos_token_id=cfg.eos_token_id, sampling_cfg=sc, cache_dtype=dtype,
        key=("opt", cfg))


# beam search through the model-agnostic factory (HF generate(num_beams=K,
# early_stopping=True))
generate_beam = make_generate_beam(_prefill, _step)
