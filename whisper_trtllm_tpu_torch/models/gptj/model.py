"""GPT-J decoder-only model (counterpart of
``whisper_trtllm_tpu/models/gptj/model.py``): partial rotary embeddings in
GPT-J's interleaved ("rotate every two") layout over the first
``rotary_dim`` dims of each head, a parallel residual block (attention and
MLP both read the one ``ln_1`` output and add into the residual
together), bias-free attention projections and an untied ``lm_head`` with
a bias. Converts from HF ``GPTJForCausalLM``.

On the card the prefill's causal attention runs K1 from 768 positions on
(GPT-J-6B's 16 heads of 256), every LayerNorm K5 (L + 1 a pass: ``ln_1``
a layer, ``ln_f``; d 4096 at 6B), every step's attention K2 (one a layer,
heads of 256); the products and the vocab head are torch matmuls, as the
JAX package runs them in XLA.
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
    prepare,
    split_heads,
    stack,
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
from whisper_trtllm_tpu_torch.runtime import beam_lm, causal_lm
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy
from whisper_trtllm_tpu_torch.utils.device import resolve_device, to_tensor


@dataclass(frozen=True)
class GPTJConfig:
    vocab_size: int = 50400
    max_positions: int = 2048
    d_model: int = 4096
    n_layer: int = 28
    n_head: int = 16
    rotary_dim: int = 64
    ffn_dim: int = 16384
    activation: str = "gelu_new"
    eos_token_id: int = 50256

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @classmethod
    def testing(cls, **overrides) -> "GPTJConfig":
        kw = dict(vocab_size=89, max_positions=32, d_model=32, n_layer=2,
                  n_head=4, rotary_dim=4, ffn_dim=64, eos_token_id=2)
        kw.update(overrides)
        return cls(**kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


# -- rotary embeddings ----------------------------------------------------------

def rope_interleaved_sin_cos(rotary_dim: int, positions: torch.Tensor):
    """positions (...,) → fp32 sin, cos (..., rotary_dim), each angle twice
    in a row (GPT-J's layout)."""
    inv_freq = 1.0 / (10000.0 ** (
        torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                     device=positions.device) / rotary_dim))
    angles = positions.float()[..., None] * inv_freq      # (..., rd/2)
    angles = angles.repeat_interleave(2, dim=-1)          # (..., rd)
    return torch.sin(angles), torch.cos(angles)


def apply_rope_interleaved(x: torch.Tensor, sin: torch.Tensor,
                           cos: torch.Tensor, rotary_dim: int):
    """x (B, H, S, dh): the first ``rotary_dim`` dims rotated in pairs
    (x[2i], x[2i + 1]) in fp32, back in x's dtype; the tail passed
    through. sin, cos (S, rd), or broadcast 4-D."""
    if sin.dim() == 2:
        sin, cos = sin[None, None], cos[None, None]
    rot, tail = x[..., :rotary_dim], x[..., rotary_dim:]
    x1, x2 = rot[..., 0::2], rot[..., 1::2]
    rotated = torch.stack([-x2, x1], dim=-1).reshape(rot.shape)
    rot = rot * cos + rotated * sin
    return torch.cat([rot.to(x.dtype), tail], dim=-1)


# -- params ---------------------------------------------------------------------

def _init_layer(rng, cfg: GPTJConfig) -> dict:
    d = cfg.d_model
    return {
        "ln_1": init_layer_norm(d),
        "q": init_dense(rng, d, d, bias=False),
        "k": init_dense(rng, d, d, bias=False),
        "v": init_dense(rng, d, d, bias=False),
        "attn_out": init_dense(rng, d, d, bias=False),
        "fc_in": init_dense(rng, d, cfg.ffn_dim),
        "fc_out": init_dense(rng, cfg.ffn_dim, d),
    }


def init_params(cfg: GPTJConfig, seed: int = 0, device=None) -> dict:
    """Random weights in the JAX package's draw order (bit-equal to its
    ``init_params``), fp32 tensors on ``device`` (the card by default)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    layers = [_init_layer(rng, cfg) for _ in range(cfg.n_layer)]
    return params_from_numpy({
        "wte": init_embedding(rng, cfg.vocab_size, cfg.d_model),
        "layers": stack(layers),
        "ln_f": init_layer_norm(cfg.d_model),
        "lm_head": init_dense(rng, cfg.d_model, cfg.vocab_size),
    }, dev)


# -- forward --------------------------------------------------------------------

def _logits(params, x):
    """``lm_head`` (with its bias) in x's dtype, then fp32."""
    return dense(params["lm_head"], x).float()


def _block(lp, cfg: GPTJConfig, x, sin, cos, attend):
    """One parallel-residual block; ``attend(q, k, v)`` gives the attention
    (causal over the prompt, or the cached step)."""
    h, dh, rd = cfg.n_head, cfg.head_dim, cfg.rotary_dim
    hid = layer_norm(lp["ln_1"], x)
    q = apply_rope_interleaved(split_heads(dense(lp["q"], hid), h, dh), sin,
                               cos, rd)
    k = apply_rope_interleaved(split_heads(dense(lp["k"], hid), h, dh), sin,
                               cos, rd)
    a = attend(q * dh ** -0.5, k, split_heads(dense(lp["v"], hid), h, dh))
    ffn = dense(lp["fc_out"], ACT2FN[cfg.activation](dense(lp["fc_in"], hid)))
    return x + dense(lp["attn_out"], merge_heads(a)) + ffn


def _prefill_hidden(params, cfg: GPTJConfig, tokens, cache_k, cache_v):
    """Context phase: the final hidden states (B, S, d); the post-rope K
    and V written into rows [0, S) of the caches when they are given."""
    s = tokens.shape[1]
    x = embedding(params["wte"], tokens)
    sin, cos = rope_interleaved_sin_cos(cfg.rotary_dim,
                                        torch.arange(s, device=x.device))
    for i in range(cfg.n_layer):
        lp = layer(params["layers"], i)

        def attend(q, k, v, i=i):
            if cache_k is not None:
                write_prefix(cache_k[i], k)
                write_prefix(cache_v[i], v)
            return mha(q, k, v, causal=True)

        x = _block(lp, cfg, x, sin, cos, attend)
    return layer_norm(params["ln_f"], x), cache_k, cache_v


@torch.inference_mode()
def forward(params: dict, cfg: GPTJConfig, tokens) -> torch.Tensor:
    """Teacher-forced: tokens (B, S) → logits (B, S, V) fp32."""
    tokens = to_tensor(tokens, params["wte"].device, torch.int64)
    x, _, _ = _prefill_hidden(params, cfg, tokens, None, None)
    return _logits(params, x)


def _prefill(params, cfg: GPTJConfig, tokens, cache_k, cache_v):
    x, cache_k, cache_v = _prefill_hidden(params, cfg, tokens, cache_k,
                                          cache_v)
    return _logits(params, x[:, -1]), cache_k, cache_v


def _prefill_ragged(params, cfg: GPTJConfig, tokens, lens, cache_k, cache_v):
    """Ragged context phase: logits at each row's own last valid
    position."""
    x, cache_k, cache_v = _prefill_hidden(params, cfg, tokens, cache_k,
                                          cache_v)
    return (_logits(params, gather_last_token_logits(x, lens)), cache_k,
            cache_v)


def _step(params, cfg: GPTJConfig, tok, pos, cache_k, cache_v):
    """Generation phase at ``pos`` (0-d, or (B,) with per-lane rope angles,
    cache rows and lengths)."""
    x = embedding(params["wte"], tok[:, None])
    if pos.dim() == 1:
        sin, cos = rope_interleaved_sin_cos(cfg.rotary_dim, pos)  # (B, rd)
        sin, cos = sin[:, None, None], cos[:, None, None]
    else:
        sin, cos = rope_interleaved_sin_cos(cfg.rotary_dim, pos.reshape(1))
    for i in range(cfg.n_layer):
        lp = layer(params["layers"], i)

        def attend(q, k, v, i=i):
            ck, cv = update_kv_cache(cache_k[i], cache_v[i], k, v, pos)
            return mha_decode_step(q, ck, cv, pos + 1)

        x = _block(lp, cfg, x, sin, cos, attend)
    x = layer_norm(params["ln_f"], x)
    return _logits(params, x[:, 0]), cache_k, cache_v


def _cache_shape(cfg: GPTJConfig, b: int, max_len: int) -> tuple:
    return (cfg.n_layer, b, cfg.n_head, max_len, cfg.head_dim)


def generate_ragged(params: dict, cfg: GPTJConfig, prompt, prompt_lens,
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
        sampling_cfg=sc, cache_dtype=dtype, key=("gptj", cfg))


def generate(params: dict, cfg: GPTJConfig, prompt, max_new_tokens: int,
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
        key=("gptj", cfg))


def generate_beam(params: dict, cfg: GPTJConfig, prompt, max_new_tokens: int,
                  num_beams: int, length_penalty: float = 1.0, device=None):
    """Beam search (HF ``early_stopping=True``; see
    ``models/gpt/model.py::generate_beam``)."""
    prompt, dtype = prepare(params, prompt, device)
    b, p = prompt.shape
    if p + max_new_tokens > cfg.max_positions:
        raise ValueError("prompt_len + max_new_tokens exceeds max_positions")
    return beam_lm.beam_generate_tokens(
        lambda pr, t, ck, cv: _prefill(pr, cfg, t, ck, cv),
        lambda pr, tok, pos, ck, cv: _step(pr, cfg, tok, pos, ck, cv),
        params, prompt, cache_shape=_cache_shape(cfg, b, p + max_new_tokens),
        prompt_len=p, max_new_tokens=max_new_tokens,
        eos_token_id=cfg.eos_token_id, num_beams=num_beams,
        length_penalty=float(length_penalty), cache_dtype=dtype,
        key=("gptj", cfg))


# -- HF conversion ----------------------------------------------------------------

def convert_hf_gptj(hf_model, device=None) -> Tuple[dict, GPTJConfig]:
    """transformers ``GPTJForCausalLM`` → (tensor tree on ``device``, the
    card by default, config)."""
    dev = resolve_device(device)
    hc = hf_model.config
    cfg = GPTJConfig(
        vocab_size=hc.vocab_size, max_positions=hc.n_positions,
        d_model=hc.n_embd, n_layer=hc.n_layer, n_head=hc.n_head,
        rotary_dim=hc.rotary_dim, ffn_dim=hc.n_inner or 4 * hc.n_embd,
        activation=hc.activation_function, eos_token_id=hc.eos_token_id,
    )
    sd = {k: v.detach().cpu().float().numpy()
          for k, v in hf_model.state_dict().items()}

    def ln(p):
        return {"scale": sd[p + ".weight"], "bias": sd[p + ".bias"]}

    def lin(p, bias=True):
        out = {"kernel": np.ascontiguousarray(sd[p + ".weight"].T)}
        if bias:
            out["bias"] = sd[p + ".bias"]
        return out

    layers = []
    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}"
        layers.append({
            "ln_1": ln(p + ".ln_1"),
            "q": lin(p + ".attn.q_proj", bias=False),
            "k": lin(p + ".attn.k_proj", bias=False),
            "v": lin(p + ".attn.v_proj", bias=False),
            "attn_out": lin(p + ".attn.out_proj", bias=False),
            "fc_in": lin(p + ".mlp.fc_in"),
            "fc_out": lin(p + ".mlp.fc_out"),
        })
    return params_from_numpy({
        "wte": sd["transformer.wte.weight"],
        "layers": stack(layers),
        "ln_f": ln("transformer.ln_f"),
        "lm_head": lin("lm_head"),
    }, dev), cfg
