"""LLaMA-family decoder-only model (counterpart of
``whisper_trtllm_tpu/models/llama/model.py``): RMSNorm, rotary position
embeddings (HF's half-rotation layout), a gated SiLU MLP and grouped-query
attention through ``n_kv_head``. The caches hold ``n_kv_head`` heads; the
prefill attends through K1's GQA (from 768 positions on the card) and the
step repeats the cache to ``n_head`` heads for K2, as the JAX step does.
RMSNorm has no kernel (the JAX package runs it in XLA), so no K5 runs
here. Converts from HF ``LlamaForCausalLM``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from whisper_trtllm_tpu_torch.layers.init import init_dense, init_embedding
from whisper_trtllm_tpu_torch.models.zoo import (
    layer,
    merge_heads,
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
    dense,
    embedding,
    gather_last_token_logits,
    rms_norm,
)
from whisper_trtllm_tpu_torch.runtime import beam_lm, causal_lm
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy
from whisper_trtllm_tpu_torch.utils.device import resolve_device, to_tensor


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_positions: int = 4096
    d_model: int = 4096
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 32          # < n_head: grouped-query attention
    ffn_dim: int = 11008
    rms_eps: float = 1e-6
    rope_theta: float = 10000.0
    eos_token_id: int = 2
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @classmethod
    def testing(cls, **overrides) -> "LlamaConfig":
        kw = dict(vocab_size=89, max_positions=32, d_model=32, n_layer=2,
                  n_head=4, n_kv_head=2, ffn_dim=56, eos_token_id=2)
        kw.update(overrides)
        return cls(**kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


# -- rotary embeddings --------------------------------------------------------

def rope_sin_cos(cfg: LlamaConfig, positions: torch.Tensor):
    """positions (...,) → fp32 sin, cos (..., head_dim) in HF's
    half-rotation layout."""
    dh = cfg.head_dim
    dev = positions.device
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, dh, 2, dtype=torch.float32, device=dev) / dh))
    angles = positions.float()[..., None] * inv_freq      # (..., dh/2)
    emb = torch.cat([angles, angles], dim=-1)
    return torch.sin(emb), torch.cos(emb)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """x (B, H, S, dh); sin, cos (S, dh), or broadcast 4-D (e.g. (B, 1, 1,
    dh) for per-lane steps). Computed in fp32, returned in x's dtype."""
    if sin.dim() == 2:
        sin, cos = sin[None, None], cos[None, None]
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x * cos + rotated * sin).to(x.dtype)


# -- params -------------------------------------------------------------------

def _init_layer(rng, cfg: LlamaConfig) -> dict:
    d, dh = cfg.d_model, cfg.head_dim
    kv = cfg.n_kv_head * dh
    return {
        "input_norm": {"scale": np.ones((d,), np.float32)},
        "q": init_dense(rng, d, d, bias=False),
        "k": init_dense(rng, d, kv, bias=False),
        "v": init_dense(rng, d, kv, bias=False),
        "o": init_dense(rng, d, d, bias=False),
        "post_norm": {"scale": np.ones((d,), np.float32)},
        "gate": init_dense(rng, d, cfg.ffn_dim, bias=False),
        "up": init_dense(rng, d, cfg.ffn_dim, bias=False),
        "down": init_dense(rng, cfg.ffn_dim, d, bias=False),
    }


def init_params(cfg: LlamaConfig, seed: int = 0, device=None) -> dict:
    """Random weights in the JAX package's draw order (bit-equal to its
    ``init_params``), fp32 tensors on ``device`` (the card by default)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    layers = [_init_layer(rng, cfg) for _ in range(cfg.n_layer)]
    p = {
        "embed_tokens": init_embedding(rng, cfg.vocab_size, cfg.d_model),
        "layers": stack(layers),
        "norm": {"scale": np.ones((cfg.d_model,), np.float32)},
    }
    if not cfg.tie_word_embeddings:
        p["lm_head"] = init_dense(rng, cfg.d_model, cfg.vocab_size,
                                  bias=False)
    return params_from_numpy(p, dev)


# -- forward ------------------------------------------------------------------

def _logits(params, cfg: LlamaConfig, x):
    """fp32 logits of x (..., d): the tied table or ``lm_head`` in x's
    dtype, summed in fp32."""
    if cfg.tie_word_embeddings:
        return tied_logits(params["embed_tokens"], x)
    w = params["lm_head"]["kernel"]
    return torch.matmul(x.float(), w.to(x.dtype).float())


def _qkv(lp, h, cfg: LlamaConfig, sin, cos):
    dh = cfg.head_dim
    q = apply_rope(split_heads(dense(lp["q"], h), cfg.n_head, dh), sin, cos)
    k = apply_rope(split_heads(dense(lp["k"], h), cfg.n_kv_head, dh), sin,
                   cos)
    v = split_heads(dense(lp["v"], h), cfg.n_kv_head, dh)
    return q * dh ** -0.5, k, v


def _finish_layer(lp, x, a, cfg: LlamaConfig):
    x = x + dense(lp["o"], merge_heads(a))
    h = rms_norm(lp["post_norm"], x, cfg.rms_eps)
    return x + dense(lp["down"],
                     F.silu(dense(lp["gate"], h)) * dense(lp["up"], h))


@torch.inference_mode()
def forward(params: dict, cfg: LlamaConfig, tokens) -> torch.Tensor:
    """Teacher-forced: tokens (B, S) → logits (B, S, V) fp32."""
    tokens = to_tensor(tokens, params["embed_tokens"].device, torch.int64)
    x, _, _ = _prefill_hidden(params, cfg, tokens, None, None)
    return _logits(params, cfg, x)


def _prefill_hidden(params, cfg: LlamaConfig, tokens, cache_k, cache_v):
    """Context phase: the final hidden states (B, S, d); the post-rope K
    and V (``n_kv_head`` heads) written into rows [0, S) of the caches when
    they are given."""
    s = tokens.shape[1]
    x = embedding(params["embed_tokens"], tokens)
    sin, cos = rope_sin_cos(cfg, torch.arange(s, device=x.device))
    for i in range(cfg.n_layer):
        lp = layer(params["layers"], i)
        h = rms_norm(lp["input_norm"], x, cfg.rms_eps)
        q, k, v = _qkv(lp, h, cfg, sin, cos)
        if cache_k is not None:
            write_prefix(cache_k[i], k)
            write_prefix(cache_v[i], v)
        x = _finish_layer(lp, x, mha(q, k, v, causal=True), cfg)
    return rms_norm(params["norm"], x, cfg.rms_eps), cache_k, cache_v


def _prefill(params, cfg: LlamaConfig, tokens, cache_k, cache_v):
    """Context phase: the whole prompt in one pass, the vocab projection
    on the last position only."""
    x, cache_k, cache_v = _prefill_hidden(params, cfg, tokens, cache_k,
                                          cache_v)
    return _logits(params, cfg, x[:, -1]), cache_k, cache_v


def _prefill_ragged(params, cfg: LlamaConfig, tokens, lens, cache_k, cache_v):
    """Ragged context phase: logits at each row's own last valid
    position."""
    x, cache_k, cache_v = _prefill_hidden(params, cfg, tokens, cache_k,
                                          cache_v)
    return (_logits(params, cfg, gather_last_token_logits(x, lens)),
            cache_k, cache_v)


def _step(params, cfg: LlamaConfig, tok, pos, cache_k, cache_v):
    """Generation phase at ``pos`` (0-d, or (B,) with per-lane rope angles,
    cache rows and lengths); the cache repeated to ``n_head`` heads for the
    attention when ``n_kv_head < n_head``."""
    x = embedding(params["embed_tokens"], tok[:, None])
    if pos.dim() == 1:
        sin, cos = rope_sin_cos(cfg, pos)                  # (B, dh)
        sin, cos = sin[:, None, None], cos[:, None, None]  # (B, 1, 1, dh)
    else:
        sin, cos = rope_sin_cos(cfg, pos.reshape(1))
    rep = cfg.n_head // cfg.n_kv_head
    for i in range(cfg.n_layer):
        lp = layer(params["layers"], i)
        h = rms_norm(lp["input_norm"], x, cfg.rms_eps)
        q, k, v = _qkv(lp, h, cfg, sin, cos)
        ck, cv = update_kv_cache(cache_k[i], cache_v[i], k, v, pos)
        if rep > 1:
            ck = ck.repeat_interleave(rep, dim=1)
            cv = cv.repeat_interleave(rep, dim=1)
        x = _finish_layer(lp, x, mha_decode_step(q, ck, cv, pos + 1), cfg)
    x = rms_norm(params["norm"], x, cfg.rms_eps)
    return _logits(params, cfg, x[:, 0]), cache_k, cache_v


def _cache_shape(cfg: LlamaConfig, b: int, max_len: int) -> tuple:
    return (cfg.n_layer, b, cfg.n_kv_head, max_len, cfg.head_dim)


def generate_ragged(params: dict, cfg: LlamaConfig, prompt, prompt_lens,
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
        sampling_cfg=sc, cache_dtype=dtype, key=("llama", cfg))


def generate(params: dict, cfg: LlamaConfig, prompt, max_new_tokens: int,
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
        key=("llama", cfg))


def generate_beam(params: dict, cfg: LlamaConfig, prompt,
                  max_new_tokens: int, num_beams: int,
                  length_penalty: float = 1.0, device=None):
    """Beam search (HF ``early_stopping=True``; see
    ``models/gpt/model.py::generate_beam``); the caches hold ``n_kv_head``
    heads and every beam shares the step's position."""
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
        key=("llama", cfg))


# -- HF conversion --------------------------------------------------------------

def convert_hf_llama(hf_model, device=None) -> Tuple[dict, LlamaConfig]:
    """transformers ``LlamaForCausalLM`` → (tensor tree on ``device``, the
    card by default, config)."""
    dev = resolve_device(device)
    hc = hf_model.config
    cfg = LlamaConfig(
        vocab_size=hc.vocab_size, max_positions=hc.max_position_embeddings,
        d_model=hc.hidden_size, n_layer=hc.num_hidden_layers,
        n_head=hc.num_attention_heads,
        n_kv_head=getattr(hc, "num_key_value_heads", hc.num_attention_heads),
        ffn_dim=hc.intermediate_size, rms_eps=hc.rms_norm_eps,
        rope_theta=getattr(hc, "rope_theta", 10000.0),
        eos_token_id=hc.eos_token_id or 2,
        tie_word_embeddings=getattr(hc, "tie_word_embeddings", False),
    )
    sd = {k: v.detach().cpu().float().numpy()
          for k, v in hf_model.state_dict().items()}

    def lin(p):
        return {"kernel": np.ascontiguousarray(sd[p + ".weight"].T)}

    layers = []
    for i in range(cfg.n_layer):
        p = f"model.layers.{i}"
        layers.append({
            "input_norm": {"scale": sd[p + ".input_layernorm.weight"]},
            "q": lin(p + ".self_attn.q_proj"),
            "k": lin(p + ".self_attn.k_proj"),
            "v": lin(p + ".self_attn.v_proj"),
            "o": lin(p + ".self_attn.o_proj"),
            "post_norm": {"scale": sd[p + ".post_attention_layernorm.weight"]},
            "gate": lin(p + ".mlp.gate_proj"),
            "up": lin(p + ".mlp.up_proj"),
            "down": lin(p + ".mlp.down_proj"),
        })
    params = {
        "embed_tokens": sd["model.embed_tokens.weight"],
        "layers": stack(layers),
        "norm": {"scale": sd["model.norm.weight"]},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {
            "kernel": np.ascontiguousarray(sd["lm_head.weight"].T)}
    return params_from_numpy(params, dev), cfg
