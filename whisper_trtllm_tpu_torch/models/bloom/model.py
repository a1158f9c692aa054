"""Bloom decoder-only model (counterpart of
``whisper_trtllm_tpu/models/bloom/model.py``): ALiBi positions (an
additive bias on the attention scores, no position table), an embedding
LayerNorm, per-head-interleaved fused QKV split at conversion, the tied
vocab head. Converts from HF ``BloomForCausalLM``.

On the card every LayerNorm runs K5 (2L + 2 a pass: ``embed_ln``,
``input_ln`` and ``post_ln`` a layer, ``ln_f``) and every step's attention
K2 with the ALiBi bias (one a layer). The prefill's attention is masked
(causal plus the bias), which the JAX package runs in XLA: here the plain
formula on either device, so no K1. The products and the tied head are
torch matmuls, as the JAX package runs them in XLA.

ALiBi's bias depends only on the key position (the softmax is
shift-invariant in the query's term), so one constant (1, H, 1, Tmax)
bias serves every step of a decode: it is made once, outside the captured
step, and kept (``step_bias``) for as long as the process runs, so a
replayed step reads the tensor its capture read.
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
    tied_logits,
    write_prefix,
)
from whisper_trtllm_tpu_torch.ops.attention import (
    mha,
    mha_decode_step,
    update_kv_cache,
)
from whisper_trtllm_tpu_torch.ops.functional import (
    alibi_bias,
    dense,
    embedding,
    gather_last_token_logits,
    gelu,
    layer_norm,
)
from whisper_trtllm_tpu_torch.runtime import beam_lm, causal_lm
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy
from whisper_trtllm_tpu_torch.utils.device import resolve_device, to_tensor


@dataclass(frozen=True)
class BloomConfig:
    vocab_size: int = 250880
    d_model: int = 1024
    n_layer: int = 24
    n_head: int = 16
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @classmethod
    def testing(cls, **overrides) -> "BloomConfig":
        kw = dict(vocab_size=89, d_model=32, n_layer=2, n_head=4,
                  eos_token_id=2)
        kw.update(overrides)
        return cls(**kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def _init_layer(rng, cfg: BloomConfig) -> dict:
    d = cfg.d_model
    return {
        "input_ln": init_layer_norm(d),
        "q": init_dense(rng, d, d),
        "k": init_dense(rng, d, d),
        "v": init_dense(rng, d, d),
        "attn_out": init_dense(rng, d, d),
        "post_ln": init_layer_norm(d),
        "fc_in": init_dense(rng, d, 4 * d),
        "fc_out": init_dense(rng, 4 * d, d),
    }


def init_params(cfg: BloomConfig, seed: int = 0, device=None) -> dict:
    """Random weights in the JAX package's draw order (bit-equal to its
    ``init_params``), fp32 tensors on ``device`` (the card by default)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    layers = [_init_layer(rng, cfg) for _ in range(cfg.n_layer)]
    return params_from_numpy({
        "word_embeddings": init_embedding(rng, cfg.vocab_size, cfg.d_model),
        "embed_ln": init_layer_norm(cfg.d_model),
        "layers": stack(layers),
        "ln_f": init_layer_norm(cfg.d_model),
    }, dev)


# (heads, rows, device) → the (1, H, 1, rows) bias of a decode's steps
_STEP_BIAS: dict = {}


def step_bias(heads: int, rows: int, device: torch.device) -> torch.Tensor:
    """The constant ALiBi bias of a decode's steps over a cache of
    ``rows`` rows, made on its first use and kept: a captured step reads
    it on every replay, so it must outlive the call that made it."""
    key = (heads, rows, torch.device(device))
    bias = _STEP_BIAS.get(key)
    if bias is None:
        bias = _STEP_BIAS[key] = alibi_bias(heads, rows, device)
    return bias


def _block(lp, cfg: BloomConfig, x, attend):
    """One block: pre-LN attention (``attend(q, k, v)``, q pre-scaled)
    and the GELU MLP, each a residual."""
    h, dh, eps = cfg.n_head, cfg.head_dim, cfg.layer_norm_eps
    hid = layer_norm(lp["input_ln"], x, eps)
    a = attend(split_heads(dense(lp["q"], hid), h, dh) * dh ** -0.5,
               split_heads(dense(lp["k"], hid), h, dh),
               split_heads(dense(lp["v"], hid), h, dh))
    x = x + dense(lp["attn_out"], merge_heads(a))
    hid = layer_norm(lp["post_ln"], x, eps)
    return x + dense(lp["fc_out"], gelu(dense(lp["fc_in"], hid)))


def _embed(params, cfg: BloomConfig, tokens):
    x = embedding(params["word_embeddings"], tokens)
    return layer_norm(params["embed_ln"], x, cfg.layer_norm_eps)


def _prefill_hidden(params, cfg: BloomConfig, tokens, cache_k, cache_v):
    """Context phase: the final hidden states (B, S, d) under the causal
    mask plus ALiBi's bias; K and V written into rows [0, S) of the caches
    when they are given."""
    x = _embed(params, cfg, tokens)
    bias = alibi_bias(cfg.n_head, tokens.shape[1], x.device)
    for i in range(cfg.n_layer):
        def attend(q, k, v, i=i):
            if cache_k is not None:
                write_prefix(cache_k[i], k)
                write_prefix(cache_v[i], v)
            return mha(q, k, v, mask=bias, causal=True)

        x = _block(layer(params["layers"], i), cfg, x, attend)
    return (layer_norm(params["ln_f"], x, cfg.layer_norm_eps), cache_k,
            cache_v)


@torch.inference_mode()
def forward(params: dict, cfg: BloomConfig, tokens) -> torch.Tensor:
    """Teacher-forced: tokens (B, S) → logits (B, S, V) fp32."""
    tokens = to_tensor(tokens, params["word_embeddings"].device, torch.int64)
    x, _, _ = _prefill_hidden(params, cfg, tokens, None, None)
    return tied_logits(params["word_embeddings"], x)


def _prefill(params, cfg: BloomConfig, tokens, cache_k, cache_v):
    x, cache_k, cache_v = _prefill_hidden(params, cfg, tokens, cache_k,
                                          cache_v)
    return tied_logits(params["word_embeddings"], x[:, -1]), cache_k, cache_v


def _prefill_ragged(params, cfg: BloomConfig, tokens, lens, cache_k,
                    cache_v):
    """Ragged context phase: logits at each row's own last valid
    position."""
    x, cache_k, cache_v = _prefill_hidden(params, cfg, tokens, cache_k,
                                          cache_v)
    return (tied_logits(params["word_embeddings"],
                        gather_last_token_logits(x, lens)), cache_k, cache_v)


def _step(params, cfg: BloomConfig, tok, pos, cache_k, cache_v):
    """Generation phase at ``pos`` (0-d, or (B,) per lane): no position
    input but the cache rows and lengths; every layer's attention takes
    the constant (1, H, 1, Tmax) bias of ``step_bias``."""
    x = _embed(params, cfg, tok[:, None])
    bias = step_bias(cfg.n_head, cache_k.shape[3], x.device)
    for i in range(cfg.n_layer):
        def attend(q, k, v, i=i):
            ck, cv = update_kv_cache(cache_k[i], cache_v[i], k, v, pos)
            return mha_decode_step(q, ck, cv, pos + 1, bias=bias)

        x = _block(layer(params["layers"], i), cfg, x, attend)
    x = layer_norm(params["ln_f"], x, cfg.layer_norm_eps)
    return tied_logits(params["word_embeddings"], x[:, 0]), cache_k, cache_v


def _cache_shape(cfg: BloomConfig, b: int, max_len: int) -> tuple:
    return (cfg.n_layer, b, cfg.n_head, max_len, cfg.head_dim)


def generate_ragged(params: dict, cfg: BloomConfig, prompt, prompt_lens,
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
        sampling_cfg=sc, cache_dtype=dtype, key=("bloom", cfg))


def generate(params: dict, cfg: BloomConfig, prompt, max_new_tokens: int,
             temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
             repetition_penalty: float = 1.0, seed: int = 0,
             do_sample: bool = False, device=None,
             sampling_cfg=None) -> torch.Tensor:
    """KV-cached generation through the shared causal-LM loop (see
    ``models/gpt/model.py::generate``); Bloom has no position limit."""
    prompt, dtype = prepare(params, prompt, device)
    b, prompt_len = prompt.shape
    max_len = prompt_len + max_new_tokens
    sc = sampling_cfg or causal_lm.make_sampling_cfg(
        temperature, top_k, top_p, repetition_penalty, seed, do_sample)
    return causal_lm.generate_tokens(
        lambda pr, t, ck, cv: _prefill(pr, cfg, t, ck, cv),
        lambda pr, tok, pos, ck, cv: _step(pr, cfg, tok, pos, ck, cv),
        params, prompt, cache_shape=_cache_shape(cfg, b, max_len),
        prompt_len=prompt_len, max_len=max_len,
        eos_token_id=cfg.eos_token_id, sampling_cfg=sc, cache_dtype=dtype,
        key=("bloom", cfg))


# beam search (HF ``early_stopping=True``) through the model-agnostic
# factory, as the JAX package wires it
generate_beam = beam_lm.make_generate_beam(_prefill, _step)


def convert_hf_bloom(hf_model, device=None) -> Tuple[dict, BloomConfig]:
    """transformers ``BloomForCausalLM`` → (tensor tree on ``device``, the
    card by default, config). Bloom's fused ``query_key_value`` weight
    (3·d, d) is (heads, 3, dh, d) per head: split into q, k and v."""
    dev = resolve_device(device)
    hc = hf_model.config
    cfg = BloomConfig(
        vocab_size=hc.vocab_size, d_model=hc.hidden_size,
        n_layer=hc.n_layer, n_head=hc.n_head,
        layer_norm_eps=hc.layer_norm_epsilon,
        eos_token_id=hc.eos_token_id if hc.eos_token_id is not None else 2,
    )
    d, h, dh = cfg.d_model, cfg.n_head, cfg.head_dim
    sd = {k: v.detach().cpu().numpy()
          for k, v in hf_model.state_dict().items()}

    def ln(p):
        return {"scale": sd[p + ".weight"], "bias": sd[p + ".bias"]}

    def lin(p):
        return {"kernel": np.ascontiguousarray(sd[p + ".weight"].T),
                "bias": sd[p + ".bias"]}

    layers = []
    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}"
        w = sd[p + ".self_attention.query_key_value.weight"].reshape(
            h, 3, dh, d)
        bvec = sd[p + ".self_attention.query_key_value.bias"].reshape(
            h, 3, dh)

        def proj(j):
            return {"kernel": np.ascontiguousarray(
                w[:, j].reshape(h * dh, d).T),
                "bias": bvec[:, j].reshape(h * dh)}

        layers.append({
            "input_ln": ln(p + ".input_layernorm"),
            "q": proj(0), "k": proj(1), "v": proj(2),
            "attn_out": lin(p + ".self_attention.dense"),
            "post_ln": ln(p + ".post_attention_layernorm"),
            "fc_in": lin(p + ".mlp.dense_h_to_4h"),
            "fc_out": lin(p + ".mlp.dense_4h_to_h"),
        })
    return params_from_numpy({
        "word_embeddings": sd["transformer.word_embeddings.weight"],
        "embed_ln": ln("transformer.word_embeddings_layernorm"),
        "layers": stack(layers),
        "ln_f": ln("transformer.ln_f"),
    }, dev), cfg
