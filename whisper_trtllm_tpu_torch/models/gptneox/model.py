"""GPT-NeoX decoder-only model (counterpart of
``whisper_trtllm_tpu/models/gptneox/model.py``): partial rotary embeddings
in the half-rotation layout over the first ``rotary_dim`` dims of each
head, q/k/v projections with biases (HF fuses them per head, interleaved;
the converter splits them), two LayerNorms a block and the
``use_parallel_residual`` switch between the parallel form
(x + attn(ln1 x) + mlp(ln2 x)) and the sequential one. Converts from HF
``GPTNeoXForCausalLM``.

On the card the prefill's causal attention runs K1 from 768 positions on
(at GPT-NeoX-20B's head width of 96), every LayerNorm K5 (2L + 1 a pass:
``input_ln`` and ``post_attn_ln`` a layer, ``final_ln``; d 6144 at 20B),
every step's attention K2 (one a layer); the products and the untied
``embed_out`` head are torch matmuls, as the JAX package runs them in XLA.
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
from whisper_trtllm_tpu_torch.models.llama.model import apply_rope
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
class GPTNeoXConfig:
    vocab_size: int = 50432
    max_positions: int = 2048
    d_model: int = 6144
    n_layer: int = 44
    n_head: int = 64
    rotary_pct: float = 0.25
    rope_theta: float = 10000.0
    ffn_dim: int = 24576
    activation: str = "gelu"
    layer_norm_eps: float = 1e-5
    use_parallel_residual: bool = True
    eos_token_id: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.rotary_pct)

    @classmethod
    def testing(cls, **overrides) -> "GPTNeoXConfig":
        kw = dict(vocab_size=89, max_positions=32, d_model=32, n_layer=2,
                  n_head=4, ffn_dim=64, eos_token_id=2)
        kw.update(overrides)
        return cls(**kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


# -- rotary embeddings ----------------------------------------------------------

def neox_rope_sin_cos(cfg: GPTNeoXConfig, positions: torch.Tensor):
    """positions (...,) → fp32 sin, cos (..., rotary_dim) in the
    half-rotation layout (LLaMA's, over ``rotary_dim`` < head_dim dims)."""
    rd = cfg.rotary_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, rd, 2, dtype=torch.float32, device=positions.device)
        / rd))
    angles = positions.float()[..., None] * inv_freq      # (..., rd/2)
    emb = torch.cat([angles, angles], dim=-1)
    return torch.sin(emb), torch.cos(emb)


def apply_partial_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                       rotary_dim: int) -> torch.Tensor:
    """x (B, H, S, dh): the first ``rotary_dim`` dims rotated, the tail
    passed through."""
    rot = apply_rope(x[..., :rotary_dim], sin, cos)
    return torch.cat([rot, x[..., rotary_dim:]], dim=-1)


# -- params ---------------------------------------------------------------------

def _init_layer(rng, cfg: GPTNeoXConfig) -> dict:
    d = cfg.d_model
    return {
        "input_ln": init_layer_norm(d),
        "q": init_dense(rng, d, d),
        "k": init_dense(rng, d, d),
        "v": init_dense(rng, d, d),
        "attn_out": init_dense(rng, d, d),
        "post_attn_ln": init_layer_norm(d),
        "fc_in": init_dense(rng, d, cfg.ffn_dim),
        "fc_out": init_dense(rng, cfg.ffn_dim, d),
    }


def init_params(cfg: GPTNeoXConfig, seed: int = 0, device=None) -> dict:
    """Random weights in the JAX package's draw order (bit-equal to its
    ``init_params``), fp32 tensors on ``device`` (the card by default)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    layers = [_init_layer(rng, cfg) for _ in range(cfg.n_layer)]
    return params_from_numpy({
        "embed_in": init_embedding(rng, cfg.vocab_size, cfg.d_model),
        "layers": stack(layers),
        "final_ln": init_layer_norm(cfg.d_model),
        "embed_out": init_dense(rng, cfg.d_model, cfg.vocab_size, bias=False),
    }, dev)


# -- forward --------------------------------------------------------------------

def _logits(params, x):
    """``embed_out`` in x's dtype, then fp32 (the JAX package's dense and
    cast)."""
    return dense(params["embed_out"], x).float()


def _block(lp, cfg: GPTNeoXConfig, x, sin, cos, attend):
    """One block, parallel or sequential residual; ``attend(q, k, v)``
    gives the attention (causal over the prompt, or the cached step)."""
    h, dh, rd = cfg.n_head, cfg.head_dim, cfg.rotary_dim
    eps = cfg.layer_norm_eps
    hid = layer_norm(lp["input_ln"], x, eps)
    q = apply_partial_rope(split_heads(dense(lp["q"], hid), h, dh), sin, cos,
                           rd)
    k = apply_partial_rope(split_heads(dense(lp["k"], hid), h, dh), sin, cos,
                           rd)
    a = attend(q * dh ** -0.5, k, split_heads(dense(lp["v"], hid), h, dh))
    attn_out = dense(lp["attn_out"], merge_heads(a))
    act = ACT2FN[cfg.activation]
    if cfg.use_parallel_residual:
        h2 = layer_norm(lp["post_attn_ln"], x, eps)
        return x + attn_out + dense(lp["fc_out"], act(dense(lp["fc_in"], h2)))
    x = x + attn_out
    h2 = layer_norm(lp["post_attn_ln"], x, eps)
    return x + dense(lp["fc_out"], act(dense(lp["fc_in"], h2)))


def _prefill_hidden(params, cfg: GPTNeoXConfig, tokens, cache_k, cache_v):
    """Context phase: the final hidden states (B, S, d); the post-rope K
    and V written into rows [0, S) of the caches when they are given."""
    s = tokens.shape[1]
    x = embedding(params["embed_in"], tokens)
    sin, cos = neox_rope_sin_cos(cfg, torch.arange(s, device=x.device))
    for i in range(cfg.n_layer):
        lp = layer(params["layers"], i)

        def attend(q, k, v, i=i):
            if cache_k is not None:
                write_prefix(cache_k[i], k)
                write_prefix(cache_v[i], v)
            return mha(q, k, v, causal=True)

        x = _block(lp, cfg, x, sin, cos, attend)
    return (layer_norm(params["final_ln"], x, cfg.layer_norm_eps), cache_k,
            cache_v)


@torch.inference_mode()
def forward(params: dict, cfg: GPTNeoXConfig, tokens) -> torch.Tensor:
    """Teacher-forced: tokens (B, S) → logits (B, S, V) fp32."""
    tokens = to_tensor(tokens, params["embed_in"].device, torch.int64)
    x, _, _ = _prefill_hidden(params, cfg, tokens, None, None)
    return _logits(params, x)


def _prefill(params, cfg: GPTNeoXConfig, tokens, cache_k, cache_v):
    x, cache_k, cache_v = _prefill_hidden(params, cfg, tokens, cache_k,
                                          cache_v)
    return _logits(params, x[:, -1]), cache_k, cache_v


def _prefill_ragged(params, cfg: GPTNeoXConfig, tokens, lens, cache_k,
                    cache_v):
    """Ragged context phase: logits at each row's own last valid
    position."""
    x, cache_k, cache_v = _prefill_hidden(params, cfg, tokens, cache_k,
                                          cache_v)
    return (_logits(params, gather_last_token_logits(x, lens)), cache_k,
            cache_v)


def _step(params, cfg: GPTNeoXConfig, tok, pos, cache_k, cache_v):
    """Generation phase at ``pos`` (0-d, or (B,) with per-lane rope angles,
    cache rows and lengths)."""
    x = embedding(params["embed_in"], tok[:, None])
    if pos.dim() == 1:
        sin, cos = neox_rope_sin_cos(cfg, pos)             # (B, rd)
        sin, cos = sin[:, None, None], cos[:, None, None]  # (B, 1, 1, rd)
    else:
        sin, cos = neox_rope_sin_cos(cfg, pos.reshape(1))
    for i in range(cfg.n_layer):
        lp = layer(params["layers"], i)

        def attend(q, k, v, i=i):
            ck, cv = update_kv_cache(cache_k[i], cache_v[i], k, v, pos)
            return mha_decode_step(q, ck, cv, pos + 1)

        x = _block(lp, cfg, x, sin, cos, attend)
    x = layer_norm(params["final_ln"], x, cfg.layer_norm_eps)
    return _logits(params, x[:, 0]), cache_k, cache_v


def _cache_shape(cfg: GPTNeoXConfig, b: int, max_len: int) -> tuple:
    return (cfg.n_layer, b, cfg.n_head, max_len, cfg.head_dim)


def generate_ragged(params: dict, cfg: GPTNeoXConfig, prompt, prompt_lens,
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
        sampling_cfg=sc, cache_dtype=dtype, key=("gptneox", cfg))


def generate(params: dict, cfg: GPTNeoXConfig, prompt, max_new_tokens: int,
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
        key=("gptneox", cfg))


def generate_beam(params: dict, cfg: GPTNeoXConfig, prompt,
                  max_new_tokens: int, num_beams: int,
                  length_penalty: float = 1.0, device=None):
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
        key=("gptneox", cfg))


# -- HF conversion ----------------------------------------------------------------

def convert_hf_gptneox(hf_model, device=None) -> Tuple[dict, GPTNeoXConfig]:
    """transformers ``GPTNeoXForCausalLM`` → (tensor tree on ``device``, the
    card by default, config). HF's fused ``query_key_value`` weight
    (3·d, d) is (heads, 3, dh, d) per head: split into q, k and v."""
    dev = resolve_device(device)
    hc = hf_model.config
    cfg = GPTNeoXConfig(
        vocab_size=hc.vocab_size, max_positions=hc.max_position_embeddings,
        d_model=hc.hidden_size, n_layer=hc.num_hidden_layers,
        n_head=hc.num_attention_heads, rotary_pct=hc.rotary_pct,
        rope_theta=hc.rotary_emb_base, ffn_dim=hc.intermediate_size,
        activation=hc.hidden_act, layer_norm_eps=hc.layer_norm_eps,
        use_parallel_residual=hc.use_parallel_residual,
        eos_token_id=hc.eos_token_id if hc.eos_token_id is not None else 0,
    )
    d, h, dh = cfg.d_model, cfg.n_head, cfg.head_dim
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
        p = f"gpt_neox.layers.{i}"
        qkv_w = sd[p + ".attention.query_key_value.weight"].reshape(h, 3, dh,
                                                                    d)
        qkv_b = sd[p + ".attention.query_key_value.bias"].reshape(h, 3, dh)

        def proj(j):
            return {"kernel": np.ascontiguousarray(qkv_w[:, j].reshape(d, d).T),
                    "bias": qkv_b[:, j].reshape(d)}

        layers.append({
            "input_ln": ln(p + ".input_layernorm"),
            "q": proj(0),
            "k": proj(1),
            "v": proj(2),
            "attn_out": lin(p + ".attention.dense"),
            "post_attn_ln": ln(p + ".post_attention_layernorm"),
            "fc_in": lin(p + ".mlp.dense_h_to_4h"),
            "fc_out": lin(p + ".mlp.dense_4h_to_h"),
        })
    return params_from_numpy({
        "embed_in": sd["gpt_neox.embed_in.weight"],
        "layers": stack(layers),
        "final_ln": ln("gpt_neox.final_layer_norm"),
        "embed_out": lin("embed_out", bias=False),
    }, dev), cfg
