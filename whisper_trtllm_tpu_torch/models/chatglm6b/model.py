"""ChatGLM-6B decoder-only model (counterpart of
``whisper_trtllm_tpu/models/chatglm6b/model.py``): 2D rotary embeddings
(head_dim in two halves, half 0 rotated by the position channel, half 1
by the block-position channel, each in the half-rotation layout), GLM's
post-LN residual ``x = ln(x) * alpha + branch`` with ``alpha =
sqrt(2 L)``, the prefix-LM mask (the prompt visible to every position,
generated positions causal among themselves), per-head-interleaved fused
QKV split at conversion, a GELU MLP and a separate (untied) ``lm_head``.

Position ids follow GLM's convention (``build_position_ids``): channel 0
counts 0..ctx-1 then stays at the [gMASK] position, channel 1 is 0 over
the prompt, then 1, 2, ... a generated token.

On the card every LayerNorm runs K5 (2L + 1 a pass: ``input_ln`` and
``post_ln`` a layer, ``final_ln``) and every step's attention K2 (one a
layer). The prefix-LM prefill is plain attention in the JAX package
(einsums in XLA), so here it is torch matmuls on either device: no K1. In
a step ``mask_pos``, ``ctx_len`` and ``pos`` are Python ints and a 0-d
position in lockstep, (B,) device tensors in ragged batches (the loop's
own state, ``causal_lm``'s ``step_lens``), so a replayed step reads the
values of its call.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional

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
from whisper_trtllm_tpu_torch.ops.kernels.decode_attention import MASK_VALUE
from whisper_trtllm_tpu_torch.runtime import beam_lm, causal_lm
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy
from whisper_trtllm_tpu_torch.utils.device import resolve_device, to_tensor


@dataclass(frozen=True)
class ChatGLM6BConfig:
    vocab_size: int = 130528
    max_positions: int = 2048
    d_model: int = 4096
    n_layer: int = 28
    n_head: int = 32
    ffn_dim: int = 16384
    activation: str = "gelu"
    eos_token_id: int = 130005

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def residual_alpha(self) -> float:
        return (2.0 * self.n_layer) ** 0.5

    @classmethod
    def testing(cls, **overrides) -> "ChatGLM6BConfig":
        kw = dict(vocab_size=89, max_positions=32, d_model=32, n_layer=2,
                  n_head=4, ffn_dim=64, eos_token_id=2)
        kw.update(overrides)
        return cls(**kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def build_position_ids(seq_len: int, mask_pos: int,
                       ctx_len: int) -> np.ndarray:
    """GLM's 2-channel position ids (2, S) int32 of one sequence whose
    prompt fills [0, ctx_len) with the [gMASK] at ``mask_pos``."""
    pos = np.arange(seq_len, dtype=np.int32)
    pos = np.where(pos < ctx_len, pos, mask_pos).astype(np.int32)
    block = np.maximum(np.arange(seq_len, dtype=np.int32) - (ctx_len - 1), 0)
    return np.stack([pos, block], axis=0)


def glm_rope_tables(half: int, positions: torch.Tensor):
    """positions (...,) → fp32 cos, sin (..., half) in the half-rotation
    layout over ``half`` dims (the closed form of GLM's tables)."""
    inv_freq = 1.0 / (10000.0 ** (
        torch.arange(0, half, 2, dtype=torch.float32,
                     device=positions.device) / half))
    angles = positions.float()[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_2d_rope(x: torch.Tensor, cos0, sin0, cos1, sin1) -> torch.Tensor:
    """x (B, H, S, dh): half 0 rotated by the position channel's tables
    (B, S, dh/2), half 1 by the block-position channel's; x's dtype."""
    half = x.shape[-1] // 2
    x0, x1 = x[..., :half], x[..., half:]
    y0 = x0 * cos0[:, None] + _rotate_half(x0) * sin0[:, None]
    y1 = x1 * cos1[:, None] + _rotate_half(x1) * sin1[:, None]
    return torch.cat([y0, y1], dim=-1).to(x.dtype)


def _init_layer(rng, cfg: ChatGLM6BConfig) -> dict:
    d = cfg.d_model
    return {
        "input_ln": init_layer_norm(d),
        "q": init_dense(rng, d, d),
        "k": init_dense(rng, d, d),
        "v": init_dense(rng, d, d),
        "attn_out": init_dense(rng, d, d),
        "post_ln": init_layer_norm(d),
        "fc_in": init_dense(rng, d, cfg.ffn_dim),
        "fc_out": init_dense(rng, cfg.ffn_dim, d),
    }


def init_params(cfg: ChatGLM6BConfig, seed: int = 0, device=None) -> dict:
    """Random weights in the JAX package's draw order (bit-equal to its
    ``init_params``), fp32 tensors on ``device`` (the card by default)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    layers = [_init_layer(rng, cfg) for _ in range(cfg.n_layer)]
    return params_from_numpy({
        "embed_tokens": init_embedding(rng, cfg.vocab_size, cfg.d_model),
        "layers": stack(layers),
        "final_ln": init_layer_norm(cfg.d_model),
        "lm_head": init_dense(rng, cfg.d_model, cfg.vocab_size, bias=False),
    }, dev)


def _tables(cfg: ChatGLM6BConfig, position_ids: torch.Tensor):
    """(B, 2, S) position ids → the two channels' cos and sin tables."""
    quarter = cfg.head_dim // 2
    return (*glm_rope_tables(quarter, position_ids[:, 0]),
            *glm_rope_tables(quarter, position_ids[:, 1]))


def _block(lp, cfg: ChatGLM6BConfig, x, tables, attend):
    """One GLM block: post-LN residuals scaled by ``alpha``; ``attend(q, k,
    v)`` (q pre-scaled, both rotated) gives the attention."""
    h, dh, alpha = cfg.n_head, cfg.head_dim, cfg.residual_alpha
    hid = layer_norm(lp["input_ln"], x)
    q = apply_2d_rope(split_heads(dense(lp["q"], hid), h, dh), *tables)
    k = apply_2d_rope(split_heads(dense(lp["k"], hid), h, dh), *tables)
    a = attend(q * dh ** -0.5, k, split_heads(dense(lp["v"], hid), h, dh))
    x = hid * alpha + dense(lp["attn_out"], merge_heads(a))
    hid = layer_norm(lp["post_ln"], x)
    return hid * alpha + dense(
        lp["fc_out"], ACT2FN[cfg.activation](dense(lp["fc_in"], hid)))


def _prefix_attention(q, k, v, allowed):
    """The JAX package's prefix-LM attention: fp32 scores, -1e9 where not
    ``allowed``, an fp32 softmax cast to v's dtype, P·V."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores.masked_fill(~allowed, MASK_VALUE)
    return torch.matmul(torch.softmax(scores, dim=-1).to(v.dtype), v)


def _allowed(s: int, ctx_len, device) -> torch.Tensor:
    """The prefix-LM mask, broadcastable to (B, H, S, S): a key is visible
    when it lies in the prompt (``ctx_len``, an int or (B,)) or not after
    the query."""
    q_pos = torch.arange(s, device=device)[:, None]
    k_pos = torch.arange(s, device=device)[None, :]
    causal = k_pos <= q_pos
    if isinstance(ctx_len, torch.Tensor) and ctx_len.dim() == 1:
        return ((k_pos[None] < ctx_len[:, None, None]) | causal[None])[:, None]
    return ((k_pos < ctx_len) | causal)[None, None]


def _hidden(params, cfg: ChatGLM6BConfig, tokens, position_ids, ctx_len,
            cache_k, cache_v):
    """The prefix-LM pass: final hidden states (B, S, d); the post-rope K
    and V written into rows [0, S) of the caches when they are given."""
    x = embedding(params["embed_tokens"], tokens)
    tables = _tables(cfg, position_ids)
    allowed = _allowed(tokens.shape[1], ctx_len, x.device)
    for i in range(cfg.n_layer):
        def attend(q, k, v, i=i):
            if cache_k is not None:
                write_prefix(cache_k[i], k)
                write_prefix(cache_v[i], v)
            return _prefix_attention(q, k, v, allowed)

        x = _block(layer(params["layers"], i), cfg, x, tables, attend)
    return layer_norm(params["final_ln"], x)


def _logits(params, x):
    return dense(params["lm_head"], x).float()


@torch.inference_mode()
def forward(params: dict, cfg: ChatGLM6BConfig, tokens, position_ids,
            ctx_len: int) -> torch.Tensor:
    """Teacher-forced: tokens (B, S), position_ids (B, 2, S) → logits
    (B, S, V) fp32; positions < ``ctx_len`` are visible to all, the rest
    causal."""
    dev = params["embed_tokens"].device
    tokens = to_tensor(tokens, dev, torch.int64)
    position_ids = to_tensor(position_ids, dev, torch.int32)
    return _logits(params, _hidden(params, cfg, tokens, position_ids,
                                   ctx_len, None, None))


def _prefill(params, cfg: ChatGLM6BConfig, tokens, position_ids, ctx_len,
             cache_k, cache_v):
    """Context phase: the prefix-LM pass writing the caches; logits at the
    last position, or with a (B,) ``ctx_len`` at each row's last valid
    one."""
    x = _hidden(params, cfg, tokens, position_ids, ctx_len, cache_k, cache_v)
    if isinstance(ctx_len, torch.Tensor) and ctx_len.dim() == 1:
        x_last = gather_last_token_logits(x, ctx_len)
    else:
        x_last = x[:, -1]
    return _logits(params, x_last), cache_k, cache_v


def _step(params, cfg: ChatGLM6BConfig, tok, pos, mask_pos, ctx_len,
          cache_k, cache_v):
    """Generation phase at ``pos``: channel 0 at the [gMASK] position,
    channel 1 at ``pos - (ctx_len - 1)``; every cached row is visible (the
    prompt is bidirectional and every generated token precedes the
    query), so the valid length alone masks."""
    b = tok.shape[0]
    x = embedding(params["embed_tokens"], tok[:, None])
    lanes = torch.zeros(b, dtype=torch.int32, device=x.device)
    p0 = (lanes + mask_pos)[:, None]
    p1 = (lanes + pos - (ctx_len - 1))[:, None]
    quarter = cfg.head_dim // 2
    tables = (*glm_rope_tables(quarter, p0), *glm_rope_tables(quarter, p1))
    for i in range(cfg.n_layer):
        def attend(q, k, v, i=i):
            ck, cv = update_kv_cache(cache_k[i], cache_v[i], k, v, pos)
            return mha_decode_step(q, ck, cv, pos + 1)

        x = _block(layer(params["layers"], i), cfg, x, tables, attend)
    x = layer_norm(params["final_ln"], x)
    return _logits(params, x[:, 0]), cache_k, cache_v


def _prefill_ragged(params, cfg: ChatGLM6BConfig, tokens, lens, cache_k,
                    cache_v):
    """Context phase over a right-padded batch: per-row position ids
    (channel 0 the positions, held at the row's [gMASK], ``lens - 2``,
    past its prompt; channel 1 zero over it), the per-row prefix mask,
    logits at each row's last valid position."""
    s = tokens.shape[1]
    ar = torch.arange(s, dtype=torch.int32, device=tokens.device)
    lens = lens.to(torch.int32)
    pos0 = torch.where(ar[None] < lens[:, None], ar[None],
                       (lens - 2)[:, None])
    pos1 = (ar[None] - (lens[:, None] - 1)).clamp(min=0)
    return _prefill(params, cfg, tokens, torch.stack([pos0, pos1], dim=1),
                    lens, cache_k, cache_v)


def _cache_shape(cfg: ChatGLM6BConfig, b: int, max_len: int) -> tuple:
    return (cfg.n_layer, b, cfg.n_head, max_len, cfg.head_dim)


def _prompt_positions(prompt: torch.Tensor, mask_pos: int) -> torch.Tensor:
    b, p = prompt.shape
    ids = torch.from_numpy(build_position_ids(p, mask_pos, p))
    return ids.to(prompt.device)[None].expand(b, 2, p)


def generate(params: dict, cfg: ChatGLM6BConfig, prompt,
             max_new_tokens: int, mask_pos: Optional[int] = None,
             temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
             repetition_penalty: float = 1.0, seed: int = 0,
             do_sample: bool = False, device=None,
             sampling_cfg=None) -> torch.Tensor:
    """KV-cached GLM generation through the shared causal-LM loop:
    ``mask_pos`` is the [gMASK] index of the prompt (the second-to-last
    position by default, GLM's prompt + [gMASK] + <sop>)."""
    prompt, dtype = prepare(params, prompt, device)
    b, prompt_len = prompt.shape
    mask_pos = prompt_len - 2 if mask_pos is None else int(mask_pos)
    max_len = min(cfg.max_positions, prompt_len + max_new_tokens)
    sc = sampling_cfg or causal_lm.make_sampling_cfg(
        temperature, top_k, top_p, repetition_penalty, seed, do_sample)
    ids = _prompt_positions(prompt, mask_pos)
    return causal_lm.generate_tokens(
        lambda pr, t, ck, cv: _prefill(pr, cfg, t, ids, prompt_len, ck, cv),
        lambda pr, tok, pos, ck, cv: _step(pr, cfg, tok, pos, mask_pos,
                                           prompt_len, ck, cv),
        params, prompt, cache_shape=_cache_shape(cfg, b, max_len),
        prompt_len=prompt_len, max_len=max_len,
        eos_token_id=cfg.eos_token_id, sampling_cfg=sc, cache_dtype=dtype,
        key=("chatglm6b", cfg, mask_pos))


def generate_ragged(params: dict, cfg: ChatGLM6BConfig, prompt, prompt_lens,
                    max_new_tokens: int, temperature: float = 1.0,
                    top_k: int = 0, top_p: float = 0.0,
                    repetition_penalty: float = 1.0, seed: int = 0,
                    do_sample: bool = False, device=None,
                    sampling_cfg=None) -> torch.Tensor:
    """Ragged GLM generation: each lane its own [gMASK] index
    (``lens - 2``), prefix boundary and block positions."""
    prompt, dtype = prepare(params, prompt, device)
    sc = sampling_cfg or causal_lm.make_sampling_cfg(
        temperature, top_k, top_p, repetition_penalty, seed, do_sample)
    lens = to_tensor(prompt_lens, prompt.device, torch.int32)
    b, p = prompt.shape
    return causal_lm.generate_tokens_ragged(
        lambda pr, t, ln, ck, cv: _prefill_ragged(pr, cfg, t, ln, ck, cv),
        lambda pr, tok, pos, ck, cv, ln: _step(pr, cfg, tok, pos, ln - 2, ln,
                                               ck, cv),
        params, prompt, lens,
        cache_shape=_cache_shape(cfg, b, p + max_new_tokens),
        max_new_tokens=max_new_tokens, eos_token_id=cfg.eos_token_id,
        sampling_cfg=sc, cache_dtype=dtype, key=("chatglm6b", cfg),
        step_lens=True)


def generate_beam(params: dict, cfg: ChatGLM6BConfig, prompt,
                  max_new_tokens: int, num_beams: int,
                  length_penalty: float = 1.0,
                  mask_pos: Optional[int] = None, device=None):
    """GLM beam search (HF ``early_stopping=True``): wired here, not by
    ``beam_lm.make_generate_beam``, because the step's position ids are
    (``mask_pos``, ``pos - ctx_len + 1``), not ``pos``. The prefill runs
    once a lane at beam width 1; the loop tiles the caches K-wide."""
    prompt, dtype = prepare(params, prompt, device)
    b, p = prompt.shape
    mask_pos = p - 2 if mask_pos is None else int(mask_pos)
    if p + max_new_tokens > cfg.max_positions:
        raise ValueError("prompt_len + max_new_tokens exceeds max_positions")
    ids = _prompt_positions(prompt, mask_pos)
    return beam_lm.beam_generate_tokens(
        lambda pr, t, ck, cv: _prefill(pr, cfg, t, ids, p, ck, cv),
        lambda pr, tok, pos, ck, cv: _step(pr, cfg, tok, pos, mask_pos, p,
                                           ck, cv),
        params, prompt, cache_shape=_cache_shape(cfg, b, p + max_new_tokens),
        prompt_len=p, max_new_tokens=max_new_tokens,
        eos_token_id=cfg.eos_token_id, num_beams=num_beams,
        length_penalty=float(length_penalty), cache_dtype=dtype,
        key=("chatglm6b", cfg, mask_pos))


def convert_hf_chatglm6b(state_dict: dict, cfg: ChatGLM6BConfig,
                         device=None) -> dict:
    """A THUDM/chatglm-6b state dict (numpy arrays, its own key names) →
    a tensor tree on ``device`` (the card by default). The fused
    ``query_key_value`` (3·d, d) is (heads, 3, dh, d) per head: split into
    q, k and v."""
    dev = resolve_device(device)
    sd = state_dict
    d, h, dh = cfg.d_model, cfg.n_head, cfg.head_dim

    def ln(p):
        return {"scale": sd[p + ".weight"], "bias": sd[p + ".bias"]}

    def lin(p):
        return {"kernel": np.ascontiguousarray(sd[p + ".weight"].T),
                "bias": sd[p + ".bias"]}

    layers = []
    for i in range(cfg.n_layer):
        p = f"transformer.layers.{i}"
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
            "post_ln": ln(p + ".post_attention_layernorm"),
            "fc_in": lin(p + ".mlp.dense_h_to_4h"),
            "fc_out": lin(p + ".mlp.dense_4h_to_h"),
        })
    return params_from_numpy({
        "embed_tokens": sd["transformer.word_embeddings.weight"],
        "layers": stack(layers),
        "final_ln": ln("transformer.final_layernorm"),
        "lm_head": {"kernel": np.ascontiguousarray(sd["lm_head.weight"].T)},
    }, dev)
