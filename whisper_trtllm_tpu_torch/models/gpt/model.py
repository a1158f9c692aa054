"""GPT-style decoder-only model (counterpart of
``whisper_trtllm_tpu/models/gpt/model.py``): stacked layers, a static KV
cache, fused-QKV attention, a prefill pass and a one-token step, with
greedy, sampled, ragged, p-tuned and beam generation through
``runtime/causal_lm.py`` and ``runtime/beam_lm.py``. Weights follow HF
GPT-2's layout.

On the card the prefill's causal attention runs K1 from 768 positions on
(``ops/attention.py::mha``, the JAX package's dispatch), every LayerNorm
K5 (2L + 1 a pass: ``ln_1`` and ``ln_2`` a layer, ``ln_f``), every step's
attention K2 (one a layer); the products and the tied vocab head are torch
matmuls, as the JAX package runs them in XLA. The paged pair
(``_prefill_paged``, ``_step_paged``) runs the same layers against pools
(L, num_blocks, tpb, H, dh) addressed by block tables: the paged batcher
(``runtime/ifb_paged.py``) and the paged beam search
(``runtime/beam_paged.py``) drive it, K2 attending each lane's blocks
gathered into a window (``ops/attention.py::paged_mha_decode_step``).
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
    paged_mha_decode_step,
    paged_prefill_update,
    paged_update_kv_cache,
    update_kv_cache,
)
from whisper_trtllm_tpu_torch.ops.functional import (
    ACT2FN,
    dense,
    embedding,
    gather_last_token_logits,
    layer_norm,
    prompt_tuning_embedding,
)
from whisper_trtllm_tpu_torch.runtime import beam_lm, causal_lm
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy
from whisper_trtllm_tpu_torch.utils.device import resolve_device, to_tensor


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    n_positions: int = 1024
    d_model: int = 768
    n_layer: int = 12
    n_head: int = 12
    ffn_dim: int = 3072
    activation: str = "gelu_new"
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 50256

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @classmethod
    def testing(cls, **overrides) -> "GPTConfig":
        kw = dict(vocab_size=89, n_positions=32, d_model=32, n_layer=2,
                  n_head=4, ffn_dim=64, eos_token_id=2)
        kw.update(overrides)
        return cls(**kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def _init_layer(rng, cfg: GPTConfig) -> dict:
    d = cfg.d_model
    return {
        "ln_1": init_layer_norm(d),
        "attn_qkv": init_dense(rng, d, 3 * d),
        "attn_out": init_dense(rng, d, d),
        "ln_2": init_layer_norm(d),
        "fc_in": init_dense(rng, d, cfg.ffn_dim),
        "fc_out": init_dense(rng, cfg.ffn_dim, d),
    }


def init_params(cfg: GPTConfig, seed: int = 0, device=None) -> dict:
    """Random weights drawn in numpy in the JAX package's order (equal to
    its ``init_params(cfg, seed)`` bit for bit), as fp32 tensors on
    ``device`` (the CUDA card by default)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    layers = [_init_layer(rng, cfg) for _ in range(cfg.n_layer)]
    return params_from_numpy({
        "wte": init_embedding(rng, cfg.vocab_size, cfg.d_model),
        "wpe": init_embedding(rng, cfg.n_positions, cfg.d_model),
        "layers": stack(layers),
        "ln_f": init_layer_norm(cfg.d_model),
    }, dev)


def _attention(lp, x, cfg: GPTConfig, causal: bool):
    qkv = dense(lp["attn_qkv"], layer_norm(lp["ln_1"], x, cfg.layer_norm_eps))
    q, k, v = qkv.split(cfg.d_model, dim=-1)
    h, dh = cfg.n_head, cfg.head_dim
    # GPT scales the scores by 1/sqrt(dh): folded into q
    q = split_heads(q, h, dh) * dh ** -0.5
    k, v = split_heads(k, h, dh), split_heads(v, h, dh)
    a = mha(q, k, v, causal=causal)
    return dense(lp["attn_out"], merge_heads(a)), k, v


def _mlp(lp, x, cfg: GPTConfig):
    h = layer_norm(lp["ln_2"], x, cfg.layer_norm_eps)
    return dense(lp["fc_out"], ACT2FN[cfg.activation](dense(lp["fc_in"], h)))


def _embed(params, cfg: GPTConfig, tokens, ptuning):
    """Token embedding, with per-task virtual prompt tokens when
    ``ptuning`` = (prompt_table, tasks): ids >= vocab_size index the
    task's page of the table."""
    if ptuning is None:
        return embedding(params["wte"], tokens)
    prompt_table, tasks = ptuning
    return prompt_tuning_embedding(params["wte"], prompt_table, tokens,
                                   tasks)


@torch.inference_mode()
def forward(params: dict, cfg: GPTConfig, tokens,
            position_offset: int = 0, ptuning=None) -> torch.Tensor:
    """Teacher-forced forward: tokens (B, S) → logits (B, S, V) fp32, on
    the parameters' device."""
    tokens = to_tensor(tokens, params["wte"].device, torch.int64)
    s = tokens.shape[1]
    x = _embed(params, cfg, tokens, ptuning)
    x = x + params["wpe"][position_offset:position_offset + s][None]
    for i in range(cfg.n_layer):
        lp = layer(params["layers"], i)
        a, _, _ = _attention(lp, x, cfg, causal=True)
        x = x + a
        x = x + _mlp(lp, x, cfg)
    x = layer_norm(params["ln_f"], x, cfg.layer_norm_eps)
    return tied_logits(params["wte"], x)


def _prefill_hidden(params, cfg: GPTConfig, tokens, cache_k, cache_v,
                    ptuning=None):
    """Context phase: the whole prompt once, its K/V written into rows
    [0, S) of the caches in place. Returns the final hidden states
    (B, S, d). ``ptuning`` applies here only: generated ids come from
    vocab logits, so the step never sees a virtual token."""
    s = tokens.shape[1]
    x = _embed(params, cfg, tokens, ptuning)
    x = x + params["wpe"][:s][None]
    for i in range(cfg.n_layer):
        lp = layer(params["layers"], i)
        a, k, v = _attention(lp, x, cfg, causal=True)
        write_prefix(cache_k[i], k)
        write_prefix(cache_v[i], v)
        x = x + a
        x = x + _mlp(lp, x, cfg)
    return layer_norm(params["ln_f"], x, cfg.layer_norm_eps), cache_k, cache_v


def _vocab_logits(params, x):
    return tied_logits(params["wte"], x)


def _prefill(params, cfg: GPTConfig, tokens, cache_k, cache_v, ptuning=None):
    x, cache_k, cache_v = _prefill_hidden(params, cfg, tokens, cache_k,
                                          cache_v, ptuning)
    return _vocab_logits(params, x[:, -1]), cache_k, cache_v


def _step(params, cfg: GPTConfig, tok, pos, cache_k, cache_v):
    """Generation phase: one token for the whole batch at ``pos``, a 0-d
    tensor (lockstep) or (B,) (ragged: per-lane rows and lengths); each
    layer appends its K/V at ``pos`` and attends to ``pos + 1`` rows."""
    h, dh = cfg.n_head, cfg.head_dim
    x = embedding(params["wte"], tok[:, None])
    x = x + position_rows(params["wpe"], pos)
    for i in range(cfg.n_layer):
        lp = layer(params["layers"], i)
        hid = layer_norm(lp["ln_1"], x, cfg.layer_norm_eps)
        q, k, v = dense(lp["attn_qkv"], hid).split(cfg.d_model, dim=-1)
        q = split_heads(q, h, dh) * dh ** -0.5
        ck, cv = update_kv_cache(cache_k[i], cache_v[i], split_heads(k, h, dh),
                                 split_heads(v, h, dh), pos)
        a = mha_decode_step(q, ck, cv, pos + 1)
        x = x + dense(lp["attn_out"], merge_heads(a))
        x = x + _mlp(lp, x, cfg)
    x = layer_norm(params["ln_f"], x, cfg.layer_norm_eps)
    return _vocab_logits(params, x[:, 0]), cache_k, cache_v


def _prefill_ragged(params, cfg: GPTConfig, tokens, lens, cache_k, cache_v):
    """Context phase over a right-padded batch: each row's logits from its
    own last valid position."""
    x, cache_k, cache_v = _prefill_hidden(params, cfg, tokens, cache_k,
                                          cache_v)
    return (_vocab_logits(params, gather_last_token_logits(x, lens)),
            cache_k, cache_v)


def _prefill_paged(params, cfg: GPTConfig, tokens, lens, pool_k, pool_v,
                   block_tables):
    """Context phase against a paged KV cache: ``_prefill_ragged``'s graph,
    with each layer's K/V written through the block tables (B, M) into its
    pools (``pool_k[i]``, (num_blocks, tpb, H, dh)) in place; one table
    serves every layer. Positions at or past ``lens`` are dropped."""
    s = tokens.shape[1]
    x = embedding(params["wte"], tokens)
    x = x + params["wpe"][:s][None]
    for i in range(cfg.n_layer):
        lp = layer(params["layers"], i)
        a, k, v = _attention(lp, x, cfg, causal=True)
        paged_prefill_update(pool_k[i], pool_v[i], k, v, block_tables, lens)
        x = x + a
        x = x + _mlp(lp, x, cfg)
    x = layer_norm(params["ln_f"], x, cfg.layer_norm_eps)
    return (_vocab_logits(params, gather_last_token_logits(x, lens)),
            pool_k, pool_v)


def _step_paged(params, cfg: GPTConfig, tok, pos, pool_k, pool_v,
                block_tables):
    """Generation phase against the paged cache: ``_step``'s layers with
    the write and the attention through the block tables (B, M); ``pos``
    is per lane (B,). A lane whose table entry is -1 writes nothing."""
    h, dh = cfg.n_head, cfg.head_dim
    x = embedding(params["wte"], tok[:, None])
    x = x + position_rows(params["wpe"], pos)
    for i in range(cfg.n_layer):
        lp = layer(params["layers"], i)
        hid = layer_norm(lp["ln_1"], x, cfg.layer_norm_eps)
        q, k, v = dense(lp["attn_qkv"], hid).split(cfg.d_model, dim=-1)
        q = split_heads(q, h, dh) * dh ** -0.5
        paged_update_kv_cache(pool_k[i], pool_v[i], split_heads(k, h, dh),
                              split_heads(v, h, dh), block_tables, pos)
        a = paged_mha_decode_step(q, pool_k[i], pool_v[i], block_tables,
                                  pos + 1)
        x = x + dense(lp["attn_out"], merge_heads(a))
        x = x + _mlp(lp, x, cfg)
    x = layer_norm(params["ln_f"], x, cfg.layer_norm_eps)
    return _vocab_logits(params, x[:, 0]), pool_k, pool_v


def _cache_shape(cfg: GPTConfig, b: int, max_len: int) -> tuple:
    return (cfg.n_layer, b, cfg.n_head, max_len, cfg.head_dim)


def generate_ragged(params: dict, cfg: GPTConfig, prompt, prompt_lens,
                    max_new_tokens: int, temperature: float = 1.0,
                    top_k: int = 0, top_p: float = 0.0,
                    repetition_penalty: float = 1.0, seed: int = 0,
                    do_sample: bool = False, device=None,
                    sampling_cfg=None) -> torch.Tensor:
    """Batched generation over right-padded prompts (B, P) of lengths
    ``prompt_lens``: tokens (B, P + max_new_tokens), each row what its own
    ``generate`` would give. ``sampling_cfg`` (``causal_lm.
    make_sampling_cfg``) takes the place of the knobs when given."""
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
        sampling_cfg=sc, cache_dtype=dtype, key=("gpt", cfg))


def generate(params: dict, cfg: GPTConfig, prompt, max_new_tokens: int,
             temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
             repetition_penalty: float = 1.0, seed: int = 0,
             do_sample: bool = False, device=None,
             sampling_cfg=None) -> torch.Tensor:
    """prompt (B, P) → tokens (B, min(n_positions, P + max_new_tokens)):
    greedy by default, the knobs the reference's sampling config's; on
    ``device`` (the CUDA card by default), where ``params`` must lie.
    ``sampling_cfg`` (``causal_lm.make_sampling_cfg``, for the word lists
    and the other penalties) takes the place of the knobs when given."""
    prompt, dtype = prepare(params, prompt, device)
    b, prompt_len = prompt.shape
    max_len = min(cfg.n_positions, prompt_len + max_new_tokens)
    sc = sampling_cfg or causal_lm.make_sampling_cfg(
        temperature, top_k, top_p, repetition_penalty, seed, do_sample)
    return causal_lm.generate_tokens(
        lambda pr, t, ck, cv: _prefill(pr, cfg, t, ck, cv),
        lambda pr, tok, pos, ck, cv: _step(pr, cfg, tok, pos, ck, cv),
        params, prompt, cache_shape=_cache_shape(cfg, b, max_len),
        prompt_len=prompt_len, max_len=max_len,
        eos_token_id=cfg.eos_token_id, sampling_cfg=sc, cache_dtype=dtype,
        key=("gpt", cfg))


def generate_ptuning(params: dict, cfg: GPTConfig, prompt, prompt_table,
                     tasks, max_new_tokens: int, device=None) -> torch.Tensor:
    """Greedy generation where the prompt may hold virtual tokens (ids >=
    vocab_size) resolved against a per-task prompt-embedding table
    (num_tasks, task_vocab, d); ``tasks`` (B,)."""
    prompt, dtype = prepare(params, prompt, device)
    dev = prompt.device
    table = to_tensor(prompt_table, dev, dtype)
    tasks = to_tensor(tasks, dev, torch.int64)
    b, prompt_len = prompt.shape
    max_len = min(cfg.n_positions, prompt_len + max_new_tokens)
    return causal_lm.generate_tokens(
        lambda pr, t, ck, cv: _prefill(pr, cfg, t, ck, cv, (table, tasks)),
        lambda pr, tok, pos, ck, cv: _step(pr, cfg, tok, pos, ck, cv),
        params, prompt, cache_shape=_cache_shape(cfg, b, max_len),
        prompt_len=prompt_len, max_len=max_len,
        eos_token_id=cfg.eos_token_id, cache_dtype=dtype,
        key=("gpt", cfg))


def generate_beam(params: dict, cfg: GPTConfig, prompt, max_new_tokens: int,
                  num_beams: int, length_penalty: float = 1.0, device=None):
    """Beam search (HF ``early_stopping=True``): prompt (B, P) → (tokens
    (B, K, P + max_new_tokens) best-first, scores, lengths)."""
    prompt, dtype = prepare(params, prompt, device)
    b, p = prompt.shape
    if p + max_new_tokens > cfg.n_positions:
        raise ValueError("prompt_len + max_new_tokens exceeds n_positions")
    return beam_lm.beam_generate_tokens(
        lambda pr, t, ck, cv: _prefill(pr, cfg, t, ck, cv),
        lambda pr, tok, pos, ck, cv: _step(pr, cfg, tok, pos, ck, cv),
        params, prompt, cache_shape=_cache_shape(cfg, b, p + max_new_tokens),
        prompt_len=p, max_new_tokens=max_new_tokens,
        eos_token_id=cfg.eos_token_id, num_beams=num_beams,
        length_penalty=float(length_penalty), cache_dtype=dtype,
        key=("gpt", cfg))


# -- HF GPT-2 conversion -------------------------------------------------------

def convert_hf_gpt2(hf_model, device=None) -> Tuple[dict, GPTConfig]:
    """transformers ``GPT2LMHeadModel`` → (the parameter tree as tensors on
    ``device``, the CUDA card by default, config). GPT-2's Conv1D weights
    are already (in, out)."""
    dev = resolve_device(device)
    hc = hf_model.config
    cfg = GPTConfig(
        vocab_size=hc.vocab_size, n_positions=hc.n_positions,
        d_model=hc.n_embd, n_layer=hc.n_layer, n_head=hc.n_head,
        ffn_dim=4 * hc.n_embd,
        activation="gelu_new" if hc.activation_function in ("gelu_new", "gelu")
        else hc.activation_function,
        layer_norm_eps=hc.layer_norm_epsilon,
        eos_token_id=hc.eos_token_id if hc.eos_token_id is not None else 50256,
    )
    sd = {k: v.detach().cpu().float().numpy()
          for k, v in hf_model.state_dict().items()}

    def ln(p):
        return {"scale": sd[p + ".weight"], "bias": sd[p + ".bias"]}

    def lin(p):
        return {"kernel": sd[p + ".weight"], "bias": sd[p + ".bias"]}

    layers = []
    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}"
        layers.append({
            "ln_1": ln(p + ".ln_1"),
            "attn_qkv": lin(p + ".attn.c_attn"),
            "attn_out": lin(p + ".attn.c_proj"),
            "ln_2": ln(p + ".ln_2"),
            "fc_in": lin(p + ".mlp.c_fc"),
            "fc_out": lin(p + ".mlp.c_proj"),
        })
    return params_from_numpy({
        "wte": sd["transformer.wte.weight"],
        "wpe": sd["transformer.wpe.weight"],
        "layers": stack(layers),
        "ln_f": ln("transformer.ln_f"),
    }, dev), cfg
