"""Whisper encoder/decoder (counterpart of
``whisper_trtllm_tpu/models/whisper/model.py``, the functions the greedy
path and the training path run).

Parameters are the JAX package's tree as tensors: layers stacked on a
leading L axis, walked here by a Python loop where the JAX package scans.
Decoding runs against static caches: the self-attention cache is
preallocated at ``max_len`` and written in place at ``pos``; cross-attention
K/V are computed once per utterance. Caches are float 2-tuples (k, v) or
quantized 4-tuples (k values, k scales, v values, v scales), and the cross
cache may be stored T-minor (``transpose_cross_kv``). On the card, a decode
step with float weights and float dh-minor caches runs each layer after
its cache append as one fused launch (kernel K6, ``_decode_step_fused``).
``decode_step_ragged_kv`` takes a position per lane (the in-flight
batcher's step) and always runs the unfused layer; ``decode_chunk`` takes
S tokens against the self cache in one pass (the speculative round's
verification).
The teacher-forced ``decode_full`` and ``encode(remat=True)`` serve
training (``training/train.py``): every op on them is differentiable.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from whisper_trtllm_tpu_torch.config import WhisperConfig
from whisper_trtllm_tpu_torch.layers.init import (
    init_attention,
    init_conv1d,
    init_dense,
    init_embedding,
    init_layer_norm,
)
from whisper_trtllm_tpu_torch.layers.transformer import (
    attention_qkv,
    merge_heads,
    mlp_block,
    split_heads,
)
from whisper_trtllm_tpu_torch.ops.attention import (
    mha,
    mha_decode_step,
    quantize_kv,
    update_kv_cache,
)
from whisper_trtllm_tpu_torch.ops.functional import (
    conv1d,
    dense,
    embedding,
    gelu,
    layer_norm,
    sinusoid_position_embedding,
)
from whisper_trtllm_tpu_torch.ops.kernels._build import tracing
from whisper_trtllm_tpu_torch.ops.kernels.fused_decoder_step import (
    fused_decoder_layer_step,
    fused_layer_supported,
)
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy
from whisper_trtllm_tpu_torch.utils.device import resolve_device, to_numpy

# cross-attention caches are padded along T to a multiple of this (1500 →
# 1504); the padding is masked by the true encoder length
CROSS_PAD = 8


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _stack(trees: list) -> dict:
    """Stack a list of identically shaped dict trees of numpy arrays along a
    new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees, axis=0)


def _init_encoder_layer(rng, cfg: WhisperConfig) -> dict:
    d = cfg.d_model
    return {
        "self_attn": init_attention(rng, d),
        "self_attn_layer_norm": init_layer_norm(d),
        "fc1": init_dense(rng, d, cfg.encoder_ffn_dim),
        "fc2": init_dense(rng, cfg.encoder_ffn_dim, d),
        "final_layer_norm": init_layer_norm(d),
    }


def _init_decoder_layer(rng, cfg: WhisperConfig) -> dict:
    d = cfg.d_model
    return {
        "self_attn": init_attention(rng, d),
        "self_attn_layer_norm": init_layer_norm(d),
        "encoder_attn": init_attention(rng, d),
        "encoder_attn_layer_norm": init_layer_norm(d),
        "fc1": init_dense(rng, d, cfg.decoder_ffn_dim),
        "fc2": init_dense(rng, cfg.decoder_ffn_dim, d),
        "final_layer_norm": init_layer_norm(d),
    }


def init_params(cfg: WhisperConfig, seed: int = 0, device=None) -> dict:
    """Random-init parameter tree (HF Whisper's statistics) as fp32 tensors
    on ``device`` (the CUDA card by default). The arrays are drawn in numpy
    in the JAX package's order, so they equal its ``init_params(cfg,
    seed)`` leaf for leaf and bit for bit, then carried by
    ``params_from_numpy``. A real checkpoint replaces them through
    ``convert.py`` or ``load_checkpoint``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    encoder = {
        "conv1": init_conv1d(rng, 3, cfg.num_mel_bins, d),
        "conv2": init_conv1d(rng, 3, d, d),
        "embed_positions": sinusoid_position_embedding(
            cfg.max_source_positions, d),
        "layers": _stack([_init_encoder_layer(rng, cfg)
                          for _ in range(cfg.encoder_layers)]),
        "layer_norm": init_layer_norm(d),
    }
    decoder = {
        "embed_tokens": init_embedding(rng, cfg.vocab_size, d),
        "embed_positions": init_embedding(rng, cfg.max_target_positions, d),
        "layers": _stack([_init_decoder_layer(rng, cfg)
                          for _ in range(cfg.decoder_layers)]),
        "layer_norm": init_layer_norm(d),
    }
    return params_from_numpy({"encoder": encoder, "decoder": decoder}, dev)


def layer(tree, i: int):
    """Layer ``i`` of a stacked (L, ...) parameter tree, as views."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def _vocab_logits(dec: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied vocab head, fp32 logits. The dot runs in fp32 whatever x's
    dtype; with the int8 table the per-row scale is applied after it."""
    table = dec["embed_tokens"]
    if isinstance(table, dict):
        logits = torch.matmul(x.float(), table["table_q"].float().t())
        return logits * table["scale"].float()
    return torch.matmul(x.float(), table.float().t())


def fuse_qkv_params(params: dict) -> dict:
    """Fuse each self-attention's q/k/v projections into one (d, 3d)
    kernel with a zero k-bias (Whisper's k projection has none). Exact:
    the fused product's columns are the three products. Cross attention
    stays split (its K/V are computed once per utterance). Untouched
    subtrees are shared; the fused projections are numpy, as in the JAX
    package, and the session places them."""
    def fuse(attn: dict) -> dict:
        q, k, v = (attn[n] for n in ("q", "k", "v"))
        kernel = np.concatenate([to_numpy(p["kernel"]) for p in (q, k, v)],
                                axis=-1)
        d_out = to_numpy(q["kernel"]).shape[-1]
        zeros_k = np.zeros_like(to_numpy(q.get("bias", np.zeros(d_out))))
        bias = np.concatenate(
            [to_numpy(q.get("bias", zeros_k)), zeros_k,
             to_numpy(v.get("bias", zeros_k))], axis=-1)
        return {"qkv": {"kernel": kernel, "bias": bias}, "out": attn["out"]}

    out = dict(params)
    for side in ("encoder", "decoder"):
        side_tree = dict(out[side])
        layers = dict(side_tree["layers"])
        layers["self_attn"] = fuse(layers["self_attn"])
        side_tree["layers"] = layers
        out[side] = side_tree
    return out


def cast_params(params, dtype: torch.dtype):
    """Cast floating leaves wider than one byte to the compute dtype; int8
    kernels and tables stay int8 (LayerNorm statistics stay fp32 inside
    ``layer_norm``)."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if params.is_floating_point() and params.element_size() > 1:
        return params.to(dtype)
    return params


# --------------------------------------------------------------------------
# encoder
# --------------------------------------------------------------------------

def _encoder_layer(lp: dict, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Pre-LN block: self attention + GELU MLP."""
    h = layer_norm(lp["self_attn_layer_norm"], x)
    q, k, v = attention_qkv(lp["self_attn"], h, None, heads)
    a = merge_heads(mha(q, k, v, causal=False))
    x = x + dense(lp["self_attn"]["out"], a)
    h = layer_norm(lp["final_layer_norm"], x)
    return x + mlp_block(lp, h)


def encode(params: dict, cfg: WhisperConfig, mel: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """mel (B, 3000, n_mels) → encoder states (B, 1500, d): conv1d+GELU
    stem, + sinusoid positions, the layers, final LN.

    ``remat=True`` rematerializes per layer (``torch.utils.checkpoint``,
    non-reentrant; ≙ ``jax.checkpoint`` on the scan body): the backward
    keeps only the (B, 1500, d) layer boundaries and runs each layer's
    forward again, its K1 and K5 launches included."""
    enc = params["encoder"]
    x = gelu(conv1d(enc["conv1"], mel, stride=1, padding=1))
    x = gelu(conv1d(enc["conv2"], x, stride=2, padding=1))
    x = x + enc["embed_positions"].to(x.dtype)[None]
    heads = cfg.encoder_attention_heads
    for i in range(cfg.encoder_layers):
        lp = layer(enc["layers"], i)
        if remat:
            x = checkpoint(_encoder_layer, lp, x, heads, use_reentrant=False)
        else:
            x = _encoder_layer(lp, x, heads)
    return layer_norm(enc["layer_norm"], x)


# --------------------------------------------------------------------------
# decoder — teacher-forced full-sequence (training)
# --------------------------------------------------------------------------

def _decoder_layer_full(
    lp: dict, x: torch.Tensor, enc_states: torch.Tensor, heads: int,
    flash_cross: bool = False,
    ga_weights: Optional[torch.Tensor] = None,
    ga_row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer over the whole sequence: causal self attention,
    cross attention, MLP. With ``ga_weights`` (S, T) and ``ga_row_mask``
    (B, S) the cross attention is the plain softmax, and the layer also
    returns the guided-attention penalty: the mean over heads and masked
    rows of the attention mass weighted by ``ga_weights``."""
    h = layer_norm(lp["self_attn_layer_norm"], x)
    q, k, v = attention_qkv(lp["self_attn"], h, None, heads)
    a = merge_heads(mha(q, k, v, causal=True))
    x = x + dense(lp["self_attn"]["out"], a)

    h = layer_norm(lp["encoder_attn_layer_norm"], x)
    q, k, v = attention_qkv(lp["encoder_attn"], h, enc_states, heads)
    ga_pen = x.new_zeros((), dtype=torch.float32)
    if ga_weights is not None:
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        probs = torch.softmax(scores, dim=-1)
        pen_rows = (probs * ga_weights[None, None]).sum(dim=-1)  # B, H, S
        rm = ga_row_mask[:, None, :].to(pen_rows.dtype)
        ga_pen = (pen_rows * rm).sum() / torch.clamp(rm.sum() * heads,
                                                     min=1.0)
        a = merge_heads(torch.matmul(probs.to(v.dtype), v))
    else:
        a = merge_heads(mha(q, k, v, causal=False, use_flash=flash_cross))
    x = x + dense(lp["encoder_attn"]["out"], a)

    h = layer_norm(lp["final_layer_norm"], x)
    x = x + mlp_block(lp, h)
    return x, ga_pen


def decode_full(
    params: dict,
    cfg: WhisperConfig,
    tokens: torch.Tensor,
    enc_states: torch.Tensor,
    flash_cross: bool = False,
    ga_weights: Optional[torch.Tensor] = None,
    ga_row_mask: Optional[torch.Tensor] = None,
):
    """Teacher-forced decoder forward: tokens (B, S) → logits (B, S, V)
    fp32.

    ``flash_cross`` picks the cross attention's lowering: False (default)
    the plain formula, as the JAX package pins XLA there; True the fused
    kernel (K1, K4 in the backward), as training runs it. With
    ``ga_weights`` (S, T) and ``ga_row_mask`` (B, S) (the guided-attention
    loss, ``training/train.py::guided_attn_weights``) it returns (logits,
    the mean of the layers' penalties)."""
    dec = params["decoder"]
    s = tokens.shape[1]
    x = embedding(dec["embed_tokens"], tokens, dtype=enc_states.dtype)
    x = x + dec["embed_positions"][:s].to(x.dtype)[None]
    heads = cfg.decoder_attention_heads
    pens = []
    for i in range(cfg.decoder_layers):
        x, pen = _decoder_layer_full(layer(dec["layers"], i), x, enc_states,
                                     heads, flash_cross, ga_weights,
                                     ga_row_mask)
        pens.append(pen)
    x = layer_norm(dec["layer_norm"], x)
    logits = _vocab_logits(dec, x)
    if ga_weights is not None:
        return logits, torch.stack(pens).mean()
    return logits


# --------------------------------------------------------------------------
# decoder — incremental decode with static caches
# --------------------------------------------------------------------------

def cross_attention_q(lp: dict, h: torch.Tensor, heads: int) -> torch.Tensor:
    """Cross-attention query projection with the (d/heads)**-0.5 scale."""
    d = h.shape[-1]
    return split_heads(
        dense(lp["encoder_attn"]["q"], h) * (d // heads) ** -0.5, heads)


def compute_cross_kv(params: dict, cfg: WhisperConfig,
                     enc_states: torch.Tensor,
                     out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V for all layers, once per utterance:
    (L, B, H, Tp, dh) ×2 with T padded to a multiple of 8 (1500 → 1504);
    the padding rows are zero and masked by the true length. ``out``: a
    pair of that shape and dtype whose padding rows are zero, written in
    place (a captured decode step reads its cross cache there)."""
    heads = cfg.decoder_attention_heads
    layers = params["decoder"]["layers"]
    b, t, d = enc_states.shape
    tp = -(-t // CROSS_PAD) * CROSS_PAD
    shape = (cfg.decoder_layers, b, heads, tp, d // heads)
    if out is not None:
        ks, vs = out
        if ks.shape != shape or vs.shape != shape or \
                ks.dtype != enc_states.dtype or vs.dtype != enc_states.dtype:
            raise ValueError(f"compute_cross_kv: out must be two {shape} "
                             f"{enc_states.dtype} tensors")
    else:
        ks = enc_states.new_zeros(shape)
        vs = enc_states.new_zeros(shape)
    for i in range(cfg.decoder_layers):
        ca = layer(layers, i)["encoder_attn"]
        ks[i, :, :, :t] = split_heads(dense(ca["k"], enc_states), heads)
        vs[i, :, :, :t] = split_heads(dense(ca["v"], enc_states), heads)
    return ks, vs


def init_self_kv(cfg: WhisperConfig, batch: int, max_len: Optional[int] = None,
                 dtype=torch.float32, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static self-attention KV cache (L, B, H, max_len, dh) ×2 on
    ``device`` (the CUDA card by default)."""
    max_len = max_len or cfg.max_target_positions
    device = resolve_device(device)
    shape = (cfg.decoder_layers, batch, cfg.decoder_attention_heads, max_len,
             cfg.decoder_head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def quantize_cross_kv(cross_k: torch.Tensor, cross_v: torch.Tensor,
                      dtype=torch.int8) -> Tuple[torch.Tensor, ...]:
    """Float cross K/V → the quantized 4-tuple (kq, ks, vq, vs), per-token
    scales (L, B, H, Tc, 1) fp32."""
    kq, ks = quantize_kv(cross_k, dtype)
    vq, vs = quantize_kv(cross_v, dtype)
    return kq, ks, vq, vs


def transpose_cross_kv(cross_kv: Tuple[torch.Tensor, ...]
                       ) -> Tuple[torch.Tensor, ...]:
    """(L, B, H, Tc, dh) cross-KV tuple → T-minor (L, B, H, dh, Tc), as
    contiguous tensors (it runs once per utterance); scales of a quantized
    4-tuple keep their (L, B, H, Tc, 1) shape. ``decode_step_kv`` reads the
    layout from the shapes."""
    def t(x):
        return x.transpose(-1, -2).contiguous()

    if len(cross_kv) == 4:
        kq, ks, vq, vs = cross_kv
        return t(kq), ks, t(vq), vs
    k, v = cross_kv
    return t(k), t(v)


def cross_kv_t_major(cfg: WhisperConfig, cross_kv: Tuple[torch.Tensor, ...]
                     ) -> bool:
    """True iff the cross-KV tuple is stored T-minor ((..., dh, Tc)), read
    from the shapes: unambiguous whenever the padded encoder length differs
    from head_dim (``apply_cross_layout`` refuses to transpose square
    caches)."""
    dh = cfg.decoder_head_dim
    k = cross_kv[0]
    return k.shape[-2] == dh and k.shape[-1] != dh


def init_self_kv_quant(cfg: WhisperConfig, batch: int,
                       max_len: Optional[int] = None, dtype=torch.int8,
                       device=None) -> Tuple[torch.Tensor, ...]:
    """Quantized self-KV cache (values int8/fp8 zeros, fp32 scales ones)
    ×2, leading L axis, on ``device`` (the CUDA card by default)."""
    max_len = max_len or cfg.max_target_positions
    device = resolve_device(device)
    shape = (cfg.decoder_layers, batch, cfg.decoder_attention_heads, max_len,
             cfg.decoder_head_dim)
    sshape = shape[:-1] + (1,)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.ones(sshape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
            torch.ones(sshape, dtype=torch.float32, device=device))


def init_self_kv_int8(cfg: WhisperConfig, batch: int,
                      max_len: Optional[int] = None, device=None
                      ) -> Tuple[torch.Tensor, ...]:
    return init_self_kv_quant(cfg, batch, max_len, torch.int8, device)


def fused_decode_enabled(device: torch.device) -> bool:
    """The fused decoder-layer kernel (K6) is taken on the CUDA card and
    never on the CPU, by device and with no switch, as the JAX package
    takes it on the TPU backend only; every CPU run keeps the unfused
    layer."""
    return device.type == "cuda"


_FUSED_BLOCKS = (("self_attn", "q"), ("self_attn", "k"), ("self_attn", "v"),
                 ("self_attn", "out"), ("encoder_attn", "q"),
                 ("encoder_attn", "out"), ("fc1",), ("fc2",))


def _fused_decode_ok(dec: dict, self_k: torch.Tensor, cross_k: torch.Tensor,
                     pos: Optional[torch.Tensor] = None) -> bool:
    """Gate of the fused decode step: the CUDA card, float caches (the
    caller checks the tuple lengths and the layout), a lockstep 0-d
    ``pos`` (None: the caller's loop keeps one), unfused float projections
    of one dtype with the caches, and the kernel's shape limits
    (``fused_layer_supported``)."""
    if not fused_decode_enabled(self_k.device) or (
            pos is not None and pos.dim() != 0):
        return False
    lp = dec["layers"]
    if "qkv" in lp["self_attn"]:
        return False
    blocks = []
    for path in _FUSED_BLOCKS:
        blk = lp
        for key in path:
            blk = blk[key]
        if "kernel" not in blk:
            return False
        blocks.append(blk["kernel"])
    if any(t.dtype != self_k.dtype for t in blocks + [cross_k]):
        return False
    _, b, h, ts, dh = self_k.shape
    return fused_layer_supported(b, h, ts, dh, cross_k.shape[3], h * dh,
                                 lp["fc1"]["kernel"].shape[-1],
                                 self_k.element_size())


def decode_step_plan(params: dict, cfg: WhisperConfig,
                     self_kv: Tuple[torch.Tensor, ...],
                     cross_kv: Tuple[torch.Tensor, ...]) -> bool:
    """True when ``decode_step_kv`` takes the fused step (K6) for these
    caches: float self and cross tuples, the cross cache dh-minor, and the
    gate ``_fused_decode_ok``. It depends on the tree and the caches' shapes
    only, so a decode loop decides it once, before its first step (the
    gate walks the weight tree)."""
    if len(self_kv) == 4 or len(cross_kv) == 4 or cross_kv_t_major(
            cfg, cross_kv):
        return False
    return _fused_decode_ok(params["decoder"], self_kv[0], cross_kv[0])


def _encoder_length(n: int, device: torch.device) -> torch.Tensor:
    """The true encoder length as a 0-d int32 tensor on ``device``, made
    once: the attention kernels read it from device memory, and a decode
    step then issues no copy for it. Read-only. While ``torch.export``
    traces, it is made anew and kept nowhere: a fake tensor in the cache
    would reach every later eager decode."""
    if tracing():
        return torch.full((), n, dtype=torch.int32, device=device)
    return _encoder_length_cached(n, device)


@functools.lru_cache(maxsize=None)
def _encoder_length_cached(n: int, device: torch.device) -> torch.Tensor:
    return torch.full((), n, dtype=torch.int32, device=device)


def _decode_step_fused(dec: dict, cfg: WhisperConfig, x: torch.Tensor,
                       pos: torch.Tensor, self_kv, cross_kv
                       ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """decode_step_kv's layer loop through the fused kernel: per layer,
    LN1 (K5), the k/v projections and the in-place cache append at
    ``pos`` (a 0-d int32 tensor), then one K6 launch for everything else;
    then the final LN and the vocab head. x: (B, 1, d) embedded tokens."""
    heads = cfg.decoder_attention_heads
    enc_len = _encoder_length(cfg.max_source_positions, x.device)
    for i in range(cfg.decoder_layers):
        lp = layer(dec["layers"], i)
        sk, sv = self_kv[0][i], self_kv[1][i]
        h = layer_norm(lp["self_attn_layer_norm"], x)
        sa = lp["self_attn"]
        update_kv_cache(sk, sv, split_heads(dense(sa["k"], h), heads),
                        split_heads(dense(sa["v"], h), heads), pos)
        x = fused_decoder_layer_step(
            x[:, 0], h[:, 0], pos, lp, sk, sv, cross_kv[0][i],
            cross_kv[1][i], enc_len)[:, None]
    x = layer_norm(dec["layer_norm"], x)
    return _vocab_logits(dec, x)[:, 0], self_kv


def decode_step_kv(
    params: dict,
    cfg: WhisperConfig,
    tokens: torch.Tensor,
    pos,
    self_kv: Tuple[torch.Tensor, ...],
    cross_kv: Tuple[torch.Tensor, ...],
    fused: Optional[bool] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One decode step: tokens (B,) at position ``pos`` → (logits (B, V)
    fp32, self_kv). ``pos`` is an int or a 0-d integer tensor; a 0-d int32
    tensor on the tokens' device is read there, never on the host, so the
    step can be captured in a CUDA graph. Each cache tuple is float (k, v)
    or quantized (kq, ks, vq, vs); the cross tuple may be T-minor.
    ``fused``: ``decode_step_plan``'s answer for these caches, which a loop
    computes once; None asks it here.

    The self-attention caches, values and scales, are updated IN PLACE and
    returned; the JAX version returns new arrays."""
    dec = params["decoder"]
    dev = tokens.device
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    elif pos.dtype != torch.int32 or pos.device != dev:
        pos = pos.to(device=dev, dtype=torch.int32)
    if pos.dim() != 0:
        raise ValueError("decode_step_kv takes one position for the batch; "
                         "per-lane (B,) positions go to "
                         "decode_step_ragged_kv")
    if fused is None:
        fused = decode_step_plan(params, cfg, self_kv, cross_kv)

    x = embedding(dec["embed_tokens"], tokens[:, None])
    x = x + dec["embed_positions"].index_select(0, pos.long().reshape(1)).to(
        x.dtype)[None]
    if fused:
        return _decode_step_fused(dec, cfg, x, pos, self_kv, cross_kv)
    return _decode_layers(dec, cfg, x, pos, self_kv, cross_kv), self_kv


def _decode_layers(dec: dict, cfg: WhisperConfig, x: torch.Tensor,
                   pos: torch.Tensor, self_kv, cross_kv) -> torch.Tensor:
    """The unfused layer loop of a decode step: x (B, 1, d) embedded
    tokens at ``pos`` (0-d, or (B,) per lane) → logits (B, V) fp32. Each
    layer appends its K/V at ``pos`` (quantized first for an int8/fp8
    cache) and attends to ``pos + 1`` rows of its self cache and to the
    encoder's length of its cross cache (K2 twice on the card), with K5
    for its three LayerNorms and once after the last layer."""
    heads = cfg.decoder_attention_heads
    quant_self = len(self_kv) == 4
    quant_cross = len(cross_kv) == 4
    t_major = cross_kv_t_major(cfg, cross_kv)
    self_len = pos + 1
    enc_len = _encoder_length(cfg.max_source_positions, x.device)
    for i in range(cfg.decoder_layers):
        lp = layer(dec["layers"], i)
        s = [cache[i] for cache in self_kv]
        c = [cache[i] for cache in cross_kv]
        # self attention with the cache append at `pos`
        h = layer_norm(lp["self_attn_layer_norm"], x)
        q, k_new, v_new = attention_qkv(lp["self_attn"], h, None, heads)
        if quant_self:
            skq, sks, svq, svs = s
            k_q, k_s = quantize_kv(k_new, skq.dtype)
            v_q, v_s = quantize_kv(v_new, svq.dtype)
            update_kv_cache(skq, svq, k_q, v_q, pos)
            update_kv_cache(sks, svs, k_s, v_s, pos)
            a = mha_decode_step(q, skq, svq, self_len, k_scale=sks,
                                v_scale=svs)
        else:
            sk, sv = update_kv_cache(s[0], s[1], k_new, v_new, pos)
            a = mha_decode_step(q, sk, sv, self_len)
        x = x + dense(lp["self_attn"]["out"], merge_heads(a))
        # cross attention; the true encoder length masks the padding rows
        h = layer_norm(lp["encoder_attn_layer_norm"], x)
        qc = cross_attention_q(lp, h, heads)
        if quant_cross:
            a = mha_decode_step(qc, c[0], c[2], enc_len, k_scale=c[1],
                                v_scale=c[3], t_major=t_major)
        else:
            a = mha_decode_step(qc, c[0], c[1], enc_len, t_major=t_major)
        x = x + dense(lp["encoder_attn"]["out"], merge_heads(a))
        h = layer_norm(lp["final_layer_norm"], x)
        x = x + mlp_block(lp, h)
    x = layer_norm(dec["layer_norm"], x)
    return _vocab_logits(dec, x)[:, 0]


def decode_step(
    params: dict,
    cfg: WhisperConfig,
    tokens: torch.Tensor,
    pos,
    self_k: torch.Tensor,
    self_v: torch.Tensor,
    cross_k: torch.Tensor,
    cross_v: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step for the whole batch with float caches (see
    ``decode_step_kv``): tokens (B,) at ``pos`` → (logits (B, V) fp32,
    self_k, self_v), the self caches written in place."""
    logits, (self_k, self_v) = decode_step_kv(
        params, cfg, tokens, pos, (self_k, self_v), (cross_k, cross_v))
    return logits, self_k, self_v


def _position(pos, device: torch.device) -> torch.Tensor:
    """``pos`` (an int or a 0-d integer tensor) as a 0-d int64 tensor on
    ``device``; a tensor already there is not read on the host."""
    if not isinstance(pos, torch.Tensor):
        return torch.tensor(pos, dtype=torch.int64, device=device)
    if pos.dim() != 0:
        raise ValueError(f"pos must be 0-d, got shape {tuple(pos.shape)}")
    return pos.to(device=device, dtype=torch.int64)


def _cross_mask(tc: int, n: int, device: torch.device) -> torch.Tensor:
    """Additive fp32 mask (1, 1, 1, tc) over a padded cross cache: 0 on
    the ``n`` encoder rows, -1e9 on the padding. Made once (anew and kept
    nowhere while ``torch.export`` traces); read-only."""
    if tracing():
        return _make_cross_mask(tc, n, device)
    return _cross_mask_cached(tc, n, device)


@functools.lru_cache(maxsize=None)
def _cross_mask_cached(tc: int, n: int, device: torch.device) -> torch.Tensor:
    return _make_cross_mask(tc, n, device)


def _make_cross_mask(tc: int, n: int, device: torch.device) -> torch.Tensor:
    col = torch.arange(tc, device=device)
    return torch.where(col < n, 0.0, -1e9).to(torch.float32)[None, None,
                                                               None]


def decode_chunk(
    params: dict,
    cfg: WhisperConfig,
    tokens: torch.Tensor,
    pos,
    self_kv: Tuple[torch.Tensor, ...],
    cross_kv: Tuple[torch.Tensor, ...],
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """S tokens (B, S) at positions [pos, pos + S) against the self cache
    in one pass (the prompt prefill and the speculative verification):
    causal within the chunk, the whole cached prefix visible. Returns
    (logits (B, S, V) fp32, self_kv), the self caches written IN PLACE.

    Float (k, v) caches only, as in the JAX package; the cross cache
    dh-minor, its padding rows masked by the true encoder length. ``pos``
    is an int or a 0-d integer tensor; a tensor on the tokens' device is
    never read on the host, so a chunk can be captured in a CUDA graph.
    The cache rows and the position rows start where the JAX package's
    ``dynamic_update_slice`` and ``dynamic_slice`` start, clamped so that
    S rows fit; the mask reads ``pos`` unclamped. Self and cross attention
    take the plain formula with a mask (``mha``), as the JAX package runs
    them in XLA; the LayerNorms take K5 on the card."""
    if len(self_kv) != 2 or len(cross_kv) != 2:
        raise ValueError("decode_chunk takes float (k, v) caches only")
    if cross_kv_t_major(cfg, cross_kv):
        raise ValueError("decode_chunk takes a dh-minor cross cache")
    dec = params["decoder"]
    heads = cfg.decoder_attention_heads
    s = tokens.shape[1]
    dev = tokens.device
    sk0, sv0 = self_kv
    t = sk0.shape[3]
    p = _position(pos, dev)
    ar = torch.arange(s, device=dev)
    rows = p.clamp(0, t - s) + ar
    prows = p.clamp(0, dec["embed_positions"].shape[0] - s) + ar

    x = embedding(dec["embed_tokens"], tokens)
    x = x + dec["embed_positions"].index_select(0, prows).to(x.dtype)[None]
    # column c of the cache is visible to chunk row r iff c <= pos + r
    col = torch.arange(t, device=dev)
    mask = torch.where(col[None] <= (p + ar)[:, None], 0.0, -1e9).to(
        torch.float32)[None, None]
    cmask = _cross_mask(cross_kv[0].shape[3], cfg.max_source_positions, dev)
    for i in range(cfg.decoder_layers):
        lp = layer(dec["layers"], i)
        sk, sv = sk0[i], sv0[i]
        h = layer_norm(lp["self_attn_layer_norm"], x)
        q, k_new, v_new = attention_qkv(lp["self_attn"], h, None, heads)
        sk.index_copy_(2, rows, k_new.to(sk.dtype))
        sv.index_copy_(2, rows, v_new.to(sv.dtype))
        x = x + dense(lp["self_attn"]["out"],
                      merge_heads(mha(q, sk, sv, mask=mask)))
        h = layer_norm(lp["encoder_attn_layer_norm"], x)
        qc = cross_attention_q(lp, h, heads)
        x = x + dense(lp["encoder_attn"]["out"], merge_heads(
            mha(qc, cross_kv[0][i], cross_kv[1][i], mask=cmask)))
        h = layer_norm(lp["final_layer_norm"], x)
        x = x + mlp_block(lp, h)
    x = layer_norm(dec["layer_norm"], x)
    return _vocab_logits(dec, x), self_kv


def decode_step_ragged_kv(
    params: dict,
    cfg: WhisperConfig,
    tokens: torch.Tensor,
    pos,
    self_kv: Tuple[torch.Tensor, ...],
    cross_kv: Tuple[torch.Tensor, ...],
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One decode step with a position per lane: tokens (B,) at ``pos``
    (B,) → (logits (B, V) fp32, self_kv). Each lane takes its own
    position embedding, appends at its own row and attends to its own
    ``pos + 1`` self rows, so lanes hold different utterances at
    different stages (the in-flight batcher's step). Caches as in
    ``decode_step_kv``: float or quantized, the cross cache in either
    layout; the self caches are updated IN PLACE. A (B,) int32 ``pos`` on
    the tokens' device is never read on the host, so the step can be
    captured. The step is always the unfused layer loop (the JAX package
    never fuses it): on the card K2 twice a layer and K5 three times a
    layer and once after."""
    dec = params["decoder"]
    dev = tokens.device
    if not isinstance(pos, torch.Tensor):
        pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    elif pos.dtype != torch.int32 or pos.device != dev:
        pos = pos.to(device=dev, dtype=torch.int32)
    if pos.shape != tokens.shape:
        raise ValueError(f"decode_step_ragged_kv: pos must be (B,) like the "
                         f"tokens {tuple(tokens.shape)}, got "
                         f"{tuple(pos.shape)}")
    x = embedding(dec["embed_tokens"], tokens[:, None])
    x = x + dec["embed_positions"].index_select(0, pos.long()).to(
        x.dtype)[:, None]
    return _decode_layers(dec, cfg, x, pos, self_kv, cross_kv), self_kv


def decode_step_ragged(
    params: dict,
    cfg: WhisperConfig,
    tokens: torch.Tensor,
    pos,
    self_k: torch.Tensor,
    self_v: torch.Tensor,
    cross_k: torch.Tensor,
    cross_v: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Float-cache ragged step (see ``decode_step_ragged_kv``): (logits,
    self_k, self_v)."""
    logits, (self_k, self_v) = decode_step_ragged_kv(
        params, cfg, tokens, pos, (self_k, self_v), (cross_k, cross_v))
    return logits, self_k, self_v
