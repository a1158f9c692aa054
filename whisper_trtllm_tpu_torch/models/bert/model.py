"""BERT-style encoder-only model (counterpart of
``whisper_trtllm_tpu/models/bert/model.py``): learned word, position and
token-type embeddings, post-LN blocks, an additive attention mask for
padded batches and a tanh pooler over the first position. Weights follow
HF ``BertModel``'s layout.

On the card every LayerNorm runs K5 (2L + 1 a pass: the embeddings',
then ``attn_ln`` and ``out_ln`` a layer); the unmasked attention is
bidirectional with S > 1, so ``ops/attention.py::mha`` dispatches it to
K1, as the JAX package dispatches it to its flash kernel; with a mask it
is the plain formula, as the JAX package runs it in XLA. The products are
torch matmuls.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple

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
    split_heads,
    stack,
)
from whisper_trtllm_tpu_torch.ops.attention import mha
from whisper_trtllm_tpu_torch.ops.functional import (
    ACT2FN,
    dense,
    embedding,
    layer_norm,
)
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy
from whisper_trtllm_tpu_torch.utils.device import resolve_device, to_tensor


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    d_model: int = 768
    n_layer: int = 12
    n_head: int = 12
    ffn_dim: int = 3072
    activation: str = "gelu"
    layer_norm_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @classmethod
    def testing(cls, **overrides) -> "BertConfig":
        kw = dict(vocab_size=97, max_position_embeddings=24, d_model=32,
                  n_layer=2, n_head=4, ffn_dim=64)
        kw.update(overrides)
        return cls(**kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def _init_layer(rng, cfg: BertConfig) -> dict:
    d = cfg.d_model
    return {
        "q": init_dense(rng, d, d),
        "k": init_dense(rng, d, d),
        "v": init_dense(rng, d, d),
        "attn_out": init_dense(rng, d, d),
        "attn_ln": init_layer_norm(d),
        "fc_in": init_dense(rng, d, cfg.ffn_dim),
        "fc_out": init_dense(rng, cfg.ffn_dim, d),
        "out_ln": init_layer_norm(d),
    }


def init_params(cfg: BertConfig, seed: int = 0, device=None) -> dict:
    """Random weights drawn in numpy in the JAX package's order (equal to
    its ``init_params(cfg, seed)`` bit for bit), as fp32 tensors on
    ``device`` (the CUDA card by default)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    layers = [_init_layer(rng, cfg) for _ in range(cfg.n_layer)]
    return params_from_numpy({
        "word_embeddings": init_embedding(rng, cfg.vocab_size, cfg.d_model),
        "position_embeddings": init_embedding(
            rng, cfg.max_position_embeddings, cfg.d_model),
        "token_type_embeddings": init_embedding(
            rng, cfg.type_vocab_size, cfg.d_model),
        "embed_ln": init_layer_norm(cfg.d_model),
        "layers": stack(layers),
        "pooler": init_dense(rng, cfg.d_model, cfg.d_model),
    }, dev)


@torch.inference_mode()
def forward(
    params: dict,
    cfg: BertConfig,
    tokens,
    attention_mask=None,
    token_type_ids=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (sequence_output (B, S, d), pooled (B, d)) on the
    parameters' device; ``attention_mask`` (B, S) 1 for a valid position,
    0 for padding."""
    dev = params["word_embeddings"].device
    tokens = to_tensor(tokens, dev, torch.int64)
    b, s = tokens.shape
    h, dh = cfg.n_head, cfg.head_dim
    x = embedding(params["word_embeddings"], tokens)
    x = x + params["position_embeddings"][:s][None]
    tt = (torch.zeros_like(tokens) if token_type_ids is None
          else to_tensor(token_type_ids, dev, torch.int64))
    x = x + embedding(params["token_type_embeddings"], tt)
    x = layer_norm(params["embed_ln"], x, cfg.layer_norm_eps)

    mask: Optional[torch.Tensor] = None
    if attention_mask is not None:
        m = to_tensor(attention_mask, dev, torch.float32)
        mask = (1.0 - m[:, None, None, :]) * -1e9

    for i in range(cfg.n_layer):
        lp = layer(params["layers"], i)
        q = split_heads(dense(lp["q"], x), h, dh) * dh ** -0.5
        a = mha(q, split_heads(dense(lp["k"], x), h, dh),
                split_heads(dense(lp["v"], x), h, dh), mask=mask)
        # post-LN residuals (BERT's)
        x = layer_norm(lp["attn_ln"], x + dense(lp["attn_out"],
                                                merge_heads(a)),
                       cfg.layer_norm_eps)
        hid = dense(lp["fc_out"], ACT2FN[cfg.activation](dense(lp["fc_in"],
                                                               x)))
        x = layer_norm(lp["out_ln"], x + hid, cfg.layer_norm_eps)
    pooled = torch.tanh(dense(params["pooler"], x[:, 0]))
    return x, pooled


def convert_hf_bert(hf_model, device=None) -> Tuple[dict, BertConfig]:
    """transformers ``BertModel`` → (the parameter tree as tensors on
    ``device``, the CUDA card by default, config). Linear weights are
    transposed to (in, out)."""
    dev = resolve_device(device)
    hc = hf_model.config
    cfg = BertConfig(
        vocab_size=hc.vocab_size,
        max_position_embeddings=hc.max_position_embeddings,
        type_vocab_size=hc.type_vocab_size,
        d_model=hc.hidden_size, n_layer=hc.num_hidden_layers,
        n_head=hc.num_attention_heads, ffn_dim=hc.intermediate_size,
        activation=hc.hidden_act, layer_norm_eps=hc.layer_norm_eps,
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
        p = f"encoder.layer.{i}"
        layers.append({
            "q": lin(p + ".attention.self.query"),
            "k": lin(p + ".attention.self.key"),
            "v": lin(p + ".attention.self.value"),
            "attn_out": lin(p + ".attention.output.dense"),
            "attn_ln": ln(p + ".attention.output.LayerNorm"),
            "fc_in": lin(p + ".intermediate.dense"),
            "fc_out": lin(p + ".output.dense"),
            "out_ln": ln(p + ".output.LayerNorm"),
        })
    return params_from_numpy({
        "word_embeddings": sd["embeddings.word_embeddings.weight"],
        "position_embeddings": sd["embeddings.position_embeddings.weight"],
        "token_type_embeddings": sd[
            "embeddings.token_type_embeddings.weight"],
        "embed_ln": ln("embeddings.LayerNorm"),
        "layers": stack(layers),
        "pooler": lin("pooler.dense"),
    }, dev), cfg
