"""Greedy generation (counterpart of
``whisper_trtllm_tpu/runtime/generation.py``: ``greedy_decode`` and
``transcribe_tokens``).

The token loop is a Python loop over fixed-shape decode steps against
static caches; the JAX package runs the same body in a ``lax.while_loop``.
The token-buffer semantics are the JAX package's: the start token at
position 0 and the forced prefix after it, pad after EOS, ``lengths`` =
EOS position + 1 (or ``max_len``), and the loop stops when every lane has
finished or the buffer is full.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from whisper_trtllm_tpu_torch.config import GenerationConfig, WhisperConfig
from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
from whisper_trtllm_tpu_torch.runtime import logits_process as lp
from whisper_trtllm_tpu_torch.runtime import sampling
from whisper_trtllm_tpu_torch.utils.device import (
    resolve_device,
    set_fp32_precision,
    to_tensor,
)


def kv_quant_dtype(kv_cache_dtype: str):
    """GenerationConfig.kv_cache_dtype → storage dtype of the quantized KV
    caches, or None for float caches ("auto")."""
    table = {"auto": None, "int8": torch.int8, "fp8": torch.float8_e4m3fn}
    if kv_cache_dtype not in table:
        raise ValueError(f"kv_cache_dtype must be one of {sorted(table)}, "
                         f"got {kv_cache_dtype!r}")
    return table[kv_cache_dtype]


def apply_cross_layout(cross_kv, layout: str):
    """Resolve GenerationConfig.cross_kv_layout: transpose the cross-KV
    tuple to T-minor for "bhdt", and for "auto" when the cache is
    quantized; float "auto" stays dh-minor. Square caches (padded encoder
    length == head_dim) keep dh-minor under "auto" and are refused under
    "bhdt": ``cross_kv_t_major`` could not tell the layouts apart."""
    if layout not in ("auto", "bhtd", "bhdt"):
        raise ValueError(
            f"cross_kv_layout must be auto|bhtd|bhdt, got {layout!r}")
    quantized = len(cross_kv) == 4
    if layout == "bhdt" or (layout == "auto" and quantized):
        k = cross_kv[0]
        if k.shape[-2] == k.shape[-1]:
            if layout == "bhdt":
                raise ValueError(
                    "cross_kv_layout='bhdt' is unsupported when the padded "
                    f"encoder length equals head_dim ({k.shape[-2]}): the "
                    "T-minor layout would be undetectable from shapes")
            return cross_kv
        return wmodel.transpose_cross_kv(cross_kv)
    return cross_kv


def check_greedy_config(gen: GenerationConfig) -> None:
    """Refuse every GenerationConfig field the greedy path does not
    implement yet, so none is silently ignored."""
    unported = {
        "num_beams": gen.num_beams != 1,
        "return_timestamps": gen.return_timestamps,
        "presence_penalty": gen.presence_penalty != 0.0,
        "min_new_tokens": gen.min_new_tokens > 0,
        "bad_words": bool(gen.bad_words),
        "stop_words": bool(gen.stop_words),
    }
    bad = [name for name, hit in unported.items() if hit]
    if bad:
        raise NotImplementedError(
            f"GenerationConfig fields not ported yet: {', '.join(bad)}")


def greedy_decode(
    params: dict,
    cfg: WhisperConfig,
    enc_states: torch.Tensor,
    gen: Optional[GenerationConfig] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy search: enc_states (B, 1500, d) → (tokens (B, max_len)
    int32, lengths (B,) int32), with ``max_len = min(max_target_positions,
    max_new_tokens + 1)``. Float caches take ``enc_states``' dtype;
    ``gen.kv_cache_dtype`` "int8"/"fp8" quantizes both caches, and
    ``gen.cross_kv_layout`` sets the cross cache's layout."""
    gen = gen or GenerationConfig()
    check_greedy_config(gen)
    max_len = min(cfg.max_target_positions, gen.max_new_tokens + 1)
    batch = enc_states.shape[0]
    dev = enc_states.device

    suppress = torch.from_numpy(lp.build_suppress_mask(cfg)).to(dev)
    begin_suppress = torch.from_numpy(lp.build_begin_suppress_mask(cfg)).to(dev)
    forced_map, begin_index = lp.build_forced_map(cfg, max_len)

    kv_qdtype = kv_quant_dtype(gen.kv_cache_dtype)
    cross_k, cross_v = wmodel.compute_cross_kv(params, cfg, enc_states)
    if kv_qdtype is not None:
        cross_kv = wmodel.quantize_cross_kv(cross_k, cross_v, kv_qdtype)
        self_kv = wmodel.init_self_kv_quant(cfg, batch, max_len, kv_qdtype,
                                            device=dev)
    else:
        cross_kv = (cross_k, cross_v)
        self_kv = wmodel.init_self_kv(cfg, batch, max_len,
                                      dtype=enc_states.dtype, device=dev)
    cross_kv = apply_cross_layout(cross_kv, gen.cross_kv_layout)
    positions = torch.arange(max_len, dtype=torch.int32, device=dev)
    tokens = torch.full((batch, max_len), cfg.pad_token_id, dtype=torch.int32,
                        device=dev)
    tokens[:, 0] = cfg.decoder_start_token_id
    finished = torch.zeros(batch, dtype=torch.bool, device=dev)
    lengths = torch.full((batch,), max_len, dtype=torch.int32, device=dev)

    for pos in range(max_len - 1):
        if pos > 0 and bool(finished.all()):
            break
        logits, self_kv = wmodel.decode_step_kv(
            params, cfg, tokens[:, pos], positions[pos], self_kv, cross_kv)
        nxt_pos = pos + 1
        logits = logits + suppress[None]
        if nxt_pos == begin_index:
            logits = logits + begin_suppress[None]
        nxt = sampling.sample_token(
            logits, temperature=gen.temperature, top_k=gen.top_k,
            top_p=gen.top_p, repetition_penalty=gen.repetition_penalty)
        if forced_map[nxt_pos] >= 0:
            nxt = torch.full_like(nxt, int(forced_map[nxt_pos]))
        nxt = torch.where(finished, cfg.pad_token_id, nxt).to(torch.int32)
        newly = ~finished & (nxt == cfg.eos_token_id)
        tokens[:, nxt_pos] = nxt
        finished = finished | newly
        lengths = torch.where(newly, nxt_pos + 1, lengths).to(torch.int32)
    return tokens, lengths


@torch.inference_mode()
def transcribe_tokens(
    params: dict,
    cfg: WhisperConfig,
    mel,
    gen: Optional[GenerationConfig] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """mel (B, 3000, n_mels) → (tokens, lengths): encode + greedy decode on
    ``device`` (the CUDA card by default), where ``params`` must already
    lie."""
    dev = resolve_device(device)
    set_fp32_precision()
    leaf = params["encoder"]["conv1"]["kernel"]
    if leaf.device.type != dev.type:
        raise ValueError(f"params lie on {leaf.device}, not on {dev}")
    mel = to_tensor(mel, dev, leaf.dtype)
    enc = wmodel.encode(params, cfg, mel)
    return greedy_decode(params, cfg, enc, gen)
