"""Logits processors (counterpart of
``whisper_trtllm_tpu/runtime/logits_process.py``): a static additive
suppress mask, a begin-suppress mask applied at one position and a
forced-token map indexed by position, built in numpy once per decode; and
the timestamp rules, a tensor op on the step's fixed shapes that reads
no device value on the host (it runs inside the decode step's CUDA
graph)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from whisper_trtllm_tpu_torch.config import WhisperConfig


def _neg_inf_mask(vocab_size: int, token_ids) -> np.ndarray:
    mask = np.zeros((vocab_size,), np.float32)
    ids = [t for t in token_ids if 0 <= t < vocab_size]
    if ids:
        mask[np.asarray(ids)] = -np.inf
    return mask


def build_suppress_mask(cfg: WhisperConfig) -> np.ndarray:
    """(V,) additive mask: -inf at always-suppressed token ids."""
    return _neg_inf_mask(cfg.vocab_size, cfg.suppress_tokens)


def build_begin_suppress_mask(cfg: WhisperConfig) -> np.ndarray:
    """(V,) additive mask applied only at the first free position."""
    return _neg_inf_mask(cfg.vocab_size, cfg.begin_suppress_tokens)


def build_forced_map(cfg: WhisperConfig, max_len: int,
                     timestamps: bool = False) -> Tuple[np.ndarray, int]:
    """(max_len,) int32 map with the forced token id at forced positions
    and -1 elsewhere, plus ``begin_index``: the first free position, where
    begin-suppress applies. ``timestamps=True`` drops a forced
    <|notimestamps|> entry, as HF does when timestamps are requested."""
    arr = np.full((max_len,), -1, np.int32)
    last_forced = 0
    for pos, tok in cfg.forced_decoder_ids:
        if timestamps and tok == cfg.no_timestamps_token_id:
            continue
        if pos < max_len:
            arr[pos] = tok
        last_forced = max(last_forced, pos)
    begin_index = 1 + last_forced  # the prompt is [decoder_start]
    return arr, begin_index


def apply_timestamp_rules(
    logits: torch.Tensor,
    tokens: torch.Tensor,
    pos: torch.Tensor,
    begin_index: int,
    timestamp_begin: int,
    eos_token_id: int,
    max_initial_timestamp_index: Optional[int] = 1,
    detect_from_logprob: bool = True,
) -> torch.Tensor:
    """Whisper's timestamp rules (HF ``WhisperTimeStampLogitsProcessor``:
    pairs, monotonicity, max-initial, log-prob mass). logits (B, V) fp32
    before the softmax; tokens the (B, max_len) buffer; ``pos`` the last
    filled position, a 0-d integer tensor on the logits' device (or an
    int). <|notimestamps|> is ``timestamp_begin - 1`` and is always
    suppressed."""
    b, v = logits.shape
    dev = logits.device
    neg = -torch.inf
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor(pos, device=dev)
    pos = pos.long()
    col = torch.arange(v, device=dev)[None]                       # (1, V)
    logits = torch.where(col == timestamp_begin - 1, neg, logits)

    seq_len = pos + 1 - begin_index                               # generated
    last_tok = tokens.index_select(1, pos.reshape(1))[:, 0]
    penult_tok = tokens.index_select(
        1, torch.clamp(pos - 1, min=0).reshape(1))[:, 0]
    last_was_ts = (seq_len >= 1) & (last_tok >= timestamp_begin)
    penult_was_ts = (seq_len < 2) | (penult_tok >= timestamp_begin)

    # pairs rule
    force_text = last_was_ts & penult_was_ts                      # (B,)
    force_ts = last_was_ts & ~penult_was_ts
    logits = torch.where(force_text[:, None] & (col >= timestamp_begin),
                         neg, logits)
    logits = torch.where(force_ts[:, None] & (col < eos_token_id), neg,
                         logits)

    # monotonicity: the latest timestamp in [begin_index, pos]
    idx = torch.arange(tokens.shape[1], device=dev)[None]
    is_ts = (idx >= begin_index) & (idx <= pos) & (tokens >= timestamp_begin)
    last_ts_pos = torch.where(is_ts, idx, -1).amax(dim=1)         # (B,)
    has_ts = last_ts_pos >= 0
    last_ts_val = tokens.gather(1, last_ts_pos.clamp(min=0)[:, None])[:, 0]
    ts_floor = torch.where(force_ts, last_ts_val, last_ts_val + 1)
    logits = torch.where(
        has_ts[:, None] & (col >= timestamp_begin) & (col < ts_floor[:, None]),
        neg, logits)

    # the first generated position: timestamps only, a bounded first index
    at_begin = (pos + 1) == begin_index
    logits = torch.where(at_begin & (col < timestamp_begin), neg, logits)
    if max_initial_timestamp_index is not None:
        last_allowed = timestamp_begin + max_initial_timestamp_index
        logits = torch.where(at_begin & (col > last_allowed), neg, logits)

    # the timestamp probability mass rule
    if detect_from_logprob:
        logprobs = torch.log_softmax(logits, dim=-1)
        ts_mask = col >= timestamp_begin
        ts_lp = torch.logsumexp(torch.where(ts_mask, logprobs, neg), dim=-1)
        max_text_lp = torch.where(~ts_mask, logprobs, neg).amax(dim=-1)
        force = (ts_lp > max_text_lp)[:, None]
        logits = torch.where(force & (col < timestamp_begin), neg, logits)
    return logits
