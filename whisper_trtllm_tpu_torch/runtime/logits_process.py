"""Logits processors as precomputed masks and maps (counterpart of
``whisper_trtllm_tpu/runtime/logits_process.py``): a static additive
suppress mask, a begin-suppress mask applied at one position, and a
forced-token map indexed by position. Built in numpy once per decode."""

from __future__ import annotations

from typing import Tuple

import numpy as np

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
