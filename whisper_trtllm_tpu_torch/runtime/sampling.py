"""Token selection and the penalty and word-rule processors (counterpart of
``whisper_trtllm_tpu/runtime/sampling.py``).

Every function is a tensor op on ``(B, V)`` logits and the ``(B, max_len)``
token buffer, with positions given as 0-d (or ``(B,)``) device tensors: no
function reads a device value on the host, so each runs inside a captured
CUDA graph as it runs eagerly. Python branches only on configuration
values (a penalty of 0, a neutral temperature), as the JAX module does at
trace time.

The random draw. The JAX package threads a threefry key through its loop;
that stream cannot be reproduced here, and a draw inside a replayed graph
must not read host-side generator state (a replay would repeat the
capture's draw, or depend on how many draws the process made before). So
the draw is Gumbel-max over noise that is a pure function of
(seed, position, lane, token): a counter-based integer hash
(``gumbel_noise``). The seed is a constant of the step and the position a
tensor the step reads from device memory, so each replay draws afresh,
the same seed gives the same tokens, and the CPU and the card compute the
same integers (their float noise differs by the last bits of ``log``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1.0e9

# the hash's mixing constants, each below 2**31 so that a product with a
# 32-bit value stays inside int64 on every device (murmur2's multiplier and
# the first of the "lowbias32" pair)
_MIX1 = 0x5BD1E995
_MIX2 = 0x7FEB352D
_MASK32 = 0xFFFFFFFF


def _as_device(x, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``like``'s device: a tensor already there is
    used as it is (no copy, nothing for a capture to refuse)."""
    if isinstance(x, torch.Tensor) and x.device == like.device:
        return x if dtype is None or x.dtype == dtype else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=like.device)


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    if temperature == 1.0:
        return logits
    return logits / max(temperature, 1e-6)


def _seen_mask(logits: torch.Tensor, tokens: torch.Tensor, pos) -> torch.Tensor:
    """(B, V) bool: the token appears in ``tokens[:, :pos + 1]``; ``pos`` a
    scalar or one position per lane. Ids outside [0, V) are dropped, as
    JAX's scatter drops them: every one goes to a spare column."""
    b, v = logits.shape
    pos = _as_device(pos, tokens)
    idx = torch.arange(tokens.shape[1], device=tokens.device)
    valid = idx[None] <= (pos[:, None] if pos.dim() == 1 else pos)
    tok = tokens.long()
    col = torch.where(valid & (tok >= 0) & (tok < v), tok, v)
    seen = torch.zeros((b, v + 1), dtype=torch.bool, device=logits.device)
    return seen.scatter_(1, col, True)[:, :v]


def apply_repetition_penalty(logits: torch.Tensor, tokens: torch.Tensor, pos,
                             penalty: float) -> torch.Tensor:
    """CTRL-style penalty over the buffer up to ``pos``: a seen token's
    positive logit is divided by ``penalty``, a negative one multiplied."""
    if penalty == 1.0:
        return logits
    seen = _seen_mask(logits, tokens, pos)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits of each row, -1e9 the rest."""
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[:, -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens whose cumulative
    probability reaches p (the top token always), -1e9 the rest."""
    if p <= 0.0 or p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < p
    thresholds = torch.where(keep, sorted_logits, torch.inf).amin(dim=-1)
    return torch.where(logits < thresholds[:, None], NEG_INF, logits)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche step on int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * _MIX1) & _MASK32
    x = x ^ (x >> 15)
    x = (x * _MIX2) & _MASK32
    return x ^ (x >> 16)


def gumbel_noise(seed: int, pos, batch: int, vocab: int,
                 device, lane_offset: int = 0) -> torch.Tensor:
    """(batch, vocab) fp32 standard Gumbel noise, a pure function of
    (seed, pos, lane, token): ``pos`` is an int or a 0-d integer tensor
    (read on the device); the rows are lanes ``lane_offset`` to
    ``lane_offset + batch - 1`` of the whole batch (a data rank's rows start
    at its first global row), so a batch cut over ranks draws what the
    whole batch draws. 24 hashed bits make a uniform in (0, 1)."""
    device = torch.device(device)
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=device, dtype=torch.int64)
    else:
        pos = torch.tensor(int(pos), dtype=torch.int64, device=device)
    lane = torch.arange(lane_offset, lane_offset + batch, dtype=torch.int64,
                        device=device)[:, None]
    tok = torch.arange(vocab, dtype=torch.int64, device=device)[None]
    h = _mix(torch.full((), int(seed) & _MASK32, dtype=torch.int64,
                        device=device) ^ 0x3C6EF372)
    h = _mix(h ^ (pos & _MASK32))
    h = _mix(h ^ lane)
    h = _mix(h ^ tok)
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample_token(
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    tokens: Optional[torch.Tensor] = None,
    pos=None,
    repetition_penalty: float = 1.0,
    do_sample: bool = False,
    seed: int = 0,
    lane_offset: int = 0,
) -> torch.Tensor:
    """(B, V) logits → (B,) int32 ids: penalties → temperature → top-k →
    top-p → categorical draw, with the JAX package's semantics: any
    non-neutral temperature, top-k or top-p draws; a repetition-penalty-
    only configuration stays (penalized) greedy; ``do_sample`` draws with
    every knob neutral. The draw is Gumbel-max over ``gumbel_noise(seed,
    pos, ...)`` (``pos`` 0 when not given), row i taking global lane
    ``lane_offset + i``; ``torch.argmax`` returns the
    first index of a maximum, as ``jnp.argmax`` does."""
    if tokens is not None and repetition_penalty != 1.0:
        logits = apply_repetition_penalty(logits, tokens, pos,
                                          repetition_penalty)
    if (not do_sample and temperature == 1.0 and top_k <= 0
            and (top_p <= 0.0 or top_p >= 1.0)):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = apply_temperature(logits, temperature)
    logits = top_k_filter(logits, top_k)
    logits = top_p_filter(logits, top_p)
    b, v = logits.shape
    noise = gumbel_noise(seed, 0 if pos is None else pos, b, v, logits.device,
                         lane_offset)
    return torch.argmax(logits + noise, dim=-1).to(torch.int32)


def apply_presence_penalty(logits: torch.Tensor, tokens: torch.Tensor, pos,
                           penalty: float) -> torch.Tensor:
    """Subtract ``penalty`` once from every token present in the buffer up
    to ``pos`` (the reference's additive presence penalty)."""
    if penalty == 0.0:
        return logits
    return torch.where(_seen_mask(logits, tokens, pos), logits - penalty,
                       logits)


def apply_min_new_tokens(logits: torch.Tensor, gen_count,
                         min_new_tokens: int,
                         eos_token_id: int) -> torch.Tensor:
    """Ban EOS while fewer than ``min_new_tokens`` tokens were generated:
    ``gen_count`` a scalar or (B,) count, the candidate not included. A
    negative EOS id counts from the end, as JAX's indexing does."""
    if min_new_tokens <= 0:
        return logits
    v = logits.shape[1]
    short = _as_device(gen_count, logits) < min_new_tokens
    short = short.reshape(-1, 1)
    col = torch.arange(v, device=logits.device) == eos_token_id % v
    return torch.where(short & col[None], NEG_INF, logits)


def pad_word_list(words) -> Tuple[np.ndarray, np.ndarray]:
    """[[ids...], ...] → (numpy (W, Lmax) int32 padded with -1, numpy (W,)
    int32 lengths)."""
    if not words:
        raise ValueError("empty word list")
    lens = np.asarray([len(w) for w in words], np.int32)
    if (lens < 1).any():
        raise ValueError("every word must have at least one token")
    table = np.full((len(words), int(lens.max())), -1, np.int32)
    for i, w in enumerate(words):
        table[i, : len(w)] = w
    return table, lens


def word_table(words, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pad_word_list`` as int64 tensors on ``device``, made once before a
    decode (a capture cannot copy from the host)."""
    table, lens = pad_word_list(words)
    return (torch.from_numpy(table).long().to(device),
            torch.from_numpy(lens).long().to(device))


def _trailing_match(tokens: torch.Tensor, pos, table: torch.Tensor,
                    match_lens: torch.Tensor) -> torch.Tensor:
    """(B, W) bool: ``tokens[:, pos - match_lens[w] + 1 .. pos]`` equals
    ``table[w, :match_lens[w]]``. A word with match length 0 matches
    vacuously; one longer than the context (``pos + 1``) never does."""
    b, max_len = tokens.shape
    pos = _as_device(pos, tokens, torch.int64)
    pos_b = pos if pos.dim() == 1 else pos.expand(b)
    width = table.shape[1]
    j = torch.arange(width, device=tokens.device)
    ml = match_lens.long()
    idx = pos_b[:, None, None] - ml[None, :, None] + 1 + j[None, None, :]
    valid_j = j[None, :] < ml[:, None]                              # (W, J)
    gathered = torch.gather(
        tokens.long()[:, None, :].expand(b, table.shape[0], max_len), 2,
        idx.clamp(0, max_len - 1))
    tok_match = gathered == table[None]                             # (B, W, J)
    enough = ml[None, :] <= pos_b[:, None] + 1                      # (B, W)
    return (tok_match | ~valid_j[None]).all(dim=2) & enough


def _tables(words, like: torch.Tensor):
    table, lens = words
    return (_as_device(table, like, torch.int64),
            _as_device(lens, like, torch.int64))


def ban_bad_words(logits: torch.Tensor, tokens: torch.Tensor, pos,
                  bad_words) -> torch.Tensor:
    """Ban the last token of every bad word whose prefix matches the tokens
    up to ``pos`` (a one-token word always); ``bad_words`` is
    ``pad_word_list``'s or ``word_table``'s pair."""
    table, lens = _tables(bad_words, logits)
    b, v = logits.shape
    match = _trailing_match(tokens, pos, table, lens - 1)           # (B, W)
    last = table.gather(1, (lens - 1)[:, None])[:, 0]               # (W,)
    col = torch.where(match, last[None], v)
    ban = torch.zeros((b, v + 1), dtype=torch.bool, device=logits.device)
    ban = ban.scatter_(1, col, True)[:, :v]
    return torch.where(ban, NEG_INF, logits)


def match_stop_words(tokens: torch.Tensor, last_pos, stop_words
                     ) -> torch.Tensor:
    """(B,) bool: the tokens ending at ``last_pos`` equal some whole stop
    word."""
    table, lens = _tables(stop_words, tokens)
    return _trailing_match(tokens, last_pos, table, lens).any(dim=1)
