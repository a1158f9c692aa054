"""Model-agnostic causal-LM generation loop (counterpart of
``whisper_trtllm_tpu/runtime/causal_lm.py``): one decode loop serving every
decoder-only zoo model, parameterized by two callables.

- ``prefill(params, tokens, cache_k, cache_v) -> (last_logits, ck, cv)``:
  the context phase. It runs the whole prompt once, writes K/V into the
  static caches (in place here) and returns the last position's logits
  (B, V) fp32.
- ``step(params, tok, pos, cache_k, cache_v) -> (logits, ck, cv)``: the
  generation phase, one token for the whole batch, the cache appended at
  ``pos`` (a 0-d tensor, or one position a lane (B,) in the ragged loop).

The per-step pipeline is the JAX package's: penalties, then min-length,
then the bad-words ban, then the sampled or greedy choice; EOS tracking
and stop words after it. The JAX loop is a ``lax.while_loop`` on the
device. Here the loop body runs through ``generation.run_decode``, as the
Whisper decode does: the prefill and the first token run eagerly in
``bind``, then on the card the step is captured once as a CUDA graph
after ``WARMUP_STEPS`` eager steps and replayed; on the CPU the same step
runs eagerly. The host reads ``finished`` once every
``FINISH_CHECK_EVERY`` steps, so a call may run up to that many steps
past the JAX loop's stop; those steps write EOS where EOS already stands,
so the tokens equal the JAX loop's. A capture that fails raises.

The draw: ``sampling.sample_token``'s Gumbel-max over noise keyed by
(seed, position): the lockstep loop's position is the column it reads, the
ragged loop's its step counter. Sampled tokens cannot equal the JAX
package's threefry draws; every deterministic rule equals its.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
from whisper_trtllm_tpu_torch.runtime import sampling


class SamplingParams(NamedTuple):
    """Static sampling knobs: the reference's SamplingConfig plus the word
    lists (``sampling.pad_word_list`` tables, numpy)."""
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    repetition_penalty: float = 1.0
    seed: int = 0
    do_sample: bool = False
    presence_penalty: float = 0.0
    min_new_tokens: int = 0
    bad_words: Optional[tuple] = None   # pad_word_list output (numpy)
    stop_words: Optional[tuple] = None  # pad_word_list output (numpy)


def make_sampling_cfg(temperature: float = 1.0, top_k: int = 0,
                      top_p: float = 0.0, repetition_penalty: float = 1.0,
                      seed: int = 0, do_sample: bool = False,
                      presence_penalty: float = 0.0, min_new_tokens: int = 0,
                      bad_words=None, stop_words=None
                      ) -> Optional[SamplingParams]:
    """None when every knob is neutral and sampling was not forced (pure
    greedy). ``do_sample=True`` draws even with neutral knobs;
    ``bad_words``/``stop_words`` are lists of token-id lists, padded to
    tables here."""
    if not (do_sample or temperature != 1.0 or top_k > 0
            or (0.0 < top_p < 1.0) or repetition_penalty != 1.0
            or presence_penalty != 0.0 or min_new_tokens > 0
            or bad_words or stop_words):
        return None
    return SamplingParams(
        temperature=temperature, top_k=top_k, top_p=top_p,
        repetition_penalty=repetition_penalty, seed=seed, do_sample=do_sample,
        presence_penalty=presence_penalty, min_new_tokens=min_new_tokens,
        bad_words=sampling.pad_word_list(bad_words) if bad_words else None,
        stop_words=sampling.pad_word_list(stop_words) if stop_words else None,
    )


def sampling_key(sc: Optional[SamplingParams]):
    """``sc`` as a hashable value (its word tables as tuples), for the
    captured step's cache key."""
    if sc is None:
        return None

    def words(w):
        if w is None:
            return None
        return tuple((a.shape, tuple(a.ravel().tolist())) for a in w)

    return sc._replace(bad_words=words(sc.bad_words),
                       stop_words=words(sc.stop_words))


class Words(NamedTuple):
    """The word tables of one decode on its device, made once before the
    loop (a capture cannot copy from the host)."""
    bad: Optional[tuple]
    stop: Optional[tuple]


def device_words(sc: Optional[SamplingParams], device) -> Words:
    """``sc``'s word tables as int64 tensors on ``device``."""
    def table(w):
        if w is None:
            return None
        return tuple(torch.from_numpy(a).long().to(device) for a in w)

    if sc is None:
        return Words(None, None)
    return Words(table(sc.bad_words), table(sc.stop_words))


def process_logits(sc: SamplingParams, logits: torch.Tensor,
                   tokens: torch.Tensor, pos, gen_count, eos_token_id: int,
                   words: Words) -> torch.Tensor:
    """The per-step processors in the reference's order: repetition and
    presence penalties over ``tokens[:, :pos + 1]``, the min-length EOS ban
    while fewer than ``min_new_tokens`` were generated (``gen_count``), the
    bad-words ban."""
    if sc.repetition_penalty != 1.0:
        logits = sampling.apply_repetition_penalty(
            logits, tokens, pos, sc.repetition_penalty)
    if sc.presence_penalty != 0.0:
        logits = sampling.apply_presence_penalty(
            logits, tokens, pos, sc.presence_penalty)
    if sc.min_new_tokens > 0:
        logits = sampling.apply_min_new_tokens(
            logits, gen_count, sc.min_new_tokens, eos_token_id)
    if words.bad is not None:
        logits = sampling.ban_bad_words(logits, tokens, pos, words.bad)
    return logits


def _pick_token(sc: Optional[SamplingParams], logits: torch.Tensor,
                tokens: torch.Tensor, pos, gen_count, eos_token_id: int,
                draw_pos, words: Words) -> torch.Tensor:
    """The per-step pipeline: ``process_logits``, then the sampled or
    greedy choice; (B,) int32. ``draw_pos`` keys the noise."""
    if sc is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = process_logits(sc, logits, tokens, pos, gen_count, eos_token_id,
                            words)
    return sampling.sample_token(
        logits, temperature=sc.temperature, top_k=sc.top_k, top_p=sc.top_p,
        pos=draw_pos, do_sample=sc.do_sample, seed=sc.seed)


class GenState(NamedTuple):
    """The loop's state, every tensor on the decode's device and updated in
    place by the step."""
    tokens: torch.Tensor     # (B, max_len) int32
    pos: torch.Tensor        # 0-d (lockstep) or (B,) (ragged) int32
    t: torch.Tensor          # 0-d int32: steps taken (ragged)
    finished: torch.Tensor   # (B,) bool
    lens: torch.Tensor       # (B,) int32: the prompts' lengths (ragged)
    cache_k: torch.Tensor    # (L, B, H, T, dh)
    cache_v: torch.Tensor


def _new_state(b: int, max_len: int, pos_shape: tuple, cache_shape,
               cache_dtype, device) -> GenState:
    return GenState(
        tokens=torch.empty((b, max_len), dtype=torch.int32, device=device),
        pos=torch.zeros(pos_shape, dtype=torch.int32, device=device),
        t=torch.zeros((), dtype=torch.int32, device=device),
        finished=torch.zeros(b, dtype=torch.bool, device=device),
        lens=torch.zeros(b, dtype=torch.int32, device=device),
        cache_k=torch.zeros(cache_shape, dtype=cache_dtype, device=device),
        cache_v=torch.zeros(cache_shape, dtype=cache_dtype, device=device))


def _lockstep_step(step, params, sc, s: GenState, words: Words,
                   eos_token_id: int, prompt_len: int) -> None:
    """The JAX loop's body, in place on ``s``: decode the token at ``pos``,
    pick the next, write it at ``pos + 1``; a finished lane writes EOS."""
    pos = s.pos
    max_len = s.tokens.shape[1]
    cur = s.tokens.index_select(1, pos.long().reshape(1))[:, 0]
    logits, _, _ = step(params, cur, pos, s.cache_k, s.cache_v)
    nxt = _pick_token(sc, logits, s.tokens, pos, pos + 1 - prompt_len,
                      eos_token_id, pos, words)
    nxt = torch.where(s.finished, eos_token_id, nxt).to(torch.int32)
    finished = s.finished | (nxt == eos_token_id)
    # the limit keeps pos + 1 inside the buffer; the clamp only guards it
    col = (pos.long() + 1).clamp(max=max_len - 1).reshape(1)
    s.tokens.index_copy_(1, col, nxt[:, None])
    if words.stop is not None:
        # a lane already finished keeps writing EOS pads: it takes no
        # fresh stop-word match on them
        finished = finished | (~s.finished & sampling.match_stop_words(
            s.tokens, pos + 1, words.stop))
    s.finished.copy_(finished)
    s.pos.add_(1)


@torch.inference_mode()
def generate_tokens(
    prefill: Callable,
    step: Callable,
    params: dict,
    prompt: torch.Tensor,
    cache_shape: Tuple[int, ...],
    prompt_len: int,
    max_len: int,
    eos_token_id: int,
    sampling_cfg: Optional[SamplingParams] = None,
    cache_dtype=torch.float32,
    key=None,
) -> torch.Tensor:
    """prompt (B, P) int32 on the decode's device → tokens (B, max_len)
    int32; positions at and after EOS hold ``eos_token_id``. A lane stopped
    by a stop word keeps the word and pads the rest with EOS. ``key``
    names the (prefill, step) pair for the captured step's cache (default:
    the callables themselves)."""
    if max_len <= prompt_len:
        raise ValueError(
            f"max_len ({max_len}) must exceed prompt_len ({prompt_len}): the "
            "prompt fills the context window, nothing can be generated")
    sc = sampling_cfg
    dev = prompt.device
    b = prompt.shape[0]

    def make():
        return (_new_state(b, max_len, (), cache_shape, cache_dtype, dev),
                None, device_words(sc, dev))

    def bind(entry):
        s, words = entry.state, entry.rules
        s.cache_k.zero_()
        s.cache_v.zero_()
        logits, _, _ = prefill(params, prompt, s.cache_k, s.cache_v)
        s.tokens.fill_(eos_token_id)
        s.tokens[:, :prompt_len] = prompt
        s.pos.fill_(prompt_len - 1)
        first = _pick_token(sc, logits, s.tokens, s.pos, s.pos + 1 - prompt_len,
                            eos_token_id, s.pos, words)
        s.tokens[:, prompt_len] = first
        finished = first == eos_token_id
        if words.stop is not None:
            finished = finished | sampling.match_stop_words(
                s.tokens, prompt_len, words.stop)
        s.finished.copy_(finished)
        s.pos.fill_(prompt_len)
        return lambda: _lockstep_step(step, params, sc, s, words,
                                      eos_token_id, prompt_len)

    run_key = ("causal_lm", (prefill, step) if key is None else key, b,
               prompt_len, max_len, tuple(cache_shape), cache_dtype, dev,
               eos_token_id, sampling_key(sc))
    # the entry is keyed by every weight of the model
    entry = gen_rt.run_decode(run_key, {"decoder": params}, dev,
                              max_len - 1 - prompt_len, make,
                              lambda entry: None, bind,
                              lambda s: bool(s.finished.all()))
    return entry.state.tokens.clone()


def _ragged_step(step, params, sc, s: GenState, words: Words,
                 eos_token_id: int, step_lens: bool = False) -> None:
    """The ragged loop's body, in place on ``s``: lane b decodes its token
    at ``pos[b]`` and writes the next at ``pos[b] + 1`` (clamped to the
    buffer's last column). With ``step_lens`` the step also takes the
    prompts' lengths, the state's (B,) tensor."""
    max_len = s.tokens.shape[1]
    pos = s.pos
    cur = s.tokens.gather(1, pos.long()[:, None])[:, 0]
    extra = (s.lens,) if step_lens else ()
    logits, _, _ = step(params, cur, pos, s.cache_k, s.cache_v, *extra)
    nxt = _pick_token(sc, logits, s.tokens, pos, pos + 1 - s.lens,
                      eos_token_id, s.t, words)
    nxt = torch.where(s.finished, eos_token_id, nxt).to(torch.int32)
    finished = s.finished | (nxt == eos_token_id)
    new_pos = (pos + 1).clamp(max=max_len - 1)
    s.tokens.scatter_(1, new_pos.long()[:, None], nxt[:, None])
    if words.stop is not None:
        finished = finished | (~s.finished & sampling.match_stop_words(
            s.tokens, new_pos, words.stop))
    s.finished.copy_(finished)
    s.pos.copy_(new_pos)
    s.t.add_(1)


@torch.inference_mode()
def generate_tokens_ragged(
    prefill: Callable,
    step: Callable,
    params: dict,
    prompt: torch.Tensor,
    prompt_lens: torch.Tensor,
    cache_shape: Tuple[int, ...],
    max_new_tokens: int,
    eos_token_id: int,
    sampling_cfg: Optional[SamplingParams] = None,
    cache_dtype=torch.float32,
    key=None,
    step_lens: bool = False,
) -> torch.Tensor:
    """Variable-length batched generation: right-padded ``prompt`` (B, P)
    with per-row ``prompt_lens`` (B,) → tokens (B, P + max_new_tokens); row
    b holds its prompt, then its continuation from column
    ``prompt_lens[b]``, then EOS.

    ``prefill(params, prompt, prompt_lens, ck, cv)`` returns each row's
    logits at its own last valid position; ``step`` takes per-lane
    positions (B,) (per-lane cache writes and valid lengths). Right
    padding is safe under a causal mask: a pad position attends only
    backward, and each lane's generated K/V overwrite the pad rows in
    order, the valid length masking everything past the lane's frontier.
    With ``step_lens`` the step is called as ``step(params, tok, pos, ck,
    cv, lens)``, ``lens`` the prompts' lengths in the loop's state, which
    a captured step reads on every replay (ChatGLM's per-lane positions
    come from them)."""
    if max_new_tokens < 1:
        raise ValueError("generate_tokens_ragged needs max_new_tokens >= 1 "
                         "(the first-token write indexes column prompt_len)")
    sc = sampling_cfg
    dev = prompt.device
    b, p = prompt.shape
    max_len = p + max_new_tokens
    lens = torch.as_tensor(prompt_lens, device=dev).to(torch.int32)

    def make():
        return (_new_state(b, max_len, (b,), cache_shape, cache_dtype, dev),
                None, device_words(sc, dev))

    def bind(entry):
        s, words = entry.state, entry.rules
        s.lens.copy_(lens)
        s.cache_k.zero_()
        s.cache_v.zero_()
        logits, _, _ = prefill(params, prompt, lens, s.cache_k, s.cache_v)
        s.tokens.fill_(eos_token_id)
        s.tokens[:, :p] = prompt
        # right-pad garbage past each row's length becomes EOS
        col = torch.arange(max_len, device=dev)[None, :]
        s.tokens.copy_(torch.where(col < lens[:, None], s.tokens,
                                   eos_token_id))
        s.t.zero_()
        first = _pick_token(sc, logits, s.tokens, lens - 1, lens - lens,
                            eos_token_id, s.t, words)
        s.tokens.scatter_(1, lens.long()[:, None], first[:, None])
        finished = first == eos_token_id
        if words.stop is not None:
            finished = finished | sampling.match_stop_words(
                s.tokens, lens, words.stop)
        s.finished.copy_(finished)
        s.pos.copy_(lens)
        s.t.fill_(1)
        return lambda: _ragged_step(step, params, sc, s, words, eos_token_id,
                                    step_lens)

    run_key = ("causal_lm_ragged", (prefill, step) if key is None else key,
               b, p, max_new_tokens, tuple(cache_shape), cache_dtype, dev,
               eos_token_id, sampling_key(sc), step_lens)
    entry = gen_rt.run_decode(run_key, {"decoder": params}, dev,
                              max_new_tokens - 1, make, lambda entry: None,
                              bind, lambda s: bool(s.finished.all()))
    return entry.state.tokens.clone()
