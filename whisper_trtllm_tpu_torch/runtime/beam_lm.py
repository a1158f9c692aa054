"""Beam search for decoder-only (causal) LMs (counterpart of
``whisper_trtllm_tpu/runtime/beam_lm.py``).

The JAX package runs it as one ``lax.while_loop`` over the prefill/step
contract of ``runtime/causal_lm.py``: the prompt is prefilled once at beam
width 1, the caches are tiled K-wide beam-major (lane ``b * K + j``), each
step expands 2K candidates, retires EOS candidates ranked within the top K
into a finished pool (length-penalized by the generated length, EOS
counted, the prompt not), keeps the best K others alive and reorders the
caches to their parents; a lane stops when its finished pool is full
(HF ``early_stopping=True``). The port keeps that shape and runs it
through ``generation.run_decode`` as ``runtime/beam.py`` runs Whisper's:
the prefill and the first expansion in ``bind``, eagerly; the step
captured once as a CUDA graph on the card and replayed, eager on the CPU.

The JAX ``cond`` is the state's ``go``: every update of the state (the
pools, ``pos`` and the cache reorder, whose parents become the identity)
applies only under it, so the steps the host runs past the JAX loop's stop
(it reads ``go`` once every ``FINISH_CHECK_EVERY`` steps) change nothing
that reaches the output. Ties in a top-k go to the lower index, as
``jax.lax.top_k`` orders them (``runtime/beam.py::top_k``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
from whisper_trtllm_tpu_torch.runtime.beam import (
    NEG_INF,
    _gather_beams,
    _length_penalty,
    reorder_caches,
    top_k,
)


class BeamLMState(NamedTuple):
    """The loop's state, every tensor on the decode's device and updated in
    place by the step."""
    alive_tokens: torch.Tensor      # (B, K, max_len) int32
    alive_scores: torch.Tensor      # (B, K) fp32 cumulative log-prob
    finished_tokens: torch.Tensor   # (B, K, max_len) int32
    finished_scores: torch.Tensor   # (B, K) fp32 length-penalized
    finished_lengths: torch.Tensor  # (B, K) int32, the EOS counted
    pos: torch.Tensor               # 0-d int32: the last written column
    cache_k: torch.Tensor           # (L, B * K, H, T, dh) beam-major
    cache_v: torch.Tensor
    go: torch.Tensor                # 0-d bool: the JAX loop's cond


def _batch_done(fin_scores: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the lane's finished pool holds K real hypotheses."""
    return (fin_scores > NEG_INF / 2).all(dim=1)


def _expand(s: BeamLMState, logits: torch.Tensor, prompt_len: int,
            eos_token_id: int, length_penalty: float) -> None:
    """One beam expansion from raw step logits (B * K, V), in place on
    ``s`` and only under ``s.go``: write column ``pos + 1``, refresh the
    alive and finished pools, reorder the caches to the surviving parents,
    then ``go`` for the state it leaves."""
    b, k, max_len = s.alive_tokens.shape
    vocab = logits.shape[-1]
    dev = logits.device
    go = s.go
    nxt = s.pos + 1
    col = nxt.long().reshape(1).clamp(max=max_len - 1)
    logp = torch.log_softmax(logits.float(), dim=-1).view(b, k, vocab)
    cand = s.alive_scores[:, :, None] + logp
    topv, topi = top_k(cand.view(b, k * vocab), 2 * k)
    parents = topi // vocab
    tok_ids = (topi % vocab).to(torch.int32)
    seqs = _gather_beams(s.alive_tokens, parents)          # (B, 2K, max)
    seqs.index_copy_(2, col, tok_ids[:, :, None])
    # only EOS candidates ranked within the top K retire, and never a dead
    # beam's NEG_INF-scored one
    in_top_k = torch.arange(2 * k, device=dev) < k
    is_eos_tok = tok_ids == eos_token_id
    is_eos = is_eos_tok & in_top_k & (topv > NEG_INF / 2)
    # the alive set: the best K non-EOS candidates
    alive_cand = torch.where(is_eos_tok, NEG_INF, topv)
    new_alive_scores, alive_sel = top_k(alive_cand, k)
    new_alive_tokens = _gather_beams(seqs, alive_sel)
    alive_parents = parents.gather(1, alive_sel)
    # the finished pool, penalized by the generated length with the EOS
    fin_cand = torch.where(
        is_eos, topv / _length_penalty(nxt + 1 - prompt_len, length_penalty),
        NEG_INF)
    fin_cand = torch.where(_batch_done(s.finished_scores)[:, None], NEG_INF,
                           fin_cand)
    merged_scores = torch.cat([s.finished_scores, fin_cand], dim=1)
    merged_tokens = torch.cat([s.finished_tokens, seqs], dim=1)
    merged_lengths = torch.cat(
        [s.finished_lengths, (nxt + 1).expand(b, 2 * k)], dim=1)
    new_fin_scores, fin_sel = top_k(merged_scores, k)
    new_fin_tokens = _gather_beams(merged_tokens, fin_sel)
    new_fin_lengths = merged_lengths.gather(1, fin_sel)
    # the writes, under go; the caches follow the parents (the identity
    # when go is False)
    beams = torch.arange(k, device=dev)
    src = torch.where(go, alive_parents, beams) \
        + torch.arange(b, device=dev)[:, None] * k
    reorder_caches((s.cache_k, s.cache_v), src.reshape(b * k))
    for dst, new in ((s.alive_tokens, new_alive_tokens),
                     (s.alive_scores, new_alive_scores),
                     (s.finished_tokens, new_fin_tokens),
                     (s.finished_scores, new_fin_scores),
                     (s.finished_lengths, new_fin_lengths)):
        dst.copy_(torch.where(go, new, dst))
    s.pos.add_(go.to(torch.int32))
    s.go.copy_(go & (s.pos < max_len - 1)
               & ~_batch_done(s.finished_scores).all())


def _beam_step(step, params, s: BeamLMState, prompt_len: int,
               eos_token_id: int, length_penalty: float) -> None:
    b, k, max_len = s.alive_tokens.shape
    cur = s.alive_tokens.view(b * k, max_len).index_select(
        1, s.pos.long().reshape(1))[:, 0]
    logits, _, _ = step(params, cur, s.pos, s.cache_k, s.cache_v)
    _expand(s, logits, prompt_len, eos_token_id, length_penalty)


def finalize(s: BeamLMState, prompt_len: int, length_penalty: float
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The code after the JAX loop: where the finished pool never filled,
    the alive beams join it penalized at their full generated length; a
    lane that stopped early drops its alive beams. The best K, best first:
    (tokens (B, K, max_len), scores (B, K), lengths (B, K))."""
    b, k, _ = s.alive_tokens.shape
    alive_len = s.pos + 1
    alive_final = s.alive_scores / _length_penalty(alive_len - prompt_len,
                                                   length_penalty)
    alive_final = torch.where(_batch_done(s.finished_scores)[:, None],
                              NEG_INF, alive_final)
    merged_scores = torch.cat([s.finished_scores, alive_final], dim=1)
    merged_tokens = torch.cat([s.finished_tokens, s.alive_tokens], dim=1)
    merged_lengths = torch.cat(
        [s.finished_lengths, alive_len.expand(b, k).to(torch.int32)], dim=1)
    scores, sel = top_k(merged_scores, k)
    return (_gather_beams(merged_tokens, sel), scores,
            merged_lengths.gather(1, sel))


@torch.inference_mode()
def beam_generate_tokens(
    prefill: Callable,
    step: Callable,
    params: dict,
    prompt: torch.Tensor,
    cache_shape: Tuple[int, ...],
    prompt_len: int,
    max_new_tokens: int,
    eos_token_id: int,
    num_beams: int,
    length_penalty: float = 1.0,
    cache_dtype=torch.float32,
    key=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """prompt (B, P) int32 on the decode's device → (tokens (B, K, P +
    max_new_tokens) best-first, scores (B, K) length-penalized, lengths
    (B, K)). ``cache_shape`` is the untiled (L, B, H, T, dh) shape with T
    >= P + max_new_tokens: the context phase runs at beam width 1 and the
    caches are tiled K-wide after it. ``key`` names the (prefill, step)
    pair for the captured step's cache (default: the callables)."""
    if max_new_tokens < 1:
        raise ValueError("beam_generate_tokens needs max_new_tokens >= 1")
    b, p = prompt.shape
    if p != prompt_len:
        raise ValueError(f"prompt width {p} != prompt_len {prompt_len}")
    k = num_beams
    max_len = prompt_len + max_new_tokens
    dev = prompt.device
    n_layer, _, heads, t, dh = cache_shape
    tiled = (n_layer, b * k, heads, t, dh)

    def make():
        def tensor(shape, dt):
            return torch.empty(shape, dtype=dt, device=dev)

        state = BeamLMState(
            alive_tokens=tensor((b, k, max_len), torch.int32),
            alive_scores=tensor((b, k), torch.float32),
            finished_tokens=tensor((b, k, max_len), torch.int32),
            finished_scores=tensor((b, k), torch.float32),
            finished_lengths=tensor((b, k), torch.int32),
            pos=tensor((), torch.int32),
            cache_k=torch.zeros(tiled, dtype=cache_dtype, device=dev),
            cache_v=torch.zeros(tiled, dtype=cache_dtype, device=dev),
            go=tensor((), torch.bool))
        return state, None, None

    def bind(entry):
        s = entry.state
        for cache in (s.cache_k, s.cache_v):
            cache.zero_()
        # the context phase at beam width 1, written into beam 0 of each
        # lane, then copied to the lane's other beams
        views = [c.view(n_layer, b, k, heads, t, dh) for c in
                 (s.cache_k, s.cache_v)]
        logits0, _, _ = prefill(params, prompt, views[0][:, :, 0],
                                views[1][:, :, 0])
        for v in views:
            v[:, :, 1:].copy_(v[:, :, :1].expand_as(v[:, :, 1:]))
        s.alive_tokens.fill_(eos_token_id)
        s.alive_tokens[:, :, :prompt_len] = prompt[:, None]
        # only beam 0 is live at first: the beams are identical before the
        # first split
        s.alive_scores.fill_(NEG_INF)
        s.alive_scores[:, 0] = 0.0
        s.finished_tokens.fill_(eos_token_id)
        s.finished_scores.fill_(NEG_INF)
        s.finished_lengths.zero_()
        s.pos.fill_(prompt_len - 1)
        s.go.fill_(True)
        _expand(s, logits0.repeat_interleave(k, dim=0), prompt_len,
                eos_token_id, length_penalty)
        return lambda: _beam_step(step, params, s, prompt_len, eos_token_id,
                                  length_penalty)

    run_key = ("beam_lm", (prefill, step) if key is None else key, b, k,
               prompt_len, max_new_tokens, tuple(cache_shape), cache_dtype,
               dev, eos_token_id, float(length_penalty))
    entry = gen_rt.run_decode(run_key, {"decoder": params}, dev,
                              max_len - 1 - prompt_len, make,
                              lambda entry: None, bind,
                              lambda s: not bool(s.go))
    return finalize(entry.state, prompt_len, length_penalty)


def make_generate_beam(prefill: Callable, step: Callable):
    """Wire a zoo family's ``(prefill, step)`` pair (each taking ``(params,
    cfg, ...)``) into ``generate_beam(params, cfg, prompt, max_new_tokens,
    num_beams, length_penalty=1.0, device=None)``. Needs the standard
    config fields (n_layer, n_head, head_dim, n_positions or
    max_positions, eos_token_id); families with GQA caches keep their own
    wiring."""
    from whisper_trtllm_tpu_torch.models.zoo import prepare

    def generate_beam(params, cfg, prompt, max_new_tokens: int,
                      num_beams: int, length_penalty: float = 1.0,
                      device=None):
        limit = getattr(cfg, "n_positions", None) or getattr(
            cfg, "max_positions", None)
        prompt, dtype = prepare(params, prompt, device)
        if limit and prompt.shape[1] + max_new_tokens > limit:
            raise ValueError(
                "prompt_len + max_new_tokens exceeds the position limit")
        b, p = prompt.shape
        return beam_generate_tokens(
            lambda pr, tk, ck, cv: prefill(pr, cfg, tk, ck, cv),
            lambda pr, tok, pos, ck, cv: step(pr, cfg, tok, pos, ck, cv),
            params, prompt,
            cache_shape=(cfg.n_layer, b, cfg.n_head, p + max_new_tokens,
                         cfg.head_dim),
            prompt_len=p, max_new_tokens=max_new_tokens,
            eos_token_id=cfg.eos_token_id, num_beams=num_beams,
            length_penalty=float(length_penalty), cache_dtype=dtype,
            key=(prefill, step, cfg))

    return generate_beam
