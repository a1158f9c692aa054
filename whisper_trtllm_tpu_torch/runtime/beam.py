"""Beam search (counterpart of ``whisper_trtllm_tpu/runtime/beam.py``:
``beam_decode`` and ``beam_decode_prompted``).

The JAX package runs the alive/finished-pool beam search inside one
``lax.while_loop``: a 2K candidate expansion a step, candidates that hit
EOS or a stop word retired into a finished pool with the length penalty
(HF-exact retirement), the self caches reordered to the surviving beams'
parents, the three HF ``early_stopping`` modes. The port keeps that shape
and runs it through the greedy loop's machinery
(``generation.run_decode``): ``beam_step`` is the body of
``_beam_decode_impl`` on a ``BeamState`` of device tensors updated in
place, captured once as a CUDA graph on the card and replayed, run eagerly
on the CPU; ``finalize`` is the code after the loop, run once.

The JAX ``cond`` is the state's ``go``: the step computes it for the state
it leaves, and applies every update of the state (``pos``, both pools,
``es_unsat``, ``all_hit`` and the cache reorder, whose parents become the
identity) only under it. A step after the JAX loop would have stopped is
then a no-op on everything that reaches the output; the host reads ``go``
once every ``FINISH_CHECK_EVERY`` steps, as it reads ``finished`` in the
greedy loop.

Ties. ``jax.lax.top_k`` puts the lower index first among equal values, and
ties are common here (a dead beam's candidates all sit at ``-1e9``, whose
fp32 ulp is 64; the first step and the forced positions tie most of the
2K candidates). ``top_k`` below is a stable descending sort and a slice,
the same order on both devices.

Cross K/V are computed once at batch B and repeated K times beam-major
(lane ``b * K + j``); the projections are not run K times.

On a tree cut over the model axis (``parallel/partition.py``) the caches
hold the rank's heads, and ``reorder_caches`` moves only them; ``go``
comes from the all-reduced logits, the same on every rank of the group.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from whisper_trtllm_tpu_torch.config import GenerationConfig, WhisperConfig
from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
from whisper_trtllm_tpu_torch.parallel.partition import local_model
from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
from whisper_trtllm_tpu_torch.runtime import logits_process as lp
from whisper_trtllm_tpu_torch.runtime import sampling
from whisper_trtllm_tpu_torch.utils.device import to_tensor

NEG_INF = -1.0e9


class BeamState(NamedTuple):
    """The beam loop's state, every tensor on the decode's device and
    updated in place by ``beam_step``."""

    alive_tokens: torch.Tensor      # (B, K, max_len) int32
    alive_scores: torch.Tensor      # (B, K) fp32 cumulative log-prob
    finished_tokens: torch.Tensor   # (B, K, max_len) int32
    finished_scores: torch.Tensor   # (B, K) fp32 length-penalized
    finished_lengths: torch.Tensor  # (B, K) int32
    pos: torch.Tensor               # 0-d int32: the last filled position
    self_kv: tuple                  # at B * K lanes, beam-major
    es_unsat: torch.Tensor          # (B,) bool: improvement still possible
    all_hit: torch.Tensor           # 0-d bool: the last expansion all hit
    go: torch.Tensor                # 0-d bool: the JAX loop's cond


def check_early_stopping(gen: GenerationConfig) -> None:
    if gen.early_stopping not in (True, False, "never"):
        raise ValueError(
            f"early_stopping must be True, False or 'never'; "
            f"got {gen.early_stopping!r}")


def top_k(x: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``n`` largest along the last axis, best first, a tie going to
    the lower index as ``jax.lax.top_k`` orders it: (values, int64
    indices)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :n], idx[..., :n]


def _length_penalty(length: torch.Tensor, alpha: float) -> torch.Tensor:
    return length.to(torch.float32).pow(alpha)


def _gather_beams(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) at idx (B, M) along axis 1 → (B, M, ...)."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def _pool_full(s: BeamState) -> torch.Tensor:
    """(B,) bool: the lane's finished pool holds K real hypotheses."""
    return (s.finished_scores > NEG_INF / 2).all(dim=1)


def _go(s: BeamState, es_mode) -> torch.Tensor:
    """The JAX loop's ``cond`` on a state: an improvement possible
    somewhere, (``early_stopping=True``) some lane's pool not full, the
    last expansion left a viable continuation, and room for a token."""
    max_len = s.alive_tokens.shape[2]
    go = (s.pos < max_len - 1) & s.es_unsat.any() & ~s.all_hit
    if es_mode is True:
        go = go & ~_pool_full(s).all()
    return go


def init_beam_state(cfg: WhisperConfig, gen: GenerationConfig, batch: int,
                    max_len: int, dtype, device, heads=None) -> BeamState:
    """A state's buffers, the self caches at ``heads`` heads (default: the
    config's); ``reset_beam_state`` gives them their first values."""
    k = gen.num_beams

    def tensor(shape, dt):
        return torch.empty(shape, dtype=dt, device=device)

    return BeamState(
        alive_tokens=tensor((batch, k, max_len), torch.int32),
        alive_scores=tensor((batch, k), torch.float32),
        finished_tokens=tensor((batch, k, max_len), torch.int32),
        finished_scores=tensor((batch, k), torch.float32),
        finished_lengths=tensor((batch, k), torch.int32),
        pos=tensor((), torch.int32),
        self_kv=gen_rt.init_self_cache(cfg, gen, batch * k, max_len, dtype,
                                       device, heads),
        es_unsat=tensor((batch,), torch.bool),
        all_hit=tensor((), torch.bool),
        go=tensor((), torch.bool))


def reset_beam_state(s: BeamState, cfg: WhisperConfig,
                     rules: gen_rt.Rules) -> None:
    """The JAX loop's initial state, written in place: every beam holds
    the start token (or the prompt), only beam 0 is live (score 0, the
    others ``NEG_INF``), an empty finished pool, ``pos`` 0, zero caches
    (scales one)."""
    s.alive_tokens.fill_(cfg.pad_token_id)
    if rules.prompt is None:
        s.alive_tokens[:, :, 0] = cfg.decoder_start_token_id
    else:
        s.alive_tokens[:, :, :rules.prompt_len] = rules.prompt[:, None]
    s.alive_scores.fill_(NEG_INF)
    s.alive_scores[:, 0] = 0.0
    s.finished_tokens.fill_(cfg.pad_token_id)
    s.finished_scores.fill_(NEG_INF)
    s.finished_lengths.zero_()
    s.pos.zero_()
    gen_rt.reset_caches(s.self_kv)
    s.es_unsat.fill_(True)
    s.all_hit.fill_(False)
    s.go.fill_(s.alive_tokens.shape[2] > 1)


def beam_step(params: dict, cfg: WhisperConfig, gen: GenerationConfig,
              s: BeamState, cross_kv: Tuple[torch.Tensor, ...],
              rules: gen_rt.Rules, fused: bool) -> None:
    """One step of ``_beam_decode_impl``'s body, in place on ``s`` and only
    under ``s.go``: decode the K beams of every lane at ``pos``,
    log-softmax, the processors in the JAX order, the forced map and the
    prompt window, the 2K expansion, retirement into the finished pool,
    the next alive beams, the cache reorder and the early-stop heuristic;
    then ``go`` for the state it leaves. Reads no device value on the
    host."""
    b, k, max_len = s.alive_tokens.shape
    vocab = cfg.vocab_size
    dev = s.pos.device
    alpha = gen.length_penalty
    es_mode = gen.early_stopping
    prompt_len = rules.prompt_len
    go, pos = s.go, s.pos
    flat_tokens = s.alive_tokens.view(b * k, max_len)
    cur = flat_tokens.index_select(1, pos.long().reshape(1))[:, 0]
    logits, _ = wmodel.decode_step_kv(params, cfg, cur, pos, s.self_kv,
                                      cross_kv, fused=fused)
    nxt_pos = pos + 1
    # the write index, clamped: a step after the loop's end (go False)
    # may sit at the buffer's last position, and its writes are dropped
    nxt1 = nxt_pos.long().reshape(1).clamp(max=max_len - 1)
    # HF's beam search log-softmaxes first and runs the processors on the
    # log-probabilities: the suppressed tokens' mass stays in the
    # normalizer, as in the JAX loop
    logp = torch.log_softmax(logits.float(), dim=-1)
    if gen.presence_penalty != 0.0:
        logp = sampling.apply_presence_penalty(logp, flat_tokens, pos,
                                               gen.presence_penalty)
    if gen.min_new_tokens > 0:
        logp = sampling.apply_min_new_tokens(
            logp, nxt_pos - rules.begin_index, gen.min_new_tokens,
            cfg.eos_token_id)
    if rules.bad_words is not None:
        logp = sampling.ban_bad_words(logp, flat_tokens, pos,
                                      rules.bad_words)
    logp = logp + rules.suppress[None]
    logp = torch.where(nxt_pos == rules.begin_index,
                       logp + rules.begin_suppress[None], logp)
    if rules.timestamps:
        logp = lp.apply_timestamp_rules(
            logp, flat_tokens, pos, rules.begin_index,
            cfg.no_timestamps_token_id + 1, cfg.eos_token_id,
            cfg.max_initial_timestamp_index)
    logp = logp.view(b, k, vocab)

    # forced positions: the forced token at log-prob 0, every other NEG_INF
    col = torch.arange(vocab, device=dev)
    forced = rules.forced_map.index_select(0, nxt1)
    logp = torch.where(forced >= 0,
                       torch.where(col == forced, 0.0, NEG_INF), logp)
    if prompt_len > 1:
        # inside the prompt window every beam takes the lane's prompt
        # token at no cost
        ptok = rules.prompt.index_select(
            1, nxt1.clamp(max=prompt_len - 1))[:, 0]
        prow = torch.where(col[None, None] == ptok[:, None, None], 0.0,
                           NEG_INF)
        logp = torch.where(nxt_pos < prompt_len, prow, logp)

    # the 2K expansion
    cand = s.alive_scores[:, :, None] + logp
    topv, topi = top_k(cand.view(b, k * vocab), 2 * k)
    parents = topi // vocab
    tok_ids = (topi % vocab).to(torch.int32)
    seqs = _gather_beams(s.alive_tokens, parents)          # (B, 2K, max)
    seqs.index_copy_(2, nxt1, tok_ids[:, :, None])
    # per-candidate stop criteria: EOS and stop words (never inside the
    # prompt window)
    hits = tok_ids == cfg.eos_token_id
    if rules.stop_words is not None:
        hits = hits | sampling.match_stop_words(
            seqs.view(b * 2 * k, max_len), nxt_pos,
            rules.stop_words).view(b, 2 * k)
    if prompt_len > 1:
        hits = hits & (nxt_pos >= prompt_len)
    # a candidate retires if it hit, ranks in the top K of the 2K and
    # carries a real score
    in_top_k = torch.arange(2 * k, device=dev) < k
    retire = hits & in_top_k & (topv > NEG_INF / 2)

    # the alive set: the best K candidates that did not hit (a hit is
    # shifted by NEG_INF, not replaced, as HF does)
    alive_cand = topv + hits.to(topv.dtype) * NEG_INF
    new_alive_scores, alive_sel = top_k(alive_cand, k)
    new_alive_tokens = _gather_beams(seqs, alive_sel)
    alive_parents = parents.gather(1, alive_sel)

    # the finished pool: merge the retiring candidates, length-penalized
    # by the generated length (the stop token counted, the prompt not)
    fin_len = nxt_pos + 1
    fin_cand = torch.where(
        retire, topv / _length_penalty(nxt_pos - (prompt_len - 1), alpha),
        NEG_INF)
    blocked = ~s.es_unsat
    if es_mode is True:
        blocked = blocked | _pool_full(s)
    fin_cand = torch.where(blocked[:, None], NEG_INF, fin_cand)
    merged_scores = torch.cat([s.finished_scores, fin_cand], dim=1)
    merged_tokens = torch.cat([s.finished_tokens, seqs], dim=1)
    merged_lengths = torch.cat(
        [s.finished_lengths, fin_len.expand(b, 2 * k)], dim=1)
    new_fin_scores, fin_sel = top_k(merged_scores, k)
    new_fin_tokens = _gather_beams(merged_tokens, fin_sel)
    new_fin_lengths = merged_lengths.gather(1, fin_sel)

    # the early-stop heuristic (HF _check_early_stop_heuristic, every
    # mode; sticky once False)
    if es_mode == "never" and alpha > 0.0:
        best_len = torch.full((), max_len - prompt_len, dtype=torch.int32,
                              device=dev)
    else:
        # at least 1: inside a prompt window the generated length is 0
        best_len = (fin_len - prompt_len).clamp(min=1)
    best_possible = new_alive_scores[:, 0] / _length_penalty(best_len, alpha)
    worst_finished = new_fin_scores.amin(dim=1)
    new_es_unsat = s.es_unsat & (best_possible > worst_finished)

    # the writes, each under go; the caches follow the surviving beams'
    # parents, the identity when go is False
    beams = torch.arange(k, device=dev)
    src = torch.where(go, alive_parents, beams) \
        + torch.arange(b, device=dev)[:, None] * k
    reorder_caches(s.self_kv, src.reshape(b * k))
    for dst, new in ((s.alive_tokens, new_alive_tokens),
                     (s.alive_scores, new_alive_scores),
                     (s.finished_tokens, new_fin_tokens),
                     (s.finished_scores, new_fin_scores),
                     (s.finished_lengths, new_fin_lengths),
                     (s.es_unsat, new_es_unsat),
                     (s.all_hit, hits.all())):
        dst.copy_(torch.where(go, new, dst))
    s.pos.add_(go.to(torch.int32))
    s.go.copy_(go & _go(s, es_mode))


def reorder_caches(self_kv: Tuple[torch.Tensor, ...],
                   src: torch.Tensor) -> None:
    """Each self cache (L, B * K, ...) in place, lane i taking lane
    ``src[i]``'s rows (values and, quantized, their scales): gathered into
    a temporary, then copied back. It moves the whole cache every step."""
    for cache in self_kv:
        cache.copy_(cache.index_select(1, src))


def finalize(s: BeamState, gen: GenerationConfig, prompt_len: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The code after the JAX loop: the alive beams join the finished pool,
    penalized by the generated length, only where the lane is not done
    (a full pool under ``early_stopping=True``, or the heuristic's stop);
    the best K of the two, best first: (tokens (B, K, max_len) int32,
    scores (B, K) fp32, lengths (B, K) int32)."""
    b, k, _ = s.alive_tokens.shape
    alive_len = s.pos + 1
    alive_scores = s.alive_scores / _length_penalty(alive_len - prompt_len,
                                                    gen.length_penalty)
    blocked = ~s.es_unsat
    if gen.early_stopping is True:
        blocked = blocked | _pool_full(s)
    alive_scores = torch.where(blocked[:, None], NEG_INF, alive_scores)
    merged_scores = torch.cat([s.finished_scores, alive_scores], dim=1)
    merged_tokens = torch.cat([s.finished_tokens, s.alive_tokens], dim=1)
    merged_lengths = torch.cat([s.finished_lengths,
                                alive_len.expand(b, k)], dim=1)
    scores, sel = top_k(merged_scores, k)
    return (_gather_beams(merged_tokens, sel), scores,
            merged_lengths.gather(1, sel))


def tile_cross(cross_kv: Tuple[torch.Tensor, ...], k: int
               ) -> Tuple[torch.Tensor, ...]:
    """Each cross tensor (L, B, ...) repeated K times beam-major along
    its batch axis: (L, B * K, ...)."""
    return tuple(x.repeat_interleave(k, dim=1) for x in cross_kv)


@torch.inference_mode()
def _beam(params, cfg, enc_states, gen, max_len, prompt=None):
    """The beam search through ``generation.run_decode``."""
    k = gen.num_beams
    batch, dev, dtype = enc_states.shape[0], enc_states.device, \
        enc_states.dtype
    heads = local_model(params, cfg).decoder_heads

    def make():
        cross = tile_cross(
            gen_rt.build_cross_kv(params, cfg, enc_states, gen), k)
        return (init_beam_state(cfg, gen, batch, max_len, dtype, dev, heads),
                cross,
                gen_rt.make_rules(cfg, gen, max_len, dev,
                                  None if prompt is None else prompt.clone()))

    def load(entry):
        for dst, src in zip(entry.cross_kv, gen_rt.build_cross_kv(
                params, cfg, enc_states, gen)):
            dst.view(src.shape[:2] + (k,) + src.shape[2:]).copy_(
                src.unsqueeze(2))
        if prompt is not None:
            entry.rules.prompt.copy_(prompt)

    def bind(entry):
        s, cross_kv, rules = entry.state, entry.cross_kv, entry.rules
        reset_beam_state(s, cfg, rules)
        fused = wmodel.decode_step_plan(params, cfg, s.self_kv, cross_kv)
        return lambda: beam_step(params, cfg, gen, s, cross_kv, rules, fused)

    key = ("beam", cfg, gen, batch, max_len, dtype, dev,
           None if prompt is None else prompt.shape[1])
    entry = gen_rt.run_decode(key, params, dev, max_len - 1, make, load,
                              bind, lambda s: not bool(s.go))
    return finalize(entry.state, gen, entry.rules.prompt_len)


def beam_decode(
    params: dict,
    cfg: WhisperConfig,
    enc_states: torch.Tensor,
    gen: GenerationConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Beam search of ``gen.num_beams`` beams: enc_states (B, 1500, d) →
    (tokens (B, K, max_len) int32 best-first, scores (B, K) fp32, lengths
    (B, K) int32), ``max_len = min(max_target_positions, max_new_tokens +
    1)``. ``gen.early_stopping`` takes the three HF modes (True, False,
    "never"); stop words retire a candidate as EOS does; every other
    processor of the greedy loop applies to the log-probabilities, as in
    the JAX loop; the caches follow ``kv_cache_dtype`` and
    ``cross_kv_layout``."""
    check_early_stopping(gen)
    max_len = min(cfg.max_target_positions, gen.max_new_tokens + 1)
    return _beam(params, cfg, enc_states, gen, max_len)


def beam_decode_prompted(
    params: dict,
    cfg: WhisperConfig,
    enc_states: torch.Tensor,
    prompt,
    gen: GenerationConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Beam search seeded with a whole decoder prompt (B, P), HF's
    ``generate(decoder_input_ids=..., num_beams=K)``: the prompt is
    teacher-forced across every beam at no score cost, the length penalty
    counts generated tokens only, and stop criteria start after the
    prompt. ``max_len = min(max_target_positions, max_new_tokens + P)``;
    returns what ``beam_decode`` returns."""
    check_early_stopping(gen)
    prompt = to_tensor(prompt, enc_states.device, torch.int32)
    max_len = min(cfg.max_target_positions,
                  gen.max_new_tokens + prompt.shape[1])
    return _beam(params, cfg, enc_states, gen, max_len, prompt)
