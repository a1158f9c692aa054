"""Speculative decoding (counterpart of
``whisper_trtllm_tpu/runtime/speculative.py``): a small draft model
proposes ``gamma`` tokens, the target scores them in one chunked pass
(``models/whisper/model.py::decode_chunk``), the longest matching prefix
is accepted and the target's own token follows it. Greedy speculative
decoding is exact: the tokens equal the target's plain greedy decode.

The JAX package runs the rounds as a ``lax.while_loop`` inside one jit.
The port keeps that shape with the greedy loop's machinery
(``generation.run_decode``): ``spec_round`` is the loop's body on a
``SpecState`` of device tensors updated in place, captured once as a CUDA
graph on the card and replayed, run eagerly on the CPU. The JAX ``cond``
is the state's ``go``: every write of a round (tokens, ``pos``,
``finished``, the stats, both self caches) is taken only under it, so a
round after the loop's end changes nothing; the host reads ``go`` after
every round. The encoders, the cross K/V and the prompt's prefill run once
an utterance, before the rounds.

Batch 1 (the latency path). Only the suppress and begin-suppress masks
apply, to both models; the prompt comes from ``forced_decoder_ids``. Caches
are float, in the encoder states' dtype, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from whisper_trtllm_tpu_torch.config import GenerationConfig, WhisperConfig
from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
from whisper_trtllm_tpu_torch.runtime import logits_process as lp
from whisper_trtllm_tpu_torch.utils.device import (
    resolve_device,
    set_fp32_precision,
    to_tensor,
)

# rounds between two host reads of ``go``: a round costs gamma draft steps
# and a chunk, so every round is read and none runs past the loop's end
SPEC_CHECK_EVERY = 1


class SpecState(NamedTuple):
    """The speculative loop's state, every tensor on the decode's device
    and updated in place by ``spec_round``."""

    tokens: torch.Tensor    # (1, max_len) int32
    pos: torch.Tensor       # 0-d int32: the last accepted position
    finished: torch.Tensor  # 0-d bool
    t_self: tuple           # the target's self cache (k, v)
    d_self: tuple           # the draft's self cache (k, v)
    rounds: torch.Tensor    # 0-d int32: rounds run (gamma draft steps and
    #                         one target chunk each)
    accepted: torch.Tensor  # 0-d int32: draft proposals accepted, counted
    #                         in the loop (EOS-cut rounds included)
    go: torch.Tensor        # 0-d bool: the JAX loop's cond


@dataclass(frozen=True)
class SpecRules:
    """What a round reads besides its state: the suppress masks (V,) fp32
    and the prompt (1, P) int32 on the device; ``begin_index`` and
    ``gamma`` on the host."""

    suppress: torch.Tensor
    begin_suppress: torch.Tensor
    prompt: torch.Tensor
    begin_index: int
    gamma: int


def _prompt(cfg: WhisperConfig) -> np.ndarray:
    """(1, P): the start token, the forced ids at their positions."""
    prompt_len = 1 + max([p for p, _ in cfg.forced_decoder_ids], default=0)
    prompt = np.full((1, prompt_len), cfg.decoder_start_token_id, np.int32)
    for p, tok in cfg.forced_decoder_ids:
        prompt[0, p] = tok
    return prompt


def make_spec_rules(cfg: WhisperConfig, max_len: int, gamma: int,
                    device) -> SpecRules:
    """The target's masks, ``begin_index`` of ``build_forced_map`` and the
    prompt."""
    _, begin_index = lp.build_forced_map(cfg, max_len)

    def dev(a):
        return torch.from_numpy(a).to(device)

    return SpecRules(suppress=dev(lp.build_suppress_mask(cfg)),
                     begin_suppress=dev(lp.build_begin_suppress_mask(cfg)),
                     prompt=dev(_prompt(cfg)), begin_index=begin_index,
                     gamma=gamma)


def _apply_masks(logits: torch.Tensor, positions: torch.Tensor,
                 suppress: torch.Tensor, begin_mask: torch.Tensor,
                 begin_index: int) -> torch.Tensor:
    """logits (B, S, V); positions (S,): the generated position of each
    row. The suppress mask everywhere, begin-suppress at ``begin_index``."""
    logits = logits + suppress[None, None]
    at_begin = (positions == begin_index)[None, :, None]
    return torch.where(at_begin, logits + begin_mask[None, None], logits)


def init_spec_state(t_cfg: WhisperConfig, d_cfg: WhisperConfig, max_len: int,
                    t_dtype, d_dtype, device) -> SpecState:
    """A state's buffers; ``reset_spec_state`` gives them their values."""
    def scalar(dtype):
        return torch.zeros((), dtype=dtype, device=device)

    return SpecState(
        tokens=torch.empty((1, max_len), dtype=torch.int32, device=device),
        pos=scalar(torch.int32), finished=scalar(torch.bool),
        t_self=wmodel.init_self_kv(t_cfg, 1, max_len, t_dtype, device),
        d_self=wmodel.init_self_kv(d_cfg, 1, max_len, d_dtype, device),
        rounds=scalar(torch.int32), accepted=scalar(torch.int32),
        go=scalar(torch.bool))


def reset_spec_state(s: SpecState, t_cfg: WhisperConfig,
                     rules: SpecRules) -> None:
    """The JAX loop's initial state, in place: pad everywhere but the
    prompt at the front, ``pos`` at the prompt's last token, zero caches
    and stats, ``go`` the loop's first cond."""
    max_len = s.tokens.shape[1]
    p = rules.prompt.shape[1]
    s.tokens.fill_(t_cfg.pad_token_id)
    s.tokens[:, :p] = rules.prompt
    s.pos.fill_(p - 1)
    s.finished.zero_()
    for cache in s.t_self + s.d_self:
        cache.zero_()
    s.rounds.zero_()
    s.accepted.zero_()
    s.go.fill_(p - 1 < max_len - rules.gamma - 1)


def prefill(t_params: dict, t_cfg: WhisperConfig, d_params: dict,
            d_cfg: WhisperConfig, s: SpecState, cross, rules: SpecRules
            ) -> None:
    """The prompt but its last token through both models' caches (the last
    token's rows are written by the first round)."""
    if rules.prompt.shape[1] > 1:
        head = rules.prompt[:, :-1]
        wmodel.decode_chunk(t_params, t_cfg, head, 0, s.t_self, cross[0])
        wmodel.decode_chunk(d_params, d_cfg, head, 0, s.d_self, cross[1])


def spec_round(t_params: dict, t_cfg: WhisperConfig, d_params: dict,
               d_cfg: WhisperConfig, s: SpecState, cross, rules: SpecRules,
               fused: bool) -> None:
    """One round of the JAX loop's body, in place on ``s`` and only under
    ``s.go``: ``gamma`` draft steps (``decode_step_kv``; ``fused`` is
    ``decode_step_plan``'s answer for the draft), each argmax written at
    the next position; one target ``decode_chunk`` over the gamma + 1
    inputs; the longest prefix of proposals equal to the target's choices
    accepted, then the target's token after it; ``pos`` frozen at the
    first EOS of the accepted region; the stats. Reads no device value on
    the host.

    The JAX loop's draft-cache hole is kept: after a round that accepts
    every proposal, the draft never writes the row of the last proposal
    (at ``pos + gamma``), and its later steps attend over that row as it
    was (zero). That lowers acceptance, not exactness, and keeps
    ``rounds`` and ``accepted`` equal to JAX's.

    Every index is clamped into the buffers (a round after the loop's end
    may sit where ``pos + gamma + 1`` passes ``max_len``), and the self
    cache rows a round may write are saved first and put back when ``go``
    is False."""
    gamma = rules.gamma
    tokens = s.tokens
    max_len = tokens.shape[1]
    last = max_len - 1
    dev = tokens.device
    go = s.go
    pos = s.pos.long()
    t_cross, d_cross = cross
    ar = torch.arange(gamma + 1, device=dev)

    def gated_write(idx, values):
        """tokens[0, idx] = values, only under go."""
        idx = idx.reshape(-1)
        old = tokens.index_select(1, idx)
        tokens.index_copy_(1, idx, torch.where(go, values.reshape(1, -1),
                                               old))

    # the self cache rows this round may write: the chunk's (its start
    # clamped as decode_chunk clamps it) and the draft steps'
    t_rows = pos.clamp(0, max_len - gamma - 1) + ar
    d_rows = (pos + ar[:gamma]).clamp(max=last)
    saved = [(c, t_rows, c.index_select(3, t_rows)) for c in s.t_self] + \
        [(c, d_rows, c.index_select(3, d_rows)) for c in s.d_self]

    # the draft proposes gamma tokens
    for j in range(gamma):
        pj = (pos + j).clamp(max=last)
        cur = tokens.index_select(1, pj.reshape(1))[:, 0]
        logits, _ = wmodel.decode_step_kv(d_params, d_cfg, cur,
                                          pj.to(torch.int32), s.d_self,
                                          d_cross, fused=fused)
        logits = _apply_masks(logits[:, None], (pos + j + 1).reshape(1),
                              rules.suppress, rules.begin_suppress,
                              rules.begin_index)[:, 0]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        gated_write((pos + j + 1).clamp(max=last), nxt)

    # the target verifies the gamma proposals in one chunk
    chunk_in = tokens.index_select(1, pos.clamp(0, max_len - gamma - 1) + ar)
    t_logits, _ = wmodel.decode_chunk(t_params, t_cfg, chunk_in, pos,
                                      s.t_self, t_cross)
    t_logits = _apply_masks(t_logits, pos + 1 + ar, rules.suppress,
                            rules.begin_suppress, rules.begin_index)
    t_choice = torch.argmax(t_logits, dim=-1).to(torch.int32)[0]
    proposals = tokens.index_select(
        1, (pos + 1).clamp(max=max_len - gamma) + ar[:gamma])[0]
    match = (proposals == t_choice[:gamma]).to(torch.int32)
    n_acc = torch.cumprod(match, dim=0).sum()
    bonus = t_choice.index_select(0, n_acc.reshape(1))
    new_pos = pos + n_acc + 1
    gated_write(new_pos.clamp(max=last), bonus)

    # EOS anywhere in the accepted region (the bonus included) finishes,
    # and pos freezes at the first one
    region = tokens.index_select(
        1, (pos + 1).clamp(max=max_len - gamma - 1) + ar)[0]
    eos_hit = (ar <= n_acc) & (region == t_cfg.eos_token_id)
    finished = eos_hit.any()
    first_eos = torch.argmax(eos_hit.to(torch.int32))
    new_pos = torch.where(finished, pos + 1 + first_eos, new_pos)

    for cache, rows, old in saved:
        cache.index_copy_(3, rows, torch.where(
            go, cache.index_select(3, rows), old))
    s.pos.copy_(torch.where(go, new_pos, pos))
    s.finished.copy_(torch.where(go, finished, s.finished))
    s.rounds.add_(go.to(torch.int32))
    s.accepted.add_(torch.where(go, n_acc, 0).to(torch.int32))
    s.go.copy_(go & (s.pos < max_len - gamma - 1) & ~s.finished)


def _tree_dtype(params: dict, dev: torch.device, name: str):
    leaf = params["encoder"]["conv1"]["kernel"]
    if leaf.device.type != dev.type:
        raise ValueError(f"{name} params lie on {leaf.device}, not on {dev}")
    return leaf.dtype


@torch.inference_mode()
def _speculative(t_params, t_cfg, d_params, d_cfg, t_enc, d_enc, max_len,
                 gamma) -> SpecState:
    """The rounds through ``generation.run_decode``; the state they left."""
    dev = t_enc.device

    def make():
        return (init_spec_state(t_cfg, d_cfg, max_len, t_enc.dtype,
                                d_enc.dtype, dev),
                (wmodel.compute_cross_kv(t_params, t_cfg, t_enc),
                 wmodel.compute_cross_kv(d_params, d_cfg, d_enc)),
                make_spec_rules(t_cfg, max_len, gamma, dev))

    def load(entry):
        wmodel.compute_cross_kv(t_params, t_cfg, t_enc, out=entry.cross_kv[0])
        wmodel.compute_cross_kv(d_params, d_cfg, d_enc, out=entry.cross_kv[1])

    def bind(entry):
        s, cross, rules = entry.state, entry.cross_kv, entry.rules
        reset_spec_state(s, t_cfg, rules)
        prefill(t_params, t_cfg, d_params, d_cfg, s, cross, rules)
        fused = wmodel.decode_step_plan(d_params, d_cfg, s.d_self, cross[1])
        return lambda: spec_round(t_params, t_cfg, d_params, d_cfg, s, cross,
                                  rules, fused)

    # each round moves pos by at least one, from the prompt's last token,
    # and the loop runs while pos < max_len - gamma - 1
    limit = max(0, max_len - gamma - _prompt(t_cfg).shape[1])
    # both trees' decoder weights key the entry, and it goes with either
    both = {"decoder": {"target": t_params["decoder"],
                        "draft": d_params["decoder"]}}
    key = ("speculative", t_cfg, d_cfg, max_len, gamma, t_enc.dtype,
           d_enc.dtype, dev)
    entry = gen_rt.run_decode(key, both, dev, limit, make, load, bind,
                              lambda s: not bool(s.go), SPEC_CHECK_EVERY)
    return entry.state


def speculative_transcribe_tokens(
    target_params: dict,
    target_cfg: WhisperConfig,
    draft_params: dict,
    draft_cfg: WhisperConfig,
    mel,
    gen: Optional[GenerationConfig] = None,
    gamma: int = 4,
    with_stats: bool = False,
    device=None,
) -> Tuple[torch.Tensor, ...]:
    """mel (1, 3000, n_mels) → (tokens (1, max_len) int32, length 0-d
    int32) on ``device`` (the CUDA card by default), where both trees must
    already lie; ``max_len = min(max_target_positions, max_new_tokens +
    1)``. The tokens equal the target's plain greedy decode on the
    positions both fill (the rounds stop gamma + 1 short of ``max_len``).
    ``with_stats=True`` also returns (rounds, accepted), 0-d int32: the
    rounds run and the draft proposals accepted, counted in the loop;
    acceptance = accepted / (gamma · rounds). Of ``gen`` only
    ``max_new_tokens`` is read, as in the JAX package."""
    gen = gen or GenerationConfig()
    dev = resolve_device(device)
    set_fp32_precision()
    t_dtype = _tree_dtype(target_params, dev, "target")
    d_dtype = _tree_dtype(draft_params, dev, "draft")
    if gamma < 1:
        raise ValueError(f"gamma must be at least 1, got {gamma}")
    mel = to_tensor(mel, dev, t_dtype)
    if mel.shape[0] != 1:
        raise ValueError(f"speculative decoding is a batch-1 latency path; "
                         f"got a batch of {mel.shape[0]}")
    max_len = min(target_cfg.max_target_positions, gen.max_new_tokens + 1)
    with torch.inference_mode():
        t_enc = wmodel.encode(target_params, target_cfg, mel)
        d_enc = wmodel.encode(draft_params, draft_cfg, mel.to(d_dtype))
    s = _speculative(target_params, target_cfg, draft_params, draft_cfg,
                     t_enc, d_enc, max_len, gamma)
    out = (s.tokens.clone(), (s.pos + 1).clone())
    if with_stats:
        return out + (s.rounds.clone(), s.accepted.clone())
    return out
