"""The programs of an engine file (``utils/engine.py``): the session's
encode, its decode step and, for beam search, the search's end, as
``torch.nn.Module``s for ``torch.export``, and ``export_programs``, which
traces them.

``EncodeProgram`` is the front of ``WhisperSession._run``: encode, the
cross cache of ``generation.build_cross_kv`` (tiled K times beam-major
for a beam search, as ``beam.tile_cross`` tiles it) and a new state reset
as ``generation.reset_state`` (``beam.reset_beam_state``) resets it.
``StepProgram`` is one ``generation.greedy_step`` on that state,
``BeamStepProgram`` one ``beam.beam_step`` (its ``top_k`` and
``reorder_caches`` included), and ``FinalizeProgram`` ``beam.finalize``
with the best hypothesis's tokens and length, as the session returns
them. The configuration (batch, ``max_len``, the generation config, the
host constants of ``Rules`` and the fused plan) is fixed at export, the
weights are an argument.
"""

from __future__ import annotations

import time

import torch

from whisper_trtllm_tpu_torch.config import GenerationConfig, WhisperConfig
from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
from whisper_trtllm_tpu_torch.runtime import beam
from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
from whisper_trtllm_tpu_torch.utils import engine as engine_io

_RULE_TENSORS = ("suppress", "begin_suppress", "forced_map")
# a beam state as the programs pass it: these fields, then the self caches
BEAM_FIELDS = ("alive_tokens", "alive_scores", "finished_tokens",
               "finished_scores", "finished_lengths", "pos", "es_unsat",
               "all_hit", "go")


def _rule_tensors(rules: gen_rt.Rules) -> dict:
    out = {k: getattr(rules, k) for k in _RULE_TENSORS}
    for k in ("bad_words", "stop_words"):
        if getattr(rules, k) is not None:
            out[k] = tuple(getattr(rules, k))
    return out


def _beam_tuple(s: beam.BeamState) -> tuple:
    return tuple(getattr(s, f) for f in BEAM_FIELDS) + tuple(s.self_kv)


def _beam_state(state: tuple) -> beam.BeamState:
    n = len(BEAM_FIELDS)
    return beam.BeamState(self_kv=tuple(state[n:]),
                          **dict(zip(BEAM_FIELDS, state[:n])))


def _rules_from(r: gen_rt.Rules, rule_tensors: dict) -> gen_rt.Rules:
    return gen_rt.Rules(
        suppress=rule_tensors["suppress"],
        begin_suppress=rule_tensors["begin_suppress"],
        forced_map=rule_tensors["forced_map"],
        begin_index=r.begin_index, prompt_len=r.prompt_len,
        timestamps=r.timestamps,
        bad_words=rule_tensors.get("bad_words"),
        stop_words=rule_tensors.get("stop_words"), prompt=None)


class EncodeProgram(torch.nn.Module):
    """(params, mel) → (encoder states, cross cache, first state); the
    state a greedy or, with ``num_beams > 1``, a beam state."""

    def __init__(self, cfg: WhisperConfig, gen: GenerationConfig,
                 max_len: int, rules: gen_rt.Rules):
        super().__init__()
        self.cfg, self.gen, self.max_len, self.rules = cfg, gen, max_len, rules

    def forward(self, params: dict, mel: torch.Tensor):
        cfg, gen = self.cfg, self.gen
        enc = wmodel.encode(params, cfg, mel)
        cross = gen_rt.build_cross_kv(params, cfg, enc, gen)
        if gen.num_beams > 1:
            s = beam.init_beam_state(cfg, gen, mel.shape[0], self.max_len,
                                     enc.dtype, enc.device)
            beam.reset_beam_state(s, cfg, self.rules)
            return (enc, beam.tile_cross(cross, gen.num_beams),
                    _beam_tuple(s))
        s = gen_rt.init_state(cfg, gen, mel.shape[0], self.max_len,
                              enc.dtype, enc.device)
        gen_rt.reset_state(s, cfg, self.rules)
        return enc, tuple(cross), (s.tokens, s.pos, s.finished, s.lengths,
                                   *s.self_kv)


class StepProgram(torch.nn.Module):
    """(params, state, cross cache, rule tensors) → the state's
    ``finished``: one greedy step, the state's tensors updated in place."""

    def __init__(self, cfg: WhisperConfig, gen: GenerationConfig,
                 rules: gen_rt.Rules, fused: bool):
        super().__init__()
        self.cfg, self.gen, self.rules, self.fused = cfg, gen, rules, fused

    def forward(self, params: dict, state: tuple, cross: tuple,
                rule_tensors: dict):
        s = gen_rt.GreedyState(*state[:4], tuple(state[4:]))
        gen_rt.greedy_step(params, self.cfg, self.gen, s, cross,
                           _rules_from(self.rules, rule_tensors), self.fused)
        # a program needs an output to be saved: the finished flags
        return s.finished


class BeamStepProgram(torch.nn.Module):
    """(params, beam state, tiled cross cache, rule tensors) → the state's
    ``go``: one beam step, the state's tensors updated in place (a no-op
    once ``go`` is False)."""

    def __init__(self, cfg: WhisperConfig, gen: GenerationConfig,
                 rules: gen_rt.Rules, fused: bool):
        super().__init__()
        self.cfg, self.gen, self.rules, self.fused = cfg, gen, rules, fused

    def forward(self, params: dict, state: tuple, cross: tuple,
                rule_tensors: dict):
        s = _beam_state(state)
        beam.beam_step(params, self.cfg, self.gen, s, cross,
                       _rules_from(self.rules, rule_tensors), self.fused)
        return s.go


class FinalizeProgram(torch.nn.Module):
    """A beam state's fields (``BEAM_FIELDS``) → the best hypothesis's
    (tokens (B, max_len) int32, lengths (B,) int32)."""

    def __init__(self, gen: GenerationConfig, prompt_len: int):
        super().__init__()
        self.gen, self.prompt_len = gen, prompt_len

    def forward(self, fields: tuple):
        s = beam.BeamState(self_kv=(), **dict(zip(BEAM_FIELDS, fields)))
        tokens, _, lengths = beam.finalize(s, self.gen, self.prompt_len)
        return tokens[:, 0], lengths[:, 0]


def export_programs(params: dict, cfg: WhisperConfig, gen: GenerationConfig,
                    dtype: torch.dtype, device: torch.device, batch: int):
    """Trace the pipeline at ``batch`` for ``params`` (already through the
    session's load-time chain): (the exported encode, the exported step,
    the rule tensors, the engine's meta, the exported finalize). The step
    is the greedy step, or with ``gen.num_beams > 1`` the beam step, and
    then the finalize program ends the search (None for greedy). The
    example state and cross cache are made from zeros: nothing is decoded,
    and no tensor made while tracing is kept in a module-level cache."""
    beams = gen.num_beams
    if beams > 1:
        beam.check_early_stopping(gen)
    else:
        gen_rt.check_greedy_config(gen)
    params = engine_io.canonical(params)
    max_len = min(cfg.max_target_positions, gen.max_new_tokens + 1)
    rules = gen_rt.make_rules(cfg, gen, max_len, device)
    mel = torch.zeros((batch, 2 * cfg.max_source_positions,
                       cfg.num_mel_bins), dtype=dtype, device=device)
    t0 = time.perf_counter()
    with torch.no_grad():
        enc = torch.zeros((batch, cfg.max_source_positions, cfg.d_model),
                          dtype=dtype, device=device)
        cross = tuple(gen_rt.build_cross_kv(params, cfg, enc, gen))
        rule_tensors = _rule_tensors(rules)
        finalize = None
        if beams > 1:
            cross = beam.tile_cross(cross, beams)
            s = beam.init_beam_state(cfg, gen, batch, max_len, dtype, device)
            beam.reset_beam_state(s, cfg, rules)
            fused = wmodel.decode_step_plan(params, cfg, s.self_kv, cross)
            state, names = _beam_tuple(s), list(BEAM_FIELDS)
            step_program = BeamStepProgram(cfg, gen, rules, fused)
            finalize = torch.export.export(
                FinalizeProgram(gen, rules.prompt_len),
                (state[:len(BEAM_FIELDS)],), strict=False)
        else:
            s = gen_rt.init_state(cfg, gen, batch, max_len, dtype, device)
            gen_rt.reset_state(s, cfg, rules)
            fused = wmodel.decode_step_plan(params, cfg, s.self_kv, cross)
            state = (s.tokens, s.pos, s.finished, s.lengths, *s.self_kv)
            names = ["tokens", "pos", "finished", "lengths"]
            step_program = StepProgram(cfg, gen, rules, fused)
        encode = torch.export.export(
            EncodeProgram(cfg, gen, max_len, rules), (params, mel),
            strict=False)
        step = torch.export.export(
            step_program, (params, state, cross, rule_tensors), strict=False)
    # the example inputs hold the weights: an engine file keeps none
    encode.example_inputs = step.example_inputs = None
    from whisper_trtllm_tpu_torch.cli.gpu_check import kernel_tree_digest

    meta = {
        "batch": batch, "max_len": max_len,
        "dtype": str(dtype).removeprefix("torch."),
        "kv_cache_dtype": gen.kv_cache_dtype,
        "cross_kv_layout": gen.cross_kv_layout,
        "device": device.type, "fused_step": fused, "num_beams": beams,
        "finish_check_every": gen_rt.FINISH_CHECK_EVERY,
        "warmup_steps": gen_rt.WARMUP_STEPS,
        "state": names + [f"self_kv{i}" for i in range(len(s.self_kv))],
        "kernel_tree_digest": kernel_tree_digest(),
        "export_s": time.perf_counter() - t0,
    }
    return encode, step, rule_tensors, meta, finalize

