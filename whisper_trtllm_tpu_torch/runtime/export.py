"""The two programs of an engine file (``utils/engine.py``): the session's
encode and its greedy decode step as ``torch.nn.Module``s for
``torch.export``, and ``export_programs``, which traces them.

``EncodeProgram`` is the front of ``WhisperSession._run``: encode, the
cross cache of ``generation.build_cross_kv`` and a new state reset as
``generation.reset_state`` resets it. ``StepProgram`` is one
``generation.greedy_step`` on that state; the configuration (batch,
``max_len``, the generation config, the host constants of ``Rules`` and
the fused plan) is fixed at export, the weights are an argument.
"""

from __future__ import annotations

import time

import torch

from whisper_trtllm_tpu_torch.config import GenerationConfig, WhisperConfig
from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
from whisper_trtllm_tpu_torch.utils import engine as engine_io

_RULE_TENSORS = ("suppress", "begin_suppress", "forced_map")


def _rule_tensors(rules: gen_rt.Rules) -> dict:
    out = {k: getattr(rules, k) for k in _RULE_TENSORS}
    for k in ("bad_words", "stop_words"):
        if getattr(rules, k) is not None:
            out[k] = tuple(getattr(rules, k))
    return out


class EncodeProgram(torch.nn.Module):
    """(params, mel) → (encoder states, cross cache, first state)."""

    def __init__(self, cfg: WhisperConfig, gen: GenerationConfig,
                 max_len: int, rules: gen_rt.Rules):
        super().__init__()
        self.cfg, self.gen, self.max_len, self.rules = cfg, gen, max_len, rules

    def forward(self, params: dict, mel: torch.Tensor):
        cfg, gen = self.cfg, self.gen
        enc = wmodel.encode(params, cfg, mel)
        cross = gen_rt.build_cross_kv(params, cfg, enc, gen)
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
        r = self.rules
        rules = gen_rt.Rules(
            suppress=rule_tensors["suppress"],
            begin_suppress=rule_tensors["begin_suppress"],
            forced_map=rule_tensors["forced_map"],
            begin_index=r.begin_index, prompt_len=r.prompt_len,
            timestamps=r.timestamps,
            bad_words=rule_tensors.get("bad_words"),
            stop_words=rule_tensors.get("stop_words"), prompt=None)
        gen_rt.greedy_step(params, self.cfg, self.gen, s, cross, rules,
                           self.fused)
        # a program needs an output to be saved: the finished flags
        return s.finished


def export_programs(params: dict, cfg: WhisperConfig, gen: GenerationConfig,
                    dtype: torch.dtype, device: torch.device, batch: int):
    """Trace the greedy pipeline at ``batch`` for ``params`` (already
    through the session's load-time chain): (the exported encode, the
    exported step, the rule tensors, the engine's meta). The example state
    and cross cache are made from zeros: nothing is decoded, and no tensor
    made while tracing is kept in a module-level cache."""
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
        s = gen_rt.init_state(cfg, gen, batch, max_len, dtype, device)
        gen_rt.reset_state(s, cfg, rules)
        fused = wmodel.decode_step_plan(params, cfg, s.self_kv, cross)
        state = (s.tokens, s.pos, s.finished, s.lengths, *s.self_kv)
        rule_tensors = _rule_tensors(rules)
        encode = torch.export.export(
            EncodeProgram(cfg, gen, max_len, rules), (params, mel),
            strict=False)
        step = torch.export.export(
            StepProgram(cfg, gen, rules, fused),
            (params, state, cross, rule_tensors), strict=False)
    # the example inputs hold the weights: an engine file keeps none
    encode.example_inputs = step.example_inputs = None
    from whisper_trtllm_tpu_torch.cli.gpu_check import kernel_tree_digest

    meta = {
        "batch": batch, "max_len": max_len,
        "dtype": str(dtype).removeprefix("torch."),
        "kv_cache_dtype": gen.kv_cache_dtype,
        "cross_kv_layout": gen.cross_kv_layout,
        "device": device.type, "fused_step": fused,
        "finish_check_every": gen_rt.FINISH_CHECK_EVERY,
        "warmup_steps": gen_rt.WARMUP_STEPS,
        "state": ["tokens", "pos", "finished", "lengths"]
                 + [f"self_kv{i}" for i in range(len(s.self_kv))],
        "kernel_tree_digest": kernel_tree_digest(),
        "export_s": time.perf_counter() - t0,
    }
    return encode, step, rule_tensors, meta

