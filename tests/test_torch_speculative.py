"""PyTorch port: speculative decoding (``runtime/speculative.py``) and the
two model functions it rests on, ``decode_step`` and ``decode_chunk``,
against the JAX package at ``WhisperConfig.testing()`` on the same weights
(JAX ``init_params`` carried over) and the same inputs drawn from a seed.

- ``decode_step``: logits and caches as JAX's ``decode_step``.
- ``decode_chunk`` on a warm cache (3 steps, then a 5-token chunk, batch
  2; the cross cache padded 20 → 24 rows): logits and caches within atol
  2e-5 and rtol 1e-4 of JAX's chunk, the limit the JAX package holds its
  chunk to its steps by (``tests/test_whisper_model.py``), and of the
  port's own steps.
- ``speculative_transcribe_tokens`` for gamma 1 and 3, with a seed-1
  draft and with the target as its own draft: the token buffer, length,
  ``rounds`` and ``accepted`` equal to JAX's exactly, and the tokens equal
  to the port's greedy decode on the positions both fill; an EOS inside a
  round's accepted region; the trained artifact as its own draft on one
  bundled utterance (gamma 4: every proposal accepted, its exact text,
  greedy's length).
- Refusals, a round after the loop's end (it changes nothing), the entry
  of both trees in the graph cache, and the two scripts on the CPU at
  narrow widths.

The captured round is card-only (``tests/test_torch_gpu.py``). Each JAX
configuration compiles once; the trees and inputs are made once a module.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_trtllm_tpu import config as jax_config
from whisper_trtllm_tpu.models.whisper import init_params
from whisper_trtllm_tpu.models.whisper import model as jax_model
from whisper_trtllm_tpu.runtime import speculative as jax_spec
from whisper_trtllm_tpu_torch import config as torch_config
from whisper_trtllm_tpu_torch.models.whisper import (
    decode_chunk,
    decode_step,
    model,
)
from whisper_trtllm_tpu_torch.runtime import generation, speculative
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-5, rtol=1e-4)
MAX_NEW = 12
# a final-LayerNorm bias along EOS's embedding: the target says EOS at
# position 3, inside the first round's accepted region
EOS_BIAS = 2.0


def _configs(**overrides):
    jcfg = jax_config.WhisperConfig.testing(**overrides)
    return jcfg, torch_config.WhisperConfig(**dataclasses.asdict(jcfg))


def _tree(jcfg, seed, eos_bias=0.0):
    ref = init_params(jcfg, seed=seed)
    if eos_bias:
        row = ref["decoder"]["embed_tokens"][jcfg.eos_token_id]
        ref["decoder"]["layer_norm"]["bias"] = (
            ref["decoder"]["layer_norm"]["bias"]
            + eos_bias * row / np.linalg.norm(row))
    return ref, params_from_numpy(ref, "cpu")


class _Spec:
    """The testing config with 24 positions, three trees (seed 0, seed 1,
    seed 0 with the EOS bias) in both packages, one mel, and JAX's
    results, each computed once."""

    def __init__(self):
        self.jcfg, self.cfg = _configs(max_target_positions=24)
        self.trees = {"seed0": _tree(self.jcfg, 0), "seed1": _tree(self.jcfg, 1),
                      "eos": _tree(self.jcfg, 0, EOS_BIAS)}
        self.mel = np.random.default_rng(0).standard_normal(
            (1, 2 * self.jcfg.max_source_positions, self.jcfg.num_mel_bins)
        ).astype(np.float32)
        self._jax = {}

    def jax(self, target, draft, gamma):
        key = (target, draft, gamma)
        if key not in self._jax:
            out = jax_spec.speculative_transcribe_tokens(
                self.trees[target][0], self.jcfg, self.trees[draft][0],
                self.jcfg, jnp.asarray(self.mel),
                jax_config.GenerationConfig(max_new_tokens=MAX_NEW),
                gamma=gamma, with_stats=True)
            self._jax[key] = [np.asarray(x) for x in out]
        return self._jax[key]

    def port(self, target, draft, gamma, mel=None, max_new=MAX_NEW):
        out = speculative.speculative_transcribe_tokens(
            self.trees[target][1], self.cfg, self.trees[draft][1], self.cfg,
            self.mel if mel is None else mel,
            torch_config.GenerationConfig(max_new_tokens=max_new),
            gamma=gamma, with_stats=True, device="cpu")
        return [x.numpy() for x in out]

    def greedy(self, target):
        toks, lens = generation.transcribe_tokens(
            self.trees[target][1], self.cfg, self.mel,
            torch_config.GenerationConfig(max_new_tokens=MAX_NEW),
            device="cpu")
        return toks[0, :int(lens[0])].numpy()


@pytest.fixture(scope="module")
def spec():
    return _Spec()


class _Chunk:
    """Weights, a padded cross cache (20 encoder rows, 24 stored), and
    tokens for the step and chunk cases, batch 2."""

    def __init__(self):
        self.jcfg, self.cfg = _configs(max_source_positions=20)
        self.ref, self.p = _tree(self.jcfg, 6)
        enc = np.random.default_rng(7).standard_normal(
            (2, 20, self.jcfg.d_model)).astype(np.float32)
        self.jcross = jax_model.compute_cross_kv(self.ref, self.jcfg,
                                                 jnp.asarray(enc))
        self.cross = model.compute_cross_kv(self.p, self.cfg,
                                            torch.from_numpy(enc))
        self.tokens = np.random.default_rng(8).integers(
            0, self.jcfg.vocab_size, (2, 8)).astype(np.int32)
        self.max_len = 12

    def port_steps(self, n, pos_tensor=False):
        """n port steps from pos 0 on a fresh cache: (logits (2, n, V),
        caches)."""
        k, v = model.init_self_kv(self.cfg, 2, self.max_len, device="cpu")
        out = []
        for i in range(n):
            pos = torch.tensor(i, dtype=torch.int32) if pos_tensor else i
            logits, k, v = decode_step(self.p, self.cfg,
                                       torch.from_numpy(self.tokens[:, i]),
                                       pos, k, v, *self.cross)
            out.append(logits[:, None])
        return torch.cat(out, 1), (k, v)


@pytest.fixture(scope="module")
def chunk():
    return _Chunk()


@pytest.mark.parametrize("pos_tensor", [False, True], ids=["int", "tensor"])
def test_decode_step_equals_jax(chunk, pos_tensor):
    jk, jv = jax_model.init_self_kv(chunk.jcfg, 2, chunk.max_len)
    ref = []
    for i in range(3):
        lg, jk, jv = jax_model.decode_step(
            chunk.ref, chunk.jcfg, jnp.asarray(chunk.tokens[:, i]),
            jnp.int32(i), jk, jv, *chunk.jcross)
        ref.append(np.asarray(lg)[:, None])
    logits, (k, v) = chunk.port_steps(3, pos_tensor)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.concatenate(ref, 1), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("pos_tensor", [False, True], ids=["int", "tensor"])
def test_decode_chunk_equals_jax_on_a_warm_cache(chunk, pos_tensor):
    jkv = jax_model.init_self_kv(chunk.jcfg, 2, chunk.max_len)
    for i in range(3):
        _, jkv = jax_model.decode_step_kv(
            chunk.ref, chunk.jcfg, jnp.asarray(chunk.tokens[:, i]),
            jnp.int32(i), jkv, chunk.jcross)
    ref, jkv = jax_model.decode_chunk(chunk.ref, chunk.jcfg,
                                      jnp.asarray(chunk.tokens[:, 3:]),
                                      jnp.int32(3), jkv, chunk.jcross)
    _, kv = chunk.port_steps(3)
    pos = torch.tensor(3, dtype=torch.int32) if pos_tensor else 3
    logits, kv = decode_chunk(chunk.p, chunk.cfg,
                              torch.from_numpy(chunk.tokens[:, 3:]), pos, kv,
                              chunk.cross)
    assert tuple(logits.shape) == (2, 5, chunk.jcfg.vocab_size)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL)
    for got, want in zip(kv, jkv):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_chunk_equals_the_ports_steps(chunk):
    steps, step_kv = chunk.port_steps(8)
    head, kv = chunk.port_steps(3)
    logits, kv = decode_chunk(chunk.p, chunk.cfg,
                              torch.from_numpy(chunk.tokens[:, 3:]), 3, kv,
                              chunk.cross)
    np.testing.assert_allclose(torch.cat([head, logits], 1).numpy(),
                               steps.numpy(), **TOL)
    for got, want in zip(kv, step_kv):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def _overlap_equal(spec_out, greedy, gamma):
    toks, length = spec_out[0][0], int(spec_out[1])
    n = min(length, len(greedy))
    # the rounds stop gamma + 1 short of max_len
    assert n >= len(greedy) - (gamma + 1)
    np.testing.assert_array_equal(toks[:n], greedy[:n])


@pytest.mark.parametrize("draft", ["seed1", "seed0"], ids=["seed1", "self"])
@pytest.mark.parametrize("gamma", [1, 3])
def test_speculative_equals_jax(spec, gamma, draft):
    ref = spec.jax("seed0", draft, gamma)
    out = spec.port("seed0", draft, gamma)
    for got, want in zip(out, ref):
        np.testing.assert_array_equal(got, want)
    assert out[1].shape == () and out[2].shape == () and out[3].shape == ()
    assert 0 <= int(out[3]) <= gamma * int(out[2])
    _overlap_equal(out, spec.greedy("seed0"), gamma)


def test_speculative_stops_at_an_eos_inside_a_round_as_jax(spec):
    ref = spec.jax("eos", "eos", 3)
    out = spec.port("eos", "eos", 3)
    for got, want in zip(out, ref):
        np.testing.assert_array_equal(got, want)
    # one round: EOS at position 3 is the second of three accepted
    # proposals, and pos froze there
    assert (int(out[1]), int(out[2]), int(out[3])) == (4, 1, 3)
    assert out[0][0, 3] == spec.jcfg.eos_token_id
    np.testing.assert_array_equal(out[0][0, :4], spec.greedy("eos"))


def test_the_artifact_as_its_own_draft_accepts_every_proposal():
    from whisper_trtllm_tpu_torch.audio import (
        log_mel_spectrogram,
        pad_or_trim,
        read_wav,
    )
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
    from whisper_trtllm_tpu_torch.utils.vocab import ids_to_text

    p, cfg = load_checkpoint(os.path.join(ROOT, "artifacts",
                                          "tiny_en_synth_int8"), device="cpu")
    with open(os.path.join(ROOT, "artifacts", "expected.json")) as f:
        want = json.load(f)["texts"][3]
    mel = log_mel_spectrogram(pad_or_trim(read_wav(os.path.join(
        ROOT, "artifacts", "eval", "utt03.wav")))[None], device="cpu")
    gen = torch_config.GenerationConfig(max_new_tokens=32)
    toks, length, rounds, accepted = speculative.speculative_transcribe_tokens(
        p, cfg, p, cfg, mel, gen, gamma=4, with_stats=True, device="cpu")
    assert (int(length), int(rounds), int(accepted)) == (18, 4, 16)
    assert ids_to_text(toks[0, :length]) == want


@pytest.mark.parametrize("case", ["batch2", "quantized-cache",
                                  "t-minor-cross", "gamma0"])
def test_refusals(spec, chunk, case):
    if case in ("batch2", "gamma0"):
        mel = np.repeat(spec.mel, 2, 0) if case == "batch2" else spec.mel
        gamma = 0 if case == "gamma0" else 2
        with pytest.raises(ValueError, match="batch-1" if case == "batch2"
                           else "gamma"):
            spec.port("seed0", "seed1", gamma, mel)
        return
    if case == "quantized-cache":
        self_kv = model.init_self_kv_quant(chunk.cfg, 2, chunk.max_len,
                                           device="cpu")
        cross = chunk.cross
    else:
        self_kv = model.init_self_kv(chunk.cfg, 2, chunk.max_len,
                                     device="cpu")
        cross = model.transpose_cross_kv(chunk.cross)
    with pytest.raises(ValueError, match="decode_chunk"):
        decode_chunk(chunk.p, chunk.cfg, torch.from_numpy(chunk.tokens[:, :2]),
                     0, self_kv, cross)


def _state_tensors(s):
    return [s.tokens, s.pos, s.finished, s.rounds, s.accepted, s.go,
            *s.t_self, *s.d_self]


@pytest.mark.parametrize("target,gamma,max_new", [("seed0", 3, 9),
                                                  ("eos", 2, MAX_NEW)],
                         ids=["length-limit", "eos"])
@torch.inference_mode()
def test_a_round_after_the_stop_changes_nothing(spec, target, gamma,
                                                max_new):
    """Rounds run by hand until ``go`` falls, then more: every tensor of
    the state (tokens, pos, finished, stats, go, both self caches) stays
    as it was, also where pos + gamma + 1 passes the buffer's end."""
    cfg, (_, p) = spec.cfg, spec.trees[target]
    max_len = max_new + 1
    mel = torch.from_numpy(spec.mel)
    enc = model.encode(p, cfg, mel)
    s = speculative.init_spec_state(cfg, cfg, max_len, torch.float32,
                                    torch.float32, "cpu")
    cross = (model.compute_cross_kv(p, cfg, enc),
             model.compute_cross_kv(p, cfg, enc))
    rules = speculative.make_spec_rules(cfg, max_len, gamma, "cpu")
    speculative.reset_spec_state(s, cfg, rules)
    speculative.prefill(p, cfg, p, cfg, s, cross, rules)
    n = 0
    while bool(s.go):
        speculative.spec_round(p, cfg, p, cfg, s, cross, rules, False)
        n += 1
    before = [t.clone() for t in _state_tensors(s)]
    for _ in range(gamma + 2):
        speculative.spec_round(p, cfg, p, cfg, s, cross, rules, False)
    for got, want in zip(_state_tensors(s), before):
        assert torch.equal(got, want)
    ref = spec.port(target, target, gamma, max_new=max_new)
    assert int(s.rounds) == n == int(ref[2])
    assert int(s.pos) + 1 == int(ref[1])
    np.testing.assert_array_equal(s.tokens.numpy(), ref[0])
    if target == "seed0":
        assert int(s.pos) + gamma + 1 > max_len


@pytest.mark.parametrize("dropped", ["target", "draft"])
def test_the_graph_cache_drops_an_entry_of_either_tree(spec, dropped):
    t, d = spec.trees["seed0"][1], spec.trees["seed1"][1]
    both = {"decoder": {"target": t["decoder"], "draft": d["decoder"]}}
    leaves = generation._decoder_leaves(both)
    generation.drop_graphs()
    entry = generation._StepGraph(None, None, None, leaves)
    generation._store(("speculative-test",), entry, leaves)
    greedy_leaves = generation._decoder_leaves(t)
    generation._store(("greedy-test",), generation._StepGraph(
        None, None, None, greedy_leaves), greedy_leaves)
    try:
        gone = generation.drop_graphs(t if dropped == "target" else d)
        # the target's greedy entry goes with the target, not the draft
        assert gone == (2 if dropped == "target" else 1)
        assert ("speculative-test",) not in generation._GRAPHS
        assert (("greedy-test",) in generation._GRAPHS) == (dropped == "draft")
    finally:
        generation.drop_graphs()


def _narrow_whisper(**overrides):
    """A narrow config that takes 30 s of audio (3000 frames, 80 bins)."""
    return torch_config.WhisperConfig.testing(
        num_mel_bins=80, max_source_positions=1500, **overrides)


@pytest.mark.parametrize("script", ["spec_bench", "spec_loop_cost"])
def test_spec_scripts_on_the_cpu(script, capsys, tmp_path, monkeypatch):
    """Each script end to end on the CPU at narrow widths: spec_bench on a
    narrow checkpoint as its own draft over a bundled WAV, spec_loop_cost
    with its preset narrowed (the micro draft keeps its shape)."""
    if script == "spec_bench":
        from whisper_trtllm_tpu_torch.benchmarks import spec_bench as mod
        from whisper_trtllm_tpu_torch.utils.checkpoint import save_checkpoint

        cfg = _narrow_whisper()
        ckpt = str(tmp_path / "ckpt")
        save_checkpoint(ckpt, model.init_params(cfg, seed=0, device="cpu"),
                        cfg)
        argv = ["--target", ckpt, "--draft", ckpt, "--wav-dir",
                os.path.join(ROOT, "artifacts", "eval"), "--utts", "1",
                "--gammas", "2", "--max-new-tokens", "12", "--dtype",
                "float32", "--device", "cpu"]
        keys = [{"mode", "utts", "ms_per_utt", "mean_len", "dtype"},
                {"mode", "utts", "ms_per_utt", "speedup_vs_greedy",
                 "acceptance_rate", "accepted_per_round", "rounds_per_utt",
                 "mean_len", "token_exact_vs_greedy"}]
    else:
        from whisper_trtllm_tpu_torch.benchmarks import spec_loop_cost as mod

        monkeypatch.setattr(mod.WhisperConfig, "preset",
                            staticmethod(lambda name: _narrow_whisper()))
        argv = ["--utts", "1", "--gammas", "2", "--max-new-tokens", "4",
                "--device", "cpu"]
        keys = [{"mode", "ms_per_utt", "ms_per_utt_median", "ms_min",
                 "ms_max"},
                {"mode", "ms_per_utt", "rounds_per_utt", "ms_per_round"}]
    assert mod.main(argv) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [set(x) for x in lines] == keys
    assert all(v > 0 for x in lines for k, v in x.items()
               if k.startswith("ms"))
    if script == "spec_bench":
        assert 0.0 <= lines[1]["acceptance_rate"] <= 1.0
    assert lines[1]["rounds_per_utt"] > 0
