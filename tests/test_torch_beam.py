"""PyTorch port: beam search (``runtime/beam.py``) against the JAX package's
``beam_decode`` and ``beam_decode_prompted`` at a tiny config (2 encoder and
2 decoder layers, d 32, vocabulary 97, 20 positions), on the same weights
(JAX ``init_params`` carried over) and the same encoder states.

Every case holds ALL K hypotheses token-equal to JAX, lengths equal, the
scores within ``SCORE_TOL`` (fp32: the port's log-softmax and the JAX
one's round apart by an ulp or two a step, over at most 19 steps of
log-probabilities below 40 in size), and the entries at ``NEG_INF`` scale
(a slot never filled, a dead beam) exactly equal. Cases: K 1, 2 and 4;
each ``early_stopping`` mode; stop and bad words; min-new-tokens; the
presence penalty; timestamps; int8 and fp8 caches in both cross layouts;
budgets off the host's check interval; lanes whose pool fills early; the
prompted search; ties in the top-k that decide the low beams (they fail
under an unstable top-k); and the session's ``num_beams > 1`` branch. The
captured CUDA graph of the step is card-only (``tests/test_torch_gpu.py``).

Each JAX configuration compiles once (about 0.7 s); the weights and the
encoder states are made once a module.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_trtllm_tpu import config as jax_config
from whisper_trtllm_tpu.models.whisper import init_params
from whisper_trtllm_tpu.runtime import beam as jax_beam
from whisper_trtllm_tpu.runtime.session import WhisperSession as JaxSession
from whisper_trtllm_tpu_torch import config as torch_config
from whisper_trtllm_tpu_torch.runtime import beam, generation
from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy

BATCH = 3
CFG = dict(max_target_positions=20, no_timestamps_token_id=60,
           max_initial_timestamp_index=5)
N = generation.FINISH_CHECK_EVERY
SCORE_TOL = dict(rtol=1e-6, atol=1e-5)


class _Model:
    """One JAX weight tree, its port, and encoder states from a seed."""

    def __init__(self, eos_bias: float = 0.0, **cfg):
        self.jcfg = jax_config.WhisperConfig.testing(**{**CFG, **cfg})
        self.cfg = torch_config.WhisperConfig(
            **dataclasses.asdict(self.jcfg))
        ref = init_params(self.jcfg, seed=0)
        if eos_bias:
            # a final-LayerNorm bias along EOS's embedding: beams hit EOS
            # within a few steps, some lanes sooner than others
            row = ref["decoder"]["embed_tokens"][self.jcfg.eos_token_id]
            ref["decoder"]["layer_norm"]["bias"] = (
                ref["decoder"]["layer_norm"]["bias"]
                + eos_bias * row / np.linalg.norm(row))
        self.ref, self.params = ref, params_from_numpy(ref, "cpu")
        self.enc = (np.random.default_rng(3).standard_normal(
            (BATCH, self.jcfg.max_source_positions, self.jcfg.d_model))
            * 4.0).astype(np.float32)

    def jax(self, prompt=None, **gen):
        g = jax_config.GenerationConfig(**gen)
        enc = jnp.asarray(self.enc)
        if prompt is None:
            out = jax_beam.beam_decode(self.ref, self.jcfg, enc, g)
        else:
            out = jax_beam.beam_decode_prompted(self.ref, self.jcfg, enc,
                                                jnp.asarray(prompt), g)
        return tuple(np.asarray(x) for x in out)

    def port(self, prompt=None, **gen):
        g = torch_config.GenerationConfig(**gen)
        enc = torch.from_numpy(self.enc)
        if prompt is None:
            out = beam.beam_decode(self.params, self.cfg, enc, g)
        else:
            out = beam.beam_decode_prompted(self.params, self.cfg, enc,
                                            prompt, g)
        return tuple(x.numpy() for x in out)

    def check(self, prompt=None, **gen):
        """Port == JAX over all K hypotheses; returns the port's triple."""
        ref = self.jax(prompt, **gen)
        generation.reset_loop_counts()
        out = self.port(prompt, **gen)
        assert_same(out, ref)
        assert generation.LOOP.steps <= out[0].shape[2] - 1
        return out


def assert_same(out, ref):
    toks, scores, lens = out
    rtoks, rscores, rlens = ref
    k = rtoks.shape[1]
    assert toks.shape == rtoks.shape and scores.shape == (BATCH, k)
    np.testing.assert_array_equal(toks, rtoks)
    np.testing.assert_array_equal(lens, rlens)
    assert toks.dtype == np.int32 and lens.dtype == np.int32
    big = np.abs(rscores) >= 1e8          # NEG_INF and NEG_INF / length
    np.testing.assert_array_equal(scores[big], rscores[big])
    np.testing.assert_allclose(scores[~big], rscores[~big], **SCORE_TOL)


@pytest.fixture(scope="module")
def plain():
    return _Model()


@pytest.fixture(scope="module")
def eos_model():
    return _Model(eos_bias=3.0)


@pytest.fixture(scope="module")
def plain_beams(plain):
    return plain.check(max_new_tokens=12, num_beams=2)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_beam_decode_equals_jax(plain, eos_model, k):
    plain.check(max_new_tokens=12, num_beams=k)
    toks, scores, lens = eos_model.check(max_new_tokens=12, num_beams=k)
    # beams retire at EOS here: the pools hold real, shorter hypotheses
    assert (lens < 13).any() and (np.diff(scores, axis=1) <= 0).all()


@pytest.mark.parametrize("early_stopping,length_penalty", [
    (True, 1.0), (False, 1.0), ("never", 1.0), ("never", 0.0)],
    ids=["true", "false", "never", "never-no-penalty"])
def test_early_stopping_modes_equal_jax(eos_model, early_stopping,
                                        length_penalty):
    eos_model.check(max_new_tokens=19, num_beams=3,
                    early_stopping=early_stopping,
                    length_penalty=length_penalty)
    steps = generation.LOOP.steps
    if early_stopping == "never" and length_penalty > 0:
        # the heuristic measures the best beam at the longest length: no
        # lane is done before the budget
        assert steps == 19
    else:
        assert steps < 19


def test_pools_that_fill_early_stop_the_loop(eos_model):
    """Every lane's finished pool fills within a few steps: the loop stops
    at the first host read after, with a budget that is no multiple of
    the check interval, and the replays past the stop change nothing."""
    toks, scores, lens = eos_model.check(max_new_tokens=17, num_beams=3)
    assert (lens < 18).all() and (scores > beam.NEG_INF / 2).all()
    assert generation.LOOP.steps == N and generation.LOOP.host_reads == 1


@pytest.mark.parametrize("max_new_tokens", [1, 7, 9, 11])
def test_budgets_around_the_check_interval_equal_jax(eos_model,
                                                     max_new_tokens):
    eos_model.check(max_new_tokens=max_new_tokens, num_beams=2,
                    early_stopping=False)


def test_stop_words_retire_beams_as_jax(plain, plain_beams):
    toks, _, _ = plain_beams
    word = (int(toks[0, 0, 3]), int(toks[0, 0, 4]))
    out = plain.check(max_new_tokens=12, num_beams=2, stop_words=(word,))
    assert (out[2] < 13).any()


def test_bad_words_equal_jax(plain, plain_beams):
    toks, _, _ = plain_beams
    bad = ((int(toks[0, 0, 2]),), (int(toks[1, 0, 2]), int(toks[1, 0, 3])))
    out = plain.check(max_new_tokens=12, num_beams=2, bad_words=bad)
    assert not (out[0][:, :, 2:] == bad[0][0]).any()


@pytest.mark.parametrize("gen", [
    dict(min_new_tokens=5), dict(presence_penalty=0.7),
    dict(return_timestamps=True)],
    ids=["min-new-tokens", "presence-penalty", "timestamps"])
def test_processors_equal_jax(eos_model, gen):
    toks, _, lens = eos_model.check(max_new_tokens=12, num_beams=2, **gen)
    if "min_new_tokens" in gen:
        assert (lens >= 2 + 5 + 1).all()


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("layout", ["bhtd", "bhdt"])
def test_quantized_caches_equal_jax(eos_model, kv, layout):
    eos_model.check(max_new_tokens=10, num_beams=2, kv_cache_dtype=kv,
                    cross_kv_layout=layout)


def test_prompted_beam_equals_jax(plain):
    prompt = np.asarray([[1, 11, 13], [1, 11, 17], [1, 11, 19]], np.int32)
    toks, _, _ = plain.check(prompt, max_new_tokens=10, num_beams=2)
    np.testing.assert_array_equal(toks[:, :, :3],
                                  np.broadcast_to(prompt[:, None], (3, 2, 3)))


def test_prompted_beam_with_stop_words_equals_jax(eos_model):
    prompt = np.asarray([[1, 11, 2, 13]] * BATCH, np.int32)
    eos_model.check(prompt, max_new_tokens=9, num_beams=3,
                    stop_words=((2,), (13, 14)))


def test_start_and_forced_prompt_reproduces_plain_beam(plain):
    """A [start, forced] prompt gives plain beam search exactly. With no
    length penalty both paths' denominators are 1; with one they differ by
    design (the prompted path does not count the prompt)."""
    gen = dict(max_new_tokens=10, num_beams=3, length_penalty=0.0)
    toks, scores, lens = plain.port(**gen)
    prompt = np.asarray([[1, 11]] * BATCH, np.int32)
    ptoks, pscores, plens = plain.port(prompt, **{**gen,
                                                  "max_new_tokens": 9})
    np.testing.assert_array_equal(ptoks, toks)
    np.testing.assert_array_equal(plens, lens)
    np.testing.assert_allclose(pscores, scores, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def tie_model():
    """Every token but 20, 21 and EOS suppressed: at the forced position
    and the one after it fewer than 2K candidates carry real scores, and
    the rest tie at exactly NEG_INF (NEG_INF + a log-prob rounds to it)."""
    return _Model(suppress_tokens=tuple(t for t in range(97)
                                        if t not in (2, 20, 21)))


@pytest.mark.parametrize("max_new_tokens", [1, 2])
def test_ties_in_the_top_k_decide_the_low_beams_as_jax(tie_model,
                                                       max_new_tokens,
                                                       monkeypatch):
    """The low beams here are picked among exact ties, the lower index
    first as ``jax.lax.top_k`` picks them; ``torch.topk``, whose order of
    ties is unspecified, gives other beams."""
    toks, scores, _ = tie_model.check(max_new_tokens=max_new_tokens,
                                      num_beams=4)
    assert (scores[:, 1:] <= beam.NEG_INF / max_new_tokens).any()
    monkeypatch.setattr(beam, "top_k",
                        lambda x, n: torch.topk(x, n, dim=-1))
    with pytest.raises(AssertionError):
        tie_model.check(max_new_tokens=max_new_tokens, num_beams=4)


def test_top_k_orders_ties_by_index():
    x = torch.tensor([[1.0, 3.0, 3.0, -1e9, 3.0, -1e9, 2.0]])
    values, idx = beam.top_k(x, 5)
    assert idx.tolist() == [[1, 2, 4, 6, 0]]
    assert values.tolist() == [[3.0, 3.0, 3.0, 2.0, 1.0]]


def test_unknown_early_stopping_mode_is_refused(plain):
    with pytest.raises(ValueError):
        plain.port(max_new_tokens=3, num_beams=2, early_stopping="sometimes")
    with pytest.raises(ValueError):
        WhisperSession(plain.params, plain.cfg, torch_config.GenerationConfig(
            num_beams=2, early_stopping=None), device="cpu")


def test_session_beams_equal_the_jax_sessions(plain):
    """``num_beams > 1`` in the session: encode, beam search, the best
    hypothesis in greedy's signature, as the JAX session returns it."""
    kw = dict(max_new_tokens=8, num_beams=2)
    mel = np.random.default_rng(4).standard_normal(
        (2, 2 * plain.cfg.max_source_positions, plain.cfg.num_mel_bins)
    ).astype(np.float32)
    ref = JaxSession(plain.ref, plain.jcfg, jax_config.GenerationConfig(
        **kw)).transcribe_features(mel)
    out = WhisperSession(plain.params, plain.cfg,
                         torch_config.GenerationConfig(**kw),
                         device="cpu").transcribe_features(mel)
    np.testing.assert_array_equal(out[0], np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1], np.asarray(ref[1]))
    assert out[0].shape == (2, 9)
