"""PyTorch port: the utilities (``utils/normalizer.py``, ``metrics.py``,
``profiler.py``, ``logger.py``, ``debugging.py``) and the runtime options
against the JAX package, at ``WhisperConfig.testing()``.

- The normalizer equals JAX's on every golden pair of
  ``tests/test_normalizer.py``, on its battery and on a seeded fuzz over
  words, numbers, symbols, contractions and spellings; ``word_error_rate``,
  ``rouge_scores`` and ``basic_normalize`` equal JAX's exactly.
- ``Timer`` behaves as JAX's; ``profile_trace`` writes a trace; the
  logger honours ``WHISPER_TPU_LOG_LEVEL``.
- ``encode_with_intermediates`` matches the port's ``encode`` (atol 1e-6)
  and its conv stem and stacked layer outputs equal JAX's within
  2e-5/1e-4; ``checked(torch.log)`` raises on -1 and gives 0 on 1.
- ``fp32_attention_softmax``, ``fp32_logits`` and ``use_pallas`` set False
  give the tokens of the JAX session with the same option and of the
  port's default; ``persistent_cache_dir`` points the kernels' build there.
"""

import dataclasses
import importlib
import json
import logging
import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_normalizer as jax_norm_tests
from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu import config as jax_config
from whisper_trtllm_tpu.models.whisper import init_params
from whisper_trtllm_tpu.runtime import WhisperSession as JaxSession
from whisper_trtllm_tpu.utils import debugging as jax_debugging
from whisper_trtllm_tpu.utils import metrics as jax_metrics
from whisper_trtllm_tpu.utils import profiler as jax_profiler
from whisper_trtllm_tpu.utils.normalizer import EnglishTextNormalizer as JaxNorm
from whisper_trtllm_tpu_torch import config as torch_config
from whisper_trtllm_tpu_torch.models.whisper import encode
from whisper_trtllm_tpu_torch.ops.kernels import _build
from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
from whisper_trtllm_tpu_torch.utils import debugging, logger, metrics, profiler
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy
from whisper_trtllm_tpu_torch.utils.normalizer import EnglishTextNormalizer

TOL = dict(atol=2e-5, rtol=1e-4)
NORM = EnglishTextNormalizer()
JNORM = JaxNorm()


@pytest.mark.parametrize("text,expect", jax_norm_tests.GOLDEN)
def test_normalizer_golden_pairs_equal_jax(text, expect):
    assert NORM(text) == JNORM(text) == expect


def test_normalizer_battery_equals_jax():
    for text in jax_norm_tests.BATTERY:
        assert NORM(text) == JNORM(text), text


def _fuzz_texts(seed: int, n: int):
    """Seeded word salads over numbers, currencies, contractions, titles,
    British spellings, brackets and symbols."""
    vocab = (
        "one two three seven nine ten eleven fifteen nineteen twenty fifty "
        "ninety hundred thousand million oh zero point and a half double "
        "triple minus plus dollars cents pounds percent per cent first "
        "third fifth twelfth fortieth hundredth sixes sevens twenties "
        "thousands cat the 3 42 7.5 1,000 $12 £3 ¢5 99% o'clock it's "
        "won't can't y'all mr. mrs. dr. st. colour favourite organise "
        "travelled [noise] (laughs) <unk> hmm uh um café naïve — , ; ! ?"
    ).split()
    rng = random.Random(seed)
    return [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 14)))
            for _ in range(n)]


def test_normalizer_fuzz_equals_jax():
    for text in _fuzz_texts(0, 600):
        assert NORM(text) == JNORM(text), text


def test_wer_rouge_and_basic_normalize_equal_jax():
    texts = _fuzz_texts(1, 60)
    hyps, refs = texts[:30], texts[30:]
    hyps_n, refs_n = [NORM(t) for t in hyps], [NORM(t) for t in refs]
    assert metrics.word_error_rate(hyps_n, refs_n) == \
        jax_metrics.word_error_rate(hyps_n, refs_n)
    assert metrics.word_error_rate(refs_n, refs_n) == 0.0
    assert metrics.rouge_scores(hyps, refs) == \
        jax_metrics.rouge_scores(hyps, refs)
    assert [metrics.basic_normalize(t) for t in texts] == \
        [jax_metrics.basic_normalize(t) for t in texts]
    assert metrics.get_text_normalizer()("Mr. Smith's colour") == \
        jax_metrics.get_text_normalizer()("Mr. Smith's colour")


def test_timer_behaves_as_jax():
    for mod in (profiler, jax_profiler):
        t = mod.Timer()
        with t.time("phase_a"):
            time.sleep(0.01)
        t.start("phase_b")
        time.sleep(0.005)
        assert t.stop("phase_b") >= 0.004
        assert t.elapsed("phase_a") >= 0.009
        lines = t.summary().splitlines()
        assert lines[0] == "Profile results:"
        assert [ln.split(":")[0] for ln in lines[1:]] == ["  phase_a",
                                                          "  phase_b"]
        t.reset("phase_a")
        assert t.elapsed("phase_a") == 0.0
        t.reset()
        assert t.summary() == "Profile results:"


def test_profile_trace_writes_a_trace(tmp_path):
    with profiler.profile_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_logger_honours_the_level_variable(monkeypatch):
    monkeypatch.setenv("WHISPER_TPU_LOG_LEVEL", "info")
    lg = importlib.reload(logger).logger
    assert lg.name == "whisper_trtllm_tpu_torch"
    assert lg.level == logging.INFO and len(lg.handlers) == 1
    monkeypatch.delenv("WHISPER_TPU_LOG_LEVEL")
    assert importlib.reload(logger).logger.level == logging.WARNING


@pytest.fixture(scope="module")
def model():
    """The testing config in both packages, JAX's seed-0 tree carried to
    the port, two mels."""
    jcfg = jax_config.WhisperConfig.testing()
    tcfg = torch_config.WhisperConfig(**dataclasses.asdict(jcfg))
    jparams = init_params(jcfg, seed=0)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    mel = np.random.default_rng(0).standard_normal(
        (2, 2 * jcfg.max_source_positions, jcfg.num_mel_bins)
    ).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, mel


def test_encode_with_intermediates_matches_encode_and_jax(model):
    jcfg, tcfg, jparams, tparams, mel = model
    final, inter = debugging.encode_with_intermediates(tparams, tcfg, mel)
    with torch.no_grad():
        ref = encode(tparams, tcfg, torch.from_numpy(mel))
    np.testing.assert_allclose(final.numpy(), ref.numpy(), atol=1e-6)
    jfinal, jinter = jax.jit(lambda p, m: jax_debugging.encode_with_intermediates(
        p, jcfg, m))(jparams, jnp.asarray(mel))
    assert inter["layer_outputs"].shape == jinter["layer_outputs"].shape == (
        tcfg.encoder_layers, 2, tcfg.max_source_positions, tcfg.d_model)
    for key in ("conv_stem", "layer_outputs"):
        np.testing.assert_allclose(inter[key].numpy(),
                                   np.asarray(jinter[key]), **TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **TOL)


def test_checked_raises_on_nan_and_passes_clean_values():
    f = debugging.checked(torch.log)
    with pytest.raises(FloatingPointError):
        f(torch.tensor([-1.0]))
    np.testing.assert_allclose(f(torch.tensor([1.0])).numpy(), [0.0])
    # an operator's fresh output buffer is not a result: no false alarm
    g = debugging.checked(lambda x: torch.empty_like(x).fill_(2.0) * x)
    assert g(torch.ones(3)).tolist() == [2.0, 2.0, 2.0]


@pytest.fixture(scope="module")
def default_tokens(model):
    jcfg, tcfg, jparams, tparams, mel = model
    gen = torch_config.GenerationConfig(max_new_tokens=6)
    toks, lens = WhisperSession(tparams, tcfg, gen,
                                device="cpu").transcribe_features(mel)
    return toks, lens


@pytest.mark.parametrize("option", ["fp32_attention_softmax", "fp32_logits",
                                    "use_pallas"])
def test_inert_options_decode_as_jax_and_as_the_default(model, default_tokens,
                                                         option):
    jcfg, tcfg, jparams, tparams, mel = model
    jsess = JaxSession(jparams, jcfg, jax_config.GenerationConfig(
        max_new_tokens=6), jax_config.RuntimeConfig(**{option: False}))
    jtoks, jlens = jsess.transcribe_features(mel)
    sess = WhisperSession(tparams, tcfg,
                          torch_config.GenerationConfig(max_new_tokens=6),
                          torch_config.RuntimeConfig(**{option: False}),
                          device="cpu")
    toks, lens = sess.transcribe_features(mel)
    np.testing.assert_array_equal(toks, np.asarray(jtoks))
    np.testing.assert_array_equal(lens, np.asarray(jlens))
    np.testing.assert_array_equal(toks, default_tokens[0])
    np.testing.assert_array_equal(lens, default_tokens[1])


@pytest.fixture
def build_dir():
    """Restores the kernels' build directory after the test."""
    before = _build.BUILD_DIR
    yield
    _build.BUILD_DIR = before


def test_persistent_cache_dir_points_the_build_there(model, build_dir,
                                                     tmp_path):
    jcfg, tcfg, jparams, tparams, mel = model
    cache = tmp_path / "kernels"
    WhisperSession(tparams, tcfg, runtime=torch_config.RuntimeConfig(
        persistent_cache_dir=str(cache)), device="cpu")
    assert cache.is_dir() and _build.BUILD_DIR == cache.resolve()
    assert _build.library_path("layer_norm").parent == cache.resolve()


def test_other_compute_dtypes_stay_refused(model):
    jcfg, tcfg, jparams, tparams, mel = model
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        WhisperSession(tparams, tcfg, runtime=torch_config.RuntimeConfig(
            compute_dtype="float16"), device="cpu")
