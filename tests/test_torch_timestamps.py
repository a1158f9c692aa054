"""PyTorch port: the timestamp rules and the forced map against the JAX
package's (``whisper_trtllm_tpu/runtime/logits_process.py``), on random
logits and the token histories of ``tests/test_timestamps.py``, which
cover every branch (pairs, monotonicity, the max-initial index, the
log-prob mass rule).

Tolerance: every suppressed (-inf) position equal, the kept logits within
1e-6 (the rules only mask; the log-softmax of the mass rule decides a mask
and never reaches the output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_trtllm_tpu import config as jax_config
from whisper_trtllm_tpu.runtime import logits_process as jax_lp
from whisper_trtllm_tpu_torch import config as torch_config
from whisper_trtllm_tpu_torch.runtime import logits_process as lp

VOCAB = 60
TS_BEGIN = 40          # timestamp tokens are [40, 60)
EOS = 2
BEGIN_INDEX = 2        # [start, lang] prompt
MAX_INITIAL = 5

HISTORIES = {
    "at_begin": [[1, 3]],
    "after_text": [[1, 3, 41, 10, 11]],
    "after_single_timestamp": [[1, 3, 41, 10, 45]],
    "after_timestamp_pair": [[1, 3, 41, 10, 45, 45]],
    "first_generated_is_timestamp": [[1, 3, 42]],
    "monotonicity_batch": [[1, 3, 41, 10, 45, 45, 12],
                           [1, 3, 44, 44, 50, 50, 13],
                           [1, 3, 40, 7, 8, 9, 10]],
}


def _compare(hist, logits, max_initial=MAX_INITIAL, logprob=True,
             begin_index=BEGIN_INDEX):
    b, cur = hist.shape
    buf = np.zeros((b, cur + 4), np.int32)
    buf[:, :cur] = hist
    theirs = np.asarray(jax_lp.apply_timestamp_rules(
        jnp.asarray(logits), jnp.asarray(buf), jnp.int32(cur - 1),
        begin_index, TS_BEGIN, EOS, max_initial, logprob))
    ours = lp.apply_timestamp_rules(
        torch.from_numpy(logits), torch.from_numpy(buf),
        torch.tensor(cur - 1, dtype=torch.int32), begin_index, TS_BEGIN,
        EOS, max_initial, logprob).numpy()
    np.testing.assert_array_equal(np.isneginf(ours), np.isneginf(theirs))
    keep = ~np.isneginf(theirs)
    np.testing.assert_allclose(ours[keep], theirs[keep], atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", sorted(HISTORIES))
@pytest.mark.parametrize("max_initial,logprob", [(MAX_INITIAL, True),
                                                 (None, True),
                                                 (MAX_INITIAL, False)])
def test_timestamp_rules_match_jax(rng, name, max_initial, logprob):
    hist = np.asarray(HISTORIES[name], np.int32)
    logits = rng.standard_normal((hist.shape[0], VOCAB)).astype(np.float32)
    _compare(hist, logits, max_initial, logprob)


@pytest.mark.parametrize("seed", range(4))
def test_timestamp_rules_on_random_histories_match_jax(seed):
    """Random histories half timestamps, and logits that favour the
    timestamps so the mass rule fires in some rows and not in others."""
    rng = np.random.default_rng(100 + seed)
    b, cur = 6, 9
    hist = np.where(rng.random((b, cur)) < 0.5,
                    rng.integers(TS_BEGIN, VOCAB, (b, cur)),
                    rng.integers(3, TS_BEGIN, (b, cur))).astype(np.int32)
    logits = rng.standard_normal((b, VOCAB)).astype(np.float32)
    logits[:, TS_BEGIN:] += rng.uniform(-1, 4, (b, 1)).astype(np.float32)
    for begin in (1, 2, 5):
        _compare(hist, logits, begin_index=begin)


def test_timestamp_rules_take_an_int_position(rng):
    hist = np.asarray(HISTORIES["after_text"], np.int32)
    logits = rng.standard_normal((1, VOCAB)).astype(np.float32)
    buf = np.zeros((1, 9), np.int32)
    buf[:, :5] = hist
    args = (BEGIN_INDEX, TS_BEGIN, EOS, MAX_INITIAL)
    a = lp.apply_timestamp_rules(torch.from_numpy(logits),
                                 torch.from_numpy(buf), 4, *args)
    b = lp.apply_timestamp_rules(torch.from_numpy(logits),
                                 torch.from_numpy(buf), torch.tensor(4), *args)
    assert torch.equal(a, b)


@pytest.mark.parametrize("timestamps", [False, True])
@pytest.mark.parametrize("max_len", [1, 2, 16])
def test_forced_map_matches_jax(timestamps, max_len):
    """The .en presets pin <|notimestamps|> at position 1; timestamps drop
    it, as HF does."""
    for preset in ("tiny_en", "testing"):
        jcfg = getattr(jax_config.WhisperConfig, preset)()
        cfg = getattr(torch_config.WhisperConfig, preset)()
        arr, begin = lp.build_forced_map(cfg, max_len, timestamps=timestamps)
        jarr, jbegin = jax_lp.build_forced_map(jcfg, max_len,
                                               timestamps=timestamps)
        np.testing.assert_array_equal(arr, jarr)
        assert begin == jbegin
    arr, begin = lp.build_forced_map(torch_config.WhisperConfig.tiny_en(), 16,
                                     timestamps=True)
    assert (arr == -1).all() and begin == 1
