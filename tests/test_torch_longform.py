"""PyTorch port: long-form transcription (``runtime/longform.py``) against
the JAX package's ``runtime/longform.py``: ``chunk_audio`` on the cases of
``tests/test_longform.py``, and ``transcribe_long`` and
``transcribe_long_conditioned`` (greedy, and beam search with K = 2) on
68 s of audio (three 30 s chunks: a tone, noise and a square wave),
per-chunk token ids equal to JAX's.

The model is the tiny test config (2 + 2 layers, d 32, vocabulary 97) at
Whisper's real input width (80 mels, 1500 encoder positions), so that 30 s
chunks go through the session's frontend and encoder; random weights from
JAX ``init_params``, carried over. The port's frontend and the JAX one
round apart in the last bits, and the token ids must still be equal.
"""

import dataclasses

import numpy as np
import pytest

from whisper_trtllm_tpu import config as jax_config
from whisper_trtllm_tpu.models.whisper import init_params
from whisper_trtllm_tpu.runtime import longform as jax_longform
from whisper_trtllm_tpu.runtime.session import WhisperSession as JaxSession
from whisper_trtllm_tpu_torch import config as torch_config
from whisper_trtllm_tpu_torch.runtime import longform
from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy


@pytest.mark.parametrize("n,overlap", [
    (480000 * 2 + 1000, 0.0), (100, 0.0), (480000 + 240000, 15.0),
    (480000, 0.0), (0, 0.0)],
    ids=["exact", "short", "overlap", "one-window", "empty"])
def test_chunk_audio_equals_jax(n, overlap):
    audio = np.arange(n, dtype=np.float32)
    ref = jax_longform.chunk_audio(audio, overlap_seconds=overlap)
    out = longform.chunk_audio(audio, overlap_seconds=overlap)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


def test_chunk_audio_refuses_an_overlap_without_stride():
    with pytest.raises(ValueError):
        longform.chunk_audio(np.zeros(10, np.float32), overlap_seconds=30.0)


class _Pair:
    """A JAX session and the port's on one weight tree."""

    def __init__(self):
        self.jcfg = jax_config.WhisperConfig.testing(
            num_mel_bins=80, max_source_positions=1500,
            max_target_positions=24)
        self.cfg = torch_config.WhisperConfig(
            **dataclasses.asdict(self.jcfg))
        self.ref = init_params(self.jcfg, seed=0)
        # a sharper and stronger cross attention, so that each chunk's
        # audio, and not the weights alone, decides its tokens
        ca = self.ref["decoder"]["layers"]["encoder_attn"]
        ca["k"]["kernel"] = ca["k"]["kernel"] * 10.0
        ca["v"]["kernel"] = ca["v"]["kernel"] * 30.0
        self.params = params_from_numpy(self.ref, "cpu")
        # a tone, noise, then 8 s of a square wave: three chunks that differ
        t = np.arange(480000) / 16000.0
        self.audio = np.concatenate([
            0.5 * np.sin(2 * np.pi * 220 * t),
            0.3 * np.random.default_rng(7).standard_normal(480000),
            0.5 * np.sign(np.sin(2 * np.pi * 3 * t[:130000]))]).astype(
                np.float32)

    def sessions(self, **gen):
        # the presence penalty keeps a chunk's tokens from repeating
        gen = dict(presence_penalty=1.0, **gen)
        return (JaxSession(self.ref, self.jcfg,
                           jax_config.GenerationConfig(**gen)),
                WhisperSession(self.params, self.cfg,
                               torch_config.GenerationConfig(**gen),
                               device="cpu"))


@pytest.fixture(scope="module")
def pair():
    return _Pair()


def _assert_chunks_equal(out, ref):
    ids, n = out
    ref_ids, ref_n = ref
    assert n == ref_n == 3 and len(ids) == len(ref_ids) == 3
    for got, want in zip(ids, ref_ids):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.asarray(want))


def test_transcribe_long_equals_jax(pair):
    jax_sess, sess = pair.sessions(max_new_tokens=8)
    ref = jax_longform.transcribe_long(jax_sess, pair.audio, batch=2)
    out = longform.transcribe_long(sess, pair.audio, batch=2)
    _assert_chunks_equal(out, ref)
    assert all(len(x) > 0 for x in out[0])
    assert any(not np.array_equal(out[0][0], x) for x in out[0][1:])


@pytest.mark.parametrize("num_beams", [1, 2], ids=["greedy", "beams"])
def test_transcribe_long_conditioned_equals_jax(pair, num_beams):
    """Chunks 2 and 3 decode prompted with the previous chunk's last 3
    tokens (``beam_decode_prompted`` with beams), chunk 1 unprompted."""
    jax_sess, sess = pair.sessions(max_new_tokens=6, num_beams=num_beams)
    ref = jax_longform.transcribe_long_conditioned(
        jax_sess, pair.audio, prev_sot_token_id=4, prev_context_tokens=3)
    out = longform.transcribe_long_conditioned(
        sess, pair.audio, prev_sot_token_id=4, prev_context_tokens=3)
    _assert_chunks_equal(out, ref)
    assert all(len(x) >= 3 for x in out[0][:2])
