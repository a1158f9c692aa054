"""PyTorch port: the log-mel frontend against the JAX package's default
(plain matmul) frontend, on the same audio drawn from a seed."""

import numpy as np
import pytest
import torch

from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu.audio import features as jax_features
from whisper_trtllm_tpu.audio import mel as jax_mel
from whisper_trtllm_tpu_torch.audio import features, mel


def test_mel_constants_equal_jax():
    for bins in (80, 128):
        np.testing.assert_array_equal(mel.mel_filter_bank(201, bins),
                                      jax_mel.mel_filter_bank(201, bins))
    np.testing.assert_array_equal(mel.hann_window(400), jax_mel.hann_window(400))
    for ours, ref in zip(mel.dft_matrices(400), jax_mel.dft_matrices(400)):
        np.testing.assert_array_equal(ours, ref)
    fe = features.LogMelSpectrogram(80, device="cpu")
    jfe = jax_features.LogMelSpectrogram(80)
    np.testing.assert_array_equal(fe.dft_basis.numpy(), np.asarray(jfe.dft_basis))


@pytest.mark.parametrize("n", [1000, 480000, 500000])
def test_pad_or_trim_equals_jax(n):
    audio = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    np.testing.assert_array_equal(features.pad_or_trim(audio),
                                  jax_features.pad_or_trim(audio))


@pytest.mark.parametrize("bins", [80, 128])
def test_log_mel_matches_jax_at_batch_2(bins):
    """Tolerance 1e-4: two fp32 matmuls summed in another order, then
    log10, against output values of order 1."""
    rng = np.random.default_rng(7)
    audio = (0.1 * rng.standard_normal((2, features.N_SAMPLES))).astype(np.float32)
    audio[1, 200000:] = 0.0  # a silent tail exercises the per-utterance clamp
    ref = np.asarray(jax_features.LogMelSpectrogram(bins)(audio))
    out = features.LogMelSpectrogram(bins, device="cpu")(torch.from_numpy(audio))
    assert out.shape == (2, features.N_FRAMES, bins)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_log_mel_spectrogram_one_shot_on_cpu():
    rng = np.random.default_rng(8)
    audio = (0.1 * rng.standard_normal(features.N_SAMPLES)).astype(np.float32)
    out = features.log_mel_spectrogram(audio, device="cpu")
    ref = np.asarray(jax_features.log_mel_spectrogram(audio))
    assert out.shape == (1, features.N_FRAMES, 80)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_frontend_casts_to_its_dtype():
    audio = torch.zeros(1, features.N_SAMPLES)
    out = features.LogMelSpectrogram(80, dtype=torch.bfloat16,
                                      device="cpu")(audio)
    assert out.dtype == torch.bfloat16
