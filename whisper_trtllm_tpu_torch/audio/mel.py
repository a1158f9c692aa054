"""Slaney-scale mel filterbank, built from scratch in numpy.

Numerically matches the filterbank the reference's frontend uses
(reference: transformers/src/transformers/models/whisper/
feature_extraction_whisper.py:60-75 — ``mel_filter_bank(201, 80, 0.0, 8000,
16000, norm="slaney", mel_scale="slaney")``). The port's own copy of
``whisper_trtllm_tpu/audio/mel.py`` (numpy only), held to it by
tests/test_torch_frontend.py.
"""

from __future__ import annotations

import numpy as np

_MIN_LOG_HERTZ = 1000.0
_MIN_LOG_MEL = 15.0
_LOGSTEP = 27.0 / np.log(6.4)


def hertz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney-scale Hz→mel: linear below 1 kHz, log above."""
    freq = np.asarray(freq, dtype=np.float64)
    mels = 3.0 * freq / 200.0
    log_region = freq >= _MIN_LOG_HERTZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HERTZ) / _MIN_LOG_HERTZ) * _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hertz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    freq = 200.0 * mels / 3.0
    log_region = mels >= _MIN_LOG_MEL
    freq = np.where(
        log_region,
        _MIN_LOG_HERTZ * np.exp((mels - _MIN_LOG_MEL) / _LOGSTEP),
        freq,
    )
    return freq


def mel_filter_bank(
    num_frequency_bins: int = 201,
    num_mel_filters: int = 80,
    min_frequency: float = 0.0,
    max_frequency: float = 8000.0,
    sampling_rate: int = 16000,
) -> np.ndarray:
    """Triangular slaney-normalized filterbank, shape
    ``(num_frequency_bins, num_mel_filters)`` (float32)."""
    mel_min = hertz_to_mel(min_frequency)
    mel_max = hertz_to_mel(max_frequency)
    mel_freqs = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = mel_to_hertz(mel_freqs)

    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, num_frequency_bins)

    filter_diff = np.diff(filter_freqs)
    slopes = np.expand_dims(filter_freqs, 0) - np.expand_dims(fft_freqs, 1)
    down_slopes = -slopes[:, :-2] / filter_diff[:-1]
    up_slopes = slopes[:, 2:] / filter_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))

    # slaney area normalization
    enorm = 2.0 / (filter_freqs[2 : num_mel_filters + 2] - filter_freqs[:num_mel_filters])
    fb = fb * np.expand_dims(enorm, 0)
    return fb.astype(np.float32)


def hann_window(length: int, periodic: bool = True) -> np.ndarray:
    """Periodic Hann window (matches np.hanning(length+1)[:-1])."""
    n = length + 1 if periodic else length
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
    if periodic:
        w = w[:-1]
    return w.astype(np.float64)


def dft_matrices(n_fft: int = 400) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag one-sided DFT matrices of shape (n_fft, n_fft//2+1).

    The STFT becomes two matmuls: ``frames @ cos`` and ``frames @ sin``.
    """
    n_bins = n_fft // 2 + 1
    k = np.arange(n_fft)[:, None]
    f = np.arange(n_bins)[None, :]
    ang = -2.0 * np.pi * k * f / n_fft
    return np.cos(ang), np.sin(ang)
