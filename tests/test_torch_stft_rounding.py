"""The rounding points of the STFT frontend kernel (K3,
``whisper_trtllm_tpu_torch/csrc/stft.cu``), emulated in plain torch on the
CPU, against the JAX package's Pallas kernel in interpret mode.

K3 takes the windowed DFT and the mel product on the tensor cores as
3xTF32: each operand is split into x = hi + lo, hi = tf32(x) and
lo = tf32(x - hi) (tf32 rounding to nearest, ties away, on the 13 dropped
mantissa bits), and a product is lo*hi + hi*lo + hi*hi. The tensor cores
truncate the sum they add into, so each step of 8 (taps, or bins in the
mel product) puts its three products into a fresh partial, added to the
fp32 accumulator: 50 partials over the 400 taps, 26 over the 201 bins
(padded to 208 with zeros). Power is fp32. The emulation below repeats
that: the steps, the split and the order in which the partials are added.

It is held to K3's limit, 2e-4 on the log10 values (the JAX package's own
STFT tolerance), on a bundled utterance and on near-silent frames (the
same speech scaled by 1e-4 after a second of exact zeros, where log10
magnifies the DFT's relative error the most). One TF32 product alone
misses the limit on the near-silent frames, which is why K3 takes three.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_trtllm_tpu.ops.pallas.stft import stft_log_mel as jax_stft_log_mel
from whisper_trtllm_tpu_torch.audio.features import (
    HOP_LENGTH,
    N_FFT,
    N_FRAMES,
    LogMelSpectrogram,
    pad_or_trim,
    read_wav,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 2e-4
STEP = 8  # taps of one mma.sync m16n8k8 step: one fresh partial each


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to tf32 as the kernel rounds it (``to_tf32`` in
    flash_tiles.cuh): to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as 3xTF32, small terms first."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def blocks_of(audio: np.ndarray) -> torch.Tensor:
    """(B, 3003, 160) hop blocks of the center-padded signal, as the
    frontend cuts them."""
    x = torch.from_numpy(audio.astype(np.float32))
    pad = N_FFT // 2
    x = torch.nn.functional.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    n_blocks = N_FRAMES + 3
    x = torch.nn.functional.pad(x, (0, n_blocks * HOP_LENGTH - x.shape[1]))
    return x.reshape(x.shape[0], n_blocks, HOP_LENGTH)


def frames_of(blocks: torch.Tensor, n_taps: int) -> torch.Tensor:
    b, n_blocks, hop = blocks.shape
    return blocks.reshape(b, n_blocks * hop).unfold(1, n_taps, hop)[
        :, :n_blocks - 2]


def stepped(a, b, products):
    """a @ b over the last axis of a in steps of 8, each step's products a
    fresh fp32 partial added to the accumulator in step order."""
    out = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k in range(0, a.shape[-1], STEP):
        out += products(a[..., k:k + STEP], b[k:k + STEP])
    return out


def emulate(blocks, basis, mel_fb, products=mm3):
    """K3's log-mel: the DFT and the mel product in 8-steps, power in
    fp32."""
    n_taps, n_bins = basis.shape[0], basis.shape[1] // 2
    spec = stepped(frames_of(blocks, n_taps), basis, products)
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    mels = stepped(re * re + im * im, mel_fb, products)
    return torch.log10(torch.clamp(mels, min=1e-10))


def speech(quiet: bool) -> np.ndarray:
    """The first bundled utterance; quiet: scaled by 1e-4 after a second
    of exact zeros."""
    audio = pad_or_trim(read_wav(os.path.join(ROOT, "artifacts", "eval",
                                              "utt00.wav")))
    if quiet:
        audio = np.concatenate([np.zeros(16000, np.float32),
                                audio[:-16000]]) * np.float32(1e-4)
    return audio[None]


def pallas_log_mel(blocks, fe):
    return np.asarray(jax_stft_log_mel(
        jnp.asarray(blocks.numpy()), jnp.asarray(fe.dft_basis.numpy()),
        jnp.asarray(fe.mel_fb.numpy()), interpret=True))


@pytest.fixture(scope="module")
def cases():
    """(name, blocks, the Pallas kernel's log-mel) for each input, 80 mels."""
    fe = LogMelSpectrogram(80, device="cpu")
    out = {}
    for quiet in (False, True):
        blocks = blocks_of(speech(quiet))
        out["near-silent" if quiet else "speech"] = (
            blocks, pallas_log_mel(blocks, fe))
    return fe, out


@pytest.mark.parametrize("name", ["speech", "near-silent"])
def test_3xtf32_with_fresh_partials_matches_pallas(cases, name):
    fe, inputs = cases
    blocks, ref = inputs[name]
    out = emulate(blocks, fe.dft_basis[:N_FFT], fe.mel_fb)
    assert tuple(out.shape) == ref.shape == (1, N_FRAMES + 1, 80)
    err = np.abs(out.numpy() - ref).max()
    assert err <= LIMIT, err


def test_near_silent_frames_reach_the_floor_and_stay_finite(cases):
    """The near-silent input is what the name says: its leading second
    sits on the 1e-10 floor, and of the rest only the loudest frames rise
    above it, by less than four decades, where log10 is steepest."""
    _, inputs = cases
    quiet = inputs["near-silent"][1]
    assert np.isfinite(quiet).all()
    assert (quiet[0, :90] == -10.0).all()
    above = quiet[quiet > -10.0]
    assert above.size > 100 and above.max() < -6.0


def test_one_tf32_product_misses_the_limit_on_near_silent_frames(cases):
    """Why K3 splits each operand: one TF32 product a step keeps ~11 bits
    and moves the near-silent log-mel by more than 2e-4."""
    fe, inputs = cases
    blocks, ref = inputs["near-silent"]
    one = emulate(blocks, fe.dft_basis[:N_FFT], fe.mel_fb,
                  products=lambda a, b: tf32(a) @ tf32(b))
    assert np.abs(one.numpy() - ref).max() > LIMIT


@pytest.mark.parametrize("n_mels", [80, 128])
def test_emulation_matches_the_plain_version_at_batch_2(n_mels):
    """The emulation against the port's plain K3 (two fp32 matmuls) on a
    batch that mixes speech and its near-silent copy, at both mel counts."""
    from whisper_trtllm_tpu_torch.ops.kernels import stft_log_mel_reference

    fe = LogMelSpectrogram(n_mels, device="cpu")
    blocks = blocks_of(np.concatenate([speech(False), speech(True)]))
    basis = fe.dft_basis[:N_FFT]
    out = emulate(blocks, basis, fe.mel_fb)
    ref = stft_log_mel_reference(blocks, basis, fe.mel_fb)
    assert (out - ref).abs().max().item() <= LIMIT
