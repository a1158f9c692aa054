"""PyTorch port on a CUDA card: each kernel against its plain version, and
the trained artifact end to end through the kernels.

Every test here is marked ``gpu`` and skips where
``torch.cuda.is_available()`` is False. The file imports no JAX, so it runs
on a machine that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerances: 1e-5 max-abs in fp32 (the kernels reorder sums: online
softmax, lane-group dot products), 2e-2 in bf16 (the plain version rounds
the softmax weights to bf16 before P·V).
"""

import json
import os

import numpy as np
import pytest
import torch

from whisper_trtllm_tpu_torch.ops.kernels import (
    KERNELS,
    attention_reference,
    decode_attention_reference,
    decode_attn,
    flash_fwd,
    reset_launch_counts,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.gpu
DTYPES = [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from whisper_trtllm_tpu_torch.utils.device import set_fp32_precision

    set_fp32_precision()
    return torch.device("cuda")


def _normal(rng, shape, scale, device, dtype):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(device, dtype)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("hkv,s,dh,causal", [(6, 1500, 64, False),
                                             (2, 200, 64, True),
                                             (2, 100, 128, False),
                                             (3, 77, 40, False)])
def test_flash_kernel_matches_plain(cuda, dtype, tol, hkv, s, dh, causal):
    rng = np.random.default_rng(s)
    q = _normal(rng, (2, 6, s, dh), dh ** -0.5, cuda, dtype)
    k = _normal(rng, (2, hkv, s, dh), 1.0, cuda, dtype)
    v = _normal(rng, (2, hkv, s, dh), 1.0, cuda, dtype)
    before = flash_fwd.launches
    out = flash_fwd(q, k, v, causal=causal)
    assert flash_fwd.launches == before + 1
    ref = attention_reference(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("t,valid_len,dh", [(33, 1, 64), (33, 33, 64),
                                            (1504, 1500, 64), (1504, 0, 64),
                                            (40, 17, 8), (64, 64, 128)])
def test_decode_kernel_matches_plain(cuda, dtype, tol, t, valid_len, dh):
    rng = np.random.default_rng(t + valid_len)
    q = _normal(rng, (4, 6, 1, dh), dh ** -0.5, cuda, dtype)
    ck = _normal(rng, (4, 6, t, dh), 1.0, cuda, dtype)
    cv = _normal(rng, (4, 6, t, dh), 1.0, cuda, dtype)
    vl = torch.tensor(valid_len, dtype=torch.int32, device=cuda)
    before = decode_attn.launches
    out = decode_attn(q, ck, cv, vl)
    assert decode_attn.launches == before + 1
    ref = decode_attention_reference(q, ck, cv, vl)
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(1, 2, 16, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd(x.transpose(2, 3).contiguous().transpose(2, 3), x, x)
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd(*(torch.zeros(1, 2, 16, 12, device=cuda),) * 3)
    with pytest.raises(TypeError):
        flash_fwd(x.half(), x.half(), x.half())
    with pytest.raises(TypeError, match="valid_len"):
        decode_attn(torch.zeros(1, 2, 1, 64, device=cuda), x, x, 3)


def test_artifact_transcribes_exactly_through_the_kernels(cuda):
    from whisper_trtllm_tpu_torch.audio import pad_or_trim, read_wav
    from whisper_trtllm_tpu_torch.config import GenerationConfig
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
    from whisper_trtllm_tpu_torch.utils.vocab import ids_to_text

    def read(i):
        return pad_or_trim(read_wav(os.path.join(
            ROOT, "artifacts", "eval", f"utt{i:02d}.wav")))

    with open(os.path.join(ROOT, "artifacts", "expected.json")) as f:
        expected = json.load(f)["texts"]
    params, cfg = load_checkpoint(
        os.path.join(ROOT, "artifacts", "tiny_en_synth_int8"))
    session = WhisperSession(params, cfg, GenerationConfig(max_new_tokens=32))
    reset_launch_counts()
    toks, lens = session.transcribe(np.stack([read(i) for i in range(4)]))
    texts = [ids_to_text(toks[i, :lens[i]]) for i in range(4)]
    assert texts == expected
    steps = int(lens.max()) - 1
    assert {n: f.launches for n, f in KERNELS.items()} == {
        "flash_fwd": cfg.encoder_layers,
        "decode_attn": 2 * cfg.decoder_layers * steps}
