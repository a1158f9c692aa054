"""PyTorch port: kernels K1 (flash attention forward) and K2 (decode
attention).

On the CPU the wrappers take their plain versions, which are held here to
the Pallas kernels run in interpret mode, at the shapes of
tests/test_pallas_kernels.py, with that file's tolerances (atol 2e-5,
rtol 1e-4 in fp32: the kernels sum in another order; 3e-2 in bf16). The
dispatching ops (``mha``, ``mha_decode_step``) are held to the JAX ops.
The kernels themselves are held to their plain versions on the card by
tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_trtllm_tpu.ops import attention as jax_att
from whisper_trtllm_tpu.ops.pallas.decode_attention import decode_mha
from whisper_trtllm_tpu.ops.pallas.flash_attention import flash_mha
from whisper_trtllm_tpu_torch.ops import attention as att
from whisper_trtllm_tpu_torch.ops.kernels import (
    KERNELS,
    decode_attn,
    flash_fwd,
    reset_launch_counts,
)

FP32_TOL = dict(atol=2e-5, rtol=1e-4)


def _qkv(seed, b, h, hkv, s, t, dh):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, dh)).astype(np.float32) * 0.3
    k = rng.standard_normal((b, hkv, t, dh)).astype(np.float32) * 0.3
    v = rng.standard_normal((b, hkv, t, dh)).astype(np.float32)
    return q, k, v


def _torch(*xs):
    return [torch.from_numpy(x) for x in xs]


# --------------------------------------------------------------------------
# K1 — plain version vs flash_mha in interpret mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,s,t,dh", [(2, 4, 128, 128, 64), (1, 2, 200, 200, 64)])
def test_flash_plain_matches_pallas(b, h, s, t, dh):
    q, k, v = _qkv(0, b, h, h, s, t, dh)
    ref = np.asarray(flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               interpret=True))
    out = flash_fwd(*_torch(q, k, v))
    np.testing.assert_allclose(out.numpy(), ref, **FP32_TOL)


@pytest.mark.parametrize("hkv,causal", [(1, False), (2, True)])
def test_flash_plain_gqa_matches_pallas(hkv, causal):
    q, k, v = _qkv(1, 2, 4, hkv, 128, 128, 64)
    ref = np.asarray(flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, interpret=True))
    out = flash_fwd(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, **FP32_TOL)


@pytest.mark.parametrize("s", [64, 200])
def test_flash_plain_causal_matches_pallas(s):
    q, k, v = _qkv(2, 2, 3, 3, s, s, 64)
    ref = np.asarray(flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, interpret=True))
    out = flash_fwd(*_torch(q, k, v), causal=True)
    np.testing.assert_allclose(out.numpy(), ref, **FP32_TOL)


def test_flash_plain_bf16_matches_pallas():
    q, k, v = _qkv(3, 1, 2, 2, 128, 128, 64)
    ref = np.asarray(flash_mha(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                               interpret=True).astype(jnp.float32))
    out = flash_fwd(*(x.bfloat16() for x in _torch(q, k, v)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("case", ["flash", "mask", "causal", "input_dtype_softmax",
                                  "single_row"])
def test_mha_matches_jax(case):
    b, h, hkv, s, t, dh = 2, 4, 2, 24, 24, 16
    if case == "single_row":
        s = 1
    q, k, v = _qkv(4, b, h, hkv, s, t, dh)
    mask = None
    if case == "mask":
        mask = np.where(np.random.default_rng(5).random((b, 1, s, t)) < 0.2,
                        -1e9, 0.0).astype(np.float32)
    kw = dict(causal=case == "causal", fp32_softmax=case != "input_dtype_softmax")
    ref = np.asarray(jax_att.mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), **kw))
    out = att.mha(*_torch(q, k, v),
                  None if mask is None else torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(out.numpy(), ref, **FP32_TOL)


# --------------------------------------------------------------------------
# K2 — plain version vs decode_mha in interpret mode
# --------------------------------------------------------------------------

def _decode_inputs(seed, b=2, h=4, t=16, dh=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, 1, dh)).astype(np.float32) * 0.3
    ck = rng.standard_normal((b, h, t, dh)).astype(np.float32) * 0.3
    cv = rng.standard_normal((b, h, t, dh)).astype(np.float32)
    return q, ck, cv


@pytest.mark.parametrize("valid_len", [1, 7, 16])
def test_decode_plain_matches_pallas(valid_len):
    q, ck, cv = _decode_inputs(6)
    ref = np.asarray(decode_mha(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                jnp.int32(valid_len), interpret=True))
    out = decode_attn(*_torch(q, ck, cv),
                      torch.tensor(valid_len, dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), ref, **FP32_TOL)


@pytest.mark.parametrize("fp32_softmax", [True, False])
@pytest.mark.parametrize("valid_len", [1, 9, 24])
def test_mha_decode_step_matches_jax(valid_len, fp32_softmax):
    q, ck, cv = _decode_inputs(7, t=24, dh=16)
    ref = np.asarray(jax_att.mha_decode_step(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.int32(valid_len),
        fp32_softmax=fp32_softmax))
    out = att.mha_decode_step(*_torch(q, ck, cv), valid_len,
                              fp32_softmax=fp32_softmax)
    np.testing.assert_allclose(out.numpy(), ref, **FP32_TOL)


@pytest.mark.parametrize("kw", [
    {"k_scale": torch.ones(2, 4, 16, 1), "v_scale": torch.ones(2, 4, 16, 1)},
    {"t_major": True},
    {"bias": torch.zeros(2, 4, 1, 16)},
    {"valid_len": torch.tensor([3, 4], dtype=torch.int32)},
])
def test_mha_decode_step_refuses_later_slices(kw):
    q, ck, cv = _torch(*_decode_inputs(8))
    kw = dict(kw)
    valid_len = kw.pop("valid_len", 5)
    with pytest.raises(NotImplementedError):
        att.mha_decode_step(q, ck, cv, valid_len, **kw)


# --------------------------------------------------------------------------
# wrappers: plain version for CPU tensors only, launches counted on the card
# --------------------------------------------------------------------------

def test_plain_versions_do_not_count_launches():
    reset_launch_counts()
    q, k, v = _torch(*_qkv(9, 1, 2, 2, 16, 16, 8))
    flash_fwd(q, k, v)
    decode_attn(q[:, :, :1], k, v, torch.tensor(3, dtype=torch.int32))
    assert {n: f.launches for n, f in KERNELS.items()} == {
        "flash_fwd": 0, "decode_attn": 0}


def test_wrappers_never_take_the_plain_version_off_the_cpu():
    q, k, v = (torch.empty(1, 2, 16, 8, device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="unsupported device"):
        flash_fwd(q, k, v)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attn(torch.empty(1, 2, 1, 8, device="meta"), k, v,
                    torch.empty((), dtype=torch.int32, device="meta"))
