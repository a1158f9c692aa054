"""PyTorch port: ALiBi's bias (``ops/functional.py::alibi_bias``) and the
decode step's additive score bias (``ops/attention.py::mha_decode_step``
with ``bias=``, kernel K2's ``bias`` on the card) against the JAX
package's ops, on the CPU.

``alibi_bias`` within 1e-7 of JAX's at 4, 6, 12 and 16 heads (6 and 12
take the interpolated extra slopes); ``mha_decode_step(..., bias=)``
within 1e-5 of JAX's (fp32) for float, int8 and fp8 caches, dh-minor and
T-minor, a scalar and a per-lane ``valid_len``, with ALiBi's (1, H, 1, T)
bias and a full (B, H, 1, T) one; a zero bias equal to none, bit for
bit, on the plain version as the card's steadiness test holds K2; the
biased kernels' library (``csrc/decode_attention_bias.cu``) rebuilt when
the source it includes changes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu.ops import attention as jax_att
from whisper_trtllm_tpu.ops.functional import alibi_bias as jax_alibi_bias
from whisper_trtllm_tpu_torch.ops import attention as att
from whisper_trtllm_tpu_torch.ops.functional import alibi_bias

_QUANT = {"int8": (jnp.int8, torch.int8),
          "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


@pytest.mark.parametrize("heads", [4, 6, 12, 16])
def test_alibi_bias_matches_jax(heads):
    got = alibi_bias(heads, 37)
    want = np.asarray(jax_alibi_bias(heads, 37))
    assert got.shape == (1, heads, 1, 37) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=0)


def _inputs(seed, b=3, h=4, t=24, dh=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, 1, dh)).astype(np.float32) * 0.3
    ck = rng.standard_normal((b, h, t, dh)).astype(np.float32) * 0.3
    cv = rng.standard_normal((b, h, t, dh)).astype(np.float32)
    return q, ck, cv


def _caches(ck, cv, kind, t_major):
    """(JAX k, v, scale kwargs), (the port's), in the layout asked."""
    if kind == "float":
        jk, jv, jkw = jnp.asarray(ck), jnp.asarray(cv), {}
        tk, tv, tkw = torch.from_numpy(ck), torch.from_numpy(cv), {}
    else:
        jdt, tdt = _QUANT[kind]
        jk, jks = jax_att.quantize_kv(jnp.asarray(ck), jdt)
        jv, jvs = jax_att.quantize_kv(jnp.asarray(cv), jdt)
        tk, tks = att.quantize_kv(torch.from_numpy(ck), tdt)
        tv, tvs = att.quantize_kv(torch.from_numpy(cv), tdt)
        jkw, tkw = dict(k_scale=jks, v_scale=jvs), dict(k_scale=tks,
                                                         v_scale=tvs)
    if t_major:
        jk, jv = jnp.swapaxes(jk, -1, -2), jnp.swapaxes(jv, -1, -2)
        tk, tv = tk.transpose(-1, -2), tv.transpose(-1, -2)
    return (jk, jv, jkw), (tk, tv, tkw)


@pytest.mark.parametrize("bias_kind", ["alibi", "full"])
@pytest.mark.parametrize("valid_len", [17, "per_lane"])
@pytest.mark.parametrize("t_major", [False, True], ids=["bhtd", "bhdt"])
@pytest.mark.parametrize("kind", ["float", "int8", "fp8"])
def test_mha_decode_step_with_a_bias_matches_jax(kind, t_major, valid_len,
                                                 bias_kind):
    q, ck, cv = _inputs(21)
    b, h, t = ck.shape[:3]
    if bias_kind == "alibi":
        bias = alibi_bias(h, t).numpy()
    else:
        bias = np.random.default_rng(22).standard_normal(
            (b, h, 1, t)).astype(np.float32) * 3
    vl = (np.array([3, 24, 0], np.int32) if valid_len == "per_lane"
          else np.int32(valid_len))
    (jk, jv, jkw), (tk, tv, tkw) = _caches(ck, cv, kind, t_major)
    want = np.asarray(jax_att.mha_decode_step(
        jnp.asarray(q), jk, jv, jnp.asarray(vl), bias=jnp.asarray(bias),
        t_major=t_major, **jkw))
    got = att.mha_decode_step(torch.from_numpy(q), tk, tv,
                              torch.from_numpy(np.asarray(vl)),
                              bias=torch.from_numpy(bias), t_major=t_major,
                              **tkw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("fp32_softmax", [True, False])
def test_bf16_decode_step_with_alibi_matches_jax(fp32_softmax):
    """bf16 q and cache, ALiBi's fp32 bias added to the fp32 scores; 3e-2
    (bf16 output)."""
    q, ck, cv = _inputs(23)
    bias = alibi_bias(4, 24).numpy()
    want = np.asarray(jax_att.mha_decode_step(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(ck, jnp.bfloat16),
        jnp.asarray(cv, jnp.bfloat16), jnp.int32(20), bias=jnp.asarray(bias),
        fp32_softmax=fp32_softmax).astype(jnp.float32))
    got = att.mha_decode_step(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(ck).bfloat16(),
        torch.from_numpy(cv).bfloat16(), 20, bias=torch.from_numpy(bias),
        fp32_softmax=fp32_softmax)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_a_zero_bias_equals_no_bias_bit_for_bit(kind):
    q, ck, cv = _inputs(24)
    _, (tk, tv, tkw) = _caches(ck, cv, kind, False)
    vl = torch.tensor([5, 24, 11], dtype=torch.int32)
    none = att.mha_decode_step(torch.from_numpy(q), tk, tv, vl, **tkw)
    zero = att.mha_decode_step(torch.from_numpy(q), tk, tv, vl,
                               bias=torch.zeros(1, 4, 1, 24), **tkw)
    assert torch.equal(none, zero)


def test_the_biased_librarys_digest_follows_the_source_it_includes(
        tmp_path, monkeypatch):
    """K2's kernels with a bias build from ``decode_attention_bias.cu``,
    which includes ``decode_attention.cu``: an edit of the included source
    must give the biased library a new digest (a stale one never loads),
    and leave an unrelated source's alone."""
    import shutil

    from whisper_trtllm_tpu_torch.ops.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in (
        "decode_attention", "decode_attention_bias", "layer_norm")}
    with open(csrc / "decode_attention.cu", "a") as f:
        f.write("// an edit\n")
    after = {n: _build.library_path(n) for n in before}
    assert after["decode_attention"] != before["decode_attention"]
    assert after["decode_attention_bias"] != before["decode_attention_bias"]
    assert after["layer_norm"] == before["layer_norm"]
