"""PyTorch port: the functional op core and transformer blocks against the
JAX package, float and int8 forms, on inputs drawn from a seed.

Tolerances: 1e-6 for elementwise ops and gathers (same fp32 arithmetic),
1e-5 for ops with a dot product or a reduction (sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_trtllm_tpu.layers import transformer as jax_tf
from whisper_trtllm_tpu.ops import attention as jax_att
from whisper_trtllm_tpu.ops import functional as jax_fn
from whisper_trtllm_tpu.quantization.quantize import (
    quantize_dense_params,
    weight_only_quantize,
)
from whisper_trtllm_tpu_torch.layers import transformer as tf
from whisper_trtllm_tpu_torch.ops import attention as att
from whisper_trtllm_tpu_torch.ops import functional as fn
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(tree):
    return params_from_numpy(tree, "cpu")


def _np(x):
    return np.asarray(x)


def _dense_params(rng, din, dout, bias=True):
    p = {"kernel": (rng.standard_normal((din, dout)) * 0.2).astype(np.float32)}
    if bias:
        p["bias"] = rng.standard_normal(dout).astype(np.float32)
    return p


def test_gelu_matches_jax():
    x = _rng().standard_normal((4, 33)).astype(np.float32) * 3
    np.testing.assert_allclose(fn.gelu(torch.from_numpy(x)).numpy(),
                               _np(jax_fn.gelu(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("int8", [False, True])
def test_dense_matches_jax(int8, bias):
    rng = _rng(1)
    p = _dense_params(rng, 48, 40, bias)
    if int8:
        p = quantize_dense_params(p)
        assert p["kernel_q"].dtype == np.int8 and "kernel" not in p
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    ref = _np(jax_fn.dense(p, jnp.asarray(x)))
    out = fn.dense(_t(p), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = _rng(2)
    x = (rng.standard_normal((3, 7, 64)) * 2 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    if dtype == "bfloat16":
        ref = _np(jax_fn.layer_norm(p, jnp.asarray(x, jnp.bfloat16))
                  .astype(jnp.float32))
        out = fn.layer_norm(_t(p), torch.from_numpy(x).bfloat16())
        assert out.dtype == torch.bfloat16
        # both round the same fp32 result to bf16; allow one bf16 ulp
        np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2,
                                   rtol=1e-2)
    else:
        ref = _np(jax_fn.layer_norm(p, jnp.asarray(x)))
        out = fn.layer_norm(_t(p), torch.from_numpy(x))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
def test_embedding_matches_jax(int8):
    rng = _rng(3)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    if int8:
        scale = (np.abs(table).max(axis=1) / 127).astype(np.float32)
        table = {"table_q": np.round(table / scale[:, None]).astype(np.int8),
                 "scale": scale}
    ids = rng.integers(0, 50, (3, 4)).astype(np.int32)
    ref = _np(jax_fn.embedding(table, jnp.asarray(ids)))
    out = fn.embedding(_t(table), torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    out16 = fn.embedding(_t(table), torch.from_numpy(ids), dtype=torch.bfloat16)
    assert out16.dtype == torch.bfloat16


def test_sinusoid_position_embedding_equals_jax():
    np.testing.assert_array_equal(fn.sinusoid_position_embedding(1500, 384),
                                  jax_fn.sinusoid_position_embedding(1500, 384))


@pytest.mark.parametrize("stride", [1, 2])
def test_conv1d_matches_jax(stride):
    rng = _rng(4)
    p = {"kernel": (rng.standard_normal((3, 12, 20)) * 0.3).astype(np.float32),
         "bias": rng.standard_normal(20).astype(np.float32)}
    x = rng.standard_normal((2, 30, 12)).astype(np.float32)
    ref = _np(jax_fn.conv1d(p, jnp.asarray(x), stride=stride, padding=1))
    out = fn.conv1d(_t(p), torch.from_numpy(x), stride=stride, padding=1)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_split_and_merge_heads_equal_jax():
    x = _rng(5).standard_normal((2, 7, 24)).astype(np.float32)
    split = tf.split_heads(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(split.numpy(),
                                  _np(jax_tf.split_heads(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(tf.merge_heads(split).numpy(), x)


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_attention_qkv_matches_jax(cross, int8):
    rng = _rng(6)
    p = {n: _dense_params(rng, 32, 32, bias=n != "k") for n in ("q", "k", "v")}
    if int8:
        p = weight_only_quantize(p)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    kv = rng.standard_normal((2, 9, 32)).astype(np.float32) if cross else None
    ref = jax_tf.attention_qkv(p, jnp.asarray(x),
                               None if kv is None else jnp.asarray(kv), 4)
    out = tf.attention_qkv(_t(p), torch.from_numpy(x),
                           None if kv is None else torch.from_numpy(kv), 4)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), _np(r), atol=1e-5, rtol=1e-5)


def test_attention_qkv_refuses_fused_qkv():
    """A fused ``qkv`` tree serves self attention only, as in the JAX
    package: with ``kv_states`` (cross attention) both refuse it, and in
    self attention the port computes the JAX fused projection (1e-6)."""
    rng = _rng(12)
    p = {"qkv": _dense_params(rng, 16, 48), "out": _dense_params(rng, 16, 16)}
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 5, 16)).astype(np.float32)
    with pytest.raises(KeyError):
        jax_tf.attention_qkv(p, jnp.asarray(x), jnp.asarray(kv), 2)
    with pytest.raises(KeyError):
        tf.attention_qkv(params_from_numpy(p, "cpu"), torch.from_numpy(x),
                         torch.from_numpy(kv), 2)
    ref = jax_tf.attention_qkv(p, jnp.asarray(x), None, 2)
    out = tf.attention_qkv(params_from_numpy(p, "cpu"), torch.from_numpy(x),
                           None, 2)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), _np(r), atol=1e-6)


@pytest.mark.parametrize("int8", [False, True])
def test_mlp_block_matches_jax(int8):
    rng = _rng(7)
    p = {"fc1": _dense_params(rng, 32, 64), "fc2": _dense_params(rng, 64, 32)}
    if int8:
        p = weight_only_quantize(p)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    ref = _np(jax_tf.mlp_block(p, jnp.asarray(x)))
    out = tf.mlp_block(_t(p), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pos", [0, 5, 15])
def test_update_kv_cache_writes_in_place_like_jax(pos):
    rng = _rng(8)
    ck, cv = (rng.standard_normal((2, 3, 16, 8)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((2, 3, 1, 8)).astype(np.float32)
              for _ in range(2))
    rk, rv = jax_att.update_kv_cache(jnp.asarray(ck), jnp.asarray(cv),
                                     jnp.asarray(kn), jnp.asarray(vn),
                                     jnp.int32(pos))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    ok, ov = att.update_kv_cache(tk, tv, torch.from_numpy(kn),
                                 torch.from_numpy(vn), torch.tensor(pos))
    assert ok is tk and ov is tv  # written in place
    np.testing.assert_array_equal(tk.numpy(), _np(rk))
    np.testing.assert_array_equal(tv.numpy(), _np(rv))


def test_update_kv_cache_refuses_per_lane_positions():
    """Per-lane (B,) positions are taken now (the ragged step's writes,
    one row a lane, as JAX's vmapped ``dynamic_update_slice``); only a
    position tensor of more than one dimension is refused."""
    c = torch.zeros(2, 1, 4, 8)
    with pytest.raises(ValueError, match="scalar or"):
        att.update_kv_cache(c, c.clone(), torch.zeros(2, 1, 1, 8),
                            torch.zeros(2, 1, 1, 8), torch.zeros(2, 2))
    rng = _rng(9)
    ck, cv, kn, vn = (rng.standard_normal(shape).astype(np.float32)
                      for shape in ((2, 1, 4, 8),) * 2 + ((2, 1, 1, 8),) * 2)
    pos = np.asarray([3, 1], np.int32)
    rk, rv = jax_att.update_kv_cache(*map(jnp.asarray, (ck, cv, kn, vn)),
                                     jnp.asarray(pos))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    att.update_kv_cache(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                        torch.from_numpy(pos))
    np.testing.assert_array_equal(tk.numpy(), _np(rk))
    np.testing.assert_array_equal(tv.numpy(), _np(rv))


def test_init_kv_cache_shapes_and_zeros():
    k, v = att.init_kv_cache(2, 3, 16, 8, dtype=torch.bfloat16, device="cpu")
    jk, _ = jax_att.init_kv_cache(2, 3, 16, 8)
    assert tuple(k.shape) == jk.shape and k.dtype == torch.bfloat16
    assert not k.any() and not v.any()
