"""PyTorch port: the causal-LM zoo's ops of ``ops/functional.py`` (the
activation table, ``rms_norm``, ``softmax_fp32``,
``gather_last_token_logits``, ``prompt_tuning_embedding``) against the JAX
package's on the same numpy inputs, within 1e-6 (gathers exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu.ops import functional as jf
from whisper_trtllm_tpu_torch.ops import functional as tf

TOL = 1e-6


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


@pytest.mark.parametrize("name", ["gelu", "gelu_new", "gelu_pytorch_tanh",
                                  "relu", "silu", "swish", "tanh", "mish"])
def test_activations_match_jax(name):
    x = np.random.default_rng(0).standard_normal((4, 37)).astype(np.float32) * 3
    _close(tf.ACT2FN[name](torch.from_numpy(x)), jf.ACT2FN[name](jnp.asarray(x)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    got = tf.rms_norm({"scale": torch.from_numpy(scale)},
                      torch.from_numpy(x).to(getattr(torch, dtype)), 1e-6)
    want = jf.rms_norm({"scale": jnp.asarray(scale)},
                       jnp.asarray(x).astype(dtype), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    # bf16 outputs: the same fp32 value rounded once in both
    _close(got.float(), np.asarray(want.astype(jnp.float32)),
           TOL if dtype == "float32" else 0.0)


@pytest.mark.parametrize("out_dtype", [None, "float32"])
def test_softmax_fp32_matches_jax(out_dtype):
    x = np.random.default_rng(2).standard_normal((3, 4, 19)).astype(
        np.float32) * 5
    got = tf.softmax_fp32(torch.from_numpy(x).bfloat16(),
                          getattr(torch, out_dtype) if out_dtype else None)
    want = jf.softmax_fp32(jnp.asarray(x).astype(jnp.bfloat16),
                           getattr(jnp, out_dtype) if out_dtype else None)
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    _close(got.float(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("lengths", [[3, 1, 7], [0, 9, 7]])
def test_gather_last_token_logits_matches_jax(lengths):
    x = np.random.default_rng(3).standard_normal((3, 7, 5)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    got = tf.gather_last_token_logits(torch.from_numpy(x),
                                      torch.from_numpy(lens))
    want = jf.gather_last_token_logits(jnp.asarray(x), jnp.asarray(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tasks", [None, [1, 0]])
def test_prompt_tuning_embedding_matches_jax(tasks):
    rng = np.random.default_rng(4)
    vocab, d = 11, 6
    table = rng.standard_normal((vocab, d)).astype(np.float32)
    if tasks is None:
        prompt_table = rng.standard_normal((4, d)).astype(np.float32)
    else:
        prompt_table = rng.standard_normal((2, 4, d)).astype(np.float32)
    # real ids, virtual ids, and one past the table (clamped)
    ids = np.asarray([[1, 11, 12, 3, 20], [14, 2, 11, 10, 13]], np.int32)
    got = tf.prompt_tuning_embedding(
        torch.from_numpy(table), torch.from_numpy(prompt_table),
        torch.from_numpy(ids),
        None if tasks is None else torch.tensor(tasks))
    want = jf.prompt_tuning_embedding(
        jnp.asarray(table), jnp.asarray(prompt_table), jnp.asarray(ids),
        None if tasks is None else jnp.asarray(tasks, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
