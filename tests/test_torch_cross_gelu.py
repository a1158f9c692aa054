"""PyTorch port: the plain versions of K7 (``cross_decode_mha``) and K8
(the example's ``fused_bias_gelu``) against the Pallas kernels run in
interpret mode on the CPU, the wrappers' dispatch, and the example's
``main()``.

Tolerances: K7 fp32 atol 2e-5 rtol 1e-4 (the JAX package's own test of the
kernel; fp32 sums in another order), bf16 one bf16 step (1e-2: both round
the same fp32 result, which may differ in its last bits). K8 fp32 1e-5
(the Pallas kernel's erf is the Abramowitz-Stegun polynomial, good to
~1.5e-7; the port's is torch.erf), bf16 one bf16 step.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.custom_kernel import custom_gelu_kernel as jax_gelu
from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu.ops.pallas.cross_attention import (
    cross_decode_mha as jax_cross_decode_mha,
)
from whisper_trtllm_tpu_torch.ops.kernels import (
    KERNELS,
    cross_decode_mha,
    cross_decode_mha_reference,
    reset_launch_counts,
)

example = importlib.import_module(
    "whisper_trtllm_tpu_torch.examples.custom_kernel.custom_gelu_kernel")
B, H, T, DH = 2, 4, 24, 16


def _cross_inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H * DH)).astype(np.float32) * 0.3
    k = rng.standard_normal((B, T, H * DH)).astype(np.float32) * 0.3
    v = rng.standard_normal((B, T, H * DH)).astype(np.float32)
    return ([jnp.asarray(x, dtype) for x in (q, k, v)],
            [torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)])


@pytest.mark.parametrize("valid_len", [20, 1, T, 0, -2, T + 3])
def test_cross_decode_mha_plain_matches_pallas(valid_len):
    """0 and below mask every row: the uniform softmax, the mean of V."""
    (jq, jk, jv), (q, k, v) = _cross_inputs(valid_len + 10, "float32")
    want = np.asarray(jax_cross_decode_mha(jq, jk, jv, heads=H, head_dim=DH,
                                           valid_len=valid_len,
                                           interpret=True))
    got = cross_decode_mha(q, k, v, H, DH, valid_len)
    assert got.dtype == torch.float32 and got.shape == (B, H * DH)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)
    if valid_len <= 0:
        mean_v = v.reshape(B, T, H, DH).mean(dim=1).reshape(B, H * DH)
        np.testing.assert_allclose(got.numpy(), mean_v.numpy(), atol=2e-6)


def test_cross_decode_mha_plain_matches_pallas_in_bf16():
    (jq, jk, jv), (q, k, v) = _cross_inputs(3, "bfloat16")
    want = np.asarray(jax_cross_decode_mha(
        jq, jk, jv, heads=H, head_dim=DH, valid_len=20,
        interpret=True).astype(jnp.float32))
    got = cross_decode_mha(q, k, v, H, DH, 20)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                               rtol=1e-2)


@pytest.mark.parametrize("shape,dtype,tol", [
    ((256, 64), "float32", 1e-5),
    ((512, 384), "float32", 1e-5),
    ((256, 48), "bfloat16", 1e-2),
])
def test_fused_bias_gelu_plain_matches_pallas(shape, dtype, tol):
    rng = np.random.default_rng(shape[1])
    x = rng.standard_normal(shape).astype(np.float32) * 2
    bias = rng.standard_normal(shape[1]).astype(np.float32)
    want = np.asarray(jax_gelu.fused_bias_gelu(
        jnp.asarray(x, dtype), jnp.asarray(bias, dtype),
        interpret=True).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = example.fused_bias_gelu(torch.from_numpy(x).to(tdt),
                                  torch.from_numpy(bias).to(tdt))
    assert got.dtype == tdt and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_plain_versions_count_no_launches_and_take_any_row_count():
    reset_launch_counts()
    example.fused_bias_gelu.launches = 0
    (_, _, _), (q, k, v) = _cross_inputs(0, "float32")
    cross_decode_mha(q, k, v, H, DH, 5)
    out = example.fused_bias_gelu(torch.ones(3, 5), torch.zeros(5))
    assert out.shape == (3, 5)  # no 256-row tiles
    assert KERNELS["cross_decode_mha"] is cross_decode_mha
    assert cross_decode_mha.launches == 0
    assert example.fused_bias_gelu.launches == 0


def test_wrappers_never_take_the_plain_version_off_the_cpu():
    q = torch.empty(B, H * DH, device="meta")
    k = torch.empty(B, T, H * DH, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cross_decode_mha(q, k, k, H, DH, 3)
    with pytest.raises(ValueError, match="H\\*dh"):
        cross_decode_mha(q, k[..., :-1], k[..., :-1], H, DH, 3)
    with pytest.raises(TypeError, match="one dtype"):
        cross_decode_mha(q, k.half(), k.half(), H, DH, 3)
    with pytest.raises(ValueError, match="head_dim"):
        cross_decode_mha(torch.empty(1, 256, device="meta"),
                         torch.empty(1, 4, 256, device="meta"),
                         torch.empty(1, 4, 256, device="meta"), 1, 256, 3)
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        example.fused_bias_gelu(x, torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="bias"):
        example.fused_bias_gelu(x, torch.empty(7, device="meta"))
    with pytest.raises(TypeError, match="one dtype"):
        example.fused_bias_gelu(x, torch.empty(8, device="meta").bfloat16())


def test_example_main_runs_the_plain_version_with_cpu(capsys):
    assert example.main(["--cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and "launches=0" in out[0] and "cpu" in out[0]


def test_example_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
