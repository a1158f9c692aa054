"""PyTorch port: the flash-attention backward (K4) and the autograd paths
of K1 and K5 on the CPU, against the JAX package.

- ``flash_attention_backward_reference`` (K4's plain version) against the
  Pallas ``_bwd_impl`` in interpret mode and ``jax.vjp`` of ``flash_mha``
  in interpret mode: GQA, T not a multiple of 8, S not a multiple of the
  Pallas q-block (128), causal S == T. atol 2e-5, rtol 1e-4: fp32 sums in
  another order (the JAX package's own flash tolerance).
- The ``FlashAttention`` function against torch autograd of
  ``attention_reference`` (1e-5), and K1's log-sum-exp's plain version.
- The ``LayerNorm`` function's backward against ``jax.vjp`` of the JAX
  package's ``layer_norm`` (1e-5 relative to the largest gradient).
- ``mha``'s dispatch: the JAX package's conditions, by spies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu.ops import functional as jax_fn
from whisper_trtllm_tpu.ops.pallas.flash_attention import _bwd_impl, flash_mha
from whisper_trtllm_tpu_torch.ops import attention as att
from whisper_trtllm_tpu_torch.ops import functional as fn
from whisper_trtllm_tpu_torch.ops.kernels import (
    FlashAttention,
    _build,
    attention_lse_reference,
    attention_reference,
    flash_attention,
    flash_attention_backward_reference,
    flash_bwd,
    flash_fwd,
)

# (B, H, Hkv, S, T, dh, causal)
CASES = [
    pytest.param(1, 4, 2, 40, 40, 16, False, id="gqa"),
    pytest.param(1, 2, 2, 24, 70, 16, False, id="T70-not-mult-8"),
    pytest.param(2, 2, 1, 130, 37, 8, False, id="S130-ragged-qblock-mqa"),
    pytest.param(1, 2, 2, 130, 130, 16, True, id="causal-S130"),
]


def _inputs(seed, b, h, hkv, s, t, dh):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, dh)).astype(np.float32) * 0.3
    k = rng.standard_normal((b, hkv, t, dh)).astype(np.float32) * 0.3
    v = rng.standard_normal((b, hkv, t, dh)).astype(np.float32)
    do = rng.standard_normal((b, h, s, dh)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("b,h,hkv,s,t,dh,causal", CASES)
def test_plain_backward_matches_pallas_bwd_kernel(b, h, hkv, s, t, dh,
                                                  causal):
    q, k, v, do = _inputs(s + t, b, h, hkv, s, t, dh)
    ref = _bwd_impl(*(jnp.asarray(x) for x in (q, k, v, do)),
                    interpret=True, causal=causal)
    got = flash_attention_backward_reference(
        *(torch.from_numpy(x) for x in (q, k, v, do)), causal=causal)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("b,h,hkv,s,t,dh,causal", CASES)
def test_autograd_function_matches_jax_vjp_of_flash_mha(b, h, hkv, s, t, dh,
                                                        causal):
    q, k, v, do = _inputs(2 * s + t, b, h, hkv, s, t, dh)
    out_j, vjp = jax.vjp(
        lambda q, k, v: flash_mha(q, k, v, interpret=True, causal=causal),
        *(jnp.asarray(x) for x in (q, k, v)))
    ref = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = FlashAttention.apply(qt, kt, vt, causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=2e-5, rtol=1e-4)
    out.backward(torch.from_numpy(do))
    for g, r in zip((qt.grad, kt.grad, vt.grad), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_function_matches_torch_autograd_of_the_plain_forward(causal):
    q, k, v, do = _inputs(3, 2, 6, 3, 33, 33, 16)
    grads = []
    for use_fn in (True, False):
        qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                      for x in (q, k, v))
        out = (flash_attention(qt, kt, vt, causal=causal) if use_fn
               else attention_reference(qt, kt, vt, causal=causal))
        assert (out.grad_fn.name().startswith("FlashAttention")) == use_fn
        out.backward(torch.from_numpy(do))
        grads.append((qt.grad, kt.grad, vt.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def test_flash_bwd_cpu_takes_the_plain_version_and_counts_nothing():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(4, 1, 2, 2, 9, 9, 8))
    before = flash_bwd.launches
    dq, dk, dv = flash_bwd(q, k, v, None, do, causal=True)
    ref = flash_attention_backward_reference(q, k, v, do, causal=True)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), ref))
    assert flash_bwd.launches == before


def test_plain_backward_keeps_dtypes_in_bf16():
    q, k, v, do = (torch.from_numpy(x).bfloat16()
                   for x in _inputs(5, 1, 4, 2, 10, 12, 8))
    dq, dk, dv = flash_attention_backward_reference(q, k, v, do)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert tuple(dk.shape) == (1, 2, 12, 8)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_reference_is_the_masked_log_sum_exp(causal):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(6, 1, 4, 2, 20, 20, 8))
    out, lse = flash_fwd(q, k, v, causal=causal, with_lse=True)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (1, 4, 20)
    scores = torch.matmul(q, k.repeat_interleave(2, dim=1).transpose(-1, -2))
    if causal:
        scores = scores.masked_fill(torch.ones(20, 20).triu(1).bool(), -1e9)
    p = torch.exp(scores - lse[..., None])
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(
        torch.matmul(p, v.repeat_interleave(2, dim=1)).numpy(), out.numpy(),
        atol=1e-6)
    assert torch.equal(lse, attention_lse_reference(q, k, causal))


@pytest.mark.parametrize("with_bias", [True, False])
def test_layer_norm_function_backward_matches_jax_vjp(with_bias):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 5, 48)) * 2 + 0.5).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)}
    if with_bias:
        p["bias"] = (0.1 * rng.standard_normal(48)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    y_j, vjp = jax.vjp(lambda p, x: jax_fn.layer_norm(p, x),
                       jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    gp_j, gx_j = vjp(jnp.asarray(dy))
    pt = {k: torch.from_numpy(a).requires_grad_(True) for k, a in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fn.layer_norm(pt, xt)
    assert y.grad_fn.name().startswith("LayerNorm")
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=1e-5)
    y.backward(torch.from_numpy(dy))
    pairs = [(xt.grad, gx_j)] + [(pt[k].grad, gp_j[k]) for k in p]
    for g, r in pairs:
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=1e-5 * np.abs(r).max(), rtol=0)


def test_needs_grad_and_refuse_grad():
    a = torch.zeros(2, requires_grad=True)
    b = torch.zeros(2)
    assert _build.needs_grad(b, None, a)
    assert not _build.needs_grad(b, None)
    with torch.no_grad():
        assert not _build.needs_grad(a)
        _build.refuse_grad("k", a)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("k", b, a)


def _spy(monkeypatch):
    calls = []
    real_flash, real_plain = att.flash_attention, att.attention_reference

    def flash(*a, **kw):
        calls.append("flash")
        return real_flash(*a, **kw)

    def plain(*a, **kw):
        calls.append("plain")
        return real_plain(*a, **kw)

    monkeypatch.setattr(att, "flash_attention", flash)
    monkeypatch.setattr(att, "attention_reference", plain)
    return calls


@pytest.mark.parametrize("s,t,hkv,dh,kw,route", [
    (32, 48, 2, 16, {}, "flash"),                         # cross, bidirectional
    (16, 16, 4, 16, {"causal": True}, "plain"),           # causal, S < 768
    (768, 768, 1, 8, {"causal": True}, "flash"),          # causal, S >= 768
    (800, 900, 4, 8, {"causal": True}, "plain"),          # causal, S != T
    (32, 48, 4, 16, {"use_flash": False}, "plain"),       # pinned plain
    (32, 48, 4, 16, {"mask": "zeros"}, "plain"),          # masked
    (1, 48, 4, 16, {}, "plain"),                          # one row
    (32, 48, 4, 12, {}, "plain"),                         # dh % 8 != 0
])
def test_mha_dispatch_is_the_jax_packages(monkeypatch, s, t, hkv, dh, kw,
                                          route):
    calls = _spy(monkeypatch)
    rng = np.random.default_rng(s)
    q = torch.from_numpy(rng.standard_normal((1, 4, s, dh)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, hkv, t, dh)).astype(np.float32))
    if kw.get("mask") == "zeros":
        kw = {"mask": torch.zeros(1, 1, s, t)}
    out = att.mha(q, k, k, **kw)
    assert calls == [route]
    ref = attention_reference(q, k, k, causal=kw.get("causal", False))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)
