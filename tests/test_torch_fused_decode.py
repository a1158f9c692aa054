"""PyTorch port: the fused decoder-layer step (K6) and the float-weight
decode path against the JAX package, on the CPU.

- The plain K6 against the Pallas kernel in interpret mode, at the shapes
  of tests/test_pallas_kernels.py (b=2, d=64, 4 heads, ffn 128, ts=16,
  tc=2·CROSS_BLOCK), with its tolerance in fp32 (atol 3e-5, rtol 1e-4:
  sums in another order; the Pallas GELU's erf polynomial is within 1.5e-7
  of the exact erf) and 2e-2 of max(|x|, 1) in bf16 (one bf16 step of the
  output).
- ``_decode_step_fused`` (plain K6) against the JAX ``decode_step_kv`` on
  ``WhisperConfig.testing()``: logits 5e-5 / 1e-4, caches 1e-6.
- The gate ``_fused_decode_ok`` and the CPU routing of ``decode_step_kv``.
- ``fuse_qkv_params`` and the fused ``attention_qkv``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu import config as jax_config
from whisper_trtllm_tpu.layers.transformer import (
    attention_qkv as jax_attention_qkv,
)
from whisper_trtllm_tpu.models.whisper import init_params
from whisper_trtllm_tpu.models.whisper import model as jax_model
from whisper_trtllm_tpu.ops.pallas.fused_decoder_step import (
    CROSS_BLOCK,
    fused_decoder_layer_step as jax_fused_step,
)
from whisper_trtllm_tpu.quantization import weight_only_quantize
from whisper_trtllm_tpu_torch import config as torch_config
from whisper_trtllm_tpu_torch.layers.transformer import attention_qkv
from whisper_trtllm_tpu_torch.models.whisper import model
from whisper_trtllm_tpu_torch.ops.kernels import (
    fused_decoder_layer_step,
    fused_layer_supported,
)
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy


def _dense(rng, d_in, d_out, bias=True):
    p = {"kernel": (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)
                    ).astype(np.float32)}
    if bias:
        p["bias"] = (0.1 * rng.standard_normal(d_out)).astype(np.float32)
    return p


def _ln(rng, d):
    return {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}


def _layer(rng, d, ffn):
    """One decoder layer with non-trivial biases and LayerNorm parameters."""
    def attn():
        return {"q": _dense(rng, d, d), "k": _dense(rng, d, d, bias=False),
                "v": _dense(rng, d, d), "out": _dense(rng, d, d)}

    return {"self_attn_layer_norm": _ln(rng, d), "self_attn": attn(),
            "encoder_attn_layer_norm": _ln(rng, d), "encoder_attn": attn(),
            "final_layer_norm": _ln(rng, d),
            "fc1": _dense(rng, d, ffn), "fc2": _dense(rng, ffn, d)}


def _jax_tree(tree, dtype):
    return {k: _jax_tree(v, dtype) if isinstance(v, dict)
            else jnp.asarray(v, dtype) for k, v in tree.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos,enc_frac", [(0, 0.97), (5, 1.0), (14, 0.5)])
def test_plain_fused_step_matches_pallas(pos, enc_frac, dtype):
    b, d, heads, ffn, ts = 2, 64, 4, 128, 16
    tc = 2 * CROSS_BLOCK
    dh = d // heads
    enc_len = max(1, int(tc * enc_frac))
    rng = np.random.default_rng(pos)
    lp = _layer(rng, d, ffn)
    x = rng.standard_normal((b, d)).astype(np.float32)
    h1 = rng.standard_normal((b, d)).astype(np.float32)
    caches = [rng.standard_normal((b, heads, t, dh)).astype(np.float32) * s
              for t, s in ((ts, 0.3), (ts, 1.0), (tc, 0.3), (tc, 1.0))]
    jdt = jnp.dtype(dtype)
    ref = jax_fused_step(
        jnp.asarray(x, jdt), jnp.asarray(h1, jdt), jnp.int32(pos),
        _jax_tree(lp, jdt), *(jnp.asarray(c, jdt) for c in caches), enc_len,
        interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    out = fused_decoder_layer_step(
        torch.from_numpy(x).to(tdt), torch.from_numpy(h1).to(tdt),
        torch.tensor(pos, dtype=torch.int32), params_from_numpy(lp, "cpu", tdt),
        *(torch.from_numpy(c).to(tdt) for c in caches), enc_len)
    assert out.dtype == tdt and tuple(out.shape) == (b, d)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, atol=3e-5, rtol=1e-4)
    else:
        err = np.abs(out.float().numpy() - ref) / np.maximum(np.abs(ref), 1)
        assert err.max() <= 2e-2


def _configs():
    jcfg = jax_config.WhisperConfig.testing()
    return jcfg, torch_config.WhisperConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("pos", [0, 3, 9])
def test_decode_step_fused_matches_jax_decode_step(pos):
    """The fused layer loop (plain K6 on the CPU) against the JAX XLA
    path, after ``pos`` earlier steps have filled the self cache."""
    jcfg, cfg = _configs()
    ref_p = init_params(jcfg, seed=0)
    p = params_from_numpy(ref_p, "cpu")
    b, max_len = 2, 16
    rng = np.random.default_rng(pos)
    enc = rng.standard_normal((b, jcfg.max_source_positions, jcfg.d_model)
                              ).astype(np.float32)
    ref_cross = jax_model.compute_cross_kv(ref_p, jcfg, jnp.asarray(enc))
    cross = model.compute_cross_kv(p, cfg, torch.from_numpy(enc))
    sk, sv = (rng.standard_normal((jcfg.decoder_layers, b, 4, max_len, 8))
              .astype(np.float32) for _ in range(2))
    toks = rng.integers(0, jcfg.vocab_size, (b,))
    ref_logits, ref_self = jax_model.decode_step_kv(
        ref_p, jcfg, jnp.asarray(toks, jnp.int32), jnp.int32(pos),
        (jnp.asarray(sk), jnp.asarray(sv)), ref_cross)
    dec = p["decoder"]
    tok = torch.from_numpy(toks)
    x = model.embedding(dec["embed_tokens"], tok[:, None])
    x = x + dec["embed_positions"][pos][None, None]
    self_kv = (torch.from_numpy(sk.copy()), torch.from_numpy(sv.copy()))
    logits, out_self = model._decode_step_fused(
        dec, cfg, x, torch.tensor(pos, dtype=torch.int32), self_kv, cross)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=5e-5, rtol=1e-4)
    for got, ref in zip(out_self, ref_self):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def _gate_inputs(**tree_kw):
    jcfg, cfg = _configs()
    ref = init_params(jcfg, seed=1)
    if tree_kw.get("int8"):
        ref = weight_only_quantize(ref)
    p = params_from_numpy(ref, "cpu")
    if tree_kw.get("fused"):
        p = params_from_numpy(model.fuse_qkv_params(p), "cpu")
    self_k = torch.zeros(jcfg.decoder_layers, 2, 4, 16, 8)
    cross_k = torch.zeros(jcfg.decoder_layers, 2, 4, 24, 8)
    return cfg, p["decoder"], self_k, cross_k


def test_fused_gate_routes_by_device_and_tree(monkeypatch):
    cfg, dec, sk, ck = _gate_inputs()
    pos = torch.tensor(3, dtype=torch.int32)
    # the CPU never takes the fused step
    assert not model._fused_decode_ok(dec, sk, ck, pos)
    monkeypatch.setattr(model, "fused_decode_enabled", lambda device: True)
    monkeypatch.setattr(model, "fused_layer_supported", lambda *a: True)
    assert model._fused_decode_ok(dec, sk, ck, pos)
    assert not model._fused_decode_ok(dec, sk, ck, torch.zeros(2, dtype=torch.int32))
    assert not model._fused_decode_ok(dec, sk.bfloat16(), ck.bfloat16(), pos)
    for kw in (dict(int8=True), dict(fused=True)):
        _, dec2, _, _ = _gate_inputs(**kw)
        assert not model._fused_decode_ok(dec2, sk, ck, pos)
    # the kernel's own shape limits refuse the toy widths (d=32)
    monkeypatch.setattr(model, "fused_layer_supported", fused_layer_supported)
    assert not model._fused_decode_ok(dec, sk, ck, pos)


def test_decode_step_kv_takes_the_fused_step_only_where_the_gate_allows(
        monkeypatch):
    """Forced on, a float step goes through K6; quantized caches and the
    T-minor layout keep the unfused layer, as in the JAX package."""
    jcfg, cfg = _configs()
    p = params_from_numpy(init_params(jcfg, seed=2), "cpu")
    enc = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, jcfg.max_source_positions, jcfg.d_model)).astype(np.float32))
    ck, cv = model.compute_cross_kv(p, cfg, enc)
    calls = []

    def counting(*args):
        calls.append(1)
        return fused_decoder_layer_step(*args)

    toks = torch.tensor([5, 9])
    ref, _ = model.decode_step_kv(p, cfg, toks, 0,
                                  model.init_self_kv(cfg, 2, 8, device="cpu"),
                                  (ck, cv))
    assert calls == []
    monkeypatch.setattr(model, "fused_decode_enabled", lambda device: True)
    monkeypatch.setattr(model, "fused_layer_supported", lambda *a: True)
    monkeypatch.setattr(model, "fused_decoder_layer_step", counting)
    out, _ = model.decode_step_kv(p, cfg, toks, 0,
                                  model.init_self_kv(cfg, 2, 8, device="cpu"),
                                  (ck, cv))
    assert len(calls) == cfg.decoder_layers
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=5e-5, rtol=1e-4)
    calls.clear()
    quant = model.quantize_cross_kv(ck, cv)
    model.decode_step_kv(p, cfg, toks, 0,
                         model.init_self_kv_int8(cfg, 2, 8, device="cpu"), quant)
    model.decode_step_kv(p, cfg, toks, 0,
                         model.init_self_kv(cfg, 2, 8, device="cpu"),
                         model.transpose_cross_kv((ck, cv)))
    assert calls == []


def test_fused_layer_supported_states_the_h100_limits():
    tiny = dict(b=4, h=6, ts=33, dh=64, tc=1504, d=384, ffn=1536)
    medium = dict(b=4, h=16, ts=33, dh=64, tc=1504, d=1024, ffn=4096)
    for shape in (tiny, medium):
        for itemsize in (4, 2):
            assert fused_layer_supported(**shape, itemsize=itemsize)
    assert fused_layer_supported(**{**tiny, "b": 16}, itemsize=4)
    assert fused_layer_supported(**{**tiny, "tc": 1500}, itemsize=4)
    refused = [dict(b=17), dict(dh=32, h=12), dict(dh=48, h=8),
               dict(dh=128, h=3), dict(d=320), dict(ffn=1500),
               dict(h=40, d=2560, ffn=10240)]
    for change in refused:
        assert not fused_layer_supported(**{**tiny, **change}, itemsize=4)
    assert not fused_layer_supported(**tiny, itemsize=1)


def test_k6_launch_checks_keep_the_kernel_inside_its_tensors():
    """The checks the wrapper makes before every launch (device-agnostic,
    so they run here on CPU tensors): a consistent set passes; another
    dtype, a non-contiguous cache, a wrong weight shape, a pos that is not
    0-d int32 and a misaligned cache are refused."""
    from whisper_trtllm_tpu_torch.ops.kernels import fused_decoder_step as k6

    rng = np.random.default_rng(11)
    b, d, heads, ffn = 2, 128, 2, 256
    lp = params_from_numpy(_layer(rng, d, ffn), "cpu")
    x, h1 = torch.zeros(b, d), torch.zeros(b, d)
    caches = [torch.zeros(b, heads, t, d // heads) for t in (8, 8, 40, 40)]
    pos = torch.tensor(3, dtype=torch.int32)
    el = torch.tensor(40, dtype=torch.int32)
    blocks = k6._blocks(lp)
    k6._check(x, h1, pos, el, blocks, caches)
    with pytest.raises(TypeError, match="one dtype"):
        k6._check(x, h1.bfloat16(), pos, el, blocks, caches)
    with pytest.raises(ValueError, match="contiguous"):
        k6._check(x, h1, pos, el, blocks, [
            caches[0], caches[1].transpose(2, 3).contiguous().transpose(2, 3),
            *caches[2:]])
    bad = k6._blocks({**lp, "fc2": {"kernel": torch.zeros(ffn, d + 64)}})
    with pytest.raises(ValueError, match="weight of shape"):
        k6._check(x, h1, pos, el, bad, caches)
    with pytest.raises(TypeError, match="0-d int32"):
        k6._check(x, h1, pos.long(), el, blocks, caches)
    with pytest.raises(ValueError, match="aligned"):
        shifted = torch.zeros(b * heads * 8 * 64 + 1)[1:].view(b, heads, 8, 64)
        k6._check(x, h1, pos, el, blocks, [shifted, *caches[1:]])
    # the workspace: four (B, d) rows, each (b, head)'s cross splits (on
    # 132 SMs, 40 rows make 40 splits of one row) and an fc2 partial for
    # each of the 32 MLP groups of 8 columns
    assert k6.fused_plan(b, heads, 40, d, ffn, 132) == (40, 1, 8, 8)
    assert k6._workspace_floats(b, heads, 40, 64, d, ffn, 132) == (
        4 * b * d + b * heads * 40 * 66 + 32 * b * d)


def test_fuse_qkv_params_equals_jax():
    jcfg, _ = _configs()
    ref = init_params(jcfg, seed=5)
    ref_fused = jax_model.fuse_qkv_params(ref)
    fused = model.fuse_qkv_params(params_from_numpy(ref, "cpu"))
    for side in ("encoder", "decoder"):
        got = fused[side]["layers"]["self_attn"]
        want = ref_fused[side]["layers"]["self_attn"]
        assert set(got) == set(want) == {"qkv", "out"}
        for key in ("kernel", "bias"):
            np.testing.assert_array_equal(np.asarray(got["qkv"][key]),
                                          np.asarray(want["qkv"][key]))
        assert got["out"] is fused[side]["layers"]["self_attn"]["out"]
    # cross attention stays split and shared
    assert "k" in fused["decoder"]["layers"]["encoder_attn"]


def test_fused_attention_qkv_matches_jax():
    jcfg, _ = _configs()
    attn = jax_model.fuse_qkv_params(init_params(jcfg, seed=6))
    attn = attn["encoder"]["layers"]["self_attn"]
    attn = {k: {n: np.asarray(a)[0] for n, a in v.items()}
            for k, v in attn.items()}
    x = np.random.default_rng(7).standard_normal((2, 5, jcfg.d_model)
                                                 ).astype(np.float32)
    ref = jax_attention_qkv(_jax_tree(attn, jnp.float32), jnp.asarray(x),
                            None, 4)
    out = attention_qkv(params_from_numpy(attn, "cpu"), torch.from_numpy(x),
                        None, 4)
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
