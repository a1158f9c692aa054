"""PyTorch port: kernels K1 (flash attention forward), K2 (decode
attention, float and int8/fp8 caches, both layouts), K3 (STFT log-mel) and
K5 (LayerNorm); K6 (the fused decoder-layer step) is held to its Pallas
kernel in tests/test_torch_fused_decode.py.

On the CPU the wrappers take their plain versions, which are held here to
the Pallas kernels run in interpret mode, at the shapes of
tests/test_pallas_kernels.py, with that file's tolerances (atol 2e-5,
rtol 1e-4 in fp32: the kernels sum in another order; 3e-2 in bf16; 2e-4
on the log10 values of K3; 1e-5 for K5). The dispatching ops (``mha``,
``mha_decode_step``, ``quantize_kv``) are held to the JAX ops. The kernels
themselves are held to their plain versions on the card by
tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu.audio.features import (
    LogMelSpectrogram as JaxLogMelSpectrogram,
)
from whisper_trtllm_tpu.ops import attention as jax_att
from whisper_trtllm_tpu.ops.pallas.decode_attention import decode_mha
from whisper_trtllm_tpu.ops.pallas.flash_attention import flash_mha
from whisper_trtllm_tpu.ops.pallas.layer_norm import layer_norm_fused
from whisper_trtllm_tpu.ops.pallas.stft import stft_log_mel as jax_stft_log_mel
from whisper_trtllm_tpu_torch.ops import attention as att
from whisper_trtllm_tpu_torch.ops.kernels import (
    KERNELS,
    decode_attn,
    flash_bwd,
    flash_fwd,
    fused_decoder_layer_step,
    layer_norm,
    reset_launch_counts,
    stft_log_mel,
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_head_dim_256_matches_pallas(causal, dtype):
    """GPT-J's head width, which K1 takes up to 256."""
    q, k, v = _qkv(14, 1, 2, 2, 256, 256, 256)
    jdt = getattr(jnp, dtype)
    ref = np.asarray(flash_mha(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                               causal=causal, interpret=True).astype(
                                   jnp.float32))
    out = flash_fwd(*(x.to(getattr(torch, dtype)) for x in _torch(q, k, v)),
                    causal=causal)
    tol = FP32_TOL if dtype == "float32" else dict(atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid_len", [1, 200, 320])
def test_decode_plain_head_dim_256_matches_pallas(valid_len, dtype):
    """GPT-J's head width, which K2 takes up to 256."""
    q, ck, cv = _decode_inputs(15, b=2, h=2, t=320, dh=256)
    jdt = getattr(jnp, dtype)
    ref = np.asarray(decode_mha(*(jnp.asarray(x, jdt) for x in (q, ck, cv)),
                                jnp.int32(valid_len), interpret=True).astype(
                                    jnp.float32))
    out = decode_attn(*(x.to(getattr(torch, dtype))
                        for x in _torch(q, ck, cv)),
                      torch.tensor(valid_len, dtype=torch.int32))
    tol = FP32_TOL if dtype == "float32" else dict(atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)


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


_QUANT = {"int8": (jnp.int8, torch.int8),
          "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantize_kv_matches_jax(kind):
    x = np.random.default_rng(10).standard_normal((2, 3, 9, 16)).astype(
        np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 scale floor
    jdt, tdt = _QUANT[kind]
    rq, rs = jax_att.quantize_kv(jnp.asarray(x), jdt)
    q, s = att.quantize_kv(torch.from_numpy(x), tdt)
    assert q.dtype == tdt and s.dtype == torch.float32
    np.testing.assert_array_equal(q.float().numpy(),
                                  np.asarray(rq.astype(jnp.float32)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        att.dequantize_kv(q, s).numpy(),
        np.asarray(jax_att.dequantize_kv(rq, rs)))


def _quant_cache(x, kind):
    jq, js = jax_att.quantize_kv(jnp.asarray(x), _QUANT[kind][0])
    tq, ts = att.quantize_kv(torch.from_numpy(x), _QUANT[kind][1])
    return (jq, js), (tq, ts)


@pytest.mark.parametrize("valid_len", [9, 0, "per_lane"])
@pytest.mark.parametrize("t_major", [False, True], ids=["bhtd", "bhdt"])
@pytest.mark.parametrize("kind", ["float", "int8", "fp8"])
def test_mha_decode_step_cache_kinds_match_jax(kind, t_major, valid_len):
    """Quantized caches (scales folded into scores and weights), the
    T-minor layout and per-lane valid_len, each against the JAX op at
    fp32: 1e-5."""
    q, ck, cv = _decode_inputs(8, b=3, t=24, dh=16)
    vl = (np.array([3, 24, 0], np.int32) if valid_len == "per_lane"
          else np.int32(valid_len))
    if kind == "float":
        jk, jv, jkw = jnp.asarray(ck), jnp.asarray(cv), {}
        tk, tv, tkw = torch.from_numpy(ck), torch.from_numpy(cv), {}
    else:
        (jk, jks), (tk, tks) = _quant_cache(ck, kind)
        (jv, jvs), (tv, tvs) = _quant_cache(cv, kind)
        jkw = dict(k_scale=jks, v_scale=jvs)
        tkw = dict(k_scale=tks, v_scale=tvs)
    if t_major:
        jk, jv = jnp.swapaxes(jk, -1, -2), jnp.swapaxes(jv, -1, -2)
        tk, tv = tk.transpose(-1, -2), tv.transpose(-1, -2)
    ref = np.asarray(jax_att.mha_decode_step(
        jnp.asarray(q), jk, jv, jnp.asarray(vl), t_major=t_major, **jkw))
    out = att.mha_decode_step(torch.from_numpy(q), tk, tv,
                              torch.from_numpy(np.asarray(vl)),
                              t_major=t_major, **tkw)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_mha_decode_step_bf16_quantized_matches_jax(kind):
    """bf16 q with a quantized cache: weights × v_scale cast to bf16 before
    P·V in both; 3e-2 (bf16 output)."""
    q, ck, cv = _decode_inputs(11, b=2, t=24, dh=16)
    (jk, jks), (tk, tks) = _quant_cache(ck, kind)
    (jv, jvs), (tv, tvs) = _quant_cache(cv, kind)
    ref = np.asarray(jax_att.mha_decode_step(
        jnp.asarray(q, jnp.bfloat16), jk, jv, jnp.int32(17), k_scale=jks,
        v_scale=jvs).astype(jnp.float32))
    out = att.mha_decode_step(torch.from_numpy(q).bfloat16(), tk, tv, 17,
                              k_scale=tks, v_scale=tvs)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("kw", [
    {"bias": torch.zeros(2, 4, 1, 16, dtype=torch.bfloat16)},
    {"bias": torch.zeros(2, 4, 1, 15)},
])
def test_mha_decode_step_refuses_later_slices(kw):
    """A bias K2 does not take (not fp32, or not broadcastable to
    (B, H, 1, T) with T whole): the card's check raises, as a CUDA call of
    ``mha_decode_step`` would; the CPU's plain version takes any bias that
    broadcasts."""
    from whisper_trtllm_tpu_torch.ops.kernels import decode_attention

    q, ck, cv = _torch(*_decode_inputs(8))
    vl = torch.tensor(5, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        decode_attention._check(q, ck, cv, vl, None, None, False, **kw)


# --------------------------------------------------------------------------
# K3 — plain version vs stft_log_mel in interpret mode
# --------------------------------------------------------------------------

def test_stft_plain_matches_pallas():
    fe = JaxLogMelSpectrogram(80)
    basis, mel_fb = np.array(fe.dft_basis), np.array(fe.mel_fb)
    blocks = np.random.default_rng(12).standard_normal(
        (2, 302, 160)).astype(np.float32) * 0.1
    ref = np.asarray(jax_stft_log_mel(jnp.asarray(blocks), fe.dft_basis,
                                      fe.mel_fb, interpret=True))
    out = stft_log_mel(*_torch(blocks, basis, mel_fb))
    assert tuple(out.shape) == ref.shape == (2, 300, 80)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=2e-4)
    # the frontend's 400 non-zero taps give the same frames
    taps = stft_log_mel(*_torch(blocks, basis[:400].copy(), mel_fb))
    np.testing.assert_allclose(taps.numpy(), ref, atol=2e-4, rtol=2e-4)


# --------------------------------------------------------------------------
# K5 — plain version vs layer_norm_fused in interpret mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_bias", [True, False])
def test_layer_norm_plain_matches_pallas(with_bias):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 100, 64)).astype(np.float32) * 2 + 0.5
    scale = rng.standard_normal(64).astype(np.float32)
    bias = (rng.standard_normal(64) if with_bias else np.zeros(64)).astype(
        np.float32)
    ref = np.asarray(layer_norm_fused(jnp.asarray(x), jnp.asarray(scale),
                                      jnp.asarray(bias), interpret=True))
    out = layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                     torch.from_numpy(bias) if with_bias else None)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", [4096, 6144, 12288])
def test_layer_norm_plain_wide_matches_pallas(d):
    """The zoo's widths (GPT-J, GPT-NeoX, gpt_175b), which K5 takes up to
    16384."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((8, d)).astype(np.float32) * 2 + 0.5
    scale = rng.standard_normal(d).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    ref = np.asarray(layer_norm_fused(jnp.asarray(x), jnp.asarray(scale),
                                      jnp.asarray(bias), interpret=True))
    out = layer_norm(*_torch(x, scale, bias))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# wrappers: plain version for CPU tensors only, launches counted on the card
# --------------------------------------------------------------------------

def test_plain_versions_do_not_count_launches():
    reset_launch_counts()
    q, k, v = _torch(*_qkv(9, 1, 2, 2, 16, 16, 8))
    flash_fwd(q, k, v)
    flash_bwd(q, k, v, None, q, causal=True)
    decode_attn(q[:, :, :1], k, v, torch.tensor(3, dtype=torch.int32))
    kq, ks = att.quantize_kv(k)
    decode_attn(q[:, :, :1], kq.transpose(-1, -2), kq.transpose(-1, -2),
                torch.tensor([3], dtype=torch.int32), ks, ks, t_major=True)
    stft_log_mel(torch.zeros(1, 5, 4), torch.zeros(12, 6), torch.zeros(3, 2))
    layer_norm(q, torch.ones(8))
    x = torch.zeros(1, 64)
    dense = {"kernel": torch.zeros(64, 64), "bias": torch.zeros(64)}
    norm = {"scale": torch.ones(64), "bias": torch.zeros(64)}
    lp = {"self_attn": {"q": dense, "out": dense},
          "encoder_attn": {"q": dense, "out": dense},
          "encoder_attn_layer_norm": norm, "final_layer_norm": norm,
          "fc1": dense, "fc2": dense}
    cache = torch.zeros(1, 2, 8, 32)
    fused_decoder_layer_step(x, x, torch.tensor(3, dtype=torch.int32), lp,
                             cache, cache, cache, cache, 8)
    kv = torch.zeros(1, 8, 64)
    KERNELS["cross_decode_mha"](x, kv, kv, 2, 32, 5)
    assert {n: f.launches for n, f in KERNELS.items()} == {
        "flash_fwd": 0, "flash_bwd": 0, "decode_attn": 0, "stft_log_mel": 0,
        "layer_norm": 0, "fused_decoder_layer_step": 0,
        "cross_decode_mha": 0}


def test_wrappers_never_take_the_plain_version_off_the_cpu():
    q, k, v = (torch.empty(1, 2, 16, 8, device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="unsupported device"):
        flash_fwd(q, k, v)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attn(torch.empty(1, 2, 1, 8, device="meta"), k, v,
                    torch.empty((), dtype=torch.int32, device="meta"))
    kq = torch.empty(1, 2, 8, 16, dtype=torch.int8, device="meta")
    ks = torch.empty(1, 2, 16, 1, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attn(torch.empty(1, 2, 1, 8, device="meta"), kq, kq,
                    torch.empty(1, dtype=torch.int32, device="meta"), ks, ks,
                    t_major=True)
    with pytest.raises(ValueError, match="unsupported device"):
        stft_log_mel(torch.empty(1, 5, 4, device="meta"),
                     torch.empty(12, 6, device="meta"),
                     torch.empty(3, 2, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        layer_norm(q, torch.empty(8, device="meta"))
    x = torch.empty(1, 128, device="meta")
    dense = {"kernel": torch.empty(128, 128, device="meta"),
             "bias": torch.empty(128, device="meta")}
    norm = {"scale": torch.empty(128, device="meta"),
            "bias": torch.empty(128, device="meta")}
    lp = {"self_attn": {"q": dense, "out": dense},
          "encoder_attn": {"q": dense, "out": dense},
          "encoder_attn_layer_norm": norm, "final_layer_norm": norm,
          "fc1": dense, "fc2": dense}
    cache = torch.empty(1, 2, 8, 64, device="meta")
    scalar = torch.empty((), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_decoder_layer_step(x, x, scalar, lp, cache, cache, cache, cache,
                                 scalar)


def test_wrappers_refuse_past_their_limits():
    """Off the CPU, K1 and K2 take heads up to 256 and K5 rows up to 16384;
    past those they raise before reaching a device (here the meta device,
    which they would refuse next)."""
    q, k, v = (torch.empty(1, 2, 16, 264, device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="up to 256"):
        flash_fwd(q, k, v)
    with pytest.raises(ValueError, match="up to 256"):
        decode_attn(q[:, :, :1], k, v,
                    torch.empty((), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="at most 16384"):
        layer_norm(torch.empty(2, 16392, device="meta"),
                   torch.empty(16392, device="meta"))
    q, k, v = (torch.empty(1, 2, 16, 256, device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="unsupported device"):
        flash_fwd(q, k, v)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attn(torch.empty(1, 2, 1, 256, device="meta"), k, v,
                    torch.empty((), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        layer_norm(torch.empty(2, 16384, device="meta"),
                   torch.empty(16384, device="meta"))
