"""PyTorch port on a CUDA card: each kernel against its plain version, the
trained artifact end to end through the kernels (configuration E, the
artifact dequantized in memory, through the fused decoder-layer kernel K6),
one training step's gradients against the CPU's, and the decode loop's
captured step: its replays against the same step run eagerly on the card
(exactly: the same kernels on the same inputs), a capture that must
raise, the launch counters against the profiler, and ``refit``; the same
for the speculative round, with ``decode_chunk`` against the CPU and
``quantize_kv``'s values and scales bit-equal to the CPU's; K1, K4 and K2
at the head counts a rank holds under tensor parallelism, their calls
with no heads (nothing launched), and ``torch.distributed`` over NCCL at a
world of one (the session, the train step and the sharded checkpoint over
a 1×1 mesh equal to one device); K1 at the UNet's and BERT's shapes (S !=
T, head dims 40, 80, 160), the causal-LM batchers' captured steps against
the same steps run eagerly (dense and paged), and a paged replay reading
its static table buffer.

Every test here is marked ``gpu`` and skips where
``torch.cuda.is_available()`` is False. The file imports no JAX, so it runs
on a machine that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerances: 1e-5 max-abs in fp32 (the kernels reorder sums: online
softmax, lane-group dot products, warp-shuffle reductions; K1 and K4 take
their products as 3xTF32, ~22 bits an operand), 2e-2 in bf16
(the plain decode attention rounds the softmax weights to bf16 before P·V
and the kernel does not; LayerNorm's bf16 outputs may round one way in one
and the other in the other, one bf16 step: 2e-2 of max(|plain|, 1)), and
2e-4 on the log10-mel values of K3 (the JAX package's own STFT tolerance:
fp32 DFT sums in another order, which log10 amplifies near the floor), and
atol 1e-4 + rtol 1e-4 in fp32 for K6 (its projections sum up to 1536
products in another order). K4 (the flash backward): 1e-5 of
max(max|plain|, 1) in fp32 (sums reordered), 2e-2 of max(|plain|, 1)
elementwise in bf16 (dq rounds to bf16 from fp32 sums taken in another
order; P and dS enter the products as bf16 hi + lo). K1's
log-sum-exp 1e-4 (fp32 values up to ~10). A training step's gradients:
1e-3 of each leaf's largest |g| on the CPU (the card's fp32 products and
cuDNN's convolutions sum in another order over ~10^5 terms).
"""

import dataclasses
import importlib

import json
import os

import numpy as np
import pytest
import torch

from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu_torch.ops.attention import quantize_kv
from whisper_trtllm_tpu_torch.ops.kernels import (
    KERNELS,
    _build,
    attention_lse_reference,
    attention_reference,
    decode_attention_reference,
    decode_attn,
    flash_attention,
    flash_attention_backward_reference,
    flash_bwd,
    flash_fwd,
    fused_decoder_layer_step,
    fused_decoder_layer_step_reference,
    layer_norm,
    layer_norm_reference,
    reset_launch_counts,
    stft_log_mel,
    stft_log_mel_reference,
)
from whisper_trtllm_tpu_torch.runtime import generation

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
@pytest.mark.parametrize("hkv,s,t,dh,causal", [
    (6, 1500, 1500, 64, False),  # the encoder's: a 28-row tail of 64
    (2, 200, 200, 64, True),
    (2, 100, 100, 128, False),
    (3, 77, 77, 40, False),
    (6, 31, 1500, 64, False),    # the training cross attention's
    (1, 1500, 1500, 64, True),   # MQA, causal, the 28-row tail
    (1, 200, 200, 8, False),     # dh 8, padded to 64
    (3, 130, 130, 72, False),    # dh 72, padded to 128
    (2, 200, 200, 256, True),    # GPT-J's head: 32-row K/V tiles
    (3, 130, 130, 256, False),
    (6, 77, 77, 136, False),     # dh 136, padded to 256
])
def test_flash_kernel_matches_plain(cuda, dtype, tol, hkv, s, t, dh, causal):
    rng = np.random.default_rng(s)
    q = _normal(rng, (2, 6, s, dh), dh ** -0.5, cuda, dtype)
    k = _normal(rng, (2, hkv, t, dh), 1.0, cuda, dtype)
    v = _normal(rng, (2, hkv, t, dh), 1.0, cuda, dtype)
    before = flash_fwd.launches
    out = flash_fwd(q, k, v, causal=causal)
    assert flash_fwd.launches == before + 1
    ref = attention_reference(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol
    out2, lse = flash_fwd(q, k, v, causal=causal, with_lse=True)
    assert torch.equal(out, out2) and lse.dtype == torch.float32
    assert (lse - attention_lse_reference(q, k, causal)).abs().max() <= 1e-4


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,hkv,s,t,dh,causal", [
    (4, 6, 1500, 1500, 64, False),   # the encoder's
    (4, 6, 31, 1500, 64, False),     # the training cross attention's
    (1, 6, 1024, 1024, 64, True),    # causal
    (2, 2, 200, 200, 64, True),      # GQA, causal
    (2, 3, 77, 130, 40, False),      # GQA, ragged S and T, dh 40
    (1, 6, 100, 100, 128, False),    # dh 128
    (1, 1, 1500, 1500, 64, True),    # MQA, causal, a 28-row tail of 64
    (2, 1, 200, 200, 8, False),      # MQA, dh 8, padded to 64
    (1, 2, 130, 1500, 72, False),    # GQA, dh 72, padded to 128
])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, tol, b, hkv, s, t, dh,
                                        causal):
    rng = np.random.default_rng(s + t + dh)
    q = _normal(rng, (b, 6, s, dh), dh ** -0.5, cuda, dtype)
    k = _normal(rng, (b, hkv, t, dh), 1.0, cuda, dtype)
    v = _normal(rng, (b, hkv, t, dh), 1.0, cuda, dtype)
    do = _normal(rng, (b, 6, s, dh), 1.0, cuda, dtype)
    _, lse = flash_fwd(q, k, v, causal=causal, with_lse=True)
    before = flash_bwd.launches
    got = flash_bwd(q, k, v, lse, do, causal=causal)
    assert flash_bwd.launches == before + 1
    ref = flash_attention_backward_reference(q, k, v, do, causal=causal)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == dtype and g.shape == r.shape
        diff = (g.float() - r.float()).abs()
        if dtype == torch.float32:
            assert diff.max().item() <= tol * max(r.abs().max().item(), 1.0)
        else:
            assert (diff / r.float().abs().clamp(min=1)).max().item() <= tol
    # no atomics: the result repeats bit for bit
    again = flash_bwd(q, k, v, lse, do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("t,valid_len,dh", [(33, 1, 64), (33, 33, 64),
                                            (1504, 1500, 64), (1504, 0, 64),
                                            (40, 17, 8), (64, 64, 128),
                                            (832, 832, 256), (16, 9, 256),
                                            (96, 50, 200), (832, 801, 96)])
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


_QUANT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("t_major", [False, True], ids=["bhtd", "bhdt"])
@pytest.mark.parametrize("kind", ["int8", "fp8", "float"])
@pytest.mark.parametrize("t,valid_len", [(33, [0, 5, 33, 17]),
                                         (1504, [1500]), (64, [64])])
def test_decode_kernel_cache_kinds_match_plain(cuda, dtype, tol, t_major,
                                               kind, t, valid_len):
    """Quantized caches, the T-minor layout, and per-lane valid_len."""
    rng = np.random.default_rng(t + len(valid_len))
    q = _normal(rng, (4, 6, 1, 64), 0.125, cuda, dtype)
    ck = _normal(rng, (4, 6, t, 64), 1.0, cuda, torch.float32)
    cv = _normal(rng, (4, 6, t, 64), 1.0, cuda, torch.float32)
    scales = {}
    if kind == "float":
        ck, cv = ck.to(dtype), cv.to(dtype)
    else:
        ck, ks = quantize_kv(ck, _QUANT[kind])
        cv, vs = quantize_kv(cv, _QUANT[kind])
        scales = dict(k_scale=ks, v_scale=vs)
    if t_major:
        ck = ck.transpose(-1, -2).contiguous()
        cv = cv.transpose(-1, -2).contiguous()
    vl = torch.tensor(valid_len if len(valid_len) > 1 else valid_len[0],
                      dtype=torch.int32, device=cuda)
    before = decode_attn.launches
    out = decode_attn(q, ck, cv, vl, t_major=t_major, **scales)
    assert decode_attn.launches == before + 1
    ref = decode_attention_reference(q, ck, cv, vl, t_major=t_major, **scales)
    assert out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("t_major", [False, True], ids=["bhtd", "bhdt"])
@pytest.mark.parametrize("kind", ["int8", "fp8", "float"])
@pytest.mark.parametrize("t,valid_len", [(33, [0, 5, 33, 17]),
                                         (832, [832, 700])])
def test_decode_kernel_wide_head_cache_kinds_match_plain(cuda, dtype, tol,
                                                         t_major, kind, t,
                                                         valid_len):
    """Heads of 256 (32 lanes a row, two 4-value vectors an fp32 lane;
    T-minor's P.V two d rows a thread) in every cache kind and layout."""
    rng = np.random.default_rng(t + 256)
    b = len(valid_len)
    q = _normal(rng, (b, 4, 1, 256), 0.0625, cuda, dtype)
    ck = _normal(rng, (b, 4, t, 256), 1.0, cuda, torch.float32)
    cv = _normal(rng, (b, 4, t, 256), 1.0, cuda, torch.float32)
    scales = {}
    if kind == "float":
        ck, cv = ck.to(dtype), cv.to(dtype)
    else:
        ck, ks = quantize_kv(ck, _QUANT[kind])
        cv, vs = quantize_kv(cv, _QUANT[kind])
        scales = dict(k_scale=ks, v_scale=vs)
    if t_major:
        ck = ck.transpose(-1, -2).contiguous()
        cv = cv.transpose(-1, -2).contiguous()
    vl = torch.tensor(valid_len, dtype=torch.int32, device=cuda)
    _k2_once(q, ck, cv, vl, t_major, scales, tol)


def _k2_cache(rng, cuda, b, t, kind, t_major, dtype):
    q = _normal(rng, (b, 6, 1, 64), 0.125, cuda, dtype)
    ck = _normal(rng, (b, 6, t, 64), 1.0, cuda, torch.float32)
    cv = _normal(rng, (b, 6, t, 64), 1.0, cuda, torch.float32)
    scales = {}
    if kind == "float":
        ck, cv = ck.to(dtype), cv.to(dtype)
    else:
        ck, ks = quantize_kv(ck, _QUANT[kind])
        cv, vs = quantize_kv(cv, _QUANT[kind])
        scales = dict(k_scale=ks, v_scale=vs)
    if t_major:
        ck = ck.transpose(-1, -2).contiguous()
        cv = cv.transpose(-1, -2).contiguous()
    return q, ck, cv, scales


def _k2_once(q, ck, cv, vl, t_major, scales, tol):
    """One counted launch against the plain version; a second launch
    repeats it bit for bit (the cluster combines in rank order)."""
    before = decode_attn.launches
    out = decode_attn(q, ck, cv, vl, t_major=t_major, **scales)
    assert decode_attn.launches == before + 1
    ref = decode_attention_reference(q, ck, cv, vl, t_major=t_major, **scales)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert torch.equal(out, decode_attn(q, ck, cv, vl, t_major=t_major,
                                        **scales))


_K2_KINDS = [("float", False), ("int8", False), ("int8", True),
             ("fp8", True)]


def _k2_inputs(rng, cuda, dtype, kind, t_major, b, h, t, dh):
    """q, the cache in ``kind`` and layout, and its scales."""
    q = _normal(rng, (b, h, 1, dh), dh ** -0.5, cuda, dtype)
    ck = _normal(rng, (b, h, t, dh), 1.0, cuda, torch.float32)
    cv = _normal(rng, (b, h, t, dh), 1.0, cuda, torch.float32)
    scales = {}
    if kind == "float":
        ck, cv = ck.to(dtype), cv.to(dtype)
    else:
        ck, ks = quantize_kv(ck, _QUANT[kind])
        cv, vs = quantize_kv(cv, _QUANT[kind])
        scales = dict(k_scale=ks, v_scale=vs)
    if t_major:
        ck = ck.transpose(-1, -2).contiguous()
        cv = cv.transpose(-1, -2).contiguous()
    return q, ck, cv, scales


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("kind,t_major", _K2_KINDS + [("float", True)],
                         ids=["float", "int8-bhtd", "int8-bhdt", "fp8-bhdt",
                              "float-bhdt"])
@pytest.mark.parametrize("t,valid_len,dh", [(864, [864], 64),
                                            (864, [864, 854, 844, 834], 64),
                                            (33, [0, 5, 33, 17], 64),
                                            (832, [832, 700], 256)])
def test_decode_kernel_with_a_bias_matches_plain(cuda, dtype, tol, kind,
                                                 t_major, t, valid_len, dh):
    """ALiBi's (1, H, 1, T) bias and a full (B, H, 1, T) one, added after
    the K scale and before the mask, in every cache kind and layout,
    through the direct, the staged and the wide paths."""
    from whisper_trtllm_tpu_torch.ops.functional import alibi_bias

    rng = np.random.default_rng(t + dh + len(valid_len))
    b, h = max(len(valid_len), 2), 8
    q, ck, cv, scales = _k2_inputs(rng, cuda, dtype, kind, t_major, b, h, t,
                                   dh)
    vl = torch.tensor(valid_len if len(valid_len) > 1 else valid_len[0],
                      dtype=torch.int32, device=cuda)
    for bias in (alibi_bias(h, t, cuda), _normal(rng, (b, h, 1, t), 3.0,
                                                  cuda, torch.float32)):
        before = decode_attn.launches
        out = decode_attn(q, ck, cv, vl, t_major=t_major, bias=bias,
                          **scales)
        assert decode_attn.launches == before + 1
        ref = decode_attention_reference(q, ck, cv, vl, t_major=t_major,
                                         bias=bias, **scales)
        assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("kind,t_major", _K2_KINDS + [("float", True)],
                         ids=["float", "int8-bhtd", "int8-bhdt", "fp8-bhdt",
                              "float-bhdt"])
@pytest.mark.parametrize("t,dh", [(33, 64), (864, 64), (1504, 64),
                                  (832, 256)])
def test_decode_kernel_zero_bias_is_bit_equal_to_no_bias(cuda, kind, t_major,
                                                         t, dh):
    """x + 0.0 == x in fp32: an all-zero bias leaves every score, and so
    the output, as without one, bit for bit (the bias costs the shapes
    without one no change of result)."""
    rng = np.random.default_rng(t + dh)
    q, ck, cv, scales = _k2_inputs(rng, cuda, torch.float32, kind, t_major,
                                   4, 6, t, dh)
    vl = torch.tensor([t, t - 1, 1, t // 2], dtype=torch.int32, device=cuda)
    zero = torch.zeros(1, 6, 1, t, device=cuda)
    assert torch.equal(
        decode_attn(q, ck, cv, vl, t_major=t_major, bias=zero, **scales),
        decode_attn(q, ck, cv, vl, t_major=t_major, **scales))


def test_decode_kernel_refuses_a_bias_it_does_not_take(cuda):
    q = torch.zeros(2, 4, 1, 64, device=cuda)
    cache = torch.zeros(2, 4, 32, 64, device=cuda)
    vl = torch.tensor(32, dtype=torch.int32, device=cuda)
    for bias in (torch.zeros(1, 4, 1, 32, device=cuda, dtype=torch.bfloat16),
                 torch.zeros(1, 4, 1, 31, device=cuda),
                 torch.zeros(3, 4, 1, 32, device=cuda)):
        with pytest.raises(NotImplementedError):
            decode_attn(q, cache, cache, vl, bias=bias)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("kind,t_major", _K2_KINDS,
                         ids=["float", "int8-bhtd", "int8-bhdt", "fp8-bhdt"])
@pytest.mark.parametrize("b", [4, 32])
def test_decode_kernel_split_edges_match_plain(cuda, dtype, tol, kind,
                                               t_major, b):
    """The cross shape (T 1504) split across a cluster: valid_len one row
    before, at and after the first chunk's edge R and the last chunk's
    start, and 1500; at batch 4 and at batch 32 (the serving batch)."""
    from whisper_trtllm_tpu_torch.ops.kernels.decode_attention import (
        decode_plan,
    )

    rng = np.random.default_rng(b + len(kind) + t_major)
    q, ck, cv, scales = _k2_cache(rng, cuda, b, 1504, kind, t_major, dtype)
    splits, chunk, _, _ = decode_plan(q, ck, t_major)
    assert splits > 1 and (splits - 1) * chunk < 1504 <= splits * chunk
    last = (splits - 1) * chunk
    for n in (chunk - 1, chunk, chunk + 1, last, last + 1, 1500):
        vl = torch.tensor(n, dtype=torch.int32, device=cuda)
        _k2_once(q, ck, cv, vl, t_major, scales, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("kind,t_major", _K2_KINDS,
                         ids=["float", "int8-bhtd", "int8-bhdt", "fp8-bhdt"])
@pytest.mark.parametrize("t", [33, 1504])
def test_decode_kernel_per_lane_mix_matches_plain(cuda, dtype, tol, kind,
                                                  t_major, t):
    """One launch whose lanes hold 0 (the uniform softmax over T), 1, T and
    lengths inside and past the cache."""
    rng = np.random.default_rng(t + len(kind) + t_major)
    q, ck, cv, scales = _k2_cache(rng, cuda, 6, t, kind, t_major, dtype)
    lens = [0, 1, t, t // 2 + 3, t + 5, -4]
    vl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    _k2_once(q, ck, cv, vl, t_major, scales, tol)


# (B, H, T, lane lengths, V's scale, whether kernel and plain must part by
# more than 0.02): chip_smoke.py's int8 T-minor self sweep at batch 4, with
# V scaled so that a lane of one row gives outputs in [4, 8) and beyond,
# where one bf16 step (0.03125) is past the check's 0.02; the bench's self
# cases at tiny.en's batch 32 and large-v3's batch 16, as chip_smoke.py
# draws them, where every output averages 49 rows
_BF16_GAP_CASES = [(4, 6, 33, [1, 10, 19, 28], 4.0, True),
                   (32, 6, 49, [49] * 32, 1.0, False),
                   (16, 20, 49, [49] * 16, 1.0, False)]


@pytest.mark.parametrize("b,h,t,lens,v_scale,parts", _BF16_GAP_CASES,
                         ids=["sweep-b4", "bench-b32-h6", "bench-b16-h20"])
def test_decode_kernel_bf16_gap_is_the_plain_versions_rounding(
        cuda, b, h, t, lens, v_scale, parts):
    """K2 with an int8 T-minor cache and bf16 q, held with its plain version
    against a witness: the plain version's formulas on q widened to fp64
    with fp64 V scales, so that the softmax weights times the scales are
    not rounded to bf16 before P·V, as the plain version rounds them and
    the kernel does not. The kernel lies within half a bf16 step of the
    witness (it rounds once, at its output), and wherever kernel and plain
    part by more than 0.02 the plain version is the farther: that gap is
    the plain version's rounding. In the sweep case they do part (the
    observation chip_smoke.py's check made once its inputs shifted)."""
    rng = np.random.default_rng(b * h + t)
    q = _normal(rng, (b, h, 1, 64), 0.125, cuda, torch.bfloat16)
    ck = _normal(rng, (b, h, t, 64), 1.0, cuda, torch.float32)
    cv = _normal(rng, (b, h, t, 64), v_scale, cuda, torch.float32)
    ck, ks = quantize_kv(ck, torch.int8)
    cv, vs = quantize_kv(cv, torch.int8)
    ck = ck.transpose(-1, -2).contiguous()
    cv = cv.transpose(-1, -2).contiguous()
    vl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = decode_attn(q, ck, cv, vl, ks, vs, True).double()
    plain = decode_attention_reference(q, ck, cv, vl, k_scale=ks, v_scale=vs,
                                       t_major=True).double()
    witness = decode_attention_reference(q.double(), ck, cv, vl, k_scale=ks,
                                         v_scale=vs.double(), t_major=True)
    assert witness.dtype == torch.float64
    # half a bf16 step (8 significant bits) of the witness, and the fp32
    # sums' own order
    half_step = torch.ldexp(torch.ones_like(witness),
                            torch.frexp(witness)[1] - 9)
    k_err = (out - witness).abs()
    assert (k_err <= half_step + 1e-5 * witness.abs() + 1e-6).all(), (
        (k_err - half_step).max().item())
    gap = (out - plain).abs() > 0.02
    assert gap.any().item() == parts
    assert ((plain - witness).abs()[gap] > k_err[gap]).all()


@pytest.mark.parametrize("kind,t_major", [("float", False), ("int8", True)])
def test_decode_kernel_replays_in_a_cuda_graph(cuda, kind, t_major):
    """A captured launch stays right when valid_len is rewritten in place:
    the split plan depends on the shape only, and the kernel reads
    valid_len from the device."""
    rng = np.random.default_rng(5)
    q, ck, cv, scales = _k2_cache(rng, cuda, 4, 1504, kind, t_major,
                                  torch.bfloat16)
    vl = torch.tensor(1500, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attn(q, ck, cv, vl, t_major=t_major, **scales)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = decode_attn.launches
    with torch.cuda.graph(graph):
        out = decode_attn(q, ck, cv, vl, t_major=t_major, **scales)
    assert decode_attn.launches == before + 1
    for n in (1500, 1, 700, 0, 1504, 97):
        vl.fill_(n)
        graph.replay()
        eager = decode_attn(q, ck, cv, vl, t_major=t_major, **scales)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        ref = decode_attention_reference(q, ck, cv, vl, t_major=t_major,
                                         **scales)
        assert (out.float() - ref.float()).abs().max().item() <= 2e-2


def test_decode_kernels_are_one_device_launch_a_call(cuda):
    """The profiler sees one operation on the card for a K2 call and one
    for a K7 call, each a kernel split across a cluster: no combine
    kernel, and no copy or memset of the wrappers' own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from whisper_trtllm_tpu_torch.ops.kernels import cross_decode_mha

    rng = np.random.default_rng(9)
    q, ck, cv, scales = _k2_cache(rng, cuda, 4, 1504, "int8", True,
                                  torch.bfloat16)
    vl = torch.tensor(1500, dtype=torch.int32, device=cuda)
    q7 = _normal(rng, (4, 384), 0.125, cuda, torch.float32)
    kv7 = _normal(rng, (4, 1504, 384), 1.0, cuda, torch.float32)
    decode_attn(q, ck, cv, vl, t_major=True, **scales)
    cross_decode_mha(q7, kv7, kv7, 6, 64, 1500)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode_attn(q, ck, cv, vl, t_major=True, **scales)
        cross_decode_mha(q7, kv7, kv7, 6, 64, 1500)
        torch.cuda.synchronize()
    # every kernel, copy and memset the card ran in the window, in order
    names = [e.name for e in sorted(prof.events(),
                                    key=lambda e: e.time_range.start)
             if e.device_type == DeviceType.CUDA]
    assert len(names) == 2, names
    assert "decode_t_minor" in names[0] and "cross_kernel" in names[1], names


@pytest.mark.parametrize("n_mels,b", [(80, 2), (128, 2), (80, 32)])
def test_stft_kernel_matches_plain(cuda, n_mels, b):
    """At batch 2 and at the bench headline's batch of 32 utterances."""
    from whisper_trtllm_tpu_torch.audio.features import LogMelSpectrogram

    fe = LogMelSpectrogram(n_mels, device=cuda)
    rng = np.random.default_rng(n_mels)
    blocks = _normal(rng, (b, 3003, 160), 0.1, cuda, torch.float32)
    blocks[1, 1500:] = 0.0  # silence: power at the 1e-10 floor
    basis = fe.dft_basis[:400]
    before = stft_log_mel.launches
    out = stft_log_mel(blocks, basis, fe.mel_fb)
    assert stft_log_mel.launches == before + 1
    ref = stft_log_mel_reference(blocks, basis, fe.mel_fb)
    assert out.shape == (b, 3001, n_mels)
    assert (out - ref).abs().max().item() <= 2e-4


@pytest.mark.parametrize("n_mels", [80, 128])
def test_stft_kernel_on_near_silent_input_matches_plain(cuda, n_mels):
    """Near-silent frames, where log10 magnifies the DFT's relative error
    the most: a bundled utterance scaled by 1e-4 after a second of exact
    zeros, and a signal of 1e-7 noise (power near the 1e-10 floor)."""
    from whisper_trtllm_tpu_torch.audio.features import (
        HOP_LENGTH,
        N_FFT,
        LogMelSpectrogram,
        pad_or_trim,
        read_wav,
    )

    fe = LogMelSpectrogram(n_mels, device=cuda)
    speech = pad_or_trim(read_wav(os.path.join(
        ROOT, "artifacts", "eval", "utt00.wav")))
    quiet = np.concatenate([np.zeros(16000, np.float32), speech[:-16000]]) * 1e-4
    noise = np.random.default_rng(3).standard_normal(speech.shape) * 1e-7
    audio = torch.from_numpy(np.stack([quiet, noise]).astype(np.float32))
    pad = N_FFT // 2
    padded = torch.nn.functional.pad(audio[:, None], (pad, pad),
                                     mode="reflect")[:, 0]
    n_blocks = 3003  # the frontend's: 3001 frames
    padded = torch.nn.functional.pad(
        padded, (0, n_blocks * HOP_LENGTH - padded.shape[1]))
    blocks = padded.reshape(2, n_blocks, HOP_LENGTH).to(cuda)
    basis = fe.dft_basis[:N_FFT]
    out = stft_log_mel(blocks, basis, fe.mel_fb)
    ref = stft_log_mel_reference(blocks, basis, fe.mel_fb)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 2e-4


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", [(4, 1500, 384), (4, 1, 384), (3, 7, 1280),
                                   (5, 40)])
def test_layer_norm_kernel_matches_plain(cuda, dtype, tol, with_bias, shape):
    rng = np.random.default_rng(shape[-1])
    x = _normal(rng, shape, 2.0, cuda, dtype) + 0.5
    scale = _normal(rng, shape[-1:], 1.0, cuda, dtype)
    bias = _normal(rng, shape[-1:], 1.0, cuda, dtype) if with_bias else None
    before = layer_norm.launches
    out = layer_norm(x, scale, bias)
    assert layer_norm.launches == before + 1
    ref = layer_norm_reference(x, scale, bias)
    assert out.dtype == dtype and out.shape == x.shape
    err = (out.float() - ref.float()).abs() / ref.float().abs().clamp(min=1)
    assert err.max().item() <= tol


_NORM_PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.float32),
               (torch.bfloat16, torch.bfloat16)]


def _norm_error(out, ref):
    """max |kernel - plain| / max(|plain|, 1): a bf16 output may round one
    way in one and the other in the other."""
    return ((out.float() - ref.float()).abs()
            / ref.float().abs().clamp(min=1)).max().item()


@pytest.mark.parametrize("x_dtype,p_dtype", _NORM_PAIRS)
@pytest.mark.parametrize("rows", [1, 4, 6000])
@pytest.mark.parametrize("d", [6, 100, 384, 1280, 2048, 2056, 4096, 4100,
                               6144, 9216, 12288, 16384])
def test_layer_norm_kernel_over_widths_and_dtype_pairs(cuda, x_dtype, p_dtype,
                                                       rows, d):
    """Every vector and scalar plan K5 takes, in each of its four x and
    parameter dtype pairs, against the plain version."""
    from whisper_trtllm_tpu_torch.ops.kernels.layer_norm import norm_plan

    rng = np.random.default_rng(d + rows)
    x = _normal(rng, (rows, d), 2.0, cuda, x_dtype) + 0.5
    scale = _normal(rng, (d,), 1.0, cuda, p_dtype)
    bias = _normal(rng, (d,), 1.0, cuda, p_dtype)
    item = x.element_size()
    plan = norm_plan(rows, d, item, True)
    assert d % plan.vec == 0 and plan.lpr * plan.vpt * plan.vec >= d
    if d % (16 // item) == 0:
        assert plan.vec > 1
    if d % (8 // item) != 0:
        assert plan.vec == 1
    out = layer_norm(x, scale, bias)
    ref = layer_norm_reference(x, scale, bias)
    assert out.dtype == x_dtype and torch.isfinite(out.float()).all()
    assert _norm_error(out, ref) <= dict(DTYPES)[x_dtype]


@pytest.mark.parametrize("x_dtype,p_dtype", _NORM_PAIRS)
@pytest.mark.parametrize("offset", [1, 2, 3, 4])
@pytest.mark.parametrize("what", ["x", "scale", "bias"])
def test_layer_norm_kernel_at_unaligned_views(cuda, x_dtype, p_dtype, offset,
                                              what):
    """x, scale or bias as a view ``offset`` values into its storage, off
    the 16-byte boundary whenever offset * itemsize is not a multiple of
    16: the scalar path of the same kernel, still one launch."""
    from whisper_trtllm_tpu_torch.ops.kernels.layer_norm import norm_plan

    rows, d = 37, 384
    rng = np.random.default_rng(offset)

    def view(shape, scale, dtype, name):
        n = int(np.prod(shape))
        k = offset if name == what else 0
        return _normal(rng, (n + k,), scale, cuda, dtype)[k:].view(shape)

    x = view((rows, d), 2.0, x_dtype, "x")
    scale = view((d,), 1.0, p_dtype, "scale")
    bias = view((d,), 1.0, p_dtype, "bias")
    moved = {"x": x, "scale": scale, "bias": bias}[what]
    assert moved.is_contiguous() and moved.storage_offset() == offset
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, bias))
    assert aligned == (offset * moved.element_size() % 16 == 0)
    plan = norm_plan(rows, d, x.element_size(), aligned)
    assert (plan.vec > 1) == aligned
    before = layer_norm.launches
    out = layer_norm(x, scale, bias)
    assert layer_norm.launches == before + 1
    ref = layer_norm_reference(x, scale, bias)
    assert _norm_error(out, ref) <= dict(DTYPES)[x_dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_and_gelu_replay_in_a_cuda_graph(cuda, dtype):
    """K5 on the output of a matmul and K8 on K5's, captured together in a
    CUDA graph at a width first launched inside the capture (so the
    kernels' one-wave occupancy query runs there; a warm-up at another
    width loads the libraries), replayed on new inputs written in place:
    bit for bit the eager launches."""
    from whisper_trtllm_tpu_torch.examples.custom_kernel.custom_gelu_kernel \
        import fused_bias_gelu

    rng = np.random.default_rng(41)

    def inputs(rows, d):
        return (_normal(rng, (rows, d), 1.0, cuda, dtype),
                _normal(rng, (d, d), d ** -0.5, cuda, dtype),
                _normal(rng, (d,), 1.0, cuda, dtype),
                _normal(rng, (d,), 1.0, cuda, dtype))

    def step(a, w, scale, bias):
        return fused_bias_gelu(layer_norm(a @ w, scale, bias), bias)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(*inputs(300, 384))
    torch.cuda.current_stream().wait_stream(side)
    rows, d = 300, 648
    a, w, scale, bias = inputs(rows, d)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(a, w, scale, bias)
    for seed in (1, 2):
        a.copy_(_normal(np.random.default_rng(seed), (rows, d), 1.0, cuda,
                        dtype))
        graph.replay()
        eager = step(a, w, scale, bias)
        torch.cuda.synchronize()
        assert torch.equal(out, eager), seed


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
    q1 = torch.zeros(1, 2, 1, 64, device=cuda)
    vl = torch.tensor(3, dtype=torch.int32, device=cuda)
    xq = x.to(torch.int8)
    with pytest.raises(TypeError, match="scales"):
        decode_attn(q1, xq, xq, vl)
    with pytest.raises(TypeError, match="float cache"):
        decode_attn(q1, x.bfloat16(), x.bfloat16(), vl)
    with pytest.raises(ValueError, match="scales"):
        s = torch.ones(1, 2, 16, 1, device=cuda)
        decode_attn(q1, xq, xq, vl, s, s.bfloat16())
    with pytest.raises(TypeError, match="float32"):
        stft_log_mel(torch.zeros(1, 5, 4, device=cuda).bfloat16(),
                     torch.zeros(12, 6, device=cuda),
                     torch.zeros(3, 2, device=cuda))
    with pytest.raises(ValueError, match="n_taps"):
        stft_log_mel(torch.zeros(1, 5, 4, device=cuda),
                     torch.zeros(13, 6, device=cuda),
                     torch.zeros(3, 2, device=cuda))
    with pytest.raises(TypeError):
        layer_norm(x.half(), torch.ones(64, device=cuda).half())
    with pytest.raises(ValueError, match="contiguous"):
        layer_norm(x.transpose(2, 3), torch.ones(16, device=cuda))
    lse = torch.zeros(1, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="lse"):
        flash_bwd(x, x, x, None, x)
    with pytest.raises(ValueError, match="lse"):
        flash_bwd(x, x, x, lse.double(), x)
    with pytest.raises(ValueError, match="dout"):
        flash_bwd(x, x, x, lse, x.transpose(2, 3).contiguous()
                  .transpose(2, 3))
    # in the JAX package's flash conditions but beyond K1's head_dim
    from whisper_trtllm_tpu_torch.ops.attention import mha
    with pytest.raises(ValueError, match="head_dim"):
        mha(*(torch.zeros(1, 2, 16, 264, device=cuda),) * 3)
    # past the limits: K1 and K2 heads of 256, K5 rows of 16384; K4 128
    wide = torch.zeros(1, 2, 16, 264, device=cuda)
    with pytest.raises(ValueError, match="up to 256"):
        flash_fwd(wide, wide, wide)
    with pytest.raises(ValueError, match="up to 256"):
        decode_attn(torch.zeros(1, 2, 1, 264, device=cuda), wide, wide, vl)
    with pytest.raises(ValueError, match="at most 16384"):
        layer_norm(torch.zeros(2, 16392, device=cuda),
                   torch.ones(16392, device=cuda))
    x256 = torch.zeros(1, 2, 16, 256, device=cuda)
    with pytest.raises(ValueError, match="up to 128"):
        flash_bwd(x256, x256, x256, torch.zeros(1, 2, 16, device=cuda), x256)


def test_kernels_without_backward_refuse_inputs_that_require_grad(cuda):
    """A kernel output filled through ctypes has no grad_fn: handed an
    input that requires grad, a kernel with no backward raises instead of
    cutting the graph; under no_grad it runs."""
    x = torch.zeros(1, 2, 16, 64, device=cuda, requires_grad=True)
    q1 = torch.zeros(1, 2, 1, 64, device=cuda, requires_grad=True)
    vl = torch.tensor(3, dtype=torch.int32, device=cuda)
    w = torch.ones(64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_fwd(x, x, x)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attn(q1, x.detach(), x.detach(), vl)
    with pytest.raises(RuntimeError, match="no backward"):
        layer_norm(x.detach(), w)
    with pytest.raises(RuntimeError, match="no backward"):
        stft_log_mel(torch.zeros(1, 5, 4, device=cuda, requires_grad=True),
                     torch.zeros(12, 6, device=cuda),
                     torch.zeros(3, 2, device=cuda))
    with torch.no_grad():
        flash_fwd(x, x, x)
        layer_norm(x, w)
    # the differentiable entries keep the graph
    out = flash_attention(x, x, x)
    assert out.grad_fn is not None and out.grad_fn.name().startswith(
        "FlashAttention")
    from whisper_trtllm_tpu_torch.ops.functional import layer_norm as ln
    assert ln({"scale": w}, x).grad_fn.name().startswith("LayerNorm")


def test_inference_launches_of_k1_write_no_lse(cuda, monkeypatch):
    """The inference path (no grad) passes a null log-sum-exp to K1; the
    training path a buffer."""
    from whisper_trtllm_tpu_torch.models.whisper.model import encode
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint

    k1 = importlib.import_module(
        "whisper_trtllm_tpu_torch.ops.kernels.flash_attention")
    lib = _build.load("flash_attention", k1._SIGNATURES)
    real, lse_args = lib.flash_fwd, []

    def spy(*args):
        lse_args.append(args[4])
        return real(*args)

    monkeypatch.setattr(lib, "flash_fwd", spy)
    params, cfg = load_checkpoint(
        os.path.join(ROOT, "artifacts", "tiny_en_synth_int8"))
    mel = torch.zeros(1, 3000, cfg.num_mel_bins, device=cuda)
    with torch.inference_mode():
        encode(params, cfg, mel)
    assert lse_args == [None] * cfg.encoder_layers
    x = torch.randn(1, 2, 16, 64, device=cuda, requires_grad=True)
    flash_attention(x, x, x)
    assert lse_args[-1] is not None


@pytest.mark.parametrize("compute,kv", [("float32", "auto"),
                                        ("bfloat16", "int8")])
def test_artifact_transcribes_exactly_through_the_kernels(cuda, compute, kv):
    """fp32 with float KV, and the serving precision: bf16 compute with an
    int8 KV cache, the cross cache T-minor ("auto")."""
    from whisper_trtllm_tpu_torch.audio import pad_or_trim, read_wav
    from whisper_trtllm_tpu_torch.config import GenerationConfig, RuntimeConfig
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
    session = WhisperSession(
        params, cfg, GenerationConfig(max_new_tokens=32, kv_cache_dtype=kv),
        RuntimeConfig(compute_dtype=compute))
    reset_launch_counts()
    generation.reset_loop_counts()
    toks, lens = session.transcribe(np.stack([read(i) for i in range(4)]))
    texts = [ids_to_text(toks[i, :lens[i]]) for i in range(4)]
    assert texts == expected
    # the loop's steps: warm-up steps and replays of the captured step
    steps = generation.LOOP.steps
    assert 0 <= steps - (int(lens.max()) - 1) < generation.FINISH_CHECK_EVERY
    assert {n: f.launches for n, f in KERNELS.items()} == {
        "flash_fwd": cfg.encoder_layers, "flash_bwd": 0,
        "decode_attn": 2 * cfg.decoder_layers * steps,
        "stft_log_mel": 1,
        "layer_norm": (2 * cfg.encoder_layers + 1
                       + (3 * cfg.decoder_layers + 1) * steps),
        "fused_decoder_layer_step": 0, "cross_decode_mha": 0}


def _fused_inputs(rng, dtype, cuda, b=4, d=384, h=6, ffn=1536, ts=33,
                  tc=1504):
    """Tiny.en's decoder-layer shapes with non-trivial biases and LayerNorm
    parameters."""
    dh = d // h

    def dense(din, dout):
        return {"kernel": _normal(rng, (din, dout), din ** -0.5, cuda, dtype),
                "bias": _normal(rng, (dout,), 0.1, cuda, dtype)}

    def norm():
        return {"scale": 1 + _normal(rng, (d,), 0.1, cuda, dtype),
                "bias": _normal(rng, (d,), 0.1, cuda, dtype)}

    lp = {"self_attn": {"q": dense(d, d), "out": dense(d, d)},
          "encoder_attn": {"q": dense(d, d), "out": dense(d, d)},
          "encoder_attn_layer_norm": norm(), "final_layer_norm": norm(),
          "fc1": dense(d, ffn), "fc2": dense(ffn, d)}
    x = _normal(rng, (b, d), 1.0, cuda, dtype)
    h1 = _normal(rng, (b, d), 1.0, cuda, dtype)
    caches = [_normal(rng, (b, h, t, dh), s, cuda, dtype)
              for t, s in ((ts, 0.3), (ts, 1.0), (tc, 0.3), (tc, 1.0))]
    return x, h1, lp, caches


# fp32: atol 1e-4 + rtol 1e-4, sums over up to 1536 terms in another
# order; bf16: 2e-2 of max(|plain|, 1), one bf16 step of the output
FUSED_DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


def _fused_close(out, ref, dtype, tol):
    assert out.dtype == dtype and out.shape == ref.shape
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert (diff <= tol + tol * ref.abs()).all(), diff.max().item()
    else:
        assert (diff / ref.float().abs().clamp(min=1)).max().item() <= tol


@pytest.mark.parametrize("dtype,tol", FUSED_DTYPES)
@pytest.mark.parametrize("b,enc_len", [(4, 1500), (1, 1504), (9, 700),
                                       (16, 1500), (4, 0), (8, 1500)])
def test_fused_decoder_step_matches_plain(cuda, dtype, tol, b, enc_len):
    """K6 at tiny.en's widths over the position sweep of a 33-row self
    cache, at batch 4 (the main path's), 1, 9 and 16 (the gate's largest),
    8 (the benchmark grid's, which pads the projections' rows to 8), and
    with no valid cross row (a uniform softmax over all of them)."""
    rng = np.random.default_rng(b)
    x, h1, lp, caches = _fused_inputs(rng, dtype, cuda, b=b)
    el = torch.tensor(enc_len, dtype=torch.int32, device=cuda)
    for pos in (0, 16, 32):
        p = torch.tensor(pos, dtype=torch.int32, device=cuda)
        before = fused_decoder_layer_step.launches
        out = fused_decoder_layer_step(x, h1, p, lp, *caches, el)
        assert fused_decoder_layer_step.launches == before + 1
        ref = fused_decoder_layer_step_reference(x, h1, p, lp, *caches, el)
        _fused_close(out, ref, dtype, tol)


@pytest.mark.parametrize("dtype,tol", FUSED_DTYPES)
def test_fused_decoder_step_at_wide_shapes_matches_plain(cuda, dtype, tol):
    """Shapes whose slices do not fit the kernel's ring at once: d 1280
    (20 heads, ffn 5120) at batch 16 with a 448-row self cache, so every
    phase streams its tiles through the stages."""
    rng = np.random.default_rng(21)
    x, h1, lp, caches = _fused_inputs(rng, dtype, cuda, b=16, d=1280, h=20,
                                      ffn=5120, ts=448, tc=1504)
    el = torch.tensor(1500, dtype=torch.int32, device=cuda)
    for pos in (0, 447):
        p = torch.tensor(pos, dtype=torch.int32, device=cuda)
        out = fused_decoder_layer_step(x, h1, p, lp, *caches, el)
        ref = fused_decoder_layer_step_reference(x, h1, p, lp, *caches, el)
        _fused_close(out, ref, dtype, tol)


@pytest.mark.parametrize("dtype,tol", FUSED_DTYPES)
def test_fused_decoder_step_replays_in_a_cuda_graph(cuda, dtype, tol):
    """A captured K6 launch, replayed with pos rewritten in place, equals
    the eager launch each time: the plan depends on the shape only, the
    kernel reads pos from the device, and its counters are back at zero
    after every launch (no memset is captured)."""
    rng = np.random.default_rng(31)
    x, h1, lp, caches = _fused_inputs(rng, dtype, cuda)
    el = torch.tensor(1500, dtype=torch.int32, device=cuda)
    pos = torch.tensor(0, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_decoder_layer_step(x, h1, pos, lp, *caches, el)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = fused_decoder_layer_step.launches
    with torch.cuda.graph(graph):
        out = fused_decoder_layer_step(x, h1, pos, lp, *caches, el)
    assert fused_decoder_layer_step.launches == before + 1
    for p in (32, 5, 17):
        pos.fill_(p)
        graph.replay()
        eager = fused_decoder_layer_step(x, h1, pos, lp, *caches, el)
        torch.cuda.synchronize()
        assert torch.equal(out, eager), p
        ref = fused_decoder_layer_step_reference(x, h1, pos, lp, *caches, el)
        _fused_close(out, ref, dtype, tol)


def test_fused_decoder_step_back_to_back_launches_need_no_sync(cuda):
    """Launches queued one after another with no sync between them (the
    decode loop's four layers): each finds the counters the last left at
    zero, and each result equals its own launch taken alone."""
    rng = np.random.default_rng(41)
    sets = [_fused_inputs(rng, torch.float32, cuda) for _ in range(3)]
    el = torch.tensor(1500, dtype=torch.int32, device=cuda)
    pos = torch.tensor(20, dtype=torch.int32, device=cuda)
    alone = []
    for x, h1, lp, caches in sets:
        alone.append(fused_decoder_layer_step(x, h1, pos, lp, *caches, el))
        torch.cuda.synchronize()
    queued = [fused_decoder_layer_step(x, h1, pos, lp, *caches, el)
              for _ in range(4) for x, h1, lp, caches in sets]
    torch.cuda.synchronize()
    for i, out in enumerate(queued):
        assert torch.equal(out, alone[i % 3]), i


def test_fused_decoder_step_refuses_before_and_at_launch(cuda):
    from whisper_trtllm_tpu_torch.ops.kernels import _build
    from whisper_trtllm_tpu_torch.ops.kernels import fused_decoder_step as k6

    rng = np.random.default_rng(0)
    x, h1, lp, caches = _fused_inputs(rng, torch.float32, cuda, b=2, ts=8,
                                      tc=40)
    pos = torch.tensor(3, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="0-d int32"):
        fused_decoder_layer_step(x, h1, pos.long(), lp, *caches, 40)
    with pytest.raises(TypeError, match="one dtype"):
        fused_decoder_layer_step(x.bfloat16(), h1, pos, lp, *caches, 40)
    # beyond the kernel's limits (batch 17): the kernel refuses the launch
    with pytest.raises(RuntimeError, match="launch failed"):
        fused_decoder_layer_step(*(torch.zeros(17, 384, device=cuda),) * 2,
                                 pos, lp, *(c[:1].expand(17, -1, -1, -1)
                                            .contiguous() for c in caches), 40)
    with pytest.raises(ValueError, match="contiguous"):
        fused_decoder_layer_step(x, h1, pos, lp, caches[0],
                                 caches[1].transpose(2, 3).contiguous()
                                 .transpose(2, 3), *caches[2:], 40)
    # a launch the kernel refuses (here: too small a workspace) raises
    lib = _build.load("fused_decoder_step", k6._SIGNATURES)
    blocks = [t.data_ptr() for pair in k6._blocks(lp) for t in pair]
    enc_len = torch.tensor(40, dtype=torch.int32, device=cuda)
    out = torch.empty_like(x)
    ws = torch.empty(16, device=cuda)
    _, sync = k6._device_state(x.device)
    err = lib.fused_decoder_step(
        x.data_ptr(), h1.data_ptr(), pos.data_ptr(), enc_len.data_ptr(),
        *blocks, *(c.data_ptr() for c in caches), out.data_ptr(),
        ws.data_ptr(), None, sync.data_ptr(), 2, 6, 8, 64, 40, 384, 1536, 0,
        *k6.fused_plan(2, 6, 40, 384, 1536, 132), 16,
        torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.check_launch(lib, err, "fused_decoder_layer_step")
    # the phase timeline: one stamp at the start and one per phase, in order
    timeline = torch.zeros(len(k6.PHASES) + 1, dtype=torch.int64, device=cuda)
    out = fused_decoder_layer_step(x, h1, pos, lp, *caches, 40,
                                   timeline=timeline)
    assert (timeline.diff() >= 0).all() and timeline[-1] > timeline[0]
    assert torch.equal(out, fused_decoder_layer_step(x, h1, pos, lp, *caches,
                                                     40))


def test_float_tree_transcribes_exactly_through_k6(cuda):
    """Configuration E: the artifact dequantized in memory, fp32, float KV:
    every decoder layer of every step is one K6 launch, no decode_attn."""
    from whisper_trtllm_tpu_torch.audio import pad_or_trim, read_wav
    from whisper_trtllm_tpu_torch.config import GenerationConfig
    from whisper_trtllm_tpu_torch.quantization import dequantize_params
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
    from whisper_trtllm_tpu_torch.utils.vocab import ids_to_text

    with open(os.path.join(ROOT, "artifacts", "expected.json")) as f:
        expected = json.load(f)["texts"]
    params, cfg = load_checkpoint(
        os.path.join(ROOT, "artifacts", "tiny_en_synth_int8"))
    session = WhisperSession(dequantize_params(params), cfg,
                             GenerationConfig(max_new_tokens=32))
    audio = np.stack([pad_or_trim(read_wav(os.path.join(
        ROOT, "artifacts", "eval", f"utt{i:02d}.wav"))) for i in range(4)])
    reset_launch_counts()
    generation.reset_loop_counts()
    toks, lens = session.transcribe(audio)
    assert [ids_to_text(toks[i, :lens[i]]) for i in range(4)] == expected
    steps = generation.LOOP.steps
    assert 0 <= steps - (int(lens.max()) - 1) < generation.FINISH_CHECK_EVERY
    assert {n: f.launches for n, f in KERNELS.items()} == {
        "flash_fwd": cfg.encoder_layers, "flash_bwd": 0, "decode_attn": 0,
        "stft_log_mel": 1,
        "layer_norm": 2 * cfg.encoder_layers + 1 + 5 * steps,
        "fused_decoder_layer_step": cfg.decoder_layers * steps,
        "cross_decode_mha": 0}


def _cut_float_artifact(device, layers=1):
    """The artifact dequantized in memory, cut to ``layers`` encoder and
    decoder layers (widths unchanged)."""
    from whisper_trtllm_tpu_torch.quantization import dequantize_params
    from whisper_trtllm_tpu_torch.training.train import tree_map
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint

    params, cfg = load_checkpoint(
        os.path.join(ROOT, "artifacts", "tiny_en_synth_int8"), device=device)
    params = dequantize_params(params)
    for side in ("encoder", "decoder"):
        params[side]["layers"] = tree_map(lambda t: t[:layers].clone(),
                                          params[side]["layers"])
    return params, dataclasses.replace(cfg, encoder_layers=layers,
                                       decoder_layers=layers)


def test_training_step_gradients_on_the_card_equal_the_cpus(cuda):
    """One step of the training path: the loss equals the CPU's, and every
    leaf's gradient is nonzero and equal to the CPU's (a kernel output
    without grad_fn would leave the leaves before it at zero); one K1 and
    one K4 launch a layer (encoder self, decoder cross), three K5 per
    decoder layer, two per encoder layer and two final ones."""
    from whisper_trtllm_tpu_torch.training import loss_and_grads, make_train_step
    from whisper_trtllm_tpu_torch.training.train import tree_leaves

    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 3000, 80)).astype(np.float32)
    tokens = np.array([[50257, 50362, 100, 105, 131, 50256, 50256, 50256],
                       [50257, 50362, 120, 50256, 50256, 50256, 50256,
                        50256]], np.int32)
    mask = np.array([[1] * 5 + [0] * 2, [1] * 3 + [0] * 4], np.float32)
    grads = {}
    for dev in ("cpu", cuda):
        params, cfg = _cut_float_artifact(dev)
        reset_launch_counts()
        loss, g = loss_and_grads(params, cfg, mel, tokens, mask)
        grads[str(dev)] = (float(loss), [t.cpu() for t in tree_leaves(g)])
    assert {n: f.launches for n, f in KERNELS.items()} == {
        "flash_fwd": 2, "flash_bwd": 2, "decode_attn": 0, "stft_log_mel": 0,
        "layer_norm": 7, "fused_decoder_layer_step": 0,
        "cross_decode_mha": 0}
    (l_cpu, g_cpu), (l_card, g_card) = grads["cpu"], grads["cuda"]
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for a, b in zip(g_card, g_cpu):
        top = b.abs().max().item()
        assert a.abs().max().item() > 0
        assert (a - b).abs().max().item() <= 1e-3 * top
    init, step = make_train_step(cfg)
    params, _ = _cut_float_artifact(cuda)
    state = init(params)
    losses = [float(step(params, state, mel, tokens, mask)[2])
              for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# --------------------------------------------------------------------------
# K7, K8, init_params, step == full and the hardware check on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,h,t,dh,valid_lens", [
    (4, 6, 1504, 64, [1500, 1, 1504, 0]),   # the hardware check's shape
    (2, 4, 24, 16, [20, -1, 30]),
    (1, 2, 130, 40, [65, 129]),
    (3, 1, 200, 128, [200, 64]),
])
def test_cross_kernel_matches_plain(cuda, dtype, tol, b, h, t, dh, valid_lens):
    """valid_len <= 0 masks every row (the mean of V); past T, none."""
    from whisper_trtllm_tpu_torch.ops.kernels import (
        cross_decode_mha,
        cross_decode_mha_reference,
    )

    rng = np.random.default_rng(t + dh)
    q = _normal(rng, (b, h * dh), dh ** -0.5, cuda, dtype)
    k = _normal(rng, (b, t, h * dh), 1.0, cuda, dtype)
    v = _normal(rng, (b, t, h * dh), 1.0, cuda, dtype)
    for vl in valid_lens:
        before = cross_decode_mha.launches
        out = cross_decode_mha(q, k, v, h, dh, vl)
        assert cross_decode_mha.launches == before + 1
        ref = cross_decode_mha_reference(q, k, v, h, dh, vl)
        assert out.dtype == dtype and out.shape == q.shape
        assert (out.float() - ref.float()).abs().max().item() <= tol
        # the chunks combine in a fixed order: bit for bit repeatable
        assert torch.equal(out, cross_decode_mha(q, k, v, h, dh, vl))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b", [4, 32])
def test_cross_kernel_is_one_launch_at_the_hardware_check_shape(
        cuda, dtype, tol, b):
    """K7 at T 1504, H 6, dh 64 over valid_len 1, 1500, T and <= 0 (the
    mean of V): each call one launch, repeatable bit for bit."""
    from whisper_trtllm_tpu_torch.ops.kernels import (
        cross_decode_mha,
        cross_decode_mha_reference,
    )

    rng = np.random.default_rng(b)
    h, t, dh = 6, 1504, 64
    q = _normal(rng, (b, h * dh), dh ** -0.5, cuda, dtype)
    k = _normal(rng, (b, t, h * dh), 1.0, cuda, dtype)
    v = _normal(rng, (b, t, h * dh), 1.0, cuda, dtype)
    for vl in (1, 1500, t, 0, -3):
        before = cross_decode_mha.launches
        out = cross_decode_mha(q, k, v, h, dh, vl)
        assert cross_decode_mha.launches == before + 1
        ref = cross_decode_mha_reference(q, k, v, h, dh, vl)
        assert (out.float() - ref.float()).abs().max().item() <= tol
        assert torch.equal(out, cross_decode_mha(q, k, v, h, dh, vl))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape", [(512, 384), (7, 33), (1000, 1536),
                                   (6000, 1536), (3, 100003)])
def test_bias_gelu_kernel_matches_plain(cuda, dtype, tol, shape):
    from whisper_trtllm_tpu_torch.examples.custom_kernel.custom_gelu_kernel \
        import fused_bias_gelu, fused_bias_gelu_reference

    rng = np.random.default_rng(shape[1])
    x = _normal(rng, shape, 2.0, cuda, dtype)
    bias = _normal(rng, shape[1:], 1.0, cuda, dtype)
    before = fused_bias_gelu.launches
    out = fused_bias_gelu(x, bias)
    assert fused_bias_gelu.launches == before + 1
    ref = fused_bias_gelu_reference(x, bias)
    assert out.dtype == dtype and out.shape == x.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol
    if dtype == torch.float32:
        gelu = torch.nn.functional.gelu(x + bias)
        assert (out - gelu).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("offset", [1, 4, 8])
@pytest.mark.parametrize("what", ["x", "bias"])
def test_bias_gelu_kernel_at_unaligned_views(cuda, dtype, tol, offset, what):
    """x or bias as a view ``offset`` values into its storage: the scalar
    path of the same kernel wherever the view is off 16 bytes."""
    from whisper_trtllm_tpu_torch.examples.custom_kernel.custom_gelu_kernel \
        import fused_bias_gelu, fused_bias_gelu_reference, gelu_plan

    rows, d = 512, 384
    rng = np.random.default_rng(offset)
    kx, kb = (offset, 0) if what == "x" else (0, offset)
    x = _normal(rng, (rows * d + kx,), 2.0, cuda, dtype)[kx:].view(rows, d)
    bias = _normal(rng, (d + kb,), 1.0, cuda, dtype)[kb:]
    aligned = x.data_ptr() % 16 == 0 and bias.data_ptr() % 16 == 0
    assert aligned == (offset * x.element_size() % 16 == 0)
    assert (gelu_plan(rows, d, x.element_size(), aligned).vec > 1) == aligned
    before = fused_bias_gelu.launches
    out = fused_bias_gelu(x, bias)
    assert fused_bias_gelu.launches == before + 1
    ref = fused_bias_gelu_reference(x, bias)
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_cross_and_gelu_kernels_refuse_what_they_do_not_take(cuda):
    from whisper_trtllm_tpu_torch.examples.custom_kernel.custom_gelu_kernel \
        import fused_bias_gelu
    from whisper_trtllm_tpu_torch.ops.kernels import cross_decode_mha

    q = torch.zeros(1, 256, device=cuda)
    kv = torch.zeros(1, 8, 256, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        cross_decode_mha(q, kv, kv, 1, 256, 4)
    with pytest.raises(TypeError, match="one dtype"):
        cross_decode_mha(q, kv.bfloat16(), kv.bfloat16(), 2, 128, 4)
    kv_t = torch.zeros(1, 256, 8, device=cuda).transpose(1, 2)  # strided
    with pytest.raises(ValueError, match="contiguous"):
        cross_decode_mha(q, kv_t, kv_t, 2, 128, 4)
    with pytest.raises(RuntimeError, match="requires grad"):
        cross_decode_mha(q.requires_grad_(True), kv, kv, 2, 128, 4)
    x = torch.zeros(4, 8, device=cuda)
    with pytest.raises(TypeError, match="one dtype"):
        fused_bias_gelu(x, torch.zeros(8, device=cuda).bfloat16())
    with pytest.raises(ValueError, match="bias"):
        fused_bias_gelu(x, torch.zeros(9, device=cuda))
    with pytest.raises(RuntimeError, match="requires grad"):
        fused_bias_gelu(x.requires_grad_(True), torch.zeros(8, device=cuda))


def test_init_params_on_the_card_equals_the_cpus(cuda):
    from whisper_trtllm_tpu_torch.config import WhisperConfig
    from whisper_trtllm_tpu_torch.models.whisper import init_params
    from whisper_trtllm_tpu_torch.training.train import tree_leaves

    cfg = WhisperConfig.tiny_en()
    card = tree_leaves(init_params(cfg, seed=3))
    cpu = tree_leaves(init_params(cfg, seed=3, device="cpu"))
    assert len(card) == len(cpu) == 50
    for a, b in zip(card, cpu):
        assert a.device.type == "cuda" and a.dtype == torch.float32
        assert torch.equal(a.cpu(), b)


# step == full on the card: float KV through K2 (int8 weights: the unfused
# layer) and through K6 (float weights: one fused launch a layer), atol
# 1e-4 + rtol 1e-4 (the kernels and cuBLAS sum in other orders than the
# full forward's products; K6's projections over up to 256 terms); an int8
# KV cache, 1e-2 of the largest |logit| (the step reads K and V rounded to
# 8 bits, the full forward exact; 3.9e-3 on the CPU at this config).
@pytest.mark.parametrize("weights,kv", [("int8", "float"), ("float", "float"),
                                        ("float", "int8")])
def test_decode_step_matches_teacher_forced_on_the_card(cuda, weights, kv):
    from whisper_trtllm_tpu_torch.config import WhisperConfig
    from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
    from whisper_trtllm_tpu_torch.quantization import weight_only_quantize
    from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy

    cfg = WhisperConfig.testing(d_model=128, encoder_attention_heads=2,
                                decoder_attention_heads=2,
                                encoder_ffn_dim=256, decoder_ffn_dim=256,
                                vocab_size=128, max_source_positions=40)
    params = wmodel.init_params(cfg, seed=1, device=cuda)
    if weights == "int8":
        params = params_from_numpy(weight_only_quantize(params), cuda)
    rng = np.random.default_rng(2)
    mel = _normal(rng, (2, 2 * cfg.max_source_positions, cfg.num_mel_bins),
                  1.0, cuda, torch.float32)
    s = 8
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)).to(cuda)
    with torch.no_grad():
        enc = wmodel.encode(params, cfg, mel)
        full = wmodel.decode_full(params, cfg, toks, enc)
        cross = wmodel.compute_cross_kv(params, cfg, enc)
        if kv == "int8":
            cross = wmodel.quantize_cross_kv(*cross)
            self_kv = wmodel.init_self_kv_int8(cfg, 2, s)
        else:
            self_kv = wmodel.init_self_kv(cfg, 2, s)
        reset_launch_counts()
        steps = []
        for i in range(s):
            logits, self_kv = wmodel.decode_step_kv(params, cfg, toks[:, i],
                                                    i, self_kv, cross)
            steps.append(logits)
    steps = torch.stack(steps, dim=1)
    fused = weights == "float" and kv == "float"
    layers = cfg.decoder_layers
    assert KERNELS["fused_decoder_layer_step"].launches == (
        layers * s if fused else 0)
    assert KERNELS["decode_attn"].launches == (0 if fused else 2 * layers * s)
    diff = (steps - full).abs()
    if kv == "int8":
        assert 0 < diff.max().item() <= 1e-2 * full.abs().max().item()
    else:
        assert (diff <= 1e-4 + 1e-4 * full.abs()).all(), diff.max().item()


def test_gpu_check_passes_on_the_card(cuda, tmp_path, monkeypatch, capsys):
    from whisper_trtllm_tpu_torch.cli import gpu_check

    state = tmp_path / "state.json"
    monkeypatch.setenv(gpu_check.STATE_PATH_ENV, str(state))
    assert gpu_check.main([]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["pass"] is True
    assert out["cross_attn_kernel"]["launches"] == {"cross_decode_mha": 1}
    record = json.loads(state.read_text())
    assert record["pass"] is True
    assert record["kernel_tree_digest"] == gpu_check.kernel_tree_digest()


# the bench's timed pipeline (cli/bench.py) on the card against the CPU, in
# fp32: float KV (K6 at this batch), int8 KV, and int8 weights through the
# session's chain with int8 KV on mels; int8 KV on audio through K3
@pytest.mark.parametrize("kv,weights,frontend", [
    ("auto", "native", False), ("int8", "native", False),
    ("int8", "int8", False), ("int8", "native", True)])
def test_bench_pipeline_on_the_card_equals_the_cpu(cuda, kv, weights,
                                                   frontend):
    from whisper_trtllm_tpu_torch.cli import bench
    from whisper_trtllm_tpu_torch.config import WhisperConfig

    cfg = WhisperConfig.testing(d_model=128, encoder_attention_heads=2,
                                decoder_attention_heads=2,
                                encoder_ffn_dim=256, decoder_ffn_dim=256,
                                vocab_size=128,
                                max_source_positions=1500 if frontend else 40,
                                num_mel_bins=80 if frontend else 16)
    rng = np.random.default_rng(6)
    if frontend:
        x = rng.standard_normal((2, 480000)).astype(np.float32) * 0.1
    else:
        x = rng.standard_normal((3, 2 * cfg.max_source_positions,
                                 cfg.num_mel_bins)).astype(np.float32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        session = bench.bench_session(cfg, kv, "float32", weight_dtype=weights,
                                      gen_tokens=12, seed=3, device=dev)
        reset_launch_counts()
        out[dev.type] = bench.run_pass(
            session, [torch.from_numpy(x).to(dev)], frontend)
        if dev.type == "cuda":
            launches = {k: f.launches for k, f in KERNELS.items()}
    np.testing.assert_array_equal(out["cuda"], out["cpu"])
    steps, layers = 12, cfg.decoder_layers
    fused = kv == "auto" and weights == "native"
    assert launches["flash_fwd"] == cfg.encoder_layers
    assert launches["stft_log_mel"] == int(frontend)
    assert launches["fused_decoder_layer_step"] == (layers * steps
                                                    if fused else 0)
    assert launches["decode_attn"] == (0 if fused else 2 * layers * steps)


def test_memory_monitor_reports_the_peak_of_an_allocation(cuda):
    from whisper_trtllm_tpu_torch.benchmarks.mem_monitor import (
        MemoryMonitor,
        get_memory_info,
    )

    total, _, _ = get_memory_info()
    assert total > 1.0
    mon = MemoryMonitor().start()
    x = torch.empty(1 << 28, dtype=torch.uint8, device=cuda)  # 0.25 GiB
    del x
    peak = mon.stop()
    assert peak >= 0.25 and mon.stop() == peak


# -- the decode loop on the card: the captured step -------------------------

def _artifact_encoder_states(cuda, float_weights, compute):
    """The trained artifact (int8, or dequantized in memory) on the card in
    ``compute``, and the encoder states of the four bundled utterances."""
    from whisper_trtllm_tpu_torch.audio import pad_or_trim, read_wav
    from whisper_trtllm_tpu_torch.config import RuntimeConfig
    from whisper_trtllm_tpu_torch.quantization import dequantize_params
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint

    params, cfg = load_checkpoint(
        os.path.join(ROOT, "artifacts", "tiny_en_synth_int8"), device="cpu")
    if float_weights:
        params = dequantize_params(params)
    session = WhisperSession(params, cfg,
                             runtime=RuntimeConfig(compute_dtype=compute))
    audio = np.stack([pad_or_trim(read_wav(os.path.join(
        ROOT, "artifacts", "eval", f"utt{i:02d}.wav"))) for i in range(4)])
    with torch.inference_mode():
        enc = session.encode(session.frontend(audio))
    return session, enc


def _eager_decode(params, cfg, enc, gen):
    """The same step function run step by step on the card, every one of
    the ``max_len - 1`` steps, with no graph."""
    from whisper_trtllm_tpu_torch.models.whisper import model as wmodel

    max_len = min(cfg.max_target_positions, gen.max_new_tokens + 1)
    with torch.inference_mode():
        s = generation.init_state(cfg, gen, enc.shape[0], max_len, enc.dtype,
                                  enc.device)
        cross = generation.build_cross_kv(params, cfg, enc, gen)
        rules = generation.make_rules(cfg, gen, max_len, enc.device)
        generation.reset_state(s, cfg, rules)
        fused = wmodel.decode_step_plan(params, cfg, s.self_kv, cross)
        for _ in range(max_len - 1):
            generation.greedy_step(params, cfg, gen, s, cross, rules, fused)
    return s.tokens.clone(), s.lengths.clone(), fused


@pytest.mark.parametrize("weights,compute,kv,layout,fused", [
    ("int8", "float32", "auto", "auto", False),
    ("int8", "float32", "auto", "bhdt", False),
    ("int8", "bfloat16", "int8", "auto", False),
    ("int8", "float32", "int8", "bhtd", False),
    ("int8", "bfloat16", "fp8", "auto", False),
    ("int8", "float32", "fp8", "bhtd", False),
    ("float", "float32", "auto", "auto", True),
    ("float", "bfloat16", "auto", "auto", True),
])
def test_replayed_step_equals_the_eager_steps(cuda, weights, compute, kv,
                                              layout, fused):
    """The captured step replayed (twice: the capturing decode, then a
    decode that only replays) gives the tokens and lengths of the same
    step run eagerly on the card, every cache kind and layout, fused (K6)
    and unfused."""
    from whisper_trtllm_tpu_torch.config import GenerationConfig

    session, enc = _artifact_encoder_states(cuda, weights == "float", compute)
    gen = GenerationConfig(max_new_tokens=24, kv_cache_dtype=kv,
                           cross_kv_layout=layout)
    ref_toks, ref_lens, took_fused = _eager_decode(session.params,
                                                   session.cfg, enc, gen)
    assert took_fused == fused
    for _ in range(2):
        generation.reset_loop_counts()
        toks, lens = generation.greedy_decode(session.params, session.cfg,
                                              enc, gen)
        torch.testing.assert_close(toks, ref_toks, rtol=0, atol=0)
        torch.testing.assert_close(lens, ref_lens, rtol=0, atol=0)
    # the second decode replayed every step
    assert generation.LOOP.eager_steps == 0 and generation.LOOP.replays > 0
    assert generation.LOOP.captures == 0


@pytest.mark.parametrize("gen_kw", [
    dict(return_timestamps=True), dict(presence_penalty=0.5, min_new_tokens=4,
                                       bad_words=((13,), (262, 11))),
    dict(temperature=0.8, top_k=20, top_p=0.9, seed=5),
], ids=["timestamps", "word-rules", "sampled"])
def test_replayed_processors_equal_the_eager_steps(cuda, gen_kw):
    """The processors inside the graph: timestamp rules, penalties and word
    rules, and the counter-based draw (one draw a seed and position)."""
    import dataclasses as dc

    from whisper_trtllm_tpu_torch.config import GenerationConfig

    session, enc = _artifact_encoder_states(cuda, False, "float32")
    cfg = dc.replace(session.cfg, no_timestamps_token_id=50362)
    gen = GenerationConfig(max_new_tokens=24, **gen_kw)
    ref_toks, ref_lens, _ = _eager_decode(session.params, cfg, enc, gen)
    toks, lens = generation.greedy_decode(session.params, cfg, enc, gen)
    torch.testing.assert_close(toks, ref_toks, rtol=0, atol=0)
    torch.testing.assert_close(lens, ref_lens, rtol=0, atol=0)


def test_capture_raises_when_the_step_would_sync(cuda, monkeypatch):
    """A step that reads a device value on the host cannot be captured: the
    decode raises, no entry is kept, the counters are not moved by the
    failed capture, and nothing falls back to an eager loop."""
    from whisper_trtllm_tpu_torch.config import GenerationConfig

    session, enc = _artifact_encoder_states(cuda, False, "float32")
    gen = GenerationConfig(max_new_tokens=6, seed=17)
    real = generation.greedy_step

    def syncing(params, cfg, g, s, *rest):
        int(s.pos)  # a host read of a device value
        return real(params, cfg, g, s, *rest)

    generation.drop_graphs()
    monkeypatch.setattr(generation, "greedy_step", syncing)
    reset_launch_counts()
    with pytest.raises(RuntimeError):
        generation.greedy_decode(session.params, session.cfg, enc, gen)
    torch.cuda.synchronize()
    assert not generation._GRAPHS
    warm = {n: f.launches for n, f in KERNELS.items()}
    assert warm["decode_attn"] == 2 * session.cfg.decoder_layers  # 1 step
    monkeypatch.setattr(generation, "greedy_step", real)
    toks, _ = generation.greedy_decode(session.params, session.cfg, enc, gen)
    assert toks.shape == (4, 7)


def test_capture_survives_garbage_that_holds_a_graph(cuda):
    """A captured graph left in a reference cycle is freed by the garbage
    collector; a collection while another step is being captured would
    destroy it mid-capture, which CUDA refuses (the capture fails). The
    capture collects first and holds the collector off."""
    import gc

    from whisper_trtllm_tpu_torch.config import GenerationConfig

    session, enc = _artifact_encoder_states(cuda, False, "float32")
    gen = GenerationConfig(max_new_tokens=6, seed=23)
    generation.drop_graphs()
    x = torch.zeros(4, device=cuda)
    junk = [torch.cuda.CUDAGraph()]
    with torch.cuda.graph(junk[0]):
        x.add_(1)
    junk.append(junk)
    del junk
    threshold = gc.get_threshold()
    gc.set_threshold(1)  # a collection at nearly every allocation
    try:
        toks, _ = generation.greedy_decode(session.params, session.cfg, enc,
                                           gen)
    finally:
        gc.set_threshold(*threshold)
    assert toks.shape == (4, 7) and len(generation._GRAPHS) == 1


_KERNEL_SYMBOLS = {"decode_attn": ("decode_dh_minor", "decode_direct",
                                   "decode_t_minor"),
                   "layer_norm": ("layer_norm_kernel", "layer_norm_wide_kernel"),
                   "fused_decoder_layer_step": ("fused_step_kernel",)}


@pytest.mark.parametrize("weights,compute,kv", [
    ("int8", "bfloat16", "int8"), ("float", "float32", "auto")])
def test_counters_equal_a_profiler_count_of_one_replayed_decode(
        cuda, weights, compute, kv):
    """Over a decode that only replays, each wrapper's counter equals the
    kernel launches the profiler traces by the kernel's name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from whisper_trtllm_tpu_torch.config import GenerationConfig

    session, enc = _artifact_encoder_states(cuda, weights == "float", compute)
    gen = GenerationConfig(max_new_tokens=20, kv_cache_dtype=kv)
    generation.greedy_decode(session.params, session.cfg, enc, gen)
    torch.cuda.synchronize()
    reset_launch_counts()
    generation.reset_loop_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        generation.greedy_decode(session.params, session.cfg, enc, gen)
        torch.cuda.synchronize()
    assert generation.LOOP.replays > 0 and generation.LOOP.eager_steps == 0
    traced = {k: 0 for k in _KERNEL_SYMBOLS}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for k, names in _KERNEL_SYMBOLS.items():
            traced[k] += any(n in e.name for n in names)
    counted = {k: KERNELS[k].launches for k in _KERNEL_SYMBOLS}
    assert counted == traced and sum(counted.values()) > 0


def test_refit_leaves_no_graph_replaying_old_weights(cuda):
    """A session captures its step, refits to other weights, and then
    transcribes as a fresh session on those weights does: no entry of the
    old weights is left."""
    from whisper_trtllm_tpu_torch.config import GenerationConfig
    from whisper_trtllm_tpu_torch.quantization import dequantize_params
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint

    params, cfg = load_checkpoint(
        os.path.join(ROOT, "artifacts", "tiny_en_synth_int8"), device="cpu")
    other = dequantize_params(params)
    bias = other["decoder"]["layer_norm"]["bias"]
    other["decoder"]["layer_norm"]["bias"] = bias + 0.5 * torch.from_numpy(
        np.random.default_rng(9).standard_normal(bias.shape).astype(
            np.float32))
    gen = GenerationConfig(max_new_tokens=16)
    rng = np.random.default_rng(10)
    mel = rng.standard_normal((2, 3000, 80)).astype(np.float32)
    generation.drop_graphs()
    session = WhisperSession(dequantize_params(params), cfg, gen)
    before, _ = session.transcribe_features(mel)
    old = generation._decoder_leaves(session.params)
    assert any(e.matches(old) for e in generation._GRAPHS.values())
    session.refit(other)
    assert not any(e.matches(old) for e in generation._GRAPHS.values())
    after, after_lens = session.transcribe_features(mel)
    fresh, fresh_lens = WhisperSession(other, cfg, gen).transcribe_features(mel)
    np.testing.assert_array_equal(after, fresh)
    np.testing.assert_array_equal(after_lens, fresh_lens)
    assert not np.array_equal(before, after)


# -- the int4, fp8-QDQ and SmoothQuant weight modes on the card -------------

@pytest.mark.parametrize("rows", [1, 4, 16, 17, 6000])
@pytest.mark.parametrize("k,n", [(384, 1536), (1536, 384)])
def test_int8_matmul_on_the_card_equals_the_cpus(cuda, rows, k, n):
    """SmoothQuant's product: ``torch._int_mm`` (rows below 17 padded with
    zero rows) equals the CPU's int32 product exactly, a sum past 2^24
    included."""
    from whisper_trtllm_tpu_torch.ops.functional import int8_matmul

    g = torch.Generator().manual_seed(rows + k)
    a = torch.randint(-127, 128, (rows, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    a[0], b[:, 1] = 127, 127
    want = int8_matmul(a, b)
    got = int8_matmul(a.to(cuda), b.to(cuda))
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    assert int(want[0, 1]) == k * 127 ** 2
    # (B, 1, K) rows, as the decode step gives them
    got3 = int8_matmul(a[:, None].to(cuda), b.to(cuda))
    assert torch.equal(got3.cpu(), want[:, None])


def test_int_mm_takes_more_than_16_rows_so_int8_matmul_pads(cuda):
    """Why ``int8_matmul`` pads: ``torch._int_mm`` on CUDA refuses a first
    dim of 16 or less (torch 2.11.0+cu128) and takes 17."""
    a = torch.ones(17, 384, dtype=torch.int8, device=cuda)
    b = torch.ones(384, 384, dtype=torch.int8, device=cuda)
    assert int(torch._int_mm(a, b)[0, 0]) == 384
    with pytest.raises(RuntimeError, match="greater than 16"):
        torch._int_mm(a[:16], b)


def test_fp8_cast_and_int4_unpack_on_the_card_equal_the_cpus(cuda):
    """The card's float8_e4m3fn cast over in-range values (±448, the
    subnormals, round-to-even ties, every finite bf16 value up to 448),
    the fp8 QDQ and SmoothQuant's per-token int8 of activations (their
    scales a true division: torch's CUDA division by a Python number is
    a product with its reciprocal), and the int4 unpack of every byte, bit
    for bit against the CPU's."""
    from whisper_trtllm_tpu_torch.ops.functional import (
        smooth_quant_activation,
    )
    from whisper_trtllm_tpu_torch.quantization import (
        fp8_qdq_activation,
        unpack_int4_kernel,
    )

    g = torch.Generator().manual_seed(11)
    sub = 2.0 ** -9                    # e4m3's smallest subnormal
    edges = torch.tensor([448.0, -448.0, 0.0, -0.0, sub, -sub, 0.5 * sub,
                          1.5 * sub, 2.5 * sub, 2.0 ** -6, 1.0625, 1.1875,
                          232.0, 240.0, 416.0, 440.0, 447.99])
    every_bf16 = torch.arange(0, 1 << 16, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).float()
    x = torch.cat([edges, every_bf16] + [torch.randn(1 << 18, generator=g) * s
                                         for s in (1.0, 30.0, 1e-2, 1e-3)])
    x = x[x.abs() <= 448]
    want = x.to(torch.float8_e4m3fn).view(torch.uint8)
    got = x.to(cuda).to(torch.float8_e4m3fn).view(torch.uint8).cpu()
    assert torch.equal(got, want)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((4, 1, 384), (4, 1500, 384), (4, 1, 1536), (1, 1, 384)):
            for _ in range(4):
                act = (torch.randn(shape, generator=g) * 3).to(dtype)
                assert torch.equal(fp8_qdq_activation(act.to(cuda)).cpu(),
                                   fp8_qdq_activation(act))
                smooth = torch.rand(shape[-1], generator=g) + 0.5
                got = smooth_quant_activation(act.to(cuda), smooth.to(cuda))
                want = smooth_quant_activation(act, smooth)
                assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
        packed = torch.arange(-128, 128, dtype=torch.int8).reshape(2, 8, 16)
        assert torch.equal(unpack_int4_kernel(packed.to(cuda), dtype).cpu(),
                           unpack_int4_kernel(packed, dtype))


def _mode_session(cuda, mode, compute):
    """The artifact's float tree on the card in ``mode`` ("int4", "fp8":
    the session's chain; "smooth": calibrated on the card with the four
    mels and the first 16 tokens of the float tree's greedy decode), and
    the encoder states of the four bundled utterances."""
    from whisper_trtllm_tpu_torch.audio import pad_or_trim, read_wav
    from whisper_trtllm_tpu_torch.config import RuntimeConfig
    from whisper_trtllm_tpu_torch.quantization import (
        dequantize_params,
        smooth_quantize_whisper,
        whisper_act_stats,
    )
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint

    params, cfg = load_checkpoint(
        os.path.join(ROOT, "artifacts", "tiny_en_synth_int8"))
    tree, wd = dequantize_params(params), mode
    audio = np.stack([pad_or_trim(read_wav(os.path.join(
        ROOT, "artifacts", "eval", f"utt{i:02d}.wav"))) for i in range(4)])
    if mode == "smooth":
        ref = WhisperSession(tree, cfg)
        with torch.inference_mode():
            mel = ref.frontend(audio)
        toks, _ = ref.transcribe(audio)
        tree = smooth_quantize_whisper(tree, whisper_act_stats(
            tree, cfg, mel, toks[:, :16]))
        wd = "native"
    session = WhisperSession(tree, cfg, runtime=RuntimeConfig(
        compute_dtype=compute, weight_dtype=wd))
    with torch.inference_mode():
        enc = session.encode(session.frontend(audio))
    return session, enc


@pytest.mark.parametrize("mode,compute,kv", [
    ("int4", "float32", "auto"), ("int4", "bfloat16", "int8"),
    ("fp8", "float32", "auto"), ("fp8", "bfloat16", "int8"),
    ("smooth", "float32", "auto"), ("smooth", "bfloat16", "int8"),
])
def test_replayed_step_of_a_quantized_tree_equals_the_eager_steps(
        cuda, mode, compute, kv):
    """The captured decode step with int4, fp8 and SmoothQuant projections
    (their unpack, QDQ and int8 product inside the graph) replays the same
    step run eagerly on the card bit for bit, and takes the unfused path
    (K6's gate refuses quantized projections)."""
    from whisper_trtllm_tpu_torch.config import GenerationConfig

    session, enc = _mode_session(cuda, mode, compute)
    gen = GenerationConfig(max_new_tokens=24, kv_cache_dtype=kv)
    ref_toks, ref_lens, took_fused = _eager_decode(session.params,
                                                   session.cfg, enc, gen)
    assert not took_fused
    for _ in range(2):
        generation.reset_loop_counts()
        toks, lens = generation.greedy_decode(session.params, session.cfg,
                                              enc, gen)
        torch.testing.assert_close(toks, ref_toks, rtol=0, atol=0)
        torch.testing.assert_close(lens, ref_lens, rtol=0, atol=0)
    assert generation.LOOP.eager_steps == 0 and generation.LOOP.replays > 0
    assert generation.LOOP.captures == 0


# -- beam search on the card: the captured beam step ------------------------

def _eager_beam(params, cfg, enc, gen):
    """The beam step run step by step on the card, every one of the
    ``max_len - 1`` steps (those after ``go`` fell are no-ops), with no
    graph; then the finalization."""
    from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
    from whisper_trtllm_tpu_torch.runtime import beam

    max_len = min(cfg.max_target_positions, gen.max_new_tokens + 1)
    with torch.inference_mode():
        s = beam.init_beam_state(cfg, gen, enc.shape[0], max_len, enc.dtype,
                                 enc.device)
        cross = beam.tile_cross(
            generation.build_cross_kv(params, cfg, enc, gen), gen.num_beams)
        rules = generation.make_rules(cfg, gen, max_len, enc.device)
        beam.reset_beam_state(s, cfg, rules)
        fused = wmodel.decode_step_plan(params, cfg, s.self_kv, cross)
        for _ in range(max_len - 1):
            beam.beam_step(params, cfg, gen, s, cross, rules, fused)
        out = beam.finalize(s, gen, rules.prompt_len)
    return out, fused


@pytest.mark.parametrize("weights,compute,kv,layout,k,fused", [
    ("float", "float32", "auto", "auto", 4, True),
    ("float", "bfloat16", "auto", "auto", 4, True),
    ("float", "float32", "auto", "auto", 5, False),
    ("int8", "float32", "int8", "bhtd", 2, False),
    ("int8", "bfloat16", "int8", "auto", 4, False),
    ("int8", "bfloat16", "fp8", "auto", 2, False),
])
def test_replayed_beam_step_equals_the_eager_steps(cuda, weights, compute,
                                                   kv, layout, k, fused):
    """The captured beam step replayed (the capturing decode, then one
    that only replays) gives every hypothesis, score and length of the
    same step run eagerly on the card: float and quantized caches, fused
    (K6, B·K <= 16) and unfused (K2) steps."""
    from whisper_trtllm_tpu_torch.config import GenerationConfig
    from whisper_trtllm_tpu_torch.runtime import beam

    session, enc = _artifact_encoder_states(cuda, weights == "float", compute)
    gen = GenerationConfig(max_new_tokens=24, num_beams=k, kv_cache_dtype=kv,
                           cross_kv_layout=layout, early_stopping=False)
    ref, took_fused = _eager_beam(session.params, session.cfg, enc, gen)
    assert took_fused == fused
    generation.drop_graphs()
    for i in range(2):
        generation.reset_loop_counts()
        out = beam.beam_decode(session.params, session.cfg, enc, gen)
        for got, want in zip(out, ref):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        if i == 0:
            assert generation.LOOP.eager_steps == generation.WARMUP_STEPS
            assert generation.LOOP.captures == 1
    assert generation.LOOP.eager_steps == 0 and generation.LOOP.captures == 0
    assert generation.LOOP.replays > 0


def test_beam_replays_after_go_fell_change_nothing(cuda):
    """Once ``go`` falls (every pool full), further replays leave the
    pools, the alive beams, ``pos`` and what ``finalize`` returns as they
    were."""
    from whisper_trtllm_tpu_torch.config import GenerationConfig
    from whisper_trtllm_tpu_torch.runtime import beam

    session, enc = _artifact_encoder_states(cuda, True, "float32")
    gen = GenerationConfig(max_new_tokens=40, num_beams=2)
    generation.drop_graphs()
    out = beam.beam_decode(session.params, session.cfg, enc, gen)
    entry = next(reversed(generation._GRAPHS.values()))
    s = entry.state
    assert not bool(s.go) and int(s.pos) < 40
    before = [t.clone() for t in (s.alive_tokens, s.alive_scores,
                                  s.finished_tokens, s.finished_scores,
                                  s.finished_lengths, s.pos, s.es_unsat)]
    for _ in range(12):
        entry.replay()
    after = (s.alive_tokens, s.alive_scores, s.finished_tokens,
             s.finished_scores, s.finished_lengths, s.pos, s.es_unsat)
    for got, want in zip(after, before):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with torch.inference_mode():
        again = beam.finalize(s, gen, entry.rules.prompt_len)
    for got, want in zip(again, out):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_beam_capture_raises_when_the_step_would_sync(cuda, monkeypatch):
    """A beam step that reads a device value on the host cannot be
    captured: the decode raises and keeps no entry."""
    from whisper_trtllm_tpu_torch.config import GenerationConfig
    from whisper_trtllm_tpu_torch.runtime import beam

    session, enc = _artifact_encoder_states(cuda, False, "float32")
    gen = GenerationConfig(max_new_tokens=6, num_beams=2)
    real = beam.beam_step

    def syncing(params, cfg, g, s, *rest):
        bool(s.go)  # a host read of a device value
        return real(params, cfg, g, s, *rest)

    generation.drop_graphs()
    monkeypatch.setattr(beam, "beam_step", syncing)
    with pytest.raises(RuntimeError):
        beam.beam_decode(session.params, session.cfg, enc, gen)
    torch.cuda.synchronize()
    assert not generation._GRAPHS
    monkeypatch.setattr(beam, "beam_step", real)
    toks, _, _ = beam.beam_decode(session.params, session.cfg, enc, gen)
    assert toks.shape == (4, 2, 7)


@pytest.mark.parametrize("weights,compute,kv", [
    ("int8", "bfloat16", "int8"), ("float", "float32", "auto")])
def test_counters_equal_a_profiler_count_of_one_replayed_beam_decode(
        cuda, weights, compute, kv):
    """Over a beam decode that only replays, at batch B·K = 16 (fused in
    float, K2 with int8 caches), each wrapper's counter equals the kernel
    launches the profiler traces by the kernel's name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from whisper_trtllm_tpu_torch.config import GenerationConfig
    from whisper_trtllm_tpu_torch.runtime import beam

    session, enc = _artifact_encoder_states(cuda, weights == "float", compute)
    gen = GenerationConfig(max_new_tokens=20, num_beams=4, kv_cache_dtype=kv)
    beam.beam_decode(session.params, session.cfg, enc, gen)
    torch.cuda.synchronize()
    reset_launch_counts()
    generation.reset_loop_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        beam.beam_decode(session.params, session.cfg, enc, gen)
        torch.cuda.synchronize()
    assert generation.LOOP.replays > 0 and generation.LOOP.eager_steps == 0
    traced = {k: 0 for k in _KERNEL_SYMBOLS}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for k, names in _KERNEL_SYMBOLS.items():
            traced[k] += any(n in e.name for n in names)
    counted = {k: KERNELS[k].launches for k in _KERNEL_SYMBOLS}
    assert counted == traced and sum(counted.values()) > 0
    layers = session.cfg.decoder_layers
    steps = generation.LOOP.steps
    if weights == "float":
        assert counted["fused_decoder_layer_step"] == layers * steps
    else:
        assert counted["decode_attn"] == 2 * layers * steps


# --------------------------------------------------------------------------
# serving: the in-flight batcher's captured ragged step; the native library
# --------------------------------------------------------------------------

def _serve_inputs(cuda):
    from whisper_trtllm_tpu_torch.audio import read_wav
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint

    params, cfg = load_checkpoint(
        os.path.join(ROOT, "artifacts", "tiny_en_synth_int8"), device=cuda)
    waves = [read_wav(os.path.join(ROOT, "artifacts", "eval",
                                   f"utt{i:02d}.wav")) for i in range(4)]
    return params, cfg, waves


def _batcher(params, cfg, kv, cuda, eager=False):
    from whisper_trtllm_tpu_torch.config import GenerationConfig
    from whisper_trtllm_tpu_torch.runtime.ifb import InflightBatcher

    b = InflightBatcher(params, cfg, GenerationConfig(
        max_new_tokens=24, kv_cache_dtype=kv), num_lanes=2, segment_steps=8,
        device=cuda)
    if eager:
        b._graph = None  # its segments run the step eagerly on the card
    return b


def _serve_drain(b, waves):
    rids = [b.submit_audio(w) for w in waves]
    b.run()
    return [b.fetch(r) for r in rids]


def _lane_tensors(b):
    def raw(t):
        return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t

    s = b.state
    return [s.tokens, s.pos, b._flags] + [raw(t) for t in s.self_kv] + [
        raw(t) for t in s.cross_kv]


@pytest.mark.parametrize("kv", ["auto", "int8", "fp8"])
def test_captured_ragged_step_equals_the_eager_steps(cuda, kv):
    """The batcher's captured step, replayed segment by segment, gives the
    rows and the lanes' final state (tokens, positions, flags, every
    cache) of the same step run eagerly on the card, bit for bit."""
    params, cfg, waves = _serve_inputs(cuda)
    graph = _batcher(params, cfg, kv, cuda)
    eager = _batcher(params, cfg, kv, cuda, eager=True)
    generation.reset_loop_counts()
    rows = _serve_drain(graph, waves)
    assert generation.LOOP.replays == graph.steps_run > 0
    assert generation.LOOP.eager_steps == 0
    want = _serve_drain(eager, waves)
    assert generation.LOOP.eager_steps == eager.steps_run == graph.steps_run
    for r, w in zip(rows, want):
        np.testing.assert_array_equal(r, w)
    for a, b in zip(_lane_tensors(graph), _lane_tensors(eager)):
        assert torch.equal(a, b)


def test_batcher_replays_with_no_live_lane_change_nothing(cuda):
    params, cfg, waves = _serve_inputs(cuda)
    b = _batcher(params, cfg, "int8", cuda)
    _serve_drain(b, waves)
    before = [t.clone() for t in _lane_tensors(b)]
    for _ in range(5):
        b._graph.replay()
    torch.cuda.synchronize()
    for a, w in zip(_lane_tensors(b), before):
        assert torch.equal(a, w)


def test_an_admit_into_a_captured_batcher_is_seen_by_the_next_replay(cuda):
    params, cfg, waves = _serve_inputs(cuda)
    graph = _batcher(params, cfg, "int8", cuda)
    eager = _batcher(params, cfg, "int8", cuda, eager=True)
    for b in (graph, eager):
        b.submit_audio(waves[2])
        b._retire_and_admit()
    graph._graph.replay()
    eager._step()
    torch.cuda.synchronize()
    assert graph.state.pos.tolist() == [1, 0]
    forced = dict(cfg.forced_decoder_ids)[1]
    assert int(graph.state.tokens[0, 1]) == forced
    for a, b in zip(_lane_tensors(graph), _lane_tensors(eager)):
        assert torch.equal(a, b)


def test_a_capture_survives_a_frontend_call_from_another_thread(cuda):
    """A handler thread runs the frontend (K3, allocations, host reads)
    while a batcher is built and captures its step: neither fails, the
    thread's mels are right, its K3 launches all stay counted and none
    is taken for the graph's, and the batcher serves the 4 texts."""
    import threading

    from whisper_trtllm_tpu_torch.audio import LogMelSpectrogram, pad_or_trim
    from whisper_trtllm_tpu_torch.utils.vocab import ids_to_text

    params, cfg, waves = _serve_inputs(cuda)
    fe = LogMelSpectrogram(cfg.num_mel_bins, device=cuda)
    audio = pad_or_trim(waves[1])[None]
    with torch.inference_mode():
        want = fe(audio).clone()
    stop, errors, calls, wrong = threading.Event(), [], [0], [0]
    reset_launch_counts()

    def frontend():
        try:
            with torch.inference_mode():
                while not stop.is_set():
                    wrong[0] += not torch.equal(fe(audio), want)
                    calls[0] += 1
        except Exception as e:  # noqa: BLE001 — the finding
            errors.append(e)

    thread = threading.Thread(target=frontend)
    thread.start()
    try:
        while calls[0] < 3 and not errors:
            pass
        before = calls[0]
        generation.reset_loop_counts()
        b = _batcher(params, cfg, "auto", cuda)
        during = calls[0] - before
    finally:
        stop.set()
        thread.join()
    assert not errors and not wrong[0]
    assert generation.LOOP.captures == 1 and during > 0
    ld = cfg.decoder_layers
    assert b._graph.launches == {"decode_attn": 2 * ld,
                                 "layer_norm": 3 * ld + 1}
    assert KERNELS["stft_log_mel"].launches == calls[0]
    with open(os.path.join(ROOT, "artifacts", "expected.json")) as f:
        expected = json.load(f)["texts"]
    assert [ids_to_text(r) for r in _serve_drain(b, waves)] == expected


def test_native_library_builds_with_gpp_alone(cuda, tmp_path, monkeypatch):
    """On the card's machine: ``cpp/`` builds into libwtpu.so with g++ (no
    cmake, no ninja) and decodes a WAV."""
    import ctypes

    from whisper_trtllm_tpu_torch.native import lib

    monkeypatch.setattr(lib, "BUILD_DIR", tmp_path)
    path = lib.build_native()
    assert path.startswith(str(tmp_path))
    so = ctypes.CDLL(path)
    assert so.wtpu_load_wav16k is not None
    with open(os.path.join(ROOT, "artifacts", "eval", "utt00.wav"),
              "rb") as f:
        audio = lib.load_wav_16k(f.read())
    assert audio.dtype == np.float32 and 16000 < len(audio) < 480000


# --------------------------------------------------------------------------
# quantize_kv's scales, decode_chunk and the captured speculative round
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("h", [6, 20])
@pytest.mark.parametrize("b", [1, 4, 16, 32])
def test_quantize_kv_on_the_card_equals_the_cpus(cuda, kind, h, b):
    """Values and scales bit-equal to the CPU's at the decode step's
    shapes (8 positions a head), each row's magnitude drawn over 20
    octaves: a division by 127 or 448 taken as a product with the
    reciprocal would land some scales one bit off."""
    rng = np.random.default_rng(b * 100 + h)
    x = (rng.standard_normal((b, h, 8, 64))
         * 2.0 ** rng.uniform(-10, 10, (b, h, 8, 1))).astype(np.float32)
    xc = torch.from_numpy(x)
    q_cpu, s_cpu = quantize_kv(xc, _QUANT[kind])
    q, s = quantize_kv(xc.to(cuda), _QUANT[kind])
    assert torch.equal(s.cpu(), s_cpu)
    assert torch.equal(q.cpu().view(torch.uint8), q_cpu.view(torch.uint8))


def _spec_inputs(cuda, float_weights, compute="float32"):
    """The trained artifact (int8, or dequantized in memory) on the card in
    ``compute``, its CPU twin in fp32, and the four bundled utterances'
    mels (1, 3000, 80) made on the card by K3."""
    from whisper_trtllm_tpu_torch.audio import (
        LogMelSpectrogram,
        pad_or_trim,
        read_wav,
    )
    from whisper_trtllm_tpu_torch.models.whisper import cast_params
    from whisper_trtllm_tpu_torch.quantization import dequantize_params
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint

    params, cfg = load_checkpoint(
        os.path.join(ROOT, "artifacts", "tiny_en_synth_int8"), device="cpu")
    if float_weights:
        params = dequantize_params(params)
    card = _to(cast_params(params, getattr(torch, compute)), cuda)
    frontend = LogMelSpectrogram(cfg.num_mel_bins, device=cuda)
    mels = [frontend(pad_or_trim(read_wav(os.path.join(
        ROOT, "artifacts", "eval", f"utt{i:02d}.wav")))[None])
        for i in range(4)]
    return card, params, cfg, mels


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _eager_spec(t, d, cfg, mel, gen, gamma):
    """The speculative round run round by round on the card with no graph,
    until ``go`` falls: (tokens, length, rounds, accepted)."""
    from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
    from whisper_trtllm_tpu_torch.runtime import speculative as sp

    max_len = min(cfg.max_target_positions, gen.max_new_tokens + 1)
    with torch.inference_mode():
        mel = mel.to(t["encoder"]["conv1"]["kernel"].dtype)
        t_enc, d_enc = wmodel.encode(t, cfg, mel), wmodel.encode(d, cfg, mel)
        s = sp.init_spec_state(cfg, cfg, max_len, t_enc.dtype, d_enc.dtype,
                               mel.device)
        cross = (wmodel.compute_cross_kv(t, cfg, t_enc),
                 wmodel.compute_cross_kv(d, cfg, d_enc))
        rules = sp.make_spec_rules(cfg, max_len, gamma, mel.device)
        sp.reset_spec_state(s, cfg, rules)
        sp.prefill(t, cfg, d, cfg, s, cross, rules)
        fused = wmodel.decode_step_plan(d, cfg, s.d_self, cross[1])
        while bool(s.go):
            sp.spec_round(t, cfg, d, cfg, s, cross, rules, fused)
    return (s.tokens.clone(), s.pos + 1, s.rounds.clone(),
            s.accepted.clone()), fused


def test_decode_chunk_on_the_card_within_fp32_of_the_cpus(cuda):
    """Three steps, then a 5-token chunk at pos 3 on the artifact: logits
    and self caches on the card within 1e-4 + 1e-4·|CPU| of the CPU's
    (fp32 products summed in another order over four layers)."""
    from whisper_trtllm_tpu_torch.models.whisper import decode_chunk
    from whisper_trtllm_tpu_torch.models.whisper import model as wmodel

    card, cpu, cfg, mels = _spec_inputs(cuda, False)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 8)).astype(np.int32))
    outs = []
    for params, mel in ((card, mels[0]), (cpu, mels[0].cpu())):
        dev = mel.device
        with torch.inference_mode():
            enc = wmodel.encode(params, cfg, mel)
            cross = wmodel.compute_cross_kv(params, cfg, enc)
            kv = wmodel.init_self_kv(cfg, 1, 12, device=dev)
            for i in range(3):
                _, kv = wmodel.decode_step_kv(params, cfg, toks[:, i].to(dev),
                                              i, kv, cross)
            pos = torch.tensor(3, dtype=torch.int32, device=dev)
            logits, kv = decode_chunk(params, cfg, toks[:, 3:].to(dev), pos,
                                      kv, cross)
        outs.append([logits.cpu(), kv[0].cpu(), kv[1].cpu()])
    for got, want in zip(*outs):
        assert ((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all(), \
            (got - want).abs().max().item()


@pytest.mark.parametrize("weights,compute,fused", [
    ("int8", "float32", False), ("float", "float32", True),
    ("float", "bfloat16", True)])
def test_captured_round_equals_the_eager_rounds(cuda, weights, compute,
                                                fused):
    """The artifact as its own draft, gamma 4: the captured round replayed
    (the capturing call, then one that only replays) gives the tokens,
    length, rounds and accepted of the same round run eagerly on the card,
    with K2 (int8 tree) or K6 (float tree) in the draft's steps."""
    from whisper_trtllm_tpu_torch.config import GenerationConfig
    from whisper_trtllm_tpu_torch.runtime import speculative as sp

    card, _, cfg, mels = _spec_inputs(cuda, weights == "float", compute)
    gen = GenerationConfig(max_new_tokens=24)
    ref, took_fused = _eager_spec(card, card, cfg, mels[3], gen, 4)
    assert took_fused == fused
    generation.drop_graphs()
    for i in range(2):
        generation.reset_loop_counts()
        out = sp.speculative_transcribe_tokens(card, cfg, card, cfg, mels[3],
                                               gen, gamma=4, with_stats=True)
        for got, want in zip(out, ref):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert generation.LOOP.captures == (1 if i == 0 else 0)
        assert generation.LOOP.eager_steps == (
            generation.WARMUP_STEPS if i == 0 else 0)
        assert generation.LOOP.steps == int(out[2])
    generation.drop_graphs()


def test_spec_replays_after_go_fell_change_nothing(cuda):
    """Replays of the captured round after the loop's end, where pos +
    gamma + 1 passes the buffer: no device assert, and the tokens, pos,
    stats, go and both self caches stay as they were."""
    from whisper_trtllm_tpu_torch.config import GenerationConfig
    from whisper_trtllm_tpu_torch.runtime import speculative as sp

    card, _, cfg, mels = _spec_inputs(cuda, True)
    gen = GenerationConfig(max_new_tokens=12)
    generation.drop_graphs()
    out = sp.speculative_transcribe_tokens(card, cfg, card, cfg, mels[0], gen,
                                           gamma=4, with_stats=True)
    entry = next(reversed(generation._GRAPHS.values()))
    s = entry.state
    assert not bool(s.go) and int(s.pos) + 5 > s.tokens.shape[1]
    state = [s.tokens, s.pos, s.finished, s.rounds, s.accepted, s.go,
             *s.t_self, *s.d_self]
    before = [t.clone() for t in state]
    for _ in range(6):
        entry.replay()
    torch.cuda.synchronize()
    for got, want in zip(state, before):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(s.pos) + 1 == int(out[1])
    generation.drop_graphs()


def test_spec_capture_raises_when_the_round_would_sync(cuda, monkeypatch):
    """A round that reads a device value on the host cannot be captured:
    the call raises and keeps no entry; nothing falls back."""
    from whisper_trtllm_tpu_torch.config import GenerationConfig
    from whisper_trtllm_tpu_torch.runtime import speculative as sp

    card, _, cfg, mels = _spec_inputs(cuda, False)
    gen = GenerationConfig(max_new_tokens=8)
    real = sp.spec_round

    def syncing(t, tc, d, dc, s, *rest):
        bool(s.go)  # a host read of a device value
        return real(t, tc, d, dc, s, *rest)

    generation.drop_graphs()
    monkeypatch.setattr(sp, "spec_round", syncing)
    with pytest.raises(RuntimeError):
        sp.speculative_transcribe_tokens(card, cfg, card, cfg, mels[0], gen,
                                         gamma=2)
    torch.cuda.synchronize()
    assert not generation._GRAPHS
    monkeypatch.setattr(sp, "spec_round", real)
    toks, length = sp.speculative_transcribe_tokens(card, cfg, card, cfg,
                                                    mels[0], gen, gamma=2)
    assert toks.shape == (1, 9) and 2 <= int(length) <= 9
    generation.drop_graphs()


# -- engine export: the kernels as operators, the exported step -------------

def _op_cases(cuda, dtype):
    """(name, the registered operator's real output, its inputs moved to
    the meta device) of K1, K2 (int8, scales), K5 and K6 at tiny.en's
    widths."""
    from whisper_trtllm_tpu_torch.ops.kernels.fused_decoder_step import (
        _blocks,
    )

    rng = np.random.default_rng(7)
    ops = torch.ops.wtpu
    q = _normal(rng, (4, 6, 1500, 64), 0.125, cuda, dtype)
    qd = _normal(rng, (4, 6, 1, 64), 0.125, cuda, dtype)
    ck = torch.randint(-127, 128, (4, 6, 1504, 64), dtype=torch.int8,
                       device=cuda)
    sc = torch.rand(4, 6, 1504, 1, device=cuda) * 0.01 + 1e-3
    vl = torch.tensor(1500, dtype=torch.int32, device=cuda)
    x = _normal(rng, (4, 1500, 384), 1.0, cuda, dtype)
    scale = 1 + _normal(rng, (384,), 0.1, cuda, dtype)
    xs, h1, lp, caches = _fused_inputs(rng, dtype, cuda)
    weights = [t for pair in _blocks(lp) for t in pair]
    pos = torch.tensor(16, dtype=torch.int32, device=cuda)
    cases = [("flash_fwd", ops.flash_fwd, (q, q, q, False)),
             ("decode_attn", ops.decode_attn,
              (qd, ck, ck, vl, sc, sc, False)),
             ("layer_norm", ops.layer_norm, (x, scale, None, 1e-5)),
             ("fused_decoder_step", ops.fused_decoder_step,
              (xs, h1, pos, weights, *caches, vl))]

    def meta(a):
        if isinstance(a, torch.Tensor):
            return torch.empty_like(a, device="meta")
        if isinstance(a, list):
            return [meta(t) for t in a]
        return a

    return [(name, op, args, [meta(a) for a in args])
            for name, op, args in cases]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operator_fakes_give_the_real_outputs_shapes(cuda, dtype):
    """Each kernel's operator: the fake implementation (what a tracer sees)
    gives the shape and dtype the CUDA implementation returns, and the
    CUDA implementation is the wrapper's launch (it counts)."""
    reset_launch_counts()
    for name, op, args, meta_args in _op_cases(cuda, dtype):
        real, fake = op(*args), op(*meta_args)
        torch.cuda.synchronize()
        assert (real.shape, real.dtype) == (fake.shape, fake.dtype), name
        assert real.is_cuda and fake.device.type == "meta", name
    counts = {k: f.launches for k, f in KERNELS.items()}
    assert counts == {"flash_fwd": 1, "flash_bwd": 0, "decode_attn": 1,
                      "stft_log_mel": 0, "layer_norm": 1,
                      "fused_decoder_layer_step": 1, "cross_decode_mha": 0}


@pytest.mark.parametrize("weights,compute,kv", [
    ("int8", "bfloat16", "int8"),
    ("float", "float32", "auto"),
    ("float", "bfloat16", "auto"),
], ids=["int8-K2", "float32-K6", "bfloat16-K6"])
def test_exported_step_replayed_equals_the_sessions_captured_step(
        cuda, weights, compute, kv):
    """An engine exported from the session (its step a CUDA graph of the
    exported program, replayed) gives the session's captured decode bit
    for bit, with the same launches a call; a second call only replays."""
    from whisper_trtllm_tpu_torch.audio import pad_or_trim, read_wav
    from whisper_trtllm_tpu_torch.config import GenerationConfig, RuntimeConfig
    from whisper_trtllm_tpu_torch.quantization import dequantize_params
    from whisper_trtllm_tpu_torch.runtime.export import export_programs
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
    from whisper_trtllm_tpu_torch.utils.engine import Engine

    params, cfg = load_checkpoint(
        os.path.join(ROOT, "artifacts", "tiny_en_synth_int8"), device="cpu")
    if weights == "float":
        params = dequantize_params(params)
    session = WhisperSession(params, cfg, GenerationConfig(
        max_new_tokens=24, kv_cache_dtype=kv), RuntimeConfig(
        compute_dtype=compute))
    audio = np.stack([pad_or_trim(read_wav(os.path.join(
        ROOT, "artifacts", "eval", f"utt{i:02d}.wav"))) for i in range(4)])
    with torch.inference_mode():
        mel = session.frontend(audio)
    engine = Engine(*export_programs(session.params, cfg, session.generation,
                                     session._dtype, cuda, 4))
    assert engine.meta["fused_step"] == (weights == "float")
    for call in range(2):
        reset_launch_counts()
        toks, lens = session.transcribe_features(mel)
        want = {k: f.launches for k, f in KERNELS.items()}
        reset_launch_counts()
        etoks, elens = engine(session.params, mel)
        torch.cuda.synchronize()
        assert {k: f.launches for k, f in KERNELS.items()} == want
        np.testing.assert_array_equal(etoks.cpu().numpy(), toks)
        np.testing.assert_array_equal(elens.cpu().numpy(), lens)
        assert engine.captures == 1
    assert engine.eager_steps == engine.meta["warmup_steps"]


def test_eager_encode_host_time_through_the_operators(cuda, monkeypatch):
    """An eager encode with each wrapper going through its registered
    operator (as an exported program calls it) against the direct launch
    the eager path takes: the same outputs and launches; the host µs a
    call of each, printed (queued behind a spin of the card)."""
    import time

    from whisper_trtllm_tpu_torch.models.whisper import encode
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint

    params, cfg = load_checkpoint(
        os.path.join(ROOT, "artifacts", "tiny_en_synth_int8"))
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 3000, cfg.num_mel_bins)).astype(np.float32)).to(cuda)

    def host_us(n=5):  # ~800 launches: under the card's queue of pending
        # launches, past which the host would wait for the spin
        with torch.inference_mode():
            out = encode(params, cfg, mel)
            torch.cuda.synchronize()
            torch.cuda._sleep(1_000_000_000)
            t0 = time.perf_counter()
            for _ in range(n):
                encode(params, cfg, mel)
            us = (time.perf_counter() - t0) * 1e6 / n
            torch.cuda.synchronize()
        return out, us

    reset_launch_counts()
    direct, direct_us = host_us()
    direct_launches = {k: f.launches for k, f in KERNELS.items()}
    monkeypatch.setattr(_build, "tracing", lambda: True)
    reset_launch_counts()
    via_ops, ops_us = host_us()
    assert {k: f.launches for k, f in KERNELS.items()} == direct_launches
    torch.testing.assert_close(via_ops, direct, rtol=0, atol=0)
    per_call = (direct_launches["flash_fwd"]
                + direct_launches["layer_norm"]) // 6
    print(f"eager encode, batch 4, tiny.en fp32, {per_call} launches a "
          f"call: {direct_us:.1f} µs a call launching directly, "
          f"{ops_us:.1f} µs through torch.ops.wtpu")


# --------------------------------------------------------------------------
# tensor parallelism: the kernels at a rank's head count, the world of one
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("h", [1, 3, 5])
def test_kernels_at_local_head_counts_equal_plain(cuda, h, dtype, tol):
    """K1, K4 and K2's cross case at the heads a rank holds when tensor
    parallelism cuts 6 heads over 8 ranks (1), 20 over 8 (3) and 20 over
    4 (5)."""
    g = torch.Generator(device="cpu").manual_seed(h)

    def normal(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(cuda, dtype)

    b, s, dh = 2, 300, 64
    q = normal(b, h, s, dh, scale=dh ** -0.5)
    k, v, do = normal(b, h, s, dh), normal(b, h, s, dh), normal(b, h, s, dh)
    out, lse = flash_fwd(q, k, v, with_lse=True)
    torch.testing.assert_close(out.float(), attention_reference(
        q, k, v).float(), atol=tol, rtol=0)
    for got, ref in zip(flash_bwd(q, k, v, lse, do),
                        flash_attention_backward_reference(q, k, v, do)):
        scale = ref.float().abs().clamp(min=1)
        if dtype == torch.float32:
            scale = max(ref.abs().max().item(), 1.0)
        assert ((got.float() - ref.float()).abs() / scale).max() <= tol
    vl = torch.tensor(1500, dtype=torch.int32, device=cuda)
    qd = normal(4, h, 1, dh, scale=dh ** -0.5)
    kc, vc = normal(4, h, 1504, dh), normal(4, h, 1504, dh)
    torch.testing.assert_close(
        decode_attn(qd, kc, vc, vl).float(),
        decode_attention_reference(qd, kc, vc, vl).float(), atol=tol, rtol=0)


def test_calls_with_no_heads_launch_nothing(cuda):
    """A rank that holds no heads (2 heads over 4 ranks: 1, 1, 0, 0) gets
    its empty outputs from K1, K4 and K2, and nothing is launched: a grid
    of no blocks is a launch error."""
    reset_launch_counts()
    q = torch.zeros((4, 0, 300, 64), device=cuda)
    out, lse = flash_fwd(q, q, q, with_lse=True)
    grads = flash_bwd(q, q, q, lse, out)
    qd = torch.zeros((4, 0, 1, 64), device=cuda)
    od = decode_attn(qd, q, q, torch.tensor(300, dtype=torch.int32,
                                            device=cuda))
    torch.cuda.synchronize()
    assert out.shape == q.shape and od.shape == qd.shape
    assert all(x.shape == q.shape for x in grads)
    assert lse.shape == (4, 0, 300)
    assert all(fn.launches == 0 for fn in KERNELS.values())


def test_world_of_one_over_nccl(cuda, tmp_path):
    """NCCL at a world of one: ``check_devices``, a session over the 1×1
    mesh token- and launch-equal to the one-device session with no
    collective issued, a train step equal to the one-device step, and the
    sharded checkpoint bit-equal."""
    import datetime
    import socket

    import torch.distributed as dist

    from whisper_trtllm_tpu_torch.config import GenerationConfig, MeshConfig
    from whisper_trtllm_tpu_torch.models.whisper import init_params
    from whisper_trtllm_tpu_torch.parallel import (
        check_devices,
        collectives,
        initialize_distributed,
        make_mesh,
        shard_params,
    )
    from whisper_trtllm_tpu_torch.parallel.dryrun import (
        mels,
        testing_config,
        train_batch,
    )
    from whisper_trtllm_tpu_torch.parallel.partition import leaves
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.training import make_train_step
    from whisper_trtllm_tpu_torch.utils.checkpoint import (
        load_sharded,
        save_sharded,
    )

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize_distributed(init_method=f"tcp://localhost:{port}",
                           world_size=1, rank=0,
                           timeout=datetime.timedelta(seconds=60))
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh(MeshConfig(1, 1))
        assert check_devices(mesh) == {"devices": 1, "ok": True}
        cfg = testing_config(4, 64, 128)
        params = init_params(cfg, seed=0, device=cuda)
        mel = mels(cfg, 4, 0)
        gen = GenerationConfig(max_new_tokens=8)
        results = []
        for m in (None, mesh):
            reset_launch_counts()
            collectives.reset_counts()
            sess = WhisperSession(params, cfg, gen, mesh=m, device=cuda)
            results.append(sess.transcribe_features(mel) + (
                {k: fn.launches for k, fn in KERNELS.items()},
                dict(collectives.COUNTS)))
        (t0, l0, n0, _), (t1, l1, n1, c1) = results
        np.testing.assert_array_equal(t1, t0)
        np.testing.assert_array_equal(l1, l0)
        assert n1 == n0 and not any(c1.values())

        batch = train_batch(cfg, 4, 1)
        init, step = make_train_step(cfg)
        one = init_params(cfg, seed=0, device=cuda)
        one, _, loss0 = step(one, init(one), *batch)
        sharded = shard_params(init_params(cfg, seed=0, device=cuda), mesh,
                               cfg=cfg)
        init, step = make_train_step(cfg, mesh=mesh)
        sharded, _, loss1 = step(sharded, init(sharded), *batch)
        assert loss1.item() == loss0.item()
        same = dict(leaves(one))
        assert all(torch.equal(t, same[p]) for p, t in leaves(sharded))

        save_sharded(str(tmp_path / "ckpt"), sharded)
        back = dict(leaves(load_sharded(str(tmp_path / "ckpt"),
                                        shardings=mesh)))
        assert all(back[p].is_cuda and torch.equal(back[p], t)
                   for p, t in leaves(sharded))
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# K3 against the fp64 witness, and the causal-LM zoo on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("source,seed,n_mels", [
    ("numpy", 9, 128), ("numpy", 21, 128), ("card", 1, 128),
    ("numpy", 21, 80)])
def test_stft_kernel_within_the_witness_where_the_plain_version_parts(
        cuda, source, seed, n_mels):
    """The inputs (B 4, 3003 hop blocks, utterance 1 silent from the middle)
    at which K3 and its fp32 plain version part by more than 2e-4 on the
    card (NVIDIA H100 80GB HBM3; ``benchmarks/stft_witness.py``): K3 stays
    within 2e-4 of the plain formula in float64, and wherever the two part
    by more than 2e-4 the plain version is the farther from it."""
    from whisper_trtllm_tpu_torch.audio.features import N_FFT, LogMelSpectrogram
    from whisper_trtllm_tpu_torch.benchmarks.stft_witness import (
        draw,
        stft_log_mel_witness,
    )

    fe = LogMelSpectrogram(n_mels, device=cuda)
    basis = fe.dft_basis[:N_FFT].contiguous()
    x = draw(seed, 4, source == "card", cuda)
    out = stft_log_mel(x, basis, fe.mel_fb)
    ref = stft_log_mel_reference(x, basis, fe.mel_fb)
    wit = stft_log_mel_witness(x, basis, fe.mel_fb)
    kw, pw = (out - wit).abs(), (ref - wit).abs()
    assert kw.max().item() <= 2e-4
    parted = (out - ref).abs() > 2e-4
    assert bool((pw[parted] > kw[parted]).all())


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,h,hkv,dh", [(4, 16, 16, 64), (2, 32, 8, 128)])
def test_flash_kernel_at_the_zoo_prefills_matches_plain(cuda, dtype, tol, b,
                                                        h, hkv, dh):
    """K1 causal at 800 positions: gpt_350m's heads, and llama_7b's 32
    heads over 8 key/value heads (GQA) at head dim 128."""
    rng = np.random.default_rng(h + hkv)
    q = _normal(rng, (b, h, 800, dh), dh ** -0.5, cuda, dtype)
    k = _normal(rng, (b, hkv, 800, dh), 1.0, cuda, dtype)
    v = _normal(rng, (b, hkv, 800, dh), 1.0, cuda, dtype)
    out = flash_fwd(q, k, v, causal=True)
    ref = attention_reference(q, k, v, causal=True)
    assert (out.float() - ref.float()).abs().max().item() <= tol


def _zoo_model(family: str):
    """A small tree of ``family`` on the card (2 layers, head dim 64;
    GPT-J's 2 heads of 256, GPT-NeoX's 4 of 64 with rotary_pct 0.25)."""
    from whisper_trtllm_tpu_torch.models import (
        bloom,
        chatglm6b,
        gpt,
        gptj,
        gptneox,
        llama,
        opt,
    )

    mod = {"gpt": gpt, "opt": opt, "llama": llama, "gptj": gptj,
           "gptneox": gptneox, "bloom": bloom, "chatglm6b": chatglm6b}[family]
    if family == "bloom":
        cfg = bloom.BloomConfig(vocab_size=512, d_model=256, n_layer=2,
                                n_head=4, eos_token_id=7)
    elif family == "chatglm6b":
        cfg = chatglm6b.ChatGLM6BConfig(vocab_size=512, max_positions=128,
                                        d_model=256, n_layer=2, n_head=4,
                                        ffn_dim=512, eos_token_id=7)
    elif family == "gptj":
        cfg = gptj.GPTJConfig(vocab_size=512, max_positions=128, d_model=512,
                              n_layer=2, n_head=2, rotary_dim=64, ffn_dim=512,
                              eos_token_id=7)
    elif family == "gptneox":
        cfg = gptneox.GPTNeoXConfig(vocab_size=512, max_positions=128,
                                    d_model=256, n_layer=2, n_head=4,
                                    ffn_dim=512, eos_token_id=7,
                                    use_parallel_residual=False)
    elif family == "gpt":
        cfg = gpt.GPTConfig(vocab_size=512, n_positions=128, d_model=256,
                            n_layer=2, n_head=4, ffn_dim=512, eos_token_id=7)
    elif family == "opt":
        cfg = opt.OPTConfig(vocab_size=512, max_positions=128, d_model=256,
                            n_layer=2, n_head=4, ffn_dim=512, eos_token_id=7)
    else:
        cfg = llama.LlamaConfig(vocab_size=512, max_positions=128,
                                d_model=256, n_layer=2, n_head=4,
                                n_kv_head=2, ffn_dim=512, eos_token_id=7)
    return mod, cfg, mod.init_params(cfg, seed=0)


@pytest.mark.parametrize("family,call", [
    ("gpt", "lockstep"), ("gpt", "ragged"), ("gpt", "rules"),
    ("gpt", "sampled"), ("opt", "beams"), ("llama", "lockstep"),
    ("llama", "beams"), ("gptj", "lockstep"), ("gptj", "beams"),
    ("gptneox", "ragged"), ("bloom", "lockstep"), ("bloom", "ragged"),
    ("bloom", "beams"), ("chatglm6b", "lockstep"), ("chatglm6b", "ragged"),
    ("chatglm6b", "beams")])
def test_zoo_captured_step_equals_the_eager_steps(cuda, monkeypatch, family,
                                                  call):
    """The zoo's loops (``runtime/causal_lm.py``, ``runtime/beam_lm.py``)
    with their step captured and replayed (a capturing call, then a call
    that only replays) give bit for bit what the same step run eagerly on
    the card gives."""
    from whisper_trtllm_tpu_torch.runtime import causal_lm

    mod, cfg, params = _zoo_model(family)
    prompt = np.random.default_rng(1).integers(8, 512, (3, 20)).astype(
        np.int32)

    def run():
        if call == "ragged":
            return (mod.generate_ragged(params, cfg, prompt, [20, 13, 17],
                                        24),)
        if call == "beams":
            return mod.generate_beam(params, cfg, prompt, 16, 3)
        kw = {}
        if call == "rules":
            kw["sampling_cfg"] = causal_lm.make_sampling_cfg(
                repetition_penalty=1.2, min_new_tokens=3,
                bad_words=[[9], [30, 31]], stop_words=[[40, 41]])
        elif call == "sampled":
            kw = dict(temperature=0.9, top_k=30, top_p=0.9, seed=3)
        return (mod.generate(params, cfg, prompt, 24, **kw),)

    captured = []
    for _ in range(2):
        generation.reset_loop_counts()
        captured.append(run())
    assert generation.LOOP.captures == 0 and generation.LOOP.replays > 0
    orig = generation.run_decode
    monkeypatch.setattr(generation, "run_decode",
                        lambda key, tree, dev, *a, **k: orig(
                            key, tree, torch.device("cpu"), *a, **k))
    generation.reset_loop_counts()
    eager = run()
    assert generation.LOOP.replays == 0
    for got in captured:
        for g, e in zip(got, eager):
            assert g.is_cuda and torch.equal(g, e)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,h,dh", [(2, 16, 256), (2, 64, 96)])
def test_flash_kernel_at_the_wide_zoo_prefills_matches_plain(cuda, dtype, tol,
                                                             b, h, dh):
    """K1 causal at 800 positions: GPT-J-6B's 16 heads of 256 and
    GPT-NeoX-20B's 64 heads of 96."""
    rng = np.random.default_rng(h + dh)
    q = _normal(rng, (b, h, 800, dh), dh ** -0.5, cuda, dtype)
    k = _normal(rng, (b, h, 800, dh), 1.0, cuda, dtype)
    v = _normal(rng, (b, h, 800, dh), 1.0, cuda, dtype)
    out = flash_fwd(q, k, v, causal=True)
    ref = attention_reference(q, k, v, causal=True)
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_gptj_at_heads_of_256_on_the_card_equals_the_cpu(cuda):
    """A 2-layer GPT-J of 2 heads of 256 from a prompt of 800 (K1 at dh
    256 in the prefill, K2 at dh 256 in the steps, K5 at d 512): the card's
    tokens equal the CPU's, lane for lane, up to a step whose CPU logits'
    two largest lie within 1e-4 of max |logit| (a near tie, which fp32
    sums in another order may break either way), where that lane's
    comparison ends."""
    from whisper_trtllm_tpu_torch.models import gptj
    from whisper_trtllm_tpu_torch.ops.kernels import reset_launch_counts

    cfg = gptj.GPTJConfig(vocab_size=512, max_positions=1024, d_model=512,
                          n_layer=2, n_head=2, rotary_dim=64, ffn_dim=1024,
                          eos_token_id=-1)
    host = gptj.init_params(cfg, seed=0, device="cpu")
    params = gptj.init_params(cfg, seed=0)
    prompt = np.random.default_rng(3).integers(8, 512, (2, 800)).astype(
        np.int32)
    reset_launch_counts()
    generation.reset_loop_counts()
    got = gptj.generate(params, cfg, prompt, 16).cpu()
    steps = generation.LOOP.steps
    assert flash_fwd.launches == cfg.n_layer
    assert decode_attn.launches == cfg.n_layer * steps
    assert layer_norm.launches == (cfg.n_layer + 1) * (1 + steps)
    want = gptj.generate(host, cfg, prompt, 16, device="cpu")
    logits = gptj.forward(host, cfg, want)
    for lane in range(2):
        for p in range(800, want.shape[1]):
            if int(got[lane, p]) == int(want[lane, p]):
                continue
            top2 = torch.topk(logits[lane, p - 1], 2).values
            gap = (top2[0] - top2[1]).item()
            assert gap < 1e-4 * logits[lane, p - 1].abs().max().item(), (
                lane, p, gap)
            break


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("s,t,dh", [
    (4096, 77, 40), (1024, 77, 80), (256, 77, 160), (64, 77, 160),
    (1024, 1024, 80), (256, 256, 160)])
def test_flash_kernel_at_the_unet_attentions_matches_plain(cuda, dtype, tol,
                                                           s, t, dh):
    """K1 bidirectional at SD-1.x's attentions, 8 heads at batch 2: the
    cross attention's S queries over T = 77 context rows (S != T, T a
    multiple of no tile) and the self attention, at head dims 40, 80 and
    160, which the kernel pads to 64, 128 and 256."""
    rng = np.random.default_rng(s + t + dh)
    q = _normal(rng, (2, 8, s, dh), dh ** -0.5, cuda, dtype)
    k = _normal(rng, (2, 8, t, dh), 1.0, cuda, dtype)
    v = _normal(rng, (2, 8, t, dh), 1.0, cuda, dtype)
    out = flash_fwd(q, k, v)
    ref = attention_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= tol


def _lm_batcher(paged: bool, cuda, eager: bool = False, num_blocks=40):
    """A 2-layer GPT (4 heads of 64) in a dense or paged batcher of 3 lanes
    on the card; ``eager``: its segments run the step eagerly."""
    from whisper_trtllm_tpu_torch.models.gpt import model as gm
    from whisper_trtllm_tpu_torch.runtime.ifb_lm import (
        CausalLMInflightBatcher,
    )
    from whisper_trtllm_tpu_torch.runtime.ifb_paged import (
        PagedCausalLMInflightBatcher,
    )

    _, cfg, params = _zoo_model("gpt")
    common = dict(cache_heads=cfg.n_head, head_dim=cfg.head_dim,
                  n_layer=cfg.n_layer, eos_token_id=cfg.eos_token_id,
                  num_lanes=3, max_prompt_len=20, max_new_tokens=16,
                  segment_steps=6, device=cuda)
    if paged:
        b = PagedCausalLMInflightBatcher(
            params, cfg,
            prefill=lambda p, t, l, pk, pv, tb: gm._prefill_paged(
                p, cfg, t, l, pk, pv, tb),
            step=lambda p, tok, pos, pk, pv, tb: gm._step_paged(
                p, cfg, tok, pos, pk, pv, tb),
            num_blocks=num_blocks, tokens_per_block=8, **common)
    else:
        b = CausalLMInflightBatcher(
            params, cfg,
            prefill=lambda p, t, l, ck, cv: gm._prefill_ragged(
                p, cfg, t, l, ck, cv),
            step=lambda p, tok, pos, ck, cv: gm._step(p, cfg, tok, pos, ck,
                                                      cv), **common)
    if eager:
        b._graph = None
    return b


def _lm_lane_tensors(b):
    return list(b.state) + ([b.tables] if hasattr(b, "tables") else [])


@pytest.mark.parametrize("paged", [False, True])
def test_captured_lm_batcher_step_equals_the_eager_steps(cuda, paged):
    """The causal-LM batchers' captured step, replayed segment by segment,
    gives the rows and the lanes' final state (tokens, positions, prompt
    lengths, flags, caches or pools, tables) of the same step run eagerly
    on the card, bit for bit, over 5 requests through 3 lanes."""
    prompts = [np.random.default_rng(n).integers(8, 512, (n,)).astype(
        np.int32) for n in (20, 7, 13, 3, 18)]
    rows = []
    for eager in (False, True):
        b = _lm_batcher(paged, cuda, eager)
        generation.reset_loop_counts()
        rids = [b.submit(p) for p in prompts]
        b.run()
        rows.append(([b.fetch(r) for r in rids], _lm_lane_tensors(b)))
        if eager:
            assert generation.LOOP.replays == 0
        else:
            assert generation.LOOP.replays == b.steps_run > 0
        if paged:
            assert b.free_blocks() == 40
    for r, w in zip(rows[0][0], rows[1][0]):
        np.testing.assert_array_equal(r, w)
    for a, w in zip(rows[0][1], rows[1][1]):
        assert torch.equal(a, w)


def test_a_paged_replay_reads_the_table_buffer_it_is_given(cuda):
    """Every lane idle at position 0 writes its slot 0 through its table
    row at each replay: after the static table buffer changes, the next
    replay writes into the new block; a -1 row writes nothing."""
    b = _lm_batcher(True, cuda)
    pool = b.state.pool_k
    with torch.inference_mode():  # the batcher's buffers are inference tensors
        b.tables.fill_(-1)
        b.tables[0, 0] = 3
    b._graph.replay()
    torch.cuda.synchronize()
    written = pool[:, 3, 0].clone()
    assert written.abs().sum().item() > 0
    others = torch.ones(pool.shape[1], dtype=torch.bool, device=cuda)
    others[3] = False
    assert pool[:, others].abs().sum().item() == 0
    assert pool[:, 3, 1:].abs().sum().item() == 0
    with torch.inference_mode():
        b.tables[0, 0] = 5
    b._graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(pool[:, 5, 0], written)  # the same lane's row
    assert torch.equal(pool[:, 3, 0], written)
    others[5] = False
    assert pool[:, others].abs().sum().item() == 0
