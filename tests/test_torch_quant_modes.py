"""PyTorch port: the int4, fp8-QDQ and SmoothQuant weight modes against the
JAX package on the CPU.

- ``QuantMode`` has the JAX flags, values and predicates.
- The int4 and fp8 quantizers give the JAX package's bytes (fp8 compared as
  uint8 views of the cast), stacked trees included; no fp8 value passes
  ±448. ``unpack_int4_kernel`` and ``fp8_qdq_activation`` equal JAX's.
- ``dense`` on ``kernel_q4``, ``kernel_f8`` and ``kernel_sq`` matches JAX
  within 1e-5 in fp32 and one bf16 step (2^-7 of max(|JAX|, 1)) in bf16;
  SmoothQuant's int8 activations and int32 product are equal exactly.
- ``whisper_act_stats`` is within 1e-5 relative of JAX's, and
  ``smooth_quantize_whisper`` on JAX's stats gives JAX's tree bit for bit.
- Sessions in each mode give JAX's fp32 tokens at ``WhisperConfig.testing()``
  sizes, and on the trained artifact's float tree (the int8 artifact
  dequantized in memory) every mode gives the four bundled texts in fp32
  and bf16, in the JAX package and in the port.
"""

import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_trtllm_tpu.config import GenerationConfig as JaxGen
from whisper_trtllm_tpu.config import RuntimeConfig as JaxRuntime
from whisper_trtllm_tpu.config import WhisperConfig as JaxWhisperConfig
from whisper_trtllm_tpu.models.whisper import init_params as jax_init_params
from whisper_trtllm_tpu.ops import functional as jax_fn
from whisper_trtllm_tpu.quantization import mode as jax_mode
from whisper_trtllm_tpu.quantization import quantize as jax_quant
from whisper_trtllm_tpu.quantization import smooth as jax_smooth
from whisper_trtllm_tpu.runtime.session import WhisperSession as JaxSession
from whisper_trtllm_tpu_torch import quantization as quant
from whisper_trtllm_tpu_torch.audio import (
    log_mel_spectrogram,
    pad_or_trim,
    read_wav,
)
from whisper_trtllm_tpu_torch.config import (
    GenerationConfig,
    RuntimeConfig,
    WhisperConfig,
)
from whisper_trtllm_tpu_torch.ops import functional as fn
from whisper_trtllm_tpu_torch.quantization import smooth
from whisper_trtllm_tpu_torch.quantization.mode import QuantMode
from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
from whisper_trtllm_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    params_from_numpy,
)
from whisper_trtllm_tpu_torch.utils.vocab import ids_to_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts", "tiny_en_synth_int8")
BF16_STEP = 2.0 ** -7


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def _bytes(x) -> np.ndarray:
    """A leaf's raw bytes as a numpy array of its own shape: fp8 as uint8
    (torch's float8_e4m3fn or ml_dtypes' through the same bit view)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        return x.numpy()
    x = np.asarray(x)
    if x.dtype == jnp.float8_e4m3fn:
        return x.view(np.uint8)
    return x


def _assert_trees_bit_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k in got:
        g, w = _bytes(got[k]), _bytes(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else
            (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


def _kernel(rng, din, dout, scale=0.2):
    w = (rng.standard_normal((din, dout)) * scale).astype(np.float32)
    w[:, 1] = 0.0                     # an all-zero channel: the 1e-8 floor
    w[3, 2] = 7.5                     # an outlier channel
    return w


# --------------------------------------------------------------------------
# QuantMode
# --------------------------------------------------------------------------

_PREDICATES = ("has_int8_weights", "has_int8_kv_cache", "has_fp8_qdq",
               "has_fp8_kv_cache", "has_kv_cache_quant",
               "has_act_and_weight_quant")


def test_quant_mode_has_the_jax_flags():
    assert ([(m.name, int(m)) for m in QuantMode]
            == [(m.name, int(m)) for m in jax_mode.QuantMode])
    assert int(QuantMode.use_weight_only()) == int(
        jax_mode.QuantMode.use_weight_only())
    assert int(QuantMode.use_weight_only(use_int4=True)) == int(
        jax_mode.QuantMode.use_weight_only(use_int4=True))
    assert int(QuantMode.use_smooth_quant()) == int(
        jax_mode.QuantMode.use_smooth_quant())


@pytest.mark.parametrize("predicate", _PREDICATES)
def test_quant_mode_predicates_match_jax_on_every_combination(predicate):
    flags = [int(m) for m in QuantMode]
    for n in range(len(flags) + 1):
        for combo in itertools.combinations(flags, n):
            v = sum(combo)
            assert (getattr(QuantMode(v), predicate)()
                    == getattr(jax_mode.QuantMode(v), predicate)()), (v,)


# --------------------------------------------------------------------------
# the quantizers
# --------------------------------------------------------------------------

def test_int4_quantizer_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    w = _kernel(rng, 48, 40)
    q, s = quant.quantize_kernel_int4(torch.from_numpy(w))
    rq, rs = jax_quant.quantize_kernel_int4(w)
    assert q.dtype == np.int8 and q.shape == (48, 20) and s.dtype == np.float32
    np.testing.assert_array_equal(q, rq)
    np.testing.assert_array_equal(s, rs)
    with pytest.raises(ValueError, match="even"):
        quant.quantize_kernel_int4(w[:, :39])
    p = {"kernel": np.stack([w, -3 * w]), "bias": np.ones(40, np.float32)}
    got, want = quant.quantize_dense_params_int4(p), \
        jax_quant.quantize_dense_params_int4(p)
    assert set(got) == set(want) == {"kernel_q4", "scale", "bias"}
    assert got["kernel_q4"].shape == (2, 48, 20) and got["scale"].shape == (2, 40)
    _assert_trees_bit_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unpack_int4_matches_jax_on_every_byte(dtype):
    """Every byte value, in a 2-D and a stacked kernel."""
    rng = np.random.default_rng(1)
    every = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    stacked = rng.integers(-128, 128, (3, 8, 16)).astype(np.int8)
    for packed in (every, stacked):
        got = quant.unpack_int4_kernel(torch.from_numpy(packed),
                                       getattr(torch, dtype))
        want = np.asarray(jax_quant.unpack_int4_kernel(
            jnp.asarray(packed), getattr(jnp, dtype)).astype(jnp.float32))
        assert got.dtype == getattr(torch, dtype)
        assert got.shape == packed.shape[:-1] + (2 * packed.shape[-1],)
        np.testing.assert_array_equal(got.float().numpy(), want)
        assert got.min() >= -8 and got.max() <= 7


def test_fp8_quantizer_matches_jax_bit_for_bit_and_stays_inside_448():
    rng = np.random.default_rng(2)
    w = _kernel(rng, 48, 40)
    w[5, 7] = -w[3, 2]                # amax on both signs
    w[6] *= 1e-4                      # values into fp8's subnormals
    q, s = quant.quantize_kernel_fp8(torch.from_numpy(w))
    rq, rs = jax_quant.quantize_kernel_fp8(w)
    assert q.dtype == torch.float8_e4m3fn and q.shape == (48, 40)
    assert np.asarray(s).dtype == np.float32 and np.asarray(s).shape == ()
    np.testing.assert_array_equal(_bytes(q), _bytes(rq))
    assert np.float32(s) == np.float32(rs)
    assert q.float().abs().max() <= 448.0
    assert q.float().abs().max() == 448.0   # the amax maps onto the edge
    p = {"kernel": np.stack([w, 1e3 * w, 1e-3 * w]),
         "bias": np.ones(40, np.float32)}
    got, want = quant.quantize_dense_params_fp8(p), \
        jax_quant.quantize_dense_params_fp8(p)
    assert set(got) == set(want) == {"kernel_f8", "scale", "bias"}
    assert got["scale"].shape == (3,) and got["scale"].dtype == np.float32
    _assert_trees_bit_equal(got, want)
    assert torch.isfinite(got["kernel_f8"].float()).all()
    assert got["kernel_f8"].float().abs().max() <= 448.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,scale", [((4, 1, 64), 1.0), ((2, 7, 48), 30.0),
                                         ((3, 16), 1e-3)])
def test_fp8_qdq_activation_matches_jax(dtype, shape, scale):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    got = quant.fp8_qdq_activation(torch.from_numpy(x).to(getattr(torch,
                                                                  dtype)))
    want = jax_quant.fp8_qdq_activation(jnp.asarray(x, getattr(jnp, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_int4_and_fp8_tree_rewrites_match_jax():
    """The whole testing-size tree, plus projections the rewrites must skip
    (an odd output dim for int4, a conv kernel, a key not in the list)."""
    cfg = JaxWhisperConfig.testing()
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(cfg, seed=0))
    rng = np.random.default_rng(4)
    tree["extra"] = {"fc1": {"kernel": _kernel(rng, 8, 9)},
                     "other": {"kernel": _kernel(rng, 8, 6)},
                     "out": {"kernel": rng.standard_normal((3, 8, 6))
                             .astype(np.float32)[None]}}
    for ours, theirs, key in ((quant.weight_only_quantize_int4,
                               jax_quant.weight_only_quantize_int4,
                               "kernel_q4"),
                              (quant.fp8_quantize, jax_quant.fp8_quantize,
                               "kernel_f8")):
        got, want = ours(params_from_numpy(tree, "cpu")), theirs(tree)
        _assert_trees_bit_equal(got, want)
        assert key in got["decoder"]["layers"]["fc1"]
    assert "kernel" in quant.weight_only_quantize_int4(tree)["extra"]["fc1"]
    assert "kernel" in quant.fp8_quantize(tree)["extra"]["other"]


# --------------------------------------------------------------------------
# dense
# --------------------------------------------------------------------------

def _sq_params(rng, din, dout):
    """A SmoothQuant projection from both packages' ``_sq_dense`` on the
    same stacked kernel and stats, layer 0 taken."""
    w = _kernel(rng, din, dout)[None]
    act = np.abs(rng.standard_normal((1, din))).astype(np.float32) * 3
    act[0, 5] = 40.0                  # an outlier activation channel
    p = {"kernel": w, "bias": rng.standard_normal(dout).astype(np.float32)}
    got, want = smooth._sq_dense(p, act, 0.5), jax_smooth._sq_dense(p, act, 0.5)
    _assert_trees_bit_equal(got, want)
    layer0 = {k: (v[0] if k != "bias" else v) for k, v in want.items()}
    return layer0


def _quantized(key, rng, din=48, dout=40):
    p = {"kernel": _kernel(rng, din, dout),
         "bias": rng.standard_normal(dout).astype(np.float32)}
    if key == "kernel_q4":
        return quant.quantize_dense_params_int4(p), \
            jax_quant.quantize_dense_params_int4(p)
    if key == "kernel_f8":
        return quant.quantize_dense_params_fp8(p), \
            jax_quant.quantize_dense_params_fp8(p)
    sq = _sq_params(rng, din, dout)
    return sq, sq


def _to_port(tree):
    return {k: v if isinstance(v, torch.Tensor) else
            torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("key", ["kernel_q4", "kernel_f8", "kernel_sq"])
@pytest.mark.parametrize("shape", [(2, 5, 48), (4, 1, 48)],
                         ids=["rows", "decode"])
def test_dense_quantized_branches_match_jax(key, dtype, shape):
    rng = np.random.default_rng(5)
    ours, theirs = _quantized(key, rng)
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    x[..., 5] *= 10                   # the outlier channel of the SQ stats
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(getattr(jnp, dtype))
        if np.asarray(a).dtype == np.float32 else jnp.asarray(a), theirs)
    tp = {k: (v.to(getattr(torch, dtype)) if v.dtype == torch.float32 else v)
          for k, v in _to_port(ours).items()}
    want = np.asarray(jax_fn.dense(jp, jnp.asarray(x, getattr(jnp, dtype)))
                      .astype(jnp.float32))
    got = fn.dense(tp, torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == shape[:-1] + (40,)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert np.all(np.abs(got - want)
                      <= BF16_STEP * np.maximum(np.abs(want), 1.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smooth_quant_activation_and_int32_product_equal_jax_exactly(dtype):
    """The int8 activations, their scales and the int32 product, against
    the same steps of the JAX dense, at fc2's depth (1536)."""
    rng = np.random.default_rng(6)
    p = _sq_params(rng, 1536, 48)
    x = (rng.standard_normal((3, 7, 1536)) * 3).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    xs = jx * jnp.asarray(p["smooth"]).astype(jx.dtype)
    amax = jnp.max(jnp.abs(xs), axis=-1, keepdims=True)
    act_scale = jnp.maximum(amax.astype(jnp.float32), 1e-8) / 127.0
    xq = jnp.clip(jnp.round(xs.astype(jnp.float32) / act_scale),
                  -127, 127).astype(jnp.int8)
    yi = jax.lax.dot_general(xq, jnp.asarray(p["kernel_sq"]),
                             (((2,), (0,)), ((), ())),
                             preferred_element_type=jnp.int32)
    got_q, got_scale = fn.smooth_quant_activation(
        torch.from_numpy(x).to(getattr(torch, dtype)),
        torch.from_numpy(p["smooth"]))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(got_scale.numpy(), np.asarray(act_scale))
    got_i = fn.int8_matmul(got_q, torch.from_numpy(p["kernel_sq"]))
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(yi))


@pytest.mark.parametrize("rows", [1, 4, 16, 17, 300])
def test_int8_matmul_is_the_exact_int32_product(rows):
    """Random int8 rows and a row of 127s against a column of 127s."""
    rng = np.random.default_rng(rows)
    a = rng.integers(-127, 128, (rows, 1536)).astype(np.int8)
    b = rng.integers(-127, 128, (1536, 384)).astype(np.int8)
    # a sum past 2^24 that fp32 cannot hold: 1536 · 127² − 127, odd
    a[0], b[:, 1] = 127, 127
    b[0, 1] = 126
    got = fn.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    want = a.astype(np.int64) @ b.astype(np.int64)
    assert want[0, 1] == 1536 * 127 ** 2 - 127 > 2 ** 24
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# SmoothQuant calibration and rewrite, sessions at testing size
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """Testing-size weights (the same values in both packages), a batch of
    two mels and token prefixes, and JAX's stats on them."""
    jcfg = JaxWhisperConfig.testing()
    jtree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, seed=0))
    rng = np.random.default_rng(7)
    mel = rng.standard_normal((2, 2 * jcfg.max_source_positions,
                               jcfg.num_mel_bins)).astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    stats = jax_smooth.whisper_act_stats(jtree, jcfg, jnp.asarray(mel),
                                         jnp.asarray(tokens))
    return (jtree, jcfg, params_from_numpy(jtree, "cpu"),
            WhisperConfig.testing(), mel, tokens, stats)


def test_whisper_act_stats_match_jax(small):
    jtree, jcfg, tree, cfg, mel, tokens, want = small
    got = quant.whisper_act_stats(tree, cfg, mel, tokens)
    assert got.keys() == want.keys()
    for side in got:
        assert got[side].keys() == want[side].keys()
        for k, g in got[side].items():
            w = np.asarray(want[side][k])
            assert g.shape == w.shape and g.dtype == np.float32, (side, k)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0,
                                       err_msg=f"{side}/{k}")


def test_smooth_quantize_whisper_on_jax_stats_is_bit_equal(small):
    jtree, jcfg, tree, cfg, mel, tokens, stats = small
    stats = jax.tree_util.tree_map(np.asarray, stats)
    got = quant.smooth_quantize_whisper(tree, stats)
    want = jax_smooth.smooth_quantize_whisper(jtree, stats)
    _assert_trees_bit_equal(_numpy_tree(got), want)
    fc2 = got["decoder"]["layers"]["fc2"]
    assert set(fc2) == {"kernel_sq", "scale", "smooth", "bias"}
    assert fc2["scale"].shape == (cfg.decoder_layers, cfg.d_model)
    assert fc2["smooth"].shape == (cfg.decoder_layers, cfg.decoder_ffn_dim)


def _small_trees(small, mode):
    """(JAX tree, port tree, weight_dtype) of a mode: int4 and fp8 by the
    session's chain, SmoothQuant by the caller's rewrite on JAX's stats."""
    jtree, jcfg, tree, cfg, mel, tokens, stats = small
    if mode == "smooth":
        stats = jax.tree_util.tree_map(np.asarray, stats)
        return (jax_smooth.smooth_quantize_whisper(jtree, stats),
                quant.smooth_quantize_whisper(tree, stats), "native")
    return jtree, tree, mode


@pytest.mark.parametrize("mode", ["int4", "fp8", "smooth"])
def test_session_tokens_equal_jax_at_testing_size(small, mode):
    jtree, jcfg, tree, cfg, mel, tokens, stats = small
    jt, pt, wd = _small_trees(small, mode)
    want = JaxSession(jt, jcfg, JaxGen(max_new_tokens=12),
                      JaxRuntime(weight_dtype=wd)).transcribe_features(mel)
    session = WhisperSession(pt, cfg, GenerationConfig(max_new_tokens=12),
                             RuntimeConfig(weight_dtype=wd), device="cpu")
    fc1 = session.params["decoder"]["layers"]["fc1"]
    assert {"int4": "kernel_q4", "fp8": "kernel_f8",
            "smooth": "kernel_sq"}[mode] in fc1
    got = session.transcribe_features(mel)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_session_casts_scales_and_keeps_the_quantized_kernels(small, compute):
    jtree, jcfg, tree, cfg, mel, tokens, stats = small
    dt = getattr(torch, compute)
    for mode, key, kdt in (("int4", "kernel_q4", torch.int8),
                           ("fp8", "kernel_f8", torch.float8_e4m3fn),
                           ("smooth", "kernel_sq", torch.int8)):
        _, pt, wd = _small_trees(small, mode)
        s = WhisperSession(pt, cfg, runtime=RuntimeConfig(
            compute_dtype=compute, weight_dtype=wd), device="cpu")
        fc1 = s.params["decoder"]["layers"]["fc1"]
        assert fc1[key].dtype == kdt and fc1["scale"].dtype == dt
        if mode == "fp8":
            assert fc1["scale"].shape == (cfg.decoder_layers,)
        if mode == "smooth":
            assert fc1["smooth"].dtype == dt
        assert s.params["encoder"]["conv1"]["kernel"].dtype == dt


# --------------------------------------------------------------------------
# the trained artifact's float tree: the four texts in every mode
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def artifact():
    params, cfg = load_checkpoint(ART, device="cpu")
    float_tree = quant.dequantize_params(params)
    audio = np.stack([pad_or_trim(read_wav(os.path.join(
        ROOT, "artifacts", "eval", f"utt{i:02d}.wav"))) for i in range(4)])
    with open(os.path.join(ROOT, "artifacts", "expected.json")) as f:
        expected = json.load(f)["texts"]
    # SmoothQuant's calibration batch: the four mels and the first 16 of
    # the float tree's greedy tokens, the same inputs in both packages
    toks, _ = WhisperSession(float_tree, cfg, GenerationConfig(
        max_new_tokens=32), device="cpu").transcribe(audio)
    mel = log_mel_spectrogram(audio, device="cpu").numpy()
    return float_tree, cfg, audio, expected, mel, toks[:, :16]


@pytest.fixture(scope="module")
def artifact_sq(artifact):
    """Each package's SmoothQuant tree of the float tree, each calibrated
    by its own pass on the same batch."""
    from whisper_trtllm_tpu.utils.checkpoint import load_checkpoint as jl

    float_tree, cfg, audio, expected, mel, toks = artifact
    _, jcfg = jl(ART)
    jtree = _numpy_tree(float_tree)
    jstats = jax_smooth.whisper_act_stats(jtree, jcfg, jnp.asarray(mel),
                                          jnp.asarray(toks))
    stats = quant.whisper_act_stats(float_tree, cfg, mel, toks)
    return (jax_smooth.smooth_quantize_whisper(jtree, jstats), jcfg,
            quant.smooth_quantize_whisper(float_tree, stats))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int4", "fp8", "smooth"])
@pytest.mark.parametrize("package", ["port", "jax"])
def test_artifact_float_tree_gives_the_four_texts(artifact, artifact_sq,
                                                  package, mode, compute):
    float_tree, cfg, audio, expected, mel, toks = artifact
    jsq, jcfg, sq = artifact_sq
    wd = "native" if mode == "smooth" else mode
    if package == "jax":
        tree = jsq if mode == "smooth" else _numpy_tree(float_tree)
        t, n = JaxSession(tree, jcfg, JaxGen(max_new_tokens=32),
                          JaxRuntime(compute_dtype=compute, weight_dtype=wd)
                          ).transcribe(audio)
    else:
        tree = sq if mode == "smooth" else float_tree
        t, n = WhisperSession(tree, cfg, GenerationConfig(max_new_tokens=32),
                              RuntimeConfig(compute_dtype=compute,
                                            weight_dtype=wd),
                              device="cpu").transcribe(audio)
    t, n = np.asarray(t), np.asarray(n)
    assert [ids_to_text(t[i, :n[i]]) for i in range(4)] == expected
