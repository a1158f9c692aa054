"""PyTorch port: the Whisper model and greedy generation against the JAX
package on the same weights (JAX ``init_params`` carried over with
``params_from_numpy``) and the same inputs drawn from a seed.

Tolerances: encoder states 1e-4 and logits 1e-4 (fp32 through several
layers, sums in another order); greedy tokens and lengths exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu import config as jax_config
from whisper_trtllm_tpu.models.whisper import init_params
from whisper_trtllm_tpu.models.whisper import model as jax_model
from whisper_trtllm_tpu.quantization import weight_only_quantize
from whisper_trtllm_tpu.runtime import generation as jax_gen
from whisper_trtllm_tpu_torch import config as torch_config
from whisper_trtllm_tpu_torch.models.whisper import model
from whisper_trtllm_tpu_torch.runtime import generation
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy


def _configs(**overrides):
    jcfg = jax_config.WhisperConfig.testing(**overrides)
    return jcfg, torch_config.WhisperConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, seed=0, int8=False):
    ref = init_params(jcfg, seed=seed)
    if int8:
        ref = weight_only_quantize(ref)
    return ref, params_from_numpy(ref, "cpu")


def _mel(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (batch, 2 * cfg.max_source_positions, cfg.num_mel_bins)
    ).astype(np.float32)


@pytest.mark.parametrize("int8", [False, True])
def test_encode_matches_jax_at_toy_dims(int8):
    jcfg, cfg = _configs(max_source_positions=20)
    ref_p, p = _params(jcfg, seed=1, int8=int8)
    mel = _mel(jcfg, 2, seed=2)
    ref = np.asarray(jax_model.encode(ref_p, jcfg, jnp.asarray(mel)))
    out = model.encode(p, cfg, torch.from_numpy(mel))
    assert tuple(out.shape) == ref.shape == (2, 20, jcfg.d_model)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_encode_matches_jax_at_tiny_en_dims():
    jcfg = jax_config.WhisperConfig.tiny_en()
    cfg = torch_config.WhisperConfig.tiny_en()
    ref_p = init_params(jcfg, seed=0)
    ref_p = {"encoder": ref_p["encoder"]}
    p = params_from_numpy(ref_p, "cpu")
    mel = _mel(jcfg, 1, seed=3)
    ref = np.asarray(jax_model.encode(ref_p, jcfg, jnp.asarray(mel)))
    out = model.encode(p, cfg, torch.from_numpy(mel))
    assert tuple(out.shape) == (1, 1500, 384)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_cross_kv_padding_matches_jax():
    jcfg, cfg = _configs(max_source_positions=20)
    ref_p, p = _params(jcfg, seed=4)
    enc = np.random.default_rng(5).standard_normal((2, 20, jcfg.d_model)
                                                   ).astype(np.float32)
    rk, rv = jax_model.compute_cross_kv(ref_p, jcfg, jnp.asarray(enc))
    k, v = model.compute_cross_kv(p, cfg, torch.from_numpy(enc))
    assert tuple(k.shape) == rk.shape == (jcfg.decoder_layers, 2, 4, 24, 8)
    np.testing.assert_allclose(k.numpy(), np.asarray(rk), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), atol=1e-5)
    assert not k[:, :, :, 20:].any()


@pytest.mark.parametrize("int8", [False, True])
def test_decode_step_kv_matches_jax_for_three_steps(int8):
    jcfg, cfg = _configs(max_source_positions=20)
    ref_p, p = _params(jcfg, seed=6, int8=int8)
    b, max_len = 2, 8
    enc = np.random.default_rng(7).standard_normal((b, 20, jcfg.d_model)
                                                   ).astype(np.float32)
    ref_cross = jax_model.compute_cross_kv(ref_p, jcfg, jnp.asarray(enc))
    ref_self = jax_model.init_self_kv(jcfg, b, max_len)
    cross = model.compute_cross_kv(p, cfg, torch.from_numpy(enc))
    self_kv = model.init_self_kv(cfg, b, max_len, device="cpu")
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (3, b))
    for pos in range(3):
        ref_logits, ref_self = jax_model.decode_step_kv(
            ref_p, jcfg, jnp.asarray(toks[pos], jnp.int32), jnp.int32(pos),
            ref_self, ref_cross)
        logits, self_kv = model.decode_step_kv(
            p, cfg, torch.from_numpy(toks[pos]), pos, self_kv, cross)
        assert logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   atol=1e-4, rtol=0)
        for got, ref in zip(self_kv, ref_self):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


_KV = {"int8": (jnp.int8, torch.int8),
       "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


@pytest.mark.parametrize("t_major", [False, True], ids=["bhtd", "bhdt"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_decode_step_kv_matches_jax_for_three_steps(kind, t_major):
    """Quantized self and cross caches, the cross cache in either layout:
    logits 1e-4, cache values exact, scales 1e-6 (sums in another order
    may move a value across a rounding boundary only where logits differ
    by ~1e-7)."""
    jcfg, cfg = _configs(max_source_positions=20)
    ref_p, p = _params(jcfg, seed=14, int8=True)
    b, max_len = 2, 8
    jdt, tdt = _KV[kind]
    enc = np.random.default_rng(15).standard_normal((b, 20, jcfg.d_model)
                                                   ).astype(np.float32)
    ref_cross = jax_model.quantize_cross_kv(
        *jax_model.compute_cross_kv(ref_p, jcfg, jnp.asarray(enc)), jdt)
    cross = model.quantize_cross_kv(
        *model.compute_cross_kv(p, cfg, torch.from_numpy(enc)), tdt)
    if t_major:
        ref_cross = jax_model.transpose_cross_kv(ref_cross)
        cross = model.transpose_cross_kv(cross)
        assert cross[0].is_contiguous()
    assert model.cross_kv_t_major(cfg, cross) == t_major
    ref_self = jax_model.init_self_kv_quant(jcfg, b, max_len, jdt)
    self_kv = model.init_self_kv_quant(cfg, b, max_len, tdt, device="cpu")
    toks = np.random.default_rng(16).integers(0, jcfg.vocab_size, (3, b))
    for pos in range(3):
        ref_logits, ref_self = jax_model.decode_step_kv(
            ref_p, jcfg, jnp.asarray(toks[pos], jnp.int32), jnp.int32(pos),
            ref_self, ref_cross)
        logits, self_kv = model.decode_step_kv(
            p, cfg, torch.from_numpy(toks[pos]), pos, self_kv, cross)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   atol=1e-4, rtol=0)
    for got, ref in zip(self_kv, ref_self):
        assert got.dtype == (tdt if got.shape[-1] != 1 else torch.float32)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   atol=1e-6, rtol=1e-6)


def test_init_self_kv_int8_and_layout_refusals():
    _, cfg = _configs(max_source_positions=20)
    kq, ks, vq, vs = model.init_self_kv_int8(cfg, 2, 8, device="cpu")
    assert kq.dtype == vq.dtype == torch.int8 and (ks == 1).all()
    assert tuple(ks.shape) == (cfg.decoder_layers, 2, 4, 8, 1)
    square = (torch.zeros(2, 1, 4, 8, 8),) * 2
    assert generation.apply_cross_layout(square + square, "auto") is not None
    with pytest.raises(ValueError, match="head_dim"):
        generation.apply_cross_layout(square, "bhdt")
    with pytest.raises(ValueError):
        generation.apply_cross_layout(square, "btd")
    with pytest.raises(ValueError):
        generation.kv_quant_dtype("int4")


@pytest.mark.parametrize("kv,layout", [("int8", "auto"), ("fp8", "auto"),
                                       ("int8", "bhtd"), ("auto", "bhdt")])
def test_greedy_tokens_equal_jax_with_kv_cache_options(kv, layout):
    jcfg, cfg = _configs()
    ref_p, p = _params(jcfg, seed=17, int8=True)
    mel = _mel(jcfg, 3, seed=18)
    kw = dict(max_new_tokens=10, kv_cache_dtype=kv, cross_kv_layout=layout)
    ref_toks, ref_lens = jax_gen.transcribe_tokens(
        ref_p, jcfg, jnp.asarray(mel), jax_config.GenerationConfig(**kw))
    toks, lens = generation.transcribe_tokens(
        p, cfg, mel, torch_config.GenerationConfig(**kw), device="cpu")
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))


def test_vocab_logits_int8_table_matches_jax():
    rng = np.random.default_rng(9)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    scale = (np.abs(table).max(axis=1) / 127).astype(np.float32)
    dec = {"embed_tokens": {
        "table_q": np.round(table / scale[:, None]).astype(np.int8),
        "scale": scale}}
    x = rng.standard_normal((3, 1, 16)).astype(np.float32)
    ref = np.asarray(jax_model._vocab_logits(dec, jnp.asarray(x)))
    out = model._vocab_logits(params_from_numpy(dec, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    bf = model._vocab_logits(params_from_numpy(dec, "cpu"),
                             torch.from_numpy(x).bfloat16())
    assert bf.dtype == torch.float32


@pytest.mark.parametrize("seed,max_new_tokens", [(0, 10), (1, 14), (2, 5)])
def test_greedy_tokens_equal_jax_on_random_toy_config(seed, max_new_tokens):
    jcfg, cfg = _configs()
    ref_p, p = _params(jcfg, seed=seed)
    mel = _mel(jcfg, 3, seed=10 + seed)
    jgen = jax_config.GenerationConfig(max_new_tokens=max_new_tokens)
    gen = torch_config.GenerationConfig(max_new_tokens=max_new_tokens)
    ref_toks, ref_lens = jax_gen.transcribe_tokens(ref_p, jcfg,
                                                   jnp.asarray(mel), jgen)
    toks, lens = generation.transcribe_tokens(p, cfg, mel, gen, device="cpu")
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))
    assert toks.shape[1] == min(cfg.max_target_positions, max_new_tokens + 1)


def test_greedy_stops_at_eos_and_pads_like_jax():
    """A final-LayerNorm bias along EOS's embedding makes EOS the first free
    token: every lane finishes at once, pad fills the rest, lengths are EOS
    position + 1 and the loop ends early, exactly as in the JAX loop."""
    jcfg, cfg = _configs()
    ref_p = init_params(jcfg, seed=11)
    eos_row = ref_p["decoder"]["embed_tokens"][jcfg.eos_token_id]
    ref_p["decoder"]["layer_norm"]["bias"] = (
        ref_p["decoder"]["layer_norm"]["bias"]
        + 8.0 * eos_row / np.linalg.norm(eos_row))
    p = params_from_numpy(ref_p, "cpu")
    mel = _mel(jcfg, 4, seed=12)
    jgen = jax_config.GenerationConfig(max_new_tokens=12)
    ref_toks, ref_lens = jax_gen.transcribe_tokens(ref_p, jcfg,
                                                   jnp.asarray(mel), jgen)
    toks, lens = generation.transcribe_tokens(
        p, cfg, mel, torch_config.GenerationConfig(max_new_tokens=12),
        device="cpu")
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))
    assert lens.tolist() == [3] * 4
    assert (toks[:, 2:] == cfg.eos_token_id).all()  # EOS, then pad (== EOS id)


@pytest.mark.parametrize("field,value", [
    ("num_beams", 2), ("return_timestamps", True), ("presence_penalty", 0.5),
    ("min_new_tokens", 2), ("bad_words", ((5,),)), ("stop_words", ((5,),)),
    ("temperature", 0.7), ("top_k", 5), ("top_p", 0.9),
    ("repetition_penalty", 1.2),
])
def test_greedy_refuses_unported_generation_options(field, value):
    """Beam search is the one field the greedy loop still refuses. Every
    other field it once refused is taken now: a deterministic option gives
    the JAX loop's tokens and lengths exactly, a sampling knob tokens of
    the loop's shape that keep the forced prefix (the JAX draw cannot be
    reproduced)."""
    jcfg, cfg = _configs(no_timestamps_token_id=60)
    ref_p, p = _params(jcfg)
    mel = _mel(cfg, 1, 0)
    gen = torch_config.GenerationConfig(max_new_tokens=3, **{field: value})
    if field == "num_beams":
        with pytest.raises(NotImplementedError):
            generation.transcribe_tokens(p, cfg, mel, gen, device="cpu")
        return
    toks, lens = generation.transcribe_tokens(p, cfg, mel, gen, device="cpu")
    if field in ("temperature", "top_k", "top_p"):
        assert tuple(toks.shape) == (1, 4) and int(toks[0, 1]) == 11
        return
    ref_toks, ref_lens = jax_gen.transcribe_tokens(
        ref_p, jcfg, jnp.asarray(mel),
        jax_config.GenerationConfig(max_new_tokens=3, **{field: value}))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))
