"""PyTorch port: random init, HF conversion and the step == full gate on
the CPU.

- ``layers/init`` and ``init_params``: bit-equal to the JAX package's from
  the same seed, leaf for leaf.
- ``convert_state_dict``, ``convert_hf_model``, ``load_pretrained`` and
  ``export_state_dict`` on a random tiny ``WhisperForConditionalGeneration``:
  equal to the JAX package's conversion.
- The port's encoder and teacher-forced logits against that HF model, at
  the JAX package's tolerances (``tests/test_whisper_model.py``): encoder
  atol 2e-5 rtol 1e-4, logits atol 5e-5 rtol 1e-4 (fp32 sums in another
  order).
- The cached ``decode_step_kv`` against the teacher-forced ``decode_full``
  over the self/cross x step-0/step-n matrix, with float and int8 weights
  and both cross-cache layouts: atol 2e-5 rtol 1e-4, as the JAX package's
  own test. With an int8 KV cache the step reads K and V rounded to 8 bits
  where the full forward reads them exact: 1e-2 of the largest |logit|
  (measured 1.0e-3 to 2.3e-3 over four seeds; one int8 step of the
  per-token scale is 0.4% of each row's largest value).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from whisper_trtllm_tpu.config import WhisperConfig as JaxConfig
from whisper_trtllm_tpu.layers import init as jax_init
from whisper_trtllm_tpu.models.whisper import convert as jax_convert
from whisper_trtllm_tpu.models.whisper import init_params as jax_init_params
from whisper_trtllm_tpu_torch.config import WhisperConfig
from whisper_trtllm_tpu_torch.layers import init as port_init
from whisper_trtllm_tpu_torch.models.whisper import (
    compute_cross_kv,
    convert_hf_model,
    convert_state_dict,
    decode_full,
    decode_step_kv,
    encode,
    export_state_dict,
    init_params,
    init_self_kv,
    init_self_kv_int8,
    load_pretrained,
    quantize_cross_kv,
    transpose_cross_kv,
)
from whisper_trtllm_tpu_torch.quantization import weight_only_quantize
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy


def _leaves(tree, prefix=""):
    """path → numpy leaf, for nested dicts of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.numpy()
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        np.testing.assert_array_equal(got[path], w, err_msg=path)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("init_dense", (24, 40)),
    ("init_layer_norm", (24,)),
    ("init_embedding", (97, 16)),
    ("init_conv1d", (3, 16, 24)),
    ("init_attention", (32,)),
])
def test_layer_init_constructors_are_bit_equal_to_jax(name, args):
    draws = name != "init_layer_norm"
    make = (lambda mod: getattr(mod, name)(np.random.default_rng(7), *args)
            if draws else getattr(mod, name)(*args))
    _assert_trees_equal(make(port_init), make(jax_init))


@pytest.mark.parametrize("overrides,seed", [
    ({}, 0),
    ({"encoder_layers": 3, "decoder_layers": 1, "decoder_ffn_dim": 48}, 5),
])
def test_init_params_is_bit_equal_to_jax(overrides, seed):
    jcfg = JaxConfig.testing(**overrides)
    cfg = WhisperConfig(**dataclasses.asdict(jcfg))
    port = init_params(cfg, seed=seed, device="cpu")
    want = jax_init_params(jcfg, seed=seed)
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in jax.tree_util.tree_leaves(port))
    _assert_trees_equal(port, jax.tree_util.tree_map(np.asarray, want))


def test_init_params_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(WhisperConfig.testing())


# --------------------------------------------------------------------------
# HF conversion
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hf_model():
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration

    torch.manual_seed(0)
    hf_cfg = HFConfig(
        vocab_size=97, num_mel_bins=16, d_model=32, encoder_layers=2,
        encoder_attention_heads=4, decoder_layers=2,
        decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
        max_source_positions=24, max_target_positions=16,
        decoder_start_token_id=1, eos_token_id=2, pad_token_id=2,
        bos_token_id=1, suppress_tokens=[], begin_suppress_tokens=[])
    return WhisperForConditionalGeneration(hf_cfg).eval()


@pytest.fixture(scope="module")
def hf_pair(hf_model):
    params, cfg = convert_hf_model(hf_model, device="cpu")
    return hf_model, params, cfg


def _mel(rng, cfg, batch=2):
    return rng.standard_normal(
        (batch, 2 * cfg.max_source_positions, cfg.num_mel_bins)
    ).astype(np.float32)


def test_convert_state_dict_equals_jax(hf_model):
    jparams, jcfg = jax_convert.convert_hf_model(hf_model)
    cfg = WhisperConfig(**dataclasses.asdict(jcfg))
    _assert_trees_equal(convert_state_dict(hf_model.state_dict(), cfg),
                        jax.tree_util.tree_map(np.asarray, jparams))
    # numpy state dicts convert alike
    sd = {k: v.numpy() for k, v in hf_model.state_dict().items()}
    _assert_trees_equal(convert_state_dict(sd, cfg),
                        jax_convert.convert_state_dict(sd, jcfg))


def test_convert_hf_model_carries_the_tree_and_config(hf_pair):
    hf, params, cfg = hf_pair
    jparams, jcfg = jax_convert.convert_hf_model(hf)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert params["encoder"]["conv1"]["kernel"].device.type == "cpu"
    _assert_trees_equal(params, jax.tree_util.tree_map(np.asarray, jparams))


def test_export_state_dict_equals_jax_and_inverts_the_conversion(hf_pair):
    hf, params, cfg = hf_pair
    got = export_state_dict(params, cfg)
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    want = jax_convert.export_state_dict(
        jax_convert.convert_hf_model(hf)[0], jcfg)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype == np.float32
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    sd = hf.state_dict()
    for k, v in got.items():
        np.testing.assert_array_equal(v, sd[k].numpy(), err_msg=k)
    # proj_out is tied to embed_tokens and not exported
    assert set(sd) - set(got) == {"proj_out.weight"}


def test_load_pretrained_reads_a_local_directory(hf_pair, tmp_path):
    hf, params, cfg = hf_pair
    hf.save_pretrained(str(tmp_path))
    got, got_cfg = load_pretrained(str(tmp_path), device="cpu")
    assert got_cfg == cfg
    _assert_trees_equal(got, params)


def test_encoder_matches_hf(hf_pair, rng):
    hf, params, cfg = hf_pair
    mel = _mel(rng, cfg)
    with torch.no_grad():
        ours = encode(params, cfg, torch.from_numpy(mel)).numpy()
        theirs = hf.model.encoder(
            torch.from_numpy(mel.transpose(0, 2, 1))).last_hidden_state.numpy()
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, atol=2e-5, rtol=1e-4)


def test_decoder_teacher_forced_logits_match_hf(hf_pair, rng):
    hf, params, cfg = hf_pair
    mel = _mel(rng, cfg)
    tokens = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int64)
    with torch.no_grad():
        enc = encode(params, cfg, torch.from_numpy(mel))
        ours = decode_full(params, cfg, torch.from_numpy(tokens), enc).numpy()
        theirs = hf(input_features=torch.from_numpy(mel.transpose(0, 2, 1)),
                    decoder_input_ids=torch.from_numpy(tokens)).logits.numpy()
    np.testing.assert_allclose(ours, theirs, atol=5e-5, rtol=1e-4)


# --------------------------------------------------------------------------
# step == full
# --------------------------------------------------------------------------

def _step_and_full(params, cfg, rng, kv, t_major, s=6):
    mel = torch.from_numpy(_mel(rng, cfg))
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32))
    with torch.no_grad():
        enc = encode(params, cfg, mel)
        full = decode_full(params, cfg, tokens, enc).numpy()
        cross = compute_cross_kv(params, cfg, enc)
        if kv == "int8":
            cross = quantize_cross_kv(*cross)
            self_kv = init_self_kv_int8(cfg, 2, s, device="cpu")
        else:
            self_kv = init_self_kv(cfg, 2, s, device="cpu")
        if t_major:
            cross = transpose_cross_kv(cross)
        steps = []
        for i in range(s):
            logits, self_kv = decode_step_kv(params, cfg, tokens[:, i], i,
                                             self_kv, cross)
            steps.append(logits.numpy())
    return np.stack(steps, axis=1), full


@pytest.mark.parametrize("t_major", [False, True], ids=["bhtd", "bhdt"])
@pytest.mark.parametrize("weights", ["float", "int8"])
def test_decode_step_matches_teacher_forced(hf_pair, rng, weights, t_major):
    """Step 0 reads only its own self-attention row and the whole cross
    cache; step n the n + 1 rows written before it, in place."""
    hf, params, cfg = hf_pair
    if weights == "int8":
        params = params_from_numpy(weight_only_quantize(params), "cpu")
        assert "kernel_q" in params["decoder"]["layers"]["fc1"]
    steps, full = _step_and_full(params, cfg, rng, "float", t_major)
    np.testing.assert_allclose(steps[:, 0], full[:, 0], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(steps[:, 1:], full[:, 1:], atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("t_major", [False, True], ids=["bhtd", "bhdt"])
def test_decode_step_with_an_int8_kv_cache_tracks_teacher_forced(
        hf_pair, rng, t_major):
    hf, params, cfg = hf_pair
    steps, full = _step_and_full(params, cfg, rng, "int8", t_major)
    err = np.abs(steps - full).max() / np.abs(full).max()
    assert 0 < err <= 1e-2
