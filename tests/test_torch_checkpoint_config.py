"""PyTorch port: configuration and checkpoint I/O against the JAX package.

The port keeps its own copies of the config dataclasses and reads flax
msgpack with plain ``msgpack``; both must agree with the JAX package
field for field and value for value (exact: nothing is computed).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from whisper_trtllm_tpu import config as jax_config
from whisper_trtllm_tpu.models.whisper import init_params
from whisper_trtllm_tpu.utils.checkpoint import load_checkpoint as jax_load
from whisper_trtllm_tpu_torch import config as torch_config
from whisper_trtllm_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    params_from_numpy,
)

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "artifacts", "tiny_en_synth_int8")


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _torch_dtype(np_dtype):
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


@pytest.mark.parametrize(
    "name", ["WhisperConfig", "GenerationConfig", "RuntimeConfig"])
def test_config_fields_and_defaults_match_jax(name):
    ours, ref = getattr(torch_config, name), getattr(jax_config, name)
    assert ([f.name for f in dataclasses.fields(ours)]
            == [f.name for f in dataclasses.fields(ref)])
    assert dataclasses.asdict(ours()) == dataclasses.asdict(ref())


@pytest.mark.parametrize(
    "preset", ["tiny.en", "base.en", "small.en", "medium.en", "large-v3"])
def test_presets_match_jax(preset):
    assert (dataclasses.asdict(torch_config.WhisperConfig.preset(preset))
            == dataclasses.asdict(jax_config.WhisperConfig.preset(preset)))


def test_json_round_trips_between_packages():
    ref = jax_config.WhisperConfig.testing(max_source_positions=20)
    ours = torch_config.WhisperConfig.from_json(ref.to_json())
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert jax_config.WhisperConfig.from_json(ours.to_json()) == ref
    gen = torch_config.GenerationConfig(max_new_tokens=7, bad_words=((1, 2),))
    assert jax_config.GenerationConfig.from_json(gen.to_json()) == \
        jax_config.GenerationConfig(max_new_tokens=7, bad_words=((1, 2),))
    rt = torch_config.RuntimeConfig(compute_dtype="bfloat16")
    assert torch_config.RuntimeConfig.from_json(rt.to_json()) == rt


def test_load_checkpoint_matches_jax_on_the_artifact():
    ref_params, ref_cfg = jax_load(ART)
    params, cfg = load_checkpoint(ART, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_flat, flat = _flatten(ref_params), _flatten(params)
    assert sorted(flat) == sorted(ref_flat)
    for key, ref in ref_flat.items():
        got = flat[key]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert tuple(got.shape) == ref.shape, key
        assert got.dtype == _torch_dtype(ref.dtype), key
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=key)
    assert flat["/decoder/embed_tokens/table_q"].dtype == torch.int8


def test_params_from_numpy_carries_the_jax_tree():
    cfg = jax_config.WhisperConfig.testing()
    ref = init_params(cfg, seed=3)
    params = params_from_numpy(ref, "cpu")
    ref_flat, flat = _flatten(ref), _flatten(params)
    assert sorted(flat) == sorted(ref_flat)
    for key, arr in ref_flat.items():
        arr = np.asarray(arr)
        assert tuple(flat[key].shape) == arr.shape, key
        np.testing.assert_array_equal(flat[key].numpy(), arr, err_msg=key)
    # (in, out) kernels with the stacked leading layer axis, untransposed
    assert tuple(params["decoder"]["layers"]["fc1"]["kernel"].shape) == (
        cfg.decoder_layers, cfg.d_model, cfg.decoder_ffn_dim)


def test_params_from_numpy_casts_only_wide_floats():
    tree = {"w": np.ones((2, 3), np.float32), "q": np.ones((3,), np.int8),
            "nested": {"b": np.zeros((3,), np.float32)}}
    out = params_from_numpy(tree, "cpu", dtype=torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16
    assert out["nested"]["b"].dtype == torch.bfloat16
    assert out["q"].dtype == torch.int8
