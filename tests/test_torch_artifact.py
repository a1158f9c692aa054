"""PyTorch port: the trained tiny.en int8 artifact end to end on the CPU.

The port's greedy tokens must equal the JAX package's ``transcribe_tokens``
on the same mel, and ``WhisperSession(device="cpu")`` must transcribe all
four bundled utterances exactly as ``artifacts/expected.json`` says.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_trtllm_tpu.audio import log_mel_spectrogram as jax_log_mel
from whisper_trtllm_tpu.config import GenerationConfig as JaxGenerationConfig
from whisper_trtllm_tpu.runtime.generation import (
    transcribe_tokens as jax_transcribe_tokens,
)
from whisper_trtllm_tpu.utils.checkpoint import load_checkpoint as jax_load
from whisper_trtllm_tpu_torch.audio import pad_or_trim, read_wav
from whisper_trtllm_tpu_torch.config import GenerationConfig, RuntimeConfig
from whisper_trtllm_tpu_torch.quantization import dequantize_params
from whisper_trtllm_tpu_torch.runtime.generation import transcribe_tokens
from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
from whisper_trtllm_tpu_torch.utils.vocab import ids_to_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts", "tiny_en_synth_int8")
GEN = GenerationConfig(max_new_tokens=32)


@pytest.fixture(scope="module")
def audio():
    return np.stack([pad_or_trim(read_wav(os.path.join(
        ROOT, "artifacts", "eval", f"utt{i:02d}.wav"))) for i in range(4)])


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(ROOT, "artifacts", "expected.json")) as f:
        return json.load(f)["texts"]


@pytest.fixture(scope="module")
def artifact():
    return load_checkpoint(ART, device="cpu")


def test_greedy_tokens_equal_jax_on_the_artifact(audio, artifact):
    """utt00 and utt02 in one batch: lanes that finish at different steps."""
    batch = audio[[0, 2]]
    mel = np.asarray(jax_log_mel(batch))
    ref_params, ref_cfg = jax_load(ART)
    ref_toks, ref_lens = jax_transcribe_tokens(
        ref_params, ref_cfg, jnp.asarray(mel),
        JaxGenerationConfig(max_new_tokens=32))
    params, cfg = artifact
    toks, lens = transcribe_tokens(params, cfg, mel, GEN, device="cpu")
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))
    assert lens[0] != lens[1]


def test_session_transcribes_all_four_utterances_exactly(audio, expected,
                                                         artifact):
    params, cfg = artifact
    session = WhisperSession(params, cfg, GEN, device="cpu")
    toks, lens = session.transcribe(audio)
    texts = [ids_to_text(toks[i, :lens[i]]) for i in range(len(expected))]
    assert texts == expected
    mel = session.frontend(audio[:1])
    t1, l1 = session.transcribe_features(mel)
    np.testing.assert_array_equal(t1, toks[:1])
    np.testing.assert_array_equal(l1, lens[:1])
    assert tuple(session.encode(mel).shape) == (1, 1500, cfg.d_model)
    assert session.memory_stats() == {"bytes_in_use": None,
                                      "peak_bytes_in_use": None,
                                      "bytes_limit": None}


# the serving-precision configurations: B is the JAX package's serving
# precision (bf16 compute, int8 KV, T-minor cross cache by "auto")
SERVING = {
    "B_bf16_int8_auto": ("bfloat16", "int8", "auto"),
    "C_fp32_int8_bhtd": ("float32", "int8", "bhtd"),
    "D_bf16_fp8_auto": ("bfloat16", "fp8", "auto"),
}


@pytest.mark.parametrize("config", sorted(SERVING))
def test_session_transcribes_exactly_at_serving_precision(audio, expected,
                                                          artifact, config):
    compute, kv, layout = SERVING[config]
    params, cfg = artifact
    gen = GenerationConfig(max_new_tokens=32, kv_cache_dtype=kv,
                           cross_kv_layout=layout)
    session = WhisperSession(params, cfg, gen,
                             RuntimeConfig(compute_dtype=compute),
                             device="cpu")
    toks, lens = session.transcribe(audio)
    texts = [ids_to_text(toks[i, :lens[i]]) for i in range(len(expected))]
    assert texts == expected


def test_session_bf16_compute_keeps_int8_weights(artifact):
    params, cfg = artifact
    session = WhisperSession(params, cfg, GEN,
                             RuntimeConfig(compute_dtype="bfloat16"),
                             device="cpu")
    layers = session.params["encoder"]["layers"]
    assert layers["fc1"]["kernel_q"].dtype == torch.int8
    assert layers["fc1"]["scale"].dtype == torch.bfloat16
    session.warmup(batch=1)


@pytest.fixture(scope="module")
def float_tree(artifact):
    """The artifact's weights dequantized in memory: each kernel = kernel_q
    · scale and the vocab table = table_q · scale[:, None], in fp32."""
    return dequantize_params(artifact[0])


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


@pytest.mark.parametrize("option", ["fuse_qkv", "weight_int8",
                                    "quantize_vocab"])
def test_session_load_time_option_on_the_float_tree(audio, expected, artifact,
                                                    float_tree, option):
    """Each option of the load-time chain on the float tree: the exact
    texts; int8 weights or the int8 table bit-equal to the artifact's; the
    fused q/k/v kernel the concatenation of the three."""
    params, cfg = artifact
    rt = {"fuse_qkv": RuntimeConfig(fuse_qkv=True),
          "weight_int8": RuntimeConfig(weight_dtype="int8"),
          "quantize_vocab": RuntimeConfig(quantize_vocab=True)}[option]
    session = WhisperSession(float_tree, cfg, GEN, rt, device="cpu")
    toks, lens = session.transcribe(audio)
    texts = [ids_to_text(toks[i, :lens[i]]) for i in range(len(expected))]
    assert texts == expected
    if option == "weight_int8":
        got = {k: v for k, v in _leaves(session.params)
               if "embed_tokens" not in k}
        want = {k: v for k, v in _leaves(params) if "embed_tokens" not in k}
        assert got.keys() == want.keys()
        assert sum(k.endswith("kernel_q") for k in got) == 16
        for k in got:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k]), k
    elif option == "quantize_vocab":
        table = session.params["decoder"]["embed_tokens"]
        for key in ("table_q", "scale"):
            assert torch.equal(table[key],
                               params["decoder"]["embed_tokens"][key])
    else:
        layers = session.params["decoder"]["layers"]["self_attn"]
        assert set(layers) == {"qkv", "out"}
        ref = float_tree["decoder"]["layers"]["self_attn"]
        assert torch.equal(layers["qkv"]["kernel"], torch.cat(
            [ref[n]["kernel"] for n in ("q", "k", "v")], dim=-1))


@pytest.mark.parametrize("option,error", [
    (dict(runtime=RuntimeConfig(compute_dtype="float16")),
     NotImplementedError),
    (dict(mesh=object()), TypeError),
], ids=["float16", "mesh"])
def test_session_refuses_options_of_later_slices(artifact, option, error):
    """float16 compute is not ported; a mesh argument that is not a
    (data, model) mesh is refused (sessions over a mesh are held against
    JAX in tests/test_torch_parallel.py)."""
    params, cfg = artifact
    with pytest.raises(error):
        WhisperSession(params, cfg, device="cpu", **option)


@pytest.mark.parametrize("weight_dtype", ["int-8", "nf4", ""])
def test_session_refuses_an_unknown_weight_dtype(artifact, weight_dtype):
    """As the JAX session does (its ``_prepare_params``): a ValueError that
    names the known values."""
    params, cfg = artifact
    with pytest.raises(ValueError, match="unknown weight_dtype.*native/int8/"
                                         "int4/fp8"):
        WhisperSession(params, cfg, runtime=RuntimeConfig(
            weight_dtype=weight_dtype), device="cpu")


def test_session_beam_search_transcribes_all_four_utterances_exactly(
        audio, expected, artifact):
    """``num_beams=4``: the best hypothesis of each utterance, in greedy's
    signature, gives the expected texts."""
    params, cfg = artifact
    session = WhisperSession(
        params, cfg, GenerationConfig(max_new_tokens=32, num_beams=4),
        device="cpu")
    toks, lens = session.transcribe(audio)
    assert toks.shape == (4, 33) and toks.dtype == np.int32
    assert [ids_to_text(toks[i, :lens[i]])
            for i in range(len(expected))] == expected


def test_session_refuses_engine_export(artifact, tmp_path):
    """Beam search is not exported (the greedy pipeline is:
    ``tests/test_torch_engine.py``)."""
    params, cfg = artifact
    session = WhisperSession(params, cfg, dataclasses.replace(
        GEN, num_beams=2), device="cpu")
    with pytest.raises(NotImplementedError, match="beam"):
        session.export_engine(str(tmp_path / "engine.bin"))
