"""PyTorch port: the float-weight path and the session's load-time chain on
the CPU.

The float tree is the trained int8 artifact dequantized in memory (each
kernel = kernel_q · scale, the vocab table = table_q · scale[:, None],
fp32); quantizing it again gives back the artifact's int8 values and
scales bit for bit, so it is a real-weight gate with no download. Here:

- the quantization functions are bit-equal to the JAX package's;
- the float tree transcribes the four bundled utterances exactly in fp32
  and bf16, with fp32 tokens equal to the JAX package's on the same tree;
- with the fused decode step forced on (the plain K6 on the CPU) it still
  transcribes exactly, with the unfused path's tokens;
- configuration G (bf16, int8 weights, int8 vocab table, fused q/k/v, int8
  KV cache) transcribes exactly, its int8 tensors bit-equal to the
  artifact's;
- ``refit`` sends a new tree through the same chain.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_trtllm_tpu.audio import log_mel_spectrogram as jax_log_mel
from whisper_trtllm_tpu.config import GenerationConfig as JaxGenerationConfig
from whisper_trtllm_tpu.quantization import quantize as jax_quant
from whisper_trtllm_tpu.runtime.generation import (
    transcribe_tokens as jax_transcribe_tokens,
)
from whisper_trtllm_tpu.utils.checkpoint import load_checkpoint as jax_load
from whisper_trtllm_tpu_torch import quantization as quant
from whisper_trtllm_tpu_torch.audio import pad_or_trim, read_wav
from whisper_trtllm_tpu_torch.config import GenerationConfig, RuntimeConfig
from whisper_trtllm_tpu_torch.models.whisper import model
from whisper_trtllm_tpu_torch.ops.kernels import KERNELS, reset_launch_counts
from whisper_trtllm_tpu_torch.runtime import generation
from whisper_trtllm_tpu_torch.runtime.generation import transcribe_tokens
from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
from whisper_trtllm_tpu_torch.utils.vocab import ids_to_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts", "tiny_en_synth_int8")
GEN = GenerationConfig(max_new_tokens=32)
# configuration G: the float tree through the whole load-time chain
G_RUNTIME = RuntimeConfig(compute_dtype="bfloat16", weight_dtype="int8",
                          quantize_vocab=True, fuse_qkv=True)
G_GEN = GenerationConfig(max_new_tokens=32, kv_cache_dtype="int8")


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


@pytest.fixture(scope="module")
def float_tree(artifact):
    return quant.dequantize_params(artifact[0])


def _texts(toks, lens):
    return [ids_to_text(toks[i, :lens[i]]) for i in range(len(lens))]


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


# --------------------------------------------------------------------------
# the quantization functions against the JAX package
# --------------------------------------------------------------------------

def test_quantize_kernel_and_dequantize_match_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((48, 40)).astype(np.float32) * 0.05
    w[:, 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    rq, rs = jax_quant.quantize_kernel(w)
    q, s = quant.quantize_kernel(torch.from_numpy(w))
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, rq)
    np.testing.assert_array_equal(s, rs)
    deq = quant.dequantize_kernel(torch.from_numpy(q), torch.from_numpy(s))
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jax_quant.dequantize_kernel(
            jnp.asarray(rq), jnp.asarray(rs))))
    stacked = np.stack([w, 2 * w])
    got = quant.quantize_dense_params({"kernel": stacked,
                                       "bias": np.ones(40, np.float32)})
    want = jax_quant.quantize_dense_params({"kernel": stacked,
                                            "bias": np.ones(40, np.float32)})
    assert set(got) == set(want) == {"kernel_q", "scale", "bias"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    conv = {"kernel": rng.standard_normal((3, 4, 5, 6)).astype(np.float32)}
    assert set(quant.quantize_dense_params(conv)) == {"kernel"}


def test_weight_only_and_vocab_quantization_match_jax(artifact, float_tree):
    """On the float tree (tensors) and on its numpy copy (the JAX input):
    the same keys, int8 values and scales, bit for bit."""
    nested = _numpy_tree(float_tree)
    want = jax_quant.quantize_vocab_embedding(
        jax_quant.weight_only_quantize(nested))
    got = quant.quantize_vocab_embedding(quant.weight_only_quantize(float_tree))
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys() == dict(_leaves(artifact[0])).keys()
    for k in got:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)
    table = quant.quantize_embedding(float_tree["decoder"]["embed_tokens"])
    np.testing.assert_array_equal(
        table["table_q"], artifact[0]["decoder"]["embed_tokens"]["table_q"])


# --------------------------------------------------------------------------
# the float tree end to end
# --------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_float_tree_transcribes_exactly(audio, expected, artifact, float_tree,
                                        compute):
    session = WhisperSession(float_tree, artifact[1], GEN,
                             RuntimeConfig(compute_dtype=compute),
                             device="cpu")
    assert session.params["decoder"]["layers"]["fc1"]["kernel"].dtype == \
        getattr(torch, compute)
    assert _texts(*session.transcribe(audio)) == expected


def test_float_tree_tokens_equal_jax(audio, artifact, float_tree):
    mel = np.asarray(jax_log_mel(audio[[1, 3]]))
    _, ref_cfg = jax_load(ART)
    nested = _numpy_tree(float_tree)
    ref_toks, ref_lens = jax_transcribe_tokens(
        nested, ref_cfg, jnp.asarray(mel),
        JaxGenerationConfig(max_new_tokens=32))
    toks, lens = transcribe_tokens(float_tree, artifact[1], mel, GEN,
                                   device="cpu")
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))


def test_float_tree_transcribes_exactly_through_the_fused_step(
        audio, expected, artifact, float_tree, monkeypatch):
    """The fused decode step forced on the CPU: every decoder layer of
    every step goes through the plain K6 (counted here, since the wrapper
    counts only launches on the card), with the unfused path's tokens."""
    session = WhisperSession(float_tree, artifact[1], GEN, device="cpu")
    ref = session.transcribe(audio)
    calls = []
    real = model.fused_decoder_layer_step

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(model, "fused_decode_enabled", lambda device: True)
    monkeypatch.setattr(model, "fused_decoder_layer_step", counting)
    reset_launch_counts()
    generation.reset_loop_counts()
    toks, lens = session.transcribe(audio)
    assert _texts(toks, lens) == _texts(*ref) == expected
    np.testing.assert_array_equal(toks, ref[0])
    # the loop reads `finished` once every FINISH_CHECK_EVERY steps: it
    # runs the steps the longest lane needs and at most that many more - 1
    steps = generation.LOOP.steps
    assert 0 <= steps - (int(lens.max()) - 1) < generation.FINISH_CHECK_EVERY
    assert len(calls) == artifact[1].decoder_layers * steps
    assert all(f.launches == 0 for f in KERNELS.values())


def test_configuration_g_transcribes_exactly_with_the_artifacts_int8(
        audio, expected, artifact, float_tree):
    session = WhisperSession(float_tree, artifact[1], G_GEN, G_RUNTIME,
                             device="cpu")
    assert _texts(*session.transcribe(audio)) == expected
    params = artifact[0]
    sa = session.params["decoder"]["layers"]["self_attn"]
    assert set(sa) == {"qkv", "out"} and sa["qkv"]["kernel_q"].dtype == torch.int8
    # the fused q/k/v quantizes per output channel: its int8 columns and
    # scales are the three projections' own
    ref = params["decoder"]["layers"]["self_attn"]
    for key in ("kernel_q", "scale"):
        assert torch.equal(sa["qkv"][key], torch.cat(
            [ref[n][key] for n in ("q", "k", "v")], dim=-1).to(sa["qkv"][key].dtype))
    got = dict(_leaves(session.params))
    for k, v in _leaves(params):
        if k.endswith(("kernel_q", "table_q")) and k in got:
            assert torch.equal(got[k], v), k
    assert got["/decoder/embed_tokens/table_q"].dtype == torch.int8


def test_refit_sends_a_new_tree_through_the_same_chain(artifact, float_tree):
    halved = quant.dequantize_params(artifact[0])
    halved["decoder"] = {**halved["decoder"], "embed_tokens":
                         halved["decoder"]["embed_tokens"] * 0.5}
    rt = RuntimeConfig(weight_dtype="int8", quantize_vocab=True)
    session = WhisperSession(halved, artifact[1], GEN, rt, device="cpu")
    before = session.params["decoder"]["embed_tokens"]["scale"].clone()
    session.refit(float_tree)
    table = session.params["decoder"]["embed_tokens"]
    assert not torch.equal(before, table["scale"])
    for key in ("table_q", "scale"):
        assert torch.equal(table[key], artifact[0]["decoder"]["embed_tokens"][key])
    assert torch.equal(session.params["encoder"]["layers"]["fc1"]["kernel_q"],
                       artifact[0]["encoder"]["layers"]["fc1"]["kernel_q"])
