"""PyTorch port: the BERT zoo model (``models/bert``) against the JAX
package's on the same weights (a tiny random HF ``BertModel``: vocabulary
97, width 32, 2 layers, 4 heads, 24 positions, converted by the JAX
package and carried over by ``params_from_numpy``) and against HF itself,
on the CPU.

``forward``'s sequence output and pooled output within 1e-5 of JAX's and
of HF's (fp32 sums in another order), without a mask, with one and with
token types (HF compared at the unmasked positions, as the JAX package's
test compares them: HF masks with the dtype's minimum, the JAX package
with -1e9); ``init_params`` and ``convert_hf_bert`` bit-equal to JAX's;
``bench_zoo``'s BERT row (the JAX row's keys) on the CPU."""

import math

import numpy as np
import pytest
import torch

import zoo_parity
from torch_threads import capped_threads  # noqa: F401
import whisper_trtllm_tpu.models.bert.model as jbert
import whisper_trtllm_tpu_torch.models.bert.model as tbert
from whisper_trtllm_tpu_torch.benchmarks import allowed_configs, benchmark

TOL = 1e-5


@pytest.fixture(scope="module")
def hf_pair():
    from transformers import BertConfig as HFConfig
    from transformers import BertModel

    torch.manual_seed(0)
    hf = BertModel(HFConfig(
        vocab_size=97, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=24, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)).eval()
    jp, jcfg = jbert.convert_hf_bert(hf)
    tp, tcfg = tbert.convert_hf_bert(hf, device="cpu")
    return hf, jp, jcfg, tp, tcfg


def _inputs(seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 97, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[0, 8:] = 0
    mask[1, 5:] = 0
    types = rng.integers(0, 2, (2, 12)).astype(np.int32)
    return tokens, mask, types


@pytest.mark.parametrize("masked,typed", [(False, False), (True, False),
                                          (False, True), (True, True)])
def test_forward_matches_jax_and_hf(hf_pair, masked, typed):
    hf, jp, jcfg, tp, tcfg = hf_pair
    tokens, mask, types = _inputs(int(masked) + 2 * int(typed))
    m = mask if masked else None
    t = types if typed else None
    seq, pooled = tbert.forward(tp, tcfg, tokens, m, t)
    jseq, jpooled = jbert.forward(jp, jcfg, tokens, m, t)
    np.testing.assert_allclose(seq.numpy(), np.asarray(jseq), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled),
                               atol=TOL, rtol=TOL)
    with torch.no_grad():
        out = hf(torch.from_numpy(tokens.astype(np.int64)),
                 attention_mask=None if m is None else torch.from_numpy(
                     mask.astype(np.int64)),
                 token_type_ids=None if t is None else torch.from_numpy(
                     types.astype(np.int64)))
    valid = mask.astype(bool) if masked else np.ones_like(mask, bool)
    np.testing.assert_allclose(seq.numpy()[valid],
                               out.last_hidden_state.numpy()[valid],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(pooled.numpy(), out.pooler_output.numpy(),
                               atol=TOL, rtol=TOL)


def test_init_params_and_conversion_equal_jax(hf_pair):
    _, jp, jcfg, tp, tcfg = hf_pair
    assert tcfg.__dict__ == jcfg.__dict__
    zoo_parity.assert_trees_equal(tp, jp)
    cfg = tbert.BertConfig.testing()
    zoo_parity.assert_trees_equal(
        tbert.init_params(cfg, seed=3, device="cpu"),
        jbert.init_params(jbert.BertConfig.testing(), seed=3))


@pytest.fixture
def bert_registry(monkeypatch):
    entry = allowed_configs.BenchConfig(
        family="bert",
        model_kwargs=dict(n_layer=2, n_head=4, d_model=32, ffn_dim=64,
                          vocab_size=97, max_position_embeddings=24),
        max_batch_size=4, max_input_len=16, max_output_len=0)
    monkeypatch.setattr(allowed_configs, "ALLOWED_CONFIGS",
                        {"bert_test": entry})
    monkeypatch.setattr(benchmark, "ALLOWED_CONFIGS", {"bert_test": entry})


@pytest.mark.parametrize("dtype,quant", [("float32", None),
                                         ("bfloat16", None),
                                         ("float32", "int8")])
def test_bench_zoo_bert_row_on_the_cpu(bert_registry, dtype, quant):
    """The encoder's row: the JAX row's ``tokens_encoded_per_s`` over
    batch x input length and ``sequences_per_s``, cut to the entry's
    limits, no output length."""
    row = benchmark.bench_zoo("bert_test", batch=8, in_len=20, out_len=10,
                              dtype=dtype, iters=2, quant=quant,
                              device="cpu")
    assert (row["batch"], row["input_len"], row["output_len"]) == (4, 16, 0)
    assert row["family"] == "bert" and "tokens_per_s" not in row
    for key in ("latency_ms_p50", "tokens_encoded_per_s", "sequences_per_s"):
        assert math.isfinite(row[key]) and row[key] > 0, key
    assert math.isclose(row["tokens_encoded_per_s"],
                        16 * row["sequences_per_s"])
    assert row["launches"] == {}


@pytest.mark.parametrize("name", ["bert_base", "bert_large", "bert_tiny"])
def test_the_bert_configs_build_without_a_generate(name):
    fam, cfg, init_params, generate, forward = allowed_configs.build_model(
        name)
    assert fam == "bert" and generate is None
    assert init_params is tbert.init_params and forward is tbert.forward
    assert cfg == tbert.BertConfig(
        **allowed_configs.ALLOWED_CONFIGS[name].model_kwargs)
