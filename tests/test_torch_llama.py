"""PyTorch port: the LLaMA zoo model (``models/llama``) against the JAX
package's on the same weights (a tiny HF LLaMA: vocabulary 89, width 32,
2 layers, 4 heads over 2 key/value heads (GQA), 48 positions, and the
same with 4 key/value heads, converted by the JAX package and carried
over by ``params_from_numpy``), on the CPU.

``rope_sin_cos``/``apply_rope`` within 1e-6 of JAX's; ``forward`` within
1e-5 of JAX's and of HF's; ``init_params`` and ``convert_hf_llama``
bit-equal to JAX's; ``generate`` and ``generate_ragged`` token-equal to
JAX, EOS padding included; every penalty and word rule with greedy
token-equal; sampled generation one draw a seed, another with another
seed, top-k 1 the greedy tokens; ``generate_beam`` tokens and lengths
equal, scores within 1e-5."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zoo_parity
from zoo_parity import BEAM_SCORE_TOL, FORWARD_TOL, RULES, Family

from torch_threads import capped_threads  # noqa: F401
import whisper_trtllm_tpu.models.llama.model as jllama
import whisper_trtllm_tpu_torch.models.llama.model as tllama


def _family(kv_heads: int) -> Family:
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    hf = LlamaForCausalLM(LlamaConfig(
        vocab_size=89, hidden_size=32, intermediate_size=56,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=kv_heads, max_position_embeddings=48,
        rms_norm_eps=1e-6, eos_token_id=2, bos_token_id=1,
        attention_dropout=0.0, tie_word_embeddings=False)).eval()
    return Family(jllama, tllama, hf, "convert_hf_llama", "LlamaConfig",
                  kv_heads="n_kv_head")


@pytest.fixture(scope="module")
def fam():
    f = _family(2)
    assert f.cfg.n_kv_head == 2
    return f


@pytest.fixture(scope="module")
def mha_fam():
    return _family(4)


def test_rope_matches_jax(fam):
    import jax.numpy as jnp

    pos = np.asarray([0, 3, 17, 40], np.int32)
    sin, cos = tllama.rope_sin_cos(fam.cfg, torch.from_numpy(pos))
    jsin, jcos = jllama.rope_sin_cos(fam.jcfg, jnp.asarray(pos))
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    x = np.random.default_rng(1).standard_normal((2, 4, 4, 8)).astype(
        np.float32)
    got = tllama.apply_rope(torch.from_numpy(x), sin, cos)
    want = jllama.apply_rope(jnp.asarray(x), jsin, jcos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("kv", ["gqa", "mha"])
def test_forward_matches_jax_and_hf(fam, mha_fam, kv):
    f = fam if kv == "gqa" else mha_fam
    e_jax, e_hf = f.forward_errors(f.prompt(0, 2, 9))
    assert e_jax <= FORWARD_TOL and e_hf <= FORWARD_TOL, (e_jax, e_hf)


def test_generate_without_gqa_token_equal_to_jax(mha_fam):
    prompt = mha_fam.prompt(3, 2, 6)
    want = np.asarray(jllama.generate(mha_fam.jp, mha_fam.jcfg,
                                      jnp.asarray(prompt), 12))
    np.testing.assert_array_equal(mha_fam.generate(prompt, 12), want)


def test_init_params_and_conversion_equal_jax(fam):
    cfg = jllama.LlamaConfig.testing()
    got = tllama.init_params(fam.port_cfg(cfg), seed=3, device="cpu")
    zoo_parity.assert_trees_equal(got, jllama.init_params(cfg, seed=3))
    params, cfg = tllama.convert_hf_llama(fam.hf, device="cpu")
    assert cfg == fam.cfg
    zoo_parity.assert_trees_equal(params, fam.jp)


@pytest.mark.parametrize("b,p,new", [(2, 4, 12), (3, 7, 20)])
def test_generate_token_equal_to_jax(fam, b, p, new):
    prompt = fam.prompt(10 * b + p, b, p)
    want = np.asarray(jllama.generate(fam.jp, fam.jcfg, jnp.asarray(prompt),
                                    new))
    np.testing.assert_array_equal(fam.generate(prompt, new), want)


def test_generate_ragged_token_equal_to_jax(fam):
    prompt = fam.prompt(5, 3, 6)
    lens = np.asarray([6, 2, 4], np.int32)
    want = np.asarray(jllama.generate_ragged(fam.jp, fam.jcfg,
                                           jnp.asarray(prompt), lens, 10))
    np.testing.assert_array_equal(fam.generate_ragged(prompt, lens, 10), want)


@pytest.mark.parametrize("ragged", [False, True])
def test_eos_padding_equal_to_jax(fam, ragged):
    prompt = fam.prompt(7, 3, 5)
    jcfg = dataclasses.replace(fam.jcfg,
                               eos_token_id=fam.eos_from_trajectory(prompt,
                                                                    16))
    cfg = fam.port_cfg(jcfg)
    if ragged:
        lens = np.asarray([5, 3, 4], np.int32)
        got = fam.generate_ragged(prompt, lens, 16, cfg=cfg)
        want = fam.jax_generate_ragged(prompt, lens, 16, jcfg=jcfg)
    else:
        got = fam.generate(prompt, 16, cfg=cfg)
        want = fam.jax_generate(prompt, 16, jcfg=jcfg)
    np.testing.assert_array_equal(got, want)
    assert (got == jcfg.eos_token_id).any()


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rules_token_equal_to_jax(fam, rule):
    prompt = fam.prompt(8, 2, 5)
    jsc, sc, jcfg, cfg = fam.rule_cfgs(rule, prompt, 16)
    got = fam.generate(prompt, 16, cfg=cfg, sampling_cfg=sc)
    np.testing.assert_array_equal(got, fam.jax_generate(prompt, 16, jsc,
                                                        jcfg))


def test_ragged_rules_token_equal_to_jax(fam):
    prompt = fam.prompt(9, 2, 6)
    lens = np.asarray([6, 3], np.int32)
    jsc, sc, jcfg, cfg = fam.rule_cfgs("together", prompt, 12)
    got = fam.generate_ragged(prompt, lens, 12, cfg=cfg, sampling_cfg=sc)
    np.testing.assert_array_equal(
        got, fam.jax_generate_ragged(prompt, lens, 12, jsc, jcfg))


def test_sampled_is_deterministic_diverse_and_top_k_1_greedy(fam):
    zoo_parity.check_sampling(fam, fam.prompt(11, 2, 4))


@pytest.mark.parametrize("k,alpha", [(3, 1.0), (2, 0.6)])
def test_generate_beam_matches_jax(fam, k, alpha):
    prompt = fam.prompt(12, 2, 5)
    want = jllama.generate_beam(fam.jp, fam.jcfg, jnp.asarray(prompt), 10, k,
                              alpha)
    got = tllama.generate_beam(fam.tp, fam.cfg, prompt, 10, k, alpha,
                             device="cpu")
    zoo_parity.assert_beams_match(got, want, BEAM_SCORE_TOL)
