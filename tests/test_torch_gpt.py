"""PyTorch port: the GPT zoo model (``models/gpt``) against the JAX
package's on the same weights (a tiny HF GPT-2: vocabulary 89, width 32,
2 layers, 4 heads, 48 positions, converted by the JAX package and carried
over by ``params_from_numpy``), on the CPU.

``forward`` within 1e-5 of JAX's and of HF's; ``init_params`` and
``convert_hf_gpt2`` bit-equal to JAX's; ``generate``, ``generate_ragged``
and ``generate_ptuning`` token-equal to JAX, EOS padding included (an EOS
the greedy trajectory reaches, so lanes stop early); every penalty and
word rule with greedy token-equal; sampled generation one draw a seed,
another with another seed, top-k 1 the greedy tokens; ``generate_beam``'s
tokens and lengths equal, scores within 1e-5."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zoo_parity
from zoo_parity import BEAM_SCORE_TOL, FORWARD_TOL, RULES, Family

from torch_threads import capped_threads  # noqa: F401
import whisper_trtllm_tpu.models.gpt.model as jgpt
import whisper_trtllm_tpu_torch.models.gpt.model as tgpt


@pytest.fixture(scope="module")
def fam():
    from transformers import GPT2Config, GPT2LMHeadModel

    torch.manual_seed(0)
    hf = GPT2LMHeadModel(GPT2Config(
        vocab_size=89, n_positions=48, n_embd=32, n_layer=2, n_head=4,
        eos_token_id=2, bos_token_id=1)).eval()
    return Family(jgpt, tgpt, hf, "convert_hf_gpt2", "GPTConfig")


def test_forward_matches_jax_and_hf(fam):
    e_jax, e_hf = fam.forward_errors(fam.prompt(0, 2, 9))
    assert e_jax <= FORWARD_TOL and e_hf <= FORWARD_TOL, (e_jax, e_hf)


def test_init_params_and_conversion_equal_jax(fam):
    cfg = jgpt.GPTConfig.testing()
    got = tgpt.init_params(fam.port_cfg(cfg), seed=3, device="cpu")
    zoo_parity.assert_trees_equal(got, jgpt.init_params(cfg, seed=3))
    params, cfg = tgpt.convert_hf_gpt2(fam.hf, device="cpu")
    assert cfg == fam.cfg
    zoo_parity.assert_trees_equal(params, fam.jp)


@pytest.mark.parametrize("b,p,new", [(2, 4, 12), (3, 7, 20)])
def test_generate_token_equal_to_jax(fam, b, p, new):
    prompt = fam.prompt(10 * b + p, b, p)
    want = np.asarray(jgpt.generate(fam.jp, fam.jcfg, jnp.asarray(prompt),
                                    new))
    np.testing.assert_array_equal(fam.generate(prompt, new), want)


def test_generate_ragged_token_equal_to_jax(fam):
    prompt = fam.prompt(5, 3, 6)
    lens = np.asarray([6, 2, 4], np.int32)
    want = np.asarray(jgpt.generate_ragged(fam.jp, fam.jcfg,
                                           jnp.asarray(prompt), lens, 10))
    np.testing.assert_array_equal(fam.generate_ragged(prompt, lens, 10), want)


def test_generate_ptuning_token_equal_to_jax(fam):
    rng = np.random.default_rng(6)
    prompt_table = rng.standard_normal((2, 3, 32)).astype(np.float32) * 0.5
    v = fam.jcfg.vocab_size
    ids = np.asarray([[v, v + 1, 5, 9], [v + 2, 7, v, 11]], np.int32)
    tasks = np.asarray([1, 0], np.int32)
    want = np.asarray(jgpt.generate_ptuning(fam.jp, fam.jcfg,
                                            jnp.asarray(ids), prompt_table,
                                            tasks, 10))
    got = tgpt.generate_ptuning(fam.tp, fam.cfg, ids, prompt_table, tasks, 10,
                                device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


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
    want = jgpt.generate_beam(fam.jp, fam.jcfg, jnp.asarray(prompt), 10, k,
                              alpha)
    got = tgpt.generate_beam(fam.tp, fam.cfg, prompt, 10, k, alpha,
                             device="cpu")
    zoo_parity.assert_beams_match(got, want, BEAM_SCORE_TOL)
