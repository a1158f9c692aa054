"""PyTorch port: the Bloom zoo model (``models/bloom``) against the JAX
package's on the same weights, on the CPU. Tiny HF ``BloomForCausalLM``
models from a seed (vocabulary 89, 2 layers), converted by the JAX package
and carried over by ``params_from_numpy``:

- ``bloom``: width 32, 4 heads (ALiBi slopes of a power of two);
- ``bloom_h6``: width 48, 6 heads (the interpolated extra slopes).

``forward`` within 1e-5 of JAX's and of HF's; ``init_params`` and the HF
converter bit-equal to JAX's; ``generate`` and ``generate_ragged``
token-equal to JAX, EOS padding included, and the cached generate equal
to HF's greedy ``generate``; every penalty and word rule with greedy
token-equal; sampled generation one draw a seed, another with another
seed, top-k 1 the greedy tokens; ``generate_beam`` tokens and lengths
equal, scores within 1e-5; the step's ALiBi bias made once and kept."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zoo_parity
from zoo_parity import BEAM_SCORE_TOL, FORWARD_TOL, RULES, Family

from torch_threads import capped_threads  # noqa: F401
import whisper_trtllm_tpu.models.bloom.model as jbloom
import whisper_trtllm_tpu_torch.models.bloom.model as tbloom

NAMES = ["bloom", "bloom_h6"]


def _hf(name: str):
    import transformers as T

    torch.manual_seed(0)
    wide = name == "bloom_h6"
    return T.BloomForCausalLM(T.BloomConfig(
        vocab_size=89, hidden_size=48 if wide else 32, n_layer=2,
        n_head=6 if wide else 4, eos_token_id=2, bos_token_id=1,
        attention_dropout=0.0, hidden_dropout=0.0)).eval()


@pytest.fixture(scope="module")
def families():
    """Each family built once, when a test first asks for it."""
    made = {}

    def get(name):
        if name not in made:
            made[name] = Family(jbloom, tbloom, _hf(name), "convert_hf_bloom",
                                "BloomConfig")
        return made[name]

    return get


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax_and_hf(families, name):
    f = families(name)
    e_jax, e_hf = f.forward_errors(f.prompt(0, 2, 9))
    assert e_jax <= FORWARD_TOL and e_hf <= FORWARD_TOL, (e_jax, e_hf)


def test_init_params_and_conversion_equal_jax(families):
    fam = families("bloom")
    cfg = jbloom.BloomConfig.testing()
    got = tbloom.init_params(fam.port_cfg(cfg), seed=3, device="cpu")
    zoo_parity.assert_trees_equal(got, jbloom.init_params(cfg, seed=3))
    params, cfg = tbloom.convert_hf_bloom(fam.hf, device="cpu")
    assert cfg == fam.cfg
    zoo_parity.assert_trees_equal(params, fam.jp)


@pytest.mark.parametrize("name,b,p,new", [
    ("bloom", 2, 4, 12), ("bloom", 3, 7, 20), ("bloom_h6", 2, 5, 12)])
def test_generate_token_equal_to_jax(families, name, b, p, new):
    fam = families(name)
    prompt = fam.prompt(10 * b + p, b, p)
    want = np.asarray(jbloom.generate(fam.jp, fam.jcfg, jnp.asarray(prompt),
                                      new))
    np.testing.assert_array_equal(fam.generate(prompt, new), want)


def test_cached_generate_equals_hf_greedy(families):
    fam = families("bloom")
    prompt = fam.prompt(4, 2, 5)
    with torch.no_grad():
        want = fam.hf.generate(
            torch.from_numpy(prompt.astype(np.int64)), max_new_tokens=7,
            do_sample=False, pad_token_id=fam.cfg.eos_token_id).numpy()
    np.testing.assert_array_equal(fam.generate(prompt, 7), want)


@pytest.mark.parametrize("name", NAMES)
def test_generate_ragged_token_equal_to_jax(families, name):
    fam = families(name)
    prompt = fam.prompt(5, 3, 6)
    lens = np.asarray([6, 2, 4], np.int32)
    want = np.asarray(jbloom.generate_ragged(fam.jp, fam.jcfg,
                                             jnp.asarray(prompt), lens, 10))
    np.testing.assert_array_equal(fam.generate_ragged(prompt, lens, 10), want)


@pytest.mark.parametrize("ragged", [False, True])
def test_eos_padding_equal_to_jax(families, ragged):
    fam = families("bloom")
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
def test_rules_token_equal_to_jax(families, rule):
    fam = families("bloom")
    prompt = fam.prompt(8, 2, 5)
    jsc, sc, jcfg, cfg = fam.rule_cfgs(rule, prompt, 16)
    got = fam.generate(prompt, 16, cfg=cfg, sampling_cfg=sc)
    np.testing.assert_array_equal(got, fam.jax_generate(prompt, 16, jsc,
                                                        jcfg))


def test_ragged_rules_token_equal_to_jax(families):
    fam = families("bloom")
    prompt = fam.prompt(9, 2, 6)
    lens = np.asarray([6, 3], np.int32)
    jsc, sc, jcfg, cfg = fam.rule_cfgs("together", prompt, 12)
    got = fam.generate_ragged(prompt, lens, 12, cfg=cfg, sampling_cfg=sc)
    np.testing.assert_array_equal(
        got, fam.jax_generate_ragged(prompt, lens, 12, jsc, jcfg))


def test_sampled_is_deterministic_diverse_and_top_k_1_greedy(families):
    fam = families("bloom")
    zoo_parity.check_sampling(fam, fam.prompt(11, 2, 4))


@pytest.mark.parametrize("k,alpha", [(3, 1.0), (2, 0.6)])
@pytest.mark.parametrize("name", NAMES)
def test_generate_beam_matches_jax(families, name, k, alpha):
    fam = families(name)
    prompt = fam.prompt(12, 2, 5)
    want = jbloom.generate_beam(fam.jp, fam.jcfg, jnp.asarray(prompt), 10,
                                k, alpha)
    got = tbloom.generate_beam(fam.tp, fam.cfg, prompt, 10, k, alpha,
                               device="cpu")
    zoo_parity.assert_beams_match(got, want, BEAM_SCORE_TOL)


def test_step_bias_is_made_once_and_kept(families):
    fam = families("bloom")
    prompt = fam.prompt(13, 2, 4)
    fam.generate(prompt, 6)
    bias = tbloom.step_bias(fam.cfg.n_head, 10, torch.device("cpu"))
    fam.generate(prompt, 6)
    assert tbloom.step_bias(fam.cfg.n_head, 10, torch.device("cpu")) is bias
    assert bias.shape == (1, fam.cfg.n_head, 1, 10)
