"""PyTorch port: the GPT-J and GPT-NeoX zoo models (``models/gptj``,
``models/gptneox``) against the JAX package's on the same weights, on the
CPU. Tiny HF models from a seed (vocabulary 89, 2 layers, 48 positions),
converted by the JAX package and carried over by ``params_from_numpy``:

- ``gptj``: width 32, 4 heads, rotary_dim 4 (interleaved);
- ``gptneox_parallel`` and ``gptneox_sequential``: width 32, 4 heads,
  rotary_pct 0.5, both residual forms;
- ``gptj_dh256``: width 512 over 2 heads, so the attention runs at
  GPT-J-6B's head width of 256, rotary_dim 64.

The rotary embeddings within 1e-6 of JAX's; ``forward`` within 1e-5 of
JAX's and of HF's; ``init_params`` and the HF converters bit-equal to
JAX's; ``generate`` and ``generate_ragged`` token-equal to JAX, EOS
padding included; every penalty and word rule with greedy token-equal;
sampled generation one draw a seed, another with another seed, top-k 1
the greedy tokens; ``generate_beam`` tokens and lengths equal, scores
within 1e-5."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zoo_parity
from zoo_parity import BEAM_SCORE_TOL, FORWARD_TOL, RULES, Family

from torch_threads import capped_threads  # noqa: F401
import whisper_trtllm_tpu.models.gptj.model as jgptj
import whisper_trtllm_tpu.models.gptneox.model as jneox
import whisper_trtllm_tpu_torch.models.gptj.model as tgptj
import whisper_trtllm_tpu_torch.models.gptneox.model as tneox

SMALL = ["gptj", "gptneox_parallel", "gptneox_sequential"]
ALL = SMALL + ["gptj_dh256"]


def _hf(name: str):
    import transformers as T

    torch.manual_seed(0)
    if name.startswith("gptj"):
        wide = name == "gptj_dh256"
        return T.GPTJForCausalLM(T.GPTJConfig(
            vocab_size=89, n_positions=48, n_embd=512 if wide else 32,
            n_layer=2, n_head=2 if wide else 4, rotary_dim=64 if wide else 4,
            n_inner=None if wide else 64, eos_token_id=2, bos_token_id=1,
            resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)).eval()
    return T.GPTNeoXForCausalLM(T.GPTNeoXConfig(
        vocab_size=89, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=48, rotary_pct=0.5,
        use_parallel_residual=name == "gptneox_parallel", eos_token_id=2,
        bos_token_id=1, hidden_dropout=0.0, attention_dropout=0.0)).eval()


def _family(name: str) -> Family:
    if name.startswith("gptj"):
        return Family(jgptj, tgptj, _hf(name), "convert_hf_gptj", "GPTJConfig")
    return Family(jneox, tneox, _hf(name), "convert_hf_gptneox",
                  "GPTNeoXConfig")


@pytest.fixture(scope="module")
def families():
    """Each family built once, when a test first asks for it."""
    made = {}

    def get(name):
        if name not in made:
            made[name] = _family(name)
        return made[name]

    return get


def test_shapes_of_the_families(families):
    assert families("gptj_dh256").cfg.head_dim == 256
    assert families("gptj").cfg.head_dim == 8
    for name in ("gptneox_parallel", "gptneox_sequential"):
        cfg = families(name).cfg
        assert cfg.rotary_dim == 4
        assert cfg.use_parallel_residual is (name == "gptneox_parallel")


def test_rope_matches_jax(families):
    pos = np.asarray([0, 3, 17, 40], np.int32)
    x = np.random.default_rng(1).standard_normal((2, 4, 4, 8)).astype(
        np.float32)
    sin, cos = tgptj.rope_interleaved_sin_cos(4, torch.from_numpy(pos))
    jsin, jcos = jgptj.rope_interleaved_sin_cos(4, jnp.asarray(pos))
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    got = tgptj.apply_rope_interleaved(torch.from_numpy(x), sin, cos, 4)
    want = jgptj.apply_rope_interleaved(jnp.asarray(x), jsin, jcos, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    fam = families("gptneox_parallel")
    sin, cos = tneox.neox_rope_sin_cos(fam.cfg, torch.from_numpy(pos))
    jsin, jcos = jneox.neox_rope_sin_cos(fam.jcfg, jnp.asarray(pos))
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    got = tneox.apply_partial_rope(torch.from_numpy(x), sin, cos, 4)
    want = jneox.apply_partial_rope(jnp.asarray(x), jsin, jcos, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("name", ALL)
def test_forward_matches_jax_and_hf(families, name):
    f = families(name)
    e_jax, e_hf = f.forward_errors(f.prompt(0, 2, 9))
    assert e_jax <= FORWARD_TOL and e_hf <= FORWARD_TOL, (e_jax, e_hf)


@pytest.mark.parametrize("name", ["gptj", "gptneox_sequential"])
def test_init_params_and_conversion_equal_jax(families, name):
    fam = families(name)
    jmod, tmod = fam.jmod, fam.tmod
    cfg = getattr(jmod, fam.cfg.__class__.__name__).testing()
    got = tmod.init_params(fam.port_cfg(cfg), seed=3, device="cpu")
    zoo_parity.assert_trees_equal(got, jmod.init_params(cfg, seed=3))
    params, cfg = getattr(tmod, fam.converter)(fam.hf, device="cpu")
    assert cfg == fam.cfg
    zoo_parity.assert_trees_equal(params, fam.jp)


@pytest.mark.parametrize("name,b,p,new", [
    (n, b, p, new) for n in SMALL for b, p, new in [(2, 4, 12), (3, 7, 20)]
] + [("gptj_dh256", 2, 5, 12)])
def test_generate_token_equal_to_jax(families, name, b, p, new):
    fam = families(name)
    prompt = fam.prompt(10 * b + p, b, p)
    want = np.asarray(fam.jmod.generate(fam.jp, fam.jcfg, jnp.asarray(prompt),
                                        new))
    np.testing.assert_array_equal(fam.generate(prompt, new), want)


@pytest.mark.parametrize("name", ALL)
def test_generate_ragged_token_equal_to_jax(families, name):
    fam = families(name)
    prompt = fam.prompt(5, 3, 6)
    lens = np.asarray([6, 2, 4], np.int32)
    want = np.asarray(fam.jmod.generate_ragged(fam.jp, fam.jcfg,
                                               jnp.asarray(prompt), lens, 10))
    np.testing.assert_array_equal(fam.generate_ragged(prompt, lens, 10), want)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("name", SMALL)
def test_eos_padding_equal_to_jax(families, name, ragged):
    fam = families(name)
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
@pytest.mark.parametrize("name", SMALL)
def test_rules_token_equal_to_jax(families, name, rule):
    fam = families(name)
    prompt = fam.prompt(8, 2, 5)
    jsc, sc, jcfg, cfg = fam.rule_cfgs(rule, prompt, 16)
    got = fam.generate(prompt, 16, cfg=cfg, sampling_cfg=sc)
    np.testing.assert_array_equal(got, fam.jax_generate(prompt, 16, jsc,
                                                        jcfg))


@pytest.mark.parametrize("name", SMALL)
def test_ragged_rules_token_equal_to_jax(families, name):
    fam = families(name)
    prompt = fam.prompt(9, 2, 6)
    lens = np.asarray([6, 3], np.int32)
    jsc, sc, jcfg, cfg = fam.rule_cfgs("together", prompt, 12)
    got = fam.generate_ragged(prompt, lens, 12, cfg=cfg, sampling_cfg=sc)
    np.testing.assert_array_equal(
        got, fam.jax_generate_ragged(prompt, lens, 12, jsc, jcfg))


@pytest.mark.parametrize("name", SMALL)
def test_sampled_is_deterministic_diverse_and_top_k_1_greedy(families, name):
    fam = families(name)
    zoo_parity.check_sampling(fam, fam.prompt(11, 2, 4))


@pytest.mark.parametrize("k,alpha", [(3, 1.0), (2, 0.6)])
@pytest.mark.parametrize("name", ALL)
def test_generate_beam_matches_jax(families, name, k, alpha):
    fam = families(name)
    prompt = fam.prompt(12, 2, 5)
    want = fam.jmod.generate_beam(fam.jp, fam.jcfg, jnp.asarray(prompt), 10,
                                  k, alpha)
    got = fam.tmod.generate_beam(fam.tp, fam.cfg, prompt, 10, k, alpha,
                                 device="cpu")
    zoo_parity.assert_beams_match(got, want, BEAM_SCORE_TOL)
