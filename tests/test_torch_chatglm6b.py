"""PyTorch port: the ChatGLM-6B zoo model (``models/chatglm6b``) against
the JAX package's on the same weights, on the CPU. A tiny random
state dict in the original key names (vocabulary 89, 2 layers, 32
positions; ``glm``: width 32 over 4 heads, ``glm_dh8``: width 16 over 2),
converted by the JAX package and carried over by ``params_from_numpy``.

The rope tables, ``apply_2d_rope`` and ``build_position_ids`` equal to
JAX's; ``forward`` within 1e-5 of JAX's (and of the JAX test's float64
torch twin at its 2e-4); ``init_params`` and the converter bit-equal;
the prefix-LM prefill sees later prompt tokens; ``generate`` and
``generate_ragged`` token-equal to JAX, EOS padding included, and the
cached generate equal to a greedy loop over ``forward``; every penalty
and word rule with greedy token-equal; sampled generation one draw a
seed; ``generate_beam`` tokens and lengths equal, scores within 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zoo_parity
from zoo_parity import BEAM_SCORE_TOL, FORWARD_TOL, RULES

from torch_threads import capped_threads  # noqa: F401
import whisper_trtllm_tpu.models.chatglm6b.model as jglm
from whisper_trtllm_tpu.runtime import causal_lm as jax_causal_lm
import whisper_trtllm_tpu_torch.models.chatglm6b.model as tglm
from whisper_trtllm_tpu_torch.runtime import causal_lm
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy

NAMES = ["glm", "glm_dh8"]


def _state_dict(cfg, seed: int = 0) -> dict:
    """Random weights in the original key names (the JAX test's)."""
    rng = np.random.default_rng(seed)
    d, f, v = cfg.d_model, cfg.ffn_dim, cfg.vocab_size
    sd = {"transformer.word_embeddings.weight":
          rng.normal(0, 0.02, (v, d)).astype(np.float32),
          "transformer.final_layernorm.weight":
          rng.normal(1, 0.02, (d,)).astype(np.float32),
          "transformer.final_layernorm.bias":
          rng.normal(0, 0.02, (d,)).astype(np.float32),
          "lm_head.weight": rng.normal(0, 0.02, (v, d)).astype(np.float32)}
    for i in range(cfg.n_layer):
        p = f"transformer.layers.{i}"
        for name, shape in [
            (".input_layernorm.weight", (d,)), (".input_layernorm.bias", (d,)),
            (".attention.query_key_value.weight", (3 * d, d)),
            (".attention.query_key_value.bias", (3 * d,)),
            (".attention.dense.weight", (d, d)),
            (".attention.dense.bias", (d,)),
            (".post_attention_layernorm.weight", (d,)),
            (".post_attention_layernorm.bias", (d,)),
            (".mlp.dense_h_to_4h.weight", (f, d)),
            (".mlp.dense_h_to_4h.bias", (f,)),
            (".mlp.dense_4h_to_h.weight", (d, f)),
            (".mlp.dense_4h_to_h.bias", (d,)),
        ]:
            sd[p + name] = rng.normal(0, 0.05, shape).astype(np.float32)
    return sd


class GLM:
    """One configuration's weights in both packages, and both sides'
    generate calls."""

    def __init__(self, name: str):
        self.jcfg = (jglm.ChatGLM6BConfig.testing(n_head=2, d_model=16)
                     if name == "glm_dh8" else jglm.ChatGLM6BConfig.testing())
        self.cfg = self.port_cfg(self.jcfg)
        self.sd = _state_dict(self.jcfg)
        self.jp = jglm.convert_hf_chatglm6b(self.sd, self.jcfg)
        self.tp = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, self.jp), "cpu")

    @staticmethod
    def port_cfg(jcfg):
        return tglm.ChatGLM6BConfig(**dataclasses.asdict(jcfg))

    def prompt(self, seed: int, b: int, p: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.integers(3, self.jcfg.vocab_size, (b, p)).astype(np.int32)

    def generate(self, prompt, new: int, cfg=None, **kw):
        return tglm.generate(self.tp, cfg or self.cfg, prompt, new,
                             device="cpu", **kw).numpy()

    def generate_ragged(self, prompt, lens, new: int, cfg=None, **kw):
        return tglm.generate_ragged(self.tp, cfg or self.cfg, prompt, lens,
                                    new, device="cpu", **kw).numpy()

    def jax_generate(self, prompt, new: int, sc=None, jcfg=None):
        """JAX's causal-LM loop over GLM's own prefill and step, with any
        sampling configuration."""
        jcfg = jcfg or self.jcfg
        b, p = prompt.shape
        max_len = min(jcfg.max_positions, p + new)
        ids = jnp.broadcast_to(jnp.asarray(
            jglm.build_position_ids(p, p - 2, p))[None], (b, 2, p))
        fn = jax.jit(lambda params, t: jax_causal_lm.generate_tokens(
            lambda pr, tk, ck, cv: jglm._prefill(pr, jcfg, tk, ids, p, ck,
                                                 cv),
            lambda pr, tok, pos, ck, cv: jglm._step(pr, jcfg, tok, pos,
                                                    p - 2, p, ck, cv),
            params, t, cache_shape=(jcfg.n_layer, b, jcfg.n_head, max_len,
                                    jcfg.head_dim),
            prompt_len=p, max_len=max_len, eos_token_id=jcfg.eos_token_id,
            sampling_cfg=sc))
        return np.asarray(fn(self.jp, jnp.asarray(prompt)))

    def jax_generate_ragged(self, prompt, lens, new: int, sc=None,
                            jcfg=None):
        jcfg = jcfg or self.jcfg
        b, p = prompt.shape
        fn = jax.jit(lambda params, t, ln: jax_causal_lm.generate_tokens_ragged(
            lambda pr, tk, l2, ck, cv: jglm._prefill_ragged(pr, jcfg, tk, l2,
                                                            ck, cv),
            lambda pr, tok, pos, ck, cv: jglm._step(pr, jcfg, tok, pos,
                                                    ln - 2, ln, ck, cv),
            params, t, ln, cache_shape=(jcfg.n_layer, b, jcfg.n_head,
                                        p + new, jcfg.head_dim),
            max_new_tokens=new, eos_token_id=jcfg.eos_token_id,
            sampling_cfg=sc))
        return np.asarray(fn(self.jp, jnp.asarray(prompt),
                             jnp.asarray(lens, jnp.int32)))

    def rule_cfgs(self, rule: str, prompt, new: int):
        """(JAX sampling cfg, port sampling cfg, JAX config, port config)
        for one of ``RULES``, the words and an EOS from the greedy
        trajectory of lane 0 (``zoo_parity.Family.rule_cfgs``)."""
        kw = dict(RULES[rule])
        out = self.generate(prompt, new)
        p = prompt.shape[1]
        if kw.get("bad_words") == "trajectory":
            kw["bad_words"] = [[int(out[0, p])]]
        if kw.get("stop_words") == "trajectory":
            kw["stop_words"] = [[int(out[0, p + 2]), int(out[0, p + 3])]]
        jcfg = self.jcfg
        if "min_new_tokens" in kw:
            jcfg = dataclasses.replace(jcfg, eos_token_id=int(out[0, p + 1]))
        return (jax_causal_lm.make_sampling_cfg(**kw),
                causal_lm.make_sampling_cfg(**kw), jcfg, self.port_cfg(jcfg))


@pytest.fixture(scope="module")
def glms():
    made = {}

    def get(name):
        if name not in made:
            made[name] = GLM(name)
        return made[name]

    return get


def test_rope_tables_and_position_ids_equal_jax():
    pos = np.asarray([[0, 3, 17, 30], [5, 5, 5, 1]], np.int32)
    for half in (4, 8):
        got = tglm.glm_rope_tables(half, torch.from_numpy(pos))
        want = jglm.glm_rope_tables(half, jnp.asarray(pos))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    x = np.random.default_rng(1).standard_normal((2, 3, 4, 16)).astype(
        np.float32)
    tables = [t.numpy() for t in tglm.glm_rope_tables(8, torch.from_numpy(
        pos))] * 2
    got = tglm.apply_2d_rope(torch.from_numpy(x),
                             *[torch.from_numpy(t) for t in tables])
    want = jglm.apply_2d_rope(jnp.asarray(x), *[jnp.asarray(t)
                                                 for t in tables])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    for s, m, c in [(8, 3, 5), (12, 6, 7), (5, 3, 5)]:
        np.testing.assert_array_equal(tglm.build_position_ids(s, m, c),
                                      jglm.build_position_ids(s, m, c))


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax_and_the_float64_twin(glms, name):
    from test_chatglm6b import _torch_glm_forward

    g = glms(name)
    b, s, ctx = 2, 10, 6
    tokens = g.prompt(0, b, s)
    pos = np.stack([jglm.build_position_ids(s, ctx - 1, ctx)] * b)
    got = tglm.forward(g.tp, g.cfg, tokens, pos, ctx).numpy()
    want = np.asarray(jglm.forward(g.jp, g.jcfg, tokens, pos, ctx_len=ctx))
    assert np.abs(got - want).max() <= FORWARD_TOL
    np.testing.assert_allclose(got, _torch_glm_forward(g.sd, g.jcfg, tokens,
                                                       pos, ctx),
                               atol=2e-4, rtol=2e-4)


def test_prefix_prefill_sees_later_prompt_tokens(glms):
    """A later prompt token changes an earlier prompt position's logits
    (the prompt is bidirectional); a token past the prompt changes no
    earlier position."""
    g = glms("glm")
    s, ctx = 10, 6
    tokens = g.prompt(1, 1, s)
    pos = jglm.build_position_ids(s, ctx - 1, ctx)[None]
    base = tglm.forward(g.tp, g.cfg, tokens, pos, ctx).numpy()
    t2 = tokens.copy()
    t2[0, ctx - 1] = (t2[0, ctx - 1] + 1) % g.cfg.vocab_size
    assert np.abs(tglm.forward(g.tp, g.cfg, t2, pos, ctx).numpy()[0, 0]
                  - base[0, 0]).max() > 1e-6
    t3 = tokens.copy()
    t3[0, s - 1] = (t3[0, s - 1] + 1) % g.cfg.vocab_size
    np.testing.assert_allclose(
        tglm.forward(g.tp, g.cfg, t3, pos, ctx).numpy()[0, :s - 1],
        base[0, :s - 1], atol=1e-6)


def test_init_params_and_conversion_equal_jax(glms):
    cfg = jglm.ChatGLM6BConfig.testing()
    got = tglm.init_params(GLM.port_cfg(cfg), seed=3, device="cpu")
    zoo_parity.assert_trees_equal(got, jglm.init_params(cfg, seed=3))
    g = glms("glm")
    zoo_parity.assert_trees_equal(
        tglm.convert_hf_chatglm6b(g.sd, g.cfg, device="cpu"), g.jp)


@pytest.mark.parametrize("name,b,p,new,mask_pos", [
    ("glm", 2, 6, 12, None), ("glm", 3, 7, 20, 3), ("glm_dh8", 2, 5, 12,
                                                    None)])
def test_generate_token_equal_to_jax(glms, name, b, p, new, mask_pos):
    g = glms(name)
    prompt = g.prompt(10 * b + p, b, p)
    want = np.asarray(jglm.generate(g.jp, g.jcfg, jnp.asarray(prompt), new,
                                    mask_pos=mask_pos))
    np.testing.assert_array_equal(g.generate(prompt, new, mask_pos=mask_pos),
                                  want)


def test_cached_generate_equals_a_greedy_loop_over_forward(glms):
    g = glms("glm")
    prompt = g.prompt(2, 1, 6)
    p, new = 6, 5
    out = g.generate(prompt, new)
    seq = prompt
    for _ in range(new):
        s = seq.shape[1]
        pos = tglm.build_position_ids(s, p - 2, p)[None]
        logits = tglm.forward(g.tp, g.cfg, seq, pos, p).numpy()
        seq = np.concatenate([seq, logits[:, -1].argmax(-1)[:, None]
                              .astype(np.int32)], axis=1)
    np.testing.assert_array_equal(out, seq)


@pytest.mark.parametrize("name", NAMES)
def test_generate_ragged_token_equal_to_jax(glms, name):
    g = glms(name)
    prompt = g.prompt(5, 3, 6)
    lens = np.asarray([6, 3, 4], np.int32)
    want = np.asarray(jglm.generate_ragged(g.jp, g.jcfg, jnp.asarray(prompt),
                                           lens, 10))
    np.testing.assert_array_equal(g.generate_ragged(prompt, lens, 10), want)


@pytest.mark.parametrize("ragged", [False, True])
def test_eos_padding_equal_to_jax(glms, ragged):
    g = glms("glm")
    prompt = g.prompt(7, 3, 5)
    eos = int(g.generate(prompt, 16)[0, 5 + 3])
    jcfg = dataclasses.replace(g.jcfg, eos_token_id=eos)
    cfg = g.port_cfg(jcfg)
    if ragged:
        lens = np.asarray([5, 3, 4], np.int32)
        got = g.generate_ragged(prompt, lens, 16, cfg=cfg)
        want = g.jax_generate_ragged(prompt, lens, 16, jcfg=jcfg)
    else:
        got = g.generate(prompt, 16, cfg=cfg)
        want = g.jax_generate(prompt, 16, jcfg=jcfg)
    np.testing.assert_array_equal(got, want)
    assert (got == eos).any()


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rules_token_equal_to_jax(glms, rule):
    g = glms("glm")
    prompt = g.prompt(8, 2, 5)
    jsc, sc, jcfg, cfg = g.rule_cfgs(rule, prompt, 16)
    got = g.generate(prompt, 16, cfg=cfg, sampling_cfg=sc)
    np.testing.assert_array_equal(got, g.jax_generate(prompt, 16, jsc, jcfg))


def test_ragged_rules_token_equal_to_jax(glms):
    g = glms("glm")
    prompt = g.prompt(9, 2, 6)
    lens = np.asarray([6, 4], np.int32)
    jsc, sc, jcfg, cfg = g.rule_cfgs("together", prompt, 12)
    got = g.generate_ragged(prompt, lens, 12, cfg=cfg, sampling_cfg=sc)
    np.testing.assert_array_equal(
        got, g.jax_generate_ragged(prompt, lens, 12, jsc, jcfg))


def test_sampled_is_deterministic_diverse_and_top_k_1_greedy(glms):
    g = glms("glm")
    prompt = g.prompt(11, 2, 4)
    kw = dict(temperature=1.3, top_k=8)
    a = g.generate(prompt, 10, seed=7, **kw)
    np.testing.assert_array_equal(a, g.generate(prompt, 10, seed=7, **kw))
    assert not np.array_equal(a, g.generate(prompt, 10, seed=8, **kw))
    np.testing.assert_array_equal(
        g.generate(prompt, 10, seed=7, temperature=1.3, top_k=1),
        g.generate(prompt, 10))
    lens = np.asarray([4, 3], np.int32)
    r = g.generate_ragged(prompt, lens, 10, seed=7, **kw)
    np.testing.assert_array_equal(
        r, g.generate_ragged(prompt, lens, 10, seed=7, **kw))


@pytest.mark.parametrize("k,alpha", [(3, 1.0), (2, 0.6)])
@pytest.mark.parametrize("name", NAMES)
def test_generate_beam_matches_jax(glms, name, k, alpha):
    g = glms(name)
    prompt = g.prompt(12, 2, 5)
    want = jglm.generate_beam(g.jp, g.jcfg, jnp.asarray(prompt), 10, k,
                              alpha)
    got = tglm.generate_beam(g.tp, g.cfg, prompt, 10, k, alpha, device="cpu")
    zoo_parity.assert_beams_match(got, want, BEAM_SCORE_TOL)
