"""PyTorch port: the causal LMs' in-flight batcher
(``runtime/ifb_lm.py::CausalLMInflightBatcher``) against the JAX package's
on the same GPT weights (``GPTConfig.testing``: vocabulary 89, width 32, 2
layers, 4 heads), on the CPU.

Token-equal to JAX's batcher and to single-request ``generate``, over
staggered variable-length requests through 2 lanes; lanes reused by more
requests than lanes; the per-request ``max_new_tokens`` cap; tokens that do
not depend on how the steps are cut into segments; the refusals with the
JAX messages. Tokens compare exactly (the same argmax over logits within
1e-5 of JAX's, no near tie at these seeds)."""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_threads import capped_threads  # noqa: F401
import whisper_trtllm_tpu.models.gpt.model as jgpt
import whisper_trtllm_tpu_torch.models.gpt.model as tgpt
from whisper_trtllm_tpu.runtime.ifb_lm import (
    CausalLMInflightBatcher as JaxBatcher,
)
from whisper_trtllm_tpu_torch.runtime.ifb_lm import CausalLMInflightBatcher


def _cfgs(**overrides):
    cfg = jgpt.GPTConfig.testing(**overrides)
    return cfg, tgpt.GPTConfig(**cfg.__dict__)


def _batchers(seed, num_lanes, max_new, segment_steps=4, max_prompt_len=6,
              **overrides):
    """(JAX batcher, port batcher) on ``init_params(seed)``."""
    jcfg, tcfg = _cfgs(**overrides)
    jp = jgpt.init_params(jcfg, seed=seed)
    tp = tgpt.init_params(tcfg, seed=seed, device="cpu")
    common = dict(cache_heads=jcfg.n_head, head_dim=jcfg.head_dim,
                  n_layer=jcfg.n_layer, eos_token_id=jcfg.eos_token_id,
                  num_lanes=num_lanes, max_prompt_len=max_prompt_len,
                  max_new_tokens=max_new, segment_steps=segment_steps)
    jb = JaxBatcher(
        jp, jcfg,
        prefill=lambda p, t, l, ck, cv: jgpt._prefill_ragged(
            p, jcfg, t, l, ck, cv),
        step=lambda p, tok, pos, ck, cv: jgpt._step(p, jcfg, tok, pos, ck,
                                                    cv), **common)
    tb = CausalLMInflightBatcher(
        tp, tcfg,
        prefill=lambda p, t, l, ck, cv: tgpt._prefill_ragged(
            p, tcfg, t, l, ck, cv),
        step=lambda p, tok, pos, ck, cv: tgpt._step(p, tcfg, tok, pos, ck,
                                                    cv),
        device="cpu", **common)
    return jb, tb, tp, tcfg


def _drain(b, prompts):
    rids = [b.submit(p) for p in prompts]
    b.run()
    return [b.fetch(r) for r in rids]


def test_batcher_token_equal_to_jax_and_single_request():
    rng = np.random.default_rng(0)
    max_new = 8
    jb, tb, tp, tcfg = _batchers(0, num_lanes=2, max_new=max_new)
    prompts = [rng.integers(3, tcfg.vocab_size, (n,)).astype(np.int32)
               for n in (2, 5, 3, 4, 2)]
    want = _drain(jb, prompts)
    got = _drain(tb, prompts)
    for g, w, prompt in zip(got, want, prompts):
        np.testing.assert_array_equal(g, w)
        plen = prompt.size
        np.testing.assert_array_equal(g[:plen], prompt)
        single = tgpt.generate(tp, tcfg, prompt[None], max_new,
                               device="cpu").numpy()[0]
        k = min(g.size, single.size) - plen
        assert k > 0
        np.testing.assert_array_equal(g[plen:plen + k],
                                      single[plen:plen + k])


def test_lane_reuse_with_more_requests_than_lanes():
    """7 identical requests through 2 lanes: every lane and segment gives
    the same tokens (an admit resets the lane), JAX's."""
    rng = np.random.default_rng(1)
    jb, tb, _, tcfg = _batchers(1, num_lanes=2, max_new=6)
    prompt = rng.integers(3, tcfg.vocab_size, (3,)).astype(np.int32)
    got = _drain(tb, [prompt] * 7)
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    np.testing.assert_array_equal(got[0], _drain(jb, [prompt])[0])


@pytest.mark.parametrize("plen", [2, 5])
def test_max_new_tokens_caps_each_request(plen):
    """With EOS never generated, a request stops after ``max_new_tokens``
    tokens of its own, not at the shared buffer's end."""
    rng = np.random.default_rng(2)
    max_new = 4
    jb, tb, _, tcfg = _batchers(0, num_lanes=2, max_new=max_new,
                                eos_token_id=-1)
    prompt = rng.integers(3, tcfg.vocab_size, (plen,)).astype(np.int32)
    got = _drain(tb, [prompt])[0]
    assert got.size == plen + max_new
    np.testing.assert_array_equal(got, _drain(jb, [prompt])[0])


@pytest.mark.parametrize("segment_steps", [1, 3, 16])
def test_tokens_do_not_depend_on_the_segments(segment_steps):
    rng = np.random.default_rng(3)
    jb, _, _, tcfg = _batchers(2, num_lanes=3, max_new=7)
    _, tb, _, _ = _batchers(2, num_lanes=3, max_new=7,
                            segment_steps=segment_steps)
    prompts = [rng.integers(3, tcfg.vocab_size, (n,)).astype(np.int32)
               for n in (6, 1, 4, 3)]
    for g, w in zip(_drain(tb, prompts), _drain(jb, prompts)):
        np.testing.assert_array_equal(g, w)


def _message(fn) -> str:
    with pytest.raises(Exception) as info:
        fn()
    return f"{type(info.value).__name__}: {info.value}"


@pytest.mark.parametrize("case", ["max_new_tokens", "empty prompt",
                                  "long prompt", "max_segments"])
def test_refusals_raise_the_jax_messages(case):
    jcfg, tcfg = _cfgs()

    def build(cls, cfg, mod, **kw):
        params = (mod.init_params(cfg, seed=0) if mod is jgpt else
                  mod.init_params(cfg, seed=0, device="cpu"))
        extra = {} if mod is jgpt else {"device": "cpu"}
        return cls(params, cfg,
                   prefill=lambda p, t, l, ck, cv: mod._prefill_ragged(
                       p, cfg, t, l, ck, cv),
                   step=lambda p, tok, pos, ck, cv: mod._step(
                       p, cfg, tok, pos, ck, cv),
                   cache_heads=cfg.n_head, head_dim=cfg.head_dim,
                   n_layer=cfg.n_layer, eos_token_id=cfg.eos_token_id,
                   num_lanes=1, max_prompt_len=4, **kw, **extra)

    def attempt(cls, cfg, mod):
        if case == "max_new_tokens":
            return lambda: build(cls, cfg, mod, max_new_tokens=0)
        b = build(cls, cfg, mod, max_new_tokens=8, segment_steps=1)
        if case == "empty prompt":
            return lambda: b.submit([])
        if case == "long prompt":
            return lambda: b.submit(np.arange(3, 8))
        b.submit([3, 4])
        b.submit([5, 6])
        return lambda: b.run(max_segments=2)

    want = _message(attempt(JaxBatcher, jcfg, jgpt))
    assert _message(attempt(CausalLMInflightBatcher, tcfg, tgpt)) == want
