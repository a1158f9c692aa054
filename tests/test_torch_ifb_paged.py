"""PyTorch port: GPT's paged pair (``models/gpt/model.py::_prefill_paged``,
``_step_paged``) and the paged in-flight batcher
(``runtime/ifb_paged.py::PagedCausalLMInflightBatcher``) against the JAX
package's on the same weights (``GPTConfig.testing``), on the CPU.

The pair's logits and pools within 1e-5 of JAX's (fp32 sums in another
order); the batcher token-equal to JAX's and to the port's dense batcher;
admission backpressure, a pool smaller than the dense equivalent, every
block back after ``run`` and pool exhaustion raising JAX's error (the
cases of ``tests/test_ifb_paged.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import capped_threads  # noqa: F401
import whisper_trtllm_tpu.models.gpt.model as jgpt
import whisper_trtllm_tpu_torch.models.gpt.model as tgpt
from whisper_trtllm_tpu.runtime.ifb_paged import (
    PagedCausalLMInflightBatcher as JaxPagedBatcher,
)
from whisper_trtllm_tpu_torch.runtime.ifb_lm import CausalLMInflightBatcher
from whisper_trtllm_tpu_torch.runtime.ifb_paged import (
    PagedCausalLMInflightBatcher,
)

TOL = 1e-5


def _cfgs(**overrides):
    cfg = jgpt.GPTConfig.testing(**overrides)
    return cfg, tgpt.GPTConfig(**cfg.__dict__)


def _paged(cls, mod, cfg, params, **kw):
    extra = {} if mod is jgpt else {"device": "cpu"}
    return cls(
        params, cfg,
        prefill=lambda p, t, l, pk, pv, tb: mod._prefill_paged(
            p, cfg, t, l, pk, pv, tb),
        step=lambda p, tok, pos, pk, pv, tb: mod._step_paged(
            p, cfg, tok, pos, pk, pv, tb),
        cache_heads=cfg.n_head, head_dim=cfg.head_dim, n_layer=cfg.n_layer,
        eos_token_id=cfg.eos_token_id, **kw, **extra)


def _pair(seed, num_blocks, num_lanes, max_new, tokens_per_block=4,
          segment_steps=4, max_prompt_len=6):
    """(JAX paged batcher, port paged batcher, port params, port cfg)."""
    jcfg, tcfg = _cfgs()
    kw = dict(num_blocks=num_blocks, tokens_per_block=tokens_per_block,
              num_lanes=num_lanes, max_prompt_len=max_prompt_len,
              max_new_tokens=max_new, segment_steps=segment_steps)
    tp = tgpt.init_params(tcfg, seed=seed, device="cpu")
    return (_paged(JaxPagedBatcher, jgpt, jcfg,
                   jgpt.init_params(jcfg, seed=seed), **kw),
            _paged(PagedCausalLMInflightBatcher, tgpt, tcfg, tp, **kw),
            tp, tcfg)


def _drain(b, prompts):
    rids = [b.submit(p) for p in prompts]
    b.run()
    return [b.fetch(r) for r in rids]


def test_paged_pair_matches_jax_logits_and_pools():
    """A ragged prefill of 2 rows through their tables, then two steps at
    per-lane positions (a -1 table row writes nothing): logits and pools
    within 1e-5 of JAX's."""
    jcfg, tcfg = _cfgs()
    jp = jgpt.init_params(jcfg, seed=4)
    tp = tgpt.init_params(tcfg, seed=4, device="cpu")
    rng = np.random.default_rng(4)
    tpb, n_blocks = 4, 12
    shape = (jcfg.n_layer, n_blocks, tpb, jcfg.n_head, jcfg.head_dim)
    tokens = rng.integers(3, jcfg.vocab_size, (2, 7)).astype(np.int32)
    lens = np.asarray([7, 3], np.int32)
    tables = np.asarray([[5, 2, 9, -1], [0, 7, -1, -1]], np.int32)
    jl, jk, jv = jgpt._prefill_paged(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(lens),
        jnp.zeros(shape), jnp.zeros(shape), jnp.asarray(tables))
    pk, pv = torch.zeros(shape), torch.zeros(shape)
    tl, _, _ = tgpt._prefill_paged(tp, tcfg, torch.from_numpy(tokens),
                                   torch.from_numpy(lens), pk, pv,
                                   torch.from_numpy(tables))
    for got, want in ((tl, jl), (pk, jk), (pv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
    pos = lens.copy()
    for step_tables in (tables, np.asarray([[5, 2, 9, -1], [-1] * 4],
                                           np.int32)):
        tok = rng.integers(3, jcfg.vocab_size, (2,)).astype(np.int32)
        jl, jk, jv = jgpt._step_paged(jp, jcfg, jnp.asarray(tok),
                                      jnp.asarray(pos), jk, jv,
                                      jnp.asarray(step_tables))
        tl, _, _ = tgpt._step_paged(tp, tcfg, torch.from_numpy(tok),
                                    torch.from_numpy(pos), pk, pv,
                                    torch.from_numpy(step_tables))
        for got, want in ((tl, jl), (pk, jk), (pv, jv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=TOL, rtol=TOL)
        pos = pos + 1


def test_paged_batcher_token_equal_to_jax_and_to_the_dense_one():
    rng = np.random.default_rng(0)
    max_new = 8
    jb, tb, tp, tcfg = _pair(0, num_blocks=16, num_lanes=2, max_new=max_new)
    prompts = [rng.integers(3, tcfg.vocab_size, (n,)).astype(np.int32)
               for n in (2, 5, 3, 4, 2)]
    got = _drain(tb, prompts)
    dense = CausalLMInflightBatcher(
        tp, tcfg,
        prefill=lambda p, t, l, ck, cv: tgpt._prefill_ragged(
            p, tcfg, t, l, ck, cv),
        step=lambda p, tok, pos, ck, cv: tgpt._step(p, tcfg, tok, pos, ck,
                                                    cv),
        cache_heads=tcfg.n_head, head_dim=tcfg.head_dim,
        n_layer=tcfg.n_layer, eos_token_id=tcfg.eos_token_id, num_lanes=2,
        max_prompt_len=6, max_new_tokens=max_new, segment_steps=4,
        device="cpu")
    for g, w, d in zip(got, _drain(jb, prompts), _drain(dense, prompts)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, d)
    assert tb.free_blocks() == 16


def _single(tp, tcfg, prompt, max_new):
    return tgpt.generate(tp, tcfg, prompt[None], max_new,
                         device="cpu").numpy()[0]


def test_admission_waits_on_free_blocks():
    """A 4-block pool holds two requests of 4 + 3 tokens (2 blocks each at
    tpb 4): the third lane and the queue wait on retirements, and every
    request still gives its single-request tokens and JAX's."""
    rng = np.random.default_rng(1)
    max_new = 3
    jb, tb, tp, tcfg = _pair(1, num_blocks=4, num_lanes=3, max_new=max_new)
    prompts = [rng.integers(3, tcfg.vocab_size, (4,)).astype(np.int32)
               for _ in range(4)]
    probe = _paged(PagedCausalLMInflightBatcher, tgpt, tcfg, tp,
                   num_blocks=4, tokens_per_block=4, num_lanes=3,
                   max_prompt_len=6, max_new_tokens=max_new, segment_steps=4)
    for prompt in prompts:
        probe.submit(prompt)
    probe._retire_and_admit()
    assert sum(r is not None for r in probe._lane_req) == 2
    assert len(probe._queue) == 2 and probe.free_blocks() == 0
    got = _drain(tb, prompts)
    for g, w, prompt in zip(got, _drain(jb, prompts), prompts):
        np.testing.assert_array_equal(g, w)
        single = _single(tp, tcfg, prompt, max_new)
        k = min(g.size, single.size) - prompt.size
        np.testing.assert_array_equal(g[prompt.size:prompt.size + k],
                                      single[prompt.size:prompt.size + k])
    assert tb.free_blocks() == 4


def test_a_pool_smaller_than_the_dense_equivalent_serves_every_request():
    """3 lanes of max_len 12 would hold 9 blocks dense; short requests
    complete with 6, blocks recycling at retirement."""
    rng = np.random.default_rng(2)
    jb, tb, _, tcfg = _pair(2, num_blocks=6, num_lanes=3, max_new=6)
    prompts = [rng.integers(3, tcfg.vocab_size, (2,)).astype(np.int32)
               for _ in range(6)]
    got = _drain(tb, prompts)
    assert all(g is not None for g in got)
    for g, w in zip(got, _drain(jb, prompts)):
        np.testing.assert_array_equal(g, w)
    assert tb.free_blocks() == 6


def test_pool_exhaustion_raises_the_jax_error():
    """Prompt 6 + first token admit into 2 blocks, but max_len 14 needs 4:
    the reservation leaves no lane a step, and run() raises JAX's error."""
    errors = []
    for b in _pair(3, num_blocks=2, num_lanes=1, max_new=8,
                   segment_steps=16)[:2]:
        b.submit(np.asarray([3, 4, 5, 6, 7, 8], np.int32))
        with pytest.raises(RuntimeError, match="exhausted") as info:
            b.run()
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_max_new_tokens_below_one_is_refused():
    jcfg, tcfg = _cfgs()
    for cls, mod, cfg, params in (
            (JaxPagedBatcher, jgpt, jcfg, jgpt.init_params(jcfg)),
            (PagedCausalLMInflightBatcher, tgpt, tcfg,
             tgpt.init_params(tcfg, device="cpu"))):
        with pytest.raises(ValueError, match="max_new_tokens must be >= 1"):
            _paged(cls, mod, cfg, params, num_blocks=4, max_new_tokens=0)
