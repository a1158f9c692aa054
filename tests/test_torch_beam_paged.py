"""PyTorch port: beam search over the paged KV pool
(``runtime/beam_paged.py::paged_beam_search``) against the JAX package's on
the same GPT weights (``GPTConfig.testing``), and against the port's dense
beam search (``models/gpt/model.py::generate_beam``), on the CPU.

Tokens and lengths exact, scores within 1e-5 (the same fp32 expansion on
the host over logits within 1e-5 of JAX's), at several length penalties
and beam widths; every block back on the free stack after a search; a
prompt that is not block-aligned refused with the JAX message."""

import numpy as np
import pytest

from torch_threads import capped_threads  # noqa: F401
import whisper_trtllm_tpu.models.gpt.model as jgpt
import whisper_trtllm_tpu.runtime.beam_paged as jbp
import whisper_trtllm_tpu_torch.models.gpt.model as tgpt
import whisper_trtllm_tpu_torch.runtime.beam_paged as tbp

SCORE_TOL = 1e-5


def _search(bp, mod, cfg, params, prompt, *, num_blocks, max_blocks_per_seq,
            max_new, k, length_penalty=1.0, tpb=4):
    extra = {} if mod is jgpt else {"device": "cpu"}
    return bp.paged_beam_search(
        lambda p, t, l, pk, pv, tb: mod._prefill_paged(
            p, cfg, t, l, pk, pv, tb),
        lambda p, tok, pos, pk, pv, tb: mod._step_paged(
            p, cfg, tok, pos, pk, pv, tb),
        params, prompt,
        pool_shape=(cfg.n_layer, num_blocks, tpb, cfg.n_head, cfg.head_dim),
        tokens_per_block=tpb, max_blocks_per_seq=max_blocks_per_seq,
        max_new_tokens=max_new, eos_token_id=cfg.eos_token_id, num_beams=k,
        length_penalty=length_penalty, **extra)


def _both(seed, prompt, **kw):
    cfg = jgpt.GPTConfig.testing()
    tcfg = tgpt.GPTConfig(**cfg.__dict__)
    tp = tgpt.init_params(tcfg, seed=seed, device="cpu")
    want = _search(jbp, jgpt, cfg, jgpt.init_params(cfg, seed=seed), prompt,
                   **kw)
    got = _search(tbp, tgpt, tcfg, tp, prompt, **kw)
    return got, want, tp, tcfg


def _assert_same(got, want):
    tokens, scores, lens = got
    np.testing.assert_array_equal(tokens, want[0])
    np.testing.assert_array_equal(lens, want[2])
    np.testing.assert_allclose(scores, want[1], rtol=SCORE_TOL,
                               atol=SCORE_TOL)


@pytest.mark.parametrize("length_penalty", [1.0, 2.0, 0.5])
def test_paged_beams_equal_jax_and_the_dense_search(length_penalty):
    """K 2 at tpb 4, 11 new tokens: the decode crosses block boundaries
    while the beams reorder every step."""
    prompt = np.random.default_rng(0).integers(3, 89, (8,)).astype(np.int32)
    max_new, k = 11, 2
    got, want, tp, tcfg = _both(0, prompt, num_blocks=24,
                                max_blocks_per_seq=8, max_new=max_new, k=k,
                                length_penalty=length_penalty)
    _assert_same(got, want)
    dense = tgpt.generate_beam(tp, tcfg, prompt[None], max_new, k,
                               length_penalty, device="cpu")
    _assert_same(got, tuple(x.numpy()[0] for x in dense))


def test_wider_beams_in_a_tight_pool():
    """K 4 with the 3 context blocks shared: the pool holds them once."""
    prompt = np.random.default_rng(1).integers(3, 89, (12,)).astype(np.int32)
    got, want, tp, tcfg = _both(1, prompt, num_blocks=3 + 4 * 4,
                                max_blocks_per_seq=8, max_new=9, k=4)
    _assert_same(got, want)
    dense = tgpt.generate_beam(tp, tcfg, prompt[None], 9, 4, device="cpu")
    _assert_same(got, tuple(x.numpy()[0] for x in dense))


def test_every_block_is_released(monkeypatch):
    mgrs = []
    init = tbp.PagedKVCache.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        mgrs.append(self)

    monkeypatch.setattr(tbp.PagedKVCache, "__init__", spy)
    prompt = np.random.default_rng(2).integers(3, 89, (4,)).astype(np.int32)
    cfg = tgpt.GPTConfig.testing()
    _search(tbp, tgpt, cfg, tgpt.init_params(cfg, seed=2, device="cpu"),
            prompt, num_blocks=16, max_blocks_per_seq=6, max_new=7, k=2)
    (mgr,) = mgrs
    assert mgr.ledger.free == mgr.ledger.num_blocks and len(mgr) == 0


def test_a_prompt_not_block_aligned_is_refused():
    prompt = np.arange(3, 9, dtype=np.int32)   # 6 tokens at tpb 4
    messages = []
    for bp, mod in ((jbp, jgpt), (tbp, tgpt)):
        cfg = mod.GPTConfig.testing()
        params = (mod.init_params(cfg) if mod is jgpt
                  else mod.init_params(cfg, device="cpu"))
        with pytest.raises(ValueError, match="block-aligned") as info:
            _search(bp, mod, cfg, params, prompt, num_blocks=16,
                    max_blocks_per_seq=6, max_new=4, k=2)
        messages.append(str(info.value))
    assert messages[0] == messages[1]
