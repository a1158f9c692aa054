"""Beam search over the PAGED KV pool, host-stepped (counterpart of
``whisper_trtllm_tpu/runtime/beam_paged.py``).

``runtime/kv_cache_manager.py::PagedKVCache`` keeps the block tables with
beam semantics; this is the decode loop that drives it at a beam width K:

  * the context phase writes the prompt's K/V once, into blocks shared by
    every beam (refcount K);
  * each step writes through per-beam private tail blocks;
  * after each expansion the tables are re-parented
    (``PagedKVCache.reorder_beams``) and the possibly shared tail is
    copy-forked (``fork_tail``), so diverging beams never write into one
    another's partial block. The forks' pool copies are one gather, then
    one scatter, over the block axis of each pool.

The expansion runs on the host in numpy and follows ``runtime/beam_lm.py``
operation for operation (the same alive and finished pools, EOS
retirement and length penalty; ties to the lower index, as
``jax.lax.top_k``: a stable descending sort), so a paged beam decode gives
the dense ``beam_generate_tokens``'s tokens, scores and lengths. The
block manager changes between steps, so the step runs eagerly (no captured
graph), its table made anew each step: on the card every step launches
K5 and, through the gathered window, K2.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from whisper_trtllm_tpu_torch.runtime.kv_cache_manager import PagedKVCache
from whisper_trtllm_tpu_torch.utils.device import resolve_device

NEG_INF = np.float32(-1.0e9)


def _log_softmax_f32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    m = x.max(axis=-1, keepdims=True)
    s = x - m
    return (s - np.log(np.exp(s).sum(axis=-1, keepdims=True,
                                     dtype=np.float32))).astype(np.float32)


def _top(x: np.ndarray, n: int) -> np.ndarray:
    """Indices of the n largest entries, ties broken by lowest index —
    lax.top_k's order, reproduced with a descending stable sort."""
    return np.argsort(-x, kind="stable")[:n]


@torch.inference_mode()
def paged_beam_search(
    prefill_paged: Callable,
    step_paged: Callable,
    params: dict,
    prompt: np.ndarray,
    *,
    pool_shape: Tuple[int, int, int, int, int],
    tokens_per_block: int,
    max_blocks_per_seq: int,
    max_new_tokens: int,
    eos_token_id: int,
    num_beams: int,
    length_penalty: float = 1.0,
    cache_dtype=torch.float32,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Single-request beam search against paged K/V pools on ``device``
    (the CUDA card by default, where ``params`` must lie).

    ``prefill_paged(params, tokens (1, P), lens (1,), pool_k, pool_v,
    tables (1, M))`` and ``step_paged(params, tok (K,), pos (K,), pool_k,
    pool_v, tables (K, M))`` follow the causal-LM paged contract
    (``models/gpt/model.py::_prefill_paged``/``_step_paged``).
    ``pool_shape`` = (L, num_blocks, tokens_per_block, H, dh). The prompt
    must be block-aligned (``PagedKVCache``'s beam admission raises
    otherwise: a partial shared tail would be written divergently).
    Returns numpy (tokens (K, P + max_new), scores (K,), lengths (K,)),
    best first, as the dense ``beam_lm.beam_generate_tokens`` gives them."""
    dev = resolve_device(device)
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    p = prompt.size
    k = num_beams
    max_len = p + max_new_tokens
    lp = np.float32(length_penalty)

    mgr = PagedKVCache(pool_shape[1], tokens_per_block, max_blocks_per_seq,
                       beam_width=k)
    row = mgr.admit(p)
    assert row == 0

    pool_k = torch.zeros(pool_shape, dtype=cache_dtype, device=dev)
    pool_v = torch.zeros(pool_shape, dtype=cache_dtype, device=dev)

    def on_device(x, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    # ---- context phase at beam 1: context blocks are beam-shared, one
    # write serves every beam ----
    tables = mgr.block_tables()[0]                       # (K, M)
    logits0, _, _ = prefill_paged(
        params, on_device(prompt[None]), on_device([p]), pool_k, pool_v,
        on_device(tables[0:1]))

    # ---- host-side beam pools (numpy twins of beam_lm's carry) ----
    alive_tokens = np.full((k, max_len), eos_token_id, np.int32)
    alive_tokens[:, :p] = prompt[None]
    alive_scores = np.where(np.arange(k) == 0, np.float32(0.0), NEG_INF)
    fin_tokens = np.full((k, max_len), eos_token_id, np.int32)
    fin_scores = np.full((k,), NEG_INF)
    fin_lens = np.zeros((k,), np.int32)

    def done() -> bool:
        return bool(np.all(fin_scores > NEG_INF / 2))

    def expand(logits: np.ndarray, nxt: int) -> np.ndarray:
        """One beam expansion (numpy twin of beam_lm's, b=1). Mutates the
        pools above; returns alive_parents (K,)."""
        nonlocal alive_tokens, alive_scores, fin_tokens, fin_scores, fin_lens
        vocab = logits.shape[-1]
        logp = _log_softmax_f32(logits)                          # (K, V)
        cand = (alive_scores[:, None] + logp).reshape(-1)
        topi = _top(cand, 2 * k)
        topv = cand[topi]
        parents = (topi // vocab).astype(np.int64)
        toks = (topi % vocab).astype(np.int32)

        seqs = alive_tokens[parents].copy()
        seqs[:, nxt] = toks
        in_top_k = np.arange(2 * k) < k
        is_eos_tok = toks == eos_token_id
        is_eos = is_eos_tok & in_top_k & (topv > NEG_INF / 2)

        alive_cand = np.where(is_eos_tok, NEG_INF, topv)
        alive_sel = _top(alive_cand, k)
        new_alive_scores = alive_cand[alive_sel].astype(np.float32)
        new_alive_tokens = seqs[alive_sel]
        alive_parents = parents[alive_sel]

        pen = np.float32(nxt + 1 - p) ** lp
        fin_cand = np.where(is_eos, (topv / pen).astype(np.float32), NEG_INF)
        if done():
            fin_cand[:] = NEG_INF
        merged_scores = np.concatenate([fin_scores, fin_cand])
        merged_tokens = np.concatenate([fin_tokens, seqs])
        merged_lens = np.concatenate(
            [fin_lens, np.full((2 * k,), nxt + 1, np.int32)])
        fin_sel = _top(merged_scores, k)
        fin_scores = merged_scores[fin_sel].astype(np.float32)
        fin_tokens = merged_tokens[fin_sel]
        fin_lens = merged_lens[fin_sel]

        alive_tokens, alive_scores = new_alive_tokens, new_alive_scores
        return alive_parents

    def reorder_and_fork(parents: np.ndarray) -> None:
        """Move block links to the surviving parents, then give every beam
        a private copy of the (possibly shared) partial tail block."""
        mgr.reorder_beams(0, parents)
        pairs = mgr.fork_tail(0)
        src = on_device(pairs[:, 0], torch.int64)
        dst = on_device(pairs[:, 1], torch.int64)
        # gather, then scatter: a dst block comes fresh off the free stack
        # (or is its own src), so no pair reads a block another writes
        for pool in (pool_k, pool_v):
            pool.index_copy_(1, dst, pool.index_select(1, src))

    # first expansion from the context-phase logits (beam 0 only is live)
    parents = expand(logits0.cpu().numpy().repeat(k, axis=0), p)
    reorder_and_fork(parents)

    pos = p
    while pos < max_len - 1 and not done():
        tables = on_device(mgr.block_tables()[0])         # (K, M)
        logits, _, _ = step_paged(
            params, on_device(alive_tokens[:, pos]),
            torch.full((k,), pos, dtype=torch.int32, device=dev), pool_k,
            pool_v, tables)
        parents = expand(logits.cpu().numpy(), pos + 1)
        reorder_and_fork(parents)
        mgr.advance(np.asarray([done()]))
        pos += 1
    if len(mgr):
        mgr.advance(np.asarray([True]))   # release every block

    # ---- finalize (beam_lm's max-length fallback) ----
    alive_len = pos + 1
    alive_final = alive_scores / np.float32(alive_len - p) ** lp
    if done():
        alive_final = np.full_like(alive_final, NEG_INF)
    merged_scores = np.concatenate([fin_scores, alive_final])
    merged_tokens = np.concatenate([fin_tokens, alive_tokens])
    merged_lens = np.concatenate(
        [fin_lens, np.full((k,), alive_len, np.int32)])
    sel = _top(merged_scores, k)
    return (merged_tokens[sel], merged_scores[sel].astype(np.float32),
            merged_lens[sel])
