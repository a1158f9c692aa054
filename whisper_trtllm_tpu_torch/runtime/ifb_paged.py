"""Paged-KV continuous batching for causal LMs (counterpart of
``whisper_trtllm_tpu/runtime/ifb_paged.py``).

``runtime/ifb_lm.py``'s fixed lanes over one shared pool of KV blocks
(L, num_blocks, tpb, H, dh), addressed by a block table a lane, with the
refcounted ``BlockLedger`` (``runtime/kv_cache_manager.py``) on the host.
Lanes no longer reserve ``max_len`` rows up front: admission waits until
the free blocks hold the request's prompt and first token (the loop
``break``s on the first request they cannot hold), and a retired request
gives its blocks back at once. Before each segment every live lane's table
grows to cover ``segment_steps`` more tokens (``_reserve_segment``), and
the segment runs as many steps as every live lane is covered for
(``nsteps``); a pool that leaves no live lane a step raises.

The host bookkeeping (``_grow``, ``_free_lane``, ``_reserve_segment`` and
the admission gate) is the JAX batcher's, line for line. What differs is
how the step reads the tables: a captured CUDA graph would bake a table
made inside the capture into itself, so the tables live in one static
(num_lanes, max_blocks) int32 device buffer that the graph reads, filled
with ``copy_`` from the host's table before each segment. A retired lane's
row is -1, so its steps write nothing. On the card the step is captured
once when the batcher is built (every lane idle, every row -1) and a
segment replays it ``nsteps`` times: JAX's dynamic bound becomes a replay
count, with no recapture. An admitted request's prefill (the family's
``_prefill_paged``, its prompt padded to ``max_prompt_len``) runs eagerly
at batch 1 through its lane's table row. On the CPU the same step runs
eagerly, on the same schedule.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from whisper_trtllm_tpu_torch.runtime.ifb_lm import (
    _LaneBatcher,
    admit_lane,
    advance_lanes,
)
from whisper_trtllm_tpu_torch.runtime.kv_cache_manager import BlockLedger


class PagedLaneState(NamedTuple):
    tokens: torch.Tensor    # (B, max_len) int32
    pos: torch.Tensor       # (B,) int32: index of the last filled position
    plen: torch.Tensor      # (B,) int32: prompt length
    active: torch.Tensor    # (B,) bool
    finished: torch.Tensor  # (B,) bool
    pool_k: torch.Tensor    # (L, num_blocks, tpb, H, dh)
    pool_v: torch.Tensor


class PagedCausalLMInflightBatcher(_LaneBatcher):
    """Continuous batching over a shared paged KV pool, on ``device`` (the
    CUDA card by default).

    ``prefill``/``step`` are the model's paged phases, e.g. for GPT:
    ``models/gpt/model.py::_prefill_paged`` (params, tokens (1, P), lens
    (1,), pool_k, pool_v, table (1, M)) and ``_step_paged`` (params, tok
    (B,), pos (B,), pool_k, pool_v, tables (B, M))."""

    def __init__(
        self,
        params: dict,
        cfg,
        prefill: Callable,
        step: Callable,
        cache_heads: int,
        head_dim: int,
        n_layer: int,
        eos_token_id: int,
        num_blocks: int,
        tokens_per_block: int = 16,
        num_lanes: int = 4,
        max_prompt_len: int = 32,
        max_new_tokens: int = 64,
        segment_steps: int = 32,
        dtype=torch.float32,
        device=None,
    ):
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self._init_common(params, cfg, eos_token_id, num_lanes,
                          max_prompt_len, max_new_tokens, segment_steps,
                          device)
        self.tpb = tokens_per_block
        self.max_blocks_per_seq = math.ceil(self.max_len / tokens_per_block)
        self._prefill = prefill
        self._step_fn = step

        self.ledger = BlockLedger(num_blocks)
        # lane -> host block-table row; -1 everywhere when the lane is free,
        # so a retired lane's in-flight writes drop at the scatter
        self._tables = np.full(
            (num_lanes, self.max_blocks_per_seq), -1, np.int32)
        self._owned = np.zeros(num_lanes, np.int32)
        self._plen = np.zeros(num_lanes, np.int32)  # the host's copy

        dev = self.device
        pool_shape = (n_layer, num_blocks, tokens_per_block,
                      cache_heads, head_dim)
        with torch.inference_mode():
            # the tables the step reads: filled from ``_tables`` before
            # each segment, never rebound
            self.tables = torch.full(self._tables.shape, -1,
                                     dtype=torch.int32, device=dev)
            self.state = PagedLaneState(
                tokens=torch.full((num_lanes, self.max_len), self.eos,
                                  dtype=torch.int32, device=dev),
                pos=torch.zeros(num_lanes, dtype=torch.int32, device=dev),
                plen=torch.zeros(num_lanes, dtype=torch.int32, device=dev),
                active=self._flags[1],
                finished=self._flags[0],
                pool_k=torch.zeros(pool_shape, dtype=dtype, device=dev),
                pool_v=torch.zeros(pool_shape, dtype=dtype, device=dev))
            self._capture()

    @torch.inference_mode()
    def _step(self) -> None:
        s = self.state
        cur = s.tokens.gather(1, s.pos.long()[:, None])[:, 0]
        logits, _, _ = self._step_fn(self.params, cur, s.pos, s.pool_k,
                                     s.pool_v, self.tables)
        advance_lanes(s, logits, self.eos, self.max_len, self.max_new_tokens)

    # -- host-side block bookkeeping --------------------------------------------
    def _blocks_of(self, lane: int) -> int:
        return int(self._owned[lane])

    def _grow(self, lane: int, want_blocks: int) -> None:
        """Take blocks for ``lane`` until it owns ``want_blocks`` (or the
        pool runs dry)."""
        want_blocks = min(want_blocks, self.max_blocks_per_seq)
        have = int(self._owned[lane])
        n = min(want_blocks - have, self.ledger.free)
        if n > 0:
            self._tables[lane, have:have + n] = self.ledger.take(n)
            self._owned[lane] = have + n

    def _free_lane(self, lane: int) -> None:
        have = int(self._owned[lane])
        if have:
            self.ledger.unref(self._tables[lane, :have])
        self._tables[lane, :] = -1
        self._owned[lane] = 0

    def free_blocks(self) -> int:
        return self.ledger.free

    # -- internals ----------------------------------------------------------------
    def _segment_len(self) -> int:
        nsteps = self._reserve_segment()
        with torch.inference_mode():
            self.tables.copy_(torch.from_numpy(self._tables))
        return nsteps

    def _reserve_segment(self) -> int:
        """Grow every live lane's table to cover up to ``segment_steps`` more
        tokens; return the step count every lane is covered for."""
        # one read of the flags and positions (after this pass's admits)
        flags = self._flags.cpu().numpy()
        finished, active = flags[0], flags[1]
        pos, plen = self.state.pos.cpu().numpy(), self._plen
        nsteps = self.segment_steps
        for lane in range(self.num_lanes):
            if not (active[lane] and not finished[lane]):
                continue
            # tokens already stored: pos+1. Never reserve past what the
            # per-request cap can write (plen + max_new tokens).
            lane_cap = min(int(plen[lane]) + self.max_new_tokens,
                           self.max_len)
            target = min(int(pos[lane]) + 1 + self.segment_steps, lane_cap)
            self._grow(lane, math.ceil(target / self.tpb))
            covered = self._blocks_of(lane) * self.tpb
            lane_steps = covered - (int(pos[lane]) + 1)
            # a lane at max_len-1 only rewrites its last slot; never stalls
            if int(pos[lane]) >= self.max_len - 1:
                continue
            nsteps = min(nsteps, lane_steps)
        if nsteps < 1:
            raise RuntimeError(
                "paged KV pool exhausted mid-request: no lane can advance "
                "and nothing can retire — size num_blocks for at least "
                "num_lanes * ceil(max_len/tokens_per_block) worst case, or "
                "lower num_lanes")
        return nsteps

    def _retire_lane(self, lane: int) -> None:
        self._free_lane(lane)
        self.state.active[lane].fill_(False)

    def _admit_waiting(self) -> None:
        s = self.state
        for lane in range(self.num_lanes):
            if self._lane_req[lane] is None and self._queue:
                rid, ids = self._queue[0]
                # admission control: context blocks (+1 token) must be
                # available NOW or the request waits
                need = math.ceil((ids.size + 1) / self.tpb)
                if self.ledger.free < need:
                    break
                self._queue.popleft()
                self._grow(lane, need)
                plen = torch.tensor([ids.size], dtype=torch.int32,
                                    device=self.device)
                table = torch.from_numpy(
                    self._tables[lane:lane + 1].copy()).to(self.device)
                logits, _, _ = self._prefill(
                    self.params, self._padded(ids), plen, s.pool_k,
                    s.pool_v, table)
                first = torch.argmax(logits[0]).to(torch.int32)
                admit_lane(s, lane, ids, first, self.eos,
                           self.max_new_tokens)
                self._plen[lane] = ids.size
                self._lane_req[lane] = rid
