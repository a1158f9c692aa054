"""Token-level in-flight (continuous) batching for the zoo's causal LMs
(counterpart of ``whisper_trtllm_tpu/runtime/ifb_lm.py``).

Batch lanes hold *different requests at different decode positions*; a
finished lane is refilled from the queue without waiting for its
neighbours. Generic over a family's ``(prefill, step)`` pair: ``prefill``
is its ragged context phase (``_prefill_ragged``), ``step`` its one-token
step with a (B,) position vector (``_step``).

The lanes' state lives in static device buffers (``LMLaneState``): tokens,
a position and a prompt length per lane, the ``finished`` and ``active``
flags (one (2, B) tensor, so the host reads both in one copy) and the
(L, B, H, max_len, dh) fp32 caches. ``lane_step`` is the body of the JAX
segment: every lane steps at its own position, the live lanes
(``active & ~finished``) take the argmax at ``min(pos + 1, max_len - 1)``
and retire on EOS, on their request's cap (``nxt_pos - plen + 1 >=
max_new_tokens``) or at the buffer's end; every write is gated by ``live``,
so a step with no live lane changes nothing the host reads, and tokens do
not depend on how the steps are cut into segments.

On the card the step is captured once, when the batcher is built (all
lanes idle), as a CUDA graph (``generation.warm_and_capture``); a segment
replays it ``segment_steps`` times with no host read inside (the JAX loop's
early exit when every lane has finished becomes replays that change
nothing), then copies the flags, tokens and positions to pinned host memory
behind an event, which the host reads once a segment. Admission writes the
lane's buffers in place (never rebinding a tensor the graph reads): the
request's prompt, padded to ``max_prompt_len``, runs the family's
``prefill`` eagerly at batch 1 with the lane's rows of the caches as its
cache (K1 on the card for a padded prompt of 768 or more), and its argmax
is the first token. On the CPU the same step runs eagerly, on the same
schedule.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy
from whisper_trtllm_tpu_torch.utils.device import resolve_device


class LMLaneState(NamedTuple):
    tokens: torch.Tensor    # (B, max_len) int32
    pos: torch.Tensor       # (B,) int32: index of the last filled position
    plen: torch.Tensor      # (B,) int32: the lane's prompt length
    active: torch.Tensor    # (B,) bool: the lane holds a request
    finished: torch.Tensor  # (B,) bool
    cache_k: torch.Tensor   # (L, B, H, max_len, dh) fp32
    cache_v: torch.Tensor


def advance_lanes(s, logits: torch.Tensor, eos: int, max_len: int,
                  max_new: int) -> None:
    """The JAX segment body's bookkeeping after a step's logits (B, V), in
    place on ``s`` (any state with tokens, pos, plen, active, finished):
    the live lanes write their argmax at ``min(pos + 1, max_len - 1)`` and
    retire on EOS, on the per-request cap or at the buffer's end."""
    live = s.active & ~s.finished
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    nxt_pos = (s.pos + 1).clamp(max=max_len - 1)
    idx = nxt_pos.long()[:, None]
    existing = s.tokens.gather(1, idx)[:, 0]
    s.tokens.scatter_(1, idx, torch.where(live, nxt, existing)[:, None])
    hit_eos = nxt == eos
    # per-request cap: tokens generated = nxt_pos - plen + 1
    hit_cap = nxt_pos - s.plen + 1 >= max_new
    hit_max = nxt_pos >= max_len - 1
    s.finished.logical_or_(live & (hit_eos | hit_cap | hit_max))
    s.pos.copy_(torch.where(live, nxt_pos, s.pos))


def admit_lane(s, lane: int, ids: np.ndarray, first: torch.Tensor, eos: int,
               max_new: int) -> None:
    """Lane ``lane`` takes a request, in place: the prompt ``ids`` then the
    first token (a 0-d device tensor) in its token row (EOS after), its
    position and prompt length at ``len(ids)``, active, and finished when
    the first token is EOS or the cap is one token."""
    plen = int(ids.size)
    row = s.tokens[lane]
    row.fill_(eos)
    row[:plen].copy_(torch.from_numpy(ids))
    row[plen:plen + 1].copy_(first.reshape(1))
    s.pos[lane].fill_(plen)
    s.plen[lane].fill_(plen)
    s.active[lane].fill_(True)
    s.finished[lane].copy_((first == eos) | (max_new <= 1))


class _LaneBatcher:
    """What the dense and the paged batcher share: the request queue, the
    results, the captured step, the segment's snapshot and the retire
    pass. A subclass gives the step (``_step``), the admission
    (``_admit``) and the segment's length (``_segment_len``)."""

    def _init_common(self, params, cfg, eos_token_id, num_lanes,
                     max_prompt_len, max_new_tokens, segment_steps, device):
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the admit-time "
                             "first-token write needs one slot per request)")
        self.device = dev = resolve_device(device)
        # the weights as given, placed on the device once (a no-op for a
        # tree already there)
        self.params = params_from_numpy(params, dev)
        self.cfg = cfg
        self.eos = int(eos_token_id)
        self.num_lanes = num_lanes
        self.max_prompt_len = max_prompt_len
        self.max_len = max_prompt_len + max_new_tokens
        self.max_new_tokens = max_new_tokens
        self.segment_steps = segment_steps
        self._queue: deque = deque()
        self._lane_req: List[Optional[int]] = [None] * num_lanes
        self._results: Dict[int, np.ndarray] = {}
        self._next_id = 1
        self.steps_run = 0
        self._flags = torch.zeros((2, num_lanes), dtype=torch.bool,
                                  device=dev)     # finished, active
        self._graph = None

    def _capture(self) -> None:
        """On the card: the step captured once, every lane idle (the
        warm-up step's writes land in rows an admit overwrites), and the
        pinned buffers of the segments' snapshots."""
        if self.device.type != "cuda":
            return
        self._graph = gen_rt._StepGraph(self.state, None, None, [])
        gen_rt.warm_and_capture(self._graph, self._step, self.device)
        self._pinned = tuple(
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in (self._flags, self.state.tokens, self.state.pos))

    # -- public ---------------------------------------------------------------
    def submit(self, prompt_ids) -> int:
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        if not (0 < ids.size <= self.max_prompt_len):
            raise ValueError(
                f"prompt length {ids.size} not in [1, {self.max_prompt_len}]")
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, ids))
        return rid

    def fetch(self, request_id: int) -> Optional[np.ndarray]:
        return self._results.pop(request_id, None)

    def run(self, max_segments: int = 10_000) -> None:
        """Process until the queue is empty and every lane has drained."""
        snap = None
        for _ in range(max_segments):
            self._retire_and_admit(snap)
            snap = None
            if not any(self._lane_req):
                if not self._queue:
                    return
                continue
            snap = self._dispatch_segment(self._segment_len())
        raise RuntimeError("run() exceeded max_segments")

    # -- internals ------------------------------------------------------------
    @torch.inference_mode()
    def _dispatch_segment(self, n: int):
        """``n`` steps, replayed on the card, eager on the CPU; returns the
        snapshot (flags, tokens, positions, event): pinned copies behind an
        event on the card."""
        if self._graph is None:
            for _ in range(n):
                self._step()
            gen_rt.LOOP.eager_steps += n
        else:
            for _ in range(n):
                self._graph.replay()
        self.steps_run += n
        src = (self._flags, self.state.tokens, self.state.pos)
        if self._graph is None:
            return tuple(t.to("cpu", copy=True) for t in src) + (None,)
        for dst, t in zip(self._pinned, src):
            dst.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return self._pinned + (event,)

    def _retire_lane(self, lane: int) -> None:
        self.state.active[lane].fill_(False)

    @torch.inference_mode()
    def _retire_and_admit(self, snapshot=None) -> None:
        """One read of the flags (the last segment's snapshot, or the state
        now), the tokens only when a lane retires; then the admissions."""
        if snapshot is None:
            flags_t, tokens_t, pos_t = (self._flags, self.state.tokens,
                                        self.state.pos)
            flags = flags_t.cpu().numpy()
        else:
            flags_t, tokens_t, pos_t, event = snapshot
            if event is not None:
                event.synchronize()
            flags = flags_t.numpy().copy()
        finished, active = flags[0], flags[1]
        retire = [lane for lane in range(self.num_lanes)
                  if active[lane] and finished[lane]
                  and self._lane_req[lane] is not None]
        if retire:
            tokens, pos = tokens_t.cpu().numpy(), pos_t.cpu().numpy()
            for lane in retire:
                self._results[self._lane_req[lane]] = \
                    tokens[lane, : pos[lane] + 1].copy()
                self._lane_req[lane] = None
                self._retire_lane(lane)
        self._admit_waiting()

    def _padded(self, ids: np.ndarray) -> torch.Tensor:
        """The prompt as a (1, max_prompt_len) row padded with EOS."""
        row = np.full((1, self.max_prompt_len), self.eos, np.int32)
        row[0, : ids.size] = ids
        return torch.from_numpy(row).to(self.device)


class CausalLMInflightBatcher(_LaneBatcher):
    """Continuous-batching generation over fixed lanes for any zoo causal
    LM, on ``device`` (the CUDA card by default).

    >>> from whisper_trtllm_tpu_torch.models.gpt import model as gm
    >>> b = CausalLMInflightBatcher(
    ...     params, cfg,
    ...     prefill=lambda p, t, l, ck, cv: gm._prefill_ragged(
    ...         p, cfg, t, l, ck, cv),
    ...     step=lambda p, tok, pos, ck, cv: gm._step(
    ...         p, cfg, tok, pos, ck, cv),
    ...     cache_heads=cfg.n_head, head_dim=cfg.head_dim,
    ...     n_layer=cfg.n_layer, eos_token_id=cfg.eos_token_id)
    >>> rid = b.submit([3, 4, 5])
    >>> b.run(); tokens = b.fetch(rid)
    """

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
        num_lanes: int = 8,
        max_prompt_len: int = 32,
        max_new_tokens: int = 64,
        segment_steps: int = 32,
        device=None,
    ):
        self._init_common(params, cfg, eos_token_id, num_lanes,
                          max_prompt_len, max_new_tokens, segment_steps,
                          device)
        self._prefill = prefill
        self._step_fn = step
        dev = self.device
        shape = (n_layer, num_lanes, cache_heads, self.max_len, head_dim)
        with torch.inference_mode():
            self.state = LMLaneState(
                tokens=torch.full((num_lanes, self.max_len), self.eos,
                                  dtype=torch.int32, device=dev),
                pos=torch.zeros(num_lanes, dtype=torch.int32, device=dev),
                plen=torch.zeros(num_lanes, dtype=torch.int32, device=dev),
                active=self._flags[1],
                finished=self._flags[0],
                cache_k=torch.zeros(shape, dtype=torch.float32, device=dev),
                cache_v=torch.zeros(shape, dtype=torch.float32, device=dev))
            self._capture()

    def _segment_len(self) -> int:
        return self.segment_steps

    @torch.inference_mode()
    def _step(self) -> None:
        s = self.state
        cur = s.tokens.gather(1, s.pos.long()[:, None])[:, 0]
        logits, _, _ = self._step_fn(self.params, cur, s.pos, s.cache_k,
                                     s.cache_v)
        advance_lanes(s, logits, self.eos, self.max_len, self.max_new_tokens)

    def _admit_waiting(self) -> None:
        s, p_max = self.state, self.max_prompt_len
        for lane in range(self.num_lanes):
            if self._lane_req[lane] is None and self._queue:
                rid, ids = self._queue.popleft()
                plen = torch.tensor([ids.size], dtype=torch.int32,
                                    device=self.device)
                # the prefill writes rows [0, max_prompt_len) of the lane's
                # caches; the rows past them are masked until a step writes
                logits, _, _ = self._prefill(
                    self.params, self._padded(ids), plen,
                    s.cache_k[:, lane:lane + 1, :, :p_max],
                    s.cache_v[:, lane:lane + 1, :, :p_max])
                first = torch.argmax(logits[0]).to(torch.int32)
                admit_lane(s, lane, ids, first, self.eos,
                           self.max_new_tokens)
                self._lane_req[lane] = rid
