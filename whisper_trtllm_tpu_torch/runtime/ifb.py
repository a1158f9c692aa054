"""Token-level in-flight (continuous) batching (counterpart of
``whisper_trtllm_tpu/runtime/ifb.py``).

Batch lanes hold *different utterances at different decode positions*; a
finished lane is refilled from the queue without waiting for its
neighbours. The lanes' state lives in static device buffers (``LaneState``):
tokens, a position per lane, the ``active`` and ``finished`` flags (one
(2, B) tensor, so the host reads both in one copy) and the self and cross
caches. ``lane_step`` is the body of the JAX segment: the ragged decode
step (``decode_step_ragged_kv``) for every lane, the suppress, begin-suppress
and forced-token rules, argmax, and EOS and max-length retirement; every
write is gated by ``live = active & ~finished``, so a step with no live lane
changes nothing the host reads, and tokens do not depend on how the steps
are cut into segments.

On the card the step is captured once, when the batcher is built (all
lanes idle), as a CUDA graph with the decode loop's machinery
(``generation.warm_and_capture``); a segment replays it ``segment_steps``
times (``max(4, segment_steps // 4)`` while requests wait) with no host
read inside, then copies the flags, tokens and positions to pinned host
memory behind an event. The host reads the flags once a segment and the
tokens only when a lane retires. Admission and retirement write into the
same buffers in place (``copy_`` and fills of one lane), never rebinding a
tensor the graph reads. Encodes of up to ``num_lanes`` queued requests are
queued behind each segment on the same stream. The batcher holds its own
graph: the decode loop's cache (``generation._GRAPHS``) never sees it.

On the CPU the same step runs eagerly, on the same schedule.

Double buffering (``WHISPER_TPU_IFB_DOUBLE_BUFFER=1``, read when the batcher
is built, as the JAX package reads it) dispatches segment N+1 before it
consumes N's snapshot; per-lane epochs keep a snapshot from retiring a lane
admitted after it was taken.

Cache precision follows ``GenerationConfig.kv_cache_dtype`` (float, int8 or
fp8 lanes) and ``cross_kv_layout``; the other decoding fields are not read,
as in the JAX batcher (greedy only).

On a tree cut over the model axis (``parallel/partition.py``) the batcher
is built and run inside its mesh, every rank of the model group given the
same requests in the same order: the lanes hold the rank's heads, and the
flags the host reads come from the all-reduced logits, so every rank
admits and retires the same lanes.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from whisper_trtllm_tpu_torch.audio.features import (
    LogMelSpectrogram,
    pad_or_trim,
)
from whisper_trtllm_tpu_torch.config import GenerationConfig, WhisperConfig
from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
from whisper_trtllm_tpu_torch.parallel import partition
from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy
from whisper_trtllm_tpu_torch.utils.device import (
    resolve_device,
    set_fp32_precision,
    to_tensor,
)


class LaneState(NamedTuple):
    tokens: torch.Tensor    # (B, max_len) int32
    pos: torch.Tensor       # (B,) int32: index of the last filled position
    active: torch.Tensor    # (B,) bool: the lane holds a request
    finished: torch.Tensor  # (B,) bool: the request hit EOS or max length
    self_kv: tuple          # float (k, v) or quantized (kq, ks, vq, vs)
    cross_kv: tuple         # (L, B, H, Tc, dh) tensors (or T-minor)


def lane_step(params: dict, cfg: WhisperConfig, s: LaneState,
              rules: gen_rt.Rules, max_len: int) -> None:
    """One step of the JAX segment's body, in place on ``s``: every lane
    decodes at its own position (idle and finished lanes too, as in the
    JAX step, writing their cache row at ``pos``), and the live lanes take
    the next token at ``min(pos + 1, max_len - 1)``. ``rules``: the
    suppress masks, the forced map and ``begin_index`` of
    ``generation.make_rules``. Reads no device value on the host."""
    live = s.active & ~s.finished
    pos = s.pos
    cur = s.tokens.gather(1, pos.long()[:, None])[:, 0]
    logits, _ = wmodel.decode_step_ragged_kv(params, cfg, cur, pos,
                                             s.self_kv, s.cross_kv)
    nxt_pos = (pos + 1).clamp(max=max_len - 1)
    idx = nxt_pos.long()
    logits = logits + rules.suppress[None]
    logits = torch.where((nxt_pos == rules.begin_index)[:, None],
                         logits + rules.begin_suppress[None], logits)
    nxt = torch.argmax(logits, dim=-1)
    forced = rules.forced_map.index_select(0, idx)
    nxt = torch.where(forced >= 0, forced, nxt).to(torch.int32)
    existing = s.tokens.gather(1, idx[:, None])[:, 0]
    s.tokens.scatter_(1, idx[:, None], torch.where(live, nxt, existing)[:, None])
    s.finished.logical_or_(live & ((nxt == cfg.eos_token_id)
                                   | (nxt_pos >= max_len - 1)))
    s.pos.copy_(torch.where(live, nxt_pos, pos))


def admit(s: LaneState, cfg: WhisperConfig, lane: int, cross) -> None:
    """Put a new utterance's cross cache (every tensor (L, 1, ...)) into
    ``lane`` and reset the lane's tokens, position and flags, in place.
    The lane's self cache is left as it is: rows past ``pos`` are masked."""
    for buf, new in zip(s.cross_kv, cross):
        buf[:, lane].copy_(new[:, 0])
    s.tokens[lane].fill_(cfg.pad_token_id)
    s.tokens[lane, 0].fill_(cfg.decoder_start_token_id)
    s.pos[lane].fill_(0)
    s.active[lane].fill_(True)
    s.finished[lane].fill_(False)


class InflightBatcher:
    """Continuous-batching decoder over fixed lanes, on ``device`` (the
    CUDA card by default).

    >>> b = InflightBatcher(params, cfg, num_lanes=8)
    >>> rid = b.submit(mel_1x3000xM)       # any number of times
    >>> b.run()                            # drain queue + lanes
    >>> tokens = b.fetch(rid)              # np.int32, start token to EOS
    """

    def __init__(
        self,
        params: dict,
        cfg: WhisperConfig,
        generation: Optional[GenerationConfig] = None,
        num_lanes: int = 8,
        segment_steps: int = 32,
        adaptive_segments: bool = True,
        device=None,
    ):
        gen = generation or GenerationConfig()
        self.device = dev = resolve_device(device)
        set_fp32_precision()
        self.cfg = cfg
        self.generation = gen
        # the weights as given, placed on the device once (a no-op for a
        # tree already there)
        self.params = params_from_numpy(params, dev)
        self.num_lanes = num_lanes
        self.segment_steps = segment_steps
        self.max_len = min(cfg.max_target_positions, gen.max_new_tokens + 1)
        gen_rt.kv_quant_dtype(gen.kv_cache_dtype)  # refuses unknown kinds
        self._dtype = self.params["encoder"]["conv1"]["kernel"].dtype
        # adaptive segmentation: while requests wait, a short segment bounds
        # the time to admission; with an empty queue the long one amortizes
        # the host's work a segment. Tokens do not depend on it.
        self._short_steps = max(4, segment_steps // 4)
        self._adaptive = (adaptive_segments
                          and self._short_steps < segment_steps)
        self._queue: deque = deque()
        self._lane_req: List[Optional[int]] = [None] * num_lanes
        self._results: Dict[int, np.ndarray] = {}
        self._next_id = 1
        self._double_buffer = (
            os.environ.get("WHISPER_TPU_IFB_DOUBLE_BUFFER") == "1")
        self._seg_idx = 0                       # segments dispatched
        self._lane_epoch = [0] * num_lanes      # first segment vouching a lane
        self.steps_run = 0                      # steps of every segment
        # built here: a lazy build under concurrent first requests would
        # race the handler threads
        self._frontend = LogMelSpectrogram(cfg.num_mel_bins, device=dev)
        with torch.inference_mode():
            probe = self._encode(torch.zeros(
                (1, 2 * cfg.max_source_positions, cfg.num_mel_bins),
                device=dev))
            self._flags = torch.zeros((2, num_lanes), dtype=torch.bool,
                                      device=dev)   # finished, active
            self.state = LaneState(
                tokens=torch.full((num_lanes, self.max_len),
                                  cfg.pad_token_id, dtype=torch.int32,
                                  device=dev),
                pos=torch.zeros(num_lanes, dtype=torch.int32, device=dev),
                active=self._flags[1],
                finished=self._flags[0],
                self_kv=gen_rt.init_self_cache(
                    cfg, gen, num_lanes, self.max_len, self._dtype, dev,
                    partition.local_model(self.params, cfg).decoder_heads),
                cross_kv=tuple(
                    torch.zeros((c.shape[0], num_lanes) + c.shape[2:],
                                dtype=c.dtype, device=dev) for c in probe))
            del probe
            # the JAX batcher's processors only: the suppress masks and the
            # forced map without timestamps (no word rules, no prompt)
            self.rules = gen_rt.make_rules(cfg, GenerationConfig(),
                                           self.max_len, dev)
            self._graph = None
            if dev.type == "cuda":
                # every lane idle: the warm-up step changes nothing
                self._graph = gen_rt._StepGraph(
                    self.state, self.state.cross_kv, self.rules, [])
                layout = partition.layout_of(self.params)
                gen_rt.warm_and_capture(
                    self._graph, self._step, dev,
                    group=None if layout is None else layout.group)
                # two sets of pinned snapshot buffers: double buffering
                # fills one while the host reads the other
                self._pinned = [tuple(
                    torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in (self._flags, self.state.tokens,
                              self.state.pos)) for _ in range(2)]

    @torch.inference_mode()
    def _step(self) -> None:
        lane_step(self.params, self.cfg, self.state, self.rules,
                  self.max_len)

    # -- public ---------------------------------------------------------------
    def submit(self, mel) -> int:
        """mel (3000, M) or (1, 3000, M), numpy or a tensor → request id."""
        mel = to_tensor(mel, self.device, torch.float32)
        if mel.dim() == 2:
            mel = mel[None]
        rid = self._next_id
        self._next_id += 1
        # [rid, mel, cross cache or None]: the encode is queued behind a
        # running segment (run()) so admission never waits for it
        self._queue.append([rid, mel, None])
        return rid

    @torch.inference_mode()
    def compute_mel(self, audio) -> torch.Tensor:
        """Raw 16 kHz audio (any length ≤ 30 s; padded or trimmed) → (1,
        3000, M) mel on the batcher's device (K3 on the card); the JAX
        batcher returns it on the host. Safe from any thread once the
        batcher is built: the serving layer calls it outside its lock."""
        return self._frontend(pad_or_trim(np.asarray(audio, np.float32))[None])

    def submit_audio(self, audio) -> int:
        """Raw audio → request id (frontend + submit)."""
        return self.submit(self.compute_mel(audio))

    def fetch(self, request_id: int) -> Optional[np.ndarray]:
        return self._results.pop(request_id, None)

    @torch.inference_mode()
    def _dispatch_segment(self):
        """Run one segment on the newest state and return its snapshot
        (flags, tokens, positions, event, segment index): pinned host
        copies behind an event on the card, copies on the CPU. Then queue
        the encodes of waiting requests behind it."""
        n = (self._short_steps if (self._queue and self._adaptive)
             else self.segment_steps)
        if self._graph is None:
            for _ in range(n):
                self._step()
            gen_rt.LOOP.eager_steps += n
        else:
            for _ in range(n):
                self._graph.replay()
        self.steps_run += n
        self._seg_idx += 1
        src = (self._flags, self.state.tokens, self.state.pos)
        if self._graph is None:
            snap = tuple(t.to("cpu", copy=True) for t in src) + (
                None, self._seg_idx)
        else:
            bufs = self._pinned[self._seg_idx % 2]
            for dst, t in zip(bufs, src):
                dst.copy_(t, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            snap = bufs + (event, self._seg_idx)
        self._pre_encode(self.num_lanes)
        return snap

    def run(self, max_segments: int = 10_000) -> None:
        """Process until the queue is empty and every lane has drained.

        Default: dispatch → read → retire/admit per segment. With
        ``WHISPER_TPU_IFB_DOUBLE_BUFFER=1`` one segment stays in flight past
        the read: segment N+1 is dispatched before N's snapshot is
        consumed, so the host's retire/admit overlaps the card's work;
        admissions land one segment later, tokens are the same."""
        snap = None
        for _ in range(max_segments):
            if not self._double_buffer:
                self._retire_and_admit(snap)
                snap = None
                if not any(self._lane_req):
                    if not self._queue:
                        return
                    continue
                snap = self._dispatch_segment()
                continue
            busy = any(self._lane_req)
            new_snap = self._dispatch_segment() if busy else None
            if snap is not None:
                self._retire_and_admit(snap)
            elif not busy:
                if not self._queue:
                    return
                self._retire_and_admit()
            snap = new_snap
        raise RuntimeError("run() exceeded max_segments")

    # -- internals ------------------------------------------------------------
    def _encode(self, mel: torch.Tensor) -> tuple:
        """Encoder + cross cache (quantized, in its layout) of one mel."""
        enc = wmodel.encode(self.params, self.cfg, mel.to(self._dtype))
        return gen_rt.build_cross_kv(self.params, self.cfg, enc,
                                     self.generation)

    def _pre_encode(self, limit: int) -> None:
        """Queue the encodes of up to ``limit`` waiting requests that have
        none yet."""
        for i, item in enumerate(self._queue):
            if i >= limit:
                break
            if item[2] is None:
                item[2] = self._encode(item[1])

    @torch.inference_mode()
    def _retire_and_admit(self, snapshot=None) -> None:
        """One read of the flags (from ``snapshot``, a dispatched segment's,
        or from the state now), the tokens only when a lane retires; then
        admit waiting requests into the free lanes."""
        if snapshot is None:
            flags_t, tokens_t, pos_t = (self._flags, self.state.tokens,
                                        self.state.pos)
            snap_seg = self._seg_idx
            flags = flags_t.cpu().numpy()
        else:
            flags_t, tokens_t, pos_t, event, snap_seg = snapshot
            if event is not None:
                event.synchronize()
            flags = flags_t.numpy().copy()
        finished, active = flags[0], flags[1]
        retire = [lane for lane in range(self.num_lanes)
                  if active[lane] and finished[lane]
                  and self._lane_req[lane] is not None
                  # a snapshot vouches only for lanes admitted before the
                  # segment it came from (with double buffering a lane
                  # re-admitted behind it still shows its old request's
                  # finished flag)
                  and self._lane_epoch[lane] <= snap_seg]
        if retire:
            tokens, pos = tokens_t.cpu().numpy(), pos_t.cpu().numpy()
            for lane in retire:
                self._results[self._lane_req[lane]] = \
                    tokens[lane, : pos[lane] + 1].copy()
                self._lane_req[lane] = None
                # on the newest state: a finished lane is frozen in any
                # segment dispatched after the snapshot
                self.state.active[lane].fill_(False)
        for lane in range(self.num_lanes):
            if self._lane_req[lane] is None and self._queue:
                rid, mel, cross = self._queue.popleft()
                if cross is None:  # not encoded ahead
                    cross = self._encode(mel)
                admit(self.state, self.cfg, lane, cross)
                self._lane_req[lane] = rid
                # the first segment that can decode this request
                self._lane_epoch[lane] = self._seg_idx + 1
