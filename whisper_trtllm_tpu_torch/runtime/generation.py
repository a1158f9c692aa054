"""Greedy and sampled generation (counterpart of
``whisper_trtllm_tpu/runtime/generation.py``: ``greedy_decode``,
``greedy_decode_prompted``, ``detect_language`` and ``transcribe_tokens``).

The JAX package runs its token loop as a ``lax.while_loop`` inside one
jit: the state lives on the device and no step reads a device value on the
host. The port keeps that shape. ``greedy_step`` is the body of
``_greedy_decode_impl``: it reads and writes a ``GreedyState`` of device
tensors in place (tokens, ``pos``, finished, lengths and the self caches),
and every processor (penalties, word rules, suppression, timestamp rules,
sampling, the forced map, the prompt window, EOS and stop words) is a
tensor op on the step's fixed shapes; Python branches only on the
configuration.

On the card the step is captured once as a CUDA graph against static
buffers and replayed (``_StepGraph``): the first decode of an entry runs
``WARMUP_STEPS`` eager steps on a side stream (they build the kernels and
make every lazily made tensor, K6's counters among them), captures, then
replays. A capture that fails raises; nothing falls back to an eager loop.
On the CPU the same step runs eagerly. Both follow one schedule
(``_run``): the host reads ``finished`` once every ``FINISH_CHECK_EVERY``
steps and never runs more than ``max_len - 1``; a step after every lane
has finished writes pad and leaves ``lengths`` alone, so tokens and lengths
equal the JAX loop's, which stops at once. The beam search
(``runtime/beam.py``) and the speculative round
(``runtime/speculative.py``) run through the same loop and cache
(``run_decode``).

The token-buffer semantics are the JAX package's: the start token (or the
prompt) first, the forced prefix after it, pad after EOS, ``lengths`` =
EOS position + 1 (or ``max_len``).

On a tree cut over the model axis (``parallel/partition.py``) the loop
runs at the rank's head count and every rank of a model group takes the
same branch at each host read: ``finished`` comes from the logits, which
the step's last all-reduce made equal on every rank. ``transcribe_tokens``
under a mesh with a data axis cuts the batch over it and gathers every
rank's tokens and lengths, so each rank returns the whole batch's, as the
JAX function returns a global array.
"""

from __future__ import annotations

import collections
import functools
import time
import weakref
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from whisper_trtllm_tpu_torch.config import GenerationConfig, WhisperConfig
from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
from whisper_trtllm_tpu_torch.ops.kernels import KERNELS, _launches
from whisper_trtllm_tpu_torch.parallel import collectives, partition
from whisper_trtllm_tpu_torch.parallel.mesh import (
    axis_size,
    current_mesh,
    join_batch,
    split_batch,
)
from whisper_trtllm_tpu_torch.runtime import logits_process as lp
from whisper_trtllm_tpu_torch.runtime import sampling
from whisper_trtllm_tpu_torch.utils.device import (
    resolve_device,
    set_fp32_precision,
    to_tensor,
)

# steps between two host reads of `finished`: a decode overruns its last
# needed step by at most FINISH_CHECK_EVERY - 1 steps that write pad
FINISH_CHECK_EVERY = 8
# eager steps of an entry's first decode before its capture
WARMUP_STEPS = 1
# captured decode steps kept; an entry also goes when a weight it reads dies
GRAPH_CACHE_SIZE = 4


def kv_quant_dtype(kv_cache_dtype: str):
    """GenerationConfig.kv_cache_dtype → storage dtype of the quantized KV
    caches, or None for float caches ("auto")."""
    table = {"auto": None, "int8": torch.int8, "fp8": torch.float8_e4m3fn}
    if kv_cache_dtype not in table:
        raise ValueError(f"kv_cache_dtype must be one of {sorted(table)}, "
                         f"got {kv_cache_dtype!r}")
    return table[kv_cache_dtype]


def apply_cross_layout(cross_kv, layout: str):
    """Resolve GenerationConfig.cross_kv_layout: transpose the cross-KV
    tuple to T-minor for "bhdt", and for "auto" when the cache is
    quantized; float "auto" stays dh-minor. Square caches (padded encoder
    length == head_dim) keep dh-minor under "auto" and are refused under
    "bhdt": ``cross_kv_t_major`` could not tell the layouts apart."""
    if layout not in ("auto", "bhtd", "bhdt"):
        raise ValueError(
            f"cross_kv_layout must be auto|bhtd|bhdt, got {layout!r}")
    quantized = len(cross_kv) == 4
    if layout == "bhdt" or (layout == "auto" and quantized):
        k = cross_kv[0]
        if k.shape[-2] == k.shape[-1]:
            if layout == "bhdt":
                raise ValueError(
                    "cross_kv_layout='bhdt' is unsupported when the padded "
                    f"encoder length equals head_dim ({k.shape[-2]}): the "
                    "T-minor layout would be undetectable from shapes")
            return cross_kv
        return wmodel.transpose_cross_kv(cross_kv)
    return cross_kv


def check_greedy_config(gen: GenerationConfig) -> None:
    """Refuse what the greedy loop does not implement: it is the
    single-beam loop, and ``num_beams > 1`` runs in ``runtime/beam.py``
    (``beam_decode``). Every other field is taken."""
    if gen.num_beams != 1:
        raise NotImplementedError(
            "greedy_decode is the single-beam loop; beam search "
            "(num_beams > 1) is runtime.beam.beam_decode")


class GreedyState(NamedTuple):
    """The decode loop's state, every tensor on the decode's device and
    updated in place by ``greedy_step``."""

    tokens: torch.Tensor    # (B, max_len) int32
    pos: torch.Tensor       # 0-d int32: the last filled position
    finished: torch.Tensor  # (B,) bool
    lengths: torch.Tensor   # (B,) int32: filled length, set at finish
    self_kv: tuple          # float (k, v) or quantized (kq, ks, vq, vs)


@dataclass(frozen=True)
class Rules:
    """What the step reads besides its state, made on the device once per
    decode: the suppress masks (V,) fp32, the forced map (max_len,) int64,
    the word tables (``sampling.word_table``) and the prompt (B, P) int32;
    and the host constants ``begin_index``, ``prompt_len`` and
    ``timestamps``."""

    suppress: torch.Tensor
    begin_suppress: torch.Tensor
    forced_map: torch.Tensor
    begin_index: int
    prompt_len: int
    timestamps: bool
    bad_words: Optional[tuple]
    stop_words: Optional[tuple]
    prompt: Optional[torch.Tensor]


def make_rules(cfg: WhisperConfig, gen: GenerationConfig, max_len: int,
               device, prompt: Optional[torch.Tensor] = None) -> Rules:
    """The processors' constants of one decode: the forced map of
    ``build_forced_map`` (none with a prompt, which carries its own
    prefix) and ``begin_index`` (the prompt's length with one)."""
    timestamps = gen.return_timestamps
    if timestamps and cfg.no_timestamps_token_id is None:
        raise ValueError("timestamp decoding needs cfg.no_timestamps_token_id")
    if prompt is None:
        forced, begin_index = lp.build_forced_map(cfg, max_len,
                                                  timestamps=timestamps)
        prompt_len = 1
    else:
        forced = np.full((max_len,), -1, np.int32)
        begin_index = prompt_len = prompt.shape[1]

    def dev(a):
        return torch.from_numpy(a).to(device)

    return Rules(
        suppress=dev(lp.build_suppress_mask(cfg)),
        begin_suppress=dev(lp.build_begin_suppress_mask(cfg)),
        forced_map=dev(forced.astype(np.int64)),
        begin_index=begin_index, prompt_len=prompt_len, timestamps=timestamps,
        bad_words=(sampling.word_table(gen.bad_words, device)
                   if gen.bad_words else None),
        stop_words=(sampling.word_table(gen.stop_words, device)
                    if gen.stop_words else None),
        prompt=prompt)


def build_cross_kv(params: dict, cfg: WhisperConfig, enc_states: torch.Tensor,
                   gen: GenerationConfig) -> Tuple[torch.Tensor, ...]:
    """The cross cache of one decode: K/V from ``enc_states``, quantized
    for an int8/fp8 ``kv_cache_dtype``, in ``cross_kv_layout``."""
    kv_qdtype = kv_quant_dtype(gen.kv_cache_dtype)
    cross_k, cross_v = wmodel.compute_cross_kv(params, cfg, enc_states)
    if kv_qdtype is not None:
        cross_kv = wmodel.quantize_cross_kv(cross_k, cross_v, kv_qdtype)
    else:
        cross_kv = (cross_k, cross_v)
    return apply_cross_layout(cross_kv, gen.cross_kv_layout)


def init_self_cache(cfg: WhisperConfig, gen: GenerationConfig, batch: int,
                    max_len: int, dtype, device, heads: Optional[int] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """The self caches of a decode's ``batch`` lanes at ``heads`` heads
    (default: the config's): float (k, v) in ``dtype``, or quantized (kq,
    ks, vq, vs) for an int8/fp8 ``kv_cache_dtype``; ``reset_caches`` gives
    them their first values."""
    kv_qdtype = kv_quant_dtype(gen.kv_cache_dtype)
    if kv_qdtype is not None:
        return wmodel.init_self_kv_quant(cfg, batch, max_len, kv_qdtype,
                                         device=device, heads=heads)
    return wmodel.init_self_kv(cfg, batch, max_len, dtype=dtype,
                               device=device, heads=heads)


def reset_caches(self_kv: Tuple[torch.Tensor, ...]) -> None:
    """Zero caches in place; a quantized tuple's scales (its second and
    fourth tensors) one."""
    for i, cache in enumerate(self_kv):
        cache.fill_(1 if len(self_kv) == 4 and i % 2 else 0)


def init_state(cfg: WhisperConfig, gen: GenerationConfig, batch: int,
               max_len: int, dtype, device, heads: Optional[int] = None
               ) -> GreedyState:
    """A state's buffers; ``reset_state`` gives them their first values."""
    return GreedyState(
        tokens=torch.empty((batch, max_len), dtype=torch.int32, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device),
        finished=torch.zeros(batch, dtype=torch.bool, device=device),
        lengths=torch.empty(batch, dtype=torch.int32, device=device),
        self_kv=init_self_cache(cfg, gen, batch, max_len, dtype, device,
                                heads))


def reset_state(s: GreedyState, cfg: WhisperConfig, rules: Rules) -> None:
    """The JAX loop's initial state, written in place: pad everywhere but
    the start token (or the prompt) at the front, ``pos`` 0, no lane
    finished, ``lengths`` ``max_len``, zero caches (scales one)."""
    s.tokens.fill_(cfg.pad_token_id)
    if rules.prompt is None:
        s.tokens[:, 0] = cfg.decoder_start_token_id
    else:
        s.tokens[:, :rules.prompt_len] = rules.prompt
    s.pos.zero_()
    s.finished.zero_()
    s.lengths.fill_(s.tokens.shape[1])
    reset_caches(s.self_kv)


def greedy_step(params: dict, cfg: WhisperConfig, gen: GenerationConfig,
                s: GreedyState, cross_kv: Tuple[torch.Tensor, ...],
                rules: Rules, fused: bool) -> None:
    """One step of ``_greedy_decode_impl``'s body, in place on ``s``:
    decode at ``pos``, the processors in the JAX order, the choice of the
    next token, and the writes of ``tokens[:, pos + 1]``, ``finished``,
    ``lengths`` and ``pos + 1``. Reads no device value on the host."""
    pos = s.pos
    pos1 = pos.long().reshape(1)
    cur = s.tokens.index_select(1, pos1)[:, 0]
    logits, _ = wmodel.decode_step_kv(params, cfg, cur, pos, s.self_kv,
                                      cross_kv, fused=fused)
    nxt_pos = pos + 1
    nxt1 = nxt_pos.long().reshape(1)
    if gen.presence_penalty != 0.0:
        logits = sampling.apply_presence_penalty(logits, s.tokens, pos,
                                                 gen.presence_penalty)
    if gen.min_new_tokens > 0:
        logits = sampling.apply_min_new_tokens(
            logits, nxt_pos - rules.begin_index, gen.min_new_tokens,
            cfg.eos_token_id)
    if rules.bad_words is not None:
        logits = sampling.ban_bad_words(logits, s.tokens, pos,
                                        rules.bad_words)
    logits = logits + rules.suppress[None]
    logits = torch.where(nxt_pos == rules.begin_index,
                         logits + rules.begin_suppress[None], logits)
    if rules.timestamps:
        logits = lp.apply_timestamp_rules(
            logits, s.tokens, pos, rules.begin_index,
            cfg.no_timestamps_token_id + 1, cfg.eos_token_id,
            cfg.max_initial_timestamp_index)
    nxt = sampling.sample_token(
        logits, temperature=gen.temperature, top_k=gen.top_k,
        top_p=gen.top_p, tokens=s.tokens, pos=pos,
        repetition_penalty=gen.repetition_penalty, seed=gen.seed)
    forced = rules.forced_map.index_select(0, nxt1)
    nxt = torch.where(forced >= 0, forced, nxt)
    not_prompt = ~s.finished
    if rules.prompt_len > 1:
        # inside the prompt window the next token is the prompt token
        in_prompt = nxt_pos < rules.prompt_len
        prompt_tok = rules.prompt.index_select(
            1, nxt1.clamp(max=rules.prompt_len - 1))[:, 0]
        nxt = torch.where(in_prompt, prompt_tok, nxt)
        not_prompt = not_prompt & ~in_prompt
    nxt = torch.where(s.finished, cfg.pad_token_id, nxt).to(torch.int32)
    newly = not_prompt & (nxt == cfg.eos_token_id)
    s.tokens.index_copy_(1, nxt1, nxt[:, None])
    if rules.stop_words is not None:
        stopped = sampling.match_stop_words(s.tokens, nxt_pos,
                                            rules.stop_words)
        newly = newly | (~s.finished & stopped
                         & (nxt_pos >= rules.begin_index))
    s.lengths.copy_(torch.where(newly, nxt_pos + 1, s.lengths))
    s.finished.logical_or_(newly)
    s.pos.add_(1)


class LoopCounts:
    """What the decode loops of this process did: eager steps (every CPU
    step, and the warm-up steps before a capture on the card), replays of
    captured steps, captures with their milliseconds, and host reads of
    ``finished``. ``reset_loop_counts`` zeroes them."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.eager_steps = 0
        self.replays = 0
        self.captures = 0
        self.capture_ms = 0.0
        self.host_reads = 0

    @property
    def steps(self) -> int:
        return self.eager_steps + self.replays


LOOP = LoopCounts()


def reset_loop_counts() -> None:
    LOOP.reset()


def _run(step, stopped, limit: int, done: int = 0,
         every: int = FINISH_CHECK_EVERY) -> None:
    """The loop's schedule: ``step()`` until ``limit`` steps ran in all,
    the host calling ``stopped()`` (a read of the state on the device:
    every lane finished, or the beam search's ``go`` fell) once every
    ``every`` steps (and before the first step only when ``done`` steps
    already ran)."""
    while done < limit:
        if done:
            LOOP.host_reads += 1
            if stopped():
                return
        n = min(every, limit - done)
        for _ in range(n):
            step()
        done += n


class _StepGraph:
    """One captured decode step: its state, cross cache and rules (static
    buffers the graph reads and writes), the kernel launches one replay
    makes, and weak references to the decoder weights it was captured
    against."""

    def __init__(self, state: GreedyState, cross_kv, rules: Rules,
                 leaves: list):
        self.state = state
        self.cross_kv = cross_kv
        self.rules = rules
        self.refs = [weakref.ref(t) for t in leaves]
        self.graph = None
        self.launches = {}

    def matches(self, leaves: list) -> bool:
        return len(leaves) == len(self.refs) and all(
            r() is t for r, t in zip(self.refs, leaves))

    def reads(self, leaves: list) -> bool:
        """True when every tensor of ``leaves`` is one this entry reads
        (a speculative entry reads two trees)."""
        live = {id(r()) for r in self.refs if r() is not None}
        return bool(leaves) and all(id(t) in live for t in leaves)

    def capture(self, step) -> None:
        """Capture ``step`` (already warmed up) into a CUDA graph
        (``_launches.capture``: the launches it records are taken back,
        and each replay adds them)."""
        t0 = time.perf_counter()
        self.graph, self.launches = _launches.capture(step, KERNELS)
        LOOP.capture_ms += (time.perf_counter() - t0) * 1e3
        LOOP.captures += 1

    def replay(self) -> None:
        self.graph.replay()
        _launches.replayed(self.launches, KERNELS)
        LOOP.replays += 1


_GRAPHS: "collections.OrderedDict[tuple, _StepGraph]" = \
    collections.OrderedDict()


def _decoder_leaves(params: dict) -> list:
    """The decoder's tensors, in a fixed order. Walked with a stack: a
    nested function that calls itself is a reference cycle, which would
    keep the list (and so every weight) alive until the next garbage
    collection, and run the entries' finalizers there."""
    out, stack = [], [params["decoder"]]
    while stack:
        tree = stack.pop()
        if isinstance(tree, dict):
            stack.extend(tree[k] for k in sorted(tree, reverse=True))
        elif isinstance(tree, torch.Tensor):
            out.append(tree)
    return out


def _forget(key: tuple) -> None:
    _GRAPHS.pop(key, None)


def drop_graphs(params: Optional[dict] = None) -> int:
    """Drop the captured steps that read ``params``' decoder weights (every
    one when None), freeing their static buffers and memory pools; returns
    how many went. ``WhisperSession.refit`` calls it for the old tree."""
    if params is None:
        n = len(_GRAPHS)
        _GRAPHS.clear()
        return n
    leaves = _decoder_leaves(params)
    gone = [k for k, e in _GRAPHS.items() if e.reads(leaves)]
    for k in gone:
        del _GRAPHS[k]
    return len(gone)


def _graph_entry(key: tuple, leaves: list):
    """The cached entry of ``key`` captured against these very weights, or
    None; a hit becomes the most recent."""
    entry = _GRAPHS.get(key)
    if entry is None:
        return None
    if not entry.matches(leaves):
        del _GRAPHS[key]
        return None
    _GRAPHS.move_to_end(key)
    return entry


def _store(key: tuple, entry: _StepGraph, leaves: list) -> None:
    while len(_GRAPHS) >= GRAPH_CACHE_SIZE:
        _GRAPHS.popitem(last=False)
    _GRAPHS[key] = entry
    for t in leaves:
        # when a weight the graph reads dies, its entry goes with it
        weakref.finalize(t, _forget, key)


@functools.lru_cache(maxsize=None)
def _warmup_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream of every warm-up on ``device``: one for the process,
    since each stream cuBLAS runs on keeps a workspace of its own for the
    life of the process."""
    return torch.cuda.Stream(device)


def warm_and_capture(entry: _StepGraph, step, device: torch.device,
                     steps: int = WARMUP_STEPS, group=None) -> None:
    """``steps`` eager calls of ``step`` on the warm-up stream (they build
    the kernels and make every lazily made tensor), then its capture into
    ``entry``. ``group``: the model axis's group of the weights the step
    reads, whose communicator (made at its first collective, which a
    capture cannot hold) an eager all-reduce makes first."""
    if group is not None:
        collectives.all_reduce_(torch.zeros(1, device=device), group)
    side = _warmup_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(steps):
            step()
    torch.cuda.current_stream(device).wait_stream(side)
    LOOP.eager_steps += steps
    entry.capture(step)


def run_decode(key: tuple, params: dict, device: torch.device, limit: int,
               make, load, bind, stopped,
               every: int = FINISH_CHECK_EVERY) -> _StepGraph:
    """The decode loop of the greedy and the beam search, on the card
    through a cached captured step, on the CPU eagerly; returns the entry
    whose state the loop left. ``make()`` gives a new entry's (state,
    cross cache, rules); ``load(entry)`` puts this decode's cross cache and
    prompt into a cached entry's buffers; ``bind(entry)`` resets the state
    and returns the step; ``stopped(state)`` is the host's read, a bool,
    made once every ``every`` steps. On the card an entry's first decode runs ``WARMUP_STEPS`` eager steps
    on the warm-up stream, then captures; later decodes only replay.
    ``key`` is the decode's configuration; the decoder weights' identity
    is added here."""
    if device.type != "cuda":
        entry = _StepGraph(*make(), [])
        step = bind(entry)

        def eager():
            step()
            LOOP.eager_steps += 1

        _run(eager, lambda: stopped(entry.state), limit, every=every)
        return entry
    leaves = _decoder_leaves(params)
    key = key + (tuple(id(t) for t in leaves),)
    entry = _graph_entry(key, leaves)
    if entry is None:
        entry = _StepGraph(*make(), leaves)
    else:
        load(entry)
    step = bind(entry)
    done = 0
    if entry.graph is None and limit > 0:
        done = min(WARMUP_STEPS, limit)
        layout = partition.layout_of(params)
        warm_and_capture(entry, step, device, done,
                         None if layout is None else layout.group)
        _store(key, entry, leaves)
    _run(entry.replay, lambda: stopped(entry.state), limit, done, every)
    return entry


def _load_cross(static, params, cfg, enc_states, gen) -> None:
    """This decode's cross cache into a captured step's buffers: computed
    in place for float dh-minor caches, else built and copied."""
    if len(static) == 2 and not wmodel.cross_kv_t_major(cfg, static):
        wmodel.compute_cross_kv(params, cfg, enc_states, out=static)
        return
    for dst, src in zip(static, build_cross_kv(params, cfg, enc_states, gen)):
        dst.copy_(src)


@torch.inference_mode()
def _decode(params, cfg, enc_states, gen, max_len, prompt=None):
    """The greedy decode through ``run_decode``: tokens and lengths."""
    check_greedy_config(gen)
    batch, dev, dtype = enc_states.shape[0], enc_states.device, \
        enc_states.dtype

    heads = partition.local_model(params, cfg).decoder_heads

    def make():
        return (init_state(cfg, gen, batch, max_len, dtype, dev, heads),
                build_cross_kv(params, cfg, enc_states, gen),
                make_rules(cfg, gen, max_len, dev,
                           None if prompt is None else prompt.clone()))

    def load(entry):
        _load_cross(entry.cross_kv, params, cfg, enc_states, gen)
        if prompt is not None:
            entry.rules.prompt.copy_(prompt)

    def bind(entry):
        s, cross_kv, rules = entry.state, entry.cross_kv, entry.rules
        reset_state(s, cfg, rules)
        fused = wmodel.decode_step_plan(params, cfg, s.self_kv, cross_kv)
        return lambda: greedy_step(params, cfg, gen, s, cross_kv, rules,
                                   fused)

    key = ("greedy", cfg, gen, batch, max_len, dtype, dev,
           None if prompt is None else prompt.shape[1])
    s = run_decode(key, params, dev, max_len - 1, make, load, bind,
                   lambda s: bool(s.finished.all())).state
    return s.tokens.clone(), s.lengths.clone()


def greedy_decode(
    params: dict,
    cfg: WhisperConfig,
    enc_states: torch.Tensor,
    gen: Optional[GenerationConfig] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy (or sampled) search: enc_states (B, 1500, d) →
    (tokens (B, max_len) int32, lengths (B,) int32), ``max_len =
    min(max_target_positions, max_new_tokens + 1)``. Float caches take
    ``enc_states``' dtype; ``gen.kv_cache_dtype`` "int8"/"fp8" quantizes
    both caches, ``gen.cross_kv_layout`` sets the cross cache's layout, and
    every other non-beam field of ``gen`` applies as in the JAX loop."""
    gen = gen or GenerationConfig()
    max_len = min(cfg.max_target_positions, gen.max_new_tokens + 1)
    return _decode(params, cfg, enc_states, gen, max_len)


def greedy_decode_prompted(
    params: dict,
    cfg: WhisperConfig,
    enc_states: torch.Tensor,
    prompt,
    gen: Optional[GenerationConfig] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy/sampled decode seeded with a whole decoder prompt (B, P),
    e.g. [<|startofprev|>, ...previous text..., <|startoftranscript|>,
    lang, task]: the prompt is teacher-forced through the same step, the
    forced map is empty and ``begin_index`` is P. ``max_len = min(
    max_target_positions, max_new_tokens + P)``."""
    gen = gen or GenerationConfig()
    if gen.num_beams > 1:
        raise NotImplementedError(
            "greedy_decode_prompted is the single-beam loop; use "
            "runtime.beam.beam_decode_prompted for prompted beam search")
    prompt = to_tensor(prompt, enc_states.device, torch.int32)
    max_len = min(cfg.max_target_positions,
                  gen.max_new_tokens + prompt.shape[1])
    return _decode(params, cfg, enc_states, gen, max_len, prompt)


@torch.inference_mode()
def detect_language(
    params: dict,
    cfg: WhisperConfig,
    enc_states: torch.Tensor,
    lang_token_ids,
) -> torch.Tensor:
    """Language identification for multilingual checkpoints: one decode
    step from <|startoftranscript|>, argmax over the language tokens.
    Returns (B,) int32 ids drawn from ``lang_token_ids``."""
    dev = enc_states.device
    ids = torch.as_tensor(np.asarray(lang_token_ids, np.int64), device=dev)
    batch = enc_states.shape[0]
    cross_kv = wmodel.compute_cross_kv(params, cfg, enc_states)
    self_kv = wmodel.init_self_kv(
        cfg, batch, 2, dtype=enc_states.dtype, device=dev,
        heads=partition.local_model(params, cfg).decoder_heads)
    start = torch.full((batch,), cfg.decoder_start_token_id,
                       dtype=torch.int32, device=dev)
    logits, _ = wmodel.decode_step_kv(params, cfg, start, 0, self_kv,
                                      cross_kv)
    return ids[torch.argmax(logits[:, ids], dim=-1)].to(torch.int32)


@torch.inference_mode()
def transcribe_tokens(
    params: dict,
    cfg: WhisperConfig,
    mel,
    gen: Optional[GenerationConfig] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """mel (B, 3000, n_mels) → (tokens, lengths): encode + greedy decode on
    ``device`` (the CUDA card by default), where ``params`` must already
    lie. Inside a mesh (``with mesh:``) each data rank takes its rows of
    the batch (which the data axis must divide) and every rank returns the
    whole batch's tokens and lengths."""
    dev = resolve_device(device)
    set_fp32_precision()
    leaf = params["encoder"]["conv1"]["kernel"]
    if leaf.device.type != dev.type:
        raise ValueError(f"params lie on {leaf.device}, not on {dev}")
    mesh = current_mesh()
    check_data_axis(gen or GenerationConfig(), mesh)
    if not isinstance(mel, torch.Tensor):
        mel = np.asarray(mel)
    mel = to_tensor(split_batch(mel, mesh), dev, leaf.dtype)
    enc = wmodel.encode(params, cfg, mel)
    tokens, lengths = greedy_decode(params, cfg, enc, gen)
    return join_batch(tokens, mesh), join_batch(lengths, mesh)


def check_data_axis(gen: GenerationConfig, mesh) -> None:
    """Refuse a sampled decode with the batch cut over a data axis: its
    draw takes noise of the whole batch's shape, which a rank's rows would
    not reproduce."""
    sampled = (gen.temperature != 1.0 or gen.top_k > 0
               or 0.0 < gen.top_p < 1.0)
    if sampled and mesh is not None and axis_size(mesh, "data") > 1:
        raise NotImplementedError(
            "a sampled decode with the batch cut over a data axis is not "
            "ported; sample on a mesh without a data axis")
