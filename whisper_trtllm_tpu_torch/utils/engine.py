"""Serialized engines: the transcribe pipeline, greedy or beam search, as
``torch.export`` programs in one file (counterpart of
``whisper_trtllm_tpu/utils/engine.py``, which serializes one jitted
pipeline with ``jax.export``).

An engine file is a zip holding

- ``encode.pt2``: (params, mel) → (encoder states, the cross cache, the
  decode's first state), the cross cache built and quantized as the
  session builds it (tiled K times for a beam search);
- ``step.pt2``: (params, state, cross cache, rules) → the state's
  ``finished`` (greedy: one ``runtime/generation.py::greedy_step``) or
  ``go`` (``num_beams > 1``: one ``runtime/beam.py::beam_step``), which
  updates the state's tensors in place;
- ``finalize.pt2`` (beam search only): the state's pools → the best
  hypothesis's tokens and lengths (``beam.finalize``), which the
  session's beam decode returns;
- ``rules.pt``: the step's processor tables (suppress masks, the forced
  map, word tables);
- ``meta.json``: batch, ``max_len``, ``num_beams``, dtypes, the
  finish-check period, the warm-up steps before a capture and the
  ``kernel_tree_digest`` of the sources it was exported from.

A format-1 file (greedy only, written before beam search was exported)
loads and runs as a greedy engine.

Weights are an argument of both programs, so one engine serves any tree
of the same structure (the refit of a TensorRT engine). Loading and
running an engine needs this module and the kernels' operator
registrations (``ops/kernels``: ``torch.ops.wtpu.*``), not the model code.
On the card the exported programs call K1, K2, K5 and K6 through those
operators, which launch what the session's wrappers launch; on the CPU
the programs hold the plain versions they were traced through.

``Engine.__call__`` runs the loop itself, as ``generation._run`` does:
the host reads ``finished`` (a beam search: ``go``) once every
``finish_check_every`` steps. On
the card it runs ``warmup_steps`` eager steps on a side stream, captures
the step once as a CUDA graph against its own buffers, and replays it; a
later call with the same weights only replays. A capture that fails
raises; nothing falls back to eager steps.
"""

from __future__ import annotations

import io
import json
import os
import weakref
import zipfile
from typing import Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

# importing the kernels registers torch.ops.wtpu.*, which the programs call
from whisper_trtllm_tpu_torch.ops.kernels import KERNELS, _launches

FORMAT = 2
READS = (1, 2)  # the formats load_engine reads
_ENCODE, _STEP, _FINALIZE, _RULES, _META = (
    "encode.pt2", "step.pt2", "finalize.pt2", "rules.pt", "meta.json")
# positions in a greedy state tuple: tokens, pos, finished, lengths, then
# the self caches
TOKENS, FINISHED, LENGTHS = 0, 2, 3
# a beam state's fields before its self caches (runtime/export.py::
# BEAM_FIELDS), and the position of ``go`` among them
BEAM_STATE_FIELDS, GO = 9, 8


def canonical(params):
    """``params`` with every dict's keys in sorted order (the same tensor
    objects): the order both programs are exported and called with, so a
    tree built in another key order still fits."""
    if isinstance(params, dict):
        return {k: canonical(params[k]) for k in sorted(params)}
    return params


def _to_bytes(save, obj) -> bytes:
    buf = io.BytesIO()
    save(obj, buf)
    return buf.getvalue()


def save_engine(path: str, encode: torch.export.ExportedProgram,
                step: torch.export.ExportedProgram, rules: dict,
                meta: dict, finalize=None) -> int:
    """Write the exported ``encode`` (params, mel) and ``step`` (params,
    state, cross cache, rules) programs, the beam search's ``finalize``
    (state fields) where given, ``rules`` and ``meta`` to one file.
    Returns the file's size in bytes."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        z.writestr(_ENCODE, _to_bytes(torch.export.save, encode))
        z.writestr(_STEP, _to_bytes(torch.export.save, step))
        if finalize is not None:
            z.writestr(_FINALIZE, _to_bytes(torch.export.save, finalize))
        z.writestr(_RULES, _to_bytes(
            torch.save, pytree.tree_map(lambda t: t.cpu(), rules)))
        z.writestr(_META, json.dumps(dict(meta, format=FORMAT), indent=1))
    blob = buf.getvalue()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


class _Captured:
    """The step captured against its own state and cross-cache buffers
    and weak references to the weights it reads; the launches one replay
    makes."""

    def __init__(self, leaves: list, state: tuple, cross: tuple):
        self.refs = [weakref.ref(t) for t in leaves]
        self.state = state
        self.cross = cross
        self.graph = None
        self.launches = {}

    def matches(self, leaves: list) -> bool:
        return len(leaves) == len(self.refs) and all(
            r() is t for r, t in zip(self.refs, leaves))

    def capture(self, step) -> None:
        self.graph, self.launches = _launches.capture(step, KERNELS)

    def replay(self) -> None:
        self.graph.replay()
        _launches.replayed(self.launches, KERNELS)


class Engine:
    """A loaded engine: ``engine(params, mel)`` → (tokens (B, max_len)
    int32, lengths (B,) int32) on the weights' device, as
    ``WhisperSession.transcribe_features`` decodes them (a beam search's
    best hypothesis). ``captures``, ``replays`` and ``eager_steps`` count
    what its loop did."""

    def __init__(self, encode, step, rules: dict, meta: dict,
                 finalize=None):
        self.meta = dict(meta)
        self.meta.setdefault("num_beams", 1)  # format 1: greedy
        if (self.meta["num_beams"] > 1) != (finalize is not None):
            raise ValueError("a beam engine has a finalize program and a "
                             "greedy engine none")
        self._encode = encode.module()
        self._step = step.module()
        self._finalize = None if finalize is None else finalize.module()
        self._rules = rules
        self._rules_on: dict = {}
        self._captured = None
        self._side = None
        self.captures = self.replays = self.eager_steps = 0

    @property
    def batch(self) -> int:
        return self.meta["batch"]

    def _rules_for(self, device: torch.device):
        rules = self._rules_on.get(device)
        if rules is None:
            rules = self._rules_on[device] = pytree.tree_map(
                lambda t: t.to(device), self._rules)
        return rules

    def _stopped(self, state: tuple) -> bool:
        """The host's read: every lane finished (greedy), or the beam
        search's ``go`` False."""
        if self.meta["num_beams"] > 1:
            return not bool(state[GO])
        return bool(state[FINISHED].all())

    def _run(self, step, state: tuple, limit: int, done: int = 0) -> None:
        """``generation._run``'s schedule: ``step()`` until ``limit``
        steps ran, the host reading ``_stopped`` once every
        ``finish_check_every`` steps."""
        every = self.meta["finish_check_every"]
        while done < limit:
            if done and self._stopped(state):
                return
            n = min(every, limit - done)
            for _ in range(n):
                step()
            done += n

    def _decode_captured(self, params: dict, state: tuple, cross: tuple,
                         rules: dict, limit: int) -> tuple:
        leaves = pytree.tree_leaves(params)
        entry = self._captured
        done = 0
        if entry is not None and entry.matches(leaves):
            for dst, src in zip(entry.state + entry.cross, state + cross):
                dst.copy_(src)
        else:
            # one captured step an engine: another tree captures anew
            self._captured = None
            entry = _Captured(leaves, state, cross)

            def step():
                self._step(params, entry.state, entry.cross, rules)

            done = min(self.meta["warmup_steps"], limit)
            dev = state[TOKENS].device
            if self._side is None:
                # one warm-up stream an engine: cuBLAS keeps a workspace for
                # every stream it runs on
                self._side = torch.cuda.Stream(dev)
            side = self._side
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(done):
                    step()
            torch.cuda.current_stream(dev).wait_stream(side)
            self.eager_steps += done
            entry.capture(step)
            self.captures += 1
            self._captured = entry

        def replay():
            entry.replay()
            self.replays += 1

        self._run(replay, entry.state, limit, done)
        return entry.state

    def __call__(self, params: dict, mel) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        params = canonical(params)
        dev = pytree.tree_leaves(params)[0].device
        dtype = getattr(torch, self.meta["dtype"])
        if not isinstance(mel, torch.Tensor):
            mel = torch.from_numpy(np.array(mel))
        mel = mel.to(device=dev, dtype=dtype)
        if mel.shape[0] != self.batch:
            raise ValueError(f"this engine was exported at batch "
                             f"{self.batch}; got a mel of batch "
                             f"{mel.shape[0]}")
        limit = self.meta["max_len"] - 1
        with torch.no_grad():
            _, cross, state = self._encode(params, mel)
            rules = self._rules_for(dev)
            if dev.type == "cuda":
                state = self._decode_captured(params, tuple(state),
                                              tuple(cross), rules, limit)
            else:
                def step():
                    self._step(params, state, cross, rules)
                    self.eager_steps += 1

                self._run(step, state, limit)
            if self._finalize is not None:
                return self._finalize(tuple(state[:BEAM_STATE_FIELDS]))
            return state[TOKENS].clone(), state[LENGTHS].clone()


def load_engine(path: str) -> Engine:
    """Read an engine file written by ``save_engine``."""
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read(_META))
        if meta.get("format") not in READS:
            raise ValueError(f"{path}: engine format {meta.get('format')}, "
                             f"this reader takes {READS}")
        encode = torch.export.load(io.BytesIO(z.read(_ENCODE)))
        step = torch.export.load(io.BytesIO(z.read(_STEP)))
        finalize = (torch.export.load(io.BytesIO(z.read(_FINALIZE)))
                    if _FINALIZE in z.namelist() else None)
        rules = torch.load(io.BytesIO(z.read(_RULES)), weights_only=True)
    return Engine(encode, step, rules, meta, finalize)
