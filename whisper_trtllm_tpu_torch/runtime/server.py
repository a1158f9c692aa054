"""Serving loops (counterpart of ``whisper_trtllm_tpu/runtime/server.py``):
clients submit raw audio, a scheduler thread calls ``step()``, results are
fetched by request id. Three backends with one submit/step/fetch/pending
surface:

- ``TranscriptionServer``: the native slot manager (``cpp/``) packs waiting
  requests into ``num_slots`` fixed lanes, one ``WhisperSession.transcribe``
  serves the batch;
- ``IfbTranscriptionServer``: the token-level ``InflightBatcher``, a
  finished lane refilled mid-decode;
- ``ScheduledTranscriptionServer``: the native batch scheduler decides when
  to launch and which requests ride together (priorities, allowed batch
  sizes, a tail-latency guard, deadlines; ``EXPIRED`` marks a request whose
  deadline passed), with ``stats()`` of its queue.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from whisper_trtllm_tpu_torch.runtime.session import WhisperSession


class TranscriptionServer:
    def __init__(self, session: WhisperSession, num_slots: int = 8,
                 max_samples: int = 480000):
        from whisper_trtllm_tpu_torch.native import NativeSlotManager

        self.session = session
        self.slots = NativeSlotManager(num_slots, max_samples)

    def submit(self, audio: np.ndarray) -> int:
        """Enqueue one utterance (float32 16 kHz); returns request id."""
        return self.slots.submit(audio)

    def step(self) -> int:
        """One scheduling round: fill slots, run the batch, complete slots.
        Returns the number of requests served."""
        ids, audio, active = self.slots.schedule()
        if active == 0:
            return 0
        tokens, lengths = self.session.transcribe(audio)
        for s in range(self.slots.num_slots):
            if ids[s] >= 0:
                self.slots.complete(s, tokens[s, : lengths[s]])
        return active

    def fetch(self, request_id: int) -> Optional[np.ndarray]:
        return self.slots.fetch(request_id)

    def run_until_drained(self, max_rounds: int = 1000) -> None:
        for _ in range(max_rounds):
            if self.step() == 0 and self.slots.pending == 0:
                return

    @property
    def pending(self) -> int:
        return int(self.slots.pending)


class IfbTranscriptionServer:
    """Serving loop over the token-level InflightBatcher: a finished lane is
    refilled mid-decode without waiting for its batch neighbours. Same
    submit/step/fetch surface as TranscriptionServer, so cli/serve.py can
    swap backends. ``device``: the batcher's (the CUDA card by default)."""

    def __init__(self, params, cfg, generation=None, num_slots: int = 8,
                 segment_steps: int = 16, device=None):
        import threading

        from whisper_trtllm_tpu_torch.runtime.ifb import InflightBatcher

        # on the card the batcher captures its step here, before any
        # request: no handler thread runs while it captures
        self.batcher = InflightBatcher(
            params, cfg, generation, num_lanes=num_slots,
            segment_steps=segment_steps, device=device,
        )
        # the batcher's host state is not thread-safe; serialize the
        # scheduler thread against handler submits/fetches
        self._lock = threading.Lock()

    def submit(self, audio: np.ndarray) -> int:
        # the frontend outside the lock: holding the scheduler's lock across
        # it would queue every concurrent client behind the decode loop
        mel = self.batcher.compute_mel(audio)
        with self._lock:
            return self.batcher.submit(mel)

    def step(self) -> int:
        with self._lock:
            self.batcher._retire_and_admit()
            active = sum(1 for r in self.batcher._lane_req if r is not None)
            if active:
                # _dispatch_segment advances the batcher's segment counter
                # (the retire epoch guard) and queues the encodes of
                # waiting requests behind the segment
                self.batcher._dispatch_segment()
            return active

    def fetch(self, request_id: int):
        with self._lock:
            return self.batcher.fetch(request_id)

    @property
    def pending(self) -> int:
        return len(self.batcher._queue)


class ScheduledTranscriptionServer:
    """Policy-scheduled lockstep serving: the native BatchScheduler decides
    WHEN to launch and WHICH requests ride together (priority ordering,
    allowed-batch-size launch policy, tail-latency guard, deadline expiry)
    — the batch-forming role of a batch manager. Launched batches pad up
    to the nearest allowed size, so the session's decode only ever meets
    the batch sizes whose steps it has captured."""

    def __init__(self, session: WhisperSession,
                 allowed_batch_sizes=(1, 2, 4, 8), max_wait_ms: int = 20,
                 max_samples: int = 480000):
        import threading

        from whisper_trtllm_tpu_torch.native.lib import NativeBatchScheduler

        self.session = session
        self.sizes = tuple(sorted(allowed_batch_sizes))
        self.max_samples = max_samples
        self.max_wait_ms = max_wait_ms
        self.sched = NativeBatchScheduler(self.sizes, max_wait_ms)
        self._lock = threading.Lock()
        self._next_id = 1
        self._payloads: dict = {}
        self._results: dict = {}

    EXPIRED = "expired"

    def submit(self, audio: np.ndarray, priority: int = 0,
               timeout_ms: int = 0) -> int:
        audio = np.asarray(audio, np.float32)[: self.max_samples]
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self._payloads[rid] = audio
        self.sched.submit(rid, priority, timeout_ms)
        return rid

    def step(self) -> int:
        """One scheduling round. Returns requests served (0 = policy chose
        to wait)."""
        batch, expired = self.sched.poll()
        with self._lock:
            for rid in expired:
                self._payloads.pop(int(rid), None)
                self._results[int(rid)] = self.EXPIRED
            if len(batch) == 0:
                return 0
            audios = [self._payloads.pop(int(r)) for r in batch]
        n = len(audios)
        padded = next(s for s in self.sizes if s >= n)
        mat = np.zeros((padded, self.max_samples), np.float32)
        for i, a in enumerate(audios):
            mat[i, : len(a)] = a
        tokens, lengths = self.session.transcribe(mat)
        with self._lock:
            for i, rid in enumerate(batch):
                self._results[int(rid)] = np.asarray(
                    tokens[i, : lengths[i]])
        return n

    def fetch(self, request_id: int):
        """Tokens, the EXPIRED sentinel, or None (not finished)."""
        with self._lock:
            return self._results.pop(request_id, None)

    def run_until_drained(self, max_rounds: int = 1000) -> None:
        """Drive steps until the queue empties. An empty step with work
        still pending means the tail-latency guard hasn't fired yet — sleep
        a fraction of it instead of busy-spinning the rounds away (a
        max_wait_ms guard can otherwise outlive max_rounds of instant
        polls, returning with requests still queued)."""
        import time

        for _ in range(max_rounds):
            served = self.step()
            if served == 0:
                if self.pending == 0:
                    return
                time.sleep(max(self.max_wait_ms / 5, 1) / 1000.0)

    @property
    def pending(self) -> int:
        return int(self.sched.pending)

    def stats(self) -> dict:
        return self.sched.stats()
