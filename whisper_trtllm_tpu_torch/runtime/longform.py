"""Long-form audio (counterpart of ``whisper_trtllm_tpu/runtime/longform.py``):
30 s windows cut on the host, batched through a ``WhisperSession``, and the
per-chunk token streams returned; or, conditioned, each chunk's decoder
seeded with the previous chunk's text (greedy, or the beam search with
``num_beams > 1``). Per-chunk outputs are numpy int32 arrays, specials
stripped."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from whisper_trtllm_tpu_torch.audio.features import N_SAMPLES, SAMPLE_RATE
from whisper_trtllm_tpu_torch.runtime import beam
from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
from whisper_trtllm_tpu_torch.runtime.session import WhisperSession


def chunk_audio(
    audio: np.ndarray,
    chunk_samples: int = N_SAMPLES,
    overlap_seconds: float = 0.0,
) -> np.ndarray:
    """(n,) → (num_chunks, chunk_samples) float32, the tail zero-padded; a
    window wholly covered by the previous one is dropped."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    stride = chunk_samples - int(overlap_seconds * SAMPLE_RATE)
    if stride <= 0:
        raise ValueError(f"overlap_seconds {overlap_seconds} leaves no "
                         f"stride for chunks of {chunk_samples} samples")
    n = len(audio)
    starts = list(range(0, max(n, 1), stride))
    while len(starts) > 1 and starts[-1] >= n:
        starts.pop()
    chunks = np.zeros((len(starts), chunk_samples), np.float32)
    for i, s in enumerate(starts):
        seg = audio[s: s + chunk_samples]
        chunks[i, : len(seg)] = seg
    return chunks


def transcribe_long(
    session: WhisperSession,
    audio: np.ndarray,
    batch: int = 8,
    overlap_seconds: float = 0.0,
) -> Tuple[List[np.ndarray], int]:
    """Transcribe audio of any length: (per-chunk token ids without the
    start token, EOS, pad and the forced prefix, the number of chunks).
    The chunks ride through ``session.transcribe`` in batches of
    ``batch``, the last one padded with silence, so one captured decode
    step serves any duration."""
    cfg = session.cfg
    chunks = chunk_audio(audio, overlap_seconds=overlap_seconds)
    forced = {t for _, t in cfg.forced_decoder_ids}
    outs: List[np.ndarray] = []
    for i in range(0, len(chunks), batch):
        cb = chunks[i: i + batch]
        real = len(cb)
        if real < batch:
            cb = np.concatenate(
                [cb, np.zeros((batch - real, cb.shape[1]), np.float32)])
        tokens, lengths = session.transcribe(cb)
        for b in range(real):
            ids = tokens[b, 1: lengths[b]]
            ids = ids[(ids != cfg.eos_token_id) & (ids != cfg.pad_token_id)]
            outs.append(np.asarray([t for t in ids if int(t) not in forced],
                                   np.int32))
    return outs, len(chunks)


def transcribe_long_conditioned(
    session: WhisperSession,
    audio: np.ndarray,
    prev_sot_token_id: int,
    prev_context_tokens: int = 16,
    overlap_seconds: float = 0.0,
) -> Tuple[List[np.ndarray], int]:
    """Long-form with previous-text conditioning: each chunk's decoder is
    seeded with [<|startofprev|>, the previous chunk's last N text tokens,
    <|startoftranscript|>, the forced ids] (HF condition_on_prev_tokens).
    Chunks run one after another, since chunk i + 1's prompt needs chunk
    i's text; the window is a fixed N, so one captured step serves every
    conditioned chunk. A chunk whose predecessor gave fewer than N tokens
    decodes unprompted."""
    chunks = chunk_audio(audio, overlap_seconds=overlap_seconds)
    with torch.inference_mode():
        mels = session.frontend(chunks)
    return _conditioned_over_features(session, mels, prev_sot_token_id,
                                      prev_context_tokens)


def _conditioned_over_features(session: WhisperSession, mels,
                               prev_sot_token_id: int,
                               prev_context_tokens: int
                               ) -> Tuple[List[np.ndarray], int]:
    """``transcribe_long_conditioned`` over mels (n, 3000, n_mels)."""
    cfg, gen = session.cfg, session.generation
    forced = [cfg.decoder_start_token_id] + [
        t for _, t in sorted(cfg.forced_decoder_ids)]
    specials = {cfg.eos_token_id, cfg.pad_token_id,
                cfg.decoder_start_token_id, prev_sot_token_id,
                *[t for _, t in cfg.forced_decoder_ids]}
    beams = gen.num_beams > 1
    outs: List[np.ndarray] = []
    prev_text: List[int] = []
    for i in range(len(mels)):
        enc = session.encode(mels[i: i + 1])
        if len(prev_text) >= prev_context_tokens:
            ctx = prev_text[-prev_context_tokens:]
            prompt = np.asarray([[prev_sot_token_id, *ctx, *forced]],
                                np.int32)
            if beams:
                t, _, ln = beam.beam_decode_prompted(session.params, cfg, enc,
                                                     prompt, gen)
                tokens, lengths = t[:, 0], ln[:, 0]
            else:
                tokens, lengths = gen_rt.greedy_decode_prompted(
                    session.params, cfg, enc, prompt, gen)
            start = prompt.shape[1]
        else:
            if beams:
                t, _, ln = beam.beam_decode(session.params, cfg, enc, gen)
                tokens, lengths = t[:, 0], ln[:, 0]
            else:
                tokens, lengths = gen_rt.greedy_decode(session.params, cfg,
                                                       enc, gen)
            start = 1
        toks = tokens[0, : int(lengths[0])].cpu().numpy()
        text_ids = np.asarray(
            [t for t in toks[start:] if int(t) not in specials], np.int32)
        outs.append(text_ids)
        prev_text = [int(t) for t in text_ids]
    return outs, len(mels)
