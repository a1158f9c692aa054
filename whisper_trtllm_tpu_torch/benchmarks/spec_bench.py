"""Speculative decoding against greedy, batch 1 (counterpart of the
repository's ``scripts/spec_bench.py``).

Per gamma: the mean acceptance rate, accepted tokens a round, and ms an
utterance at batch 1 against the target's plain greedy decode over the
same utterances, with the count of utterances whose tokens equal
greedy's. Every utterance is timed between two syncs of the card, and
both paths fetch each utterance's tokens to the host in one copy.

  python -m whisper_trtllm_tpu_torch.benchmarks.spec_bench \\
      --target DIR --draft DIR --wav-dir DIR [--utts 16] \\
      [--gammas 2,4,6] [--max-new-tokens 96] [--dtype bfloat16] \\
      [--device cuda]

Prints one JSON line for greedy, then one a gamma. Without a CUDA card it
raises unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from whisper_trtllm_tpu_torch.audio import pad_or_trim, read_wav
from whisper_trtllm_tpu_torch.audio.features import LogMelSpectrogram
from whisper_trtllm_tpu_torch.benchmarks.benchmark import sync
from whisper_trtllm_tpu_torch.config import GenerationConfig
from whisper_trtllm_tpu_torch.models.whisper import cast_params
from whisper_trtllm_tpu_torch.runtime.generation import transcribe_tokens
from whisper_trtllm_tpu_torch.runtime.speculative import (
    speculative_transcribe_tokens,
)
from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
from whisper_trtllm_tpu_torch.utils.device import resolve_device


def load_mels(path: str, n_mels: int, limit: int, dtype, device):
    """The first ``limit`` WAVs of ``path`` (sorted), each padded to 30 s,
    as (1, 3000, n_mels) mels on ``device``."""
    frontend = LogMelSpectrogram(n_mels, device=device)
    wavs = sorted(pathlib.Path(path).glob("*.wav"))[:limit]
    return [frontend(pad_or_trim(read_wav(str(w)))[None]).to(dtype)
            for w in wavs]


def fetch(*tensors) -> np.ndarray:
    """The tensors flattened into one int32 vector, copied to the host
    once (the completion barrier of an utterance)."""
    return torch.cat([t.reshape(-1).to(torch.int32)
                      for t in tensors]).cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--target", required=True)
    ap.add_argument("--draft", required=True)
    ap.add_argument("--wav-dir", required=True)
    ap.add_argument("--utts", type=int, default=16)
    ap.add_argument("--gammas", default="2,4,6")
    ap.add_argument("--max-new-tokens", type=int, default=96)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    t_params, t_cfg = load_checkpoint(args.target, device=dev)
    d_params, d_cfg = load_checkpoint(args.draft, device=dev)
    if dtype != torch.float32:
        t_params = cast_params(t_params, dtype)
        d_params = cast_params(d_params, dtype)
    mels = load_mels(args.wav_dir, t_cfg.num_mel_bins, args.utts, dtype, dev)
    if not mels:
        raise FileNotFoundError(f"no .wav files in {args.wav_dir}")
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens)

    def greedy(m):
        toks, lens = transcribe_tokens(t_params, t_cfg, m, gen, device=dev)
        return fetch(lens, toks)

    def spec(m, gamma):
        out = speculative_transcribe_tokens(t_params, t_cfg, d_params, d_cfg,
                                            m, gen, gamma=gamma,
                                            with_stats=True, device=dev)
        return fetch(out[1], out[2], out[3], out[0])

    greedy(mels[0])                               # capture, warm up
    glens, gtoks, g_ms = [], [], 0.0
    for m in mels:
        sync(dev)
        t0 = time.perf_counter()
        host = greedy(m)
        sync(dev)
        g_ms += (time.perf_counter() - t0) * 1e3
        glens.append(int(host[0]))
        gtoks.append(host[1:1 + glens[-1]])
    g_ms /= len(mels)
    print(json.dumps({"mode": "greedy", "utts": len(mels),
                      "ms_per_utt": g_ms,
                      "mean_len": float(np.mean(glens)),
                      "dtype": args.dtype}), flush=True)

    for gamma in [int(g) for g in args.gammas.split(",")]:
        spec(mels[0], gamma)                      # capture, warm up
        acc_tok = acc_rounds = exact = 0
        lens, ms = [], 0.0
        for i, m in enumerate(mels):
            sync(dev)
            t0 = time.perf_counter()
            host = spec(m, gamma)
            sync(dev)
            ms += (time.perf_counter() - t0) * 1e3
            length, rounds, accepted = (int(x) for x in host[:3])
            toks = host[3:3 + length]
            lens.append(length)
            acc_tok += accepted
            acc_rounds += rounds
            exact += int(length == glens[i]
                         and np.array_equal(toks, gtoks[i]))
        ms /= len(mels)
        print(json.dumps({
            "mode": f"speculative_g{gamma}", "utts": len(mels),
            "ms_per_utt": ms, "speedup_vs_greedy": g_ms / ms,
            "acceptance_rate": acc_tok / max(gamma * acc_rounds, 1),
            "accepted_per_round": acc_tok / max(acc_rounds, 1),
            "rounds_per_utt": acc_rounds / len(mels),
            "mean_len": float(np.mean(lens)),
            "token_exact_vs_greedy": exact,
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
