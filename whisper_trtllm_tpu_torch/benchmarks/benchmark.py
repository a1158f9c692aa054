"""Benchmark CLI: latency and throughput grids over Whisper presets, batch
sizes and compute dtypes, on the card (counterpart of the JAX package's
``benchmarks/benchmark.py``, Whisper part).

Usage:
  python -m whisper_trtllm_tpu_torch.benchmarks.benchmark \
      --model tiny.en base.en --batch 1 8 --dtype float32 bfloat16 \
      [--gen-tokens 48] [--iters 10] [--checkpoint DIR]

Each configuration prints one JSON row: p50/p95/p99 latency, tokens/s and
audio-seconds/s of one ``WhisperSession.transcribe_features`` call on
random mels (EOS disabled, so every call decodes ``--gen-tokens`` steps),
the peak device memory over the timed calls, the launches of each kernel
over them, and the card's name and power limit. Float weights with float
KV caches at batch <= 16 run every decode layer as one fused launch (K6);
that is the only bench path that takes K6.

``--num-beams`` K > 1 runs the session's beam branch (K beams a
lane: decode steps at batch B·K, K6 while B·K <= 16); the row's
formulas stay the JAX row's, ``tokens_per_s`` counting the best
hypothesis' ``batch * gen_tokens``. Not ported yet, and refused with
``NotImplementedError``: the causal-LM zoo's names
(``allowed_configs.py``, ``bench_zoo``; ROADMAP Queue 1 item 11) and
``--quant`` (the zoo's weight-only modes). Without a card it exits
non-zero and prints no row.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from whisper_trtllm_tpu_torch.benchmarks.mem_monitor import MemoryMonitor
from whisper_trtllm_tpu_torch.config import (
    GenerationConfig,
    RuntimeConfig,
    WhisperConfig,
)
from whisper_trtllm_tpu_torch.models.whisper import init_params
from whisper_trtllm_tpu_torch.ops.kernels import KERNELS, reset_launch_counts
from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint


def card_info() -> dict:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them (its first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    name, power = out.stdout.strip().splitlines()[0].rsplit(", ", 1)
    return {"name": name, "power_limit": power}


def sync(device: torch.device) -> None:
    """Wait for the card's queued work: a host clock stopped before it
    measures the enqueue, not the work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_calls(fn, device: torch.device, iters: int, warmup: int = 1):
    """(the last call's result, the ms of each of ``iters`` calls of ``fn``
    after ``warmup`` untimed ones): every timed call runs between two syncs
    of ``device``, so the clock holds the card's work, not its enqueue."""
    out = None
    for _ in range(warmup):
        out = fn()
    times = []
    for _ in range(iters):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return out, times


def whisper_preset(model: str) -> WhisperConfig:
    """The Whisper preset named ``model``; any other name is one of the
    causal-LM zoo's, which is not ported yet."""
    try:
        return WhisperConfig.preset(model)
    except ValueError:
        raise NotImplementedError(
            f"{model!r} is not a Whisper preset; the causal-LM zoo "
            "(allowed_configs.py, bench_zoo) is not ported yet (ROADMAP "
            "Queue 1 item 11)") from None


def bench_config(model: str, batch: int, dtype: str, gen_tokens: int,
                 iters: int, checkpoint: str | None = None,
                 num_beams: int = 1, quant: str | None = None,
                 device=None) -> dict:
    """One row: ``iters`` timed ``transcribe_features`` calls after one
    warm-up call (which also builds the kernels), each ending in a sync on
    the card; ``device`` defaults to the card."""
    if quant is not None:
        raise NotImplementedError(
            "--quant selects the causal-LM zoo's weight-only modes; the zoo "
            "is not ported yet (ROADMAP Queue 1 item 11)")
    if checkpoint:
        params, cfg = load_checkpoint(checkpoint, device="cpu")
    else:
        cfg = whisper_preset(model)
        params = init_params(cfg, seed=0, device="cpu")
    # fixed decode length for a stable measurement (no EOS early exit)
    cfg = dataclasses.replace(cfg, eos_token_id=-1)
    sess = WhisperSession(
        params, cfg,
        GenerationConfig(max_new_tokens=gen_tokens, num_beams=num_beams),
        RuntimeConfig(compute_dtype=dtype), device=device)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal(
        (batch, 2 * cfg.max_source_positions, cfg.num_mel_bins)
    ).astype(np.float32)

    sess.transcribe_features(mel)  # warm-up: builds the kernels
    sync(sess.device)
    reset_launch_counts()
    mon = MemoryMonitor(sess.device).start()
    _, lats = timed_calls(lambda: sess.transcribe_features(mel), sess.device,
                          iters, warmup=0)
    peak_gib = mon.stop()
    launches = {k: f.launches for k, f in KERNELS.items() if f.launches}
    batch_s = float(np.median(lats)) / 1e3
    return {
        "peak_mem_gib": peak_gib,
        "model": model,
        "batch": batch,
        "dtype": dtype,
        "num_beams": num_beams,
        "gen_tokens": gen_tokens,
        "latency_ms_p50": float(np.percentile(lats, 50)),
        "latency_ms_p95": float(np.percentile(lats, 95)),
        "latency_ms_p99": float(np.percentile(lats, 99)),
        "tokens_per_s": batch * gen_tokens / batch_s,
        "audio_s_per_s": batch * 30.0 / batch_s,
        "backend": sess.device.type,
        "device": card_info() if sess.device.type == "cuda" else None,
        "iters": iters,
        "launches": launches,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", nargs="+", default=["tiny.en"],
                    help="Whisper presets (tiny.en, base.en, small.en, "
                         "medium.en, large-v3)")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--dtype", nargs="+", default=["float32"],
                    choices=["float32", "bfloat16"])
    ap.add_argument("--gen-tokens", type=int, default=48)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--num-beams", type=int, default=1)
    ap.add_argument("--quant", choices=["int8", "sq"], default=None,
                    help="weight-only modes of the causal-LM zoo (not "
                         "ported yet)")
    ap.add_argument("--checkpoint", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark: needs a CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    for model in args.model:
        for dtype in args.dtype:
            for batch in args.batch:
                row = bench_config(model, batch, dtype, args.gen_tokens,
                                   args.iters, args.checkpoint,
                                   args.num_beams, args.quant)
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
