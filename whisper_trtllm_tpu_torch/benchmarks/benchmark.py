"""Benchmark CLI: latency and throughput grids over Whisper presets and
the causal-LM zoo's named configurations, batch sizes and compute dtypes,
on the card (counterpart of the JAX package's ``benchmarks/benchmark.py``).

Usage:
  python -m whisper_trtllm_tpu_torch.benchmarks.benchmark \
      --model tiny.en base.en --batch 1 8 --dtype float32 bfloat16 \
      [--gen-tokens 48] [--iters 10] [--checkpoint DIR]
  python -m whisper_trtllm_tpu_torch.benchmarks.benchmark \
      --model gpt_350m --batch 4 --in-len 32 --gen-tokens 48 [--quant int8]

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
hypothesis' ``batch * gen_tokens``.

A zoo name (``allowed_configs.py``) runs ``bench_zoo``: the family's
``generate`` over random prompts of ``--in-len`` tokens with EOS
disabled, tokens/s over ``batch * gen_tokens``, with ``--quant int8``
the weight-only int8 tree (``chatglm_6b`` through GLM's own ``generate``,
its [gMASK] at the prompt's second-to-last position); a BERT name
(``bert_base``, ``bert_large``, ``bert_tiny``) runs the encoder's
``forward`` over the same prompts, its row the JAX row's
``tokens_encoded_per_s`` over ``batch * in_len`` and ``sequences_per_s``.
Not ported yet, and refused with ``NotImplementedError`` naming ROADMAP
Queue 1 item 11.6: ``--quant sq`` (SmoothQuant for GPT).
Without a card it exits non-zero and prints no row.
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

from whisper_trtllm_tpu_torch.benchmarks.allowed_configs import (
    ALLOWED_CONFIGS,
    build_model,
)
from whisper_trtllm_tpu_torch.benchmarks.mem_monitor import MemoryMonitor
from whisper_trtllm_tpu_torch.config import (
    GenerationConfig,
    RuntimeConfig,
    WhisperConfig,
)
from whisper_trtllm_tpu_torch.models.whisper import init_params
from whisper_trtllm_tpu_torch.ops.kernels import KERNELS, reset_launch_counts
from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
from whisper_trtllm_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    params_from_numpy,
)
from whisper_trtllm_tpu_torch.utils.device import resolve_device


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
    """The Whisper preset named ``model``; a zoo name raises, pointing to
    ``bench_zoo``."""
    if model in ALLOWED_CONFIGS:
        raise ValueError(f"{model!r} is a causal-LM zoo name: bench_zoo "
                         "runs it, bench_config runs Whisper presets")
    return WhisperConfig.preset(model)


def bench_config(model: str, batch: int, dtype: str, gen_tokens: int,
                 iters: int, checkpoint: str | None = None,
                 num_beams: int = 1, quant: str | None = None,
                 device=None) -> dict:
    """One row: ``iters`` timed ``transcribe_features`` calls after one
    warm-up call (which also builds the kernels), each ending in a sync on
    the card; ``device`` defaults to the card."""
    if quant is not None:
        raise ValueError("--quant selects the causal-LM zoo's weight modes "
                         "(bench_zoo), not a Whisper row's")
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


def bench_zoo(name: str, batch: int, in_len: int, out_len: int, dtype: str,
              iters: int, quant: str | None = None, device=None) -> dict:
    """One row of a named zoo configuration: ``iters`` timed ``generate``
    calls (BERT's: ``forward`` calls) after one warm-up call (which builds
    the kernels and captures the step), each between two syncs of
    ``device`` (the card by default). Batch, input and output lengths are
    cut to the entry's limits; EOS is disabled, so every call runs
    ``out_len`` steps. Weights from
    ``init_params(seed=0)`` on the host, ``--quant int8`` through the
    port's ``weight_only_quantize``, cast to ``dtype``."""
    from whisper_trtllm_tpu_torch.quantization import weight_only_quantize

    entry = ALLOWED_CONFIGS[name]
    fam, cfg, init_params_fn, generate, forward = build_model(name)
    if quant == "sq":
        raise NotImplementedError(
            "--quant sq needs smooth_quantize_gpt, not ported yet (ROADMAP "
            "Queue 1 item 11.6)")
    if quant not in (None, "int8"):
        raise ValueError(f"--quant is int8 or sq, got {quant!r}")
    dev = resolve_device(device)
    batch = min(batch, entry.max_batch_size)
    in_len = min(in_len, entry.max_input_len)
    out_len = min(out_len, entry.max_output_len)
    params = init_params_fn(cfg, seed=0, device="cpu")
    if quant == "int8":
        params = weight_only_quantize(params)
    params = params_from_numpy(
        params, dev, torch.bfloat16 if dtype == "bfloat16" else None)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        3, cfg.vocab_size, (batch, in_len)).astype(np.int32)).to(dev)
    if fam == "bert":
        def run():
            return forward(params, cfg, tokens)[0]
        work_tokens = batch * in_len
    else:
        # EOS disabled for a stable measurement (random weights)
        cfg = dataclasses.replace(cfg, eos_token_id=-1)

        def run():
            return generate(params, cfg, tokens, max_new_tokens=out_len,
                            device=dev)
        work_tokens = batch * out_len

    run()  # warm-up: builds the kernels, captures the step
    sync(dev)
    reset_launch_counts()
    mon = MemoryMonitor(dev).start()
    _, lats = timed_calls(run, dev, iters, warmup=0)
    peak_gib = mon.stop()
    med_s = float(np.median(lats)) / 1e3
    row = {
        "peak_mem_gib": peak_gib,
        "model": name,
        "family": fam,
        "batch": batch,
        "input_len": in_len,
        "output_len": out_len,
        "dtype": dtype,
        "quant": quant,
        "latency_ms_p50": float(np.percentile(lats, 50)),
        "latency_ms_p95": float(np.percentile(lats, 95)),
        "latency_ms_p99": float(np.percentile(lats, 99)),
        "tokens_per_s" if fam != "bert" else "tokens_encoded_per_s":
            work_tokens / med_s,
        "backend": dev.type,
        "device": card_info() if dev.type == "cuda" else None,
        "iters": iters,
        "launches": {k: f.launches for k, f in KERNELS.items()
                     if f.launches},
    }
    if fam == "bert":
        row["sequences_per_s"] = batch / med_s
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", nargs="+", default=["tiny.en"],
                    help="Whisper presets (tiny.en, base.en, small.en, "
                         "medium.en, large-v3) or zoo names from "
                         "allowed_configs.py (gpt_350m, opt_350m, llama_7b, "
                         "chatglm_6b, ...)")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--dtype", nargs="+", default=["float32"],
                    choices=["float32", "bfloat16"])
    ap.add_argument("--gen-tokens", type=int, default=48)
    ap.add_argument("--in-len", type=int, default=32,
                    help="prompt length of a zoo row")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--num-beams", type=int, default=1)
    ap.add_argument("--quant", choices=["int8", "sq"], default=None,
                    help="a zoo row's weights: weight-only int8 (sq, "
                         "SmoothQuant, is not ported yet)")
    ap.add_argument("--checkpoint", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark: needs a CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    for model in args.model:
        for dtype in args.dtype:
            for batch in args.batch:
                if model in ALLOWED_CONFIGS:
                    row = bench_zoo(model, batch, args.in_len,
                                    args.gen_tokens, dtype, args.iters,
                                    args.quant)
                else:
                    row = bench_config(model, batch, dtype, args.gen_tokens,
                                       args.iters, args.checkpoint,
                                       args.num_beams, args.quant)
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
