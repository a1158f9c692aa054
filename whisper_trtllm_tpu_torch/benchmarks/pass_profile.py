#!/usr/bin/env python3
"""The bench's headline pass, profiled, for one checkout of the port: the
session and pass of ``cli/bench.py`` (tiny.en from ``init_params(seed=0)``,
EOS disabled, 48 tokens, bf16, three batches of 32 utterances of 30 s,
audio through the frontend), with int8 KV (the headline) and with bf16 KV.
For each: one warm-up pass; three untraced passes (median, min..max);
one batch's greedy decode timed alone (median of 3, and per step); one
pass under ``torch.profiler``, whose device busy time over the median
untraced pass is the card's idle share; the peak device memory over the
untraced passes. Prints one JSON line.

It is run by path, so that ``--root`` chooses the checkout whose package
is imported (this one by default, or an earlier commit unpacked in a
directory), and two commits can be timed in turns in one call:

    python3 whisper_trtllm_tpu_torch/benchmarks/pass_profile.py [--root DIR]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def profile_kv(torch, kv: str) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from whisper_trtllm_tpu_torch.benchmarks.benchmark import timed_calls
    from whisper_trtllm_tpu_torch.cli import bench
    from whisper_trtllm_tpu_torch.config import WhisperConfig
    from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
    from whisper_trtllm_tpu_torch.utils.profile_transcribe import _device_us

    import numpy as np

    dev = torch.device("cuda")
    cfg = WhisperConfig.tiny_en()
    rng = np.random.default_rng(0)
    audio = [torch.from_numpy(
        rng.standard_normal((bench.BATCH, bench.N_SAMPLES)).astype(np.float32)
        * np.float32(0.1)).to(dev) for _ in range(bench.N_BATCHES)]
    session = bench.bench_session(cfg, kv, "bfloat16", device=dev)

    def one_pass():
        return bench.run_pass(session, audio, frontend=True)

    one_pass()
    torch.cuda.reset_peak_memory_stats(dev)
    _, pass_ms = timed_calls(one_pass, dev, 3, warmup=0)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    with torch.inference_mode():
        enc = session.encode(session.frontend(audio[0]))
    _, dec_ms = timed_calls(lambda: gen_rt.greedy_decode(
        session.params, session.cfg, enc, session.generation), dev, 3,
        warmup=0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, traced = timed_calls(one_pass, dev, 1, warmup=0)
    busy = sum(_device_us(e) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("Activity Buffer")) / 1e3
    untraced = statistics.median(pass_ms)
    del session, audio, enc
    torch.cuda.empty_cache()
    return {
        "kv": kv, "pass_ms": untraced, "pass_ms_min": min(pass_ms),
        "pass_ms_max": max(pass_ms),
        "audio_s_per_s": bench.BATCH * bench.N_BATCHES * 30.0
        / (untraced / 1e3),
        "decode_ms": statistics.median(dec_ms),
        "decode_ms_per_step": statistics.median(dec_ms) / bench.GEN_TOKENS,
        "busy_ms": busy, "idle_share": 1 - busy / untraced,
        "traced_pass_ms": traced[0], "peak_gib": peak,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="the checkout whose whisper_trtllm_tpu_torch is imported")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("pass_profile: needs a CUDA card", file=sys.stderr)
        return 1
    import whisper_trtllm_tpu_torch

    pkg = os.path.dirname(os.path.abspath(whisper_trtllm_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        print(f"pass_profile: imported {pkg}, not {root}'s package",
              file=sys.stderr)
        return 1
    from whisper_trtllm_tpu_torch.utils.device import set_fp32_precision

    set_fp32_precision()
    rows = [profile_kv(torch, kv) for kv in ("int8", "auto")]
    print(json.dumps({"root": root, "card": card_line(),
                      "device": torch.cuda.get_device_name(0),
                      "series": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
