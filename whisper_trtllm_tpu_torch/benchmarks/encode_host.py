#!/usr/bin/env python3
"""Host cost of an eager encode for one checkout of the port: the trained
tiny.en artifact (fp32) encoding a batch of 4 mels, K1 once and K5 twice
an encoder layer and K5 once after, every call from Python with no graph.

Each timed call is queued behind a spin of the card far longer than the
calls' work (``torch.cuda._sleep``), so a launch only queues and the wall
time is the host's: the wrappers' checks, plans and launches, and the
PyTorch ops between them. A round stays under the card's queue of
pending launches (about a thousand; an encode makes ~160 launches of all
kinds): past it the host waits for the spin, as 20 calls a round did.
Reports the median over ``--reps`` rounds of ``--calls`` calls (µs a
call and a kernel launch of the wrappers), whether the spin outlasted
every round, and the device ms of one encode. Prints one JSON line.

It is run by path, so that ``--root`` chooses the checkout whose package
is imported (this one by default, or an earlier commit unpacked in a
directory), and two commits can be timed in turns in one call:

    python3 whisper_trtllm_tpu_torch/benchmarks/encode_host.py [--root DIR]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SPIN_CYCLES = 1_000_000_000  # ~0.5 s at a 2 GHz clock


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("encode_host needs a CUDA card")
    from whisper_trtllm_tpu_torch.models.whisper import encode
    from whisper_trtllm_tpu_torch.ops.kernels import (
        KERNELS,
        reset_launch_counts,
    )
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
    from whisper_trtllm_tpu_torch.utils.device import set_fp32_precision

    set_fp32_precision()
    params, cfg = load_checkpoint(
        os.path.join(root, "artifacts", "tiny_en_synth_int8"))
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (args.batch, 2 * cfg.max_source_positions, cfg.num_mel_bins)
    ).astype(np.float32)).cuda()

    def call():
        with torch.inference_mode():
            return encode(params, cfg, mel)

    call()
    torch.cuda.synchronize()
    reset_launch_counts()
    call()
    torch.cuda.synchronize()
    launches = sum(f.launches for f in KERNELS.values())
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    call()
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end)
    host, queued = [], True
    for _ in range(args.reps):
        spun = torch.cuda.Event()
        torch.cuda._sleep(SPIN_CYCLES)
        spun.record()
        t0 = time.perf_counter()
        for _ in range(args.calls):
            call()
        host.append((time.perf_counter() - t0) * 1e6 / args.calls)
        queued &= not spun.query()
        torch.cuda.synchronize()
    us = statistics.median(host)
    print(json.dumps({
        "root": root, "card": card_line(), "batch": args.batch,
        "launches_a_call": launches, "host_us_a_call": us,
        "host_us_a_launch": us / launches, "host_us_min": min(host),
        "host_us_max": max(host), "spin_outlasted_the_calls": queued,
        "device_ms_a_call": device_ms}))


if __name__ == "__main__":
    main()
