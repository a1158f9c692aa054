"""Where one transcribe's time goes on the card.

    python -m whisper_trtllm_tpu_torch.utils.profile_transcribe
        [--compute-dtype float32|bfloat16] [--kv-cache-dtype auto|int8|fp8]
        [--float-weights] [--trace transcribe_trace.json]

Loads the trained tiny.en artifact (with ``--float-weights`` dequantized
in memory: the float-weight path, whose decode steps run the fused
decoder-layer kernel with float KV caches), transcribes the four bundled
utterances as one batch once to warm up, then once more under
``torch.profiler`` and prints: the traced wall time, the device's busy
time (the sum of kernel, copy and fill times on the card; one stream, so
they do not overlap; the profiler's own buffer requests are left out) and
idle share, the number of device operations, and the top device
operations by total time, then K5's launches one by one: their count and
median device time (the decode loop's: K5 launches 221 times in B's
decode against 9 in its encoder). Needs a CUDA card; the profiler's
own overhead is included in the traced wall time.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from whisper_trtllm_tpu_torch.audio import pad_or_trim, read_wav
from whisper_trtllm_tpu_torch.config import GenerationConfig, RuntimeConfig
from whisper_trtllm_tpu_torch.quantization import dequantize_params
from whisper_trtllm_tpu_torch.runtime import generation
from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the profiled call here")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--kv-cache-dtype", default="auto",
                    choices=["auto", "int8", "fp8"])
    ap.add_argument("--float-weights", action="store_true",
                    help="dequantize the artifact's int8 weights in memory")
    args = ap.parse_args(argv)

    audio = np.stack([pad_or_trim(read_wav(os.path.join(
        ROOT, "artifacts", "eval", f"utt{i:02d}.wav"))) for i in range(4)])
    params, cfg = load_checkpoint(
        os.path.join(ROOT, "artifacts", "tiny_en_synth_int8"))
    if args.float_weights:
        params = dequantize_params(params)
    session = WhisperSession(
        params, cfg,
        GenerationConfig(max_new_tokens=32, kv_cache_dtype=args.kv_cache_dtype),
        RuntimeConfig(compute_dtype=args.compute_dtype))
    session.transcribe(audio)
    torch.cuda.synchronize()

    generation.reset_loop_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.transcribe(audio)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, fills): the CPU-side op
    # that launched a kernel reports the same time again
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith("Activity Buffer")]
    rows = [r for r in rows if r[2] > 0]
    busy_ms = sum(r[2] for r in rows) / 1e3
    n_ops = sum(r[1] for r in rows)
    steps = generation.LOOP.steps  # replays of the captured step
    weights = "float" if args.float_weights else "int8"
    print(f"profile: {weights} weights, {args.compute_dtype} compute, kv "
          f"{args.kv_cache_dtype}, "
          f"batch {len(audio)}, {steps} decode steps, traced wall "
          f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {n_ops} device operations "
          f"({n_ops / max(steps, 1):.1f} per decode step, encode included)")
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:20]:
        print(f"profile: {us / 1e3:9.3f} ms {count:6d} x {us / count:9.2f} us  "
              f"{key[:100]}")
    us = sorted(_device_us(e) for e in prof.events()
                if e.device_type == DeviceType.CUDA and "layer_norm" in e.name)
    if not us:
        raise RuntimeError("profile: no launch of layer_norm (K5) traced")
    print(f"profile: launches of layer_norm: {len(us)}, median "
          f"{statistics.median(us):.2f} us (min {us[0]:.2f}, max "
          f"{us[-1]:.2f}), total {sum(us) / 1e3:.3f} ms")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
