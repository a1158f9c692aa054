"""Data-parallel scaling efficiency (counterpart of
``whisper_trtllm_tpu/benchmarks/scaling.py``).

For each device count of a ladder, the greedy pipeline
(``runtime/generation.py::transcribe_tokens``) over a (data, model) mesh of
that many ranks, ``--per-device-batch`` utterances a data rank: its
throughput in audio seconds a second and its efficiency against the first
count measured, per device. Each rank is one process on one device, so the
script runs under ``torchrun`` (NCCL over the cards; gloo with ``--cpu``);
started alone it runs a world of one. A count above the world size prints
the JAX script's ``"skipped"`` row. Rank 0 prints the rows.

Usage:
  torchrun --nproc-per-node N -m whisper_trtllm_tpu_torch.benchmarks.scaling \\
      --model tiny.en --devices 1 2 4 8 --per-device-batch 4 \\
      [--model-parallel 1] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist


def measure(model: str, n_devices: int, per_device_batch: int,
            model_parallel: int, gen_tokens: int, iters: int,
            device=None):
    """One ladder entry over the first ``n_devices`` ranks of the world
    (every rank calls it; the others return None): the row of the JAX
    script (devices, mesh, batch, audio_s_per_s, latency_ms), weights from
    ``init_params(seed=0)`` with no EOS, so every decode runs
    ``gen_tokens`` steps."""
    from whisper_trtllm_tpu_torch.config import (
        GenerationConfig,
        MeshConfig,
        WhisperConfig,
    )
    from whisper_trtllm_tpu_torch.models.whisper import init_params
    from whisper_trtllm_tpu_torch.parallel import make_mesh, shard_params
    from whisper_trtllm_tpu_torch.runtime.generation import transcribe_tokens

    cfg = dataclasses.replace(WhisperConfig.preset(model), eos_token_id=-1)
    gen = GenerationConfig(max_new_tokens=gen_tokens)
    data_ax = n_devices // model_parallel
    mesh = make_mesh(MeshConfig(data=data_ax, model=model_parallel),
                     device=device, devices=range(n_devices))
    if mesh.get_coordinate() is None:
        return None
    dev = torch.device(mesh.device_type)
    params = shard_params(init_params(cfg, seed=0, device=dev), mesh,
                          cfg=cfg)
    batch = per_device_batch * data_ax
    rng = np.random.default_rng(0)
    mel = rng.standard_normal(
        (batch, 2 * cfg.max_source_positions, cfg.num_mel_bins)
    ).astype(np.float32)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with mesh:
        transcribe_tokens(params, cfg, mel, gen, device=dev)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            transcribe_tokens(params, cfg, mel, gen, device=dev)
        sync()
    elapsed = (time.perf_counter() - t0) / iters
    return {
        "devices": n_devices,
        "mesh": f"data={data_ax} model={model_parallel}",
        "batch": batch,
        "audio_s_per_s": round(batch * 30.0 / elapsed, 1),
        "latency_ms": round(elapsed * 1e3, 2),
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny.en")
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--per-device-batch", type=int, default=4)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--gen-tokens", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU (the kernels' plain "
                    "versions); the default is NCCL over the cards")
    args = ap.parse_args(argv)

    from whisper_trtllm_tpu_torch.parallel import initialize_distributed

    device = "cpu" if args.cpu else None
    started = not dist.is_initialized()
    if started:
        if "RANK" in os.environ:
            initialize_distributed(device)
        else:
            initialize_distributed(
                device, init_method=f"tcp://localhost:{_free_port()}",
                world_size=1, rank=0)
    avail, lead = dist.get_world_size(), dist.get_rank() == 0
    base = None
    for n in args.devices:
        if n > avail:
            if lead:
                print(json.dumps({"devices": n,
                                  "skipped": f"only {avail} available"}))
            continue
        row = measure(args.model, n, args.per_device_batch,
                      args.model_parallel, args.gen_tokens, args.iters,
                      device)
        if not lead:
            continue
        if base is None:
            base = row["audio_s_per_s"] / row["devices"]
        row["scaling_efficiency"] = round(
            row["audio_s_per_s"] / (base * row["devices"]), 3)
        print(json.dumps(row), flush=True)
    if started:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
