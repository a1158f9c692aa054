"""Dump the pipeline's programs for inspection (counterpart of the
repository's ``cli/visualize.py``, whose three stages are the jaxpr, the
StableHLO module and the optimized HLO).

Two stages here:

- ``fx``: the exported engine programs' graphs (``runtime/export.py``,
  the graphs ``export_engine`` writes), ``{out}.encode.fx.txt`` and
  ``{out}.step.fx.txt`` — the framework-level ops, the kernels as
  ``torch.ops.wtpu.*`` on the card;
- ``kernels``: what actually runs, ``{out}.kernels.txt``: every device
  kernel of one profiled ``transcribe_features`` (after a warm-up one) with
  its launches, and the kernel wrappers' own launch counts. With ``--cpu``
  the list holds the CPU's operators instead, and the wrappers count
  nothing (their plain versions run).

Usage:
  python -m whisper_trtllm_tpu_torch.cli.visualize --checkpoint DIR \\
      --out graph [--batch 1] [--stage fx|kernels|all] \\
      [--max-new-tokens 32] [--dtype float32|bfloat16] [--cpu]
"""

from __future__ import annotations

import argparse
import collections


def _write(path: str, txt: str) -> None:
    with open(path, "w") as f:
        f.write(txt)
    print(f"{path} ({len(txt)} chars)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--out", required=True, help="output path prefix")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--stage", default="all", choices=["fx", "kernels", "all"])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions); "
                    "the default is the CUDA card")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from whisper_trtllm_tpu_torch.config import GenerationConfig, RuntimeConfig
    from whisper_trtllm_tpu_torch.ops.kernels import (
        KERNELS,
        reset_launch_counts,
    )
    from whisper_trtllm_tpu_torch.runtime.export import export_programs
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
    from whisper_trtllm_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    params, cfg = load_checkpoint(args.checkpoint, device=dev)
    sess = WhisperSession(
        params, cfg, GenerationConfig(max_new_tokens=args.max_new_tokens),
        RuntimeConfig(compute_dtype=args.dtype), device=dev)

    if args.stage in ("fx", "all"):
        encode, step = export_programs(
            sess.params, cfg, sess.generation, sess._dtype, dev,
            args.batch)[:2]
        for name, ep in (("encode", encode), ("step", step)):
            _write(f"{args.out}.{name}.fx.txt",
                   ep.graph_module.print_readable(print_output=False))
    if args.stage in ("kernels", "all"):
        mel = torch.zeros((args.batch, 2 * cfg.max_source_positions,
                           cfg.num_mel_bins), device=dev)
        sess.transcribe_features(mel)
        activities = [ProfilerActivity.CPU]
        kind = DeviceType.CPU
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
            kind = DeviceType.CUDA
            torch.cuda.synchronize()
        reset_launch_counts()
        with profile(activities=activities) as prof:
            sess.transcribe_features(mel)
        launches = collections.Counter(
            e.name for e in prof.events() if e.device_type == kind
            and (kind == DeviceType.CUDA or e.name.startswith("aten::")))
        lines = [f"# one transcribe_features at batch {args.batch}, "
                 f"{args.max_new_tokens} new tokens, {args.dtype}, on {dev}",
                 "# wrapper launches: " + ", ".join(
                     f"{k} {f.launches}" for k, f in KERNELS.items()),
                 f"# {'kernel' if kind == DeviceType.CUDA else 'operator'}"
                 f"\tlaunches"]
        lines += [f"{name}\t{n}" for name, n in launches.most_common()]
        _write(f"{args.out}.kernels.txt", "\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
