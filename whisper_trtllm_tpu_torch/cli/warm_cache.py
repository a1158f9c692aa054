"""Build the kernels into a persistent directory and warm the session for
every deployment shape (counterpart of the repository's
``cli/warm_cache.py``, which fills XLA's persistent compilation cache).

What persists here is the kernels' build: ``--cache-dir`` becomes the
directory where ``ops/kernels/_build.py`` writes and finds its libraries
(``utils.checkpoint.init_compilation_cache``), and every kernel source is
built there first (one ``nvcc`` each, all at once). A later process whose
session has ``RuntimeConfig(persistent_cache_dir=DIR)`` (``cli.serve
--cache-dir DIR``) then loads them and runs no ``nvcc``. The warm-ups that
follow capture each shape's decode step as a CUDA graph, which does not
outlive this process: they time a first transcribe at each shape, as the
JAX CLI's compiles do.

Usage:
  python -m whisper_trtllm_tpu_torch.cli.warm_cache --model tiny.en \\
      --batch 1 16 [--gen-tokens 48 224] [--dtype bfloat16] \\
      [--num-beams 1] [--cache-dir DIR] [--cpu]
  python -m whisper_trtllm_tpu_torch.cli.warm_cache --checkpoint DIR \\
      --batch 1 8

``--cpu`` warms the plain PyTorch path on the CPU, which builds nothing.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny.en")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 16])
    ap.add_argument("--gen-tokens", type=int, nargs="+", default=[48])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--num-beams", type=int, nargs="+", default=[1])
    ap.add_argument("--cache-dir", default=None,
                    help="directory of the kernels' built libraries "
                    "(default: build/kernels at the repository's root)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions); "
                    "the default is the CUDA card")
    args = ap.parse_args(argv)

    from whisper_trtllm_tpu_torch.cli.gpu_check import SOURCES
    from whisper_trtllm_tpu_torch.config import (
        GenerationConfig,
        RuntimeConfig,
        WhisperConfig,
    )
    from whisper_trtllm_tpu_torch.models.whisper import init_params
    from whisper_trtllm_tpu_torch.ops.kernels import _build
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.checkpoint import (
        init_compilation_cache,
        load_checkpoint,
    )
    from whisper_trtllm_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    if args.cache_dir:
        init_compilation_cache(args.cache_dir)
    if dev.type == "cuda":
        t0 = time.time()
        _build.build(SOURCES)
        print(f"built {len(SOURCES)} kernel sources into {_build.BUILD_DIR}: "
              f"{time.time() - t0:.1f}s")

    if args.checkpoint:
        params, cfg = load_checkpoint(args.checkpoint, device=dev)
    else:
        cfg = WhisperConfig.preset(args.model)
        params = init_params(cfg, seed=0, device=dev)

    for beams in args.num_beams:
        for toks in args.gen_tokens:
            sess = WhisperSession(
                params, cfg,
                GenerationConfig(max_new_tokens=toks, num_beams=beams),
                RuntimeConfig(compute_dtype=args.dtype),
                device=dev,
            )
            for b in args.batch:
                t0 = time.time()
                sess.warmup(batch=b)
                print(f"warmed batch={b} tokens={toks} beams={beams} "
                      f"dtype={args.dtype}: {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
