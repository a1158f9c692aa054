"""Build step: a local HF checkpoint → this repository's artifact (weights
and config), the kernels built and each batch size warmed, and with
``--export-engines`` one engine file a batch size (counterpart of the
repository's ``cli/build.py``).

Usage:
  python -m whisper_trtllm_tpu_torch.cli.build --model LOCAL_HF_DIR \\
      --output engines/tiny.en [--warmup-batches 1 8] [--cache-dir DIR] \\
      [--export-engines] [--dtype float32|bfloat16] [--cpu]

``--cache-dir`` is where the kernels' libraries are built and found
(``RuntimeConfig.persistent_cache_dir``). ``--export-engines`` writes
``whisper_b{b}.engine`` (``utils/engine.py``) beside the checkpoint; on
the card its programs call the kernels, on the CPU (``--cpu``) their
plain versions. Nothing is downloaded: ``--model`` is a local directory.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True,
                    help="local HF Whisper model directory")
    ap.add_argument("--output", required=True, help="artifact directory")
    ap.add_argument("--warmup-batches", type=int, nargs="*", default=[1],
                    help="batch sizes to warm")
    ap.add_argument("--cache-dir", default=None,
                    help="directory of the kernels' built libraries")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--max-new-tokens", type=int, default=224)
    ap.add_argument("--export-engines", action="store_true",
                    help="also write one engine file a warm-up batch size, "
                    "loadable with utils.engine.load_engine")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions); "
                    "the default is the CUDA card")
    args = ap.parse_args(argv)

    from whisper_trtllm_tpu_torch.config import GenerationConfig, RuntimeConfig
    from whisper_trtllm_tpu_torch.models.whisper import load_pretrained
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.checkpoint import save_checkpoint
    from whisper_trtllm_tpu_torch.utils.device import resolve_device
    from whisper_trtllm_tpu_torch.utils.logger import logger

    dev = resolve_device("cpu" if args.cpu else None)
    t0 = time.time()
    params, cfg = load_pretrained(args.model, device=dev)
    logger.info("loaded %s in %.1fs", args.model, time.time() - t0)

    save_checkpoint(args.output, params, cfg)
    print(f"saved weights+config to {args.output}")

    sess = WhisperSession(
        params, cfg,
        GenerationConfig(max_new_tokens=args.max_new_tokens),
        RuntimeConfig(compute_dtype=args.dtype,
                      persistent_cache_dir=args.cache_dir),
        device=dev,
    )
    for b in args.warmup_batches:
        t0 = time.time()
        sess.warmup(batch=b)
        print(f"compiled batch={b} in {time.time() - t0:.1f}s")
        if args.export_engines:
            path = os.path.join(args.output, f"whisper_b{b}.engine")
            nbytes = sess.export_engine(path, batch=b)
            print(f"serialized engine batch={b}: {path} ({nbytes} bytes)")


if __name__ == "__main__":
    main()
