"""WER evaluation over a cached (mel, text) pickle (counterpart of the
repository's ``cli/cal_wer.py``): greedy decode on the CUDA card
(``--cpu``: the plain PyTorch path on the CPU), normalize hypothesis and
reference with the English WER protocol, report corpus WER.

Usage:
  python -m whisper_trtllm_tpu_torch.cli.cal_wer --checkpoint DIR \\
      --dataset data.pkl --hf-model LOCAL_DIR [--batch 8] [--cpu]

``--hf-model`` is a local directory holding the tokenizer.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--hf-model", required=True, help="for the tokenizer")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--num-beams", type=int, default=1)
    ap.add_argument("--max-new-tokens", type=int, default=224)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions); "
                    "the default is the CUDA card")
    args = ap.parse_args(argv)

    from transformers import WhisperTokenizerFast

    from whisper_trtllm_tpu_torch.cli.transcribe import _batches, _load_dataset
    from whisper_trtllm_tpu_torch.config import GenerationConfig, RuntimeConfig
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
    from whisper_trtllm_tpu_torch.utils.device import resolve_device
    from whisper_trtllm_tpu_torch.utils.metrics import (
        get_text_normalizer,
        word_error_rate,
    )

    dev = resolve_device("cpu" if args.cpu else None)
    params, cfg = load_checkpoint(args.checkpoint, device=dev)
    sess = WhisperSession(
        params, cfg,
        GenerationConfig(max_new_tokens=args.max_new_tokens,
                         num_beams=args.num_beams),
        RuntimeConfig(compute_dtype=args.dtype),
        device=dev,
    )
    tokenizer = WhisperTokenizerFast.from_pretrained(args.hf_model,
                                                     local_files_only=True)
    normalize = get_text_normalizer()

    mels, texts = _load_dataset(args.dataset, cfg.num_mel_bins)
    n = len(mels)
    hyps = []
    t0 = time.perf_counter()
    for mb in _batches(mels, args.batch):
        pad = args.batch - len(mb)
        if pad:
            mb = np.concatenate([mb, np.repeat(mb[-1:], pad, 0)])
        tokens, lengths = sess.transcribe_features(mb)
        for b in range(len(tokens) - pad):
            ids = tokens[b, 1 : lengths[b]]
            ids = ids[ids != cfg.eos_token_id]
            hyps.append(tokenizer.decode(ids, skip_special_tokens=True))
    elapsed = time.perf_counter() - t0

    refs = [normalize(t) for t in texts[:len(hyps)]]
    hyps_n = [normalize(h) for h in hyps]
    wer = word_error_rate(hyps_n, refs)
    print(f"WER: {wer * 100:.2f}%  ({n} utterances, {elapsed:.1f}s, "
          f"{n * 30.0 / elapsed:.1f} audio-s/s)")


if __name__ == "__main__":
    main()
