"""Serving/eval CLI: transcribe a dataset, optionally differential-test
against HF transformers (counterpart of the repository's
``cli/transcribe.py``).

Two passes over the dataset, a warm-up and a timed one, batched on the
CUDA card (``--cpu``: the plain PyTorch path on the CPU); ``--compare``
counts the transcripts equal to a local HF model's.

Usage:
  python -m whisper_trtllm_tpu_torch.cli.transcribe --checkpoint DIR \\
      [--dataset data.pkl] [--batch 8] [--num-beams 1] [--compare] \\
      [--hf-model LOCAL_DIR] [--dtype float32|bfloat16] \\
      [--kv-cache-dtype auto|int8|fp8] [--cpu]

The dataset is a pickle of (mel, text) pairs, mel (3000, M) or (M, 3000).
Without ``--dataset``, 8 synthetic mels are used (a shape and speed smoke
run). Each of the first 5 hypotheses is printed as ``[i] ...``: its ids
after the start token, EOS dropped, space-joined (or its text with
``--hf-model``).
"""

from __future__ import annotations

import argparse
import pickle
import time

import numpy as np


def _load_dataset(path, n_mels):
    """Returns (mels (N, 3000, M) float32, texts list[str])."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    mels, texts = [], []
    for item in data:
        mel, text = item[0], item[1]
        mel = np.asarray(mel, np.float32)
        if mel.ndim == 3:
            mel = mel[0]
        if mel.shape[0] == n_mels:  # (M, T) → (T, M)
            mel = mel.T
        mels.append(mel)
        texts.append(text)
    return np.stack(mels), texts


def _batches(x, batch):
    for i in range(0, len(x), batch):
        yield x[i : i + batch]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--num-beams", type=int, default=1)
    ap.add_argument("--max-new-tokens", type=int, default=224)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--kv-cache-dtype", default="auto",
                    choices=["auto", "int8", "fp8"])
    ap.add_argument("--compare", action="store_true",
                    help="differential test vs HF transformers (CPU torch)")
    ap.add_argument("--hf-model", default=None,
                    help="HF model for --compare / tokenizer")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions); "
                    "the default is the CUDA card")
    args = ap.parse_args(argv)

    from whisper_trtllm_tpu_torch.config import GenerationConfig, RuntimeConfig
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
    from whisper_trtllm_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    params, cfg = load_checkpoint(args.checkpoint, device=dev)
    sess = WhisperSession(
        params, cfg,
        GenerationConfig(max_new_tokens=args.max_new_tokens,
                         num_beams=args.num_beams,
                         kv_cache_dtype=args.kv_cache_dtype),
        RuntimeConfig(compute_dtype=args.dtype),
        device=dev,
    )

    if args.dataset:
        mels, texts = _load_dataset(args.dataset, cfg.num_mel_bins)
    else:
        rng = np.random.default_rng(0)
        mels = rng.standard_normal(
            (8, 2 * cfg.max_source_positions, cfg.num_mel_bins)
        ).astype(np.float32) * 0.1
        texts = [""] * len(mels)

    # pad the tail batch to the batch size
    batch = args.batch
    n = len(mels)

    def run_pass():
        outs = []
        t0 = time.perf_counter()
        for mb in _batches(mels, batch):
            pad = batch - len(mb)
            if pad:
                mb = np.concatenate([mb, np.repeat(mb[-1:], pad, 0)])
            tokens, lengths = sess.transcribe_features(mb)
            outs.append((tokens, lengths))
        elapsed = time.perf_counter() - t0
        return outs, elapsed

    run_pass()                       # warm-up: builds, captures
    outs, elapsed = run_pass()
    audio_s = n * 30.0
    print(f"{n} utterances in {elapsed:.2f}s → "
          f"{audio_s / elapsed:.1f} audio-s/s, "
          f"{elapsed / n * 1e3:.1f} ms/utt")

    tokenizer = None
    if args.hf_model:
        try:
            from transformers import WhisperTokenizerFast

            tokenizer = WhisperTokenizerFast.from_pretrained(
                args.hf_model, local_files_only=True)
        except Exception as e:  # noqa: BLE001 — ids are printed without it
            print(f"(no tokenizer: {e})")

    hyps = []
    idx = 0
    for tokens, lengths in outs:
        for b in range(len(tokens)):
            if idx >= n:
                break
            ids = tokens[b, 1 : lengths[b]]
            ids = ids[ids != cfg.eos_token_id]
            if tokenizer is not None:
                hyps.append(tokenizer.decode(ids, skip_special_tokens=True))
            else:
                hyps.append(" ".join(map(str, ids)))
            idx += 1

    if args.compare:
        import torch
        from transformers import WhisperForConditionalGeneration

        hf = WhisperForConditionalGeneration.from_pretrained(
            args.hf_model or args.checkpoint, local_files_only=True
        ).eval()
        same = diff = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            for i in range(n):
                out = hf.generate(
                    input_features=torch.from_numpy(mels[i].T[None]),
                    max_new_tokens=args.max_new_tokens,
                    num_beams=args.num_beams, do_sample=False,
                )
                ref = (tokenizer.decode(out[0], skip_special_tokens=True)
                       if tokenizer else " ".join(map(str, out[0].numpy())))
                if ref.strip() == hyps[i].strip():
                    same += 1
                else:
                    diff += 1
                    print(f"[diff utt {i}]\n  ours:   {hyps[i]}\n  theirs: {ref}")
        hf_elapsed = time.perf_counter() - t0
        print(f"same: {same}  diff: {diff}  (HF pass {hf_elapsed:.2f}s, "
              f"speedup {hf_elapsed / elapsed:.2f}x)")
    else:
        for i, h in enumerate(hyps[: min(n, 5)]):
            print(f"[{i}] {h}")


if __name__ == "__main__":
    main()
