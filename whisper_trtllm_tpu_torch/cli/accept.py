"""Unattended accuracy acceptance: WER + exact-transcript differential
(counterpart of the repository's ``cli/accept.py``).

One command gives both headline accuracy results where real weights and
audio are present:

  * corpus WER through the English WER protocol (``utils/normalizer.py``),
  * the exact-transcript differential against HF torch: the count of
    identical transcripts over the dataset,
  * with ``--bf16-drift``, the bf16-vs-fp32 drift (token agreement and
    exact text matches).

Usage:
  python -m whisper_trtllm_tpu_torch.cli.accept --hf-dir LOCAL_DIR \
      --dataset data.pkl [--audio-dir wavs/] \
      [--wer-threshold 5.7] [--min-match-frac 0.9] [--bf16-drift] \
      [--limit 73] [--out accept.json] [--cpu]

Exit code 0 iff every requested gate passes. ``--checkpoint`` takes this
repository's saved checkpoints instead of an HF dir (the differential and
the tokenizer then need ``--hf-ref``). The session runs on the CUDA card
(``--cpu``: the plain PyTorch path on the CPU); ``--audio-dir``'s log-mel
frontend runs on the session's device. HF's own generate runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _load_audio_dir(path, n_mels, device=None):
    """Directory of 16 kHz PCM16 .wav files with sibling .txt transcripts →
    (mels (N, 3000, n_mels) numpy, texts). Stdlib-only decode; the log-mel
    frontend (K3 on the card) runs on ``device``."""
    import pathlib
    import wave

    from whisper_trtllm_tpu_torch.audio import LogMelSpectrogram, pad_or_trim

    wavs = sorted(pathlib.Path(path).glob("*.wav"))
    if not wavs:
        raise FileNotFoundError(f"no .wav files under {path}")
    frontend = LogMelSpectrogram(n_mels, device=device)
    mels, texts = [], []
    for w in wavs:
        with wave.open(str(w), "rb") as f:
            if f.getsampwidth() != 2:
                raise ValueError(f"{w}: only PCM16 supported here")
            pcm = np.frombuffer(f.readframes(f.getnframes()), np.int16)
            if f.getnchannels() > 1:
                pcm = pcm.reshape(-1, f.getnchannels()).mean(axis=1)
            if f.getframerate() != 16000:
                raise ValueError(f"{w}: expected 16 kHz, got {f.getframerate()}")
        audio = pad_or_trim(pcm.astype(np.float32) / 32768.0)
        mels.append(frontend(audio).cpu().numpy()[0])
        txt = w.with_suffix(".txt")
        texts.append(txt.read_text().strip() if txt.exists() else "")
    return np.stack(mels), texts


def _decode_rows(tokenizer, tokens, lengths, cfg, start: int = 1):
    out = []
    for b in range(len(tokens)):
        ids = np.asarray(tokens[b][start:int(lengths[b])])
        ids = ids[(ids != cfg.eos_token_id) & (ids != cfg.pad_token_id)]
        out.append(tokenizer.decode([int(t) for t in ids],
                                    skip_special_tokens=True))
    return out


def _transcribe_all(sess, mels, batch):
    hyp_tokens, hyp_lens = [], []
    for i in range(0, len(mels), batch):
        mb = mels[i:i + batch]
        pad = batch - len(mb)
        if pad:
            mb = np.concatenate([mb, np.repeat(mb[-1:], pad, 0)])
        tokens, lengths = sess.transcribe_features(mb)
        hyp_tokens.extend(np.asarray(tokens)[: len(mb) - pad])
        hyp_lens.extend(np.asarray(lengths)[: len(mb) - pad])
    return hyp_tokens, hyp_lens


def main(argv=None):
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--hf-dir", help="local HF Whisper checkpoint directory")
    src.add_argument("--checkpoint", help="this repo's saved checkpoint dir "
                                          "(differential still needs --hf-dir "
                                          "via --hf-ref)")
    ap.add_argument("--hf-ref", help="HF dir for the differential/tokenizer "
                                     "when loading via --checkpoint")
    ap.add_argument("--dataset", help="pickled [(mel, text), ...] cache "
                                      "(cli/get_librispeech.py output)")
    ap.add_argument("--audio-dir", help="dir of 16 kHz PCM16 wavs + .txt refs")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--limit", type=int, default=0,
                    help="cap utterance count (the reference run.py dummy set is 73)")
    ap.add_argument("--max-new-tokens", type=int, default=224)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--wer-threshold", type=float, default=None,
                    help="gate: corpus WER%% must be <= this")
    ap.add_argument("--min-match-frac", type=float, default=None,
                    help="gate: exact-transcript match fraction vs HF")
    ap.add_argument("--bf16-drift", action="store_true",
                    help="also decode in bf16 and report drift vs fp32")
    ap.add_argument("--skip-differential", action="store_true")
    ap.add_argument("--out", help="write the full JSON report here")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions); "
                    "the default is the CUDA card")
    args = ap.parse_args(argv)

    from transformers import WhisperTokenizerFast

    from whisper_trtllm_tpu_torch.cli.transcribe import _load_dataset
    from whisper_trtllm_tpu_torch.config import GenerationConfig, RuntimeConfig
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.device import resolve_device
    from whisper_trtllm_tpu_torch.utils.metrics import (
        get_text_normalizer,
        word_error_rate,
    )

    dev = resolve_device("cpu" if args.cpu else None)

    # ---- model ----
    hf_dir = args.hf_dir or args.hf_ref
    hf_model = None
    if args.checkpoint:
        from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
        params, cfg = load_checkpoint(args.checkpoint, device=dev)
    else:
        from transformers import WhisperForConditionalGeneration

        from whisper_trtllm_tpu_torch.models.whisper import convert_hf_model
        hf_model = WhisperForConditionalGeneration.from_pretrained(
            args.hf_dir, local_files_only=True).eval()
        params, cfg = convert_hf_model(hf_model, device=dev)
    tokenizer = WhisperTokenizerFast.from_pretrained(hf_dir,
                                                     local_files_only=True)
    normalize = get_text_normalizer()

    # ---- data ----
    if args.dataset:
        mels, texts = _load_dataset(args.dataset, cfg.num_mel_bins)
    elif args.audio_dir:
        mels, texts = _load_audio_dir(args.audio_dir, cfg.num_mel_bins, dev)
    else:
        ap.error("need --dataset or --audio-dir")
    if args.limit:
        mels, texts = mels[: args.limit], texts[: args.limit]
    n = len(mels)

    gen = GenerationConfig(max_new_tokens=args.max_new_tokens)
    sess = WhisperSession(params, cfg, gen,
                          RuntimeConfig(compute_dtype=args.dtype), device=dev)

    # ---- our transcripts + WER ----
    t0 = time.perf_counter()
    hyp_tokens, hyp_lens = _transcribe_all(sess, mels, args.batch)
    elapsed = time.perf_counter() - t0
    hyps = _decode_rows(tokenizer, hyp_tokens, hyp_lens, cfg)
    wer = None
    if any(t for t in texts):
        refs_n = [normalize(t) for t in texts]
        hyps_n = [normalize(h) for h in hyps]
        wer = word_error_rate(hyps_n, refs_n) * 100.0

    report = {
        "utterances": n,
        "dtype": args.dtype,
        "audio_s_per_s": round(n * 30.0 / elapsed, 2),
        "wer_pct": round(wer, 3) if wer is not None else None,
        "wer_threshold_pct": args.wer_threshold,
    }

    # ---- exact-transcript differential vs HF torch ----
    if not args.skip_differential:
        import torch
        if hf_model is None:
            from transformers import WhisperForConditionalGeneration
            if not hf_dir:
                ap.error("differential needs --hf-dir or --hf-ref")
            hf_model = WhisperForConditionalGeneration.from_pretrained(
                hf_dir, local_files_only=True).eval()
        prompt = [cfg.decoder_start_token_id] + [
            t for _, t in sorted(cfg.forced_decoder_ids)]
        # our buffer is max_new_tokens+1 wide including [start, forced...],
        # so the generated-token budget after the prompt is max_new - n_forced
        # — give HF the same budget so non-EOS-terminated decodes align
        hf_new = max(args.max_new_tokens - (len(prompt) - 1), 1)
        same = 0
        hf_texts = []
        for i in range(0, n, args.batch):
            mb = mels[i:i + args.batch]
            with torch.no_grad():
                out = hf_model.generate(
                    input_features=torch.from_numpy(
                        np.asarray(mb).transpose(0, 2, 1)),
                    decoder_input_ids=torch.tensor([prompt] * len(mb)),
                    max_new_tokens=hf_new,
                    do_sample=False).numpy()
            for row in out:
                ids = row[(row != cfg.eos_token_id) & (row != cfg.pad_token_id)]
                hf_texts.append(tokenizer.decode(
                    [int(t) for t in ids], skip_special_tokens=True))
        for h, g in zip(hyps, hf_texts):
            same += int(h.strip() == g.strip())
        report["differential_same"] = same
        report["differential_total"] = n
        report["differential_frac"] = round(same / max(n, 1), 4)
        if wer is not None:
            refs_n = [normalize(t) for t in texts]
            hf_wer = word_error_rate(
                [normalize(h) for h in hf_texts], refs_n) * 100.0
            report["hf_wer_pct"] = round(hf_wer, 3)

    # ---- bf16 drift vs fp32 (the headline precision's accuracy cost) ----
    if args.bf16_drift:
        sess16 = WhisperSession(params, cfg, gen,
                                RuntimeConfig(compute_dtype="bfloat16"),
                                device=dev)
        tok16, len16 = _transcribe_all(sess16, mels, args.batch)
        hyps16 = _decode_rows(tokenizer, tok16, len16, cfg)
        agree, total = 0, 0
        for a, al, b, bl in zip(hyp_tokens, hyp_lens, tok16, len16):
            m = min(int(al), int(bl))
            agree += int(np.sum(np.asarray(a[:m]) == np.asarray(b[:m])))
            total += max(int(al), int(bl))
        report["bf16_token_agreement"] = round(agree / max(total, 1), 4)
        report["bf16_exact_text_matches"] = sum(
            int(x.strip() == y.strip()) for x, y in zip(hyps, hyps16))
        if wer is not None:
            report["bf16_wer_pct"] = round(word_error_rate(
                [normalize(h) for h in hyps16],
                [normalize(t) for t in texts]) * 100.0, 3)

    # ---- gates ----
    ok = True
    if args.wer_threshold is not None:
        ok &= wer is not None and wer <= args.wer_threshold
    if args.min_match_frac is not None:
        ok &= report.get("differential_frac", 0.0) >= args.min_match_frac
    report["pass"] = bool(ok)

    line = json.dumps(report)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
