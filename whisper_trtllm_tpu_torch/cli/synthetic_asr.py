"""Synthetic ASR corpus and trained-weight acceptance scaffolding
(counterpart of the repository's ``cli/synthetic_asr.py``).

Real checkpoints and LibriSpeech audio cannot be fetched here, so this CLI
closes the accuracy loop offline:

  1. ``make`` — a deterministic audio<->text corpus (each word is a fixed
     two-tone chirp; sentences are word sequences under 30 s), a
     real-architecture HF Whisper model dir with a locally built
     ``WhisperTokenizerFast`` (word-level vocab at safe ids inside the
     model's 51864-token space), this repository's matching checkpoint
     (the same random init, converted), a finetune dataset pickle, and an
     eval wav/txt directory. The log-mel frontend runs on the CUDA card
     (``--cpu``: on the CPU);
  2. train with ``cli.finetune`` until the model transcribes;
  3. ``export-hf`` — write the fine-tuned weights back into the HF dir, so
     ``cli.accept``'s differential compares the same weights across
     frameworks and its WER gate runs against known references.

The word list is ``utils/vocab.py``'s ``WORDS``.

Usage:
  python -m whisper_trtllm_tpu_torch.cli.synthetic_asr make --out DIR \
      [--preset tiny.en|toy] [--train-n 256] [--eval-n 64] [--seed 0] [--cpu]
  python -m whisper_trtllm_tpu_torch.cli.synthetic_asr export-hf \
      --checkpoint ckpt_dir --hf-dir dir [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import wave

import numpy as np

from whisper_trtllm_tpu_torch.utils.vocab import WORD_ID_BASE, WORDS

SAMPLE_RATE = 16000

# NATO-style words (utils/vocab.py): normalizer-stable (asserted at corpus
# build), one token each in the word-level tokenizer, at ids WORD_ID_BASE +
# index (100+ avoids Whisper's suppress lists, symbols at <=93 and >=357,
# and begin-suppress, 220)


def word_audio(word_index: int, rng=None) -> np.ndarray:
    """Deterministic acoustic form of one word: two consecutive tones whose
    frequencies encode the word index (8x4 grid), 0.12 s each + 0.06 s gap.
    Optional additive noise makes training see a distribution, not a point.

    Frequencies are log-spaced (>=20% apart): the mel filterbank's low-band
    filters are ~40-60 Hz wide, and linear 45 Hz steps at 300-600 Hz would
    put adjacent words in the same mel bins."""
    f1 = 400.0 * (1.25 ** (word_index % 8))       # 400 .. 1907 Hz
    f2 = 2200.0 * (1.35 ** (word_index // 8))     # 2200 .. 5413 Hz
    n = int(0.12 * SAMPLE_RATE)
    t = np.arange(n) / SAMPLE_RATE
    env = np.hanning(n)
    seg = np.concatenate([
        0.3 * env * np.sin(2 * np.pi * f1 * t),
        0.3 * env * np.sin(2 * np.pi * f2 * t),
        np.zeros(int(0.06 * SAMPLE_RATE)),
    ]).astype(np.float32)
    if rng is not None:
        seg = seg + rng.standard_normal(seg.shape).astype(np.float32) * 0.01
    return seg


def sentence_audio(word_indices, rng=None) -> np.ndarray:
    lead = np.zeros(int(0.1 * SAMPLE_RATE), np.float32)
    return np.concatenate([lead] + [word_audio(i, rng) for i in word_indices])


def make_sentences(n: int, seed: int, min_words=3, max_words=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(min_words, max_words + 1))
        out.append([int(w) for w in rng.integers(0, len(WORDS), k)])
    return out, rng


def build_tokenizer(out_dir: str, vocab_size: int, eos: int, sot: int,
                    notimestamps: int):
    """Word-level WhisperTokenizerFast covering the model's full id space
    (filler tokens close the holes so round-trips are total)."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import WhisperTokenizerFast

    vocab = {f"<unused{i}>": i for i in range(vocab_size)}
    for i, w in enumerate(WORDS):
        del vocab[f"<unused{WORD_ID_BASE + i}>"]
        vocab[w] = WORD_ID_BASE + i
    for tok_str, tid in (("<|endoftext|>", eos),
                         ("<|startoftranscript|>", sot),
                         ("<|notimestamps|>", notimestamps)):
        vocab.pop(f"<unused{tid}>", None)
        vocab[tok_str] = tid
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unused0>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    os.makedirs(out_dir, exist_ok=True)
    tok_path = os.path.join(out_dir, "tokenizer.json")
    tok.save(tok_path)
    wt = WhisperTokenizerFast(
        tokenizer_file=tok_path, unk_token="<unused0>",
        bos_token="<|endoftext|>", eos_token="<|endoftext|>",
        pad_token="<|endoftext|>")
    wt.add_special_tokens({"additional_special_tokens":
                           ["<|startoftranscript|>", "<|notimestamps|>"]})
    wt.save_pretrained(out_dir)
    return wt


def write_wav(path: str, audio: np.ndarray):
    pcm = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(SAMPLE_RATE)
        f.writeframes(pcm.tobytes())


def cmd_make(args):
    from whisper_trtllm_tpu_torch.audio import LogMelSpectrogram, pad_or_trim
    from whisper_trtllm_tpu_torch.config import WhisperConfig
    from whisper_trtllm_tpu_torch.utils.checkpoint import save_checkpoint
    from whisper_trtllm_tpu_torch.utils.device import resolve_device
    from whisper_trtllm_tpu_torch.utils.metrics import get_text_normalizer

    dev = resolve_device("cpu" if args.cpu else None)

    # 'toy' keeps the REAL frontend geometry and token ids (so the same
    # tokenizer/corpus flow works) at CPU-test model dims
    cfg = (WhisperConfig.preset(args.preset) if args.preset != "toy"
           else WhisperConfig.testing(
               vocab_size=51864, num_mel_bins=80, d_model=64,
               encoder_ffn_dim=128, decoder_ffn_dim=128,
               max_source_positions=1500, max_target_positions=64,
               decoder_start_token_id=50257, eos_token_id=50256,
               pad_token_id=50256, bos_token_id=50257,
               suppress_tokens=(), begin_suppress_tokens=(220, 50256),
               forced_decoder_ids=((1, 50362),)))
    normalize = get_text_normalizer()
    for w in WORDS:
        assert normalize(w) == w, (
            f"word {w!r} is not normalizer-stable ({normalize(w)!r}) — the "
            "WER protocol would mismatch on it")

    os.makedirs(args.out, exist_ok=True)

    # ---- HF model dir: real architecture, random init, local tokenizer ----
    import torch
    from transformers import GenerationConfig as HFGenConfig
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration

    hf_dir = os.path.join(args.out, "hf")
    torch.manual_seed(args.seed)
    hf_cfg = HFConfig(
        vocab_size=cfg.vocab_size, num_mel_bins=cfg.num_mel_bins,
        d_model=cfg.d_model, encoder_layers=cfg.encoder_layers,
        encoder_attention_heads=cfg.encoder_attention_heads,
        decoder_layers=cfg.decoder_layers,
        decoder_attention_heads=cfg.decoder_attention_heads,
        encoder_ffn_dim=cfg.encoder_ffn_dim,
        decoder_ffn_dim=cfg.decoder_ffn_dim,
        max_source_positions=cfg.max_source_positions,
        max_target_positions=cfg.max_target_positions,
        decoder_start_token_id=cfg.decoder_start_token_id,
        eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id,
        bos_token_id=cfg.bos_token_id,
        suppress_tokens=list(cfg.suppress_tokens),
        begin_suppress_tokens=list(cfg.begin_suppress_tokens),
        forced_decoder_ids=[list(x) for x in cfg.forced_decoder_ids],
    )
    hf = WhisperForConditionalGeneration(hf_cfg).eval()
    hf.generation_config = HFGenConfig(
        decoder_start_token_id=cfg.decoder_start_token_id,
        eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id,
        bos_token_id=cfg.bos_token_id,
        suppress_tokens=list(cfg.suppress_tokens),
        begin_suppress_tokens=list(cfg.begin_suppress_tokens),
        forced_decoder_ids=[list(x) for x in cfg.forced_decoder_ids],
    )
    hf.save_pretrained(hf_dir)
    build_tokenizer(hf_dir, cfg.vocab_size, cfg.eos_token_id,
                    cfg.decoder_start_token_id,
                    cfg.no_timestamps_token_id or 50362)

    # ---- our checkpoint: SAME weights (converted), finetune starts here ----
    from whisper_trtllm_tpu_torch.models.whisper import convert_hf_model

    params, ccfg = convert_hf_model(hf, device=dev)
    save_checkpoint(os.path.join(args.out, "ckpt_init"), params, ccfg)

    # ---- corpora ----
    sot, notime = cfg.decoder_start_token_id, (cfg.no_timestamps_token_id
                                               or 50362)
    train_sents, rng = make_sentences(args.train_n, args.seed + 1,
                                      args.min_words, args.max_words)
    # the frontend runs in batches: corpora large enough to defeat suffix
    # memorization hold thousands of utterances
    frontend = LogMelSpectrogram(cfg.num_mel_bins, device=dev)
    train = []
    CHUNK = 32
    for c0 in range(0, len(train_sents), CHUNK):
        chunk = train_sents[c0:c0 + CHUNK]
        audio = np.stack([pad_or_trim(sentence_audio(s, rng))
                          for s in chunk])
        with torch.no_grad():
            mels = frontend(audio).float().cpu().numpy()
        for s, mel in zip(chunk, mels):
            ids = [sot, notime] + [WORD_ID_BASE + i for i in s] \
                + [cfg.eos_token_id]
            train.append((mel, ids))
    with open(os.path.join(args.out, "train.pkl"), "wb") as f:
        pickle.dump(train, f)

    eval_dir = os.path.join(args.out, "eval_wavs")
    os.makedirs(eval_dir, exist_ok=True)
    eval_sents, erng = make_sentences(args.eval_n, args.seed + 2,
                                      args.min_words, args.max_words)
    for j, s in enumerate(eval_sents):
        write_wav(os.path.join(eval_dir, f"utt{j:04d}.wav"),
                  sentence_audio(s, erng))
        with open(os.path.join(eval_dir, f"utt{j:04d}.txt"), "w") as f:
            f.write(" ".join(WORDS[i] for i in s))

    print(json.dumps({
        "out": args.out, "preset": args.preset, "words": len(WORDS),
        "train_utts": len(train), "eval_utts": args.eval_n,
        "hf_dir": hf_dir, "checkpoint": os.path.join(args.out, "ckpt_init"),
    }))


def cmd_export_hf(args):
    import torch
    from transformers import WhisperForConditionalGeneration

    from whisper_trtllm_tpu_torch.models.whisper import export_state_dict
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint

    params, cfg = load_checkpoint(args.checkpoint,
                                  device="cpu" if args.cpu else None)
    hf = WhisperForConditionalGeneration.from_pretrained(
        args.hf_dir, local_files_only=True).eval()
    sd = {k: torch.from_numpy(v)
          for k, v in export_state_dict(params, cfg).items()}
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    # proj_out is tied to embed_tokens; everything else must be present
    missing = [m for m in missing if m != "proj_out.weight"]
    assert not missing and not unexpected, (missing, unexpected)
    hf.save_pretrained(args.hf_dir)
    print(json.dumps({"hf_dir": args.hf_dir,
                      "exported_tensors": len(sd)}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    mk = sub.add_parser("make")
    mk.add_argument("--out", required=True)
    mk.add_argument("--preset", default="tiny.en",
                    help="'tiny.en' etc., or 'toy' for CPU-speed tests")
    mk.add_argument("--train-n", type=int, default=256)
    mk.add_argument("--eval-n", type=int, default=64)
    mk.add_argument("--seed", type=int, default=0)
    mk.add_argument("--min-words", type=int, default=40)
    mk.add_argument("--max-words", type=int, default=88,
                    help="words per sentence; the default fills most of the "
                    "30 s window (0.3 s/word). Sparse sentences (the first "
                    "cut used 3-8 words = ~2 s of signal in 30 s) starve "
                    "cross-attention of alignment supervision and the model "
                    "memorizes instead of learning word acoustics")
    mk.add_argument("--cpu", action="store_true",
                    help="run the mel frontend on the CPU; the default is "
                    "the CUDA card")
    mk.set_defaults(fn=cmd_make)
    ex = sub.add_parser("export-hf")
    ex.add_argument("--checkpoint", required=True)
    ex.add_argument("--hf-dir", required=True)
    ex.add_argument("--cpu", action="store_true",
                    help="load the checkpoint on the CPU; the default is "
                    "the CUDA card")
    ex.set_defaults(fn=cmd_export_hf)
    args = ap.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
