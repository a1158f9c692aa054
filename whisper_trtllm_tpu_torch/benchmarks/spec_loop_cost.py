"""The cost of a speculative round, apart from acceptance (counterpart of
the repository's ``scripts/spec_loop_cost.py``).

Target and draft carry independent random weights, so greedy acceptance
is about 0: every round gives one token (the target's), and ms an
utterance over rounds is the round's cost. The target is a ``--preset``
(bf16), the draft the 2-layer d 192 micro model over the target's token
configuration. Inputs are random audio through the log-mel frontend.
Each call is timed between two syncs of the card, its tokens fetched to
the host.

  python -m whisper_trtllm_tpu_torch.benchmarks.spec_loop_cost \\
      [--gammas 2,4,6] [--utts 8] [--max-new-tokens 96] \\
      [--preset tiny.en] [--device cuda]

Prints one JSON line for greedy (the mean, median, min and max ms of a
call), then one a gamma. Without a CUDA card it raises unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import numpy as np
import torch

from whisper_trtllm_tpu_torch.audio.features import N_SAMPLES, LogMelSpectrogram
from whisper_trtllm_tpu_torch.benchmarks.benchmark import sync
from whisper_trtllm_tpu_torch.config import GenerationConfig, WhisperConfig
from whisper_trtllm_tpu_torch.models.whisper import cast_params, init_params
from whisper_trtllm_tpu_torch.runtime.generation import transcribe_tokens
from whisper_trtllm_tpu_torch.runtime.speculative import (
    speculative_transcribe_tokens,
)
from whisper_trtllm_tpu_torch.utils.device import resolve_device


def micro_draft(t_cfg: WhisperConfig) -> WhisperConfig:
    """The micro draft: 2 layers, d 192, 3 heads, FFN 768, with the
    target's token configuration, so both propose in one space."""
    return dataclasses.replace(
        t_cfg, d_model=192, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=3, decoder_attention_heads=3,
        encoder_ffn_dim=768, decoder_ffn_dim=768)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gammas", default="2,4,6")
    ap.add_argument("--utts", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=96)
    ap.add_argument("--preset", default="tiny.en",
                    help="the target's preset; the draft stays the micro")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    t_cfg = WhisperConfig.preset(args.preset)
    d_cfg = micro_draft(t_cfg)
    t_params = cast_params(init_params(t_cfg, seed=0, device=dev),
                           torch.bfloat16)
    d_params = cast_params(init_params(d_cfg, seed=1, device=dev),
                           torch.bfloat16)
    frontend = LogMelSpectrogram(t_cfg.num_mel_bins, device=dev)
    rng = np.random.default_rng(0)
    mels = [frontend((rng.standard_normal((1, N_SAMPLES)).astype(np.float32)
                      * 0.1)).to(torch.bfloat16) for _ in range(args.utts)]
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens)

    def greedy(m):
        toks, _ = transcribe_tokens(t_params, t_cfg, m, gen, device=dev)
        return toks[0, -1].cpu()

    greedy(mels[0])                               # capture, warm up
    lat = []
    for m in mels:
        sync(dev)
        t0 = time.perf_counter()
        greedy(m)
        sync(dev)
        lat.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"mode": "greedy", "ms_per_utt": float(np.mean(lat)),
                      "ms_per_utt_median": statistics.median(lat),
                      "ms_min": min(lat), "ms_max": max(lat)}), flush=True)

    for gamma in [int(g) for g in args.gammas.split(",")]:
        speculative_transcribe_tokens(t_params, t_cfg, d_params, d_cfg,
                                      mels[0], gen, gamma=gamma, device=dev)
        rounds_total, ms = 0, 0.0
        for m in mels:
            sync(dev)
            t0 = time.perf_counter()
            out = speculative_transcribe_tokens(
                t_params, t_cfg, d_params, d_cfg, m, gen, gamma=gamma,
                with_stats=True, device=dev)
            host = torch.stack([out[0][0, -1], out[2]]).cpu()
            sync(dev)
            ms += (time.perf_counter() - t0) * 1e3
            rounds_total += int(host[1])
        ms /= len(mels)
        print(json.dumps({
            "mode": f"spec g={gamma}", "ms_per_utt": ms,
            "rounds_per_utt": rounds_total / len(mels),
            "ms_per_round": ms * len(mels) / max(rounds_total, 1),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
