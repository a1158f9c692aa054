"""One-line JSON benchmark of the port on the card: end-to-end ASR
throughput in audio-seconds per second (counterpart of the repository's
``bench.py``, same protocol and constants).

    python -m whisper_trtllm_tpu_torch.cli.bench [--fp32]

Gate first: the record of the last full ``cli.gpu_check`` run on the card
(``build/gpu_check_last.json``, or ``$WHISPER_TORCH_CHECK_STATE``) must
pass and carry the ``kernel_tree_digest`` of the sources about to be
measured. A missing, failing or stale record makes the bench run
``python -m whisper_trtllm_tpu_torch.cli.gpu_check`` in a subprocess; if
the record still does not pass, it prints the gate and exits 1 before
measuring anything. No switch bypasses the gate.

Then, tiny.en from ``init_params(seed=0)`` with EOS disabled (every
utterance decodes exactly ``GEN_TOKENS`` tokens), through
``WhisperSession`` on the card:

- headline: bf16 compute, int8 KV caches (cross cache T-minor through
  "auto"), ``N_BATCHES`` batches of ``BATCH`` random 30 s utterances staged
  on the card, the log-mel frontend inside each timed pass; one warm-up
  pass (which also builds the kernels), then the median of ``REPEATS``
  passes with their min and max;
- the bf16-KV series under the same protocol, and with ``--fp32`` the fp32
  series (fp32 weights, compute and KV);
- p50 latency of one utterance at batch 1 over ``P50_RUNS`` runs;
- MFU, achieved TFLOP/s and the decode loop's device-memory floor from
  ``benchmarks/roofline.py`` and the card's data-sheet peaks;
- medium.en and large-v3 sections: int8 weight-only weights through the
  session's load-time chain, bf16 compute, int8 KV, ``SECTION_BATCHES``
  batches of ``SECTION_BATCH`` random mels, timed as the headline, and an
  encode timed on its own so that the decode loop gets its own roofline
  fraction. Unlike ``bench.py``, a large-v3 failure is not caught: int8
  large-v3 at batch 16 fits an 80 GB card, so a failure there is a fault.

Every timed region ends in ``torch.cuda.synchronize()``. The last line of
standard output is one JSON object; ``bench.py``'s keys, with
``gpu_check`` for ``tpu_check``, ``backend`` "cuda", and the card's name
and power limit under ``device``. Exit 0 only when the gate passes; without
a card, exit 1 with no result line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from whisper_trtllm_tpu_torch.audio.features import N_SAMPLES
from whisper_trtllm_tpu_torch.benchmarks import roofline
from whisper_trtllm_tpu_torch.benchmarks.benchmark import card_info, timed_calls
from whisper_trtllm_tpu_torch.benchmarks.mem_monitor import MemoryMonitor
from whisper_trtllm_tpu_torch.config import (
    GenerationConfig,
    RuntimeConfig,
    WhisperConfig,
)
from whisper_trtllm_tpu_torch.models.whisper import init_params
from whisper_trtllm_tpu_torch.runtime.session import WhisperSession

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# bench.py's estimate of the HF torch fp32 tiny.en end-to-end throughput on
# a GPU; vs_baseline = value / (1.5 x that), so >= 1.0 meets the target
HF_GPU_AUDIO_S_PER_S = 30.0
TARGET_MULTIPLIER = 1.5
BATCH = 32             # the serving batch of bench.py's headline
N_BATCHES = 3          # 96 utterances
GEN_TOKENS = 48        # tokens decoded per utterance (no EOS early exit)
AUDIO_SECONDS_PER_UTT = 30.0
REPEATS = 3            # timed passes after the warm-up; the median is kept
P50_RUNS = 10
SECTION_BATCH = 16
SECTION_BATCHES = 2
# a rerun of the hardware check builds every kernel and runs 10 checks
GATE_TIMEOUT_S = 1800


# --------------------------------------------------------------------------
# the gate: the last full hardware check must vouch for these sources
# --------------------------------------------------------------------------

def _read_state(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def gpu_check_gate() -> dict:
    """{"status": "pass" | "fail" | "missing", ...} from the record of the
    last full ``cli.gpu_check`` run, rerunning the check in a subprocess
    when the record is missing, failing or stale (its
    ``kernel_tree_digest`` is not the tree's)."""
    from whisper_trtllm_tpu_torch.cli import gpu_check

    path = os.environ.get(gpu_check.STATE_PATH_ENV,
                          gpu_check.DEFAULT_STATE_PATH)
    digest = gpu_check.kernel_tree_digest()
    state = _read_state(path)
    stale = (state is None or not state.get("pass")
             or state.get("kernel_tree_digest") != digest)
    rerun_error = None
    if stale:
        try:  # a subprocess: the check's state must not leak into the bench
            proc = subprocess.run(
                [sys.executable, "-m", "whisper_trtllm_tpu_torch.cli.gpu_check"],
                capture_output=True, text=True, timeout=GATE_TIMEOUT_S,
                cwd=ROOT)
            if proc.returncode != 0:
                rerun_error = (f"gpu_check exit {proc.returncode}: "
                               f"{proc.stderr.strip()[-300:]}")
        except (OSError, subprocess.SubprocessError) as e:
            rerun_error = f"{type(e).__name__}: {e}"
        state = _read_state(path)
    if state is None:
        return {"status": "missing",
                "error": f"no gpu_check record at {path} and a fresh run "
                         "wrote none",
                "rerun_error": rerun_error}
    gate = {
        "status": "pass" if (state.get("pass")
                             and state.get("kernel_tree_digest") == digest)
        else "fail",
        "git_head": state.get("git_head"),
        "age_h": (time.time() - float(state.get("ts", 0))) / 3600.0,
        "rerun": stale,
    }
    if state.get("kernel_tree_digest") != digest:
        gate["stale_digest"] = {"record": state.get("kernel_tree_digest"),
                                "tree": digest}
    if rerun_error:
        gate["rerun_error"] = rerun_error
    return gate


# --------------------------------------------------------------------------
# the timed pipeline
# --------------------------------------------------------------------------

def bench_session(cfg: WhisperConfig, kv_cache_dtype: str, compute_dtype: str,
                  weight_dtype: str = "native", gen_tokens: int = GEN_TOKENS,
                  seed: int = 0, device=None) -> WhisperSession:
    """A session over ``init_params(cfg, seed)`` with EOS disabled. The
    float tree is made on the host and goes through the session's
    load-time chain (``weight_dtype="int8"``: weight-only int8 on the host)
    before it moves to ``device`` (the card by default) once."""
    cfg = dataclasses.replace(cfg, eos_token_id=-1)
    params = init_params(cfg, seed=seed, device="cpu")
    return WhisperSession(
        params, cfg,
        GenerationConfig(max_new_tokens=gen_tokens,
                         kv_cache_dtype=kv_cache_dtype),
        RuntimeConfig(compute_dtype=compute_dtype, weight_dtype=weight_dtype),
        device=device)


def run_pass(session: WhisperSession, batches, frontend: bool):
    """Tokens of the last batch of one pass over ``batches``, which lie on
    the session's device: audio (B, N_SAMPLES) through the log-mel
    frontend when ``frontend``, else mels (B, 3000, n_mels)."""
    tokens = None
    for x in batches:
        if frontend:
            with torch.inference_mode():
                x = session.frontend(x)
        tokens, _ = session.transcribe_features(x)
    return tokens


def series(session: WhisperSession, batches, frontend: bool) -> dict:
    """One warm-up pass, then ``REPEATS`` timed passes: the median rate in
    audio-seconds per second, its min and max, the median pass in seconds
    and the peak device memory over the timed passes (GiB, weights
    included)."""
    def one_pass():
        return run_pass(session, batches, frontend)

    one_pass()
    mon = MemoryMonitor(session.device).start()
    _, ms = timed_calls(one_pass, session.device, REPEATS, warmup=0)
    peak = mon.stop()
    times = [t / 1e3 for t in ms]
    audio_s = sum(len(b) for b in batches) * AUDIO_SECONDS_PER_UTT
    rates = sorted(audio_s / t for t in times)
    return {"audio_s_per_s": statistics.median(rates), "min": rates[0],
            "max": rates[-1], "n": len(rates),
            "seconds": statistics.median(times), "peak_mem_gib": peak}


def _spread(s: dict) -> dict:
    return {"min": s["min"], "max": s["max"], "n": s["n"]}


def p50_latency(session: WhisperSession) -> dict:
    """Latency of one silent 30 s utterance at batch 1 (mels made once by
    the frontend): one warm-up call, then ``P50_RUNS`` calls, each ending
    in a sync; ms."""
    with torch.inference_mode():
        mel = session.frontend(torch.zeros((1, N_SAMPLES),
                                           device=session.device))
    _, lats = timed_calls(lambda: session.transcribe_features(mel),
                          session.device, P50_RUNS)
    return {"p50": statistics.median(lats), "min": min(lats),
            "max": max(lats), "n": len(lats)}


def size_section(preset: str, rng: np.random.Generator, peaks,
                 device) -> dict:
    """A full-width preset at the serving precision: int8 weight-only
    weights (the session's chain), bf16 compute, int8 KV, batch
    ``SECTION_BATCH``, ``SECTION_BATCHES`` batches of random mels, and an
    encode timed on its own so that the decode loop (cross K/V included)
    gets its own share of the device-memory floor."""
    peak_tflops, hbm_gbps = peaks
    cfg = WhisperConfig.preset(preset)
    session = bench_session(cfg, "int8", "bfloat16", weight_dtype="int8",
                            device=device)
    mels = [torch.from_numpy(
        (rng.standard_normal((SECTION_BATCH, 2 * cfg.max_source_positions,
                              cfg.num_mel_bins)) * 0.5).astype(np.float32)
    ).to(device, torch.bfloat16) for _ in range(SECTION_BATCHES)]
    s = series(session, mels, frontend=False)
    _, enc = timed_calls(lambda: session.encode(mels[0]), device, REPEATS)
    enc_s = statistics.median(enc) / 1e3
    decode_s = s["seconds"] / SECTION_BATCHES - enc_s
    utts = SECTION_BATCH * SECTION_BATCHES
    tflops = (roofline.pipeline_flops_per_utt(cfg, GEN_TOKENS) * utts
              / s["seconds"] / 1e12)
    bytes_step = roofline.decode_bytes_per_step(
        cfg, SECTION_BATCH, GEN_TOKENS // 2, weight_bytes=1.0, kv_bytes=1.0,
        kv_scale_bytes=4.0)
    floor_s = GEN_TOKENS * bytes_step / (hbm_gbps * 1e9) if hbm_gbps else None
    return {
        "audio_s_per_s": s["audio_s_per_s"],
        "spread": _spread(s),
        "config": f"int8 weights + int8 KV, bf16, batch {SECTION_BATCH}",
        "mfu": tflops / peak_tflops if peak_tflops else None,
        "achieved_tflops": tflops,
        "encode_ms_per_batch": enc_s * 1e3,
        "decode_ms_per_batch": decode_s * 1e3,
        "decode_hbm_floor_ms": floor_s * 1e3 if floor_s else None,
        "decode_roofline_frac": (floor_s / decode_s
                                 if floor_s and decode_s > 0 else None),
        "peak_mem_gib": s["peak_mem_gib"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fp32", action="store_true",
                    help="also time the fp32 series (fp32 weights, compute "
                         "and KV caches)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: needs a CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    gate = gpu_check_gate()
    if gate["status"] != "pass":
        print(json.dumps({"gpu_check": gate}))
        return 1
    dev = torch.device("cuda")
    cfg = WhisperConfig.tiny_en()
    rng = np.random.default_rng(0)
    # staged on the card before timing, as a server holds its requests
    audio = [torch.from_numpy(
        rng.standard_normal((BATCH, N_SAMPLES)).astype(np.float32)
        * np.float32(0.1)).to(dev) for _ in range(N_BATCHES)]

    session = bench_session(cfg, "int8", "bfloat16", device=dev)
    head = series(session, audio, frontend=True)
    p50 = p50_latency(session)
    # one session on the card at a time: each series' peak holds its own
    # weights only
    del session
    compat = series(bench_session(cfg, "auto", "bfloat16", device=dev),
                    audio, frontend=True)
    fp32 = (series(bench_session(cfg, "auto", "float32", device=dev), audio,
                   frontend=True) if args.fp32 else None)
    del audio
    torch.cuda.empty_cache()

    peaks = roofline.chip_peaks(torch.cuda.get_device_name(dev))
    peak_tflops, hbm_gbps = peaks
    flops_utt = roofline.pipeline_flops_per_utt(cfg, GEN_TOKENS)
    achieved_tflops = flops_utt * BATCH * N_BATCHES / head["seconds"] / 1e12
    mfu = achieved_tflops / peak_tflops if peak_tflops else None
    # the decode loop's floor at the headline batch, mid-decode cache
    # length: bf16 weights, int8 KV with fp32 scales
    bytes_step = roofline.decode_bytes_per_step(cfg, BATCH, GEN_TOKENS // 2,
                                                kv_bytes=1.0,
                                                kv_scale_bytes=4.0)
    floor_ms = (GEN_TOKENS * bytes_step / (hbm_gbps * 1e9) * 1e3
                if hbm_gbps else None)

    sections = {}
    for key, preset in (("medium", "medium.en"), ("large", "large-v3")):
        sections[key] = size_section(preset, rng, peaks, dev)
        torch.cuda.empty_cache()

    print(json.dumps({
        "metric": "audio_seconds_per_second_per_chip",
        "value": head["audio_s_per_s"],
        "headline_spread": _spread(head),
        "unit": "audio-s/s",
        "vs_baseline": head["audio_s_per_s"]
        / (TARGET_MULTIPLIER * HF_GPU_AUDIO_S_PER_S),
        "config": f"bf16 weights + int8 KV (T-minor), batch {BATCH}",
        "headline_peak_mem_gib": head["peak_mem_gib"],
        "bf16_kv_audio_s_per_s": compat["audio_s_per_s"],
        "bf16_kv_spread": _spread(compat),
        "bf16_kv_peak_mem_gib": compat["peak_mem_gib"],
        "model_gflops_per_utt": flops_utt / 1e9,
        "achieved_tflops": achieved_tflops,
        "mfu": mfu,
        "peak_bf16_tflops": peak_tflops,
        "decode_bytes_per_step": int(bytes_step),
        "decode_hbm_floor_ms_per_batch": floor_ms,
        "fp32_audio_s_per_s": fp32["audio_s_per_s"] if fp32 else None,
        "fp32_spread": _spread(fp32) if fp32 else None,
        "fp32_peak_mem_gib": fp32["peak_mem_gib"] if fp32 else None,
        "p50_latency_ms_batch1": p50["p50"],
        "p50_spread": {k: p50[k] for k in ("min", "max", "n")},
        "model": "whisper-tiny.en (random weights)",
        "batch": BATCH,
        "utterances": BATCH * N_BATCHES,
        "gen_tokens_per_utt": GEN_TOKENS,
        "backend": "cuda",
        "baseline_def": "1.5x estimated HF-GPU tiny.en e2e (30 audio-s/s)",
        "medium": sections["medium"],
        "large": sections["large"],
        "gpu_check": gate,
        "device": card_info(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
