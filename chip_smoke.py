#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``whisper_trtllm_tpu_torch``) on one
CUDA card.

    python3 chip_smoke.py

Three phases; any failure raises and the script exits non-zero:

1. build — compiles every kernel of the main path from ``csrc/`` with
   ``nvcc`` for sm_90a (one ``nvcc`` per source, all at once) and prints
   the build time, ``nvcc``'s register/spill report and the card's name
   and power limit;
2. kernels — holds each kernel against its plain PyTorch version on the
   card at the main path's shapes, in fp32 and bf16, and times the kernel,
   the plain version and one PyTorch library call computing the same
   function (the yardstick; the port never calls it);
3. end to end — loads the trained tiny.en artifact, transcribes the four
   bundled utterances as one batch through ``WhisperSession.transcribe``,
   requires the exact texts of ``artifacts/expected.json``, the same
   tokens as the plain path on the CPU, and the expected kernel launch
   counts, then times each stage.

The line before the last is one JSON object with every ported kernel's
numbers; the last is ``{"ok": true, "device": {...}}``. Without a CUDA
card, or without the rest of the repository beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(ROOT, "artifacts", "tiny_en_synth_int8")
EVAL_DIR = os.path.join(ROOT, "artifacts", "eval")
SEED = 0
DEVICE = "cuda"

# H100 SXM published peaks (dense): device memory bytes/s and flop/s by the
# inputs' type — fp32 outside the tensor cores, bf16 on them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# fp32: the kernel reorders sums (online softmax, lane-group dots);
# bf16: the plain version rounds the softmax weights to bf16 before P·V
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}
L2_BYTES = 50e6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, arg_sets, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches, cycling through
    ``arg_sets`` so that the inputs of one launch are not in L2 from the
    last, as in the decode loop where other layers' caches pass between."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def n_sets(set_bytes: float) -> int:
    return max(2, min(8, math.ceil(2 * L2_BYTES / set_bytes)))


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def check_flash(torch, rng, card):
    import torch.nn.functional as F

    from whisper_trtllm_tpu_torch.ops.kernels import (
        attention_reference,
        flash_fwd,
    )

    cases = [  # (name, B, H, Hkv, S=T, dh, causal)
        ("encoder", 4, 6, 6, 1500, 64, False),
        ("gqa", 4, 6, 2, 1500, 64, False),
        ("causal", 4, 6, 6, 1500, 64, True),
        ("dh128", 1, 2, 2, 300, 128, False),
    ]
    headline = None
    for name, b, h, hkv, s, dh, causal in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            item = torch.tensor([], dtype=dtype).element_size()
            set_bytes = (2 * b * h * s * dh + 2 * b * hkv * s * dh) * item
            sets = []
            for _ in range(n_sets(set_bytes)):
                q = rng.standard_normal((b, h, s, dh), dtype="float32") / math.sqrt(dh)
                k = rng.standard_normal((b, hkv, s, dh), dtype="float32")
                v = rng.standard_normal((b, hkv, s, dh), dtype="float32")
                sets.append(tuple(torch.from_numpy(x).to(DEVICE, dtype)
                                  for x in (q, k, v)))
            q, k, v = sets[0]
            out = flash_fwd(q, k, v, causal=causal)
            ref = attention_reference(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if not math.isfinite(err) or err > TOLERANCE[dn]:
                fail(f"flash_fwd {name} {dn}: max |kernel - plain| = {err} "
                     f"> {TOLERANCE[dn]}")
            iters = 20
            ms = time_ms(torch, lambda q, k, v: flash_fwd(q, k, v, causal=causal),
                         sets, iters)
            plain = time_ms(torch, lambda q, k, v: attention_reference(
                q, k, v, causal=causal), sets, iters)
            lib = time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, scale=1.0, is_causal=causal, enable_gqa=hkv != h),
                sets, iters)
            pairs = s * (s + 1) / 2 if causal else s * s
            flops = 4.0 * b * h * pairs * dh
            nbytes = (2 * b * h * s * dh + 2 * b * hkv * s * dh) * item
            b_ms, b_by = bound(nbytes, flops, dn)
            print(f"kernel flash_fwd {name} {dn} B={b} H={h} Hkv={hkv} "
                  f"S=T={s} dh={dh} causal={causal}: max_abs_err={err:.3e} "
                  f"(tol {TOLERANCE[dn]}) ms={ms:.4f} plain_ms={plain:.4f} "
                  f"library_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                  f"[{card}]")
            if name == "encoder" and dtype == torch.float32:
                headline = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    return headline


def check_decode(torch, rng, card):
    import torch.nn.functional as F

    from whisper_trtllm_tpu_torch.ops.kernels import (
        decode_attention_reference,
        decode_attn,
    )

    b, h, dh = 4, 6, 64
    cases = [  # (name, T, valid lengths checked, valid length timed)
        ("self", 33, list(range(1, 34)), 33),
        ("cross", 1504, [1500], 1500),
    ]
    headline = None
    for name, t, sweep, vl_timed in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            item = torch.tensor([], dtype=dtype).element_size()
            sets = []
            for _ in range(n_sets(2 * b * h * t * dh * item)):
                q = rng.standard_normal((b, h, 1, dh), dtype="float32") / math.sqrt(dh)
                k = rng.standard_normal((b, h, t, dh), dtype="float32")
                v = rng.standard_normal((b, h, t, dh), dtype="float32")
                sets.append(tuple(torch.from_numpy(x).to(DEVICE, dtype)
                                  for x in (q, k, v)))
            q, k, v = sets[0]
            err = 0.0
            for vl in sweep:
                vlt = torch.tensor(vl, dtype=torch.int32, device=DEVICE)
                out = decode_attn(q, k, v, vlt)
                ref = decode_attention_reference(q, k, v, vlt)
                torch.cuda.synchronize()
                e = (out.float() - ref.float()).abs().max().item()
                if not math.isfinite(e) or e > TOLERANCE[dn]:
                    fail(f"decode_attn {name} {dn} valid_len={vl}: "
                         f"max |kernel - plain| = {e} > {TOLERANCE[dn]}")
                err = max(err, e)
            vlt = torch.tensor(vl_timed, dtype=torch.int32, device=DEVICE)
            iters = 200
            ms = time_ms(torch, lambda q, k, v: decode_attn(q, k, v, vlt),
                         sets, iters)
            plain = time_ms(torch, lambda q, k, v: decode_attention_reference(
                q, k, v, vlt), sets, iters)
            lib = time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
                q, k[:, :, :vl_timed], v[:, :, :vl_timed], scale=1.0),
                sets, iters)
            flops = 4.0 * b * h * vl_timed * dh
            nbytes = (2 * b * h * dh + 2 * b * h * vl_timed * dh) * item + 4
            b_ms, b_by = bound(nbytes, flops, dn)
            print(f"kernel decode_attn {name} {dn} B={b} H={h} T={t} dh={dh} "
                  f"valid_len={sweep[0]}..{sweep[-1]}: max_abs_err={err:.3e} "
                  f"(tol {TOLERANCE[dn]}) at valid_len={vl_timed}: "
                  f"ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by}) [{card}]")
            if name == "cross" and dtype == torch.float32:
                headline = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    return headline


# --------------------------------------------------------------------------
# phase 3: end to end
# --------------------------------------------------------------------------

def end_to_end(torch, np, card):
    from whisper_trtllm_tpu_torch.audio import pad_or_trim, read_wav
    from whisper_trtllm_tpu_torch.config import GenerationConfig
    from whisper_trtllm_tpu_torch.ops.kernels import (
        KERNELS,
        reset_launch_counts,
    )
    from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
    from whisper_trtllm_tpu_torch.utils.vocab import ids_to_text

    with open(os.path.join(ROOT, "artifacts", "expected.json")) as f:
        expected = json.load(f)["texts"]
    waves = [read_wav(os.path.join(EVAL_DIR, f"utt{i:02d}.wav"))
             for i in range(len(expected))]
    audio_s = sum(len(w) for w in waves) / 16000.0
    audio = np.stack([pad_or_trim(w) for w in waves])
    gen = GenerationConfig(max_new_tokens=32)

    params, cfg = load_checkpoint(ARTIFACT, device=DEVICE)
    session = WhisperSession(params, cfg, gen, device=DEVICE)

    # the main path, counted: launches made from here to the read below
    reset_launch_counts()
    tokens, lengths = session.transcribe(audio)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in KERNELS.items()}

    texts = [ids_to_text(tokens[i, :lengths[i]]) for i in range(len(expected))]
    steps = int(lengths.max()) - 1
    print(f"e2e: tokens {tokens.shape} lengths {lengths.tolist()} "
          f"decode steps {steps} launches {launches}")
    for got, want in zip(texts, expected):
        print(f"e2e: {'ok  ' if got == want else 'BAD '} {got!r}")
    if texts != expected:
        fail("transcripts differ from artifacts/expected.json")
    want = {"flash_fwd": cfg.encoder_layers,
            "decode_attn": 2 * cfg.decoder_layers * steps}
    if launches != want:
        fail(f"kernel launches {launches}, expected {want}")

    params_cpu, _ = load_checkpoint(ARTIFACT, device="cpu")
    tok_cpu, len_cpu = WhisperSession(params_cpu, cfg, gen,
                                      device="cpu").transcribe(audio)
    if not (np.array_equal(tok_cpu, tokens) and np.array_equal(len_cpu, lengths)):
        fail("card tokens differ from the plain path's tokens on the CPU")
    print("e2e: tokens equal the plain path's on the CPU")

    def timed(fn, reps=5):
        out, times = None, []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(times), min(times), max(times)

    audio_t = torch.from_numpy(audio)
    with torch.inference_mode():
        mel, fe_ms, fe_lo, fe_hi = timed(lambda: session.frontend(audio_t))
        enc, en_ms, en_lo, en_hi = timed(lambda: session.encode(mel))
        _, de_ms, de_lo, de_hi = timed(
            lambda: gen_rt.greedy_decode(session.params, cfg, enc, gen))
    _, tr_ms, tr_lo, tr_hi = timed(lambda: session.transcribe(audio))
    stats = session.memory_stats()
    print(f"e2e timing (median of 5, min..max) batch 4, {steps} decode steps "
          f"[{card}]: frontend {fe_ms:.2f} ms ({fe_lo:.2f}..{fe_hi:.2f}), "
          f"encode {en_ms:.2f} ms ({en_lo:.2f}..{en_hi:.2f}), "
          f"decode {de_ms:.2f} ms ({de_lo:.2f}..{de_hi:.2f}), "
          f"transcribe {tr_ms:.2f} ms ({tr_lo:.2f}..{tr_hi:.2f}), "
          f"per decode step {de_ms / steps:.3f} ms")
    print(f"e2e throughput [{card}]: {audio_s / (tr_ms / 1e3):.2f} audio-s/s "
          f"of speech ({audio_s:.2f} s in 4 utterances), "
          f"{4 * 30.0 / (tr_ms / 1e3):.2f} audio-s/s of 30 s windows; "
          f"peak device memory {stats['peak_bytes_in_use']} bytes")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a CUDA card")
    import numpy as np

    sys.path.insert(0, ROOT)
    from whisper_trtllm_tpu_torch.ops.kernels import _build
    from whisper_trtllm_tpu_torch.utils.device import set_fp32_precision

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    sources = ["flash_attention", "decode_attention"]
    t0 = time.perf_counter()
    _build.build(sources)
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(sources)} "
          f"sources (nvcc -gencode arch=compute_90a,code=sm_90a)")
    for src in sources:
        log = _build.library_path(src).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {src}: {line.strip()}")

    set_fp32_precision()
    rng = np.random.default_rng(SEED)
    flash = check_flash(torch, rng, card)
    decode = check_decode(torch, rng, card)
    launches = end_to_end(torch, np, card)

    rows = [
        dict(name="flash_fwd", route="cuda",
             source="whisper_trtllm_tpu_torch/csrc/flash_attention.cu",
             replaces="whisper_trtllm_tpu/ops/pallas/flash_attention.py:89",
             launches=launches["flash_fwd"], **flash),
        dict(name="decode_attn", route="cuda",
             source="whisper_trtllm_tpu_torch/csrc/decode_attention.cu",
             replaces="whisper_trtllm_tpu/ops/pallas/decode_attention.py:80",
             launches=launches["decode_attn"], **decode),
    ]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
