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
   card at the main path's shapes, in fp32 and bf16 (decode attention also
   with int8 and fp8 caches, both cache layouts and per-lane valid
   lengths), and times the kernel, the plain version and, where one
   exists, one PyTorch library call computing the same function (the
   yardstick; the port never calls it);
3. end to end — loads the trained tiny.en artifact and transcribes the
   four bundled utterances as one batch through
   ``WhisperSession.transcribe`` in four configurations: A fp32 with float
   KV caches; B bf16 with int8 KV, cross cache T-minor ("auto"), the
   serving precision; C fp32 with int8 KV, cross cache dh-minor ("bhtd");
   D bf16 with fp8 KV ("auto"). Each must give the exact texts of
   ``artifacts/expected.json`` and the expected launch count of every
   kernel, counted from zero over that one transcribe; A and C must give
   the same tokens as the plain path on the CPU. A and B are timed stage
   by stage.

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
# fp32: the kernel reorders sums (online softmax, lane-group dots, warp
# shuffles); bf16: the plain decode attention rounds the softmax weights to
# bf16 before P·V, and a bf16 LayerNorm output may round the other way (one
# bf16 step, checked relative to max(|plain|, 1))
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}
# log10-mel values: the JAX package's STFT tolerance (fp32 DFT sums in
# another order, amplified by log10 near the floor)
STFT_TOLERANCE = 2e-4
SOURCES = ["flash_attention", "decode_attention", "stft", "layer_norm"]
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


def check_decode_quant(torch, rng, card):
    """K2 with int8/fp8 caches (scales folded in), both cache layouts, fp32
    and bf16 q: a per-lane valid_len sweep at the self-attention shape and
    the scalar cross case. No single PyTorch call computes it: no library
    time."""
    from whisper_trtllm_tpu_torch.ops.attention import quantize_kv
    from whisper_trtllm_tpu_torch.ops.kernels import (
        decode_attention_reference,
        decode_attn,
    )

    b, h, dh = 4, 6, 64
    # per-lane sweep: lane i reads (v + 9 i) mod 34 rows, v = 0..33, so every
    # lane meets every length 0..33 (0: the uniform softmax)
    cases = [("self", 33, [[(v + 9 * i) % 34 for i in range(b)]
                           for v in range(34)], [33] * b),
             ("cross", 1504, [1500], 1500)]
    kinds = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
    for name, t, sweep, vl_timed in cases:
        for kind, qdt in kinds.items():
            for t_major in (False, True):
                for dtype in (torch.float32, torch.bfloat16):
                    dn = str(dtype).split(".")[1]
                    item = torch.tensor([], dtype=dtype).element_size()
                    sets = []
                    for _ in range(n_sets(2 * b * h * t * (dh + 4))):
                        q = rng.standard_normal((b, h, 1, dh), dtype="float32") / math.sqrt(dh)
                        k = rng.standard_normal((b, h, t, dh), dtype="float32")
                        v = rng.standard_normal((b, h, t, dh), dtype="float32")
                        kq, ks = quantize_kv(torch.from_numpy(k).to(DEVICE), qdt)
                        vq, vs = quantize_kv(torch.from_numpy(v).to(DEVICE), qdt)
                        if t_major:
                            kq = kq.transpose(-1, -2).contiguous()
                            vq = vq.transpose(-1, -2).contiguous()
                        sets.append((torch.from_numpy(q).to(DEVICE, dtype),
                                     kq, vq, ks, vs))
                    q, kq, vq, ks, vs = sets[0]
                    err = 0.0
                    for vl in sweep:
                        vlt = torch.tensor(vl, dtype=torch.int32, device=DEVICE)
                        out = decode_attn(q, kq, vq, vlt, ks, vs, t_major)
                        ref = decode_attention_reference(
                            q, kq, vq, vlt, k_scale=ks, v_scale=vs,
                            t_major=t_major)
                        torch.cuda.synchronize()
                        e = (out.float() - ref.float()).abs().max().item()
                        if not math.isfinite(e) or e > TOLERANCE[dn]:
                            fail(f"decode_attn {name} {kind} t_major={t_major} "
                                 f"{dn} valid_len={vl}: max |kernel - plain| "
                                 f"= {e} > {TOLERANCE[dn]}")
                        err = max(err, e)
                    vlt = torch.tensor(vl_timed, dtype=torch.int32, device=DEVICE)
                    ms = time_ms(torch, lambda q, k, v, ks, vs: decode_attn(
                        q, k, v, vlt, ks, vs, t_major), sets, 200)
                    plain = time_ms(torch, lambda q, k, v, ks, vs:
                                    decode_attention_reference(
                                        q, k, v, vlt, k_scale=ks, v_scale=vs,
                                        t_major=t_major), sets, 200)
                    rows = b * h * (vl_timed if isinstance(vl_timed, int)
                                    else vl_timed[0])
                    flops = 4.0 * rows * dh
                    # q and out in q's dtype, 1-byte values and fp32 scales
                    # of the rows read, the valid lengths
                    nbytes = 2 * b * h * dh * item + 2 * rows * (dh + 4) + 4 * b
                    # the arithmetic is fp32 whatever q's dtype
                    b_ms, b_by = bound(nbytes, flops, "float32")
                    print(f"kernel decode_attn {name} {kind} "
                          f"{'bhdt' if t_major else 'bhtd'} q={dn} B={b} H={h} "
                          f"T={t} dh={dh} {len(sweep)} valid_len sets: "
                          f"max_abs_err={err:.3e} (tol {TOLERANCE[dn]}) at "
                          f"valid_len={vl_timed if isinstance(vl_timed, int) else vl_timed[0]}: "
                          f"ms={ms:.4f} plain_ms={plain:.4f} library_ms=none "
                          f"bound_ms={b_ms:.4f} ({b_by}) [{card}]")


def check_stft(torch, rng, card):
    from whisper_trtllm_tpu_torch.audio.features import (
        HOP_LENGTH,
        N_FFT,
        LogMelSpectrogram,
    )
    from whisper_trtllm_tpu_torch.ops.kernels import (
        stft_log_mel,
        stft_log_mel_reference,
    )

    b, n_blocks = 4, 3003
    headline = None
    for n_mels in (80, 128):
        fe = LogMelSpectrogram(n_mels, device=DEVICE)
        basis, mel_fb = fe.dft_basis[:N_FFT], fe.mel_fb
        sets = []
        for _ in range(n_sets(b * n_blocks * HOP_LENGTH * 4)):
            x = rng.standard_normal((b, n_blocks, HOP_LENGTH), dtype="float32") * 0.1
            x[1, n_blocks // 2:] = 0.0  # silence: power at the 1e-10 floor
            sets.append((torch.from_numpy(x).to(DEVICE),))
        out = stft_log_mel(sets[0][0], basis, mel_fb)
        ref = stft_log_mel_reference(sets[0][0], basis, mel_fb)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not math.isfinite(err) or err > STFT_TOLERANCE:
            fail(f"stft_log_mel M={n_mels}: max |kernel - plain| = {err} > "
                 f"{STFT_TOLERANCE}")
        ms = time_ms(torch, lambda x: stft_log_mel(x, basis, mel_fb), sets, 20)
        plain = time_ms(torch, lambda x: stft_log_mel_reference(x, basis, mel_fb),
                        sets, 20)
        n_frames, n_bins = n_blocks - 2, basis.shape[1] // 2
        flops = b * n_frames * (2.0 * N_FFT * 2 * n_bins + 3 * n_bins
                                + 2.0 * n_bins * n_mels)
        nbytes = 4 * (b * n_blocks * HOP_LENGTH + basis.numel()
                      + mel_fb.numel() + b * n_frames * n_mels)
        b_ms, b_by = bound(nbytes, flops, "float32")
        print(f"kernel stft_log_mel B={b} blocks={n_blocks}x{HOP_LENGTH} "
              f"taps={N_FFT} M={n_mels} float32: max_abs_err={err:.3e} "
              f"(tol {STFT_TOLERANCE}) ms={ms:.4f} plain_ms={plain:.4f} "
              f"library_ms=none bound_ms={b_ms:.4f} ({b_by}) [{card}]")
        if n_mels == 80:
            headline = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return headline


def check_layer_norm(torch, rng, card):
    import torch.nn.functional as F

    from whisper_trtllm_tpu_torch.ops.kernels import (
        layer_norm,
        layer_norm_reference,
    )

    d = 384
    cases = [("encoder", (4, 1500, d)), ("decode", (4, 1, d))]
    headline = None
    for name, shape in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            item = torch.tensor([], dtype=dtype).element_size()
            rows = shape[0] * shape[1]
            sets = []
            for _ in range(n_sets(2 * rows * d * item)):
                x = rng.standard_normal(shape, dtype="float32") * 2 + 0.5
                g = 1 + 0.1 * rng.standard_normal(d, dtype="float32")
                bb = 0.1 * rng.standard_normal(d, dtype="float32")
                sets.append(tuple(torch.from_numpy(a).to(DEVICE, dtype)
                                  for a in (x, g, bb)))
            x, g, bb = sets[0]
            err = 0.0
            for bias in (bb, None):
                out = layer_norm(x, g, bias)
                ref = layer_norm_reference(x, g, bias)
                torch.cuda.synchronize()
                diff = (out.float() - ref.float()).abs()
                e = (diff / ref.float().abs().clamp(min=1)).max().item()
                if not math.isfinite(e) or e > TOLERANCE[dn]:
                    fail(f"layer_norm {name} {dn} bias={bias is not None}: "
                         f"max |kernel - plain| / max(|plain|, 1) = {e} > "
                         f"{TOLERANCE[dn]}")
                err = max(err, diff.max().item())
            iters = 200
            ms = time_ms(torch, layer_norm, sets, iters)
            plain = time_ms(torch, layer_norm_reference, sets, iters)
            lib = time_ms(torch, lambda x, g, bb: F.layer_norm(
                x, (d,), g, bb, 1e-5), sets, iters)
            nbytes = (2 * rows * d + 2 * d) * item
            b_ms, b_by = bound(nbytes, 8.0 * rows * d, "float32")
            print(f"kernel layer_norm {name} {dn} rows={rows} d={d}: "
                  f"max_abs_err={err:.3e} (tol {TOLERANCE[dn]} of "
                  f"max(|plain|, 1)) ms={ms:.4f} plain_ms={plain:.4f} "
                  f"library_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) [{card}]")
            if name == "encoder" and dtype == torch.float32:
                headline = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    return headline


# --------------------------------------------------------------------------
# phase 3: end to end
# --------------------------------------------------------------------------

# name: (compute dtype, kv_cache_dtype, cross_kv_layout, held to the CPU
# tokens, timed by stage)
CONFIGS = {
    "A": ("float32", "auto", "auto", True, True),
    "B": ("bfloat16", "int8", "auto", False, True),
    "C": ("float32", "int8", "bhtd", True, False),
    "D": ("bfloat16", "fp8", "auto", False, False),
}


def end_to_end(torch, np, card):
    """Returns each configuration's kernel launch counts."""
    from whisper_trtllm_tpu_torch.audio import pad_or_trim, read_wav
    from whisper_trtllm_tpu_torch.config import GenerationConfig, RuntimeConfig
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
    params, cfg = load_checkpoint(ARTIFACT, device=DEVICE)
    params_cpu, _ = load_checkpoint(ARTIFACT, device="cpu")

    def timed(fn, reps=5):
        out, times = None, []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(times), min(times), max(times)

    counts = {}
    for name, (compute, kv, layout, vs_cpu, timing) in CONFIGS.items():
        tag = f"e2e {name} ({compute}, kv {kv}, cross {layout})"
        gen = GenerationConfig(max_new_tokens=32, kv_cache_dtype=kv,
                               cross_kv_layout=layout)
        rt = RuntimeConfig(compute_dtype=compute)
        session = WhisperSession(params, cfg, gen, rt, device=DEVICE)

        # this path, counted: launches made from here to the read below
        reset_launch_counts()
        tokens, lengths = session.transcribe(audio)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in KERNELS.items()}

        texts = [ids_to_text(tokens[i, :lengths[i]])
                 for i in range(len(expected))]
        steps = int(lengths.max()) - 1
        print(f"{tag}: tokens {tokens.shape} lengths {lengths.tolist()} "
              f"decode steps {steps} launches {launches}")
        for got, want in zip(texts, expected):
            print(f"{tag}: {'ok  ' if got == want else 'BAD '} {got!r}")
        if texts != expected:
            fail(f"{tag}: transcripts differ from artifacts/expected.json")
        want = {"flash_fwd": cfg.encoder_layers,
                "decode_attn": 2 * cfg.decoder_layers * steps,
                "stft_log_mel": 1,
                "layer_norm": (2 * cfg.encoder_layers + 1
                               + (3 * cfg.decoder_layers + 1) * steps)}
        if launches != want:
            fail(f"{tag}: kernel launches {launches}, expected {want}")
        counts[name] = launches

        if vs_cpu:
            tok_cpu, len_cpu = WhisperSession(
                params_cpu, cfg, gen, rt, device="cpu").transcribe(audio)
            if not (np.array_equal(tok_cpu, tokens)
                    and np.array_equal(len_cpu, lengths)):
                fail(f"{tag}: card tokens differ from the plain path's "
                     f"tokens on the CPU")
            print(f"{tag}: tokens equal the plain path's on the CPU")
        if not timing:
            continue
        audio_t = torch.from_numpy(audio)
        with torch.inference_mode():
            mel, fe_ms, fe_lo, fe_hi = timed(lambda: session.frontend(audio_t))
            enc, en_ms, en_lo, en_hi = timed(lambda: session.encode(mel))
            _, de_ms, de_lo, de_hi = timed(
                lambda: gen_rt.greedy_decode(session.params, cfg, enc, gen))
        torch.cuda.reset_peak_memory_stats()
        _, tr_ms, tr_lo, tr_hi = timed(lambda: session.transcribe(audio))
        stats = session.memory_stats()
        print(f"{tag} timing (median of 5, min..max) batch 4, {steps} decode "
              f"steps [{card}]: frontend {fe_ms:.2f} ms ({fe_lo:.2f}..{fe_hi:.2f}), "
              f"encode {en_ms:.2f} ms ({en_lo:.2f}..{en_hi:.2f}), "
              f"decode {de_ms:.2f} ms ({de_lo:.2f}..{de_hi:.2f}), "
              f"transcribe {tr_ms:.2f} ms ({tr_lo:.2f}..{tr_hi:.2f}), "
              f"per decode step {de_ms / steps:.3f} ms")
        print(f"{tag} throughput [{card}]: {audio_s / (tr_ms / 1e3):.2f} "
              f"audio-s/s of speech ({audio_s:.2f} s in 4 utterances), "
              f"{4 * 30.0 / (tr_ms / 1e3):.2f} audio-s/s of 30 s windows; "
              f"peak device memory over the transcribes "
              f"{stats['peak_bytes_in_use']} bytes (weights included)")
    return counts


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

    t0 = time.perf_counter()
    _build.build(SOURCES)
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(SOURCES)} "
          f"sources (nvcc -gencode arch=compute_90a,code=sm_90a)")
    for src in SOURCES:
        log = _build.library_path(src).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {src}: {line.strip()}")

    set_fp32_precision()
    rng = np.random.default_rng(SEED)
    flash = check_flash(torch, rng, card)
    decode = check_decode(torch, rng, card)
    check_decode_quant(torch, rng, card)
    stft = check_stft(torch, rng, card)
    norm = check_layer_norm(torch, rng, card)
    # the launches of configuration B, the serving precision, which runs
    # every kernel of the path
    launches = end_to_end(torch, np, card)["B"]

    rows = [
        dict(name="flash_fwd", route="cuda",
             source="whisper_trtllm_tpu_torch/csrc/flash_attention.cu",
             replaces="whisper_trtllm_tpu/ops/pallas/flash_attention.py:89",
             **flash),
        dict(name="decode_attn", route="cuda",
             source="whisper_trtllm_tpu_torch/csrc/decode_attention.cu",
             replaces="whisper_trtllm_tpu/ops/pallas/decode_attention.py:80",
             **decode),
        dict(name="stft_log_mel", route="cuda",
             source="whisper_trtllm_tpu_torch/csrc/stft.cu",
             replaces="whisper_trtllm_tpu/ops/pallas/stft.py:76", **stft),
        dict(name="layer_norm", route="cuda",
             source="whisper_trtllm_tpu_torch/csrc/layer_norm.cu",
             replaces="whisper_trtllm_tpu/ops/pallas/layer_norm.py:50", **norm),
    ]
    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
