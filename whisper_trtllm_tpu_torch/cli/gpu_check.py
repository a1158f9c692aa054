"""On-card kernel regression check of the port (counterpart of
``cli/tpu_check.py``): one command that builds and checks every kernel and
quantized path on the CUDA card, each against the port's plain path, and
prints one JSON line of per-check pass/fail, error and kernel launches;
exit 0 iff every check passes.

    python -m whisper_trtllm_tpu_torch.cli.gpu_check              # every check
    python -m whisper_trtllm_tpu_torch.cli.gpu_check --only flash_fwd cross_attn_kernel
    python -m whisper_trtllm_tpu_torch.cli.gpu_check --cpu        # dry run

The checks, shapes and limits are ``tpu_check``'s. Without a card it
prints ``"pass": false`` and exits 1; ``--cpu`` is the explicit dry run of
the harness, where the kernel checks report ``"pass": null``. A full run on
the card writes the state record (``ts``, ``git_head``, ``pass``,
``results``, ``kernel_tree_digest``) to ``build/gpu_check_last.json``, or
to ``$WHISPER_TORCH_CHECK_STATE``; subset and CPU runs write nothing.

All thirteen of ``tpu_check``'s checks, in its order.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from whisper_trtllm_tpu_torch.config import GenerationConfig, WhisperConfig
from whisper_trtllm_tpu_torch.ops.kernels import (
    KERNELS,
    _build,
    reset_launch_counts,
)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _normal(rng, shape, scale, dev):
    x = rng.standard_normal(shape).astype(np.float32) * np.float32(scale)
    return torch.from_numpy(x).to(dev)


def _max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _small_config() -> WhisperConfig:
    return WhisperConfig.testing(d_model=64, encoder_attention_heads=4,
                                 decoder_attention_heads=4,
                                 encoder_ffn_dim=128, decoder_ffn_dim=128,
                                 vocab_size=128)


def check_flash_fwd(dev):
    from whisper_trtllm_tpu_torch.ops.kernels import (
        attention_reference,
        flash_fwd,
    )

    rng = np.random.default_rng(0)
    b, h, s, dh = 4, 6, 1500, 64   # tiny.en encoder shape
    q = _normal(rng, (b, h, s, dh), 0.125, dev)
    k = _normal(rng, (b, h, s, dh), 0.3, dev)
    v = _normal(rng, (b, h, s, dh), 1.0, dev)
    err = _max_err(flash_fwd(q, k, v), attention_reference(q, k, v))
    return err < 2e-4, {"max_err": err}


def check_flash_bwd(dev):
    from whisper_trtllm_tpu_torch.ops.kernels import (
        attention_reference,
        flash_attention,
    )

    rng = np.random.default_rng(1)
    b, h, s, dh = 2, 4, 512, 64
    q = _normal(rng, (b, h, s, dh), 0.125, dev)
    k = _normal(rng, (b, h, s, dh), 0.3, dev)
    v = _normal(rng, (b, h, s, dh), 1.0, dev)
    w = _normal(rng, (b, h, s, dh), 1.0, dev)

    def grads(attn):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        with torch.enable_grad():
            loss = (attn(*leaves) * w).sum()
            return torch.autograd.grad(loss, leaves)

    got = grads(flash_attention)
    ref = grads(attention_reference)
    err = max(_max_err(a, r) for a, r in zip(got, ref))
    return err < 5e-4, {"max_err": err}


def check_flash_causal(dev):
    from whisper_trtllm_tpu_torch.ops.kernels import (
        attention_reference,
        flash_fwd,
    )

    rng = np.random.default_rng(2)
    b, h, s, dh = 2, 4, 1024, 64   # >= the S=768 dispatch boundary
    q = _normal(rng, (b, h, s, dh), 0.125, dev)
    k = _normal(rng, (b, h, s, dh), 0.3, dev)
    v = _normal(rng, (b, h, s, dh), 1.0, dev)
    err = _max_err(flash_fwd(q, k, v, causal=True),
                   attention_reference(q, k, v, causal=True))
    return err < 2e-4, {"max_err": err}


def check_decode_kernel(dev):
    from whisper_trtllm_tpu_torch.ops.kernels import (
        decode_attention_reference,
        decode_attn,
    )

    rng = np.random.default_rng(3)
    b, h, t, dh = 8, 6, 449, 64
    q = _normal(rng, (b, h, 1, dh), 0.125, dev)
    ck = _normal(rng, (b, h, t, dh), 0.3, dev)
    cv = _normal(rng, (b, h, t, dh), 1.0, dev)
    valid = torch.tensor(37, dtype=torch.int32, device=dev)
    err = _max_err(decode_attn(q, ck, cv, valid),
                   decode_attention_reference(q, ck, cv, valid))
    return err < 2e-4, {"max_err": err}


def check_fused_layer(dev):
    """The fused decoder-layer kernel (K6), through decode_step_kv's own
    dispatch on the card, against the same step on the CPU (the unfused
    plain layer)."""
    from whisper_trtllm_tpu_torch.models.whisper import model as wmodel

    cfg = WhisperConfig.tiny_en()
    rng = np.random.default_rng(4)
    b = 4
    enc = (rng.standard_normal((b, cfg.max_source_positions, cfg.d_model))
           .astype(np.float32) * np.float32(0.3))
    toks = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)

    def step(device):
        params = wmodel.init_params(cfg, seed=0, device=device)
        cross_kv = wmodel.compute_cross_kv(
            params, cfg, torch.from_numpy(enc).to(device))
        self_kv = wmodel.init_self_kv(cfg, b, 16, device=device)
        return wmodel.decode_step_kv(params, cfg,
                                     torch.from_numpy(toks).to(device), 3,
                                     self_kv, cross_kv)[0].cpu()

    err = _max_err(step(dev), step("cpu"))
    return err < 5e-3, {"max_err": err}


def check_int8_kv_fold(dev):
    """int8 KV cache with the per-token scales folded in against
    dequantize-then-attend in the plain path."""
    from whisper_trtllm_tpu_torch.ops.attention import (
        dequantize_kv,
        mha_decode_step,
        quantize_kv,
    )
    from whisper_trtllm_tpu_torch.ops.kernels import decode_attention_reference

    rng = np.random.default_rng(5)
    b, h, t, dh = 4, 6, 64, 64
    q = _normal(rng, (b, h, 1, dh), 0.125, dev)
    ck = _normal(rng, (b, h, t, dh), 0.3, dev)
    cv = _normal(rng, (b, h, t, dh), 1.0, dev)
    kq, ks = quantize_kv(ck, torch.int8)
    vq, vs = quantize_kv(cv, torch.int8)
    folded = mha_decode_step(q, kq, vq, 50, k_scale=ks, v_scale=vs)
    deq = decode_attention_reference(q, dequantize_kv(kq, ks),
                                     dequantize_kv(vq, vs), 50)
    err = _max_err(folded, deq)
    return err < 2e-4, {"max_err": err}


def check_step_equals_full(dev):
    """The cached decode step equals the teacher-forced decoder: the
    self/cross x step-0/step-n matrix, ten steps."""
    from whisper_trtllm_tpu_torch.models.whisper import model as wmodel

    cfg = _small_config()
    params = wmodel.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(6)
    mel = _normal(rng, (2, 2 * cfg.max_source_positions, cfg.num_mel_bins),
                  1.0, dev)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)).to(dev)
    with torch.no_grad():
        enc = wmodel.encode(params, cfg, mel)
        full = wmodel.decode_full(params, cfg, toks, enc)
        cross_kv = wmodel.compute_cross_kv(params, cfg, enc)
        self_kv = wmodel.init_self_kv(cfg, 2, 10, dtype=enc.dtype, device=dev)
        steps = []
        for i in range(10):
            logits, self_kv = wmodel.decode_step_kv(params, cfg, toks[:, i], i,
                                                    self_kv, cross_kv)
            steps.append(logits)
    err = _max_err(full, torch.stack(steps, dim=1))
    return err < 2e-4, {"max_err": err}


def check_int8_kv_greedy(dev):
    """Greedy decoding with an int8 KV cache tracks the float cache."""
    from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
    from whisper_trtllm_tpu_torch.runtime.generation import greedy_decode

    cfg = _small_config()
    params = wmodel.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(8)
    mel = _normal(rng, (2, 2 * cfg.max_source_positions, cfg.num_mel_bins),
                  1.0, dev)
    with torch.no_grad():
        enc = wmodel.encode(params, cfg, mel)
        t32, _ = greedy_decode(params, cfg, enc,
                               GenerationConfig(max_new_tokens=10))
        t8, _ = greedy_decode(params, cfg, enc, GenerationConfig(
            max_new_tokens=10, kv_cache_dtype="int8"))
    m = min(t32.shape[1], t8.shape[1])
    agree = (t32[:, :m] == t8[:, :m]).float().mean().item()
    return agree >= 0.8, {"token_agreement": agree}


def check_ifb_quantized_lanes(dev):
    """The in-flight batcher with int8 lanes (the quantized ragged step)
    reproduces lockstep int8 greedy exactly: 2 lanes, 3 requests, lane
    stagger and all."""
    from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
    from whisper_trtllm_tpu_torch.runtime.generation import transcribe_tokens
    from whisper_trtllm_tpu_torch.runtime.ifb import InflightBatcher

    cfg = _small_config()
    params = wmodel.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(9)
    mels = rng.standard_normal(
        (3, 2 * cfg.max_source_positions, cfg.num_mel_bins)
    ).astype(np.float32)
    gen = GenerationConfig(max_new_tokens=8, kv_cache_dtype="int8")
    ref_t, ref_l = transcribe_tokens(params, cfg, mels, gen, device=dev)
    ref_t, ref_l = ref_t.cpu().numpy(), ref_l.cpu().numpy()
    b = InflightBatcher(params, cfg, gen, num_lanes=2, segment_steps=3,
                        device=dev)
    rids = [b.submit(mels[i]) for i in range(3)]
    b.run()
    exact = 0
    for i, rid in enumerate(rids):
        out = b.fetch(rid)
        expect = ref_t[i, : ref_l[i]]
        exact += int(out is not None
                     and np.array_equal(out[: len(expect)], expect))
    return exact == 3, {"exact": exact, "quantized_lanes":
                        len(b.state.self_kv) == 4}


def check_paged_vs_contiguous(dev):
    """Decode attention through a shuffled block pool equals the same
    attention over the contiguous cache (K2 on both sides on the card)."""
    from whisper_trtllm_tpu_torch.ops.attention import (
        mha_decode_step,
        paged_mha_decode_step,
    )

    rng = np.random.default_rng(7)
    b, h, dh, tpb, m = 4, 4, 64, 8, 6
    t = tpb * m
    valid = 29
    ck = rng.standard_normal((b, h, t, dh)).astype(np.float32) * 0.3
    cv = rng.standard_normal((b, h, t, dh)).astype(np.float32)
    q = _normal(rng, (b, h, 1, dh), 1.0, dev) * 0.125
    # scatter the contiguous cache into a shuffled pool
    perm = rng.permutation(b * m)
    pool_k = np.zeros((b * m, tpb, h, dh), np.float32)
    pool_v = np.zeros((b * m, tpb, h, dh), np.float32)
    tables = np.zeros((b, m), np.int32)
    for lane in range(b):
        for blk in range(m):
            p = int(perm[lane * m + blk])
            tables[lane, blk] = p
            sl = slice(blk * tpb, (blk + 1) * tpb)
            pool_k[p] = ck[lane, :, sl].transpose(1, 0, 2)
            pool_v[p] = cv[lane, :, sl].transpose(1, 0, 2)

    def on(x):
        return torch.from_numpy(x).to(dev)

    out = paged_mha_decode_step(q, on(pool_k), on(pool_v), on(tables), valid)
    ref = mha_decode_step(q, on(ck), on(cv), valid)
    err = _max_err(out, ref)
    return err == 0.0 or err < 1e-6, {"max_err": err}


def check_cross_attn_kernel(dev):
    """The head-contiguous cross-attention kernel (K7) against the plain
    decode attention on the (B, H, T, dh) layout."""
    from whisper_trtllm_tpu_torch.ops.kernels import (
        cross_decode_mha,
        decode_attention_reference,
    )

    rng = np.random.default_rng(4)
    b, h, t, dh = 4, 6, 1504, 64          # tiny.en cross shapes
    valid = 1500
    q = _normal(rng, (b, h, 1, dh), 0.3, dev)
    ck = _normal(rng, (b, h, t, dh), 0.3, dev)
    cv = _normal(rng, (b, h, t, dh), 1.0, dev)
    ref = decode_attention_reference(q, ck, cv, valid).reshape(b, h * dh)

    def contiguous(c):
        return c.transpose(1, 2).reshape(b, t, h * dh).contiguous()

    out = cross_decode_mha(q[:, :, 0].reshape(b, h * dh), contiguous(ck),
                           contiguous(cv), heads=h, head_dim=dh,
                           valid_len=valid)
    err = _max_err(out, ref)
    return err < 2e-4, {"max_err": err}


def check_stft_kernel(dev):
    """The STFT + mel + log10 frontend kernel (K3) against the same
    frames in numpy."""
    from whisper_trtllm_tpu_torch.audio.features import (
        HOP_LENGTH,
        N_FFT,
        N_FREQ_BINS,
        LogMelSpectrogram,
    )
    from whisper_trtllm_tpu_torch.ops.kernels import stft_log_mel

    rng = np.random.default_rng(5)
    fe = LogMelSpectrogram(80, device=dev)
    n_rows = 300 + 2
    audio_blocks = rng.standard_normal(
        (2, n_rows, HOP_LENGTH)).astype(np.float32) * 0.1
    frames = np.concatenate(
        [audio_blocks[:, :-2], audio_blocks[:, 1:-1], audio_blocks[:, 2:]],
        axis=-1)
    basis = fe.dft_basis.cpu().numpy()
    spec = np.einsum("btn,nf->btf", frames, basis)
    power = spec[..., :N_FREQ_BINS] ** 2 + spec[..., N_FREQ_BINS:] ** 2
    ref = np.log10(np.maximum(power @ fe.mel_fb.cpu().numpy(), 1e-10))
    out = stft_log_mel(torch.from_numpy(audio_blocks).to(dev),
                       fe.dft_basis[:N_FFT], fe.mel_fb).cpu().numpy()
    err = float(np.abs(out - ref).max())
    return err < 5e-4, {"max_err": err}


def check_beam_path(dev):
    """Beam search at tiny.en's widths: ``num_beams=1`` reproduces the
    greedy tokens on their common prefix (argmax does not move under the
    beam loop's log-softmax), and K = 2 returns sorted, finite scores."""
    from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
    from whisper_trtllm_tpu_torch.runtime.beam import beam_decode
    from whisper_trtllm_tpu_torch.runtime.generation import greedy_decode

    cfg = WhisperConfig.tiny_en()
    params = wmodel.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(6)
    mel = _normal(rng, (2, 2 * cfg.max_source_positions, cfg.num_mel_bins),
                  0.5, dev)
    with torch.no_grad():
        enc = wmodel.encode(params, cfg, mel)
    g_tokens, g_lens = greedy_decode(params, cfg, enc,
                                     GenerationConfig(max_new_tokens=12))
    b_tokens, _, b_lens = beam_decode(
        params, cfg, enc, GenerationConfig(max_new_tokens=12, num_beams=1))
    n = int(min(g_lens.min(), b_lens[:, 0].min()))
    tok_eq = bool((b_tokens[:, 0, :n] == g_tokens[:, :n]).all())
    _, s2, _ = beam_decode(params, cfg, enc,
                           GenerationConfig(max_new_tokens=12, num_beams=2))
    s2 = s2.cpu().numpy()
    sorted_ok = bool((np.diff(s2, axis=1) <= 1e-6).all())
    finite_ok = bool(np.isfinite(s2[:, 0]).all())
    return tok_eq and sorted_ok and finite_ok, {
        "beam1_eq_greedy": tok_eq, "k2_sorted": sorted_ok,
        "k2_finite": finite_ok, "prefix_len": n}


# name: (check, the kernel it holds, or None for a check of a path that
# also runs on the CPU)
CHECKS = {
    "flash_fwd": (check_flash_fwd, "flash_fwd"),
    "flash_bwd": (check_flash_bwd, "flash_bwd"),
    "flash_causal": (check_flash_causal, "flash_fwd"),
    "decode_kernel": (check_decode_kernel, "decode_attn"),
    "fused_layer": (check_fused_layer, "fused_decoder_layer_step"),
    "int8_kv_fold": (check_int8_kv_fold, None),
    "int8_kv_greedy": (check_int8_kv_greedy, None),
    "ifb_quantized_lanes": (check_ifb_quantized_lanes, None),
    "step_equals_full": (check_step_equals_full, None),
    "paged_vs_contiguous": (check_paged_vs_contiguous, None),
    "cross_attn_kernel": (check_cross_attn_kernel, "cross_decode_mha"),
    "stft_kernel": (check_stft_kernel, "stft_log_mel"),
    "beam_path": (check_beam_path, None),
}

# the kernel sources the checks run, built together before the first check
SOURCES = ("flash_attention", "flash_attention_bwd", "decode_attention",
           "fused_decoder_step", "layer_norm", "cross_attention", "stft")
STATE_PATH_ENV = "WHISPER_TORCH_CHECK_STATE"
DEFAULT_STATE_PATH = os.path.join(ROOT, "build", "gpu_check_last.json")
# the port's compute path that a passing record vouches for: an edit here
# after the record was written means it no longer covers the code
KERNEL_TREE_DIRS = tuple(
    os.path.join("whisper_trtllm_tpu_torch", d)
    for d in ("ops", "csrc", "models/whisper", "quantization", "runtime",
              "audio"))


def kernel_tree_digest(repo_root: str = ROOT) -> str:
    """Content hash of the sources (``.py``, ``.cu``, ``.cuh``) under
    ``KERNEL_TREE_DIRS``."""
    h = hashlib.sha256()
    for d in KERNEL_TREE_DIRS:
        for dirpath, dirnames, filenames in sorted(
                os.walk(os.path.join(repo_root, d))):
            dirnames.sort()
            for fn in sorted(filenames):
                if not fn.endswith((".py", ".cu", ".cuh")):
                    continue
                p = os.path.join(dirpath, fn)
                h.update(os.path.relpath(p, repo_root).encode())
                with open(p, "rb") as f:
                    h.update(f.read())
    return h.hexdigest()[:16]


def _git_head() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, timeout=10, cwd=ROOT).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", help="subset of check names")
    ap.add_argument("--cpu", action="store_true",
                    help="dry run of the harness on the CPU: the checks of "
                    "paths run through the plain versions, the kernel "
                    "checks are skipped")
    args = ap.parse_args(argv)
    names = args.only or list(CHECKS)
    unknown = [n for n in names if n not in CHECKS]
    if unknown:
        ap.error(f"unknown checks: {unknown}; have {sorted(CHECKS)}")
    if not (args.cpu or torch.cuda.is_available()):
        print(json.dumps({"device": "cpu", "pass": False,
                          "error": "no CUDA card (use --cpu to dry-run)"}))
        return 1
    dev = torch.device("cpu" if args.cpu else "cuda")
    if dev.type == "cuda":
        from whisper_trtllm_tpu_torch.utils.device import set_fp32_precision

        set_fp32_precision()
        _build.build(SOURCES)  # one nvcc per source, all at once
    results, ok = {}, True
    for name in names:
        check, kernel = CHECKS[name]
        if dev.type == "cpu" and kernel is not None:
            results[name] = {"pass": None, "skipped": "needs the card"}
            continue
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            passed, info = check(dev)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 — a crash is the finding
            passed, info = False, {"error": f"{type(e).__name__}: {e}"}
        info["launches"] = {k: f.launches for k, f in KERNELS.items()
                            if f.launches}
        if kernel is not None and not info["launches"].get(kernel):
            passed = False
            info.setdefault("error", f"{kernel} was not launched")
        info["pass"] = bool(passed)
        info["s"] = round(time.perf_counter() - t0, 2)
        results[name] = info
        ok &= bool(passed)

    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    report = {"device": where, "pass": bool(ok), **results}
    print(json.dumps(report), flush=True)
    if dev.type == "cuda" and not args.only:
        state = {"ts": time.time(), "git_head": _git_head(), "pass": bool(ok),
                 "results": report, "kernel_tree_digest": kernel_tree_digest()}
        path = os.environ.get(STATE_PATH_ENV, DEFAULT_STATE_PATH)
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with open(path, "w") as f:
                json.dump(state, f, indent=1)
        except OSError as e:
            print(json.dumps({"state_write_error": str(e)}), file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
