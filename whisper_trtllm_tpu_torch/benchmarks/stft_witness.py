"""K3 (``stft_log_mel``) and its plain version held against an fp64 witness.

    python -m whisper_trtllm_tpu_torch.benchmarks.stft_witness \
        [--seeds 32] [--mels 80 128] [--batch 4] [--out FILE]

For each seed, the input of ``chip_smoke.py``'s K3 check (B utterances of
3003 hop blocks of 160 samples, 0.1 × standard normals, the second
utterance silent from block 1501 on) is drawn twice: once by numpy
(``default_rng(seed)``, as the check drew it on the host) and once on the
card (a CUDA ``torch.Generator`` seeded with ``seed``). Each goes through
the kernel, the plain version (two fp32 matmuls, TF32 off) and the same
formula in float64 on the card (the witness). It prints, a line each, the
largest |kernel − plain|, |kernel − witness| and |plain − witness| on the
log10-mel values, and where each of the three lies (frame, mel, the
witness's linear mel energy there and its ratio to the frame's median,
every error there). Beside them, the DFT with the kernel's operand split
summed exactly (``split_products``: the kernel's three products, and the
four with lo·lo), which separates the split's error from the sums'. A last line sums the worst case
of each pair over all seeds. The plain version is also run once with TF32
allowed, to show what a TF32 product would read.

Needs a CUDA card and builds ``csrc/stft.cu``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from whisper_trtllm_tpu_torch.audio.features import (
    HOP_LENGTH,
    N_FFT,
    LogMelSpectrogram,
)
from whisper_trtllm_tpu_torch.ops.kernels import (
    stft_log_mel,
    stft_log_mel_reference,
)
from whisper_trtllm_tpu_torch.utils.device import set_fp32_precision

N_BLOCKS = 3003


def stft_log_mel_witness(x: torch.Tensor, basis: torch.Tensor,
                         mel_fb: torch.Tensor) -> torch.Tensor:
    """The plain version's formula in float64 (fp32 output)."""
    return stft_log_mel_reference(x.double(), basis.double(),
                                  mel_fb.double()).float()


def linear_mel(x, basis, mel_fb) -> torch.Tensor:
    """The witness's mel energies before log10 (float64)."""
    return torch.pow(10.0, stft_log_mel_witness(x, basis, mel_fb).double())


def draw(seed: int, b: int, on_card: bool, device) -> torch.Tensor:
    """The check's input: 0.1 × normals, utterance 1 silent from the middle
    on; numpy on the host or a seeded CUDA generator."""
    shape = (b, N_BLOCKS, HOP_LENGTH)
    if on_card:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        x = torch.randn(shape, generator=gen, device=device) * 0.1
    else:
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(
            rng.standard_normal(shape, dtype="float32") * 0.1).to(device)
    x[1, N_BLOCKS // 2:] = 0.0
    return x


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to tf32 as ``flash_tiles.cuh::to_tf32`` does
    (to nearest, ties away from zero), as float64."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).double()


def split_products(x, basis, mel_fb, terms: int) -> torch.Tensor:
    """The DFT with each operand split as the kernel splits it (hi =
    tf32(x), lo = tf32(x - hi)) and ``terms`` of the products summed
    exactly (3: lo·hi + hi·lo + hi·hi, the kernel's; 4: lo·lo too); power,
    mel and log10 in float64. Isolates the split's error from the sums'."""
    b, n_blocks, hop = x.shape
    n_taps, n_bins = basis.shape[0], basis.shape[1] // 2
    frames = x.reshape(b, n_blocks * hop).unfold(1, n_taps, hop)[
        :, :n_blocks - 2]
    fh = _tf32(frames)
    fl = _tf32(frames.double() - fh)
    bh = _tf32(basis)
    bl = _tf32(basis.double() - bh)
    spec = fl @ bh + fh @ bl + fh @ bh
    if terms == 4:
        spec = spec + fl @ bl
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    mel = (re * re + im * im) @ mel_fb.double()
    return torch.log10(torch.clamp(mel, min=1e-10)).float()


def _where(err: torch.Tensor, energy_of, extra: dict) -> dict:
    """The place of ``err``'s largest value, the witness's energy there
    (and over its frame's median), and each of ``extra`` there."""
    b, f, m = np.unravel_index(int(torch.argmax(err).item()), err.shape)
    energy = energy_of(b)
    return dict(utterance=int(b), frame=int(f), mel=int(m),
                energy=float(energy[f, m]),
                energy_over_median=float(energy[f, m])
                / float(energy[f].median()),
                **{k: float(v[b, f, m]) for k, v in extra.items()})


def compare(x, basis, mel_fb) -> dict:
    out = stft_log_mel(x, basis, mel_fb)
    ref = stft_log_mel_reference(x, basis, mel_fb)
    wit = stft_log_mel_witness(x, basis, mel_fb)
    kp = (out - ref).abs()
    kw = (out - wit).abs()
    pw = (ref - wit).abs()
    s3 = (split_products(x, basis, mel_fb, 3) - wit).abs()
    s4 = (split_products(x, basis, mel_fb, 4) - wit).abs()
    errs = dict(kernel_plain=kp, kernel_witness=kw, plain_witness=pw,
                split3_witness=s3, split4_witness=s4)

    def energy_of(b):
        return linear_mel(x[b:b + 1], basis, mel_fb)[0]

    return dict(
        kernel_plain=float(kp.max()), kernel_witness=float(kw.max()),
        plain_witness=float(pw.max()), split3_witness=float(s3.max()),
        split4_witness=float(s4.max()),
        at=_where(kp, energy_of, errs),
        at_kernel=_where(kw, energy_of, errs),
        at_plain=_where(pw, energy_of, errs),
        kernel_over_limit=int((kw > 2e-4).sum()),
        plain_over_limit=int((pw > 2e-4).sum()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--mels", type=int, nargs="+", default=[80, 128])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", help="also write every line here (JSON lines)")
    ap.add_argument("--only", nargs="+", metavar="SOURCE:SEED",
                    help="only these cases, e.g. card:20 numpy:9")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stft_witness: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    set_fp32_precision()
    lines = []
    worst = {}
    for n_mels in args.mels:
        fe = LogMelSpectrogram(n_mels, device=dev)
        basis, mel_fb = fe.dft_basis[:N_FFT].contiguous(), fe.mel_fb
        for source in ("numpy", "card"):
            for seed in range(args.seeds):
                if args.only and f"{source}:{seed}" not in args.only:
                    continue
                x = draw(seed, args.batch, source == "card", dev)
                row = dict(mels=n_mels, source=source, seed=seed,
                           **compare(x, basis, mel_fb))
                lines.append(row)
                print(json.dumps(row), flush=True)
                key = f"M{n_mels}"
                w = worst.setdefault(key, dict(kernel_plain=0.0,
                                               kernel_witness=0.0,
                                               plain_witness=0.0))
                for k in w:
                    w[k] = max(w[k], row[k])
        torch.backends.cuda.matmul.allow_tf32 = True
        x = draw(0, args.batch, True, dev)
        tf32 = (stft_log_mel_reference(x, basis, mel_fb)
                - stft_log_mel_witness(x, basis, mel_fb)).abs().max()
        set_fp32_precision()
        fp32 = (stft_log_mel_reference(x, basis, mel_fb)
                - stft_log_mel_witness(x, basis, mel_fb)).abs().max()
        row = dict(mels=n_mels, plain_tf32_witness=float(tf32),
                   plain_fp32_witness=float(fp32))
        lines.append(row)
        print(json.dumps(row), flush=True)
    summary = dict(worst=worst, card=torch.cuda.get_device_name(0))
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            for row in lines + [summary]:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
