"""Worked example: a custom fused bias+GELU kernel written by hand in CUDA
C++ for Hopper (``csrc/fused_bias_gelu.cu``), compiled and bound with
``ctypes`` by ``ops/kernels/_build.py``, and held against PyTorch's own exact
GELU (counterpart of ``examples/custom_kernel/custom_gelu_kernel.py``).

    python -m whisper_trtllm_tpu_torch.examples.custom_kernel.custom_gelu_kernel
    python -m whisper_trtllm_tpu_torch.examples.custom_kernel.custom_gelu_kernel --cpu

It runs on the CUDA card and raises without one; ``--cpu`` runs the plain
version instead. It prints one line and exits 0 when the result is within
1e-5 of ``F.gelu(x + bias)``.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import sys
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from whisper_trtllm_tpu_torch.ops.kernels import _build
from whisper_trtllm_tpu_torch.utils.device import resolve_device

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"fused_bias_gelu": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TOLERANCE = 1e-5
THREADS = 256            # at most, a block's
MAX_CPT = 4              # vectors a thread that csrc/fused_bias_gelu.cu takes


class GeluPlan(NamedTuple):
    vec: int      # values a vector: 16 bytes of the dtype, or 1 (scalar)
    cpt: int      # vectors a thread in its column chunk
    tx: int       # column threads a row
    ty: int       # rows a block
    chunks: int   # column chunks of tx * cpt vectors (the grid's y)
    blocks: int   # row blocks; the kernel launches one wave of them


@functools.lru_cache(maxsize=None)
def gelu_plan(rows: int, d: int, elem: int, aligned: bool) -> GeluPlan:
    """K8's launch for x (``rows``, ``d``) of ``elem``-byte values:
    16-byte vectors where ``d`` divides into them and ``aligned`` (every
    pointer on 16 bytes), else one value at a time; a row's vectors over
    at most ``THREADS`` column threads of up to ``MAX_CPT`` vectors each,
    in as many column chunks as that leaves; as many rows a block as fill
    ``THREADS``; row blocks for every row, of which the kernel launches
    one wave (as many as its occupancy lets the card hold) that loops over
    the rest."""
    vec = 16 // elem
    if not (aligned and d % vec == 0):
        vec = 1
    nv = d // vec
    cpt = min(MAX_CPT, -(-nv // THREADS))
    tx = min(THREADS, -(-nv // cpt))
    ty = THREADS // tx
    return GeluPlan(vec, cpt, tx, ty, -(-nv // (tx * cpt)), -(-rows // ty))


def fused_bias_gelu_reference(x: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Plain version: y = x + bias in fp32, 0.5 y (1 + erf(y / sqrt 2)),
    in x's dtype. The erf is taken in fp64 and rounded to fp32: PyTorch's
    fp32 CPU erf was seen off by up to 2.4e-4 on a 2048-element block on
    its first call in a process that had run JAX (not reproduced alone)."""
    y = x.float() + bias.float()
    erf = torch.erf(y.double() * 2.0 ** -0.5).float()
    return (0.5 * y * (1.0 + erf)).to(x.dtype)


def _check(x, bias):
    if x.device != bias.device:
        raise ValueError("fused_bias_gelu: x and bias must lie on one device")
    if x.dim() != 2 or bias.shape != (x.shape[1],):
        raise ValueError(f"fused_bias_gelu: x (B, D) and bias (D,), got "
                         f"{tuple(x.shape)}, {tuple(bias.shape)}")
    if x.dtype not in _DTYPES or bias.dtype != x.dtype:
        raise TypeError(f"fused_bias_gelu: float32 or bfloat16 x and bias of "
                        f"one dtype, got {x.dtype}, {bias.dtype}")
    if not (x.is_contiguous() and bias.is_contiguous()):
        raise ValueError("fused_bias_gelu: x and bias must be contiguous")


def fused_bias_gelu(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (B, D) + bias (D,) → gelu(x + bias), one fused kernel, any B.
    Has no backward: on the card it refuses inputs that require grad.
    Counts its kernel launches in ``fused_bias_gelu.launches``."""
    if x.device.type == "cpu":
        return fused_bias_gelu_reference(x, bias)
    _check(x, bias)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bias_gelu: unsupported device {x.device}")
    _build.refuse_grad("fused_bias_gelu", x, bias)
    lib = _build.load("fused_bias_gelu", _SIGNATURES)
    out = torch.empty_like(x)
    plan = gelu_plan(x.shape[0], x.shape[1], x.element_size(),
                     _build.aligned16(x, bias, out))
    with torch.cuda.device(x.device):
        err = lib.fused_bias_gelu(x.data_ptr(), bias.data_ptr(),
                                  out.data_ptr(), x.shape[0], x.shape[1],
                                  _DTYPES[x.dtype], *plan,
                                  torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, "fused_bias_gelu")
    fused_bias_gelu.launches += 1
    return out


fused_bias_gelu.launches = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain version on the CPU; the default is "
                    "the kernel on the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        rng.standard_normal((512, 384)).astype(np.float32)).to(dev)
    bias = torch.from_numpy(
        rng.standard_normal((384,)).astype(np.float32)).to(dev)

    fused_bias_gelu.launches = 0
    out = fused_bias_gelu(x, bias)
    ref = F.gelu(x + bias, approximate="none")
    err = (out - ref).abs().max().item()
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain version)")
    print(f"fused_bias_gelu on {name}: x (512, 384) float32, "
          f"launches={fused_bias_gelu.launches} max_abs_err={err:.3e} vs "
          f"F.gelu(x + bias) (tol {TOLERANCE:g})", flush=True)
    if not err < TOLERANCE:
        print("fused_bias_gelu: the custom kernel does not match",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
