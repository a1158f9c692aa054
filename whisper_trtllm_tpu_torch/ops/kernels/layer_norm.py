"""K5: LayerNorm with fp32 statistics — the wrapper of
``csrc/layer_norm.cu`` and its plain PyTorch version.

Counterpart of ``whisper_trtllm_tpu/ops/pallas/layer_norm.py::
layer_norm_fused``. The wrapper takes the plain version only for CPU
tensors; for a CUDA tensor it launches the kernel or raises.

``LayerNorm`` makes it differentiable: its forward is the wrapper and its
backward the LayerNorm VJP in plain PyTorch ops with fp32 statistics (the
JAX package has no backward kernel: XLA differentiates its LayerNorm).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from whisper_trtllm_tpu_torch.ops.kernels import _build, _launches

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "layer_norm": [_P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _I,
                   _I, _I, _I, _I, _I, _P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 2048
THREADS = 128        # a block's threads when the rows fill more than one
LANE_VECTORS = 4     # vectors a lane holds before another lane joins its row
# the vectors a lane that csrc/layer_norm.cu instantiates, by path: 16-byte
# vectors, 8-byte vectors filling 32 lanes exactly, one value at a time
VECTOR_VPTS = (1, 2, 3, 4, 6, 8, 12, 16)
HALF_VPTS = (1, 2, 3, 4)
SCALAR_VPTS = (1, 2, 3, 4, 8, 16, 32, 64)


class NormPlan(NamedTuple):
    vec: int       # values a vector: 16 or 8 bytes of x's dtype, or 1
    lpr: int       # lanes a row, a power of two
    vpt: int       # vectors a lane; lpr * vpt * vec >= d
    rpw: int       # rows a warp, 32 // lpr
    threads: int   # a block's
    blocks: int    # one warp a row group; the kernel launches one wave


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def norm_plan(rows: int, d: int, elem: int, aligned: bool) -> NormPlan:
    """K5's launch for ``rows`` rows of ``d`` values of ``elem`` bytes.

    Rows that fit in one block (at most ``THREADS // 32`` warps of one row
    each) are bound by the kernel's chain of instructions: 32 lanes a row,
    each with as few values as fill them exactly, in 16-byte vectors or,
    where those leave lanes idle, 8-byte ones. Otherwise 16-byte vectors
    where ``d`` divides into them, else one value at a time; the fewest
    lanes a row (a power of two up to 32) that hold it in
    ``LANE_VECTORS`` vectors a lane, rounded up to an instantiated count.
    Every vector path needs ``aligned`` (every pointer on 16 bytes). Rows
    that fit in one block get just the warps they need, more get
    ``THREADS``-thread blocks, one warp a row group, of which the kernel
    launches one wave (as many as its occupancy lets the card hold) that
    loops over the rest."""
    wide = 16 // elem
    if aligned and rows * 32 <= THREADS:
        for vec, vpts in ((wide, VECTOR_VPTS), (wide // 2, HALF_VPTS)):
            if d % (32 * vec) == 0 and d // (32 * vec) in vpts:
                return NormPlan(vec, 32, d // (32 * vec), 1, rows * 32, 1)
    vec = wide if aligned and d % wide == 0 else 1
    nv = d // vec
    lpr = 1
    while lpr < 32 and lpr * LANE_VECTORS < nv:
        lpr *= 2
    vpt = min(v for v in (VECTOR_VPTS if vec > 1 else SCALAR_VPTS)
              if lpr * v >= nv)
    rpw = 32 // lpr
    warps = _ceil(rows, rpw)
    if warps * 32 <= THREADS:
        return NormPlan(vec, lpr, vpt, rpw, warps * 32, 1)
    return NormPlan(vec, lpr, vpt, rpw, THREADS, _ceil(warps, THREADS // 32))


def layer_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         eps: float = 1e-5) -> torch.Tensor:
    """Plain version: two-pass fp32 mean and variance over the last axis,
    ``(x - mean) * rsqrt(var + eps) * scale (+ bias)``, in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _check(x, scale, bias):
    params = [scale] + ([] if bias is None else [bias])
    if any(p.device != x.device for p in params):
        raise ValueError("layer_norm: x and its parameters must lie on one "
                         "device")
    d = x.shape[-1]
    if any(p.dim() != 1 or p.shape[0] != d for p in params):
        raise ValueError(f"layer_norm: scale and bias must be ({d},), got "
                         f"{[tuple(p.shape) for p in params]}")
    if d > MAX_D:
        raise ValueError(f"layer_norm: the last axis is at most {MAX_D}, got "
                         f"{d}")
    if (x.dtype not in _DTYPES or scale.dtype not in _DTYPES
            or any(p.dtype != scale.dtype for p in params)):
        raise TypeError(f"layer_norm: float32 or bfloat16 x and one float32 "
                        f"or bfloat16 dtype for scale and bias, got "
                        f"{x.dtype}, {[p.dtype for p in params]}")
    if not (x.is_contiguous() and all(p.is_contiguous() for p in params)):
        raise ValueError("layer_norm: x, scale and bias must be contiguous")


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of x (..., d) over d with fp32 statistics; returns x's
    shape and dtype. Has no backward: on the card it refuses inputs that
    require grad (``LayerNorm`` is the differentiable entry). Counts its
    kernel launches in ``layer_norm.launches``."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, scale, bias, eps)
    _check(x, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    _build.refuse_grad("layer_norm", x, scale, bias)
    lib = _build.load("layer_norm", _SIGNATURES)
    d = x.shape[-1]
    rows = x.numel() // d
    out = torch.empty_like(x)
    plan = norm_plan(rows, d, x.element_size(),
                     _build.aligned16(x, scale, bias, out))
    with torch.cuda.device(x.device):
        err = lib.layer_norm(
            x.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), rows,
            d, eps, _DTYPES[x.dtype], _DTYPES[scale.dtype], plan.vec,
            plan.lpr, plan.vpt, plan.blocks, plan.threads,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, "layer_norm")
    _launches.count(layer_norm)
    return out


layer_norm.launches = 0


def layer_norm_backward(x: torch.Tensor, scale: torch.Tensor,
                        dy: torch.Tensor, eps: float = 1e-5):
    """The LayerNorm VJP in fp32: with x̂ = (x - mean) · rstd,
    dx = rstd · (g - mean(g) - x̂ · mean(g · x̂)) for g = dy · scale;
    dscale = Σ dy · x̂ and dbias = Σ dy over the rows. Returns (dx in x's
    dtype, dscale, dbias in scale's dtype)."""
    d = x.shape[-1]
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    dyf = dy.float()
    g = dyf * scale.float()
    dx = rstd * (g - g.mean(dim=-1, keepdim=True)
                 - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    dscale = (dyf * xhat).reshape(-1, d).sum(dim=0)
    dbias = dyf.reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype)


class LayerNorm(torch.autograd.Function):
    """K5 forward, the plain LayerNorm VJP backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return layer_norm(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_backward(x, scale, dy, ctx.eps)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dscale if need[1] else None,
                dbias if need[2] else None, None)
