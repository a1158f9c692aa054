"""K1 and K4: fused attention forward and backward — the wrappers of
``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``, their
plain PyTorch versions, and the ``torch.autograd.Function`` joining them.

Counterpart of ``whisper_trtllm_tpu/ops/pallas/flash_attention.py``:
``flash_fwd`` is ``_fwd_impl``, ``flash_bwd`` is ``_bwd_impl`` and
``FlashAttention`` the custom VJP ``_flash``. A wrapper takes its plain
version only for CPU tensors; for a CUDA tensor it launches its kernel or
raises. ``flash_attention`` is the entry point: where autograd records, it
goes through ``FlashAttention`` (K1 saving its log-sum-exp, K4 in the
backward); otherwise it is one K1 launch that writes no log-sum-exp. A
call with no (batch, head) pair to compute (a rank that holds no heads of a
tree cut over the model axis) returns its empty outputs and launches
nothing: a grid of no blocks is a launch error.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from whisper_trtllm_tpu_torch.ops.kernels import _build, _launches

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}
_BWD_SIGNATURES = {
    "flash_bwd": [_P] * 9 + [_I] * 8 + [_P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MASK_VALUE = -1e9


def _masked_scores(q, k, causal):
    """fp32 scores q k^T (GQA heads repeated), causal entries col > row +
    (T - S) set to -1e9."""
    h, s = q.shape[1], q.shape[2]
    hkv, t = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if causal:
        keep = torch.ones(s, t, dtype=torch.bool, device=q.device).tril(t - s)
        scores = scores.masked_fill(~keep, MASK_VALUE)
    return scores


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
    fp32_softmax: bool = True,
) -> torch.Tensor:
    """Plain full-sequence attention (``ops/attention.py::mha``'s formula).
    q (B, H, S, dh) pre-scaled; k, v (B, Hkv, T, dh) with Hkv | H; fp32
    scores; ``mask`` is additive; causal masks col > row + (T - S)."""
    h, hkv = q.shape[1], k.shape[1]
    if hkv != h:
        v = v.repeat_interleave(h // hkv, dim=1)
    scores = _masked_scores(q, k, causal)
    if mask is not None:
        scores = scores + mask.float()
    if fp32_softmax:
        weights = torch.softmax(scores, dim=-1).to(q.dtype)
    else:
        weights = torch.softmax(scores.to(q.dtype), dim=-1)
    return torch.matmul(weights, v)


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor,
                            causal: bool = False) -> torch.Tensor:
    """Plain version of K1's optional output: each row's fp32 log-sum-exp
    of its masked scores, (B, H, S)."""
    return torch.logsumexp(_masked_scores(q, k, causal), dim=-1)


def flash_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K4, ``_bwd_kernel``'s explicit formula in fp32:
    recompute P from the masked scores, dP = dO V^T, delta = rowsum(P dP),
    dS = P (dP - delta); dq = dS K in q's dtype, dk = dS^T Q and dv = P^T
    dO summed over each GQA group in fp32, then in k's dtype."""
    b, h, s, dh = q.shape
    hkv, t = k.shape[1], k.shape[2]
    group = h // hkv if hkv else 1
    kf, vf = k.float(), v.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=1)
        vf = vf.repeat_interleave(group, dim=1)
    p = torch.softmax(_masked_scores(q, k, causal), dim=-1)
    do = dout.float()
    dp = torch.matmul(do, vf.transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), do)
    dk = dk.reshape(b, hkv, group, t, dh).sum(dim=2)
    dv = dv.reshape(b, hkv, group, t, dh).sum(dim=2)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, causal, what="flash_fwd"):
    if not (q.device == k.device == v.device):
        raise ValueError(f"{what}: q, k, v must lie on one device")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"{what}: q (B,H,S,dh), k/v (B,Hkv,T,dh); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, dh = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[3] != dh or (h % hkv if hkv else h):
        raise ValueError(
            f"{what}: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if causal and s != k.shape[2]:
        raise ValueError(f"{what}: causal needs S == T")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"{what}: float32 or bfloat16 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if dh % 8 or dh > 128:
        raise ValueError(f"{what}: head_dim must be a multiple of 8 up "
                         f"to 128, got {dh}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: q, k, v must be contiguous")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"{what}: q, k, v must start on 16 bytes (the "
                         "kernels copy 16 bytes at a time)")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, with_lse: bool = False):
    """Fused attention; q (B, H, S, dh) pre-scaled, k/v (B, Hkv, T, dh).
    Returns (B, H, S, dh) in q's dtype, and with ``with_lse`` also each
    row's fp32 log-sum-exp (B, H, S), which K4 recomputes the softmax from.
    Has no backward: on the card it refuses inputs that require grad
    (``flash_attention`` is the differentiable entry). Counts its kernel
    launches in ``flash_fwd.launches``. Traced by ``torch.export`` on the
    card, it is the operator ``torch.ops.wtpu.flash_fwd`` (without the
    log-sum-exp, which only training asks for)."""
    if q.device.type == "cpu":
        out = attention_reference(q, k, v, causal=causal)
        return (out, attention_lse_reference(q, k, causal)) if with_lse else out
    if _build.tracing():
        if with_lse:
            raise NotImplementedError("flash_fwd: the log-sum-exp output is "
                                      "not exported")
        return _OP(q, k, v, causal)
    return _launch(q, k, v, causal, with_lse)


def _launch(q, k, v, causal: bool, with_lse: bool = False):
    _check(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    _build.refuse_grad("flash_fwd", q, k, v)
    lib = _build.load("flash_attention", _SIGNATURES)
    b, h, s, dh = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, s, dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b * h == 0:
        return (out, lse) if with_lse else out
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, h, k.shape[1], s, k.shape[2], dh, int(causal),
            _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, "flash_fwd")
    _launches.count(flash_fwd)
    return (out, lse) if with_lse else out


_OP = _build.define_op(
    "flash_fwd(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor",
    _launch, lambda q, k, v, causal: torch.empty_like(q))

flash_fwd.launches = 0


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lse: Optional[torch.Tensor], dout: torch.Tensor,
              causal: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: (dq, dk, dv) of ``flash_fwd(q, k, v, causal)`` for the output
    cotangent ``dout``; ``lse`` is that forward's log-sum-exp (the plain
    version on the CPU recomputes the softmax and takes None). dq in q's
    dtype, dk/dv in k's. Counts its kernel launches (one a call: the dq
    kernel, then the dk/dv kernel) in ``flash_bwd.launches``."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, dout, causal)
    _check(q, k, v, causal, "flash_bwd")
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd: unsupported device {q.device}")
    b, h, s, dh = q.shape
    if (dout.shape != q.shape or dout.dtype != q.dtype
            or dout.device != q.device or not dout.is_contiguous()
            or dout.data_ptr() % 16):
        raise ValueError(f"flash_bwd: dout must be a contiguous, 16-byte "
                         f"aligned {tuple(q.shape)} {q.dtype} on {q.device}")
    if (lse is None or lse.shape != (b, h, s) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_bwd: lse must be K1's contiguous fp32 "
                         f"({b}, {h}, {s}) log-sum-exp")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b * h == 0:
        return dq, dk, dv
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    delta = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, k.shape[1], s, k.shape[2],
            dh, int(causal), _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, "flash_bwd")
    _launches.count(flash_bwd)
    return dq, dk, dv


flash_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """K1 forward, K4 backward (the custom VJP ``_flash``). The forward
    saves q, k, v and, on the card, K1's log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cpu":
            out, lse = flash_fwd(q, k, v, causal=causal), None
        else:
            out, lse = flash_fwd(q, k, v, causal=causal, with_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, lse, dout.contiguous(), ctx.causal)
        need = ctx.needs_input_grad
        return (dq if need[0] else None, dk if need[1] else None,
                dv if need[2] else None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Differentiable fused attention (``flash_mha``): through
    ``FlashAttention`` where autograd records, else one K1 launch that
    writes no log-sum-exp."""
    if _build.needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal)
    return flash_fwd(q, k, v, causal=causal)
