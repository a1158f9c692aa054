"""K2: single-token masked attention against a static KV cache — the
wrapper of ``csrc/decode_attention.cu`` and its plain PyTorch version, and
the split plan that K2 and K7 (``cross_attention.py``) share.

Counterpart of ``whisper_trtllm_tpu/ops/pallas/decode_attention.py::
decode_mha``, extended to everything ``ops/attention.py::mha_decode_step``
computes around it in the JAX package: int8 and fp8 (e4m3fn) caches with
per-token fp32 scales folded into the scores and the weights, the T-minor
``(B, H, dh, T)`` layout, a per-lane ``(B,)`` ``valid_len`` and an
fp32 additive score bias broadcastable to ``(B, H, 1, T)`` (ALiBi). The
wrapper takes the plain version only for CPU tensors; for a CUDA tensor it
launches the kernel or raises. A call with no (batch, head) pair to
compute returns its empty output and launches nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from whisper_trtllm_tpu_torch.ops.kernels import _build, _launches

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "decode_attn": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _I, _I, _I,
                    _I, _I, _I, _I, _I, _I, _I, _I, _P],
}
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CACHE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                 torch.float8_e4m3fn: 3}
QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)
MAX_T = 53248  # the longest cache the kernel is held to
MAX_DH = 256   # the widest head (csrc/decode_split.cuh's MAX_DH_WIDE)
MASK_VALUE = -1e9

# The split of one (batch, head)'s rows across a cluster of blocks
# (csrc/decode_split.cuh): from the shape and the SM count only, never from
# valid_len, so a captured launch stays right when valid_len changes.
MAX_SPLITS = 16        # the largest cluster (non-portable above 8)
ROW_ALIGN = 16         # chunk and tile rows are multiples of it
MIN_ROWS = 64          # rows a block takes at the least
BLOCKS_PER_SM = 2      # what the split aims for where B * H is small
TILE_BYTES = 32 * 1024  # shared memory of one tile's rows, at most
TILE_ROWS = 64         # rows of a tile, at most
MAX_STAGES = 2         # tiles a block keeps in flight


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def split_plan(t: int, bh: int, row_bytes: int, sms: int,
               t_major: bool = False) -> Tuple[int, int, int, int]:
    """(splits, chunk, tile, stages) for ``t`` rows of each of ``bh``
    (batch, head) pairs, ``row_bytes`` the shared memory one row of a tile
    takes (K, V and their scales), on a card of ``sms`` SMs. Enough splits
    to give every SM ``BLOCKS_PER_SM`` blocks, but no block under
    ``MIN_ROWS`` rows, and at most 16; ``chunk`` rows a block, a multiple
    of 16, no chunk empty of rows; the block walks its chunk in tiles of
    ``tile`` rows (at most ``TILE_BYTES``, and in the dh-minor layout,
    whose rows each slot of lanes takes one after another, at most
    ``TILE_ROWS``), up to ``stages`` of them in flight."""
    cap = TILE_BYTES // row_bytes
    if not t_major:
        cap = min(cap, TILE_ROWS)
    tile_max = max(ROW_ALIGN, cap // ROW_ALIGN * ROW_ALIGN)
    splits = max(1, min(MAX_SPLITS, _ceil(BLOCKS_PER_SM * sms, bh),
                        _ceil(t, MIN_ROWS)))
    chunk = _ceil(_ceil(t, splits), ROW_ALIGN) * ROW_ALIGN
    tile = min(chunk, tile_max)
    return (_ceil(t, chunk), chunk, tile,
            min(MAX_STAGES, _ceil(chunk, tile)))


def tile_row_bytes(dh: int, elem: int, t_major: bool) -> int:
    """Shared memory one cache row takes in a tile's stage: K and V
    (dh-minor rows padded to whole 16- or 8-byte reads) and two scales."""
    vec = 16 // elem if elem > 1 else 8
    dhp = dh if t_major else _ceil(dh, vec) * vec
    return 2 * dhp * elem + 8


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def decode_plan(q: torch.Tensor, cache_k: torch.Tensor,
                t_major: bool) -> Tuple[int, int, int, int]:
    """The split plan of a ``decode_attn`` call on the card."""
    b, h, _, dh = q.shape
    t = cache_k.shape[3] if t_major else cache_k.shape[2]
    return split_plan(t, b * h, tile_row_bytes(dh, cache_k.element_size(),
                                               t_major),
                      sm_count(q.device.index or 0), t_major)


def decode_attention_reference(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    valid_len,
    fp32_softmax: bool = True,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    t_major: bool = False,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain single-token attention, ``mha_decode_step``'s formulas: q
    (B, H, 1, dh) pre-scaled; cache (B, H, T, dh), or (B, H, dh, T) when
    ``t_major``; ``bias`` (broadcastable to (B, H, 1, T)) added to the fp32
    scores after the K scale, relative to its value at each lane's last
    valid row (``relative_bias``); rows at or after ``valid_len`` (a scalar
    or one count per lane) masked with -1e9. With scales (B, H, T, 1) the cache holds
    int8/fp8 values: ``k_scale`` multiplies the fp32 scores, the softmax is
    fp32, and ``v_scale`` multiplies the weights, which are cast to q's
    dtype before P·V; no dequantized cache is formed."""
    # int8 and e4m3 values are exact in bf16 and fp32, so widening the
    # cache straight to fp32 equals the JAX package's cast to q's dtype
    kf = cache_k.float()
    scores = torch.matmul(q.float(), kf if t_major else kf.transpose(-1, -2))
    if k_scale is not None:
        scores = scores * k_scale[..., 0][:, :, None, :]
    vl = torch.as_tensor(valid_len, device=q.device)
    if bias is not None:
        scores = scores + relative_bias(bias, vl, scores.shape)
    t = scores.shape[-1]
    if vl.dim() == 1:
        vl = vl[:, None, None, None]
    scores = scores.masked_fill(torch.arange(t, device=q.device) >= vl,
                                MASK_VALUE)
    if fp32_softmax or k_scale is not None:
        weights = torch.softmax(scores, dim=-1)
    else:
        weights = torch.softmax(scores.to(q.dtype), dim=-1)
    if v_scale is not None:
        weights = weights * v_scale[..., 0][:, :, None, :]
        cache_v = cache_v.to(q.dtype)
    weights = weights.to(q.dtype)
    return torch.matmul(weights,
                        cache_v.transpose(-1, -2) if t_major else cache_v)


def relative_bias(bias: torch.Tensor, valid_len: torch.Tensor,
                  shape) -> torch.Tensor:
    """The fp32 bias to add to scores of ``shape`` (B, H, 1, T): ``bias``
    less its value at each lane's last valid row. The softmax does not
    see a constant a (lane, head), and the difference keeps ``scores +
    bias`` from being rounded at ALiBi's magnitudes: at Bloom's 864 rows
    its bias reaches ~600, where one fp32 step is 6e-5, and the sum so
    rounded sat 3.5e-5 from exact arithmetic. K2 takes the bias so."""
    b, h, _, t = shape
    bias = bias.float().expand(b, h, 1, t)
    last = (valid_len.long() - 1).clamp(0, t - 1).expand(b)
    return bias - bias.gather(3, last.view(b, 1, 1, 1).expand(b, h, 1, 1))


def _check(q, k, v, valid_len, k_scale, v_scale, t_major, bias=None):
    tensors = [q, k, v, valid_len] + [s for s in (k_scale, v_scale, bias)
                                      if s is not None]
    if any(x.device != q.device for x in tensors):
        raise ValueError("decode_attn: q, the cache, its scales and "
                         "valid_len must lie on one device")
    if q.dim() != 4 or q.shape[2] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"decode_attn: q (B,H,1,dh), cache (B,H,T,dh) or (B,H,dh,T); "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, dh = q.shape
    t = k.shape[3] if t_major else k.shape[2]
    if k.shape[:2] != q.shape[:2] or k.shape[2 if t_major else 3] != dh:
        raise ValueError(
            f"decode_attn: cache {tuple(k.shape)} does not fit q "
            f"{tuple(q.shape)} (t_major={t_major})")
    if q.dtype not in _Q_DTYPES or k.dtype != v.dtype:
        raise TypeError(f"decode_attn: float32 or bfloat16 q and one cache "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.dtype in QUANT_DTYPES:
        if k_scale is None:
            raise TypeError(f"decode_attn: a {k.dtype} cache needs scales")
        for s in (k_scale, v_scale):
            if (s.dtype != torch.float32 or tuple(s.shape) != (b, h, t, 1)
                    or not s.is_contiguous()):
                raise ValueError(
                    f"decode_attn: scales must be contiguous float32 "
                    f"(B,H,T,1) = {(b, h, t, 1)}, got {s.dtype} "
                    f"{tuple(s.shape)}")
    elif k.dtype != q.dtype or k_scale is not None:
        raise TypeError(
            f"decode_attn: a float cache has q's dtype and no scales; got q "
            f"{q.dtype}, cache {k.dtype}, scales {k_scale is not None}")
    if dh % 8 or dh > MAX_DH:
        raise ValueError(f"decode_attn: head_dim must be a multiple of 8 up "
                         f"to {MAX_DH}, got {dh}")
    if t > MAX_T:
        raise ValueError(f"decode_attn: cache length {t} exceeds "
                         f"MAX_T ({MAX_T})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attn: q and the cache must be contiguous")
    # the caches the decode path makes start rows on 8- or 16-byte pieces
    # (dh-minor) or runs of 4 elements (T-minor, T % 4 == 0); the kernel
    # bulk-copies them where 16 bytes align and copies element by element
    # otherwise, and refuses what no caller makes
    if t_major:
        align = k.element_size() * (4 if t % 4 == 0 else 1)
    else:
        align = 8 if k.element_size() == 1 else 16
    if k.data_ptr() % align or v.data_ptr() % align:
        raise ValueError(f"decode_attn: cache rows must be {align}-byte "
                         f"aligned")
    if (valid_len.dtype != torch.int32 or valid_len.dim() > 1
            or valid_len.numel() not in (1, b)):
        raise TypeError("decode_attn: valid_len must be one int32 or one per "
                        "lane (B,) on q's device")
    if bias is not None:
        # no path makes another bias (ALiBi's is fp32 (1, H, 1, T)): the
        # rest is ROADMAP Queue 2 item 2
        if bias.dtype != torch.float32:
            raise NotImplementedError(
                f"decode_attn: the kernel takes a float32 bias, got "
                f"{bias.dtype} (ROADMAP Queue 2 item 2)")
        if (bias.dim() != 4 or bias.shape[2] != 1 or bias.shape[3] != t
                or bias.shape[0] not in (1, b) or bias.shape[1] not in (1, h)):
            raise NotImplementedError(
                f"decode_attn: the bias must broadcast to (B, H, 1, T) = "
                f"{(b, h, 1, t)} with T whole, got {tuple(bias.shape)} "
                f"(ROADMAP Queue 2 item 2)")


def decode_attn(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                valid_len: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None,
                t_major: bool = False,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, 1, dh) pre-scaled; cache (B, H, T, dh), or (B, H, dh, T)
    when ``t_major``, in q's dtype, or int8/fp8 with fp32 scales
    (B, H, T, 1) for each; ``valid_len`` an int32 tensor on the device,
    one count or one per lane, read by the kernel (no host sync). fp32
    softmax. ``bias``, an fp32 tensor broadcastable to (B, H, 1, T), is
    added to the scores after the K scale and before the mask (a bias of
    another dtype or shape raises on the card). Returns (B, H, 1, dh) in
    q's dtype. Has no backward: on the
    card it refuses inputs that require grad. Counts its kernel launches in
    ``decode_attn.launches``. Traced by ``torch.export`` on the card, it is
    the operator ``torch.ops.wtpu.decode_attn``."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attn: give both k_scale and v_scale or "
                         "neither")
    if q.device.type == "cpu":
        return decode_attention_reference(q, cache_k, cache_v, valid_len,
                                          k_scale=k_scale, v_scale=v_scale,
                                          t_major=t_major, bias=bias)
    if not isinstance(valid_len, torch.Tensor):
        raise TypeError("decode_attn: valid_len must be an int32 tensor on "
                        "q's device")
    if _build.tracing():
        return _OP(q, cache_k, cache_v, valid_len, k_scale, v_scale, t_major,
                   bias)
    return _launch(q, cache_k, cache_v, valid_len, k_scale, v_scale, t_major,
                   bias)


def _launch(q, cache_k, cache_v, valid_len, k_scale, v_scale,
            t_major: bool, bias=None) -> torch.Tensor:
    _check(q, cache_k, cache_v, valid_len, k_scale, v_scale, t_major, bias)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn: unsupported device {q.device}")
    _build.refuse_grad("decode_attn", q, cache_k, cache_v, k_scale, v_scale,
                       bias)
    b, h, _, dh = q.shape
    if b * h == 0:
        return torch.empty_like(q)
    if bias is not None:
        # the kernel's operand: (B, H, 1, T), stride 0 where it broadcasts,
        # rows contiguous
        bias = (bias if bias.stride(3) == 1 else bias.contiguous()).expand(
            b, h, 1, bias.shape[3])
    # the kernels with a bias build apart (csrc/decode_attention_bias.cu)
    lib = _build.load("decode_attention" if bias is None
                      else "decode_attention_bias", _SIGNATURES)
    t = cache_k.shape[3] if t_major else cache_k.shape[2]
    splits, chunk, tile, stages = decode_plan(q, cache_k, t_major)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.decode_attn(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(),
            valid_len.data_ptr(), int(valid_len.dim() == 1),
            None if bias is None else bias.data_ptr(),
            0 if bias is None else bias.stride(0),
            0 if bias is None else bias.stride(1), out.data_ptr(), b, h, t, dh, _Q_DTYPES[q.dtype],
            _CACHE_DTYPES[cache_k.dtype], int(t_major), splits, chunk, tile,
            stages, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, "decode_attn")
    _launches.count(decode_attn)
    return out


_OP = _build.define_op(
    "decode_attn(Tensor q, Tensor cache_k, Tensor cache_v, Tensor valid_len, "
    "Tensor? k_scale, Tensor? v_scale, bool t_major, Tensor? bias=None) "
    "-> Tensor",
    _launch, lambda q, cache_k, cache_v, valid_len, k_scale, v_scale,
    t_major, bias=None: torch.empty_like(q))

decode_attn.launches = 0
