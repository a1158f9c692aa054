"""Attention ops over (B, H, S, dh) tensors (counterpart of
``whisper_trtllm_tpu/ops/attention.py``).

``mha`` dispatches exactly as the JAX package does on the TPU: the fused
flash kernel (K1, with K4 in its backward) takes the unmasked case with
S > 1, dh % 8 == 0 and Hkv | H, bidirectional or causal square with
S == T >= 768, unless ``use_flash=False``. Every other case the JAX package
runs in XLA, and here it runs the plain formula on either device: the
masked case, causal attention below S = 768 (the decoder's self attention
in training: Whisper has at most 448 positions) and ``use_flash=False``
(``decode_full``'s default cross attention). Those are torch matmuls
standing for XLA's products, not cases the kernels have yet to take. A case
inside the flash conditions that K1 does not take (dh > 256) raises on the
card. The decode step's attention always runs K2 on the card, the paged
cache's decode too (each lane's blocks gathered into a window first). A
rank that holds no heads of a tree cut over the model axis
(``parallel/partition.py``) computes nothing: ``mha`` (by the plain
formula on its empty tensors) and ``mha_decode_step`` return its empty
output without a launch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from whisper_trtllm_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_reference,
    decode_attn,
)
from whisper_trtllm_tpu_torch.ops.kernels.flash_attention import (
    attention_reference,
    flash_attention,
)
from whisper_trtllm_tpu_torch.quantization.quantize import divide
from whisper_trtllm_tpu_torch.utils.device import resolve_device

# the causal flash path engages only from this length on: the JAX package's
# choice (ops/attention.py), measured on its TPU
FLASH_CAUSAL_MIN_LEN = 768


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    fp32_softmax: bool = True,
    use_flash: bool = True,
) -> torch.Tensor:
    """Full-sequence attention. q: (B, H, S, dh) pre-scaled by dh**-0.5;
    k, v: (B, Hkv, T, dh) with Hkv | H; ``mask`` additive, broadcastable
    to (B, H, S, T). Differentiable on both paths.

    The JAX package's flash conditions go to ``flash_attention`` (K1, and
    K4 in the backward; the plain versions on the CPU); the rest to the
    plain formula (see the module docstring)."""
    h, s, dh = q.shape[1:]
    hkv, t = k.shape[1], k.shape[2]
    if h == 0:
        # empty products, no launch; kept on autograd's graph, so the
        # backward reaches the rank's collectives as every rank's does
        return attention_reference(q, k, v, causal=causal, mask=mask,
                                   fp32_softmax=fp32_softmax)
    if (use_flash and mask is None and h % hkv == 0 and s > 1
            and dh % 8 == 0
            and (not causal or (s == t and s >= FLASH_CAUSAL_MIN_LEN))):
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal)
    return attention_reference(q, k, v, causal=causal, mask=mask,
                               fp32_softmax=fp32_softmax)


def init_kv_cache(batch: int, heads: int, max_len: int, head_dim: int,
                  dtype=torch.float32, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Preallocated static KV cache (B, H, max_len, dh) ×2 on ``device``
    (the CUDA card by default)."""
    device = resolve_device(device)
    shape = (batch, heads, max_len, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def update_kv_cache(
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write the step's K/V (B, H, 1, dh) at row ``pos`` of the caches.

    Unlike the JAX version, which returns updated arrays, this writes IN
    PLACE into the preallocated caches (and into the stacked (L, ...)
    tensor they may be views of) and returns them. ``pos`` is a scalar,
    an int or a 0-d tensor (lockstep batch), or a (B,) vector: lane b
    writes its row at ``pos[b]``, clamped into the cache as
    ``dynamic_update_slice`` clamps (ragged and in-flight batches). A
    position on the cache's device is never read on the host, so the
    write can be captured in a CUDA graph."""
    idx = pos if isinstance(pos, torch.Tensor) and \
        pos.device == cache_k.device else torch.as_tensor(
            pos, device=cache_k.device)
    if idx.dim() > 1:
        raise ValueError(f"pos must be a scalar or (B,), got shape "
                         f"{tuple(idx.shape)}")
    per_lane = idx.dim() == 1
    if per_lane:
        rows = idx.long().clamp(0, cache_k.shape[2] - 1).view(-1, 1, 1, 1)
    else:
        idx = idx.long().reshape(1)
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        new = new.to(cache.dtype)
        if cache.dtype == torch.float8_e4m3fn:
            # index_copy_ and scatter_ have no fp8 kernels; the bytes are
            # copied unchanged
            cache, new = cache.view(torch.uint8), new.view(torch.uint8)
        if per_lane:
            cache.scatter_(2, rows.expand(new.shape), new)
        else:
            cache.index_copy_(2, idx, new)
    return cache_k, cache_v


def quantize_kv(x: torch.Tensor, dtype=torch.int8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token-per-head symmetric quantization of K/V states, reduced over
    head_dim, to int8 (amax / 127, round half to even, clip to ±127) or
    float8_e4m3fn (amax / 448). Returns (values, fp32 scales with a
    trailing keepdim); ``values.float() * scale`` recovers the states.
    Both quotients are true divisions on every device (``divide``), so the
    card's scales equal the CPU's bit for bit."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if dtype == torch.int8:
        scale = divide(amax.clamp(min=1e-8), 127.0)
        return torch.clamp(torch.round(xf / scale), -127, 127).to(dtype), scale
    if dtype == torch.float8_e4m3fn:
        # 448 is e4m3fn's largest finite value: scaling amax onto it keeps
        # the cast in range
        scale = divide(amax.clamp(min=1e-8), 448.0)
        return (xf / scale).to(dtype), scale
    raise TypeError(f"quantize_kv: int8 or float8_e4m3fn, got {dtype}")


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Quantized cache values → ``dtype`` (tests and inspection; the decode
    step folds the scales into the attention instead)."""
    return q.to(dtype) * scale.to(dtype)


def mha_decode_step(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    valid_len,
    fp32_softmax: bool = True,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    t_major: bool = False,
) -> torch.Tensor:
    """Single-token attention against a static cache: q (B, H, 1, dh);
    cache (B, H, Tmax, dh), or (B, H, dh, Tmax) when ``t_major`` (the
    T-minor cross layout; scales keep (B, H, Tmax, 1)); ``valid_len`` the
    number of valid rows, a scalar or one per lane (B,).

    int8/fp8 caches come with ``k_scale``/``v_scale``: the scales fold into
    the scores and the weights, the softmax is fp32 whatever
    ``fp32_softmax`` says, and no dequantized cache is formed. ``bias``, an
    additive score bias broadcastable to (B, H, 1, Tmax) (Bloom's ALiBi),
    is added after the K scale and before the mask, as the JAX package adds
    it on every branch; on the card K2 takes it in fp32 (another dtype
    raises), taken relative to its value at each lane's last valid row: the
    softmax is the same, and the sum is not rounded at ALiBi's magnitudes
    (``decode_attention.relative_bias``). Every case with an fp32 softmax
    goes to kernel K2."""
    if q.shape[1] == 0:
        return torch.empty_like(q)
    if not (isinstance(valid_len, torch.Tensor)
            and valid_len.dtype == torch.int32
            and valid_len.device == q.device):
        valid_len = torch.as_tensor(valid_len, dtype=torch.int32,
                                    device=q.device)
    if valid_len.dim() > 1:
        raise ValueError(f"valid_len must be a scalar or (B,), got shape "
                         f"{tuple(valid_len.shape)}")
    if fp32_softmax or k_scale is not None:
        return decode_attn(q, cache_k, cache_v, valid_len, k_scale, v_scale,
                           t_major, bias)
    if q.is_cuda:
        raise NotImplementedError(
            "decode attention on CUDA takes its softmax in fp32 only")
    return decode_attention_reference(q, cache_k, cache_v, valid_len,
                                      fp32_softmax=False, t_major=t_major,
                                      bias=bias)


# --------------------------------------------------------------------------
# the paged KV cache: pools of fixed-size blocks addressed by block tables
# (runtime/kv_cache_manager.py keeps the tables on the host)
# --------------------------------------------------------------------------

def init_paged_kv_cache(num_blocks: int, tokens_per_block: int, heads: int,
                        head_dim: int, dtype=torch.float32, device=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paged K/V pools, (num_blocks, tokens_per_block, H, dh) ×2 on
    ``device`` (the CUDA card by default): tokens before heads, so a
    block gather gives (…, tpb, H, dh) windows that reshape to a
    (B, S, H, dh) operand."""
    device = resolve_device(device)
    shape = (num_blocks, tokens_per_block, heads, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _write_rows(pool: torch.Tensor, flat: torch.Tensor, valid: torch.Tensor,
                values: torch.Tensor) -> None:
    """``pool`` viewed as (num_blocks · tpb, H, dh) rows: row ``flat[i]``
    takes ``values[i]`` (N, H, dh) where ``valid[i]``; the rest is dropped,
    as a ``mode="drop"`` scatter drops out-of-range entries. A dropped
    entry rewrites the first valid entry's row with that entry's value (row
    0 with its own value when none is valid), so a row written twice gets
    one value either way, and nothing is read on the host: the first valid
    entry is selected by a device index (a 0-d index tensor would be read
    on the host, which a CUDA graph capture refuses)."""
    rows = pool.view(-1, *pool.shape[2:])
    values = values.to(pool.dtype)
    if pool.dtype == torch.float8_e4m3fn:
        rows, values = rows.view(torch.uint8), values.view(torch.uint8)
    first = valid.int().argmax().view(1)
    any_valid = valid.any()
    row = torch.where(any_valid, flat.index_select(0, first)[0],
                      torch.zeros_like(flat[0]))
    value = torch.where(any_valid, values.index_select(0, first)[0],
                        rows[0])
    rows.index_copy_(0, torch.where(valid, flat, row),
                     torch.where(valid.view(-1, 1, 1), values, value))


def _tables(block_tables, device) -> torch.Tensor:
    return torch.as_tensor(block_tables, device=device).long()


def paged_update_kv_cache(
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    block_tables,
    pos,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one decode step's K/V (B, H, 1, dh) through the block tables
    (B, max_blocks) IN PLACE and return the pools: lane b writes slot
    ``pos[b] % tpb`` of block ``table[b, pos[b] // tpb]``; ``pos`` is (B,)
    or a scalar. A lane whose entry is -1 or whose position lies outside
    its table's coverage writes nothing (a retired lane of a continuous
    batcher keeps stepping, and its freed blocks may belong to another
    request)."""
    tpb = pool_k.shape[1]
    b = k_new.shape[0]
    tables = _tables(block_tables, pool_k.device)
    m = tables.shape[1]
    pos = torch.as_tensor(pos, device=pool_k.device).long().expand(b)
    blocks = tables.gather(1, (pos // tpb).clamp(0, m - 1)[:, None])[:, 0]
    flat = blocks * tpb + pos % tpb
    valid = (blocks >= 0) & (pos >= 0) & (pos < m * tpb)
    _write_rows(pool_k, flat, valid, k_new[:, :, 0])
    _write_rows(pool_v, flat, valid, v_new[:, :, 0])
    return pool_k, pool_v


def paged_prefill_update(
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_tables,
    lens,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write whole prompts' K/V (B, H, S, dh), right-padded to S, through
    the block tables IN PLACE and return the pools. Positions at or past
    ``lens[b]``, past the table's coverage or under a -1 entry are
    dropped, so they never touch another sequence's blocks."""
    tpb = pool_k.shape[1]
    b, _, s, _ = k.shape
    dev = pool_k.device
    tables = _tables(block_tables, dev)
    m = tables.shape[1]
    lens = torch.as_tensor(lens, device=dev).long()
    t = torch.arange(s, device=dev)[None, :].expand(b, s)
    blocks = tables.gather(1, (t // tpb).clamp(max=m - 1))
    flat = blocks * tpb + t % tpb
    valid = (t < lens[:, None]) & (blocks >= 0) & (t < m * tpb)
    h, dh = k.shape[1], k.shape[3]
    for pool, x in ((pool_k, k), (pool_v, v)):
        _write_rows(pool, flat.reshape(-1), valid.reshape(-1),
                    x.transpose(1, 2).reshape(b * s, h, dh))
    return pool_k, pool_v


def paged_mha_decode_step(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    block_tables,
    valid_len,
    fp32_softmax: bool = True,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token attention against a paged cache: each lane's blocks
    are gathered into a (B, H, max_blocks · tpb, dh) window in q's dtype
    (-1 entries clamped for the gather and masked by ``valid_len``, a
    scalar or (B,)), which ``mha_decode_step`` attends: kernel K2 on the
    card."""
    n, tpb, h, dh = pool_k.shape
    tables = _tables(block_tables, pool_k.device).clamp(0, n - 1)
    b, m = tables.shape

    def window(pool):
        return pool[tables].reshape(b, m * tpb, h, dh).transpose(1, 2).to(
            q.dtype).contiguous()

    return mha_decode_step(q, window(pool_k), window(pool_v), valid_len,
                           fp32_softmax=fp32_softmax, bias=bias)
