"""K6: one decoder layer's decode step after the cache append, fused into
one launch — the wrapper of ``csrc/fused_decoder_step.cu``, its plain
PyTorch version and its gate.

Counterpart of ``whisper_trtllm_tpu/ops/pallas/fused_decoder_step.py``
(``fused_decoder_layer_step`` and ``fused_layer_supported``): q projection
→ masked self attention over the cache up to ``pos`` → out projection +
residual → LN2 → cross-q projection → cross attention masked at
``enc_len`` → out projection + residual → LN3 → fc1 → exact GELU → fc2 +
residual. x, x_mid, the LayerNorms and the softmaxes are fp32; each
projection casts its fp32 input to the weight dtype and accumulates in
fp32; the output is in x's dtype. The TPU kernel's GELU is a polynomial
erf because Mosaic has none; here it is the exact erf on both sides.

The wrapper takes the plain version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises. Which steps come here is the
model's gate's decision (``_fused_decode_ok``, once a decode call through
``decode_step_plan``), and
``fused_layer_supported`` states the kernel's shape limits for it; the
wrapper checks only what keeps the launch inside the tensors it is given,
and the kernel itself refuses a launch outside its limits.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from whisper_trtllm_tpu_torch.ops.kernels import _build, _launches

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"fused_decoder_step": [_P] * 28 + [_I] * 13 + [_P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's shape limits (csrc/fused_decoder_step.cu): batch rows held
# in registers, the head dim of its attention (every Whisper size's), d and
# ffn in 64-column heads and groups, the heads' tickets
MAX_B = 16
HEAD_DIM = 64
MAX_D = 2048
MAX_SPLITS = 128   # cross splits a head
SYNC_WORDS = 40    # the kernel's per-device counters (uint32)
MASK_VALUE = -1e9
# the kernel's phases; each after the first starts with a wait for the
# blocks that produce what it reads (csrc/fused_decoder_step.cu), and a
# timeline holds their boundaries
PHASES = ("q + self attention", "out projection",
          "LN2 + cross q + cross attention + combine",
          "cross out projection", "LN3 + fc1 + GELU + fc2",
          "residual + store")

_WEIGHTS = (  # (subtree path, weight key) in the kernel's order
    (("self_attn", "q"), "kernel"), (("self_attn", "out"), "kernel"),
    (("encoder_attn_layer_norm",), "scale"), (("encoder_attn", "q"), "kernel"),
    (("encoder_attn", "out"), "kernel"), (("final_layer_norm",), "scale"),
    (("fc1",), "kernel"), (("fc2",), "kernel"),
)


def fused_layer_supported(b: int, h: int, ts: int, dh: int, tc: int, d: int,
                          ffn: int, itemsize: int) -> bool:
    """True when the H100 kernel takes these shapes: 1 <= b <= 16 batch
    rows, dh 64 with d = h·dh, d and ffn multiples of 64, d <= 2048 (a
    ticket a head), fp32 or bf16 storage, non-empty caches. Neither cache
    length is bounded: both attentions stream their rows through the
    kernel's ring of stages."""
    return (1 <= b <= MAX_B and dh == HEAD_DIM and d == h * dh
            and d % 64 == 0 and ffn % 64 == 0 and ffn > 0 and d <= MAX_D
            and itemsize in (2, 4) and ts >= 1 and tc >= 1)


def _blocks(lp: dict):
    """The 8 (weight, bias) pairs the kernel reads, in its order; a
    LayerNorm's pair is (scale, bias). A missing bias is None."""
    out = []
    for path, key in _WEIGHTS:
        blk = lp
        for name in path:
            blk = blk[name]
        out.append((blk[key], blk.get("bias")))
    return out


def _dot32(a32: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, din) fp32 × (din, dout) → (B, dout) fp32: the input is cast to
    the weight dtype, the products and their sum are fp32 (a product of two
    bf16 values is exact in fp32)."""
    y = torch.matmul(a32.to(w.dtype).float(), w.float())
    return y if bias is None else y + bias.float()


def _ln32(x32: torch.Tensor, scale: torch.Tensor,
          bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps) * scale.float()
    return y if bias is None else y + bias.float()


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """q (B, H, dh) fp32 against (B, H, T, dh): fp32 scores, rows where
    ``valid`` is False at -1e9, softmax normalised before P·V."""
    s = torch.einsum("bhd,bhtd->bht", q, k.float())
    s = s.masked_fill(~valid, MASK_VALUE)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bht,bhtd->bhd", p, v.float())


def fused_decoder_layer_step_reference(x, h1, pos, lp, self_k, self_v,
                                       cross_k, cross_v, enc_len
                                       ) -> torch.Tensor:
    """Plain version: what the TPU kernel computes, in full-sequence
    softmaxes (the TPU kernel's cross softmax is online over blocks, which
    changes only the order of the sums)."""
    b, d = x.shape
    _, h, ts, dh = self_k.shape
    scale = dh ** -0.5
    (wq, bq), (wo, bo), (ln2s, ln2b), (wcq, bcq), (wco, bco), \
        (ln3s, ln3b), (wf1, bf1), (wf2, bf2) = _blocks(lp)
    dev = x.device
    pos = torch.as_tensor(pos, device=dev)
    enc_len = torch.as_tensor(enc_len, device=dev)
    x32 = x.float()
    q = (_dot32(h1.float(), wq, bq) * scale).reshape(b, h, dh)
    a = _attend(q, self_k, self_v, torch.arange(ts, device=dev) <= pos)
    x_mid = x32 + _dot32(a.reshape(b, d), wo, bo)
    qc = (_dot32(_ln32(x_mid, ln2s, ln2b), wcq, bcq) * scale).reshape(b, h, dh)
    a = _attend(qc, cross_k, cross_v,
                torch.arange(cross_k.shape[2], device=dev) < enc_len)
    x2 = x_mid + _dot32(a.reshape(b, d), wco, bco)
    f1 = _dot32(_ln32(x2, ln3s, ln3b), wf1, bf1)
    mid = 0.5 * f1 * (1.0 + torch.erf(f1 * 2.0 ** -0.5))
    return (x2 + _dot32(mid, wf2, bf2)).to(x.dtype)


def fused_plan(b: int, h: int, tc: int, d: int, ffn: int,
               sms: int) -> tuple:
    """The kernel's split of the work, from the shape and the SM count
    alone (never from pos or enc_len, so a captured launch stays right):
    (splits, chunk, cg, g) — ``splits`` blocks a head share the cross rows,
    ``chunk`` rows each; the out projections go in column groups of ``cg``,
    the MLP in groups of ``g`` ffn columns (fc1) and fc2 rows, each the
    smallest power of two from 8 (a 16-byte row of a bf16 column slice,
    the least a tensor copy moves) that needs at most one block an SM, at
    most 64."""
    splits = max(1, min(sms // h, tc, MAX_SPLITS))

    def group(n: int) -> int:
        g = 8
        while n // g > sms and g < 64:
            g *= 2
        return g

    return splits, -(-tc // splits), group(d), group(ffn)


def _workspace_floats(b: int, h: int, tc: int, dh: int, d: int, ffn: int,
                      sms: int) -> int:
    """fp32 workspace of one launch, as the kernel's ``layout()`` lays it
    out (the kernel refuses a smaller one): four (B, d) rows (the self
    attention's output, x_mid, the cross attention's output, x2), each
    cross split's (max, sum, acc[dh]) a (b, head), and one (B, d) fc2
    partial an MLP group."""
    splits, _, _, g = fused_plan(b, h, tc, d, ffn, sms)
    return 4 * b * d + b * h * splits * (dh + 2) + (ffn // g) * b * d


_SMS: dict = {}
_SYNC: dict = {}


def _device_state(device: torch.device):
    """(SM count, the kernel's counters) of a card: the counters are made
    and zeroed once, at the device's first launch, and every launch leaves
    them at zero. A first launch inside a CUDA graph capture is refused: a
    buffer made there would belong to the graph's memory pool."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    sync = _SYNC.get(idx)
    if sync is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("fused_decoder_layer_step: launch once on "
                               "this device outside a CUDA graph capture "
                               "first (it makes the kernel's counters)")
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
        sync = _SYNC[idx] = torch.zeros(SYNC_WORDS, dtype=torch.int32,
                                        device=torch.device("cuda", idx))
    return _SMS[idx], sync


def _check(x, h1, pos, enc_len, blocks, caches):
    """What keeps the launch inside the tensors it is given: one device,
    one float dtype (float32 or bfloat16), the shapes the kernel indexes
    by, contiguous storage, caches and weights aligned to 16 bytes (the
    kernel's bulk copies and 16-byte cp.async). One pass over the ~25
    tensors: it runs at every launch."""
    b, d = x.shape
    sk, sv, ck, cv = caches
    ffn = blocks[6][0].shape[-1]
    if sk.dim() != 4 or sk.shape[0] != b or sv.shape != sk.shape or \
            ck.dim() != 4 or cv.shape != ck.shape or \
            ck.shape[:2] != sk.shape[:2] or ck.shape[3] != sk.shape[3] or \
            sk.shape[1] * sk.shape[3] != d:
        raise ValueError(
            f"fused_decoder_layer_step: self cache (B,H,Ts,dh), cross cache "
            f"(B,H,Tc,dh) for x {tuple(x.shape)}; got {tuple(sk.shape)}, "
            f"{tuple(sv.shape)}, {tuple(ck.shape)}, {tuple(cv.shape)}")
    want = ((d, d), (d, d), (d,), (d, d), (d, d), (d,), (d, ffn), (ffn, d))
    floats = [x, h1, *caches]
    for (w, bias), shape in zip(blocks, want):
        if w.shape != shape or (bias is not None and bias.shape != shape[-1:]):
            raise ValueError(f"fused_decoder_layer_step: a weight of shape "
                             f"{tuple(w.shape)} where {shape} was expected")
        floats.append(w)
        if bias is not None:
            floats.append(bias)
    dev, dt = x.device, x.dtype
    for t in floats:
        if t.dtype != dt or dt not in _DTYPES:
            raise TypeError(f"fused_decoder_layer_step: x, h1, the caches "
                            f"and every weight in one dtype, float32 or "
                            f"bfloat16; x is {dt}, another input {t.dtype}")
        if t.device != dev:
            raise ValueError("fused_decoder_layer_step: every input must lie "
                             "on x's device")
        if not t.is_contiguous():
            raise ValueError("fused_decoder_layer_step: every input must be "
                             "contiguous")
    for t in (pos, enc_len):
        if t.dtype != torch.int32 or t.dim() != 0 or t.device != dev:
            raise TypeError("fused_decoder_layer_step: pos and enc_len must "
                            "be 0-d int32 tensors on x's device")
    if any(t.data_ptr() % 16 for t in caches) or any(
            w.data_ptr() % 16 for w, _ in blocks):
        raise ValueError("fused_decoder_layer_step: caches and weights are "
                         "copied in 16-byte pieces; both must be aligned "
                         "so")


def fused_decoder_layer_step(x: torch.Tensor, h1: torch.Tensor, pos, lp: dict,
                             self_k: torch.Tensor, self_v: torch.Tensor,
                             cross_k: torch.Tensor, cross_v: torch.Tensor,
                             enc_len,
                             timeline: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """One decoder layer's decode step after the cache append. x, h1
    (B, d): the hidden state and its LN1; ``pos`` the step's position, a
    0-d int32 tensor (read by the kernel, so no host sync); ``lp`` the
    layer's unfused float parameters; self cache (B, H, Ts, dh) ×2 already
    holding this step's K/V at ``pos``; cross cache (B, H, Tc, dh) ×2 of
    which the first ``enc_len`` rows are valid (a 0-d int32 tensor or an
    int). Returns x' (B, d) in x's dtype. Has no backward: on the card it
    refuses inputs that require grad. Counts its kernel launches in
    ``fused_decoder_layer_step.launches``.

    ``timeline``, on the card only: an int64 tensor of ``len(PHASES) + 1``
    on x's device that receives the card's global timer (ns) at the start
    of the kernel, after each phase's wait and at the end, as its first
    block sees them.

    Launches on one card must not overlap (one stream): they share the
    kernel's per-device counters. Traced by ``torch.export`` on the card,
    it is the operator ``torch.ops.wtpu.fused_decoder_step``."""
    if x.device.type == "cpu":
        return fused_decoder_layer_step_reference(
            x, h1, pos, lp, self_k, self_v, cross_k, cross_v, enc_len)
    if x.device.type != "cuda":
        raise ValueError(f"fused_decoder_layer_step: unsupported device "
                         f"{x.device}")
    if not isinstance(pos, torch.Tensor):
        raise TypeError("fused_decoder_layer_step: pos must be a 0-d int32 "
                        "tensor on x's device")
    if not isinstance(enc_len, torch.Tensor):
        enc_len = torch.tensor(enc_len, dtype=torch.int32, device=x.device)
    blocks = _blocks(lp)
    caches = (self_k, self_v, cross_k, cross_v)
    if _build.tracing():
        if timeline is not None:
            raise NotImplementedError("fused_decoder_layer_step: the "
                                      "timeline is not exported")
        return _OP(x, h1, pos, [t for pair in blocks for t in pair],
                   *caches, enc_len)
    return _launch(x, h1, pos, blocks, caches, enc_len, timeline)


def _launch(x, h1, pos, blocks, caches, enc_len, timeline=None
            ) -> torch.Tensor:
    _check(x, h1, pos, enc_len, blocks, caches)
    _build.refuse_grad("fused_decoder_layer_step", x, h1, *caches,
                       *(t for pair in blocks for t in pair))
    if timeline is not None and (
            timeline.dtype != torch.int64 or timeline.device != x.device
            or timeline.numel() < len(PHASES) + 1):
        raise ValueError(f"fused_decoder_layer_step: the timeline is int64 "
                         f"with {len(PHASES) + 1} entries on x's device")
    lib = _build.load("fused_decoder_step", _SIGNATURES)
    self_k, _, cross_k, _ = caches
    b, d = x.shape
    _, h, ts, dh = self_k.shape
    tc = cross_k.shape[2]
    ffn = blocks[6][0].shape[-1]
    sms, sync = _device_state(x.device)
    plan = fused_plan(b, h, tc, d, ffn, sms)
    n_ws = _workspace_floats(b, h, tc, dh, d, ffn, sms)
    workspace = torch.empty(n_ws, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    ptrs = [t.data_ptr() if t is not None else None
            for pair in blocks for t in pair]
    with torch.cuda.device(x.device):
        err = lib.fused_decoder_step(
            x.data_ptr(), h1.data_ptr(), pos.data_ptr(), enc_len.data_ptr(),
            *ptrs, *(c.data_ptr() for c in caches), out.data_ptr(),
            workspace.data_ptr(),
            None if timeline is None else timeline.data_ptr(),
            sync.data_ptr(), b, h, ts, dh, tc, d, ffn, _DTYPES[x.dtype],
            *plan, n_ws, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, "fused_decoder_layer_step")
    _launches.count(fused_decoder_layer_step)
    return out


def _op_launch(x, h1, pos, weights, self_k, self_v, cross_k, cross_v,
               enc_len):
    """The operator's CUDA implementation: ``weights`` flat, in
    ``_blocks``' order, (weight, bias) after (weight, bias)."""
    blocks = list(zip(weights[0::2], weights[1::2]))
    return _launch(x, h1, pos, blocks, (self_k, self_v, cross_k, cross_v),
                   enc_len)


_OP = _build.define_op(
    "fused_decoder_step(Tensor x, Tensor h1, Tensor pos, Tensor?[] weights, "
    "Tensor self_k, Tensor self_v, Tensor cross_k, Tensor cross_v, "
    "Tensor enc_len) -> Tensor",
    _op_launch, lambda x, h1, pos, weights, self_k, self_v, cross_k, cross_v,
    enc_len: torch.empty_like(x))

fused_decoder_layer_step.launches = 0
