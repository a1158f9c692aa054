"""The order of sums of the fused decoder-layer step kernel (K6,
``whisper_trtllm_tpu_torch/csrc/fused_decoder_step.cu``), replayed in plain
torch on the CPU, against the JAX package's Pallas kernel in interpret mode.

K6 runs six phases with five waits between them, and its split of the
work comes from ``fused_plan`` (the shape and the SM count alone):

- q and self attention, a block a head: the head's q over the full d-deep
  sum for every batch row (no split-K partials), each thread summing the
  rows of its row group, the row groups then added in a fixed order; the
  head's attention over the rows t <= pos as one tile's softmax;
- the out projection in column groups of ``cg``, full d-deep:
  x_mid = x + bias + a Wo;
- LN2 recomputed from x_mid by every cross block, the head's cross q, the
  cross rows cut into ``splits`` chunks of ``chunk`` rows, each chunk's
  (max, sum, acc) and the head's combine: weights exp(m_s - M), so a chunk
  past enc_len (max -1e30, sum 0) weighs exactly 0;
- the cross out projection, column groups: x2 = x_mid + bias + ca Wco;
- LN3 recomputed, fc1 of a group of ``g`` ffn columns, GELU once, times
  fc2's ``g`` rows: one (B, d) partial a group;
- the store: x2 + bias + the partials, summed warp by warp (warp w takes
  the groups w, w + 8, ...), the warps in order.

Projections cast their fp32 input to the weight dtype and sum fp32
products; bf16 is emulated by rounding exactly there. The emulation is
held to the limits the card holds K6 to against its plain version: fp32
atol 3e-5 + rtol 1e-4 against the Pallas kernel (its GELU's erf is a
polynomial within 1.5e-7), bf16 2e-2 of max(|ref|, 1).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu.ops.pallas.fused_decoder_step import (
    CROSS_BLOCK,
    fused_decoder_layer_step as jax_fused_step,
)
from whisper_trtllm_tpu_torch.ops.kernels.fused_decoder_step import (
    MAX_SPLITS,
    _workspace_floats,
    fused_layer_supported,
    fused_plan,
)

THREADS = 256   # a block's consumer threads
WARPS = 8
SMS = 132       # an H100 SXM's
DH = 64
MASK = -1e9
NEG_BIG = -1e30


def rnd(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The cast of a projection's fp32 input to the weight dtype."""
    return x.to(dtype).float()


def project(inp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, d) fp32 x the (d, C) column slice w as K6 sums it: a thread
    takes 4 columns of one row group (THREADS / (C / 4) groups, rows dealt
    out in turn), the row groups of a warp are added, then the warps in
    order."""
    c = w.shape[1]
    groups = THREADS // (c // 4)
    parts = torch.stack([inp[:, g::groups] @ w[g::groups].float()
                         for g in range(groups)])            # (G, B, C)
    per_warp = parts.reshape(WARPS, groups // WARPS, *parts.shape[1:])
    out = torch.zeros_like(parts[0])
    for w_sum in per_warp.sum(1):                             # warps in order
        out = out + w_sum
    return out


def layer_norm(x: torch.Tensor, scale, bias) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5) * scale.float() + bias.float()


def tile_softmax(q, k, v, t0, valid):
    """One tile's (max, sum, acc) for query rows q (B, dh) against k, v
    (B, n, dh): rows t0 + r at or past `valid` score MASK."""
    s = torch.einsum("bd,btd->bt", q, k.float())
    rows = t0 + torch.arange(k.shape[1])
    s = torch.where(rows < valid, s, torch.full_like(s, MASK))
    m = s.amax(-1)
    p = torch.exp(s - m[:, None])
    return m, p.sum(-1), torch.einsum("bt,btd->bd", p, v.float())


def emulate(x, h1, pos, enc_len, lp, sk, sv, ck, cv):
    """K6's step, phase by phase, in its order of sums."""
    dt = x.dtype
    b, d = x.shape
    _, h, ts, _ = sk.shape
    tc = ck.shape[2]
    ffn = lp["fc1"]["kernel"].shape[1]
    splits, chunk, cg, g = fused_plan(b, h, tc, d, ffn, SMS)
    scale = DH ** -0.5
    valid_s = min(max(pos + 1, 0), ts)
    limit_s = valid_s if valid_s > 0 else ts
    valid_c = min(max(enc_len, 0), tc)
    limit_c = valid_c if valid_c > 0 else tc
    w = {k: lp[k]["kernel"] for k in ("fc1", "fc2")}
    sa, ca_p = lp["self_attn"], lp["encoder_attn"]
    x32, h1_32 = x.float(), h1.float()

    # 0. q and self attention, a head at a time
    a = torch.zeros(b, d)
    for hh in range(h):
        cols = slice(hh * DH, (hh + 1) * DH)
        q = (project(h1_32, sa["q"]["kernel"][:, cols])
             + sa["q"]["bias"][cols].float()) * scale
        m, l, acc = tile_softmax(q, sk[:, hh, :limit_s], sv[:, hh, :limit_s],
                                 0, valid_s)
        a[:, cols] = acc / l[:, None]
    # 1. out projection, column groups
    x_mid = torch.zeros(b, d)
    for n0 in range(0, d, cg):
        cols = slice(n0, n0 + cg)
        x_mid[:, cols] = (x32[:, cols] + sa["out"]["bias"][cols].float()
                          + project(rnd(a, dt), sa["out"]["kernel"][:, cols]))
    # 2. LN2, cross q, the split cross attention and its combine
    h2 = rnd(layer_norm(x_mid, lp["encoder_attn_layer_norm"]["scale"],
                        lp["encoder_attn_layer_norm"]["bias"]), dt)
    ca = torch.zeros(b, d)
    for hh in range(h):
        cols = slice(hh * DH, (hh + 1) * DH)
        q = (project(h2, ca_p["q"]["kernel"][:, cols])
             + ca_p["q"]["bias"][cols].float()) * scale
        parts = []
        for s in range(splits):
            r0, r1 = s * chunk, min(s * chunk + chunk, limit_c)
            if r1 <= r0:  # past enc_len: an empty partial
                parts.append((torch.full((b,), NEG_BIG), torch.zeros(b),
                              torch.zeros(b, DH)))
                continue
            parts.append(tile_softmax(q, ck[:, hh, r0:r1], cv[:, hh, r0:r1],
                                      r0, valid_c))
        m = torch.stack([p[0] for p in parts])                 # (S, B)
        weights = torch.exp(m - m.amax(0))
        for s, (ms, ls, _) in enumerate(parts):
            if (ms == NEG_BIG).all():
                assert (weights[s] == 0).all() and (ls == 0).all()
        total = torch.zeros(b)
        acc = torch.zeros(b, DH)
        for s, (_, ls, accs) in enumerate(parts):               # split order
            total = total + ls * weights[s]
            acc = acc + weights[s][:, None] * accs
        ca[:, cols] = acc / total[:, None]
    # 3. cross out projection, column groups
    x2 = torch.zeros(b, d)
    for n0 in range(0, d, cg):
        cols = slice(n0, n0 + cg)
        x2[:, cols] = (x_mid[:, cols] + ca_p["out"]["bias"][cols].float()
                       + project(rnd(ca, dt), ca_p["out"]["kernel"][:, cols]))
    # 4. LN3, fc1 -> GELU -> fc2 a group of g ffn columns at a time
    h3 = rnd(layer_norm(x2, lp["final_layer_norm"]["scale"],
                        lp["final_layer_norm"]["bias"]), dt)
    partials = []
    for j0 in range(0, ffn, g):
        cols = slice(j0, j0 + g)
        f = project(h3, w["fc1"][:, cols]) + lp["fc1"]["bias"][cols].float()
        mid = rnd(0.5 * f * (1.0 + torch.erf(f * 2.0 ** -0.5)), dt)
        partials.append(mid @ w["fc2"][cols].float())
    # 5. the store: the partials warp by warp, the warps in order
    tot = torch.zeros(b, d)
    for wp in range(WARPS):
        s = torch.zeros(b, d)
        for part in partials[wp::WARPS]:
            s = s + part
        tot = tot + s
    return (x2 + lp["fc2"]["bias"].float() + tot).to(dt)


def _layer(rng, d, ffn):
    def dense(din, dout):
        return {"kernel": rng.standard_normal((din, dout)) / np.sqrt(din),
                "bias": 0.1 * rng.standard_normal(dout)}

    def norm():
        return {"scale": 1 + 0.1 * rng.standard_normal(d),
                "bias": 0.1 * rng.standard_normal(d)}

    def attn():
        return {"q": dense(d, d), "k": dense(d, d), "v": dense(d, d),
                "out": dense(d, d)}

    return {"self_attn_layer_norm": norm(), "self_attn": attn(),
            "encoder_attn_layer_norm": norm(), "encoder_attn": attn(),
            "final_layer_norm": norm(), "fc1": dense(d, ffn),
            "fc2": dense(ffn, d)}


def _tree(tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


DTYPES = [pytest.param(torch.float32, id="fp32"),
          pytest.param(torch.bfloat16, id="bf16")]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos,enc_len", [(0, CROSS_BLOCK), (9, 300), (15, 1)])
def test_k6_order_of_sums_matches_pallas(dtype, pos, enc_len):
    """b 2, d 128 (two heads of 64), ffn 256, a 16-row self cache and
    CROSS_BLOCK cross rows: on 132 SMs, 66 splits of 8 rows, two of them
    always empty and, at a ragged enc_len, many more."""
    b, d, heads, ffn, ts, tc = 2, 128, 2, 256, 16, CROSS_BLOCK
    rng = np.random.default_rng(pos + enc_len)
    lp = _layer(rng, d, ffn)
    x = rng.standard_normal((b, d))
    h1 = rng.standard_normal((b, d))
    caches = [rng.standard_normal((b, heads, t, DH)) * s
              for t, s in ((ts, 0.3), (ts, 1.0), (tc, 0.3), (tc, 1.0))]
    to_t = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    to_j = lambda v: jnp.asarray(to_t(v).float().numpy(), jdt)
    ref = jax_fused_step(to_j(x), to_j(h1), jnp.int32(pos), _tree(lp, to_j),
                         *(to_j(c) for c in caches), enc_len, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    out = emulate(to_t(x), to_t(h1), pos, enc_len, _tree(lp, to_t),
                  *(to_t(c) for c in caches))
    assert out.dtype == dtype and tuple(out.shape) == (b, d)
    got = out.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=3e-5, rtol=1e-4)
    else:
        err = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
        assert err.max() <= 2e-2, err.max()


# the decoder widths of the Whisper sizes (d, heads, ffn): tiny.en to large
WIDTHS = [(384, 6, 1536), (512, 8, 2048), (768, 12, 3072), (1024, 16, 4096),
          (1280, 20, 5120)]


@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("d,heads,ffn", WIDTHS,
                         ids=["tiny", "base", "small", "medium", "large"])
def test_fused_plan_covers_the_work_in_one_round(b, d, heads, ffn):
    """Every Whisper width the gate admits: the cross splits cover the
    1500 encoder rows (padded to 1504) and need at most one block an SM,
    the column groups are powers of two from 8 (a bf16 tensor copy's
    16-byte row) to 64 that divide d and ffn, and the workspace holds the
    layout the kernel lays out."""
    tc = 1504
    assert fused_layer_supported(b, heads, 33, DH, tc, d, ffn, 4)
    splits, chunk, cg, g = fused_plan(b, heads, tc, d, ffn, SMS)
    assert 1 <= splits <= MAX_SPLITS and splits * heads <= SMS
    assert splits * chunk >= tc
    for group, n in ((cg, d), (g, ffn)):
        assert group in (8, 16, 32, 64) and n % group == 0
        assert n // group <= SMS or group == 64
    assert _workspace_floats(b, heads, tc, DH, d, ffn, SMS) == (
        4 * b * d + b * heads * splits * (DH + 2) + (ffn // g) * b * d)


def test_fused_plan_reads_neither_pos_nor_enc_len():
    """The plan is a function of the shape and the SM count alone, so a
    captured launch stays right when pos and enc_len change on the device:
    at tiny.en's widths it is the same whatever rows are valid."""
    plans = {fused_plan(4, 6, 1504, 384, 1536, SMS) for _ in range(3)}
    assert plans == {(22, 69, 8, 16)}
    assert math.ceil(1504 / 22) == 69
