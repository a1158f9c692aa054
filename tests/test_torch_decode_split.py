"""The split-T arithmetic of the decode-attention kernels (K2 ``decode_attn``
and K7 ``cross_decode_mha`` in ``whisper_trtllm_tpu_torch/csrc``, on the
engine of ``csrc/decode_split.cuh``), emulated in plain torch on the CPU,
against the JAX package: ``decode_mha`` and ``cross_decode_mha`` in
interpret mode, and ``ops/attention.py::mha_decode_step`` for what the port
adds to K2 (int8/fp8 caches, the T-minor layout, per-lane lengths).

The CUDA kernels run only on a card; what they compute, and in what order,
is arithmetic that can be repeated here:

- the rows of one (batch, head) are cut into ``splits`` chunks of
  ``chunk`` rows (``decode_attention.split_plan``: from the shape and the
  SM count, never from valid_len); a block attends rows [rank * chunk,
  min((rank + 1) * chunk, n)) in tiles of ``tile`` rows, with n = min(
  valid_len, T), or T with every score -1e9 when valid_len <= 0; a chunk
  past n is an empty partial (m = -inf, l = 0, acc = 0);
- fp32 scores (times k_scale) feed an online softmax: a running max m,
  sum l of exp(s - m) and acc of exp(s - m) (times v_scale) · V. In the
  dh-minor layout (K2's and K7's) each slot of lanes runs its own over
  the rows it takes (rows slot, slot + slots, ... of each tile) and the
  block merges its slots in order; in the T-minor layout the block takes
  each tile's softmax at once;
- the cluster's rank 0 combines the partials in rank order:
  out = sum acc_r e^(m_r - M) / sum l_r e^(m_r - M), M = max m_r, cast
  once to q's dtype.

Limits: fp32 1e-5 (sums in another order), bf16 2e-2 (the JAX package
rounds the weights to bf16 before P·V, the kernels round only the output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_trtllm_tpu.ops import attention as jax_att
from whisper_trtllm_tpu.ops.pallas.cross_attention import (
    cross_decode_mha as jax_cross_decode_mha,
)
from whisper_trtllm_tpu.ops.pallas.decode_attention import decode_mha
from whisper_trtllm_tpu_torch.ops import attention as att
from whisper_trtllm_tpu_torch.ops.kernels.decode_attention import (
    MAX_SPLITS,
    MAX_STAGES,
    MIN_ROWS,
    ROW_ALIGN,
    split_plan,
    tile_row_bytes,
)

MASK = -1e9
H100_SMS = 132
THREADS = 128  # a block of the kernels
LIMIT = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
DTYPES = [pytest.param(torch.float32, id="fp32"),
          pytest.param(torch.bfloat16, id="bf16")]


def slot_count(dh, elem, threads=None):
    """Rows a dh-minor block takes at once: its threads (128, or 256 for a
    lone block that reads one small tile in place), a power-of-two group of
    lanes a row, each lane reading 16 bytes (fp32, bf16) or 8 (int8, fp8)."""
    vec = 4 if elem == 4 else 8
    lanes = 1
    while lanes * vec < dh:
        lanes *= 2
    return (threads or THREADS) // lanes


def dh_minor_slots(dh, elem, plan):
    """The slots of K2's dh-minor block under ``plan``: a lone block of
    one tile of at most 64 rows reads it in place with 256 threads."""
    splits, chunk, tile = plan
    direct = splits == 1 and tile == chunk <= 64 and (dh * elem) % 16 == 0
    return slot_count(dh, elem, 256 if direct else None)


def _online(s, w, v, state):
    """One row into a running (m, l, acc): s its score, w its weight's
    factor (v_scale or 1), v its values."""
    m, l, acc = state
    m_new = torch.maximum(m, s)
    alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
    return m_new, l * alpha + p, acc * alpha + (p * w) * v


def _merge(parts, dh):
    """(m, l, acc) partials merged in order: M = max m, each weighed by
    e^(m - M), which is 0 for an empty one."""
    big = max(m for m, _, _ in parts)
    if big == -float("inf"):
        return big, torch.tensor(0.0), torch.zeros(dh)
    l, acc = torch.tensor(0.0), torch.zeros(dh)
    for m, pl, pacc in parts:
        w = torch.exp(m - big)
        l = l + pl * w
        acc = acc + pacc * w
    return big, l, acc


def split_attend(q, k, v, n, all_masked, plan, ks=None, vs=None, slots=None):
    """One (batch, head) as the kernel takes it: q (dh,), k and v (T, dh)
    in fp32, scales (T,) or None; plan (splits, chunk, tile). With
    ``slots`` (dh-minor) each slot takes rows slot, slot + slots, ... of a
    tile in its own online softmax and the block merges its slots; without
    (T-minor) the block takes each tile's softmax at once. Returns the fp32
    output row and the blocks' partials."""
    splits, chunk, tile = plan
    dh = q.shape[0]
    empty = (torch.tensor(-float("inf")), torch.tensor(0.0), torch.zeros(dh))
    parts = []
    for rank in range(splits):
        c0, c1 = rank * chunk, min((rank + 1) * chunk, n)
        state = empty
        per_slot = [empty] * (slots or 1)
        for r0 in range(c0, c1, tile):
            rows = slice(r0, min(r0 + tile, c1))
            s = k[rows] @ q
            if ks is not None:
                s = s * ks[rows]
            if all_masked:
                s = torch.full_like(s, MASK)
            w = vs[rows] if vs is not None else torch.ones_like(s)
            if slots:
                for i in range(s.shape[0]):
                    per_slot[i % slots] = _online(s[i], w[i], v[r0 + i],
                                                  per_slot[i % slots])
                continue
            m, l, acc = state
            m_new = torch.maximum(m, s.max())
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            state = (m_new, l * alpha + p.sum(), acc * alpha + (p * w) @ v[rows])
        parts.append(_merge(per_slot, dh) if slots else state)
    _, den, num = _merge(parts, dh)   # rank order
    return num / den, parts


def check_plan(t, plan):
    """What the kernels' launch refuses otherwise: 1..16 splits, chunk and
    tile multiples of 16, chunks covering t rows with none empty of rows."""
    splits, chunk, tile = plan
    assert 1 <= splits <= MAX_SPLITS
    assert chunk % ROW_ALIGN == 0 and tile % ROW_ALIGN == 0
    assert (splits - 1) * chunk < t <= splits * chunk


def split_decode(q, k, v, valid_len, ks=None, vs=None, t_major=False,
                 plan=None):
    """K2's output for q (B, H, 1, dh) and a cache (B, H, T, dh), or
    (B, H, dh, T) when ``t_major``, with scales (B, H, T, 1) for int8/fp8
    values; ``valid_len`` a scalar or one per lane. ``plan`` defaults to
    the card's (``split_plan`` on 132 SMs)."""
    b, h, _, dh = q.shape
    kf, vf = k.float(), v.float()
    if t_major:
        kf, vf = kf.transpose(-1, -2), vf.transpose(-1, -2)
    t = kf.shape[2]
    if plan is None:
        plan = split_plan(t, b * h, tile_row_bytes(dh, k.element_size(),
                                                   t_major), H100_SMS,
                          t_major)[:3]
    check_plan(t, plan)
    lens = torch.as_tensor(valid_len).expand(b)
    out = torch.zeros(b, h, 1, dh)
    for i in range(b):
        vl = int(lens[i])
        n = t if vl <= 0 else min(vl, t)
        for j in range(h):
            out[i, j, 0], _ = split_attend(
                q[i, j, 0].float(), kf[i, j], vf[i, j], n, vl <= 0, plan,
                None if ks is None else ks[i, j, :, 0],
                None if vs is None else vs[i, j, :, 0],
                None if t_major else dh_minor_slots(dh, k.element_size(),
                                                    plan))
    return out.to(q.dtype)


def split_cross(q, k, v, heads, dh, valid_len, plan=None):
    """K7's output for q (B, H*dh) and a head-contiguous cache (B, T,
    H*dh): the same engine on head h's columns of each row, over the rows
    valid_len leaves (all T when it masks every row)."""
    b, t = k.shape[0], k.shape[1]
    rows = t if valid_len <= 0 else min(valid_len, t)
    if plan is None:
        plan = split_plan(rows, b * heads,
                          tile_row_bytes(dh, q.element_size(), False),
                          H100_SMS)[:3]
    check_plan(rows, plan)
    out = torch.zeros(b, heads * dh)
    for i in range(b):
        for j in range(heads):
            cols = slice(j * dh, (j + 1) * dh)
            out[i, cols], _ = split_attend(
                q[i, cols].float(), k[i, :, cols].float(),
                v[i, :, cols].float(), rows, valid_len <= 0, plan,
                slots=slot_count(dh, q.element_size()))
    return out.to(q.dtype)


def _normal(rng, shape, scale=1.0):
    return rng.standard_normal(shape).astype(np.float32) * scale


def _err(got, want):
    return float(np.abs(got.float().numpy() - np.asarray(
        want, np.float32)).max())


# (T, valid_len, (splits, chunk, tile)): ragged chunk edges, chunks past
# valid_len left empty, tiles shorter than a chunk, and valid_len <= 0
FORCED = [
    pytest.param(33, 33, (1, 48, 48), id="s1"),
    pytest.param(33, 17, (2, 32, 16), id="s2-tiles-empty"),
    pytest.param(40, 40, (3, 16, 16), id="s3-ragged"),
    pytest.param(120, 70, (8, 16, 16), id="s8-empty"),
    pytest.param(250, 250, (16, 16, 16), id="s16-ragged"),
    pytest.param(250, 0, (16, 16, 16), id="s16-all-masked"),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,valid_len,plan", FORCED)
def test_split_decode_matches_decode_mha(dtype, t, valid_len, plan):
    rng = np.random.default_rng(t + valid_len)
    q = _normal(rng, (2, 3, 1, 64), 0.125)
    k, v = _normal(rng, (2, 3, t, 64)), _normal(rng, (2, 3, t, 64))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = decode_mha(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                      jnp.int32(valid_len), interpret=True)
    got = split_decode(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                       valid_len, plan=plan)
    assert got.dtype == dtype
    assert _err(got, want.astype(jnp.float32)) <= LIMIT[dtype]


def _quant(x, kind):
    qdt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[kind]
    jdt = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[kind]
    tq, ts = att.quantize_kv(torch.from_numpy(x), qdt)
    jq, js = jax_att.quantize_kv(jnp.asarray(x), jdt)
    return (tq, ts), (jq, js)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t_major", [False, True], ids=["bhtd", "bhdt"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_split_decode_quantized_per_lane_matches_mha_decode_step(
        dtype, t_major, kind):
    """Scales folded into the scores and weights, both layouts, per-lane
    lengths 0 (uniform), 1, T and one inside a chunk, over 8 splits."""
    t, lens = 120, np.array([0, 1, 120, 37], np.int32)
    rng = np.random.default_rng(len(kind) + t_major)
    q = _normal(rng, (4, 2, 1, 64), 0.125)
    (tk, tks), (jk, jks) = _quant(_normal(rng, (4, 2, t, 64)), kind)
    (tv, tvs), (jv, jvs) = _quant(_normal(rng, (4, 2, t, 64)), kind)
    if t_major:
        tk, tv = tk.transpose(-1, -2).contiguous(), tv.transpose(-1, -2).contiguous()
        jk, jv = jnp.swapaxes(jk, -1, -2), jnp.swapaxes(jv, -1, -2)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_att.mha_decode_step(jnp.asarray(q, jdt), jk, jv,
                                   jnp.asarray(lens), k_scale=jks,
                                   v_scale=jvs, t_major=t_major)
    got = split_decode(torch.from_numpy(q).to(dtype), tk, tv,
                       torch.from_numpy(lens), tks, tvs, t_major,
                       plan=(8, 16, 16))
    assert got.dtype == dtype
    assert _err(got, want.astype(jnp.float32)) <= LIMIT[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t_major", [False, True], ids=["bhtd", "bhdt"])
def test_split_decode_card_plan_matches_mha_decode_step(dtype, t_major):
    """The plan the card takes at the cross shape (T 1504, 1500 valid, B 2,
    H 2, 132 SMs: 16 splits) with an int8 cache and per-lane lengths."""
    t, lens = 1504, np.array([1500, 700], np.int32)
    rng = np.random.default_rng(1504 + t_major)
    q = _normal(rng, (2, 2, 1, 64), 0.125)
    (tk, tks), (jk, jks) = _quant(_normal(rng, (2, 2, t, 64)), "int8")
    (tv, tvs), (jv, jvs) = _quant(_normal(rng, (2, 2, t, 64)), "int8")
    if t_major:
        tk, tv = tk.transpose(-1, -2).contiguous(), tv.transpose(-1, -2).contiguous()
        jk, jv = jnp.swapaxes(jk, -1, -2), jnp.swapaxes(jv, -1, -2)
    plan = split_plan(t, 4, tile_row_bytes(64, 1, t_major), H100_SMS, t_major)
    assert plan[0] == MAX_SPLITS
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_att.mha_decode_step(jnp.asarray(q, jdt), jk, jv,
                                   jnp.asarray(lens), k_scale=jks,
                                   v_scale=jvs, t_major=t_major)
    got = split_decode(torch.from_numpy(q).to(dtype), tk, tv,
                       torch.from_numpy(lens), tks, tvs, t_major)
    assert _err(got, want.astype(jnp.float32)) <= LIMIT[dtype]


@pytest.mark.parametrize("valid_len,plan", [
    (20, None), (1, None), (24, (2, 16, 16)), (0, (3, 16, 16)),
    (-2, None), (27, (2, 16, 16)),
])
def test_split_cross_matches_cross_decode_mha(valid_len, plan):
    """K7 splits only the rows it reads; 0 and below read all T rows with
    every score masked: the mean of V."""
    b, heads, t, dh = 2, 4, 40, 16
    rng = np.random.default_rng(valid_len + 10)
    q = _normal(rng, (b, heads * dh), 0.3)
    k, v = _normal(rng, (b, t, heads * dh), 0.3), _normal(rng, (b, t, heads * dh))
    want = jax_cross_decode_mha(*(jnp.asarray(x) for x in (q, k, v)),
                                heads=heads, head_dim=dh,
                                valid_len=valid_len, interpret=True)
    got = split_cross(*(torch.from_numpy(x) for x in (q, k, v)), heads, dh,
                      valid_len, plan)
    assert _err(got, want) <= LIMIT[torch.float32]


def test_split_cross_matches_cross_decode_mha_in_bf16():
    b, heads, t, dh = 2, 3, 200, 40
    rng = np.random.default_rng(3)
    q = _normal(rng, (b, heads * dh), 0.3)
    k, v = _normal(rng, (b, t, heads * dh), 0.3), _normal(rng, (b, t, heads * dh))
    want = jax_cross_decode_mha(*(jnp.asarray(x, jnp.bfloat16)
                                  for x in (q, k, v)),
                                heads=heads, head_dim=dh, valid_len=150,
                                interpret=True)
    got = split_cross(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                      heads, dh, 150, (5, 32, 16))
    assert got.dtype == torch.bfloat16
    assert _err(got, want.astype(jnp.float32)) <= LIMIT[torch.bfloat16]


def test_an_empty_partial_leaves_the_combine_unchanged():
    """Chunks past valid_len add e^(-inf) = 0 to both sums: the output of
    16 splits of which 14 are empty equals one split over the valid rows
    to the last bit of the same sums."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(_normal(rng, (64,), 0.125))
    k = torch.from_numpy(_normal(rng, (256, 64)))
    v = torch.from_numpy(_normal(rng, (256, 64)))
    for slots in (None, 32):
        out16, parts = split_attend(q, k, v, 20, False, (16, 16, 16),
                                    slots=slots)
        assert all(l == 0 and m == -float("inf") for m, l, _ in parts[2:])
        out2, _ = split_attend(q, k, v, 20, False, (2, 16, 16), slots=slots)
        assert torch.equal(out16, out2)


@pytest.mark.parametrize("b,t,elem,t_major", [
    (4, 1504, 4, False), (4, 1504, 2, False), (4, 1504, 1, True),
    (4, 1504, 1, False), (32, 1504, 2, False), (32, 1504, 1, True),
    (4, 33, 4, False), (4, 33, 1, True), (1, 53248, 4, False),
])
def test_split_plan_fills_the_card_from_the_shape(b, t, elem, t_major):
    """Cross cases at B 4 take 8-16 splits of at least MIN_ROWS rows; the
    self cache (T 33) one block; chunks and tiles are multiples of 16 and
    cover T with no chunk empty of rows; the shared memory of the stages
    in flight stays within the kernel's limit."""
    rb = tile_row_bytes(64, elem, t_major)
    splits, chunk, tile, stages = split_plan(t, b * 6, rb, H100_SMS, t_major)
    check_plan(t, (splits, chunk, tile))
    assert tile <= chunk and 1 <= stages <= MAX_STAGES
    assert stages == min(MAX_STAGES, -(-chunk // tile))
    assert stages * tile * rb <= 200 * 1024
    if t == 33:
        assert splits == 1
    if b == 4 and t == 1504:
        assert 8 <= splits <= 16 and chunk >= MIN_ROWS
        assert splits * b * 6 >= H100_SMS
