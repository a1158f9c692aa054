"""The rounding points of the tensor-core flash kernels (K1 forward, K4
backward in ``whisper_trtllm_tpu_torch/csrc``), emulated in plain torch on
the CPU, against the JAX package's Pallas kernels in interpret mode.

The CUDA kernels run only on a card; what they round, and where, is
arithmetic that can be repeated here:

- K1 keeps an online softmax over 64-column tiles and, in bf16, rounds the
  unnormalised P = exp(s - running max) to bf16 before P.V, dividing by
  the fp32 row sum at the end (the JAX kernel rounds the normalised P);
- K4 in bf16 splits P and dS into bf16 hi + lo (~16 bits) and takes
  dv = P^T dO, dq = dS K and dk = dS^T Q as two products each (the JAX
  kernel keeps P and dS in fp32). Rounding them once to bf16 instead
  breaks the bf16 limit on dq: dq sums terms dS K that cancel (the row
  sum of dS is 0), so their rounding errors do not shrink with dq;
  ``test_single_bf16_rounding_of_ds_breaks_the_bf16_limit`` shows it;
- in fp32 both take every product as 3xTF32: x = hi + lo with hi = tf32(x)
  and lo = tf32(x - hi), tf32 rounding to nearest (ties away) on the 13
  dropped mantissa bits, and a product is lo*hi + hi*lo + hi*hi.

Each emulation is held to the limit the card holds the kernel to against
its plain version: 2e-2 in bf16 (K1 max abs; K4 of max(|ref|, 1)
elementwise), 1e-5 in fp32 (K1 max abs; K4 of max(max|ref|, 1)). One TF32
product alone breaks the fp32 limit, which is why the fp32 kernels take
three.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_trtllm_tpu.ops.pallas.flash_attention import _bwd_impl, _fwd_impl

TILE = 64  # the kernels' K/V tile rows
MASK = -1e9
# (B, H, Hkv, S, T, dh, causal): ragged against the 64-row tiles
CASES = [
    pytest.param(1, 2, 2, 200, 200, 64, False, id="S200"),
    pytest.param(1, 2, 2, 31, 200, 64, False, id="cross-S31-T200"),
    pytest.param(1, 2, 2, 200, 200, 64, True, id="causal-S200"),
    pytest.param(1, 2, 1, 200, 200, 64, False, id="gqa-Hkv1"),
]
LIMIT = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
DTYPES = [pytest.param(torch.float32, id="fp32-3xtf32"),
          pytest.param(torch.bfloat16, id="bf16")]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to tf32 as ``cvt.rna.tf32.f32``: to nearest, ties away
    from zero, on the 13 dropped mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as 3xTF32 with fp32 sums, small terms first."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def mm(a, b, dtype, a_bits=None):
    """One kernel product from fp32 operands: 3xTF32 in fp32; in bf16 an
    exact product of bf16 values summed in fp32, where the A operand comes
    from fp32 accumulators rounded to bf16 (``a_bits`` 8: the forward's P)
    or split into bf16 hi + lo (16: the backward's P and dS)."""
    if dtype == torch.float32:
        return mm3(a, b)
    if a_bits == 8:
        a = bf16(a)
    elif a_bits == 16:
        a = bf16(a) + bf16(a - bf16(a))
    return a @ b


def _mask(s, t0, causal):
    rows = torch.arange(s.shape[-2]).unsqueeze(1)
    cols = t0 + torch.arange(s.shape[-1]).unsqueeze(0)
    if causal:
        s = s.masked_fill(cols > rows, MASK)
    return s


def _repeat(x, h):
    return x.repeat_interleave(h // x.shape[1], dim=1)


def emulate_fwd(q, k, v, causal):
    """K1: (out in q's dtype, fp32 lse) from its tile loop's rounding."""
    dtype = q.dtype
    qf, kf, vf = q.float(), _repeat(k, q.shape[1]).float(), _repeat(v, q.shape[1]).float()
    b, h, s, dh = q.shape
    m = torch.full((b, h, s, 1), -torch.inf)
    l = torch.zeros(b, h, s, 1)
    acc = torch.zeros(b, h, s, dh)
    for t0 in range(0, k.shape[2], TILE):
        kt, vt = kf[:, :, t0:t0 + TILE], vf[:, :, t0:t0 + TILE]
        sc = _mask(mm(qf, kt.transpose(-1, -2), dtype), t0, causal)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, vt, dtype, a_bits=8)
        m = m_new
    return (acc / l).to(dtype), (m + torch.log(l)).squeeze(-1)


def emulate_bwd(q, k, v, do, lse, causal):
    """K4: (dq, dk, dv) from its rounding points, P from K1's lse."""
    dtype = q.dtype
    h, hkv = q.shape[1], k.shape[1]
    qf, dof = q.float(), do.float()
    kf, vf = _repeat(k, h).float(), _repeat(v, h).float()
    p = torch.exp(_mask(mm(qf, kf.transpose(-1, -2), dtype), 0, causal)
                  - lse.unsqueeze(-1))
    dp = mm(dof, vf.transpose(-1, -2), dtype)
    delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = mm(ds, kf, dtype, a_bits=16)
    dk = mm(ds.transpose(-1, -2), qf, dtype, a_bits=16)
    dv = mm(p.transpose(-1, -2), dof, dtype, a_bits=16)
    b, _, t, dh = k.shape
    dk = dk.reshape(b, hkv, h // hkv, t, dh).sum(2)
    dv = dv.reshape(b, hkv, h // hkv, t, dh).sum(2)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _inputs(seed, b, h, hkv, s, t, dh):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, s, dh)) / np.sqrt(dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, t, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, t, dh)).astype(np.float32)
    do = rng.standard_normal((b, h, s, dh)).astype(np.float32)
    return q, k, v, do


def _both(x, dtype):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    xt = torch.from_numpy(x).to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return xt, jnp.asarray(xt.float().numpy(), jdt)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,hkv,s,t,dh,causal", CASES)
def test_forward_rounding_matches_pallas_fwd(dtype, b, h, hkv, s, t, dh,
                                             causal):
    (qt, qj), (kt, kj), (vt, vj), _ = (
        _both(x, dtype) for x in _inputs(s + t, b, h, hkv, s, t, dh))
    ref = _f32(_fwd_impl(qj, kj, vj, interpret=True, causal=causal))
    out, lse = emulate_fwd(qt, kt, vt, causal)
    assert out.dtype == dtype and tuple(out.shape) == ref.shape
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= LIMIT[dtype], err
    # the lse K4 reads: the fp32 log-sum-exp of the masked scores
    sc = qt.float() @ _repeat(kt, h).float().transpose(-1, -2)
    exact = torch.logsumexp(_mask(sc, 0, causal), -1)
    assert (lse - exact).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,hkv,s,t,dh,causal", CASES)
def test_backward_rounding_matches_pallas_bwd(dtype, b, h, hkv, s, t, dh,
                                              causal):
    (qt, qj), (kt, kj), (vt, vj), (dot, doj) = (
        _both(x, dtype) for x in _inputs(2 * s + t, b, h, hkv, s, t, dh))
    ref = _bwd_impl(qj, kj, vj, doj, interpret=True, causal=causal)
    _, lse = emulate_fwd(qt, kt, vt, causal)
    got = emulate_bwd(qt, kt, vt, dot, lse, causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        r = _f32(r)
        assert g.dtype == dtype and tuple(g.shape) == r.shape, name
        diff = np.abs(g.float().numpy() - r)
        if dtype == torch.float32:
            assert diff.max() <= LIMIT[dtype] * max(np.abs(r).max(), 1.0), name
        else:
            rel = (diff / np.maximum(np.abs(r), 1.0)).max()
            assert rel <= LIMIT[dtype], (name, rel)


def test_one_tf32_product_breaks_the_fp32_limit():
    """Why the fp32 kernels split each operand: S = Q K^T at the encoder's
    dh as one TF32 product misses fp32 by far more than 1e-5."""
    q, k, _, _ = _inputs(0, 1, 2, 2, 200, 200, 64)
    q, k = torch.from_numpy(q), torch.from_numpy(k).transpose(-1, -2)
    exact = q.double() @ k.double()
    one = (tf32(q) @ tf32(k)).double()
    assert (one - exact).abs().max().item() > 1e-4
    assert (mm3(q, k).double() - exact).abs().max().item() <= 1e-5


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 3.0])
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 1.0, 3.0])
    assert torch.equal(tf32(x), want)


def test_single_bf16_rounding_of_ds_breaks_the_bf16_limit():
    """Why K4 splits P and dS: rounded once to bf16 they move causal dq by
    more than 2e-2 of max(|ref|, 1) against the JAX kernel."""
    b, h, hkv, s, t, dh = 1, 2, 2, 200, 200, 64
    (qt, qj), (kt, kj), (vt, vj), (dot, doj) = (
        _both(x, torch.bfloat16) for x in _inputs(2 * s + t, b, h, hkv, s, t, dh))
    ref = _f32(_bwd_impl(qj, kj, vj, doj, interpret=True, causal=True)[0])
    _, lse = emulate_fwd(qt, kt, vt, True)
    qf, kf, dof, vf = qt.float(), kt.float(), dot.float(), vt.float()
    p = torch.exp(_mask(qf @ kf.transpose(-1, -2), 0, True) - lse.unsqueeze(-1))
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    rel = lambda dq: (np.abs(dq.to(torch.bfloat16).float().numpy() - ref)
                      / np.maximum(np.abs(ref), 1.0)).max()
    assert rel(bf16(ds) @ kf) > 2e-2
    assert rel((bf16(ds) + bf16(ds - bf16(ds))) @ kf) <= 2e-2
