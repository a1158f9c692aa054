"""PyTorch port: per-lane cache writes, the ragged decode step and the
paged KV cache (ops and host ledger) against the JAX package, on the same
weights (JAX ``init_params`` carried over with ``params_from_numpy``) and
the same inputs drawn from a seed.

Tolerances: logits 1e-5 (fp32 through two layers, sums in another
order); float caches 1e-5; quantized cache values and scales, pools and
block tables exactly; the ragged step with every lane at one position
equal to ``decode_step_kv`` bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu import config as jax_config
from whisper_trtllm_tpu.models.whisper import init_params
from whisper_trtllm_tpu.models.whisper import model as jax_model
from whisper_trtllm_tpu.ops import attention as jax_att
from whisper_trtllm_tpu.runtime import kv_cache_manager as jax_kvm
from whisper_trtllm_tpu_torch import config as torch_config
from whisper_trtllm_tpu_torch.models.whisper import model
from whisper_trtllm_tpu_torch.ops import attention as att
from whisper_trtllm_tpu_torch.runtime import kv_cache_manager as kvm
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy

B, T = 4, 12
QDT = {"int8": (torch.int8, jnp.int8),
       "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}


def to_torch(x) -> torch.Tensor:
    """A JAX array as a CPU tensor, bit for bit (fp8 through its bytes)."""
    a = np.asarray(x)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def raw(x) -> np.ndarray:
    """Bytes-exact numpy view of a tensor or JAX array (fp8 as uint8)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _normal(rng, shape, scale=1.0):
    return rng.standard_normal(shape).astype(np.float32) * scale


# --------------------------------------------------------------------------
# per-lane cache writes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["float", "int8", "fp8"])
def test_per_lane_update_matches_jax(kind):
    """Lane b writes its K/V (and scales) at row pos[b], in place; a row
    past the cache is clamped to the last, as dynamic_update_slice does."""
    rng = np.random.default_rng(1)
    h, dh = 3, 8
    pos = np.asarray([3, 0, T - 1, T + 4], np.int32)
    cache = [_normal(rng, (B, h, T, dh)) for _ in range(2)]
    new = [_normal(rng, (B, h, 1, dh)) for _ in range(2)]
    if kind == "float":
        ref = jax_att.update_kv_cache(*map(jnp.asarray, cache + new),
                                      jnp.asarray(pos))
        got = [torch.from_numpy(c.copy()) for c in cache]
        out = att.update_kv_cache(*got, *map(torch.from_numpy, new),
                                  torch.from_numpy(pos))
        assert out[0] is got[0] and out[1] is got[1]
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        return
    tdt, jdt = QDT[kind]
    jq = [jax_att.quantize_kv(jnp.asarray(x), jdt) for x in cache + new]
    ref_v = jax_att.update_kv_cache(jq[0][0], jq[1][0], jq[2][0], jq[3][0],
                                    jnp.asarray(pos))
    ref_s = jax_att.update_kv_cache(jq[0][1], jq[1][1], jq[2][1], jq[3][1],
                                    jnp.asarray(pos))
    tq = [(to_torch(v), to_torch(s)) for v, s in jq]
    att.update_kv_cache(tq[0][0], tq[1][0], tq[2][0], tq[3][0],
                        torch.from_numpy(pos))
    att.update_kv_cache(tq[0][1], tq[1][1], tq[2][1], tq[3][1],
                        torch.from_numpy(pos))
    assert tq[0][0].dtype == tdt
    for i in range(2):
        np.testing.assert_array_equal(raw(tq[i][0]), raw(ref_v[i]))
        np.testing.assert_array_equal(raw(tq[i][1]), raw(ref_s[i]))


def test_per_lane_update_refuses_a_matrix_of_positions():
    k = torch.zeros(2, 1, 4, 2)
    with pytest.raises(ValueError, match="scalar or"):
        att.update_kv_cache(k, k.clone(), torch.ones(2, 1, 1, 2),
                            torch.ones(2, 1, 1, 2), torch.zeros(2, 2))


# --------------------------------------------------------------------------
# the ragged step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_config.WhisperConfig.testing(max_target_positions=T)
    cfg = torch_config.WhisperConfig(**dataclasses.asdict(jcfg))
    ref = init_params(jcfg, seed=0)
    enc = _normal(np.random.default_rng(2),
                  (B, jcfg.max_source_positions, jcfg.d_model), 2.0)
    return jcfg, cfg, ref, params_from_numpy(ref, "cpu"), enc


def _caches(jcfg, ref, enc, kv, layout):
    """JAX's self and cross caches for ``kv`` and ``layout``, and the same
    bytes as tensors."""
    ck, cv = jax_model.compute_cross_kv(ref, jcfg, jnp.asarray(enc))
    if kv == "auto":
        cross = (ck, cv)
        self_kv = jax_model.init_self_kv(jcfg, B, T)
    else:
        jdt = QDT[kv][1]
        cross = jax_model.quantize_cross_kv(ck, cv, jdt)
        self_kv = jax_model.init_self_kv_quant(jcfg, B, T, jdt)
    if layout == "bhdt":
        cross = jax_model.transpose_cross_kv(cross)
    return (tuple(self_kv), tuple(cross),
            tuple(to_torch(x) for x in self_kv),
            tuple(to_torch(x) for x in cross))


@pytest.mark.parametrize("layout", ["bhtd", "bhdt"])
@pytest.mark.parametrize("kv", ["auto", "int8", "fp8"])
def test_ragged_step_matches_jax_at_staggered_positions(tiny, kv, layout):
    """Four steps, the lanes at positions four apart and one held back,
    each on the step's own output caches: logits within 1e-5, caches equal
    (float ones within 1e-5)."""
    jcfg, cfg, ref, params, enc = tiny
    j_self, j_cross, t_self, t_cross = _caches(jcfg, ref, enc, kv, layout)
    assert model.cross_kv_t_major(cfg, t_cross) == (layout == "bhdt")
    rng = np.random.default_rng(3)
    pos = np.asarray([0, 4, 8, 2], np.int32)
    j_step = jax.jit(jax_model.decode_step_ragged_kv, static_argnums=1)
    for step in range(4):
        toks = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
        j_logits, j_self = j_step(ref, jcfg, jnp.asarray(toks),
                                  jnp.asarray(pos), j_self, j_cross)
        logits, out = model.decode_step_ragged_kv(
            params, cfg, torch.from_numpy(toks), torch.from_numpy(pos),
            t_self, t_cross)
        assert out is t_self
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   atol=1e-5, rtol=0)
        for got, want in zip(t_self, j_self):
            if got.dtype == torch.float32 and kv == "auto":
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           atol=1e-5, rtol=0)
            elif got.dtype == torch.float32:  # scales
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-5, atol=0)
            else:
                np.testing.assert_array_equal(raw(got), raw(want))
        pos = pos + np.asarray([1, 1, 1, step % 2], np.int32)


@pytest.mark.parametrize("kv,layout", [("auto", "bhtd"), ("int8", "bhdt"),
                                       ("fp8", "bhtd")])
def test_ragged_step_at_one_position_equals_decode_step_kv(tiny, kv, layout):
    jcfg, cfg, ref, params, enc = tiny
    _, _, self_a, cross = _caches(jcfg, ref, enc, kv, layout)
    self_b = tuple(x.clone() for x in self_a)
    toks = torch.arange(B, dtype=torch.int32) + 7
    for p in range(3):
        ragged, _ = model.decode_step_ragged_kv(
            params, cfg, toks, torch.full((B,), p, dtype=torch.int32),
            self_a, cross)
        lockstep, _ = model.decode_step_kv(params, cfg, toks, p, self_b,
                                           cross)
        assert torch.equal(ragged, lockstep)
        for a, b in zip(self_a, self_b):
            assert torch.equal(a.view(torch.uint8) if a.element_size() == 1
                               else a, b.view(torch.uint8)
                               if b.element_size() == 1 else b)


def test_float_ragged_step_returns_its_caches(tiny):
    jcfg, cfg, ref, params, enc = tiny
    _, _, (sk, sv), (ck, cv) = _caches(jcfg, ref, enc, "auto", "bhtd")
    toks = torch.zeros(B, dtype=torch.int32)
    logits, k, v = model.decode_step_ragged(
        params, cfg, toks, np.asarray([0, 1, 2, 3]), sk, sv, ck, cv)
    assert k is sk and v is sv and logits.shape == (B, jcfg.vocab_size)


def test_lockstep_step_refuses_per_lane_positions(tiny):
    jcfg, cfg, ref, params, enc = tiny
    _, _, self_kv, cross = _caches(jcfg, ref, enc, "auto", "bhtd")
    with pytest.raises(ValueError, match="decode_step_ragged_kv"):
        model.decode_step_kv(params, cfg, torch.zeros(B, dtype=torch.int32),
                             torch.zeros(B, dtype=torch.int32), self_kv,
                             cross)
    with pytest.raises(ValueError, match=r"\(B,\)"):
        model.decode_step_ragged_kv(params, cfg,
                                    torch.zeros(B, dtype=torch.int32), 0,
                                    self_kv, cross)


# --------------------------------------------------------------------------
# the paged cache: ops
# --------------------------------------------------------------------------

NB, TPB, M, H, DH = 10, 4, 3, 2, 8


def _pools(rng):
    return [_normal(rng, (NB, TPB, H, DH)) for _ in range(2)]


def test_paged_update_matches_jax_and_drops_what_jax_drops():
    """-1 entries, negative and past-the-table positions write nothing;
    the rest go to [table[pos // tpb], pos % tpb]."""
    rng = np.random.default_rng(4)
    tables = np.asarray([[3, 7, -1], [0, 1, 2], [5, -1, -1], [9, 8, 6],
                         [4, 4, 4]], np.int32)
    pos = np.asarray([9, 5, 2, 13, -1], np.int32)  # 9: under a -1 entry
    pools = _pools(rng)
    new = [_normal(rng, (5, H, 1, DH)) for _ in range(2)]
    ref = jax_att.paged_update_kv_cache(
        *map(jnp.asarray, pools + new), jnp.asarray(tables),
        jnp.asarray(pos))
    got = [torch.from_numpy(p.copy()) for p in pools]
    out = att.paged_update_kv_cache(*got, *map(torch.from_numpy, new),
                                    torch.from_numpy(tables),
                                    torch.from_numpy(pos))
    assert out[0] is got[0]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # only lanes 1 and 2 wrote; lane 2 into block 5 slot 2
    changed = (got[0].numpy() != pools[0]).any(axis=(2, 3))
    assert changed.sum() == 2 and changed[5, 2] and changed[1, 1]
    # a scalar position, and nothing valid at all
    ref = jax_att.paged_update_kv_cache(
        *map(jnp.asarray, pools + new), jnp.asarray(tables), jnp.int32(12))
    got = [torch.from_numpy(p.copy()) for p in pools]
    att.paged_update_kv_cache(*got, *map(torch.from_numpy, new), tables, 12)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), pools[0] if g is got[0]
                                      else pools[1])


@pytest.mark.parametrize("dtype", ["float32", "int8", "fp8"])
def test_paged_prefill_matches_jax(dtype):
    rng = np.random.default_rng(5)
    tables = np.asarray([[2, 6, -1], [0, 9, 3]], np.int32)
    lens = np.asarray([7, 11], np.int32)
    s = 14  # past the tables' 12 positions
    kv = [_normal(rng, (2, H, s, DH)) for _ in range(2)]
    pools = _pools(rng)
    if dtype == "float32":
        jpools = [jnp.asarray(p) for p in pools]
        jkv = [jnp.asarray(x) for x in kv]
    else:
        jdt = QDT[dtype][1]
        jpools = [jnp.asarray(p).astype(jdt) if dtype == "fp8"
                  else jnp.asarray(np.round(p * 20)).astype(jdt)
                  for p in pools]
        jkv = [jnp.asarray(np.round(x * 20)).astype(jdt) for x in kv]
    ref = jax_att.paged_prefill_update(*jpools, *jkv, jnp.asarray(tables),
                                       jnp.asarray(lens))
    got = [to_torch(p) for p in jpools]
    att.paged_prefill_update(*got, *map(to_torch, jkv),
                             torch.from_numpy(tables), torch.from_numpy(lens))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(raw(g), raw(r))


@pytest.mark.parametrize("valid", [10, [12, 1, 7]])
def test_paged_decode_matches_jax_and_the_contiguous_cache(valid):
    rng = np.random.default_rng(6)
    tables = np.asarray([[3, 7, -1], [0, 1, 2], [9, 5, 4]], np.int32)
    pools = _pools(rng)
    q = _normal(rng, (3, H, 1, DH), 0.3)
    vl = np.asarray(valid, np.int32)
    ref = jax_att.paged_mha_decode_step(
        jnp.asarray(q), *map(jnp.asarray, pools), jnp.asarray(tables),
        jnp.asarray(vl))
    out = att.paged_mha_decode_step(torch.from_numpy(q),
                                    *map(torch.from_numpy, pools),
                                    torch.from_numpy(tables),
                                    torch.from_numpy(vl))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)
    # the same rows laid out contiguously
    safe = np.clip(tables, 0, NB - 1)
    k, v = (torch.from_numpy(p[safe].reshape(3, M * TPB, H, DH)).transpose(
        1, 2).contiguous() for p in pools)
    want = att.mha_decode_step(torch.from_numpy(q), k, v,
                               torch.from_numpy(vl))
    assert torch.equal(out, want)


def test_init_paged_cache_shapes():
    k, v = att.init_paged_kv_cache(NB, TPB, H, DH, device="cpu")
    jk, _ = jax_att.init_paged_kv_cache(NB, TPB, H, DH)
    assert tuple(k.shape) == jk.shape and not k.any() and not v.any()


# --------------------------------------------------------------------------
# the paged cache: the host ledger
# --------------------------------------------------------------------------

def _state(c):
    return (c.block_tables().tolist(), c.lengths.tolist(),
            c.owned_blocks.tolist(), c.ledger.free,
            [c.ledger.refcount(i) for i in range(c.ledger.num_blocks)])


@pytest.mark.parametrize("beam", [1, 2])
@pytest.mark.parametrize("seed", range(4))
def test_paged_ledger_equals_jax_over_a_random_lifecycle(seed, beam):
    """Admissions, steps with retirements, beam reorders and tail forks
    drawn from a seed, on the JAX manager and the port's copy: every table,
    length, refcount and error equal after every operation."""
    rng = np.random.default_rng(seed)
    caches = [m.PagedKVCache(24, 4, 6, beam_width=beam) for m in (jax_kvm, kvm)]
    for _ in range(40):
        n = len(caches[0])
        op = rng.integers(0, 4)
        outs = []
        if op == 0 or n == 0:
            args = ("admit", int(rng.integers(0, 5)) * (4 if beam > 1 else 1))
        elif op == 1:
            args = ("advance", rng.random(n) < 0.2)
        elif op == 2 and beam > 1:
            args = ("reorder_beams", int(rng.integers(0, n)),
                    rng.integers(0, beam, beam))
        else:
            args = ("fork_tail", int(rng.integers(0, n)))
        for c in caches:
            try:
                res = getattr(c, args[0])(*args[1:])
                outs.append(("ok", None if res is None
                             else np.asarray(res).tolist()))
            except (MemoryError, ValueError, RuntimeError) as e:
                outs.append((type(e).__name__, None))
        assert outs[0] == outs[1], args
        assert _state(caches[0]) == _state(caches[1]), args
