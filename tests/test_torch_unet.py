"""PyTorch port: the UNet-2D-condition model (``models/unet``) and its
channels-last ops (``ops/functional.py``: ``group_norm``, ``conv2d``,
``upsample_nearest_2x``, ``avg_pool_2x``) against the JAX package's, on the
CPU.

The four ops within 1e-6 of JAX's (fp32 sums in another order);
``timestep_embedding`` within 1e-5 (fp32 exp and cos of arguments up to
~1000, rounded one ulp apart); ``forward`` at ``UNetConfig.testing`` and at
the SD-depth toy topology of ``tests/test_unet.py`` within 2e-4, the JAX
package's own tolerance against its torch twin; ``init_params`` and
``convert_diffusers_unet`` bit-equal to JAX's, the Python lists of the
tree kept."""

import numpy as np
import pytest
import torch

import zoo_parity
from torch_threads import capped_threads  # noqa: F401
import whisper_trtllm_tpu.models.unet.model as junet
import whisper_trtllm_tpu.ops.functional as jf
import whisper_trtllm_tpu_torch.models.unet.model as tunet
import whisper_trtllm_tpu_torch.ops.functional as tf

OP_TOL = 1e-6
TEMB_TOL = 1e-5
FORWARD_TOL = 2e-4


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _x(seed, shape=(2, 9, 8, 16)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("with_bias", [True, False])
def test_group_norm_matches_jax(with_bias):
    rng = np.random.default_rng(0)
    x = _x(1) * 3.0 + 1.5
    p = {"scale": rng.standard_normal(16).astype(np.float32)}
    if with_bias:
        p["bias"] = rng.standard_normal(16).astype(np.float32)
    got = tf.group_norm(_t(p), torch.from_numpy(x), 4, eps=1e-6).numpy()
    want = np.asarray(jf.group_norm(p, x, 4, eps=1e-6))
    np.testing.assert_allclose(got, want, atol=OP_TOL, rtol=OP_TOL)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", [0, 1])
def test_conv2d_matches_jax(stride, padding):
    rng = np.random.default_rng(stride + 2 * padding)
    p = {"kernel": (rng.standard_normal((3, 3, 16, 8)) / 12).astype(
        np.float32), "bias": rng.standard_normal(8).astype(np.float32)}
    x = _x(2)
    got = tf.conv2d(_t(p), torch.from_numpy(x), stride, padding).numpy()
    want = np.asarray(jf.conv2d(p, x, stride, padding))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=OP_TOL, rtol=OP_TOL)


@pytest.mark.parametrize("op", ["upsample_nearest_2x", "avg_pool_2x"])
def test_resampling_matches_jax(op):
    x = _x(3)
    got = getattr(tf, op)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jf, op)(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=OP_TOL, rtol=OP_TOL)


def test_timestep_embedding_matches_jax():
    cfg = junet.UNetConfig.testing()
    ts = np.array([0.0, 5.0, 999.0], np.float32)
    got = tunet.timestep_embedding(cfg, ts).numpy()
    np.testing.assert_allclose(got, np.asarray(
        junet.timestep_embedding(cfg, ts)), atol=TEMB_TOL, rtol=0)


SD_DEPTH = dict(
    block_out_channels=(8, 8, 16, 16),
    down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                      "CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D",
                    "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
    norm_num_groups=4, attention_head_dim=1, cross_attention_dim=8)


@pytest.mark.parametrize("topology", ["testing", "sd depth"])
def test_forward_matches_jax(topology):
    """``UNetConfig.testing`` at batch 2 over 16x16 latents and 3 context
    rows; SD-1.x's depth (4 stages, 3 downsamples) at toy widths at batch
    1 over 32x32 and 2 rows."""
    rng = np.random.default_rng(4)
    if topology == "testing":
        cfg, seed, b, hw, t = junet.UNetConfig.testing(), 0, 2, 16, 3
        ts = np.array([5.0, 999.0], np.float32)
    else:
        cfg, seed, b, hw, t = junet.UNetConfig.testing(**SD_DEPTH), 1, 1, 32, 2
        ts = np.array([7.0], np.float32)
    sample = rng.standard_normal((b, hw, hw, cfg.in_channels)).astype(
        np.float32)
    ctx = rng.standard_normal((b, t, cfg.cross_attention_dim)).astype(
        np.float32)
    tcfg = tunet.UNetConfig(**cfg.__dict__)
    got = tunet.forward(tunet.init_params(tcfg, seed=seed, device="cpu"),
                        tcfg, sample, ts, ctx).numpy()
    want = np.asarray(junet.forward(junet.init_params(cfg, seed=seed), cfg,
                                    sample, ts, ctx))
    assert got.shape == (b, hw, hw, cfg.out_channels)
    np.testing.assert_allclose(got, want, atol=FORWARD_TOL, rtol=FORWARD_TOL)


def _to_diffusers(p: dict, cfg) -> dict:
    """Our tree back to a diffusers state dict (NCHW kernels (Cout, Cin,
    KH, KW), linear weights (out, in)): the inverse of the conversion."""
    sd = {}

    def conv(prefix, q):
        sd[prefix + ".weight"] = np.ascontiguousarray(
            q["kernel"].transpose(3, 2, 0, 1))
        sd[prefix + ".bias"] = q["bias"]

    def lin(prefix, q):
        sd[prefix + ".weight"] = np.ascontiguousarray(q["kernel"].T)
        if "bias" in q:
            sd[prefix + ".bias"] = q["bias"]

    def gn(prefix, q):
        sd[prefix + ".weight"], sd[prefix + ".bias"] = q["scale"], q["bias"]

    def resnet(prefix, q):
        for name in ("norm1", "norm2"):
            gn(f"{prefix}.{name}", q[name])
        for name in ("conv1", "conv2", "conv_shortcut"):
            if name in q:
                conv(f"{prefix}.{name}", q[name])
        lin(prefix + ".time_emb_proj", q["time_emb_proj"])

    def transformer(prefix, q):
        gn(prefix + ".norm", q["norm"])
        conv(prefix + ".proj_in", q["proj_in"])
        conv(prefix + ".proj_out", q["proj_out"])
        blk, bp = q["blocks"][0], prefix + ".transformer_blocks.0"
        for name in ("norm1", "norm2", "norm3"):
            gn(f"{bp}.{name}", blk[name])
        for name in ("attn1", "attn2"):
            for ours, theirs in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                                 ("out", "to_out.0")):
                lin(f"{bp}.{name}.{theirs}", blk[name][ours])
        lin(bp + ".ff.net.0.proj", blk["ff_in"])
        lin(bp + ".ff.net.2", blk["ff_out"])

    conv("conv_in", p["conv_in"])
    conv("conv_out", p["conv_out"])
    gn("conv_norm_out", p["conv_norm_out"])
    lin("time_embedding.linear_1", p["time_mlp_1"])
    lin("time_embedding.linear_2", p["time_mlp_2"])
    for kind, blocks in (("down", p["down"]), ("up", p["up"])):
        for i, blk in enumerate(blocks):
            base = f"{kind}_blocks.{i}"
            for j, r in enumerate(blk["resnets"]):
                resnet(f"{base}.resnets.{j}", r)
            for j, a in enumerate(blk["attns"]):
                transformer(f"{base}.attentions.{j}", a)
            if "downsample" in blk:
                conv(base + ".downsamplers.0.conv", blk["downsample"])
            if "upsample" in blk:
                conv(base + ".upsamplers.0.conv", blk["upsample"])
    for j, r in enumerate(p["mid"]["resnets"]):
        resnet(f"mid_block.resnets.{j}", r)
    transformer("mid_block.attentions.0", p["mid"]["attns"][0])
    return sd


@pytest.mark.parametrize("topology", ["testing", "sd depth"])
def test_init_params_and_conversion_equal_jax(topology):
    cfg = (junet.UNetConfig.testing() if topology == "testing"
           else junet.UNetConfig.testing(**SD_DEPTH))
    tcfg = tunet.UNetConfig(**cfg.__dict__)
    jp = junet.init_params(cfg, seed=5)
    tp = tunet.init_params(tcfg, seed=5, device="cpu")
    zoo_parity.assert_trees_equal(tp, jp)
    sd = _to_diffusers(jp, cfg)
    want = junet.convert_diffusers_unet(sd, cfg)
    got = tunet.convert_diffusers_unet(sd, tcfg, device="cpu")
    zoo_parity.assert_trees_equal(got, want)
    # the conversion inverts _to_diffusers: the tree comes back whole
    zoo_parity.assert_trees_equal(got, jp)
    got_t = tunet.convert_diffusers_unet(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tcfg, device="cpu")
    zoo_parity.assert_trees_equal(got_t, want)
