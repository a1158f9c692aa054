"""UNet-2D-condition model, the diffusion family (counterpart of
``whisper_trtllm_tpu/models/unet/model.py``): a Stable-Diffusion-style
``UNet2DConditionModel`` of ResnetBlock2D, Transformer2DModel (self
attention, cross attention, GEGLU feed-forward), Downsample/Upsample2D and
sinusoidal timestep embeddings, channels-last (B, H, W, C) throughout as in
the JAX package. The parameter tree holds Python lists (the blocks of a
stage), which ``params_from_numpy`` keeps.

The block topology is the JAX package's: down blocks push a residual after
every resnet and after the downsampler, up blocks pop one a resnet and
concatenate it on channels, the mid block runs resnet → [attention →
resnet].

On the card every Transformer2D block's two attentions run K1: both are
unmasked and bidirectional with S = H·W > 1 queries, so
``ops/attention.py::mha`` dispatches them to it as the JAX package does;
the cross attention's S queries attend T context rows (77 for SD's text
encoder), S ≠ T. Its three LayerNorms run K5. At SD-1.x's topology (16
Transformer2D blocks) a forward launches K1 32 times and K5 48 times. The
convolutions (cuDNN), the group norms and the products are torch ops, as
the JAX package runs them in XLA; ``forward`` sets full fp32 precision
for them on the card (``utils/device.py::set_fp32_precision``).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from whisper_trtllm_tpu_torch.layers.init import init_dense, init_layer_norm
from whisper_trtllm_tpu_torch.models.zoo import split_heads
from whisper_trtllm_tpu_torch.ops.attention import mha
from whisper_trtllm_tpu_torch.ops.functional import (
    conv2d,
    dense,
    gelu,
    group_norm,
    layer_norm,
    upsample_nearest_2x,
)
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy
from whisper_trtllm_tpu_torch.utils.device import (
    resolve_device,
    set_fp32_precision,
    to_tensor,
)


@dataclass(frozen=True)
class UNetConfig:
    """Defaults are Stable Diffusion v1.x's."""
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D")
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D")
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    resnet_eps: float = 1e-6
    cross_attention_dim: int = 1280
    attention_head_dim: int = 8        # number of heads (diffusers naming)
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @classmethod
    def testing(cls, **overrides) -> "UNetConfig":
        kw = dict(
            in_channels=4, out_channels=4, block_out_channels=(32, 64),
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            layers_per_block=1, norm_num_groups=8, cross_attention_dim=16,
            attention_head_dim=2,
        )
        kw.update(overrides)
        return cls(**kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def timestep_embedding(cfg: UNetConfig, timesteps) -> torch.Tensor:
    """timesteps (B,) → (B, block_out_channels[0]) fp32 sinusoids, DDPM's
    convention (cos then sin when ``flip_sin_to_cos``, SD's), on the
    timesteps' device (the CPU for numpy)."""
    t = timesteps if isinstance(timesteps, torch.Tensor) else \
        torch.from_numpy(np.asarray(timesteps))
    dim = cfg.block_out_channels[0]
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device)
    exponent = exponent / (half - cfg.freq_shift)
    freqs = torch.exp(exponent)
    args = t.float()[:, None] * freqs[None]
    if cfg.flip_sin_to_cos:
        return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


# -- parameter constructors ---------------------------------------------------

def _init_conv(rng, kh, kw, cin, cout):
    fan_in = kh * kw * cin
    return {
        "kernel": rng.normal(0.0, fan_in ** -0.5, (kh, kw, cin, cout))
        .astype(np.float32),
        "bias": np.zeros((cout,), np.float32),
    }


def _init_gn(c):
    return {"scale": np.ones((c,), np.float32),
            "bias": np.zeros((c,), np.float32)}


def _init_resnet(rng, cfg, cin, cout):
    p = {
        "norm1": _init_gn(cin),
        "conv1": _init_conv(rng, 3, 3, cin, cout),
        "time_emb_proj": init_dense(rng, cfg.time_embed_dim, cout),
        "norm2": _init_gn(cout),
        "conv2": _init_conv(rng, 3, 3, cout, cout),
    }
    if cin != cout:
        p["conv_shortcut"] = _init_conv(rng, 1, 1, cin, cout)
    return p


def _init_attn(rng, q_dim, kv_dim, inner):
    return {
        "q": init_dense(rng, q_dim, inner, bias=False),
        "k": init_dense(rng, kv_dim, inner, bias=False),
        "v": init_dense(rng, kv_dim, inner, bias=False),
        "out": init_dense(rng, inner, q_dim),
    }


def _init_transformer2d(rng, cfg, channels):
    inner = channels  # heads * (channels // heads)
    block = {
        "norm1": init_layer_norm(inner),
        "attn1": _init_attn(rng, inner, inner, inner),
        "norm2": init_layer_norm(inner),
        "attn2": _init_attn(rng, inner, cfg.cross_attention_dim, inner),
        "norm3": init_layer_norm(inner),
        "ff_in": init_dense(rng, inner, inner * 8),   # GEGLU: 2x inner*4
        "ff_out": init_dense(rng, inner * 4, inner),
    }
    return {
        "norm": _init_gn(channels),
        "proj_in": _init_conv(rng, 1, 1, channels, inner),
        "blocks": [block],
        "proj_out": _init_conv(rng, 1, 1, inner, channels),
    }


def init_params(cfg: UNetConfig, seed: int = 0, device=None) -> dict:
    """Random weights drawn in numpy in the JAX package's order (equal to
    its ``init_params(cfg, seed)`` bit for bit), as fp32 tensors on
    ``device`` (the CUDA card by default)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    ch0 = cfg.block_out_channels[0]
    p = {
        "conv_in": _init_conv(rng, 3, 3, cfg.in_channels, ch0),
        "time_mlp_1": init_dense(rng, ch0, cfg.time_embed_dim),
        "time_mlp_2": init_dense(rng, cfg.time_embed_dim, cfg.time_embed_dim),
        "down": [], "up": [],
        "conv_norm_out": _init_gn(ch0),
        "conv_out": _init_conv(rng, 3, 3, ch0, cfg.out_channels),
    }
    out_c = ch0
    for i, btype in enumerate(cfg.down_block_types):
        in_c, out_c = out_c, cfg.block_out_channels[i]
        is_final = i == len(cfg.block_out_channels) - 1
        blk = {"resnets": [], "attns": []}
        for j in range(cfg.layers_per_block):
            blk["resnets"].append(
                _init_resnet(rng, cfg, in_c if j == 0 else out_c, out_c))
            if btype == "CrossAttnDownBlock2D":
                blk["attns"].append(_init_transformer2d(rng, cfg, out_c))
        if not is_final:
            blk["downsample"] = _init_conv(rng, 3, 3, out_c, out_c)
        p["down"].append(blk)
    last = cfg.block_out_channels[-1]
    p["mid"] = {
        "resnets": [_init_resnet(rng, cfg, last, last),
                    _init_resnet(rng, cfg, last, last)],
        "attns": [_init_transformer2d(rng, cfg, last)],
    }
    rev = list(reversed(cfg.block_out_channels))
    out_c = rev[0]
    for i, btype in enumerate(cfg.up_block_types):
        prev_out, out_c = out_c, rev[i]
        in_c = rev[min(i + 1, len(rev) - 1)]
        is_final = i == len(rev) - 1
        blk = {"resnets": [], "attns": []}
        n = cfg.layers_per_block + 1
        for j in range(n):
            skip_c = in_c if j == n - 1 else out_c
            res_in = prev_out if j == 0 else out_c
            blk["resnets"].append(
                _init_resnet(rng, cfg, res_in + skip_c, out_c))
            if btype == "CrossAttnUpBlock2D":
                blk["attns"].append(_init_transformer2d(rng, cfg, out_c))
        if not is_final:
            blk["upsample"] = _init_conv(rng, 3, 3, out_c, out_c)
        p["up"].append(blk)
    return params_from_numpy(p, dev)


# -- blocks -------------------------------------------------------------------

def _resnet(p, cfg, x, temb):
    h = group_norm(p["norm1"], x, cfg.norm_num_groups, eps=cfg.resnet_eps)
    h = conv2d(p["conv1"], F.silu(h), padding=1)
    t = dense(p["time_emb_proj"], F.silu(temb))
    h = h + t[:, None, None, :]
    h = group_norm(p["norm2"], h, cfg.norm_num_groups, eps=cfg.resnet_eps)
    h = conv2d(p["conv2"], F.silu(h), padding=1)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x)
    return x + h


def _attention(p, x, context, heads):
    """Pre-scaled-q attention over (B, S, C) sequences; ``context``
    defaults to x (self attention)."""
    b, s, c = x.shape
    ctx = x if context is None else context
    dh = c // heads
    q = split_heads(dense(p["q"], x), heads, dh) * dh ** -0.5
    k = split_heads(dense(p["k"], ctx), heads, dh)
    v = split_heads(dense(p["v"], ctx), heads, dh)
    o = mha(q, k, v)
    return dense(p["out"], o.transpose(1, 2).reshape(b, s, c))


def _transformer2d(p, cfg, x, context):
    b, hh, ww, c = x.shape
    residual = x
    h = group_norm(p["norm"], x, cfg.norm_num_groups, eps=1e-6)
    h = conv2d(p["proj_in"], h).reshape(b, hh * ww, c)
    for blk in p["blocks"]:
        h = h + _attention(blk["attn1"], layer_norm(blk["norm1"], h), None,
                           cfg.attention_head_dim)
        h = h + _attention(blk["attn2"], layer_norm(blk["norm2"], h), context,
                           cfg.attention_head_dim)
        ff = dense(blk["ff_in"], layer_norm(blk["norm3"], h))
        gate_in, gate = ff.chunk(2, dim=-1)
        h = h + dense(blk["ff_out"], gate_in * gelu(gate))
    h = conv2d(p["proj_out"], h.reshape(b, hh, ww, c))
    return h + residual


@torch.inference_mode()
def forward(params: dict, cfg: UNetConfig, sample, timesteps,
            encoder_hidden_states) -> torch.Tensor:
    """sample (B, H, W, in_channels) channels-last; timesteps (B,);
    encoder_hidden_states (B, T, cross_attention_dim) → (B, H, W,
    out_channels), on the parameters' device and in their dtype."""
    dev = params["conv_in"]["kernel"].device
    dtype = params["conv_in"]["kernel"].dtype
    if dev.type == "cuda":
        set_fp32_precision()
    sample = to_tensor(sample, dev, dtype)
    context = to_tensor(encoder_hidden_states, dev, dtype)
    temb = timestep_embedding(cfg, to_tensor(timesteps, dev)).to(dtype)
    temb = dense(params["time_mlp_2"],
                 F.silu(dense(params["time_mlp_1"], temb)))

    x = conv2d(params["conv_in"], sample, padding=1)
    res_stack = [x]
    for blk, btype in zip(params["down"], cfg.down_block_types):
        cross = btype == "CrossAttnDownBlock2D"
        for j, rp in enumerate(blk["resnets"]):
            x = _resnet(rp, cfg, x, temb)
            if cross:
                x = _transformer2d(blk["attns"][j], cfg, x, context)
            res_stack.append(x)
        if "downsample" in blk:
            x = conv2d(blk["downsample"], x, stride=2, padding=1)
            res_stack.append(x)

    mid = params["mid"]
    x = _resnet(mid["resnets"][0], cfg, x, temb)
    for ap, rp in zip(mid["attns"], mid["resnets"][1:]):
        x = _transformer2d(ap, cfg, x, context)
        x = _resnet(rp, cfg, x, temb)

    for blk, btype in zip(params["up"], cfg.up_block_types):
        cross = btype == "CrossAttnUpBlock2D"
        for j, rp in enumerate(blk["resnets"]):
            x = torch.cat([x, res_stack.pop()], dim=-1)
            x = _resnet(rp, cfg, x, temb)
            if cross:
                x = _transformer2d(blk["attns"][j], cfg, x, context)
        if "upsample" in blk:
            x = conv2d(blk["upsample"], upsample_nearest_2x(x), padding=1)

    x = group_norm(params["conv_norm_out"], x, cfg.norm_num_groups,
                   eps=cfg.norm_eps)
    return conv2d(params["conv_out"], F.silu(x), padding=1)


# -- diffusers checkpoint conversion ------------------------------------------

def convert_diffusers_unet(state_dict: dict, cfg: UNetConfig,
                           device=None) -> dict:
    """A diffusers ``UNet2DConditionModel`` state dict (numpy arrays or
    tensors; convolution kernels (Cout, Cin, KH, KW)) → the channels-last
    parameter tree as tensors on ``device`` (the CUDA card by default)."""
    dev = resolve_device(device)
    sd = {k: (v.detach().cpu().float().numpy()
              if isinstance(v, torch.Tensor) else np.asarray(v))
          for k, v in state_dict.items()}

    def conv(prefix):
        return {
            "kernel": np.ascontiguousarray(
                sd[prefix + ".weight"].transpose(2, 3, 1, 0)),
            "bias": sd[prefix + ".bias"],
        }

    def lin(prefix, bias=True):
        out = {"kernel": np.ascontiguousarray(sd[prefix + ".weight"].T)}
        if bias:
            out["bias"] = sd[prefix + ".bias"]
        return out

    def gn(prefix):
        return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}

    def resnet(prefix, has_shortcut):
        p = {
            "norm1": gn(prefix + ".norm1"),
            "conv1": conv(prefix + ".conv1"),
            "time_emb_proj": lin(prefix + ".time_emb_proj"),
            "norm2": gn(prefix + ".norm2"),
            "conv2": conv(prefix + ".conv2"),
        }
        if has_shortcut:
            p["conv_shortcut"] = conv(prefix + ".conv_shortcut")
        return p

    def transformer(prefix):
        bp = prefix + ".transformer_blocks.0"

        def attn(ap):
            return {
                "q": lin(ap + ".to_q", bias=False),
                "k": lin(ap + ".to_k", bias=False),
                "v": lin(ap + ".to_v", bias=False),
                "out": lin(ap + ".to_out.0"),
            }

        return {
            "norm": gn(prefix + ".norm"),
            "proj_in": conv(prefix + ".proj_in"),
            "blocks": [{
                "norm1": gn(bp + ".norm1"),
                "attn1": attn(bp + ".attn1"),
                "norm2": gn(bp + ".norm2"),
                "attn2": attn(bp + ".attn2"),
                "norm3": gn(bp + ".norm3"),
                "ff_in": lin(bp + ".ff.net.0.proj"),
                "ff_out": lin(bp + ".ff.net.2"),
            }],
            "proj_out": conv(prefix + ".proj_out"),
        }

    def has(name):
        return name + ".weight" in sd

    params = {
        "conv_in": conv("conv_in"),
        "time_mlp_1": lin("time_embedding.linear_1"),
        "time_mlp_2": lin("time_embedding.linear_2"),
        "conv_norm_out": gn("conv_norm_out"),
        "conv_out": conv("conv_out"),
        "down": [], "up": [],
    }
    for i, btype in enumerate(cfg.down_block_types):
        base = f"down_blocks.{i}"
        blk = {"resnets": [], "attns": []}
        for j in range(cfg.layers_per_block):
            rp = f"{base}.resnets.{j}"
            blk["resnets"].append(resnet(rp, has(rp + ".conv_shortcut")))
            if btype == "CrossAttnDownBlock2D":
                blk["attns"].append(transformer(f"{base}.attentions.{j}"))
        if has(base + ".downsamplers.0.conv"):
            blk["downsample"] = conv(base + ".downsamplers.0.conv")
        params["down"].append(blk)
    params["mid"] = {
        "resnets": [resnet("mid_block.resnets.0", False),
                    resnet("mid_block.resnets.1", False)],
        "attns": [transformer("mid_block.attentions.0")],
    }
    for i, btype in enumerate(cfg.up_block_types):
        base = f"up_blocks.{i}"
        blk = {"resnets": [], "attns": []}
        for j in range(cfg.layers_per_block + 1):
            rp = f"{base}.resnets.{j}"
            blk["resnets"].append(resnet(rp, has(rp + ".conv_shortcut")))
            if btype == "CrossAttnUpBlock2D":
                blk["attns"].append(transformer(f"{base}.attentions.{j}"))
        if has(base + ".upsamplers.0.conv"):
            blk["upsample"] = conv(base + ".upsamplers.0.conv")
        params["up"].append(blk)
    return params_from_numpy(params, dev)
