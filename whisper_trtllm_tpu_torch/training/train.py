"""Fine-tuning: teacher-forced cross-entropy and the train step
(counterpart of ``whisper_trtllm_tpu/training/train.py``).

On the card the loss runs the encoder's self attention and the decoder's
cross attention through the fused flash kernel (K1 forward, K4 backward)
and every LayerNorm through K5 (a plain-op backward); the decoder's causal
self attention (S < 768) and the guided-attention cross attention are the
plain formula, as the JAX package runs them in XLA. The optimizer is
``optax.adamw``'s arithmetic written out in PyTorch.

With a ``mesh`` the step takes the whole batch, as the JAX step takes a
global array, and each data rank its rows of it. The parameters are this
rank's shards (``parallel/partition.py::shard_params``): the model axis
runs through the collectives of ``parallel/collectives.py``, so each rank's
gradients are those of its shards, and the data ranks' gradients are
summed, since the loss is already normalised by the whole batch's count of
target tokens (a mean of the ranks' means would differ wherever their
masks do). AdamW is elementwise and updates the shards where they lie.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Union

import numpy as np
import torch

from whisper_trtllm_tpu_torch.config import WhisperConfig
from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
from whisper_trtllm_tpu_torch.parallel import partition
from whisper_trtllm_tpu_torch.parallel.collectives import all_reduce_
from whisper_trtllm_tpu_torch.parallel.mesh import (
    axis_group,
    check_mesh,
    split_batch,
)
from whisper_trtllm_tpu_torch.utils.device import set_fp32_precision, to_tensor


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def cross_entropy_loss(
    params: dict,
    cfg: WhisperConfig,
    mel: torch.Tensor,
    tokens: torch.Tensor,
    loss_mask: torch.Tensor,
    ga_weights: Optional[torch.Tensor] = None,
    ga_scale=None,
    remat_encoder: bool = False,
    mask_total: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """mel (B, T, M); tokens (B, S) int, decoder start included; loss_mask
    (B, S-1) marks the target positions that count. ``ga_weights``
    (S-1, T_enc) with ``ga_scale`` (a number or a 0-d tensor): the
    guided-attention loss, ``ga_scale`` × the mean cross-attention mass
    outside the known word slots (``guided_attn_weights``). Returns the
    0-d fp32 loss. ``mask_total``: the count of target positions both
    terms are normalised by, the whole batch's where the batch is cut over
    a data axis (default: ``loss_mask``'s)."""
    enc = wmodel.encode(params, cfg, mel, remat=remat_encoder)
    if ga_weights is not None:
        logits, ga_pen = wmodel.decode_full(
            params, cfg, tokens[:, :-1], enc, flash_cross=True,
            ga_weights=ga_weights, ga_row_mask=loss_mask,
            ga_norm=mask_total)
    else:
        ga_pen = None
        logits = wmodel.decode_full(params, cfg, tokens[:, :-1], enc,
                                    flash_cross=True)  # fp32
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    mask = loss_mask.to(nll.dtype)
    count = mask.sum() if mask_total is None else mask_total
    loss = (nll * mask).sum() / torch.clamp(count, min=1.0)
    if ga_pen is not None:
        loss = loss + (ga_scale if ga_scale is not None else 1.0) * ga_pen
    return loss


def guided_attn_weights(
    seq_len: int,
    enc_len: int,
    sigma: float = 10.0,
    lead_s: float = 0.1,
    word_s: float = 0.3,
    pos_per_s: float = 50.0,
) -> np.ndarray:
    """Guided-attention loss weights (numpy (seq_len, enc_len) f32):
    W[i, p] = 1 - exp(-(p - c_i)^2 / (2 sigma^2)), high where
    cross-attention mass should not sit given the synthetic corpus's known
    slot grid. Row 0 (the forced prefix) and rows whose slot falls past the
    encoder are zero (no constraint)."""
    i = np.arange(seq_len)[:, None]
    p = np.arange(enc_len)[None, :]
    center = (lead_s + (i - 1) * word_s + word_s / 2.0) * pos_per_s
    w = 1.0 - np.exp(-((p - center) ** 2) / (2.0 * sigma * sigma))
    w[0, :] = 0.0
    w[center[:, 0] > enc_len - 1, :] = 0.0
    return w.astype(np.float32)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then cosine decay to
    ``end_value`` at ``decay_steps`` (warmup included), held after."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps must exceed warmup_steps, got "
                         f"{decay_steps} <= {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


class AdamW:
    """``optax.adamw``'s arithmetic and defaults (weight decay 1e-4, not
    ``torch.optim.AdamW``'s 1e-2): Adam moments with bias correction, eps
    outside the square root, decoupled weight decay on every leaf, all
    scaled by the learning rate (a number, or a schedule of the step count
    as optax calls it: 0 on the first step).

    Unlike optax, which returns new trees, ``update`` writes the parameters
    and the state in place."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: dict) -> dict:
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict) -> None:
        lr = self.learning_rate
        lr = lr(state["count"]) if callable(lr) else lr
        state["count"] += 1
        # 1 - b**count in fp32, as optax takes it
        f32 = torch.tensor([self.b1, self.b2], dtype=torch.float32)
        bc1, bc2 = (1 - f32 ** state["count"]).tolist()
        b1, b2 = self.b1, self.b2
        for p, g, mu, nu in zip(*map(tree_leaves, (params, grads,
                                                   state["mu"], state["nu"]))):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(-lr * u)


def loss_and_grads(params: dict, cfg: WhisperConfig, mel, tokens, loss_mask,
                   ga_weights=None, ga_scale=None, remat: bool = False,
                   data_group=None):
    """``jax.value_and_grad`` of ``cross_entropy_loss`` with respect to
    every leaf of ``params`` (all floating point: fine-tuning needs a
    float tree, e.g. ``quantization.dequantize_params`` of an int8 one).
    Inputs may be numpy; they go to the parameters' device. Returns (the
    0-d loss, a tree of gradients). With ``data_group`` (the data axis's
    group) the inputs are this rank's rows: the loss is normalised by the
    whole batch's target count, and the loss and the gradients returned
    are summed over the data axis, the whole batch's."""
    leaves = tree_leaves(params)
    if not all(t.is_floating_point() for t in leaves):
        raise TypeError("fine-tuning needs a float parameter tree; "
                        "dequantize int8 weights first")
    dev = leaves[0].device
    live = partition.adopt(
        tree_map(lambda t: t.detach().requires_grad_(True), params), params)
    mel = to_tensor(mel, dev, leaves[0].dtype)
    tokens = to_tensor(tokens, dev, torch.long)
    loss_mask = to_tensor(loss_mask, dev, torch.float32)
    mask_total = None
    if data_group is not None:
        mask_total = all_reduce_(loss_mask.sum(), data_group)
    if ga_weights is not None:
        ga_weights = to_tensor(ga_weights, dev, torch.float32)
    # full fp32 on the card: cuDNN would run the conv stem in TF32
    set_fp32_precision()
    with torch.enable_grad():
        loss = cross_entropy_loss(live, cfg, mel, tokens, loss_mask,
                                  ga_weights, ga_scale, remat_encoder=remat,
                                  mask_total=mask_total)
        flat = tree_leaves(live)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(flat, grads)]
    loss = loss.detach()
    if data_group is not None:
        # one all-reduce for every gradient, and one for the loss
        summed = all_reduce_(torch.cat([g.reshape(-1) for g in grads]),
                             data_group)
        grads = [s.view_as(g) for s, g in zip(
            summed.split([g.numel() for g in grads]), grads)]
        loss = all_reduce_(loss.clone(), data_group)
    grads = iter(grads)
    return loss, tree_map(lambda _: next(grads), params)


def make_train_step(cfg: WhisperConfig, optimizer: Optional[AdamW] = None,
                    mesh=None, remat: bool = False):
    """Returns (init_opt_state, step). ``step(params, opt_state, mel,
    tokens, loss_mask, ga_weights=None, ga_scale=None)`` returns (params,
    opt_state, loss), the first two updated in place. The default
    optimizer is ``AdamW(1e-4)``, as the JAX package's ``optax.adamw(1e-4)``.
    ``remat=True`` rematerializes the encoder per layer. With a ``mesh``
    the step runs inside it on this rank's shards of the parameters and
    its rows of the whole batch it is given (which the data axis must
    divide), and returns the whole batch's loss."""
    check_mesh(mesh)
    optimizer = optimizer or AdamW(1e-4)
    data_group = None if mesh is None else axis_group(mesh, "data")

    def rows(x):
        return split_batch(x if isinstance(x, torch.Tensor)
                           else np.asarray(x), mesh)

    def step(params, opt_state, mel, tokens, loss_mask, ga_weights=None,
             ga_scale=None):
        with mesh if mesh is not None else contextlib.nullcontext():
            loss, grads = loss_and_grads(
                params, cfg, rows(mel), rows(tokens), rows(loss_mask),
                ga_weights, ga_scale, remat=remat, data_group=data_group)
        optimizer.update(params, grads, opt_state)
        return params, opt_state, loss

    return optimizer.init, step
