"""The collectives of tensor and data parallelism, which XLA inserts in
the JAX package and the port issues itself.

Megatron's pair around a block whose weights are cut over the model axis:
``copy_to_model`` where the block's column-parallel input enters (forward
identity, backward all-reduce: each rank's input gradient covers only its
own heads or columns) and ``reduce_from_model`` where its row-parallel
output leaves (forward all-reduce of the ranks' partial sums, backward
identity: the sum's gradient is the same on every rank).
``torch.distributed.nn.functional.all_reduce`` is not that pair: its
backward all-reduces again a gradient that is already the same on every
rank, multiplying it by the axis size. ``gather_data`` joins the ranks'
slices of a batch over the data axis.

A group of None stands for an axis of one rank: nothing is issued. Every
collective issued adds one to ``COUNTS`` (a host counter: a captured CUDA
graph's replays issue their collectives without passing here).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

COUNTS = {"all_reduce": 0, "all_gather": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place (nothing when ``group`` is None);
    returns ``x``."""
    if group is not None:
        dist.all_reduce(x, group=group)
        COUNTS["all_reduce"] += 1
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _recording(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel block: ``x`` itself; where autograd
    records, its gradient is all-reduced over the model axis."""
    if group is None or not _recording(x):
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The partial sums of a row-parallel block, all-reduced over the model
    axis; where autograd does not record, in place on ``x`` (a product that
    nothing else reads)."""
    if group is None:
        return x
    if _recording(x):
        return _ReduceFromModel.apply(x, group)
    return all_reduce_(x, group)


def gather_data(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The ranks' equal slices of a batch (dim 0), joined in rank order
    over the data axis; ``x`` itself when ``group`` is None."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    COUNTS["all_gather"] += 1
    return torch.cat(parts)
