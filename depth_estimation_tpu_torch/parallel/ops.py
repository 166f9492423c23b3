"""Megatron's two operators of tensor parallelism (``parallel/mesh.py``).

``copy_to_group`` (identity forward, all-reduce backward) goes before the
column-parallel matmuls and ``reduce_from_group`` (all-reduce forward,
identity backward) after the row-parallel ones; without the first, the
gradients of everything before a block (LayerNorms, embeddings) would miss
the other ranks' heads. ``torch.distributed.nn.functional.all_reduce`` has
the second operator's forward but not its backward.

This module imports no model, so the ViT's modules can use it while
``parallel.mesh`` cuts them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _CopyToGroup(torch.autograd.Function):
    """Before a column-parallel matmul: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    """After a row-parallel matmul: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)
