"""The differentiable collectives of tensor and sequence parallelism.

Tensor parallelism (``parallel/mesh.py``) uses Megatron's two operators:
``copy_to_group`` (identity forward, all-reduce backward) goes before the
column-parallel matmuls and ``reduce_from_group`` (all-reduce forward,
identity backward) after the row-parallel ones; without the first, the
gradients of everything before a block (LayerNorms, embeddings) would miss
the other ranks' heads. ``torch.distributed.nn.functional.all_reduce`` has
the second operator's forward but not its backward.

Sequence parallelism (``parallel.mesh.sequence_parallel``) cuts a ViT's
tokens, cls included, over the mesh's ``sp`` group as evenly as their count
allows (``token_counts``: 577 over 2 is 289 and 288; the JAX package pads the
tokens to a multiple instead, which changes nothing numerically). Three
operators move them, each along the token axis (dim 1):

* ``scatter_tokens`` — into the sp region after the embedding: this rank's
  tokens forward; backward, the token gradients of every rank gathered, so
  that the embedding (and DPT_Hybrid's stem) gets its whole gradient on
  every rank;
* ``gather_kv`` — K and V of every rank's tokens for the local queries
  (kernel K1 then runs with Nk ≠ Nq); backward, each rank keeps the sum
  over all ranks of the gradient on its own tokens (a reduce-scatter,
  made as an all-reduce and a slice);
* ``gather_tokens`` — the hook tokens for the decoder, which every sp rank
  runs whole; backward, this rank's slice of its own gradient, with no sum,
  since every sp rank's decoder computes the same gradient.

The all-gathers pad every rank's tokens to the largest count and strip the
padding, since the backends' all-gathers take equal sizes. Inside the sp
region the blocks' parameters see only the rank's tokens, so their
gradients are partial and are summed over sp by the train step
(``train.step.sync_gradients``); everything outside it (the embedding, the
decoder) has its whole gradient on every sp rank.

This module imports no model, so the ViT's modules can use it while
``parallel.mesh`` cuts them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

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


# -- sequence parallelism ---------------------------------------------------


def token_counts(n: int, size: int) -> Tuple[int, ...]:
    """``n`` tokens over ``size`` ranks as evenly as the count allows, the
    first ``n % size`` ranks one more."""
    return tuple(n // size + (r < n % size) for r in range(size))


class SeqShards(NamedTuple):
    """How one forward cuts its tokens: over ``group`` of ``size`` ranks, this
    one ``rank``, rank r holding ``counts[r]`` consecutive tokens."""
    group: object
    size: int
    rank: int
    counts: Tuple[int, ...]

    @property
    def start(self) -> int:
        return sum(self.counts[:self.rank])


def seq_shards(group, n: int) -> SeqShards:
    size = dist.get_world_size(group)
    return SeqShards(group, size, dist.get_rank(group), token_counts(n, size))


def _all_gather_tokens(x: torch.Tensor, seq: SeqShards) -> torch.Tensor:
    """Every rank's tokens, in rank order, along dim 1."""
    most = max(seq.counts)
    x = x.contiguous()
    if x.shape[1] < most:
        x = torch.cat([x, x.new_zeros((x.shape[0], most - x.shape[1], *x.shape[2:]))], 1)
    parts = [torch.empty_like(x) for _ in range(seq.size)]
    dist.all_gather(parts, x, group=seq.group)
    return torch.cat([p[:, :c] for p, c in zip(parts, seq.counts)], 1)


def _own_tokens(x: torch.Tensor, seq: SeqShards) -> torch.Tensor:
    return x.narrow(1, seq.start, seq.counts[seq.rank])


class _ScatterTokens(torch.autograd.Function):
    """This rank's tokens; backward, every rank's token gradients gathered."""

    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return _own_tokens(x, seq).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_tokens(grad, ctx.seq), None


class _GatherKV(torch.autograd.Function):
    """Every rank's tokens; backward, the sum over ranks of the gradient on this rank's tokens."""

    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return _all_gather_tokens(x, seq)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.seq.group)
        return _own_tokens(grad, ctx.seq).contiguous(), None


class _GatherTokens(torch.autograd.Function):
    """Every rank's tokens; backward, this rank's slice of its own gradient."""

    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return _all_gather_tokens(x, seq)

    @staticmethod
    def backward(ctx, grad):
        return _own_tokens(grad, ctx.seq).contiguous(), None


def scatter_tokens(x: torch.Tensor, seq: SeqShards) -> torch.Tensor:
    return _ScatterTokens.apply(x, seq)


def gather_kv(x: torch.Tensor, seq: SeqShards) -> torch.Tensor:
    return _GatherKV.apply(x, seq)


def gather_tokens(x: torch.Tensor, seq: SeqShards) -> torch.Tensor:
    return _GatherTokens.apply(x, seq)
