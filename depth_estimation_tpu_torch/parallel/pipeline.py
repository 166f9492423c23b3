"""GPipe pipeline parallelism for the ViT trunk (JAX ``parallel/pipeline.py``).

The blocks are split into ``pp`` stages along the mesh's ``pp`` axis; each
rank runs its stage's blocks. Microbatches flow from stage to stage by
``send``/``recv`` over the pp group, in the classic schedule of ``M + pp − 1``
ticks (fill, steady state, drain): at tick t stage s works on microbatch
t − s. JAX runs every stage at every tick on a scanned program; here a stage
simply skips the ticks where it has no microbatch.

The schedule is differentiable, so the same code trains:

* a receive is an autograd Function whose backward sends the gradient back
  to the previous stage, and a send one whose backward receives it from the
  next. NCCL pairs a send with a receive by their order alone (it ignores
  tags), so each stage chains its receives, and its sends, by a token: the
  Function of microbatch m takes the token of microbatch m − 1, and its
  backward must run before that one's. Both sides of a link then exchange
  the gradients in the order M − 1, …, 0, whatever order autograd would
  otherwise pick. No tag is used, so the gloo ranks of the tests pair by
  order too;
* the hooked activations are broadcast from their stage to every rank of the
  pp group, and every rank runs the decoder on them. The decoder's gradient
  is then the same on every rank, so the broadcast's backward keeps the
  owning stage's own gradient and drops the copies; summed over the ranks,
  the trunk's gradient would come out pp times too large.

The weights are replicated over the pp group (as in the JAX package's train
state); the train step takes each gradient from the stage that owns it
(``gradient_owners``) before the optimizer runs. The pipeline composes with ``dp``
(the batch a rank pipelines is its dp slice); a tp axis of the mesh sees
replicated compute inside the trunk, as in JAX.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from depth_estimation_tpu_torch.parallel.mesh import axis_rank, axis_size


def stack_stage_params(depth: int, pp: int, stage: int) -> range:
    """The blocks of stage ``stage`` (stage-major order), the counterpart of
    JAX's stacking of the block trees on a ``(pp, depth // pp)`` axis."""
    if depth % pp:
        raise ValueError(f"depth={depth} not divisible by pp={pp}")
    per_stage = depth // pp
    return range(stage * per_stage, (stage + 1) * per_stage)


# the ViT trunk's blocks by state-dict name (DPT keeps its ViT at
# ``pretrained.model``); DPT_Hybrid's ResNetV2 stem has ``blocks`` of its own
# (``pretrained.model.patch_embed.backbone.stages.S.blocks.B``), outside the pipe
_TRUNK_BLOCK = re.compile(r"(?:^|\.)pretrained\.model\.blocks\.(\d+)\.")


def gradient_owners(names: Sequence[str], pp: int) -> Dict[str, int]:
    """The stage that computes each tensor's whole gradient: its trunk
    block's stage, and stage 0 for everything outside the trunk's blocks
    (the embedding and DPT_Hybrid's stem feed stage 0 as well as the
    decoder, which every rank runs alike)."""
    blocks = {k: int(m.group(1)) for k in names if (m := _TRUNK_BLOCK.search(k))}
    depth = 1 + max(blocks.values(), default=0)
    if depth % pp:
        raise ValueError(f"depth={depth} not divisible by pp={pp}")
    return {k: blocks[k] // (depth // pp) if k in blocks else 0 for k in names}


def hook_table(hooks: Sequence[int], depth: int, pp: int) -> np.ndarray:
    """(pp, k_max) table of stage-local block indices for each hook.

    Every stage gets the same number k_max of slots; stages owning fewer
    hooks are padded with index 0, which is never read (pipeline_blocks only
    reads the real (stage, slot) pairs). So ragged layouts are legal:
    DPT-Large's hooks (5, 11, 17, 23) split evenly at pp ∈ {2, 4}, and
    DPT-Hybrid's transformer hooks both land in the last stage at pp = 2."""
    if depth % pp:
        raise ValueError(f"depth={depth} not divisible by pp={pp}")
    if not hooks:
        raise ValueError("need at least one hook")
    if any(h < 0 or h >= depth for h in hooks):
        raise ValueError(f"hooks {tuple(hooks)} out of range for depth={depth}")
    per_stage = depth // pp
    rows = [
        [h - s * per_stage for h in hooks if s * per_stage <= h < (s + 1) * per_stage]
        for s in range(pp)
    ]
    k_max = max(len(r) for r in rows)
    tbl = [r + [0] * (k_max - len(r)) for r in rows]
    return np.asarray(tbl, np.int32)


class _Recv(torch.autograd.Function):
    """Receive a microbatch from the previous stage; the backward sends its
    gradient back. ``prev`` is the token of the stage's previous receive
    (None for the first): this receive's backward runs before that one's."""

    @staticmethod
    def forward(ctx, anchor, prev, shape, src, group):
        ctx.src, ctx.group, ctx.has_prev = src, group, prev is not None
        buf = torch.empty(shape, dtype=anchor.dtype, device=anchor.device)
        dist.recv(buf, src=src, group=group)
        return buf, anchor.new_zeros(0)

    @staticmethod
    def backward(ctx, grad, _):
        dist.send(grad.contiguous(), dst=ctx.src, group=ctx.group)
        return None, grad.new_zeros(0) if ctx.has_prev else None, None, None, None


class _Send(torch.autograd.Function):
    """Send a microbatch to the next stage; returns a token that keeps the
    send in the graph and chains the next send to it (``prev``, as in
    ``_Recv``). The backward receives the gradient of ``x``."""

    @staticmethod
    def forward(ctx, x, prev, dst, group):
        ctx.dst, ctx.group, ctx.has_prev = dst, group, prev is not None
        ctx.shape, ctx.dtype, ctx.device = x.shape, x.dtype, x.device
        dist.send(x.contiguous(), dst=dst, group=group)
        return x.new_zeros(0)

    @staticmethod
    def backward(ctx, _):
        grad = torch.empty(ctx.shape, dtype=ctx.dtype, device=ctx.device)
        dist.recv(grad, src=ctx.dst, group=ctx.group)
        return grad, grad.new_zeros(0) if ctx.has_prev else None, None, None


class _GatherHooks(torch.autograd.Function):
    """Broadcast each hook from its stage to the whole pp group.

    Inputs: ``like`` (the tokens: the hooks' dtype and device), then the
    stage's tensors that must get a backward whatever the decoder reads (its
    microbatches' last outputs and send tokens: zero gradients), then the
    hooks this stage owns, in hook order. Outputs: every hook, whole. The
    backward gives each owned hook this rank's own gradient (every rank's
    decoder computes the same one)."""

    @staticmethod
    def forward(ctx, like, group, owners, me, n_keep, *tensors):
        keep, owned = tensors[:n_keep], list(tensors[n_keep:])
        ctx.keep = [(t.shape, t.dtype, t.device) for t in keep]
        ctx.mine = [j for j, o in enumerate(owners) if o == me]
        outs = []
        for owner in owners:
            buf = owned.pop(0).clone() if owner == me else torch.empty(like.shape, dtype=like.dtype,
                                                                       device=like.device)
            if group is not None:
                dist.broadcast(buf, src=dist.get_global_rank(group, owner), group=group)
            outs.append(buf)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        zeros = tuple(torch.zeros(shape, dtype=dtype, device=device) for shape, dtype, device in ctx.keep)
        return (None,) * 5 + zeros + tuple(grads[j] for j in ctx.mine)


def pipeline_blocks(run_block: Callable, tokens: torch.Tensor, mesh, hooks: Sequence[int], depth: int,
                    microbatches: int) -> List[torch.Tensor]:
    """Run ``depth`` transformer blocks as a GPipe pipeline over the mesh's
    ``pp`` axis; return the hooked activations, (B, N, C) each, on every rank
    in hook order.

    ``run_block(i, tokens) -> tokens`` runs block ``i``. ``tokens`` (B, N, C)
    is the rank's dp slice (every rank of a pp group computes it; stage 0
    reads it), with B divisible by ``microbatches``. A mesh without a 'pp'
    axis (``make_mesh``'s two-axis mesh) is a pipeline of one stage."""
    pp, stage = axis_size(mesh, "pp"), axis_rank(mesh, "pp")
    M = microbatches
    B, N, C = tokens.shape
    if M < 1 or B % M:
        raise ValueError(f"batch {B} not divisible by microbatches={M}")
    hook_table(hooks, depth, pp)  # validates the hooks against the stages
    per_stage = depth // pp
    blocks = stack_stage_params(depth, pp, stage)
    group = mesh.get_group("pp") if pp > 1 else None
    b = B // M
    x_mb = tokens.reshape(M, b, N, C)
    local = {h: [None] * M for h in hooks if h in blocks}
    keep = []
    recv_token = send_token = None  # the chains that order the backward's exchanges
    for t in range(M + pp - 1):
        m = t - stage  # the microbatch this stage works on at tick t
        if not 0 <= m < M:
            continue
        if stage == 0:
            x = x_mb[m]
        else:
            x, recv_token = _Recv.apply(tokens, recv_token, (b, N, C), dist.get_global_rank(group, stage - 1), group)
        for i in blocks:
            x = run_block(i, x)
            if i in local:
                local[i][m] = x
        keep.append(x)
        if stage < pp - 1:
            send_token = _Send.apply(x, send_token, dist.get_global_rank(group, stage + 1), group)
            keep.append(send_token)
    owned = [torch.cat(local[h]) for h in hooks if h in local]
    return list(_GatherHooks.apply(tokens, group, [h // per_stage for h in hooks], stage, len(keep), *keep, *owned))


def vit_apply_pipelined(vit: nn.Module, x: torch.Tensor, mesh, microbatches: int):
    """``models.vit.ViT.forward`` with the block trunk pipelined over the
    mesh's ``pp`` axis: the same ([conv maps], [hook tokens], (gh, gw)). The
    embedding (and DPT_Hybrid's ResNetV2 stem and 1×1 projection) runs on
    every rank, outside the pipe."""
    levels, tokens, grid = vit.embed(x)
    hooked = pipeline_blocks(vit.run_block, tokens, mesh, vit.hooks, len(vit.blocks), microbatches)
    return levels, hooked, grid


def dpt_apply_pipelined(model: nn.Module, x: torch.Tensor, mesh, microbatches: int = 2) -> torch.Tensor:
    """The whole DPT forward with its ViT trunk pipelined over 'pp'; every
    rank runs the decoder (readout, reassemble, fusion, head) on the hooks.
    For DPT_Hybrid the stem's two stage maps re-enter as ``stem_layers``."""
    levels, hooked, grid = vit_apply_pipelined(model.pretrained.model, x, mesh, microbatches)
    return model(x, hooked=hooked, grid=grid, stem_layers=levels)


class PipelinedDPT(nn.Module):
    """A DPT whose forward is ``dpt_apply_pipelined`` over ``mesh`` (for the
    train step and ``TrainingApply``); its state dict is the DPT's under
    ``model.``."""

    def __init__(self, model: nn.Module, mesh, microbatches: int = 2):
        super().__init__()
        self.model = model
        self.mesh = mesh
        self.microbatches = microbatches

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dpt_apply_pipelined(self.model, x, self.mesh, self.microbatches)
