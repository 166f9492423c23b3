"""ViT trunk for DPT (vit_large_patch16_384; vit_base_r50_s16_384 for the hybrid), NCHW input.

Counterpart of the JAX package's ``models/vit.py``, with the timm/torch-hub
module names so a hub state dict loads as it is:

* patch embedding as the stride-16 conv ``patch_embed.proj``, or for the
  hybrid timm's ``HybridEmbed``: the ResNetV2 stem ``patch_embed.backbone``
  and the 1×1 conv ``patch_embed.proj`` on its stride-16 output,
* learned cls token + position embedding, resampled bilinearly for
  non-native grids (DPT ``_resize_pos_embed``),
* pre-LN blocks (LN eps 1e-6, qkv-bias attention, exact-GELU MLP), with the
  attention through kernel K1 (``ops.kernels.attention``) and the four
  float32 linear layers through the f32 GEMM kernel (``dense``, which calls
  ``ops.kernels.dense.linear``; fc1's GELU in its epilogue),
* the token tensors at the hook blocks returned before any final norm, as
  DPT's reassemble stage consumes them,
* tensor parallelism (``parallel.mesh.tensor_parallel``): ``Attention`` and
  ``Mlp`` hold a rank's heads and hidden features after ``shard_``, with one
  all-reduce after ``proj`` and one after ``fc2``,
* sequence parallelism (``parallel.mesh.sequence_parallel`` sets
  ``ViT.sp_group``): after the embedding each sp rank keeps its share of the
  tokens (``parallel.ops.scatter_tokens``); LayerNorm, the MLP and the
  queries stay token-local, each attention gathers K and V over the group
  (``gather_kv``) and runs K1 with its local queries against every key, and
  the hook tokens are gathered whole for the decoder (``gather_tokens``). It
  composes with tensor parallelism (K/V of the rank's heads) and with remat,
* per-block rematerialisation (``remat``): while a gradient is wanted, each
  block runs under ``torch.utils.checkpoint``, so the backward recomputes its
  activations from its input instead of storing them.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from depth_estimation_tpu_torch.models.resnetv2 import STAGE_CHANNELS, ResNetV2Stem
from depth_estimation_tpu_torch.ops.kernels.attention import multi_head_attention
from depth_estimation_tpu_torch.ops.kernels.dense import linear, linear_plain
from depth_estimation_tpu_torch.ops.resize import resize_bilinear
from depth_estimation_tpu_torch.parallel.ops import (copy_to_group, gather_kv, gather_tokens, reduce_from_group,
                                                     scatter_tokens, seq_shards)


def _like(layer: nn.Linear, in_features: int, out_features: int) -> nn.Linear:
    w = layer.weight
    return nn.Linear(in_features, out_features, device=w.device, dtype=w.dtype)


def dense(layer: nn.Linear, x, bias: bool = True, gelu: bool = False):
    """``layer(x)`` (without its bias if not ``bias``; then exact-erf GELU if
    ``gelu``): float32 through the f32 GEMM kernel's operator, other dtypes
    through ``F.linear``, whose bf16 products are on the tensor cores already."""
    fn = linear if x.dtype is torch.float32 else linear_plain
    return fn(x, layer.weight, layer.bias if bias else None, gelu)


def _row_parallel(layer: nn.Linear, x, group):
    """``layer(x)`` when whole; cut over ``group``, the partial products
    all-reduced and the whole bias added once."""
    if group is None:
        return dense(layer, x)
    return reduce_from_group(dense(layer, x, bias=False), group) + layer.bias


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.tp_group = None

    def shard_(self, tp: int, group) -> None:
        """Hold one tp rank's ``num_heads/tp`` heads: qkv column-parallel by
        head, proj row-parallel (weights to be loaded from ``shard_params``)."""
        if self.num_heads % tp:
            raise ValueError(f"num_heads={self.num_heads} does not split over tp={tp}: "
                             "the port shards attention by whole heads")
        dim = self.proj.out_features
        self.qkv, self.proj = _like(self.qkv, dim, 3 * dim // tp), _like(self.proj, dim // tp, dim)
        self.num_heads //= tp
        self.tp_group = group

    def forward(self, x, seq=None):
        """x: (B, N, C) tokens; ``seq`` (``parallel.ops.SeqShards``): x is
        this sp rank's share, and K and V are gathered over the group."""
        B, N, _ = x.shape
        H = self.num_heads
        qkv = dense(self.qkv, copy_to_group(x, self.tp_group))
        D = qkv.shape[-1] // (3 * H)
        qkv = qkv.reshape(B, N, 3, H, D)
        if seq is None:
            q, k, v = qkv.permute(2, 0, 3, 1, 4)  # (B, H, N, D) each
        else:  # local queries (B, H, N, D) against every rank's keys and values (B, H, Nk, D)
            q = qkv[:, :, 0].transpose(1, 2)
            k, v = gather_kv(qkv[:, :, 1:], seq).permute(2, 0, 3, 1, 4)
        out = multi_head_attention(q, k, v)
        return _row_parallel(self.proj, out.transpose(1, 2).reshape(B, N, H * D), self.tp_group)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)  # then exact-erf GELU, applied with fc1's product
        self.fc2 = nn.Linear(hidden, dim)
        self.tp_group = None

    def shard_(self, tp: int, group) -> None:
        """Hold one tp rank's ``hidden/tp`` features: fc1 column-parallel, fc2 row-parallel."""
        dim, hidden = self.fc1.in_features, self.fc1.out_features
        if hidden % tp:
            raise ValueError(f"hidden={hidden} does not split over tp={tp}")
        self.fc1, self.fc2 = _like(self.fc1, dim, hidden // tp), _like(self.fc2, hidden // tp, dim)
        self.tp_group = group

    def forward(self, x):
        h = dense(self.fc1, copy_to_group(x, self.tp_group), gelu=True)
        return _row_parallel(self.fc2, h, self.tp_group)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x, seq=None):
        x = x + self.attn(self.norm1(x), seq)
        return x + self.mlp(self.norm2(x))


def resize_pos_embed(pos_embed: torch.Tensor, grid_hw: Tuple[int, int], orig_grid: int) -> torch.Tensor:
    """DPT ``_resize_pos_embed``: bilinear (align_corners=False) resample of
    the grid part of the position embedding; the cls entry passes through."""
    gh, gw = grid_hw
    if (gh, gw) == (orig_grid, orig_grid):
        return pos_embed
    cls_pe, grid_pe = pos_embed[:, :1], pos_embed[:, 1:]
    c = grid_pe.shape[-1]
    grid = resize_bilinear(grid_pe.reshape(1, orig_grid, orig_grid, c), (gh, gw), align_corners=False)
    return torch.cat([cls_pe, grid.reshape(1, gh * gw, c)], dim=1)


class PatchEmbed(nn.Module):
    """Non-overlapping P×P patch projection (timm ``PatchEmbed``)."""

    def __init__(self, features: int, patch: int, in_chans: int = 3):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(in_chans, features, patch, stride=patch)

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        h, w = x.shape[-2:]
        if h % self.patch or w % self.patch:
            raise ValueError(f"input {h}x{w} not a multiple of patch {self.patch}")
        return self.proj(x), []  # (B, C, gh, gw), no conv feature maps


class HybridEmbed(nn.Module):
    """timm ``HybridEmbed``: ResNetV2 stem, then a 1×1 projection of its
    stride-16 output to the embedding. Also returns the stem's stage-1 and
    stage-2 maps, DPT_Hybrid's pyramid levels 0 and 1."""

    def __init__(self, features: int):
        super().__init__()
        self.backbone = ResNetV2Stem()
        self.proj = nn.Conv2d(STAGE_CHANNELS[-1], features, 1)

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        feats, levels = self.backbone(x)
        return self.proj(feats), levels


class ViT(nn.Module):
    """Transformer trunk; returns the patch embedding's conv feature maps
    (the hybrid's, else none) and the hooked token tensors (cls included)."""

    def __init__(self, embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 patch_size: int = 16, img_size: int = 384, hooks: Tuple[int, ...] = (5, 11, 17, 23),
                 hybrid: bool = False, remat: bool = False):
        super().__init__()
        self.hooks = tuple(hooks)
        self.remat = remat
        self.orig_grid = img_size // patch_size
        self.patch_embed = HybridEmbed(embed_dim) if hybrid else PatchEmbed(embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.orig_grid ** 2 + 1, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads) for _ in range(depth))
        self.sp_group = None  # the sp process group under sequence parallelism

    def embed(self, x):
        """x: (B, 3, H, W) → ([conv maps], tokens (B, 1 + gh·gw, C) before the blocks, (gh, gw))."""
        patches, levels = self.patch_embed(x)
        B, C, gh, gw = patches.shape
        tokens = patches.flatten(2).transpose(1, 2)
        tokens = torch.cat([self.cls_token.expand(B, -1, -1), tokens], dim=1)
        tokens = tokens + resize_pos_embed(self.pos_embed, (gh, gw), self.orig_grid)
        return levels, tokens, (gh, gw)

    def run_block(self, i: int, tokens, seq=None):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self.blocks[i], tokens, seq, use_reentrant=False)
        return self.blocks[i](tokens, seq)

    def trunk(self, tokens, group=None):
        """The blocks on the whole embedded tokens (B, N, C) → [tokens (B, N,
        C) per hook], whole. ``group``: the blocks run sequence-parallel over
        it, on this rank's share of the tokens (``parallel/spatial.py``
        passes its axis's group here, and leaves ``sp_group`` alone)."""
        seq = None
        if group is not None:
            seq = seq_shards(group, tokens.shape[1])
            tokens = scatter_tokens(tokens, seq)
        hooked = {}
        for i in range(len(self.blocks)):
            tokens = self.run_block(i, tokens, seq)
            if i in self.hooks:
                hooked[i] = tokens if seq is None else gather_tokens(tokens, seq)
        return [hooked[i] for i in self.hooks]

    def forward(self, x):
        """x: (B, 3, H, W) → ([conv maps], [tokens (B, 1 + gh·gw, C) per hook], (gh, gw)).
        Under sequence parallelism the blocks run on this rank's tokens and
        the hooks come back whole."""
        levels, tokens, grid = self.embed(x)
        return levels, self.trunk(tokens, self.sp_group), grid
