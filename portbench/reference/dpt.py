"""Plain PyTorch DPT (Ranftl et al., arXiv:2103.13413), as intel-isl/MiDaS's
torch hub builds ``DPT_Large`` and ``DPT_Hybrid``.

The benchmark's reference for the frame program's network. It follows the
hub's ``DPTDepthModel`` and timm's ``vit_large_patch16_384`` /
``vit_base_r50_s16_384`` and keeps their state-dict key names, so one state
dict loads into this model and into the program under test. Everything is
spelled out with ``torch`` and ``torch.nn.functional`` calls: attention is a
softmax between two matmuls, TF-SAME padding is an explicit ``F.pad``, the
fusion blocks upsample before their 1x1 convolution as the hub does. Sizes
come from a configuration file under ``portbench/configs``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _same_pads(size: int, kernel: int, stride: int):
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class StdConv2dSame(nn.Conv2d):
    """timm ``StdConv2dSame``: the kernel standardized per output channel
    (population variance, ``eps`` added under the root), TF-SAME padding."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, eps: float = 1e-6):
        super().__init__(cin, cout, k, stride, bias=False)
        self.eps = eps

    def forward(self, x):
        w = self.weight
        flat = w.reshape(w.shape[0], -1)
        mean = flat.mean(dim=1, keepdim=True)
        var = ((flat - mean) ** 2).mean(dim=1, keepdim=True)
        w = ((flat - mean) / torch.sqrt(var + self.eps)).reshape_as(w)
        (t, b), (l, r) = (_same_pads(n, k, s) for n, k, s in zip(x.shape[-2:], w.shape[-2:], self.stride))
        return F.conv2d(F.pad(x, (l, r, t, b)), w, None, self.stride)


class GroupNormAct(nn.GroupNorm):
    def __init__(self, channels: int, act: bool = True):
        super().__init__(32, channels, eps=1e-5)
        self.act = act

    def forward(self, x):
        x = F.group_norm(x, 32, self.weight, self.bias, self.eps)
        return F.relu(x) if self.act else x


class Bottleneck(nn.Module):
    """timm ResNetV2 non-preact bottleneck, stride on conv2."""

    def __init__(self, cin: int, cout: int, stride: int, eps: float):
        super().__init__()
        mid = cout // 4
        if stride != 1 or cin != cout:
            self.downsample = nn.Module()
            self.downsample.conv = StdConv2dSame(cin, cout, 1, stride, eps)
            self.downsample.norm = GroupNormAct(cout, act=False)
        else:
            self.downsample = None
        self.conv1 = StdConv2dSame(cin, mid, 1, eps=eps)
        self.norm1 = GroupNormAct(mid)
        self.conv2 = StdConv2dSame(mid, mid, 3, stride, eps)
        self.norm2 = GroupNormAct(mid)
        self.conv3 = StdConv2dSame(mid, cout, 1, eps=eps)
        self.norm3 = GroupNormAct(cout, act=False)

    def forward(self, x):
        sc = x if self.downsample is None else self.downsample.norm(self.downsample.conv(x))
        h = self.norm1(self.conv1(x))
        h = self.norm2(self.conv2(h))
        h = self.norm3(self.conv3(h))
        return F.relu(h + sc)


class ResNetV2(nn.Module):
    """The hybrid's backbone: 'same' stem (7x7/2 conv, GroupNorm, ReLU, 3x3/2
    max pool padded with -inf), then stages of bottlenecks."""

    def __init__(self, depths: Sequence[int], widths: Sequence[int], stem_width: int, eps: float):
        super().__init__()
        self.stem = nn.Module()
        self.stem.conv = StdConv2dSame(3, stem_width, 7, 2, eps)
        self.stem.norm = GroupNormAct(stem_width)
        self.stages = nn.ModuleList()
        cin = stem_width
        for i, (d, c) in enumerate(zip(depths, widths)):
            stage = nn.Module()
            stage.blocks = nn.ModuleList(
                Bottleneck(cin if b == 0 else c, c, (1 if i == 0 else 2) if b == 0 else 1, eps) for b in range(d))
            self.stages.append(stage)
            cin = c

    def forward(self, x) -> List[torch.Tensor]:
        x = self.stem.norm(self.stem.conv(x))
        (t, b), (l, r) = (_same_pads(n, 3, 2) for n in x.shape[-2:])
        x = F.max_pool2d(F.pad(x, (l, r, t, b), value=-math.inf), 3, 2)
        outs = []
        for stage in self.stages:
            for block in stage.blocks:
                x = block(x)
            outs.append(x)
        return outs


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        d = C // self.heads
        q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        attn = torch.softmax((q @ k.transpose(-2, -1)) * d ** -0.5, dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int, eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, hidden)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ResidualConvUnit(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.conv1 = nn.Conv2d(f, f, 3, padding=1)
        self.conv2 = nn.Conv2d(f, f, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """MiDaS ``FeatureFusionBlock_custom``: add the skip's residual unit, a
    residual unit, x2 bilinear (align_corners=True), then the 1x1 conv."""

    def __init__(self, f: int, skip: bool):
        super().__init__()
        if skip:
            self.resConfUnit1 = ResidualConvUnit(f)
        self.resConfUnit2 = ResidualConvUnit(f)
        self.out_conv = nn.Conv2d(f, f, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        return self.out_conv(x)


class _Interpolate(nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class Readout(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tokens):
        feat = tokens[:, 1:]
        return self.project(torch.cat([feat, tokens[:, :1].expand_as(feat)], dim=-1))


def _reassemble(dim: int, channels: int, level: int) -> nn.Module:
    """``act_postprocess{level+1}``: readout, tokens to a map (done in the
    forward), 1x1 conv, then resample to stride 4, 8, 16 or 32."""
    seq = nn.Module()
    seq.add_module("0", Readout(dim))
    seq.add_module("3", nn.Conv2d(dim, channels, 1))
    if level == 0:
        seq.add_module("4", nn.ConvTranspose2d(channels, channels, 4, stride=4))
    elif level == 1:
        seq.add_module("4", nn.ConvTranspose2d(channels, channels, 2, stride=2))
    elif level == 3:
        seq.add_module("4", nn.Conv2d(channels, channels, 3, stride=2, padding=1))
    return seq


class DPT(nn.Module):
    """DPT with a ViT trunk (``hybrid``: a ResNetV2 backbone under the patch
    projection). forward: (B, 3, H, W) normalized → (B, H, W) inverse depth."""

    def __init__(self, cfg: Dict):
        super().__init__()
        C = cfg["hidden_size"]
        self.patch = cfg["patch_size"]
        self.hooks = list(cfg["backbone_out_indices"])
        self.hybrid = bool(cfg["is_hybrid"])
        self.orig_grid = cfg["image_size"] // cfg["patch_size"]
        f = cfg["fusion_hidden_size"]
        neck = cfg["neck_hidden_sizes"]
        eps = cfg["layer_norm_eps"]

        self.pretrained = nn.Module()
        model = self.pretrained.model = nn.Module()
        model.patch_embed = nn.Module()
        if self.hybrid:
            h = cfg["backbone_config"]
            model.patch_embed.backbone = ResNetV2(h["depths"], h["hidden_sizes"], h["stem_width"],
                                                  h["std_conv_eps"])
            model.patch_embed.proj = nn.Conv2d(h["hidden_sizes"][-1], C, 1)
        else:
            model.patch_embed.proj = nn.Conv2d(3, C, self.patch, stride=self.patch)
        model.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        model.pos_embed = nn.Parameter(torch.zeros(1, self.orig_grid ** 2 + 1, C))
        model.blocks = nn.ModuleList(
            Block(C, cfg["num_attention_heads"], cfg["intermediate_size"], eps)
            for _ in range(cfg["num_hidden_layers"]))
        self.first_token_level = 2 if self.hybrid else 0
        for level in range(self.first_token_level, 4):
            self.pretrained.add_module(f"act_postprocess{level + 1}", _reassemble(C, neck[level], level))

        self.scratch = nn.Module()
        for i, c in enumerate(neck):
            self.scratch.add_module(f"layer{i + 1}_rn", nn.Conv2d(c, f, 3, padding=1, bias=False))
        for i in (1, 2, 3, 4):
            self.scratch.add_module(f"refinenet{i}", FeatureFusionBlock(f, skip=i != 4))
        self.scratch.output_conv = nn.Sequential(
            nn.Conv2d(f, f // 2, 3, padding=1), _Interpolate(), nn.Conv2d(f // 2, 32, 3, padding=1),
            nn.ReLU(), nn.Conv2d(32, 1, 1), nn.ReLU())

    def _pos_embed(self, gh: int, gw: int):
        pe = self.pretrained.model.pos_embed
        if (gh, gw) == (self.orig_grid, self.orig_grid):
            return pe
        grid = pe[:, 1:].reshape(1, self.orig_grid, self.orig_grid, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False)
        return torch.cat([pe[:, :1], grid.flatten(2).transpose(1, 2)], dim=1)

    def forward(self, x):
        m = self.pretrained.model
        levels = []
        if self.hybrid:
            stages = m.patch_embed.backbone(x)
            levels = stages[:2]
            patches = m.patch_embed.proj(stages[-1])
        else:
            patches = m.patch_embed.proj(x)
        B, C, gh, gw = patches.shape
        tokens = torch.cat([m.cls_token.expand(B, -1, -1), patches.flatten(2).transpose(1, 2)], dim=1)
        tokens = tokens + self._pos_embed(gh, gw)
        hooked = []
        for i, block in enumerate(m.blocks):
            tokens = block(tokens)
            if i in self.hooks[self.first_token_level:]:
                hooked.append(tokens)
        for level, t in enumerate(hooked, start=self.first_token_level):
            post = getattr(self.pretrained, f"act_postprocess{level + 1}")
            fm = post._modules["0"](t).transpose(1, 2).reshape(B, C, gh, gw)
            fm = post._modules["3"](fm)
            if "4" in post._modules:
                fm = post._modules["4"](fm)
            levels.append(fm)
        s = self.scratch
        rn = [getattr(s, f"layer{i + 1}_rn")(levels[i]) for i in range(4)]
        p = s.refinenet4(rn[3])
        p = s.refinenet3(p, rn[2])
        p = s.refinenet2(p, rn[1])
        p = s.refinenet1(p, rn[0])
        return s.output_conv(p)[:, 0]


def build(cfg: Dict) -> DPT:
    """The network of configuration ``cfg``."""
    return DPT(cfg)


def upsampled_1x1(model: DPT) -> List[nn.Conv2d]:
    """The fusion blocks' ``out_conv``: 1x1 convolutions after an x2
    bilinear upsampling, which they commute with."""
    return [m.out_conv for m in model.modules() if isinstance(m, FeatureFusionBlock)]
