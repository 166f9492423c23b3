"""DPT-Large / DPT-Hybrid monocular depth (MiDaS v3), NCHW, torch-hub module names.

Counterpart of the JAX package's ``models/dpt.py``. Pipeline: ViT backbone
with 4 hooks → per-hook readout-project (concat cls, linear, GELU) →
reassemble to maps at strides 4/8/16/32 → 3×3 projection to ``features``
channels → 4 feature-fusion blocks → monocular head.

DPT-Large : ViT-L/16, hooks (5, 11, 17, 23), reassemble channels (256, 512, 1024, 1024)
DPT-Hybrid: ResNetV2-50 stem + ViT-B/16. Pyramid levels 0 and 1 are the
            stem's stage-1 and stage-2 maps as they are (the hub's
            ``act_postprocess1/2`` are identities without weights); levels 2
            and 3 are blocks 8 and 11, reassembled. Channels (256, 512, 768, 768)

Module names follow the hub's ``DPTDepthModel`` (``pretrained.model.*``,
``pretrained.act_postprocess1-4.{0,3,4}``, ``scratch.*``), so the port's
``state_dict`` is the hub's and loads with ``load_state_dict``. The JAX
package's per-section matmul precisions of DPT_Hybrid (the stem at
'highest', the rest at 'high') are the port's full f32 (``device.full_f32``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from depth_estimation_tpu_torch.models.midas_small import FeatureFusionBlock, UpsampleConv3x3
from depth_estimation_tpu_torch.models.vit import ViT, dense


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    hooks: Tuple[int, ...] = (5, 11, 17, 23)
    reassemble_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    features: int = 256
    hybrid: bool = False
    img_size: int = 384
    non_negative: bool = True
    # Per-block rematerialisation of the ViT trunk while a gradient is
    # wanted (models/vit.py ``remat``): the forward and the state dict are
    # unchanged, the backward recomputes each block from its input.
    remat: bool = False


DPT_LARGE = DPTConfig()
DPT_HYBRID = DPTConfig(
    embed_dim=768,
    depth=12,
    num_heads=12,
    hooks=(0, 1, 8, 11),
    reassemble_channels=(256, 512, 768, 768),
    hybrid=True,
)


class Readout(nn.Module):
    """ProjectReadout: fold the cls token into every patch token. ``project``
    is the hub's ``Sequential(Linear, GELU)``; the forward runs both as one
    ``vit.dense`` call, in float32 GELU in the f32 GEMM kernel's epilogue."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tokens):
        cls_tok, feat = tokens[:, :1], tokens[:, 1:]
        return dense(self.project[0], torch.cat([feat, cls_tok.expand_as(feat)], dim=-1), gelu=True)


class Reassemble(nn.Module):
    """Readout → token grid to map → 1×1 projection → resample to the
    pyramid level's stride. Submodules sit at the hub Sequential's slots
    0 (readout), 3 (projection) and 4 (resample)."""

    def __init__(self, dim: int, channels: int, pos: int):
        super().__init__()
        self.add_module("0", Readout(dim))
        self.add_module("3", nn.Conv2d(dim, channels, 1))
        if pos == 0:  # stride 16 → 4
            resample = nn.ConvTranspose2d(channels, channels, 4, stride=4)
        elif pos == 1:  # stride 16 → 8
            resample = nn.ConvTranspose2d(channels, channels, 2, stride=2)
        elif pos == 3:  # stride 16 → 32
            resample = nn.Conv2d(channels, channels, 3, stride=2, padding=1)
        else:
            resample = nn.Identity()
        self.add_module("4", resample)

    def forward(self, tokens, gh: int, gw: int):
        t = self._modules["0"](tokens)
        fm = t.transpose(1, 2).reshape(t.shape[0], t.shape[2], gh, gw)
        return self._modules["4"](self._modules["3"](fm))


class DPT(nn.Module):
    def __init__(self, cfg: DPTConfig = DPT_LARGE):
        super().__init__()
        self.cfg = cfg
        C, f = cfg.embed_dim, cfg.features
        levels = 2 if cfg.hybrid else 0  # pyramid levels that are the stem's conv maps
        self.pretrained = nn.Module()
        self.pretrained.model = ViT(C, cfg.depth, cfg.num_heads, img_size=cfg.img_size,
                                    hooks=cfg.hooks[levels:], hybrid=cfg.hybrid, remat=cfg.remat)
        for pos in range(levels, 4):
            self.pretrained.add_module(f"act_postprocess{pos + 1}",
                                       Reassemble(C, cfg.reassemble_channels[pos], pos))

        self.scratch = nn.Module()
        for i, rc in enumerate(cfg.reassemble_channels):
            self.scratch.add_module(f"layer{i + 1}_rn", nn.Conv2d(rc, f, 3, padding=1, bias=False))
        for i in (1, 2, 3, 4):
            self.scratch.add_module(f"refinenet{i}", FeatureFusionBlock(f, align_corners=True, skip=i != 4))
        self.scratch.output_conv = nn.Sequential(
            nn.Conv2d(f, f // 2, 3, padding=1),
            nn.Identity(),  # the hub's Interpolate; UpsampleConv3x3 upsamples
            UpsampleConv3x3(f // 2, 32, align_corners=True),
            nn.ReLU(),
            nn.Conv2d(32, 1, 1),
            nn.ReLU() if cfg.non_negative else nn.Identity(),
        )

    def forward(self, x: torch.Tensor, hooked=None, grid=None, stem_layers=None) -> torch.Tensor:
        """x: (B, 3, H, W) normalized, H and W multiples of 32 → (B, H, W).

        ``hooked`` / ``grid``: trunk hook tokens and patch grid computed
        outside (the pipelined trunk, ``parallel.pipeline.dpt_apply_pipelined``);
        the ViT is skipped and only the decoder runs on them. DPT_Hybrid then
        also needs ``stem_layers``, its stem's two stage maps."""
        if hooked is None:
            levels, hooked, grid = self.pretrained.model(x)
        elif self.cfg.hybrid:
            if stem_layers is None:
                raise ValueError("hybrid hook injection needs stem_layers")
            levels = list(stem_layers)
        else:
            levels = []
        gh, gw = grid
        pre, s = self.pretrained, self.scratch
        layers = levels + [getattr(pre, f"act_postprocess{len(levels) + i + 1}")(t, gh, gw)
                           for i, t in enumerate(hooked)]
        rn = [getattr(s, f"layer{i + 1}_rn")(layers[i]) for i in range(4)]
        p4 = s.refinenet4(rn[3])
        p3 = s.refinenet3(p4, rn[2])
        p2 = s.refinenet2(p3, rn[1])
        p1 = s.refinenet1(p2, rn[0])
        return s.output_conv(p1)[:, 0]
