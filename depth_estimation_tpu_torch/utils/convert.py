"""JAX parameter tree → the port's state dict.

The port's depth modules keep the torch-hub key names, so these are the
inverses of the JAX package's ``utils/convert.py::convert_dpt``,
``::convert_midas_small`` and ``::convert_midas_v21`` (hub state dict → Flax
params). The detector nets (BlazeFace, FaceMesh+iris, BlazePose) keep the
Flax module names instead, so their converters walk the tree key for key.
They let both packages run on the same weights.

Layout rules (inverse of the JAX converter's):
  conv kernel        (kH, kW, I, O) → (O, I, kH, kW)   (patch embed included)
  dense kernel       (in, out)      → (out, in)
  conv-transpose     (kH, kW, I, O) → (I, O, kH, kW), spatially flipped
  grouped conv       (kH, kW, I/G, O) → (O, I/G, kH, kW)
  layer norm         scale/bias     → weight/bias
  frozen batch norm  scale/bias/mean/var → weight/bias/running_mean/running_var
  group norm         {"gn": {scale, bias}} → weight/bias
  depthwise conv     (kH, kW, 1, C) → (C, 1, kH, kW)   (the conv rule)
  PReLU              alpha          → alpha
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from depth_estimation_tpu_torch.models.dpt import DPT_LARGE, DPTConfig
from depth_estimation_tpu_torch.models.efficientnet_lite import LAYER_STAGES, LITE3_STAGES
from depth_estimation_tpu_torch.models.midas_v21 import MIDAS_V21, MidasV21Config
from depth_estimation_tpu_torch.models.resnetv2 import STAGE_DEPTHS


def f2t_conv(k) -> np.ndarray:
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def f2t_linear(k) -> np.ndarray:
    return np.transpose(np.asarray(k), (1, 0))


def f2t_deconv(k) -> np.ndarray:
    return np.transpose(np.asarray(k), (2, 3, 0, 1))[:, :, ::-1, ::-1]


def _conv(sd: Dict, prefix: str, p: Mapping, bias: bool = True) -> None:
    sd[f"{prefix}.weight"] = f2t_conv(p["kernel"])
    if bias:
        sd[f"{prefix}.bias"] = p["bias"]


def _dense(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = f2t_linear(p["kernel"])
    sd[f"{prefix}.bias"] = p["bias"]


def _ln(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = p["scale"]
    sd[f"{prefix}.bias"] = p["bias"]


def _bn(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = p["scale"]
    sd[f"{prefix}.bias"] = p["bias"]
    sd[f"{prefix}.running_mean"] = p["mean"]
    sd[f"{prefix}.running_var"] = p["var"]


def _gn(sd: Dict, prefix: str, p: Mapping) -> None:
    _ln(sd, prefix, p["gn"])


def _decoder(sd: Dict, p: Mapping, out_conv: bool) -> None:
    """``scratch.*``: the ``layerN_rn`` projections, the fusion blocks (with
    their ``out_conv`` where the family has one) and the head."""
    for i in (1, 2, 3, 4):
        _conv(sd, f"scratch.layer{i}_rn", p[f"layer{i}_rn"], bias=False)
        rn = p[f"refinenet{i}"]
        for unit in ("resConfUnit1", "resConfUnit2") if i != 4 else ("resConfUnit2",):
            _conv(sd, f"scratch.refinenet{i}.{unit}.conv1", rn[unit]["conv1"])
            _conv(sd, f"scratch.refinenet{i}.{unit}.conv2", rn[unit]["conv2"])
        if out_conv:
            _conv(sd, f"scratch.refinenet{i}.out_conv", rn["out_conv"])
    for i in (0, 2, 4):
        _conv(sd, f"scratch.output_conv.{i}", p[f"output_conv_{i}"])


def _to_tensors(sd: Mapping) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in sd.items()}


def params_from_jax(params: Mapping, cfg: DPTConfig = DPT_LARGE) -> Dict[str, torch.Tensor]:
    """Flax params of the JAX ``models.DPT`` (numpy leaves, with or without
    the outer ``"params"`` key) → the port's DPT ``state_dict``. For the
    hybrid the JAX tree holds the ResNetV2 stem as ``resnet_stem`` and the 1×1
    projection as a top-level ``patch_embed``; only pyramid positions 2 and 3
    have readout and reassemble weights."""
    p = params.get("params", params)
    vit = p["vit"]
    sd: Dict = {
        "pretrained.model.cls_token": vit["cls_token"],
        "pretrained.model.pos_embed": vit["pos_embed"],
    }
    if cfg.hybrid:
        _resnet_stem(sd, "pretrained.model.patch_embed.backbone", p["resnet_stem"])
        _conv(sd, "pretrained.model.patch_embed.proj", p["patch_embed"])
    else:
        _conv(sd, "pretrained.model.patch_embed.proj", vit["patch_embed"])
    for i in range(cfg.depth):
        b, pre = vit[f"blocks_{i}"], f"pretrained.model.blocks.{i}"
        _ln(sd, f"{pre}.norm1", b["norm1"])
        _dense(sd, f"{pre}.attn.qkv", b["attn"]["qkv"])
        _dense(sd, f"{pre}.attn.proj", b["attn"]["proj"])
        _ln(sd, f"{pre}.norm2", b["norm2"])
        _dense(sd, f"{pre}.mlp.fc1", b["mlp"]["fc1"])
        _dense(sd, f"{pre}.mlp.fc2", b["mlp"]["fc2"])

    for pos in range(2 if cfg.hybrid else 0, 4):
        app = f"pretrained.act_postprocess{pos + 1}"
        _dense(sd, f"{app}.0.project.0", p[f"readout_{pos}"]["project"])
        _conv(sd, f"{app}.3", p[f"project_{pos}"])
        if pos in (0, 1):
            sd[f"{app}.4.weight"] = f2t_deconv(p[f"resample_{pos}"]["kernel"])
            sd[f"{app}.4.bias"] = p[f"resample_{pos}"]["bias"]
        elif pos == 3:
            _conv(sd, f"{app}.4", p[f"resample_{pos}"])
    _decoder(sd, p, out_conv=True)
    return _to_tensors(sd)


def _resnet_stem(sd: Dict, prefix: str, stem: Mapping) -> None:
    """The JAX ``ResNetV2Stem`` tree → timm's ResNetV2 keys under ``prefix``."""
    _conv(sd, f"{prefix}.stem.conv", stem["stem_conv"], bias=False)
    _gn(sd, f"{prefix}.stem.norm", stem["stem_norm"])
    for si, depth in enumerate(STAGE_DEPTHS):
        for bi in range(depth):
            blk, pre = stem[f"stage{si}_block{bi}"], f"{prefix}.stages.{si}.blocks.{bi}"
            for i in (1, 2, 3):
                _conv(sd, f"{pre}.conv{i}", blk[f"conv{i}"], bias=False)
                _gn(sd, f"{pre}.norm{i}", blk[f"norm{i}"])
            if bi == 0:
                _conv(sd, f"{pre}.downsample.conv", blk["downsample_conv"], bias=False)
                _gn(sd, f"{pre}.downsample.norm", blk["downsample_norm"])


def lite3_hub_prefix(stage: int, block: int) -> str:
    """Hub key prefix of EfficientNet-Lite3 block ``block`` of geffnet stage
    ``stage``: ``pretrained.layer{L}.{slot}.{block}``, where layer 1's stages
    follow the stem's three modules (``models/efficientnet_lite.py``)."""
    for li, stages in enumerate(LAYER_STAGES, start=1):
        if stage in stages:
            slot = stages.index(stage) + (3 if li == 1 else 0)
            return f"pretrained.layer{li}.{slot}.{block}"
    raise ValueError(f"no EfficientNet-Lite3 stage {stage}")


def params_from_jax_midas_small(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params of the JAX ``models.MidasSmall`` (numpy leaves, with or
    without the outer ``"params"`` key) → the port's MidasSmall ``state_dict``."""
    p = params.get("params", params)
    enc = p["pretrained"]
    sd: Dict = {}
    _conv(sd, "pretrained.layer1.0", enc["conv_stem"], bias=False)
    _bn(sd, "pretrained.layer1.1", enc["bn1"])
    for si, (btype, reps, *_) in enumerate(LITE3_STAGES):
        units = (("conv_dw", "bn1"), ("conv_pw", "bn2")) if btype == "ds" else (
            ("conv_pw", "bn1"), ("conv_dw", "bn2"), ("conv_pwl", "bn3"))
        for bi in range(reps):
            blk, pre = enc[f"blocks_{si}_{bi}"], lite3_hub_prefix(si, bi)
            for conv, bn in units:
                _conv(sd, f"{pre}.{conv}", blk[conv], bias=False)
                _bn(sd, f"{pre}.{bn}", blk[bn])
    _decoder(sd, p, out_conv=True)
    return _to_tensors(sd)


def resnext_hub_prefix(layer: int, block: int) -> str:
    """Hub key prefix of ResNeXt bottleneck ``block`` of ``layer``: layer 1's
    blocks follow the stem inside ``pretrained.layer1`` at slot 4."""
    return f"pretrained.layer1.4.{block}" if layer == 1 else f"pretrained.layer{layer}.{block}"


def params_from_jax_midas_v21(params: Mapping, cfg: MidasV21Config = MIDAS_V21) -> Dict[str, torch.Tensor]:
    """Flax params of the JAX ``models.MidasV21`` (numpy leaves, with or
    without the outer ``"params"`` key) → the port's MidasV21 ``state_dict``."""
    p = params.get("params", params)
    enc = p["pretrained"]
    sd: Dict = {}
    _conv(sd, "pretrained.layer1.0", enc["conv1"], bias=False)
    _bn(sd, "pretrained.layer1.1", enc["bn1"])
    for li, depth in enumerate(cfg.depths, start=1):
        for bi in range(depth):
            blk, pre = enc[f"layer{li}_block{bi}"], resnext_hub_prefix(li, bi)
            for i in (1, 2, 3):
                _conv(sd, f"{pre}.conv{i}", blk[f"conv{i}"], bias=False)
                _bn(sd, f"{pre}.bn{i}", blk[f"bn{i}"])
            if bi == 0:
                _conv(sd, f"{pre}.downsample.0", blk["downsample_conv"], bias=False)
                _bn(sd, f"{pre}.downsample.1", blk["downsample_bn"])
    _decoder(sd, p, out_conv=False)
    return _to_tensors(sd)


def _flax_tree(sd: Dict, prefix: str, tree: Mapping) -> None:
    """A detector's Flax tree, module names kept: ``kernel`` → ``weight``
    (4-d by the conv rule, 2-d by the dense one), ``bias`` and ``alpha`` as
    they are."""
    for name, v in tree.items():
        key = f"{prefix}.{name}" if prefix else name
        if isinstance(v, Mapping):
            _flax_tree(sd, key, v)
        elif name == "kernel":
            k = np.asarray(v)
            sd[f"{prefix}.weight"] = f2t_conv(k) if k.ndim == 4 else f2t_linear(k)
        elif name in ("bias", "alpha"):
            sd[key] = v
        else:
            raise KeyError(f"unexpected detector parameter {key!r}")


def _detector(params: Mapping) -> Dict[str, torch.Tensor]:
    sd: Dict = {}
    _flax_tree(sd, "", params.get("params", params))
    return _to_tensors(sd)


def params_from_jax_blazeface(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params of the JAX ``models.blazeface.BlazeFace`` → the port's
    ``BlazeFace`` state dict."""
    return _detector(params)


def params_from_jax_facemesh(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params of the JAX ``models.facemesh.FaceMeshWithIris`` → the
    port's ``FaceMeshWithIris`` state dict."""
    return _detector(params)


def params_from_jax_blazepose(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params of the JAX ``models.blazepose.BlazePose`` → the port's
    ``BlazePose`` state dict (its unused heatmap branch included)."""
    return _detector(params)
