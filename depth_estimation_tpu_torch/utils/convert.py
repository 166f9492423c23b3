"""JAX parameter tree → the port's state dict.

The port's depth modules keep the torch-hub key names, so these are the
inverses of the JAX package's ``utils/convert.py::convert_dpt``,
``::convert_midas_small`` and ``::convert_midas_v21`` (hub state dict → Flax
params). The detector nets (BlazeFace, FaceMesh+iris, BlazePoseDetector,
BlazePose) keep the Flax module names instead, so their converters walk the
tree key for key. They let both packages run on the same weights. The last
section converts MediaPipe ``.tflite`` files straight to the port's detector
state dicts (JAX ``convert_*_tflite``).

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

import inspect
import warnings
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from depth_estimation_tpu_torch.models.dpt import DPT_LARGE, DPTConfig
from depth_estimation_tpu_torch.models.efficientnet_lite import LAYER_STAGES, LITE3_STAGES
from depth_estimation_tpu_torch.models.layers import PReLU
from depth_estimation_tpu_torch.models.midas_v21 import MIDAS_V21, MidasV21Config
from depth_estimation_tpu_torch.models.resnetv2 import STAGE_DEPTHS
from depth_estimation_tpu_torch.utils.tflite import read_tflite_ops


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


def params_from_jax_blazepose_detector(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params of the JAX ``models.blazepose.BlazePoseDetector`` → the
    port's ``BlazePoseDetector`` state dict."""
    return _detector(params)


# -- TFLite → the port's state dicts (the MediaPipe detector stack) -----------
#
# The detector weights ship as .tflite flatbuffers (mediapipe 0.8.11). Their
# tensor names are converter artifacts, so conversion keys on structure: the
# operator stream in execution order (utils/tflite.py::read_tflite_ops) is
# matched against the net's weight layers in execution order
# (``tflite_layer_order``), and every assignment is shape-checked after the
# layout change, so a file either proves the architecture layer for layer or
# fails naming the first layer that differs. The layouts go from TFLite
# straight to torch:
#
#   CONV_2D kernel             (O, H, W, I) → (O, I, H, W)   permute (0, 3, 1, 2)
#   DEPTHWISE_CONV_2D kernel   (1, H, W, C) → (C, 1, H, W)   permute (3, 0, 1, 2)
#   FULLY_CONNECTED kernel     (out, in)    → nn.Linear's (out, in)
#   PRELU alpha                (..., C)     → (C,)

_TFLITE_WEIGHT_OPS = {"CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED", "PRELU"}


def tflite_weight_layers(ops, consts) -> List[Tuple[str, np.ndarray, Optional[np.ndarray]]]:
    """[(kind, kernel or alpha, bias or None), ...] in execution order."""
    out = []
    for op in ops:
        if op.op not in _TFLITE_WEIGHT_OPS:
            continue
        kernel = consts.get(op.inputs[1]) if len(op.inputs) > 1 else None
        if kernel is None:
            continue  # dynamic weights (never the case in these models)
        bias = None
        if op.op != "PRELU" and len(op.inputs) > 2 and op.inputs[2] >= 0:
            bias = consts.get(op.inputs[2])
        out.append((op.op, np.asarray(kernel), None if bias is None else np.asarray(bias)))
    return out


def tflite_layer_order(net: nn.Module, input_shape) -> List[str]:
    """The module names of ``net``'s weight layers (leaf ``nn.Conv2d``,
    ``nn.Linear``, ``PReLU``) in the order one forward calls them: JAX
    ``flax_layer_order``'s order, in the port's names. The forward runs on
    the meta device (no arithmetic) on an ``input_shape`` (NCHW) input, with
    ``return_full=True`` where the net takes it, so that ``BlazePose`` runs
    its heatmap branch, in JAX's order."""
    kinds = (nn.Conv2d, nn.Linear, PReLU)
    order: List[str] = []
    hooks = [m.register_forward_pre_hook(lambda _m, _a, name=name: order.append(name) if name not in order else None)
             for name, m in net.named_modules() if isinstance(m, kinds)]
    try:
        meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in net.state_dict().items()}
        kwargs = {"return_full": True} if "return_full" in inspect.signature(net.forward).parameters else {}
        with torch.no_grad():
            torch.func.functional_call(net, meta, (torch.empty(tuple(input_shape), device="meta"),), kwargs)
    finally:
        for h in hooks:
            h.remove()
    return order


def _convert_layer(kind: str, kernel: np.ndarray, slot_shape) -> np.ndarray:
    if kind == "CONV_2D":
        return kernel.transpose(0, 3, 1, 2)
    if kind == "DEPTHWISE_CONV_2D":
        k = kernel.transpose(3, 0, 1, 2)
        if k.shape != tuple(slot_shape) and kernel.shape[0] != 1:
            # the channel-multiplier layout variant, read as JAX reads it: (H, W, 1, C·M), then the conv rule
            k = f2t_conv(kernel.reshape(kernel.shape[1], kernel.shape[2], 1, -1))
        return k
    if kind == "FULLY_CONNECTED":
        return kernel
    return kernel.reshape(-1)  # PRELU


def _slot_expected_kind(leaf: Mapping) -> str:
    if "alpha" in leaf:
        return "PRELU"
    return "FULLY_CONNECTED" if len(leaf["weight"]) == 2 else "CONV_2D"


def _op_matches_slot(kind: str, converted: np.ndarray, bias, leaf: Mapping) -> bool:
    """The whole structural agreement: kernel shape, PReLU or not, and the
    bias (present or not, and its shape). The bias is part of the match, so a
    shape-coincident conv of a branch the net leaves out cannot bind to a
    slot whose bias it does not share."""
    want = leaf["alpha"] if "alpha" in leaf else leaf["weight"]
    if converted.shape != tuple(want):
        return False
    if ("alpha" in leaf) != (kind == "PRELU"):
        return False
    if "alpha" not in leaf:
        if ("bias" in leaf) != (bias is not None):
            return False
        if bias is not None and bias.shape != tuple(leaf["bias"]):
            return False
    return True


def assign_tflite_weights(ops, consts, net: nn.Module, input_shape, model_name: str = "?",
                          allow_skips: bool = False) -> Dict[str, torch.Tensor]:
    """Map a TFLite op stream onto ``net``'s state dict structurally (JAX
    ``assign_tflite_weights``).

    For each weight layer, in execution order (``tflite_layer_order``), the
    next compatible weight op is taken. By default every weight op must be
    taken in order: a foreign op raises instead of being stepped over, which
    is what makes a conversion prove the architecture layer for layer. For
    graphs that carry whole branches the net leaves out (the pose landmark
    file's segmentation decoder) pass ``allow_skips=True``: each op stepped
    over is then named in a warning. A layer that nothing fills raises a
    ``ValueError`` naming it and the position in the stream."""
    layers = tflite_weight_layers(ops, consts)
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    pos = 0
    skipped: List[Tuple[int, str]] = []
    for name in tflite_layer_order(net, input_shape):
        leaf = {p: shapes[f"{name}.{p}"] for p in ("weight", "bias", "alpha") if f"{name}.{p}" in shapes}
        want = leaf["alpha"] if "alpha" in leaf else leaf["weight"]
        found = None
        for j in range(pos, len(layers) if allow_skips else min(pos + 1, len(layers))):
            kind, kernel, bias = layers[j]
            k = _convert_layer(kind, kernel, want)
            if _op_matches_slot(kind, k, bias, leaf):
                found = (j, k, bias)
                break
        if found is None:
            got = (f"next op is {layers[pos][0]} kernel {layers[pos][1].shape}" if pos < len(layers)
                   else "op stream exhausted")
            raise ValueError(
                f"{model_name}: no TFLite weight matches layer {name} (expected {_slot_expected_kind(leaf)} "
                f"kernel shape {want}; {got}; position {pos}/{len(layers)}"
                + ("" if allow_skips else "; strict in-order matching — "
                   "pass allow_skips=True only for graphs with known extra branches") + ")")
        j, k, bias = found
        skipped.extend((i, layers[i][0]) for i in range(pos, j))
        pos = j + 1
        out[f"{name}.alpha" if "alpha" in leaf else f"{name}.weight"] = k
        if "bias" in leaf:
            out[f"{name}.bias"] = bias
    if skipped:
        warnings.warn(f"{model_name}: skipped {len(skipped)} weight op(s) from branches the port's net does not "
                      f"implement: {skipped[:8]}" + ("..." if len(skipped) > 8 else ""), stacklevel=2)
    return {k: torch.from_numpy(np.array(out[k], dtype=np.float32)) for k in shapes}  # copies: the file's are read-only


def _meta(make) -> nn.Module:
    with torch.device("meta"):
        return make()


def convert_blazeface_tflite(path) -> Dict[str, torch.Tensor]:
    """face_detection_short_range.tflite → the port's ``BlazeFace`` state dict."""
    from depth_estimation_tpu_torch.models.blazeface import BlazeFace

    ops, consts, _ = read_tflite_ops(path)
    return assign_tflite_weights(ops, consts, _meta(BlazeFace), (1, 3, 128, 128), "BlazeFace")


def convert_facemesh_tflite(face_path, iris_path) -> Dict[str, torch.Tensor]:
    """face_landmark.tflite + iris_landmark.tflite → the port's
    ``FaceMeshWithIris`` state dict (``mesh.*`` and ``iris.*``)."""
    from depth_estimation_tpu_torch.models.facemesh import FaceMesh, IrisLandmark

    sd = {}
    for prefix, path, make, shape, name in (("mesh", face_path, FaceMesh, (1, 3, 192, 192), "FaceMesh"),
                                            ("iris", iris_path, IrisLandmark, (1, 3, 64, 64), "IrisLandmark")):
        ops, consts, _ = read_tflite_ops(path)
        sd.update({f"{prefix}.{k}": v for k, v in assign_tflite_weights(ops, consts, _meta(make), shape,
                                                                         name).items()})
    return sd


def convert_blazepose_detector_tflite(path) -> Dict[str, torch.Tensor]:
    """pose_detection.tflite → the port's ``BlazePoseDetector`` state dict."""
    from depth_estimation_tpu_torch.models.blazepose import BlazePoseDetector

    ops, consts, _ = read_tflite_ops(path)
    return assign_tflite_weights(ops, consts, _meta(BlazePoseDetector), (1, 3, 224, 224), "BlazePoseDetector")


def convert_blazepose_tflite(path) -> Dict[str, torch.Tensor]:
    """pose_landmark_{lite,full,heavy}.tflite → the port's ``BlazePose`` state dict."""
    from depth_estimation_tpu_torch.models.blazepose import BlazePose

    ops, consts, _ = read_tflite_ops(path)
    # the real pose landmark graph carries segmentation and heatmap branches that the net leaves out:
    # stepping over them is expected here (and warned)
    return assign_tflite_weights(ops, consts, _meta(BlazePose), (1, 3, 256, 256), "BlazePose", allow_skips=True)
