"""The reference's frame program in plain PyTorch: ``dpt_transform`` (BGR to
RGB, /255, bicubic resize to the network size, normalize), the network, the
bicubic upsample back to the frame's size (depth_midas.py's
``F.interpolate(..., mode="bicubic", align_corners=False)``), run in blocks
of frames with TF32 off unless ``tf32`` asks for it (the control)."""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from torch import nn

from portbench.reference import family


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on or off for matmuls and cuDNN convolutions, restored after."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def build_model(cfg: Dict, state: Dict[str, torch.Tensor], device) -> nn.Module:
    """The reference network of configuration ``cfg`` holding ``state``."""
    with torch.device("meta"):
        model = family(cfg).build(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    return model.eval()


def preprocess(frames_u8: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """(B, H, W, 3) u8 BGR → (B, 3, h, w) float32 normalized network input."""
    p = cfg["preprocess"]
    x = frames_u8.flip(-1).permute(0, 3, 1, 2).to(torch.float32) / 255.0
    x = F.interpolate(x, size=tuple(cfg["net_hw"]), mode="bicubic", align_corners=False)
    mean = torch.tensor(p["mean"], dtype=torch.float32, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(p["std"], dtype=torch.float32, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def depth_maps(model: nn.Module, frames_u8: torch.Tensor, cfg: Dict, tf32: bool = False, block: int = 8) -> torch.Tensor:
    """(B, H, W, 3) u8 BGR frames → (B, H, W) float32 depth maps, ``block``
    frames at a time."""
    out = []
    with torch.inference_mode(), matmul_precision(tf32):
        for i in range(0, frames_u8.shape[0], block):
            f = frames_u8[i:i + block]
            pred = model(preprocess(f, cfg))
            up = F.interpolate(pred[:, None], size=tuple(f.shape[1:3]), mode="bicubic", align_corners=False)
            out.append(up[:, 0])
    return torch.cat(out)


def wraparound_u8(depth: torch.Tensor) -> torch.Tensor:
    """numpy's ``astype(np.uint8)`` of a float map (depth_midas.py:83):
    truncate toward zero, then modulo 256."""
    return torch.remainder(torch.trunc(depth.double()), 256).to(torch.uint8)


def net_tokens(cfg: Dict) -> int:
    h, w = cfg["net_hw"]
    return (h // cfg["patch_size"]) * (w // cfg["patch_size"]) + 1

