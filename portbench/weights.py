"""Weights from ``--seed``, made on the device in the type they are served in.

One ``torch.randn`` call fills every kernel, bias and embedding at once from
a ``torch.Generator`` on the device; each tensor is then a scaled view of
that buffer. The rule is the program's own for random weights: kernels
N(0, 1/fan_in) (a transposed conv's fan-in is its input channels), biases,
the cls token and the position embedding 0.02 N(0, 1), LayerNorm and
GroupNorm at identity. The head's last conv (the configuration's
``weights.head``) is scaled by ``head_gain`` and shifted by ``head_bias``,
so that its
maps span the range a trained model's relative inverse depth has, and the
u8 cast of the stream cells has something to cast. The same seed gives the
same state dict on every call, so the reference is handed the same weights
again after the program's are freed.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from portbench.reference import family

_IDENTITY_NORMS = (nn.LayerNorm, nn.GroupNorm)


def weight_seed(seed: int) -> int:
    return int(seed) % (2 ** 63)


def make_weights(cfg: Dict, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The state dict of configuration ``cfg`` (hub key names) from ``seed``."""
    with torch.device("meta"):
        model = family(cfg).build(cfg)
    normal, fixed = [], {}
    for prefix, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            key = f"{prefix}.{name}" if prefix else name
            if isinstance(mod, _IDENTITY_NORMS):
                fixed[key] = (p.shape, 1.0 if name == "weight" else 0.0)
            elif name == "weight" and p.dim() >= 2:
                fan_in = p.shape[0] if isinstance(mod, nn.ConvTranspose2d) else p[0].numel()
                normal.append((key, p.shape, fan_in ** -0.5))
            else:
                normal.append((key, p.shape, 0.02))
    g = torch.Generator(device=device).manual_seed(weight_seed(seed))
    flat = torch.randn(sum(s.numel() for _, s, _ in normal), generator=g, device=device, dtype=dtype)
    state, at = {}, 0
    for key, shape, std in normal:
        n = shape.numel()
        state[key] = flat[at:at + n].view(shape).mul_(std)
        at += n
    for key, (shape, value) in fixed.items():
        state[key] = torch.full(shape, value, device=device, dtype=dtype)
    w = cfg["weights"]
    state[f"{w['head']}.weight"].mul_(w["head_gain"])
    state[f"{w['head']}.bias"].add_(w["head_bias"])
    return state
