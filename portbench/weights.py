"""Weights from ``--seed``, made on the device in the type they are served in.

One ``torch.randn`` call fills every kernel, bias and embedding at once from
a ``torch.Generator`` on the device; each tensor is then a scaled view of
that buffer. The rule is the program's own for random weights: kernels
N(0, 1/fan_in) (a transposed conv's fan-in is its input channels), biases,
the cls token and the position embedding 0.02 N(0, 1), LayerNorm, GroupNorm
and BatchNorm at identity. Persistent buffers are filled as a fresh
BatchNorm's (``running_mean`` 0, ``running_var`` 1, ``num_batches_tracked``
0; a frozen norm's ``weight`` 1 and ``bias`` 0), beside the draw, which
they leave as it is. Each head of the configuration's ``weights.heads``
(``{"param": prefix, "gain": g, "bias": b}``, either number optional; the
keys ``head``, ``head_gain`` and ``head_bias`` are one such head) has its
``weight`` scaled by ``gain`` and its ``bias`` shifted by ``bias``: the
depth head's last conv so that its maps span the range a trained model's
relative inverse depth has, and the u8 cast of the stream cells has
something to cast; a detector's score head so that some frames hold a
detection and some do not. The same seed gives the same state dict on every
call, so the reference is handed the same weights again after the
program's are freed.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from portbench.reference import family

_IDENTITY_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.modules.batchnorm._BatchNorm)
_BUFFERS = {"running_mean": 0, "running_var": 1, "num_batches_tracked": 0, "weight": 1, "bias": 0}


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
                fixed[key] = (p.shape, 1.0 if name == "weight" else 0.0, dtype)
            elif name == "weight" and p.dim() >= 2:
                fan_in = p.shape[0] if isinstance(mod, nn.ConvTranspose2d) else p[0].numel()
                normal.append((key, p.shape, fan_in ** -0.5))
            else:
                normal.append((key, p.shape, 0.02))
        for name, b in mod.named_buffers(recurse=False):
            if name in mod._non_persistent_buffers_set:
                continue
            key = f"{prefix}.{name}" if prefix else name
            if name not in _BUFFERS:
                raise ValueError(f"{key}: no rule fills a persistent buffer of this name ({sorted(_BUFFERS)})")
            fixed[key] = (b.shape, _BUFFERS[name], dtype if b.dtype.is_floating_point else b.dtype)
    g = torch.Generator(device=device).manual_seed(weight_seed(seed))
    flat = torch.randn(sum(s.numel() for _, s, _ in normal), generator=g, device=device, dtype=dtype)
    state, at = {}, 0
    for key, shape, std in normal:
        n = shape.numel()
        state[key] = flat[at:at + n].view(shape).mul_(std)
        at += n
    for key, (shape, value, kind) in fixed.items():
        state[key] = torch.full(shape, value, device=device, dtype=kind)
    for head in heads(cfg["weights"]):
        if "gain" in head:
            state[f"{head['param']}.weight"].mul_(head["gain"])
        if "bias" in head:
            state[f"{head['param']}.bias"].add_(head["bias"])
    return state


def heads(w: Dict) -> List[Dict]:
    """A configuration's adjusted heads: ``weights.heads``, or its
    ``head`` / ``head_gain`` / ``head_bias`` as a list of one."""
    if "heads" in w:
        return list(w["heads"])
    return [{"param": w["head"], "gain": w["head_gain"], "bias": w["head_bias"]}]
