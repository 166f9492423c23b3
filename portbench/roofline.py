"""The yardstick for device numbers: the chip's peaks, and the operations
and bytes of each kernel and of the whole network, from shapes alone.

Counting rules (frozen here, whatever implements a kernel):

* bytes: each input byte read once, each output byte written once;
* operations: what the algorithm needs (a multiply-add is 2), at the
  fastest rate any route with these input types has on the chip: the dense
  TF32 tensor-core rate for float32 inputs, bf16's for bfloat16;
* a bound is the larger of operations over that rate and bytes over the
  memory's bandwidth; a roofline share is the bound over the measured time;
* a network's operations are torch's count over the reference, each net
  the program runs at one frame's input to it (the reference module's
  ``count_inputs``), less three quarters of each 1x1 convolution that runs
  after an x2 upsampling it commutes with (its ``upsampled_1x1``): the
  algorithm needs it only at the pixels before the upsampling.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

# Dense rates of one H100 SXM (NVIDIA's data sheet) at its 700 W limit.
H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "matmul_flops_per_s": {"float32": 495e12, "bfloat16": 989e12},
    "fma_flops_per_s": 67e12,
}


def peaks(device_name: str) -> Optional[Dict]:
    """The peak table of the card named ``device_name``; None for a card
    this table does not know (then no share of a peak is reported)."""
    if "H100" in device_name and "PCIe" not in device_name:
        return H100_SXM
    return None


def bound_s(flops: float, nbytes: float, flops_per_s: float, bytes_per_s: float) -> float:
    return max(flops / flops_per_s, nbytes / bytes_per_s)


def attention_cost(batch: int, heads: int, nq: int, nk: int, head_dim: int, elem_bytes: int) -> Tuple[float, float]:
    """K1, softmax(q kᵀ / √d) v: (operations, bytes). q and o are (B, H, Nq,
    D), k and v (B, H, Nk, D)."""
    flops = 4.0 * batch * heads * nq * nk * head_dim
    nbytes = float(batch * heads * (2 * nq + 2 * nk) * head_dim * elem_bytes)
    return flops, nbytes


def preprocess_cost(batch: int, in_hw: Tuple[int, int], out_hw: Tuple[int, int]) -> Tuple[float, float]:
    """K2, u8 BGR (B, H, W, 3) → f32 (B, 3, h, w): a separable 4-tap resize
    (rows, then columns) and the normalization."""
    (H, W), (h, w) = in_hw, out_hw
    flops = batch * 3 * (8.0 * h * W + 8.0 * h * w + 2.0 * h * w)
    nbytes = batch * (H * W * 3 + 3 * h * w * 4.0)
    return flops, nbytes


def upsample_cost(batch: int, in_hw: Tuple[int, int], out_hw: Tuple[int, int], out_bytes: int) -> Tuple[float, float]:
    """K3, f32 (B, h, w) → (B, H, W) at ``out_bytes`` a pixel (4: f32, 1: the u8 cast)."""
    (h, w), (H, W) = in_hw, out_hw
    flops = batch * (8.0 * H * w + 8.0 * H * W)
    nbytes = batch * (h * w * 4.0 + H * W * out_bytes)
    return flops, nbytes


def network_flops(cfg: Dict) -> float:
    """Matmul and convolution operations of one frame through the nets of
    ``cfg``, counted by torch's FlopCounterMode over the reference model on
    the meta device (shapes only, no arithmetic), with each upsampled 1x1
    convolution counted before its upsampling. The inputs are the family's
    ``count_inputs(cfg)``, one frame's input to each net it runs, or else
    the whole model at (1, 3, *net_hw)."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference import family

    ref = family(cfg)
    late: List[float] = []  # operations of each upsampled 1x1 conv, as run
    with torch.device("meta"):
        model = ref.build(cfg)
        hooks = [conv.register_forward_hook(lambda mod, args, out: late.append(2.0 * out.numel() * mod.in_channels))
                 for conv in getattr(ref, "upsampled_1x1", lambda m: [])(model)]
        inputs = ref.count_inputs(cfg) if hasattr(ref, "count_inputs") else {"": (1, 3, *cfg["net_hw"])}
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            for net, shape in inputs.items():
                model.get_submodule(net)(torch.empty(*shape))
    for h in hooks:
        h.remove()
    return float(counter.get_total_flops()) - 0.75 * sum(late)


def vit_block_flops(tokens: int, dim: int, hidden: int) -> float:
    """One pre-LN transformer block at ``tokens`` tokens: qkv, q kᵀ, p v,
    the projection and the two MLP matmuls."""
    return 2.0 * tokens * dim * (3 * dim + dim + 2 * hidden) + 4.0 * tokens * tokens * dim
