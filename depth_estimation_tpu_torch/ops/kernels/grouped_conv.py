"""K4: grouped 3×3 convolution, stride 1, zero padding 1, NCHW.

Replaces ``depth_estimation_tpu/ops/pallas/grouped_conv.py::_kernel`` (:105,
launched by ``grouped_conv3x3_pallas``): the stride-1 conv2 of every
ResNeXt-101 32x8d bottleneck of MiDaS v2.1. The kernel is
``csrc/grouped_conv.cu``; its source note gives the bound and the design.

``grouped_conv3x3_plain`` is the plain PyTorch version: im2col
(``F.unfold``) and one matmul with the group as a batch dimension, the form
of the JAX package's ``_batched_matmul_grouped_conv``, in f32 with the
output cast to the input type. ``grouped_conv3x3`` takes it for CPU tensors
and launches the kernel for CUDA tensors.

Layouts: x (B, C, H, W); weight (C, C/G, 3, 3), as ``nn.Conv2d(groups=G)``
stores it: output channel o reads the input channels of its group
``o // (C/G)``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from depth_estimation_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(x: torch.Tensor, weight: torch.Tensor, groups: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got shape {tuple(x.shape)}")
    c = x.shape[1]
    if groups < 1 or c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    if tuple(weight.shape) != (c, c // groups, 3, 3):
        raise ValueError(f"weight shape {tuple(weight.shape)} != ({c}, {c // groups}, 3, 3)")


def grouped_conv3x3_plain(x: torch.Tensor, weight: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, C, H, W) → (B, C, H, W) in x's dtype, computed in f32."""
    _check_shapes(x, weight, groups)
    b, c, h, w = x.shape
    cg = c // groups
    patches = F.unfold(x.float(), 3, padding=1)  # (B, C·9, H·W), rows ordered (c, kh, kw)
    patches = patches.reshape(b, groups, cg * 9, h * w)
    wk = weight.float().reshape(groups, cg, cg * 9)  # (G, out, (ci, kh, kw))
    return torch.matmul(wk, patches).reshape(b, c, h, w).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("grouped_conv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grouped_conv3x3.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.grouped_conv3x3.restype = ctypes.c_int
    lib.grouped_conv3x3_tiling.argtypes = [i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.grouped_conv3x3_tiling.restype = ctypes.c_int
    return lib


def grouped_conv3x3(x: torch.Tensor, weight: torch.Tensor, groups: int) -> torch.Tensor:
    """``grouped_conv3x3_plain`` for a CPU tensor; one K4 launch for a CUDA
    tensor. The kernel takes contiguous f32 or bf16 x and weight of one
    dtype, on one device, and writes a new contiguous output."""
    if x.device.type == "cpu":
        return grouped_conv3x3_plain(x, weight, groups)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped conv kernel for device {x.device}")
    _check_shapes(x, weight, groups)
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(f"x and weight must both be float32 or bfloat16; got {x.dtype}, {weight.dtype}")
    if weight.device != x.device:
        raise ValueError(f"x on {x.device} but weight on {weight.device}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("the grouped conv kernel takes contiguous x and weight")
    b, c, h, w = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().grouped_conv3x3(
            x.data_ptr(), weight.data_ptr(), out.data_ptr(), b, c, h, w, groups,
            _DTYPES[x.dtype], build.sm_count(x.device.index), torch.cuda.current_stream().cuda_stream)
    build.check(err, "grouped conv kernel launch")
    build.count_launch(grouped_conv3x3)
    return out


grouped_conv3x3.launches = 0

_TILING_FIELDS = ("nco", "th", "tw", "wk", "mt", "rw", "plane", "pco", "smem_bytes")


def tiling(x_shape, groups: int, sms: int, dtype: torch.dtype) -> dict:
    """The tiling the kernel's ``dtype`` route picks for an input of
    ``x_shape`` on a card with ``sms`` SMs: output channels a block (nco),
    rows and columns a block (th, tw), warp slices over the input channels
    (wk), m16 pixel tiles a warp (mt), the staged input row and plane and
    weight row pitches in values of ``dtype`` (rw, plane, pco) and the shared
    memory a block. Builds the kernel's library, so it needs nvcc."""
    if dtype not in _DTYPES:
        raise TypeError(f"no grouped conv route for {dtype}")
    b, c, h, w = x_shape
    out = (ctypes.c_int * len(_TILING_FIELDS))()
    err = _lib().grouped_conv3x3_tiling(b, c, h, w, groups, _DTYPES[dtype], sms, out)
    build.check(err, "grouped conv tiling")
    return dict(zip(_TILING_FIELDS, out))
