"""The ViT's float32 linear layers on the tensor cores: y = x·Wᵀ (+ bias) (+ GELU).

Replaces no TPU kernel: the JAX package leaves these products to XLA
(``models/vit.py``'s ``nn.Dense``). On the H100 with TF32 off
(``device.full_f32``) cuBLAS runs float32 GEMMs on the FMA units, at most 67
TFLOP/s, and they took most of every DPT program's device time. The kernel
(``csrc/linear.cu``, ``linear_gemm_f32x3_kernel``) is a persistent,
warp-specialised ``wgmma`` GEMM fed by TMA, in 3xTF32: each operand is split
into a TF32 high part and a TF32 remainder and lo·hi + hi·lo + hi·hi is summed
in f32, so it holds the plain version as f32 arithmetic does (one TF32 pass
would not). Bound: three times the products' FLOPs at the 495 TFLOP/s TF32
rate. Bias and, for ``fc1`` and the readout projections, exact-erf GELU are
applied in its epilogue.

The weight's remainder ``w − trunc_tf32(w)`` is computed once a weight and
kept beside it with the two TMA descriptors of w and w_lo (``_weight_entry``;
1.2 GB for ViT-L's blocks). The entry is keyed by the weight's storage and its
view of it, not by the tensor object, so the fresh detached tensors of each
``state_dict()`` (``fn(est.params, frame)``) find it too. It is made again when
the weight is written in place (``_version``, which detached views share:
``load_state_dict``, an optimizer step) and dropped when the storage is freed
(``param.data = …`` leaves the old storage). A write through ``.data`` bumps no
version that the weight's tensors see, and is not seen here either. The state
dict is the hub's: nothing is added to the modules.

``linear`` calls the operator ``depth_tpu_torch::linear``
(``torch.ops.depth_tpu_torch.linear``): its CPU implementation is
``linear_plain`` (``F.linear``, then ``F.gelu``), its CUDA implementation
(``_cuda_linear``) launches the kernel and raises ``ValueError`` on operands
it cannot take (``_takes``: float32, a contiguous 16-byte aligned weight with
K a multiple of 32 and N of 8, a 16-byte aligned x; a non-contiguous x is
copied first), as K1's wrapper does. bfloat16 layers do not call it: the
models pick ``F.linear`` for them by dtype, since cuBLAS runs bf16 on the
tensor cores already. Its fake implementation gives the output's shape and
dtype for ``torch.export``. A CUDA call that wants no gradient and is not
being traced goes to ``_cuda_linear`` directly: the dispatcher's Python round
trip cost more host time than ``F.linear``'s whole call, and the live
programs make 100 of these calls a DPT_Large frame.

Gradient. The operator's registered backward, on both devices, is plain
products with TF32 off (``linear_backward_plain``): the pre-activation is
recomputed where GELU was applied, then dX = dZ·W, dW = dZᵀ·X and db = Σ dZ.
The forward kernel adds with no atomics, so a step stays deterministic.
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from depth_estimation_tpu_torch.device import full_f32
from depth_estimation_tpu_torch.ops.kernels import build

BLOCK_M = 128  # output rows a tile: two consumer warpgroups of 64
BLOCK_K = 32   # the K slice a pipeline stage holds (one 128-byte swizzle row of f32)
BLOCK_NS = (128, 64)
TILE_OVERHEAD = 32  # a tile's fixed cost (its epilogue, the pipeline's fill) in units of one output column
_TF32_MASK = -(1 << 13)  # clears the 13 mantissa bits the tensor cores ignore

# id(storage) → (weak reference to the storage, {(offset, shape, stride, dtype): entry})
_WEIGHTS: Dict[int, Tuple[weakref.ref, Dict[tuple, "_WeightEntry"]]] = {}


def linear_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 gelu: bool = False) -> torch.Tensor:
    """``F.linear`` and, with ``gelu``, exact-erf ``F.gelu``: what ``nn.Linear``
    (+ ``nn.GELU()``) computes."""
    y = F.linear(x, weight, bias)
    return F.gelu(y) if gelu else y


def linear_backward_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], gelu: bool,
                          dy: torch.Tensor, needs=(True, True, True)):
    """(dX, dW, db) of ``linear_plain`` for the output gradient ``dy``; db is
    None without a bias, and each entry whose ``needs`` is False is None."""
    dz = dy
    if gelu:  # PyTorch's exact GELU derivative at the recomputed pre-activation
        z = F.linear(x, weight, bias)
        cdf = 0.5 * (1.0 + torch.erf(z * math.sqrt(0.5)))
        dz = dy * (cdf + z * torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi))
    n, k = weight.shape
    dz2 = dz.reshape(-1, n)
    dx = torch.matmul(dz, weight) if needs[0] else None
    dw = torch.matmul(dz2.t(), x.reshape(-1, k)) if needs[1] else None
    db = dz2.sum(0) if bias is not None and needs[2] else None
    return dx, dw, db


@functools.lru_cache(maxsize=None)
def tiling(m: int, n: int, sms: int) -> int:
    """The output tile's width, BLOCK_NS[i], for an (m, n) product on ``sms``
    SMs: the fewest rounds of the persistent grid times a tile's cost (its
    width plus ``TILE_OVERHEAD``), the wider tile on a tie. At DPT_Large's one
    frame (m = 769) and n = 1024, 128-wide tiles would leave 76 of 132 SMs
    idle; 64-wide ones fill 112."""
    m_tiles = -(-m // BLOCK_M)

    def cost(bn):
        return -(-m_tiles * -(-n // bn) // sms) * (bn + TILE_OVERHEAD)

    return min(BLOCK_NS, key=cost)


def _takes(x: torch.Tensor, entry: "_WeightEntry", bias: Optional[torch.Tensor]) -> bool:
    """Whether the kernel takes these operands: a weight it takes (``entry``),
    x float32 on the weight's device, contiguous and 16-byte aligned (TMA),
    with K columns; no bias or a contiguous float32 one of N there."""
    if not (entry.takes and x.dtype is torch.float32 and x.get_device() == entry.dev and x.dim() >= 1
            and x.shape[-1] == entry.k and x.is_contiguous() and x.data_ptr() % 16 == 0):
        return False
    return bias is None or (bias.dtype is torch.float32 and bias.get_device() == entry.dev and bias.dim() == 1
                            and bias.shape[0] == entry.n and bias.is_contiguous())


def weight_lo(weight: torch.Tensor) -> torch.Tensor:
    """``weight − trunc_tf32(weight)``: the remainder that the kernel's w_lo
    products read, exact in float32."""
    with torch.no_grad():
        w = weight.detach()
        return w - (w.view(torch.int32) & _TF32_MASK).view(torch.float32)


class _WeightEntry:
    """What a launch needs of a weight, found once: whether the kernel takes
    it (float32, 2-D, contiguous, 16-byte aligned, K a multiple of
    ``BLOCK_K`` and N of 8, on a CUDA device), its shape, device and SM
    count, its remainder and, by tile width, the TMA descriptors of the
    weight and the remainder. Valid while the weight's version and storage
    are the ones seen."""

    __slots__ = ("version", "ptr", "takes", "n", "k", "dev", "sms", "lo", "maps")

    def __init__(self, weight: torch.Tensor):
        self.version = -1 if weight.is_inference() else weight._version
        self.ptr = weight.data_ptr()
        self.n, self.k = weight.shape if weight.dim() == 2 else (0, 0)
        self.dev = weight.get_device()
        self.takes = (weight.dtype is torch.float32 and self.dev >= 0 and weight.dim() == 2 and self.n > 0
                      and self.n % 8 == 0 and self.k > 0 and self.k % BLOCK_K == 0 and weight.is_contiguous()
                      and self.ptr % 16 == 0)
        self.sms = build.sm_count(self.dev) if self.takes else 0
        self.lo = weight_lo(weight) if self.takes else None
        self.maps = {}

    def maps_for(self, block_n: int):
        maps = self.maps.get(block_n)
        if maps is None:
            lib = _lib()
            maps = ctypes.create_string_buffer(2 * lib.linear_map_bytes())
            build.check(lib.linear_weight_maps(self.ptr, self.lo.data_ptr(), self.n, self.k, block_n, maps),
                        "linear kernel tensor maps")
            self.maps[block_n] = maps
        return maps


def _weight_entry(weight: torch.Tensor) -> _WeightEntry:
    """The entry of the weight's storage and view, made at its first use and
    made again after the storage is written in place (``_version``) or moves;
    dropped when the storage is freed. An inference tensor has no version
    counter: its entry is made anew each call, so the programs' weights are
    made outside inference mode."""
    if weight.is_inference():
        return _WeightEntry(weight)
    storage = weight.untyped_storage()  # the same Python object while the storage lives
    key = id(storage)
    hit = _WEIGHTS.get(key)
    if hit is None or hit[0]() is not storage:
        hit = _WEIGHTS[key] = (weakref.ref(storage, functools.partial(_forget, key)), {})
    view = (weight.storage_offset(), weight.shape, weight.stride(), weight.dtype)
    entry = hit[1].get(view)
    if entry is None or entry.version != weight._version or entry.ptr != weight.data_ptr():
        entry = hit[1][view] = _WeightEntry(weight)
    return entry


def _forget(key: int, ref: weakref.ref) -> None:
    """Drop a freed storage's entries (unless its ``id`` already names a newer storage's)."""
    hit = _WEIGHTS.get(key)
    if hit is not None and hit[0] is ref:
        del _WEIGHTS[key]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("linear")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.linear_forward.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.linear_forward.restype = i
    lib.linear_weight_maps.argtypes = [p, p, i, i, i, p]
    lib.linear_weight_maps.restype = i
    lib.linear_map_bytes.argtypes = []
    lib.linear_map_bytes.restype = i
    return lib


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           gelu: bool = False) -> torch.Tensor:
    """``linear_plain(x, weight, bias, gelu)``: x (..., K), weight (N, K), bias
    (N) or None → (..., N). CPU tensors take the plain version, CUDA tensors
    the kernel (float32 only: ``_cuda_linear``). The output carries the
    gradient of ``linear_backward_plain``."""
    if x.is_cuda:
        if type(x) is torch.Tensor and not torch.compiler.is_compiling() and not (
                torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                             or (bias is not None and bias.requires_grad))):
            return _cuda_linear(x, weight, bias, gelu)  # the operator's CUDA implementation, without the dispatcher
    elif x.device.type != "cpu":
        raise ValueError(f"no linear kernel for device {x.device}")
    return linear_op(x, weight, bias, gelu)


def _cuda_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], gelu: bool) -> torch.Tensor:
    """The operator's CUDA implementation: one counted launch of the kernel
    (none for an x of no rows). A non-contiguous x is copied; operands the
    kernel cannot take raise ``ValueError``."""
    entry = _weight_entry(weight)
    if not x.is_contiguous():
        x = x.contiguous()
    if not _takes(x, entry, bias):
        raise ValueError(
            "the linear kernel takes float32 CUDA operands on one device: weight (N, K) contiguous and 16-byte "
            f"aligned with K % {BLOCK_K} == 0 and N % 8 == 0, x (..., K) 16-byte aligned, bias (N) contiguous or "
            f"None; got x {x.dtype} {tuple(x.shape)} on {x.device} at {x.data_ptr() % 16} mod 16, weight "
            f"{weight.dtype} {tuple(weight.shape)} stride {weight.stride()} on {weight.device}, bias "
            f"{None if bias is None else (bias.dtype, tuple(bias.shape), str(bias.device))}")
    n, k, dev, sms = entry.n, entry.k, entry.dev, entry.sms
    m = x.numel() // k
    out = x.new_empty((*x.shape[:-1], n))
    if m == 0:
        return out
    block_n = tiling(m, n, sms)
    args = (x.data_ptr(), entry.maps_for(block_n), None if bias is None else bias.data_ptr(), out.data_ptr(), m, n,
            k, int(gelu), block_n, sms, dev, torch._C._cuda_getCurrentRawStream(dev))
    if torch.cuda.current_device() == dev:
        err = _lib().linear_forward(*args)
    else:
        with torch.cuda.device(dev):
            err = _lib().linear_forward(*args)
    build.check(err, "linear kernel launch")
    build.count_launch(linear)
    return out


@torch.library.custom_op("depth_tpu_torch::linear", mutates_args=(), device_types="cuda")
def linear_op(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], gelu: bool) -> torch.Tensor:
    """The linear layer as an operator; this body is its CUDA implementation."""
    return _cuda_linear(x, weight, bias, gelu)


@linear_op.register_kernel("cpu")
def _linear_cpu(x, weight, bias, gelu):
    return linear_plain(x, weight, bias, gelu)


@linear_op.register_fake
def _linear_fake(x, weight, bias, gelu):
    return x.new_empty((*x.shape[:-1], weight.shape[0]))


def _linear_setup(ctx, inputs, output):
    x, weight, bias, gelu = inputs
    ctx.gelu = gelu
    ctx.save_for_backward(x, weight, bias)


def _linear_backward(ctx, dy):
    x, weight, bias = ctx.saved_tensors
    with full_f32():
        return (*linear_backward_plain(x, weight, bias, ctx.gelu, dy, ctx.needs_input_grad[:3]), None)


linear_op.register_autograd(_linear_backward, setup_context=_linear_setup)


linear.launches = 0
