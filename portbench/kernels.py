"""Which device kernels of a trace belong to which part of the program, by
name: the program's own kernels (``csrc/*.cu``) and the dense layers that
cuBLAS and cuDNN run."""

from __future__ import annotations

K1 = ("attention_f32_kernel", "attention_bf16_kernel")
RESIZE = ("separable_resize_kernel",)  # K2 and K3 share one template
_DENSE = ("gemm", "conv", "winograd", "fprop", "cudnn", "cutlass", "xmma", "fft")


def is_k1(name: str) -> bool:
    return any(k in name for k in K1)


def is_resize(name: str) -> bool:
    return any(k in name for k in RESIZE)


def is_dense(name: str) -> bool:
    """A cuBLAS GEMM or a cuDNN convolution (not one of the program's own)."""
    low = name.lower()
    return not (is_k1(name) or is_resize(name)) and any(k in low for k in _DENSE)
