"""Device selection and the f32 numerics policy of the frame program."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """The port runs on the GPU unless the caller names the CPU. A request
    for CUDA on a host without a GPU raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA GPU is available; pass "
            "device='cpu' explicitly to run the plain PyTorch path"
        )
    return dev


@contextlib.contextmanager
def full_f32():
    """Matmuls and cuDNN convolutions in full float32, restored on exit.

    cuDNN's TF32 default is the H100's counterpart of the TPU's single-pass
    bf16 default, which fails the 1e-3 accuracy gate (BASELINE.md:74-78)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@contextlib.contextmanager
def conv_algorithms_by_timing():
    """cuDNN chooses each convolution's algorithm by timing the candidates on
    the first call at a shape (``torch.backends.cudnn.benchmark``), restored
    on exit.

    Without it, on an H100 with TF32 off, cuDNN's heuristic runs MiDaS v2.1's
    first head conv (256→128, 3×3) at batch 4 as an FFT whose complex GEMM is
    launched some 33,000 times, which made a frame five times slower at
    batch 4 than at batch 1. Timing changes which algorithm runs, not the
    type: f32 stays f32 under ``full_f32``."""
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = prev
