"""Device selection and the f32 numerics policy of the frame program."""

from __future__ import annotations

import contextlib
import threading

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


class _SharedFlags:
    """Process-wide torch flags held at the frame program's values while any
    thread is inside the context, restored on the last exit.

    The flags are global to the process, so a context that saved and
    restored them on its own would let one thread's exit undo the settings
    under another thread still inside (the servers run a dispatcher thread a
    resolution). Here the first entry saves and sets them, nested and
    concurrent entries only count, and the last exit restores what the
    first entry saw."""

    def __init__(self, getter, setter, value):
        self._get, self._set, self._value = getter, setter, value
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = None

    @contextlib.contextmanager
    def __call__(self):
        with self._lock:
            if self._depth == 0:
                self._saved = self._get()
                self._set(self._value)
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    self._set(self._saved)


def _set_tf32(flags):
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _set_benchmark(flag):
    torch.backends.cudnn.benchmark = flag


def _set_deterministic(flag):
    torch.backends.cudnn.deterministic = flag


_NO_TF32 = _SharedFlags(lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32),
                       _set_tf32, (False, False))
_TIMED_CONVS = _SharedFlags(lambda: torch.backends.cudnn.benchmark, _set_benchmark, True)
_DETERMINISTIC_CONVS = _SharedFlags(lambda: torch.backends.cudnn.deterministic, _set_deterministic, True)


def full_f32():
    """Matmuls and cuDNN convolutions in full float32 while any thread is
    inside, restored on the last exit (``_SharedFlags``).

    cuDNN's TF32 default is the H100's counterpart of the TPU's single-pass
    bf16 default, which fails the 1e-3 accuracy gate (BASELINE.md:74-78)."""
    return _NO_TF32()


def conv_algorithms_by_timing():
    """cuDNN chooses each convolution's algorithm by timing the candidates on
    the first call at a shape (``torch.backends.cudnn.benchmark``) while any
    thread is inside, restored on the last exit (``_SharedFlags``).

    Without it, on an H100 with TF32 off, cuDNN's heuristic runs MiDaS v2.1's
    first head conv (256→128, 3×3) at batch 4 as an FFT whose complex GEMM is
    launched some 33,000 times, which made a frame five times slower at
    batch 4 than at batch 1. Timing changes which algorithm runs, not the
    type: f32 stays f32 under ``full_f32``."""
    return _TIMED_CONVS()


def deterministic_convs():
    """cuDNN restricted to deterministic algorithms (timing, under
    ``conv_algorithms_by_timing``, chooses among those) while any thread is
    inside, restored on the last exit (``_SharedFlags``). The train step runs
    under it: some of cuDNN's backward algorithms add with atomics, so two
    identical DPT_Large steps on an H100 gave different gradients."""
    return _DETERMINISTIC_CONVS()


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or in its own type where that is wider: the plain
    versions compute in f32, and a float64 input (a gradient reference) in
    float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))
