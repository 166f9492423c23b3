"""Build the CUDA sources under ``csrc/`` into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` at first use into ``depth_estimation_tpu_torch/_build/``
(listed in ``.gitignore``), under a file name keyed by a hash of the source
and the flags, so an edited source is rebuilt and a built one is reused. A
build may add preprocessor macros (``defines``, passed as ``-D``); the port's
own libraries take none. The library is loaded with ``ctypes``; every
pointer and the stream are passed as ``c_void_p``.

``build`` and ``load`` hold one module lock, and each compile writes to a
temporary file named for its process and thread, so threads that reach a
kernel's first use together (the servers' dispatchers) build each source
once. The wrappers count their launches through ``count_launch``, under a
lock of its own.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Tuple

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("attention", "resize", "grouped_conv", "linear")
_LOCK = threading.RLock()  # build and load
_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_COUNT_LOCK = threading.Lock()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def _flags(defines: Tuple[str, ...]) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines: Tuple[str, ...] = ()) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES, defines: Tuple[str, ...] = ()) -> Dict[str, str]:
    """Compile each named source that is not built yet, one ``nvcc`` per
    source, all started together. Returns each source's compiler output
    (empty for one that was already built); raises if any build fails."""
    with _LOCK:
        return _build(tuple(names), tuple(defines))


def _build(names: Tuple[str, ...], defines: Tuple[str, ...]) -> Dict[str, str]:
    jobs = {}
    try:
        for name in names:
            out = library_path(name, defines)
            if out.exists():
                continue
            BUILD_DIR.mkdir(exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, out)
        logs = {name: "" for name in names}
        failed = []
        for name, (proc, tmp, out) in jobs.items():
            logs[name], _ = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
            else:
                failed.append(f"nvcc failed for {name}.cu:\n{logs[name]}")
        if failed:
            raise RuntimeError("\n".join(failed))
        return logs
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it first if needed."""
    key = (name, tuple(defines))
    with _LOCK:
        if key not in _LIBS:
            build((name,), key[1])
            _LIBS[key] = ctypes.CDLL(str(library_path(name, key[1])))
        return _LIBS[key]


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``; the dispatcher threads launch at once."""
    with _COUNT_LOCK:
        wrapper.launches += 1


@functools.lru_cache(maxsize=None)
def sm_count(index) -> int:
    """The number of SMs of CUDA device ``index``."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
