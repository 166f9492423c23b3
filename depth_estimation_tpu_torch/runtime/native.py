"""ctypes bindings for the C++ framepipe (``native/framepipe.cpp``), the
counterpart of the JAX package's ``runtime/native.py``.

``NativeSource`` / ``NativeSink`` drop into the FrameSource / FrameSink slots
of the streaming runtime: decode runs in a C++ thread into a pre-allocated
zero-copy ring, encode in a C++ thread draining a bounded queue; neither
holds the GIL, so host IO overlaps device compute.

The library builds at first use with ``g++ -O3 -std=c++17 -fPIC -shared``
into ``depth_estimation_tpu_torch/_build/`` (git-ignored), under the lock of
the kernels' first-use build (``ops/kernels/build.py``), in a file named by a
hash of the source and the flags. OpenCV's flags come from ``pkg-config
opencv4``. Without them the source builds its ring, decode thread and
synthetic source alone: ``NativeSource`` then serves ``synthetic:NxHxW`` and
reports a file closed, ``NativeSink`` refuses, and ``open_source`` /
``open_sink`` go on to Python IO for files. Where the library cannot be
built or loaded at all, ``native_available()`` is False and all IO is
Python's. ``native_load_error()`` says which of the two happened, and why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from depth_estimation_tpu_torch.ops.kernels import build as kernel_build
from depth_estimation_tpu_torch.runtime.video import FrameSink, FrameSource

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "native" / "framepipe.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")
OPENCV_LIBS = ("-lopencv_videoio", "-lopencv_imgproc", "-lopencv_core")
NO_OPENCV = "FRAMEPIPE_NO_OPENCV"  # a define that builds the source without OpenCV
_LIBS: Dict[Tuple[str, ...], ctypes.CDLL] = {}  # defines → loaded library
_NO_OPENCV_WHY: Dict[Tuple[str, ...], Optional[str]] = {}  # defines → why that build has no OpenCV flags
_LOAD_ERRORS: Dict[Tuple[str, ...], str] = {}  # defines → why that build failed to build or load


def _opencv_flags() -> Tuple[Tuple[str, ...], Tuple[str, ...], Optional[str]]:
    """(compile flags, link flags, None) for OpenCV 4, or ((), (), why there are none)."""
    try:
        out = subprocess.run(["pkg-config", "--cflags", "--libs-only-L", "opencv4"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return (), (), f"pkg-config: {e}"
    if out.returncode != 0:
        return (), (), f"pkg-config opencv4: {out.stderr.strip() or 'not found'}"
    flags = out.stdout.split()
    return (tuple(f for f in flags if not f.startswith("-L")),
            (*(f for f in flags if f.startswith("-L")), *OPENCV_LIBS), None)


def build(defines: Tuple[str, ...] = ()) -> Tuple[pathlib.Path, Optional[str]]:
    """Compile ``framepipe.cpp`` with ``-D`` of each of ``defines`` unless
    that build exists; returns (the library, why it has no OpenCV flags or
    None). Raises if ``g++`` is missing or fails."""
    with kernel_build._LOCK:
        if NO_OPENCV in defines:
            cflags, libs, why = (), (), f"built with -D{NO_OPENCV}"
        else:
            cflags, libs, why = _opencv_flags()
        args = (*CXX_FLAGS, *(f"-D{d}" for d in defines), *cflags)
        digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(args + libs).encode()).hexdigest()[:16]
        out = kernel_build.BUILD_DIR / f"framepipe-{digest}.so"
        if out.exists():
            return out, why
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the native framepipe builds where a C++ compiler is installed")
        kernel_build.BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            proc = subprocess.run([cxx, *args, str(SOURCE), "-o", str(tmp), *libs], capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for framepipe.cpp:\n{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        finally:
            tmp.unlink(missing_ok=True)
        return out, why


def load(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The built library for ``defines``, building it first if needed."""
    key = tuple(defines)
    with kernel_build._LOCK:
        if key not in _LIBS:
            path, why = build(key)
            lib = ctypes.CDLL(str(path))
            lib.fp_has_opencv.restype = ctypes.c_int
            lib.fp_has_opencv.argtypes = []
            lib.fp_open_video.restype = ctypes.c_void_p
            lib.fp_open_video.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.fp_open_synthetic.restype = ctypes.c_void_p
            lib.fp_open_synthetic.argtypes = [ctypes.c_int] * 4
            lib.fp_width.restype = ctypes.c_int
            lib.fp_width.argtypes = [ctypes.c_void_p]
            lib.fp_height.restype = ctypes.c_int
            lib.fp_height.argtypes = [ctypes.c_void_p]
            lib.fp_frame_count.restype = ctypes.c_double
            lib.fp_frame_count.argtypes = [ctypes.c_void_p]
            lib.fp_acquire.restype = ctypes.c_int
            lib.fp_acquire.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte))]
            lib.fp_release.restype = None
            lib.fp_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.fp_close.restype = None
            lib.fp_close.argtypes = [ctypes.c_void_p]
            lib.fw_open.restype = ctypes.c_void_p
            lib.fw_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_char_p]
            lib.fw_write.restype = None
            lib.fw_write.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte)]
            lib.fw_written.restype = ctypes.c_long
            lib.fw_written.argtypes = [ctypes.c_void_p]
            lib.fw_close.restype = None
            lib.fw_close.argtypes = [ctypes.c_void_p]
            _LIBS[key], _NO_OPENCV_WHY[key] = lib, why
        return _LIBS[key]


def _library() -> Optional[ctypes.CDLL]:
    """The default build, or None where it cannot be built or loaded (the
    reason in ``native_load_error()``); tried once a process."""
    with kernel_build._LOCK:
        if () not in _LIBS and () not in _LOAD_ERRORS:
            try:
                load()
            except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:  # no compiler, or no loadable library
                _LOAD_ERRORS[()] = f"{type(e).__name__}: {e}"
        return _LIBS.get(())


def native_available() -> bool:
    """Whether the library is built and loaded: its decode thread, ring and synthetic source."""
    return _library() is not None


def native_opencv() -> bool:
    """Whether the library also decodes video files and writes MJPG (it built with OpenCV)."""
    lib = _library()
    return lib is not None and bool(lib.fp_has_opencv())


def native_load_error() -> Optional[str]:
    """None when the library built with OpenCV; else why it did not build or
    load (all IO is Python's), or why it has no OpenCV (files are Python's)."""
    lib = _library()
    if lib is None:
        return _LOAD_ERRORS[()]
    if lib.fp_has_opencv():
        return None
    why = _NO_OPENCV_WHY[()] or "the OpenCV headers were not found"
    return f"built without OpenCV ({why}): video files and the writer go through Python IO"


class NativeSource(FrameSource):
    """C++ decode thread + zero-copy ring. src: path or 'synthetic:NxHxW'."""

    def __init__(self, src: str, ring_depth: int = 4):
        lib = _library()
        if lib is None:
            raise RuntimeError(f"native framepipe unavailable: {native_load_error()}")
        self._lib = lib
        if isinstance(src, str) and src.startswith("synthetic:"):
            n, h, w = (int(v) for v in src.split(":", 1)[1].split("x"))
            self._h = lib.fp_open_synthetic(n, h, w, ring_depth)
        else:
            self._h = lib.fp_open_video(str(src).encode(), ring_depth)
        if not self._h:
            self._h = None
            self.width = self.height = 0
            self.frame_count = -1.0
            return
        self.width = lib.fp_width(self._h)
        self.height = lib.fp_height(self._h)
        self.frame_count = lib.fp_frame_count(self._h)

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        slot, view = self.read_borrowed()
        if slot < 0:
            return False, None
        # copied out of the ring so that the slot is recycled at once; the decode happened off the GIL
        frame = view.copy()
        self.release_slot(slot)
        return True, frame

    def read_borrowed(self) -> Tuple[int, Optional[np.ndarray]]:
        """Zero-copy read: (slot, view into the ring), or (-1, None) at the
        end. The caller releases the slot (``release_slot``) before the next
        read; the view is invalid after that."""
        if self._h is None:
            return -1, None
        ptr = ctypes.POINTER(ctypes.c_ubyte)()
        slot = self._lib.fp_acquire(self._h, ctypes.byref(ptr))
        if slot < 0:
            return -1, None
        return slot, np.ctypeslib.as_array(ptr, shape=(self.height, self.width, 3))

    def release_slot(self, slot: int) -> None:
        self._lib.fp_release(self._h, slot)

    def is_opened(self) -> bool:
        return self._h is not None

    def release(self) -> None:
        if self._h is not None:
            self._lib.fp_close(self._h)
            self._h = None


class NativeSink(FrameSink):
    """C++ asynchronous MJPG writer. Raises ``RuntimeError`` where the library
    is unavailable, has no OpenCV, or cannot open ``path``."""

    def __init__(self, path, size_wh: Tuple[int, int], fps: float = 20.0, fourcc: str = "MJPG"):
        lib = _library()
        if lib is None:
            raise RuntimeError(f"native framepipe unavailable: {native_load_error()}")
        self._lib = lib
        self._w, self._h2 = int(size_wh[0]), int(size_wh[1])
        self._h = lib.fw_open(str(path).encode(), self._w, self._h2, float(fps), fourcc.encode())
        if not self._h:
            self._h = None
            raise RuntimeError(f"could not open writer {path}" + ("" if lib.fp_has_opencv() else
                                                                   ": the framepipe has no OpenCV"))

    def write(self, frame: np.ndarray) -> None:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.shape != (self._h2, self._w, 3):
            raise ValueError(f"frame of shape {frame.shape}, the writer takes {(self._h2, self._w, 3)}")
        self._lib.fw_write(self._h, frame.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))

    def frames_written(self) -> int:
        return int(self._lib.fw_written(self._h))

    def release(self) -> None:
        if self._h is not None:
            self._lib.fw_close(self._h)
            self._h = None
