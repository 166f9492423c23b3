"""K2 (fused preprocess) and K3 (plane resize): separable banded resizes.

Replace ``depth_estimation_tpu/ops/pallas/resize.py::_preprocess_kernel``
(:44, via ``pallas_preprocess``) and ``::_resize_kernel`` (:102, via
``pallas_resize2d``). The kernels are entry points of one template in
``csrc/resize.cu``, whose source note gives the bound (bytes) and the design:
a block per output tile, the tile's input window staged in shared memory by
16-byte copies, a vertical then a horizontal 4-tap pass, the epilogue fused.

The kernels read each interpolation matrix as a band table, ``band_taps``:
for every output row, 4 (source index, weight) taps taken from the dense
float32 ``interp_matrix``, so clipped border duplicates arrive already
summed (``np.add.at`` in ``interp_matrix``) and the table densifies back to
the matrix exactly. Linear resizes have 2 taps, padded with zero weights.
Each row's indices are non-decreasing and lie between its first and last
nonzero column, so a tile's input window is the least first index to the
greatest last index over its rows.

``tiling`` picks the output tile of a launch and the shared memory it needs;
the kernel takes it as it is.

``preprocess_plain`` and ``resize_planes_plain`` are the plain PyTorch
versions (the dense matmul form of the JAX package). ``fused_preprocess``
and ``resize_planes`` call the operators ``depth_tpu_torch::preprocess`` and
``depth_tpu_torch::resize_planes``, whose CPU implementations are the plain
versions, whose CUDA implementations launch the kernels, and whose fake
implementations give the output's shape and dtype, so that ``torch.export``
and ``torch.compile`` trace through them. ``resize_planes(...,
output="u8")`` fuses the reference's wrap-around uint8 cast
(``ops.postprocess.wraparound_u8``) into K3.

Row windows. Both take ``window=(r0, r1, in_h, row0)``: output rows
[r0, r1) of the resize whose source has ``in_h`` rows in all, computed from
a slab of the source that starts at its row ``row0`` (``parallel/spatial.py``
cuts a frame's rows over ranks so). The row tap table is sliced to the
window and rebased to the slab (``window_taps``), ``tiling`` runs on the
sliced table, and the kernel takes the slab as its whole input: the kernel
itself is unchanged. ``window_rows`` gives the source rows a window reads;
the plain versions take the same window through the dense matrix's rows.

Gradient. K2 takes u8 frames and has none. K3's f32 route has the
registered backward ``resize_planes_backward_plain``, on both devices: the
transpose of the plain version's two products, dD = Whᵀ·G·Ww with the dense
``interp_matrix``es, as ``torch.matmul``s with TF32 off (the JAX package
trains through ``resize2d``'s products, which XLA differentiates). The u8
route takes no gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from depth_estimation_tpu_torch.device import at_least_f32, full_f32
from depth_estimation_tpu_torch.ops.kernels import build
from depth_estimation_tpu_torch.ops.postprocess import wraparound_u8
from depth_estimation_tpu_torch.ops.resize import _matrix, interp_matrix, resize2d

TAPS = 4
THREADS = 256  # kThreads in csrc/resize.cu
MIN_BLOCKS = 4  # kMinBlocks: __launch_bounds__'s blocks an SM
TILE_WIDTHS = (32, 64, 128)  # output columns a block: 8, 16 or 32 threads make 4 each
MAX_TILE_H = 32  # output rows a block: one warp loads their taps
SMEM_BLOCK = 232_448  # bytes of shared memory a block may have on the H100 (227 KB)
SMEM_SM = 233_472  # bytes an SM shares among its blocks (228 KB), 1 KB of them reserved a block
# (channels, bytes a value) of each kernel's input
_KERNELS = {"preprocess": (3, 1), "resize": (1, 4)}
_OUTPUTS = {"f32": 0, "u8": 1}


@functools.lru_cache(maxsize=64)
def band_taps(in_size: int, out_size: int, method: str = "cubic",
              align_corners: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """``interp_matrix`` as (out_size, 4) int32 source indices and float32
    weights: each row's nonzero columns in column order, then zero-weight
    pads at the row's last nonzero column."""
    w = interp_matrix(in_size, out_size, method, align_corners)
    if in_size < TAPS:
        w = np.pad(w, ((0, 0), (0, TAPS - in_size)))
    nonzero = w != 0
    count = nonzero.sum(axis=1)
    if count.max() > TAPS:
        raise ValueError(f"{method} resize {in_size}->{out_size} has more than {TAPS} taps per row")
    order = np.argsort(~nonzero, axis=1, kind="stable")[:, :TAPS]
    weights = np.take_along_axis(w, order, axis=1).astype(np.float32)
    last = np.where(nonzero, np.arange(w.shape[1]), 0).max(axis=1)
    idx = np.where(np.arange(TAPS) < count[:, None], order, last[:, None]).astype(np.int32)
    return idx, weights


def window_rows(in_size: int, out_size: int, r0: int, r1: int, method: str = "cubic",
                align_corners: bool = False) -> Tuple[int, int]:
    """[lo, hi): the source rows that output rows [r0, r1) of the resize read
    (their band taps' least first index to greatest last index)."""
    idx, _ = band_taps(in_size, out_size, method, align_corners)
    return int(idx[r0:r1, 0].min()), int(idx[r0:r1, TAPS - 1].max()) + 1


@functools.lru_cache(maxsize=256)
def window_taps(in_size: int, out_size: int, method: str, align_corners: bool, r0: int, r1: int,
                row0: int) -> Tuple[np.ndarray, np.ndarray]:
    """``band_taps`` of output rows [r0, r1), indices rebased to a slab whose first row is ``row0``."""
    idx, w = band_taps(in_size, out_size, method, align_corners)
    return np.ascontiguousarray(idx[r0:r1] - row0), np.ascontiguousarray(w[r0:r1])


def _check_window(window, out_size: int, slab_rows: int, method: str, align_corners: bool):
    """The window as ints, after checking that the slab holds every source row it reads."""
    r0, r1, in_h, row0 = (int(v) for v in window)
    if not 0 <= r0 < r1 <= out_size:
        raise ValueError(f"window rows [{r0}, {r1}) outside the {out_size} output rows")
    lo, hi = window_rows(in_h, out_size, r0, r1, method, align_corners)
    if lo < row0 or hi > row0 + slab_rows:
        raise ValueError(f"output rows [{r0}, {r1}) read source rows [{lo}, {hi}); the slab holds "
                         f"[{row0}, {row0 + slab_rows})")
    return r0, r1, in_h, row0


def _tile_windows(idx: np.ndarray, tile: int) -> Tuple[np.ndarray, np.ndarray]:
    """For each run of ``tile`` consecutive output rows of a band table, the
    first and last input index it reads (the kernel's warp-0 min and max)."""
    starts = np.arange(0, len(idx), tile)
    return np.minimum.reduceat(idx[:, 0], starts), np.maximum.reduceat(idx[:, TAPS - 1], starts)


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def tile_room(h_idx: np.ndarray, w_idx: np.ndarray, th: int, tw: int, kernel: str) -> dict:
    """What th × tw output tiles over these band tables stage, at most: input
    rows (``rows``) and columns (``cols``), the staged row pitch in bytes
    (``in_pitch``: a row's window from the 16-byte boundary at or below its
    first byte to the one at or above its last), the vertical pass's row
    pitch in floats (``mid_pitch``: ≡ tw/4 mod 32, so the rows that a warp
    spans in the horizontal pass, tw/4 lanes each, start tw/4 banks apart),
    and the shared memory a block takes."""
    channels, itemsize = _KERNELS[kernel]
    r_lo, r_hi = _tile_windows(h_idx, th)
    c_lo, c_hi = _tile_windows(w_idx, tw)
    rows, cols = int((r_hi - r_lo).max()) + 1, int((c_hi - c_lo).max()) + 1
    in_pitch = _round16(cols * channels * itemsize + 16 - itemsize)
    mid_pitch = cols + (tw // 4 - cols) % 32
    return {"rows": rows, "cols": cols, "in_pitch": in_pitch, "mid_pitch": mid_pitch,
            "smem_bytes": 32 * th + rows * in_pitch + 4 * channels * th * mid_pitch}


@functools.lru_cache(maxsize=256)
def tiling(in_hw, out_hw, batch: int, sms: int, kernel: str = "resize", method: str = "cubic",
           align_corners: bool = False, window=None) -> dict:
    """The launch of K2 (``kernel="preprocess"``: u8 × 3 channels) or K3
    (``"resize"``: f32 planes) for ``batch`` images of ``in_hw`` → ``out_hw``
    on a card with ``sms`` SMs; with ``window=(r0, r1, row0)``, of output
    rows [r0, r1) from a source slab starting at row ``row0``, over the
    window's rebased row taps.

    A block owns ``th`` output rows × ``tw`` output columns of one image, all
    channels. ``tw`` is the widest of 128, 64, 32 that cuts a row into 4
    tiles or more (32 where none does); ``th`` the shortest up to 32 that
    keeps the launch at 2 blocks an SM or fewer, so that at batch 1 it is one
    wave of one to two blocks an SM, which timed best on the H100 at every
    main-path shape. Then ``tile_room``'s fields over all tiles, and the
    blocks an SM holds."""
    (h_in, w_in), (h_out, w_out) = map(int, in_hw), map(int, out_hw)
    if window is None:
        h_idx, _ = band_taps(h_in, h_out, method, align_corners)
    else:
        h_idx, _ = window_taps(h_in, h_out, method, align_corners, *window)
        h_out = len(h_idx)
    tw = next((t for t in reversed(TILE_WIDTHS) if w_out >= 4 * t), TILE_WIDTHS[0])
    col_tiles = -(-w_out // tw)
    th = next((t for t in range(1, MAX_TILE_H + 1) if batch * -(-h_out // t) * col_tiles <= 2 * sms), MAX_TILE_H)
    w_idx, _ = band_taps(w_in, w_out, method, align_corners)
    room = tile_room(h_idx, w_idx, th, tw, kernel)
    while room["smem_bytes"] > SMEM_BLOCK and th > 1:
        th -= 1
        room = tile_room(h_idx, w_idx, th, tw, kernel)
    grid = (col_tiles, -(-h_out // th), batch)
    return {"th": th, "tw": tw, "grid": grid, "blocks": grid[0] * grid[1] * grid[2],
            **room, "blocks_per_sm": min(MIN_BLOCKS, SMEM_SM // (room["smem_bytes"] + 1024))}


@functools.lru_cache(maxsize=64)
def _device_taps(in_size, out_size, method, align_corners, device, window=None):
    idx, w = (band_taps(in_size, out_size, method, align_corners) if window is None
              else window_taps(in_size, out_size, method, align_corners, *window))
    return torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("resize")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tile = [i] * 7  # th, tw, rows, in_pitch, mid_pitch, smem_bytes, aligned
    lib.preprocess_u8.argtypes = [p, p, i, i, i, i, i, i, p, p, p, p, *tile, f, f, f, f, f, f, p]
    lib.preprocess_u8.restype = ctypes.c_int
    lib.resize_f32.argtypes = [p, p, i, i, i, i, i, i, p, p, p, p, *tile, p]
    lib.resize_f32.restype = ctypes.c_int
    return lib


def _launch_args(x: torch.Tensor, in_hw, out_hw, kernel, method, align_corners, window=None):
    """The tap tables' pointers, then the tiling's fields as the C entries take
    them; ``window``: (r0, r1, row0) of a row window (``in_hw`` the whole source's)."""
    h_idx, h_w = _device_taps(int(in_hw[0]), int(out_hw[0]), method, bool(align_corners), x.device, window)
    w_idx, w_w = _device_taps(int(in_hw[1]), int(out_hw[1]), method, bool(align_corners), x.device)
    channels, itemsize = _KERNELS[kernel]
    t = tiling(tuple(in_hw), tuple(out_hw), x.shape[0], build.sm_count(x.device.index), kernel, method,
               bool(align_corners), window)
    aligned = x.data_ptr() % 16 == 0 and in_hw[1] * channels * itemsize % 16 == 0
    return (h_idx.data_ptr(), h_w.data_ptr(), w_idx.data_ptr(), w_w.data_ptr(), t["th"], t["tw"], t["rows"],
            t["in_pitch"], t["mid_pitch"], t["smem_bytes"], int(aligned))


def _check_cuda(x: torch.Tensor, dtype: torch.dtype, ndim: int, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {x.device}")
    if x.dtype != dtype or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{what} kernel takes a contiguous {ndim}-d {dtype} tensor; "
                         f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")


# -- K2: u8 frame → normalized network input ---------------------------------

def _window_matrix(in_size, out_size, method, align_corners, window, slab_rows, device, dtype):
    """The rows [r0, r1) of the dense row matrix, over the slab's columns."""
    r0, r1, _, row0 = window
    m = interp_matrix(in_size, out_size, method, align_corners)[r0:r1, row0:row0 + slab_rows]
    return torch.from_numpy(np.ascontiguousarray(m)).to(device, dtype)


def _resize_window(x: torch.Tensor, out_hw, method, align_corners, window) -> torch.Tensor:
    """``resize2d`` of (…, rows, W, C) rows ``window`` (checked), in ``resize2d``'s two contractions."""
    in_h, in_w = int(window[2]), x.shape[-2]
    r0, r1, _, row0 = _check_window(window, int(out_hw[0]), x.shape[-3], method, align_corners)
    dtype = x.dtype
    x = at_least_f32(x)
    x = torch.einsum("oh,...hwc->...owc", _window_matrix(in_h, int(out_hw[0]), method, align_corners,
                                                        (r0, r1, in_h, row0), x.shape[-3], x.device, x.dtype), x)
    if in_w != int(out_hw[1]):
        x = torch.einsum("ow,...hwc->...hoc", _matrix(in_w, int(out_hw[1]), method, align_corners, x.device, x.dtype),
                         x)
    return x.to(dtype) if dtype.is_floating_point else x


def preprocess_plain(imgs: torch.Tensor, out_hw: Tuple[int, int], mean: Sequence[float],
                     std: Sequence[float], bgr_to_rgb: bool = True, method: str = "cubic",
                     window=None) -> torch.Tensor:
    """u8 (B, H, W, 3) → f32 (B, 3, H_out, W_out): RGB, /255, cubic (or
    linear) resize, (x - mean_c) / std_c. ``window=(r0, r1, in_h, row0)``:
    output rows [r0, r1) only, ``imgs`` holding source rows row0 … of in_h."""
    x = imgs.flip(-1) if bgr_to_rgb else imgs
    x = x.to(torch.float32) / 255.0
    if window is None:
        x = resize2d(x, out_hw, method=method, align_corners=False)
    else:
        x = _resize_window(x, out_hw, method, False, window)
    mean_v = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_v = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - mean_v) / std_v).permute(0, 3, 1, 2).contiguous()


def normalize_affine(mean: Sequence[float], std: Sequence[float]) -> Tuple[list, list]:
    """(x/255 - mean_c) / std_c as x·scale_c + bias_c: the constants,
    worked out in double and rounded once to float32, that K2 folds in."""
    scale = [float(np.float32(1.0 / (255.0 * s))) for s in std]
    bias = [float(np.float32(-m / s)) for m, s in zip(mean, std)]
    return scale, bias


def fused_preprocess(imgs: torch.Tensor, out_hw: Tuple[int, int], mean: Sequence[float],
                     std: Sequence[float], bgr_to_rgb: bool = True, method: str = "cubic",
                     window=None) -> torch.Tensor:
    """``preprocess_plain`` for a CPU tensor; one K2 launch for a CUDA tensor.
    ``method="linear"`` is the detectors' input (JAX ``pallas_preprocess(...,
    method="linear")``): 2 taps a row, padded to 4 with zero weights.
    ``window=(r0, r1, in_h, row0)``: output rows [r0, r1) of the resize of an
    ``in_h``-row frame, ``imgs`` holding its rows from ``row0`` (the module
    docstring); the output is (B, 3, r1 − r0, W_out)."""
    if imgs.device.type != "cpu" and method not in ("cubic", "linear"):
        raise ValueError(f"preprocess kernel takes cubic or linear, got {method!r}")
    if imgs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no preprocess kernel for device {imgs.device}")
    return preprocess_op(imgs, [int(n) for n in out_hw], [float(m) for m in mean], [float(s) for s in std],
                         bool(bgr_to_rgb), method, None if window is None else [int(v) for v in window])


@torch.library.custom_op("depth_tpu_torch::preprocess", mutates_args=(), device_types="cuda")
def preprocess_op(imgs: torch.Tensor, out_hw: List[int], mean: List[float], std: List[float], bgr_to_rgb: bool,
                  method: str, window: Optional[List[int]] = None) -> torch.Tensor:
    """K2 as an operator; this body is its CUDA implementation: one launch, counted."""
    _check_cuda(imgs, torch.uint8, 4, "preprocess")
    b, h, w, c = imgs.shape
    if c != 3:
        raise ValueError(f"preprocess kernel takes 3-channel frames, got {c}")
    h_out, w_out = out_hw
    in_hw, rows, win = (h, w), h_out, None
    if window is not None:
        r0, r1, in_h, row0 = _check_window(window, h_out, h, method, False)
        in_hw, rows, win = (in_h, w), r1 - r0, (r0, r1, row0)
    out = torch.empty((b, 3, rows, w_out), dtype=torch.float32, device=imgs.device)
    scale, bias = normalize_affine(mean, std)
    with torch.cuda.device(imgs.device):
        err = _lib().preprocess_u8(
            imgs.data_ptr(), out.data_ptr(), b, h, w, rows, w_out, int(bgr_to_rgb),
            *_launch_args(imgs, in_hw, (h_out, w_out), "preprocess", method, False, win), *scale, *bias,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "preprocess kernel launch")
    build.count_launch(fused_preprocess)
    return out


@preprocess_op.register_kernel("cpu")
def _preprocess_cpu(imgs, out_hw, mean, std, bgr_to_rgb, method, window=None):
    return preprocess_plain(imgs, out_hw, mean, std, bgr_to_rgb, method, window).contiguous()


def _window_out_rows(out_rows: int, window) -> int:
    return out_rows if window is None else int(window[1]) - int(window[0])


@preprocess_op.register_fake
def _preprocess_fake(imgs, out_hw, mean, std, bgr_to_rgb, method, window=None):
    return imgs.new_empty((imgs.shape[0], 3, _window_out_rows(out_hw[0], window), out_hw[1]), dtype=torch.float32)


fused_preprocess.launches = 0


# -- K3: f32 planes → resized planes, f32 or wrapped to u8 -------------------

def resize_planes_plain(x: torch.Tensor, out_hw: Tuple[int, int], method: str = "cubic",
                        align_corners: bool = False, output: str = "f32", window=None) -> torch.Tensor:
    """f32 (B, H, W) or (H, W) → (B, H_out, W_out) or (H_out, W_out), f32 or
    with ``output="u8"`` the reference's wrap-around uint8 cast of it.
    ``window=(r0, r1, in_h, row0)``: output rows [r0, r1) only, ``x``
    holding source rows row0 … of in_h."""
    if output not in _OUTPUTS:
        raise ValueError(f"output must be one of {sorted(_OUTPUTS)}, got {output!r}")
    if window is None:
        out = resize2d(x[..., None], out_hw, method, align_corners)[..., 0]
    else:
        out = _resize_window(x[..., None], out_hw, method, align_corners, window)[..., 0]
    return wraparound_u8(out) if output == "u8" else out


def resize_planes_backward_plain(g: torch.Tensor, in_hw: Tuple[int, int], method: str = "cubic",
                                 align_corners: bool = False, window=None, out_rows=None) -> torch.Tensor:
    """The gradient of ``resize_planes_plain``'s f32 route with respect to
    its (B, H, W) input, for the output gradient ``g`` (B, H_out, W_out):
    Whᵀ·g·Ww, in f32 (float64 for a float64 ``g``). With ``window``, ``in_hw``
    is the slab's and Wh the window's rows of the ``out_rows``-row resize
    over the slab's columns."""
    h_out, w_out = g.shape[-2:]
    g = at_least_f32(g)
    # a traced backward (fake tensors) makes its matrices anew; an eager one takes the cached device copies
    matrix = _matrix if is_fake(g) else _device_matrix
    ww = matrix(int(in_hw[1]), int(w_out), method, bool(align_corners), g.device).to(g.dtype)
    if window is None:
        wh = matrix(int(in_hw[0]), int(h_out), method, bool(align_corners), g.device).to(g.dtype)
    else:
        r0, r1, in_h, row0 = window
        wh = matrix(int(in_h), int(out_rows), method, bool(align_corners), g.device)[
            r0:r1, row0:row0 + int(in_hw[0])].to(g.dtype)
    return torch.matmul(wh.t(), torch.matmul(g, ww))


@functools.lru_cache(maxsize=64)
def _device_matrix(in_size, out_size, method, align_corners, device):
    return torch.from_numpy(interp_matrix(in_size, out_size, method, align_corners)).to(device)


def resize_planes(x: torch.Tensor, out_hw: Tuple[int, int], method: str = "cubic",
                  align_corners: bool = False, output: str = "f32", window=None) -> torch.Tensor:
    """``resize_planes_plain`` for a CPU tensor; one K3 launch for all the
    planes of a CUDA tensor. The u8 route stores ``(int)trunc(v) & 255``,
    ``wraparound_u8``'s function for |trunc(v)| < 2**24; the f32 route
    carries the gradient of ``resize_planes_backward_plain``.
    ``window=(r0, r1, in_h, row0)``: output rows [r0, r1) of the resize of an
    ``in_h``-row map, ``x`` holding its rows from ``row0`` (the module
    docstring)."""
    if x.device.type != "cpu" and method not in ("cubic", "linear"):
        raise ValueError(f"resize kernel takes cubic or linear, got {method!r}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no resize kernel for device {x.device}")
    if output not in _OUTPUTS:
        raise ValueError(f"output must be one of {sorted(_OUTPUTS)}, got {output!r}")
    planes = x if x.dim() == 3 else x[None]
    out = resize_planes_op(planes, [int(out_hw[0]), int(out_hw[1])], method, bool(align_corners), output,
                           None if window is None else [int(v) for v in window])
    return out if x.dim() == 3 else out[0]


@torch.library.custom_op("depth_tpu_torch::resize_planes", mutates_args=(), device_types="cuda")
def resize_planes_op(planes: torch.Tensor, out_hw: List[int], method: str, align_corners: bool,
                     output: str, window: Optional[List[int]] = None) -> torch.Tensor:
    """K3 on (B, H, W) planes as an operator; this body is its CUDA
    implementation: one launch, counted."""
    _check_cuda(planes, torch.float32, 3, "resize")
    b, h, w = planes.shape
    h_out, w_out = out_hw
    in_hw, rows, win = (h, w), h_out, None
    if window is not None:
        r0, r1, in_h, row0 = _check_window(window, h_out, h, method, align_corners)
        in_hw, rows, win = (in_h, w), r1 - r0, (r0, r1, row0)
    dtype = torch.uint8 if output == "u8" else torch.float32
    out = torch.empty((b, rows, w_out), dtype=dtype, device=planes.device)
    with torch.cuda.device(planes.device):
        err = _lib().resize_f32(
            planes.data_ptr(), out.data_ptr(), b, h, w, rows, w_out, _OUTPUTS[output],
            *_launch_args(planes, in_hw, (h_out, w_out), "resize", method, align_corners, win),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "resize kernel launch")
    build.count_launch(resize_planes)
    return out


@resize_planes_op.register_kernel("cpu")
def _resize_planes_cpu(planes, out_hw, method, align_corners, output, window=None):
    out = resize_planes_plain(planes, out_hw, method, align_corners, output, window)
    if output == "f32" and window is None and tuple(planes.shape[1:]) == tuple(out_hw):
        return out.clone(memory_format=torch.contiguous_format)  # resize2d returned its input
    return out.contiguous()


@resize_planes_op.register_fake
def _resize_planes_fake(planes, out_hw, method, align_corners, output, window=None):
    dtype = torch.uint8 if output == "u8" else planes.dtype
    return planes.new_empty((planes.shape[0], _window_out_rows(out_hw[0], window), out_hw[1]), dtype=dtype)


def _resize_planes_setup(ctx, inputs, output):
    planes, out_hw, ctx.method, ctx.align_corners, _output, ctx.window = inputs
    ctx.in_hw, ctx.out_rows = tuple(planes.shape[1:]), out_hw[0]


def _resize_planes_backward(ctx, g):
    with full_f32():
        return (resize_planes_backward_plain(g, ctx.in_hw, ctx.method, ctx.align_corners, ctx.window, ctx.out_rows),
                None, None, None, None, None)


resize_planes_op.register_autograd(_resize_planes_backward, setup_context=_resize_planes_setup)


resize_planes.launches = 0
