"""Training data pipeline (JAX ``train/data.py``): host IO → batching → device prefetch.

* the host only decodes and batches uint8 images + float32 disparity maps —
  no normalization or resizing on the CPU;
* ``TrainingApply`` puts the MiDaS input transform into the model's forward
  (u8 → K2 ``fused_preprocess`` → the network → K3 cubic back to the
  dataset's size), so the train step consumes raw u8 batches;
* ``device_prefetch`` keeps ``size`` batches in flight: pinned host tensors
  copied with ``non_blocking=True``, so host decode and stacking overlap the
  device's work; over a mesh, each rank's dp slice only.

Storage format: .npz files with ``image`` (H, W, 3) uint8 and ``disparity``
(H, W) float32 — the (frame, inverse-depth) pairs the SSI loss expects
(train/losses.py). The numpy helpers are copies of the JAX package's, so
both give the same arrays.
"""

from __future__ import annotations

import pathlib
from collections import deque
from typing import Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from depth_estimation_tpu_torch.device import resolve_device
from depth_estimation_tpu_torch.ops.kernels.resize import fused_preprocess, resize_planes
from depth_estimation_tpu_torch.ops.preprocess import compute_resize_shape

Pair = Tuple[np.ndarray, np.ndarray]


def iter_npz_dir(path) -> Iterator[Pair]:
    """Yield (image u8 (H,W,3), disparity f32 (H,W)) from every .npz under
    ``path`` — recursively, in sorted order (deterministic)."""
    files = sorted(pathlib.Path(path).rglob("*.npz"))
    if not files:
        raise FileNotFoundError(f"no .npz samples under {path}")
    for f in files:
        with np.load(f) as z:
            img = np.asarray(z["image"])
            disp = np.asarray(z["disparity"])
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"{f}: 'image' must be (H, W, 3) uint8, got "
                             f"{img.shape} {img.dtype}")
        if disp.shape != img.shape[:2]:
            raise ValueError(f"{f}: 'disparity' {disp.shape} does not match "
                             f"image {img.shape[:2]}")
        yield img, disp.astype(np.float32)


def synthetic_pairs(n: int, h: int, w: int, seed: int = 0) -> Iterator[Pair]:
    """Deterministic synthetic (image, disparity) pairs for tests/smokes."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        disp = rng.random((h, w), np.float32) + 0.1
        yield img, disp


class ShardedBatch(tuple):
    """A batch already cut to this rank's dp slice and on its device
    (``device_prefetch(mesh=)``); ``fit(mesh=)`` takes it as it is."""


class _Reiterable:
    """Dataset wrapper that restarts from scratch on every ``iter()`` —
    what train/loop.py's epoch restart (``iter(data)`` after exhaustion)
    needs; a bare generator would come back empty."""

    def __init__(self, factory):
        self._factory = factory

    def __iter__(self):
        return self._factory()


def batches(
    pairs: Iterable[Pair],
    batch_size: int,
    epochs: int = 1,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
):
    """Stack pairs into ((B,H,W,3) u8, (B,H,W) f32) numpy batches.

    Materializes the sample list once and returns a RE-ITERABLE: each
    ``iter()`` yields ``epochs`` deterministic passes, reshuffled per epoch
    from ``seed`` — so fit() can restart the dataset when it runs more
    steps than one pass provides."""
    data = list(pairs)
    if not data:
        raise ValueError("empty dataset")
    if drop_remainder and len(data) < batch_size:
        raise ValueError(f"{len(data)} samples < batch_size {batch_size}")

    def gen():
        for epoch in range(epochs):
            order = np.arange(len(data))
            if shuffle:
                np.random.default_rng(seed + epoch).shuffle(order)
            stop = (len(data) // batch_size) * batch_size if drop_remainder else len(data)
            for i in range(0, stop, batch_size):
                sel = order[i:i + batch_size]
                yield (np.stack([data[j][0] for j in sel]),
                       np.stack([data[j][1] for j in sel]))

    return _Reiterable(gen)


def device_prefetch(it: Iterable, size: int = 2, mesh=None, device="cuda"):
    """Batches already on ``device``, ``size`` copies kept in flight.

    Each batch's arrays become pinned host tensors (on a CUDA device) copied
    with ``non_blocking=True``, so while the step consumes batch t, batches
    t+1..t+size are crossing to the device. Each pinned source is held until
    the consumer asks for the batch after its own.

    With ``mesh`` (``parallel.mesh.make_mesh``), only the rank's dp slice of
    each batch goes to the rank's device (``device`` is ignored), as a
    ``ShardedBatch``.

    Returns a RE-ITERABLE: each ``iter()`` restarts ``it`` when it is one
    (e.g. :func:`batches`'s result), so fit()'s epoch restart works through
    the prefetcher."""
    if mesh is not None:
        from depth_estimation_tpu_torch.parallel.mesh import batch_slice, mesh_device

        dev, cut, wrap = mesh_device(mesh), (lambda a: batch_slice(a, mesh)), ShardedBatch
    else:
        dev, cut, wrap = resolve_device(device), (lambda a: a), tuple

    def put(batch):
        host = [torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
                for a in map(cut, batch)]
        if dev.type == "cuda":
            host = [h.pin_memory() for h in host]
        return host, wrap(h.to(dev, non_blocking=True) for h in host)

    def gen():
        q: deque = deque()
        for item in it:
            q.append(put(item))
            if len(q) > max(1, int(size)):
                held = q.popleft()
                yield held[1]
        while q:
            held = q.popleft()
            yield held[1]

    return _Reiterable(gen)


class TrainingApply(nn.Module):
    """The model over RAW uint8 batches: (B, H, W, 3) u8 on the model's
    device → (B, H, W) disparity at the batch's own size (JAX
    ``make_training_apply``).

    K2 (``fused_preprocess``) makes the network input (/255, cubic resize to
    the network grid, mean/std normalize), the model runs, and K3
    (``resize_planes``) resizes its output back to the source size, the
    cubic the inference path uses, so the loss aligns with full-resolution
    ground truth. ``net_hw`` pins the network grid; by default it is the
    transform of the batch's size. ``bgr=True`` mirrors the inference
    path's cv2 channel order. On the CPU the kernels' plain versions run."""

    def __init__(self, model: nn.Module, preprocess_cfg, net_hw: Optional[Sequence[int]] = None,
                 bgr: bool = False):
        super().__init__()
        self.model = model
        self.preprocess_cfg = preprocess_cfg
        self.net_hw = tuple(net_hw) if net_hw else None
        self.bgr = bgr

    def forward(self, imgs_u8: torch.Tensor) -> torch.Tensor:
        cfg = self.preprocess_cfg
        src_hw = (int(imgs_u8.shape[1]), int(imgs_u8.shape[2]))
        hw = self.net_hw or compute_resize_shape(*src_hw, cfg)
        x = fused_preprocess(imgs_u8.contiguous(), hw, cfg.mean, cfg.std, bgr_to_rgb=self.bgr)
        pred = self.model(x)  # (B, h', w') at the network grid
        return resize_planes(pred, src_hw, "cubic", align_corners=False)
