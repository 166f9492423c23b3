"""The training loop (JAX ``train/loop.py``): fit with periodic evaluation,
checkpoints and resume.

Checkpoints every ``ckpt_every`` steps into ``ckpt_dir/state`` and resumes
from it: on the CPU a resumed run is bitwise the straight one
(tests/test_torch_train_loop.py). With ``mesh=`` every rank of the mesh
calls ``fit``: the model is cut to the rank's tp shard, each step takes the
rank's dp slice of the batch, the checkpoint is the whole state in the
single-device format (written by global rank 0) and a resume cuts it again
(tests/test_torch_parallel_train.py).
"""

from __future__ import annotations

import pathlib
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from depth_estimation_tpu_torch.device import conv_algorithms_by_timing, full_f32, resolve_device
from depth_estimation_tpu_torch.parallel.mesh import batch_slice, mesh_device
from depth_estimation_tpu_torch.train.data import ShardedBatch
from depth_estimation_tpu_torch.train.metrics import depth_metrics, metrics_to_host
from depth_estimation_tpu_torch.train.step import (TrainState, init_state, load_sharded_train_state, make_train_step,
                                                   save_sharded_train_state)
from depth_estimation_tpu_torch.utils.checkpoint import load_train_state, save_train_state


def _on(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(dev, non_blocking=True)


def fit(
    model: nn.Module,
    data: Iterable[Tuple[np.ndarray, np.ndarray]],
    steps: int,
    lr: float = 1e-4,
    alpha: float = 0.5,
    accum_steps: int = 1,
    mesh=None,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 100,
    log_every: int = 10,
    verbose: bool = True,
    eval_data: Optional[Iterable[Tuple[np.ndarray, np.ndarray]]] = None,
    eval_every: int = 100,
    device="cuda",
) -> Tuple[TrainState, list]:
    """Run ``steps`` optimizer steps of ``model`` (moved to ``device``) over
    ``data`` (an iterable of (images, gt) batches, numpy or tensors).

    Resumes from ``ckpt_dir`` if a checkpoint exists there. Returns the
    final state and the history: ``(step, loss)`` every ``log_every`` steps
    and at the end. ``eval_data`` (a re-iterable of (images, gt) batches)
    scores the model every ``eval_every`` steps and at the end with the
    aligned depth metrics (train/metrics.py), as ``(step, loss, metrics)``.

    ``mesh``: a ``parallel.mesh.make_mesh`` mesh; every rank calls ``fit``
    with the same global batches (or with ``device_prefetch(mesh=)``'s
    slices), runs on the mesh's device (``device`` is ignored) and logs the
    global loss; only global rank 0 prints. Evaluation runs the whole eval
    batches on every rank.
    """
    dev = mesh_device(mesh) if mesh is not None else resolve_device(device)
    verbose = verbose and (mesh is None or dist.get_rank() == 0)
    with torch.no_grad():  # buffers moved outside any graph stay leaves
        model.to(dev)
    state = init_state(model, lr=lr, mesh=mesh)
    save, load = (save_train_state, load_train_state) if mesh is None else (save_sharded_train_state,
                                                                            load_sharded_train_state)

    ckpt_path = pathlib.Path(ckpt_dir) / "state" if ckpt_dir else None
    if ckpt_path is not None and ckpt_path.exists():
        load(ckpt_path, state)
        if verbose:
            print(f"resumed from step {state.step}")

    step_fn = make_train_step(model, state.optimizer, alpha=alpha, accum_steps=accum_steps, mesh=mesh)

    def run_eval():
        sums, n = {}, 0
        with torch.no_grad(), full_f32(), conv_algorithms_by_timing():
            for imgs, gt in eval_data:
                imgs, gt = _on(imgs, dev), _on(gt, dev)
                m = metrics_to_host(depth_metrics(model(imgs), gt, align=True))
                k = len(imgs)
                for key, v in m.items():
                    sums[key] = sums.get(key, 0.0) + v * k
                n += k
        return {key: v / max(n, 1) for key, v in sums.items()}

    it: Iterator = iter(data)
    history = []
    saved_at = None
    for i in range(state.step, steps):
        try:
            batch = next(it)
        except StopIteration:
            it = iter(data)
            try:
                batch = next(it)
            except StopIteration:
                raise ValueError(
                    "dataset yielded nothing on restart — pass a "
                    "re-iterable (e.g. train/data.py::batches / "
                    "device_prefetch), not a bare generator"
                ) from None
        images, gt = batch
        if mesh is not None and not isinstance(batch, ShardedBatch):
            images, gt = batch_slice(images, mesh), batch_slice(gt, mesh)
        loss = step_fn(_on(images, dev), _on(gt, dev))
        state.step = i + 1
        if (i + 1) % log_every == 0 or i + 1 == steps:
            loss_v = float(loss)
            history.append((i + 1, loss_v))
            if verbose:
                print(f"step {i + 1}/{steps} loss {loss_v:.5f}")
        if eval_data is not None and ((i + 1) % eval_every == 0 or i + 1 == steps):
            m = run_eval()
            history.append((i + 1, float(loss), m))
            if verbose:
                print(f"step {i + 1}/{steps} eval abs_rel {m['abs_rel']:.4f} "
                      f"d1 {m['d1']:.3f} rmse {m['rmse']:.4f}")
        if ckpt_path is not None and (i + 1) % ckpt_every == 0:
            save(ckpt_path, state)
            saved_at = state.step
    if ckpt_path is not None and saved_at != state.step:
        save(ckpt_path, state)
    return state, history


def synthetic_depth_dataset(batch: int, hw: Tuple[int, int], n_batches: int = 8, seed: int = 0):
    """Deterministic toy dataset: images + inverse-depth gt with structure
    (a bright disc at a known depth over a gradient background)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    out = []
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n_batches):
        imgs = np.empty((batch, h, w, 3), np.float32)
        gts = np.empty((batch, h, w), np.float32)
        for b in range(batch):
            cx, cy = rng.integers(w // 4, 3 * w // 4), rng.integers(h // 4, 3 * h // 4)
            r = rng.integers(min(h, w) // 8, min(h, w) // 4)
            disc = ((xx - cx) ** 2 + (yy - cy) ** 2) < r * r
            depth_bg = 1.0 / (2.0 + 3.0 * (yy / h))  # floor receding with y
            depth = np.where(disc, 1.0, depth_bg).astype(np.float32)
            img = np.stack([depth, depth * 0.5, 1.0 - depth], axis=-1)
            img = img + rng.normal(0, 0.02, img.shape)
            imgs[b] = img.astype(np.float32)
            gts[b] = depth
        out.append((imgs, gts))
    return out
