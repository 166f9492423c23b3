"""Checkpoints (JAX ``utils/checkpoint.py``): the weight cache and the train state.

Hub checkpoints (.pt state dicts, as ``torch.hub.load("intel-isl/MiDaS",
...)`` downloads them in the reference, depth_midas.py:10) are imported once
into an explicit cache, ``$DEPTH_ESTIMATION_TPU_TORCH_CACHE`` or
``~/.cache/depth_estimation_tpu_torch``: ``<model_type>/params.pt`` holds
the hub-keyed state dict the port's modules load as it is, and
``<model_type>/meta.json`` the source file's content hash, so a re-import of
the same file does no work. ``DepthEstimator(model_type)`` loads the cache
when no weights are given.

``save_train_state`` / ``load_train_state`` keep the model's state dict, the
optimizer's and the step in one file (a temporary file, then a rename).
``write_train_state`` / ``read_train_state`` are the file alone, for a
state kept elsewhere (``train.step.save_sharded_train_state`` writes a
state sharded over a mesh, gathered, in the same format).
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
from typing import Dict, Optional, Tuple

import torch

CACHE_ENV = "DEPTH_ESTIMATION_TPU_TORCH_CACHE"


def cache_dir() -> pathlib.Path:
    root = os.environ.get(CACHE_ENV) or os.path.join(os.path.expanduser("~"), ".cache", "depth_estimation_tpu_torch")
    return pathlib.Path(root)


def _ckpt_path(model_type: str) -> pathlib.Path:
    return cache_dir() / model_type / "params.pt"


def _save_atomic(obj, path: pathlib.Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def save_params(model_type: str, params: Dict[str, torch.Tensor], meta: Optional[Dict] = None) -> pathlib.Path:
    """Cache a hub-keyed state dict for ``model_type`` (and its ``meta.json``)."""
    path = _ckpt_path(model_type)
    _save_atomic({k: v.detach().cpu().contiguous() for k, v in params.items()}, path)
    if meta:
        (path.parent / "meta.json").write_text(json.dumps(meta))
    return path


def load_params(model_type: str) -> Optional[Dict[str, torch.Tensor]]:
    """The cached state dict of ``model_type`` on the CPU, or None."""
    path = _ckpt_path(model_type)
    if not path.exists():
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def content_hash(path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def import_torch_checkpoint(pt_path, model_type: str) -> Dict[str, torch.Tensor]:
    """Check a downloaded hub checkpoint (.pt state dict) against
    ``model_type``'s modules and cache it.

    Skips the work when the cached copy came from the same content hash.
    Keys the forward never reads (``estimator._unread_hub_key``) are left
    out; any other missing or unexpected key, or a shape that differs,
    raises. Returns the cached state dict."""
    digest = content_hash(pt_path)
    meta_file = _ckpt_path(model_type).parent / "meta.json"
    if meta_file.exists() and json.loads(meta_file.read_text()).get("source_sha256") == digest:
        cached = load_params(model_type)
        if cached is not None:
            return cached

    from depth_estimation_tpu_torch.estimator import _unread_hub_key
    from depth_estimation_tpu_torch.registry import get_entry

    sd = torch.load(pt_path, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items() if not _unread_hub_key(k)}
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in get_entry(model_type).make_model().state_dict().items()}
    missing, unexpected = sorted(want.keys() - sd.keys()), sorted(sd.keys() - want.keys())
    wrong = sorted(k for k in want.keys() & sd.keys() if tuple(sd[k].shape) != want[k])
    if missing or unexpected or wrong:
        raise KeyError(f"{pt_path} is not a {model_type} checkpoint: missing {missing[:5]} "
                       f"({len(missing)}), unexpected {unexpected[:5]} ({len(unexpected)}), "
                       f"shapes differ {wrong[:5]} ({len(wrong)})")
    save_params(model_type, sd, meta={"source_sha256": digest, "model_type": model_type})
    return load_params(model_type)


# -- training state (checkpoint/resume) ---------------------------------------

def write_train_state(path, model_sd: Dict, optimizer_sd: Dict, step: int) -> None:
    """Write a model's state dict, its optimizer's and the step to a
    temporary file, then rename it to ``path``."""
    _save_atomic({"model": model_sd, "optimizer": optimizer_sd, "step": int(step)}, pathlib.Path(path))


def read_train_state(path) -> Tuple[Dict, Dict, int]:
    """``write_train_state``'s (model state dict, optimizer state dict, step),
    read to the host."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    return saved["model"], saved["optimizer"], int(saved["step"])


def save_train_state(path, state) -> None:
    """Save a ``train.step.TrainState`` on one device (``write_train_state``)."""
    if state.mesh is not None:
        raise ValueError("a state sharded over a mesh is saved by train.step.save_sharded_train_state")
    write_train_state(path, state.model.state_dict(), state.optimizer.state_dict(), state.step)


def load_train_state(path, state):
    """Restore ``save_train_state``'s file into ``state`` (same model and
    optimizer layout), in place; returns ``state``. The file is read to the
    host: the loads copy each tensor to its parameter's device, and the
    optimizer keeps its step counts on the host, as it made them."""
    if state.mesh is not None:
        raise ValueError("a state sharded over a mesh is loaded by train.step.load_sharded_train_state")
    model_sd, optimizer_sd, step = read_train_state(path)
    state.model.load_state_dict(model_sd)
    state.optimizer.load_state_dict(optimizer_sd)
    state.step = step
    return state
