"""Detector weights loaded from the TFLite cache directory (JAX ``detect/weights.py``).

Drop the public MediaPipe model files (the ones mediapipe 0.8.11 bundles)
into ``~/.cache/depth_estimation_tpu_torch/tflite/`` (or
``$DEPTH_ESTIMATION_TPU_TORCH_CACHE/tflite/``), or stage them with
``python -m depth_estimation_tpu_torch.tools.import_weights --tflite FILE...``:

    face_detection_short_range.tflite   (or face_detection_front.tflite)
    face_landmark.tflite
    iris_landmark.tflite
    pose_detection.tflite
    pose_landmark_full.tflite           (or _lite / _heavy)

and ``PersonDetector`` / ``FaceDetector`` built without ``params`` take
them. Each file is converted structurally (``utils/convert.py``) on first
use, and the state dict is cached under ``detector_<key>`` with the source
files' content hashes, so that later constructions load it directly.
"""

from __future__ import annotations

import json
import warnings
from typing import Dict, Optional

import torch

from depth_estimation_tpu_torch.utils import checkpoint as ckpt

# params key → (candidate files in order of preference, a tuple where a net takes two; converter)
_SPECS = {
    "blazeface": (("face_detection_short_range.tflite", "face_detection_front.tflite"), "convert_blazeface_tflite"),
    "facemesh": ((("face_landmark.tflite", "iris_landmark.tflite"),), "convert_facemesh_tflite"),
    "blazepose_detector": (("pose_detection.tflite",), "convert_blazepose_detector_tflite"),
    "blazepose": (("pose_landmark_full.tflite", "pose_landmark_lite.tflite", "pose_landmark_heavy.tflite"),
                  "convert_blazepose_tflite"),
}


def tflite_dir():
    return ckpt.cache_dir() / "tflite"


def _convert_one(key: str) -> Optional[Dict[str, torch.Tensor]]:
    from depth_estimation_tpu_torch.utils import convert as cv

    names, fn_name = _SPECS[key]
    root = tflite_dir()
    for cand in names:
        paths = [root / c for c in (cand if isinstance(cand, tuple) else (cand,))]
        if not all(p.exists() for p in paths):
            continue
        digest = "+".join(ckpt.content_hash(p) for p in paths)
        cache_key = f"detector_{key}"
        meta_file = ckpt.cache_dir() / cache_key / "meta.json"
        if meta_file.exists() and json.loads(meta_file.read_text()).get("source_sha256") == digest:
            cached = ckpt.load_params(cache_key)
            if cached is not None:
                return cached
        try:
            sd = getattr(cv, fn_name)(*paths)
        except ValueError as e:
            # a structural mismatch (or a malformed file): the contract is to load what converts and leave
            # the rest to random weights, with a warning, not to fail the detector
            warnings.warn(f"TFLite conversion for {key!r} unavailable: {e}", stacklevel=2)
            return None
        ckpt.save_params(cache_key, sd, meta={"source_sha256": digest})
        return sd
    return None


def load_detector_params() -> Dict[str, Dict[str, torch.Tensor]]:
    """{params key: state dict} for every detector whose TFLite file(s) lie in
    the cache directory; {} when none do."""
    if not tflite_dir().exists():
        return {}
    out = {}
    for key in _SPECS:
        sd = _convert_one(key)
        if sd is not None:
            out[key] = sd
    return out
