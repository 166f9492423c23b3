"""Model registry: name string → (module factory, preprocess config).

Names match the reference (depth_midas.py:10-16) and the JAX package's
registry. The port's modules keep the torch-hub state-dict key names, so a
hub checkpoint loads as ``DepthEstimator(params=...)`` and no converter is
needed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from depth_estimation_tpu_torch.config import DPT_PREPROCESS, SMALL_PREPROCESS, PreprocessConfig


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    name: str
    make_model: Callable
    preprocess: PreprocessConfig


def _make_dpt_large():
    from depth_estimation_tpu_torch.models.dpt import DPT, DPT_LARGE

    return DPT(DPT_LARGE)


def _make_dpt_hybrid():
    from depth_estimation_tpu_torch.models.dpt import DPT, DPT_HYBRID

    return DPT(DPT_HYBRID)


def _make_midas_small():
    from depth_estimation_tpu_torch.models.midas_small import MidasSmall

    return MidasSmall()


def _make_midas_v21():
    from depth_estimation_tpu_torch.models.midas_v21 import MIDAS_V21, MidasV21

    return MidasV21(MIDAS_V21)


_REGISTRY: Dict[str, ModelEntry] = {
    "DPT_Large": ModelEntry("DPT_Large", _make_dpt_large, DPT_PREPROCESS),
    "DPT_Hybrid": ModelEntry("DPT_Hybrid", _make_dpt_hybrid, DPT_PREPROCESS),
    "MiDaS_small": ModelEntry("MiDaS_small", _make_midas_small, SMALL_PREPROCESS),
    # the reference's non-DPT branch gives "MiDaS" small_transform too
    "MiDaS": ModelEntry("MiDaS", _make_midas_v21, SMALL_PREPROCESS),
}


def get_entry(model_type: str) -> ModelEntry:
    try:
        return _REGISTRY[model_type]
    except KeyError:
        raise ValueError(
            f"unknown model_type {model_type!r}; available: {sorted(_REGISTRY)}"
        ) from None


def available_models():
    return sorted(_REGISTRY)


def register(entry: ModelEntry) -> None:
    _REGISTRY[entry.name] = entry
