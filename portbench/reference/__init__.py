"""The benchmark's plain reference: each network family in plain PyTorch,
one module a family, and the reference's frame transform (``frame.py``).
Imports nothing of the program under test, of JAX or of the JAX package.

A configuration names its family's module under ``"reference"``:
``reference/<name>.py``. That module exposes ``build(cfg)``, the network of
the configuration (its parameters on the current default device), and may
expose ``upsampled_1x1(model)``, the 1x1 convolutions that run after an x2
upsampling they commute with (``roofline.network_flops`` counts them before
it). A new family arrives as a new module and a configuration file."""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict


def family(cfg: Dict) -> ModuleType:
    """The reference module that configuration ``cfg`` names."""
    return importlib.import_module(f"{__name__}.{cfg['reference']}")
