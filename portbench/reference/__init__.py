"""The benchmark's plain reference: each network family in plain PyTorch,
one module a family, and the reference's frame transform (``frame.py``).
Imports nothing of the program under test, of JAX or of the JAX package.

A configuration names its family's module under ``"reference"``:
``reference/<name>.py``. That module exposes ``build(cfg)``, the network of
the configuration (its parameters and buffers on the current default
device; a program of several nets is one module that holds them all), and
may expose:

* ``upsampled_1x1(model)``: the 1x1 convolutions that run after an x2
  upsampling they commute with (``roofline.network_flops`` counts them
  before it);
* ``count_inputs(cfg)``: ``{submodule: input shape}``, one frame's input
  to each net the program runs (its leading size the net's runs a frame),
  which ``roofline.network_flops`` counts; without it, the whole model at
  (1, 3, *net_hw);
* ``outputs(model, frames_u8, cfg, given, tf32=False)``: ``{field:
  tensor}``, the reference's value of each field the program serves a
  frame, stacked over the frames. ``given`` is the program's own values of
  its fields for the same frames, or None where the reference makes its own
  choices (the control): a discrete choice of the program (a detection's
  validity, a crop box, an int landmark) is held fixed from it and what
  follows is recomputed from that choice, so that a rounding flip does not
  cascade; the choice is judged as a field of its own. Without it, the one
  field is the depth map (``frame.depth_maps``).

A new family arrives as a new module and a configuration file."""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict


def family(cfg: Dict) -> ModuleType:
    """The reference module that configuration ``cfg`` names."""
    return importlib.import_module(f"{__name__}.{cfg['reference']}")
