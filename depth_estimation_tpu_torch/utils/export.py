"""Serialized frame programs on ``torch.export`` (JAX ``utils/export.py``).

The JAX package deploys an ahead-of-time artifact: ``jax.export`` serializes
a whole frame program (u8 BGR→RGB, /255, cubic resize, normalize, forward,
bicubic upsample) as StableHLO that a serving process reloads without the
package's model code. The port exports the same programs with
``torch.export`` and saves them as a ``.pt2`` archive.

* The weights stay an argument: the exported graph takes the state dicts as
  inputs (the nets run through ``torch.func.functional_call``), so one
  artifact serves any checkpoint of the same architecture. The archive is
  saved without the example inputs that ``torch.export`` keeps, which would
  be the weights.
* The kernels are the operators ``torch.ops.depth_tpu_torch.*``
  (``ops/kernels``): a loaded program calls them as the live one does, and
  they count their launches. Where JAX's StableHLO needs only ``jax`` to
  load, the ``.pt2`` needs the port's operator registrations, i.e.
  ``import depth_estimation_tpu_torch.ops.kernels`` (this module imports
  it), and nothing of the models.
* Numerics are process flags, not graph: the live f32 program runs matmuls
  and convolutions without TF32 (``device.full_f32``) and picks cuDNN's
  algorithms by timing (``device.conv_algorithms_by_timing``). The archive
  carries a record (the ``extra_files`` entry ``RECORD``: kind, model type,
  in_hw, dtype, batched, batch, device type, format, the state dicts' keys)
  and the loaded callable enters the same flags as the live program.
* No ``platforms=`` argument: the port has one CUDA target and the CPU's
  plain path. A program runs on the device type it was exported on, and the
  loaded callable raises for tensors on another.

Usage:
    blob = export_frame_program(est, (480, 640))
    pathlib.Path("dpt_480x640.pt2").write_bytes(blob)
    # serving side:
    fn = load_frame_program("dpt_480x640.pt2")
    depth = fn(est.params, bgr_u8_frame)

CLI: ``python -m depth_estimation_tpu_torch.tools.export_program --model-type
DPT_Large --hw 480 640 --out dpt.pt2`` (``depth-export-torch``).
"""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

import depth_estimation_tpu_torch.ops.kernels  # noqa: F401  (registers the operators the graphs call)
from depth_estimation_tpu_torch.device import conv_algorithms_by_timing, full_f32

RECORD = "depth_estimation_tpu_torch.json"
FORMAT = 1


class _Call(torch.nn.Module):
    """A module whose forward is ``fn``. As the root that ``torch.export``
    traces it is given no nets, so their weights enter the graph only as
    inputs; the fused program's nets sit under one such module, so that one
    ``functional_call`` swaps all their weights for the inputs."""

    def __init__(self, fn, **nets):
        super().__init__()
        self.fn = fn
        if nets:
            self.nets = torch.nn.ModuleDict(nets)

    def forward(self, *args):
        return self.fn(*args)


def _export(fn, args: Sequence, record: dict) -> bytes:
    program = torch.export.export(_Call(fn), tuple(args), strict=False)
    program.example_inputs = None  # they hold the weights
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={RECORD: json.dumps(record)})
    return buf.getvalue()


def _record(kind: str, estimator, in_hw, param_keys, **extra) -> dict:
    return {"format": FORMAT, "kind": kind, "model_type": estimator.model_type, "in_hw": [int(n) for n in in_hw],
            "dtype": str(estimator.dtype).removeprefix("torch."), "device": estimator.device.type,
            "params": [list(keys) for keys in param_keys], **extra}


def export_frame_program(estimator, in_hw: Tuple[int, int], batched: bool = False, batch: int = 1) -> bytes:
    """The estimator's frame program for ``in_hw`` (``frame_fn``), or with
    ``batched=True`` its (``batch``, H, W, 3) program (``batched_frame_fn``),
    as ``.pt2`` bytes. The loaded callable is fn(params, img) → (H, W) or
    (B, H, W) float32."""
    in_hw = (int(in_hw[0]), int(in_hw[1]))
    params = dict(estimator.params)  # a plain dict, as the loaded program passes them
    shape = (int(batch), *in_hw, 3) if batched else (*in_hw, 3)
    img = torch.zeros(shape, dtype=torch.uint8, device=estimator.device)
    fn = estimator.batched_frame_fn(in_hw) if batched else estimator.frame_fn(in_hw)
    record = _record("frame", estimator, in_hw, [params], batched=bool(batched),
                     batch=int(batch) if batched else 1, full_f32=estimator.dtype == torch.float32)
    return _export(fn, (params, img), record)


def export_fused_program(estimator, detector, in_hw: Tuple[int, int], include_pose: bool = True) -> bytes:
    """The fused iris/pose + depth program (``runtime/fused.py::
    make_fused_iris_frame_fn`` at B = 1, ``emit_depth_map=False``) as
    ``.pt2`` bytes: depth, BlazeFace, FaceMesh+iris, the BlazePose fallback,
    the output frame and the depth samples. The loaded callable takes
    (depth_params, face_params, mesh_params[, pose_params], img_u8 (H, W, 3),
    fallback_pts (2, 2) int32) and returns one frame's output dict."""
    from depth_estimation_tpu_torch.runtime.fused import make_fused_iris_frame_fn

    in_hw = (int(in_hw[0]), int(in_hw[1]))
    live = make_fused_iris_frame_fn(estimator, detector, in_hw, include_pose=include_pose, emit_depth_map=False)
    nets = {"depth": estimator.model, "face": detector._face_det, "mesh": detector._mesh}
    if include_pose:
        nets["pose"] = detector._pose
    root = _Call(live, **nets)
    names = list(nets)

    def fused(*args):
        *groups, img, pts = args
        params = {f"nets.{name}.{k}": v for name, sd in zip(names, groups) for k, v in sd.items()}
        out = functional_call(root, params, (img[None], pts[None]))
        return {k: v[0] for k, v in out.items()}

    states = [dict(net.state_dict()) for net in nets.values()]
    img = torch.zeros((*in_hw, 3), dtype=torch.uint8, device=estimator.device)
    pts = torch.zeros((2, 2), dtype=torch.int32, device=estimator.device)
    record = _record("fused", estimator, in_hw, states, include_pose=bool(include_pose), batched=False, batch=1,
                     full_f32=True)
    return _export(fused, (*states, img, pts), record)


class FrameProgram:
    """A loaded program. Call it as the exported function: state dicts
    first (tensors on the program's device type, or numpy arrays), then the
    frame and, for the fused program, the fallback points (tensors or numpy
    arrays). It runs in inference mode under the live program's numerics."""

    def __init__(self, exported: torch.export.ExportedProgram, record: Mapping):
        self.exported = exported
        self.record = dict(record)
        self.device = torch.device(self.record["device"])
        self._module = exported.module()

    def _tensor(self, value) -> torch.Tensor:
        if not isinstance(value, torch.Tensor):
            return torch.from_numpy(np.ascontiguousarray(value)).to(self.device)
        if value.device.type != self.device.type:
            raise ValueError(f"a tensor on {value.device} given to a program exported for {self.device.type}")
        return value

    def __call__(self, *args):
        keys = self.record["params"]
        if len(args) != len(keys) + (2 if self.record["kind"] == "fused" else 1):
            raise TypeError(f"the {self.record['kind']} program takes {len(keys)} state dicts and its inputs; "
                            f"got {len(args)} arguments")
        states = [{k: self._tensor(sd[k]) for k in names} for sd, names in zip(args, keys)]
        inputs = [self._tensor(a) for a in args[len(keys):]]
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.inference_mode())
            stack.enter_context(conv_algorithms_by_timing())
            if self.record["full_f32"]:
                stack.enter_context(full_f32())
            return self._module(*states, *inputs)


def load_frame_program(blob_or_path) -> FrameProgram:
    """bytes or path of an exported program → its callable (``FrameProgram``)."""
    extra: Dict[str, str] = {RECORD: ""}
    src = blob_or_path if isinstance(blob_or_path, (str, pathlib.Path)) else io.BytesIO(bytes(blob_or_path))
    exported = torch.export.load(src, extra_files=extra)
    if not extra[RECORD]:
        raise ValueError("not a program exported by depth_estimation_tpu_torch.utils.export: no record")
    record = json.loads(extra[RECORD])
    if record.get("format") != FORMAT:
        raise ValueError(f"program format {record.get('format')}, this loader reads {FORMAT}")
    return FrameProgram(exported, record)
