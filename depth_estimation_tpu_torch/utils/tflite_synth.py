"""Synthesize real-shape ``.tflite`` flatbuffers from the port's detector nets
(JAX ``utils/tflite_synth.py``).

No MediaPipe ``.tflite`` file is in the repository, so the import route is
proved on structurally real files: full-size weight tensors in TFLite
layouts, real buffer, tensor and operator-code tables, and an operator
stream in execution order with weightless ops interleaved. Pushed through
``import_weights --tflite`` → ``detect/weights.py`` → the detectors, they
take the path a real MediaPipe file takes.

The steps stay callable on a state dict that the caller already has:
``ordered_slots(net, shape, sd)`` → ``to_tflite_stream`` →
``serialize_tflite``; ``synthesize_model_file`` runs them on random
weights. ``serialize_tflite`` writes the flatbuffer by hand (the layout is
``utils/tflite.py``'s), front to back: every table after the one that
points to it, since a uoffset only points ahead.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from depth_estimation_tpu_torch.utils.tflite import _DTYPES, BUILTIN_OPS, TFLiteOp

_DTYPE_CODES = {np.dtype(t): code for code, t in _DTYPES.items()}
_OP_CODES = {name: code for code, name in BUILTIN_OPS.items()}
_BUFFER_ALIGN = 16  # the TFLite converter's alignment of buffer data


def fill_random(template: Mapping[str, torch.Tensor], rng) -> Dict[str, torch.Tensor]:
    """A state dict's shapes → standard-normal float32 tensors from ``rng`` (numpy)."""
    return {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32)) for k, v in template.items()}


def ordered_slots(net, input_shape, sd: Mapping[str, torch.Tensor]) -> List[Tuple[str, Dict[str, torch.Tensor]]]:
    """(module name, {"weight", "bias"} or {"alpha"} of ``sd``) for each weight
    layer of ``net`` in execution order (``convert.tflite_layer_order``)."""
    from depth_estimation_tpu_torch.utils.convert import tflite_layer_order

    return [(name, {leaf: sd[f"{name}.{leaf}"] for leaf in ("weight", "bias", "alpha") if f"{name}.{leaf}" in sd})
            for name in tflite_layer_order(net, input_shape)]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def to_tflite_stream(slots, interleave_noise: bool = True, extra_branch_layers: int = 0, rng=None):
    """Ordered layer slots → (ops, consts) in execution order, in the TFLite
    layouts that the converter undoes:

      conv (O, I, H, W) → (O, H, W, I);  depthwise (C, 1, H, W) → (1, H, W, C)
      linear (out, in) as it is;         PReLU alpha (C,) → (1, 1, C)

    ``interleave_noise`` puts a RESHAPE and an ADD (no weights) before every
    third layer. ``extra_branch_layers`` puts that many weight-bearing convs
    whose shapes match no slot in the middle of the stream: a stand-in for
    graph branches the port's net leaves out (the pose segmentation
    decoder), which ``allow_skips`` steps over."""
    ops: List[TFLiteOp] = []
    consts: Dict[int, np.ndarray] = {}
    nxt = [0]

    def add_const(arr):
        consts[nxt[0]] = np.ascontiguousarray(arr)
        nxt[0] += 1
        return nxt[0] - 1

    def add_act():  # an activation tensor: not in consts
        nxt[0] += 1
        return nxt[0] - 1

    for i, (_name, leaf) in enumerate(slots):
        if extra_branch_layers and i == len(slots) // 2:
            r = rng if rng is not None else np.random.default_rng(0)
            for j in range(extra_branch_layers):
                k = r.standard_normal((13 + j, 3, 3, 7)).astype(np.float32)  # prime channel counts
                bias = r.standard_normal((13 + j,)).astype(np.float32)
                ops.append(TFLiteOp("CONV_2D", [add_act(), add_const(k), add_const(bias)], [add_act()]))
        if interleave_noise and i % 3 == 0:
            ops.append(TFLiteOp("RESHAPE", [add_act(), add_const(np.array([1, -1], np.int32))], [add_act()]))
            ops.append(TFLiteOp("ADD", [add_act(), add_act()], [add_act()]))
        if "alpha" in leaf:
            ops.append(TFLiteOp("PRELU", [add_act(), add_const(_np(leaf["alpha"]).reshape(1, 1, -1))], [add_act()]))
            continue
        k = _np(leaf["weight"])
        if k.ndim == 2:
            op = "FULLY_CONNECTED"
        elif k.shape[1] == 1 and k.shape[0] > 1:
            op, k = "DEPTHWISE_CONV_2D", k.transpose(1, 2, 3, 0)
        else:
            op, k = "CONV_2D", k.transpose(0, 2, 3, 1)
        ops.append(TFLiteOp(op, [add_act(), add_const(k), add_const(_np(leaf["bias"]))], [add_act()]))
    return ops, consts


class _Table:
    """A table to write: {field id: (struct format, value)} scalars and
    {field id: child} offsets, the child a ``_Table``, a list of them, a
    numpy array (a vector of its items) or bytes."""

    def __init__(self, scalars=None, children=None):
        self.scalars, self.children = scalars or {}, children or {}


class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def pad_to(self, align: int, ahead: int = 0) -> None:
        """Pad so that the byte ``ahead`` bytes on starts at a multiple of ``align``."""
        self.buf += bytes(-(len(self.buf) + ahead) % align)

    def patch(self, at: int, target: int) -> None:
        struct.pack_into("<I", self.buf, at, target - at)

    def table(self, t: _Table) -> int:
        """Writes the vtable, then the table (4-byte fields first, each
        aligned to its size), then its children; returns the table's position."""
        fields = sorted([(fid, fmt, v) for fid, (fmt, v) in t.scalars.items()]
                        + [(fid, "I", None) for fid in t.children], key=lambda f: -struct.calcsize(f[1]))
        layout, size = {}, 4
        for fid, fmt, _v in fields:
            n = struct.calcsize(fmt)
            size += -size % n
            layout[fid] = size
            size += n
        size += -size % 4
        n_slots = max(layout, default=-1) + 1
        self.pad_to(4)
        vtable = len(self.buf)
        self.buf += struct.pack(f"<HH{n_slots}H", 4 + 2 * n_slots, size, *(layout.get(i, 0) for i in range(n_slots)))
        self.pad_to(4)
        pos = len(self.buf)
        body = bytearray(size)
        struct.pack_into("<i", body, 0, pos - vtable)
        for fid, fmt, v in fields:
            if v is not None:
                struct.pack_into("<" + fmt, body, layout[fid], v)
        self.buf += body
        for fid, child in t.children.items():
            self.patch(pos + layout[fid], self.child(child))
        return pos

    def child(self, c) -> int:
        if isinstance(c, _Table):
            return self.table(c)
        if isinstance(c, list):  # a vector of tables
            self.pad_to(4)
            at = len(self.buf)
            self.buf += struct.pack("<I", len(c)) + bytes(4 * len(c))
            for i, t in enumerate(c):
                self.patch(at + 4 + 4 * i, self.table(t))
            return at
        if isinstance(c, np.ndarray):  # a vector of scalars
            data, count, align = c.tobytes(), c.size, max(4, c.itemsize)
        else:  # buffer data
            data, count, align = bytes(c), len(c), _BUFFER_ALIGN
        self.pad_to(align, ahead=4)
        at = len(self.buf)
        self.buf += struct.pack("<I", count) + data
        return at


def serialize_tflite(ops, consts) -> bytes:
    """An (ops, consts) stream → a TFLite flatbuffer (file identifier
    ``TFL3``, schema version 3): buffer 0 empty and one buffer a constant,
    typed tensors (activations (1, 1) float32 on buffer 0), the operator-code
    table in order of first use (``builtin_code``, field 3) and one subgraph
    with the operator stream. ``read_tflite_ops`` reads it back."""
    n_tensors = max((t + 1 for op in ops for t in op.inputs + op.outputs), default=0)
    buffer_of = {tidx: i + 1 for i, tidx in enumerate(sorted(consts))}
    buffers = [_Table()] + [_Table(children={0: np.ascontiguousarray(consts[t]).tobytes()}) for t in sorted(consts)]
    tensors = []
    for tidx in range(n_tensors):
        if tidx in consts:
            arr = consts[tidx]
            shape, code, buf = arr.shape, _DTYPE_CODES[np.dtype(arr.dtype)], buffer_of[tidx]
        else:
            shape, code, buf = (1, 1), 0, 0
        tensors.append(_Table({1: ("b", code), 2: ("I", buf)}, {0: np.asarray(shape, "<i4")}))
    opcode_order = list(dict.fromkeys(op.op for op in ops))
    operators = [_Table({0: ("I", opcode_order.index(op.op))},
                        {1: np.asarray(op.inputs, "<i4"), 2: np.asarray(op.outputs, "<i4")}) for op in ops]
    model = _Table({0: ("I", 3)}, {
        1: [_Table({3: ("i", _OP_CODES[name])}) for name in opcode_order],
        2: [_Table(children={0: tensors, 3: operators})],
        4: buffers})
    w = _Writer()
    w.buf += bytes(4) + b"TFL3"
    w.patch(0, w.table(model))
    return bytes(w.buf)


def synthesize_model_file(net, input_shape, rng, extra_branch_layers: int = 0
                          ) -> Tuple[bytes, Dict[str, torch.Tensor]]:
    """→ (real-shape .tflite bytes, the random state dict the file encodes),
    the state dict being the conversion's oracle. ``input_shape`` is NCHW."""
    sd = fill_random(net.state_dict(), rng)
    ops, consts = to_tflite_stream(ordered_slots(net, input_shape, sd), interleave_noise=True,
                                   extra_branch_layers=extra_branch_layers, rng=rng)
    return serialize_tflite(ops, consts), sd
