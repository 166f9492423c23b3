"""TFLite flatbuffer reader (JAX ``utils/tflite.py``): the weight tensors and
the operator stream of a ``.tflite`` file, walked by hand with ``struct``
and numpy, so that no ``flatbuffers`` package is needed.

The stable TFLite schema's field ids:

  Model:        version=0, operator_codes=1, subgraphs=2, description=3, buffers=4
  OperatorCode: deprecated_builtin_code=0, custom_code=1, version=2, builtin_code=3
  SubGraph:     tensors=0, inputs=1, outputs=2, operators=3, name=4
  Operator:     opcode_index=0, inputs=1, outputs=2
  Tensor:       shape=0, type=1, buffer=2, name=3
  Buffer:       data=0

The encoding, little-endian: the file opens with the root table's uoffset.
A table at ``pos`` starts with an int32 soffset to its vtable at ``pos -
soffset``; the vtable holds uint16s (its own size, the table's size, then
one slot per field), field k's slot at vtable offset 4 + 2k, 0 or past the
vtable's end meaning absent (the schema's default, 0 for every field read
here). A scalar field lies at ``pos + slot``; an offset field holds a uint32
that points that far ahead of itself to a vector (its uint32 length, then
its elements), a string (a byte vector) or a table. A vector of tables holds
one such uoffset an element.

``read_tflite_ops`` returns subgraph 0's operator stream in execution order
and its constant tensors (those whose buffer has data), which is what the
structural converters (``utils/convert.py``) key on; ``read_tflite_tensors``
the constant tensors of every subgraph by name.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np

# TensorType codes → numpy types
_DTYPES = {
    0: np.float32,
    1: np.float16,
    2: np.int32,
    3: np.uint8,
    4: np.int64,
    6: np.bool_,
    7: np.int16,
    9: np.int8,
    10: np.float64,
}

# TFLite BuiltinOperator codes (stable schema enum values); others read as OP_<n>
BUILTIN_OPS = {
    0: "ADD",
    2: "CONCATENATION",
    3: "CONV_2D",
    4: "DEPTHWISE_CONV_2D",
    9: "FULLY_CONNECTED",
    14: "LOGISTIC",
    17: "MAX_POOL_2D",
    22: "RESHAPE",
    23: "RESIZE_BILINEAR",
    34: "PAD",
    54: "PRELU",
    67: "TRANSPOSE_CONV",
    97: "RESIZE_NEAREST_NEIGHBOR",
}


class TFLiteOp:
    """One operator: builtin-op name + input/output tensor indices."""

    __slots__ = ("op", "inputs", "outputs")

    def __init__(self, op: str, inputs, outputs):
        self.op = op
        self.inputs = list(inputs)
        self.outputs = list(outputs)

    def __repr__(self):
        return f"TFLiteOp({self.op}, in={self.inputs}, out={self.outputs})"


class _Table:
    """A flatbuffer table at ``pos`` of ``buf``."""

    __slots__ = ("buf", "pos", "vtable", "vtable_size")

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        self.vtable = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vtable_size = struct.unpack_from("<H", buf, self.vtable)[0]

    def _slot(self, fid: int) -> int:
        """Field ``fid``'s offset inside the table, 0 if absent."""
        at = 4 + 2 * fid
        return struct.unpack_from("<H", self.buf, self.vtable + at)[0] if at < self.vtable_size else 0

    def scalar(self, fid: int, fmt: str) -> int:
        slot = self._slot(fid)
        return struct.unpack_from("<" + fmt, self.buf, self.pos + slot)[0] if slot else 0

    def _target(self, fid: int) -> Optional[int]:
        slot = self._slot(fid)
        if not slot:
            return None
        at = self.pos + slot
        return at + struct.unpack_from("<I", self.buf, at)[0]

    def _vector(self, fid: int, itemsize: int):
        """(start of the elements, count), (0, 0) if absent."""
        at = self._target(fid)
        if at is None:
            return 0, 0
        n = struct.unpack_from("<I", self.buf, at)[0]
        if at + 4 + n * itemsize > len(self.buf):
            raise ValueError(f"a vector of {n} items at byte {at} runs past the end ({len(self.buf)} bytes)")
        return at + 4, n

    def tables(self, fid: int) -> List["_Table"]:
        start, n = self._vector(fid, 4)
        return [_Table(self.buf, p + struct.unpack_from("<I", self.buf, p)[0])
                for p in range(start, start + 4 * n, 4)]

    def int32s(self, fid: int) -> List[int]:
        start, n = self._vector(fid, 4)
        return list(struct.unpack_from(f"<{n}i", self.buf, start))

    def raw(self, fid: int) -> bytes:
        start, n = self._vector(fid, 1)
        return bytes(self.buf[start:start + n])

    def string(self, fid: int) -> str:
        return self.raw(fid).decode()


def _parse_model(data: bytes):
    """→ (model table, each buffer's bytes, each operator code's name)."""
    model = _Table(data, struct.unpack_from("<I", data, 0)[0])
    buffers = [b.raw(0) for b in model.tables(4)]
    # builtin_code (field 3, int32) where present, else the deprecated int8 field 0 (older converters)
    opcodes = []
    for oc in model.tables(1):
        code = oc.scalar(3, "i") if oc._slot(3) else oc.scalar(0, "b")
        opcodes.append(BUILTIN_OPS.get(code, f"OP_{code}"))
    return model, buffers, opcodes


def _parse_tensor(t: _Table, buffers):
    """→ (name, shape, dtype, const array or None)."""
    buf_idx = t.scalar(2, "I")
    raw = buffers[buf_idx] if buf_idx < len(buffers) else b""
    shape = t.int32s(0)
    dtype = _DTYPES.get(t.scalar(1, "b"))
    arr = None
    if raw and dtype is not None:
        arr = np.frombuffer(raw, dtype=dtype)
        if shape:
            arr = arr.reshape(shape)
    return t.string(3), shape, dtype, arr


def _ops(data: bytes):
    model, buffers, opcodes = _parse_model(data)
    sg = model.tables(2)[0]
    consts: Dict[int, np.ndarray] = {}
    names: Dict[int, str] = {}
    for ti, t in enumerate(sg.tables(0)):
        names[ti], _shape, _dtype, arr = _parse_tensor(t, buffers)
        if arr is not None:
            consts[ti] = arr
    ops = []
    for o in sg.tables(3):
        idx = o.scalar(0, "I")
        ops.append(TFLiteOp(opcodes[idx] if idx < len(opcodes) else "OP_?", o.int32s(1), o.int32s(2)))
    return ops, consts, names


def _tensors(data: bytes) -> Dict[str, np.ndarray]:
    model, buffers, _opcodes = _parse_model(data)
    out: Dict[str, np.ndarray] = {}
    for si, sg in enumerate(model.tables(2)):
        for ti, t in enumerate(sg.tables(0)):
            name, _shape, _dtype, arr = _parse_tensor(t, buffers)
            if arr is not None:  # activations and unsupported types have none
                out[name or f"tensor_{si}_{ti}"] = arr
    return out


def _read(path, parse):
    """``parse`` on the file's bytes; a malformed file (an offset or a vector
    out of bounds, a size that does not fit its shape) raises ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return parse(data)
    except (struct.error, IndexError, ValueError) as e:
        raise ValueError(f"{path} is not a readable TFLite flatbuffer: {e}") from e


def read_tflite_ops(path):
    """→ (ops: list[TFLiteOp] in execution order, consts: {tensor index:
    array}, names: {tensor index: name}) for subgraph 0."""
    return _read(path, _ops)


def read_tflite_tensors(path) -> Dict[str, np.ndarray]:
    """{tensor name: weights} for every constant tensor of the model."""
    return _read(path, _tensors)
