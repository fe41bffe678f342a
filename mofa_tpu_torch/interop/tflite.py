"""TFLite graphs read without TensorFlow and compiled to PyTorch modules.

Counterpart of mofa_tpu/interop/tflite_jax.py. The mediapipe face models
(BlazeFace, the 478-point landmarker, the blendshape MLP-mixer) ship as
.tflite flatbuffers inside a .task zip; this module runs them on a CUDA
device (or the CPU) without TensorFlow or the `flatbuffers` package:

- `_Table` reads the flatbuffer wire format (little-endian; a table's
  soffset to its vtable, the vtable's u16 field offsets, u32 forward
  offsets to tables, vectors and strings) for the part of TensorFlow's
  schema (tensorflow/lite/schema/schema.fbs) that `from_bytes` needs:
  Model (operator_codes, subgraphs[0], buffers), Tensor (shape, type,
  buffer), Operator (opcode_index, inputs, outputs, the builtin options
  union), OperatorCode (builtin_code, else deprecated_builtin_code) and
  the option tables of the op vocabulary. Field slots are the schema's.
  A buffer whose bytes lie outside the flatbuffer (its `offset` / `size`
  pointing past the flatbuffer into the file, as in models over 2 GB) is
  read from the file at that offset, or refused with an error that names
  it when the file is shorter; a tensor in an external buffer group is
  refused too.
- `TFLiteGraph`: the parsed subgraph, as in the JAX package (fp16
  constants behind DEQUANTIZE folded to fp32); `save_npz` / `load_npz`
  write and read exactly the JAX package's npz format, so a graph parsed
  by either package loads in the other.
- `compile_tflite(graph, device)` -> `TFLiteModule`, an `nn.Module` whose
  floating constants are its buffers on `device` (conv kernels laid out
  for `F.conv2d`: OHWI -> OIHW, depthwise [1, H, W, C*m] -> [C*m, 1, H,
  W]); its forward walks the op list in NHWC as the interpreter does:
  SAME padding applied as an explicit (asymmetric) pad before the conv or
  max-pool (-inf for the pool), fused activations, PRELU broadcasting,
  STRIDED_SLICE's masks, MEAN / SUM. An op outside the vocabulary raises
  NotImplementedError naming it.

fp32 only; quantized (int8) graphs are out of scope, as in the JAX
package.
"""

from __future__ import annotations

import json
import struct
import zipfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

_PAD_SAME, _PAD_VALID = 0, 1
_ACT = {0: None, 1: "relu", 2: "relu_n1to1", 3: "relu6", 4: "tanh"}
_DTYPES = {0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8,
           4: np.int64, 6: np.bool_, 7: np.int16, 9: np.int8}

# schema.fbs `enum BuiltinOperator : int32`, values 0..209 in order
BUILTIN_OPERATORS = tuple("""
ADD AVERAGE_POOL_2D CONCATENATION CONV_2D DEPTHWISE_CONV_2D DEPTH_TO_SPACE
DEQUANTIZE EMBEDDING_LOOKUP FLOOR FULLY_CONNECTED HASHTABLE_LOOKUP
L2_NORMALIZATION L2_POOL_2D LOCAL_RESPONSE_NORMALIZATION LOGISTIC
LSH_PROJECTION LSTM MAX_POOL_2D MUL RELU RELU_N1_TO_1 RELU6 RESHAPE
RESIZE_BILINEAR RNN SOFTMAX SPACE_TO_DEPTH SVDF TANH CONCAT_EMBEDDINGS
SKIP_GRAM CALL CUSTOM EMBEDDING_LOOKUP_SPARSE PAD UNIDIRECTIONAL_SEQUENCE_RNN
GATHER BATCH_TO_SPACE_ND SPACE_TO_BATCH_ND TRANSPOSE MEAN SUB DIV SQUEEZE
UNIDIRECTIONAL_SEQUENCE_LSTM STRIDED_SLICE BIDIRECTIONAL_SEQUENCE_RNN EXP
TOPK_V2 SPLIT LOG_SOFTMAX DELEGATE BIDIRECTIONAL_SEQUENCE_LSTM CAST PRELU
MAXIMUM ARG_MAX MINIMUM LESS NEG PADV2 GREATER GREATER_EQUAL LESS_EQUAL
SELECT SLICE SIN TRANSPOSE_CONV SPARSE_TO_DENSE TILE EXPAND_DIMS EQUAL
NOT_EQUAL LOG SUM SQRT RSQRT SHAPE POW ARG_MIN FAKE_QUANT REDUCE_PROD
REDUCE_MAX PACK LOGICAL_OR ONE_HOT LOGICAL_AND LOGICAL_NOT UNPACK REDUCE_MIN
FLOOR_DIV REDUCE_ANY SQUARE ZEROS_LIKE FILL FLOOR_MOD RANGE
RESIZE_NEAREST_NEIGHBOR LEAKY_RELU SQUARED_DIFFERENCE MIRROR_PAD ABS SPLIT_V
UNIQUE CEIL REVERSE_V2 ADD_N GATHER_ND COS WHERE RANK ELU REVERSE_SEQUENCE
MATRIX_DIAG QUANTIZE MATRIX_SET_DIAG ROUND HARD_SWISH IF WHILE
NON_MAX_SUPPRESSION_V4 NON_MAX_SUPPRESSION_V5 SCATTER_ND SELECT_V2 DENSIFY
SEGMENT_SUM BATCH_MATMUL PLACEHOLDER_FOR_GREATER_OP_CODES CUMSUM CALL_ONCE
BROADCAST_TO RFFT2D CONV_3D IMAG REAL COMPLEX_ABS HASHTABLE HASHTABLE_FIND
HASHTABLE_IMPORT HASHTABLE_SIZE REDUCE_ALL CONV_3D_TRANSPOSE VAR_HANDLE
READ_VARIABLE ASSIGN_VARIABLE BROADCAST_ARGS RANDOM_STANDARD_NORMAL BUCKETIZE
RANDOM_UNIFORM MULTINOMIAL GELU DYNAMIC_UPDATE_SLICE RELU_0_TO_1
UNSORTED_SEGMENT_PROD UNSORTED_SEGMENT_MAX UNSORTED_SEGMENT_SUM ATAN2
UNSORTED_SEGMENT_MIN SIGN BITCAST BITWISE_XOR RIGHT_SHIFT STABLEHLO_LOGISTIC
STABLEHLO_ADD STABLEHLO_DIVIDE STABLEHLO_MULTIPLY STABLEHLO_MAXIMUM
STABLEHLO_RESHAPE STABLEHLO_CLAMP STABLEHLO_CONCATENATE
STABLEHLO_BROADCAST_IN_DIM STABLEHLO_CONVOLUTION STABLEHLO_SLICE
STABLEHLO_CUSTOM_CALL STABLEHLO_REDUCE STABLEHLO_ABS STABLEHLO_AND
STABLEHLO_COSINE STABLEHLO_EXPONENTIAL STABLEHLO_FLOOR STABLEHLO_LOG
STABLEHLO_MINIMUM STABLEHLO_NEGATE STABLEHLO_OR STABLEHLO_POWER
STABLEHLO_REMAINDER STABLEHLO_RSQRT STABLEHLO_SELECT STABLEHLO_SUBTRACT
STABLEHLO_TANH STABLEHLO_SCATTER STABLEHLO_COMPARE STABLEHLO_CONVERT
STABLEHLO_DYNAMIC_SLICE STABLEHLO_DYNAMIC_UPDATE_SLICE STABLEHLO_PAD
STABLEHLO_IOTA STABLEHLO_DOT_GENERAL STABLEHLO_REDUCE_WINDOW STABLEHLO_SORT
STABLEHLO_WHILE STABLEHLO_GATHER STABLEHLO_TRANSPOSE DILATE
STABLEHLO_RNG_BIT_GENERATOR REDUCE_WINDOW STABLEHLO_COMPOSITE
STABLEHLO_SHIFT_LEFT STABLEHLO_CBRT STABLEHLO_CASE
""".split())

# the ops the compiler lowers
VOCABULARY = frozenset({
    "CONV_2D", "DEPTHWISE_CONV_2D", "MAX_POOL_2D", "PAD", "RESHAPE", "CONCATENATION",
    "TRANSPOSE", "STRIDED_SLICE", "MEAN", "SUM", "ADD", "SUB", "MUL", "DIV", "PRELU",
    "RELU", "LOGISTIC", "NEG", "SQRT", "RSQRT", "SQUARED_DIFFERENCE"})

# the option tables read: schema.fbs `union BuiltinOptions` member -> its
# union code and its fields (slot, struct format, default) in slot order
_I8, _I32, _BOOL = "<b", "<i", "<?"
OPTION_TABLES = {
    "Conv2DOptions": (1, dict(padding=(0, _I8, 0), sw=(1, _I32, 0), sh=(2, _I32, 0),
                              act=(3, _I8, 0), dw=(4, _I32, 1), dh=(5, _I32, 1))),
    "DepthwiseConv2DOptions": (2, dict(padding=(0, _I8, 0), sw=(1, _I32, 0),
                                       sh=(2, _I32, 0), mult=(3, _I32, 0),
                                       act=(4, _I8, 0), dw=(5, _I32, 1),
                                       dh=(6, _I32, 1))),
    "Pool2DOptions": (5, dict(padding=(0, _I8, 0), sw=(1, _I32, 0), sh=(2, _I32, 0),
                              fw=(3, _I32, 0), fh=(4, _I32, 0), act=(5, _I8, 0))),
    "ConcatenationOptions": (10, dict(axis=(0, _I32, 0), act=(1, _I8, 0))),
    "AddOptions": (11, dict(act=(0, _I8, 0))),
    "ReshapeOptions": (17, dict(new_shape=(0, "vector", None))),
    "MulOptions": (21, dict(act=(0, _I8, 0))),
    "ReducerOptions": (27, dict(keep_dims=(0, _BOOL, False))),
    "SubOptions": (28, dict(act=(0, _I8, 0))),
    "DivOptions": (29, dict(act=(0, _I8, 0))),
    "StridedSliceOptions": (32, dict(begin_mask=(0, _I32, 0), end_mask=(1, _I32, 0),
                                     ellipsis_mask=(2, _I32, 0),
                                     new_axis_mask=(3, _I32, 0),
                                     shrink_axis_mask=(4, _I32, 0))),
}
OP_OPTIONS = {"CONV_2D": "Conv2DOptions", "DEPTHWISE_CONV_2D": "DepthwiseConv2DOptions",
              "MAX_POOL_2D": "Pool2DOptions", "CONCATENATION": "ConcatenationOptions",
              "ADD": "AddOptions", "SUB": "SubOptions", "MUL": "MulOptions",
              "DIV": "DivOptions", "RESHAPE": "ReshapeOptions", "MEAN": "ReducerOptions",
              "SUM": "ReducerOptions", "STRIDED_SLICE": "StridedSliceOptions"}


# ---------- the flatbuffer wire format ----------

class _Table:
    """One flatbuffer table at `pos` of `buf`."""

    __slots__ = ("buf", "pos", "vt", "vt_len")

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        self.vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt_len = struct.unpack_from("<H", buf, self.vt)[0]

    def _field(self, slot: int) -> int:
        """The field's offset inside the table, 0 when it is absent."""
        o = 4 + 2 * slot
        return struct.unpack_from("<H", self.buf, self.vt + o)[0] if o < self.vt_len else 0

    def scalar(self, slot: int, fmt: str, default):
        o = self._field(slot)
        return struct.unpack_from(fmt, self.buf, self.pos + o)[0] if o else default

    def _target(self, slot: int):
        o = self._field(slot)
        if not o:
            return None
        p = self.pos + o
        return p + struct.unpack_from("<I", self.buf, p)[0]

    def table(self, slot: int):
        p = self._target(slot)
        return None if p is None else _Table(self.buf, p)

    def vector(self, slot: int, fmt: str = "i"):
        """A vector of scalars as a list, None when absent."""
        p = self._target(slot)
        if p is None:
            return None
        n = struct.unpack_from("<I", self.buf, p)[0]
        return list(struct.unpack_from(f"<{n}{fmt}", self.buf, p + 4))

    def vector_bytes(self, slot: int):
        p = self._target(slot)
        if p is None:
            return None
        n = struct.unpack_from("<I", self.buf, p)[0]
        if p + 4 + n > len(self.buf):
            raise ValueError(f"flatbuffer vector at {p} runs past the end")
        return self.buf[p + 4:p + 4 + n]

    def tables(self, slot: int) -> list:
        p = self._target(slot)
        if p is None:
            return []
        n = struct.unpack_from("<I", self.buf, p)[0]
        out = []
        for i in range(n):
            q = p + 4 + 4 * i
            out.append(_Table(self.buf, q + struct.unpack_from("<I", self.buf, q)[0]))
        return out


def _options(op: _Table, name: str) -> Dict[str, Any]:
    """The op's builtin options as the JAX package's `from_bytes` keeps
    them (tflite_jax.py:90-119), the schema's defaults for absent fields."""
    kind = OP_OPTIONS.get(name)
    if kind is None:
        return {}
    code, fields = OPTION_TABLES[kind]
    utype = op.scalar(3, "<B", 0)
    if utype not in (0, code):
        raise ValueError(f"{name}: builtin_options_type {utype}, expected {code} ({kind})")
    t = op.table(4) if utype else None
    if name == "RESHAPE":
        shape = t.vector(0) if t is not None else None
        return {} if shape is None else dict(new_shape=[int(d) for d in shape])
    out = {}
    for key, (slot, fmt, default) in fields.items():
        v = t.scalar(slot, fmt, default) if t is not None else default
        out[key] = bool(v) if fmt == _BOOL else int(v)
    if name in ("MEAN", "SUM"):
        return dict(keep_dims=out["keep_dims"])
    return out


# ---------- the graph ----------

@dataclass
class _Op:
    name: str                      # builtin op name, e.g. "CONV_2D"
    inputs: List[int]              # tensor ids (-1 = absent optional input)
    outputs: List[int]
    options: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TFLiteGraph:
    """Parsed, TensorFlow-free representation of one tflite subgraph."""

    ops: List[_Op]
    shapes: Dict[int, Tuple[int, ...]]          # tensor id -> shape
    constants: Dict[int, np.ndarray]            # tensor id -> fp32 / int array
    inputs: List[int]
    outputs: List[int]

    @classmethod
    def from_bytes(cls, buf: bytes) -> "TFLiteGraph":
        """Parse a .tflite flatbuffer (the file's bytes)."""
        buf = bytes(buf)
        try:
            model = _Table(buf, struct.unpack_from("<I", buf, 0)[0])
            opcodes = []
            for oc in model.tables(1):
                code = oc.scalar(3, "<i", 0) or oc.scalar(0, "<b", 0)
                opcodes.append(BUILTIN_OPERATORS[code] if 0 <= code < len(BUILTIN_OPERATORS)
                               else f"BUILTIN_{code}")
            subgraphs = model.tables(2)
            if not subgraphs:
                raise ValueError("the model has no subgraph")
            sg, buffers = subgraphs[0], model.tables(4)
        except struct.error as e:
            raise ValueError(f"not a tflite flatbuffer: {e}") from None

        shapes, constants = {}, {}
        for tid, t in enumerate(sg.tables(0)):
            shape = t.vector(0)
            shapes[tid] = tuple(int(d) for d in (shape if shape is not None else []))
            if t.scalar(10, "<I", 0):
                raise ValueError(f"tensor {tid} lies in external buffer "
                                 f"{t.scalar(10, '<I', 0)}, which this reader does not read")
            data = _buffer_data(buf, buffers, t.scalar(2, "<I", 0), tid)
            if data is not None and len(data):
                ttype = t.scalar(1, "<b", 0)
                if ttype not in _DTYPES:
                    raise ValueError(f"tensor {tid}: tflite type {ttype} is not read")
                arr = np.frombuffer(bytes(data), dtype=_DTYPES[ttype]).copy()
                constants[tid] = arr.reshape(shapes[tid])

        ops: List[_Op] = []
        for op in sg.tables(3):
            name = opcodes[op.scalar(0, "<I", 0)]
            ops.append(_Op(name, [int(i) for i in op.vector(1) or []],
                           [int(i) for i in op.vector(2) or []], _options(op, name)))

        g = cls(ops=ops, shapes=shapes, constants=constants,
                inputs=[int(i) for i in sg.vector(1) or []],
                outputs=[int(i) for i in sg.vector(2) or []])
        g._fold_dequantize()
        return g

    @classmethod
    def from_path(cls, path: str) -> "TFLiteGraph":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    @classmethod
    def from_task(cls, task_path: str, member: str) -> "TFLiteGraph":
        """Load one .tflite member out of a mediapipe .task (zip) bundle."""
        with zipfile.ZipFile(task_path) as z:
            return cls.from_bytes(z.read(member))

    def _fold_dequantize(self) -> None:
        """Fold DEQUANTIZE(const fp16) -> const fp32; rewire activations."""
        alias: Dict[int, int] = {}
        kept: List[_Op] = []
        for op in self.ops:
            if op.name == "DEQUANTIZE":
                src, dst = op.inputs[0], op.outputs[0]
                if src in self.constants:
                    self.constants[dst] = self.constants[src].astype(np.float32)
                    continue
                alias[dst] = src  # activation dequant: passthrough (fp32 math)
                continue
            op.inputs = [alias.get(i, i) for i in op.inputs]
            kept.append(op)
        self.ops = kept
        self.outputs = [alias.get(i, i) for i in self.outputs]

    # ---------- the JAX package's npz format ----------

    def save_npz(self, path: str) -> None:
        meta = dict(
            ops=[dict(name=o.name, inputs=o.inputs, outputs=o.outputs,
                      options=o.options) for o in self.ops],
            shapes={str(k): list(v) for k, v in self.shapes.items()},
            inputs=self.inputs, outputs=self.outputs)
        arrays = {f"t{k}": v for k, v in self.constants.items()}
        np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)

    @classmethod
    def load_npz(cls, path: str) -> "TFLiteGraph":
        z = np.load(path, allow_pickle=False)
        meta = json.loads(str(z["__meta__"]))
        return cls(
            ops=[_Op(d["name"], d["inputs"], d["outputs"], d["options"])
                 for d in meta["ops"]],
            shapes={int(k): tuple(v) for k, v in meta["shapes"].items()},
            constants={int(k[1:]): z[k] for k in z.files if k != "__meta__"},
            inputs=meta["inputs"], outputs=meta["outputs"])


def _buffer_data(buf: bytes, buffers: list, index: int, tid: int):
    """Buffer `index`'s bytes: its `data` vector, else the `size` bytes at
    file offset `offset` (set past 1 when the data lies outside the
    flatbuffer); None when the buffer holds nothing."""
    if index >= len(buffers):
        raise ValueError(f"tensor {tid} names buffer {index} of {len(buffers)}")
    b = buffers[index]
    data = b.vector_bytes(0)
    if data is not None and len(data):
        return data
    offset, size = b.scalar(1, "<Q", 0), b.scalar(2, "<Q", 0)
    if offset > 1 and size > 0:
        if offset + size > len(buf):
            raise ValueError(f"tensor {tid}: buffer {index} lies at bytes "
                             f"[{offset}, {offset + size}) outside the {len(buf)}-byte file")
        return buf[offset:offset + size]
    return data


# ---------- op lowering ----------

def _act(x, code):
    kind = _ACT[code]
    if kind is None:
        return x
    if kind == "relu":
        return torch.clamp_min(x, 0)
    if kind == "relu6":
        return torch.clamp(x, 0, 6)
    if kind == "relu_n1to1":
        return torch.clamp(x, -1, 1)
    return torch.tanh(x)


def _same_pads(in_size, stride, eff_k):
    out = -(-in_size // stride)
    total = max(0, (out - 1) * stride + eff_k - in_size)
    return (total // 2, total - total // 2)


def _pads(x, o, kh, kw, dh=1, dw=1):
    """F.pad's (left, right, top, bottom) of an NHWC input for the op's
    padding (SAME: tflite's split, the odd pixel after)."""
    if o["padding"] != _PAD_SAME:
        return (0, 0, 0, 0)
    top = _same_pads(x.shape[1], o["sh"], (kh - 1) * dh + 1)
    left = _same_pads(x.shape[2], o["sw"], (kw - 1) * dw + 1)
    return left + top


def _conv2d(x, w, b, o, groups: int = 1):
    """NHWC x, torch-layout w ([O, I/groups, kh, kw]) -> NHWC."""
    kh, kw = w.shape[2], w.shape[3]
    xc = F.pad(x.permute(0, 3, 1, 2), _pads(x, o, kh, kw, o["dh"], o["dw"]))
    y = F.conv2d(xc, w, b, stride=(o["sh"], o["sw"]), dilation=(o["dh"], o["dw"]),
                 groups=groups)
    return _act(y.permute(0, 2, 3, 1), o["act"])


def _maxpool(x, o):
    xc = F.pad(x.permute(0, 3, 1, 2), _pads(x, o, o["fh"], o["fw"]), value=-float("inf"))
    y = F.max_pool2d(xc, (o["fh"], o["fw"]), (o["sh"], o["sw"]))
    return _act(y.permute(0, 2, 3, 1), o["act"])


def _strided_slice(x, begin, end, strides, o):
    if o["ellipsis_mask"] or o["new_axis_mask"]:
        raise NotImplementedError(
            "STRIDED_SLICE with an ellipsis or new-axis mask is not in the op vocabulary")
    out, dim = x, 0
    for d in range(x.ndim):
        if (o["shrink_axis_mask"] >> d) & 1:
            out = out.select(dim, int(begin[d]))
            continue
        b = None if (o["begin_mask"] >> d) & 1 else int(begin[d])
        e = None if (o["end_mask"] >> d) & 1 else int(end[d])
        s = int(strides[d])
        if s > 0:
            out = out[(slice(None),) * dim + (slice(b, e, s),)]
        else:        # numpy's negative-step slice, as an index gather
            idx = list(range(*slice(b, e, s).indices(out.shape[dim])))
            out = out.index_select(dim, torch.tensor(idx, dtype=torch.long,
                                                     device=out.device))
        dim += 1
    return out


class TFLiteModule(nn.Module):
    """A compiled tflite subgraph: `forward(*inputs) -> [outputs]`, NHWC
    tensors on the module's device. Floating constants are buffers (`t<id>`;
    conv kernels `w<id>` in F.conv2d's layout); shape, axis, pad and slice
    constants stay host arrays read at each call."""

    def __init__(self, graph: TFLiteGraph):
        super().__init__()
        unknown = sorted({op.name for op in graph.ops} - VOCABULARY)
        if unknown:
            raise NotImplementedError(f"tflite op {', '.join(unknown)}")
        self.graph = graph
        layouts = {}
        for op in graph.ops:
            if op.name in ("CONV_2D", "DEPTHWISE_CONV_2D"):
                layouts[op.inputs[1]] = op.name
        for tid, v in graph.constants.items():
            if not np.issubdtype(v.dtype, np.floating):
                continue
            t = torch.from_numpy(np.array(v))
            if layouts.get(tid) == "CONV_2D":            # OHWI -> OIHW
                self.register_buffer(f"w{tid}", t.permute(0, 3, 1, 2).contiguous())
            elif layouts.get(tid) == "DEPTHWISE_CONV_2D":  # [1,H,W,C*m] -> [C*m,1,H,W]
                self.register_buffer(f"w{tid}", t[0].permute(2, 0, 1)[:, None].contiguous())
            else:
                self.register_buffer(f"t{tid}", t)
        self.static = {k: v for k, v in graph.constants.items()
                       if not np.issubdtype(v.dtype, np.floating)}

    def _host(self, tid: int) -> np.ndarray:
        return np.asarray(self.graph.constants[tid])

    @torch.no_grad()
    def forward(self, *inputs):
        g = self.graph
        env: Dict[int, Any] = {}
        for name, t in self.named_buffers():
            if name[0] == "t":
                env[int(name[1:])] = t
        env.update(self.static)
        for tid, x in zip(g.inputs, inputs):
            env[tid] = x

        def get(i):
            return env[i] if i >= 0 else None

        def bias(i):
            return get(i[2]) if len(i) > 2 else None

        for op in g.ops:
            i, o = op.inputs, op.options
            if op.name == "CONV_2D":
                y = _conv2d(get(i[0]), getattr(self, f"w{i[1]}"), bias(i), o)
            elif op.name == "DEPTHWISE_CONV_2D":
                x = get(i[0])
                y = _conv2d(x, getattr(self, f"w{i[1]}"), bias(i), o, groups=x.shape[-1])
            elif op.name == "MAX_POOL_2D":
                y = _maxpool(get(i[0]), o)
            elif op.name == "PAD":
                pads = self._host(i[1]).tolist()
                y = F.pad(get(i[0]), [int(p) for pair in reversed(pads) for p in pair])
            elif op.name == "RESHAPE":
                shape = o.get("new_shape") or self._host(i[1]).tolist()
                y = torch.reshape(get(i[0]), [int(d) for d in shape])
            elif op.name == "CONCATENATION":
                y = _act(torch.cat([get(t) for t in i], dim=o["axis"]), o["act"])
            elif op.name == "TRANSPOSE":
                y = get(i[0]).permute(*[int(d) for d in self._host(i[1]).tolist()])
            elif op.name == "STRIDED_SLICE":
                y = _strided_slice(get(i[0]), self._host(i[1]), self._host(i[2]),
                                   self._host(i[3]), o)
            elif op.name in ("MEAN", "SUM"):
                axes = [int(a) for a in np.atleast_1d(self._host(i[1])).tolist()]
                red = torch.mean if op.name == "MEAN" else torch.sum
                y = red(get(i[0]), dim=axes, keepdim=o["keep_dims"])
            elif op.name == "ADD":
                y = _act(get(i[0]) + get(i[1]), o["act"])
            elif op.name == "SUB":
                y = _act(get(i[0]) - get(i[1]), o["act"])
            elif op.name == "MUL":
                y = _act(get(i[0]) * get(i[1]), o["act"])
            elif op.name == "DIV":
                y = _act(get(i[0]) / get(i[1]), o["act"])
            elif op.name == "PRELU":
                x, a = get(i[0]), get(i[1])
                y = torch.where(x >= 0, x, x * a)
            elif op.name == "RELU":
                y = torch.clamp_min(get(i[0]), 0)
            elif op.name == "LOGISTIC":
                y = torch.sigmoid(get(i[0]))
            elif op.name == "NEG":
                y = -get(i[0])
            elif op.name == "SQRT":
                y = torch.sqrt(get(i[0]))
            elif op.name == "RSQRT":
                y = torch.rsqrt(get(i[0]))
            elif op.name == "SQUARED_DIFFERENCE":
                y = torch.square(get(i[0]) - get(i[1]))
            else:
                raise NotImplementedError(f"tflite op {op.name}")
            env[op.outputs[0]] = y
        return [env[t] for t in g.outputs]


def compile_tflite(graph: TFLiteGraph, device="cuda") -> TFLiteModule:
    """graph -> TFLiteModule on `device` (its weights that device's tensors)."""
    return TFLiteModule(graph).to(device).eval()
