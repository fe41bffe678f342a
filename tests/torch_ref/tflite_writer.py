"""A tflite flatbuffer writer in pure Python, and the synthetic face models.

No `flatbuffers` package and no TensorFlow: `chip_smoke.py` imports this
module on the card to write the synthetic mediapipe `.task` it runs, and
the port's tests write their graphs with it. The writer lays each object
out front to back (a table's vtable just before it, its children after
it, so every uoffset points forward as the wire format requires), with
scalars at their natural alignment and buffer data at 16 bytes. Field
slots and enum values are those of TensorFlow's schema
(tensorflow/lite/schema/schema.fbs); `tests/test_torch_tflite.py` reads
the bytes back with `tf.lite.Interpreter` in a child process.

The synthetic graphs have the published input and output shapes of the
mediapipe FaceLandmarker's three models (seeded weights, a MobileNet-like
body, fp16 weights behind DEQUANTIZE where the real files have them):

- `blazeface(rng)`: face_detector.tflite, BlazeFace short-range,
  [1, 128, 128, 3] -> regressors [1, 896, 16] and classificators
  [1, 896, 1] (two anchors a cell at 16^2, six at 8^2); the score and box
  heads carry planted biases so that the anchors of one kind pass the 0.5
  score threshold with boxes about `FACE_BOX` pixels wide;
- `landmarker(rng, canonical)`: face_landmarks_detector.tflite,
  [1, 256, 256, 3] -> [1, 1, 1, 1434] (478 x, y, z in crop pixels; the
  head's bias is the canonical face drawn into the crop) and the presence
  logit [1, 1, 1, 1] (bias +4);
- `blendshapes(rng)`: face_blendshapes.tflite, an MLP-mixer over
  [1, 146, 2] -> [52];
- `geometry_metadata(canonical, tris, weights)`: the
  GeometryPipelineMetadata protobuf (468 canonical xyzuv vertices, their
  triangles, the Procrustes weights);
- `write_task(path, seed)`: all four in a zip, as the .task bundle.

`every_op_graph(rng)` exercises each op of the compiler's vocabulary on a
small input; `width` / `depth` arguments shrink the face models (same
input and output shapes) for the CPU tests.
"""

from __future__ import annotations

import io
import struct
import zipfile

import numpy as np

# schema.fbs values
OPCODES = {"ADD": 0, "CONCATENATION": 2, "CONV_2D": 3, "DEPTHWISE_CONV_2D": 4,
           "DEQUANTIZE": 6, "LOGISTIC": 14, "MAX_POOL_2D": 17, "MUL": 18, "RELU": 19,
           "RESHAPE": 22, "PAD": 34, "TRANSPOSE": 39, "MEAN": 40, "SUB": 41, "DIV": 42,
           "STRIDED_SLICE": 45, "PRELU": 54, "NEG": 59, "SUM": 74, "SQRT": 75,
           "RSQRT": 76, "SQUARED_DIFFERENCE": 99, "TANH": 28}
TYPES = {np.dtype(np.float32): 0, np.dtype(np.float16): 1, np.dtype(np.int32): 2}
SAME, VALID = 0, 1
ACT = {None: 0, "relu": 1, "relu_n1to1": 2, "relu6": 3, "tanh": 4}
# op -> (union code, {option: (slot, struct format)})
OPTIONS = {
    "CONV_2D": (1, dict(padding=(0, "b"), sw=(1, "i"), sh=(2, "i"), act=(3, "b"),
                        dw=(4, "i"), dh=(5, "i"))),
    "DEPTHWISE_CONV_2D": (2, dict(padding=(0, "b"), sw=(1, "i"), sh=(2, "i"),
                                  mult=(3, "i"), act=(4, "b"), dw=(5, "i"), dh=(6, "i"))),
    "MAX_POOL_2D": (5, dict(padding=(0, "b"), sw=(1, "i"), sh=(2, "i"), fw=(3, "i"),
                            fh=(4, "i"), act=(5, "b"))),
    "CONCATENATION": (10, dict(axis=(0, "i"), act=(1, "b"))),
    "ADD": (11, dict(act=(0, "b"))),
    "RESHAPE": (17, dict(new_shape=(0, "vec"))),
    "MUL": (21, dict(act=(0, "b"))),
    "MEAN": (27, dict(keep_dims=(0, "?"))),
    "SUM": (27, dict(keep_dims=(0, "?"))),
    "SUB": (28, dict(act=(0, "b"))),
    "DIV": (29, dict(act=(0, "b"))),
    "STRIDED_SLICE": (32, dict(begin_mask=(0, "i"), end_mask=(1, "i"),
                               ellipsis_mask=(2, "i"), new_axis_mask=(3, "i"),
                               shrink_axis_mask=(4, "i"))),
}


# ---------------------------------------------------------------- wire format

class Table:
    """fields: [(slot, fmt, value)]; fmt a struct code ('b', 'B', 'i', 'I',
    'Q', '?') or 'off' (value another object)."""

    def __init__(self, fields):
        self.fields = [f for f in fields if f[2] is not None]


class Vec:
    def __init__(self, fmt, items):
        self.fmt, self.items = fmt, list(items)


class Bytes:
    def __init__(self, data: bytes):
        self.data = bytes(data)


class TableVec:
    def __init__(self, tables):
        self.tables = list(tables)


class String:
    def __init__(self, s: str):
        self.data = s.encode()


class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def pad(self, align: int, extra: int = 0) -> None:
        while (len(self.buf) + extra) % align:
            self.buf.append(0)

    def patch(self, at: int, target: int) -> None:
        assert target > at, "uoffsets point forward"
        struct.pack_into("<I", self.buf, at, target - at)

    def emit(self, obj) -> int:
        if isinstance(obj, Table):
            return self.table(obj)
        if isinstance(obj, Vec):
            size = struct.calcsize("<" + obj.fmt)
            self.pad(max(4, size), 4)
            pos = len(self.buf)
            self.buf += struct.pack(f"<I{len(obj.items)}{obj.fmt}", len(obj.items), *obj.items)
            return pos
        if isinstance(obj, Bytes):
            self.pad(16, 4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(obj.data)) + obj.data
            return pos
        if isinstance(obj, String):
            self.pad(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(obj.data)) + obj.data + b"\0"
            return pos
        if isinstance(obj, TableVec):
            self.pad(4)
            pos = len(self.buf)
            self.buf += struct.pack(f"<I{len(obj.tables)}I", len(obj.tables),
                                    *[0] * len(obj.tables))
            for k, t in enumerate(obj.tables):
                self.patch(pos + 4 + 4 * k, self.emit(t))
            return pos
        raise TypeError(obj)

    def table(self, t: Table) -> int:
        size = lambda fmt: 4 if fmt == "off" else struct.calcsize("<" + fmt)
        order = sorted(t.fields, key=lambda f: -size(f[1]))
        layout, off = {}, 4
        for slot, fmt, _ in order:
            s = size(fmt)
            off = -(-off // s) * s
            layout[slot] = off
            off += s
        inline = off
        nslots = max((f[0] for f in t.fields), default=-1) + 1
        self.pad(2)
        vt = len(self.buf)
        self.buf += struct.pack(f"<HH{nslots}H", 4 + 2 * nslots, inline,
                                *[layout.get(s, 0) for s in range(nslots)])
        self.pad(max([4] + [size(f[1]) for f in t.fields]))
        pos = len(self.buf)
        self.buf += bytes(inline)
        struct.pack_into("<i", self.buf, pos, pos - vt)
        children = []
        for slot, fmt, value in t.fields:
            if fmt == "off":
                children.append((pos + layout[slot], value))
            else:
                struct.pack_into("<" + fmt, self.buf, pos + layout[slot], value)
        for at, child in children:
            self.patch(at, self.emit(child))
        return pos


def flatbuffer(root: Table, identifier: bytes = b"TFL3") -> bytes:
    w = _Writer()
    w.buf += bytes(4) + identifier
    w.patch(0, w.emit(root))
    return bytes(w.buf)


# ---------------------------------------------------------------- graphs

class GraphBuilder:
    """One subgraph: tensors (with their buffers), ops, inputs, outputs."""

    def __init__(self):
        self.tensors = []          # (shape, dtype, buffer index, name)
        self.data = [b""]          # buffer 0: empty, as converters write it
        self.ops = []              # (name, inputs, outputs, options)

    def tensor(self, shape, dtype=np.float32, name=None) -> int:
        self.tensors.append((tuple(int(d) for d in shape), np.dtype(dtype), 0,
                             name or f"t{len(self.tensors)}"))
        return len(self.tensors) - 1

    def const(self, array, name=None) -> int:
        array = np.ascontiguousarray(array)
        self.data.append(array.tobytes())
        self.tensors.append((array.shape, array.dtype, len(self.data) - 1,
                             name or f"c{len(self.tensors)}"))
        return len(self.tensors) - 1

    def shape(self, tid):
        return self.tensors[tid][0]

    def op(self, name, inputs, out_shape, dtype=np.float32, **options) -> int:
        out = self.tensor(out_shape, dtype)
        self.ops.append((name, list(inputs), [out], options))
        return out

    def serialize(self, inputs, outputs, external: bool = False) -> bytes:
        """The .tflite bytes. With `external`, every constant's bytes follow
        the flatbuffer, its Buffer holding only `offset` / `size` (the
        layout of models over 2 GB)."""
        names = sorted({n for n, *_ in self.ops}, key=lambda n: OPCODES[n])
        index = {n: k for k, n in enumerate(names)}
        codes = [Table([(0, "b", min(OPCODES[n], 127)), (2, "i", 1), (3, "i", OPCODES[n])])
                 for n in names]
        tensors = [Table([(0, "off", Vec("i", shape)), (1, "b", TYPES[dtype]),
                          (2, "I", buf), (3, "off", String(name))])
                   for shape, dtype, buf, name in self.tensors]
        operators = []
        for name, ins, outs, opts in self.ops:
            fields = [(0, "I", index[name]), (1, "off", Vec("i", ins)),
                      (2, "off", Vec("i", outs))]
            if name in OPTIONS:
                code, spec = OPTIONS[name]
                sub = []
                for key, value in opts.items():
                    slot, fmt = spec[key]
                    sub.append((slot, "off", Vec("i", value)) if fmt == "vec"
                               else (slot, fmt, value))
                fields += [(3, "B", code), (4, "off", Table(sub))]
            operators.append(Table(fields))
        subgraph = Table([(0, "off", TableVec(tensors)), (1, "off", Vec("i", inputs)),
                          (2, "off", Vec("i", outputs)), (3, "off", TableVec(operators)),
                          (4, "off", String("main"))])

        def model(buffers):
            return Table([(0, "I", 3), (1, "off", TableVec(codes)),
                          (2, "off", TableVec([subgraph])),
                          (3, "off", String("synthetic")), (4, "off", TableVec(buffers))])

        if not external:
            return flatbuffer(model([Table([(0, "off", Bytes(d))]) if d else Table([])
                                     for d in self.data]))
        # lay the flatbuffer out once with placeholder offsets (same size),
        # then again with the data's real offsets past its end
        sizes = [len(d) for d in self.data]
        place = lambda offs: [Table([(1, "Q", o), (2, "Q", s)]) if s else Table([])
                              for o, s in zip(offs, sizes)]
        head = len(flatbuffer(model(place([2] * len(sizes)))))
        offs, pos = [], -(-head // 16) * 16
        for s in sizes:
            offs.append(pos if s else 0)
            pos = -(-(pos + s) // 16) * 16
        fb = flatbuffer(model(place(offs)))
        assert len(fb) == head
        out = bytearray(fb)
        for o, d in zip(offs, self.data):
            if d:
                out += bytes(o - len(out)) + d
        return bytes(out)


# ---------------------------------------------------------------- layers

def _out(n, k, s, padding, d=1):
    ek = (k - 1) * d + 1
    return -(-n // s) if padding == SAME else (n - ek) // s + 1


class Net:
    """Helpers that add layers to a GraphBuilder with seeded weights."""

    def __init__(self, rng, fp16_weights: bool = False):
        self.g, self.rng, self.fp16 = GraphBuilder(), rng, fp16_weights

    def weight(self, array):
        """A float constant; with fp16 weights, an fp16 constant behind
        DEQUANTIZE (the mediapipe files' layout)."""
        array = np.asarray(array, np.float32)
        if not self.fp16:
            return self.g.const(array)
        half = self.g.const(array.astype(np.float16))
        return self.g.op("DEQUANTIZE", [half], array.shape)

    def conv(self, x, cout, k, stride=1, padding=SAME, act=None, dilation=1,
             gain=1.0, bias=None):
        n, h, w, cin = self.g.shape(x)
        wt = self.rng.randn(cout, k, k, cin) * gain / np.sqrt(k * k * cin)
        b = self.rng.randn(cout) * 0.05 if bias is None else bias
        shape = (n, _out(h, k, stride, padding, dilation), _out(w, k, stride, padding, dilation),
                 cout)
        return self.g.op("CONV_2D", [x, self.weight(wt), self.weight(b)], shape,
                         padding=padding, sw=stride, sh=stride, act=ACT[act],
                         dw=dilation, dh=dilation)

    def dwconv(self, x, k, stride=1, padding=SAME, act=None, mult=1, dilation=1):
        n, h, w, c = self.g.shape(x)
        wt = self.rng.randn(1, k, k, c * mult) / k
        shape = (n, _out(h, k, stride, padding, dilation), _out(w, k, stride, padding, dilation),
                 c * mult)
        return self.g.op("DEPTHWISE_CONV_2D",
                         [x, self.weight(wt), self.weight(self.rng.randn(c * mult) * 0.05)],
                         shape, padding=padding, sw=stride, sh=stride, mult=mult,
                         act=ACT[act], dw=dilation, dh=dilation)

    def maxpool(self, x, k=2, stride=2, padding=VALID, act=None):
        n, h, w, c = self.g.shape(x)
        return self.g.op("MAX_POOL_2D", [x], (n, _out(h, k, stride, padding),
                                              _out(w, k, stride, padding), c),
                         padding=padding, sw=stride, sh=stride, fw=k, fh=k, act=ACT[act])

    def prelu(self, x):
        c = self.g.shape(x)[-1]
        a = self.weight((0.25 + 0.05 * self.rng.randn(1, 1, c)))
        return self.g.op("PRELU", [x, a], self.g.shape(x))

    def binary(self, name, a, b, act=None):
        shape = np.broadcast_shapes(self.g.shape(a), self.g.shape(b))
        opts = {"act": ACT[act]} if name in ("ADD", "SUB", "MUL", "DIV") else {}
        return self.g.op(name, [a, b], shape, **opts)

    def unary(self, name, x):
        return self.g.op(name, [x], self.g.shape(x))

    def pad_channels(self, x, cout):
        c = self.g.shape(x)[-1]
        if c == cout:
            return x
        pads = self.g.const(np.array([[0, 0], [0, 0], [0, 0], [0, cout - c]], np.int32))
        n, h, w, _ = self.g.shape(x)
        return self.g.op("PAD", [x, pads], (n, h, w, cout))

    def reshape(self, x, shape, option: bool = True):
        out = np.empty(self.g.shape(x), np.int8).reshape(shape).shape
        ins = [x, self.g.const(np.asarray(shape, np.int32))]
        opts = dict(new_shape=list(shape)) if option else {}
        return self.g.op("RESHAPE", ins, out, **opts)

    def reduce(self, name, x, axes, keep_dims):
        shape = np.empty(self.g.shape(x), np.int8).sum(axis=tuple(axes), keepdims=keep_dims).shape
        return self.g.op(name, [x, self.g.const(np.asarray(axes, np.int32))], shape,
                         keep_dims=keep_dims)

    def transpose(self, x, perm):
        shape = tuple(self.g.shape(x)[p] for p in perm)
        return self.g.op("TRANSPOSE", [x, self.g.const(np.asarray(perm, np.int32))], shape)

    def concat(self, xs, axis):
        shape = np.concatenate([np.empty(self.g.shape(x), np.int8) for x in xs], axis).shape
        return self.g.op("CONCATENATION", xs, shape, axis=axis, act=0)

    def layer_norm(self, x, eps=1e-5):
        """LN over the last axis as the converters lower it: MEAN, SUB,
        SQUARED_DIFFERENCE, MEAN, ADD, RSQRT, MUL, then the affine."""
        c = self.g.shape(x)[-1]
        ax = len(self.g.shape(x)) - 1
        mu = self.reduce("MEAN", x, [ax], True)
        var = self.reduce("MEAN", self.binary("SQUARED_DIFFERENCE", x, mu), [ax], True)
        inv = self.unary("RSQRT", self.binary("ADD", var, self.g.const(np.float32([eps]))))
        y = self.binary("MUL", self.binary("SUB", x, mu), inv)
        y = self.binary("MUL", y, self.weight(1 + 0.1 * self.rng.randn(c)))
        return self.binary("ADD", y, self.weight(0.05 * self.rng.randn(c)))


# ------------------------------------------------------- the face models

FACE_BOX = 48.0            # planted box size, pixels of the 128^2 input
CROP = 256
BLENDSHAPE_INPUTS = 146


def _ch(c, width):
    return max(4, int(round(c * width)))


def blazeface(rng, width: float = 1.0, depth: int = 1) -> bytes:
    """BlazeFace short-range at the published shapes: a 5x5 stride-2 stem
    and BlazeBlocks (depthwise 3x3 + 1x1 conv + residual, max-pool and
    channel pad when strided) to 16x16x88 and 8x8x96, then the 1x1 heads,
    reshaped and concatenated over the 896 anchors."""
    n = Net(rng, fp16_weights=True)
    g = n.g
    x_in = g.tensor((1, 128, 128, 3), name="input")
    x = n.conv(x_in, _ch(24, width), 5, stride=2, act="relu")

    def block(x, cout, stride):
        y = n.dwconv(x, 3, stride=stride, padding=SAME)
        y = n.conv(y, cout, 1, gain=0.5)
        skip = n.maxpool(x) if stride == 2 else x
        return n.binary("ADD", y, n.pad_channels(skip, cout), act="relu")

    if depth:
        plan16 = [(24, 1), (28, 1), (32, 2), (36, 1), (42, 1), (48, 2), (56, 1), (64, 1),
                  (72, 1), (80, 1), (88, 1)]
        plan8 = [(96, 2), (96, 1), (96, 1), (96, 1), (96, 1)]
    else:                       # the strided blocks and the last of each grid
        plan16, plan8 = [(32, 2), (48, 2), (88, 1)], [(96, 2)]
    for c, s in plan16:
        x = block(x, _ch(c, width), s)
    f16 = x
    for c, s in plan8:
        x = block(x, _ch(c, width), s)
    f8 = x
    # the planted heads: anchors of kind 0 at 16^2 pass the threshold
    score16 = n.conv(f16, 2, 1, gain=0.2, bias=np.array([4.0, -8.0]))
    score8 = n.conv(f8, 6, 1, gain=0.2, bias=np.full(6, -8.0))
    reg_bias = np.zeros(16)
    reg_bias[2:4] = FACE_BOX
    reg_bias[4:16] = np.array([-10, -8, 10, -8, 0, 4, 0, 14, -20, -4, 20, -4]) * FACE_BOX / 48
    box16 = n.conv(f16, 32, 1, gain=0.5, bias=np.tile(reg_bias, 2))
    box8 = n.conv(f8, 96, 1, gain=0.5, bias=np.tile(reg_bias, 6))
    boxes = n.concat([n.reshape(box16, (1, 512, 16)), n.reshape(box8, (1, 384, 16))], 1)
    scores = n.concat([n.reshape(score16, (1, 512, 1)), n.reshape(score8, (1, 384, 1))], 1)
    return g.serialize([x_in], [boxes, scores])


def landmark_bias(canonical: np.ndarray) -> np.ndarray:
    """The landmark head's planted bias: the canonical face ([468, 3] cm)
    drawn into the 256^2 crop (x right, y down, 8 px a cm), plus ten iris
    points about the eyes: [1434]."""
    c = canonical[:, :3]
    pts = np.stack([CROP / 2 + 8 * c[:, 0], CROP / 2 - 8 * c[:, 1], 8 * c[:, 2]], -1)
    eyes = np.array([[-3.2, 3.0, 2.0], [3.2, 3.0, 2.0]])
    iris = np.concatenate([np.stack([e + [dx, dy, 0] for dx, dy in
                                     ((0, 0), (0.5, 0), (0, 0.5), (-0.5, 0), (0, -0.5))])
                           for e in eyes])
    iris = np.stack([CROP / 2 + 8 * iris[:, 0], CROP / 2 - 8 * iris[:, 1], 8 * iris[:, 2]], -1)
    return np.concatenate([pts, iris]).reshape(-1)


def landmarker(rng, canonical: np.ndarray, width: float = 1.0, depth: int = 1) -> bytes:
    """The 478-point landmark model at the published shapes: a stride-2
    stem, PReLU residual stages (depthwise + 1x1) down to 4x4, then 4x4
    VALID heads: landmarks [1, 1, 1, 1434] and the presence logit."""
    n = Net(rng, fp16_weights=True)
    g = n.g
    x_in = g.tensor((1, CROP, CROP, 3), name="input_12")
    x = n.prelu(n.conv(x_in, _ch(16, width), 3, stride=2))
    for c in (32, 64, 128, 128, 128):
        c = _ch(c, width)
        y = n.conv(n.dwconv(x, 3, stride=2), c, 1, gain=0.5)
        x = n.prelu(n.binary("ADD", y, n.pad_channels(n.maxpool(x), c)))
        for _ in range(depth):
            y = n.conv(n.prelu(n.dwconv(x, 3)), c, 1, gain=0.5)
            x = n.prelu(n.binary("ADD", x, y))
    lm = n.conv(x, 1434, 4, padding=VALID, gain=1.0, bias=landmark_bias(canonical))
    presence = n.conv(x, 1, 4, padding=VALID, gain=0.2, bias=np.array([4.0]))
    return g.serialize([x_in], [lm, presence])


def blendshapes(rng, width: float = 1.0, depth: int = 2) -> bytes:
    """An MLP-mixer over the 146 landmarks -> 52 blendshape scores: the
    points centred and scaled, 1x1 convs as dense layers, token mixing
    through TRANSPOSE, layer norms, MEAN over tokens, LOGISTIC."""
    n = Net(rng)
    g = n.g
    t, c = BLENDSHAPE_INPUTS, _ch(64, width)
    x_in = g.tensor((1, t, 2), name="input_points")
    mu = n.reduce("MEAN", x_in, [1], True)
    xc = n.binary("SUB", x_in, mu)
    var = n.reduce("MEAN", n.binary("MUL", xc, xc), [1, 2], True)
    std = n.unary("SQRT", n.binary("ADD", var, g.const(np.float32([1e-6]))))
    x = n.reshape(n.binary("DIV", xc, std), (1, t, 1, 2), option=False)
    x = n.conv(x, c, 1)                                   # [1, 146, 1, C]
    for _ in range(depth):
        y = n.transpose(n.layer_norm(x), (0, 3, 2, 1))     # [1, C, 1, 146]
        y = n.conv(n.conv(y, _ch(32, width), 1, act="relu"), t, 1, gain=0.5)
        x = n.binary("ADD", x, n.transpose(y, (0, 3, 2, 1)))
        y = n.conv(n.conv(n.layer_norm(x), 2 * c, 1, act="relu"), c, 1, gain=0.5)
        x = n.binary("ADD", x, y)
    x = n.reduce("MEAN", n.layer_norm(x), [1], True)       # [1, 1, 1, C]
    x = n.unary("LOGISTIC", n.conv(x, 52, 1))
    return g.serialize([x_in], [n.reshape(x, (52,))])


def every_op_graph(rng) -> bytes:
    """The .tflite bytes of `every_op_builder`."""
    g, inputs, outputs = every_op_builder(rng)
    return g.serialize(inputs, outputs)


def every_op_builder(rng):
    """Every op of the compiler's vocabulary on [1, 11, 10, 3] (odd sizes, so
    SAME pads split unevenly): strided, dilated and depthwise (mult 2)
    convs, fp16 weights behind DEQUANTIZE, SAME and VALID max-pools, PAD,
    both RESHAPE forms, CONCATENATION, TRANSPOSE, STRIDED_SLICE (masks,
    shrink, a negative stride), MEAN, SUM, the elementwise ops with fused
    activations (relu, relu6, relu_n1to1: TFLite's kernels clamp to the
    activation's range, so they skip a fused tanh, which the compilers
    apply), PRELU, RELU, LOGISTIC, NEG, SQRT, RSQRT, SQUARED_DIFFERENCE.
    Returns (GraphBuilder, inputs, outputs: three tensors)."""
    n = Net(rng, fp16_weights=True)
    g = n.g
    x_in = g.tensor((1, 11, 10, 3), name="x")
    a = n.conv(x_in, 8, 3, stride=2, act="relu6")                  # [1, 6, 5, 8]
    b = n.conv(x_in, 8, 3, dilation=2, act="relu")                 # [1, 11, 10, 8]
    b = n.maxpool(b, 3, 2, SAME, act="relu_n1to1")                 # [1, 6, 5, 8]
    c = n.dwconv(a, 3, stride=1, mult=2, act="relu")               # [1, 6, 5, 16]
    c = n.conv(c, 8, 1)
    d = n.prelu(n.binary("ADD", a, b))
    e = n.binary("MUL", d, c, act="relu")
    f = n.binary("SUB", d, n.unary("NEG", c), act="relu6")
    sq = n.binary("SQUARED_DIFFERENCE", e, f)
    one = g.const(np.float32([1.0]))
    den = n.binary("ADD", sq, one)
    h = n.binary("DIV", f, den, act="relu_n1to1")
    h = n.binary("MUL", h, n.unary("RSQRT", den))
    h = n.binary("ADD", h, n.unary("SQRT", den))
    h = n.unary("LOGISTIC", n.unary("RELU", n.binary("SUB", h, g.const(np.float32([1.2])))))
    p = n.g.op("PAD", [h, g.const(np.array([[0, 0], [1, 2], [0, 1], [0, 0]], np.int32))],
               (1, 9, 6, 8))
    p = n.maxpool(p, 2, 2, VALID)                                  # [1, 4, 3, 8]
    t = n.transpose(p, (0, 2, 1, 3))                               # [1, 3, 4, 8]
    r = n.reshape(t, (1, 12, 8))
    r2 = n.reshape(t, (1, -1), option=False)                       # [1, 96]
    cat = n.concat([r, n.reshape(p, (1, 12, 8))], axis=-1)          # [1, 12, 16]
    begin = g.const(np.array([0, 1, 2], np.int32))
    end = g.const(np.array([1, 11, 14], np.int32))
    stride = g.const(np.array([1, 2, 3], np.int32))
    s1 = g.op("STRIDED_SLICE", [cat, begin, end, stride], (1, 5, 4), begin_mask=1,
              end_mask=0, ellipsis_mask=0, new_axis_mask=0, shrink_axis_mask=0)
    s2 = g.op("STRIDED_SLICE", [cat, g.const(np.array([0, 10, 0], np.int32)),
                                g.const(np.array([1, 2, 16], np.int32)),
                                g.const(np.array([1, -3, 1], np.int32))], (3, 16),
              begin_mask=4, end_mask=4, ellipsis_mask=0, new_axis_mask=0, shrink_axis_mask=1)
    m = n.reduce("MEAN", s1, [1], False)                           # [1, 4]
    s = n.reduce("SUM", s2, [0, -1], True)                         # [1, 1]
    out1 = n.binary("ADD", m, s)
    return g, [x_in], [out1, r2, cat]


# ------------------------------------------------ geometry metadata (protobuf)

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _ld(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def geometry_metadata(canonical: np.ndarray, tris: np.ndarray, weights: np.ndarray) -> bytes:
    """GeometryPipelineMetadata: field 1 the canonical Mesh3d (vertex_type 1
    = VERTEX_PT, primitive_type 1 = TRIANGLE, vertex_buffer floats, index
    buffer varints, each repeated field unpacked), field 2 a
    WeightedLandmarkRef (landmark_id, weight) per non-zero weight."""
    mesh = _key(1, 0) + _varint(1) + _key(2, 0) + _varint(1)
    mesh += b"".join(_key(3, 5) + struct.pack("<f", v) for v in canonical.reshape(-1))
    mesh += b"".join(_key(4, 0) + _varint(int(i)) for i in tris.reshape(-1))
    out = _ld(1, mesh)
    for lid in np.nonzero(weights)[0]:
        ref = _key(1, 0) + _varint(int(lid)) + _key(2, 5) + struct.pack("<f", weights[lid])
        out += _ld(2, ref)
    return out


def synthetic_face_mesh(rng, n: int = 468):
    """A seeded canonical face: [n, 5] xyzuv in cm (an ellipsoid cap 14 cm
    wide, 18 cm tall, nose toward +z), random triangles over it, Procrustes
    weights on 40 of the vertices."""
    theta = rng.uniform(-1.1, 1.1, n)
    phi = rng.uniform(-1.0, 1.0, n)
    xyz = np.stack([7 * np.sin(theta) * np.cos(phi), 9 * np.sin(phi),
                    4 * np.cos(theta) * np.cos(phi)], -1)
    uv = rng.uniform(0, 1, (n, 2))
    canonical = np.concatenate([xyz, uv], 1).astype(np.float32)
    tris = np.stack([rng.choice(n, 3, replace=False) for _ in range(2 * n)]).astype(np.int64)
    weights = np.zeros(n, np.float32)
    weights[rng.choice(n, 40, replace=False)] = rng.uniform(0.1, 1.0, 40)
    return canonical, tris, weights


TASK_MEMBERS = ("face_detector.tflite", "face_landmarks_detector.tflite",
                "face_blendshapes.tflite", "geometry_pipeline_metadata_landmarks.binarypb")


def task_members(seed: int, width: float = 1.0, depth: int = 1) -> dict:
    """The four members of the synthetic .task: name -> bytes."""
    rng = np.random.RandomState(seed)
    canonical, tris, weights = synthetic_face_mesh(rng)
    return {
        TASK_MEMBERS[0]: blazeface(rng, width, depth),
        TASK_MEMBERS[1]: landmarker(rng, canonical, width, depth),
        TASK_MEMBERS[2]: blendshapes(rng, width, 2 if depth else 1),
        TASK_MEMBERS[3]: geometry_metadata(canonical, tris, weights),
    }


def write_task(path: str, seed: int, width: float = 1.0, depth: int = 1) -> dict:
    """Write the synthetic face_landmarker .task (a zip) and return its
    members."""
    members = task_members(seed, width, depth)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for name, data in members.items():
            z.writestr(name, data)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    return members
