"""The port's tflite reader and compiler (mofa_tpu_torch/interop/tflite.py) on the CPU.

The graphs come from tests/torch_ref/tflite_writer.py (a pure-Python
flatbuffer writer): an every-op graph, the synthetic .task's three face
models (BlazeFace, the landmarker, the blendshapes) at a reduced width
and depth (the published input and output shapes), and the every-op
graph with its constants stored outside the flatbuffer.

- the writer -> the port's reader gives back the graph that was written;
  fp16 constants behind DEQUANTIZE folded to fp32;
- TensorFlow's own reading, in ONE child process for every graph (TF is
  never imported into the pytest process): `tf.lite.Interpreter` on
  seeded inputs (the class itself, from tensorflow/lite/python, the
  package's heavy __init__ skipped), and mofa_tpu's
  `TFLiteGraph.from_bytes` -> `save_npz`.
  The port's parse equals the JAX package's (ops, options, shapes,
  constants bit for bit); the port's compiled modules match the
  interpreter within atol 1e-4 + rtol 1e-4 (fp32 sums in other orders);
- the compilers: the port's module against mofa_tpu's `compile_tflite`
  on `load_npz` of the same npz, the every-op graph, atol 1e-5;
- the npz format both ways: the port's `save_npz` loads in the JAX
  package and the JAX package's in the port, equal;
- buffers outside the flatbuffer read (and a truncated file refused,
  naming the buffer), an op outside the vocabulary refused by name, the
  op-code table and option slots against TensorFlow's schema (read as
  text).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from mofa_tpu.interop import tflite_jax as J

from mofa_tpu_torch.interop import tflite as P
from tests.torch_ref import tflite_writer as W
from tests.torch_port_util import jit_fast, one_torch_thread  # noqa: F401 (autouse)

TASK_SEED, TASK_WIDTH, TASK_DEPTH = 7, 0.5, 0

# the child: tf.lite's Interpreter and mofa_tpu's parser on every graph of
# a directory. `tensorflow` is entered as a bare package (its __init__,
# which loads all of TensorFlow in about 6 s, skipped): the interpreter
# and the schema module mofa_tpu reads need only their own files.
_TF_CHILD = r"""
import importlib.util, os, sys, types
import numpy as np
tf_pkg = types.ModuleType("tensorflow")
tf_pkg.__path__ = list(importlib.util.find_spec("tensorflow").submodule_search_locations)
sys.modules["tensorflow"] = tf_pkg
from tensorflow.lite.python.interpreter import Interpreter
sys.path.insert(0, sys.argv[2])
from mofa_tpu.interop.tflite_jax import TFLiteGraph

root = sys.argv[1]
for k, name in enumerate(sorted(f for f in os.listdir(root) if f.endswith(".tflite"))):
    buf = open(os.path.join(root, name), "rb").read()
    interp = Interpreter(model_content=buf)
    interp.allocate_tensors()
    rng = np.random.default_rng(k)
    ins = [rng.standard_normal(d["shape"], dtype=np.float32) for d in interp.get_input_details()]
    for d, x in zip(interp.get_input_details(), ins):
        interp.set_tensor(d["index"], x)
    interp.invoke()
    save = {f"in_{i}": x for i, x in enumerate(ins)}
    for i, d in enumerate(interp.get_output_details()):
        save[f"out_{i}"] = interp.get_tensor(d["index"])
    np.savez(os.path.join(root, name + ".tf.npz"), **save)
    if not name.startswith("external"):
        TFLiteGraph.from_bytes(buf).save_npz(os.path.join(root, name + ".jax.npz"))
"""


def _graphs():
    members = W.task_members(TASK_SEED, TASK_WIDTH, TASK_DEPTH)
    graphs = {"every_op.tflite": W.every_op_graph(np.random.RandomState(1))}
    graphs.update({k: v for k, v in members.items() if k.endswith(".tflite")})
    return graphs


@pytest.fixture(scope="module")
def tf_run(tmp_path_factory):
    """{name: (bytes, TF inputs, TF outputs in the graph's order, the JAX
    package's npz path)} from one TensorFlow child."""
    root = tmp_path_factory.mktemp("tflite")
    graphs = _graphs()
    g, ins, outs = _every_op_builder()
    graphs["external_every_op.tflite"] = g.serialize(ins, outs, external=True)
    for name, buf in graphs.items():
        (root / name).write_bytes(buf)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _TF_CHILD, str(root), repo],
                          capture_output=True, text=True, timeout=240,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES="", TF_CPP_MIN_LOG_LEVEL="3"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = {}
    for name, buf in graphs.items():
        d = np.load(root / (name + ".tf.npz"))
        ins = [d[f"in_{i}"] for i in range(sum(k.startswith("in_") for k in d.files))]
        outs = [d[f"out_{i}"] for i in range(sum(k.startswith("out_") for k in d.files))]
        out[name] = (buf, ins, outs, str(root / (name + ".jax.npz")))
    return out


def _every_op_builder():
    return W.every_op_builder(np.random.RandomState(1))


def _same_graph(a, b):
    assert [(o.name, list(o.inputs), list(o.outputs), o.options) for o in a.ops] == \
        [(o.name, list(o.inputs), list(o.outputs), o.options) for o in b.ops]
    assert {k: tuple(v) for k, v in a.shapes.items()} == {k: tuple(v) for k, v in b.shapes.items()}
    assert list(a.inputs) == list(b.inputs) and list(a.outputs) == list(b.outputs)
    assert a.constants.keys() == b.constants.keys()
    for k in a.constants:
        assert a.constants[k].dtype == b.constants[k].dtype, k
        np.testing.assert_array_equal(a.constants[k], b.constants[k])


def test_writer_round_trip():
    """The port's reader gives back what the writer wrote: every option
    table, tensor shapes and constants; DEQUANTIZE folded (its fp16
    constant cast to fp32 under the dequantized tensor's id)."""
    g, ins, outs = _every_op_builder()
    parsed = P.TFLiteGraph.from_bytes(g.serialize(ins, outs))
    deq = {outs[0]: ins[0] for name, ins, outs, _ in g.ops if name == "DEQUANTIZE"}
    want = [(name, ins, outs, dict(opts)) for name, ins, outs, opts in g.ops
            if name != "DEQUANTIZE"]
    got = [(o.name, o.inputs, o.outputs, o.options) for o in parsed.ops]
    assert got == want
    assert {"CONV_2D", "DEPTHWISE_CONV_2D", "MAX_POOL_2D", "STRIDED_SLICE", "RESHAPE",
            "MEAN", "SUM", "CONCATENATION"} <= {n for n, *_ in got}
    assert parsed.shapes == {t: shape for t, (shape, *_) in enumerate(g.tensors)}
    assert (parsed.inputs, parsed.outputs) == (ins, outs)
    for tid, (shape, dtype, buf, _) in enumerate(g.tensors):
        if buf:
            want_c = np.frombuffer(g.data[buf], dtype).reshape(shape)
            np.testing.assert_array_equal(parsed.constants[tid], want_c)
    for dst, src in deq.items():
        assert parsed.constants[dst].dtype == np.float32
        np.testing.assert_array_equal(parsed.constants[dst],
                                      parsed.constants[src].astype(np.float32))


@pytest.mark.parametrize("name", sorted(_graphs()) + ["external_every_op.tflite"])
def test_tensorflow_reads_what_the_port_reads(tf_run, name):
    """Per graph: the port's parse equals mofa_tpu's (from the TF child's
    npz), and the port's compiled module matches tf.lite.Interpreter."""
    buf, ins, outs, jax_npz = tf_run[name]
    graph = P.TFLiteGraph.from_bytes(buf)
    if os.path.exists(jax_npz):
        _same_graph(graph, J.TFLiteGraph.load_npz(jax_npz))
    got = P.compile_tflite(graph, "cpu")(*[torch.from_numpy(x) for x in ins])
    assert len(got) == len(outs)
    for g, w in zip(got, outs):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4)


def test_compiler_matches_jax_every_op(tf_run, tmp_path):
    """The port's module against mofa_tpu's compile_tflite on the same
    npz (the JAX package's own save), every op of the vocabulary."""
    _, ins, _, jax_npz = tf_run["every_op.tflite"]
    jg = J.TFLiteGraph.load_npz(jax_npz)
    fn, params = J.compile_tflite(jg)
    want = jit_fast(fn)(params, *ins)
    got = P.compile_tflite(P.TFLiteGraph.load_npz(jax_npz), "cpu")(
        *[torch.from_numpy(x) for x in ins])
    assert {op.name for op in jg.ops} == P.VOCABULARY
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_fused_activations_match_jax():
    """Every fused-activation code, to 1e-6 (tanh's last bits differ
    between libraries; TFLite's kernels skip a fused tanh, which both
    compilers apply, so the TF check cannot see it)."""
    x = np.random.RandomState(3).randn(64).astype(np.float32) * 3
    for code in P._ACT:
        np.testing.assert_allclose(P._act(torch.from_numpy(x), code).numpy(),
                                   np.asarray(J._act(x, code)), rtol=0, atol=1e-6)


def test_npz_files_cross_load(tf_run, tmp_path):
    """The port's save_npz loads in mofa_tpu; mofa_tpu's loads in the port."""
    for name in ("every_op.tflite", W.TASK_MEMBERS[2]):
        buf, _, _, jax_npz = tf_run[name]
        ours = P.TFLiteGraph.from_bytes(buf)
        path = str(tmp_path / (name + ".port.npz"))
        ours.save_npz(path)
        _same_graph(J.TFLiteGraph.load_npz(path), ours)
        _same_graph(P.TFLiteGraph.load_npz(jax_npz), ours)


def test_buffers_outside_the_flatbuffer():
    """Constants stored past the flatbuffer are read from their offsets
    (the same graph as inline); a file cut short is refused, naming the
    tensor and buffer, never read as empty."""
    g, ins, outs = _every_op_builder()
    inline = P.TFLiteGraph.from_bytes(g.serialize(ins, outs))
    ext = g.serialize(ins, outs, external=True)
    _same_graph(P.TFLiteGraph.from_bytes(ext), inline)
    with pytest.raises(ValueError, match=r"tensor \d+: buffer \d+ lies at bytes"):
        P.TFLiteGraph.from_bytes(ext[:-64])


def test_unknown_op_refused_by_name():
    n = W.Net(np.random.RandomState(0))
    x = n.g.tensor((1, 4, 4, 2))
    y = n.g.op("TANH", [x], (1, 4, 4, 2))
    graph = P.TFLiteGraph.from_bytes(n.g.serialize([x], [y]))
    assert graph.ops[0].name == "TANH"
    with pytest.raises(NotImplementedError, match="tflite op TANH"):
        P.compile_tflite(graph, "cpu")


def test_schema_tables_match_tensorflow():
    """BUILTIN_OPERATORS and the option slots, defaults and union codes
    against TensorFlow's generated schema module, read as text."""
    import importlib.util
    spec = importlib.util.find_spec("tensorflow")
    if spec is None:
        pytest.skip("tensorflow is not installed")
    path = os.path.join(os.path.dirname(spec.origin), "lite", "python",
                        "schema_py_generated.py")
    src = open(path).read()
    enum = re.search(r"^class BuiltinOperator\(object\):\n(.*?)\n\n", src, re.S | re.M)
    values = {int(v): k for k, v in re.findall(r"    (\w+) = (-?\d+)", enum.group(1))}
    assert P.BUILTIN_OPERATORS == tuple(values[i] for i in range(len(values)))
    union = re.search(r"^class BuiltinOptions\(object\):\n(.*?)\n\n", src, re.S | re.M)
    codes = dict((k, int(v)) for k, v in re.findall(r"    (\w+) = (\d+)", union.group(1)))
    names = {"padding": "Padding", "sw": "StrideW", "sh": "StrideH", "act":
             "FusedActivationFunction", "dw": "DilationWFactor", "dh": "DilationHFactor",
             "mult": "DepthMultiplier", "fw": "FilterWidth", "fh": "FilterHeight",
             "axis": "Axis", "new_shape": "NewShape", "keep_dims": "KeepDims",
             "begin_mask": "BeginMask", "end_mask": "EndMask", "ellipsis_mask":
             "EllipsisMask", "new_axis_mask": "NewAxisMask", "shrink_axis_mask":
             "ShrinkAxisMask"}
    kinds = {"PrependInt8Slot": P._I8, "PrependInt32Slot": P._I32, "PrependBoolSlot": P._BOOL,
             "PrependUOffsetTRelativeSlot": "vector"}
    for table, (code, fields) in P.OPTION_TABLES.items():
        assert codes[table] == code, table
        for key, (slot, fmt, default) in fields.items():
            m = re.search(rf"def {table}Add{names[key]}\(builder, \w+\):\n"
                          rf"    builder\.(\w+)\((\d+), [^,]+, ?([^)]*)\)", src)
            assert m, (table, key)
            assert (kinds[m.group(1)], int(m.group(2))) == (fmt, slot), (table, key)
            if fmt != "vector":
                assert int(m.group(3)) == int(default), (table, key)
