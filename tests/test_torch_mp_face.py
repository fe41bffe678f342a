"""The port's FaceLandmarker (mofa_tpu_torch/models/mp_face.py) against mofa_tpu's, on the CPU.

The .task is the synthetic one of tests/torch_ref/tflite_writer.py
(BlazeFace, the landmarker and the blendshapes at the published input and
output shapes, half width, reduced depth; a seeded canonical mesh). The
JAX package's `FaceLandmarkerJax` runs the same graphs: the port parses
the .task and saves each graph with `save_npz`, mofa_tpu's `load_npz` and
`compile_tflite` read them (that the two packages parse a flatbuffer
alike is tests/test_torch_tflite.py's check against TensorFlow's child).

- `blaze_anchors`, `decode_detections` and `weighted_nms` bit-equal;
- the geometry protobuf read equal (and packed repeated fields read as
  protobuf packs them: fixed32 floats, varint indices);
- the 128^2 resize equal to `jax.image.resize(..., "linear")` (antialiased)
  at a downscale and an upscale, to 1e-6; the rotated crop to 1e-5;
- `detect_face` and the whole landmarker on a 240 x 320 image: box, key
  points, score within 1e-4; lmks and bs within 1e-4, lmks3d within 1e-4
  of its largest value (cm), the rotation within 1e-4 and the
  translation within 1e-4 of itself; faces equal.
"""

import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofa_tpu.interop import tflite_jax as JT
from mofa_tpu.models import mp_face as JM

from mofa_tpu_torch.models import mp_face as PM
from tests.torch_ref import tflite_writer as W
from tests.torch_port_util import jit_fast, one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("task") / "face_landmarker.task")
    W.write_task(path, seed=11, width=0.5, depth=0)
    return path


@pytest.fixture(scope="module")
def pair(task, tmp_path_factory):
    """(the port's FaceLandmarker on the CPU, FaceLandmarkerJax on the
    port-saved graphs)."""
    port = PM.load_face_landmarker(task, "cpu")
    root = tmp_path_factory.mktemp("npz")
    fns = []
    for name, net in (("det", port.detector), ("lmk", port.landmarks),
                      ("bs", port.blendshapes)):
        net.graph.save_npz(str(root / f"{name}.npz"))
        fn, params = JT.compile_tflite(JT.TFLiteGraph.load_npz(str(root / f"{name}.npz")))
        fns += [jit_fast(fn), params]
    with zipfile.ZipFile(task) as z:
        geo = JM.parse_geometry_metadata(z.read(PM.GEOMETRY_MEMBER))
    return port, JM.FaceLandmarkerJax(*fns, *geo)


def _image(h=240, w=320, seed=0):
    import cv2
    rng = np.random.RandomState(seed)
    small = (rng.rand(h // 16, w // 16, 3) * 255).astype(np.uint8)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)


def test_anchors_decode_nms_bit_equal():
    np.testing.assert_array_equal(PM.blaze_anchors(), JM.blaze_anchors())
    rng = np.random.RandomState(1)
    raw_boxes = (rng.randn(896, 16) * 8).astype(np.float32)
    raw_boxes[:, 2:4] = np.abs(raw_boxes[:, 2:4]) + 20
    raw_scores = (rng.randn(896, 1) * 2).astype(np.float32)
    a = PM.decode_detections(raw_boxes, raw_scores, PM.blaze_anchors())
    b = JM.decode_detections(raw_boxes, raw_scores, JM.blaze_anchors())
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert len(a[2]) > 100
    na, nb = PM.weighted_nms(*a), JM.weighted_nms(*b)
    assert len(na) == len(nb) > 1
    for da, db in zip(na, nb):
        for x, y in zip(da, db):
            np.testing.assert_array_equal(x, y)


def test_geometry_metadata_read_equal(task):
    with zipfile.ZipFile(task) as z:
        buf = z.read(PM.GEOMETRY_MEMBER)
    got, want = PM.parse_geometry_metadata(buf), JM.parse_geometry_metadata(buf)
    assert got[0].shape == (468, 5) and (got[2] > 0).sum() == 40
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    # packed repeated fields (wire type 2): the vertices as fixed32 floats,
    # the index buffer as varints
    tris = np.array([[0, 200, 3], [467, 1, 130]])
    verts = np.arange(10, dtype=np.float32) / 3
    mesh = (W._ld(4, b"".join(W._varint(int(i)) for i in tris.reshape(-1)))
            + W._ld(3, verts.tobytes()))
    canonical, got_tris, _ = PM.parse_geometry_metadata(W._ld(1, mesh))
    np.testing.assert_array_equal(got_tris, tris)
    np.testing.assert_array_equal(canonical.reshape(-1), verts)


@pytest.mark.parametrize("in_hw", [(320, 300), (100, 90)])
def test_resize_matches_jax_image_resize(in_hw):
    """The antialiased downscale (and the plain upscale) of the 128^2 input."""
    x = np.random.RandomState(2).rand(*in_hw, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (128, 128, 3), "linear"))
    got = PM.resize_linear(torch.from_numpy(x), 128, 128).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_crop256_matches_jax(pair):
    port, jlm = pair
    img = _image().astype(np.float32) / 255.0
    args = (150.3, 101.7, 83.2, 0.37)
    want = np.asarray(jlm._crop256(jnp.asarray(img), *(jnp.float32(a) for a in args)))
    got = port._crop256(torch.from_numpy(img), *args).numpy()
    assert got.shape == (1, 256, 256, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_detect_face_matches_jax(pair):
    port, jlm = pair
    img = _image(seed=3).astype(np.float32) / 255.0
    got = PM.detect_face(port.detector, img)
    want = JM.detect_face(jlm.det_fn, jlm.det_params, img)
    assert got is not None and want is not None
    for x, y in zip(got, want):
        np.testing.assert_allclose(x, y, rtol=0, atol=TOL)


def test_landmarker_matches_jax(pair):
    """The whole landmarker: detection, the rotated crop, the landmark net,
    presence, the blendshapes, the Procrustes solve."""
    port, jlm = pair
    img = _image(seed=4)
    got, want = port(img), jlm(img)
    assert got is not None and want is not None
    assert got.keys() == want.keys()
    assert got["lmks"].shape == (478, 3) and got["lmks3d"].shape == (468, 3)
    assert got["bs"].shape == (51,)
    np.testing.assert_array_equal(got["faces"], want["faces"])
    for key in ("lmks", "lmks3d", "bs"):      # lmks3d in cm: 1e-4 of its span
        scale = max(1.0, float(np.abs(want[key]).max()))
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=TOL * scale,
                                   err_msg=key)
    np.testing.assert_allclose(got["trans_mat"][:3, :3], want["trans_mat"][:3, :3],
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got["trans_mat"][:, 3], want["trans_mat"][:, 3],
                               rtol=TOL, atol=0)
    R = got["trans_mat"][:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)
