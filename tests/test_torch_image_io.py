"""The port's PIL-free image reading and resizing against Pillow, on the CPU.

`preprocess/image.py` reproduces Pillow's `Image.resize` (NEAREST,
BILINEAR, BICUBIC), `Image.crop` and `convert("RGB" / "L")` of PNG files;
each is held here to Pillow bit for bit, on downscales and upscales, odd
sizes, RGB and L. `preprocess_image` on a path and on an array equals
mofa_tpu's PIL pipeline. The inference CLIs run with PIL blocked, and no
module of the port imports PIL except `write_video`'s .gif branch.
"""

import json
import pathlib
import re
import sys

import numpy as np
import pytest
from PIL import Image

from mofa_tpu.preprocess import traj as j_traj

from mofa_tpu_torch.preprocess import image as img_io
from mofa_tpu_torch.preprocess import traj as p_traj
from tests.torch_port_util import one_torch_thread  # noqa: F401 (autouse)

PIL_FILTERS = {img_io.NEAREST: Image.NEAREST, img_io.BILINEAR: Image.BILINEAR,
               img_io.BICUBIC: Image.BICUBIC}
# (in h, w) -> (out w, h): downscales by 1.3 to 5.9, upscales by 1.2 to 7,
# one axis kept, odd sizes throughout
SIZES = [((97, 131), (37, 29)), ((64, 64), (224, 224)), ((300, 217), (128, 177)),
         ((33, 41), (41, 99)), ((250, 7), (3, 250)), ((45, 80), (80, 17))]


def _image(h, w, channels, seed):
    """Noise plus a smooth ramp (edges and gradients both)."""
    rng = np.random.RandomState(seed)
    shape = (h, w, channels) if channels else (h, w)
    ramp = np.add.outer(np.linspace(0, 200, h), np.linspace(0, 55, w))
    if channels:
        ramp = ramp[..., None]
    return np.clip(ramp + rng.randint(-40, 40, shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("channels", [3, 0], ids=["RGB", "L"])
@pytest.mark.parametrize("resample", list(PIL_FILTERS))
def test_pil_resize_equals_pillow(resample, channels):
    for i, ((h, w), size) in enumerate(SIZES):
        img = _image(h, w, channels, i)
        want = np.asarray(Image.fromarray(img).resize(size, PIL_FILTERS[resample]))
        got = img_io.pil_resize(img, size, resample)
        assert got.dtype == np.uint8 and got.shape == want.shape, (size, got.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{resample} {h}x{w} -> {size}")


def test_read_image_and_crop_equal_pillow(tmp_path):
    """RGB, RGBA and L PNGs read as RGB and as L (Pillow's luma), and
    crops reaching outside the image (zeros there)."""
    rgba = _image(37, 41, 4, 7)
    files = {"rgba": rgba, "rgb": rgba[..., :3], "l": rgba[..., 0]}
    for name, arr in files.items():
        Image.fromarray(arr).save(tmp_path / f"{name}.png")
        for mode in ("RGB", "L"):
            with Image.open(tmp_path / f"{name}.png") as im:
                want = np.asarray(im.convert(mode))
            np.testing.assert_array_equal(img_io.read_image(str(tmp_path / f"{name}.png"),
                                                            mode), want)
    rgb = files["rgb"]
    for box in ((-5, -3, 50, 20), (10, 4, 30, 36), (30, 30, 60, 61), (-9, -9, -1, -1)):
        want = np.asarray(Image.fromarray(rgb).crop(box))
        np.testing.assert_array_equal(img_io.pil_crop(rgb, box), want)
    with pytest.raises(FileNotFoundError):
        img_io.read_image(str(tmp_path / "missing.png"))


def test_preprocess_image_path_and_array_equal_jax(tmp_path):
    """The port's preprocess_image (a path, an array) against mofa_tpu's,
    which resizes through PIL."""
    for shape, target in (((100, 150, 3), 128), ((300, 217, 3), 64), ((71, 64), 96)):
        arr = _image(*shape[:2], shape[2] if len(shape) == 3 else 0, shape[0])
        Image.fromarray(arr).save(tmp_path / "in.png")
        ref, ref_hw = j_traj.preprocess_image(Image.open(tmp_path / "in.png"), target)
        for src in (str(tmp_path / "in.png"), arr):
            got, hw = p_traj.preprocess_image(src, target)
            assert hw == ref_hw and got.dtype == np.float32
            np.testing.assert_array_equal(got, ref)


def test_no_pil_import_but_the_gif_writer():
    """A source check: the only PIL import in mofa_tpu_torch is the one in
    `write_video`'s .gif branch."""
    root = pathlib.Path(p_traj.__file__).parents[1]
    found = []
    for path in sorted(root.rglob("*.py")):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if re.match(r"\s*(from\s+PIL[\s.]|import\s+PIL\b)", line):
                found.append((path.relative_to(root).as_posix(), n, line.strip()))
    assert [f[0] for f in found] == ["apps/loaders.py"], found
    src = (root / "apps" / "loaders.py").read_text().splitlines()
    n = found[0][1]
    assert src[n - 2].strip() == 'if path.endswith(".gif"):', src[n - 3:n]
    assert any(line.startswith("def write_video(") for line in src[n - 15:n])


@pytest.fixture
def no_pil(monkeypatch):
    """PIL made unimportable, as on an installation without it."""
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401


def test_inference_clis_run_without_pil(tmp_path, no_pil):
    """traj_app (with a motion brush), keypoint_app and audio2ldmk_app read
    their image files and write their outputs at the tiny settings of their
    own tests, with PIL blocked (hybrid_app's face mask goes through the
    same reader and resampler, in test_torch_hybrid.py's CLI test)."""
    import cv2

    from mofa_tpu_torch.apps import audio2ldmk_app, keypoint_app, traj_app
    from tests.test_torch_audio import _face, _write_wav

    rng = np.random.RandomState(3)
    cv2.imwrite(str(tmp_path / "in.png"), _image(70, 90, 3, 1))
    brush = np.zeros((70, 90), np.uint8)
    brush[:, :45] = 255
    cv2.imwrite(str(tmp_path / "brush.png"), brush)
    spec = {"tracks": [[[10.0, 12.0], [30.0, 20.0]], [[60.0, 40.0], [50.0, 30.0]]],
            "motion_brush": str(tmp_path / "brush.png")}
    (tmp_path / "t.json").write_text(json.dumps(spec))
    tiny = ["--device", "cpu", "--tiny", "--target_size", "64",
            "--num_inference_steps", "1"]
    traj_app.main(["--image", str(tmp_path / "in.png"), "--tracks", str(tmp_path / "t.json"),
                   "--num_frames", "3", "--output", str(tmp_path / "traj.mp4")] + tiny)
    np.save(tmp_path / "l.npy", (rng.rand(7, 68, 2) * [90, 70]).astype(np.float32))
    keypoint_app.main(["--image", str(tmp_path / "in.png"), "--landmarks",
                       str(tmp_path / "l.npy"), "--num_frames", "7", "--window_size", "4",
                       "--stride", "2", "--output", str(tmp_path / "kp.mp4")] + tiny)
    np.savez(tmp_path / "face.npz", **_face(70, 90, 4))
    _write_wav(tmp_path / "a.wav", rng.uniform(-0.5, 0.5, 8000), 16000)
    audio2ldmk_app.main(["--ref_image_path", str(tmp_path / "in.png"), "--audio_path",
                         str(tmp_path / "a.wav"), "--face_npz", str(tmp_path / "face.npz"),
                         "--save_dir", str(tmp_path / "ldmk"), "--device", "cpu", "--tiny"])
    assert np.load(tmp_path / "ldmk" / "landmarks.npy").shape == (14, 68, 2)
    for name, frames in (("traj", 3), ("kp", 7)):
        cap = cv2.VideoCapture(str(tmp_path / f"{name}.mp4"))
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == frames, name
        cap.release()
