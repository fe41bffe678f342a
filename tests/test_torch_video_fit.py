"""The port's raw-video 3DMM fit (mofa_tpu_torch/preprocess/video_fit.py) and the
CLIs' --task paths against mofa_tpu, on the CPU.

BlazeFace is the synthetic .task's (tests/torch_ref/tflite_writer.py, half
width); the FAN has one module and ReconNet is the tiny one, each the
port's seeded weights carried into Flax by mofa_tpu's strict converters.

- `read_video_frames` and `smooth_3dmm_params` equal to mofa_tpu's;
- `detect_video_boxes` against mofa_tpu's (within 1e-3 px), a frame
  without a detection reusing the last box in both;
- the chain `fit_driving_video` (Pillow's BILINEAR resize to 256^2 without
  PIL, BlazeFace, the batched FAN, the host alignment, the batched
  ReconNet, the pose smoothing) against mofa_tpu's on a 3-frame mp4 with
  PIL blocked on the port's side: coefficients within 1e-4 of their
  largest value;
- with PIL blocked: `face_fit_app --task` (BlazeFace's box), the
  aniportrait engine's reference face from `--task` (`extract_face`: the
  FaceLandmarker on the image) and `--engine video --driving_video`, each
  through the app.
"""

import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mofa_tpu.interop import tflite_jax as JT
from mofa_tpu.models import face_alignment as JA
from mofa_tpu.models.audio import face3d_fit as JF
from mofa_tpu.models.weights import convert_face3d_recon_state_dict, convert_fan_state_dict
from mofa_tpu.preprocess import video_fit as JV

from chip_smoke import write_bfm_mat
from mofa_tpu_torch.apps import audio2ldmk_app, face_fit_app
from mofa_tpu_torch.models.mp_face import load_face_detector
from mofa_tpu_torch.preprocess import video_fit as PV
from tests.torch_ref import tflite_writer as W
from tests.torch_port_util import (flax_apply_without_shape_recheck,  # noqa: F401
                                   jit_fast, one_torch_thread, sd_np, template)


@pytest.fixture
def no_pil(monkeypatch):
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)


def _write_video(path, frames):
    import cv2
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25, (w, h))
    for f in frames:
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()


def _frames(n=3, h=200, w=240, seed=0):
    import cv2
    rng = np.random.RandomState(seed)
    small = (rng.rand(h // 20, w // 20, 3) * 255).astype(np.uint8)
    base = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC).astype(np.int32)
    return [np.clip(base + 6 * i, 0, 255).astype(np.uint8) for i in range(n)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The files, the port's nets (CPU) and their JAX twins."""
    from scipy.io import savemat
    d = tmp_path_factory.mktemp("vfit")
    W.write_task(str(d / "face.task"), seed=13, width=0.5, depth=0)
    _write_video(d / "drive.mp4", _frames())
    savemat(d / "lm3d.mat", {"lm": np.random.RandomState(18).randn(68, 3)})
    det = load_face_detector(str(d / "face.task"), "cpu")
    recon, fan = face_fit_app.load_face_nets(None, None, "cpu", tiny=True, fan_tiny=True)
    det.graph.save_npz(str(d / "det.npz"))
    det_fn, det_params = JT.compile_tflite(JT.TFLiteGraph.load_npz(str(d / "det.npz")))
    jfan = JA.FAN(num_modules=1)
    fan_params = convert_fan_state_dict(
        template(lambda: jfan.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))),
        sd_np(fan))
    jrecon = JF.ReconNet(layers=(1, 1, 1, 1), width=8)
    recon_params = convert_face3d_recon_state_dict(
        template(lambda: jrecon.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))),
        sd_np(recon))

    class Recon:
        apply = staticmethod(jit_fast(jrecon.apply))

    return dict(dir=d, det=det, fan=fan, recon=recon, jdet=(jit_fast(det_fn), det_params),
                jfan=(jit_fast(jfan.apply), fan_params), jrecon=(Recon(), recon_params),
                lm3d=JF.load_lm3d(str(d / "lm3d.mat")))


def test_read_and_smooth_match_jax(setup):
    got, fps = PV.read_video_frames(str(setup["dir"] / "drive.mp4"))
    want, want_fps = JV.read_video_frames(str(setup["dir"] / "drive.mp4"))
    np.testing.assert_array_equal(got, want)
    assert fps == want_fps == 25 and got.shape == (3, 200, 240, 3)
    x = np.random.RandomState(0).randn(7, 6).astype(np.float32)
    np.testing.assert_array_equal(PV.smooth_3dmm_params(x), JV.smooth_3dmm_params(x))


def _miss_second(detect):
    """detect_face with its second call's detection withheld."""
    calls = []

    def wrapped(*args):
        calls.append(1)
        return None if len(calls) == 2 else detect(*args)
    return wrapped


def test_detect_video_boxes_match_jax(setup, monkeypatch):
    """Both packages' boxes, frame 1's detection withheld in both: it
    reuses frame 0's box."""
    import mofa_tpu.models.mp_face as JM
    frames = np.stack(_frames(3, 256, 256, seed=1))
    monkeypatch.setattr(PV, "detect_face", _miss_second(PV.detect_face))
    monkeypatch.setattr(JM, "detect_face", _miss_second(JM.detect_face))
    got = PV.detect_video_boxes(frames, setup["det"])
    want = JV.detect_video_boxes(frames, *setup["jdet"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got[1], got[0])
    assert (got[:, 2] - got[:, 0] > 10).all() and not np.array_equal(got[0], [0, 0, 256, 256])


def test_fit_driving_video_matches_jax(setup, no_pil):
    s = setup
    got, fps = PV.fit_driving_video(str(s["dir"] / "drive.mp4"), s["det"], s["fan"],
                                    s["recon"], s["lm3d"])
    sys.modules.pop("PIL")                  # the JAX package resizes through PIL
    want, _ = JV.fit_driving_video(str(s["dir"] / "drive.mp4"), *s["jdet"], *s["jfan"],
                                   *s["jrecon"], s["lm3d"])
    assert got.shape == (3, 70) and fps == 25
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def _write_wav(path, seconds, seed, rate=16000):
    pcm = (np.random.RandomState(seed).uniform(-0.3, 0.3, int(seconds * rate)) * 32767)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes(pcm.astype(np.int16).tobytes())


def test_task_clis_without_pil(setup, tmp_path, no_pil):
    """face_fit_app --task, the aniportrait engine's --task and the video
    engine's --driving_video through `main`, PIL blocked."""
    import cv2
    s, d = setup, tmp_path
    task, lm3d = str(s["dir"] / "face.task"), str(s["dir"] / "lm3d.mat")
    cv2.imwrite(str(d / "in.png"), _frames(1, 180, 160, seed=2)[0])
    face_fit_app.main(["--image", str(d / "in.png"), "--lm3d_mat", lm3d, "--save",
                       str(d / "coeff.npz"), "--device", "cpu", "--tiny", "--fan_tiny",
                       "--task", task])
    out = np.load(d / "coeff.npz", allow_pickle=True)
    assert out["full_3dmm"].shape == (1, 257) and np.isfinite(out["full_3dmm"]).all()

    _write_wav(d / "a.wav", 0.3, 3)
    common = ["--ref_image_path", str(d / "in.png"), "--audio_path", str(d / "a.wav"),
              "--device", "cpu", "--task", task]
    # the aniportrait engine's reference face (its audio half: test_torch_audio.py)
    args = audio2ldmk_app.build_parser().parse_args(common + ["--save_dir", str(d / "ap")])
    img = cv2.imread(str(d / "in.png"))[..., ::-1]
    face = audio2ldmk_app.extract_face(args, img, "cpu")
    lmks, lmks3d, trans = audio2ldmk_app.reference_face(face, 160, 180)
    assert lmks.shape == (478, 2) and lmks3d.shape == (468, 3) and trans.shape == (4, 4)
    assert np.isfinite(lmks).all() and np.isfinite(lmks3d).all()

    write_bfm_mat(str(d / "bfm.mat"), 8, 8, seed=12)
    coeff = out["full_3dmm"].copy()
    coeff[0, 224:227], coeff[0, 254:257] = (0.05, -0.1, 0.02), (0.0, 0.05, 0.0)
    np.savez(d / "coeff2.npz", full_3dmm=coeff, trans_params=out["trans_params"],
             crop_info=out["crop_info"])
    audio2ldmk_app.main(common + [
        "--engine", "video", "--coeff_npz", str(d / "coeff2.npz"), "--bfm_mat",
        str(d / "bfm.mat"), "--driving_video", str(s["dir"] / "drive.mp4"), "--fan_tiny",
        "--recon_tiny", "--lm3d_mat", lm3d, "--save_dir", str(d / "vid")])
    lm = np.load(d / "vid" / "landmarks.npy")
    assert lm.shape == (4, 68, 2) and np.isfinite(lm).all()
