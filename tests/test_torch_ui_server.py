"""The port's browser UI server (mofa_tpu_torch/apps/ui_server.py) and logger, on the CPU.

- Data URLs through cv2: an RGBA and an RGB PNG decode as Pillow's
  convert("RGB") decodes them (alpha dropped, not composited), and the
  encoder's PNG decodes back to its array;
- `/preprocess` equal to mofa_tpu's UI backend on the same image; the
  brush's 384^2 resize equal to Pillow's NEAREST; `visualize_drag` equal to
  mofa_tpu's bit for bit;
- the HTTP plumbing on 127.0.0.1:0 with the generation faked: the page,
  /preprocess, /preview, /run, /video, a 404, a 500 carrying the error's
  message, and a good request after it;
- one real `/run` at the MICRO / TINY widths with --device cpu and PIL
  blocked: its frames equal to `traj_app.generate` on the same image,
  tracks, brush and seed, the mp4 of /video holding every frame;
- `/run_landmarks` routed to the port's hybrid and keypoint CLIs with the
  server's --device;
- `get_logger`'s format and `MetricsWriter`'s JSONL lines against
  mofa_tpu.utils.logging, and the trainer apps logging through it.
"""

import base64
import io
import json
import logging
import re
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from mofa_tpu.apps import ui_server as jui
from mofa_tpu.preprocess.traj import visualize_drag as jax_visualize_drag
from mofa_tpu.utils import logging as jlogging

from mofa_tpu_torch.apps import traj_app
from mofa_tpu_torch.apps import ui_server as ui
from mofa_tpu_torch.apps.loaders import load_bundle, load_cmp
from mofa_tpu_torch.models.clip_vision import TINY_CLIP_CONFIG
from mofa_tpu_torch.models.cmp.model import TINY_CMP_CONFIG
from mofa_tpu_torch.models.svd_unet import MICRO_UNET_CONFIG
from mofa_tpu_torch.models.vae import TINY_VAE_CONFIG
from mofa_tpu_torch.preprocess.image import read_image
from mofa_tpu_torch.preprocess.traj import visualize_drag
from mofa_tpu_torch.utils import logging as plogging
from mofa_tpu_torch.utils.profiling import PhaseTimer
from tests.test_torch_image_io import no_pil  # noqa: F401
from tests.torch_port_util import one_torch_thread  # noqa: F401

TINY = ["--device", "cpu", "--tiny", "--num_frames", "3", "--num_inference_steps", "1",
        "--port", "0"]


def _pil_png_url(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _image(h, w, seed, channels=3):
    return (np.random.RandomState(seed).rand(h, w, channels) * 255).astype(np.uint8)


@pytest.mark.parametrize("channels", [4, 3])
def test_data_urls_through_cv2_equal_pillow(channels):
    arr = _image(20, 30, channels, channels)
    if channels == 4:
        arr[..., 3] = np.where(arr[..., 3] > 128, arr[..., 3], 0)   # transparent pixels
    url = _pil_png_url(arr)
    want = np.asarray(Image.open(io.BytesIO(base64.b64decode(url.split(",")[1])))
                      .convert("RGB"))
    np.testing.assert_array_equal(ui.data_url_to_array(url), want)
    rgb = arr[..., :3]
    back = Image.open(io.BytesIO(base64.b64decode(ui.array_to_data_url(rgb).split(",")[1])))
    np.testing.assert_array_equal(np.asarray(back), rgb)
    grey = arr[..., 0]
    np.testing.assert_array_equal(ui.data_url_to_array(ui.array_to_data_url(grey)),
                                  np.repeat(grey[..., None], 3, -1))


def test_preprocess_equals_mofa_tpu_backend():
    args = ui.build_parser().parse_args(TINY + ["--target_size", "128"])
    backend = ui.TrajUIBackend(args)
    jbackend = jui.TrajUIBackend(jui.build_parser().parse_args(["--tiny"]))
    for h, w in ((200, 260), (97, 131)):
        url = _pil_png_url(_image(h, w, h))
        got, want = (b.preprocess({"image": url, "target_size": 128})
                     for b in (backend, jbackend))
        assert (got["height"], got["width"]) == (want["height"], want["width"])
        np.testing.assert_array_equal(ui.data_url_to_array(got["image"]),
                                      jui._data_url_to_array(want["image"]))


@pytest.mark.parametrize("hw", [(576, 1024), (64, 128), (500, 300)])
def test_brush_resize_equals_pillow_nearest(hw):
    brush = (np.random.RandomState(5).rand(*hw) > 0.5).astype(np.uint8) * 255
    want = np.asarray(Image.fromarray(brush).resize((384, 384), Image.NEAREST))
    np.testing.assert_array_equal(traj_app.nearest_resize(brush, 384), want)


def test_visualize_drag_equals_mofa_tpu():
    image = np.random.RandomState(6).rand(60, 90, 3).astype(np.float32)
    tracks = [[(3, 4), (40, 30), (70, 50)], [(10, 50)], [(80, 5), (20, 55)]]
    got = visualize_drag(image, tracks)
    assert got.dtype == np.uint8 and got.shape == (60, 90, 3)
    np.testing.assert_array_equal(got, jax_visualize_drag(image, tracks))


def _serve(backend):
    from http.server import ThreadingHTTPServer
    server = ThreadingHTTPServer(("127.0.0.1", 0), ui.make_handler(backend))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=60).read())


def test_http_round_trip_with_fakes(monkeypatch):
    args = ui.build_parser().parse_args(TINY)
    backend = ui.TrajUIBackend(args)
    seen = {}

    def fake_generate(image01, tracks, cmp_loader, bundle_loader, *, brush=None, **kw):
        seen.update(tracks=tracks, brush=brush, kw=kw)
        return torch.zeros(kw["num_frames"], *image01.shape), None

    def fake_drag_flow(engine, image, tracks, num_frames, brush=None):
        h, w = image.shape[1:3]
        return torch.ones(1, num_frames - 1, h, w, 2)

    monkeypatch.setattr(ui, "generate", fake_generate)
    monkeypatch.setattr(ui, "drag_flow", fake_drag_flow)
    monkeypatch.setattr(backend, "cmp", lambda: torch.nn.Conv2d(1, 1, 1))
    server, thread, base = _serve(backend)
    try:
        page = urllib.request.urlopen(base + "/", timeout=60).read().decode()
        assert "MOFA" in page and "canvas" in page and "/run_landmarks" in page
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/video", timeout=60)
        assert e.value.code == 404
        pre = _post(base + "/preprocess", {"image": _pil_png_url(_image(70, 90, 1)),
                                           "target_size": 64})
        assert (pre["height"], pre["width"]) == (64, 64)
        tracks = [[[3, 4], [10, 12]]]
        prev = _post(base + "/preview", {"image": pre["image"], "tracks": tracks})
        assert ui.data_url_to_array(prev["flow"]).shape == (64, 64, 3)
        assert ui.data_url_to_array(prev["hint"]).shape == (64, 64, 3)
        brush = np.zeros((64, 64, 3), np.uint8)
        brush[:20] = 255
        resp = _post(base + "/run", {"image": pre["image"], "tracks": tracks,
                                     "brush": _pil_png_url(brush)})
        assert resp == {"video": "/video"}
        assert seen["tracks"] == [[(3, 4), (10, 12)]]
        assert seen["brush"].shape == (64, 64) and seen["brush"].max() == 255
        assert seen["kw"]["seed"] == args.seed and seen["kw"]["num_frames"] == 3
        video = urllib.request.urlopen(base + "/video", timeout=60).read()
        assert len(video) > 100
        for body, needle in (({"image": pre["image"], "tracks": []}, "trajectory"),
                             ({"image": _pil_png_url(_image(70, 90, 2)), "tracks": tracks},
                              "multiples of 64"),
                             ({"image": "no-comma", "tracks": tracks}, "unpack")):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + "/run", body)
            assert e.value.code == 500 and needle in e.value.read().decode()
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/nothing", {})
        assert e.value.code == 404
        # the server keeps serving after the failures
        assert _post(base + "/run", {"image": pre["image"], "tracks": tracks}) == resp
        assert seen["brush"] is None
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_run_equals_generate_without_pil(no_pil, monkeypatch, tmp_path):
    """/preprocess and a real /run at the tiny widths with PIL blocked; the
    frames equal `traj_app.generate` called directly with the same models'
    seeds, image, tracks, brush and seed."""
    import cv2

    args = ui.build_parser().parse_args(TINY + ["--seed", "7"])
    server = ui.make_server(args)
    assert server.backend.device == torch.device("cpu")
    frames_seen = []

    def spy(*a, **kw):
        out = traj_app.generate(*a, **kw)
        frames_seen.append(out[0])
        return out

    monkeypatch.setattr(ui, "generate", spy)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        pre = _post(base + "/preprocess", {"image": ui.array_to_data_url(_image(80, 100, 3)),
                                           "target_size": 64})
        tracks = [[[10, 12], [30, 20], [40, 44]], [[50, 50], [45, 30]]]
        brush = np.zeros((pre["height"], pre["width"]), np.uint8)
        brush[:32] = 255
        _post(base + "/run", {"image": pre["image"], "tracks": tracks,
                              "brush": ui.array_to_data_url(brush)})
        (tmp_path / "out.mp4").write_bytes(
            urllib.request.urlopen(base + "/video", timeout=60).read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    image01 = ui.data_url_to_array(pre["image"]).astype(np.float32) / 255.0
    want, _ = traj_app.generate(
        image01, [[tuple(p) for p in tr] for tr in tracks],
        lambda: load_cmp(None, "cpu", cfg=TINY_CMP_CONFIG),
        lambda: load_bundle(None, None, "cpu", torch.float32, unet_cfg=MICRO_UNET_CONFIG,
                            vae_cfg=TINY_VAE_CONFIG, clip_cfg=TINY_CLIP_CONFIG),
        timer=PhaseTimer(), brush=brush.astype(np.float32), num_frames=3,
        num_inference_steps=1, seed=7)
    assert len(frames_seen) == 1 and frames_seen[0].shape == (3, 64, 64, 3)
    assert torch.isfinite(want).all()
    torch.testing.assert_close(frames_seen[0], want, rtol=0, atol=0)
    cap = cv2.VideoCapture(str(tmp_path / "out.mp4"))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 3


@pytest.mark.parametrize("mode", ["hybrid", "keypoint"])
def test_run_landmarks_routes_to_the_port_clis(mode, monkeypatch):
    from mofa_tpu_torch.apps import hybrid_app, keypoint_app
    app = hybrid_app if mode == "hybrid" else keypoint_app
    seen = {}

    def fake_run(parsed):
        seen["args"] = parsed
        seen["landmarks"] = np.load(parsed.landmarks)
        seen["image"] = read_image(parsed.image)
        if getattr(parsed, "face_mask", None):
            seen["mask"] = read_image(parsed.face_mask, "L")
        if getattr(parsed, "tracks", None):
            with open(parsed.tracks) as f:
                seen["tracks"] = json.load(f)["tracks"]
        with open(parsed.output, "wb") as f:
            f.write(b"\x00" * 200)

    monkeypatch.setattr(app, "run", fake_run)
    backend = ui.TrajUIBackend(ui.build_parser().parse_args(TINY + ["--bf16"]))
    img = _image(32, 48, 4)
    lm = np.random.RandomState(4).rand(5, 68, 2).astype(np.float32)
    buf = io.BytesIO()
    np.save(buf, lm)
    brush = np.zeros((32, 48, 3), np.uint8)
    brush[4:9, 6:20] = 255
    resp = backend.run_landmarks({
        "image": ui.array_to_data_url(img), "mode": mode, "target_size": 320,
        "landmarks": base64.b64encode(buf.getvalue()).decode(),
        "tracks": [[[1, 2], [3, 4]]], "brush": ui.array_to_data_url(brush)})
    assert resp == {"video": "/video"} and backend.last_video == b"\x00" * 200
    parsed = seen["args"]
    assert (parsed.device, parsed.tiny, parsed.bf16, parsed.target_size) == ("cpu", True,
                                                                            True, 320)
    assert parsed.num_inference_steps == 1 and parsed.seed == 42
    np.testing.assert_array_equal(seen["landmarks"], lm)
    np.testing.assert_array_equal(seen["image"], img)
    if mode == "hybrid":
        assert seen["tracks"] == [[[1, 2], [3, 4]]]
        np.testing.assert_array_equal(seen["mask"], brush[..., 0])
    else:       # the keypoint app takes neither
        assert "mask" not in seen and "tracks" not in seen
    with pytest.raises(ValueError, match="landmarks"):
        backend.run_landmarks({"image": ui.array_to_data_url(img), "mode": mode})
    with pytest.raises(ValueError, match="mode"):
        backend.run_landmarks({"image": ui.array_to_data_url(img), "landmarks": "aa",
                               "mode": "bogus"})


def test_device_defaults_to_cuda():
    args = ui.build_parser().parse_args([])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ui.TrajUIBackend(args)


def test_logger_and_metrics_equal_mofa_tpu(tmp_path, monkeypatch):
    port = plogging.get_logger("ui_test_port")
    ref = jlogging.get_logger("ui_test_jax")
    assert plogging.get_logger("ui_test_port") is port and len(port.handlers) == 1
    assert not port.propagate and port.level == logging.INFO
    record = logging.LogRecord("train", logging.WARNING, __file__, 1, "step %d", (3,), None)
    assert (port.handlers[0].formatter.format(record)
            == ref.handlers[0].formatter.format(record))
    assert re.fullmatch(r"\d\d:\d\d:\d\d WARNING train: step 3",
                        port.handlers[0].formatter.format(record))
    monkeypatch.setattr("time.time", lambda: 1234.5)
    with plogging.MetricsWriter(str(tmp_path / "p")) as w:
        w.write(1, loss=np.float32(0.25), lr=1e-4)
        w.write(2, loss=0.5)
    jw = jlogging.MetricsWriter(str(tmp_path / "j"))
    jw.write(1, loss=np.float32(0.25), lr=1e-4)
    jw.write(2, loss=0.5)
    jw.close()
    got = (tmp_path / "p" / "metrics.jsonl").read_text()
    assert got == (tmp_path / "j" / "metrics.jsonl").read_text()
    assert json.loads(got.splitlines()[0]) == {"step": 1, "time": 1234.5, "loss": 0.25,
                                               "lr": 1e-4}


def test_trainer_apps_log_where_the_jax_apps_do():
    """Each trainer app logs through get_logger under the JAX app's logger
    name and prints nothing but eval_flow_app's result line."""
    root = Path(__file__).resolve().parent.parent
    for app, name in (("train_app", "train"), ("train_cmp_app", "train_cmp"),
                      ("train_flow_app", "train_flow"), ("eval_flow_app", "eval_flow")):
        src = (root / "mofa_tpu_torch" / "apps" / f"{app}.py").read_text()
        jsrc = (root / "mofa_tpu" / "apps" / f"{app}.py").read_text()
        assert f'get_logger("{name}")' in src and f'get_logger("{name}")' in jsrc
        prints = re.findall(r"^\s*print\(", src, re.M)
        assert len(prints) == (1 if app == "eval_flow_app" else 0), app
