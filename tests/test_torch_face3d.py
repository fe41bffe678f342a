"""The port's face stack against the JAX package, on the CPU: FAN, fit, render, CLIs.

- the AWing FAN (two modules, so the boundary channels and the inter-module
  convs run) and ReconNet at the JAX tests' tiny size within `_close`'s
  1e-4 of max |JAX|, fp32, their weights the port's seeded state dicts
  carried into Flax by mofa_tpu's `convert_fan_state_dict` /
  `convert_face3d_recon_state_dict` (strict); the heatmap decode and the
  98 -> 68 map equal; `get_landmarks` (one module) to 1e-4 px;
- `align_img` equal to mofa_tpu's PIL version (trans_params, the 224 crop
  pixel for pixel, also where the crop leaves the image), and `fit_image`
  with the tiny net: trans_params to 1e-5, full_3dmm as the nets;
- the shading equal to 1e-6, and the z-buffer against mofa_tpu's on small
  meshes (a synthetic BFM's grid; hand-made occlusion, interpolation,
  face 0 under `mask_quirk`, ties within and across blocks): masks equal,
  colours within 1e-5 where both hit;
- the strict checkpoint readers of ReconNet (.pth.tar under "net_recon",
  SadTalker's combined .safetensors) and the FAN;
- the CLIs, port only on the CPU: face_fit_app (--fan_tiny --tiny
  --bbox), audio2ldmk_app --engine sadtalker --face3dvis and --engine
  video, opendomain_app --engine sadtalker at the keypoint app's tiny
  settings.
"""

import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mofa_tpu.models import face_alignment as JA
from mofa_tpu.models.audio import face3d_fit as JF
from mofa_tpu.models.audio import face3d_render as JR
from mofa_tpu.models.audio.sadtalker import BFMModel as JBFMModel
from mofa_tpu.models.weights import (convert_face3d_recon_state_dict,
                                     convert_fan_state_dict)

from chip_smoke import write_bfm_mat
from mofa_tpu_torch.apps import audio2ldmk_app, face_fit_app, opendomain_app
from mofa_tpu_torch.apps.loaders import init_random_cmp_
from mofa_tpu_torch.models import face_alignment as PA
from mofa_tpu_torch.models.audio import face3d_fit as PF
from mofa_tpu_torch.models.audio import face3d_render as PR
from mofa_tpu_torch.models.audio.sadtalker import BFMModel
from mofa_tpu_torch.models.weights import save_safetensors
from tests.test_torch_audio import _close
from tests.torch_port_util import jit_fast, sd_np, template
from tests.torch_port_util import (flax_apply_without_shape_recheck,  # noqa: F401
                                   one_torch_thread)  # (both autouse)


def _seeded(net, seed):
    return init_random_cmp_(net, torch.Generator().manual_seed(seed)).eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# ------------------------------------------------------------------ FAN

@pytest.fixture(scope="module")
def fan_pair():
    """One-module FANs at 256^2 (the app's input)."""
    port = _seeded(PA.FAN(num_modules=1), 1)
    tree = template(lambda: JA.FAN(num_modules=1).init(jax.random.PRNGKey(0),
                                                       jnp.zeros((1, 64, 64, 3))))
    return port, jit_fast(JA.FAN(num_modules=1).apply), convert_fan_state_dict(
        tree, sd_np(port))


def test_fan_two_modules_matches_jax():
    """Two modules at 64^2: the boundary channels of the second hourglass
    and the bl / al convs between modules run; facexlib's names."""
    port = _seeded(PA.FAN(num_modules=2), 2)
    assert {"m1.coordconv.conv.weight", "conv2.downsample.2.weight", "al0.weight",
            "m0.b2_plus_1.conv3.weight"} <= set(port.state_dict())
    tree = template(lambda: JA.FAN(num_modules=2).init(jax.random.PRNGKey(0),
                                                       jnp.zeros((1, 64, 64, 3))))
    params = convert_fan_state_dict(tree, sd_np(port))
    x = np.random.RandomState(3).rand(1, 64, 64, 3).astype(np.float32)
    want = jit_fast(JA.FAN(num_modules=2).apply)(params, x)
    with torch.no_grad():
        got = port(_nchw(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g.numpy().transpose(0, 2, 3, 1), w)


def test_fan_landmarks_match_jax(fan_pair):
    """get_landmarks on an 80 x 70 crop (cv2 resize to 256, BGR), the
    decode and the 98 -> 68 map."""
    port, j_apply, params = fan_pair
    crop = (np.random.RandomState(4).rand(80, 70, 3) * 255).astype(np.uint8)
    got = PA.get_landmarks(port, crop)
    ref = JA.get_landmarks(j_apply, params, crop)
    assert got.shape == (98, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    heat = np.random.RandomState(5).rand(2, 98, 16, 16).astype(np.float32)
    np.testing.assert_array_equal(PA.calculate_points(heat), JA.calculate_points(heat))
    np.testing.assert_array_equal(PA.landmark_98_to_68(got), JA.landmark_98_to_68(got))


# ------------------------------------------------------------- the fit

@pytest.fixture(scope="module")
def recon_pair():
    port = _seeded(PF.ReconNet(**PF.TINY_RECON), 6)
    jnet = JF.ReconNet(layers=(1, 1, 1, 1), width=8)
    tree = template(lambda: jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    params = convert_face3d_recon_state_dict(tree, sd_np(port))

    class Jitted:
        apply = staticmethod(jit_fast(jnet.apply))

    return port, Jitted(), params


def test_reconnet_matches_jax(recon_pair):
    port, jm, params = recon_pair
    assert {"backbone.layer4.0.downsample.1.running_var",
            "final_layers.6.bias"} <= set(port.state_dict())
    x = np.random.RandomState(7).rand(1, 224, 224, 3).astype(np.float32)
    with torch.no_grad():
        got = port(_nchw(x)).numpy()
    assert got.shape == (1, 257)
    _close(got, jm.apply(params, x))


def _face_image(h, w, seed):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def _keypoints(cx, cy, scale, seed):
    """68 points about (cx, cy), y down, spread like a face's."""
    rng = np.random.RandomState(seed)
    return (np.array([cx, cy]) + rng.uniform(-1, 1, (68, 2)) * scale).astype(np.float32)


@pytest.mark.parametrize("where", ["centre", "corner"])
def test_align_and_fit_image_match_jax(recon_pair, where):
    """A face in the middle, and one near the corner whose 224 crop reaches
    outside the resized image (zeros there in both)."""
    port, jm, params = recon_pair
    img = _face_image(256, 240, 8)
    kp = (_keypoints(120, 128, 60, 9) if where == "centre"
          else _keypoints(10, 10, 100, 10))
    lm3d = np.random.RandomState(11).randn(5, 3).astype(np.float32)
    lm = kp.copy()
    lm[:, 1] = 255 - lm[:, 1]
    tp, im224, lm_new = PF.align_img(img, lm, lm3d)
    j_tp, j_im224, j_lm_new = JF.align_img(Image.fromarray(img), lm, lm3d)
    assert [float(np.asarray(v).reshape(-1)[0]) for v in tp] == \
        [float(np.asarray(v).reshape(-1)[0]) for v in j_tp]
    np.testing.assert_array_equal(im224, np.asarray(j_im224))
    np.testing.assert_array_equal(lm_new, j_lm_new)
    if where == "corner":                  # left, up < 0: a zero margin
        assert tp[5] < 0 and tp[6] < 0 and not im224[:40, :60].any()
    full, coeff, tp = PF.fit_image(port, img, kp, lm3d)
    j_full, j_coeff, j_tp = JF.fit_image(jm, params, Image.fromarray(img), kp, lm3d)
    assert full.shape == (1, 257) and coeff.shape == (1, 76) and tp.shape == (8,)
    np.testing.assert_allclose(tp, j_tp, rtol=1e-5, atol=0)
    _close(full, j_full)
    np.testing.assert_array_equal(coeff[0, 64:67], full[0, 224:227])
    np.testing.assert_array_equal(coeff[0, 70:], tp[2:])


# ------------------------------------------------------------- render

@pytest.fixture(scope="module")
def bfm_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("face3d")
    write_bfm_mat(str(root / "bfm.mat"), 16, 16, seed=12)
    # the CLIs' (98 faces: the CPU renders 224^2 frames of it)
    write_bfm_mat(str(root / "small.mat"), 8, 8, seed=13)
    return root


def test_shading_equals_jax(bfm_files):
    pb = BFMModel.load(str(bfm_files / "bfm.mat"), with_render_data=True)
    jb = JBFMModel.load(str(bfm_files / "bfm.mat"), with_render_data=True)
    np.testing.assert_array_equal(pb.face_buf, jb.face_buf)
    np.testing.assert_array_equal(pb.point_buf, jb.point_buf)
    coeffs = (np.random.RandomState(13).randn(2, 257) * 0.1).astype(np.float32)
    for got, ref in zip(PR.compute_for_render(pb, coeffs), JR.compute_for_render(jb, coeffs)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def _raster_pair(verts, tri, colors, **kw):
    got_img, got_mask = PR.rasterize_mesh(torch.from_numpy(verts), torch.from_numpy(tri),
                                          torch.from_numpy(colors), **kw)
    ref_img, ref_mask = JR.rasterize_mesh(jnp.asarray(verts), jnp.asarray(tri.astype(np.int32)),
                                          jnp.asarray(colors), **kw)
    got_img, got_mask = got_img.numpy(), got_mask.numpy()
    ref_img, ref_mask = np.asarray(ref_img), np.asarray(ref_mask)
    np.testing.assert_array_equal(got_mask, ref_mask)
    np.testing.assert_allclose(got_img[got_mask], ref_img[ref_mask], rtol=0, atol=1e-5)
    return got_img, got_mask


def test_render_face_video_matches_jax(bfm_files):
    """The grid BFM at 64^2 in blocks of 64 faces (450 faces, 8 blocks):
    coverage, the surface's self-occlusion, interpolated colours."""
    pb = BFMModel.load(str(bfm_files / "bfm.mat"), with_render_data=True)
    coeffs = (np.random.RandomState(14).randn(1, 257) * 0.1).astype(np.float32)
    verts, colors = PR.compute_for_render(pb, coeffs)
    img, mask = _raster_pair(verts[0], pb.face_buf, colors[0], size=64, focal=290.0,
                             center=32.0, face_chunk=64)
    assert 0.3 < mask.mean() < 1.0 and img[mask].std() > 0.01
    frames = PR.render_face_video(pb, np.repeat(coeffs, 2, 0), size=64, face_chunk=64)
    assert frames.shape == (2, 64, 64, 3) and frames.dtype == np.uint8
    np.testing.assert_array_equal(frames[0], frames[1])


# two triangles covering the centre of a 32^2 frame at camera depth ~10
_TRI_A = np.array([[-0.2, -0.2, 10.0], [0.2, -0.2, 10.0], [0.0, 0.25, 10.0]], np.float32)


def _mesh(*tris_and_colors):
    """[(verts [3, 3], colours [3, 3]), ...] -> (verts, tri, colours), a
    vertex set a triangle."""
    verts = np.concatenate([v for v, _ in tris_and_colors]).astype(np.float32)
    colors = np.concatenate([c for _, c in tris_and_colors]).astype(np.float32)
    tri = np.arange(len(verts), dtype=np.int64).reshape(-1, 3)
    return verts, tri, colors


def _flat(rgb):
    return np.tile(np.asarray(rgb, np.float32), (3, 1))


KW = dict(size=32, focal=400.0, center=16.0)


def test_rasterizer_rules_match_jax():
    near = _TRI_A - [0, 0, 2.0]                   # nearer the camera
    red, green, blue = _flat([1, 0, 0]), _flat([0, 1, 0]), _flat([0, 0, 1])
    # occlusion: the nearer face wins in either order and block split
    for order in ((_TRI_A, red, near, green), (near, green, _TRI_A, red)):
        verts, tri, colors = _mesh((order[0], order[1]), (order[2], order[3]))
        for chunk in (1, 2):
            img, mask = _raster_pair(verts, tri, colors, face_chunk=chunk,
                                     mask_quirk=False, **KW)
            assert mask.sum() > 20
            np.testing.assert_allclose(img[mask], np.broadcast_to([0, 1, 0], img[mask].shape),
                                       atol=1e-5)
    # mask_quirk: face 0 is background
    verts, tri, colors = _mesh((_TRI_A, red))
    _, mask = _raster_pair(verts, tri, colors, face_chunk=4, mask_quirk=True, **KW)
    assert not mask.any()
    # interpolation: a colour ramp over a slanted face, perspective-correct
    slant = _TRI_A + np.array([[0, 0, -1.5], [0, 0, 1.5], [0, 0, 0]], np.float32)
    verts, tri, colors = _mesh((slant, np.eye(3, dtype=np.float32)))
    img, mask = _raster_pair(verts, tri, colors, face_chunk=4, mask_quirk=False, **KW)
    np.testing.assert_allclose(img[mask].sum(-1), 1.0, atol=1e-5)
    # outside znear / zfar: nothing drawn
    verts, tri, colors = _mesh((_TRI_A + [0, 0, 6.0], red), (_TRI_A - [0, 0, 5.5], blue))
    _, mask = _raster_pair(verts, tri, colors, face_chunk=2, mask_quirk=False, **KW)
    assert not mask.any()


@pytest.mark.parametrize("chunk", [4, 1], ids=["one_block", "two_blocks"])
def test_rasterizer_ties_keep_the_first_face(chunk):
    """Two faces at the same place and depth: within a block argmin keeps
    the first, across blocks the strict < keeps the earlier block's."""
    verts, tri, colors = _mesh((_TRI_A, _flat([1, 0, 0])), (_TRI_A, _flat([0, 0, 1])))
    img, mask = _raster_pair(verts, tri, colors, face_chunk=chunk, mask_quirk=False, **KW)
    assert mask.sum() > 20
    np.testing.assert_allclose(img[mask], np.broadcast_to([1, 0, 0], img[mask].shape),
                               atol=1e-5)


# ------------------------------------------------------- checkpoints

def test_face_checkpoints_load_strict(tmp_path):
    """ReconNet from a Deep3DFaceRecon-style .pth.tar ({"net_recon": ...},
    `module.` prefixes, BatchNorm counters) and from a SadTalker-style
    .safetensors (`face_3drecon.` keys beside another model's), the FAN
    from facexlib's {"state_dict": ...}: every tensor equal; a missing or
    an unexpected key raises."""
    recon, fan = _seeded(PF.ReconNet(**PF.TINY_RECON), 15), _seeded(PA.FAN(1), 16)
    rsd = recon.state_dict()
    torch.save({"net_recon": {f"module.{k}": v for k, v in rsd.items()}, "epoch": 20},
               tmp_path / "epoch_20.pth.tar")
    combined = {f"face_3drecon.{k}": v for k, v in rsd.items()}
    combined["audio2exp.mapping1.weight"] = torch.zeros(64, 577)
    save_safetensors(combined, str(tmp_path / "sadtalker.safetensors"))
    torch.save({"state_dict": fan.state_dict()}, tmp_path / "fan.pth")
    for ckpt in ("epoch_20.pth.tar", "sadtalker.safetensors"):
        got, got_fan = face_fit_app.load_face_nets(
            str(tmp_path / ckpt), str(tmp_path / "fan.pth"), "cpu", tiny=True, fan_tiny=True)
        for net, want in ((got, recon), (got_fan, fan)):
            for k, v in want.state_dict().items():
                if not k.endswith("num_batches_tracked"):
                    assert torch.equal(net.state_dict()[k], v), (ckpt, k)
    bad = {k: v for k, v in rsd.items() if k != "final_layers.3.bias"}
    torch.save(bad, tmp_path / "missing.pth")
    with pytest.raises(RuntimeError, match="final_layers.3.bias"):
        face_fit_app.load_face_nets(str(tmp_path / "missing.pth"), None, "cpu", tiny=True,
                                    fan=False)
    torch.save({**rsd, "backbone.fc.weight": torch.zeros(3)}, tmp_path / "extra.pth")
    with pytest.raises(RuntimeError, match="backbone.fc.weight"):
        face_fit_app.load_face_nets(str(tmp_path / "extra.pth"), None, "cpu", tiny=True,
                                    fan=False)


# ------------------------------------------------------------- CLIs

def _write_wav(path, seconds, seed, sr=16000):
    pcm = (np.random.RandomState(seed).uniform(-0.4, 0.4, int(seconds * sr)) * 32767)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.astype(np.int16).tobytes())


def _frames(path):
    import cv2
    cap = cv2.VideoCapture(str(path))
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


def test_face_fit_then_sadtalker_clis_on_cpu(tmp_path, bfm_files):
    """face_fit_app (the one-module FAN on a box, the tiny ReconNet) writes
    the npz contract; audio2ldmk_app's sadtalker engine reads it with the
    grid BFM and renders --face3dvis; the video engine retargets a driving
    track; --task and --driving_video refuse to run without their inputs
    (their runs: tests/test_torch_video_fit.py)."""
    from scipy.io import savemat
    d = tmp_path
    Image.fromarray(_face_image(90, 100, 17)).save(d / "in.png")
    savemat(d / "lm3d.mat", {"lm": np.random.RandomState(18).randn(68, 3)})
    fit = ["--image", str(d / "in.png"), "--lm3d_mat", str(d / "lm3d.mat"),
           "--save", str(d / "coeff.npz"), "--device", "cpu", "--tiny"]
    face_fit_app.main(fit + ["--fan_tiny", "--bbox", "30,20,200,230"])
    out = np.load(d / "coeff.npz", allow_pickle=True)
    assert out["full_3dmm"].shape == (1, 257) and out["coeff_3dmm"].shape == (1, 76)
    assert out["trans_params"].shape == (8,) and np.isfinite(out["full_3dmm"]).all()
    assert out["trans_params"][:2].tolist() == [256, 256]
    assert out["crop_info"].tolist()[0] == (256, 256)
    with pytest.raises(SystemExit, match="need --kp or --fan_ckpt"):
        face_fit_app.main(fit + ["--task", "x.task"])

    # a fitted face's pose (small angles, the BFM in front of the camera)
    coeff = out["full_3dmm"].copy()
    coeff[0, 224:227], coeff[0, 254:257] = (0.05, -0.1, 0.02), (0.0, 0.05, 0.0)
    np.savez(d / "coeff2.npz", full_3dmm=coeff, trans_params=out["trans_params"],
             crop_info=out["crop_info"])
    _write_wav(d / "a.wav", 0.2, 19)
    common = ["--ref_image_path", str(d / "in.png"), "--audio_path", str(d / "a.wav"),
              "--coeff_npz", str(d / "coeff2.npz"), "--bfm_mat", str(bfm_files / "small.mat"),
              "--device", "cpu"]
    audio2ldmk_app.main(common + ["--engine", "sadtalker", "--face3dvis",
                                  "--save_dir", str(d / "st")])
    lm = np.load(d / "st" / "landmarks.npy")
    assert lm.shape == (6, 68, 2) and np.isfinite(lm).all()
    assert _frames(d / "st" / "3dface.mp4") == 5
    assert _frames(d / "st" / "landmarks_vis.mp4") == 6

    np.savez(d / "drive.npz", coeff_3dmm=(np.random.RandomState(20).randn(9, 70)
                                          * 0.05).astype(np.float32))
    audio2ldmk_app.main(common + ["--engine", "video", "--driving_coeffs_npz",
                                  str(d / "drive.npz"), "--save_dir", str(d / "vid")])
    lm = np.load(d / "vid" / "landmarks.npy")
    assert lm.shape == (10, 68, 2) and np.isfinite(lm).all()
    for extra, msg in ((["--engine", "video", "--driving_video", "x.mp4"], "needs --task"),
                       (["--engine", "video", "--driving_video", "x.mp4", "--task", "x.task"],
                        "needs --lm3d_mat"),
                       (["--engine", "video"], "needs --driving_video or")):
        with pytest.raises(SystemExit, match=msg):
            audio2ldmk_app.main(common + extra + ["--save_dir", str(d / "x")])
    with pytest.raises(SystemExit, match="needs --bfm_mat"):
        audio2ldmk_app.main(common[:6] + ["--engine", "sadtalker", "--device", "cpu",
                                          "--save_dir", str(d / "x")])
    assert not (d / "x").exists()


def test_opendomain_sadtalker_cli_on_cpu(tmp_path, bfm_files):
    """Audio -> SadTalker landmarks -> a 7-frame keypoint video (windows of
    4, stride 2) at the micro widths, from a coefficient npz and the grid
    BFM, without --face_npz."""
    d = tmp_path
    Image.fromarray(_face_image(70, 90, 21)).save(d / "in.png")
    coeff = (np.random.RandomState(22).randn(1, 257) * 0.05).astype(np.float32)
    np.savez(d / "coeff.npz", full_3dmm=coeff,
             trans_params=np.array([90, 70, 0.8, 45, 35, 0, 0, 224], np.float32),
             crop_info=np.array(((90, 70), (0, 0, 90, 70), (0, 0, 90, 70)), object))
    _write_wav(d / "a.wav", 0.5, 23)
    opendomain_app.main(["--engine", "sadtalker", "--image", str(d / "in.png"),
                         "--audio", str(d / "a.wav"), "--coeff_npz", str(d / "coeff.npz"),
                         "--bfm_mat", str(bfm_files / "small.mat"), "--work_dir",
                         str(d / "w"), "--output", str(d / "out.mp4"), "--device", "cpu",
                         "--tiny", "--target_size", "64", "--num_frames", "7",
                         "--window_size", "4", "--stride", "2",
                         "--num_inference_steps", "1"])
    lm = np.load(d / "w" / "landmarks.npy")
    assert lm.shape == (13, 68, 2) and np.isfinite(lm).all()
    assert os.path.getsize(d / "out.mp4") > 0 and _frames(d / "w" / "video_silent.mp4") == 7
