"""The port's trajectory slice against the JAX package, end to end, on CPU.

One video made twice — by `mofa_tpu.pipelines.traj.TrajPipeline` and by
`mofa_tpu_torch.pipelines.traj.TrajPipeline` — from the same random
weights (the port's seeded state dicts, converted by mofa_tpu's own
checkpoint converters), the same latents and the same dense flow, at
MICRO_UNET_CONFIG / TINY_VAE_CONFIG / the tiny CLIP of
test_fullchain_parity.py, T=4, 64x128, 2 steps, fp32, bug_compat on,
noise augmentation off. Also: the port imports neither jax nor mofa_tpu,
and CPU tensors leave every kernel launch counter at 0.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mofa_tpu.models.clip_vision import CLIPVisionConfig as JCLIPConfig
from mofa_tpu.models.cmp.model import TINY_CMP_CONFIG as J_TINY_CMP
from mofa_tpu.ops.resize import resize_nhwc as j_resize_nhwc
from mofa_tpu.ops.trajectory import interpolate_trajectory as j_interp
from mofa_tpu.preprocess.traj import DragFlowEngine as JDragFlowEngine
from mofa_tpu.preprocess.traj import divide_points_afterinterpolate as j_divide
from mofa_tpu.preprocess.traj import prepare_trajectory_flow as j_prepare
from mofa_tpu.models.svd_unet import MICRO_UNET_CONFIG as J_MICRO
from mofa_tpu.models.vae import TINY_VAE_CONFIG as J_TINY_VAE
from mofa_tpu.pipelines.common import ModelBundle as JBundle
from mofa_tpu.pipelines.traj import TrajPipeline as JTrajPipeline

from mofa_tpu_torch import kernels
from mofa_tpu_torch.apps.loaders import init_random_cmp_
from mofa_tpu_torch.apps.traj_app import drag_flow
from mofa_tpu_torch.models.clip_vision import CLIPVisionConfig
from mofa_tpu_torch.models.cmp.model import CMP, TINY_CMP_CONFIG
from mofa_tpu_torch.models.svd_unet import MICRO_UNET_CONFIG
from mofa_tpu_torch.models.vae import TINY_VAE_CONFIG
from mofa_tpu_torch.pipelines.common import ModelBundle
from mofa_tpu_torch.pipelines.traj import TrajPipeline
from mofa_tpu_torch.preprocess.traj import DragFlowEngine
from tests.torch_port_util import (jax_clip, jax_cmp, jax_flow_controlnet,
                                   jax_unet, jax_vae)
from tests.torch_port_util import (flax_apply_without_shape_recheck,  # noqa: F401
                                   one_torch_thread)  # (both autouse)

H, W, T, STEPS = 64, 128, 4, 2
CLIP_KW = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
               patch_size=16, image_size=48, projection_dim=32)


def jax_bundle_from(bundle: ModelBundle) -> JBundle:
    """mofa_tpu bundle holding the port bundle's weights."""
    unet, unet_p = jax_unet(J_MICRO, bundle.unet)
    cn, cn_p = jax_flow_controlnet(J_MICRO, bundle.controlnet)
    vae, vae_p = jax_vae(J_TINY_VAE, bundle.vae)
    clip, clip_p = jax_clip(JCLIPConfig(**CLIP_KW), bundle.clip)
    return JBundle(unet, unet_p, cn, cn_p, vae, vae_p, clip, clip_p)


@pytest.fixture(scope="module")
def pair():
    bundle = ModelBundle.init_random("cpu", torch.Generator().manual_seed(0),
                                     MICRO_UNET_CONFIG, TINY_VAE_CONFIG,
                                     CLIPVisionConfig(**CLIP_KW))
    # smaller random weights keep the tiny video inside [0, 1], so the
    # frame comparison is not flattened by the final clip
    with torch.no_grad():
        for p in bundle.vae.decoder.conv_out.parameters():
            p.mul_(0.05)
    rng = np.random.RandomState(42)
    inputs = dict(image01=rng.rand(1, H, W, 3).astype(np.float32),
                  flow=rng.rand(1, T - 1, H, W, 2).astype(np.float32) * 6 - 3,
                  latents=rng.randn(1, T, H // 8, W // 8, 4).astype(np.float32))
    return bundle, jax_bundle_from(bundle), inputs


def _run_port(bundle, inputs, output_type, bug_compat=True):
    out, _ = TrajPipeline(bundle, bug_compat=bug_compat)(
        torch.from_numpy(inputs["image01"]), torch.from_numpy(inputs["flow"]),
        num_inference_steps=STEPS, noise_aug_strength=0.0, fps=8,
        motion_bucket_id=100, latents=torch.from_numpy(inputs["latents"]),
        decode_chunk_size=8, output_type=output_type)
    return out.numpy()


class _OneCompileTraj(JTrajPipeline):
    """mofa_tpu's TrajPipeline with one jit program for both bug_compat
    settings: bug_compat only picks the added-time ids, outside the jit
    program, which takes them as an argument; the stock class keys its
    jit cache on bug_compat too, and so compiles the same program twice."""

    def __hash__(self):
        return hash((id(self.bundle), id(self.mesh)))

    def __eq__(self, other):
        return (isinstance(other, _OneCompileTraj) and other.bundle is self.bundle
                and other.mesh is self.mesh)


def _run_jax(jbundle, inputs, output_type, bug_compat=True):
    out, _ = _OneCompileTraj(jbundle, bug_compat=bug_compat)(
        jnp.asarray(inputs["image01"]), jnp.asarray(inputs["flow"]),
        num_inference_steps=STEPS, noise_aug_strength=0.0, fps=8,
        motion_bucket_id=100, latents=jnp.asarray(inputs["latents"]),
        decode_chunk_size=8, output_type=output_type)
    return np.asarray(out)


def test_traj_slice_matches_jax_psnr(pair):
    bundle, jbundle, inputs = pair
    kernels.reset_launch_counts()
    got = _run_port(bundle, inputs, "np")
    assert kernels.launch_counts() == {k: 0 for k in kernels.launch_counts()}
    ref = _run_jax(jbundle, inputs, "np")
    assert got.shape == ref.shape == (1, T, H, W, 3)
    assert np.isfinite(got).all()
    assert 0.05 < got.mean() < 0.95 and got.std() > 0.01   # not saturated
    mse = float(np.mean((got - ref) ** 2))
    psnr = 10.0 * np.log10(1.0 / max(mse, 1e-20))
    # two fp32 implementations of the same math: well above the 45 dB bar
    # of test_fullchain_parity.py
    assert psnr > 45.0, f"slice PSNR {psnr:.1f} dB"


@pytest.mark.parametrize("bug_compat", [True, False])
def test_traj_slice_latents_match_jax(pair, bug_compat):
    """bug_compat=False takes the caller's fps / motion bucket instead of
    the hardcoded (6, 128, 0.02) added-time ids."""
    bundle, jbundle, inputs = pair
    got = _run_port(bundle, inputs, "latent", bug_compat)
    ref = _run_jax(jbundle, inputs, "latent", bug_compat)
    scale = np.abs(ref).max()
    # fp32, different conv / matmul summation orders over ~60 layers x 2
    # steps x 2 models
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale)


# ------------------------------------- drag tracks -> CMP -> video

RASTER = 96                # the CMP canvas (384 in the app), cut for the CPU
DRAG_TRACKS = [[[12.0, 10.0], [30.0, 22.0], [45.0, 30.0]],
               [[100.0, 40.0], [85.0, 28.0], [70.0, 20.0], [60.0, 15.0]],
               [[64.0, 50.0], [66.0, 30.0]]]


def _jax_drag_flow(jengine, image01, tracks, brush):
    """mofa_tpu's traj app from tracks to flow (traj_app.py:79-108), on a
    RASTER canvas."""
    h, w = image01.shape[1:3]
    image_r = j_resize_nhwc(jnp.asarray(image01), (RASTER, RASTER))
    both_axes = lambda m: jnp.asarray(np.repeat(m[..., None], 2, -1))[None]
    if brush is None:
        s_flow, mask = j_prepare(tracks, T, h, w, RASTER)
        return jengine.get_flow(image_r, jnp.asarray(s_flow)[None], both_axes(mask),
                                h, w)
    pts = np.stack([np.asarray(j_interp(tr, T)) for tr in tracks])
    inside, outside = j_divide(pts, brush)
    side = lambda p: j_prepare([list(map(tuple, q)) for q in p] if len(p) else [],
                               T, h, w, RASTER)
    (f_in, m_in), (f_out, m_out) = side(inside), side(outside)
    brush_r = np.asarray(Image.fromarray(brush.astype(np.uint8)).resize(
        (RASTER, RASTER), Image.NEAREST), np.float32) / 255.0
    return jengine.get_drag_flow_with_brush(
        image_r, jnp.asarray(f_in)[None], both_axes(m_in), jnp.asarray(f_out)[None],
        both_axes(m_out), jnp.asarray(brush_r), h, w)


@pytest.fixture(scope="module")
def cmp_pair():
    """DragFlowEngines of both packages on one seeded TINY CMP."""
    cmp = init_random_cmp_(CMP(TINY_CMP_CONFIG), torch.Generator().manual_seed(3))
    _, params = jax_cmp(J_TINY_CMP, cmp)
    return DragFlowEngine(cmp), JDragFlowEngine(params, J_TINY_CMP)


@pytest.mark.parametrize("with_brush", [False, True])
def test_drag_tracks_to_video_matches_jax(pair, cmp_pair, with_brush):
    """Tracks -> PCHIP -> sparse flow -> CMP -> flow at the video's size
    (the port through traj_app.drag_flow, JAX through its app's code), then
    both TrajPipelines on their own flows (the JAX program compiled once
    for this module). With the brush, the tracks are split by it (one
    inside, two outside) and the two completions merged."""
    bundle, jbundle, inputs = pair
    engine, jengine = cmp_pair
    brush = None
    if with_brush:
        brush = np.zeros((H, W), np.float32)
        brush[:, : W // 2] = 255.0
    flow = drag_flow(engine, torch.from_numpy(inputs["image01"]), DRAG_TRACKS, T,
                     brush, raster_size=RASTER).numpy()
    jflow = np.asarray(_jax_drag_flow(jengine, inputs["image01"], DRAG_TRACKS, brush))
    assert flow.shape == jflow.shape == (1, T - 1, H, W, 2)
    assert np.abs(jflow).max() > 0
    # fp32, two conv implementations through the tiny CMP
    np.testing.assert_allclose(flow, jflow, rtol=0, atol=1e-4 * np.abs(jflow).max())
    got = _run_port(bundle, dict(inputs, flow=flow), "np")
    ref = _run_jax(jbundle, dict(inputs, flow=jflow), "np")
    assert np.isfinite(got).all()
    mse = float(np.mean((got - ref) ** 2))
    psnr = 10.0 * np.log10(1.0 / max(mse, 1e-20))
    assert psnr > 45.0, f"drag -> video PSNR {psnr:.1f} dB"


def test_port_imports_neither_jax_nor_mofa_tpu():
    """Every module of the port (walked, not listed; the walk must reach the
    training slices' train/, models/gmflow/ and models/cmp/ modules, the
    trainer apps, the face stack, the tflite compiler, the landmarker,
    facerender, PIRender, FILM, the UI server, the native binding and the
    logger), chip_smoke.py, chip_ab.py and the tflite writer
    (tests/torch_ref/tflite_writer.py, which chip_smoke.py imports) import
    in a fresh interpreter without jax, flax, optax, mofa_tpu, tensorflow,
    flatbuffers or PIL."""
    code = ("import importlib, pkgutil, sys, mofa_tpu_torch, chip_smoke, chip_ab;"
            "import tests.torch_ref.tflite_writer;"
            "mods = [m.name for m in pkgutil.walk_packages("
            "mofa_tpu_torch.__path__, 'mofa_tpu_torch.')];"
            "[importlib.import_module(m) for m in mods];"
            "want = {'mofa_tpu_torch.apps.' + a for a in ('hybrid_app', 'keypoint_app',"
            " 'audio2ldmk_app', 'opendomain_app', 'train_app', 'train_cmp_app',"
            " 'train_flow_app', 'eval_flow_app', 'face_fit_app', 'facerender_app',"
            " 'ui_server')} | {'mofa_tpu_torch.models.pirender', 'mofa_tpu_torch.models.film',"
            " 'mofa_tpu_torch.native', 'mofa_tpu_torch.utils.logging'} | {"
            "'mofa_tpu_torch.interop.tflite', 'mofa_tpu_torch.models.mp_face',"
            " 'mofa_tpu_torch.models.gfpgan', 'mofa_tpu_torch.models.facerender',"
            " 'mofa_tpu_torch.preprocess.video_fit', 'mofa_tpu_torch.preprocess.enhance'} | {"
            "'mofa_tpu_torch.pipelines.keypoint', 'mofa_tpu_torch.preprocess.image',"
            " 'mofa_tpu_torch.models.face_alignment', 'mofa_tpu_torch.models.audio.sadtalker',"
            " 'mofa_tpu_torch.models.audio.face3d_fit', 'mofa_tpu_torch.models.audio.face3d_render',"
            " 'mofa_tpu_torch.models.audio.wav2vec2', 'mofa_tpu_torch.models.audio.aniportrait',"
            " 'mofa_tpu_torch.models.gmflow.model', 'mofa_tpu_torch.models.gmflow.train',"
            " 'mofa_tpu_torch.models.cmp.train', 'mofa_tpu_torch.ops.edm'} | {"
            "'mofa_tpu_torch.train.' + t for t in ('stage', 'state', 'checkpoint', 'sampler',"
            " 'data', 'flow_cache', 'inputs', 'flow_sampler', 'flow_datasets')};"
            "assert len(mods) > 40 and want <= set(mods), (want - set(mods), mods);"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'mofa_tpu' or m.startswith('mofa_tpu.') or m == 'flax'"
            " or m.startswith('flax.') or m == 'optax' or m.startswith('optax.')"
            " or m.split('.')[0] in ('tensorflow', 'flatbuffers', 'PIL')];"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
