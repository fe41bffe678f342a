"""The port's hybrid slice against the JAX package, on the CPU.

Landmarks -> sparse flow and raster (bit for bit), the landmark adapter's
occlusion matting and feature stack, the dual-adapter HybridPipeline and
the hybrid app's chain from landmarks and drag tracks to video, each
held to mofa_tpu on the same weights (the port's seeded state dicts
through mofa_tpu's converters) and inputs: MICRO_UNET_CONFIG /
TINY_VAE_CONFIG / the tiny CLIP of test_fullchain_parity.py, 64x64, T=3,
2 steps, fp32, latents injected and noise augmentation off. JAX runs its
pipeline through one jit program for the whole module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofa_tpu.apps.panels import hybrid_panel as j_hybrid_panel
from mofa_tpu.apps.panels import keypoint_panel as j_keypoint_panel
from mofa_tpu.models.clip_vision import CLIPVisionConfig as JCLIPConfig
from mofa_tpu.models.cmp.model import TINY_CMP_CONFIG as J_TINY_CMP
from mofa_tpu.models.hourglass import ForegroundMatting as JForegroundMatting
from mofa_tpu.models.mofa_adapter import LdmkFlowControlNet as JLdmkFlowControlNet
from mofa_tpu.models.svd_unet import MICRO_UNET_CONFIG as J_MICRO
from mofa_tpu.models.vae import TINY_VAE_CONFIG as J_TINY_VAE
from mofa_tpu.models.weights import convert_torch_state_dict
from mofa_tpu.ops.flow_viz import flow_to_image as j_flow_to_image
from mofa_tpu.ops.rasterize import landmarks_to_sparse_flow as j_landmark_scatter
from mofa_tpu.ops.resize import resize_nhwc as j_resize_nhwc
from mofa_tpu.pipelines.common import ModelBundle as JBundle
from mofa_tpu.pipelines.hybrid import HybridPipeline as JHybridPipeline
from mofa_tpu.preprocess.landmark import LandmarkFlowEngine as JLandmarkFlowEngine
from mofa_tpu.preprocess.landmark import draw_landmark_sequence as j_draw_sequence
from mofa_tpu.preprocess.landmark import prepare_landmark_flow as j_prepare_landmarks
from mofa_tpu.preprocess.traj import DragFlowEngine as JDragFlowEngine
from mofa_tpu.preprocess.traj import prepare_trajectory_flow as j_prepare_tracks

from mofa_tpu_torch import kernels
from mofa_tpu_torch.apps import hybrid_app
from mofa_tpu_torch.apps.loaders import init_random_cmp_
from mofa_tpu_torch.apps.panels import hybrid_panel, keypoint_panel
from mofa_tpu_torch.models.clip_vision import CLIPVisionConfig
from mofa_tpu_torch.models.cmp.model import CMP, TINY_CMP_CONFIG
from mofa_tpu_torch.models.hourglass import ForegroundMatting
from mofa_tpu_torch.models.mofa_adapter import LdmkFlowControlNet
from mofa_tpu_torch.models.svd_unet import MICRO_UNET_CONFIG
from mofa_tpu_torch.models.vae import TINY_VAE_CONFIG
from mofa_tpu_torch.models.weights import state_dict_from_flax
from mofa_tpu_torch.ops.flow_viz import flow_to_image, read_flo, write_flo
from mofa_tpu_torch.ops.rasterize import landmarks_to_sparse_flow
from mofa_tpu_torch.pipelines.common import ModelBundle
from mofa_tpu_torch.pipelines.hybrid import HybridPipeline
from mofa_tpu_torch.pipelines.traj import TrajPipeline
from mofa_tpu_torch.preprocess.landmark import (LandmarkFlowEngine,
                                                draw_landmark_sequence,
                                                prepare_landmark_flow)
from mofa_tpu_torch.utils.profiling import PhaseTimer
from tests.torch_port_util import (jax_clip, jax_cmp, jax_flow_controlnet,
                                   jax_ldmk_controlnet, jax_unet, jax_vae,
                                   sd_np, seeded, template)
from tests.torch_port_util import one_torch_thread  # noqa: F401 (autouse)

H = W = 64
T, STEPS = 3, 2
CLIP_KW = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
               patch_size=16, image_size=48, projection_dim=32)
SCALES = dict(ctrl_scale_ldmk=1.0, ctrl_scale_traj=0.6)
TRACKS = [[[12.0, 10.0], [30.0, 22.0], [45.0, 30.0]],
          [[50.0, 40.0], [40.0, 50.0]]]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _psnr(a, b) -> float:
    return 10.0 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-20))


def _landmarks(rng, t: int, h: int, w: int) -> np.ndarray:
    """[t, 68, 2] (x, y): a seeded face inside the frame, small motion per
    frame, and landmarks 1 and 2 on one pixel of frame 0 with different
    motion (the scatter's duplicate-pixel rule)."""
    base = rng.uniform((0.2 * w, 0.2 * h), (0.8 * w, 0.8 * h), (68, 2))
    lm = base[None] + rng.randn(t, 68, 2) * 1.5
    lm[:, 1] = lm[:, 0] + rng.randn(t, 2)
    lm[0, 1] = lm[0, 0]
    return np.clip(lm, 0, (w - 1, h - 1)).astype(np.float32)


@pytest.mark.parametrize("hw", [(64, 96), (384, 384)])
def test_landmark_scatter_and_raster_match_jax(hw):
    """landmarks_to_sparse_flow, prepare_landmark_flow (its 384^2 copies
    included; at 384^2 they are the arrays themselves) and the raster,
    bit for bit."""
    h, w = hw
    rng = np.random.RandomState(5)
    lm = np.stack([_landmarks(rng, 4, h, w) for _ in range(2)])   # [2, 4, 68, 2]
    for got, ref in zip(landmarks_to_sparse_flow(lm, h, w), j_landmark_scatter(lm, h, w)):
        np.testing.assert_array_equal(got, ref)
    got, ref = prepare_landmark_flow(lm, h, w), j_prepare_landmarks(lm, h, w)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["mask_384"].sum() > 0
    raster = draw_landmark_sequence(lm[0], h, w)
    np.testing.assert_array_equal(raster, j_draw_sequence(lm[0], h, w))
    assert raster.shape == (4, h, w, 3) and raster.max() > 0


def test_flow_viz_and_panels_match_jax(tmp_path):
    """flow_to_image and both panel videos bit for bit; .flo round trip."""
    rng = np.random.RandomState(6)
    flow = rng.randn(2, 16, 24, 2).astype(np.float32) * 3
    np.testing.assert_array_equal(flow_to_image(flow[0]), j_flow_to_image(flow[0]))
    write_flo(flow[0], str(tmp_path / "f.flo"))
    np.testing.assert_array_equal(read_flo(str(tmp_path / "f.flo")), flow[0])
    first, frames = rng.rand(16, 24, 3), rng.rand(3, 16, 24, 3)
    raster, lm = rng.rand(3, 16, 24, 3), rng.uniform(0, 16, (3, 68, 2))
    np.testing.assert_array_equal(
        hybrid_panel(first, flow, flow[::-1], raster, frames, lm),
        j_hybrid_panel(first, flow, flow[::-1], raster, frames, lm))
    np.testing.assert_array_equal(keypoint_panel(first, flow, raster, frames, lm),
                                  j_keypoint_panel(first, flow, raster, frames, lm))


def test_foreground_matting_matches_jax():
    """Hourglass + matting heads, weights through mofa_tpu's converter."""
    c, n, h, w = 8, 3, 12, 16
    port = seeded(ForegroundMatting(c), 11)
    jm = JForegroundMatting(c)
    z = jnp.zeros
    params = convert_torch_state_dict(
        template(lambda: jm.init(jax.random.PRNGKey(0), z((1, h, w, c)),
                                 z((1, h, w, 2)), z((1, h, w, c)))),
        sd_np(port), strict=True)
    rng = np.random.RandomState(12)
    ref_f, flow, warped = (rng.randn(n, h, w, k).astype(np.float32) for k in (c, 2, c))
    nchw = lambda x: _t(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        out, mask = port(nchw(ref_f), nchw(flow), nchw(warped))
    j_out, j_mask = jm.apply(params, ref_f, flow, warped)
    for got, ref in ((out, j_out), (mask, j_mask)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    assert 0.0 < float(mask.min()) and float(mask.max()) < 1.0


@pytest.fixture(scope="module")
def pair():
    bundle = ModelBundle.init_random("cpu", torch.Generator().manual_seed(0),
                                     MICRO_UNET_CONFIG, TINY_VAE_CONFIG,
                                     CLIPVisionConfig(**CLIP_KW), ldmk=True, dual=True)
    # smaller random weights keep the tiny video inside [0, 1]
    with torch.no_grad():
        for p in bundle.vae.decoder.conv_out.parameters():
            p.mul_(0.05)
    unet, unet_p = jax_unet(J_MICRO, bundle.unet)
    cn, cn_p = jax_ldmk_controlnet(J_MICRO, bundle.controlnet)
    cn2, cn2_p = jax_flow_controlnet(J_MICRO, bundle.controlnet2)
    vae, vae_p = jax_vae(J_TINY_VAE, bundle.vae)
    clip, clip_p = jax_clip(JCLIPConfig(**CLIP_KW), bundle.clip)
    jbundle = JBundle(unet, unet_p, cn, cn_p, vae, vae_p, clip, clip_p, cn2, cn2_p)
    rng = np.random.RandomState(42)
    mask = np.zeros((1, H, W, 1), np.float32)
    mask[:, :, : W // 2] = 1.0                                    # the left half
    inputs = dict(image01=rng.rand(1, H, W, 3).astype(np.float32),
                  face_flow=rng.rand(1, T - 1, H, W, 2).astype(np.float32) * 6 - 3,
                  drag_flow=rng.rand(1, T - 1, H, W, 2).astype(np.float32) * 6 - 3,
                  landmarks=rng.rand(1, T, H, W, 3).astype(np.float32),
                  face_mask=mask,
                  latents=rng.randn(1, T, H // 8, W // 8, 4).astype(np.float32))
    return bundle, jbundle, inputs


def test_ldmk_encode_features_matches_jax(pair):
    """LdmkFlowControlNet.encode_features: the inject stack and the
    occlusion masks; the "ldmk_controlnet" family carries the converted
    params back to the port's state dict bit for bit."""
    bundle, jbundle, inputs = pair
    cn = bundle.controlnet
    back = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                       jbundle.controlnet_params),
                                "ldmk_controlnet")
    own = cn.state_dict()
    assert back.keys() == own.keys()
    assert not any("zeroconvs" in k for k in own)
    for k, v in own.items():
        assert torch.equal(back[k], v), k
    args = (inputs["image01"] * 2 - 1, inputs["face_flow"], inputs["landmarks"])
    with torch.no_grad():
        inject, masks = cn.encode_features(*map(_t, args))
    j_inject, j_masks = jax.jit(lambda p, *a: jbundle.controlnet.apply(
        p, *a, method=type(jbundle.controlnet).encode_features))(
            jbundle.controlnet_params, *map(jnp.asarray, args))
    assert len(inject) == len(j_inject) == 4 and len(masks) == len(j_masks) == 4
    for got, ref in zip(inject + masks, list(j_inject) + list(j_masks)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_ldmk_embedding_joins_by_feature_height():
    """With block_out_channels[1] == block_out_channels[0] the /32 feature
    has the landmark embedding's channels too, and its height matches the
    embedding resized by 1/4: it joins there as well (the reference keys
    the join by height, not by the first two scales)."""
    boc = (32, 32, 64, 64)
    cfg = dataclasses.replace(MICRO_UNET_CONFIG, block_out_channels=boc)
    jcfg = dataclasses.replace(J_MICRO, block_out_channels=boc)
    cn = seeded(LdmkFlowControlNet(cfg), 13)
    jcn, params = jax_ldmk_controlnet(jcfg, cn)
    rng = np.random.RandomState(14)
    args = [rng.rand(1, H, W, 3).astype(np.float32) * 2 - 1,
            rng.randn(1, T - 1, H, W, 2).astype(np.float32) * 3,
            rng.rand(1, T, H, W, 3).astype(np.float32)]
    with torch.no_grad():
        inject, _ = cn.encode_features(*map(_t, args))
        no_lm, _ = cn.encode_features(*map(_t, args[:2] + [0 * args[2]]))
    j_inject, _ = jax.jit(lambda p, *a: jcn.apply(
        p, *a, method=JLdmkFlowControlNet.encode_features))(params, *map(jnp.asarray, args))
    assert [f.shape[-1] for f in inject] == [32, 32, 32, 64]
    assert not torch.equal(inject[2], no_lm[2])          # /32 took the embedding
    for got, ref in zip(inject, j_inject):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def _run_port(bundle, inputs, output_type, **kw):
    out, _ = HybridPipeline(bundle)(
        *(_t(inputs[k]) for k in ("image01", "face_flow", "drag_flow", "landmarks",
                                  "face_mask")),
        num_inference_steps=STEPS, noise_aug_strength=0.0,
        latents=_t(inputs["latents"]), output_type=output_type, **SCALES, **kw)
    return out.numpy()


class _OneCompileHybrid(JHybridPipeline):
    """mofa_tpu's HybridPipeline with one jit program for both bug_compat
    settings: nothing on its path reads the flag, but the stock class keys
    its jit cache on it."""

    def __hash__(self):
        return hash((id(self.bundle), id(self.mesh)))

    def __eq__(self, other):
        return (isinstance(other, _OneCompileHybrid) and other.bundle is self.bundle
                and other.mesh is self.mesh)


def _run_jax(jbundle, inputs, output_type, bug_compat=True, **scales):
    out, _ = _OneCompileHybrid(jbundle, bug_compat=bug_compat)(
        *(jnp.asarray(inputs[k]) for k in ("image01", "face_flow", "drag_flow",
                                           "landmarks", "face_mask")),
        num_inference_steps=STEPS, noise_aug_strength=0.0,
        latents=jnp.asarray(inputs["latents"]), output_type=output_type,
        **(scales or SCALES))
    return np.asarray(out)


@pytest.mark.parametrize("bug_compat", [True, False])
def test_hybrid_latents_match_jax(pair, bug_compat):
    """The mask's left half takes the face adapter, the right half the drag
    adapter. The port's HybridPipeline has no bug_compat flag (nothing on
    the JAX hybrid path reads it): it must match the reference under
    either setting."""
    bundle, jbundle, inputs = pair
    got = _run_port(bundle, inputs, "latent")
    ref = _run_jax(jbundle, inputs, "latent", bug_compat)
    # fp32, other conv / matmul summation orders over three models x 2 steps
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_hybrid_frames_match_jax_psnr(pair):
    bundle, jbundle, inputs = pair
    kernels.reset_launch_counts()
    got = _run_port(bundle, inputs, "np")
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    ref = _run_jax(jbundle, inputs, "np")
    assert got.shape == ref.shape == (1, T, H, W, 3)
    assert 0.05 < got.mean() < 0.95 and got.std() > 0.01       # not saturated
    assert _psnr(got, ref) > 45.0, f"hybrid PSNR {_psnr(got, ref):.1f} dB"


class _OneAdapter:
    """One adapter alone behind TrajPipeline's adapter interface. Its
    features are computed at the B rows of the first CFG half and repeated,
    as HybridPipeline computes them (the landmark adapter with its landmark
    frames)."""

    def __init__(self, cn, landmarks=None):
        self.cn, self.landmarks = cn, landmarks

    def encode_features(self, cond, flow):
        b = cond.shape[0] // 2
        if self.landmarks is None:
            feats = self.cn.encode_features(cond[:b], flow[:b])
        else:
            feats, _ = self.cn.encode_features(cond[:b], flow[:b], self.landmarks)
        return [torch.cat([f, f]) for f in feats]

    def __call__(self, *args, **kw):
        return self.cn(*args, **kw)


@pytest.mark.parametrize("side", ["face", "drag"])
def test_hybrid_mask_extremes_reduce_to_one_adapter(pair, side):
    """A mask of ones gives the landmark adapter's single-adapter video, a
    mask of zeros the trajectory adapter's, each run alone by TrajPipeline.
    Both pipelines draw the noise augmentation (0.02) from the same seeded
    generator and use the added-time ids (6, 128, 0.02)."""
    bundle, _, inputs = pair
    mask = np.full_like(inputs["face_mask"], 1.0 if side == "face" else 0.0)
    got, _ = HybridPipeline(bundle)(
        *(_t(inputs[k]) for k in ("image01", "face_flow", "drag_flow", "landmarks")),
        _t(mask), num_inference_steps=STEPS, latents=_t(inputs["latents"]),
        generator=torch.Generator().manual_seed(7), output_type="latent", **SCALES)
    if side == "face":
        alone = _OneAdapter(bundle.controlnet, _t(inputs["landmarks"]))
        flow, scale = inputs["face_flow"], SCALES["ctrl_scale_ldmk"]
    else:
        alone = _OneAdapter(bundle.controlnet2)
        flow, scale = inputs["drag_flow"], SCALES["ctrl_scale_traj"]
    single = dataclasses.replace(bundle, controlnet=alone, controlnet2=None)
    ref, _ = TrajPipeline(single)(
        _t(inputs["image01"]), _t(flow), num_inference_steps=STEPS,
        latents=_t(inputs["latents"]), controlnet_cond_scale=scale,
        generator=torch.Generator().manual_seed(7), output_type="latent")
    # face * 1 + drag * 0 (and face * 0 + drag * 1) is the one adapter's
    # residual exactly: the same operations on the same values
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.fixture(scope="module")
def cmp_pair():
    """The seeded TINY CMP of both packages (test_torch_traj.py's)."""
    cmp = init_random_cmp_(CMP(TINY_CMP_CONFIG), torch.Generator().manual_seed(3))
    return cmp, jax_cmp(J_TINY_CMP, cmp)[1]


def test_landmark_flow_engine_matches_jax(cmp_pair):
    """LandmarkFlowEngine: the batched CMP completion of a landmark
    scatter on the 384^2 canvas, rescaled per axis to a 64x96 video."""
    cmp, cmp_params = cmp_pair
    h, w = 64, 96
    rng = np.random.RandomState(10)
    lm = _landmarks(rng, T, h, w)
    flow_in = prepare_landmark_flow(lm[None], h, w)
    frames = rng.rand(1, T - 1, 384, 384, 3).astype(np.float32)
    args = (frames, flow_in["sparse_flow_384"], flow_in["mask_384"])
    got = LandmarkFlowEngine(cmp).get_cmp_flow_landmarks(*map(_t, args), h, w)
    ref = np.asarray(JLandmarkFlowEngine(cmp_params, J_TINY_CMP).get_cmp_flow_landmarks(
        *map(jnp.asarray, args), h, w))
    assert got.shape == ref.shape == (1, T - 1, h, w, 2) and np.abs(ref).max() > 0
    # fp32, two conv implementations through the tiny CMP
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_hybrid_app_generate_matches_jax_chain(pair, cmp_pair, monkeypatch):
    """hybrid_app.generate from landmarks and drag tracks against the JAX
    app's chain (hybrid_app.py:79-137) built from its parts: the landmark
    scatter on the 384^2 canvas -> CMP -> face flow; the tracks -> CMP ->
    drag flow, tiled to T-1; the raster; HybridPipeline with a mask of
    ones. The drag adapter's 25-frame length is cut to 2 on this CPU (one
    CMP frame at 384^2, tiled to T-1 = 2 frames); latents are injected and
    noise augmentation is off on both sides."""
    bundle, jbundle, inputs = pair
    cmp, cmp_params = cmp_pair
    model_length = 2
    monkeypatch.setattr(hybrid_app, "MODEL_LENGTH", model_length)

    class Injected(HybridPipeline):
        def __call__(self, *args, **kw):
            return super().__call__(*args, **kw, noise_aug_strength=0.0,
                                    latents=_t(inputs["latents"]))

    monkeypatch.setattr(hybrid_app, "HybridPipeline", Injected)
    lm = _landmarks(np.random.RandomState(8), T, H, W)
    image = inputs["image01"][0]
    frames, face, drag, raster = hybrid_app.generate(
        image, lm, TRACKS, None, lambda: cmp, lambda: bundle,
        timer=PhaseTimer(torch.device("cpu")), num_inference_steps=STEPS, **SCALES)

    flow_in = j_prepare_landmarks(lm[None], H, W)
    image_c = j_resize_nhwc(jnp.asarray(image)[None], (384, 384))
    j_face = JLandmarkFlowEngine(cmp_params, J_TINY_CMP).get_cmp_flow_landmarks(
        jnp.repeat(image_c[:, None], T - 1, axis=1),
        jnp.asarray(flow_in["sparse_flow_384"]), jnp.asarray(flow_in["mask_384"]),
        H, W)
    s_flow, mask = j_prepare_tracks(TRACKS, model_length, H, W)
    j_drag = JDragFlowEngine(cmp_params, J_TINY_CMP).get_flow(
        image_c, jnp.asarray(s_flow)[None],
        jnp.asarray(np.repeat(mask[..., None], 2, -1))[None], H, W)
    j_drag = jnp.tile(j_drag, (1, -(-(T - 1) // j_drag.shape[1]), 1, 1, 1))[:, : T - 1]
    j_raster = j_draw_sequence(lm, H, W)
    np.testing.assert_array_equal(raster, j_raster)
    for got, ref in ((face, j_face), (drag, j_drag)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape == (1, T - 1, H, W, 2) and np.abs(ref).max() > 0
        # fp32, two conv implementations through the tiny CMP
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
    ref = _run_jax(jbundle, dict(inputs, face_flow=np.asarray(j_face),
                                 drag_flow=np.asarray(j_drag), landmarks=j_raster[None],
                                 face_mask=np.ones_like(inputs["face_mask"])), "np",
                   ctrl_scale_ldmk=1.0, ctrl_scale_traj=0.6)[0]
    got = frames.numpy()
    assert np.isfinite(got).all()
    assert _psnr(got, ref) > 45.0, f"app chain PSNR {_psnr(got, ref):.1f} dB"


def test_hybrid_app_cli_on_cpu(tmp_path):
    """The CLI on the CPU at the micro widths: image, landmarks and a face
    mask from files, no tracks (zero drag flow), a gif and its panel out."""
    from PIL import Image
    rng = np.random.RandomState(9)
    Image.fromarray((rng.rand(70, 70, 3) * 255).astype(np.uint8)).save(tmp_path / "in.png")
    np.save(tmp_path / "l.npy", _landmarks(rng, T, 64, 64))
    face = np.zeros((70, 70), np.uint8)
    face[10:50, 15:55] = 255
    Image.fromarray(face).save(tmp_path / "face.png")
    out, panel = tmp_path / "out.gif", tmp_path / "panel.gif"
    hybrid_app.main(["--image", str(tmp_path / "in.png"), "--landmarks",
                     str(tmp_path / "l.npy"), "--face_mask", str(tmp_path / "face.png"),
                     "--device", "cpu", "--tiny", "--target_size", "64",
                     "--num_inference_steps", "1", "--output", str(out),
                     "--panel_output", str(panel)])
    assert out.stat().st_size > 0 and panel.stat().st_size > 0
    assert Image.open(panel).size == (64 * 6, 64)
