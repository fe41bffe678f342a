"""The port's keypoint slice against the JAX package, on the CPU.

The sliding-window views, the windowed KeypointPipeline (latents and
frames), window batching against one window a call, and the keypoint
app's chain from a landmark track to video, each held to mofa_tpu on the
same weights (the port's seeded state dicts through mofa_tpu's
converters) and inputs: MICRO_UNET_CONFIG / TINY_VAE_CONFIG / the tiny
CLIP of test_fullchain_parity.py / TINY_CMP_CONFIG, 64x64, T=7 frames in
windows of 4 at stride 2 (views (1, 4), (3, 6) and the ragged (4, 7)),
2 steps, fp32, latents injected and noise augmentation off. The JAX side
runs its pipeline's host-driven mode (big_program=False: one jit program
a window step, reused over steps and views; mofa_tpu's own
tests/test_pipeline_keypoint_hybrid.py holds it to the one-program scan),
compiled once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofa_tpu.models.clip_vision import CLIPVisionConfig as JCLIPConfig
from mofa_tpu.models.cmp.model import TINY_CMP_CONFIG as J_TINY_CMP
from mofa_tpu.models.svd_unet import MICRO_UNET_CONFIG as J_MICRO
from mofa_tpu.models.vae import TINY_VAE_CONFIG as J_TINY_VAE
from mofa_tpu.ops.euler import make_euler_schedule as j_schedule
from mofa_tpu.ops.resize import resize_nhwc as j_resize_nhwc
from mofa_tpu.pipelines.common import ModelBundle as JBundle
from mofa_tpu.pipelines.common import decode_latents_jit as j_decode
from mofa_tpu.pipelines.common import postprocess_frames as j_postprocess
from mofa_tpu.pipelines.keypoint import KeypointPipeline as JKeypointPipeline
from mofa_tpu.pipelines.keypoint import view_index_array as j_view_index_array
from mofa_tpu.pipelines.keypoint import window_views as j_window_views
from mofa_tpu.preprocess.landmark import LandmarkFlowEngine as JLandmarkFlowEngine
from mofa_tpu.preprocess.landmark import draw_landmark_sequence as j_draw_sequence
from mofa_tpu.preprocess.landmark import prepare_landmark_flow as j_prepare_landmarks

from mofa_tpu_torch import kernels
from mofa_tpu_torch.apps import keypoint_app
from mofa_tpu_torch.apps.loaders import init_random_cmp_
from mofa_tpu_torch.models.clip_vision import CLIPVisionConfig
from mofa_tpu_torch.models.cmp.model import CMP, TINY_CMP_CONFIG
from mofa_tpu_torch.models.svd_unet import MICRO_UNET_CONFIG
from mofa_tpu_torch.models.vae import TINY_VAE_CONFIG
from mofa_tpu_torch.pipelines.common import ModelBundle
from mofa_tpu_torch.pipelines.keypoint import (KeypointPipeline,
                                               view_index_array,
                                               window_groups, window_views)
from mofa_tpu_torch.utils.profiling import PhaseTimer
from tests.torch_port_util import (jax_clip, jax_cmp, jax_ldmk_controlnet,
                                   jax_unet, jax_vae)
from tests.torch_port_util import (flax_apply_without_shape_recheck,  # noqa: F401
                                   one_torch_thread)  # (both autouse)

H = W = 64
T, WIN, STRIDE, STEPS = 7, 4, 2, 2
CLIP_KW = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
               patch_size=16, image_size=48, projection_dim=32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _psnr(a, b) -> float:
    return 10.0 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-20))


def _latent_atol(ref, latents) -> float:
    """1e-4 of the latents' scale, plus the fp32 floor of the first Euler
    step: at sigma_0 ~ 700 it forms x0 as a difference of samples near
    sigma_0 * max|latents| (about 2.5e3 here), so either package's result
    carries a few ulps of that magnitude (JAX's own output moves by 1.5e-3
    when its input moves by 1e-7 of itself); 8 ulps of it."""
    sigma0 = float(j_schedule(STEPS).init_noise_sigma)
    return (1e-4 * float(np.abs(ref).max())
            + 8 * float(np.spacing(np.float32(sigma0 * np.abs(latents).max()))))


@pytest.mark.parametrize("n,w,s", [(125, 25, 12), (49, 25, 12), (7, 4, 2), (8, 4, 2)])
def test_window_views_match_jax(n, w, s):
    """The reference's view list, its duplicate last view where
    (N - W) % S == 0 included, and the index array; the groups of
    window_batch views pad with zero-weight copies of the last view."""
    assert window_views(n, w, s) == j_window_views(n, w, s)
    idx = view_index_array(n, w, s)
    np.testing.assert_array_equal(idx, j_view_index_array(n, w, s))
    if (n - w) % s == 0:
        np.testing.assert_array_equal(idx[-1], idx[-2])
    covered = {int(i) for i in idx[:, 1:].ravel()}
    assert covered == set(range(1, n)) and (idx[:, 0] == 0).all()
    for vb in (1, 3):
        g_idx, g_w = window_groups(n, w, s, vb)
        v = idx.shape[0]
        assert g_idx.shape == g_w.shape == (-(-v // vb), vb, w)
        flat_idx, flat_w = g_idx.reshape(-1, w), g_w.reshape(-1, w)
        np.testing.assert_array_equal(flat_idx[:v], idx)
        assert (flat_idx[v:] == idx[-1]).all() and (flat_w[v:] == 0).all()
        assert flat_w[0, 0] == 1 and (flat_w[1:v, 0] == 0).all()
        assert (flat_w[:v, 1:] == 1).all()


@pytest.fixture(scope="module")
def pair():
    bundle = ModelBundle.init_random("cpu", torch.Generator().manual_seed(0),
                                     MICRO_UNET_CONFIG, TINY_VAE_CONFIG,
                                     CLIPVisionConfig(**CLIP_KW), ldmk=True)
    # smaller random weights keep the tiny video inside [0, 1]
    with torch.no_grad():
        for p in bundle.vae.decoder.conv_out.parameters():
            p.mul_(0.05)
    unet, unet_p = jax_unet(J_MICRO, bundle.unet)
    cn, cn_p = jax_ldmk_controlnet(J_MICRO, bundle.controlnet)
    vae, vae_p = jax_vae(J_TINY_VAE, bundle.vae)
    clip, clip_p = jax_clip(JCLIPConfig(**CLIP_KW), bundle.clip)
    jbundle = JBundle(unet, unet_p, cn, cn_p, vae, vae_p, clip, clip_p)
    rng = np.random.RandomState(42)
    inputs = dict(image01=rng.rand(1, H, W, 3).astype(np.float32),
                  flow=rng.rand(1, T - 1, H, W, 2).astype(np.float32) * 6 - 3,
                  landmarks=rng.rand(1, T, H, W, 3).astype(np.float32),
                  latents=rng.randn(1, T, H // 8, W // 8, 4).astype(np.float32))
    return bundle, jbundle, inputs


def _run_port(bundle, inputs, output_type, **kw):
    out, _ = KeypointPipeline(bundle)(
        *(_t(inputs[k]) for k in ("image01", "flow", "landmarks")),
        window_size=WIN, stride=STRIDE, num_inference_steps=STEPS,
        noise_aug_strength=0.0, latents=_t(inputs["latents"]),
        output_type=output_type, decode_chunk_size=4, **kw)
    return out.numpy()


def _run_jax(jbundle, inputs):
    """(latents, frames) of mofa_tpu's KeypointPipeline; the frames decoded
    from those latents as its __call__ decodes them."""
    lat, _ = JKeypointPipeline(jbundle, big_program=False)(
        *(jnp.asarray(inputs[k]) for k in ("image01", "flow", "landmarks")),
        window_size=WIN, stride=STRIDE, num_inference_steps=STEPS,
        noise_aug_strength=0.0, latents=jnp.asarray(inputs["latents"]),
        output_type="latent")
    frames = j_postprocess(j_decode(jbundle, lat, 4))
    return np.asarray(lat), np.asarray(frames)


@pytest.fixture(scope="module")
def jax_out(pair):
    _, jbundle, inputs = pair
    return _run_jax(jbundle, inputs)


def test_keypoint_latents_match_jax(pair, jax_out):
    bundle, _, inputs = pair
    got = _run_port(bundle, inputs, "latent")
    ref = jax_out[0]
    assert got.shape == ref.shape == (1, T, H // 8, W // 8, 4)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=_latent_atol(ref, inputs["latents"]))


def test_keypoint_frames_match_jax_psnr(pair, jax_out):
    bundle, _, inputs = pair
    kernels.reset_launch_counts()
    got = _run_port(bundle, inputs, "np")
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    ref = jax_out[1]
    assert got.shape == ref.shape == (1, T, H, W, 3)
    assert 0.05 < got.mean() < 0.95 and got.std() > 0.01       # not saturated
    assert _psnr(got, ref) > 45.0, f"keypoint PSNR {_psnr(got, ref):.1f} dB"


@pytest.mark.parametrize("vb", [2, 3])
def test_window_batch_matches_one_window(pair, vb):
    """T=8: views (1, 4), (3, 6), (5, 8) and its duplicate; vb=2 makes two
    even groups, vb=3 a full group and one padded with two zero-weight
    copies. The rows of a CFG half share one image embedding, so the
    pairwise time-context rule gives each window what it gets alone; the
    bound is mofa_tpu's own (tests/test_window_batch.py)."""
    bundle, _, inputs = pair
    rng = np.random.RandomState(3)
    t = 8
    inputs = dict(image01=inputs["image01"],
                  flow=rng.rand(1, t - 1, H, W, 2).astype(np.float32) * 6 - 3,
                  landmarks=rng.rand(1, t, H, W, 3).astype(np.float32),
                  latents=rng.randn(1, t, H // 8, W // 8, 4).astype(np.float32))
    want = _run_port(bundle, inputs, "latent")
    got = _run_port(bundle, inputs, "latent", window_batch=vb)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=5e-3)


@pytest.fixture(scope="module")
def cmp_pair():
    """The seeded TINY CMP of both packages (test_torch_traj.py's)."""
    cmp = init_random_cmp_(CMP(TINY_CMP_CONFIG), torch.Generator().manual_seed(3))
    return cmp, jax_cmp(J_TINY_CMP, cmp)[1]


def _landmarks(rng, t: int, h: int, w: int) -> np.ndarray:
    """[t, 68, 2] (x, y): a seeded face inside the frame, small motion."""
    base = rng.uniform((0.2 * w, 0.2 * h), (0.8 * w, 0.8 * h), (68, 2))
    lm = base[None] + rng.randn(t, 68, 2) * 1.5
    return np.clip(lm, 0, (w - 1, h - 1)).astype(np.float32)


def test_keypoint_app_generate_matches_jax_chain(pair, jax_out, cmp_pair, monkeypatch):
    """keypoint_app.generate from a landmark track against the JAX app's
    chain (keypoint_app.py:79-121) built from its parts: the landmark
    scatter on the 384^2 canvas -> CMP over the T-1 frames -> flow; the
    raster; KeypointPipeline. Latents injected, noise augmentation off on
    both sides."""
    bundle, jbundle, inputs = pair
    cmp, cmp_params = cmp_pair

    class Injected(KeypointPipeline):
        def __call__(self, *args, **kw):
            return super().__call__(*args, **kw, noise_aug_strength=0.0,
                                    latents=_t(inputs["latents"]))

    monkeypatch.setattr(keypoint_app, "KeypointPipeline", Injected)
    lm = _landmarks(np.random.RandomState(8), T, H, W)
    image = inputs["image01"][0]
    timer = PhaseTimer(torch.device("cpu"))
    frames, flow, raster = keypoint_app.generate(
        image, lm, lambda: cmp, lambda: bundle, timer=timer, window_size=WIN,
        stride=STRIDE, num_inference_steps=STEPS, decode_chunk_size=4)
    assert set(timer.totals) == {"cmp_load", "cmp_flow", "bundle_load", "denoise_decode"}

    flow_in = j_prepare_landmarks(lm[None], H, W)
    image_c = j_resize_nhwc(jnp.asarray(image)[None], (384, 384))
    j_flow = JLandmarkFlowEngine(cmp_params, J_TINY_CMP).get_cmp_flow_landmarks(
        jnp.repeat(image_c[:, None], T - 1, axis=1),
        jnp.asarray(flow_in["sparse_flow_384"]), jnp.asarray(flow_in["mask_384"]),
        H, W)
    j_raster = j_draw_sequence(lm, H, W)
    np.testing.assert_array_equal(raster, j_raster)
    j_flow = np.asarray(j_flow)
    assert flow.shape == j_flow.shape == (1, T - 1, H, W, 2) and np.abs(j_flow).max() > 0
    # fp32, two conv implementations through the tiny CMP
    np.testing.assert_allclose(flow.numpy(), j_flow, rtol=0,
                               atol=1e-4 * np.abs(j_flow).max())
    _, ref = _run_jax(jbundle, dict(inputs, flow=j_flow, landmarks=j_raster[None]))
    got = frames.numpy()
    assert got.shape == (T, H, W, 3) and np.isfinite(got).all()
    assert _psnr(got, ref[0]) > 45.0, f"app chain PSNR {_psnr(got, ref[0]):.1f} dB"


def test_keypoint_app_cli_on_cpu(tmp_path):
    """The CLI on the CPU at the micro widths, with window batching: an
    image and a landmark track longer than --num_frames from files, a gif
    and its 5-panel video out."""
    from PIL import Image
    rng = np.random.RandomState(9)
    Image.fromarray((rng.rand(70, 70, 3) * 255).astype(np.uint8)).save(tmp_path / "in.png")
    np.save(tmp_path / "l.npy", _landmarks(rng, 9, 64, 64))
    out, panel = tmp_path / "out.gif", tmp_path / "panel.gif"
    keypoint_app.main(["--image", str(tmp_path / "in.png"), "--landmarks",
                       str(tmp_path / "l.npy"), "--device", "cpu", "--tiny",
                       "--target_size", "64", "--num_frames", "7", "--window_size",
                       "4", "--stride", "2", "--window_batch", "2",
                       "--num_inference_steps", "1", "--output", str(out),
                       "--panel_output", str(panel)])
    gif = Image.open(out)
    assert gif.n_frames == 7 and gif.size == (64, 64)
    assert Image.open(panel).size == (64 * 5, 64)
