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

from mofa_tpu.models.clip_vision import CLIPVisionConfig as JCLIPConfig
from mofa_tpu.models.svd_unet import MICRO_UNET_CONFIG as J_MICRO
from mofa_tpu.models.vae import TINY_VAE_CONFIG as J_TINY_VAE
from mofa_tpu.pipelines.common import ModelBundle as JBundle
from mofa_tpu.pipelines.traj import TrajPipeline as JTrajPipeline

from mofa_tpu_torch import kernels
from mofa_tpu_torch.models.clip_vision import CLIPVisionConfig
from mofa_tpu_torch.models.svd_unet import MICRO_UNET_CONFIG
from mofa_tpu_torch.models.vae import TINY_VAE_CONFIG
from mofa_tpu_torch.pipelines.common import ModelBundle
from mofa_tpu_torch.pipelines.traj import TrajPipeline
from tests.torch_port_util import (jax_clip, jax_flow_controlnet, jax_unet,
                                   jax_vae)

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


def _run_jax(jbundle, inputs, output_type, bug_compat=True):
    out, _ = JTrajPipeline(jbundle, bug_compat=bug_compat)(
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


def test_port_imports_neither_jax_nor_mofa_tpu():
    code = ("import sys, mofa_tpu_torch.pipelines.traj, mofa_tpu_torch.models.weights;"
            "import mofa_tpu_torch.kernels.attention;"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'mofa_tpu' or m.startswith('mofa_tpu.') or m == 'flax'];"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
