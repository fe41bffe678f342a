"""The port's full trajectory chain against the reference pipeline's own
semantics, on CPU, without JAX.

One video made twice from the same random weights: by the port's
`TrajPipeline` (CPU tensors: every kernel wrapper runs its plain version)
and by an independent transcription of the reference pipeline's
`__call__` (MOFA-Video-Traj pipeline.py:282-528) built from the torch
transcriptions `tests/torch_ref/{svd,vae,clip}_torch.py`, which load the
port's state dicts as they are (the names are diffusers', on both sides).
The chain covers CLIP with the un-normalised antialias resize, the VAE
encode's mode, the hard-coded (6, 128, 0.02) time ids, the CFG denoise
with per-frame linspace guidance and the adapter's warped features, the
chunk-local temporal decode and the postprocess. Settings: bug_compat,
noise augmentation off, injected latents, fp32, MICRO_UNET_CONFIG /
TINY_VAE_CONFIG / a tiny CLIP, 128x192, T=6, 2 steps. Bars: PSNR > 45 dB,
the bar of tests/test_fullchain_parity.py, which holds the JAX package
to the same chain, and > 90 dB, rounding between two fp32 transcriptions.

The antialias resize is transcribed here from diffusers'
`_resize_with_antialiasing` algorithm (a separable Gaussian with sigma =
max((factor - 1) / 2, 0.001) per axis, an odd kernel of at least 3
taps, reflect padding, then torch's bicubic interpolation with
align_corners=True); the Euler tables come from the port (golden-tested
against the vendored scheduler through tests/test_euler.py), the Euler
update and the guidance are written out below.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mofa_tpu_torch.models.clip_vision import CLIPVisionConfig
from mofa_tpu_torch.models.svd_unet import MICRO_UNET_CONFIG
from mofa_tpu_torch.models.vae import TINY_VAE_CONFIG
from mofa_tpu_torch.ops.euler import make_euler_schedule
from mofa_tpu_torch.pipelines.common import ModelBundle
from mofa_tpu_torch.pipelines.traj import TrajPipeline
from tests.torch_ref.clip_torch import CLIPVisionModelWithProjectionTorch
from tests.torch_ref.svd_torch import (
    FlowControlNetTorch, UNetSpatioTemporalConditionControlNetModelTorch)
from tests.torch_ref.vae_torch import AutoencoderKLTemporalDecoderTorch

H, W, T, STEPS = 128, 192, 6, 2
CLIP_KW = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
               patch_size=16, image_size=48,
               projection_dim=MICRO_UNET_CONFIG.cross_attention_dim)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def antialias_resize(x: torch.Tensor, size) -> torch.Tensor:
    """diffusers' `_resize_with_antialiasing(x, size)` on NCHW: blur along
    W, then along H, then bicubic with align_corners=True."""
    h, w = x.shape[-2:]
    sigmas = [max((h / size[0] - 1.0) / 2.0, 0.001),
              max((w / size[1] - 1.0) / 2.0, 0.001)]
    ks = [int(max(4.0 * s, 3)) for s in sigmas]
    ks = [k + 1 if k % 2 == 0 else k for k in ks]
    c = x.shape[1]
    for axis in (1, 0):                       # W first, then H
        k, s = ks[axis], sigmas[axis]
        t = torch.arange(k, dtype=x.dtype) - k // 2
        g = torch.exp(-t ** 2 / (2.0 * s ** 2))
        g = g / g.sum()
        pad = (k - 1) // 2
        if axis == 1:
            x = F.pad(x, (pad, k - 1 - pad, 0, 0), mode="reflect")
            x = F.conv2d(x, g.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
        else:
            x = F.pad(x, (0, 0, pad, k - 1 - pad), mode="reflect")
            x = F.conv2d(x, g.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.interpolate(x, size=size, mode="bicubic", align_corners=True)


def reference_modules(bundle: ModelBundle):
    """The torch_ref transcriptions holding the port bundle's weights."""
    ucfg, vcfg = MICRO_UNET_CONFIG, TINY_VAE_CONFIG
    mods = (UNetSpatioTemporalConditionControlNetModelTorch(ucfg),
            FlowControlNetTorch(ucfg),
            AutoencoderKLTemporalDecoderTorch(
                block_out_channels=vcfg.block_out_channels,
                layers_per_block=vcfg.layers_per_block,
                latent_channels=vcfg.latent_channels),
            CLIPVisionModelWithProjectionTorch(**CLIP_KW))
    ports = (bundle.unet, bundle.controlnet, bundle.vae, bundle.clip)
    for ref, port in zip(mods, ports):
        ref.load_state_dict(port.state_dict(), strict=True)
        ref.eval()
    return mods


def reference_chain(unet, cn, vae, clip, image01, flow, latents0):
    """The reference __call__ (pipeline.py:282-528), torch, fp32, aug=0.
    image01 [1, H, W, 3], flow [1, T-1, H, W, 2], latents0 [1, T, h, w, 4]
    (numpy); returns frames [1, T, H, W, 3] in [0, 1]."""
    sched = make_euler_schedule(STEPS)
    img = torch.from_numpy(np.moveaxis(image01, -1, 1).copy())

    # CLIP on the un-normalised [0, 1] image through the antialias resize
    emb = clip(antialias_resize(img, (CLIP_KW["image_size"],) * 2)).unsqueeze(1)
    image_embeddings = torch.cat([torch.zeros_like(emb), emb])

    # VAE encode of the [-1, 1] image, mode(), CFG zeros, frame repeat
    image_pm1 = img * 2.0 - 1.0
    lat = vae.encode_mode(image_pm1)
    image_latents = torch.cat([torch.zeros_like(lat), lat])
    image_latents = image_latents.unsqueeze(1).repeat(1, T, 1, 1, 1)

    ids = torch.tensor([[6.0, 128.0, 0.02]]).repeat(2, 1)   # the hard-coded ids

    latents = torch.from_numpy(np.moveaxis(latents0, -1, 2).copy())
    latents = latents * sched.init_noise_sigma
    cond = torch.cat([image_pm1] * 2)
    flow_cfg = torch.cat([torch.from_numpy(np.moveaxis(flow, -1, 2).copy())] * 2)
    guidance = torch.linspace(1.0, 3.0, T)[None, :, None, None, None]

    for i in range(STEPS):
        sigma, sigma_next = float(sched.sigmas[i]), float(sched.sigmas[i + 1])
        ts = float(sched.timesteps[i])
        lat_in = torch.cat([latents] * 2) / float(np.sqrt(sigma ** 2 + 1))
        lat_in = torch.cat([lat_in, image_latents], dim=2)
        down, mid = cn(lat_in, ts, image_embeddings, ids, cond, flow_cfg,
                       conditioning_scale=1.0)
        pred = unet(lat_in, ts, image_embeddings, ids, down, mid)
        unc, cnd = pred.chunk(2)
        pred = unc + guidance * (cnd - unc)
        # v-prediction: x0 = c_out * v + c_skip * x, then one Euler step
        pred_x0 = (pred * (-sigma / float(np.sqrt(sigma ** 2 + 1)))
                   + latents / (sigma ** 2 + 1))
        latents = latents + (latents - pred_x0) / sigma * (sigma_next - sigma)

    # chunk-local temporal decode (chunks of 8 frames), then postprocess
    flat = latents.flatten(0, 1) / vae.scaling_factor
    frames = torch.cat([vae.decode(flat[i:i + 8], flat[i:i + 8].shape[0])
                        for i in range(0, flat.shape[0], 8)])
    out = (frames / 2 + 0.5).clamp(0, 1)
    return np.moveaxis(out.numpy(), 1, -1)[None]


def test_port_chain_matches_the_reference_chain():
    bundle = ModelBundle.init_random("cpu", torch.Generator().manual_seed(0),
                                     MICRO_UNET_CONFIG, TINY_VAE_CONFIG,
                                     CLIPVisionConfig(**CLIP_KW))
    # smaller random weights keep the video inside [0, 1], so the final
    # clip does not flatten the comparison
    with torch.no_grad():
        for p in bundle.vae.decoder.conv_out.parameters():
            p.mul_(0.05)
    rng = np.random.RandomState(42)
    image01 = rng.rand(1, H, W, 3).astype(np.float32)
    flow = rng.rand(1, T - 1, H, W, 2).astype(np.float32) * 6 - 3
    latents0 = rng.randn(1, T, H // 8, W // 8, 4).astype(np.float32)

    with torch.no_grad():
        ref = reference_chain(*reference_modules(bundle), image01, flow, latents0)
    got, _ = TrajPipeline(bundle, bug_compat=True)(
        torch.from_numpy(image01), torch.from_numpy(flow),
        num_inference_steps=STEPS, noise_aug_strength=0.0,
        latents=torch.from_numpy(latents0), decode_chunk_size=8)
    got = got.numpy()

    assert got.shape == ref.shape == (1, T, H, W, 3)
    clipped = float(np.mean((ref <= 0.0) | (ref >= 1.0)))
    assert clipped < 0.05, f"{clipped:.1%} of the reference video is clipped"
    mse = float(np.mean((got - ref) ** 2))
    psnr = 10.0 * np.log10(1.0 / max(mse, 1e-12))
    print(f"\nport vs reference chain: PSNR {psnr:.1f} dB "
          f"(max|diff| {np.abs(got - ref).max():.2e})")
    assert psnr > 45.0, f"full-chain PSNR {psnr:.1f} dB"
    # two fp32 transcriptions of one function agree to rounding (the
    # reading is at the 120 dB cap of this formula); 90 dB (an RMS of 3e-5)
    # still rejects a bilinear CLIP resize (85 dB) or other time ids
    # (69 dB), which the 45 dB bar lets pass
    assert psnr > 90.0, f"full-chain PSNR {psnr:.1f} dB: not rounding"
