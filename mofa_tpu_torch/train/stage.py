"""EDM training step of the MOFA adapter (stage 1).

Counterpart of mofa_tpu/train/stage.py (the reference's
Training/train_stage1.py:1040-1166 inner loop):

- the clip is VAE-encoded (latent_dist.sample(), in chunks of 8 frames)
  and its first frame CLIP-encoded with the CLIP mean and std, both frozen
  and without gradient;
- sigmas ~ `rand_cosine_interpolated`; noisy = latents + noise * sigma;
  the model input is noisy * c_in, concatenated per frame with the first
  frame's latent (noise-augmented by 0.02, un-scaled);
- timesteps 0.25 * log(sigma); added time ids (6, 127, 0.02);
- InstructPix2Pix conditioning dropout: the CLIP embedding is dropped
  where p < 2q, the image latent where q <= p < 3q;
- denoised = pred * c_out + c_skip * noisy, the (1 + s^2) / s^2-weighted
  MSE to the clean latents;
- gradients reach only the adapter: the UNet, VAE and CLIP hold
  requires_grad False (the UNet is differentiated through, not into).

The random draws (the VAE sample's eps, the noise, the sigmas, the
dropout p) come from one `torch.Generator` in that order (`draw`), or are
passed in, which lets a test hand the port JAX's draws.
"""

from __future__ import annotations

import time

import torch

from mofa_tpu_torch.ops.edm import edm_scalings, rand_cosine_interpolated
from mofa_tpu_torch.ops.resize import resize_antialias_hw
from mofa_tpu_torch.pipelines.common import (ModelBundle, get_add_time_ids,
                                             params_dtype)

# CLIPImageProcessor normalisation: the training encode normalises, unlike
# the inference pipeline's quirk (train_stage1.py:935-954)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

TRAIN_NOISE_AUG = 0.02
VAE_CHUNK = 8


def encode_clip_train(bundle: ModelBundle, pixel01_first: torch.Tensor):
    """[B, H, W, 3] in [0, 1] -> [B, 1, D], CLIP-normalised."""
    size = bundle.clip.cfg.image_size
    x = resize_antialias_hw((pixel01_first * 2.0 - 1.0).permute(0, 3, 1, 2),
                            (size, size)).permute(0, 2, 3, 1)
    x = (x + 1.0) / 2.0
    mean = x.new_tensor(CLIP_MEAN)
    std = x.new_tensor(CLIP_STD)
    return bundle.clip((x - mean) / std)[:, None, :]


def latent_size(bundle: ModelBundle, h: int, w: int) -> tuple:
    f = 2 ** (len(bundle.vae.cfg.block_out_channels) - 1)
    return h // f, w // f


def vae_encode_video(bundle: ModelBundle, pixels_pm1: torch.Tensor,
                     eps: torch.Tensor, chunk: int = VAE_CHUNK) -> torch.Tensor:
    """[B, T, H, W, 3] in [-1, 1] -> scaled sampled latents [B, T, h, w, 4]
    (tensor_to_vae_latent, train_stage1.py:319-327): mean + exp(logvar / 2)
    * eps, eps [B*T, h, w, 4]; the frames encoded `chunk` at a time (the
    per-frame encoder makes that exact and bounds its activations)."""
    b, t = pixels_pm1.shape[:2]
    flat = pixels_pm1.reshape((b * t,) + pixels_pm1.shape[2:])
    moments = [bundle.vae.encode_moments(part) for part in flat.split(chunk)]
    mean = torch.cat([m[0] for m in moments])
    logvar = torch.cat([m[1] for m in moments])
    z = mean + torch.exp(0.5 * logvar) * eps
    return z.reshape((b, t) + z.shape[1:]) * bundle.vae.cfg.scaling_factor


def draw(generator: torch.Generator, bundle: ModelBundle, b: int, t: int,
         h: int, w: int) -> dict:
    """One step's random draws, in order: the VAE sample's eps [B*T, h/8,
    w/8, 4], the noise [B, T, h/8, w/8, 4], the sigmas [B] (from stratified
    uniforms) and the dropout p [B]."""
    lh, lw = latent_size(bundle, h, w)
    c = bundle.vae.cfg.latent_channels
    dev = generator.device
    eps = torch.randn(b * t, lh, lw, c, generator=generator, device=dev)
    noise = torch.randn(b, t, lh, lw, c, generator=generator, device=dev)
    sigmas = rand_cosine_interpolated((b,), generator=generator)
    drop_p = torch.rand(b, generator=generator, device=dev)
    return {"vae_eps": eps, "noise": noise, "sigmas": sigmas, "drop_p": drop_p}


def edm_loss(controlnet, bundle: ModelBundle, batch: dict, draws: dict,
             cond_dropout_prob: float | None = 0.1):
    """batch: pixel_values01 [B, T, H, W, 3], flows [B, T-1, H, W, 2];
    draws as `draw` returns them. Computes in the UNet's dtype (fp32 in
    training, as the JAX package). Returns (loss, metrics)."""
    dtype = params_dtype(bundle.unet)
    px01 = batch["pixel_values01"].to(dtype)
    flows = batch["flows"].to(dtype)
    b, t = px01.shape[:2]
    unet = bundle.unet
    pixels_pm1 = px01 * 2.0 - 1.0
    with torch.no_grad():
        latents = vae_encode_video(bundle, pixels_pm1, draws["vae_eps"])
        ehs = encode_clip_train(bundle, px01[:, 0])
    noise, sigmas = draws["noise"], draws["sigmas"]
    s = sigmas.reshape((b,) + (1,) * (latents.ndim - 1))

    # the first frame's conditional latent: 0.02-noise-augmented, un-scaled
    cond_lat = ((latents + noise * TRAIN_NOISE_AUG)[:, 0]
                / bundle.vae.cfg.scaling_factor)
    noisy = latents + noise * s
    c_out, c_skip, weighting, c_in, timesteps = edm_scalings(s)
    inp = noisy * c_in
    added_time_ids = get_add_time_ids(6, 127, TRAIN_NOISE_AUG, b, do_cfg=False,
                                      device=px01.device).to(dtype)
    if cond_dropout_prob:
        q, p = cond_dropout_prob, draws["drop_p"]
        ehs = torch.where((p < 2 * q)[:, None, None], torch.zeros_like(ehs), ehs)
        image_mask = 1.0 - ((p >= q) & (p < 3 * q)).to(cond_lat.dtype)
        cond_lat = cond_lat * image_mask.reshape(b, 1, 1, 1)
    cond_lat = cond_lat[:, None].expand((b, t) + cond_lat.shape[1:])
    inp = torch.cat([inp, cond_lat], dim=-1)

    ts = timesteps.reshape(b)
    down, mid = controlnet(inp, ts, ehs, added_time_ids,
                           controlnet_cond=pixels_pm1[:, 0], controlnet_flow=flows)
    pred = unet(inp, ts, ehs, added_time_ids, down, mid)

    denoised = pred * c_out + c_skip * noisy
    acc = torch.promote_types(dtype, torch.float32)    # fp32 at the least
    err = (denoised.to(acc) - latents.to(acc)) ** 2
    per_sample = (weighting.to(acc) * err).reshape(b, -1).mean(dim=1)
    loss = per_sample.mean()
    return loss, {"loss": loss.detach(), "sigma_mean": sigmas.mean()}


def _sync(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def make_train_step(bundle: ModelBundle, state, generator: torch.Generator,
                    cond_dropout_prob: float | None = 0.1, remat: bool = False,
                    accum_steps: int = 1):
    """Returns step(batch) -> metrics: `accum_steps` micro-batches (batch
    tensors with a leading [accum_steps] axis when it is above 1; replaces
    accelerator.accumulate, train_stage1.py:1040), each with its draws from
    `generator` and its loss / accum_steps back-propagated into the
    adapter's grads, then one `state.apply_gradients()`. Metrics: loss and
    sigma_mean (means over the micro-batches), grad_norm (before
    clipping), and the seconds of forward + backward and of the optimizer
    (the device synchronised)."""
    controlnet = state.model
    controlnet.remat_blocks = remat
    bundle.unet.remat_blocks = remat

    def step(batch: dict) -> dict:
        dev = batch["pixel_values01"].device
        t0 = _sync(dev)
        micro = ([batch] if accum_steps == 1 else
                 [{k: v[i] for k, v in batch.items()} for i in range(accum_steps)])
        losses, sig = [], []
        for mb in micro:
            d = draw(generator, bundle, *mb["pixel_values01"].shape[:4])
            loss, metrics = edm_loss(controlnet, bundle, mb, d, cond_dropout_prob)
            (loss / accum_steps).backward()
            losses.append(metrics["loss"])
            sig.append(metrics["sigma_mean"])
        t1 = _sync(dev)
        grad_norm = state.apply_gradients()
        t2 = _sync(dev)
        return {"loss": torch.stack(losses).mean(), "sigma_mean": torch.stack(sig).mean(),
                "grad_norm": grad_norm, "fwd_bwd_s": t1 - t0, "optimizer_s": t2 - t1}

    return step
