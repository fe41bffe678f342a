"""Trajectory pipeline: the single-adapter SVD denoise loop (PyTorch).

Counterpart of mofa_tpu/pipelines/traj.py (reference
`FlowControlNetPipeline.__call__`, pipeline.py:282-528):
- CLIP and VAE encode the first frame;
- the MOFA adapter's warped feature stack is computed ONCE per video
  (it depends on neither the latent nor the timestep);
- a batched-CFG Euler loop runs the adapter trunk and the UNet on the
  [uncond, cond] batch; the latent carry and the Euler math stay fp32
  while the models run in their parameter dtype;
- the temporal VAE decodes the latents in chunks.

Bug-compat quirks kept (default on): added_time_ids hardcoded to
(fps=6, motion=128, aug=0.02); CLIP sees un-normalised [0, 1] pixels;
per-frame guidance linspace(min, max).

With `mesh` (core.mesh.make_mesh) the adapter encode and the denoise run
frame-parallel (pipelines/common.py), at the places the JAX package
enters `frame_parallel` (mofa_tpu/pipelines/traj.py:178,291,308).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from mofa_tpu_torch.ops.euler import (euler_step, make_euler_schedule,
                                      scale_model_input)
from mofa_tpu_torch.pipelines.common import (ModelBundle, decode_latents,
                                             encode_clip_image,
                                             encode_vae_image,
                                             frame_parallel_or_none,
                                             get_add_time_ids,
                                             local_frame_rows, params_dtype,
                                             postprocess_frames, replicated)


class _PhaseClock:
    """Wall seconds per phase, synchronising the device at each mark;
    a no-op without a target dict."""

    def __init__(self, target: Optional[dict], device: torch.device):
        self.target, self.device = target, device
        self.t0 = self._now() if target is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, name: str) -> None:
        if self.target is None:
            return
        now = self._now()
        self.target.setdefault(name, []).append(now - self.t0)
        self.t0 = now


class TrajPipeline:
    def __init__(self, bundle: ModelBundle, bug_compat: bool = True,
                 mesh=None):
        """mesh: a DeviceMesh for frame-parallel inference (None: one
        device)."""
        self.bundle = bundle
        self.bug_compat = bug_compat
        self.mesh = mesh

    @torch.no_grad()
    def __call__(self, image01: torch.Tensor, controlnet_flow: torch.Tensor,
                 num_inference_steps: int = 25,
                 min_guidance_scale: float = 1.0, max_guidance_scale: float = 3.0,
                 fps: int = 7, motion_bucket_id: int = 127,
                 noise_aug_strength: float = 0.02,
                 controlnet_cond_scale: float = 1.0,
                 decode_chunk_size: int = 8,
                 generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None,
                 output_type: str = "np",
                 phase_times: Optional[dict] = None):
        """image01 [B, H, W, 3] first frame in [0, 1] (H, W multiples of 64);
        controlnet_flow [B, T-1, H, W, 2]. Random draws (noise
        augmentation, initial latents) come from `generator`, on the
        inputs' device. Returns (frames [B, T, H, W, 3] in [0, 1], or the
        latents for output_type="latent", and controlnet_flow).

        phase_times: if a dict is given, the device is synchronised after
        each phase and its wall seconds are appended under "clip_encode",
        "vae_encode", "warp", "denoise_step" (one entry per step) and
        "decode"."""
        bundle = self.bundle
        dev = image01.device
        clock = _PhaseClock(phase_times, dev)
        b = image01.shape[0]
        t = controlnet_flow.shape[1] + 1
        h, w = image01.shape[1:3]
        image01 = image01.float()
        sched = make_euler_schedule(num_inference_steps)
        cd = params_dtype(bundle.unet)

        image_embeddings = encode_clip_image(bundle, image01, do_cfg=True)
        clock.mark("clip_encode")

        image_pm1 = image01 * 2.0 - 1.0
        if noise_aug_strength:
            image_pm1 = image_pm1 + noise_aug_strength * torch.randn(
                image_pm1.shape, generator=generator, device=dev)
        image_latents = encode_vae_image(bundle, image_pm1, do_cfg=True)
        image_latents = image_latents[:, None].expand(
            (2 * b, t) + image_latents.shape[1:]).to(cd)           # [2B,T,h,w,4]
        clock.mark("vae_encode")

        if self.bug_compat:
            added_time_ids = get_add_time_ids(6, 128, 0.02, b, True, dev)
        else:
            added_time_ids = get_add_time_ids(fps - 1, motion_bucket_id,
                                              noise_aug_strength, b, True, dev)

        latent_c = bundle.unet.cfg.in_channels // 2
        if latents is None:
            latents = torch.randn((b, t, h // 8, w // 8, latent_c),
                                  generator=generator, device=dev)
        latents = latents.float() * sched.init_noise_sigma

        cond_image = torch.cat([image01 * 2.0 - 1.0] * 2).to(cd)
        flow_cfg = torch.cat([controlnet_flow] * 2).to(cd)
        guidance = torch.linspace(min_guidance_scale, max_guidance_scale, t,
                                  device=dev)[None, :, None, None, None]

        with frame_parallel_or_none(self.mesh):
            image_embeddings, image_latents, latents = replicated(
                image_embeddings.to(cd), image_latents, latents)
            rows = local_frame_rows(2 * b * t)
            inject = bundle.controlnet.encode_features(
                cond_image, flow_cfg, **({} if rows is None else {"rows": rows}))
            clock.mark("warp")
            latents = self._denoise(sched, num_inference_steps, latents,
                                    image_latents, image_embeddings,
                                    added_time_ids, inject, guidance,
                                    controlnet_cond_scale, cd, clock)

        if output_type == "latent":
            return latents, controlnet_flow
        frames = postprocess_frames(decode_latents(bundle, latents,
                                                   decode_chunk_size, self.mesh))
        clock.mark("decode")
        return frames, controlnet_flow

    def _denoise(self, sched, num_inference_steps, latents, image_latents,
                 image_embeddings, added_time_ids, inject, guidance,
                 controlnet_cond_scale, cd, clock):
        bundle = self.bundle
        for i in range(num_inference_steps):
            sigma = float(sched.sigmas[i])
            sigma_next = float(sched.sigmas[i + 1])
            ts = float(sched.timesteps[i])
            latent_in = scale_model_input(torch.cat([latents] * 2), sigma)
            latent_in = torch.cat([latent_in.to(cd), image_latents], dim=-1)
            down, mid = bundle.controlnet(
                latent_in, ts, image_embeddings, added_time_ids,
                conditioning_scale=controlnet_cond_scale,
                precomputed_features=inject)
            noise_pred = bundle.unet(latent_in, ts, image_embeddings,
                                     added_time_ids,
                                     down_block_additional_residuals=down,
                                     mid_block_additional_residual=mid)
            uncond, cond = noise_pred.chunk(2)
            noise_pred = uncond + guidance.to(cond.dtype) * (cond - uncond)
            latents, _ = euler_step(noise_pred, latents, sigma, sigma_next)
            clock.mark("denoise_step")
        return latents
