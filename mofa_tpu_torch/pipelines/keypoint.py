"""Keypoint pipeline: sliding-window denoise of a long video (PyTorch).

Counterpart of mofa_tpu/pipelines/keypoint.py (reference MOFA-Video-Keypoint
`svdxt_pipeline_ctrlnet_loop.py.__call__`): the landmark adapter drives a
video longer than the model's window.

- views `[(1+i*s, i*s+W)] + [(N-W+1, N)]` over the non-anchor frames, each
  window being frame 0 (the anchor) plus W-1 frames; the last view is kept
  even when it repeats the one before (`(N - W) % S == 0`), as the
  reference keeps it;
- the landmark adapter's warped feature stack of every view is computed
  once per video, at B rows (both CFG halves see the same first frame,
  flows and landmarks), and repeated for the CFG batch per call;
- steps outside, views inside: every window of a step is denoised at the
  same sigma (the reference's step-index rollback, made structural);
- overlaps averaged in fp32 by value / count, frame 0 counted only from
  view 0;
- guidance linspace(min, max, W) over the window; added-time ids
  (6, 128, noise_aug_strength); one video at a time.

`window_batch` stacks that many windows on the batch axis of one denoiser
call, in (cfg, view, frame) order, the view count padded to a multiple of
it with zero-weight copies of the last view. Within a step the windows
interact only through the overlap average, so the result is the
window-at-a-time one. The JAX package's `big_program`, `cfg_split` and
`offload_encoders` are not ported: they shrink its compiled program or fit
it into one 16 GB TPU chip.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mofa_tpu_torch.ops.euler import (euler_step, make_euler_schedule,
                                      scale_model_input)
from mofa_tpu_torch.pipelines.common import (ModelBundle, decode_latents,
                                             encode_clip_image,
                                             encode_vae_image,
                                             get_add_time_ids, params_dtype,
                                             postprocess_frames)
from mofa_tpu_torch.pipelines.traj import _PhaseClock


def window_views(num_frames: int, window_size: int, stride: int) -> list[tuple[int, int]]:
    """Reference view list: [(1+i*s, i*s+W)] + [(N-W+1, N)] over 1-based
    non-anchor frames (svdxt_pipeline_ctrlnet_loop.py:426-429)."""
    n = (num_frames - window_size) // stride + 1
    views = [(1 + i * stride, i * stride + window_size) for i in range(n)]
    views.append((num_frames - window_size + 1, num_frames))
    return views


def view_index_array(num_frames: int, window_size: int, stride: int) -> np.ndarray:
    """[V, W] frame indices per window: anchor 0 + frames t_start..t_end-1."""
    views = window_views(num_frames, window_size, stride)
    idx = np.zeros((len(views), window_size), np.int32)
    for v, (t_start, t_end) in enumerate(views):
        idx[v] = np.concatenate([[0], np.arange(t_start, t_end)])
    return idx


def window_groups(num_frames: int, window_size: int, stride: int,
                  window_batch: int) -> tuple[np.ndarray, np.ndarray]:
    """The views in groups of `window_batch`: frame indices [G, vb, W] and
    overlap weights [G, vb, W] (frame 0 weighs 1 in view 0 only; the
    copies of the last view that pad the last group weigh 0)."""
    idx = view_index_array(num_frames, window_size, stride)
    n_views = idx.shape[0]
    weights = np.ones(idx.shape, np.float32)
    weights[1:, 0] = 0.0
    pad = -n_views % window_batch
    if pad:
        idx = np.concatenate([idx, np.repeat(idx[-1:], pad, axis=0)])
        weights = np.concatenate([weights, np.zeros((pad, window_size), np.float32)])
    shape = (-1, window_batch, window_size)
    return idx.reshape(shape), weights.reshape(shape)


class KeypointPipeline:
    """bundle.controlnet: LdmkFlowControlNet."""

    def __init__(self, bundle: ModelBundle):
        self.bundle = bundle

    @torch.no_grad()
    def __call__(self, image01: torch.Tensor, controlnet_flow: torch.Tensor,
                 landmarks: torch.Tensor,
                 window_size: int = 25, stride: int = 12,
                 num_inference_steps: int = 25,
                 min_guidance_scale: float = 1.0, max_guidance_scale: float = 3.0,
                 noise_aug_strength: float = 0.02,
                 controlnet_cond_scale: float = 1.0,
                 decode_chunk_size: int = 8,
                 generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None,
                 output_type: str = "np",
                 window_batch: int = 1,
                 phase_times: Optional[dict] = None):
        """image01 [1, H, W, 3] in [0, 1]; controlnet_flow [1, T-1, H, W, 2];
        landmarks [1, T, H, W, 3] landmark frames in [0, 1]. Random draws
        (noise augmentation, initial latents) come from `generator`.
        Returns (frames [1, T, H, W, 3] in [0, 1], or the latents for
        output_type="latent", and controlnet_flow). phase_times: as in
        TrajPipeline ("warp" holds every view's features; one
        "denoise_step" a step over all windows)."""
        bundle = self.bundle
        b = image01.shape[0]
        if b != 1:
            raise ValueError(f"the windowed pipeline takes one video; got B = {b}")
        t = landmarks.shape[1]
        if not 1 < window_size <= t or stride < 1 or window_batch < 1:
            raise ValueError(f"window {window_size}, stride {stride}, window_batch "
                             f"{window_batch} for a {t}-frame video")
        dev = image01.device
        clock = _PhaseClock(phase_times, dev)
        h, w = image01.shape[1:3]
        image01 = image01.float()
        sched = make_euler_schedule(num_inference_steps)
        cd = params_dtype(bundle.unet)

        image_embeddings = encode_clip_image(bundle, image01, do_cfg=True).to(cd)
        clock.mark("clip_encode")

        image_pm1 = image01 * 2.0 - 1.0
        image_aug = image_pm1
        if noise_aug_strength:
            image_aug = image_pm1 + noise_aug_strength * torch.randn(
                image_pm1.shape, generator=generator, device=dev)
        image_latents = encode_vae_image(bundle, image_aug, do_cfg=True).to(cd)
        clock.mark("vae_encode")

        added_time_ids = get_add_time_ids(6, 128, noise_aug_strength, b, True, dev)
        latent_c = bundle.unet.cfg.in_channels // 2
        if latents is None:
            latents = torch.randn((b, t, h // 8, w // 8, latent_c),
                                  generator=generator, device=dev)
        latents = latents.float() * sched.init_noise_sigma
        guidance = torch.linspace(min_guidance_scale, max_guidance_scale,
                                  window_size, device=dev)[None, :, None, None, None]

        vb = window_batch
        idx_np, w_np = window_groups(t, window_size, stride, vb)
        # every view's features at B rows, once: the flow window is
        # flow[:, idx[1:] - 1], the landmark window landmarks[:, idx]
        cond = image_pm1.to(cd)
        feats_of_view = {}             # a repeated view is encoded once
        for v in idx_np.reshape(-1, window_size):
            key = tuple(int(i) for i in v)
            if key not in feats_of_view:
                sel = torch.as_tensor(v, device=dev, dtype=torch.long)
                feats_of_view[key], _ = bundle.controlnet.encode_features(
                    cond, controlnet_flow[:, sel[1:] - 1].to(cd),
                    landmarks[:, sel].to(cd))
        # each group's features in (view, frame) row order; the CFG halves
        # are the same rows twice, stacked per call
        groups = []
        for idx_g, w_g in zip(idx_np, w_np):
            views = [feats_of_view[tuple(int(i) for i in v)] for v in idx_g]
            feats = [torch.cat(level) if vb > 1 else level[0]
                     for level in zip(*views)]
            flat = torch.as_tensor(idx_g.reshape(-1), device=dev, dtype=torch.long)
            weight = torch.as_tensor(w_g.reshape(-1), device=dev)[:, None, None, None]
            groups.append((flat, weight, feats))
        del feats_of_view
        count = torch.zeros(t, device=dev).index_add_(
            0, torch.as_tensor(idx_np.reshape(-1), device=dev, dtype=torch.long),
            torch.as_tensor(w_np.reshape(-1), device=dev))[:, None, None, None]
        ehs = image_embeddings.repeat_interleave(vb, dim=0)        # [2vb, 1, D]
        ids = added_time_ids.repeat_interleave(vb, dim=0)          # [2vb, 3]
        img_lat = image_latents[:, None, None].expand(
            (2, vb, window_size) + image_latents.shape[1:]).reshape(
            (2 * vb, window_size) + image_latents.shape[1:])      # [2vb, W, h, w, 4]
        clock.mark("warp")

        for i in range(num_inference_steps):
            sigma = float(sched.sigmas[i])
            sigma_next = float(sched.sigmas[i + 1])
            ts = float(sched.timesteps[i])
            value = torch.zeros_like(latents[0])
            for flat, weight, feats in groups:
                win_lat = latents[0, flat].reshape((vb, window_size) + latents.shape[2:])
                latent_in = scale_model_input(torch.cat([win_lat] * 2), sigma)
                latent_in = torch.cat([latent_in.to(cd), img_lat], dim=-1)
                inject = [torch.cat([f, f]) for f in feats]
                down, mid = bundle.controlnet(
                    latent_in, ts, ehs, ids, conditioning_scale=controlnet_cond_scale,
                    precomputed_features=inject)
                noise_pred = bundle.unet(latent_in, ts, ehs, ids,
                                         down_block_additional_residuals=down,
                                         mid_block_additional_residual=mid)
                uncond, cond_pred = noise_pred.chunk(2)
                noise_pred = uncond + guidance.to(cond_pred.dtype) * (cond_pred - uncond)
                new_win, _ = euler_step(noise_pred, win_lat, sigma, sigma_next)
                value.index_add_(0, flat, new_win.reshape(
                    (vb * window_size,) + value.shape[1:]) * weight)
            latents = torch.where(count > 0, value / count, value)[None]
            clock.mark("denoise_step")

        if output_type == "latent":
            return latents, controlnet_flow
        frames = postprocess_frames(decode_latents(bundle, latents,
                                                   decode_chunk_size))
        clock.mark("decode")
        return frames, controlnet_flow
