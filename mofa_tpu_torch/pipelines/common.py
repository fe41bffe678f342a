"""Shared pipeline pieces: model bundle, encoders, VAE decode (PyTorch).

Counterpart of mofa_tpu/pipelines/common.py. Image tensors are
channel-last; frames [B, T, H, W, C].
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn as nn

from mofa_tpu_torch.models.clip_vision import (CLIPVisionConfig,
                                               CLIPVisionModelWithProjection)
from mofa_tpu_torch.models.mofa_adapter import FlowControlNet, LdmkFlowControlNet
from mofa_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                            UNetSpatioTemporalConditionModel)
from mofa_tpu_torch.models.vae import AutoencoderKLTemporalDecoder, VAEConfig
from mofa_tpu_torch.ops.resize import resize_antialias_hw


def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Overwrite every parameter with a seeded random draw (in place).

    Matrices and conv kernels ~ N(0, 1/fan_in); biases ~ N(0, 0.02²);
    norm scales ~ 1 + N(0, 0.05²); embeddings ~ N(0, 0.02²); mix factors
    ~ N(0, 1). The adapter's zero convs get random weights too, so the
    residual stack carries signal through every kernel."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.endswith(("position_embedding.weight", "class_embedding")):
                p.normal_(0.0, 0.02, generator=generator)
            elif p.ndim >= 2:
                fan_in = p[0].numel()
                p.normal_(0.0, fan_in ** -0.5, generator=generator)
            elif leaf == "mix_factor":
                p.normal_(0.0, 1.0, generator=generator)
            elif leaf == "weight":
                p.normal_(1.0, 0.05, generator=generator)
            else:
                p.normal_(0.0, 0.02, generator=generator)
    return module


@dataclasses.dataclass
class ModelBundle:
    """The frozen SVD parts and the MOFA-Adapter(s). `controlnet` is the
    trajectory adapter, or the landmark adapter of the hybrid workload,
    whose trajectory adapter is then `controlnet2`."""

    unet: UNetSpatioTemporalConditionModel
    controlnet: Union[FlowControlNet, LdmkFlowControlNet]
    vae: AutoencoderKLTemporalDecoder
    clip: CLIPVisionModelWithProjection
    controlnet2: Optional[FlowControlNet] = None

    @staticmethod
    def part_constructors(unet_cfg: SVDUNetConfig = SVDUNetConfig(),
                      vae_cfg: VAEConfig = VAEConfig(),
                      clip_cfg: CLIPVisionConfig = CLIPVisionConfig(),
                      ldmk: bool = False, dual: bool = False) -> dict:
        """Part name -> a function building that part (uninitialised), in
        the order their random weights are drawn. ldmk: `controlnet` is a
        LdmkFlowControlNet; dual: a FlowControlNet `controlnet2` too."""
        parts = {"unet": lambda: UNetSpatioTemporalConditionModel(unet_cfg),
                 "controlnet": lambda: (LdmkFlowControlNet if ldmk
                                        else FlowControlNet)(unet_cfg),
                 "vae": lambda: AutoencoderKLTemporalDecoder(vae_cfg),
                 "clip": lambda: CLIPVisionModelWithProjection(clip_cfg)}
        if dual:
            parts["controlnet2"] = lambda: FlowControlNet(unet_cfg)
        return parts

    @classmethod
    def init_random(cls, device, generator: torch.Generator,
                    unet_cfg: SVDUNetConfig = SVDUNetConfig(),
                    vae_cfg: VAEConfig = VAEConfig(),
                    clip_cfg: CLIPVisionConfig = CLIPVisionConfig(),
                    dtype: torch.dtype = torch.float32, ldmk: bool = False,
                    dual: bool = False) -> "ModelBundle":
        """Random-weight bundle built and drawn on `device` (the generator
        must live there), then cast to `dtype`, in eval mode; ldmk / dual
        as in `part_constructors`."""
        parts = {}
        for name, build in cls.part_constructors(unet_cfg, vae_cfg, clip_cfg,
                                                 ldmk, dual).items():
            with torch.device(device):
                m = build()
            init_random_(m, generator)
            parts[name] = m.to(dtype).eval().requires_grad_(False)
        return cls(**parts)

    def modules(self):
        mods = {"unet": self.unet, "controlnet": self.controlnet,
                "vae": self.vae, "clip": self.clip}
        if self.controlnet2 is not None:
            mods["controlnet2"] = self.controlnet2
        return mods


def params_dtype(module: nn.Module) -> torch.dtype:
    """Compute dtype of a model: the dtype of its first floating parameter."""
    for p in module.parameters():
        if p.is_floating_point():
            return p.dtype
    return torch.float32


def encode_clip_image(bundle: ModelBundle, image01: torch.Tensor,
                      do_cfg: bool) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> [2B or B, 1, proj_dim]. Replicates the
    reference's quirk of feeding UN-normalised [0, 1] pixels through the
    antialiased bicubic resize."""
    size = bundle.clip.cfg.image_size
    x = resize_antialias_hw(image01.permute(0, 3, 1, 2), (size, size))
    x = x.permute(0, 2, 3, 1).to(params_dtype(bundle.clip))
    emb = bundle.clip(x)[:, None, :]
    if do_cfg:
        emb = torch.cat([torch.zeros_like(emb), emb], dim=0)
    return emb


def encode_vae_image(bundle: ModelBundle, image_pm1: torch.Tensor,
                     do_cfg: bool) -> torch.Tensor:
    """[B, H, W, 3] in [-1, 1] -> latent mean [2B or B, h, w, 4] (unscaled)."""
    lat = bundle.vae.encode_mode(image_pm1.to(params_dtype(bundle.vae)))
    if do_cfg:
        lat = torch.cat([torch.zeros_like(lat), lat], dim=0)
    return lat


def decode_latents(bundle: ModelBundle, latents: torch.Tensor,
                   decode_chunk_size: int = 8) -> torch.Tensor:
    """[B, T, h, w, 4] -> frames [B, T, H, W, 3] fp32 in [-1, 1]. Chunked:
    each chunk of `decode_chunk_size` frames is its own video for the
    temporal convs (the reference's decode_latents)."""
    b, t = latents.shape[:2]
    flat = latents.reshape((b * t,) + latents.shape[2:])
    flat = (flat / bundle.vae.cfg.scaling_factor).to(params_dtype(bundle.vae))
    frames = [bundle.vae.decode(chunk, chunk.shape[0]).float()
              for chunk in flat.split(decode_chunk_size)]
    out = torch.cat(frames, dim=0)
    return out.reshape((b, t) + out.shape[1:])


def get_add_time_ids(fps: float, motion_bucket_id: float, noise_aug: float,
                     batch_size: int, do_cfg: bool, device=None) -> torch.Tensor:
    ids = torch.tensor([[fps, motion_bucket_id, noise_aug]],
                       dtype=torch.float32, device=device)
    ids = ids.repeat(batch_size, 1)
    return torch.cat([ids, ids], dim=0) if do_cfg else ids


def postprocess_frames(frames_pm1: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1] clipped (VaeImageProcessor.postprocess 'np')."""
    return (frames_pm1 / 2 + 0.5).clamp(0.0, 1.0)
