"""AutoencoderKLTemporalDecoder (the SVD VAE): 2-D encoder + temporal decoder.

Counterpart of mofa_tpu/models/vae.py with diffusers-0.24 names. Public
layouts are channel-last: images [N, H, W, 3], latents [N, h, w, 4].

- `encode_mode`: the SD VAE encoder (stride-2 downsamplers with the
  asymmetric (0, 1) pad), quant_conv, mean of the moments;
  `encode_moments`: the mean and the clamped log-variance (training).
- `decode`: the temporal decoder. Its mid block holds `layers_per_block`
  resnets and ONE attention, and diffusers zips resnets[1:] against the
  attention list, so exactly resnets[0] [, attention, resnets[1]] run: at
  layers_per_block = 1 the attention is in the state dict but never runs.
  The final (3, 1, 1) `time_conv_out` mixes the frames of the decoded
  video (the caller decides what a video is; see pipelines/common.py).

The mid-block attention is single-head over all h*w tokens; the JAX
package leaves it to XLA, and here it stays plain PyTorch (matmul + fp32
softmax).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mofa_tpu_torch.models.layers import GroupNorm
from mofa_tpu_torch.models.resnet_blocks import (ResnetBlock2D,
                                                 SpatioTemporalResBlock)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215


TINY_VAE_CONFIG = VAEConfig(block_out_channels=(32, 32, 64, 64), layers_per_block=1)


class VAEAttention(nn.Module):
    """Single-head attention with GroupNorm prenorm, biased q/k/v/out and
    a residual."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(32, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        n, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(n, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        logits = torch.matmul(q, k.transpose(1, 2))
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32)) * c ** -0.5
        y = torch.matmul(torch.softmax(logits, dim=-1).to(y.dtype), v)
        y = self.to_out[0](y).reshape(n, h, w, c).permute(0, 3, 1, 2)
        return y + x


def _module(**children) -> nn.Module:
    m = nn.Module()
    for name, child in children.items():
        setattr(m, name, child)
    return m


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels[0]
        self.conv_in = nn.Conv2d(cfg.in_channels, ch, 3, padding=1)
        self.down_blocks = nn.ModuleList()
        for i, cout in enumerate(cfg.block_out_channels):
            resnets = nn.ModuleList([ResnetBlock2D(ch if j == 0 else cout, cout,
                                                   None, 1e-6)
                                     for j in range(cfg.layers_per_block)])
            down = None
            if i < len(cfg.block_out_channels) - 1:
                down = nn.ModuleList([_module(conv=nn.Conv2d(cout, cout, 3, stride=2))])
            self.down_blocks.append(_module(resnets=resnets, downsamplers=down))
            ch = cout
        self.mid_block = _module(
            resnets=nn.ModuleList([ResnetBlock2D(ch, ch, None, 1e-6),
                                   ResnetBlock2D(ch, ch, None, 1e-6)]),
            attentions=nn.ModuleList([VAEAttention(ch)]))
        self.conv_norm_out = GroupNorm(32, ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if block.downsamplers is not None:
                x = block.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        x = self.mid_block.resnets[0](x)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


def _st_block(cin: int, cout: int) -> SpatioTemporalResBlock:
    return SpatioTemporalResBlock(cin, cout, None, eps=1e-6, temporal_eps=1e-5,
                                  merge_strategy="learned",
                                  switch_spatial_to_temporal_mix=True)


class TemporalDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels[-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch, 3, padding=1)
        self.mid_block = _module(
            resnets=nn.ModuleList([_st_block(ch, ch)
                                   for _ in range(cfg.layers_per_block)]),
            attentions=nn.ModuleList([VAEAttention(ch)]))
        self.up_blocks = nn.ModuleList()
        rev = list(reversed(cfg.block_out_channels))
        prev = rev[0]
        for i, cout in enumerate(rev):
            resnets = nn.ModuleList([_st_block(prev if j == 0 else cout, cout)
                                     for j in range(cfg.layers_per_block + 1)])
            up = None
            if i < len(rev) - 1:
                up = nn.ModuleList([_module(conv=nn.Conv2d(cout, cout, 3, padding=1))])
            self.up_blocks.append(_module(resnets=resnets, upsamplers=up))
            prev = cout
        c0 = cfg.block_out_channels[0]
        self.conv_norm_out = GroupNorm(32, c0, eps=1e-6)
        self.conv_out = nn.Conv2d(c0, cfg.out_channels, 3, padding=1)
        self.time_conv_out = nn.Conv3d(cfg.out_channels, cfg.out_channels,
                                       (3, 1, 1), padding=(1, 0, 0))

    def forward(self, z, image_only_indicator):
        # z [B*T, latent, h, w]; image_only_indicator [B, T]
        x = self.conv_in(z)
        x = self.mid_block.resnets[0](x, None, image_only_indicator)
        for resnet, attn in zip(self.mid_block.resnets[1:],
                                self.mid_block.attentions):
            x = attn(x)
            x = resnet(x, None, image_only_indicator)
        for block in self.up_blocks:
            for resnet in block.resnets:
                x = resnet(x, None, image_only_indicator)
            if block.upsamplers is not None:
                x = block.upsamplers[0].conv(
                    F.interpolate(x, scale_factor=2.0, mode="nearest"))
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        b, t = image_only_indicator.shape
        bt, c, h, w = x.shape
        x = self.time_conv_out(x.reshape(b, t, c, h, w).permute(0, 2, 1, 3, 4))
        return x.permute(0, 2, 1, 3, 4).reshape(bt, c, h, w)


class AutoencoderKLTemporalDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = TemporalDecoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, 1)

    def encode_mode(self, x):
        """x [N, H, W, 3] in [-1, 1] -> latent mean [N, H/8, W/8, 4]."""
        moments = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        return moments[:, :self.cfg.latent_channels].permute(0, 2, 3, 1)

    def encode_moments(self, x):
        """x [N, H, W, 3] in [-1, 1] -> (mean, logvar), each [N, H/8, W/8,
        4]; logvar clamped to [-30, 20] as diffusers'
        DiagonalGaussianDistribution (the training encode samples it)."""
        moments = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        moments = moments.permute(0, 2, 3, 1)
        c = self.cfg.latent_channels
        return moments[..., :c], moments[..., c:].clamp(-30.0, 20.0)

    def decode(self, z, num_frames: int):
        """z [B*T, h, w, 4] (already divided by the scaling factor) ->
        frames [B*T, H, W, 3]; the T frames of each video share the
        temporal convs."""
        b = z.shape[0] // num_frames
        indicator = torch.zeros(b, num_frames, dtype=z.dtype, device=z.device)
        frames = self.decoder(z.permute(0, 3, 1, 2).contiguous(), indicator)
        return frames.permute(0, 2, 3, 1)
