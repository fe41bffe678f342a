"""Frozen SVD-XT spatio-temporal UNet with ControlNet residuals (PyTorch).

Counterpart of mofa_tpu/models/svd_unet.py
(`UNetSpatioTemporalConditionControlNetModel` on diffusers-0.24's SVD
UNet). Public layouts are the JAX package's: sample [B, T, H, W, C], the
ControlNet residuals [B*T, h, w, c]. Inside, activations are contiguous
NCHW tensors: PyTorch's CUDA GroupNorm copies channel-last inputs to NCHW
and back, which cost more than cuDNN's NCHW convolutions save (measured
on the H100, PERF.md).

Replicated quirk: the reference adds the ControlNet residuals inside the
down-block loop by re-zipping the GROWING skip tuple against the residual
list each iteration, so residual k is re-added once per later down block:
multiplicities [4, 4, 4, 4, 3, 3, 3, 2, 2, 2, 1, 1] for the 4-block config.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mofa_tpu_torch.models.layers import (GroupNorm, TimestepEmbedding,
                                          get_timestep_embedding)
from mofa_tpu_torch.models.unet_blocks import (
    CrossAttnDownBlockSpatioTemporal, CrossAttnUpBlockSpatioTemporal,
    DownBlockSpatioTemporal, UNetMidBlockSpatioTemporal,
    UpBlockSpatioTemporal)


@dataclasses.dataclass(frozen=True)
class SVDUNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlockSpatioTemporal",
        "CrossAttnDownBlockSpatioTemporal",
        "CrossAttnDownBlockSpatioTemporal",
        "DownBlockSpatioTemporal",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    transformer_layers_per_block: int = 1
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    # The MOFA adapter's trunk runs ControlNetSDVModel's default heads
    # (5, 10, 10, 20), not the UNet checkpoint's: FlowControlNet.__init__
    # never forwards its arguments to super().__init__().
    controlnet_num_attention_heads: Tuple[int, ...] = (5, 10, 10, 20)
    time_context_hw_major_quirk: bool = True

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


# single-layer blocks: the cheapest config that still has every block type
MICRO_UNET_CONFIG = SVDUNetConfig(
    block_out_channels=(32, 64, 64, 64),
    num_attention_heads=(2, 4, 4, 4),
    controlnet_num_attention_heads=(2, 4, 2, 4),
    cross_attention_dim=32,
    addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=24,
    layers_per_block=1,
)


def frames_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, C] -> contiguous [B*T, C, H, W]."""
    return x.reshape((-1,) + x.shape[2:]).permute(0, 3, 1, 2).contiguous()


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def build_embeddings(m: nn.Module, cfg: SVDUNetConfig) -> None:
    c0 = cfg.block_out_channels[0]
    m.conv_in = nn.Conv2d(cfg.in_channels, c0, 3, padding=1)
    m.time_embedding = TimestepEmbedding(c0, cfg.time_embed_dim)
    m.add_embedding = TimestepEmbedding(
        cfg.projection_class_embeddings_input_dim, cfg.time_embed_dim)


def embed_timestep_and_ids(m: nn.Module, cfg: SVDUNetConfig, timestep,
                           added_time_ids, batch_size: int, dtype):
    """Time + added-time embedding shared by the UNet and the trunk."""
    dev = added_time_ids.device
    ts = torch.as_tensor(timestep, dtype=torch.float32, device=dev)
    ts = ts.reshape(-1).expand(batch_size)
    emb = m.time_embedding(
        get_timestep_embedding(ts, cfg.block_out_channels[0]).to(dtype))
    time_embeds = get_timestep_embedding(added_time_ids.reshape(-1),
                                         cfg.addition_time_embed_dim)
    time_embeds = time_embeds.reshape(batch_size, -1).to(dtype)
    return emb + m.add_embedding(time_embeds)


def build_down_blocks(cfg: SVDUNetConfig, heads) -> nn.ModuleList:
    blocks = nn.ModuleList([])
    out_ch = cfg.block_out_channels[0]
    for i, bt in enumerate(cfg.down_block_types):
        in_ch, out_ch = out_ch, cfg.block_out_channels[i]
        final = i == len(cfg.block_out_channels) - 1
        if bt == "CrossAttnDownBlockSpatioTemporal":
            blocks.append(CrossAttnDownBlockSpatioTemporal(
                in_ch, out_ch, cfg.time_embed_dim, cfg.layers_per_block,
                cfg.transformer_layers_per_block, heads[i],
                cfg.cross_attention_dim, add_downsample=not final,
                time_context_hw_major_quirk=cfg.time_context_hw_major_quirk))
        else:
            blocks.append(DownBlockSpatioTemporal(
                in_ch, out_ch, cfg.time_embed_dim, cfg.layers_per_block,
                add_downsample=not final))
    return blocks


def build_mid_block(cfg: SVDUNetConfig, heads) -> UNetMidBlockSpatioTemporal:
    return UNetMidBlockSpatioTemporal(
        cfg.block_out_channels[-1], cfg.time_embed_dim,
        cfg.transformer_layers_per_block, heads[-1], cfg.cross_attention_dim,
        cfg.time_context_hw_major_quirk)


def run_down_block(block, x, emb, context, indicator):
    if block.has_cross_attention:
        return block(x, emb, context, indicator)
    return block(x, emb, indicator)


class UNetSpatioTemporalConditionModel(nn.Module):
    def __init__(self, cfg: SVDUNetConfig = SVDUNetConfig()):
        super().__init__()
        self.cfg = cfg
        heads = cfg.num_attention_heads
        build_embeddings(self, cfg)
        self.down_blocks = build_down_blocks(cfg, heads)
        self.mid_block = build_mid_block(cfg, heads)

        self.up_blocks = nn.ModuleList([])
        rev_ch = list(reversed(cfg.block_out_channels))
        rev_heads = list(reversed(heads))
        out_ch = rev_ch[0]
        n = len(cfg.block_out_channels)
        for i, bt in enumerate(cfg.up_block_types):
            final = i == n - 1
            prev_out, out_ch = out_ch, rev_ch[i]
            in_ch = rev_ch[min(i + 1, n - 1)]
            n_layers = cfg.layers_per_block + 1
            if bt == "CrossAttnUpBlockSpatioTemporal":
                self.up_blocks.append(CrossAttnUpBlockSpatioTemporal(
                    in_ch, prev_out, out_ch, cfg.time_embed_dim, n_layers,
                    cfg.transformer_layers_per_block, rev_heads[i],
                    cfg.cross_attention_dim, add_upsample=not final,
                    time_context_hw_major_quirk=cfg.time_context_hw_major_quirk))
            else:
                self.up_blocks.append(UpBlockSpatioTemporal(
                    in_ch, prev_out, out_ch, cfg.time_embed_dim, n_layers,
                    add_upsample=not final))
        self.conv_norm_out = GroupNorm(32, cfg.block_out_channels[0], eps=1e-5)
        self.conv_out = nn.Conv2d(cfg.block_out_channels[0], cfg.out_channels,
                                  3, padding=1)

    def forward(self, sample, timestep, encoder_hidden_states, added_time_ids,
                down_block_additional_residuals: Optional[Sequence] = None,
                mid_block_additional_residual=None):
        """sample [B, T, H, W, C_in]; encoder_hidden_states [B, S, D];
        added_time_ids [B, 3]; residuals [B*T, h, w, c]. Returns
        [B, T, H, W, C_out]."""
        cfg = self.cfg
        bsz, nf = sample.shape[:2]
        emb = embed_timestep_and_ids(self, cfg, timestep, added_time_ids, bsz,
                                     sample.dtype)
        emb = emb.repeat_interleave(nf, dim=0)
        ehs = encoder_hidden_states.repeat_interleave(nf, dim=0)
        indicator = torch.zeros(bsz, nf, dtype=sample.dtype,
                                device=sample.device)
        residuals = (None if down_block_additional_residuals is None else
                     [r.permute(0, 3, 1, 2)
                      for r in down_block_additional_residuals])

        x = self.conv_in(frames_to_nchw(sample))
        samples = (x,)
        for block in self.down_blocks:
            x, res = run_down_block(block, x, emb, ehs, indicator)
            samples += res
            if residuals is not None:       # the re-add quirk (module note)
                samples = tuple(s + r for s, r in zip(samples, residuals))

        x = self.mid_block(x, emb, ehs, indicator)
        if mid_block_additional_residual is not None:
            x = x + mid_block_additional_residual.permute(0, 3, 1, 2)

        for block in self.up_blocks:
            n = len(block.resnets)
            res, samples = samples[-n:], samples[:-n]
            if block.has_cross_attention:
                x = block(x, res, emb, ehs, indicator)
            else:
                x = block(x, res, emb, indicator)

        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return nchw_to_nhwc(x).reshape(sample.shape[:4] + (x.shape[1],))
