"""SVD UNet down / mid / up blocks (PyTorch).

Counterpart of mofa_tpu/models/unet_blocks.py (diffusers-0.24
`unet_3d_blocks` spatio-temporal blocks). Resnet eps: plain down blocks
1e-5, cross-attention down blocks 1e-6, mid block 1e-5, up blocks 1e-6.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from mofa_tpu_torch.models.resnet_blocks import (Downsample2D,
                                                 SpatioTemporalResBlock,
                                                 Upsample2D)
from mofa_tpu_torch.models.transformer_blocks import \
    TransformerSpatioTemporalModel


class DownBlockSpatioTemporal(nn.Module):
    has_cross_attention = False

    def __init__(self, cin: int, cout: int, temb_channels: int,
                 num_layers: int, add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(cin if i == 0 else cout, cout,
                                   temb_channels, eps=1e-5)
            for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(cout)])
                             if add_downsample else None)

    def forward(self, x, temb, image_only_indicator):
        outs = ()
        for resnet in self.resnets:
            x = resnet(x, temb, image_only_indicator)
            outs += (x,)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            outs += (x,)
        return x, outs


class CrossAttnDownBlockSpatioTemporal(nn.Module):
    has_cross_attention = True

    def __init__(self, cin: int, cout: int, temb_channels: int,
                 num_layers: int, transformer_layers: int, heads: int,
                 cross_attention_dim: int, add_downsample: bool,
                 time_context_hw_major_quirk: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(cin if i == 0 else cout, cout,
                                   temb_channels, eps=1e-6)
            for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            TransformerSpatioTemporalModel(
                heads, cout // heads, cout, transformer_layers,
                cross_attention_dim, time_context_hw_major_quirk)
            for _ in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(cout)])
                             if add_downsample else None)

    def forward(self, x, temb, context, image_only_indicator):
        outs = ()
        for resnet, attn in zip(self.resnets, self.attentions):
            x = resnet(x, temb, image_only_indicator)
            x = attn(x, context, image_only_indicator)
            outs += (x,)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            outs += (x,)
        return x, outs


class UNetMidBlockSpatioTemporal(nn.Module):
    def __init__(self, ch: int, temb_channels: int, transformer_layers: int,
                 heads: int, cross_attention_dim: int,
                 time_context_hw_major_quirk: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(ch, ch, temb_channels, eps=1e-5),
            SpatioTemporalResBlock(ch, ch, temb_channels, eps=1e-5)])
        self.attentions = nn.ModuleList([
            TransformerSpatioTemporalModel(
                heads, ch // heads, ch, transformer_layers,
                cross_attention_dim, time_context_hw_major_quirk)])

    def forward(self, x, temb, context, image_only_indicator):
        x = self.resnets[0](x, temb, image_only_indicator)
        x = self.attentions[0](x, context, image_only_indicator)
        return self.resnets[1](x, temb, image_only_indicator)


class UpBlockSpatioTemporal(nn.Module):
    has_cross_attention = False

    def __init__(self, cin: int, prev_out: int, cout: int,
                 temb_channels: int, num_layers: int, add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(
                (prev_out if i == 0 else cout)
                + (cin if i == num_layers - 1 else cout),
                cout, temb_channels, eps=1e-6)
            for i in range(num_layers)])
        self.upsamplers = (nn.ModuleList([Upsample2D(cout)])
                           if add_upsample else None)

    def forward(self, x, res_samples, temb, image_only_indicator):
        for resnet in self.resnets:
            x = torch.cat([x, res_samples[-1]], dim=1)
            res_samples = res_samples[:-1]
            x = resnet(x, temb, image_only_indicator)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class CrossAttnUpBlockSpatioTemporal(nn.Module):
    has_cross_attention = True

    def __init__(self, cin: int, prev_out: int, cout: int,
                 temb_channels: int, num_layers: int, transformer_layers: int,
                 heads: int, cross_attention_dim: int, add_upsample: bool,
                 time_context_hw_major_quirk: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(
                (prev_out if i == 0 else cout)
                + (cin if i == num_layers - 1 else cout),
                cout, temb_channels, eps=1e-6)
            for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            TransformerSpatioTemporalModel(
                heads, cout // heads, cout, transformer_layers,
                cross_attention_dim, time_context_hw_major_quirk)
            for _ in range(num_layers)])
        self.upsamplers = (nn.ModuleList([Upsample2D(cout)])
                           if add_upsample else None)

    def forward(self, x, res_samples, temb, context, image_only_indicator):
        for resnet, attn in zip(self.resnets, self.attentions):
            x = torch.cat([x, res_samples[-1]], dim=1)
            res_samples = res_samples[:-1]
            x = resnet(x, temb, image_only_indicator)
            x = attn(x, context, image_only_indicator)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x
