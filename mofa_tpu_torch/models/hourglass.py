"""Occlusion matting of the landmark MOFA-Adapter (PyTorch, NCHW).

Counterpart of mofa_tpu/models/hourglass.py (the reference's
MOFA-Video-Hybrid models/occlusion/hourglass.py): three conv + relu "down"
blocks without spatial change, a decoder with skip concatenations, then
the 7x7 `matting_mask` (sigmoid) and `matting` heads;
out = warped * mask + matting * (1 - mask).

Module names are those mofa_tpu's checkpoint converter resolves
(`hourglass.encoder.down_blocks.i.conv`, `hourglass.decoder.up_blocks.j.conv`,
`matting_mask`, `matting`); no reference checkpoint has checked them yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class _ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x):
        return F.relu(self.conv(x))


class _Blocks(nn.Module):
    """`down_blocks` (encoder) or `up_blocks` (decoder) under one name."""

    def __init__(self, name: str, blocks: list):
        super().__init__()
        setattr(self, name, nn.ModuleList(blocks))


class Hourglass(nn.Module):
    """[N, cin, H, W] -> [N, block_expansion, H, W]."""

    def __init__(self, cin: int, block_expansion: int = 64, num_blocks: int = 3,
                 max_features: int = 512):
        super().__init__()
        width = lambda i: min(max_features, block_expansion * 2 ** i)
        down, c = [], cin
        for i in range(num_blocks):
            down.append(_ConvBlock(c, width(i + 1)))
            c = width(i + 1)
        up, skip = [], 0
        for i in reversed(range(num_blocks)):
            up.append(_ConvBlock(width(i + 1) + skip, width(i)))
            skip = width(i)
        self.encoder = _Blocks("down_blocks", down)
        self.decoder = _Blocks("up_blocks", up)

    def forward(self, x):
        outs = []
        for block in self.encoder.down_blocks:
            x = block(x)
            outs.append(x)
        x = None
        for block in self.decoder.up_blocks:
            out = outs.pop()
            x = block(out if x is None else torch.cat([out, x], dim=1))
        return x


class ForegroundMatting(nn.Module):
    """Per-scale occlusion head: reference features, flow and warped
    features (NCHW, C + 2 + C channels) -> (matted features [N, C, H, W],
    mask [N, 1, H, W])."""

    def __init__(self, num_channels: int, block_expansion: int = 64,
                 num_blocks: int = 3, max_features: int = 512):
        super().__init__()
        self.hourglass = Hourglass(2 * num_channels + 2, block_expansion,
                                   num_blocks, max_features)
        self.matting_mask = nn.Conv2d(block_expansion, 1, 7, padding=3)
        self.matting = nn.Conv2d(block_expansion, num_channels, 7, padding=3)

    def forward(self, reference_feat, dense_flow, warped_feat):
        h = self.hourglass(torch.cat([reference_feat, dense_flow, warped_feat], dim=1))
        # the sigmoid in fp32, cast back to the activation dtype
        mask = torch.sigmoid(self.matting_mask(h).float()).to(h.dtype)
        out = warped_feat * mask + self.matting(h) * (1.0 - mask)
        return out, mask
