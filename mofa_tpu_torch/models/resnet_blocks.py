"""Spatio-temporal resnet blocks of the SVD UNet and VAE decoder (PyTorch).

Counterpart of mofa_tpu/models/resnet_blocks.py (diffusers-0.24
`ResnetBlock2D`, `TemporalResnetBlock`, `SpatioTemporalResBlock`,
Down/Upsample2D). Spatial tensors are [B*T, C, H, W]; the temporal block
runs on the [B, C, T, H, W] view, where its GroupNorm pools over the
frames of each video and its (3, 1, 1) convs mix neighbouring frames
(zero padding at the ends).

Inside a frame_parallel context (parallel/activation.py) the spatial
block runs on this rank's frames; the temporal block gets all frames of
this rank's share of the H*W tokens (`frames_to_tokens`), its GroupNorm
statistics reduced over the shares, and the result comes back to the
rank's frames for the blend.
"""

from __future__ import annotations

from typing import Optional

import torch.nn as nn
import torch.nn.functional as F

from mofa_tpu_torch.models.layers import (AlphaBlender, GroupNorm,
                                          group_norm_token_sharded)
from mofa_tpu_torch.parallel.activation import (frame_ctx_active,
                                                frames_to_tokens, local_rows,
                                                tokens_to_frames)


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb_channels: Optional[int],
                 eps: float):
        super().__init__()
        self.norm1 = GroupNorm(32, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_channels, cout)
                              if temb_channels else None)
        self.norm2 = GroupNorm(32, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        sc = self.conv_shortcut(x) if self.conv_shortcut is not None else x
        return sc + h


class TemporalResnetBlock(nn.Module):
    """Resnet over the frame axis: x [B, C, T, H, W], temb [B, T, temb].
    `tokens` (a TokenSlice): x holds those of the H*W tokens along H, and
    the GroupNorm statistics are reduced over the ranks holding the rest."""

    def __init__(self, cin: int, cout: int, temb_channels: Optional[int],
                 eps: float):
        super().__init__()
        self.norm1 = GroupNorm(32, cin, eps=eps)
        self.conv1 = nn.Conv3d(cin, cout, (3, 1, 1), padding=(1, 0, 0))
        self.time_emb_proj = (nn.Linear(temb_channels, cout)
                              if temb_channels else None)
        self.norm2 = GroupNorm(32, cout, eps=eps)
        self.conv2 = nn.Conv3d(cout, cout, (3, 1, 1), padding=(1, 0, 0))
        self.conv_shortcut = (nn.Conv3d(cin, cout, 1) if cin != cout
                              else None)

    def forward(self, x, temb=None, tokens=None):
        norm = ((lambda m, y: m(y)) if tokens is None else
                (lambda m, y: group_norm_token_sharded(m, y, tokens)))
        h = self.conv1(F.silu(norm(self.norm1, x)))
        if self.time_emb_proj is not None and temb is not None:
            t = self.time_emb_proj(F.silu(temb))                 # [B, T, C]
            h = h + t.permute(0, 2, 1)[:, :, :, None, None]
        h = self.conv2(F.silu(norm(self.norm2, h)))
        sc = self.conv_shortcut(x) if self.conv_shortcut is not None else x
        return sc + h


class SpatioTemporalResBlock(nn.Module):
    """spatial resnet -> temporal resnet -> learned alpha blend."""

    def __init__(self, cin: int, cout: int, temb_channels: Optional[int],
                 eps: float, temporal_eps: Optional[float] = None,
                 merge_strategy: str = "learned_with_images",
                 switch_spatial_to_temporal_mix: bool = False):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(cin, cout, temb_channels, eps)
        self.temporal_res_block = TemporalResnetBlock(
            cout, cout, temb_channels, temporal_eps or eps)
        self.time_mixer = AlphaBlender(
            merge_strategy, switch_spatial_to_temporal_mix,
            mix_init=0.5 if merge_strategy == "learned_with_images" else 0.0)

    def forward(self, x, temb, image_only_indicator):
        # x [B*T, C, H, W]; temb [B*T, temb] or None; indicator [B, T]
        if frame_ctx_active():
            return self._forward_frame_parallel(x, temb, image_only_indicator)
        b, t = image_only_indicator.shape
        h = self.spatial_res_block(x, temb)
        bt, c, hh, ww = h.shape
        h5 = h.reshape(b, t, c, hh, ww).permute(0, 2, 1, 3, 4)
        temb_bt = temb.reshape(b, t, -1) if temb is not None else None
        ht = self.temporal_res_block(h5, temb_bt)
        ht = ht.permute(0, 2, 1, 3, 4).reshape(bt, c, hh, ww)
        return self.time_mixer(h, ht, image_only_indicator)

    def _forward_frame_parallel(self, x, temb, image_only_indicator):
        # x: this rank's rows of the [B*T, C, H, W] batch; temb and the
        # indicator whole
        b, t = image_only_indicator.shape
        total = b * t
        h = self.spatial_res_block(
            x, None if temb is None else local_rows(temb, total))
        rows, c, hh, ww = h.shape
        h_tok, tokens = frames_to_tokens(h.reshape(rows, c, hh * ww), total, 2)
        n_tok = h_tok.shape[2]
        h5 = h_tok.reshape(b, t, c, n_tok, 1).permute(0, 2, 1, 3, 4)
        temb_bt = temb.reshape(b, t, -1) if temb is not None else None
        ht = self.temporal_res_block(h5, temb_bt, tokens)
        ht = ht.permute(0, 2, 1, 3, 4).reshape(total, c, n_tok)
        ht = tokens_to_frames(ht, tokens, 2).reshape(rows, c, hh, ww)
        return self.time_mixer(h, ht, local_rows(
            image_only_indicator.reshape(total), total))


class Downsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
