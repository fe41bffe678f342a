"""Spatial and temporal transformer blocks of the SVD UNet (PyTorch).

Counterpart of mofa_tpu/models/transformer_blocks.py (diffusers-0.24
`BasicTransformerBlock`, `TemporalBasicTransformerBlock`,
`TransformerSpatioTemporalModel`). The temporal block always runs in the
spatial-major ("tmajor") layout: its hidden rows stay [B*T, S, C] and the
temporal self-attention reads them in place (kernels/attention.py); every
other op of the block is row-wise.

The temporal cross-attention context replicates diffusers-0.24's HW-major
quirk: the context is flattened HW-major while the hidden rows are
batch-major, so at B = 2 (one CFG pair) hidden row (b, hw) reads the
context of CFG side (b*HW + hw) % 2. For a batch of several CFG pairs,
each pair (v, half + v) gets exactly that B = 2 misalignment.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from mofa_tpu_torch.models.layers import (AlphaBlender, Attention,
                                          FeedForward, GroupNorm,
                                          TimestepEmbedding,
                                          get_timestep_embedding,
                                          ln_ff_residual)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return ln_ff_residual(x, self.norm3, self.ff)


class TemporalBasicTransformerBlock(nn.Module):
    """x [B*T, S, C] (spatial-major rows); context [B, S, 1, D]."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        self.norm_in = nn.LayerNorm(dim)
        self.ff_in = FeedForward(dim)
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, num_frames: int, context=None):
        x = ln_ff_residual(x, self.norm_in, self.ff_in)
        x = self.attn1(self.norm1(x), tmajor_frames=num_frames) + x
        x = self.attn2(self.norm2(x), context, tmajor_frames=num_frames) + x
        return ln_ff_residual(x, self.norm3, self.ff)


def time_context(tc: torch.Tensor, hw: int, quirk: bool) -> torch.Tensor:
    """First-frame context [B, 1, D] -> per-spatial-token [B, HW, 1, D]."""
    bsz, s, d = tc.shape
    if s != 1:
        raise ValueError("the temporal context must be a single token")
    if not quirk or bsz == 1:
        # B = 1: the HW-major flattening degenerates to a plain broadcast
        return tc[:, None].expand(bsz, hw, 1, d)
    if bsz % 2:
        raise ValueError("the HW-major context quirk needs B = 1 or even B "
                         f"(CFG pairs); got B = {bsz}")
    half = bsz // 2
    tc2 = tc[:, 0].reshape(2, half, d)
    rows = torch.arange(bsz, device=tc.device)
    sides, vs = rows // half, rows % half
    hw_idx = torch.arange(hw, device=tc.device)
    sel = (sides[:, None] * hw + hw_idx[None, :]) % 2            # [B, HW]
    ctx = torch.where(sel[..., None] == 0, tc2[0][vs][:, None, :],
                      tc2[1][vs][:, None, :])                    # [B, HW, D]
    return ctx[:, :, None, :]


class TransformerSpatioTemporalModel(nn.Module):
    def __init__(self, heads: int, dim_head: int, in_channels: int,
                 num_layers: int = 1, cross_attention_dim: int = 1024,
                 time_context_hw_major_quirk: bool = True):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(32, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, cross_attention_dim)
            for _ in range(num_layers)])
        self.temporal_transformer_blocks = nn.ModuleList([
            TemporalBasicTransformerBlock(inner, heads, dim_head,
                                          cross_attention_dim)
            for _ in range(num_layers)])
        self.time_pos_embed = TimestepEmbedding(inner, inner * 4, out_dim=inner)
        self.time_mixer = AlphaBlender()
        self.proj_out = nn.Linear(inner, in_channels)
        self.inner = inner
        self.quirk = time_context_hw_major_quirk

    def forward(self, x, encoder_hidden_states, image_only_indicator):
        # x [B*T, C, H, W]; encoder_hidden_states [B*T, S, D]
        bf, ch, h, w = x.shape
        bsz, nf = image_only_indicator.shape
        ehs = encoder_hidden_states
        tc = ehs.reshape(bsz, nf, -1, ehs.shape[-1])[:, 0]           # [B, S, D]
        t_ctx = time_context(tc, h * w, self.quirk)

        residual = x
        x = self.norm(x).permute(0, 2, 3, 1).reshape(bf, h * w, ch)
        x = self.proj_in(x)

        frame_ids = torch.arange(nf, device=x.device).repeat(bsz)
        t_emb = get_timestep_embedding(frame_ids, self.inner)
        emb = self.time_pos_embed(t_emb.to(x.dtype))[:, None, :]

        for block, tblock in zip(self.transformer_blocks,
                                 self.temporal_transformer_blocks):
            x_spatial = block(x, ehs)
            x_mix = tblock(x_spatial + emb, nf, t_ctx)
            x = self.time_mixer(x_spatial, x_mix, image_only_indicator)

        x = self.proj_out(x)
        return residual + x.reshape(bf, h, w, ch).permute(0, 3, 1, 2)
