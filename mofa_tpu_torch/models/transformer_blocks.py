"""Spatial and temporal transformer blocks of the SVD UNet (PyTorch).

Counterpart of mofa_tpu/models/transformer_blocks.py (diffusers-0.24
`BasicTransformerBlock`, `TemporalBasicTransformerBlock`,
`TransformerSpatioTemporalModel`). The temporal block runs in one of two
layouts, which compute the same function:

- spatial-major ("tmajor", the default): the hidden rows stay [B*T, S, C]
  and the temporal self-attention reads them in place
  (kernels/attention.py::temporal_attention_tmajor); every other op of
  the block is row-wise;
- classic: the rows are transposed to [B*S, T, C], the block runs there
  (its self-attention is short attention over T per spatial token), and
  the rows are transposed back.

The choice follows the JAX package (transformer_blocks.py:130-134), read
at call time: tmajor unless `MOFA_TMAJOR=0`, the context has more than one
token, or the HW-major quirk meets an odd batch B > 1 (its context layout
interleaves the batch, which the tmajor layout cannot express).

The temporal cross-attention context replicates diffusers-0.24's HW-major
quirk: the context is flattened HW-major while the hidden rows are
batch-major, so at B = 2 (one CFG pair) hidden row (b, hw) reads the
context of CFG side (b*HW + hw) % 2. For a batch of several CFG pairs,
each pair (v, half + v) gets exactly that B = 2 misalignment; an odd batch
B > 1 takes the raw reference indexing.

Inside a frame_parallel context (parallel/activation.py) the spatial
block runs on this rank's frames, and each temporal block gets all frames
of this rank's share of the tokens (`frames_to_tokens`) in the classic
layout, as the JAX package turns tmajor off under its "frames" policy;
its context rows are those of the tokens the rank holds (their global
indices decide the quirk's CFG side).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn as nn

from mofa_tpu_torch.models.layers import (AlphaBlender, Attention,
                                          FeedForward, GroupNorm,
                                          TimestepEmbedding,
                                          get_timestep_embedding,
                                          ln_ff_residual)
from mofa_tpu_torch.parallel.activation import (frames_to_tokens, local_rows,
                                                sharding_policy, token_slice,
                                                tokens_to_frames)


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
    """x [B*T, S, C] rows. tmajor: context [B, S, 1, D]; classic: context
    [B*S, S_ctx, D] (one context row per spatial-token sequence)."""

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

    def forward(self, x, num_frames: int, context=None, tmajor: bool = True):
        bf, seq, ch = x.shape
        b = bf // num_frames
        kw = dict(tmajor_frames=num_frames) if tmajor else {}
        if not tmajor:                                          # -> [B*S, T, C]
            x = x.reshape(b, num_frames, seq, ch).transpose(1, 2)
            x = x.reshape(b * seq, num_frames, ch)
        x = ln_ff_residual(x, self.norm_in, self.ff_in)
        x = self.attn1(self.norm1(x), **kw) + x
        x = self.attn2(self.norm2(x), context, **kw) + x
        x = ln_ff_residual(x, self.norm3, self.ff)
        if not tmajor:                                          # -> [B*T, S, C]
            x = x.reshape(b, seq, num_frames, ch).transpose(1, 2)
            x = x.reshape(bf, seq, ch)
        return x


def tmajor_enabled(bsz: int, ctx_tokens: int, quirk: bool) -> bool:
    """The JAX package's layout choice: tmajor unless MOFA_TMAJOR=0, under
    the "frames" sharding policy, for a multi-token context, or with the
    quirk at an odd batch B > 1."""
    return (os.environ.get("MOFA_TMAJOR", "") != "0"
            and sharding_policy() != "frames" and ctx_tokens == 1
            and (bsz == 1 or bsz % 2 == 0 or not quirk))


def time_context(tc: torch.Tensor, hw: int, quirk: bool,
                 tmajor: bool = True, tokens=None) -> torch.Tensor:
    """First-frame context [B, S, D] -> the temporal cross-attention's
    context, in the four layouts of mofa_tpu (transformer_blocks.py:135-178):
    per spatial token [B, HW, 1, D] (tmajor), or one row per spatial-token
    sequence [B*HW, S', D] (classic). `tokens` (a TokenSlice of the HW
    tokens, classic layout only): the rows of those tokens alone."""
    bsz, s, d = tc.shape
    start, stop = (0, hw) if tokens is None else (tokens.start, tokens.stop)
    n_tok = stop - start
    if tokens is not None and tmajor:
        raise ValueError("a token slice of the context is classic-layout only")
    if quirk and bsz % 2 == 0:
        # pairwise: row (b, hw) reads CFG side (side(b)*HW + hw) % 2 of its pair
        half = bsz // 2
        tc2 = tc[:, 0].reshape(2, half, d)
        rows = torch.arange(bsz, device=tc.device)
        sides, vs = rows // half, rows % half
        hw_idx = torch.arange(start, stop, device=tc.device)
        sel = (sides[:, None] * hw + hw_idx[None, :]) % 2        # [B, HW]
        ctx = torch.where(sel[..., None] == 0, tc2[0][vs][:, None, :],
                          tc2[1][vs][:, None, :])                # [B, HW, D]
        return ctx[:, :, None, :] if tmajor else ctx.reshape(bsz * n_tok, 1, d)
    if quirk and tmajor:
        if bsz != 1:
            raise ValueError("the HW-major context quirk has no tmajor layout "
                             f"at an odd batch B > 1; got B = {bsz}")
        # B = 1: the HW-major flattening degenerates to a plain broadcast
        return tc[:, None, :1].expand(bsz, hw, 1, d)
    if quirk and tokens is not None:
        # odd batch, raw indexing: hidden row b*HW + hw reads batch
        # element (b*HW + hw) % B
        idx = (torch.arange(bsz, device=tc.device)[:, None] * hw
               + torch.arange(start, stop, device=tc.device)[None, :]) % bsz
        return tc[idx.reshape(-1), :1]
    if quirk:
        # odd batch: the raw reference indexing, [HW, B, 1, D] -> [HW*B, 1, D]
        return tc[None, :, :1].expand(hw, bsz, 1, d).reshape(hw * bsz, 1, d)
    if tmajor:
        if s != 1:
            raise ValueError("the tmajor context must be a single token")
        return tc[:, None].expand(bsz, hw, 1, d)
    return tc[:, None].expand(bsz, n_tok, s, d).reshape(bsz * n_tok, s, d)


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
        # x [B*T, C, H, W] (inside frame_parallel: this rank's rows);
        # encoder_hidden_states [B*T, S, D]
        bf, ch, h, w = x.shape
        bsz, nf = image_only_indicator.shape
        ehs = encoder_hidden_states
        tc = ehs.reshape(bsz, nf, -1, ehs.shape[-1])[:, 0]           # [B, S, D]
        tmajor = tmajor_enabled(bsz, tc.shape[1], self.quirk)
        sharded = sharding_policy() == "frames"
        indicator = image_only_indicator
        tokens = None
        if sharded:
            total = bsz * nf
            ehs = local_rows(ehs, total)
            indicator = local_rows(indicator.reshape(total), total)
            tokens = token_slice(h * w)
        t_ctx = time_context(tc, h * w, self.quirk, tmajor, tokens)

        residual = x
        x = self.norm(x).permute(0, 2, 3, 1).reshape(bf, h * w, ch)
        x = self.proj_in(x)

        frame_ids = torch.arange(nf, device=x.device).repeat(bsz)
        t_emb = get_timestep_embedding(frame_ids, self.inner)
        emb = self.time_pos_embed(t_emb.to(x.dtype))[:, None, :]
        if sharded:
            emb = local_rows(emb, total)

        for block, tblock in zip(self.transformer_blocks,
                                 self.temporal_transformer_blocks):
            x_spatial = block(x, ehs)
            if sharded:
                x_tok, tokens = frames_to_tokens(x_spatial + emb, total, 1)
                x_mix = tokens_to_frames(tblock(x_tok, nf, t_ctx, False),
                                         tokens, 1)
            else:
                x_mix = tblock(x_spatial + emb, nf, t_ctx, tmajor)
            x = self.time_mixer(x_spatial, x_mix, indicator)

        x = self.proj_out(x)
        return residual + x.reshape(bf, h, w, ch).permute(0, 3, 1, 2)
