"""Primitive layers of the SVD UNet family (PyTorch).

Counterpart of mofa_tpu/models/layers.py, with diffusers module and
parameter names (to_q / to_k / to_v / to_out.0, ff.net.0.proj, ...), so
that `mofa_tpu.models.weights` converts this package's `state_dict()` as
it converts a real checkpoint.

Layouts: convolutional activations are contiguous NCHW tensors; token
activations are [N, L, C].
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mofa_tpu_torch.kernels.attention import (dot_product_attention,
                                              temporal_attention_tmajor)
from mofa_tpu_torch.kernels.geglu_ffn import fused_ffn_applicable, ln_geglu_ffn


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = True,
                           downscale_freq_shift: float = 0.0,
                           max_period: float = 10000.0) -> torch.Tensor:
    """diffusers get_timestep_embedding; timesteps [N] -> [N, dim], fp32."""
    half = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class GroupNorm(nn.GroupNorm):
    """GroupNorm over [N, C, ...] with fp32 statistics (PyTorch's kernels
    accumulate in fp32 for bf16 inputs).

    pool_leading=K pools the statistics over K consecutive leading samples
    (rows r*K .. r*K+K-1 share mean and variance): on [B*T, C, H, W] that
    is PyTorch's 5-D GroupNorm over C/G x T x H x W per video."""

    def forward(self, x: torch.Tensor, pool_leading: int = 1) -> torch.Tensor:
        if pool_leading == 1:
            return super().forward(x)
        n, c = x.shape[:2]
        x5 = x.reshape(n // pool_leading, pool_leading, c, -1).transpose(1, 2)
        y = super().forward(x5)
        return y.transpose(1, 2).reshape(x.shape)


class TimestepEmbedding(nn.Module):
    """linear_1 -> silu -> linear_2 (diffusers TimestepEmbedding)."""

    def __init__(self, in_dim: int, time_embed_dim: int,
                 out_dim: Optional[int] = None):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, out_dim or time_embed_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class Attention(nn.Module):
    """diffusers Attention: bias-free to_q/to_k/to_v, biased to_out.0.

    With `tmajor_frames=T` the hidden states arrive in the spatial-major
    layout [B*T, S, C] and attention runs over the frame axis per spatial
    token (kernels/attention.py::temporal_attention_tmajor); cross
    attention then takes a per-spatial-token single-token context
    [B, S, 1, D]. With a single-token context softmax is exactly 1, so the
    output is the projected value: to_q / to_k stay in the state dict (the
    checkpoint has them) but are not applied."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        ctx = cross_attention_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx, inner, bias=False)
        self.to_v = nn.Linear(ctx, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x, context=None, tmajor_frames: Optional[int] = None):
        if tmajor_frames is not None:
            return self._tmajor(x, context, tmajor_frames)
        b, lq, _ = x.shape
        if context is not None and context.shape[1] == 1:
            out = self.to_out[0](self.to_v(context))            # [B, 1, C]
            return out.expand(b, lq, out.shape[-1])
        ctx = x if context is None else context
        lk = ctx.shape[1]
        q = self.to_q(x).reshape(b, lq, self.heads, self.dim_head)
        k = self.to_k(ctx).reshape(b, lk, self.heads, self.dim_head)
        v = self.to_v(ctx).reshape(b, lk, self.heads, self.dim_head)
        out = dot_product_attention(q, k, v)
        return self.to_out[0](out.reshape(b, lq, self.heads * self.dim_head))

    def _tmajor(self, x, context, nf: int):
        bt, s, ch = x.shape
        if context is not None:
            if context.ndim != 4 or context.shape[2] != 1:
                raise ValueError(f"tmajor context must be [B, S, 1, D], got "
                                 f"{tuple(context.shape)}")
            out = self.to_out[0](self.to_v(context[:, :, 0]))    # [B, S, C]
            return out[:, None].expand(bt // nf, nf, s, ch).reshape(bt, s, ch)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        out = temporal_attention_tmajor(q, k, v, nf, self.heads)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward: dim -> 8*dim -> gate -> 4*dim -> dim_out."""

    def __init__(self, dim: int, dim_out: Optional[int] = None, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList(
            [GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim_out or dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


def ln_ff_residual(x, norm: nn.LayerNorm, ff: FeedForward):
    """x + ff(norm(x)). At the sites `fused_ffn_applicable` admits (C of
    320 or 640, dim_out == C, rows >= 4096) this is the `ln_geglu_ffn`
    kernel; elsewhere plain PyTorch. Same parameters either way."""
    c = x.shape[-1]
    proj, out = ff.net[0].proj, ff.net[2]
    if fused_ffn_applicable(x.numel() // c, c, out.out_features):
        return ln_geglu_ffn(x, norm.weight, norm.bias, proj.weight, proj.bias,
                            out.weight, out.bias)
    return ff(norm(x)) + x


class AlphaBlender(nn.Module):
    """Learned spatial/temporal mixing (diffusers AlphaBlender).

    "learned": alpha = sigmoid(mix_factor); "learned_with_images": alpha =
    1 where image_only_indicator is set, else sigmoid(mix_factor). Inputs
    are [B*T, ...], one alpha per row."""

    def __init__(self, merge_strategy: str = "learned_with_images",
                 switch_spatial_to_temporal_mix: bool = False,
                 mix_init: float = 0.5):
        super().__init__()
        if merge_strategy not in ("learned", "learned_with_images"):
            raise ValueError(merge_strategy)
        self.merge_strategy = merge_strategy
        self.switch = switch_spatial_to_temporal_mix
        self.mix_factor = nn.Parameter(torch.tensor([mix_init]))

    def forward(self, x_spatial, x_temporal, image_only_indicator=None):
        mix = torch.sigmoid(self.mix_factor.float())[0]
        if self.merge_strategy == "learned":
            alpha = mix
        else:
            alpha = torch.where(image_only_indicator.bool(),
                                torch.ones_like(mix), mix)
            alpha = alpha.reshape((-1,) + (1,) * (x_spatial.ndim - 1))
        alpha = alpha.to(x_spatial.dtype)
        if self.switch:
            alpha = 1.0 - alpha
        # alpha * x_spatial + (1 - alpha) * x_temporal, as one kernel
        return torch.lerp(x_temporal, x_spatial, alpha)
