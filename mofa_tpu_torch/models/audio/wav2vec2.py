"""wav2vec 2.0 audio encoder (base / post-norm variant) in PyTorch.

Counterpart of mofa_tpu/models/audio/wav2vec2.py. AniPortrait wraps HF's
`Wav2Vec2Model` (wav2vec2-base-960h) with a linear interpolation of the
conv features to the video's frame count before the feature projection
(aniportrait/src/audio_models/wav2vec2.py:30-33). Module and parameter
names are those of HF's state dict, so an AniPortrait `audio2*.pt` loads
with `strict=True`:

  feature_extractor.conv_layers.N.conv: 7 bias-free convs (kernels
    10,3,3,3,3,2,2; strides 5,2,2,2,2,2,2), conv_layers.0.layer_norm a
    GroupNorm with one group per channel, GELU after each;
  -> linear interpolation (align_corners=True) to the frame count;
  feature_projection.{layer_norm, projection};
  encoder.pos_conv_embed.conv: the grouped positional conv (k=128, 16
    groups, the last output dropped, GELU), weight-normed at dim=2 in the
    checkpoints, which carry `weight_g` / `weight_v` or
    `parametrizations.weight.original0` / `original1`; both are merged
    into `weight` on load;
  encoder.layer_norm, then encoder.layers.N: post-norm blocks
    (attention.{q,k,v,out}_proj, layer_norm, feed_forward.
    {intermediate_dense, output_dense}, final_layer_norm).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mofa_tpu_torch.ops.resize import interp_matrix


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: int = 512
    conv_kernels: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_strides: tuple = (5, 2, 2, 2, 2, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5


TINY_W2V_CONFIG = Wav2Vec2Config(hidden_size=32, num_layers=2, num_heads=4,
                                 intermediate_size=64, conv_dim=16)


def interpolate_linear_to(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """[B, T, C] -> [B, out_len, C], torch F.interpolate(mode='linear',
    align_corners=True) semantics, in fp32."""
    m = torch.from_numpy(interp_matrix(x.shape[1], out_len, "bilinear",
                                       align_corners=True)).to(x.device)
    return torch.einsum("ot,btc->boc", m, x.float()).to(x.dtype)


def normalize_audio(samples: np.ndarray) -> np.ndarray:
    """Wav2Vec2FeatureExtractor zero-mean unit-variance normalization."""
    samples = np.asarray(samples, np.float32)
    return (samples - samples.mean()) / np.sqrt(samples.var() + 1e-7)


class ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, s: int, norm: bool, eps: float):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, stride=s, bias=False)
        if norm:
            self.layer_norm = nn.GroupNorm(cout, cout, eps=eps)

    def forward(self, x):
        x = self.conv(x)
        if hasattr(self, "layer_norm"):
            x = self.layer_norm(x)
        return F.gelu(x)


class FeatureExtractor(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.conv_layers = nn.ModuleList([
            ConvLayer(1 if i == 0 else c.conv_dim, c.conv_dim, k, s, i == 0,
                      c.layer_norm_eps)
            for i, (k, s) in enumerate(zip(c.conv_kernels, c.conv_strides))])

    def forward(self, audio):
        """[B, samples] -> [B, frames, conv_dim]."""
        x = audio[:, None]
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(c.conv_dim, eps=c.layer_norm_eps)
        self.projection = nn.Linear(c.conv_dim, c.hidden_size)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class WeightNormConv1d(nn.Conv1d):
    """A Conv1d whose checkpoints store its weight normalised at dim=2:
    `weight_g` [1, 1, K] and `weight_v` (torch.nn.utils.weight_norm) or
    `parametrizations.weight.original0` / `original1`
    (torch.nn.utils.parametrizations.weight_norm). Either pair is merged
    into `weight` = g * v / ||v||, the norm over dims 0 and 1, on load; a
    plain `weight` loads as it is."""

    _HALVES = (("weight_g", "weight_v"),
               ("parametrizations.weight.original0",
                "parametrizations.weight.original1"))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for g_name, v_name in self._HALVES:
            if prefix + g_name in state_dict:
                g = state_dict.pop(prefix + g_name)
                v = state_dict.pop(prefix + v_name)
                state_dict[prefix + "weight"] = g * v / v.norm(dim=(0, 1), keepdim=True)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class PositionalConvEmbedding(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        k = c.num_conv_pos_embeddings
        self.conv = WeightNormConv1d(c.hidden_size, c.hidden_size, k, padding=k // 2,
                                     groups=c.num_conv_pos_embedding_groups)
        self.drop_last = k % 2 == 0

    def forward(self, x):
        """[B, T, C] -> [B, T, C]."""
        pos = self.conv(x.transpose(1, 2))
        if self.drop_last:
            pos = pos[:, :, :-1]
        return F.gelu(pos).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        d = c.hidden_size
        self.heads = c.num_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(d, d) for _ in range(4))

    def forward(self, x):
        b, t, d = x.shape
        split = lambda y: y.reshape(b, t, self.heads, d // self.heads).transpose(1, 2)
        out = F.scaled_dot_product_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                                             split(self.v_proj(x)))
        return self.out_proj(out.transpose(1, 2).reshape(b, t, d))


class FeedForward(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.intermediate_dense = nn.Linear(c.hidden_size, c.intermediate_size)
        self.output_dense = nn.Linear(c.intermediate_size, c.hidden_size)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    """Post-norm: x = LN(x + attn(x)); x = LN(x + ff(x))."""

    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.attention = Attention(c)
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.feed_forward = FeedForward(c)
        self.final_layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, x):
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class Encoder(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(c)
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.layers = nn.ModuleList([EncoderLayer(c) for _ in range(c.num_layers)])

    def forward(self, x):
        x = self.layer_norm(x + self.pos_conv_embed(x))
        for layer in self.layers:
            x = layer(x)
        return x


class Wav2Vec2Model(nn.Module):
    """The encoder with the reference's frame-rate interpolation."""

    def __init__(self, cfg: Wav2Vec2Config = Wav2Vec2Config()):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureExtractor(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = Encoder(cfg)

    def forward(self, audio: torch.Tensor, seq_len: int) -> torch.Tensor:
        """audio [B, samples] (normalize_audio'd) -> hidden states
        [B, seq_len, hidden]."""
        feats = interpolate_linear_to(self.feature_extractor(audio), seq_len)
        return self.encoder(self.feature_projection(feats))
