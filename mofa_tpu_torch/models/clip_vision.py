"""CLIP vision encoder with projection (ViT-H/14 by default), PyTorch.

Counterpart of mofa_tpu/models/clip_vision.py, with transformers'
`CLIPVisionModelWithProjection` state-dict names. Returns `image_embeds`:
the visual projection of the post-layernormed CLS token. Attention over
the 257 tokens stays plain PyTorch (kernels/attention.py), as the JAX
package leaves it to XLA.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from mofa_tpu_torch.kernels.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    patch_size: int = 14
    image_size: int = 224
    projection_dim: int = 1024
    hidden_act: str = "gelu"


TINY_CLIP_CONFIG = CLIPVisionConfig(
    hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
    patch_size=32, image_size=64, projection_dim=32)


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, l, d = x.shape
        shape = (b, l, self.heads, d // self.heads)
        out = dot_product_attention(self.q_proj(x).reshape(shape),
                                    self.k_proj(x).reshape(shape),
                                    self.v_proj(x).reshape(shape))
        return self.out_proj(out.reshape(b, l, d))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, hidden: int, act: str):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.act = act

    def forward(self, x):
        h = self.fc1(x)
        h = F.gelu(h) if self.act == "gelu" else h * torch.sigmoid(1.702 * h)
        return self.fc2(h)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size)
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size)
        self.mlp = CLIPMLP(cfg.hidden_size, cfg.intermediate_size, cfg.hidden_act)

    def forward(self, x):
        x = self.self_attn(self.layer_norm1(x)) + x
        return self.mlp(self.layer_norm2(x)) + x


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        npos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(npos, cfg.hidden_size)

    def forward(self, pixel_values):
        b = pixel_values.shape[0]
        patches = self.patch_embedding(pixel_values.permute(0, 3, 1, 2))
        patches = patches.flatten(2).transpose(1, 2)            # [B, hw, C]
        cls = self.class_embedding.to(patches.dtype).expand(b, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        return x + self.position_embedding.weight.to(x.dtype)[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                             for _ in range(cfg.num_layers)])
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size)


class CLIPVisionModelWithProjection(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.cfg = cfg
        self.vision_model = CLIPVisionTransformer(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim,
                                           bias=False)

    def forward(self, pixel_values):
        """pixel_values [B, H, W, 3] -> image_embeds [B, projection_dim]."""
        vm = self.vision_model
        x = vm.pre_layrnorm(vm.embeddings(pixel_values))
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))
