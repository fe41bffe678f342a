"""GMFlow / UniMatch optical flow: the teacher, and its training forward.

Counterpart of mofa_tpu/models/gmflow/model.py (the flow path of the
reference's Training/train_utils/unimatch/unimatch/unimatch.py, config
gmflow-scale2-regrefine6: 128 feature channels, 2 scales, upsample factor
4, 6 transformer layers, 6 regression refinements; train_stage1.py:
725-733):

  CNN pyramid (1/8, 1/4 by one shared trident conv) ->
  per scale: the swin-split feature transformer (self, cross + FFN,
  shifted windows on odd layers) -> correlation softmax (global at 1/8,
  radius 4 at 1/4) -> self-attention flow propagation ->
  6 SepConvGRU regression refinements at 1/4 -> RAFT convex upsampling x4.

Module and parameter names are UniMatch's, so its checkpoint loads with
`load_state_dict(strict=True)` (`load_gmflow`, which drops the unused
`upsampler.` keys as mofa_tpu's `convert_gmflow_state_dict` does).
Layouts follow the JAX package: images and features [B, H, W, C], the
convs in NCHW inside. `forward(..., return_preds=True)` is the training
mode (unimatch.py:226-358): it also returns every full-resolution
prediction the sequence loss reads (a bilinear upsample after each
scale's propagation, a convex upsample after every refinement), with the
flow detached where the JAX package stops its gradient (the scale-2 start,
the propagation's input, each refinement's input). The forward runs under
autograd; `get_optical_flows` is the no-grad teacher. Attention and correlations are plain matmul +
softmax (no kernel: GMFlow reaches no Pallas kernel). The LayerNorms use
the JAX package's epsilon, 1e-6 (UniMatch's torch modules take 1e-5).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mofa_tpu_torch.ops.consts import device_constant
from mofa_tpu_torch.ops.resize import resize_nhwc

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class GMFlowConfig:
    feature_channels: int = 128
    num_scales: int = 2
    upsample_factor: int = 4              # at the finest scale
    num_transformer_layers: int = 6
    ffn_dim_expansion: int = 4
    attn_splits: Sequence[int] = (2, 8)
    corr_radius: Sequence[int] = (-1, 4)
    prop_radius: Sequence[int] = (-1, 1)
    num_reg_refine: int = 6


TINY_GMFLOW_CONFIG = GMFlowConfig(num_transformer_layers=2, num_reg_refine=2)


# ----------------------------------------------------------------- helpers

def split_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*k*k, H/k, W/k, C], in (b, kh, kw) order."""
    b, h, w, c = x.shape
    x = x.reshape(b, k, h // k, k, w // k, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * k * k, h // k, w // k, c)


def merge_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of split_windows."""
    bkk, hk, wk, c = x.shape
    x = x.reshape(bkk // (k * k), k, k, hk, wk, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(bkk // (k * k), k * hk, k * wk, c)


def position_embedding_sine(h: int, w: int, num_pos_feats: int,
                            temperature: float = 10000.0) -> np.ndarray:
    """[h, w, 2 * num_pos_feats], cat(pos_y, pos_x) (unimatch/position.py)."""
    scale, eps = 2 * math.pi, 1e-6
    y = np.cumsum(np.ones((h, w), np.float32), axis=0)
    x = np.cumsum(np.ones((h, w), np.float32), axis=1)
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    px = x[:, :, None] / dim_t
    py = y[:, :, None] / dim_t
    px = np.stack([np.sin(px[..., 0::2]), np.cos(px[..., 1::2])], -1).reshape(h, w, -1)
    py = np.stack([np.sin(py[..., 0::2]), np.cos(py[..., 1::2])], -1).reshape(h, w, -1)
    return np.concatenate([py, px], axis=-1)


def shift_window_attn_mask(h: int, w: int, k: int) -> np.ndarray:
    """[k*k, hw', hw'] additive mask of shifted-window attention
    (unimatch/utils.py:84-108)."""
    wh, ww = h // k, w // k
    sh, sw = wh // 2, ww // 2
    img = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -sh), slice(-sh, None)):
        for ws in (slice(0, -ww), slice(-ww, -sw), slice(-sw, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = img.reshape(1, k, wh, k, ww, 1).transpose(0, 1, 3, 2, 4, 5)
    win = win.reshape(k * k, wh * ww)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def coords_grid(h: int, w: int, like: torch.Tensor) -> torch.Tensor:
    """[h, w, 2] (x, y) pixel coordinates."""
    y, x = torch.meshgrid(torch.arange(h, device=like.device, dtype=like.dtype),
                          torch.arange(w, device=like.device, dtype=like.dtype),
                          indexing="ij")
    return torch.stack([x, y], dim=-1)


def bilinear_sample(feature: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid_sample(align_corners=True, zeros padding) at pixel coordinates:
    feature [B, H, W, C], coords [B, h, w, 2] (x, y) -> [B, h, w, C]."""
    h, w = feature.shape[1:3]
    grid = torch.stack([2.0 * coords[..., 0] / (w - 1) - 1.0,
                        2.0 * coords[..., 1] / (h - 1) - 1.0], dim=-1)
    out = F.grid_sample(feature.permute(0, 3, 1, 2), grid.to(feature.dtype),
                        mode="bilinear", padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1)


def flow_warp(feature: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp feature [B, H, W, C] by flow [B, H, W, 2]."""
    h, w = feature.shape[1:3]
    return bilinear_sample(feature, coords_grid(h, w, flow)[None] + flow)


def upsample_flow_with_mask(flow: torch.Tensor, up_mask: torch.Tensor,
                            factor: int) -> torch.Tensor:
    """RAFT convex upsampling (unimatch/utils.py:134-152): flow [B, h, w, 2],
    up_mask [B, h, w, 9 * factor^2] -> [B, h * factor, w * factor, 2]."""
    b, h, w, _ = flow.shape
    mask = torch.softmax(up_mask.reshape(b, h, w, 9, factor, factor), dim=3)
    pad = F.pad(flow * factor, (0, 0, 1, 1, 1, 1))
    neigh = torch.stack([pad[:, dy:dy + h, dx:dx + w] for dy in range(3)
                         for dx in range(3)], dim=3)            # [B, h, w, 9, 2]
    up = torch.einsum("bhwkuv,bhwkc->bhwuvc", mask, neigh)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, h * factor, w * factor, 2)


def global_correlation_softmax(f0: torch.Tensor, f1: torch.Tensor):
    """[B, H, W, C] x 2 -> flow [B, H, W, 2] (unimatch/matching.py:7-37)."""
    b, h, w, c = f0.shape
    corr = torch.matmul(f0.reshape(b, h * w, c),
                        f1.reshape(b, h * w, c).transpose(1, 2)) / c ** 0.5
    prob = torch.softmax(corr, dim=-1)
    grid = coords_grid(h, w, f0).reshape(1, h * w, 2)
    return (torch.matmul(prob, grid.expand(b, -1, -1)) - grid).reshape(b, h, w, 2)


def _shifts(radius: int):
    return [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)]


def local_correlation_softmax(f0: torch.Tensor, f1: torch.Tensor, radius: int):
    """Radius-r local matching by shifted products (matching.py:40-85)."""
    b, h, w, c = f0.shape
    pad = F.pad(f1, (0, 0, radius, radius, radius, radius))
    grid = coords_grid(h, w, f0)
    corrs, valids, offs = [], [], []
    for dy, dx in _shifts(radius):
        shifted = pad[:, dy + radius:dy + radius + h, dx + radius:dx + radius + w]
        corrs.append((f0 * shifted).sum(-1))
        cx, cy = grid[..., 0] + dx, grid[..., 1] + dy
        valids.append((cx >= 0) & (cx < w) & (cy >= 0) & (cy < h))
        offs.append([dx, dy])
    corr = torch.stack(corrs, dim=-1) / c ** 0.5                 # [B, H, W, k*k]
    corr = torch.where(torch.stack(valids, dim=-1), corr, -1e4)
    prob = torch.softmax(corr, dim=-1)
    offsets = device_constant(("local_offsets", radius),
                              lambda: torch.tensor(offs, dtype=torch.float64),
                              f0.device, f0.dtype)
    sample = grid[None, :, :, None, :] + offsets
    return torch.einsum("bhwk,bhwkc->bhwc", prob, sample) - grid[None]


def local_correlation_with_flow(f0: torch.Tensor, f1: torch.Tensor,
                                flow: torch.Tensor, radius: int):
    """[B, H, W, (2r+1)^2] correlation at flow-displaced windows
    (matching.py:88-131), zeros padding."""
    h, w, c = f0.shape[1:]
    base = coords_grid(h, w, f0)[None] + flow
    corrs = []
    offsets = device_constant(("flow_offsets", radius),
                              lambda: torch.tensor([[dx, dy] for dy, dx in _shifts(radius)],
                                                   dtype=torch.float64),
                              f0.device, f0.dtype)
    for i in range(offsets.shape[0]):
        corrs.append((f0 * bilinear_sample(f1, base + offsets[i])).sum(-1))
    return torch.stack(corrs, dim=-1) / c ** 0.5


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """NCHW, per sample and channel over space, no affine (biased var)."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


# ----------------------------------------------------------------- modules

class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, dilation,
                               dilation=dilation, bias=False)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, dilation,
                               dilation=dilation, bias=False)
        self.downsample = (None if stride == 1 and in_planes == planes else
                           nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride)))

    def forward(self, x):
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = instance_norm(self.downsample(x))
        return F.relu(x + y)


class TridentConv(nn.Module):
    """One 3x3 weight applied at strides 1 and 2 (MultiScaleTridentConv)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, channels, 3, 3))

    def forward(self, x):
        return [F.conv2d(x, self.weight, stride=s, padding=1) for s in (1, 2)]


class CNNEncoder(nn.Module):
    def __init__(self, cfg: GMFlowConfig):
        super().__init__()
        c = cfg.feature_channels
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64), ResidualBlock(64, 64))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, 2), ResidualBlock(96, 96))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, 1),
                                    ResidualBlock(128, 128))    # stays 1/4
        self.conv2 = nn.Conv2d(128, c, 1)
        self.trident_conv = TridentConv(c)

    def forward(self, x):
        """[N, 3, H, W] -> [f_1/8, f_1/4], NCHW."""
        x = F.relu(instance_norm(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        quarter, eighth = self.trident_conv(self.conv2(x))
        return [eighth, quarter]


class TransformerLayer(nn.Module):
    def __init__(self, c: int, ffn_dim_expansion: int, no_ffn: bool = False):
        super().__init__()
        self.q_proj = nn.Linear(c, c, bias=False)
        self.k_proj = nn.Linear(c, c, bias=False)
        self.v_proj = nn.Linear(c, c, bias=False)
        self.merge = nn.Linear(c, c, bias=False)
        self.norm1 = nn.LayerNorm(c, eps=LN_EPS)
        self.no_ffn = no_ffn
        if not no_ffn:
            self.mlp = nn.Sequential(
                nn.Linear(2 * c, 2 * c * ffn_dim_expansion, bias=False), nn.GELU(),
                nn.Linear(2 * c * ffn_dim_expansion, c, bias=False))
            self.norm2 = nn.LayerNorm(c, eps=LN_EPS)

    def forward(self, source, target, h, w, k, with_shift, attn_mask):
        """source / target [B, H*W, C] -> [B, H*W, C]."""
        b, _, c = source.shape
        q, key, v = self.q_proj(source), self.k_proj(target), self.v_proj(target)
        if k > 1:
            qw, kw, vw = (t.reshape(b, h, w, c) for t in (q, key, v))
            sh, sw = (h // k) // 2, (w // k) // 2
            if with_shift:
                qw, kw, vw = (torch.roll(t, (-sh, -sw), dims=(1, 2))
                              for t in (qw, kw, vw))
            qs, ks, vs = (split_windows(t, k).reshape(b * k * k, -1, c)
                          for t in (qw, kw, vw))
            scores = torch.matmul(qs, ks.transpose(1, 2)) / c ** 0.5
            if with_shift:
                scores = scores + attn_mask.repeat(b, 1, 1).to(scores.dtype)
            out = torch.matmul(torch.softmax(scores, dim=-1), vs)
            out = merge_windows(out.reshape(b * k * k, h // k, w // k, c), k)
            if with_shift:
                out = torch.roll(out, (sh, sw), dims=(1, 2))
            message = out.reshape(b, h * w, c)
        else:
            scores = torch.matmul(q, key.transpose(1, 2)) / c ** 0.5
            message = torch.matmul(torch.softmax(scores, dim=-1), v)
        message = self.norm1(self.merge(message))
        if not self.no_ffn:
            message = self.mlp(torch.cat([source, message], dim=-1))
            message = self.norm2(message)
        return source + message


class TransformerBlock(nn.Module):
    def __init__(self, c: int, ffn_dim_expansion: int):
        super().__init__()
        self.self_attn = TransformerLayer(c, ffn_dim_expansion, no_ffn=True)
        self.cross_attn_ffn = TransformerLayer(c, ffn_dim_expansion)

    def forward(self, source, target, h, w, k, with_shift, attn_mask):
        source = self.self_attn(source, source, h, w, k, with_shift, attn_mask)
        return self.cross_attn_ffn(source, target, h, w, k, with_shift, attn_mask)


class FeatureTransformer(nn.Module):
    def __init__(self, cfg: GMFlowConfig):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerBlock(cfg.feature_channels, cfg.ffn_dim_expansion)
            for _ in range(cfg.num_transformer_layers)])

    def forward(self, f0, f1, k):
        """f0 / f1 [B, H, W, C], k attention splits; both directions in one
        pass (source = cat(f0, f1), target = cat(f1, f0))."""
        b, h, w, c = f0.shape
        mask = (device_constant(("shift_window_mask", h, w, k),
                                lambda: shift_window_attn_mask(h, w, k), f0.device)
                if k > 1 else None)
        s, t = f0.reshape(b, h * w, c), f1.reshape(b, h * w, c)
        src, tgt = torch.cat([s, t]), torch.cat([t, s])
        for i, layer in enumerate(self.layers):
            src = layer(src, tgt, h, w, k, k > 1 and i % 2 == 1, mask)
            tgt = torch.cat([src[b:], src[:b]])
        return src[:b].reshape(b, h, w, c), src[b:].reshape(b, h, w, c)


class SelfAttnPropagation(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)

    def forward(self, feature, flow, local_radius: int):
        """feature [B, H, W, C], flow [B, H, W, 2]; radius <= 0: global.
        The reference's global branch chains k_proj(q_proj(x))
        (attention.py:198-205); its local branch projects the feature."""
        b, h, w, c = feature.shape
        x = feature.reshape(b, h * w, c)
        q = self.q_proj(x)
        if local_radius <= 0:
            k = self.k_proj(q)
            prob = torch.softmax(torch.matmul(q, k.transpose(1, 2)) / c ** 0.5, -1)
            return torch.matmul(prob, flow.reshape(b, h * w, 2)).reshape(b, h, w, 2)
        r = local_radius
        qs = q.reshape(b, h, w, c)
        kpad = F.pad(self.k_proj(x).reshape(b, h, w, c), (0, 0, r, r, r, r))
        fpad = F.pad(flow, (0, 0, r, r, r, r))
        scores, values = [], []
        for dy in range(2 * r + 1):
            for dx in range(2 * r + 1):
                scores.append((qs * kpad[:, dy:dy + h, dx:dx + w]).sum(-1))
                values.append(fpad[:, dy:dy + h, dx:dx + w])
        prob = torch.softmax(torch.stack(scores, dim=-1) / c ** 0.5, dim=-1)
        return torch.einsum("bhwk,bhwkc->bhwc", prob, torch.stack(values, dim=3))


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_channels: int = 81):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(256, 126, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden: int = 128, inp: int = 256):
        super().__init__()
        for suffix, (kh, kw) in (("1", (1, 5)), ("2", (5, 1))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{suffix}",
                        nn.Conv2d(hidden + inp, hidden, (kh, kw),
                                  padding=(kh // 2, kw // 2)))

    def forward(self, h, x):
        for suffix in "12":
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
            q = torch.tanh(getattr(self, f"convq{suffix}")(torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, inp: int = 128, hidden: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(inp, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, cfg: GMFlowConfig):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU()
        self.flow_head = FlowHead()
        self.mask = nn.Sequential(nn.Conv2d(128, 256, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(256, cfg.upsample_factor ** 2 * 9, 1))

    def forward(self, net, inp, corr, flow):
        """NCHW -> (net, up mask, flow delta) (reg_refine.py)."""
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, self.mask(net), self.flow_head(net)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class GMFlow(nn.Module):
    """forward(img0, img1): [B, H, W, 3] in [0, 255] -> flow [B, H, W, 2]."""

    def __init__(self, cfg: GMFlowConfig = GMFlowConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg.feature_channels
        self.backbone = CNNEncoder(cfg)
        self.transformer = FeatureTransformer(cfg)
        self.feature_flow_attn = SelfAttnPropagation(c)
        self.refine_proj = nn.Conv2d(c, 256, 1)
        self.refine = BasicUpdateBlock(cfg)

    def forward(self, img0, img1, return_preds: bool = False):
        """Flow [B, H, W, 2]; with return_preds, (flow, preds)."""
        cfg = self.cfg
        c = cfg.feature_channels
        mean = device_constant("imagenet_mean", lambda: np.asarray(IMAGENET_MEAN),
                               img0.device, img0.dtype)
        std = device_constant("imagenet_std", lambda: np.asarray(IMAGENET_STD),
                              img0.device, img0.dtype)
        img0 = (img0 / 255.0 - mean) / std
        img1 = (img1 / 255.0 - mean) / std
        feats = [_nhwc(f) for f in self.backbone(_nchw(torch.cat([img0, img1])))]
        b = img0.shape[0]
        flow, flow_up, preds = None, None, []
        for scale_idx in range(cfg.num_scales):
            f0, f1 = feats[scale_idx][:b], feats[scale_idx][b:]
            f0_ori, f1_ori = f0, f1
            if scale_idx > 0:
                flow = resize_nhwc(flow, f0.shape[1:3], "bilinear",
                                   align_corners=True).detach() * 2.0
                f1 = flow_warp(f1, flow)
            k = cfg.attn_splits[scale_idx]
            h, w = f0.shape[1:3]
            posf = device_constant(
                ("position_sine", h, w, k, c),
                lambda: merge_windows(torch.from_numpy(position_embedding_sine(
                    h // k, w // k, c // 2))[None].repeat(k * k, 1, 1, 1), k),
                f0.device, f0.dtype)
            f0, f1 = self.transformer(f0 + posf, f1 + posf, k)
            radius = cfg.corr_radius[scale_idx]
            flow_pred = (global_correlation_softmax(f0, f1) if radius == -1
                         else local_correlation_softmax(f0, f1, radius))
            flow = flow_pred if flow is None else flow + flow_pred
            flow = self.feature_flow_attn(f0, flow.detach(), cfg.prop_radius[scale_idx])
            if return_preds:
                # bilinear (align_corners) to the image's size, times the
                # factor (unimatch.py:230-232, 271-274)
                factor = cfg.upsample_factor * 2 ** (cfg.num_scales - 1 - scale_idx)
                hh, ww = flow.shape[1:3]
                preds.append(resize_nhwc(flow, (hh * factor, ww * factor), "bilinear",
                                         align_corners=True) * factor)
            if scale_idx == cfg.num_scales - 1:
                # the reference re-initialises the GRU state from refine_proj
                # every iteration (unimatch.py:278-327); only flow carries
                net0, inp = self.refine_proj(_nchw(f0)).chunk(2, dim=1)
                net0, inp = torch.tanh(net0), F.relu(inp)
                up_mask = None
                for _ in range(cfg.num_reg_refine):
                    flow = flow.detach()
                    corr = local_correlation_with_flow(f0_ori, f1_ori, flow, 4)
                    _, up_mask, delta = self.refine(net0, inp, _nchw(corr),
                                                    _nchw(flow))
                    flow = flow + _nhwc(delta)
                    if return_preds:                  # unimatch.py:355-358
                        preds.append(upsample_flow_with_mask(
                            flow, _nhwc(up_mask), cfg.upsample_factor))
                flow_up = upsample_flow_with_mask(flow, _nhwc(up_mask),
                                                  cfg.upsample_factor)
        return (flow_up, preds) if return_preds else flow_up


def load_gmflow(model: GMFlow, state_dict: dict) -> GMFlow:
    """A UniMatch / GMFlow checkpoint's state dict into `model`, strictly
    (`module.` prefixes and the `upsampler.` keys, which the regression-
    refine flow model never runs, dropped first). In place."""
    sd = {k.removeprefix("module."): v for k, v in state_dict.items()}
    sd = {k: v for k, v in sd.items() if not k.startswith("upsampler.")}
    model.load_state_dict(sd, strict=True)
    return model


@torch.no_grad()
def get_optical_flows(gmflow: GMFlow, video01: torch.Tensor,
                      inference_size=(384, 512),
                      pair_chunk: int | None = None) -> torch.Tensor:
    """[B, T, H, W, 3] in [0, 1] -> frame 0 -> frame i flows [B, T-1, H, W, 2]
    (mofa_tpu's get_optical_flows; the reference's train_stage1.py:113-143
    runs the pairs one by one): all T-1 pairs as one batch, or
    `pair_chunk` pairs at a time; portrait inputs transposed to landscape
    and the flow's spatial axes transposed back, its channels left as
    computed (the reference's postprocess_size, bug-compatible)."""
    b, t, h, w = video01.shape[:4]
    video = video01 * 255.0
    transpose = h > w
    if transpose:
        video = video.transpose(2, 3)
        h, w = w, h
    ih, iw = inference_size
    img0 = video[:, :1].expand(b, t - 1, h, w, 3).reshape(b * (t - 1), h, w, 3)
    img1 = video[:, 1:].reshape(b * (t - 1), h, w, 3)
    if (h, w) != (ih, iw):
        img0 = resize_nhwc(img0, (ih, iw), "bilinear", align_corners=True)
        img1 = resize_nhwc(img1, (ih, iw), "bilinear", align_corners=True)
    n = img0.shape[0]
    chunk = n if pair_chunk is None else pair_chunk
    flow = torch.cat([gmflow(img0[i:i + chunk], img1[i:i + chunk])
                      for i in range(0, n, chunk)])
    if (h, w) != (ih, iw):
        flow = resize_nhwc(flow, (h, w), "bilinear", align_corners=True)
        flow = flow * device_constant(("flow_scale", w / iw, h / ih),
                                      lambda: torch.tensor([w / iw, h / ih],
                                                           dtype=torch.float64),
                                      flow.device, flow.dtype)
    flow = flow.reshape(b, t - 1, h, w, 2)
    return flow.transpose(2, 3) if transpose else flow
