"""FILM frame interpolation (Reda et al., ECCV 2022) in PyTorch.

Counterpart of mofa_tpu/models/film.py, NCHW: film_net's cascaded
shared-conv feature pyramid, coarse-to-fine bidirectional residual flow,
backward warping and a U-Net fusion decoder, and the reference's
frame insertion order (MOFA-Video-Hybrid/aniportrait/src/utils/
frame_interpolation.py:12-69) in `interpolate_frames`.

- `warp`: backward warp, bilinear, each of the four gather indices
  clamped at the edge (the JAX package's rule, not `grid_sample`'s
  clamped coordinate: the two agree up to rounding);
- the flow is upsampled x2 with bilinear, half-pixel `F.interpolate`
  (equal to `jax.image.resize`'s "bilinear" for an upscale), the fusion's
  features with nearest; its 2x2 conv pads (0, 1) as Flax's "SAME";
- `FilmNet(x0, x1, dt)`: x0, x1 [B, 3, H, W] in [0, 1], H and W multiples
  of 2 ** (pyramid_levels - 1), dt a float or [B] -> [B, 3, H, W].

The reference ships film_net_fp16.pt, a TorchScript blob, for which
neither package has a converter; module names here are those of the JAX
package's parameter tree (`extract.extract_sublevels.convs_0`,
`predict_flow.predictors_shared.convs_head1`, `fuse.convs_0_up`, ...), and
`film_state_dict_from_jax` carries a JAX tree into this module.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class FilmConfig:
    pyramid_levels: int = 7
    fusion_pyramid_levels: int = 5
    specialized_levels: int = 3
    sub_levels: int = 4
    filters: int = 64
    flow_convs: Tuple[int, ...] = (3, 3, 3, 3)
    flow_filters: Tuple[int, ...] = (32, 64, 128, 256)


TINY_FILM_CONFIG = FilmConfig(pyramid_levels=3, fusion_pyramid_levels=3,
                              specialized_levels=1, sub_levels=2, filters=8,
                              flow_convs=(2, 2), flow_filters=(8, 16))


def feature_channels(cfg: FilmConfig, level: int) -> int:
    """Channels of the cascaded feature pyramid at `level`."""
    return sum(cfg.filters << j for j in range(min(cfg.sub_levels, level + 1)))


def build_image_pyramid(image: torch.Tensor, levels: int) -> list:
    """[B, C, H, W] -> `levels` images, each half the size of the last."""
    pyr = [image]
    for _ in range(levels - 1):
        pyr.append(F.avg_pool2d(pyr[-1], 2))
    return pyr


def warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp: image [B, C, H, W] sampled at (x + flow_x, y +
    flow_y), flow [B, 2, H, W]; bilinear, each gather index clamped to the
    image."""
    b, c, h, w = image.shape
    gy = torch.arange(h, device=flow.device, dtype=flow.dtype)[:, None]
    gx = torch.arange(w, device=flow.device, dtype=flow.dtype)[None, :]
    sx = gx + flow[:, 0]
    sy = gy + flow[:, 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[:, None], (sy - y0)[:, None]
    flat = image.reshape(b, c, h * w)

    def gather(yi, xi):
        yi = yi.clamp(0, h - 1).long()
        xi = xi.clamp(0, w - 1).long()
        idx = (yi * w + xi).reshape(b, 1, h * w).expand(b, c, h * w)
        return torch.gather(flat, 2, idx).reshape(b, c, h, w)

    out = ((1 - wy) * ((1 - wx) * gather(y0, x0) + wx * gather(y0, x0 + 1))
           + wy * ((1 - wx) * gather(y0 + 1, x0) + wx * gather(y0 + 1, x0 + 1)))
    return out.to(image.dtype)


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2 if k % 2 else 0)


class SubTreeExtractor(nn.Module):
    """`sub_levels` pairs of 3x3 convs, each pair followed by a 2x2 average
    pool into the next depth."""

    def __init__(self, cfg: FilmConfig):
        super().__init__()
        self.sub_levels = cfg.sub_levels
        cin = 3
        for i in range(cfg.sub_levels):
            cout = cfg.filters << i
            setattr(self, f"convs_{2 * i}", _conv(cin, cout, 3))
            setattr(self, f"convs_{2 * i + 1}", _conv(cout, cout, 3))
            cin = cout

    def forward(self, image, n: int) -> list:
        feats, x = [], image
        for i in range(self.sub_levels):
            x = F.relu(getattr(self, f"convs_{2 * i}")(x))
            x = F.relu(getattr(self, f"convs_{2 * i + 1}")(x))
            feats.append(x)
            if i < n - 1:
                x = F.avg_pool2d(x, 2)
        return feats[:n]


class FeatureExtractor(nn.Module):
    """One shared SubTreeExtractor over every image-pyramid level; features
    of equal resolution from different roots concatenated."""

    def __init__(self, cfg: FilmConfig):
        super().__init__()
        self.sub_levels = cfg.sub_levels
        self.extract_sublevels = SubTreeExtractor(cfg)

    def forward(self, image_pyramid: list) -> list:
        n = len(image_pyramid)
        subs = [self.extract_sublevels(im, min(n - i, self.sub_levels))
                for i, im in enumerate(image_pyramid)]
        return [torch.cat([subs[i - j][j] for j in range(min(self.sub_levels, i + 1))], 1)
                for i in range(n)]


class FlowEstimator(nn.Module):
    """`num_convs` 3x3 convs, then a 1x1 head to half the filters and a 1x1
    head to the 2-channel residual flow."""

    def __init__(self, cin: int, num_convs: int, num_filters: int):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            setattr(self, f"convs_{i}", _conv(cin if i == 0 else num_filters, num_filters, 3))
        self.convs_head0 = _conv(num_filters, num_filters // 2, 1)
        self.convs_head1 = _conv(num_filters // 2, 2, 1)

    def forward(self, feat_a, feat_b):
        x = torch.cat([feat_a, feat_b], 1)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"convs_{i}")(x))
        return self.convs_head1(F.relu(self.convs_head0(x)))


def _upsample_flow(v, size):
    return 2.0 * F.interpolate(v, size=tuple(size), mode="bilinear", align_corners=False)


class PyramidFlowEstimator(nn.Module):
    """Coarse to fine: specialized estimators at the finest
    `specialized_levels`, a shared one elsewhere; at each level the
    upsampled coarser flow warps feat_b before the residual is predicted."""

    def __init__(self, cfg: FilmConfig):
        super().__init__()
        self.specialized = cfg.specialized_levels
        for i in range(cfg.specialized_levels):
            setattr(self, f"predictors_{i}", FlowEstimator(
                2 * feature_channels(cfg, i), cfg.flow_convs[i], cfg.flow_filters[i]))
        self.predictors_shared = FlowEstimator(
            2 * feature_channels(cfg, cfg.specialized_levels), cfg.flow_convs[-1],
            cfg.flow_filters[-1])

    def _predictor(self, level: int) -> FlowEstimator:
        if level < self.specialized:
            return getattr(self, f"predictors_{level}")
        return self.predictors_shared

    def forward(self, fa: list, fb: list) -> list:
        """The forward flows (a -> b) of each level, finest first."""
        levels = len(fa)
        v = self._predictor(levels - 1)(fa[-1], fb[-1])
        residuals = [v]
        for i in reversed(range(levels - 1)):
            v = _upsample_flow(v, fa[i].shape[2:])
            res = self._predictor(i)(fa[i], warp(fb[i], v))
            residuals.insert(0, res)
            v = v + res
        flows = [residuals[-1]]
        for i in reversed(range(levels - 1)):
            flows.insert(0, residuals[i] + _upsample_flow(flows[0], fa[i].shape[2:]))
        return flows


class Fusion(nn.Module):
    """U-Net decoder over the aligned pyramid: from the coarsest fusion
    level, nearest x2 + a 2x2 conv, the skip concatenated, two 3x3 convs;
    a final 1x1 conv to RGB."""

    def __init__(self, cfg: FilmConfig):
        super().__init__()
        m = cfg.fusion_pyramid_levels
        aligned = [2 * (3 + feature_channels(cfg, i)) + 4 for i in range(m)]
        cin = aligned[-1]
        self.m = m
        for k, i in enumerate(reversed(range(m - 1))):
            num_f = cfg.filters << min(i, cfg.sub_levels - 1)
            setattr(self, f"convs_{k}_up", _conv(cin, num_f, 2))
            setattr(self, f"convs_{k}_a", _conv(aligned[i] + num_f, num_f, 3))
            setattr(self, f"convs_{k}_b", _conv(num_f, num_f, 3))
            cin = num_f
        self.output_conv = _conv(cin, 3, 1)

    def forward(self, pyramid: list):
        x = pyramid[-1]
        for k, i in enumerate(reversed(range(self.m - 1))):
            x = F.interpolate(x, size=tuple(pyramid[i].shape[2:]), mode="nearest")
            x = getattr(self, f"convs_{k}_up")(F.pad(x, (0, 1, 0, 1)))  # Flax SAME, 2x2
            x = torch.cat([pyramid[i], x], 1)
            x = F.relu(getattr(self, f"convs_{k}_a")(x))
            x = F.relu(getattr(self, f"convs_{k}_b")(x))
        return self.output_conv(x)


class FilmNet(nn.Module):
    """x0, x1 [B, 3, H, W] in [0, 1], dt in (0, 1) -> the frame at dt."""

    def __init__(self, cfg: FilmConfig = FilmConfig()):
        super().__init__()
        self.cfg = cfg
        self.extract = FeatureExtractor(cfg)
        self.predict_flow = PyramidFlowEstimator(cfg)
        self.fuse = Fusion(cfg)

    def forward(self, x0, x1, dt):
        cfg = self.cfg
        pyr0 = build_image_pyramid(x0, cfg.pyramid_levels)
        pyr1 = build_image_pyramid(x1, cfg.pyramid_levels)
        f0, f1 = self.extract(pyr0), self.extract(pyr1)
        fwd = self.predict_flow(f0, f1)
        bwd = self.predict_flow(f1, f0)
        dt = torch.as_tensor(dt, dtype=x0.dtype, device=x0.device).reshape(-1, 1, 1, 1)
        aligned = []
        for i in range(cfg.fusion_pyramid_levels):
            # the frame at dt samples the source frames along dt * (t->0)
            # and (1 - dt) * (t->1)
            to0, to1 = dt * bwd[i], (1.0 - dt) * fwd[i]
            w0 = warp(torch.cat([pyr0[i], f0[i]], 1), to0)
            w1 = warp(torch.cat([pyr1[i], f1[i]], 1), to1)
            aligned.append(torch.cat([w0, w1, to0, to1], 1))
        return self.fuse(aligned)


def film_state_dict_from_jax(flax_params: dict) -> dict:
    """The JAX package's FilmNet parameter tree (numpy leaves; with or
    without the outer "params") -> this module's state dict: the path
    joined with ".", each conv "kernel" [kh, kw, I, O] -> "weight"
    [O, I, kh, kw]."""
    tree = flax_params.get("params", flax_params)
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k == "kernel":
                out[".".join(path + ("weight",))] = torch.from_numpy(
                    np.ascontiguousarray(np.asarray(v, np.float32).transpose(3, 2, 0, 1)))
            else:
                out[".".join(path + (k,))] = torch.from_numpy(np.array(v, np.float32))

    walk(tree, ())
    return out


def interpolate_frames(frames: np.ndarray, inter_frames: int, predict) -> np.ndarray:
    """frame_interpolation.py:22-69: insert `inter_frames` frames between
    every adjacent pair, each insertion point chosen by the reference's
    argmin-distance bisection. frames [T, H, W, 3]; predict(x0, x1, dt) ->
    [H, W, 3]. Returns [T + (T - 1) * inter_frames, H, W, 3]."""
    out = []
    for idx in range(len(frames) - 1):
        results = [frames[idx], frames[idx + 1]]
        idxes = [0, inter_frames + 1]
        remains = list(range(1, inter_frames + 1))
        splits = np.linspace(0, 1, inter_frames + 2)
        for _ in range(len(remains)):
            starts = splits[idxes[:-1]]
            ends = splits[idxes[1:]]
            distances = np.abs((splits[None, remains] - starts[:, None])
                               / (ends[:, None] - starts[:, None]) - 0.5)
            start_i, step = np.unravel_index(int(np.argmin(distances)), distances.shape)
            end_i = start_i + 1
            dt = ((splits[remains[step]] - splits[idxes[start_i]])
                  / (splits[idxes[end_i]] - splits[idxes[start_i]]))
            pred = np.clip(np.asarray(predict(results[start_i], results[end_i], float(dt))),
                           0.0, 1.0)
            pos = bisect.bisect_left(idxes, remains[step])
            idxes.insert(pos, remains[step])
            results.insert(pos, pred)
            del remains[step]
        out.extend(results[:-1])
    out.append(frames[-1])
    return np.stack(out)
